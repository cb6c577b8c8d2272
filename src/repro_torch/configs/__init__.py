"""Per-architecture configs: ``CONFIG`` and ``smoke_config()``."""

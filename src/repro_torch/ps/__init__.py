"""Parameter-server training on the dataflow core (paper §4.4, §6.4)."""

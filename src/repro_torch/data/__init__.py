"""The input pipeline."""

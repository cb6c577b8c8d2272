"""Optimizers as tensor code on trees of parameters."""

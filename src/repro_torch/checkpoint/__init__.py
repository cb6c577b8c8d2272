"""Checkpointing (port of ``repro.checkpoint``): the manager and its
on-disk format, and restore onto a device."""

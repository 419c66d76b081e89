"""Checkpointing (counterpart of ``repro.checkpoint``)."""

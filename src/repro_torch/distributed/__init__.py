"""Logical-axis sharding over a mesh of ranks (counterpart of
``repro.distributed``)."""

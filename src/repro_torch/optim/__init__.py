"""Optimiser (counterpart of ``repro.optim``): AdamW with decoupled weight
decay, and int8 error-feedback gradient compression."""

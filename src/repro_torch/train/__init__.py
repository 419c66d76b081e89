"""Training (counterpart of ``repro.train``): the step factories and the
resilient training loop."""

"""Launchers (counterpart of ``repro.launch``): ``serve``."""

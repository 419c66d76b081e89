"""The Mamba-2 SSD kernel (CUDA C++ under ``csrc/``), its wrapper and plain
version (``ssd_scan``), its entry point (``ops``) and oracle (``ref``)."""

"""The flash-attention kernel (CUDA C++ under ``csrc/``), its wrapper and
plain version (``flash_attention``), its entry point (``ops``) and oracle
(``ref``)."""

"""The membench throughput kernels (CUDA C++ under ``csrc/``), their wrappers
(``membench``), their timed forms (``ops``) and per-call references (``ref``)."""

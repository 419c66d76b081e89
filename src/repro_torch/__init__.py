"""repro_torch — the Arm-membench throughput benchmark on PyTorch and CUDA.

The second package of this repository: ``repro`` (JAX + Pallas) is the
reference, this one runs the same measurement on an NVIDIA GPU.  Module names
mirror the reference's (``repro_torch.bench.runner`` is the counterpart of
``repro.bench.runner``), the spec and result JSON are interchangeable
(``repro_torch.convert``), and every kernel the reference wrote in Pallas is a
CUDA C++ kernel here (``repro_torch.kernels``).  Nothing in this package
imports ``jax`` or ``repro``; only the tests import both.
"""

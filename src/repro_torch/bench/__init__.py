"""repro_torch.bench — the unified experiment API on PyTorch.

One declarative BenchSpec, pluggable backends (``torch`` plain oracles /
``cuda`` hand-written kernels / ``sharded`` and ``distributed`` meshes of the
oracles), one Runner owning the measurement discipline, versioned results:

    from repro_torch.bench import BenchSpec, Runner
    res = Runner().run(BenchSpec(mixes=("load_sum", "fma_8"), backend="cuda",
                                 sizes=(32 * 2**10, 16 * 2**20)))
    res.to_json("sweep.json")

``Runner()`` runs on ``cuda`` and raises when there is no CUDA device;
``Runner(device="cpu")`` asks for the CPU.

CLI: ``python -m repro_torch.bench {run,list-mixes,compare,launch,...}``.

Heavy submodules (backends pull in the kernel package) load lazily so that
``repro_torch.core`` modules can import the mix registry without a cycle.
"""
from repro_torch.bench.mixes import (FMA_DEPTHS, MAX_RW, MixDef,  # noqa: F401
                                     RW_RATIOS, get_mix, mix_names, registry,
                                     rw_name, rw_ratio)
from repro_torch.bench.result import (BenchPoint, BenchResult,  # noqa: F401
                                      SCHEMA_VERSION, machine_meta)
from repro_torch.bench.spec import (BenchSpec, BenchSpecError,  # noqa: F401
                                    SPEC_VERSION, quick_spec)

_LAZY = {
    "Runner": ("repro_torch.bench.runner", "Runner"),
    "run": ("repro_torch.bench.runner", "run"),
    "pick_passes": ("repro_torch.bench.runner", "pick_passes"),
    "Backend": ("repro_torch.bench.backends", "Backend"),
    "get_backend": ("repro_torch.bench.backends", "get_backend"),
    "register_backend": ("repro_torch.bench.backends", "register_backend"),
    "available_backends": ("repro_torch.bench.backends",
                           "available_backends"),
    # multi-process coordination (the `distributed` backend's plumbing)
    "ensure_initialized": ("repro_torch.bench.distributed",
                           "ensure_initialized"),
    "gather_result": ("repro_torch.bench.distributed", "gather_result"),
    "launch_local": ("repro_torch.bench.distributed", "launch_local"),
}

__all__ = ["BenchSpec", "BenchSpecError", "BenchPoint", "BenchResult",
           "MixDef", "FMA_DEPTHS", "MAX_RW", "RW_RATIOS", "SCHEMA_VERSION",
           "SPEC_VERSION", "registry", "get_mix", "mix_names", "rw_name",
           "rw_ratio", "machine_meta", "quick_spec", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(
        f"module 'repro_torch.bench' has no attribute {name!r}")

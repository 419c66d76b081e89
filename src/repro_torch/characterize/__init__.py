"""repro_torch.characterize — measurement-driven machine characterization.

Turns raw ``repro_torch.bench`` results into a fitted machine model, the way
the paper turns its sweeps into §5-§6 conclusions:

    from repro_torch.bench import Runner
    from repro_torch.characterize import characterize, render_markdown
    model, sweep = characterize(runner=Runner(), backend="cuda")
    print(render_markdown(model, sweep))
    model.to_json("fitted_machine_model.json")

Layers (measurement -> inference):

* ``adaptive``  — boundary-bisecting refinement driver over ``bench.Runner``
  (the paper's fine spatial granularity at a fraction of a dense grid)
* ``detect``    — change-point/plateau detection: levels, capacities and
  bandwidths *with confidence intervals*, no prior/documentation input
* ``loaded``    — loaded-latency (Mess-style bandwidth–latency) sweeps over
  the ``latency_chase`` mix's ``load`` axis + per-level knee fits
* ``fit``       — schema-versioned ``FittedMachineModel``; registers into
  the ``core.machine_model`` spec registry; consumed by ``core.autotune``;
  ``compare_to`` reproduces the Table-1 deltas
* ``report``    — markdown/JSON rendering (also:
  ``python -m repro_torch.bench characterize``)

Observability: adaptive rounds trace as ``characterize.round`` spans with
``characterize.bisect`` decision events (``--trace``), every CLI
characterization appends its bandwidth cells to the run ledger, and the
ledger's regression gate (``python -m repro_torch.bench diff``) reuses
``detect.significant_step`` — the same noise-aware two-sample threshold the
plateau merge applies here.

Counterpart of ``repro.characterize``, with the same ``__all__``.
"""
from repro_torch.characterize.adaptive import (AdaptiveSweep,  # noqa: F401
                                               DEFAULT_RESOLUTION,
                                               adaptive_sweep)
from repro_torch.characterize.detect import (Boundary,  # noqa: F401
                                             DetectedLevel, Detection,
                                             detect_from_result,
                                             detect_levels)
from repro_torch.characterize.fit import (FITTED_SCHEMA_VERSION,  # noqa: F401
                                          FittedMachineModel, LevelFit,
                                          characterize, crosscheck_prior,
                                          fit_from_result, probe_sizes)
from repro_torch.characterize.loaded import (fit_knee,  # noqa: F401
                                             fit_loaded,
                                             loaded_latency_sweep)
from repro_torch.characterize.report import (render_json,  # noqa: F401
                                             render_markdown, write_report)

__all__ = [
    "AdaptiveSweep", "DEFAULT_RESOLUTION", "adaptive_sweep",
    "Boundary", "DetectedLevel", "Detection", "detect_from_result",
    "detect_levels",
    "FITTED_SCHEMA_VERSION", "FittedMachineModel", "LevelFit",
    "characterize", "crosscheck_prior", "fit_from_result", "probe_sizes",
    "fit_knee", "fit_loaded", "loaded_latency_sweep",
    "render_json", "render_markdown", "write_report",
]

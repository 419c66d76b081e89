"""Block-shape autotuner — the paper's LD1D/LD2D/LD4D study (C4) put to work.

Figure 3 shows A64FX peaks at exactly two registers per load instruction;
the kernels' analogue is rows per tile (``block_rows``).  This module sweeps
block shapes with the membench kernel family and returns the best shape for
a given working-set size.

Counterpart of ``repro.core.autotune``: the ``cuda`` backend (the
hand-written kernels) where the reference sweeps ``pallas``.  Its unroll
leg (``tune_unroll``) ranks candidates by the accounting audit's waivers
(``repro_torch.audit.verify.waiver_reason``), and its ECM prefilter
(``model`` + ``ecm_keep``) prunes the ladder with
``repro_torch.audit.ecm.ecm_filter_rows``, as the reference's do.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import torch

# candidate block shapes: (rows, 128 lanes), multiples of the 8-row tile
# the working sets are built in; LD1/2/4 analogue = 8/16/32/... rows a tile
CANDIDATE_ROWS = (8, 16, 32, 64, 128, 256, 512)
# per-pass unroll factors swept by ``tune_unroll`` (the kernels are compiled
# for these)
CANDIDATE_UNROLLS = (1, 2, 4, 8)


@dataclass
class TuneResult:
    nbytes: int
    dtype: str
    mix: str
    best_rows: int
    table: dict  # rows -> GB/s
    best_unroll: int = 1
    unroll_table: dict | None = None    # unroll -> GB/s (at best_rows)
    unroll_audit: dict | None = None    # unroll -> waiver reason or None
    ecm: dict | None = None   # prefilter provenance: predicted / kept / pruned


def sweep_block_shapes(nbytes: int, mix: str = "load_sum",
                       dtype=torch.float32, reps: int = 8,
                       tune_unroll: bool = False, model=None,
                       ecm_keep: int | None = None,
                       runner=None) -> TuneResult:
    """Run the hand-written ``cuda`` membench kernels across block shapes
    via the bench Runner (one BenchSpec per candidate row count; C4 of the
    paper).  ``runner=None`` makes a ``Runner()`` on the default device
    (``cuda``); on a CPU runner the kernels' plain versions run.

    ``tune_unroll=True`` adds the second objective: at the winning block
    shape, sweep the per-pass unroll factor; a candidate whose (mix, cuda,
    unroll) combination carries an accounting waiver is timed and reported
    (``unroll_audit``) but never wins.  ``model`` + ``ecm_keep``: prune the
    candidate ladder with the ECM predictor before timing anything; the
    pruned rows and their predictions land in ``TuneResult.ecm``.
    """
    from repro_torch.bench import BenchSpec, Runner
    from repro_torch.core import buffers
    dtype_s = buffers.dtype_name(dtype)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    rows_total = buffers.working_set_shape(nbytes, dtype=dtype)[0]
    runner = runner or Runner()
    candidates = tuple(r for r in CANDIDATE_ROWS
                       if r <= rows_total and not rows_total % r)
    ecm_info = None
    if model is not None and ecm_keep:
        from repro_torch.audit.ecm import ecm_filter_rows
        kept, predicted = ecm_filter_rows(nbytes, model, candidates,
                                          keep=ecm_keep, mix=mix,
                                          itemsize=itemsize)
        ecm_info = {"predicted_gbps": predicted, "kept": list(kept),
                    "pruned": [r for r in candidates if r not in kept]}
        candidates = kept
    table = {}
    for rows in candidates:
        spec = BenchSpec(mixes=(mix,), sizes=(nbytes,), dtype=dtype_s,
                         backend="cuda", block_rows=rows, passes=1,
                         reps=reps, warmup=1)
        table[rows] = runner.run(spec).points[0].gbps
    best = max(table, key=table.get)
    best_unroll, unroll_table, unroll_audit = 1, None, None
    if tune_unroll:
        from repro_torch.audit.verify import waiver_reason
        from repro_torch.bench.mixes import get_mix
        mixdef = get_mix(mix)
        unroll_table, unroll_audit = {}, {}
        for u in CANDIDATE_UNROLLS:
            spec = BenchSpec(mixes=(mix,), sizes=(nbytes,), dtype=dtype_s,
                             backend="cuda", block_rows=best, passes=u,
                             unroll=u, reps=reps, warmup=1)
            unroll_table[u] = runner.run(spec).points[0].gbps
            unroll_audit[u] = waiver_reason(mixdef, "cuda", {"unroll": u})
        sound = [u for u in unroll_table if unroll_audit[u] is None]
        best_unroll = max(sound or unroll_table, key=unroll_table.get)
    return TuneResult(nbytes=nbytes, dtype=dtype_s, mix=mix,
                      best_rows=best, table=table,
                      best_unroll=best_unroll, unroll_table=unroll_table,
                      unroll_audit=unroll_audit, ecm=ecm_info)


def _innermost_capacity(model) -> int | None:
    """Innermost-level capacity from any machine-model flavor: a
    ``characterize.FittedMachineModel`` (detected), a ``HardwareSpec``
    (documented table), or a path to a fitted-model JSON."""
    if model is None:
        return None
    if isinstance(model, (str, Path)):
        from repro_torch.characterize.fit import FittedMachineModel
        model = FittedMachineModel.from_json(model)
    cap = getattr(model, "innermost_capacity", None)   # FittedMachineModel
    if cap:
        return int(cap)
    for lvl in getattr(model, "levels", ()):           # HardwareSpec
        size = getattr(lvl, "size_bytes", None)
        if size:
            return int(size)
    return None


def model_block_rows(model, lanes: int = 128, itemsize: int = 4,
                     default: int = 128) -> int:
    """Largest candidate row count whose block fits in HALF the machine's
    innermost level (detected by ``repro_torch.characterize`` or
    documented) — half, so the block plus its accumulator/companion stream
    stay resident.
    """
    cap = _innermost_capacity(model)
    if not cap:
        return default
    fitting = [r for r in CANDIDATE_ROWS if r * lanes * itemsize <= cap / 2]
    return max(fitting, default=CANDIDATE_ROWS[0])


def choose_block_rows(nbytes: int, cache_path: str | Path | None = None,
                      default: int = 128, model=None) -> int:
    """Consult a cached tune result; else size blocks against a machine
    model's measured innermost capacity (``model``: FittedMachineModel,
    HardwareSpec, or fitted-model JSON path); else the default."""
    if cache_path and Path(cache_path).exists():
        d = json.loads(Path(cache_path).read_text())
        return int(d.get("best_rows", default))
    if model is not None:
        return model_block_rows(model, default=default)
    return default


def choose_unroll(cache_path: str | Path | None = None,
                  default: int = 1) -> int:
    """The unroll companion to ``choose_block_rows``: consult a cached
    tune result that carries ``best_unroll``, else the no-unroll default
    (there is no model-derived fallback — issue width is fitted, not
    documented in the spec tables)."""
    if cache_path and Path(cache_path).exists():
        d = json.loads(Path(cache_path).read_text())
        return int(d.get("best_unroll", default))
    return default

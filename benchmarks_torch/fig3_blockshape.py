"""Fig 3 — registers-per-load-instruction (LD1D/LD2D/LD4D) => rows-per-block.

Counterpart of ``benchmarks/fig3_blockshape.py`` on the port.  One BenchSpec
per block shape (``block_rows`` = C4 knob) for the measured table — on the
``cuda`` backend ``acc.cu``'s load_sum over tiles of R rows, on ``torch``
the blocked-walk oracle — then the ECM self-calibration over the sweep's
instruction profiles (on ``cuda`` read from the SASS of the kernels this
checkout built, through ``istream``; on ``torch`` from the aten trace).
Last the kernel path: ``make_kernel("load_sum", block_rows=R)`` held
against the plain reference (``kernels/membench/ref.py``) at the
reference's 1e-2 — on the card ``acc.cu``, on the CPU the wrapper's plain
version; the printed line says which ran.

    PYTHONPATH=src:. python -m benchmarks_torch.fig3_blockshape --quick
"""
from __future__ import annotations

import argparse

from benchmarks_torch.common import add_device_flags, emit
from repro_torch.audit import validate_ecm
from repro_torch.bench import BenchSpec, BenchSpecError, Runner
from repro_torch.characterize.fit import FittedMachineModel, LevelFit
from repro_torch.core import buffers
from repro_torch.istream import ProfileCache, analyze_case, fit_issue_rate

#: the kernel path's working set and block shapes (the reference's)
KERNEL_CHECK_BYTES = 64 * 2**10
KERNEL_CHECK_ROWS = (8, 32, 128)


def spec_for(quick: bool = False, backend: str = "cuda") -> BenchSpec:
    nbytes = 4 * 2**20 if quick else 16 * 2**20
    return BenchSpec(mixes=("load_sum",), sizes=(nbytes,),
                     reps=5 if quick else 10, warmup=2,
                     target_bytes=5e7 if quick else 2e8, backend=backend)


def rows_for(quick: bool = False) -> tuple[int, ...]:
    return (8, 16, 32, 128) if quick else (8, 16, 32, 64, 128, 256, 512)


def row_name(rows: int, nbytes: int) -> str:
    return f"fig3/rows{rows}/{nbytes}B"


def ecm_row_name(rows: int) -> str:
    return f"fig3/ecm/rows{rows}"


def main(quick: bool = False, backend: str = "cuda", device: str = "cuda"):
    base = spec_for(quick, backend)
    (nbytes,) = base.sizes
    runner = Runner(device=device)          # raises without a CUDA device
    best = (None, 0.0)
    pairs = []          # (BenchPoint, InstructionProfile) across the sweep
    cache = ProfileCache()
    # the cuda profiles come from this checkout's SASS (cuobjdump on the
    # card's machine); one reader for the whole sweep
    sass = None
    if backend == "cuda" and runner.device.type == "cuda":
        from repro_torch.istream.analyze import LiveSass
        sass = LiveSass()
    shape = buffers.working_set_shape(nbytes)
    for rows in rows_for(quick):
        try:
            spec = base.replace(block_rows=rows)
            res = runner.run(spec)
        except BenchSpecError:     # rows not dividing this working set
            continue
        p = res.points[0]
        emit(row_name(rows, p.nbytes), p.mean_s * 1e6,
             f"{p.gbps:.2f}GB/s")
        try:
            pairs.append((p, analyze_case(spec, "load_sum", shape, "float32",
                                          p.passes, runner=runner,
                                          cache=cache, sass=sass)))
        except Exception as e:     # prediction is a bonus, never blocks fig3
            print(f"# ecm: profile extraction failed at rows={rows}: {e}")
        if p.gbps > best[1]:
            best = (rows, p.gbps)
    print(f"# best block rows on this device: {best[0]} ({best[1]:.1f} GB/s)")

    # ECM predicted-vs-measured over the very sweep just timed: the sweep
    # self-calibrates a one-level model (best sustained transfer rate +
    # fitted issue rate) and the predictor must then reproduce each point's
    # time from its profile alone.  The transfer term is calibrated in
    # OBSERVED bytes/s, as the reference does.
    if pairs:
        def _obs_bw(p, prof):
            per_pass = (prof.per_iter["loads"] + prof.per_iter["stores"]) \
                / max(prof.unroll, 1) * 4
            return per_pass * p.passes / p.mean_s
        model = FittedMachineModel(
            name="fig3-self-calibrated",
            levels=(LevelFit(
                name="mem", capacity_bytes=None, capacity_ci=None,
                bandwidth={"load_sum": {
                    "gbps": max(_obs_bw(p, pr) for p, pr in pairs) / 1e9,
                    "ci": None, "n": len(pairs)}}),),
            issue={"rate_elems_per_s": fit_issue_rate(pairs)})
        val = validate_ecm(pairs, model)
        for r in val["rows"]:
            emit(ecm_row_name(r["knobs"]["block_rows"]),
                 r["predicted_s"] * 1e6,
                 f"meas={r['measured_s'] * 1e6:.1f}us "
                 f"err={r['rel_err'] * 100:+.1f}% {r['bound']}-bound")
        print(f"# ecm predicted-vs-measured over {val['n']} block shapes: "
              f"median |rel err| {val['median_abs_rel_err'] * 100:.1f}%, "
              f"max {val['max_abs_rel_err'] * 100:.1f}%")

    # kernel path: the same spec shape on the cuda backend, each block
    # shape's kernel held against the plain reference
    from repro_torch.kernels.membench import ops as mb_ops
    from repro_torch.kernels.membench.ref import reference
    small = base.replace(sizes=(KERNEL_CHECK_BYTES,), backend="cuda",
                         passes=1, reps=2, warmup=1)
    xs = buffers.working_set(KERNEL_CHECK_BYTES, device=runner.device)
    for rows in KERNEL_CHECK_ROWS:
        runner.run(small.replace(block_rows=rows))      # runs through Runner
        out = float(mb_ops.make_kernel("load_sum", block_rows=rows)(xs))
        ref = float(reference("load_sum", xs))
        if not abs(out - ref) < 1e-2:
            raise AssertionError(f"block_rows={rows}: kernel {out} against "
                                 f"the reference {ref}")
    what = ("acc.cu on " + str(runner.device)
            if runner.device.type == "cuda"
            else "the wrappers' plain versions on the CPU")
    print(f"# cuda block-shape kernels verified vs oracle ({what})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    add_device_flags(ap)
    main(**vars(ap.parse_args()))

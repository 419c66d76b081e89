"""``python -m repro_torch.bench`` — run / list-mixes / compare /
characterize / istream / audit / latency / launch / history / diff.

    run         execute a BenchSpec (flags or --spec JSON), print + save the
                schema-versioned result JSON; under a multi-process launch
                (REPRO_NUM_PROCESSES et al.) it starts the torch.distributed
                process group (gloo on the CPU, NCCL on CUDA), gathers
                timings across processes, and saves from process 0
    list-mixes  the shared mix registry with its bytes/flops accounting
    compare     the same spec on several backends, side by side
    characterize  adaptive fine-granularity sweep -> detected topology ->
                FittedMachineModel JSON + markdown report
                (repro_torch.characterize)
    istream     instruction-stream microscope: unroll x interleave sweep ->
                per-case profiles (cuda: the SASS its launches execute;
                torch: the aten operations) -> bandwidth-vs-issue-bound
                classification + fig6 table (repro_torch.istream)
    audit       static accounting verifier: declared bytes/flops vs what runs
                (the kernels' SASS, the oracles' aten operations) for every
                mix x backend x knob combination, no timing; exit 0 clean,
                2 on violation (repro_torch.audit)
    latency     loaded-latency surface: the latency_chase probe across the
                load axis -> bandwidth-latency curve + knee fit; --smoke
                also audits the chase on both backends (exit 2 otherwise)
    launch      spawn N coordinated local processes running ``run --backend
                distributed``, each with its own devices (logical CPU
                devices, or its own GPUs) — one machine running a
                multi-process Fig-4 scaling study
    history     list the persistent run ledger (BENCH_history/); --add
                ingests a saved result JSON as a record (repro_torch.obs.ledger)
    diff        noise-aware bandwidth comparison against a ledger baseline
                (characterize.detect two-sample test); exit 2 on regression

Every command that measures takes ``--device`` (default ``cuda``; with no
CUDA device present the default raises — pass ``--device cpu`` to run the
plain PyTorch versions on the CPU).  ``run``, ``characterize`` and
``latency`` take ``--trace PATH`` (span tracing -> Perfetto JSON), append a
ledger record unless ``--no-ledger``, and refuse to overwrite an existing
``--out``/``--report`` file unless ``--force``.

Counterpart of ``repro.bench.cli``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.bench.mixes import registry
from repro_torch.bench.runner import Runner
from repro_torch.bench.spec import BenchSpec, BenchSpecError, quick_spec
from repro_torch.obs import ledger, trace


def row_name(backend: str, mix: str, nbytes: int) -> str:
    """The name of a point's ``name,us_per_call,derived`` line."""
    return f"{backend}/{mix}/{nbytes}B"


def _parse_sizes(s: str) -> tuple[int, ...]:
    """'32768,1M,16M' -> bytes (supports K/M/G suffixes)."""
    out = []
    for tok in s.split(","):
        tok = tok.strip()
        mult = {"K": 2**10, "M": 2**20, "G": 2**30}.get(tok[-1:].upper(), 1)
        out.append(int(float(tok[:-1]) * mult) if mult != 1 else int(tok))
    return tuple(out)


def _spec_from_args(args) -> BenchSpec:
    if args.spec:
        return BenchSpec.from_json(args.spec)
    kw = {}
    if args.mixes is not None:
        kw["mixes"] = tuple(args.mixes.split(","))
    if args.sizes is not None:
        kw["sizes"] = _parse_sizes(args.sizes)
    # `is not None`: an explicit 0 must reach BenchSpec validation, not be
    # silently treated as "flag absent"
    for knob in ("reps", "streams", "devices", "block_rows", "dtype",
                 "unroll", "interleave", "load"):
        if getattr(args, knob, None) is not None:
            kw[knob] = getattr(args, knob)
    if args.quick:
        return quick_spec(backend=args.backend, **kw)
    return BenchSpec(backend=args.backend, **kw)


def _add_spec_flags(p: argparse.ArgumentParser):
    p.add_argument("--spec", default=None,
                   help="path to a BenchSpec JSON (overrides other flags)")
    p.add_argument("--quick", action="store_true",
                   help="small sizes / few reps smoke preset")
    p.add_argument("--backend", default="cuda",
                   help="torch | cuda | sharded | distributed (the mesh "
                        "backends run the torch oracles per shard, but a "
                        "latency_chase walk on a CUDA shard launches "
                        "chase.cu; on the CPU it is the host walk)")
    p.add_argument("--mixes", "--mix", default=None,
                   help="comma list, e.g. load_sum,copy,fma_8")
    p.add_argument("--sizes", default=None, help="comma list, K/M/G ok: 32K,2M")
    p.add_argument("--reps", type=int, default=None)
    p.add_argument("--streams", type=int, default=None)
    p.add_argument("--devices", type=int, default=None,
                   help="mesh devices the working set spreads over "
                        "(multi-device backends: sharded, distributed)")
    p.add_argument("--block-rows", dest="block_rows", type=int, default=None)
    p.add_argument("--dtype", default=None)
    p.add_argument("--unroll", type=int, default=None,
                   help="per-pass unroll factor (istream knob)")
    p.add_argument("--interleave", type=int, default=None,
                   help="independent dependence chains (istream knob)")
    p.add_argument("--load", type=int, default=None,
                   help="co-scheduled bandwidth generators next to the "
                        "latency probe (latency_chase only; 0 = idle)")
    p.add_argument("--device", default=None,
                   help="torch device the run uses (default: cuda; raises "
                        "when no CUDA device is present — pass 'cpu' to run "
                        "the plain PyTorch versions on the CPU)")


def _add_grid_flags(p: argparse.ArgumentParser):
    """The knob-grid flags shared by ``istream`` (with timing) and
    ``audit`` (without), as in the reference."""
    p.add_argument("--backends", "--backend", default=None,
                   help="comma list (default: torch,cuda)")
    p.add_argument("--mixes", "--mix", default=None,
                   help="comma list (default: per-command representative set)")
    p.add_argument("--sizes", default=None,
                   help="comma list, K/M/G ok: 64K,1M")
    p.add_argument("--unrolls", default=None,
                   help="comma list of unroll factors")
    p.add_argument("--interleaves", default=None,
                   help="comma list of chain counts")


def _add_obs_flags(p: argparse.ArgumentParser):
    """Observability flags shared by every measuring command."""
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="enable span tracing; write a Perfetto-loadable "
                        "Chrome trace JSON (or .jsonl event log) here")
    p.add_argument("--force", action="store_true",
                   help="overwrite existing output files (refused otherwise)")
    p.add_argument("--no-ledger", dest="no_ledger", action="store_true",
                   help="skip appending this run to the history ledger")
    p.add_argument("--history-root", dest="history_root", default=None,
                   help=f"ledger directory (default: ${ledger.LEDGER_ENV} "
                        f"or {ledger.DEFAULT_ROOT}/)")


def _check_overwrite(args, *attrs: str) -> None:
    """Refuse to clobber an existing output file unless --force — checked
    BEFORE the (possibly minutes-long) measurement, not after."""
    for a in attrs:
        path = getattr(args, a, None)
        if path and os.path.exists(path) and not getattr(args, "force", False):
            raise BenchSpecError(
                f"refusing to overwrite existing {path!r}; pass --force")


def _obs_begin(args) -> None:
    if getattr(args, "trace", None):
        trace.configure(enabled=True, clear=True)


def _obs_finish(args, res, cmd: str) -> None:
    """Write the trace and append the run's ledger record (call on the
    primary process only — the distributed gather has already merged the
    other processes' events into this tracer)."""
    trace_path = None
    if getattr(args, "trace", None):
        tr = trace.get_tracer()
        trace_path = tr.write(args.trace)
        print(f"# saved trace ({len(tr.events())} events) -> {trace_path}")
    if not getattr(args, "no_ledger", False):
        path, rec = ledger.append_record(
            res, cmd=cmd, trace_path=trace_path,
            out_path=getattr(args, "out", None),
            root=getattr(args, "history_root", None))
        print(f"# ledger += {rec['spec_digest']} "
              f"({len(rec['curves'])} cells) -> {path}")


def cmd_run(args) -> int:
    _check_overwrite(args, "out")
    from repro_torch.bench import distributed as dist
    runner = Runner(device=args.device)     # raises without a CUDA device
    # the process group must exist before the spec's mesh is checked; a
    # no-op outside a multi-process launch
    dist.ensure_initialized(runner.device)
    _obs_begin(args)
    spec = _spec_from_args(args)
    res = dist.gather_result(runner.run(spec))
    if not dist.is_primary():
        print(f"# process {dist.process_index()}/{dist.process_count()} "
              f"done ({len(res.points)} points gathered by process 0)")
        return 0
    _obs_finish(args, res, "run")
    text = res.to_json(args.out)
    if args.out:
        for p in res.points:
            print(f"{row_name(p.backend, p.mix, p.nbytes)},"
                  f"{p.mean_s * 1e6:.2f},{p.gbps:.2f}GB/s")
        print(f"# saved {len(res.points)} points (schema v{res.schema_version})"
              f" -> {args.out}")
    else:
        print(text)
    return 0


def cmd_list_mixes(args) -> int:
    from repro_torch.bench.mixes import MAX_RW, mix_names
    reg = registry()
    print(f"{'mix':10s} {'flops/elem':>10s} {'reads':>6s} {'writes':>6s}  "
          f"{'backends':16s} description")
    for name in mix_names():     # deterministic: family parameter, then name
        m = reg[name]
        print(f"{name:10s} {m.flops_per_elem:10.1f} {m.reads_per_elem:6.1f} "
              f"{m.writes_per_elem:6.1f}  {'+'.join(m.backends):16s} "
              f"{m.description}")
    print(f"# open-ended families: fma_k (any k >= 1), rw_RtoW "
          f"(any R, W in 1..{MAX_RW}); the table lists the canonical ladders")
    return 0


def cmd_compare(args) -> int:
    _check_overwrite(args, "out")
    runner = Runner(device=args.device)
    backends = tuple(args.backends.split(","))
    if args.spec:
        spec = BenchSpec.from_json(args.spec)
    else:
        # the requested mix set may be runnable by only some of the backends
        # (e.g. load_only): construct the base spec against the first backend
        # that accepts it in full; Runner.compare filters per backend
        spec, err = None, None
        for b in backends:
            args.backend = b
            try:
                spec = _spec_from_args(args)
                break
            except BenchSpecError as e:
                err = e
        if spec is None:
            raise err or BenchSpecError("no runnable spec")
    results = runner.compare(spec, backends=backends)
    print(f"{'mix':10s} {'nbytes':>12s} " +
          " ".join(f"{b + ' GB/s':>14s}" for b in results))
    rows: dict[tuple, dict] = {}
    for b, res in results.items():
        for p in res.points:
            rows.setdefault((p.mix, p.nbytes), {})[b] = p
    mismatch = False
    for (mix, nbytes), per in sorted(rows.items()):
        cells = [f"{per[b].gbps:14.2f}" if b in per else f"{'-':>14s}"
                 for b in results]
        print(f"{mix:10s} {nbytes:12d} " + " ".join(cells))
        acct = {(p.bytes_per_call, p.flops_per_call, p.passes)
                for p in per.values()}
        if len(acct) > 1:
            mismatch = True
            print(f"  !! accounting mismatch for {mix}: {acct}")
    skipped = next(iter(results.values())).meta.get("skipped", {})
    for b, items in sorted(skipped.items()):
        for mix, reason in items:
            print(f"# skipped {b}/{mix}: {reason}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({b: r.to_dict() for b, r in results.items()}, f,
                      indent=2)
        print(f"# saved -> {args.out}")
    return 1 if mismatch else 0


#: ``characterize``'s presets, the reference's: sweep keywords of
#: ``characterize.characterize`` and the mixes (the first drives detection).
#: ``smoke``: copy drives detection — its store stream keeps the big-size
#: points memory-bound, so the cache cliffs are sharpest where the coarse
#: grid is thinnest (and its resolution is at least 0.35).
CHARACTERIZE_PRESETS = {
    "smoke": (dict(lo=16 * 2**10, hi=64 * 2**20, coarse_per_decade=2,
                   max_rounds=2, reps=5, warmup=1, target_bytes=3e7),
              ("copy", "load_sum")),
    "full": (dict(coarse_per_decade=4, reps=10, warmup=2, target_bytes=2e8,
                  hi=256 * 2**20),
             ("load_sum", "copy", "fma_1", "fma_2", "fma_8", "fma_32",
              "fma_64")),
    "default": (dict(coarse_per_decade=3, reps=5, warmup=1,
                     target_bytes=5e7),
                ("load_sum", "copy", "fma_8", "fma_32")),
}


def cmd_characterize(args) -> int:
    """Measurement-driven machine characterization: adaptive fine-granularity
    sweep -> change-point detection -> FittedMachineModel + report (see
    repro_torch.characterize).  ``--smoke`` is the fast preset (coarse grid,
    one refinement round); ``--full`` the paper-grade sweep.  The presets
    are the reference's; on a CUDA device the prior is the card's
    (``core.machine_model.detect_device``), elsewhere the host's sysfs."""
    from repro_torch.characterize import (characterize, render_markdown,
                                          write_report)
    from repro_torch.core.machine_model import get_spec

    _check_overwrite(args, "out", "report")
    runner = Runner(device=args.device)     # raises without a CUDA device
    _obs_begin(args)
    kw: dict = dict(backend=args.backend, resolution=args.resolution,
                    max_rounds=args.max_rounds)
    preset = "smoke" if args.smoke else "full" if args.full else "default"
    sweep_kw, mixes = CHARACTERIZE_PRESETS[preset]
    kw.update(sweep_kw)
    if args.smoke:
        kw["resolution"] = max(args.resolution, 0.35)
    if args.mixes:
        mixes = tuple(args.mixes.split(","))

    model, sweep = characterize(mixes=mixes, primary=mixes[0], runner=runner,
                                **kw)
    _obs_finish(args, sweep.result, "characterize")
    documented = get_spec(args.compare) if args.compare else None
    print(render_markdown(model, sweep, documented))
    if args.out:
        model.to_json(args.out)
        print(f"# saved fitted model (schema v{model.schema_version}, "
              f"{len(model.levels)} levels) -> {args.out}")
    if args.report:
        write_report(model, args.report, sweep, documented)
        print(f"# saved report -> {args.report}")
    return 0


def cmd_istream(args) -> int:
    """Instruction-stream sweep + classification (see repro_torch.istream):
    runs the unroll x interleave grid on the requested backends and mixes,
    observes each case's profile (cuda: the SASS its launches execute, from
    the libraries built from this checkout, which needs the CUDA toolkit;
    torch: its aten operations), labels every point bandwidth-bound vs
    issue-bound and prints the fig6 table.  ``--smoke`` first runs the
    synthetic classifier self-test (it must see BOTH labels), then a
    seconds-scale sweep.  On a CUDA device the card's issue ceiling (SMs x
    4 warp instructions a clock x clocks.max.sm) is printed beside cuda's
    fitted rate."""
    from repro_torch.istream import run_istream, synthetic_check

    _check_overwrite(args, "out")
    runner = Runner(device=args.device)     # raises without a CUDA device
    _obs_begin(args)
    if args.smoke:
        chk = synthetic_check()
        print(f"# synthetic check: {chk['labels']} "
              f"(issue rate {chk['issue_rate']:.3e} elem-ops/s)")
        if not chk["ok"]:
            print("error: synthetic classifier check failed "
                  f"({chk})", file=sys.stderr)
            return 2
    model = None
    if args.model:
        from repro_torch.characterize.fit import FittedMachineModel
        model = FittedMachineModel.from_json(args.model)
    kw: dict = dict(smoke=args.smoke, model=model, runner=runner)
    if args.backends:
        kw["backends"] = tuple(args.backends.split(","))
    if args.mixes:
        kw["mixes"] = tuple(args.mixes.split(","))
    if args.sizes:
        kw["sizes"] = _parse_sizes(args.sizes)
    if args.unrolls:
        kw["unrolls"] = tuple(int(u) for u in args.unrolls.split(","))
    if args.interleaves:
        kw["interleaves"] = tuple(int(i) for i in args.interleaves.split(","))
    if args.reps is not None:
        kw["reps"] = args.reps
    report = run_istream(**kw)
    _obs_finish(args, report.result, "istream")
    print(report.table)
    rates = report.result.meta["istream"]["issue_rates"]
    if "cuda" in rates and runner.device.type == "cuda":
        from repro_torch.audit.ecm import issue_ceiling
        from repro_torch.istream.analyze import card_clock_mhz, machine_of
        sms = machine_of(runner.device)[0]
        mhz = card_clock_mhz()
        print(f"# cuda issue: fitted {rates['cuda']:.3e} warp instructions/s"
              f", ceiling {issue_ceiling(sms, mhz):.3e} ({sms} SMs x 4 a "
              f"clock x {mhz:.0f} MHz)")
    labels = report.labels
    if args.out:
        report.result.to_json(args.out)
        print(f"# saved {len(report.result.points)} classified points "
              f"(schema v{report.result.schema_version}) -> {args.out}")
    if args.smoke and (not labels.get("issue-bound")
                       or not labels.get("bandwidth-bound")):
        print(f"# note: measured sweep was one-sided ({labels}); "
              f"synthetic check covered both labels")
    return 0


def cmd_audit(args) -> int:
    """Static accounting audit (see repro_torch.audit): declared
    bytes/flops vs what runs, for every registered mix x backend x knob
    combination.  Exit 0 clean, 2 on any violation (each named by its
    backend/mix/knob triple).  The live cuda audit reads the SASS of the
    libraries built from this checkout and raises, naming it, where
    ``cuobjdump`` is missing; ``--goldens DIR`` audits committed SASS and
    aten traces instead (deviceless), ``--write-goldens DIR`` writes them
    (on the card)."""
    from repro_torch.audit import audit_goldens, audit_registry, write_goldens

    _check_overwrite(args, "out")
    if args.write_goldens:
        manifest = write_goldens(args.write_goldens)
        print(f"# wrote {len(manifest['cases'])} golden cases (the SASS of "
              f"their libraries, their aten traces) -> {args.write_goldens}")
        return 0
    if args.goldens:
        report = audit_goldens(args.goldens)
    else:
        kw: dict = dict(smoke=args.smoke, rw_pairs=args.rw_pairs,
                        seed=args.seed)
        if args.backends:
            kw["backends"] = tuple(args.backends.split(","))
        if args.mixes:
            kw["mixes"] = tuple(args.mixes.split(","))
        if args.sizes:
            nbytes = _parse_sizes(args.sizes)[0]
            kw["shape"] = (max(nbytes // (128 * 4), 8), 128)
        if args.unrolls or args.interleaves:
            grid = [{}]
            grid += [{"unroll": int(u)}
                     for u in (args.unrolls or "").split(",") if u and int(u) > 1]
            grid += [{"interleave": int(i)}
                     for i in (args.interleaves or "").split(",")
                     if i and int(i) > 1]
            kw["knob_grid"] = grid
        report = audit_registry(**kw)
    if args.json:
        print(report.to_json())
    else:
        print(report.table())
    for c in report.waived:
        print(f"# waived {c.where()}: {c.waived_reason}")
    if args.out:
        report.to_json(args.out)
        print(f"# saved audit report ({len(report.cases)} cases) "
              f"-> {args.out}")
    for v in report.violations:
        print(f"error: accounting violation at {v.where()}: "
              + "; ".join(f"{c.name}: {c.detail}" for c in v.failures),
              file=sys.stderr)
    return report.exit_code()


#: the chase audits of ``latency --smoke``: the reference's shape, dtype
#: and passes, at load 0 and 1
CHASE_AUDIT = {"shape": (64, 128), "dtype": "float32", "passes": 4,
               "loads": (0, 1)}
#: where the committed SASS goldens live (``audit --write-goldens``)
GOLDENS = "tests/data_torch/sass"


def chase_audits(device) -> list[tuple]:
    """(CaseAudit, source) of latency_chase on torch and cuda at load 0 and
    1.  torch is observed live (meta tensors); cuda reads the SASS of the
    libraries built from this checkout on a CUDA device (``live``), and the
    committed goldens elsewhere (``goldens``)."""
    from repro_torch.audit.verify import audit_case, audit_sass
    from repro_torch.istream.extract import parse_sass
    from repro_torch.kernels.build import ROOT
    shape, dtype, passes = (CHASE_AUDIT[k] for k in ("shape", "dtype",
                                                     "passes"))
    nbytes = shape[0] * shape[1] * 4
    out = []
    for backend in ("torch", "cuda"):
        for load in CHASE_AUDIT["loads"]:
            spec = BenchSpec(mixes=("latency_chase",), sizes=(nbytes,),
                             backend=backend, passes=passes, reps=2,
                             warmup=0, load=load)
            if backend == "torch" or device.type == "cuda":
                out.append((audit_case(spec, "latency_chase", shape, dtype,
                                       passes), "live"))
                continue
            golden = ROOT / GOLDENS
            manifest = json.loads((golden / "manifest.json").read_text())
            case = next(c for c in manifest["cases"]
                        if c["backend"] == "cuda"
                        and c["mix"] == "latency_chase"
                        and (c.get("knobs") or {}).get("load", 0) == load)
            sass = {p.stem: parse_sass(p.read_text())
                    for p in golden.glob("*.sass")}
            out.append((audit_sass(sass, "latency_chase", shape, dtype,
                                   passes, knobs={"load": load},
                                   machine=(manifest["sms"], manifest["l2"]),
                                   launches=case["launches"]), "goldens"))
    return out


def cmd_latency(args) -> int:
    """Loaded-latency surface (see characterize.loaded): sweep the
    ``latency_chase`` probe across the ``load`` axis at each working-set
    size, fit the bandwidth–latency knee, print the curve, save the result.
    ``--smoke`` is the small preset (one 128 KiB size, loads 0,1,2, 3 reps)
    plus the reference's inline accounting audit of the chase on BOTH
    backends at load 0 and 1 (``chase_audits``), which must come back
    checked — never waived — and clean (exit 2 otherwise)."""
    from repro_torch.characterize.loaded import (fit_loaded,
                                                 loaded_latency_sweep)

    _check_overwrite(args, "out")
    runner = Runner(device=args.device)     # raises without a CUDA device
    _obs_begin(args)
    sizes = _parse_sizes(args.sizes) if args.sizes else \
        ((128 * 2**10,) if args.smoke else (128 * 2**10, 16 * 2**20))
    loads = tuple(int(tok) for tok in args.loads.split(",")) if args.loads \
        else ((0, 1, 2) if args.smoke else (0, 1, 2, 4))
    reps = args.reps if args.reps is not None else (3 if args.smoke else 5)
    res = loaded_latency_sweep(sizes, loads, backend=args.backend,
                               runner=runner, reps=reps)
    fit = fit_loaded(res)
    if fit:
        res.meta["loaded_latency"]["fit"] = fit

    print(f"{'nbytes':>12s} {'load':>4s} {'latency ns':>10s} {'gen GB/s':>9s}")
    for p in res.points:
        print(f"{p.nbytes:12d} {p.load:4d} {p.latency_ns:10.2f} "
              f"{p.gen_gbps:9.2f}")
    for name, knee in ((fit or {}).get("levels") or {}).items():
        print(f"# {name}: idle {knee['idle_latency_ns']:.1f} ns, knee at "
              f"load={knee['knee_load']} ({knee['knee_gen_gbps']:.2f} GB/s "
              f"generated), max {knee['max_latency_ns']:.1f} ns")
    rc = 0
    if args.smoke:
        audits = chase_audits(runner.device)
        for a, source in audits:
            print(f"# audit {a.where()} ({source}): "
                  f"{'waived' if a.waived else 'ok' if a.ok else 'FAIL'}")
        res.meta["audit"] = [dict(a.to_dict(), source=source)
                             for a, source in audits]
        if any(a.waived or not a.ok for a, _ in audits):
            print("error: latency_chase accounting must be checked clean on "
                  "both backends (got a waiver or violation)", file=sys.stderr)
            rc = 2
    _obs_finish(args, res, "latency")
    if args.out:
        res.to_json(args.out)
        print(f"# saved {len(res.points)} points "
              f"(schema v{res.schema_version}) -> {args.out}")
    return rc


def cmd_launch(args) -> int:
    """Spawn N coordinated local processes running ``run`` with the same
    spec flags (see bench.distributed.launch_local).  All children share one
    argv — ``cmd_run`` gates the ``--out`` write on process 0, which holds
    the gathered result; the others report and exit.  The workers run on
    ``--device`` (default cuda: one process per GPU slice, NCCL; ``cpu``:
    logical CPU devices, gloo)."""
    from pathlib import Path

    from repro_torch.bench import distributed as dist
    if any(f == "--spec" or f.startswith("--spec=")
           for f in args.worker_flags):
        # a spec file short-circuits _spec_from_args, silently discarding
        # the injected --backend/--devices below — the workers would run
        # the file's backend single-process and the 'gathered' result would
        # be wrong; demand explicit flags instead
        raise BenchSpecError(
            "launch does not accept --spec (the file's backend/devices "
            "would override the injected distributed defaults); pass the "
            "spec as explicit flags (--mixes/--sizes/--devices/...)")
    worker = [sys.executable, "-m", "repro_torch.bench", "run",
              "--backend", args.backend] + list(args.worker_flags)
    if args.device is not None:
        worker += ["--device", args.device]
    if not any(f == "--devices" or f.startswith("--devices=")
               for f in args.worker_flags):
        # default to the full mesh: every process must own a mesh shard
        # (the backend rejects a mesh that leaves a process out).  Appended,
        # so it must not shadow either user spelling — argparse takes the
        # LAST occurrence
        worker += ["--devices",
                   str(args.processes * args.devices_per_process)]
    if args.out:
        worker += ["--out", args.out]
    # the workers import this package from where this process found it
    src = str(Path(__file__).resolve().parents[2])
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=src + (os.pathsep + path if path
                                             else ""))
    return dist.launch_local(worker, processes=args.processes,
                             devices_per_process=args.devices_per_process,
                             env=env, timeout=args.timeout or None,
                             device=args.device)


def cmd_history(args) -> int:
    """List the persistent run ledger (see repro_torch.obs.ledger).
    ``--add`` first ingests a file — a saved ledger record or a full
    BenchResult JSON (summarized on the fly)."""
    root = args.history_root
    if args.add:
        rec = ledger.resolve_ref(args.add, root=root)
        path, rec = ledger.append_record(rec, root=root)
        print(f"# ledger += {rec['spec_digest']} "
              f"({len(rec.get('curves') or [])} cells) -> {path}")
    records = ledger.read_ledger(root)
    if args.json:
        print(json.dumps(records, indent=1))
        return 0
    if not records:
        print(f"# empty ledger at {ledger.ledger_root(root)}")
        return 0
    import datetime
    print(f"{'idx':>3s} {'when':19s} {'cmd':12s} {'digest':12s} "
          f"{'backend':11s} {'cells':>5s} mixes")
    for i, r in enumerate(records):
        t = datetime.datetime.fromtimestamp(r.get("time_unix_s", 0))
        print(f"{i:3d} {t:%Y-%m-%d %H:%M:%S} {r.get('cmd', '?'):12s} "
              f"{r.get('spec_digest', '?'):12s} "
              f"{str(r.get('backend') or '-'):11s} "
              f"{len(r.get('curves') or []):5d} "
              f"{','.join(r.get('mixes') or [])}")
    return 0


def cmd_diff(args) -> int:
    """Noise-aware bandwidth diff against a ledger baseline (see
    repro_torch.obs.ledger.diff_records): per curve cell, the two-sample
    log-bandwidth test of ``characterize.detect.significant_step``.
    Exit 0 when nothing significantly dropped, 2 on regression."""
    root = args.history_root
    base = ledger.resolve_ref(args.baseline, root=root)
    cur = ledger.resolve_ref(args.current, root=root)
    report = ledger.diff_records(base, cur, z=args.z,
                                 tolerance=args.tolerance)
    if args.json:
        print(json.dumps(report.to_dict(), indent=1))
    else:
        print(report.table())
    for r in report.regressions:
        print(f"error: bandwidth regression at {r['cell']}: "
              f"{r['base_gbps']:.2f} -> {r['cur_gbps']:.2f} GB/s "
              f"(ratio {r['ratio']:.3f})", file=sys.stderr)
    return report.exit_code()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench",
                                 description=__doc__, allow_abbrev=False,
                                 formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="execute a BenchSpec",
                           allow_abbrev=False)
    _add_spec_flags(p_run)
    p_run.add_argument("--out", default=None, help="write result JSON here")
    _add_obs_flags(p_run)
    p_run.set_defaults(fn=cmd_run)

    p_list = sub.add_parser("list-mixes", help="show the mix registry")
    p_list.set_defaults(fn=cmd_list_mixes)

    p_cmp = sub.add_parser("compare", help="same spec on several backends",
                           allow_abbrev=False)
    _add_spec_flags(p_cmp)
    p_cmp.add_argument("--backends", default="torch,cuda")
    p_cmp.add_argument("--out", default=None)
    p_cmp.add_argument("--force", action="store_true",
                       help="overwrite an existing --out file")
    p_cmp.set_defaults(fn=cmd_compare)

    p_chz = sub.add_parser(
        "characterize",
        help="adaptive sweep -> detected topology -> fitted machine model",
        allow_abbrev=False)
    mode = p_chz.add_mutually_exclusive_group()
    mode.add_argument("--smoke", action="store_true",
                      help="fast preset: coarse grid, minimal refinement")
    mode.add_argument("--full", action="store_true",
                      help="paper-grade sweep (slow)")
    p_chz.add_argument("--backend", default="cuda",
                       help="measurement backend (cuda | torch)")
    p_chz.add_argument("--resolution", type=float, default=0.10,
                       help="target relative width of capacity brackets")
    p_chz.add_argument("--max-rounds", dest="max_rounds", type=int, default=8)
    p_chz.add_argument("--mixes", "--mix", default=None,
                       help="comma list; first is the detection-driving mix")
    p_chz.add_argument("--compare", default=None,
                       help="documented spec to diff against (e.g. "
                            "nvidia-h100-sxm, fujitsu-a64fx, host)")
    p_chz.add_argument("--device", default=None,
                       help="torch device (default: cuda; raises when no "
                            "CUDA device is present — pass 'cpu' to run the "
                            "plain PyTorch versions on the CPU)")
    p_chz.add_argument("--out", default=None,
                       help="write the FittedMachineModel JSON here")
    p_chz.add_argument("--report", default=None,
                       help="write a markdown (.md) or JSON (.json) report")
    _add_obs_flags(p_chz)
    p_chz.set_defaults(fn=cmd_characterize)

    p_ist = sub.add_parser(
        "istream",
        help="unroll x interleave sweep -> per-case instruction profiles -> "
             "bandwidth-vs-issue-bound classification (fig6)",
        allow_abbrev=False)
    p_ist.add_argument("--smoke", action="store_true",
                       help="synthetic classifier self-test + seconds-scale "
                            "end-to-end sweep")
    _add_grid_flags(p_ist)
    p_ist.add_argument("--reps", type=int, default=None)
    p_ist.add_argument("--model", default=None,
                       help="FittedMachineModel JSON for bandwidth lookup "
                            "(else self-calibrated from the sweep)")
    p_ist.add_argument("--device", default=None,
                       help="torch device (default: cuda; raises when no "
                            "CUDA device is present — pass 'cpu' to run the "
                            "plain PyTorch versions on the CPU)")
    p_ist.add_argument("--out", default=None,
                       help="write the classified result JSON here")
    _add_obs_flags(p_ist)
    p_ist.set_defaults(fn=cmd_istream)

    p_aud = sub.add_parser(
        "audit",
        help="declared vs observed accounting (exit 2 on violation; see "
             "repro_torch.audit)",
        allow_abbrev=False)
    p_aud.add_argument("--smoke", action="store_true",
                       help="representative mixes, base + unroll + load knobs")
    _add_grid_flags(p_aud)
    p_aud.add_argument("--rw-pairs", dest="rw_pairs", type=int, default=0,
                       help="additionally audit N random rw_RtoW members")
    p_aud.add_argument("--seed", type=int, default=0,
                       help="seed for --rw-pairs sampling")
    p_aud.add_argument("--goldens", default=None,
                       help="audit committed SASS and aten traces in this "
                            "directory (deviceless; e.g. "
                            "tests/data_torch/sass)")
    p_aud.add_argument("--write-goldens", dest="write_goldens", default=None,
                       help="write the golden SASS and traces here (on the "
                            "card)")
    p_aud.add_argument("--json", action="store_true",
                       help="print the full JSON report instead of the table")
    p_aud.add_argument("--out", default=None,
                       help="write the audit report JSON here")
    p_aud.add_argument("--force", action="store_true",
                       help="overwrite an existing --out file")
    p_aud.set_defaults(fn=cmd_audit)

    p_lat = sub.add_parser(
        "latency",
        help="loaded-latency surface: latency_chase across the load axis "
             "(Mess-style bandwidth-latency curves; see characterize.loaded)",
        allow_abbrev=False)
    p_lat.add_argument("--smoke", action="store_true",
                       help="small preset: one 128K size, loads 0,1,2, 3 "
                            "reps, plus an inline both-backend chase "
                            "accounting audit")
    p_lat.add_argument("--backend", default="cuda",
                       help="cuda | torch (both: the single-device "
                            "time-shared composite; torch walks the chain "
                            "in a host loop, so its latency_ns is no "
                            "memory latency; the sharded mesh composite, "
                            "through run --devices N --load N-1, walks "
                            "chase.cu on a CUDA shard 0)")
    p_lat.add_argument("--sizes", default=None,
                       help="comma list, K/M/G ok (default: 128K smoke, "
                            "128K,16M full)")
    p_lat.add_argument("--loads", default=None,
                       help="comma list of generator counts "
                            "(default: 0,1,2 smoke, 0,1,2,4 full)")
    p_lat.add_argument("--reps", type=int, default=None)
    p_lat.add_argument("--device", default=None,
                       help="torch device (default: cuda; raises when no "
                            "CUDA device is present — pass 'cpu' to run the "
                            "plain PyTorch versions on the CPU)")
    p_lat.add_argument("--out", default=None,
                       help="write the result JSON here")
    _add_obs_flags(p_lat)
    p_lat.set_defaults(fn=cmd_latency)

    p_launch = sub.add_parser(
        "launch", help="N coordinated local processes (a multi-process "
                       "mesh on one machine)",
        allow_abbrev=False)
    p_launch.add_argument("--processes", type=int, default=2,
                          help="processes (one per host on a cluster)")
    p_launch.add_argument("--devices-per-process", dest="devices_per_process",
                          type=int, default=1,
                          help="devices each process gets (GPUs of its own, "
                               "or logical CPU devices); the global mesh has "
                               "processes * this many devices")
    p_launch.add_argument("--backend", default="distributed",
                          help="worker backend (default: distributed)")
    p_launch.add_argument("--device", default=None,
                          help="the workers' device (default: cuda, NCCL; "
                               "'cpu': logical CPU devices, gloo)")
    p_launch.add_argument("--timeout", type=float, default=None,
                          help="seconds before stragglers are killed")
    p_launch.add_argument("--out", default=None,
                          help="gathered result JSON (written by process 0)")
    p_launch.set_defaults(fn=cmd_launch, takes_worker_flags=True)

    p_hist = sub.add_parser(
        "history", help="list the persistent run ledger "
                        "(repro_torch.obs.ledger)",
        allow_abbrev=False)
    p_hist.add_argument("--add", default=None, metavar="FILE",
                        help="ingest a saved result/record JSON as a ledger "
                             "record first")
    p_hist.add_argument("--history-root", dest="history_root", default=None,
                        help=f"ledger directory (default: "
                             f"${ledger.LEDGER_ENV} or {ledger.DEFAULT_ROOT}/)")
    p_hist.add_argument("--json", action="store_true",
                        help="print raw records instead of the table")
    p_hist.set_defaults(fn=cmd_history)

    p_diff = sub.add_parser(
        "diff", help="noise-aware bandwidth diff vs a ledger baseline "
                     "(exit 2 on regression)",
        allow_abbrev=False)
    p_diff.add_argument("--baseline", required=True,
                        help="ledger index (-1 = newest), 'latest', a spec-"
                             "digest prefix, or a record/result JSON file")
    p_diff.add_argument("--current", default="latest",
                        help="same forms (default: latest)")
    p_diff.add_argument("--z", type=float, default=3.0,
                        help="noise-test z score (detect.significant_step)")
    p_diff.add_argument("--tolerance", type=float, default=0.05,
                        help="minimum relative drop treated as real")
    p_diff.add_argument("--history-root", dest="history_root", default=None,
                        help=f"ledger directory (default: "
                             f"${ledger.LEDGER_ENV} or {ledger.DEFAULT_ROOT}/)")
    p_diff.add_argument("--json", action="store_true",
                        help="print the full diff report JSON")
    p_diff.set_defaults(fn=cmd_diff)

    # `launch` forwards unknown flags (--mixes/--sizes/--devices/...) to its
    # `run` workers verbatim; every other command treats extras as errors
    args, extra = ap.parse_known_args(argv)
    if getattr(args, "takes_worker_flags", False):
        args.worker_flags = extra
    elif extra:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    try:
        return args.fn(args)
    except (BenchSpecError, ValueError, KeyError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())

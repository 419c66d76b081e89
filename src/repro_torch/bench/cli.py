"""``python -m repro_torch.bench`` — run / list-mixes / compare / latency.

    run         execute a BenchSpec (flags or --spec JSON), print + save the
                schema-versioned result JSON
    list-mixes  the shared mix registry with its bytes/flops accounting
    compare     the same spec on several backends, side by side
    latency     loaded-latency surface: the latency_chase probe across the
                load axis -> bandwidth-latency curve + knee fit

Every command that measures takes ``--device`` (default ``cuda``; with no
CUDA device present the default raises — pass ``--device cpu`` to run the
plain PyTorch versions on the CPU).  ``run`` and ``latency`` take ``--trace
PATH`` (span tracing -> Perfetto JSON), append a ledger record unless
``--no-ledger``, and refuse to overwrite an existing ``--out`` file unless
``--force``.

Counterpart of ``repro.bench.cli``; its other sub-commands (characterize,
istream, audit, launch, history, diff) have none here yet.
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
    p.add_argument("--backend", default="cuda", help="torch | cuda")
    p.add_argument("--mixes", "--mix", default=None,
                   help="comma list, e.g. load_sum,copy,fma_8")
    p.add_argument("--sizes", default=None, help="comma list, K/M/G ok: 32K,2M")
    p.add_argument("--reps", type=int, default=None)
    p.add_argument("--streams", type=int, default=None)
    p.add_argument("--devices", type=int, default=None,
                   help="devices the working set spreads over (multi-device "
                        "backends only; none is registered yet)")
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
    """Write the trace and append the run's ledger record."""
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
    runner = Runner(device=args.device)     # raises without a CUDA device
    _obs_begin(args)
    spec = _spec_from_args(args)
    res = runner.run(spec)
    _obs_finish(args, res, "run")
    text = res.to_json(args.out)
    if args.out:
        for p in res.points:
            print(f"{p.backend}/{p.mix}/{p.nbytes}B,{p.mean_s * 1e6:.2f},"
                  f"{p.gbps:.2f}GB/s")
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


def cmd_latency(args) -> int:
    """Loaded-latency surface (see characterize.loaded): sweep the
    ``latency_chase`` probe across the ``load`` axis at each working-set
    size, fit the bandwidth–latency knee, print the curve, save the result.
    ``--smoke`` is the small preset (one 128 KiB size, loads 0,1,2, 3 reps);
    the reference's smoke also audits the chase's accounting, which comes
    with the port of the audit."""
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
    _obs_finish(args, res, "latency")
    if args.out:
        res.to_json(args.out)
        print(f"# saved {len(res.points)} points "
              f"(schema v{res.schema_version}) -> {args.out}")
    return 0


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

    p_lat = sub.add_parser(
        "latency",
        help="loaded-latency surface: latency_chase across the load axis "
             "(Mess-style bandwidth-latency curves; see characterize.loaded)",
        allow_abbrev=False)
    p_lat.add_argument("--smoke", action="store_true",
                       help="small preset: one 128K size, loads 0,1,2, 3 "
                            "reps (the reference's inline chase audit comes "
                            "with the port of the audit)")
    p_lat.add_argument("--backend", default="cuda",
                       help="cuda | torch (both: the single-device "
                            "time-shared composite; torch walks the chain "
                            "in a host loop, so its latency_ns is no "
                            "memory latency)")
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

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (BenchSpecError, ValueError, KeyError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())

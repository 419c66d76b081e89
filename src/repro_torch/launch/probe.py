"""Per-part breakdown of a cell's roofline counts, and the check that the
parts compose to the dry run's whole step (counterpart of
``repro.launch.probe``).

    PYTHONPATH=src python -m repro_torch.launch.probe --mesh both
    PYTHONPATH=src python -m repro_torch.launch.probe --arch granite-3-2b \\
        --shape train_4k --mesh single

The reference probes part by part because XLA:CPU's cost analysis counts a
``while`` body once, whatever its trip count, so its rolled dry run
undercounts by about the number of layers.  Eager PyTorch runs, and
``FlopCounterMode`` counts, every layer: the port's dry run
(``launch.dryrun``) already counts the whole step.  What the port keeps of
the probe is the breakdown and a check on it:

- the parts are measured on the same rank of the same production mesh as
  the dry run (``dryrun.trace``), from the step cut to one and to two
  layers (a hybrid: one and two sites; encdec: its decoder and its encoder
  separately): a layer is the difference of the two, the head (embedding,
  final norm, logits or loss, the gradient rule's reductions and AdamW) is
  the one-layer step less its layer.  In training each part is split into
  its forward (the loss alone, without autograd) and its gradient (the
  rest: the backward, and the forward again under ``remat="full"``), and
  the optimizer gets the reference's analytic 15 FLOPs and 28 bytes a
  held parameter (AdamW's elementwise work, which the FLOP counter does
  not count);
- composed as the reference composes them, ``total = L x layer + head (+
  E x encoder layer) + optimizer``, the counted FLOPs and the collective
  bytes must equal the dry run's whole-step counts within 1 %
  (``MATCH_TOL``), or the record's status is ``error``: this check is
  what the port keeps of the probe.  The parts are differences of the
  same eager trace, which is linear in the depth for a stack of equal
  layers, so on such a stack the check reads exactly 0: it catches only
  structure that depends on the depth (a hybrid's shared-block sites,
  encdec's encoder beside its decoder), and is no count of the whole
  independent of the dry run's.

Each record carries ``"source": "probe"``, the roofline terms (the memory
term by ``roofline.model_bytes.analytic_bytes``) and ``hbm_bytes_upper``,
every op's operand and result bytes summed with no fusion (the
counterpart of XLA's "bytes accessed"), and goes to
``artifacts/torch/probe/<arch>__<shape>__<pod1|pod2>__<variant>.json``.
The whole step's counts are read from the dry run's record where it is
there (``--dryrun-dir``), else traced here.  As the dry run, this runs in
a fake world: a program (or a subprocess) of its own.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from dataclasses import replace
from pathlib import Path

from repro_torch.configs import SHAPES, get_arch, list_archs, param_count
from repro_torch.launch import dryrun
from repro_torch.roofline.analyze import CollectiveOp, RooflineTerms

ART = Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "probe"
#: the composed total against the dry run's whole step, relative
MATCH_TOL = 0.01


def _counts(cfg, shape, ctx, variant, forward_only: bool = False) -> dict:
    """FLOPs, no-fusion bytes and collective bytes of one run of the
    cell's step (``forward_only``: the training loss alone)."""
    c = dryrun.trace(cfg, shape, ctx, variant, memory=False,
                     bytes_upper=True, forward_only=forward_only)
    colls: dict[str, float] = {}
    for op in c["collectives"]:
        key = f"{op.kind}/{op.group_size}"
        colls[key] = colls.get(key, 0.0) + op.bytes
    return {"flops": c["flops"], "bytes": c["hbm_bytes_upper"],
            "coll_bytes": float(sum(colls.values())), "colls": colls}


def _sub(a: dict, b: dict) -> dict:
    """Part ``a`` less part ``b``, the collectives by (kind, group size)."""
    out = {k: a[k] - b[k] for k in ("flops", "bytes", "coll_bytes")}
    out["colls"] = {k: a["colls"].get(k, 0.0) - b["colls"].get(k, 0.0)
                    for k in set(a["colls"]) | set(b["colls"])}
    return out


def _depth(cfg, units: int, encoder: int | None = None):
    """``cfg`` cut to ``units`` layers (a hybrid: sites) and, for encdec,
    ``encoder`` encoder layers."""
    n = units * cfg.attn_every if cfg.family == "hybrid" else units
    out = replace(cfg, n_layers=n)
    if encoder is not None:
        out = replace(out, n_encoder_layers=encoder)
    return out


def probe_parts(cfg, shape, ctx, variant) -> list[tuple[str, int, dict]]:
    """[(part, multiplier, {"flops", "bytes", "coll_bytes"[, "fwd",
    "grad"]})] of one rank's step, by differences of the step cut to one
    and two layers."""
    enc = 1 if cfg.family == "encdec" else None
    units = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
             else cfg.n_layers)
    one = _depth(cfg, 1, enc)
    runs = {"base": one, "layer": _depth(cfg, 2, enc)}
    if enc:
        runs["enc_layer"] = _depth(cfg, 1, 2)
    train = shape.kind == "train"
    whole = {k: _counts(c, shape, ctx, variant) for k, c in runs.items()}
    fwd = ({k: _counts(c, shape, ctx, variant, forward_only=True)
            for k, c in runs.items()} if train else None)
    name = "site" if cfg.family == "hybrid" else "layer"
    parts = []
    head = dict(whole["base"])
    for part, mult in (("layer", units), ("enc_layer", cfg.n_encoder_layers)):
        if part not in runs:
            continue
        d = _sub(whole[part], whole["base"])
        if train:
            f = _sub(fwd[part], fwd["base"])["flops"]
            d.update(fwd=f, grad=d["flops"] - f)
        parts.append((name if part == "layer" else part, mult, d))
        head = _sub(head, d)
    if train:
        f = fwd["base"]["flops"] - sum(p[2]["fwd"] for p in parts)
        head.update(fwd=f, grad=head["flops"] - f)
    parts.append(("head", 1, head))
    if train:
        total_p, _ = param_count(cfg)
        p_local = total_p / ctx.n_ranks
        parts.append(("optimizer", 1, {"flops": 15.0 * p_local,
                                       "bytes": 28.0 * p_local,
                                       "coll_bytes": 0.0, "colls": {},
                                       "analytic": True}))
    return parts


def _whole(arch, shape_name, multi_pod, variant_name, cfg, shape, ctx,
           variant, dryrun_dir: Path) -> dict:
    """The dry run's whole-step counts: its record, or a trace here."""
    path = dryrun.cell_path(arch, shape_name, multi_pod, variant_name,
                            dryrun_dir)
    if path.exists():
        rec = json.loads(path.read_text())
        if rec.get("status") == "ok":
            return {"flops": rec["flops"],
                    "coll_bytes": float(rec["collective_bytes"]),
                    "from": str(path.name)}
    c = dryrun.trace(cfg, shape, ctx, variant, memory=False)
    return {"flops": c["flops"],
            "coll_bytes": float(sum(op.bytes for op in c["collectives"])),
            "from": "trace"}


def probe_cell(arch: str, shape_name: str, multi_pod: bool,
               variant_name: str, dryrun_dir: Path = dryrun.ART) -> dict:
    from repro_torch.models.variant import VARIANTS
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, reason = cfg.supports_shape(shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "variant": variant_name, "status": "skipped",
                "reason": reason, "source": "probe"}
    variant = VARIANTS[variant_name]
    ctx, rank = dryrun.production_ctx(multi_pod, variant)
    t0 = time.time()
    parts = probe_parts(cfg, shape, ctx, variant)
    counted = {k: sum(m * c[k] for _, m, c in parts if not c.get("analytic"))
               for k in ("flops", "bytes", "coll_bytes")}
    flops = sum(m * c["flops"] for _, m, c in parts)
    # the ring model is linear in the bytes at a (kind, group size): one
    # op a pair carries the composed bytes
    by_kind: dict[str, float] = {}
    for _, m, c in parts:
        for k, b in c["colls"].items():
            by_kind[k] = by_kind.get(k, 0.0) + m * b
    colls = [CollectiveOp(k.split("/")[0], int(round(b)), int(k.split("/")[1]))
             for k, b in sorted(by_kind.items()) if round(b)]
    whole = _whole(arch, shape_name, multi_pod, variant_name, cfg, shape,
                   ctx, variant, dryrun_dir)
    match = {k: (counted[k] - whole[k]) / whole[k] if whole[k] else
             float(counted[k] != 0) for k in ("flops", "coll_bytes")}
    hbm = dryrun.hbm_model_bytes(cfg, shape, ctx, variant)
    terms = RooflineTerms(flops=flops, hbm_bytes=hbm, collectives=colls)
    model_flops = dryrun.model_flops(cfg, shape, ctx.n_ranks)
    good = all(abs(v) <= MATCH_TOL for v in match.values())
    rec = {
        **terms.summary(),
        "hbm_bytes_upper": counted["bytes"],
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "variant": variant_name, "status": "ok" if good else "error",
        "source": "probe", "rank": rank,
        "model_flops": model_flops,
        "useful_flop_ratio": model_flops / flops if flops else 0.0,
        "flops_counted": counted["flops"],
        "collective_bytes_counted": counted["coll_bytes"],
        "dryrun": whole, "match": match,
        "parts": {n: {"mult": m, **{k: v for k, v in c.items()
                                    if k not in ("analytic", "colls")}}
                  for n, m, c in parts},
        "probe_s": round(time.time() - t0, 1),
    }
    if not good:
        rec["error"] = (f"parts compose to {counted['flops']:.6g} FLOPs and "
                        f"{counted['coll_bytes']:.6g} collective bytes; the "
                        f"dry run's whole step {whole['flops']:.6g} and "
                        f"{whole['coll_bytes']:.6g} (relative {match})")
    return rec


def cell_path(arch, shape_name, multi_pod, variant, art: Path = ART) -> Path:
    mesh_tag = "pod2" if multi_pod else "pod1"
    return art / f"{arch}__{shape_name}__{mesh_tag}__{variant}.json"


def run_cell(arch, shape_name, multi_pod, variant, force=False,
             art: Path = ART, dryrun_dir: Path = dryrun.ART) -> dict:
    out = cell_path(arch, shape_name, multi_pod, variant, art)
    if out.exists() and not force:
        return json.loads(out.read_text())
    try:
        rec = probe_cell(arch, shape_name, multi_pod, variant, dryrun_dir)
    except Exception as e:  # a failing cell is a bug — record it loudly
        rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
               "variant": variant, "status": "error", "source": "probe",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=2, default=float))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=str(ART))
    ap.add_argument("--dryrun-dir", default=str(dryrun.ART),
                    help="where the dry run's records are read from")
    args = ap.parse_args(argv)
    archs = list_archs() if args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    errors = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape, mp, args.variant,
                               force=args.force, art=Path(args.out_dir),
                               dryrun_dir=Path(args.dryrun_dir))
                tag = (f"{arch} x {shape} x {'pod2' if mp else 'pod1'} x "
                       f"{args.variant}")
                if rec["status"] == "ok":
                    print(f"[ok]   {tag}: dom={rec['dominant']} "
                          f"t=({rec['t_compute_s']:.4f},"
                          f"{rec['t_memory_s']:.4f},"
                          f"{rec['t_collective_s']:.4f})s "
                          f"useful={rec['useful_flop_ratio']:.2f} "
                          f"match={rec['match']} "
                          f"({time.time() - t0:.0f}s)", flush=True)
                elif rec["status"] == "skipped":
                    print(f"[skip] {tag}", flush=True)
                else:
                    errors += 1
                    print(f"[ERR]  {tag}: {rec['error'][:300]}", flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())

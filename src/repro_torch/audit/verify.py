"""Static accounting verifier — declared work vs what runs.

Counterpart of ``repro.audit.verify``.  Every mix in the registry declares
its traffic (``MixDef.bytes_per_pass`` / ``flops_per_pass``: the accounting
every GB/s and flop/s number is normalized by).  The verifier holds those
declarations against what a case runs, per pass:

* ``cuda``: the SASS of the hand-written kernels, run for the launches of
  one timed call (``membench.launch_record``, ``istream.emulate``);
* ``torch``: the aten operations one call dispatches (``istream.analyze``).

Three layers of checking per case, as in the reference, with its names:

* **formula lint** (``lint_mix``): the declared per-element numbers against
  the mix's structural parameters.  Pure registry math.
* **traffic checks** ``loads`` / ``stores`` / ``arith``: observed elements
  per pass against ``expected_counts`` — the DECLARED numbers mapped through
  each backend's calibrated behaviour (``audit/README.md`` names every
  term).  A corrupted declaration moves the expectation and fails by name.
* **liveness** ``loop`` / ``trips`` / ``dce``: the passes run where the
  launch record says (a loop of the kernel's SASS that holds its traffic,
  grid.y, or a launch a pass; eager code on torch), the per-pass traffic
  is the same from p to 2p as from 2p to 3p passes, and a timed region that
  moves less than half a working set per pass fails ``dce`` before any
  elementwise comparison.

Cases with no stable expectation are *waived*: reported with their reason,
counted (``audit_waivers``), never failed.

Entry points: ``audit_registry`` (live: torch on meta tensors here; cuda on
the SASS of the libraries built from this checkout, which needs
``cuobjdump``), ``audit_sass`` / ``audit_trace`` / ``audit_goldens``
(deviceless: the same checks over committed SASS and aten traces).
"""
from __future__ import annotations

import dataclasses
import json
import random as _random
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.bench.mixes import (GEN_SWEEPS_PER_PASS, MAX_RW, MixDef,
                                     get_mix, interleavable, mix_names,
                                     rw_name)
from repro_torch.bench.spec import BenchSpec, BenchSpecError

# exit code contract shared with the CLI (``python -m repro_torch.bench
# audit``)
EXIT_OK = 0
EXIT_VIOLATION = 2

#: lanes of the canonical audit shape; the mxu weight panel is LANES x LANES
LANES = 128

# the reference's tolerance policy: the absolute term covers a pass's scalar
# scaffolding per unrolled sweep, the relative term systematic slack
RTOL = 0.03
ATOL_ELEMS_PER_SWEEP = 64.0

#: a timed region whose observed traffic falls below this fraction of one
#: working-set read is considered eliminated, not merely mis-accounted
DCE_FRACTION = 0.5

#: the card the goldens and a deviceless record assume: an H100's SMs and
#: L2 (a live audit reads the card's own)
H100 = (132, 50 * 2**20)

# -- calibrated terms (audit/README.md has the table) -------------------------

#: cuda load_only: FADDs a 16-byte position a pass, by unroll — ptxas
#: if-converts the fixed-cursor pass loop's [0,0] add (``acc += first ?
#: v : 0`` in every thread) in some of its unrolled bodies; measured on
#: the H100's SASS at float32 and bfloat16, at the audit's pass counts
CUDA_LOAD_ONLY_ADDS_PER_POSITION = {1: 0.75, 2: 1.25, 4: 0.875, 8: 0.875}


def _cuda_block_sum(threads: int) -> int:
    """FADDs of one CTA's ``block_sum``: 5 shuffle levels in every thread,
    then 5 more in warp 0."""
    return 5 * threads + 5 * 32

#: torch: the scalar scaffolding of one load_sum sweep of a loaded chase's
#: generator (the accumulator add and the ``_perturb`` chain)
TORCH_SWEEP_SCAFFOLD = {"loads": 7.0, "stores": 5.0, "arith": 3.0}


# --------------------------------------------------------------------------
# expected traffic
# --------------------------------------------------------------------------

def waiver_reason(mix: MixDef, backend: str,
                  knobs: dict | None = None) -> str | None:
    """Why a case carries no stable expectation (it is *waived*: observed
    counts reported, never failed) — or None when it is fully checkable.

    * ``torch`` with ``interleave`` > 1: the chunked oracles
      (``k_*_istream``) add per-chunk copies and a concatenation whose
      traffic has no closed form across (mix, chunks) — the reference's
      class.
    * ``cuda`` has none: every mix and knob of the registry is checked,
      ``load_only`` included (its loads must survive: the reference waives
      it for interpret-mode DCE, which the cuda kernel does not have).
    """
    knobs = knobs or {}
    if backend == "torch" and (knobs.get("interleave") or 1) > 1:
        return ("chunked interleave variant restructures per-chunk traffic "
                "(no closed form)")
    return None


def _chase_generator(n: float, knobs: dict, machine) -> dict:
    """Per-pass terms of the cuda loaded chase's generator launch beyond
    its declared sweeps: acc.cu's per-CTA partials and its fold stages
    (one launch a pass, on a float32 buffer of n elements)."""
    from repro_torch.kernels.membench import membench as mb
    rows = int(n // LANES)
    block_rows = knobs.get("block_rows") or mb.default_block_rows(
        rows, knobs.get("streams") or 1)
    sms, l2 = machine or H100
    grid = mb.acc_launch_plan(rows // block_rows, block_rows * LANES * 4, 1,
                              sms, l2)["grid"]
    threads = mb.ACC_WIN[0]
    fold = [(grid, 1)] if grid <= mb.FOLD_CHUNK else \
        [(grid, -(-grid // mb.FOLD_CHUNK)),
         (-(-grid // mb.FOLD_CHUNK), 1)]
    arith = grid * _cuda_block_sum(threads)
    stores = grid
    loads = 0
    for n_in, ctas in fold:
        loads += n_in
        stores += ctas
        arith += ctas * (3 * mb._THREADS + _cuda_block_sum(mb._THREADS)) \
            + n_in
    return {"loads": loads, "stores": stores, "arith": arith}


def expected_counts(mix: MixDef, backend: str, n: float,
                    knobs: dict | None = None, dtype: str = "float32",
                    machine=None) -> dict | None:
    """Per-pass loads / stores / arith (elements) that ``backend`` is
    expected to show for ``mix``, derived from the mix's DECLARED numbers
    (R = reads_per_elem, W = writes_per_elem, f = flops_per_elem) plus the
    calibrated behaviour of each backend.  Deriving from the declared
    numbers is what makes this a verifier: corrupt a declaration and the
    expectation moves away from the (unchanged) code.

    ``cuda`` (SASS, a thread-instruction's elements; ``FFMA`` is one
    arithmetic element, so a declared multiply-add pair is one):

    * load_sum, copy, triad, rw_RtoW: ``R n / W n / f n`` exactly.
    * fma_k, mxu: arith ``(f/2 + 1) n`` — each multiply-add pair is one
      FFMA (mxu: one MAC per ``HMMA`` element, 64 a thread), plus the
      vector sum (fma) or the checksum (mxu): one FADD an element.
    * load_only: arith ``f n + a n s / 16`` (s the element size, a the
      if-converted [0,0] adds a position, by unroll:
      ``CUDA_LOAD_ONLY_ADDS_PER_POSITION``).
    * latency_chase: ``R n`` dependent loads, plus per pass (one launch a
      pass) the final-j store and, after the first pass, the read of the
      result it accumulates into (1 load, 1 store, n_tiles + 1 adds).
      Loaded: ``load * GEN_SWEEPS_PER_PASS`` generator sweeps (``n`` loads
      and adds each) in one acc.cu launch a pass, whose per-CTA partials
      and fold stages (``_chase_generator``) then recur every pass.

    ``torch`` (aten operations, the reference's element-op units):

    * load_sum: ``R n / 0 / f n``; copy: ``R n / W n / (f+1) n`` (the scale
      multiply that the oracle keeps, as xla).
    * triad: ``(R+f+2) n / (W+f+1) n / (f+2) n``: every binary operation of
      the eager statement (the triad's two and the self-dependence's two)
      reads its operands and writes a full array.
    * rw_RtoW: ``(R+W+f) n / (1+f+W) n / (1+f+W) n``: stream 0's eps add,
      a scale and an add per further stream, an add per output.
    * fma_k: ``(R+f) n / f n / (f+1) n``: each link of the chain is a
      multiply and an add over the whole array, then the sum.
    * mxu: ``R n + 128^2 / n / f n``: the weight panel is read every pass,
      the product is written.
    * latency_chase: ``R n`` host reads (the walk), nothing else; loaded:
      each generator sweep's ``n`` loads and adds plus its scalar
      scaffolding (``TORCH_SWEEP_SCAFFOLD``).

    Returns None when no stable expectation exists (a waiver)."""
    if backend not in ("torch", "cuda"):
        return None
    if waiver_reason(mix, backend, knobs) is not None:
        return None
    knobs = knobs or {}
    R, W, f = mix.reads_per_elem, mix.writes_per_elem, mix.flops_per_elem
    name = mix.name
    load = knobs.get("load") or 0
    if mix.chase:
        gl = load * GEN_SWEEPS_PER_PASS
        out = {"loads": (R + gl) * n, "stores": 0.0, "arith": (f + gl) * n}
        if backend == "torch":
            for k, v in TORCH_SWEEP_SCAFFOLD.items():
                out[k] += gl * v
            return out
        rows = int(n // LANES)
        from repro_torch.kernels.membench import membench as mb
        block_rows = knobs.get("block_rows") or mb.default_block_rows(
            rows, knobs.get("streams") or 1)
        n_tiles = rows // block_rows
        out["stores"] += 1
        out["arith"] += n_tiles
        if load:
            for k, v in _chase_generator(n, knobs, machine).items():
                out[k] += v
        else:
            out["loads"] += 1
            out["arith"] += 1
        return out
    if backend == "cuda":
        if name.startswith("fma_") or name == "mxu":
            return {"loads": R * n, "stores": 0.0, "arith": (f / 2 + 1) * n}
        if name == "load_only":
            import numpy as np
            size = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
            adds = CUDA_LOAD_ONLY_ADDS_PER_POSITION[knobs.get("unroll") or 1]
            return {"loads": R * n, "stores": 0.0,
                    "arith": f * n + adds * n * size / 16}
        if name in ("load_sum", "copy", "triad") or mix.rw is not None:
            return {"loads": R * n, "stores": W * n, "arith": f * n}
        return None
    if name == "load_sum":
        return {"loads": R * n, "stores": 0.0, "arith": f * n}
    if name == "copy":
        return {"loads": R * n, "stores": W * n, "arith": (f + 1) * n}
    if name == "triad":
        return {"loads": (R + f + 2) * n, "stores": (W + f + 1) * n,
                "arith": (f + 2) * n}
    if mix.rw is not None:
        return {"loads": (R + W + f) * n, "stores": (1 + f + W) * n,
                "arith": (1 + f + W) * n}
    if name.startswith("fma_"):
        return {"loads": (R + f) * n, "stores": f * n, "arith": (f + 1) * n}
    if name == "mxu":
        return {"loads": R * n + LANES * LANES, "stores": n, "arith": f * n}
    return None


def lint_mix(mix: MixDef) -> list[tuple[str, bool, str]]:
    """Registry-internal consistency: declared per-element numbers vs the
    mix's structural parameters.  Returns (check, ok, detail) triples."""
    out = []
    if mix.rw is not None:
        R, W = mix.rw
        out.append(("formula:reads", mix.reads_per_elem == R,
                    f"reads_per_elem={mix.reads_per_elem} vs rw R={R}"))
        out.append(("formula:writes", mix.writes_per_elem == W,
                    f"writes_per_elem={mix.writes_per_elem} vs rw W={W}"))
        out.append(("formula:flops", mix.flops_per_elem == 2 * (R - 1),
                    f"flops_per_elem={mix.flops_per_elem} vs 2(R-1)={2*(R-1)}"))
    if mix.name.startswith("fma_"):
        k = mix.fma_depth
        out.append(("formula:flops", mix.flops_per_elem == 2 * k,
                    f"flops_per_elem={mix.flops_per_elem} vs 2k={2 * k}"))
    if mix.name == "triad":
        out.append(("formula:triad", (mix.reads_per_elem, mix.writes_per_elem,
                                      mix.flops_per_elem) == (2.0, 1.0, 2.0),
                    f"triad declares (R,W,f)=({mix.reads_per_elem},"
                    f"{mix.writes_per_elem},{mix.flops_per_elem}) != (2,1,2)"))
    if mix.chase:
        out.append(("formula:chase", (mix.reads_per_elem, mix.writes_per_elem,
                                      mix.flops_per_elem) == (1.0, 0.0, 0.0),
                    f"chase declares (R,W,f)=({mix.reads_per_elem},"
                    f"{mix.writes_per_elem},{mix.flops_per_elem}) != (1,0,0) "
                    "(one dependent load per step, nothing else)"))
    return out


# --------------------------------------------------------------------------
# per-case audit
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Check:
    name: str
    ok: bool
    detail: str


@dataclass
class CaseAudit:
    """Declared vs observed accounting for ONE case."""
    mix: str
    backend: str
    shape: tuple
    dtype: str
    passes: int
    knobs: dict                    # streams / block_rows / unroll / ...
    declared: dict                 # registry accounting (per pass)
    expected: dict | None          # expectation (per pass)
    observed: dict                 # observed counts (per pass)
    checks: list[Check] = field(default_factory=list)
    waived: bool = False           # no expectation: reported, never failed
    waived_reason: str | None = None

    @property
    def ok(self) -> bool:
        return self.waived or all(c.ok for c in self.checks)

    @property
    def failures(self) -> list[Check]:
        return [] if self.waived else [c for c in self.checks if not c.ok]

    def where(self) -> str:
        """mix/backend/knob triple naming the case in violation output (a
        knob at its no-op value is elided)."""
        knobs = ",".join(f"{k}={v}" for k, v in sorted(self.knobs.items())
                         if v is not None
                         and v != (0 if k == "load" else 1))
        if self.dtype != "float32":            # the audit's default dtype
            knobs = ",".join(x for x in (knobs, self.dtype) if x)
        return f"{self.backend}/{self.mix}" + (f"[{knobs}]" if knobs else "")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(d["shape"])
        d["ok"] = self.ok
        return d


def _close(obs: float, exp: float, n: float, unroll: int) -> bool:
    atol = ATOL_ELEMS_PER_SWEEP * max(unroll, 1)
    return abs(obs - exp) <= atol + RTOL * max(exp, 0.01 * n)


def audit_counts(mix: MixDef, backend: str, shape, dtype: str, passes: int,
                 per_iter: dict, loop, trips: int, unroll: int = 1,
                 knobs: dict | None = None, machine=None) -> CaseAudit:
    """The pure core: observed per-iteration counts -> CaseAudit (shared by
    the live path and the deviceless one)."""
    import numpy as np
    n = float(np.prod(shape)) if shape else 1.0
    itemsize = 2 if str(dtype) == "bfloat16" else np.dtype(dtype).itemsize
    unroll = max(unroll, 1)
    knobs = dict(knobs or {})
    knobs.setdefault("unroll", unroll)

    obs = {k: per_iter.get(k, 0.0) / unroll
           for k in ("loads", "stores", "arith", "move")}
    obs["bytes"] = (obs["loads"] + obs["stores"]) * itemsize
    declared = {"bytes": mix.bytes_per_pass(int(n) * itemsize),
                "flops": mix.flops_per_pass(int(n))}
    exp = expected_counts(mix, backend, n, knobs=knobs, dtype=str(dtype),
                          machine=machine)

    checks = [Check(name, ok, detail) for name, ok, detail in lint_mix(mix)]
    expected_trips = max(passes // unroll, 1)
    if expected_trips > 1:
        checks.append(Check(
            "loop", loop is not None,
            f"pass loop {'found (' + str(loop) + ')' if loop else 'MISSING'} "
            f"(expected {expected_trips} trips)"))
        if loop is not None:
            checks.append(Check(
                "trips", trips == expected_trips,
                f"trip count {trips} vs passes/unroll={expected_trips}"
                + ("" if trips else " (the per-pass traffic differs between "
                   "p->2p and 2p->3p passes)")))

    audit = CaseAudit(mix=mix.name, backend=backend, shape=tuple(shape),
                      dtype=str(dtype), passes=passes, knobs=knobs,
                      declared=declared, expected=exp, observed=obs,
                      checks=checks, waived=exp is None,
                      waived_reason=(waiver_reason(mix, backend, knobs)
                                     or "no expectation for this backend")
                      if exp is None else None)
    if exp is None:
        from repro_torch.obs import metrics
        metrics.REGISTRY.inc("audit_waivers")
        return audit

    exp_traffic = exp["loads"] + exp["stores"]
    if exp_traffic > 0 and (obs["loads"] + obs["stores"]) \
            < DCE_FRACTION * min(n, exp_traffic):
        checks.append(Check(
            "dce", False,
            f"timed work eliminated: observed "
            f"{obs['loads'] + obs['stores']:.0f} traffic elems/pass vs "
            f"expected {exp_traffic:.0f} (deleted or hoisted)"))
        return audit
    for key in ("loads", "stores", "arith"):
        checks.append(Check(
            key, _close(obs[key], exp[key], n, unroll),
            f"observed {obs[key]:.0f} vs expected {exp[key]:.0f} "
            f"elems/pass (declared "
            f"{declared['bytes' if key != 'arith' else 'flops']:.0f} "
            f"{'bytes' if key != 'arith' else 'flops'})"))
    return audit


def audit_case(spec: BenchSpec, mix_name: str, shape, dtype, passes: int,
               runner=None, cache=None, sass=None, machine=None) -> CaseAudit:
    """Live audit of one case (``istream.analyze_case``: torch on meta
    tensors; cuda on ``sass``, by default the SASS of the libraries built
    from this checkout)."""
    from repro_torch.istream.analyze import analyze_case, spec_knobs
    if spec.backend == "cuda" and machine is None:
        from repro_torch.istream.analyze import machine_of
        machine = machine_of()
    prof = analyze_case(spec, mix_name, shape, dtype, passes, runner=runner,
                        cache=cache, sass=sass, machine=machine)
    return audit_counts(
        get_mix(mix_name), spec.backend, shape, str(prof.dtype), passes,
        prof.per_iter, prof.loop, prof.trips, unroll=spec.unroll,
        knobs=spec_knobs(spec), machine=machine)


def _spec(mix_name: str, backend: str, shape, dtype: str, passes: int,
          unroll: int, knobs: dict | None) -> BenchSpec:
    import numpy as np
    size = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
    extra = {k: v for k, v in (knobs or {}).items() if k != "unroll"}
    return BenchSpec(mixes=(mix_name,), sizes=(int(np.prod(shape)) * size,),
                     backend=backend, dtype=dtype, passes=passes, reps=2,
                     warmup=0, unroll=unroll, **extra)


def audit_sass(sass: dict, mix_name: str, shape, dtype: str = "float32",
               passes: int = 4, unroll: int = 1, knobs: dict | None = None,
               machine=H100, launches: list | None = None) -> CaseAudit:
    """Deviceless audit of a cuda case over SASS text already in hand
    (``sass``: source file -> its kernels, ``extract.parse_sass``): the
    launch records are rebuilt for ``machine`` = (SMs, L2 bytes); when the
    record a golden was written with is given (``launches``), it must be
    the one rebuilt here (check ``launch``)."""
    from repro_torch.istream.analyze import (json_record,
                                             profile_from_record,
                                             record_case, spec_knobs)
    spec = _spec(mix_name, "cuda", shape, dtype, passes, unroll, knobs)
    try:
        record = record_case(spec, mix_name, shape, dtype, passes,
                             sass=sass, machine=machine)
    except KeyError as e:          # a launched kernel missing from the SASS
        return _failed(mix_name, "cuda", shape, dtype, passes, knobs,
                       "launch", str(e))
    prof = profile_from_record(record, spec, mix_name, shape, dtype, passes)
    audit = audit_counts(get_mix(mix_name), "cuda", shape, dtype, passes,
                         prof.per_iter, prof.loop, prof.trips, unroll=unroll,
                         knobs=spec_knobs(spec), machine=machine)
    if launches is not None:
        same = json.loads(json.dumps(json_record(record["launches"][0]))) \
            == launches
        audit.checks.insert(0, Check(
            "launch", same, "the golden's launch record is the one "
            "membench.launch_record gives" if same else
            "the golden's launch record differs from membench.launch_record "
            "(a host-side dispatch changed: rewrite the goldens)"))
    return audit


def audit_trace(traces: list, mix_name: str, shape, dtype: str = "float32",
                passes: int = 4, unroll: int = 1,
                knobs: dict | None = None) -> CaseAudit:
    """Deviceless audit of a torch case over its aten traces at p, 2p, 3p
    passes (``istream.analyze.torch_trace`` / ``parse_trace``)."""
    from repro_torch.istream.analyze import profile_from_record, spec_knobs
    spec = _spec(mix_name, "torch", shape, dtype, passes, unroll, knobs)
    prof = profile_from_record({"backend": "torch", "traces": traces}, spec,
                               mix_name, shape, dtype, passes)
    return audit_counts(get_mix(mix_name), "torch", shape, dtype, passes,
                        prof.per_iter, prof.loop, prof.trips, unroll=unroll,
                        knobs=spec_knobs(spec))


def _failed(mix_name, backend, shape, dtype, passes, knobs, check,
            detail) -> CaseAudit:
    return CaseAudit(mix=mix_name, backend=backend, shape=tuple(shape),
                     dtype=dtype, passes=passes, knobs=dict(knobs or {}),
                     declared={}, expected=None, observed={},
                     checks=[Check(check, False, detail)], waived=False)


# --------------------------------------------------------------------------
# registry-wide audit
# --------------------------------------------------------------------------

@dataclass
class AuditReport:
    cases: list[CaseAudit] = field(default_factory=list)
    skipped: list[dict] = field(default_factory=list)   # knob-gated combos
    meta: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.cases)

    @property
    def violations(self) -> list[CaseAudit]:
        return [c for c in self.cases if not c.ok]

    @property
    def waived(self) -> list[CaseAudit]:
        return [c for c in self.cases if c.waived]

    def table(self) -> str:
        rows = [f"{'case':34s} {'decl B/pass':>12s} {'obs B/pass':>12s} "
                f"{'decl flop':>10s} {'obs arith':>10s}  status"]
        for c in self.cases:
            status = ("waived (" + str(c.waived_reason) + ")" if c.waived else
                      "ok" if c.ok else
                      "FAIL " + ",".join(f.name for f in c.failures))

            def cell(d, key, width):
                return f"{d[key]:{width}.0f}" if key in d else f"{'-':>{width}s}"
            rows.append(
                f"{c.where():34s} {cell(c.declared, 'bytes', 12)} "
                f"{cell(c.observed, 'bytes', 12)} "
                f"{cell(c.declared, 'flops', 10)} "
                f"{cell(c.observed, 'arith', 10)}  {status}")
        for s in self.skipped:
            rows.append(f"{s['case']:34s} {'-':>12s} {'-':>12s} {'-':>10s} "
                        f"{'-':>10s}  skipped ({s['reason']})")
        counts = (f"# {len(self.cases)} cases: "
                  f"{sum(c.ok and not c.waived for c in self.cases)} ok, "
                  f"{len(self.waived)} waived, "
                  f"{len(self.violations)} violations, "
                  f"{len(self.skipped)} skipped")
        return "\n".join(rows + [counts])

    def to_dict(self) -> dict:
        return {"schema": "repro_torch.audit/v1", "ok": self.ok,
                "summary": {
                    "ok": sum(c.ok and not c.waived for c in self.cases),
                    "waived": len(self.waived),
                    "violations": len(self.violations),
                    "skipped": len(self.skipped)},
                "meta": self.meta,
                "cases": [c.to_dict() for c in self.cases],
                "skipped": self.skipped}

    def to_json(self, path=None) -> str:
        s = json.dumps(self.to_dict(), indent=2)
        if path is not None:
            Path(path).write_text(s)
        return s

    def exit_code(self) -> int:
        return EXIT_OK if self.ok else EXIT_VIOLATION


def random_rw_pairs(k: int, seed: int = 0,
                    max_side: int = MAX_RW) -> list[str]:
    """Deterministic pseudo-random rw_RtoW sample (property-test surface)."""
    rng = _random.Random(seed)
    out = []
    for _ in range(k):
        out.append(rw_name(rng.randint(1, max_side), rng.randint(1, max_side)))
    return sorted(set(out))


def default_knob_grid(smoke: bool = False) -> list[dict]:
    """The reference's one-factor-at-a-time knob coverage: the base case
    plus each knob alone; smoke keeps the base case, unroll 2 and 4 and the
    loaded chase (load 1, chase mixes only)."""
    if smoke:
        return [{}, {"unroll": 2}, {"unroll": 4}, {"load": 1}]
    return [{}, {"streams": 2, "block_rows": 16}, {"unroll": 2},
            {"interleave": 2}, {"block_rows": 32}, {"load": 1}]


SMOKE_MIXES = ("copy", "triad", "rw_2to1", "latency_chase")


def audit_registry(backends=("torch", "cuda"), mixes=None, shape=(64, 128),
                   dtype: str = "float32", passes: int = 4,
                   knob_grid: list[dict] | None = None, rw_pairs: int = 0,
                   seed: int = 0, smoke: bool = False, cache=None, sass=None,
                   machine=None) -> AuditReport:
    """Audit every registered mix on every requested backend across the
    knob grid.  The live cuda audit reads the SASS of the libraries built
    from this checkout (``sass``, by default ``istream.analyze.LiveSass``,
    which raises naming ``cuobjdump`` where the toolkit is missing) on the
    current card (``machine``: (SMs, L2 bytes))."""
    import numpy as np
    from repro_torch.istream.analyze import LiveSass, ProfileCache, machine_of
    cache = cache if cache is not None else ProfileCache()
    if "cuda" in backends:
        sass = sass if sass is not None else LiveSass()
        machine = machine if machine is not None else machine_of()
    knob_grid = knob_grid if knob_grid is not None else \
        default_knob_grid(smoke)
    n = int(np.prod(shape))
    size = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
    report = AuditReport(meta={"shape": list(shape), "dtype": dtype,
                               "passes": passes, "smoke": smoke,
                               "knob_grid": knob_grid,
                               "backends": list(backends),
                               "machine": list(machine) if machine else None,
                               "source": "live"})
    for backend in backends:
        names = list(mixes) if mixes is not None else \
            (list(SMOKE_MIXES) if smoke else mix_names(backend))
        if rw_pairs:
            names += [p for p in random_rw_pairs(rw_pairs, seed)
                      if p not in names]
        for name in names:
            mix = get_mix(name)
            if not mix.supports(backend):
                continue
            for knobs in knob_grid:
                if knobs.get("interleave", 1) > 1 and not interleavable(mix):
                    continue
                if (knobs.get("load") or 0) > 0 and not mix.chase:
                    continue
                case_id = f"{backend}/{name}" + \
                    (f"[{','.join(f'{k}={v}' for k, v in sorted(knobs.items()))}]"
                     if knobs else "")
                u = max(knobs.get("unroll", 1) or 1, 1)
                p = passes if passes % u == 0 else passes * u
                p = max(p, 2 * u)
                try:
                    spec = BenchSpec(mixes=(name,), sizes=(n * size,),
                                     backend=backend, dtype=dtype, passes=p,
                                     reps=2, warmup=0, **knobs)
                except BenchSpecError as e:
                    report.skipped.append({"case": case_id, "reason": str(e)})
                    continue
                try:
                    report.cases.append(audit_case(
                        spec, name, shape, dtype, p, cache=cache,
                        sass=sass if backend == "cuda" else None,
                        machine=machine if backend == "cuda" else None))
                except BenchSpecError as e:   # knob gated at make_case time
                    report.skipped.append({"case": case_id, "reason": str(e)})
                except (KeyError, ValueError, RuntimeError) as e:
                    # a case that cannot be observed IS an audit finding
                    report.cases.append(_failed(
                        name, backend, shape, dtype, p, knobs, "lower",
                        f"{type(e).__name__}: {e}"))
    return report


# --------------------------------------------------------------------------
# golden fixtures (the deviceless path)
# --------------------------------------------------------------------------

#: (mix, backends, unroll[, knobs[, dtype]]): the reference's GOLDEN_SET on
#: torch and cuda, plus load_only and mxu (float32 and bfloat16) on cuda
GOLDEN_SET = (("load_sum", ("torch", "cuda"), 1),
              ("copy", ("torch", "cuda"), 1),
              ("triad", ("torch", "cuda"), 1),
              ("rw_2to1", ("torch", "cuda"), 1),
              ("fma_8", ("torch", "cuda"), 1),
              ("copy", ("torch", "cuda"), 2),
              ("triad", ("torch", "cuda"), 2),
              ("rw_2to1", ("torch", "cuda"), 2),
              ("copy", ("torch", "cuda"), 4),
              ("triad", ("torch", "cuda"), 4),
              ("rw_2to1", ("torch", "cuda"), 4),
              ("latency_chase", ("torch", "cuda"), 1),
              ("latency_chase", ("torch", "cuda"), 1, {"load": 1}),
              ("load_only", ("cuda",), 1),
              ("mxu", ("cuda",), 1, {}, "float32"),
              ("mxu", ("cuda",), 1, {}, "bfloat16"))


def _golden_passes(passes: int, unroll: int) -> int:
    """A multiple of unroll with >= 2 trips (the reference's rule)."""
    p = passes if passes % unroll == 0 else passes * unroll
    return max(p, 2 * unroll)


def golden_cases(shape=(64, 128), dtype: str = "float32", passes: int = 4):
    """(mix, backend, unroll, passes, knobs, dtype, stem) of every golden."""
    for entry in GOLDEN_SET:
        name, backends, unroll = entry[:3]
        extra = dict(entry[3]) if len(entry) > 3 else {}
        dt = entry[4] if len(entry) > 4 else dtype
        p = _golden_passes(passes, unroll)
        for backend in backends:
            stem = (f"{backend}__{name}__{'x'.join(map(str, shape))}__{dt}"
                    f"__p{p}{f'__u{unroll}' if unroll > 1 else ''}"
                    + "".join(f"__{k}{v}" for k, v in sorted(extra.items())))
            yield name, backend, unroll, p, extra, dt, stem


def write_goldens(out_dir, shape=(64, 128), dtype: str = "float32",
                  passes: int = 4, sass=None, machine=None) -> dict:
    """Write the golden fixtures: one ``.ops`` file a torch case (its aten
    traces at p, 2p, 3p passes), one ``<source>.sass`` a library holding the
    kernels the cuda cases launch (cut from ``cuobjdump -sass`` of the
    libraries built from this checkout: ``sass``, a ``LiveSass``), and
    ``manifest.json`` (shape, dtype, passes, the card's SMs and L2, each
    case with its launch record).  Regenerate with ``python -m
    repro_torch.bench audit --write-goldens tests/data_torch/sass`` on the
    card."""
    from repro_torch.istream.analyze import (LiveSass, PASS_MULTIPLES,
                                             format_trace, json_record,
                                             machine_of, torch_trace)
    from repro_torch.istream.extract import prune_sass
    from repro_torch.kernels.membench import membench as mb
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sass = sass if sass is not None else LiveSass()
    sms, l2 = machine if machine is not None else machine_of()
    manifest = {"shape": list(shape), "dtype": dtype, "passes": passes,
                "unroll": 1, "sms": sms, "l2": l2, "cases": []}
    kernels: dict[str, set] = {}
    for name, backend, unroll, p, extra, dt, stem in golden_cases(
            shape, dtype, passes):
        case = {"mix": name, "backend": backend, "dtype": dt}
        if unroll > 1:
            case["unroll"] = unroll
            case["passes"] = p
        if extra:
            case["knobs"] = extra
        knobs = dict(extra, unroll=unroll)
        if backend == "torch":
            spec = _spec(name, "torch", shape, dt, p, unroll, extra)
            text = "".join(f"# passes={p * k}\n" + format_trace(
                torch_trace(spec, name, shape, dt, p * k))
                for k in PASS_MULTIPLES)
            (out_dir / f"{stem}.ops").write_text(text)
            case["file"] = f"{stem}.ops"
        else:
            rec = mb.launch_record(name, dt, shape, knobs, p, sms, l2)
            for r in rec:
                kernels.setdefault(r["source"], set()).add(r["kernel"])
                sass.get(r["source"])
            case["launches"] = json_record(rec)
        manifest["cases"].append(case)
    for source, names in sorted(kernels.items()):
        names.add(mb.FOLD_KERNEL)
        (out_dir / f"{source}.sass").write_text(
            prune_sass(sass.texts[source], names))
    (out_dir / "manifest.json").write_text(
        json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    return manifest


def read_trace_file(path) -> list:
    """The traces of a golden ``.ops`` file, one list per ``# passes=``
    section."""
    from repro_torch.istream.analyze import parse_trace
    sections, cur = [], None
    for line in Path(path).read_text().splitlines(keepends=True):
        if line.startswith("# passes="):
            cur = []
            sections.append(cur)
        elif cur is not None:
            cur.append(line)
    return [parse_trace("".join(s)) for s in sections]


def audit_goldens(golden_dir) -> AuditReport:
    """Deviceless audit over a golden directory's manifest: torch cases
    over their ``.ops`` traces, cuda cases over the ``<source>.sass`` files
    for the card the manifest names."""
    from repro_torch.istream.extract import parse_sass
    golden_dir = Path(golden_dir)
    manifest = json.loads((golden_dir / "manifest.json").read_text())
    shape = tuple(manifest["shape"])
    machine = (manifest["sms"], manifest["l2"])
    report = AuditReport(meta={"goldens": str(golden_dir),
                               "shape": list(shape),
                               "dtype": manifest["dtype"],
                               "passes": manifest["passes"],
                               "machine": list(machine),
                               "source": "goldens"})
    sass: dict[str, dict] = {}
    for path in sorted(golden_dir.glob("*.sass")):
        sass[path.stem] = parse_sass(path.read_text())
    for case in manifest["cases"]:
        unroll = case.get("unroll", manifest.get("unroll", 1))
        knobs = dict(case.get("knobs") or {})
        dt = case.get("dtype", manifest["dtype"])
        p = case.get("passes", manifest["passes"])
        if case["backend"] == "torch":
            report.cases.append(audit_trace(
                read_trace_file(golden_dir / case["file"]), case["mix"],
                shape, dt, p, unroll, knobs))
        else:
            report.cases.append(audit_sass(
                sass, case["mix"], shape, dt, p, unroll, knobs, machine,
                launches=case.get("launches")))
    return report

"""The Runner — pass-picking, warmup, serialized timing, result assembly.

This is the ONE measurement loop of the package: the CLI and every caller
hand it a BenchSpec; it owns the repetition discipline (warmup + reps via
``core.timing``), the pass-picking policy (enough internal passes that one
timed call moves ``target_bytes`` — the paper's measurement-loop sizing), and
emits a schema-versioned BenchResult.

Memory discipline: working sets are built lazily, one size at a time, and
released as soon as that size's cases are timed — peak footprint is one
working set (plus companions, e.g. triad's second stream), not the sum of
every size in the sweep.  Cases are cached per Runner instance, keyed by
(backend, mix, shape, dtype, passes, knobs): a knob sweep via ``run_many`` or
a ``compare`` reuses them, and a cached case never closes over a buffer (see
bench.backends).

Counterpart of ``repro.bench.runner``.  The one addition is the explicit
device: ``Runner(device=...)`` (None = ``cuda``) says where the working sets
live and what the timing serializes on; it is an argument, not a spec field,
so spec JSON stays interchangeable with the reference's.  Taking the default
with no CUDA device present raises.  A multi-device backend spreads its mesh
over the pool of that device's kind (``core.device.device_pool``): the
Runner asks it to check its devices while planning (``check_devices``) and
to make each working set shard by shard (``working_set``).
"""
from __future__ import annotations

from repro_torch.bench.backends import get_backend
from repro_torch.bench.result import (REP_SAMPLE_LIMIT, BenchPoint, BenchResult,
                                machine_meta)
from repro_torch.bench.spec import BenchSpec, BenchSpecError
from repro_torch.obs import metrics, trace


#: serial dependent-load steps per timed call for chase mixes — the latency
#: analogue of ``target_bytes``.  A pointer chase is ~2 orders of magnitude
#: slower per byte than a bandwidth sweep (each load waits out the full
#: access latency), so sizing its passes by target_bytes over-provisions the
#: wall time of a timed call by the same factor; size by total chain steps
#: instead.
CHASE_TARGET_STEPS = 2 ** 17


def pick_passes(nbytes: int, target_bytes: float = 2e8, mix=None,
                n_elems: int | None = None, devices: int = 1) -> int:
    """Enough passes that one timed call moves ~target_bytes (>= ms-scale).

    Chase mixes are sized per-mix instead: enough passes that one call walks
    ~``CHASE_TARGET_STEPS`` dependent steps (per probe shard — on a mesh the
    probe walks its ``1/devices`` slice), because a dependent chain's wall
    time scales with steps x latency, not bytes / bandwidth."""
    if mix is not None and getattr(mix, "chase", False):
        steps = max(1, (n_elems if n_elems else nbytes // 4)
                    // max(devices, 1))
        return max(1, CHASE_TARGET_STEPS // steps)
    return max(1, int(target_bytes / max(nbytes, 1)))


def _chase_accounting(mix, spec: BenchSpec, real_bytes: int, n_elems: int,
                      passes: int) -> tuple[float, float]:
    """Bytes/flops per timed call for a chase (latency-probe) case.

    Probe traffic: idle (load=0) every shard walks its own cycle, touching
    the whole buffer per pass; in a loaded composite only shard 0 walks its
    ``1/devices`` slice (devices=1 on the single-device backends).
    Generator traffic: each of the ``load`` generators performs
    ``GEN_SWEEPS_PER_PASS`` load_sum sweeps of its ``1/devices`` slice per
    probe pass — the same formula both backends' composite kernels execute,
    so the bytes_per_call a chase point reports is total composite traffic
    (probe + generators).  Flops: the probe does none; each generator
    element costs one load_sum add."""
    from repro_torch.bench.mixes import GEN_SWEEPS_PER_PASS
    k = max(spec.devices, 1)
    probe_bytes = mix.bytes_per_pass(real_bytes) / (k if spec.load else 1)
    gen_elems = spec.load * GEN_SWEEPS_PER_PASS * (n_elems / k)
    gen_bytes = gen_elems * (real_bytes / n_elems)
    return (probe_bytes + gen_bytes) * passes, gen_elems * passes


class Runner:
    """Executes BenchSpecs on one device.  Stateless apart from the backend
    registry and the case cache (kernels only — never working-set
    buffers)."""

    def __init__(self, device=None):
        from repro_torch.core.device import resolve_device
        self.device = resolve_device(device)    # raises: no silent CPU run
        self._cases: dict[tuple, object] = {}   # case_key -> compiled case
        self.cache_hits = 0
        self.cache_misses = 0

    # -- compiled-case cache --------------------------------------------
    def _case(self, backend, spec: BenchSpec, mix, shape, dtype, passes: int):
        """Cache-aware make_case; returns the compiled callable-of-buffers.
        Every lookup emits a ``cache`` trace event with its outcome and
        bumps the matching obs counter — the result's ``meta["obs"]``
        counters and the trace agree by construction."""
        tr = trace.get_tracer()
        key = backend.case_key(spec, mix, shape, dtype, passes)
        case = self._cases.get(key)
        if case is None:
            self.cache_misses += 1
            metrics.REGISTRY.inc("cache_misses")
            tr.event("cache", outcome="miss", mix=mix.name,
                     backend=backend.name)
            with tr.span("case.build", mix=mix.name, backend=backend.name,
                         passes=passes):
                case = backend.make_case(spec, mix, shape, dtype, passes)
            self._cases[key] = case
        else:
            self.cache_hits += 1
            metrics.REGISTRY.inc("cache_hits")
            tr.event("cache", outcome="hit", mix=mix.name,
                     backend=backend.name)
        return case

    def run(self, spec: BenchSpec, extra_meta: dict | None = None
            ) -> BenchResult:
        """Execute one spec.  Observability (repro.obs): the whole run is a
        ``runner.run`` span with ``runner.plan`` and per-size ``runner.size``
        children (buffer build/release, per-case timing), the obs counter
        registry collects this run's delta (cache outcomes, buffer
        lifecycle, peak working set), and both land in ``meta["obs"]``
        (result schema v6) together with the Runner's cumulative cache
        counters — which previously died with the Runner object."""
        tr = trace.get_tracer()
        with metrics.REGISTRY.scope() as mscope, \
                tr.span("runner.run", backend=spec.backend,
                        mixes=list(spec.mixes), sizes=list(spec.sizes),
                        devices=spec.devices):
            res = self._run_traced(spec, extra_meta, tr)
            obs = mscope.delta()
            # THIS run's peak, not the scope delta: the global gauge is a
            # process-lifetime high-water mark, so a run smaller than an
            # earlier one would otherwise report no peak at all
            if res.points:
                obs.setdefault("gauges", {})["peak_working_set_bytes"] = \
                    max(p.nbytes for p in res.points)
            obs["runner"] = {"cache_hits": self.cache_hits,
                             "cache_misses": self.cache_misses}
            res.meta["obs"] = obs
        return res

    def _run_traced(self, spec: BenchSpec, extra_meta, tr) -> BenchResult:
        from repro_torch.bench.mixes import get_mix
        from repro_torch.core import buffers, timing

        # plan every case up front from shapes alone (no buffers yet): a
        # data-dependent knob error (block_rows / streams / devices not
        # dividing some size) surfaces before any timing is spent, and the
        # compiled-case cache is populated without retaining working sets.
        # (build()-only third-party backends get no shape pre-check — their
        # data-dependent errors surface lazily, when their size is reached)
        plan = []       # (nbytes, shape, [(mix, passes, case|None, bpc, fpc)])
        dtype = buffers.as_dtype(spec.dtype)
        isz = buffers.itemsize(dtype)
        with tr.span("runner.plan", sizes=len(spec.sizes),
                     mixes=len(spec.mixes)):
            backend = get_backend(spec.backend)
            backend.validate(spec)
            check_devices = getattr(backend, "check_devices", None)
            if check_devices is not None:   # a mesh: do its devices exist?
                check_devices(spec, self.device)
            cacheable = hasattr(backend, "make_case")
            for nbytes in spec.sizes:
                shape = buffers.working_set_shape(nbytes, dtype=dtype)
                n_elems = shape[0] * shape[1]
                real_bytes = n_elems * isz
                group = []
                for name in spec.mixes:
                    mix = get_mix(name)
                    # per-MIX pass picking: a chase mix is sized by chain
                    # steps, a bandwidth mix by bytes (same answer for
                    # uniform specs)
                    passes = spec.passes or pick_passes(
                        real_bytes, spec.target_bytes, mix=mix,
                        n_elems=n_elems, devices=spec.devices)
                    if passes % spec.unroll:
                        # auto-picked passes round UP to whole unrolled loop
                        # bodies (explicit spec.passes is validated to divide)
                        passes += spec.unroll - passes % spec.unroll
                    case = (self._case(backend, spec, mix, shape, dtype,
                                       passes)
                            if cacheable else None)
                    if mix.chase:
                        bpc, fpc = _chase_accounting(mix, spec, real_bytes,
                                                     n_elems, passes)
                    else:
                        bpc = mix.bytes_per_pass(real_bytes) * passes
                        fpc = mix.flops_per_pass(n_elems) * passes
                    group.append((mix, passes, case, bpc, fpc))
                plan.append((real_bytes, shape, group))

        with tr.span("runner.meta"):
            res = BenchResult(
                spec=spec.to_dict(), machine=machine_meta(self.device),
                meta={"dtype": spec.dtype, "reps": spec.reps,
                      "sizes": list(spec.sizes), "mixes": list(spec.mixes),
                      **(extra_meta or {})})
        prepare = getattr(backend, "prepare_buffer", None)
        # a mesh makes each shard where it lives (never the whole set on one
        # device first)
        make = getattr(backend, "working_set", None)
        for nbytes, (real_bytes, shape, group) in zip(spec.sizes, plan):
            with tr.span("runner.size", nbytes=real_bytes):
                # lazy build: exactly one working set lives at a time
                with tr.span("buffers.build", nbytes=real_bytes):
                    if make is not None:
                        x = make(spec, nbytes, dtype, self.device)
                    else:
                        x = buffers.working_set(nbytes, dtype=dtype,
                                                value=spec.value,
                                                device=self.device)
                    if prepare is not None:  # e.g. sharded: one mesh
                        x = prepare(spec, x)  # placement, shared per size
                metrics.REGISTRY.inc("buffers_built")
                metrics.REGISTRY.gauge_max("peak_working_set_bytes",
                                           real_bytes)
                for mix, passes, case, bpc, fpc in group:
                    with tr.span("runner.case", mix=mix.name, passes=passes,
                                 reps=spec.reps):
                        if case is not None:
                            fn = backend.bind_case(case, spec, mix, x)
                        else:
                            fn = backend.build(spec, mix, x, passes)
                        t = timing.time_fn(fn, reps=spec.reps,
                                           warmup=spec.warmup,
                                           bytes_per_call=bpc,
                                           flops_per_call=fpc,
                                           device=self.device)
                        del fn  # drop companions with the case binding
                    latency_ns = gen_gbps = None
                    if mix.chase:
                        # the Mess-curve coordinates: ns per dependent step
                        # of the probe shard's walk, and aggregate generator
                        # GB/s
                        from repro_torch.bench.mixes import GEN_SWEEPS_PER_PASS
                        k = max(spec.devices, 1)
                        n_elems = shape[0] * shape[1]
                        steps = passes * max(n_elems // k, 1)
                        latency_ns = t.mean_s * 1e9 / steps
                        gen_bytes = (spec.load * GEN_SWEEPS_PER_PASS
                                     * real_bytes / k) * passes
                        gen_gbps = gen_bytes / t.mean_s / 1e9
                    res.points.append(BenchPoint(
                        nbytes=real_bytes, nbytes_requested=nbytes,
                        mix=mix.name, dtype=spec.dtype,
                        backend=spec.backend, passes=passes,
                        streams=spec.streams,
                        block_rows=spec.block_rows, reps=spec.reps,
                        bytes_per_call=bpc, flops_per_call=fpc,
                        mean_s=t.mean_s, std_s=t.std_s, min_s=t.min_s,
                        gbps=t.gbps, gflops=t.gflops, devices=spec.devices,
                        unroll=spec.unroll, interleave=spec.interleave,
                        load=spec.load, latency_ns=latency_ns,
                        gen_gbps=gen_gbps,
                        rep_times_s=t.samples(REP_SAMPLE_LIMIT)))
                del x       # release this size before building the next
                metrics.REGISTRY.inc("buffers_released")
                tr.event("buffers.release", nbytes=real_bytes)
        return res

    def run_many(self, specs, extra_meta: dict | None = None) -> BenchResult:
        """Run several specs into one result (e.g. a streams / block_rows
        sweep, where the knob lives on the spec rather than the point
        list).  With more than one distinct spec the envelope records all of
        them (``spec["many"]``) and the meta knob lists (``sizes``/``mixes``)
        are the union across the merged specs; each point carries its own
        knobs regardless.  Cases are shared across the specs (the
        Runner-level cache)."""
        results = [self.run(s, extra_meta=extra_meta) for s in specs]
        if not results:
            raise ValueError("run_many needs at least one spec")
        merged = results[0]
        for r in results[1:]:
            merged.points.extend(r.points)
        # the envelope must describe ALL merged points, not results[0]'s
        merged.meta["sizes"] = sorted({s for r in results
                                       for s in r.meta["sizes"]})
        mixes: list[str] = []
        for r in results:
            mixes.extend(m for m in r.meta["mixes"] if m not in mixes)
        merged.meta["mixes"] = mixes
        # dtype/reps likewise: results[0]'s scalar silently misdescribed a
        # merge of disagreeing specs — stay scalar when uniform (the common
        # knob sweep), union to a first-seen-ordered list when not (each
        # point still carries its own dtype/reps regardless)
        for key in ("dtype", "reps"):
            vals: list = []
            for r in results:
                v = r.meta[key]
                for item in (v if isinstance(v, list) else [v]):
                    if item not in vals:
                        vals.append(item)
            merged.meta[key] = vals[0] if len(vals) == 1 else vals
        # obs counters fold across the merged runs (sum counters, max
        # gauges); the Runner-cumulative block already spans them all
        merged.meta["obs"] = metrics.merge_obs(
            [r.meta["obs"] for r in results if "obs" in r.meta])
        spec_dicts = [r.spec for r in results]
        if any(d != spec_dicts[0] for d in spec_dicts[1:]):
            merged.spec = {"spec_version": spec_dicts[0]["spec_version"],
                           "many": spec_dicts}
        return merged

    def compare(self, spec: BenchSpec, backends=("torch", "cuda")
                ) -> dict[str, BenchResult]:
        """The same spec on several backends — the paper's
        oracle-vs-embodiment cross-check.  Mixes are filtered per backend by
        *full* validation (support set and knob combinations), so e.g.
        ``streams=4`` keeps load_sum on torch and drops copy rather than
        aborting the whole comparison.  Nothing is dropped silently: every
        skipped (backend, mix) lands in each result's
        ``meta["skipped"] = {backend: [[mix, reason], ...]}``, and if *no*
        backend can run the spec the skip map is raised as a BenchSpecError
        instead of returning an empty dict."""
        out: dict[str, BenchResult] = {}
        skipped: dict[str, list[list[str]]] = {}
        for b in backends:
            names = []
            for m in spec.mixes:
                try:
                    sub = spec.replace(backend=b, mixes=(m,))
                    get_backend(b).validate(sub)
                except (BenchSpecError, KeyError) as e:
                    skipped.setdefault(b, []).append([m, str(e)])
                    continue
                names.append(m)
            if not names:
                continue
            try:
                out[b] = self.run(spec.replace(backend=b, mixes=tuple(names)))
            except BenchSpecError as e:
                # data-dependent constraint (e.g. streams vs. block count for
                # this buffer): this backend can't run the spec — record it
                skipped.setdefault(b, []).extend([m, str(e)] for m in names)
                continue
        if not out:
            raise BenchSpecError(f"no backend could run the spec; "
                                 f"skipped: {skipped}")
        if skipped:
            for res in out.values():
                res.meta["skipped"] = skipped
        return out


def run(spec: BenchSpec, device=None, **kw) -> BenchResult:
    """Module-level convenience: ``repro_torch.bench.run(spec)``."""
    return Runner(device=device).run(spec, **kw)

"""Per-case instruction profiles: observe, cache, bound.

Counterpart of ``repro.istream.analyze``.  Where the reference lowers a case
to optimized HLO and reads its pass loop, the port reads what runs:

* ``cuda``: the SASS of the hand-written kernels.  ``membench.launch_record``
  says which template instances one timed call launches, with which grid,
  block and arguments; ``istream.emulate`` runs each launch's SASS and counts
  what every thread executes (global load / store bytes, shared-memory bytes,
  arithmetic elements, warp instructions).
* ``torch`` (the counterpart of ``xla``): the aten operations one call of the
  case dispatches, under a ``TorchDispatchMode`` that weights each operation
  by the elements it reads, writes and computes (``weigh_op``), plus the host
  reads of a tensor turned into a list (the chase walks one: each read is a
  dependent load, and the chain of them is its critical path).

Either way the case runs at ``passes`` = p, 2p and 3p.  The per-pass profile
is the difference between p and 2p, divided by p, which drops what a call
does once (set-up, the fold of partial sums); the difference between 2p and
3p must equal it (``linear``): the timed work repeats once per pass.  That is
the ``trips`` check of the audit, since neither eager code nor a kernel's
remainder loops show one loop whose trip count is the pass count.  What a
call does once is kept as ``per_call``.

The torch side runs on ``meta`` tensors from ``Backend.abstract_args`` (no
working set is built), but for the chase's permutation buffer, which is a
CPU tensor holding ``chase_perm`` (its walk reads the values).

``bounds`` and ``fit_issue_rate`` are the reference's.  A profile's issue
work is ``per_iter["issue"]``: warp instructions on ``cuda``, element-ops
(loads + stores + arith + move, the reference's unit) on ``torch``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.bench.backends import case_knobs, get_backend
from repro_torch.bench.spec import BenchSpec

#: the counters a profile holds per pass
COUNTERS = ("loads", "stores", "arith", "move", "issue", "ops")
#: pass multiples a case is observed at (p, 2p, 3p)
PASS_MULTIPLES = (1, 2, 3)


@dataclass(frozen=True)
class InstructionProfile:
    """Per-pass-loop-iteration instruction profile of one case (one
    iteration covers ``unroll`` passes, as in the reference)."""
    mix: str
    backend: str
    shape: tuple
    dtype: str
    nbytes: int                 # working-set bytes (joins against BenchPoint)
    unroll: int
    interleave: int
    per_iter: dict              # loads/stores/arith/move/issue/ops/opcodes
    critical_path: float        # longest dependent-load chain of a pass
    trips: int                  # passes/unroll when the work repeats per pass
    passes: int                 # the passes it was observed at (p)
    loop: str | None            # where the passes run (None: not found)

    @property
    def issue_elems_per_iter(self) -> float:
        """Issue work per loop iteration (warp instructions on cuda,
        element-ops on torch)."""
        c = self.per_iter
        if "issue" in c:
            return c["issue"]
        return c["loads"] + c["stores"] + c["arith"] + c["move"]

    def issue_elems_per_call(self, passes: int | None = None) -> float:
        """Issue work per timed call: one iteration covers ``unroll``
        passes, so a call at ``passes`` runs passes/unroll iterations."""
        p = self.passes if passes is None else passes
        return self.issue_elems_per_iter * max(p // max(self.unroll, 1), 1)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(d["shape"])
        return d


def profile_join_key(backend: str, mix: str, unroll: int, interleave: int,
                     nbytes: int) -> tuple:
    """The coordinates shared by a BenchPoint and its profile."""
    return (backend, mix, unroll, interleave, nbytes)


def point_join_key(p) -> tuple:
    return profile_join_key(p.backend, p.mix, p.unroll, p.interleave,
                            p.nbytes)


class ProfileCache:
    """Profiles keyed like the Runner's case cache but passes-free (the
    per-pass profile does not depend on how many passes a call runs)."""

    def __init__(self):
        self._profiles: dict[tuple, InstructionProfile] = {}
        self.hits = 0
        self.misses = 0

    def key(self, spec: BenchSpec, mix, shape, dtype) -> tuple:
        mix_name = getattr(mix, "name", mix)
        return (spec.backend, mix_name, tuple(shape), str(dtype),
                case_knobs(spec))

    def get(self, spec, mix, shape, dtype) -> InstructionProfile | None:
        prof = self._profiles.get(self.key(spec, mix, shape, dtype))
        if prof is not None:
            self.hits += 1
        return prof

    def put(self, spec, mix, shape, dtype,
            prof: InstructionProfile) -> InstructionProfile:
        self.misses += 1
        self._profiles[self.key(spec, mix, shape, dtype)] = prof
        return prof

    def __len__(self) -> int:
        return len(self._profiles)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _itemsize(dtype) -> int:
    import numpy as np
    name = _dtype_name(dtype)
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


def spec_knobs(spec: BenchSpec) -> dict:
    """The knobs of a spec that shape a case (the audit's ``knobs``)."""
    return {"streams": spec.streams, "block_rows": spec.block_rows,
            "unroll": spec.unroll, "interleave": spec.interleave,
            "load": spec.load}


# -- torch: the aten operations of one call ----------------------------------

#: operations that move no data (views, metadata, allocation)
FREE_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "select", "slice", "as_strided",
    "expand", "alias", "detach", "t", "transpose", "permute", "unsqueeze",
    "squeeze", "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty", "_reshape_alias", "unbind", "split", "view_as",
    "resolve_conj", "resolve_neg", "split_with_sizes", "unsafe_split",
})
#: operations that copy or fill (data movement, no arithmetic)
MOVE_OPS = frozenset({
    "copy_", "_to_copy", "clone", "cat", "stack", "zeros", "zeros_like",
    "full", "full_like", "fill_", "zero_", "index_put_", "index_put",
    "slice_scatter", "select_scatter", "scalar_tensor", "ones", "ones_like",
    "new_zeros", "new_full", "index", "gather", "masked_fill_",
    "_local_scalar_dense", "lift_fresh_copy", "tensor", "eye",
})
#: reductions: every input element is one arithmetic element-op
REDUCE_OPS = frozenset({"sum", "mean", "amax", "amin", "prod", "max", "min",
                        "argmax", "argmin", "norm", "linalg_vector_norm"})
#: products: 2 K element-ops per output element
MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "matmul", "baddbmm"})
#: elementwise arithmetic the weighting knows (anything else is unknown)
ARITH_OPS = frozenset({
    "add", "add_", "sub", "sub_", "mul", "mul_", "div", "div_", "neg",
    "abs", "exp", "log", "sqrt", "rsqrt", "pow", "maximum", "minimum",
    "clamp", "where", "addcmul", "addcdiv", "lerp", "rsub", "reciprocal",
    "eq", "ne", "lt", "le", "gt", "ge", "bitwise_and", "bitwise_or",
    "remainder", "fmod", "sign", "floor", "ceil", "round", "tanh",
    "sigmoid", "relu",
})


def weigh_op(name: str, in_numels: list[int], out_numels: list[int],
             k_depth: int = 1) -> dict:
    """Elements one aten operation reads (``loads``), writes (``stores``),
    computes (``arith``) and copies (``move``).  Views are free; a product
    computes 2 K element-ops per output element (``k_depth`` = K), a
    reduction one per input element, an elementwise operation one per
    output element; an operation the table does not know is counted as
    arithmetic and under ``unknown``."""
    out = {"loads": 0, "stores": 0, "arith": 0, "move": 0, "ops": 0,
           "unknown": 0}
    if name in FREE_OPS:
        return out
    out["ops"] = 1
    out["loads"] = sum(in_numels)
    out["stores"] = sum(out_numels)
    if name in MOVE_OPS:
        out["move"] = sum(out_numels)
    elif name in REDUCE_OPS:
        out["arith"] = sum(in_numels[:1])
    elif name in MATMUL_OPS:
        out["arith"] = 2 * k_depth * sum(out_numels)
    elif name in ARITH_OPS:
        out["arith"] = sum(out_numels)
    else:
        out["arith"] = sum(out_numels)
        out["unknown"] = sum(out_numels)
    return out


def _host_view_class(counter: dict):
    """A tensor subclass whose ``tolist()`` returns a list that counts its
    reads (``counter["reads"]``) and the longest chain of reads each
    indexed by the value the previous one returned (``counter["chain"]``):
    the chase walks such a list, one dependent load a step."""
    import torch

    class _CountingList(list):
        def __getitem__(self, i):
            v = list.__getitem__(self, i)
            counter["reads"] += 1
            counter["run"] = counter["run"] + 1 \
                if counter["last"] == i else 1
            counter["chain"] = max(counter["chain"], counter["run"])
            counter["last"] = v
            return v

    class _HostView(torch.Tensor):
        @classmethod
        def __torch_function__(cls, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            with torch._C.DisableTorchFunctionSubclass():
                out = func(*args, **kwargs)
            if func is torch.Tensor.tolist and isinstance(out, list):
                return _CountingList(out)
            if func is torch.Tensor.reshape and isinstance(out, torch.Tensor):
                return out.as_subclass(cls)
            return out

    return _HostView


def torch_trace(spec: BenchSpec, mix_name: str, shape, dtype,
                passes: int) -> list[tuple]:
    """The aten operations of one timed call of the ``torch`` case, each as
    (name, input numels, output numels, K), and the host reads as
    ``("host.read", (reads,), (), chain)``.  Runs on meta tensors
    (``TorchBackend.abstract_args``)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from repro_torch.bench.mixes import get_mix

    backend = get_backend(spec.backend)
    mix = get_mix(mix_name)
    dtype = getattr(torch, _dtype_name(dtype))
    case = backend.make_case(spec, mix, tuple(shape), dtype, passes)
    args = list(backend.abstract_args(spec, mix, shape, dtype))
    counter = {"reads": 0, "chain": 0, "run": 0, "last": None}
    if mix.chase:
        args[0] = args[0].as_subclass(_host_view_class(counter))
    ops: list[tuple] = []

    class _Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            kw = kw or {}
            out = func(*a, **kw)
            # an ``out=`` tensor is written, not read
            read = (a, {k: v for k, v in kw.items() if k != "out"})
            ins = [t.numel() for t in tree_flatten(read)[0]
                   if isinstance(t, torch.Tensor)]
            outs = [t.numel() for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor)]
            name = func.overloadpacket.__name__
            k = 1
            if name in MATMUL_OPS:
                tensors = [t for t in tree_flatten((a, kw))[0]
                           if isinstance(t, torch.Tensor)]
                k = int(tensors[-1].shape[-2]) if tensors and \
                    tensors[-1].dim() >= 2 else 1
            if "out" in kw and not outs:
                outs = [t.numel() for t in tree_flatten(kw["out"])[0]]
            if name.endswith("_") and not outs:
                outs = ins[:1]
            ops.append((name, tuple(ins), tuple(outs), k))
            return out

    with _Record():
        case(*args)
    if counter["reads"]:
        ops.append(("host.read", (counter["reads"],), (), counter["chain"]))
    return ops


def format_trace(ops: list[tuple]) -> str:
    """A torch trace as text, one operation a line (the goldens' form)."""
    return "".join(f"{name} in={','.join(map(str, ins))} "
                   f"out={','.join(map(str, outs))} k={k}\n"
                   for name, ins, outs, k in ops)


def parse_trace(text: str) -> list[tuple]:
    ops = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        name, ins, outs, k = line.split()

        def nums(field):
            v = field.split("=", 1)[1]
            return tuple(int(x) for x in v.split(",") if x)
        ops.append((name, nums(ins), nums(outs), int(k.split("=")[1])))
    return ops


def torch_counts(ops: list[tuple]) -> dict:
    """Element counts of a torch trace (``weigh_op`` per operation; the
    host reads are loads, their longest chain the critical path)."""
    c = {k: 0 for k in COUNTERS}
    c.update(opcodes={}, unknown={}, chain=0)
    for name, ins, outs, k in ops:
        if name == "host.read":
            c["loads"] += ins[0]
            c["chain"] = max(c["chain"], k)
            continue
        w = weigh_op(name, list(ins), list(outs), k)
        for key in ("loads", "stores", "arith", "move", "ops"):
            c[key] += w[key]
        if w["ops"]:
            c["opcodes"][name] = c["opcodes"].get(name, 0) + 1
        if w["unknown"]:
            c["unknown"][name] = c["unknown"].get(name, 0) + w["unknown"]
    c["issue"] = c["loads"] + c["stores"] + c["arith"] + c["move"]
    return c


# -- cuda: the SASS of the launches of one call ------------------------------

def sass_counts(launches: list[dict], sass: dict, itemsize: int) -> dict:
    """Counts of one call's launches (``membench.launch_record``), each
    launch's SASS run by ``istream.emulate``; ``sass`` maps a source file
    to its kernels (``extract.parse_sass``).  Loads, stores and move
    (shared memory) in elements of ``itemsize`` bytes."""
    from repro_torch.istream.emulate import LaunchCounts, emulator_for
    total = LaunchCounts()
    for rec in launches:
        kernels = sass.get(rec["source"]) or {}
        if rec["kernel"] not in kernels:
            raise KeyError(f"kernel {rec['kernel']} of {rec['source']} is "
                           f"not in its SASS (the launch record and the "
                           f"build disagree)")
        total.add(_run_launch(emulator_for(rec["kernel"],
                                           kernels[rec["kernel"]]), rec),
                  rec.get("times", 1))
    return {"loads": total.load_bytes / itemsize,
            "stores": total.store_bytes / itemsize,
            "arith": float(total.arith),
            "move": total.shared_bytes / itemsize,
            "issue": float(total.warp_instructions),
            "ops": float(total.thread_instructions),
            "opcodes": dict(total.opcodes), "unknown": {},
            "chain": total.load_chain}


_launch_cache: dict[tuple, object] = {}


def _run_launch(emu, rec: dict):
    """One launch's counts, cached by kernel and arguments (a chase call
    repeats the same launch once a pass)."""
    from repro_torch.istream.emulate import pack_params
    params = pack_params(rec["params"])
    key = (id(emu), tuple(rec["grid"]), rec["threads"], params)
    hit = _launch_cache.get(key)
    if hit is None:
        if len(_launch_cache) > 4096:
            _launch_cache.clear()
        hit = _launch_cache[key] = emu.run(tuple(rec["grid"]),
                                           rec["threads"], params)
    return hit


def json_record(launches: list[dict]) -> list[dict]:
    """A launch record with its by-value bytes as hex (JSON-safe)."""
    return [dict(r, params=[[k, v.hex()] if k == "bytes" else [k, v]
                            for k, v in r["params"]]) for r in launches]


def machine_of(device=None) -> tuple[int, int]:
    """(SMs, L2 bytes) of the CUDA device."""
    from repro_torch.kernels.membench import membench as mb
    dev = device if device is not None else "cuda"
    return mb.sm_count(dev), mb.l2_bytes(dev)


def card_clock_mhz() -> float:
    """The card's maximum SM clock (``nvidia-smi --query-gpu=
    clocks.max.sm``, the first card), in MHz."""
    import subprocess
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


class LiveSass:
    """The SASS of the membench libraries built from this checkout's
    sources: ``cuobjdump`` is required first (and raises naming it), then
    the libraries are built (``nvcc``) and dumped once each."""

    def __init__(self):
        from repro_torch.istream.extract import find_cuobjdump
        find_cuobjdump()
        self._parsed: dict[str, dict] = {}
        self.texts: dict[str, str] = {}

    def get(self, source: str, default=None):
        if source not in self._parsed:
            from repro_torch.istream.extract import dump_sass, parse_sass
            from repro_torch.kernels.membench import membench as mb
            path = mb.LIBRARY.build_all()[source]
            self.texts[source] = dump_sass(path)
            self._parsed[source] = parse_sass(self.texts[source])
        return self._parsed.get(source, default)

    __getitem__ = get


def record_case(spec: BenchSpec, mix_name: str, shape, dtype, passes: int,
                sass=None, machine=None) -> dict:
    """What one timed call of a case runs, at ``passes`` x (1, 2, 3) — the
    port's counterpart of the reference's ``lower_case`` (and, like it, the
    step the goldens share).  ``torch``: ``{"backend", "traces"}``, the
    aten traces; ``cuda``: ``{"backend", "launches", "counts"}``, the
    launch records and their emulated counts over ``sass`` (a mapping
    source -> kernels; ``LiveSass()`` by default) on a card of ``machine``
    = (SMs, L2 bytes) (the current device by default)."""
    if spec.backend == "torch":
        return {"backend": "torch",
                "traces": [torch_trace(spec, mix_name, shape, dtype,
                                       passes * k) for k in PASS_MULTIPLES]}
    if spec.backend != "cuda":
        raise TypeError(f"backend {spec.backend!r}: istream observes the "
                        f"torch and cuda case backends")
    from repro_torch.kernels.membench import membench as mb
    sms, l2 = machine if machine is not None else machine_of()
    sass = sass if sass is not None else LiveSass()
    knobs = spec_knobs(spec)
    launches = [mb.launch_record(mix_name, _dtype_name(dtype), shape, knobs,
                                 passes * k, sms, l2)
                for k in PASS_MULTIPLES]
    itemsize = _itemsize(dtype)
    return {"backend": "cuda", "launches": launches, "machine": (sms, l2),
            "counts": [sass_counts(r, sass, itemsize) for r in launches],
            "sass": sass}


def _pass_loop(record: dict, passes: int) -> str | None:
    """Where the passes of a cuda call run, checked against the record:
    ``launches`` (a launch a pass), ``grid.y`` (the passes are the grid's
    slow dimension) or ``sass:<loop>`` (the first loop of the kernel's
    SASS that holds global loads or stores: the pass loop is inside);
    None when the record and the code do not bear it out."""
    from repro_torch.istream.extract import decode, kernel_loops
    launches = record["launches"][0]
    main = launches[0]
    runs = [r for r in launches if r["kernel"] == main["kernel"]]
    if main["axis"] == "launch":
        return "launches" if sum(r["times"] for r in runs) == passes \
            else None
    if main["axis"] == "grid.y":
        return "grid.y" if sum(r["grid"][1] * r["times"] for r in runs) \
            == passes else None
    for loop in kernel_loops(decode(record["sass"][main["source"]]
                                    [main["kernel"]])):
        if loop.per_trip["loads"] or loop.per_trip["stores"]:
            return f"sass:{loop.start:#x}"
    return None


def profile_from_record(record: dict, spec: BenchSpec, mix_name: str, shape,
                        dtype, passes: int) -> InstructionProfile:
    """Counts at p, 2p, 3p -> InstructionProfile (the per-pass difference,
    scaled to one loop iteration of ``unroll`` passes)."""
    from repro_torch.bench.mixes import get_mix
    mix = get_mix(mix_name)
    if record["backend"] == "torch":
        counts = [torch_counts(t) for t in record["traces"]]
        loop = "eager"
    else:
        counts = record["counts"]
        loop = _pass_loop(record, passes)
    c1, c2, c3 = counts
    unroll = max(spec.unroll, 1)
    d1 = {k: (c2[k] - c1[k]) / passes for k in COUNTERS}
    d2 = {k: (c3[k] - c2[k]) / passes for k in COUNTERS}
    linear = all(abs(d1[k] - d2[k]) <= 1e-9 * max(abs(d1[k]), 1.0)
                 for k in ("loads", "stores"))
    per_iter = {k: d1[k] * unroll for k in COUNTERS}
    per_iter["opcodes"] = {k: (c2["opcodes"].get(k, 0) - v) / passes * unroll
                           for k, v in c1["opcodes"].items()}
    per_iter["unknown"] = dict(c1.get("unknown") or {})
    per_iter["per_call"] = {k: c1[k] - passes * d1[k]
                            for k in ("loads", "stores", "arith")}
    per_iter["linear"] = linear
    chain = (c2["chain"] - c1["chain"]) / passes if record["backend"] == \
        "torch" else c1["chain"]
    n_elems = 1
    for d in shape:
        n_elems *= d
    return InstructionProfile(
        mix=mix.name, backend=spec.backend, shape=tuple(shape),
        dtype=_dtype_name(dtype), nbytes=n_elems * _itemsize(dtype),
        unroll=spec.unroll, interleave=spec.interleave, per_iter=per_iter,
        critical_path=float(max(chain, 1)),
        trips=max(passes // unroll, 1) if linear else 0,
        passes=passes, loop=loop)


def analyze_case(spec: BenchSpec, mix_name: str, shape, dtype, passes: int,
                 runner=None, cache: ProfileCache | None = None, sass=None,
                 machine=None) -> InstructionProfile:
    """The instruction profile of one case (``record_case`` ->
    ``profile_from_record``, with caching).  ``runner`` is accepted for the
    reference's signature; the case is rebuilt here (``make_case`` on
    abstract arguments), never timed."""
    from repro_torch.bench.mixes import get_mix
    del runner
    mix = get_mix(mix_name)
    if cache is not None:
        prof = cache.get(spec, mix, shape, _dtype_name(dtype))
        if prof is not None:
            if prof.passes != passes:
                prof = dataclasses.replace(
                    prof, passes=passes,
                    trips=max(passes // max(spec.unroll, 1), 1)
                    if prof.trips else 0)
            return prof
    record = record_case(spec, mix_name, shape, dtype, passes, sass=sass,
                         machine=machine)
    prof = profile_from_record(record, spec, mix_name, shape, dtype, passes)
    if cache is not None:
        cache.put(spec, mix, shape, _dtype_name(dtype), prof)
    return prof


def bounds(profile: InstructionProfile, issue_width: float = 8.0) -> dict:
    """OSACA-style per-iteration bound pair: the throughput bound is the
    issue work divided by the issue width, the latency bound the
    dependence critical path; the larger names the regime."""
    tp = profile.issue_elems_per_iter / max(issue_width, 1e-12)
    lat = profile.critical_path
    return {"throughput_bound": tp, "latency_bound": lat,
            "bound": "throughput" if tp >= lat else "latency"}


def fit_issue_rate(pairs) -> float:
    """Fit the sustained issue rate (issue work per second) from measured
    (BenchPoint, InstructionProfile) pairs: the fastest point sets the
    demonstrated capability.  Returns 0.0 when nothing is fittable."""
    rates = [prof.issue_elems_per_call(p.passes) / p.mean_s
             for p, prof in pairs
             if prof is not None and p.mean_s > 0]
    return max(rates, default=0.0)

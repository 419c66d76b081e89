"""The prefill loop: one client sends batches of prompts to the program on a
closed loop, each request answered with its first token.

A traffic mix of this kind (``"kind": "prefill"``) gives the batch B, the
prompt length S, the tokens generated a request (``new_tokens``: 1, the
first token only), the prefills that warm the cell's shape up, the sample
of served batches the comparison reads (``check_batches``, of which the
first ``cache_batches`` keep their cache too) and the batches traced
after the window's close (``trace_batches``). Each request's prompt is drawn on
the host from the seed as uniform ids over the vocabulary, before the
window opens.

The timed call is the one ``repro_torch.launch.serve.run`` makes, with the
model and its weights built once at set-up: the tokens copied to the
device, ``model.prefill(params, tokens, make_smoke_ctx(), replace(BASELINE,
use_pallas=True))``, the argmax of the last position's logits over the
vocabulary's own columns, and that first token back on the host. The next
batch goes once the last one's first tokens are on the host; a request's
time to first token runs from its tokens' copy to the device to then.

``measure`` is what the harness calls: set-up, the window, and the
comparison, run once the harness has read the window.
"""
from __future__ import annotations

import gc
import importlib
import math
import random
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from chipbench import check, weights
from chipbench.trace import SERVE_SPAN, Trace


@dataclass
class Window:
    """What one measured window left behind."""
    seconds: float
    opened: float = 0.0
    started: list = field(default_factory=list)   # a batch's tokens sent, s
    done: list = field(default_factory=list)      # ... first tokens on host
    traced: list = field(default_factory=list)    # ... served under trace
    samples: list = field(default_factory=list)   # kept for the comparison
    launches: dict = field(default_factory=dict)  # kernel counter deltas
    trace_launches: dict = field(default_factory=dict)  # ... while traced
    trace_read_s: float = 0.0
    peak_bytes: int = 0
    trace: Trace | None = None

    @property
    def close(self) -> float:
        return self.opened + self.seconds


@dataclass
class Measured:
    """A run's set-up seconds, its window, the requests it served, notes
    for standard error, and ``compare()``: the comparison's numbers, the
    program's state other than the kept sample freed first."""
    setup_s: float
    window: Window
    attempted: int
    notes: dict
    compare: object


class PrefillCell:
    """One configuration under one prefill traffic mix on one device: the
    program's model and the benchmark's weights, built once."""

    def __init__(self, cfg: dict, traffic: dict, device, seed: int):
        from repro_torch.distributed.sharding import make_smoke_ctx
        from repro_torch.models.registry import build
        from repro_torch.models.variant import BASELINE

        if traffic.get("new_tokens", 1) != 1:
            raise ValueError("the prefill loop serves the first token only")
        self.cfg, self.device = cfg, device
        self.B, self.S = traffic["batch"], traffic["prompt_len"]
        self.model = build(arch_config(cfg))
        self.ctx = make_smoke_ctx()
        self.variant = replace(BASELINE, use_pallas=True)
        self.seed = seed
        self.params = weights.make_params(self.model.param_specs(), seed,
                                          device)
        counts = importlib.import_module(
            f"chipbench.counts.model_{cfg['family']}")
        self.kernels = {k: importlib.import_module(f"chipbench.counts.{k}")
                        for k in counts.launches(cfg, 1, 1)}

    def prompts(self, n: int, seed: int):
        """n batches of B x S uniform token ids, int64, on the host (pinned
        where the device is a GPU). Batch i is the same for every n > i."""
        rng = np.random.default_rng(seed)
        toks = torch.from_numpy(rng.integers(
            0, self.cfg["vocab_size"], size=(n, self.B, self.S),
            dtype=np.int64))
        return toks.pin_memory() if self.device.type == "cuda" else toks

    # -- the timed call ----------------------------------------------------
    def serve(self, tokens_host):
        """One batch: (first tokens on the host (B,), logits (B, V_padded),
        cache)."""
        tok = tokens_host.to(self.device, non_blocking=True)
        logits, cache = self.model.prefill(self.params, tok, self.ctx,
                                           self.variant)
        first = torch.argmax(logits[:, :self.cfg["vocab_size"]], dim=-1)
        return first.cpu(), logits, cache

    def warm_up(self, n: int) -> float:
        """Serve the cell's own shape ``n`` times (the first builds and
        loads the kernels). Returns the last warm batch's seconds."""
        toks = self.prompts(1, self.seed ^ 0x5eed)[0]
        took = 0.0
        with torch.inference_mode():
            for _ in range(n):
                t = time.perf_counter()
                self.serve(toks)
                took = time.perf_counter() - t
        self.sync()
        return took

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counters(self) -> dict:
        """The program's launch counter of each hand-written kernel."""
        return {k: mod.launched() for k, mod in self.kernels.items()}

    def window(self, seconds: float, tokens, *, keep: int, keep_cache: int,
               keep_seed: int, trace_batches: int = 0) -> Window:
        """Serve the batches of ``tokens`` in turn, each once the one
        before it is done, from now for ``seconds``: no batch starts after
        the close. ``keep`` served batches are kept for the comparison, a
        uniform sample drawn from ``keep_seed`` (reservoir sampling), the
        first ``keep_cache`` of its slots with their cache. With
        ``trace_batches``, the next batches after the close are served
        under the profiler, which starts only then (its first start takes
        seconds, and a profiler once started slows every later launch on
        the host): one that carries its start-up and is not read, then
        ``trace_batches`` that are (``SERVE_SPAN``)."""
        w = Window(seconds=seconds)
        pick = random.Random(keep_seed)
        before = self.counters()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.sync()
        with torch.inference_mode():
            w.opened = time.perf_counter()
            i = 0
            while True:
                start = time.perf_counter()
                if start >= w.close:
                    break
                toks = tokens[i % len(tokens)]
                first, logits, cache = self.serve(toks)
                w.started.append(start)
                w.done.append(time.perf_counter())
                w.traced.append(False)
                slot = len(w.samples) if len(w.samples) < keep else \
                    pick.randrange(i + 1)
                if slot < keep:
                    kept = {"tokens": toks, "first": first, "logits": logits,
                            "cache": cache if slot < keep_cache else None}
                    if slot == len(w.samples):
                        w.samples.append(kept)
                    else:
                        w.samples[slot] = kept
                del logits, cache
                i += 1
            self.sync()
            if self.device.type == "cuda":
                w.peak_bytes = torch.cuda.max_memory_allocated(self.device)
            after = self.counters()
            w.launches = {k: after[k] - before[k] for k in after}
            if trace_batches:
                prof = _profiler()
                prof.start()
                for j in range(trace_batches + 1):
                    toks = tokens[(i + j) % len(tokens)]
                    start = time.perf_counter()
                    if j == 0:
                        self.serve(toks)
                        at_start = self.counters()
                        continue
                    with torch.profiler.record_function(SERVE_SPAN):
                        self.serve(toks)
                    w.started.append(start)
                    w.done.append(time.perf_counter())
                    w.traced.append(True)
                prof.stop()
                now = self.counters()
                w.trace_launches = {k: now[k] - at_start[k] for k in now}
                t = time.perf_counter()
                w.trace = Trace.from_profiler(prof)
                w.trace_read_s = time.perf_counter() - t
        return w


def measure(arch: dict, traffic: dict, seed: int, seconds: float,
            trace: bool, t_start: float, device) -> Measured:
    """Set-up (the model, the weights, the cell's shape warmed up, the
    prompts drawn), then the window."""
    pc = PrefillCell(arch, traffic, device, seed)
    service = pc.warm_up(traffic["warmup_batches"])
    # more batches than the window can serve at twice the warm speed
    n = max(4, math.ceil(2 * seconds / max(service, 1e-3)))
    tokens = pc.prompts(n, seed)
    gc.collect()
    gc.freeze()
    pc.sync()
    setup_s = time.perf_counter() - t_start
    w = pc.window(seconds, tokens, keep=traffic["check_batches"],
                  keep_cache=traffic["cache_batches"],
                  keep_seed=seed ^ 0x6b6565,
                  trace_batches=traffic["trace_batches"] if trace else 0)
    slow = sorted(((d - s) * 1e3, i) for i, (s, d)
                  in enumerate(zip(w.started, w.done)))[-3:]
    notes = {"kernel launches in the window": w.launches,
             "slowest batches": [{"batch": i, "service_ms": round(ms, 3)}
                                 for ms, i in reversed(slow)]}
    if trace:
        notes["trace"] = {"launches": w.trace_launches,
                          "read_s": w.trace_read_s,
                          "device_ops": len(w.trace.device) if w.trace
                          else 0}

    def compare() -> dict:
        nonlocal tokens
        samples, w.samples = w.samples, []
        tokens = None
        gc.unfreeze()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        notes["compared"] = {"batches": len(samples), "with cache": sum(
            s["cache"] is not None for s in samples)}
        if not samples:
            return {}
        return check.worst([check.readings(arch, pc.params, s)
                            for s in samples])
    return Measured(setup_s=setup_s, window=w, attempted=len(w.done) * pc.B,
                    notes=notes, compare=compare)


def arch_config(cfg: dict):
    """The program's ``ArchConfig`` of a configuration file's ``arch``
    (its nested groups, ``moe``, ``mla`` and ``ssm``, as their own
    configs)."""
    from repro_torch.configs import base
    groups = {"moe": base.MoEConfig, "mla": base.MLAConfig,
              "ssm": base.SSMConfig}
    return base.ArchConfig(**{k: groups[k](**v) if k in groups and v
                              else v for k, v in cfg.items()})


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

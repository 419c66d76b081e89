"""The comparison that decides ``correct``.

Once the window has closed, the batches the loop kept (a sample of the
served ones, drawn from the seed) are run again through the plain float32
reference of the configuration's family (``chipbench/reference/
<family>.py``), on the same tokens and the same weights, and three numbers
are read, each the worst over the sample:

- ``token_gap``: how far the served first token's reference logit lies
  below the reference's best, in standard deviations of the reference's
  logits over the vocabulary (greedy tokens; 0 where they agree);
- ``logit_err``: the last position's logits of a kept batch, |program -
  reference| / |reference| (2-norms over its requests and the
  vocabulary), the worst batch;
- ``cache_err``: the prefill's cache, the same ratio for every leaf (the
  attention k and v of every layer), the worst leaf, over the batches the
  loop kept with their cache.

Each is held to its limit in ``chipbench/limits/<workload>.json``. The
control (``control_serve``) puts the reference with float8 products in the
program's place and is read by these same numbers.
"""
from __future__ import annotations

import importlib

import torch

from chipbench.reference import ops

NUMBERS = ("token_gap", "logit_err", "cache_err")


def reference(family: str):
    return importlib.import_module(f"chipbench.reference.{family}")


def rel(a, b) -> float:
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def token_gap(r_logits, picked):
    """The widest gap between the reference's best logit and its logit of
    the ``picked`` token (indices on the last dim, kept), over the rows, in
    standard deviations of each row's logits."""
    gap = r_logits.amax(-1) - r_logits.gather(-1, picked)[..., 0]
    return (gap / r_logits.std(-1)).amax()


class exact_matmuls:
    """float32 products without TF32 inside the block."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, prec) = self.saved
        torch.set_float32_matmul_precision(prec)


def readings(cfg: dict, params: dict, sample: dict) -> dict:
    """The numbers of one kept batch: its tokens (host), the served first
    tokens (host), the last-position logits and, where kept, the cache
    (``cache_err`` is 0 for a batch kept without it)."""
    ref = reference(cfg["family"])
    V = cfg["vocab_size"]
    dev = sample["logits"].device
    with torch.inference_mode(), exact_matmuls():
        r_logits, r_cache = ref.forward(cfg, params,
                                        sample["tokens"].to(dev))
        p_logits = sample["logits"][:, :V].to(torch.float32)
        first = sample["first"].to(dev)
        gap = token_gap(r_logits, first[:, None])
        logit = rel(p_logits, r_logits)
        cache = 0.0
        if sample["cache"] is not None:
            for (name, p), (rname, r) in zip(
                    ref.program_cache(sample["cache"]),
                    ref.reference_cache(r_cache), strict=True):
                if name != rname or tuple(p.shape) != tuple(r.shape):
                    raise ValueError(f"cache leaf {name} {tuple(p.shape)} "
                                     f"does not pair with {rname} "
                                     f"{tuple(r.shape)}")
                cache = max(cache, rel(p, r))
    return {"token_gap": float(gap), "logit_err": logit, "cache_err": cache}


def control_serve(cell, tokens_host):
    """The control, in the place of the loop's ``serve``: the reference with
    float8 products, one precision below the configuration's bfloat16,
    answering as the program does (first tokens on the host, the last
    position's logits, the cache in the program's layout)."""
    ref = reference(cell.cfg["family"])
    with exact_matmuls():
        logits, cache = ref.forward(cell.cfg, cell.params,
                                    tokens_host.to(cell.device), ops.fp8)
    return logits.argmax(-1).cpu(), logits, ref.as_program_cache(cache)


def worst(readings_list: list[dict]) -> dict:
    return {k: max(r[k] for r in readings_list) for k in NUMBERS}

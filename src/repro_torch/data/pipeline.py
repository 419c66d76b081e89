"""Deterministic synthetic token pipeline, resumable (counterpart of
``repro.data.pipeline``).

Each batch is drawn from (seed, step) alone — a restart at step k
reproduces the exact stream (a checkpoint stores only the step counter).
Tokens follow a Zipf(``zipf_a``) unigram draw with a Markov mixing term (a
quarter of the tokens repeat the previous one, plus one mod V) so the loss
curve has learnable structure; ``labels`` are the tokens shifted by one.
The draw runs on a CPU ``torch.Generator`` seeded from (seed, step) and the
batch then moves to the device, so that a step gives the same batch on the
card and on the CPU.  The port cannot reproduce ``jax.random``'s bits: its
batches follow the reference's distribution, not its values.  On a mesh
every rank draws the whole global batch from the same generator, exactly
as one device does, and keeps its block under the ``batch`` rule (the
data axes where they divide the batch, else whole), as the reference's
``make_pipeline`` places it: the values are one device's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.device import resolve_device

#: the share of tokens that repeat the previous one (+1 mod V)
REPEAT_P = 0.25


@dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator whose stream depends on (seed, step) only."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


class SyntheticTokens:
    def __init__(self, cfg: DataConfig, frames_dim: int = 0,
                 n_audio_ctx: int = 0, device=None, ctx=None):
        self.cfg = cfg
        self.ctx = ctx
        self.frames_dim = frames_dim
        self.n_audio_ctx = n_audio_ctx
        self.device = resolve_device(device)
        # the Zipf unigram's cumulative distribution over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._cdf = torch.from_numpy(np.cumsum(p / p.sum()))

    def batch(self, step: int) -> dict:
        """{"tokens", "labels": (B, S) int64, ["frames": (B, A, D) bf16]}
        on the device: this rank's block of them on a mesh."""
        cfg = self.cfg
        gen = step_generator(cfg.seed, step)
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        u = torch.rand((B, S + 1), generator=gen, dtype=torch.float64)
        base = torch.clamp(torch.searchsorted(self._cdf, u), max=V - 1)
        rep = torch.rand((B, S + 1), generator=gen) < REPEAT_P
        shifted = torch.roll(base, 1, dims=1)
        tokens = torch.where(rep, (shifted + 1) % V, base)
        out = {"tokens": tokens[:, :S], "labels": tokens[:, 1:]}
        if self.frames_dim:
            out["frames"] = torch.randn(
                (B, self.n_audio_ctx, self.frames_dim),
                generator=gen).to(torch.bfloat16) * 0.02
        if self.ctx is not None:
            out = {k: self.ctx.shard(v, self.ctx.block_spec(
                v.shape, ("batch",) + (None,) * (v.ndim - 1)))
                for k, v in out.items()}
        return {k: v.contiguous().to(self.device) for k, v in out.items()}


def make_pipeline(cfg_arch, shape, ctx=None, seed: int = 0, device=None):
    """The pipeline for an architecture at ``shape`` = (batch, seq) or a
    ``ShapeConfig``; encdec also draws its frame embeddings.  ``ctx`` (a
    ``ShardCtx``): each batch is this rank's block of the global one."""
    if isinstance(shape, tuple):
        B, S = shape
    else:
        B, S = shape.global_batch, shape.seq_len
    dcfg = DataConfig(vocab_size=cfg_arch.vocab_size, seq_len=S,
                      global_batch=B, seed=seed)
    frames_dim = cfg_arch.d_model if cfg_arch.family == "encdec" else 0
    return SyntheticTokens(dcfg, frames_dim, cfg_arch.n_audio_ctx,
                           device=device, ctx=ctx)

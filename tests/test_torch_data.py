"""The port's synthetic data pipeline (``repro_torch.data.pipeline``),
held to the reference's tests (``tests/test_data.py``) and to its
distribution, on the CPU.

The port draws on a CPU ``torch.Generator`` seeded from (seed, step); it
cannot reproduce ``jax.random``'s bits, so its batches are held to the
reference's distribution (the Zipf skew, the repeat rate, the shapes and
dtypes), not to its values.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs import reduced as j_reduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro_torch.configs import get_arch, reduced
from repro_torch.data.pipeline import (REPEAT_P, DataConfig, SyntheticTokens,
                                       make_pipeline)


def pipe(**kw):
    return SyntheticTokens(DataConfig(**kw), device="cpu")


def test_deterministic_given_step():
    p = pipe(vocab_size=128, seq_len=32, global_batch=4, seed=7)
    a, b = p.batch(3), p.batch(3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], p.batch(4)["tokens"])
    # a new pipeline of the same seed: the same stream; another seed: not
    assert torch.equal(pipe(vocab_size=128, seq_len=32, global_batch=4,
                            seed=7).batch(3)["tokens"], a["tokens"])
    assert not torch.equal(pipe(vocab_size=128, seq_len=32, global_batch=4,
                                seed=8).batch(3)["tokens"], a["tokens"])


def test_labels_are_shifted_tokens():
    b = pipe(vocab_size=128, seq_len=32, global_batch=2, seed=0).batch(0)
    assert b["tokens"].shape == b["labels"].shape == (2, 32)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].dtype == torch.int64


def test_tokens_in_range():
    t = pipe(vocab_size=64, seq_len=128, global_batch=2, seed=1).batch(0)
    assert int(t["tokens"].min()) >= 0 and int(t["tokens"].max()) < 64


def repeat_rate(tokens: np.ndarray, V: int, zipf_a: float) -> float:
    """The Markov mixing rate q behind a batch.  A token repeats the
    previous *draw* plus one, so the observed share r of tokens equal to
    (previous token + 1) mod V is q(1 - q)(1 + c2 - 2 c) + c, with c and
    c2 the chances that two independent Zipf draws a, b give b = a + 1 and
    b = a + 2 (mod V); solved for q below 1/2."""
    p = np.arange(1, V + 1, dtype=np.float64) ** -zipf_a
    p /= p.sum()
    c, c2 = float(p @ np.roll(p, -1)), float(p @ np.roll(p, -2))
    r = float((tokens[:, 1:] == (tokens[:, :-1] + 1) % V).mean())
    u = (r - c) / (1 + c2 - 2 * c)
    return (1 - np.sqrt(1 - 4 * u)) / 2


@pytest.mark.parametrize("seed", [2, 3])
def test_zipf_skew_and_repeat_rate_match_the_reference(seed):
    """Over 16 x 1024 tokens of a vocab of 1024: low ids much more frequent
    than high ones, as in the reference's test; the shares of ids below 16
    and at or above 512 each within 0.02 of the reference's on its own
    batch; the mixing rate behind the batch (``repeat_rate``) within 0.02
    of REPEAT_P, on both sides."""
    kw = dict(vocab_size=1024, seq_len=1024, global_batch=16, seed=seed)
    t = pipe(**kw).batch(0)["tokens"].numpy()
    j = np.asarray(JSyntheticTokens(JDataConfig(**kw)).batch(0)["tokens"])
    low, high = (t < 16).mean(), (t >= 512).mean()
    assert low > high * 2
    assert abs(low - (j < 16).mean()) <= 0.02
    assert abs(high - (j >= 512).mean()) <= 0.02
    for x in (t, j):
        assert abs(repeat_rate(x, 1024, 1.2) - REPEAT_P) <= 0.02


def test_encdec_frames():
    cfg = reduced(get_arch("whisper-medium"))
    b = make_pipeline(cfg, (2, 16), seed=0, device="cpu").batch(0)
    jcfg = j_reduced(j_get_arch("whisper-medium"))
    assert b["frames"].shape == (2, jcfg.n_audio_ctx, jcfg.d_model)
    assert b["frames"].dtype == torch.bfloat16
    assert 0.015 < float(b["frames"].float().std()) < 0.025


def test_the_device_is_explicit():
    """``device`` defaults to cuda and raises without one, naming the
    way out; the batch lands on the device asked for."""
    cfg = DataConfig(vocab_size=64, seq_len=8, global_batch=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SyntheticTokens(cfg)
    assert SyntheticTokens(cfg, device="cpu").batch(0)["tokens"].device \
        == torch.device("cpu")

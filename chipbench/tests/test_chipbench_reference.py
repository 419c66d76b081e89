"""The plain float32 references against the program's prefill, on the CPU
at the program's reduced sizes: the program on its plain route and on its
kernel route (whose CUDA kernels take their plain versions on the CPU),
within a limit that the control, the reference with float8 products in the
program's place, fails."""
from __future__ import annotations

from dataclasses import replace

import pytest
import torch

from chipbench import check
from chipbench.loops.prefill import PrefillCell
from conftest import small_arch

#: a bfloat16 prefill of 2 layers against float32 reads 0.01-0.03 here;
#: float8 products read 0.09-0.21 (logits) and 0.11-0.15 (cache)
LIMIT = 0.06


def _cell(config_name, B, S, seed, use_pallas):
    arch = small_arch(config_name)
    traffic = {"kind": "prefill", "batch": B, "prompt_len": S}
    s = PrefillCell(arch, traffic, torch.device("cpu"), seed)
    s.variant = replace(s.variant, use_pallas=use_pallas)
    return arch, s


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("config_name,B,S", [
    ("granite-3-2b", 2, 64), ("granite-3-2b", 1, 96)])
def test_program_within_limit_control_outside(config_name, B, S,
                                              use_pallas):
    arch, s = _cell(config_name, B, S, 2 ** 31 + 7, use_pallas)
    toks = s.prompts(1, 11)[0]
    with torch.inference_mode():
        first, logits, cache = s.serve(toks)
    got = check.readings(arch, s.params, {"tokens": toks, "first": first,
                                          "logits": logits, "cache": cache})
    assert got["logit_err"] < LIMIT and got["cache_err"] < LIMIT, got
    assert got["token_gap"] < 0.05, got
    with torch.inference_mode():
        first, logits, cache = check.control_serve(s, toks)
    ctl = check.readings(arch, s.params, {"tokens": toks, "first": first,
                                          "logits": logits, "cache": cache})
    assert ctl["logit_err"] > LIMIT and ctl["cache_err"] > LIMIT, ctl


@pytest.mark.parametrize("config_name", ["granite-3-2b"])
def test_reference_cache_pairs_with_program_cache(config_name):
    """Every leaf of the program's cache has its reference leaf, named and
    shaped alike."""
    arch, s = _cell(config_name, 2, 64, 5, True)
    toks = s.prompts(1, 3)[0]
    with torch.inference_mode():
        _, _, cache = s.serve(toks)
        ref = check.reference(arch["family"])
        _, r_cache = ref.forward(arch, s.params, toks)
    prog = ref.program_cache(cache)
    refs = ref.reference_cache(r_cache)
    assert [n for n, _ in prog] == [n for n, _ in refs]
    assert all(tuple(a.shape) == tuple(b.shape)
               for (_, a), (_, b) in zip(prog, refs))
    assert {n.split(".")[-1] for n, _ in prog} == {"k", "v"}
    ctl = ref.program_cache(ref.as_program_cache(r_cache))
    assert [n for n, _ in ctl] == [n for n, _ in prog]

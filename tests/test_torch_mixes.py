"""The port's mix registry against the reference's: same names, same
bytes/flops accounting, same errors."""
import random

import pytest

from repro.bench import mixes as ref
from repro_torch.bench import mixes as port

BACKEND = {"xla": "torch", "pallas": "cuda"}


def _same_accounting(a, b):
    for nbytes in (4096, 32 * 1024, 3 * 2**20):
        assert a.bytes_per_pass(nbytes) == b.bytes_per_pass(nbytes)
        assert a.flops_per_pass(nbytes // 4) == b.flops_per_pass(nbytes // 4)
    assert (a.flops_per_elem, a.reads_per_elem, a.writes_per_elem,
            a.fma_depth, a.rw, a.chase, a.description) == \
           (b.flops_per_elem, b.reads_per_elem, b.writes_per_elem,
            b.fma_depth, b.rw, b.chase, b.description)


@pytest.mark.parametrize("name", sorted(ref.registry()))
def test_registered_mix_matches_reference(name):
    a, b = ref.get_mix(name), port.get_mix(name)
    assert b.name == name
    _same_accounting(a, b)
    assert b.backends == tuple(BACKEND[x] for x in a.backends)


def test_registry_names_and_order():
    assert list(port.registry()) == list(ref.registry())
    assert port.mix_names() == ref.mix_names()
    for rb, pb in BACKEND.items():
        assert port.mix_names(pb) == ref.mix_names(rb)
    assert "load_only" not in port.mix_names("torch")
    assert "load_only" in port.mix_names("cuda")


def test_open_families_match_reference():
    rng = random.Random(0)
    names = [f"fma_{rng.randint(1, 500)}" for _ in range(20)]
    names += [f"rw_{rng.randint(1, 8)}to{rng.randint(1, 8)}"
              for _ in range(20)]
    for name in names:
        _same_accounting(ref.get_mix(name), port.get_mix(name))
        assert port.get_mix(name).name == name
        assert port.get_mix(name).backends == tuple(
            BACKEND[x] for x in ref.get_mix(name).backends)
    assert port.rw_ratio(3, 2).bytes_per_pass(100) == \
        ref.rw_ratio(3, 2).bytes_per_pass(100)


@pytest.mark.parametrize("name", ["rw_01to1", "rw_9to1", "rw_0to1", "fma_0",
                                  "fma_x", "nope"])
def test_bad_names_raise_like_the_reference(name):
    with pytest.raises(KeyError) as er:
        ref.get_mix(name)
    with pytest.raises(KeyError) as ep:
        port.get_mix(name)
    assert str(ep.value) == str(er.value)


def test_shared_constants():
    assert port.GEN_SWEEPS_PER_PASS == ref.GEN_SWEEPS_PER_PASS == 16
    assert port.RW_COMBINE_COEF == ref.RW_COMBINE_COEF == 1.5
    assert port.FMA_DEPTHS == ref.FMA_DEPTHS
    assert port.RW_RATIOS == ref.RW_RATIOS and port.MAX_RW == ref.MAX_RW
    assert port._RW_NAME.pattern == ref._RW_NAME.pattern
    for name in ("load_sum", "copy", "triad", "mxu", "rw_2to1", "fma_8"):
        assert port.interleavable(port.get_mix(name)) == \
            ref.interleavable(ref.get_mix(name))
        assert port._sort_key(port.get_mix(name)) == \
            ref._sort_key(ref.get_mix(name))

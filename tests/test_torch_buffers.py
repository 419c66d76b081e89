"""The port's working-set buffers against the reference's: same shapes, same
bits, for every dtype; and the bit-exact carriers of ``convert``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import buffers as ref
from repro_torch import convert
from repro_torch.core import buffers as port

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int32": jnp.int32,
       "float16": jnp.float16}


def _bits(a):
    """numpy array -> an integer view that == compares bit for bit."""
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32", "float16"])
@pytest.mark.parametrize("nbytes", [1000, 4096, 16 * 1024, 100_000,
                                    128 * 1024])
def test_working_set_equals_reference(dtype, nbytes):
    a = np.asarray(ref.working_set(nbytes, dtype=JNP[dtype]))
    t = port.working_set(nbytes, dtype=dtype, device="cpu")
    assert tuple(t.shape) == a.shape == port.working_set_shape(nbytes, dtype)
    assert t.is_contiguous() and t.shape[0] % 8 == 0 and t.shape[1] == 128
    # carried across bit for bit, both ways
    carried = convert.tensor_from_reference(a)
    assert carried.dtype == t.dtype == port.as_dtype(dtype)
    assert torch.equal(carried, t)
    back = convert.to_reference(t)
    assert back.shape == a.shape and back.dtype.name == a.dtype.name
    assert (_bits(back) == _bits(a)).all()
    assert np.asarray(jnp.asarray(back)).dtype == a.dtype


@pytest.mark.parametrize("value", [1.234567, 3.0, 0.001, -7.5])
def test_init_pattern_values_and_no_denormals(value):
    for dtype in ("float32", "bfloat16"):
        for n in (7, 8, 1001):
            a = np.asarray(ref.init_pattern(n, value, JNP[dtype]))
            t = port.init_pattern(n, value, dtype, device="cpu")
            assert torch.equal(convert.tensor_from_reference(a), t)
            assert not port.has_denormals(t)
    assert port.has_denormals(torch.tensor([1e-40]))
    assert not port.has_denormals(torch.tensor([1, 2], dtype=torch.int32))


@pytest.mark.parametrize("bad", [0.0, float("inf"), float("nan")])
def test_init_pattern_rejects(bad):
    with pytest.raises(ValueError, match="finite and nonzero"):
        port.init_pattern(8, bad, device="cpu")


def test_shapes_and_grids_equal_reference():
    for dtype in ("float32", "bfloat16", "int32"):
        for nbytes in (1, 1000, 4096, 5000, 70_000, 2**20, 2**31):
            assert port.working_set_shape(nbytes, dtype) == \
                ref.working_set_shape(nbytes, JNP[dtype])
        req = [1000, 4096, 5000, 70_000, 70_001, 2**20]
        assert port.snap_sizes(req, dtype) == ref.snap_sizes(req, JNP[dtype])
        assert port.size_grid(dtype=dtype) == ref.size_grid(dtype=JNP[dtype])
    assert port.sizes_logspace(1024, 2**24) == ref.sizes_logspace(1024, 2**24)
    assert port.hierarchy_grid() == ref.hierarchy_grid()
    assert port.hierarchy_grid(quick=True) == ref.hierarchy_grid(quick=True)
    assert (port.DEFAULT_VALUE, port.HIERARCHY_SPAN, port.QUICK_SIZES) == \
        (ref.DEFAULT_VALUE, ref.HIERARCHY_SPAN, ref.QUICK_SIZES)


def test_default_device_raises_without_cuda_and_names_the_flag():
    if torch.cuda.is_available():
        assert port.working_set(4096).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="--device cpu"):
        port.working_set(4096)
    with pytest.raises(RuntimeError, match="--device cpu"):
        port.init_pattern(8)


def test_dtype_table():
    assert port.as_dtype("bfloat16") is torch.bfloat16
    assert port.as_dtype(torch.float16) is torch.float16
    assert port.dtype_name(torch.int32) == "int32"
    assert [port.itemsize(d) for d in ("float32", "bfloat16", "int32")] == \
        [4, 2, 4]
    with pytest.raises(TypeError):
        port.as_dtype("float99")

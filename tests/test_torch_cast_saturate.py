"""Float-to-integer casts of the port against the JAX package, on the
CPU: ``Cast``, ``cast`` and ``NDArray.astype`` from float32 and bf16 to
uint8, int8 and int32 saturate as the reference's XLA convert does
(truncated toward zero, clamped to the target's range, NaN to 0), where
PyTorch's own conversion wraps.  The input holds the values that tell
the two apart (below zero for uint8, past the range, NaN, both
infinities, 3e9 past int32) and in-range values on either side of zero.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.elemwise import saturating_cast

EDGES = np.float32([-2.7, 300.7, np.nan, np.inf, -np.inf, 3e9])
IN_RANGE = np.float32([0.0, -0.0, 0.49, -0.51, 1.5, -1.5, 7.99, 100.2,
                       -100.2, 126.9, -127.9, 254.6])
SRC = np.concatenate([EDGES, IN_RANGE])

# the reference's results on EDGES (its convert, on the CPU)
WANT_EDGES = {"uint8": [0, 255, 0, 255, 0, 255],
              "int8": [-2, 127, 0, 127, -128, 127],
              "int32": [-2, 300, 0, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1]}


def _cast(pkg, how, src_dtype, dtype):
    with pkg.cpu():
        x = pkg.nd.array(SRC)
        if src_dtype != "float32":
            x = x.astype(src_dtype)
        if how == "astype":
            y = x.astype(dtype)
        else:
            y = getattr(pkg.nd, how)(x, dtype=dtype)
        return str(y.dtype), y.asnumpy()


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int32"])
@pytest.mark.parametrize("src_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("how", ["Cast", "cast", "astype"])
def test_float_to_int_saturates_as_the_reference(how, src_dtype, dtype):
    want_dt, want = _cast(jmx, how, src_dtype, dtype)
    got_dt, got = _cast(tmx, how, src_dtype, dtype)
    assert got_dt == want_dt == dtype
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if src_dtype == "float32":
        assert got[:len(EDGES)].tolist() == WANT_EDGES[dtype]


@pytest.mark.parametrize("dtype", [torch.int64, torch.int16])
def test_saturating_cast_other_integer_widths(dtype):
    """The wider and the narrower integers the reference's table leaves
    out: int64's top (2**63 - 1, which float64 cannot hold) and int16's
    bounds."""
    x = torch.tensor([np.nan, np.inf, -np.inf, 1e30, -1e30, -2.7, 2.7])
    info = torch.iinfo(dtype)
    got = saturating_cast(x, dtype)
    assert got.dtype == dtype
    assert got.tolist() == [0, info.max, info.min, info.max, info.min,
                            -2, 2]


def test_saturating_cast_keeps_other_pairs():
    """Integer sources, float targets and bool convert as ``Tensor.to``;
    the result is a copy."""
    i = torch.tensor([300, -2, 7], dtype=torch.int32)
    assert saturating_cast(i, torch.uint8).tolist() == \
        i.to(torch.uint8).tolist()
    f = torch.tensor([1.5, -0.0, -2.7])
    for dt in (torch.bfloat16, torch.float64, torch.bool):
        assert torch.equal(saturating_cast(f, dt), f.to(dt))
    assert saturating_cast(f, torch.float32).data_ptr() != f.data_ptr()

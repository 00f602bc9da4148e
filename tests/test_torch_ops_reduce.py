"""The port's ``norm``, ``broadcast_to``, ``broadcast_axis`` /
``broadcast_axes`` and ``argmax_channel`` (``ops/reduce.py``) against
``mxnet_tpu``'s, forward and backward (the rules are in
``tests/test_torch_ops_common.py``)."""
import pytest

import mxnet_tpu_torch as tmx
from test_torch_ops_common import (EXACT, REL, _one_torch_thread,  # noqa: F401
                                   arr, case_id, check, run)

# (op, input specs, attrs, tolerance, backward?)
CASES = [
    ("norm", [arr((4, 5))], {}, REL, True),
    ("norm", [arr((2, 3, 4))], {}, REL, False),
    ("broadcast_to", [arr((1, 5))], {"shape": (4, 5)}, EXACT, True),
    ("broadcast_to", [arr((3, 1))], {"shape": (0, 4)}, EXACT, True),
    ("broadcast_to", [arr((1, 5), "i")], {"shape": (3, 5)}, EXACT, False),
    ("broadcast_axis", [arr((1, 5, 1))], {"axis": (0, 2), "size": (3, 2)},
     EXACT, True),
    ("broadcast_axes", [arr((4, 1))], {"axis": 1, "size": 6}, EXACT, True),
    ("argmax_channel", [arr((4, 5))], {}, EXACT, False),
    ("argmax_channel", [arr((2, 5, 3))], {}, EXACT, False),
    ("argmax_channel", [arr((4, 5), "ties")], {}, EXACT, False),
]


@pytest.mark.parametrize("case", CASES, ids=[case_id(c) for c in CASES])
def test_forward(case):
    op, specs, attrs, tol, _ = case
    check(op, specs, attrs, tol=tol)


@pytest.mark.parametrize("case", [c for c in CASES if c[4]],
                         ids=[case_id(c) for c in CASES if c[4]])
def test_backward(case):
    op, specs, attrs, _, _ = case
    check(op, specs, attrs, grad=True)


def test_norm_is_a_scalar_and_argmax_channel_float32():
    (n, _), = run(tmx, "norm", [arr((4, 5))])
    assert n.shape == ()
    (a, dt), = run(tmx, "argmax_channel", [arr((4, 5))])
    assert dt == "float32" and a.shape == (4,)


def test_broadcast_axis_refuses_an_axis_that_is_not_one():
    with tmx.cpu():
        with pytest.raises(tmx.MXNetError, match="size 1"):
            tmx.nd.broadcast_axis(tmx.nd.ones((2, 3)), axis=1, size=4)
        out = tmx.nd.broadcast_to(tmx.nd.ones((1, 3)), shape=(2, 3))
        out[0, 0] = 5.0     # a materialised array takes an in-place write
        assert out.asnumpy()[1, 0] == 1.0

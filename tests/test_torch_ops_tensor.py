"""The port's matrix and shape ops (``mxnet_tpu_torch/ops/tensor.py``)
against ``mxnet_tpu``'s, forward and backward: ``dot`` / ``batch_dot``
(within 1e-5 x max|ref|), the shape-only ops bit-equal (the rules are in
``tests/test_torch_ops_common.py``)."""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from test_torch_ops_common import (EXACT, REL, _one_torch_thread,  # noqa: F401
                                   arr, case_id, check, run)

# (op, input specs, attrs, tolerance, backward?)
CASES = [
    ("dot", [arr((5, 7)), arr((7, 3))], {}, REL, True),
    ("dot", [arr((7, 5)), arr((7, 3))], {"transpose_a": True}, REL, True),
    ("dot", [arr((5, 7)), arr((3, 7))], {"transpose_b": True}, REL, True),
    ("dot", [arr((7, 5)), arr((3, 7))],
     {"transpose_a": True, "transpose_b": True}, REL, True),
    ("dot", [arr((7,)), arr((7,))], {}, REL, True),
    ("dot", [arr((7,)), arr((7, 3))], {}, REL, True),
    ("dot", [arr((2, 5, 7)), arr((7, 3))], {}, REL, True),
    # transpose_a of an N-d operand reverses every axis: (7, 5, 2) -> ...
    ("dot", [arr((7, 5, 2)), arr((7, 3))], {"transpose_a": True}, REL, True),
    ("dot", [arr((5, 7)), arr((3, 4, 7))], {"transpose_b": True}, REL, True),
    ("batch_dot", [arr((3, 5, 7)), arr((3, 7, 4))], {}, REL, True),
    ("batch_dot", [arr((3, 7, 5)), arr((3, 4, 7))],
     {"transpose_a": True, "transpose_b": True}, REL, True),
    ("Concat", [arr((2, 3)), arr((2, 4)), arr((2, 1))], {"dim": 1}, EXACT,
     True),
    ("concat", [arr((2, 3)), arr((5, 3))], {"dim": 0}, EXACT, True),
    ("Concat", [arr((2, 3), "i"), arr((2, 3), "i")], {}, EXACT, False),
    ("Flatten", [arr((2, 3, 4))], {}, EXACT, True),
    ("flatten", [arr((5,))], {}, EXACT, False),
    ("expand_dims", [arr((2, 3))], {"axis": 1}, EXACT, True),
    ("expand_dims", [arr((2, 3))], {"axis": -1}, EXACT, False),
    ("SwapAxis", [arr((2, 3, 4))], {"dim1": 0, "dim2": 2}, EXACT, True),
    ("swapaxes", [arr((2, 3, 4))], {"dim1": 1, "dim2": -1}, EXACT, False),
    ("slice", [arr((5, 6, 4))], {"begin": (1, -4), "end": (4, -1)}, EXACT,
     True),
    ("crop", [arr((5, 6))], {"begin": (0, 2), "end": (3, 6)}, EXACT, False),
    ("slice_axis", [arr((5, 6))], {"axis": 1, "begin": 1, "end": 4}, EXACT,
     True),
    ("slice_axis", [arr((5, 6))], {"axis": -2, "begin": -3, "end": None},
     EXACT, False),
    ("clip", [arr((5, 6))], {"a_min": -0.5, "a_max": 0.7}, EXACT, True),
    ("clip", [arr((5, 6), "i")], {"a_min": -3, "a_max": 4}, EXACT, False),
    ("repeat", [arr((2, 3))], {"repeats": 2}, EXACT, True),
    ("repeat", [arr((2, 3))], {"repeats": 3, "axis": 1}, EXACT, True),
    ("repeat", [arr((2, 3), "i")], {"repeats": 2, "axis": 0}, EXACT, False),
    ("tile", [arr((2, 3))], {"reps": (2, 2)}, EXACT, True),
    ("tile", [arr((2, 3))], {"reps": (3,)}, EXACT, False),
    ("tile", [arr((3,))], {"reps": (2, 2)}, EXACT, False),
    ("reverse", [arr((2, 3, 4))], {"axis": (0, 2)}, EXACT, True),
    ("flip", [arr((4, 3))], {"axis": 1}, EXACT, False),
    ("where", [arr((4, 3), "i"), arr((4, 3)), arr((4, 3))], {}, EXACT, True),
    ("where", [arr((4,), "i"), arr((4, 3)), arr((4, 3))], {}, EXACT, True),
    ("SliceChannel", [arr((2, 6, 3))], {"num_outputs": 3}, EXACT, True),
    ("split", [arr((4, 6))], {"num_outputs": 2, "axis": 0}, EXACT, True),
    ("SliceChannel", [arr((2, 3, 4))],
     {"num_outputs": 3, "axis": 1, "squeeze_axis": True}, EXACT, True),
    ("Pad", [arr((2, 3, 4, 5))],
     {"pad_width": (0, 0, 0, 0, 1, 2, 2, 1), "constant_value": 1.5},
     EXACT, True),
    ("pad", [arr((2, 3, 4, 5))],
     {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)}, EXACT, True),
    ("Pad", [arr((2, 3, 4, 5))],
     {"mode": "reflect", "pad_width": (0, 0, 0, 0, 1, 2, 3, 1)}, EXACT,
     True),
    ("Pad", [arr((1, 2, 3, 4, 5))],
     {"mode": "edge", "pad_width": (0, 0, 0, 0, 1, 1, 2, 0, 0, 2)}, EXACT,
     False),
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


def test_variadic_and_multi_output_ops_in_nd():
    """``Concat`` counts its positional inputs into ``num_args``;
    ``SliceChannel`` gives a list of ``num_outputs`` arrays."""
    parts = run(tmx, "SliceChannel", [arr((2, 6))], {"num_outputs": 3})
    assert len(parts) == 3 and all(p.shape == (2, 2) for p, _ in parts)
    with tmx.cpu():
        a, b = tmx.nd.ones((2, 2)), tmx.nd.zeros((2, 3))
        out = tmx.nd.Concat(a, b, a, dim=1)
        assert out.shape == (2, 7)
        np.testing.assert_array_equal(out.asnumpy()[:, 5:], 1.0)
        assert tmx.nd.dot(a, a).asnumpy().tolist() == [[2.0, 2.0]] * 2
        with pytest.raises(tmx.MXNetError):
            tmx.nd.Pad(tmx.nd.ones((2, 2)), mode="edge",
                       pad_width=(1, 1, 1, 1))

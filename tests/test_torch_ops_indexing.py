"""The port's indexing and ordering ops (``ops/indexing.py``,
``ops/ordering.py``) against ``mxnet_tpu``'s: ``take``, ``batch_take``,
``one_hot`` and ``pick`` with indices out of range and negative,
``sort`` / ``argsort`` / ``topk`` on rows full of ties, every
``ret_typ`` and both orders.  Index and ordering results are bit-equal;
gradients within 1e-5 x max|ref| (the rules are in
``tests/test_torch_ops_common.py``)."""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from test_torch_ops_common import (EXACT, _one_torch_thread,  # noqa: F401
                                   check, run)

R = np.random.RandomState(3)
DATA = R.randn(5, 6).astype(np.float32)
# out of range on both sides, negative, and fractional (truncated)
IDX = np.array([0, 7, -2, 3, -7, 5.9, 2, -1], np.float32)
ROW_IDX = np.array([0, 7, -1, -7, 2.5], np.float32)   # one per row of DATA
# rows full of ties
TIES = np.array([[1, 0, 1, 0, 1, 0, 1, 1],
                 [2, 2, 2, 2, 2, 2, 2, 2],
                 [0.5, -1, 0.5, 0.5, -1, 3, 3, 0.5]], np.float32)

# (op, numpy inputs, attrs)
CASES = [
    ("take", [DATA, IDX], {}),
    ("take", [DATA, IDX], {"mode": "wrap"}),
    ("take", [DATA, IDX], {"mode": "raise"}),
    ("take", [DATA, IDX.reshape(2, 4)], {"axis": 1}),
    ("take", [DATA, IDX.reshape(2, 4)], {"axis": 1, "mode": "wrap"}),
    ("take", [DATA.astype(np.int32), IDX], {}),
    ("batch_take", [DATA, ROW_IDX], {}),
    ("one_hot", [IDX], {"depth": 6}),
    ("one_hot", [IDX.reshape(2, 4)],
     {"depth": 5, "on_value": 2.5, "off_value": -1.0}),
    ("one_hot", [IDX], {"depth": 6, "dtype": "int32"}),
    ("pick", [DATA, ROW_IDX], {"axis": 1}),
    ("pick", [DATA, ROW_IDX], {"axis": -1, "keepdims": True}),
    ("pick", [DATA, ROW_IDX], {"mode": "wrap"}),
    ("pick", [DATA, np.array([0, 9, -1, 3, 2, 5], np.float32)],
     {"axis": 0}),
    ("sort", [TIES], {}),
    ("sort", [TIES], {"is_ascend": False}),
    ("sort", [TIES], {"axis": 0}),
    ("sort", [TIES], {"axis": None}),
    ("argsort", [TIES], {}),
    ("argsort", [TIES], {"is_ascend": False}),
    ("argsort", [TIES], {"axis": 0, "is_ascend": False}),
    ("argsort", [TIES], {"axis": None}),
    ("topk", [TIES], {"k": 3}),
    ("topk", [TIES], {"k": 3, "is_ascend": True}),
    ("topk", [TIES], {"k": 2, "ret_typ": "value"}),
    ("topk", [TIES], {"k": 4, "ret_typ": "mask"}),
    ("topk", [TIES], {"k": 3, "ret_typ": "both"}),
    ("topk", [TIES], {"k": 2, "axis": 0, "ret_typ": "both"}),
    ("topk", [TIES], {"k": 5, "axis": None, "ret_typ": "indices"}),
    ("topk", [TIES.astype(np.int32)], {"k": 3, "ret_typ": "both"}),
]


def _id(case):
    op, vals, attrs = case
    return "%s-%s%s" % (op, "x".join(map(str, vals[0].shape)), "".join(
        "-%s=%s" % kv for kv in sorted(attrs.items())))


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_forward_bit_equal(case):
    op, vals, attrs = case
    check(op, [], attrs, tol=EXACT, values=vals)


# backward: the gathers' gradients scatter-add into the data (random
# data, so the sorts have no ties)
GRAD_CASES = [
    ("take", [DATA, IDX], {}), ("take", [DATA, IDX], {"mode": "wrap"}),
    ("take", [DATA, IDX.reshape(2, 4)], {"axis": 1}),
    ("batch_take", [DATA, np.array([0, 5, -1, 2, 3], np.float32)], {}),
    ("pick", [DATA, ROW_IDX], {"axis": 1}),
    ("pick", [DATA, ROW_IDX], {"keepdims": True, "mode": "wrap"}),
    ("sort", [DATA], {"is_ascend": False}),
    ("topk", [DATA], {"k": 3, "ret_typ": "value"}),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[_id(c) for c in GRAD_CASES])
def test_backward(case):
    op, vals, attrs = case
    check(op, [], attrs, grad=True, values=vals)


def test_the_reference_edges():
    """What the reference does at each edge, named: ``batch_take`` past
    the row is NaN and -1 the last column; ``one_hot`` outside [0, depth)
    a zero row; ``take`` clips; descending ``argsort`` puts ties higher
    index first, ``topk`` lower index first."""
    (bt, _), = run(tmx, "batch_take", [], values=[DATA, ROW_IDX])
    assert np.isnan(bt[1]) and bt[2] == DATA[2, -1] and np.isnan(bt[3])
    (oh, _), = run(tmx, "one_hot", [], {"depth": 6}, values=[IDX])
    assert not oh[1].any() and not oh[2].any() and oh[0, 0] == 1
    (tk, _), = run(tmx, "take", [], values=[DATA, IDX])
    np.testing.assert_array_equal(tk[1], DATA[4])
    np.testing.assert_array_equal(tk[2], DATA[0])
    row = np.array([[1, 0, 1, 0, 1]], np.float32)
    (a, _), = run(tmx, "argsort", [], {"is_ascend": False}, values=[row])
    assert a.tolist() == [[4, 2, 0, 3, 1]]
    (t, _), = run(tmx, "topk", [], {"k": 2}, values=[row])
    assert t.tolist() == [[0, 2]]


def test_multi_output_topk_in_nd():
    with tmx.cpu():
        vals, idx = tmx.nd.topk(tmx.nd.array(TIES), k=2, ret_typ="both")
    assert vals.shape == idx.shape == (3, 2)
    assert idx.dtype == np.float32

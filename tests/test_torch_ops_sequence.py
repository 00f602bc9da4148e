"""The port's sequence ops (``ops/sequence.py``) and init ops
(``ops/init_ops.py``) against ``mxnet_tpu``'s: ``SequenceLast``,
``SequenceMask`` and ``SequenceReverse`` with and without
``use_sequence_length`` (forward bit-equal, backward within 1e-5 x
max|ref|), and ``_zeros``, ``_ones``, ``_arange``, ``zeros_like``,
``ones_like``."""
import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from test_torch_ops_common import (EXACT, _one_torch_thread,  # noqa: F401
                                   check, run)

T, N, C = 5, 4, 3
DATA = np.random.RandomState(5).randn(T, N, C).astype(np.float32)
# lengths of 1, T, a middle one, and fractional (truncated)
LENS = np.array([1, T, 3, 2.7], np.float32)

CASES = [
    ("SequenceLast", [DATA], {}),
    ("SequenceLast", [DATA, LENS], {"use_sequence_length": True}),
    ("SequenceLast", [DATA[..., 0], LENS], {"use_sequence_length": True}),
    ("SequenceMask", [DATA], {}),
    ("SequenceMask", [DATA, LENS], {"use_sequence_length": True}),
    ("SequenceMask", [DATA, LENS],
     {"use_sequence_length": True, "value": -2.5}),
    ("SequenceReverse", [DATA], {}),
    ("SequenceReverse", [DATA, LENS], {"use_sequence_length": True}),
    ("SequenceReverse", [DATA[..., 0], LENS], {"use_sequence_length": True}),
]


def _id(case):
    op, vals, attrs = case
    return "%s-%dd%s" % (op, vals[0].ndim, "".join(
        "-%s=%s" % kv for kv in sorted(attrs.items())))


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_sequence_forward_and_backward(case):
    op, vals, attrs = case
    check(op, [], attrs, tol=EXACT, values=vals)
    if op != "SequenceMask" or len(vals) > 1:
        check(op, [], attrs, grad=True, values=vals)
        return
    # without lengths the op returns its input array, whose gradient the
    # JAX package's eager tape doubles (ROADMAP Queue 3, traps): the
    # port's is the head gradient
    (_, _), (g, _) = run(tmx, op, [], attrs, grad=True, values=vals)
    head = np.random.RandomState(1).randn(*DATA.shape).astype(np.float32)
    np.testing.assert_array_equal(g, head)


INIT = [
    ("_zeros", {"shape": (2, 3)}),
    ("_ones", {"shape": (4,), "dtype": "int32"}),
    ("_arange", {"start": 1.0, "stop": 7.0, "step": 1.5}),
    ("_arange", {"start": 0.0, "stop": 5.0, "repeat": 2, "dtype": "int32"}),
]


@pytest.mark.parametrize("op,attrs", INIT, ids=["%s-%d" % (c[0], i)
                                                for i, c in enumerate(INIT)])
def test_init_ops(op, attrs):
    check(op, [], attrs, tol=EXACT, values=[])


@pytest.mark.parametrize("op", ["zeros_like", "ones_like"])
def test_like_ops(op):
    for v in (DATA, DATA.astype(np.int32)):
        check(op, [], tol=EXACT, values=[v])


def test_init_ops_take_the_context():
    """``ctx=None`` is the current context; a named one is taken."""
    with tmx.cpu():
        z = tmx.nd._zeros(shape=(2,))
    assert z._data.device.type == "cpu"
    z = tmx.nd._arange(stop=3.0, ctx=tmx.cpu())
    assert z._data.device.type == "cpu" and z.asnumpy().tolist() == [0, 1, 2]
    sym = tmx.sym._ones(shape=(2, 2), ctx="cpu(0)")
    assert sym.attr_dict()[sym.name]["ctx"] == "cpu(0)"

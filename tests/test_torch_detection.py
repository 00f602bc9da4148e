"""The detection slice of the port (``ops/contrib.py``'s MultiBox half,
``models/ssd.py``, ``metric.Loss``) against ``mxnet_tpu``'s.

The ops: ``MultiBoxPrior``, ``MultiBoxTarget`` and ``MultiBoxDetection``
of both packages, bound through ``simple_bind`` (the reference compiles
its graph, as in its SSD network) on the same numpy inputs from a seed:
small anchor sets with padding rows, label columns past the fifth,
zero scores and ties; bookkeeping (anchors, class targets, masks, class
ids and row order) bit-equal, ``loc_target``, scores and boxes within
1e-6 absolute.  The reference's own cases of
``tests/test_vision_contrib_ops.py`` and ``tests/test_ssd.py`` are
among them.  One rule differs by design (ROADMAP Queue 3): a ground
truth box is force-matched only when its row is valid, so the anchor-0
case is held to that formula, and every random case first asserts that
no valid box's best anchor is anchor 0.

The network: ``ssd_train(num_classes=3)`` at batch 1, 300 x 300, from
the reference's Xavier parameters carried by name: one ``Module``
``forward_backward`` and SGD update (the example's lr 0.002, momentum
0.9, wd 5e-4) on each package's classic route, from one module fixture.
The port's step runs twice: with its own ReLU and max-pool decisions,
and with the reference's replayed (``ReferenceKinks``: a ReLU input or
a max-pool window within float32 rounding of its kink can fall on the
other side in the two packages, which moves the gradients below it by
up to 2.7e-3 x max|ref|).  With the reference's decisions, every
output is within 1e-5 x max|ref|, every gradient within 1e-4 x max|ref|
and every parameter after the update within 1e-5 x max|ref|
(``0_scale``'s ``wd_mult`` 0.1 included).  With its own, the outputs
and the heads' gradients hold the same bounds, every gradient is
within KINK_GRAD x max|ref|, and every update follows the reference's
rule from the port's own gradient.  The MultiBox decisions are held by
replay: the port's ``cls_label`` and ``det_out`` equal the reference's
ops run on the port's own anchors, class and box predictions, and
``cls_label`` equals the reference network's own.
``ssd(num_classes=3)`` gives (1, 8732, 6) rows, held by the same
replay.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models.ssd import _RATIOS, _SIZES
from mxnet_tpu_torch.ops import contrib as tcontrib
from mxnet_tpu_torch.ops import nn as tnn

LOC_TOL = 1e-6           # loc_target, scores, boxes: absolute
FWD, GRAD, PARAM = 1e-5, 1e-4, 1e-5   # x max|ref|
# the port's step on its own ReLU and max-pool decisions: 4 ReLU inputs
# and 2 max-pool windows within rounding of their kinks decide otherwise
# than in the reference and move the gradients below fc6 by 4.6e-4 to
# 2.7e-3 x max|ref| (conv3_2); with the reference's decisions replayed
# every gradient holds GRAD
KINK_GRAD = 1e-2
SSD_CLASSES = 3
SSD_SHAPE = (1, 3, 300, 300)
SSD_OPT = {"learning_rate": 0.002, "momentum": 0.9, "wd": 5e-4}
# a loc and a cls head at scales that hold positive or mined anchors
GRAD_NAMES = ("conv4_3_weight", "conv_fc7_weight", "0_scale",
              "loc_pred3_conv_weight", "cls_pred2_conv_weight")
NMS_TOPK = 400


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module (under a parallel run each
    tiny torch op handed to a team of threads costs many times the op);
    restored when the module ends."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sym_run(pkg, op, values, **attrs):
    """``pkg.sym.<op>`` bound on numpy ``values``: one forward's outputs
    as numpy."""
    names = ["in%d" % i for i in range(len(values))]
    net = getattr(pkg.sym, op)(*[pkg.sym.Variable(n) for n in names],
                               **attrs)
    exe = net.simple_bind(pkg.cpu(), grad_req="null",
                          **{n: v.shape for n, v in zip(names, values)})
    for n, v in zip(names, values):
        exe.arg_dict[n][:] = v
    return [o.asnumpy() for o in exe.forward(is_train=False)]


def both(op, values, **attrs):
    return sym_run(tmx, op, values, **attrs), sym_run(jmx, op, values,
                                                      **attrs)


def group_run(pkg, op, cases):
    """Every case ``(values, attrs)`` of ``op`` as one ``Group`` bound
    once (one compile of the reference for the lot): each case's outputs
    as numpy."""
    heads, shapes, feed = [], {}, {}
    for c, (values, attrs) in enumerate(cases):
        names = ["c%d_in%d" % (c, i) for i in range(len(values))]
        heads.append(getattr(pkg.sym, op)(
            *[pkg.sym.Variable(n) for n in names], **attrs))
        shapes.update((n, v.shape) for n, v in zip(names, values))
        feed.update(zip(names, values))
    exe = pkg.sym.Group(heads).simple_bind(pkg.cpu(), grad_req="null",
                                           **shapes)
    for n, v in feed.items():
        exe.arg_dict[n][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=False)]
    per = len(outs) // len(cases)
    return [outs[c * per:(c + 1) * per] for c in range(len(cases))]


def hold_detections(got, want, what=""):
    """Class ids and row order bit-equal; scores and boxes within
    LOC_TOL."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got[..., 0], want[..., 0], err_msg=what)
    err = float(np.abs(got[..., 1:] - want[..., 1:]).max()) if got.size \
        else 0.0
    assert err <= LOC_TOL, (what, err)


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------
PRIOR_CASES = [
    # (feature map (H, W), attributes)
    ((4, 4), dict(sizes=(0.5, 0.25), ratios=(1.0, 2.0))),
    ((38, 38), dict(sizes=(.1, .141), ratios=(1, 2, .5))),
    ((19, 19), dict(sizes=(.2, .272), ratios=(1, 2, .5, 3, 1. / 3))),
    ((1, 1), dict(sizes=(.88, .961), ratios=(1, 2, .5))),
    ((3, 5), dict(sizes=(0.7, 1.3), ratios=(2.0, 0.5), clip=True)),
    ((6, 2), dict(sizes=(0.3,), ratios=(1.0, 3.0), steps=(0.1, 0.05),
                  offsets=(0.25, 0.75))),
    ((5, 7), dict()),
]


def eager_prior(data, **attrs):
    """The reference's ``MultiBoxPrior`` run op by op (its engine's
    ``set_imperative_jit(False)``): the float32 arithmetic its code
    states.  Compiled, XLA's CPU backend may contract ``(i + offset) *
    step - half`` into one FMA (the single-anchor 5 x 7 case: 1 ulp on
    28 of 140 coordinates); SSD's scales come out the same either way
    (``test_ssd_scales_equal_the_compiled_reference``)."""
    engine = jmx.engine.get()
    jit = engine.imperative_jit
    engine.set_imperative_jit(False)
    try:
        with jmx.cpu():
            return jmx.nd.MultiBoxPrior(jmx.nd.array(data),
                                        **attrs).asnumpy()
    finally:
        engine.set_imperative_jit(jit)


@pytest.mark.parametrize("hw,attrs", PRIOR_CASES,
                         ids=["%dx%d-%d" % (c[0] + (i,))
                              for i, c in enumerate(PRIOR_CASES)])
def test_multibox_prior_is_bit_equal(hw, attrs):
    data = np.zeros((2, 3) + hw, np.float32)
    (got,) = sym_run(tmx, "MultiBoxPrior", [data], **attrs)
    want = eager_prior(data, **attrs)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ssd_scales_equal_the_compiled_reference():
    """SSD-300's six feature maps with their sizes and ratios: the
    port's anchors equal the reference's compiled ones bit for bit."""
    scales = ((38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1))
    values = [np.zeros((1, 4) + hw, np.float32) for hw in scales]
    got, want = [], []
    for pkg, out in ((tmx, got), (jmx, want)):
        names = ["in%d" % i for i in range(len(values))]
        net = pkg.sym.Group([
            pkg.sym.MultiBoxPrior(pkg.sym.Variable(n), sizes=tuple(s),
                                  ratios=tuple(r))
            for n, s, r in zip(names, _SIZES, _RATIOS)])
        exe = net.simple_bind(pkg.cpu(), grad_req="null",
                              **{n: v.shape for n, v in zip(names, values)})
        out.extend(o.asnumpy() for o in exe.forward(is_train=False))
    assert sum(g.shape[1] for g in got) == 8732
    for hw, g, w in zip(scales, got, want):
        np.testing.assert_array_equal(g, w, err_msg=str(hw))


def test_multibox_prior_reference_case_and_copies():
    """The reference's own case (its first anchor centred at (0.125,
    0.125) with size 0.5); each call returns anchors of its own, and the
    input gets no gradient."""
    data = np.zeros((1, 8, 4, 4), dtype="float32")
    (got,) = sym_run(tmx, "MultiBoxPrior", [data], sizes=(0.5, 0.25),
                     ratios=(1.0, 2.0))
    assert got.shape == (1, 4 * 4 * 3, 4)
    np.testing.assert_allclose(got[0, 0], [0.125 - 0.25, 0.125 - 0.25,
                                           0.125 + 0.25, 0.125 + 0.25],
                               atol=1e-6)
    op = tmx.ops.registry.get_op("MultiBoxPrior")
    attrs = op.parse_attrs({"sizes": (0.5, 0.25), "ratios": (1.0, 2.0)})
    x = torch.zeros(1, 8, 4, 4, requires_grad=True)
    first = tcontrib._multibox_prior_fc(attrs, x)
    assert not first.requires_grad
    first.fill_(7.0)
    np.testing.assert_array_equal(
        tcontrib._multibox_prior_fc(attrs, x).numpy(), got)


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------
def target_case(seed, num_anchors=120, n=3, m=4, classes=4, cols=6,
                ties=False):
    """Anchors (1, A, 4) (anchor 0 a small box in the far corner), labels
    (N, M, cols) with 0..M-1 boxes an image and the padding rows last
    (the last image has none), class predictions (N, classes + 1, A);
    ``ties``: the predictions rounded to halves, a third of them 0."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(0, 0.8, (num_anchors, 2))
    wh = rs.uniform(0.05, 0.4, (num_anchors, 2))
    anchors = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    anchors[0] = [0.96, 0.96, 0.99, 0.99]
    label = np.full((n, m, cols), -1.0, np.float32)
    for i in range(n - 1):
        for j in range(rs.randint(1, m)):
            x0, y0 = rs.uniform(0.0, 0.55, 2)
            w, h = rs.uniform(0.15, 0.4, 2)
            label[i, j, :5] = [rs.randint(0, classes), x0, y0, x0 + w,
                               y0 + h]
            label[i, j, 5:] = rs.uniform(0, 1, cols - 5)
    cls_pred = rs.randn(n, classes + 1, num_anchors).astype(np.float32)
    if ties:
        cls_pred = np.round(cls_pred * 2) / 2
        cls_pred[rs.uniform(size=cls_pred.shape) < 0.33] = 0.0
    return anchors[None], label, cls_pred


def no_valid_best_anchor_zero(anchors, label):
    """The precondition of holding the port to the reference: no valid
    box's best anchor is anchor 0 (where the reference's padding rows
    can undo its forced match)."""
    ious = tcontrib._iou(torch.from_numpy(anchors[0]),
                         torch.from_numpy(label[..., 1:5]))
    best = torch.argmax(ious, dim=1).numpy()
    return not (best[label[..., 0] >= 0] == 0).any()


TARGET_CASES = [
    # (case seed, case keywords, attributes)
    (0, {}, {}),
    (1, {}, dict(negative_mining_ratio=3.0, overlap_threshold=0.5,
                 negative_mining_thresh=0.5, minimum_negative_samples=0)),
    (2, {}, dict(negative_mining_ratio=2.0, minimum_negative_samples=10,
                 ignore_label=-2.0)),
    (3, dict(ties=True), dict(negative_mining_ratio=3.0)),
    (4, dict(ties=True, cols=5), dict(negative_mining_ratio=1.5,
                                      minimum_negative_samples=3)),
    (5, {}, dict(overlap_threshold=0.3, variances=(0.2, 0.2, 0.5, 0.5),
                 negative_mining_ratio=3.0,
                 negative_mining_thresh=0.4)),
    (6, dict(num_anchors=300, n=2, m=6, cols=8),
     dict(negative_mining_ratio=3.0, overlap_threshold=0.6)),
    (7, dict(classes=1), dict(negative_mining_ratio=0.5)),
]


@pytest.fixture(scope="module")
def target_runs():
    cases = [(list(target_case(seed, **kw)), attrs)
             for seed, kw, attrs in TARGET_CASES]
    return cases, group_run(tmx, "MultiBoxTarget", cases), \
        group_run(jmx, "MultiBoxTarget", cases)


@pytest.mark.parametrize("i", range(len(TARGET_CASES)),
                         ids=["case%d" % c[0] for c in TARGET_CASES])
def test_multibox_target_matches_reference(target_runs, i):
    cases, port, ref = target_runs
    anchors, label, _ = cases[i][0]
    assert no_valid_best_anchor_zero(anchors, label)
    got, want = port[i], ref[i]
    for i, name in enumerate(("loc_target", "loc_mask", "cls_target")):
        assert got[i].dtype == want[i].dtype and \
            got[i].shape == want[i].shape, name
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert float(np.abs(got[0] - want[0]).max()) <= LOC_TOL
    assert (got[2] > 0).any()


def test_multibox_target_reference_cases():
    """``tests/test_vision_contrib_ops.py::test_multibox_target`` and
    the encode/decode round trip of ``tests/test_ssd.py``."""
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                         [0.0, 0.5, 0.5, 1.0]]], dtype="float32")
    label = np.array([[[1, 0.05, 0.05, 0.45, 0.45]]], dtype="float32")
    cls_pred = np.ones((1, 3, 3), dtype="float32") / 3
    got, want = both("MultiBoxTarget", [anchors, label, cls_pred])
    loc_t, loc_m, cls_t = got
    assert cls_t[0, 0] == 2.0 and cls_t[0, 1] == 0.0
    assert loc_m[0, :4].sum() == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOC_TOL)
    np.testing.assert_array_equal(got[2], want[2])

    anchors = np.array([[[0.2, 0.2, 0.6, 0.6]]], dtype="float32")
    gt = [0.25, 0.15, 0.65, 0.55]
    label = np.array([[[0] + gt]], dtype="float32")
    (loc_t, _, _), _ = both("MultiBoxTarget",
                            [anchors, label, np.ones((1, 2, 1), "f") / 2])
    cls_prob = np.array([[[0.1], [0.9]]], dtype="float32")
    got, want = both("MultiBoxDetection", [cls_prob, loc_t, anchors],
                     threshold=0.5)
    hold_detections(got[0], want[0])
    np.testing.assert_allclose(got[0][0, 0, 2:], gt, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("order", ["gt_first", "pad_first"])
def test_multibox_target_forces_valid_rows_only(order):
    """A valid box whose best anchor is anchor 0 is force-matched there
    whatever the place of the padding rows: ``cls_target`` is the box's
    class + 1 at anchor 0 and 0 elsewhere (IoU under the 0.95
    threshold).  Were the padding rows scattered too (their best anchor
    is anchor 0), ``gt_first`` would lose the match: the reference gives
    ``[0, 0, 0]`` there and ``[1, 0, 0]`` for ``pad_first``."""
    anchors = np.array([[[.1, .1, .5, .5], [.6, .6, .9, .9],
                         [.5, .5, .7, .7]]], np.float32)
    gt, pad = [0, .1, .1, .45, .45], [-1] * 5
    rows = [gt, pad] if order == "gt_first" else [pad, gt]
    label = np.array([rows], np.float32)
    cls_pred = np.zeros((1, 2, 3), np.float32)
    (loc_t, loc_m, cls_t), (_, _, ref_cls) = both(
        "MultiBoxTarget", [anchors, label, cls_pred],
        overlap_threshold=0.95)
    np.testing.assert_array_equal(cls_t, [[1, 0, 0]])
    np.testing.assert_array_equal(loc_m, [[1] * 4 + [0] * 8])
    # the formula: centre offsets over the anchor's size / 0.1, log size
    # ratios / 0.2
    want = np.array([(.275 - .3) / .4 / .1, (.275 - .3) / .4 / .1,
                     np.log(.35 / .4) / .2, np.log(.35 / .4) / .2])
    np.testing.assert_allclose(loc_t[0, :4], want, rtol=0, atol=1e-6)
    assert ref_cls.tolist() == ([[0, 0, 0]] if order == "gt_first"
                                else [[1, 0, 0]])


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------
def detection_case(seed, num_anchors=90, n=2, classes=3, ties=False,
                   raw=False):
    """Class probabilities (N, classes + 1, A) (``ties``: rounded to
    tenths, many equal; ``raw``: normal draws, negative too), box deltas
    (N, A*4) and anchors (1, A, 4) clustered so that NMS suppresses."""
    rs = np.random.RandomState(100 + seed)
    centres = rs.uniform(0.2, 0.8, (6, 2))
    xy = centres[rs.randint(0, 6, num_anchors)] + \
        rs.normal(0, 0.03, (num_anchors, 2))
    wh = rs.uniform(0.1, 0.3, (num_anchors, 2))
    anchors = np.concatenate([xy - wh / 2, xy + wh / 2], 1)
    if raw:
        prob = rs.randn(n, classes + 1, num_anchors)
    else:
        prob = rs.dirichlet(np.ones(classes + 1) * 0.5,
                            size=(n, num_anchors)).transpose(0, 2, 1)
        if ties:
            prob = np.round(prob * 10) / 10
    loc = rs.randn(n, num_anchors * 4) * 0.5
    return (prob.astype(np.float32), loc.astype(np.float32),
            anchors[None].astype(np.float32))


DETECTION_CASES = [
    (0, {}, {}),
    (1, {}, dict(nms_topk=10)),
    (2, {}, dict(nms_topk=1000, nms_threshold=0.3)),
    (3, {}, dict(nms_topk=25, force_suppress=True)),
    (4, {}, dict(clip=False, nms_threshold=0.7)),
    (5, {}, dict(background_id=2, nms_topk=30)),
    (6, {}, dict(background_id=3, threshold=0.3)),
    (7, dict(ties=True), dict(nms_topk=20)),
    (8, dict(ties=True), dict(threshold=0.0, force_suppress=True)),
    (9, dict(raw=True), dict(threshold=-0.5, nms_topk=15)),
    (10, dict(raw=True, classes=1), dict(threshold=-2.0)),
    (11, dict(num_anchors=400, n=3, classes=5), dict(nms_topk=40)),
]


@pytest.fixture(scope="module")
def detection_runs():
    cases = [(list(detection_case(seed, **kw)), attrs)
             for seed, kw, attrs in DETECTION_CASES]
    return cases, group_run(tmx, "MultiBoxDetection", cases), \
        group_run(jmx, "MultiBoxDetection", cases)


@pytest.mark.parametrize("i", range(len(DETECTION_CASES)),
                         ids=["case%d" % c[0] for c in DETECTION_CASES])
def test_multibox_detection_matches_reference(detection_runs, i):
    cases, port, ref = detection_runs
    attrs = cases[i][1]
    (got,), (want,) = port[i], ref[i]
    assert got.dtype == want.dtype
    hold_detections(got, want, str(attrs))
    kept = got[..., 0] >= 0
    assert kept.any() and (~kept).any()


def test_multibox_detection_reference_case():
    """``tests/test_vision_contrib_ops.py::test_multibox_detection``."""
    anchors = np.array([[[0.1, 0.1, 0.4, 0.4],
                         [0.6, 0.6, 0.9, 0.9]]], dtype="float32")
    cls_prob = np.array([[[0.1, 0.8], [0.9, 0.2]]], dtype="float32")
    loc_pred = np.zeros((1, 8), dtype="float32")
    (got,), (want,) = both("MultiBoxDetection", [cls_prob, loc_pred,
                                                 anchors], threshold=0.5)
    assert got.shape == (1, 2, 6)
    np.testing.assert_allclose(got[0, 0, :2], [0, 0.9], atol=1e-5)
    np.testing.assert_allclose(got[0, 0, 2:], [0.1, 0.1, 0.4, 0.4],
                               atol=1e-5)
    assert got[0, 1, 0] == -1
    hold_detections(got, want)


def test_nms_visits_the_top_k_candidates():
    """``nms_topk`` > 0 with ``threshold`` >= 0 visits ``nms_topk``
    candidates, every other case all of them."""
    op = tmx.ops.registry.get_op("MultiBoxDetection")
    k = [tcontrib._nms_candidates(op.parse_attrs(a), 8732) for a in (
        {"nms_topk": 400}, {"nms_topk": 9000}, {}, {"nms_topk": 0},
        {"nms_topk": 400, "threshold": -0.1},
        {"nms_topk": 400, "threshold": 0.0})]
    assert k == [400, 8732, 8732, 8732, 8732, 400]


# ---------------------------------------------------------------------------
# metric.Loss
# ---------------------------------------------------------------------------
def test_loss_metric_averages_every_output():
    rs = np.random.RandomState(3)
    preds = [rs.randn(2, 21, 5).astype(np.float32),
             rs.randn(2, 20).astype(np.float32)]
    got, want = [], []
    for pkg, out in ((tmx, got), (jmx, want)):
        with pkg.cpu():
            metric = pkg.metric.create("loss")
            for _ in range(2):
                metric.update(None, [pkg.nd.array(p) for p in preds])
        out.append(metric.get())
    assert got[0][0] == want[0][0] == "loss"
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=1e-6)
    assert isinstance(tmx.metric.create("loss"), tmx.metric.Loss)


# ---------------------------------------------------------------------------
# the SSD network
# ---------------------------------------------------------------------------
class SyntheticDetIter(tmx.io.DataIter):
    """A copy of ``examples/ssd/train.py``'s ``SyntheticDetIter`` over the
    port (the example imports the JAX package): scenes with 1-2
    axis-aligned coloured boxes on noise; label rows ``[cls, xmin, ymin,
    xmax, ymax]`` padded with -1."""

    def __init__(self, num_classes, batch_size, data_shape, num_batches,
                 seed=0):
        super().__init__(batch_size)
        self.rs = np.random.RandomState(seed)
        self.num_classes = num_classes
        self.data_shape = data_shape
        self.num_batches = num_batches
        self.cur = 0
        self.provide_data = [tmx.io.DataDesc(
            "data", (batch_size,) + data_shape)]
        self.provide_label = [tmx.io.DataDesc("label", (batch_size, 2, 5))]

    def reset(self):
        self.cur = 0

    def next(self):
        if self.cur >= self.num_batches:
            raise StopIteration
        self.cur += 1
        b = self.batch_size
        c, h, w = self.data_shape
        data = self.rs.uniform(-1, 1, (b, c, h, w)).astype(np.float32) * 0.1
        label = np.full((b, 2, 5), -1.0, dtype=np.float32)
        for i in range(b):
            for j in range(self.rs.randint(1, 3)):
                cls = self.rs.randint(0, self.num_classes)
                x0, y0 = self.rs.uniform(0.05, 0.5, 2)
                bw, bh = self.rs.uniform(0.2, 0.45, 2)
                x1, y1 = min(x0 + bw, 0.95), min(y0 + bh, 0.95)
                px0, py0 = int(x0 * w), int(y0 * h)
                px1, py1 = int(x1 * w), int(y1 * h)
                data[i, cls % c, py0:py1, px0:px1] += 1.0
                label[i, j] = [cls, x0, y0, x1, y1]
        return tmx.io.DataBatch(data=[tmx.nd.array(data)],
                                label=[tmx.nd.array(label)], pad=0)


def test_ssd_shapes_match_reference():
    """8732 anchors at 300 x 300 (38^2*4 + 19^2*6 + 10^2*6 + 5^2*6 +
    3^2*4 + 4); the same argument names, shapes and ``0_scale``'s
    attributes as the reference."""
    shapes = {}
    for pkg in (tmx, jmx):
        net = pkg.models.ssd_train(num_classes=20)
        args, outs, aux = net.infer_shape(data=(1, 3, 300, 300),
                                          label=(1, 2, 5))
        shapes[pkg] = (net.list_arguments(), args, net.list_outputs(),
                       outs, aux, net.attr_dict().get("0_scale"))
        inf = pkg.models.ssd(num_classes=3, nms_thresh=0.45)
        assert inf.infer_shape(data=(1, 3, 300, 300))[1] == [(1, 8732, 6)]
    assert shapes[tmx] == shapes[jmx]
    outs = dict(zip(shapes[tmx][2], shapes[tmx][3]))
    assert outs["cls_label_output"] == (1, 8732)
    assert outs["cls_prob_output"] == (1, 21, 8732)
    assert outs["loc_loss_output"] == (1, 8732 * 4)
    assert outs["det_out_output"] == (1, 8732, 6)


def test_synthetic_det_iter_copy():
    it = SyntheticDetIter(20, 3, (3, 30, 30), 2, seed=26)
    with tmx.cpu():
        batches = list(it)
    assert len(batches) == 2
    label = batches[0].label[0].asnumpy()
    assert label.shape == (3, 2, 5) and (label[:, 0, 0] >= 0).all()
    pad = label[:, 1, 0] < 0
    assert (label[pad, 1] == -1).all()
    it.reset()
    with tmx.cpu():
        assert next(it).data[0].shape == (3, 3, 30, 30)


INTERNALS = ("multibox_cls_pred_output", "multibox_loc_pred_output",
             "multibox_anchors_output")


def ssd_batch(pkg, seed=0):
    rs = np.random.RandomState(seed)
    data = rs.uniform(-1, 1, SSD_SHAPE).astype(np.float32)
    label = np.full((1, 2, 5), -1.0, np.float32)
    label[0, 0] = [1.0, 0.3, 0.3, 0.7, 0.7]
    with pkg.cpu():
        return data, label, pkg.io.DataBatch([pkg.nd.array(data)],
                                             [pkg.nd.array(label)])


def module_step(pkg, params=None):
    """One classic-route ``forward_backward`` and SGD update of
    ``ssd_train(3)``: the parameters it started from, its outputs,
    gradients, parameters after the update, and (the port) the
    internals of ``INTERNALS``."""
    net = pkg.models.ssd_train(num_classes=SSD_CLASSES)
    mod = pkg.mod.Module(net, data_names=("data",), label_names=("label",),
                         context=pkg.cpu())
    data, label, batch = ssd_batch(pkg)
    mod.bind(data_shapes=[("data", data.shape)],
             label_shapes=[("label", label.shape)])
    if params is None:
        np.random.seed(0)
        mod.init_params(initializer=pkg.init.Xavier(
            rnd_type="gaussian", factor_type="in", magnitude=2))
        params = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
        # biases off 0, as the reference's init leaves them: no ReLU
        # input sits at its kink, where the gradient is 0.5 in the
        # reference and 0 in the port (ROADMAP Queue 3)
        rs = np.random.RandomState(1)
        for n in params:
            if n.endswith("_bias"):
                params[n] = rs.uniform(-0.05, 0.05,
                                       params[n].shape).astype(np.float32)
        mod.set_params(params, {})
    else:
        mod.init_params(arg_params=params, aux_params={})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SSD_OPT))
    internals = {}
    if pkg is tmx:
        exe = mod._exec_group.executor
        exe.set_monitor_callback(
            lambda name, a: internals.__setitem__(name, a.asnumpy())
            if name in INTERNALS else None)
        grads = exe.grad_dict
    else:
        grads = mod._exec_group.execs[0].grad_dict
    mod.forward_backward(batch)
    outs = [o.asnumpy() for o in mod.get_outputs()]
    grads = {n: grads[n].asnumpy() for n in params}
    mod.update()
    after = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    return dict(params=params, outs=outs, grads=grads, after=after,
                internals=internals, label=label)


def kink_nodes(pkg):
    """The network's ReLUs and max pools in graph order: (op, the name
    of the internal output they read)."""
    nodes = json.loads(pkg.models.ssd_train(
        num_classes=SSD_CLASSES).tojson())["nodes"]
    return [(n["op"], nodes[n["inputs"][0][0]]["name"] + "_output")
            for n in nodes if n["op"] in ("Activation", "Pooling")]


class ReferenceKinks:
    """The reference's ReLU and max-pool decisions on ``ssd_batch`` from
    ``params``, replayed in the port's step: the inputs of the network's
    ReLUs and max pools from the reference's compiled forward, and,
    under ``patched()``, the port's ReLU ``x * (ref > 0)`` and its max
    pool gathering the element the reference's window takes as its max,
    so that the port's backward follows the reference's decisions.  Each
    replayed input must lie within 1e-3 x max|ref| of the reference's
    (the graph orders agree); ``flips`` counts the ReLU inputs and
    max-pool windows where the port's own decision differs."""

    def __init__(self, params):
        self.order = kink_nodes(tmx)
        assert self.order == kink_nodes(jmx)
        names = list(dict.fromkeys(n for _, n in self.order))
        inner = jmx.models.ssd_train(num_classes=SSD_CLASSES).get_internals()
        group = jmx.sym.Group([inner[n] for n in names])
        data, _, _ = ssd_batch(jmx)
        exe = group.simple_bind(jmx.cpu(), grad_req="null", data=data.shape)
        for n in group.list_arguments():
            exe.arg_dict[n][:] = data if n == "data" else params[n]
        self.values = {n: torch.from_numpy(o.asnumpy()) for n, o in
                       zip(group.list_outputs(),
                           exe.forward(is_train=False))}
        self.flips = {"Activation": 0, "Pooling": 0}

    def _next(self, seen, op, x):
        kind, name = self.order[len(seen)]
        seen.append(name)
        ref = self.values[name]
        assert kind == op and ref.shape == x.shape, (name, op, x.shape)
        assert float((x.detach() - ref).abs().max()) <= \
            1e-3 * float(ref.abs().max()), name
        return ref

    @contextlib.contextmanager
    def patched(self):
        act, pool = (tmx.ops.registry.get_op(n)
                     for n in ("Activation", "Pooling"))
        act_fc, pool_fc = act.fcompute, pool.fcompute
        seen = []

        def relu(attrs, x):
            assert attrs["act_type"] == "relu"
            mask = self._next(seen, "Activation", x) > 0
            self.flips["Activation"] += int((mask != (x > 0)).sum())
            return x * mask.to(x.dtype)

        def max_pool(attrs, x):
            assert attrs["pool_type"] == "max" and not attrs["global_pool"]
            kernel = tuple(attrs["kernel"])
            stride, pad = attrs["stride"] or (1, 1), attrs["pad"] or (0, 0)
            ref = self._next(seen, "Pooling", x)
            padded = tnn.pool_pad(attrs, x, kernel, stride, pad)
            with torch.no_grad():
                _, idx = torch.nn.functional.max_pool2d(
                    tnn.pool_pad(attrs, ref, kernel, stride, pad), kernel,
                    stride, return_indices=True)
                _, own = torch.nn.functional.max_pool2d(
                    padded, kernel, stride, return_indices=True)
            self.flips["Pooling"] += int((idx != own).sum())
            return padded.flatten(2).gather(2, idx.flatten(2)).view(
                idx.shape)

        act.fcompute, pool.fcompute = relu, max_pool
        try:
            yield self
        finally:
            act.fcompute, pool.fcompute = act_fc, pool_fc
        assert len(seen) == len(self.order)


@pytest.fixture(scope="module")
def ssd_steps():
    """The reference's step from its Xavier parameters, then the port's
    from the same numpy arrays (both classic routes, the reference on
    its plain XLA lowerings): on the port's own ReLU and max-pool
    decisions, and on the reference's (``port["replayed"]``)."""
    saved = {k: os.environ.get(k) for k in ("MXNET_PALLAS",
                                            "MXNET_MODULE_FUSED")}
    os.environ.update(MXNET_PALLAS="0", MXNET_MODULE_FUSED="0")
    try:
        ref = module_step(jmx)
        port = module_step(tmx, ref["params"])
        kinks = ReferenceKinks(ref["params"])
        with kinks.patched():
            port["replayed"] = module_step(tmx, ref["params"])
        port["flips"] = kinks.flips
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return port, ref


def rel_err(got, want):
    return float(np.abs(got - want).max()) / \
        max(float(np.abs(want).max()), 1e-30)


def test_ssd_step_outputs_and_gradients(ssd_steps):
    """With the reference's ReLU and max-pool decisions replayed, every
    output within FWD and every gradient within GRAD x max|ref|; on the
    port's own decisions, the outputs and the heads' gradients within
    the same bounds and every gradient within KINK_GRAD x max|ref|."""
    port, ref = ssd_steps
    assert np.all(ref["params"]["0_scale"] == 20.0)
    assert ref["outs"][1].any()
    for name in GRAD_NAMES:
        assert np.abs(ref["grads"][name]).max() > 0, name
    for got in (port["replayed"], port):
        for i, name in ((0, "cls_prob"), (1, "loc_loss")):
            assert got["outs"][i].shape == ref["outs"][i].shape
            assert rel_err(got["outs"][i], ref["outs"][i]) <= FWD, name
    np.testing.assert_array_equal(port["replayed"]["outs"][2],
                                  ref["outs"][2])
    for name, want in ref["grads"].items():
        err = rel_err(port["replayed"]["grads"][name], want)
        assert err <= GRAD, (name, err, port["flips"])
    # the heads and the layers above the lowest max pools hold the bound
    for name in GRAD_NAMES[1:]:
        assert rel_err(port["grads"][name], ref["grads"][name]) <= GRAD
    for name, want in ref["grads"].items():
        err = rel_err(port["grads"][name], want)
        assert err <= KINK_GRAD, (name, err, port["flips"])


def test_ssd_update_matches_reference(ssd_steps):
    """With the reference's decisions replayed, every updated parameter
    within PARAM x max|ref|.  On the port's own gradients: the
    parameters whose gradients hold GRAD within PARAM x max|ref|, and
    every parameter within PARAM x max|ref| of the reference's update
    moved by the port's gradient in its place (lr x (ref - port); the
    first step, so no momentum yet)."""
    port, ref = ssd_steps
    lr = SSD_OPT["learning_rate"]
    for got in (port["replayed"], port):
        assert set(got["after"]) == set(ref["after"])
    for name, want in ref["after"].items():
        err = rel_err(port["replayed"]["after"][name], want)
        assert err <= PARAM, (name, err, port["flips"])
    for name in GRAD_NAMES[1:]:
        assert rel_err(port["after"][name], ref["after"][name]) <= PARAM
    for name, want in ref["after"].items():
        moved = want + lr * (ref["grads"][name] - port["grads"][name])
        err = rel_err(port["after"][name], moved)
        assert err <= PARAM, (name, err)
    # 0_scale moved by lr * (grad + 0.1 * wd * w): its wd_mult is 0.1
    g = port["grads"]["0_scale"]
    want = 20.0 - lr * (g + 0.1 * SSD_OPT["wd"] * 20.0)
    np.testing.assert_allclose(port["after"]["0_scale"], want, rtol=0,
                               atol=1e-6)


def mining_gap(cls_pred, cls_label):
    """The background scores on each side of the mining cut: the largest
    kept negative's and the smallest candidate left out."""
    bg = cls_pred[0, 0]
    kept = bg[cls_label[0] == 0]
    out = bg[cls_label[0] == -1]
    return (float(kept.max()) if kept.size else None,
            float(out.min()) if out.size else None)


def test_ssd_decisions_replay_on_the_reference(ssd_steps):
    port, ref = ssd_steps
    cls_pred, loc_pred, anchors = (port["internals"][n] for n in INTERNALS)
    with jmx.cpu():
        nd = jmx.nd
        _, _, cls_t = nd.MultiBoxTarget(
            nd.array(anchors), nd.array(port["label"]), nd.array(cls_pred),
            overlap_threshold=.5, ignore_label=-1,
            negative_mining_ratio=3, minimum_negative_samples=0,
            negative_mining_thresh=.5, variances=(0.1, 0.1, 0.2, 0.2))
        det = nd.MultiBoxDetection(
            nd.array(port["outs"][0]), nd.array(loc_pred),
            nd.array(anchors), nms_threshold=0.5, force_suppress=False,
            variances=(0.1, 0.1, 0.2, 0.2), nms_topk=NMS_TOPK)
        cls_t, det = cls_t.asnumpy(), det.asnumpy()
    cls_label = port["outs"][2]
    gap = mining_gap(cls_pred, cls_label)
    np.testing.assert_array_equal(cls_label, cls_t,
                                  err_msg="mining cut %s" % (gap,))
    np.testing.assert_array_equal(cls_label, ref["outs"][2],
                                  err_msg="mining cut %s" % (gap,))
    assert (cls_label > 0).any() and (cls_label == -1).any()
    hold_detections(port["outs"][3], det, "det_out")
    assert port["outs"][3].shape == (1, 8732, 6)


def test_ssd_inference_rows_replay_on_the_reference(ssd_steps):
    port, _ = ssd_steps
    net = tmx.models.ssd(num_classes=SSD_CLASSES, nms_thresh=0.45)
    data, _, _ = ssd_batch(tmx)
    exe = net.simple_bind(tmx.cpu(), grad_req="null", data=data.shape)
    for n, v in port["params"].items():
        exe.arg_dict[n][:] = v
    exe.arg_dict["data"][:] = data
    seen = {}
    exe.set_monitor_callback(
        lambda name, a: seen.__setitem__(name, a.asnumpy())
        if name in INTERNALS + ("cls_prob_output",) else None)
    (out,) = [o.asnumpy() for o in exe.forward(is_train=False)]
    assert out.shape == (1, 8732, 6)
    with jmx.cpu():
        nd = jmx.nd
        det = nd.MultiBoxDetection(
            nd.array(seen["cls_prob_output"]),
            nd.array(seen["multibox_loc_pred_output"]),
            nd.array(seen["multibox_anchors_output"]), nms_threshold=0.45,
            force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
            nms_topk=NMS_TOPK)
    hold_detections(out, det.asnumpy(), "ssd")
    assert (out[..., 0] >= 0).any()

"""Contrib operators (counterpart of ``mxnet_tpu/ops/contrib.py``), its
SSD half: ``MultiBoxPrior`` (anchors), ``MultiBoxTarget`` (training
targets) and ``MultiBoxDetection`` (decoding and greedy NMS), each also
under its ``_contrib_`` name, with the reference's attributes, defaults
and shapes.  The reference computes them in plain ``jnp`` (no Pallas
kernel), so these are plain PyTorch, batched over the images, with no
host copy, host sync or Python loop over the batch.  Every sort is
stable, as ``jnp.argsort``, on keys whose zeros are made positive (the
reference's comparator puts -0 beside +0).

``MultiBoxPrior`` depends on the input's shape only: each call builds
its anchors on the input's device, with no host copy; the half-widths
and half-heights are computed in float64, as the reference's
``np.sqrt``, and rounded once to float32, the centres in float32 as
``(arange + offset) * step``.  The input takes no gradient.

``MultiBoxTarget`` and ``MultiBoxDetection`` give outputs that carry no
gradient.  One rule differs from the reference on purpose: a ground
truth box is force-matched to its best anchor only when its row is
valid (class >= 0), whatever the order of the rows.  The reference
scatters the padding rows too (their best anchor is anchor 0, the last
write wins), so a valid box whose best anchor is anchor 0 loses its
forced match when a padding row follows it.

``MultiBoxDetection`` runs the reference's greedy NMS over the top
``K`` candidates by score rather than over every anchor: only a
candidate with a positive score can suppress, and after the
``nms_topk`` cut those are among the first ``nms_topk`` in score
order; a candidate past them is never alive, and with ``threshold >=
0`` it already has score 0 and class -1, so suppressing it changes
nothing.  ``K`` is ``min(nms_topk, anchors)``, or every anchor when
``nms_topk <= 0`` or ``threshold < 0``.  The loop has a static trip
count of ``K`` steps, each two launches over the whole batch.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import Bool, Float, FloatTuple, Int, register, register_alias

_INF = float("inf")


def _stable_order(key):
    """The stable ascending order of each row of ``key``, -0.0 made +0.0
    first (the reference's sort canonicalizes zeros before comparing)."""
    return torch.argsort(key + 0.0, dim=-1, stable=True)


def _rank(order):
    """``rank[order] = arange``: each element's place in ``order``."""
    idx = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, idx)


# ---------------------------------------------------------------------------
# MultiBoxPrior
# ---------------------------------------------------------------------------
def _half_sizes(sizes, ratios):
    """Each anchor's half-width and half-height: the sizes with
    ``ratios[0]``, then ``ratios[1:]`` with ``sizes[0]``; float64 then
    float32, as the reference's ``jnp.asarray`` of ``np.sqrt``'s."""
    ws, hs = [], []
    for s in sizes:
        ws.append(s * np.sqrt(ratios[0]) / 2)
        hs.append(s / np.sqrt(ratios[0]) / 2)
    for r in ratios[1:]:
        ws.append(sizes[0] * np.sqrt(r) / 2)
        hs.append(sizes[0] / np.sqrt(r) / 2)
    return (np.asarray(ws, np.float32).tolist(),
            np.asarray(hs, np.float32).tolist())


def _build_priors(attrs, in_h, in_w, device):
    steps, offsets = attrs["steps"], attrs["offsets"]
    step_y = steps[0] if steps[0] > 0 else 1.0 / in_h
    step_x = steps[1] if steps[1] > 0 else 1.0 / in_w
    f32 = lambda v: float(np.float32(v))  # noqa: E731  (exact in float32)
    cy = (torch.arange(in_h, dtype=torch.float32, device=device)
          + f32(offsets[0])) * f32(step_y)
    cx = (torch.arange(in_w, dtype=torch.float32, device=device)
          + f32(offsets[1])) * f32(step_x)
    cy, cx = cy[:, None].expand(in_h, in_w), cx[None, :].expand(in_h, in_w)
    per_anchor = [torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
                  for w, h in zip(*_half_sizes(attrs["sizes"],
                                               attrs["ratios"]))]
    anchors = torch.stack(per_anchor, dim=2)  # (H, W, A, 4)
    if attrs["clip"]:
        anchors = torch.clamp(anchors, 0.0, 1.0)
    return anchors.reshape(1, -1, 4)


def _multibox_prior_fc(attrs, data):
    _, _, in_h, in_w = data.shape
    return _build_priors(attrs, in_h, in_w, data.device).to(data.dtype)


def _multibox_prior_infer(attrs, in_shapes):
    (ds,) = in_shapes
    if ds is None:
        return in_shapes, [None], []
    num = len(attrs["sizes"]) + len(attrs["ratios"]) - 1
    return in_shapes, [(1, ds[2] * ds[3] * num, 4)], []


register("_contrib_MultiBoxPrior", fcompute=_multibox_prior_fc,
         attrs={"sizes": FloatTuple((1.0,)), "ratios": FloatTuple((1.0,)),
                "clip": Bool(False), "steps": FloatTuple((-1.0, -1.0)),
                "offsets": FloatTuple((0.5, 0.5))},
         infer_shape=_multibox_prior_infer,
         doc="SSD anchors (1, H*W*A, 4) of a feature map's shape: sizes "
             "with ratios[0], then ratios[1:] with sizes[0].")
register_alias("_contrib_MultiBoxPrior", "MultiBoxPrior")


# ---------------------------------------------------------------------------
# box helpers
# ---------------------------------------------------------------------------
def _iou(boxes_a, boxes_b):
    """(..., A, 4) x (..., B, 4) -> (..., A, B) IoU (corner format)."""
    ax1, ay1, ax2, ay2 = boxes_a.unbind(-1)
    bx1, by1, bx2, by2 = boxes_b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    inter = torch.clamp(ix2 - ix1, min=0.0) * torch.clamp(iy2 - iy1, min=0.0)
    area_a = torch.clamp((ax2 - ax1) * (ay2 - ay1), min=0.0)
    area_b = torch.clamp((bx2 - bx1) * (by2 - by1), min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _corners(boxes):
    """Width, height and centre of corner-format boxes."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return x2 - x1, y2 - y1, (x1 + x2) / 2, (y1 + y2) / 2


def _encode_boxes(anchors, gt, variances):
    """SSD box encoding: centre offsets over the anchor's size and log
    size ratios, each over its variance.  The division by a variance is
    a product with its float32 reciprocal, as XLA compiles the
    reference's division by a constant."""
    aw, ah, acx, acy = _corners(anchors)
    gw, gh, gcx, gcy = _corners(gt)
    eps = 1e-8
    aw, ah = torch.clamp(aw, min=eps), torch.clamp(ah, min=eps)
    inv = [float(np.float32(1.0) / np.float32(v)) for v in variances]
    tx = (gcx - acx) / aw * inv[0]
    ty = (gcy - acy) / ah * inv[1]
    tw = torch.log(torch.clamp(gw / aw, min=eps)) * inv[2]
    th = torch.log(torch.clamp(gh / ah, min=eps)) * inv[3]
    return torch.stack([tx, ty, tw, th], dim=-1)


def _decode_boxes(anchors, deltas, variances, clip):
    aw, ah, acx, acy = _corners(anchors)
    dx, dy, dw, dh = deltas.unbind(-1)
    cx = dx * variances[0] * aw + acx
    cy = dy * variances[1] * ah + acy
    w = torch.exp(dw * variances[2]) * aw / 2
    h = torch.exp(dh * variances[3]) * ah / 2
    out = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------
def _multibox_target_fc(attrs, anchor, label, cls_pred):
    """anchor (1, A, 4); label (N, M, 5+) rows ``[cls, x1, y1, x2, y2]``,
    class -1 for padding; cls_pred (N, classes + 1, A), ranked on its
    row 0 for negative mining."""
    with torch.no_grad():
        anchors = anchor.detach().reshape(-1, 4)
        label, cls_pred = label.detach(), cls_pred.detach()
        n, num_anchors = label.shape[0], anchors.shape[0]
        valid_gt = label[..., 0] >= 0                        # (N, M)
        gt_boxes = label[..., 1:5]
        ious = _iou(anchors, gt_boxes)                       # (N, A, M)
        ious = torch.where(valid_gt[:, None, :], ious, -1.0)
        best_iou = torch.amax(ious, dim=2)                   # (N, A)
        best_gt = torch.argmax(ious, dim=2)
        # each valid gt's best anchor is positive (padding rows never
        # take part, whatever their place)
        best_anchor = torch.argmax(ious, dim=1)              # (N, M)
        arange = torch.arange(num_anchors, device=anchors.device)
        forced = ((best_anchor[..., None] == arange) &
                  valid_gt[..., None]).any(dim=1)            # (N, A)
        positive = forced | (best_iou >= attrs["overlap_threshold"])
        gt_cls = torch.gather(label[..., 0], 1, best_gt)
        cls_target = torch.where(positive, gt_cls + 1.0, 0.0)
        ratio = attrs["negative_mining_ratio"]
        if ratio > 0:
            num_pos = positive.sum(dim=1, dtype=torch.int32)
            max_neg = torch.clamp((ratio * num_pos.to(torch.float32))
                                  .to(torch.int32),
                                  min=attrs["minimum_negative_samples"])
            neg_cand = ~positive & (best_iou <
                                    attrs["negative_mining_thresh"])
            # hardest negatives first: the lowest background score
            order = _stable_order(torch.where(neg_cand, cls_pred[:, 0],
                                              _INF))
            keep_neg = neg_cand & (_rank(order) < max_neg[:, None])
            cls_target = torch.where(
                positive, cls_target,
                torch.where(keep_neg, 0.0, attrs["ignore_label"]))
        matched = torch.gather(gt_boxes, 1,
                               best_gt[..., None].expand(n, num_anchors, 4))
        loc_t = _encode_boxes(anchors, matched, attrs["variances"])
        pos4 = positive[..., None]
        loc_target = torch.where(pos4, loc_t, 0.0).reshape(n, -1)
        loc_mask = torch.where(pos4, torch.ones_like(loc_t), 0.0) \
            .reshape(n, -1)
    return loc_target, loc_mask, cls_target


def _multibox_target_infer(attrs, in_shapes):
    anchor_s, label_s, _ = in_shapes
    if anchor_s is None or label_s is None:
        return in_shapes, [None, None, None], []
    num_anchors, n = anchor_s[1], label_s[0]
    return in_shapes, [(n, num_anchors * 4), (n, num_anchors * 4),
                       (n, num_anchors)], []


register("_contrib_MultiBoxTarget", fcompute=_multibox_target_fc,
         arguments=("anchor", "label", "cls_pred"),
         outputs=("loc_target", "loc_mask", "cls_target"), num_outputs=3,
         attrs={"overlap_threshold": Float(0.5), "ignore_label": Float(-1.0),
                "negative_mining_ratio": Float(-1.0),
                "negative_mining_thresh": Float(0.5),
                "minimum_negative_samples": Int(0),
                "variances": FloatTuple((0.1, 0.1, 0.2, 0.2))},
         infer_shape=_multibox_target_infer,
         doc="SSD training targets: loc_target, loc_mask (N, A*4) and "
             "cls_target (N, A), with hard negative mining.")
register_alias("_contrib_MultiBoxTarget", "MultiBoxTarget")


# ---------------------------------------------------------------------------
# MultiBoxDetection
# ---------------------------------------------------------------------------
def _gather_rows(x, idx):
    """``x[n, idx[n]]`` for (N, A) or (N, A, k) ``x`` and (N, K) ``idx``."""
    if x.dim() == 2:
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _nms_keep(boxes, score, classes, nms_threshold, force_suppress, k):
    """The reference's greedy NMS keep mask (N, A), run over the first
    ``k`` candidates in score order: ``k`` steps of two launches, each
    over the whole batch."""
    order = _stable_order(-score)[:, :k]                     # (N, K)
    b, s, c = (_gather_rows(t, order) for t in (boxes, score, classes))
    arange = torch.arange(k, device=score.device)
    suppress = ((_iou(b, b) > nms_threshold)
                & (arange[None, :] > arange[:, None])
                & (s > 0)[..., None])                        # (N, K, K)
    if not force_suppress:
        suppress &= c[..., :, None] == c[..., None, :]
    suppress = suppress.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=score.device)
    keep = torch.ones(order.shape, dtype=torch.float32, device=score.device)
    for i in range(k):
        keep.mul_(torch.addcmul(one, keep[:, i:i + 1], suppress[:, i],
                                value=-1.0))
    full = torch.ones(score.shape, dtype=torch.bool, device=score.device)
    return full.scatter_(1, order, keep > 0.5)


def _nms_candidates(attrs, num_anchors):
    """How many candidates in score order NMS must visit (see the
    module's docstring)."""
    topk = attrs["nms_topk"]
    if topk > 0 and attrs["threshold"] >= 0:
        return min(topk, num_anchors)
    return num_anchors


def _multibox_detection_fc(attrs, cls_prob, loc_pred, anchor):
    """cls_prob (N, classes + 1, A), loc_pred (N, A*4), anchor (1, A, 4)
    -> (N, A, 6) rows ``[class, score, x1, y1, x2, y2]`` in descending
    score order, class -1 for the rows dropped."""
    with torch.no_grad():
        cls_prob, loc_pred = cls_prob.detach(), loc_pred.detach()
        anchors = anchor.detach().reshape(-1, 4)
        n, _, num_anchors = cls_prob.shape
        boxes = _decode_boxes(anchors, loc_pred.reshape(n, -1, 4),
                              attrs["variances"], attrs["clip"])
        bg = attrs["background_id"]
        fg = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], dim=1)
        cls_id = torch.argmax(fg, dim=1)                     # (N, A)
        score = torch.amax(fg, dim=1)
        valid = score > attrs["threshold"]
        score = torch.where(valid, score, 0.0)
        if attrs["nms_topk"] > 0:
            top = _rank(_stable_order(-score)) < attrs["nms_topk"]
            score = torch.where(top, score, 0.0)
            valid = valid & top
        cls_out = torch.where(valid, cls_id.to(score.dtype), -1.0)
        keep = _nms_keep(boxes, score, cls_id, attrs["nms_threshold"],
                         attrs["force_suppress"],
                         _nms_candidates(attrs, num_anchors))
        score = torch.where(keep, score, 0.0)
        cls_out = torch.where(keep, cls_out, -1.0)
        out = torch.cat([cls_out[..., None], score[..., None], boxes],
                        dim=2)
        return _gather_rows(out, _stable_order(-score))


def _multibox_detection_infer(attrs, in_shapes):
    cls_s = in_shapes[0]
    if cls_s is None:
        return in_shapes, [None], []
    return in_shapes, [(cls_s[0], cls_s[2], 6)], []


register("_contrib_MultiBoxDetection", fcompute=_multibox_detection_fc,
         arguments=("cls_prob", "loc_pred", "anchor"),
         attrs={"clip": Bool(True), "threshold": Float(0.01),
                "background_id": Int(0), "nms_threshold": Float(0.5),
                "force_suppress": Bool(False),
                "variances": FloatTuple((0.1, 0.1, 0.2, 0.2)),
                "nms_topk": Int(-1)},
         infer_shape=_multibox_detection_infer,
         doc="SSD detections (N, A, 6): decoded boxes, the best "
             "foreground class and its score, greedy NMS, sorted by "
             "score.")
register_alias("_contrib_MultiBoxDetection", "MultiBoxDetection")

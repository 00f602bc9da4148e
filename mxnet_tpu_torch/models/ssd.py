"""SSD-VGG16 single-shot detector (counterpart of
``mxnet_tpu/models/ssd.py``: the same graph and layer names, over the
port's ``symbol``).  ``get_symbol_train`` gives the training group
``[cls_prob, loc_loss, cls_label, det_out]`` (MultiBoxTarget, the
softmax class loss over the anchors not ignored, the smooth-L1 box
loss, and MultiBoxDetection behind ``BlockGrad``); ``get_symbol`` the
inference symbol, MultiBoxDetection over ``SoftmaxActivation``.  The
ops are in ``ops/contrib.py``.  At 300 x 300 the six scales give 8732
anchors."""
from __future__ import annotations

import json

from .. import symbol as sym

__all__ = ["get_symbol", "get_symbol_train"]


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1),
              stride=(1, 1), dilate=(1, 1)):
    c = sym.Convolution(data=data, kernel=kernel, pad=pad, stride=stride,
                        dilate=dilate, num_filter=num_filter,
                        name="conv%s" % name)
    return sym.Activation(data=c, act_type="relu", name="relu%s" % name)


def _vgg16_reduced(data):
    """VGG16 through relu4_3 and relu7 (dilated fc6/fc7 as convs,
    reference legacy_vgg16_ssd_300.py body)."""
    x = _conv_act(data, "1_1", 64)
    x = _conv_act(x, "1_2", 64)
    x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    name="pool1")
    x = _conv_act(x, "2_1", 128)
    x = _conv_act(x, "2_2", 128)
    x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    name="pool2")
    x = _conv_act(x, "3_1", 256)
    x = _conv_act(x, "3_2", 256)
    x = _conv_act(x, "3_3", 256)
    x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    pooling_convention="full", name="pool3")
    x = _conv_act(x, "4_1", 512)
    x = _conv_act(x, "4_2", 512)
    relu4_3 = _conv_act(x, "4_3", 512)
    x = sym.Pooling(relu4_3, pool_type="max", kernel=(2, 2), stride=(2, 2),
                    name="pool4")
    x = _conv_act(x, "5_1", 512)
    x = _conv_act(x, "5_2", 512)
    x = _conv_act(x, "5_3", 512)
    x = sym.Pooling(x, pool_type="max", kernel=(3, 3), stride=(1, 1),
                    pad=(1, 1), name="pool5")
    x = _conv_act(x, "_fc6", 1024, kernel=(3, 3), pad=(6, 6),
                  dilate=(6, 6))
    relu7 = _conv_act(x, "_fc7", 1024, kernel=(1, 1), pad=(0, 0))
    return relu4_3, relu7


def _extra_layers(relu7):
    """conv6-conv9 feature pyramid (reference common.py add_extras)."""
    x = _conv_act(relu7, "6_1", 256, kernel=(1, 1), pad=(0, 0))
    conv6_2 = _conv_act(x, "6_2", 512, stride=(2, 2))
    x = _conv_act(conv6_2, "7_1", 128, kernel=(1, 1), pad=(0, 0))
    conv7_2 = _conv_act(x, "7_2", 256, stride=(2, 2))
    x = _conv_act(conv7_2, "8_1", 128, kernel=(1, 1), pad=(0, 0))
    conv8_2 = _conv_act(x, "8_2", 256, pad=(0, 0))
    x = _conv_act(conv8_2, "9_1", 128, kernel=(1, 1), pad=(0, 0))
    conv9_2 = _conv_act(x, "9_2", 256, pad=(0, 0))
    return conv6_2, conv7_2, conv8_2, conv9_2


# per-scale anchor config (reference legacy_vgg16_ssd_300.py)
_SIZES = [[.1, .141], [.2, .272], [.37, .447], [.54, .619],
          [.71, .79], [.88, .961]]
_RATIOS = [[1, 2, .5], [1, 2, .5, 3, 1. / 3], [1, 2, .5, 3, 1. / 3],
           [1, 2, .5, 3, 1. / 3], [1, 2, .5], [1, 2, .5]]
_NORMALIZATION = [20, -1, -1, -1, -1, -1]


def _multibox_layer(from_layers, num_classes, sizes, ratios, normalization):
    """Per-scale loc/cls heads + anchors, flattened and concatenated
    (reference common.py multibox_layer)."""
    loc_layers, cls_layers, anchor_layers = [], [], []
    num_classes += 1  # background
    for k, from_layer in enumerate(from_layers):
        if normalization[k] > 0:
            from_layer = sym.L2Normalization(
                data=from_layer, mode="channel",
                name="%d_norm" % k)
            scale = sym.Variable(
                "%d_scale" % k, shape=(1, 512, 1, 1),
                attr={"__wd_mult__": "0.1",
                      "__init__": json.dumps(
                          ["constant", {"value": float(normalization[k])}])})
            from_layer = sym.broadcast_mul(lhs=scale, rhs=from_layer)
        num_anchors = len(sizes[k]) + len(ratios[k]) - 1

        loc = sym.Convolution(data=from_layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * 4,
                              name="loc_pred%d_conv" % k)
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_layers.append(sym.Flatten(data=loc))

        cls = sym.Convolution(data=from_layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * num_classes,
                              name="cls_pred%d_conv" % k)
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_layers.append(sym.Flatten(data=cls))

        anchors = sym.MultiBoxPrior(
            from_layer, sizes=tuple(sizes[k]), ratios=tuple(ratios[k]),
            clip=False, name="anchors%d" % k)
        anchor_layers.append(sym.Flatten(data=anchors))

    loc_preds = sym.Concat(*loc_layers, num_args=len(loc_layers), dim=1,
                           name="multibox_loc_pred")
    cls_preds = sym.Concat(*cls_layers, num_args=len(cls_layers), dim=1)
    cls_preds = sym.Reshape(data=cls_preds, shape=(0, -1, num_classes))
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1),
                              name="multibox_cls_pred")
    anchor_boxes = sym.Concat(*anchor_layers, num_args=len(anchor_layers),
                              dim=1)
    anchor_boxes = sym.Reshape(data=anchor_boxes, shape=(0, -1, 4),
                               name="multibox_anchors")
    return loc_preds, cls_preds, anchor_boxes


def _heads(num_classes):
    data = sym.Variable("data")
    relu4_3, relu7 = _vgg16_reduced(data)
    conv6_2, conv7_2, conv8_2, conv9_2 = _extra_layers(relu7)
    layers = [relu4_3, relu7, conv6_2, conv7_2, conv8_2, conv9_2]
    return _multibox_layer(layers, num_classes, _SIZES, _RATIOS,
                           _NORMALIZATION)


def get_symbol_train(num_classes=20, nms_thresh=0.5, force_suppress=False,
                     nms_topk=400, **kwargs):
    """Training symbol: MultiBoxTarget + softmax cls loss + smooth-L1 loc
    loss (reference symbol_builder.get_symbol_train)."""
    loc_preds, cls_preds, anchor_boxes = _heads(num_classes)
    label = sym.Variable("label")

    tmp = sym.MultiBoxTarget(
        anchor_boxes, label, cls_preds, overlap_threshold=.5,
        ignore_label=-1, negative_mining_ratio=3,
        minimum_negative_samples=0, negative_mining_thresh=.5,
        variances=(0.1, 0.1, 0.2, 0.2), name="multibox_target")
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]

    cls_prob = sym.SoftmaxOutput(data=cls_preds, label=cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 grad_scale=1.0, multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_diff = loc_target_mask * (loc_preds - loc_target)
    loc_loss_ = sym.smooth_l1(data=loc_diff, scalar=1.0,
                              name="loc_loss_")
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1.0,
                            normalization="valid", name="loc_loss")

    cls_label = sym.BlockGrad(cls_target, name="cls_label")
    det = sym.MultiBoxDetection(
        cls_prob, loc_preds, anchor_boxes, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)
    det = sym.BlockGrad(det, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=False,
               nms_topk=400, **kwargs):
    """Inference symbol: softmax + MultiBoxDetection
    (reference symbol_builder.get_symbol)."""
    loc_preds, cls_preds, anchor_boxes = _heads(num_classes)
    cls_prob = sym.SoftmaxActivation(data=cls_preds, mode="channel",
                                     name="cls_prob")
    out = sym.MultiBoxDetection(
        cls_prob, loc_preds, anchor_boxes, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk)
    return out

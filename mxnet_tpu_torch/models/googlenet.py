"""GoogLeNet (Inception v1, "Going Deeper with Convolutions";
counterpart of ``mxnet_tpu/models/googlenet.py``: the same graph and
layer names, over the port's ``symbol``).  The stem and the nine
inception modules are data, one builder walks them.
"""
from .. import symbol as sym

# (1x1, 3x3reduce, 3x3, 5x5reduce, 5x5, pool-proj) per inception module;
# "pool" rows insert a stride-2 max pool between stages
_STAGES = (
    ("in3a", (64, 96, 128, 16, 32, 32)),
    ("in3b", (128, 128, 192, 32, 96, 64)),
    "pool",
    ("in4a", (192, 96, 208, 16, 48, 64)),
    ("in4b", (160, 112, 224, 24, 64, 64)),
    ("in4c", (128, 128, 256, 24, 64, 64)),
    ("in4d", (112, 144, 288, 32, 64, 64)),
    ("in4e", (256, 160, 320, 32, 128, 128)),
    "pool",
    ("in5a", (256, 160, 320, 32, 128, 128)),
    ("in5b", (384, 192, 384, 48, 128, 128)),
)


def _relu_conv(x, filters, kernel, name, suffix="", stride=(1, 1),
               pad=(0, 0)):
    """conv+relu with the reference naming scheme (no BN in v1)."""
    x = sym.Convolution(x, num_filter=filters, kernel=kernel,
                        stride=stride, pad=pad,
                        name="conv_%s%s" % (name, suffix))
    return sym.Activation(x, act_type="relu",
                          name="relu_%s%s" % (name, suffix))


def _inception(x, name, spec):
    n1, n3r, n3, n5r, n5, nproj = spec
    branches = [
        _relu_conv(x, n1, (1, 1), "%s_1x1" % name),
        _relu_conv(_relu_conv(x, n3r, (1, 1), "%s_3x3" % name,
                              suffix="_reduce"),
                   n3, (3, 3), "%s_3x3" % name, pad=(1, 1)),
        _relu_conv(_relu_conv(x, n5r, (1, 1), "%s_5x5" % name,
                              suffix="_reduce"),
                   n5, (5, 5), "%s_5x5" % name, pad=(2, 2)),
        _relu_conv(sym.Pooling(x, kernel=(3, 3), stride=(1, 1),
                               pad=(1, 1), pool_type="max",
                               name="max_pool_%s_pool" % name),
                   nproj, (1, 1), "%s_proj" % name),
    ]
    return sym.Concat(*branches, name="ch_concat_%s_chconcat" % name)


def get_symbol(num_classes=1000, **kwargs):
    x = sym.Variable("data")
    # stem: 7x7/2 -> pool -> 1x1 -> 3x3 -> pool
    x = _relu_conv(x, 64, (7, 7), "conv1", stride=(2, 2), pad=(3, 3))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _relu_conv(x, 64, (1, 1), "conv2")
    x = _relu_conv(x, 192, (3, 3), "conv3", pad=(1, 1))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")

    for entry in _STAGES:
        if entry == "pool":
            x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                            pool_type="max")
        else:
            x = _inception(x, entry[0], entry[1])

    x = sym.Pooling(x, kernel=(7, 7), stride=(1, 1), global_pool=True,
                    pool_type="avg")
    x = sym.FullyConnected(sym.Flatten(x), num_hidden=num_classes,
                           name="fc1")
    return sym.SoftmaxOutput(x, name="softmax")

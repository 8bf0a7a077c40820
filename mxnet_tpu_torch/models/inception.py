"""Inception-BN model family (reference example/image-classification/
symbol_inception-bn.py and symbol_inception-bn-28-small.py).

These are the reference's published-baseline workloads: CIFAR-10
"inception-bn-28-small" is the 1/2/4-GPU img/sec table and ImageNet
Inception-BN the epoch-time table (SURVEY.md §6).  Table-driven rebuild:
one mixed-block builder consumes per-stage branch configs instead of
per-block factory calls; supports NHWC layout.  The port's copy of
``mxnet_tpu/models/inception.py`` (the same Symbols, byte for byte).
"""

from .. import symbol as mx_sym

_EPS = 1e-10 + 1e-5
_BN_MOM = 0.9


def _conv_bn(data, num_filter, kernel, name, stride=(1, 1), pad=(0, 0),
             layout="NCHW"):
    bn_axis = -1 if layout == "NHWC" else 1
    x = mx_sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, layout=layout,
                           name=f"conv_{name}")
    x = mx_sym.BatchNorm(x, fix_gamma=False, eps=_EPS, momentum=_BN_MOM,
                         axis=bn_axis, name=f"bn_{name}")
    return mx_sym.Activation(x, act_type="relu", name=f"relu_{name}")


def _mixed(data, name, branches, layout="NCHW"):
    """One inception block.  ``branches`` is a list of branch specs:
    - ("conv", [(filters, kernel, stride, pad), ...])   chain of conv-bn
    - ("pool", pool_type, stride, proj_filters_or_None) pool (+ 1x1 proj)
    Branch outputs concat on the channel axis."""
    concat_axis = -1 if layout == "NHWC" else 1
    outs = []
    for bi, spec in enumerate(branches):
        if spec[0] == "conv":
            x = data
            for ci, (nf, k, s, p) in enumerate(spec[1]):
                x = _conv_bn(x, nf, k, f"{name}_b{bi}_{ci}", stride=s, pad=p,
                             layout=layout)
            outs.append(x)
        else:
            _, pool_type, stride, proj = spec
            x = mx_sym.Pooling(data, kernel=(3, 3), stride=stride, pad=(1, 1),
                               pool_type=pool_type, layout=layout,
                               name=f"pool_{name}_b{bi}")
            if proj is not None:
                x = _conv_bn(x, proj, (1, 1), f"{name}_b{bi}_proj",
                             layout=layout)
            outs.append(x)
    return mx_sym.Concat(*outs, num_args=len(outs), dim=concat_axis,
                         name=f"concat_{name}")


def _stage_a(n1, nr3, n3, nrd3, nd3, pool, proj):
    """Reference InceptionFactoryA branch table."""
    return [
        ("conv", [(n1, (1, 1), (1, 1), (0, 0))]),
        ("conv", [(nr3, (1, 1), (1, 1), (0, 0)),
                  (n3, (3, 3), (1, 1), (1, 1))]),
        ("conv", [(nrd3, (1, 1), (1, 1), (0, 0)),
                  (nd3, (3, 3), (1, 1), (1, 1)),
                  (nd3, (3, 3), (1, 1), (1, 1))]),
        ("pool", pool, (1, 1), proj),
    ]


def _stage_b(nr3, n3, nrd3, nd3):
    """Reference InceptionFactoryB (stride-2 grid reduction)."""
    return [
        ("conv", [(nr3, (1, 1), (1, 1), (0, 0)),
                  (n3, (3, 3), (2, 2), (1, 1))]),
        ("conv", [(nrd3, (1, 1), (1, 1), (0, 0)),
                  (nd3, (3, 3), (1, 1), (1, 1)),
                  (nd3, (3, 3), (2, 2), (1, 1))]),
        ("pool", "max", (2, 2), None),
    ]


# the reference get_symbol() block sequence, as data
_IMAGENET_BLOCKS = [
    ("3a", _stage_a(64, 64, 64, 64, 96, "avg", 32)),
    ("3b", _stage_a(64, 64, 96, 64, 96, "avg", 64)),
    ("3c", _stage_b(128, 160, 64, 96)),
    ("4a", _stage_a(224, 64, 96, 96, 128, "avg", 128)),
    ("4b", _stage_a(192, 96, 128, 96, 128, "avg", 128)),
    ("4c", _stage_a(160, 128, 160, 128, 160, "avg", 128)),
    ("4d", _stage_a(96, 128, 192, 160, 192, "avg", 128)),
    ("4e", _stage_b(128, 192, 192, 256)),
    ("5a", _stage_a(352, 192, 320, 160, 224, "avg", 128)),
    ("5b", _stage_a(352, 192, 320, 192, 224, "max", 128)),
]


def inception_bn(num_classes=1000, layout="NCHW"):
    """Inception-BN for ~224x224 inputs (symbol_inception-bn.py)."""
    data = mx_sym.Variable("data")
    x = _conv_bn(data, 64, (7, 7), "1", stride=(2, 2), pad=(3, 3),
                 layout=layout)
    x = mx_sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                       layout=layout, name="pool_1")
    x = _conv_bn(x, 64, (1, 1), "2_red", layout=layout)
    x = _conv_bn(x, 192, (3, 3), "2", pad=(1, 1), layout=layout)
    x = mx_sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                       layout=layout, name="pool_2")
    for name, branches in _IMAGENET_BLOCKS:
        x = _mixed(x, name, branches, layout=layout)
    x = mx_sym.Pooling(x, kernel=(7, 7), stride=(1, 1), pool_type="avg",
                       layout=layout, name="global_pool")
    x = mx_sym.Flatten(x, name="flatten")
    x = mx_sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return mx_sym.SoftmaxOutput(x, name="softmax")


# (1x1 filters, 3x3 filters) per simple block; None = downsample block
_SMALL_BLOCKS = [
    ("3a", (32, 32)), ("3b", (32, 48)), ("3c", (None, 80)),
    ("4a", (112, 48)), ("4b", (96, 64)), ("4c", (80, 80)),
    ("4d", (48, 96)), ("4e", (None, 96)),
    ("5a", (176, 160)), ("5b", (176, 160)),
]


def _conv_relu(data, num_filter, kernel, name, stride=(1, 1), pad=(0, 0),
               layout="NCHW"):
    """Conv + ReLU without BN (GoogLeNet v1 blocks)."""
    x = mx_sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, layout=layout,
                           name=f"conv_{name}")
    return mx_sym.Activation(x, act_type="relu", name=f"relu_{name}")


# GoogLeNet block table: (1x1, 3x3red, 3x3, 5x5red, 5x5, proj) per block,
# None = stride-2 max pool (symbol_googlenet.py get_symbol sequence)
_GOOGLENET_BLOCKS = [
    ("in3a", (64, 96, 128, 16, 32, 32)),
    ("in3b", (128, 128, 192, 32, 96, 64)),
    ("pool4", None),
    ("in4a", (192, 96, 208, 16, 48, 64)),
    ("in4b", (160, 112, 224, 24, 64, 64)),
    ("in4c", (128, 128, 256, 24, 64, 64)),
    ("in4d", (112, 144, 288, 32, 64, 64)),
    ("in4e", (256, 160, 320, 32, 128, 128)),
    ("pool5", None),
    ("in5a", (256, 160, 320, 32, 128, 128)),
    ("in5b", (384, 192, 384, 48, 128, 128)),
]


def googlenet(num_classes=1000, layout="NCHW"):
    """GoogLeNet / Inception v1 (symbol_googlenet.py): 1x1 + 3x3 + 5x5 +
    pool-proj branches, no batch norm."""
    concat_axis = -1 if layout == "NHWC" else 1
    x = mx_sym.Variable("data")
    x = _conv_relu(x, 64, (7, 7), "1", stride=(2, 2), pad=(3, 3),
                   layout=layout)
    x = mx_sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                       pooling_convention="full", layout=layout,
                       name="pool_1")
    x = _conv_relu(x, 64, (1, 1), "2", layout=layout)
    x = _conv_relu(x, 192, (3, 3), "3", pad=(1, 1), layout=layout)
    x = mx_sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                       pooling_convention="full", layout=layout,
                       name="pool_3")
    for name, cfg in _GOOGLENET_BLOCKS:
        if cfg is None:
            # legacy mshadow ceil convention keeps the reference's 7x7
            # map at the head (112->56->28->14->7)
            x = mx_sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                               pool_type="max", pooling_convention="full",
                               layout=layout, name=name)
            continue
        n1, nr3, n3, nr5, n5, proj = cfg
        b1 = _conv_relu(x, n1, (1, 1), f"{name}_1x1", layout=layout)
        b3 = _conv_relu(x, nr3, (1, 1), f"{name}_3x3r", layout=layout)
        b3 = _conv_relu(b3, n3, (3, 3), f"{name}_3x3", pad=(1, 1),
                        layout=layout)
        b5 = _conv_relu(x, nr5, (1, 1), f"{name}_5x5r", layout=layout)
        b5 = _conv_relu(b5, n5, (5, 5), f"{name}_5x5", pad=(2, 2),
                        layout=layout)
        bp = mx_sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                            pool_type="max", layout=layout,
                            name=f"pool_{name}")
        bp = _conv_relu(bp, proj, (1, 1), f"{name}_proj", layout=layout)
        x = mx_sym.Concat(b1, b3, b5, bp, num_args=4, dim=concat_axis,
                          name=f"concat_{name}")
    x = mx_sym.Pooling(x, kernel=(7, 7), stride=(1, 1), pool_type="avg",
                       global_pool=True, layout=layout, name="global_pool")
    x = mx_sym.Flatten(x, name="flatten")
    x = mx_sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return mx_sym.SoftmaxOutput(x, name="softmax")


def inception_bn_small(num_classes=10, layout="NCHW", force_mirroring=False):
    """The CIFAR-10 "28-small" variant (the multi-GPU img/sec baseline,
    symbol_inception-bn-28-small.py); ``force_mirroring`` tags every
    activation for gradient-checkpoint recompute like the reference's
    mirror_attr."""
    from ..attribute import AttrScope

    concat_axis = -1 if layout == "NHWC" else 1
    scope = (AttrScope(force_mirroring="true") if force_mirroring
             else AttrScope())
    with scope:
        data = mx_sym.Variable("data")
        x = _conv_bn(data, 96, (3, 3), "1", pad=(1, 1), layout=layout)
        for name, (n1, n3) in _SMALL_BLOCKS:
            if n1 is None:   # downsample: stride-2 conv branch ++ max pool
                conv = _conv_bn(x, n3, (3, 3), f"{name}_ds", stride=(2, 2),
                                pad=(1, 1), layout=layout)
                pool = mx_sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), pool_type="max",
                                      layout=layout, name=f"pool_{name}")
                x = mx_sym.Concat(conv, pool, num_args=2, dim=concat_axis,
                                  name=f"concat_{name}")
            else:            # simple: 1x1 branch ++ 3x3 branch
                a = _conv_bn(x, n1, (1, 1), f"{name}_1x1", layout=layout)
                b = _conv_bn(x, n3, (3, 3), f"{name}_3x3", pad=(1, 1),
                             layout=layout)
                x = mx_sym.Concat(a, b, num_args=2, dim=concat_axis,
                                  name=f"concat_{name}")
        x = mx_sym.Pooling(x, kernel=(7, 7), pool_type="avg", layout=layout,
                           name="global_pool")
        x = mx_sym.Flatten(x, name="flatten1")
        x = mx_sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
        return mx_sym.SoftmaxOutput(x, name="softmax")

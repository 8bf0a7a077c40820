"""VGG and AlexNet (reference example/image-classification/symbol_vgg.py,
symbol_alexnet.py) — the ImageNet epoch-time baseline models
(SURVEY.md §6: VGG bs=96/384 epoch table).

Config-table rebuild: the VGG conv trunk is a per-stage filter list
(11/13/16/19-layer variants) instead of unrolled symbol code; NHWC
layout supported.  The port's copy of ``mxnet_tpu/models/vgg.py`` (the
same Symbols, byte for byte).
"""

from .. import symbol as mx_sym

# convs per stage for each named depth; reference symbol_vgg.py is the
# 11-layer table
_VGG_CFG = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


def vgg(num_classes=1000, num_layers=11, batch_norm=False, layout="NCHW"):
    """VGG-style network; ``num_layers`` in {11, 13, 16, 19}."""
    if num_layers not in _VGG_CFG:
        raise ValueError(f"vgg: unsupported depth {num_layers}")
    counts, filters = _VGG_CFG[num_layers]
    bn_axis = -1 if layout == "NHWC" else 1

    x = mx_sym.Variable("data")
    for stage, (reps, nf) in enumerate(zip(counts, filters), start=1):
        for i in range(1, reps + 1):
            x = mx_sym.Convolution(x, kernel=(3, 3), pad=(1, 1),
                                   num_filter=nf, layout=layout,
                                   name=f"conv{stage}_{i}")
            if batch_norm:
                x = mx_sym.BatchNorm(x, fix_gamma=False, axis=bn_axis,
                                     name=f"bn{stage}_{i}")
            x = mx_sym.Activation(x, act_type="relu",
                                  name=f"relu{stage}_{i}")
        x = mx_sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                           layout=layout, name=f"pool{stage}")

    x = mx_sym.Flatten(x, name="flatten")
    for i, fc_name in enumerate(("fc6", "fc7")):
        x = mx_sym.FullyConnected(x, num_hidden=4096, name=fc_name)
        x = mx_sym.Activation(x, act_type="relu", name=f"relu{6 + i}")
        x = mx_sym.Dropout(x, p=0.5, name=f"drop{6 + i}")
    x = mx_sym.FullyConnected(x, num_hidden=num_classes, name="fc8")
    return mx_sym.SoftmaxOutput(x, name="softmax")


def alexnet(num_classes=1000, layout="NCHW"):
    """AlexNet (symbol_alexnet.py): 5-conv trunk with LRN after the
    first two pools, 4096-wide classifier head."""
    x = mx_sym.Variable("data")
    trunk = [
        # (filters, kernel, stride, pad, pool?, lrn?)
        (96, (11, 11), (4, 4), (0, 0), True, True),
        (256, (5, 5), (1, 1), (2, 2), True, True),
        (384, (3, 3), (1, 1), (1, 1), False, False),
        (384, (3, 3), (1, 1), (1, 1), False, False),
        (256, (3, 3), (1, 1), (1, 1), True, False),
    ]
    for i, (nf, k, s, p, pool, lrn) in enumerate(trunk, start=1):
        x = mx_sym.Convolution(x, kernel=k, stride=s, pad=p, num_filter=nf,
                               layout=layout, name=f"conv{i}")
        x = mx_sym.Activation(x, act_type="relu", name=f"relu{i}")
        if pool:
            x = mx_sym.Pooling(x, kernel=(3, 3), stride=(2, 2),
                               pool_type="max", layout=layout,
                               name=f"pool{i}")
        if lrn:
            x = mx_sym.LRN(x, alpha=0.0001, beta=0.75, knorm=1, nsize=5,
                           name=f"norm{i}")
    x = mx_sym.Flatten(x, name="flatten")
    for i in (1, 2):
        x = mx_sym.FullyConnected(x, num_hidden=4096, name=f"fc{i}")
        x = mx_sym.Activation(x, act_type="relu", name=f"fcrelu{i}")
        x = mx_sym.Dropout(x, p=0.5, name=f"fcdrop{i}")
    x = mx_sym.FullyConnected(x, num_hidden=num_classes, name="fc3")
    return mx_sym.SoftmaxOutput(x, name="softmax")

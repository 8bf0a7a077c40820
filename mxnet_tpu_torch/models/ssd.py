"""SSD object detector (reference example/ssd/symbol/symbol_vgg16_reduced.py
+ example/ssd/symbol/common.py multibox head, using the MultiBox ops).

The port of ``mxnet_tpu/models/ssd.py``: the same ``get_symbol`` over the
port's Symbol ops, so both packages emit byte-equal JSON.

``get_symbol(..., mode="train")`` emits the training graph (multibox
target matching + softmax cls loss + smooth-L1 loc loss); ``mode="det"``
emits the detection graph (decode + NMS).
"""

from __future__ import annotations

from .. import symbol as mx_sym


def _conv_act(data, name, num_filter, kernel=(3, 3), pad=(1, 1), stride=(1, 1)):
    c = mx_sym.Convolution(data, kernel=kernel, pad=pad, stride=stride,
                           num_filter=num_filter, name=f"conv{name}")
    return mx_sym.Activation(c, act_type="relu", name=f"relu{name}")


def vgg16_reduced(data, fs=1):
    """VGG16 with reduced fc6/fc7 as dilated convs (symbol_vgg16_reduced.py).

    ``fs`` divides all channel widths (testing knob; 1 = reference arch).
    Returns (relu4_3, relu7) feature maps."""
    x = data
    for i, (n_convs, nf) in enumerate([(2, 64), (2, 128), (3, 256)], 1):
        for j in range(n_convs):
            x = _conv_act(x, f"{i}_{j + 1}", nf // fs)
        x = mx_sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                           pooling_convention="full", name=f"pool{i}")
    for j in range(3):
        x = _conv_act(x, f"4_{j + 1}", 512 // fs)
    relu4_3 = x
    x = mx_sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                       pooling_convention="full", name="pool4")
    for j in range(3):
        x = _conv_act(x, f"5_{j + 1}", 512 // fs)
    x = mx_sym.Pooling(x, pool_type="max", kernel=(3, 3), stride=(1, 1),
                       pad=(1, 1), name="pool5")
    # fc6 as dilated conv, fc7 as 1x1 (the "reduced" trick)
    fc6 = mx_sym.Convolution(x, kernel=(3, 3), pad=(6, 6), dilate=(6, 6),
                             num_filter=1024 // fs, name="fc6")
    relu6 = mx_sym.Activation(fc6, act_type="relu", name="relu6")
    fc7 = mx_sym.Convolution(relu6, kernel=(1, 1), num_filter=1024 // fs, name="fc7")
    relu7 = mx_sym.Activation(fc7, act_type="relu", name="relu7")
    return relu4_3, relu7


def _extra_layers(relu7, fs=1):
    """Conv8-conv11 pyramid (example/ssd/symbol/common.py multi_layer_feature)."""
    layers = [relu7]
    x = relu7
    specs = [(256, 512, 2), (128, 256, 2), (128, 256, 1), (128, 256, 1)]
    for i, (nf1, nf2, stride) in enumerate(specs, 8):
        x = _conv_act(x, f"{i}_1", nf1 // fs, kernel=(1, 1), pad=(0, 0))
        pad = (1, 1) if stride == 2 else (0, 0)
        x = _conv_act(x, f"{i}_2", nf2 // fs, kernel=(3, 3), pad=pad,
                      stride=(stride, stride))
        layers.append(x)
    return layers


_SIZES = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
          (0.71, 0.79), (0.88, 0.961)]
_RATIOS = [(1.0, 2.0, 0.5)] * 2 + [(1.0, 2.0, 0.5, 3.0, 1.0 / 3)] * 3 + \
    [(1.0, 2.0, 0.5)]


def multibox_layer(from_layers, num_classes, sizes=None, ratios=None,
                   clip=True):
    """Per-scale loc/cls heads + anchors (common.py multibox_layer)."""
    sizes = sizes or _SIZES
    ratios = ratios or _RATIOS
    loc_layers, cls_layers, anchor_layers = [], [], []
    num_classes_b = num_classes + 1  # + background
    for i, layer in enumerate(from_layers):
        n_anchor = len(sizes[i]) + len(ratios[i]) - 1
        loc = mx_sym.Convolution(layer, kernel=(3, 3), pad=(1, 1),
                                 num_filter=n_anchor * 4,
                                 name=f"loc_pred_conv{i}")
        # (N, A*4, H, W) -> (N, H, W, A*4) -> flat
        loc = mx_sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_layers.append(mx_sym.Flatten(loc))
        cls = mx_sym.Convolution(layer, kernel=(3, 3), pad=(1, 1),
                                 num_filter=n_anchor * num_classes_b,
                                 name=f"cls_pred_conv{i}")
        cls = mx_sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_layers.append(mx_sym.Flatten(cls))
        anchors = mx_sym.MultiBoxPrior(layer, sizes=sizes[i], ratios=ratios[i],
                                       clip=clip, name=f"anchors{i}")
        anchor_layers.append(mx_sym.Reshape(anchors, shape=(-1, 4)))
    loc_preds = mx_sym.Concat(*loc_layers, num_args=len(loc_layers), dim=1,
                              name="multibox_loc_pred")
    cls_concat = mx_sym.Concat(*cls_layers, num_args=len(cls_layers), dim=1)
    cls_preds = mx_sym.Reshape(cls_concat, shape=(0, -1, num_classes_b))
    cls_preds = mx_sym.transpose(cls_preds, axes=(0, 2, 1),
                                 name="multibox_cls_pred")
    anchors_c = mx_sym.Concat(*anchor_layers, num_args=len(anchor_layers),
                              dim=0)
    anchor_boxes = mx_sym.Reshape(anchors_c, shape=(1, -1, 4),
                                  name="multibox_anchors")
    return loc_preds, cls_preds, anchor_boxes


def get_symbol(num_classes=20, mode="train", nms_thresh=0.5, nms_topk=400,
               filter_scale=1, **kwargs):
    fs = filter_scale
    data = mx_sym.Variable("data")
    relu4_3, relu7 = vgg16_reduced(data, fs)
    # L2-normalize conv4_3 feature like the reference, with learned scale
    norm4_3 = mx_sym.L2Normalization(relu4_3, mode="channel",
                                     name="relu4_3_norm")
    scale_var = mx_sym.Variable("relu4_3_scale", shape=(1, 512 // fs, 1, 1))
    norm4_3 = mx_sym.broadcast_mul(norm4_3, scale_var)
    layers = [norm4_3] + _extra_layers(relu7, fs)
    loc_preds, cls_preds, anchors = multibox_layer(layers, num_classes)

    if mode == "det":
        cls_prob = mx_sym.SoftmaxActivation(cls_preds, mode="channel",
                                            name="cls_prob")
        return mx_sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                        nms_threshold=nms_thresh, clip=True,
                                        nms_topk=nms_topk, name="detection")

    label = mx_sym.Variable("label")
    tgt = mx_sym.MultiBoxTarget(anchors, label, cls_preds,
                                overlap_threshold=0.5,
                                ignore_label=-1, negative_mining_ratio=3.0,
                                minimum_negative_samples=0,
                                negative_mining_thresh=0.5,
                                name="multibox_target")
    loc_target, loc_target_mask, cls_target = tgt[0], tgt[1], tgt[2]
    cls_prob = mx_sym.SoftmaxOutput(cls_preds, cls_target,
                                    ignore_label=-1, use_ignore=True,
                                    multi_output=True,
                                    normalization="valid", name="cls_prob")
    loc_diff = loc_preds - loc_target
    masked_loc = loc_target_mask * loc_diff
    loc_loss_ = mx_sym.smooth_l1(masked_loc, sigma=1.0, name="loc_loss_")
    loc_loss = mx_sym.MakeLoss(loc_loss_, grad_scale=1.0,
                               normalization="valid", name="loc_loss")
    # monitoring outputs (blocked grads), same as reference train symbol
    cls_label = mx_sym.MakeLoss(cls_target, grad_scale=0, name="cls_label")
    return mx_sym.Group([cls_prob, loc_loss, cls_label])

"""ResNet (reference example/image-classification/symbol_resnet.py,
generalized to the standard depth configs used by train_imagenet.py).

The port's copy of ``mxnet_tpu/models/resnet.py``: the same Symbol, node
for node (its JSON is the reference's byte for byte).  ResNet-50 on
ImageNet is the image-classification workload of ``bench.py`` and
``examples/train_imagenet.py``.  BatchNorm uses fix_gamma=False like the
reference resnet symbol; blocks are the bottleneck variant for depth >= 50.
"""

from .. import symbol as mx_sym


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True,
                  bn_mom=0.9, workspace=512, layout="NCHW"):
    bn_axis = -1 if layout == "NHWC" else 1
    if bottle_neck:
        bn1 = mx_sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                               axis=bn_axis, name=name + "_bn1")
        act1 = mx_sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = mx_sym.Convolution(act1, layout=layout, num_filter=num_filter // 4,
                                   kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                   no_bias=True, workspace=workspace,
                                   name=name + "_conv1")
        bn2 = mx_sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                               momentum=bn_mom, axis=bn_axis, name=name + "_bn2")
        act2 = mx_sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = mx_sym.Convolution(act2, layout=layout, num_filter=num_filter // 4,
                                   kernel=(3, 3), stride=stride, pad=(1, 1),
                                   no_bias=True, workspace=workspace,
                                   name=name + "_conv2")
        bn3 = mx_sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5,
                               momentum=bn_mom, axis=bn_axis, name=name + "_bn3")
        act3 = mx_sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = mx_sym.Convolution(act3, layout=layout, num_filter=num_filter, kernel=(1, 1),
                                   stride=(1, 1), pad=(0, 0), no_bias=True,
                                   workspace=workspace, name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = mx_sym.Convolution(act1, layout=layout, num_filter=num_filter,
                                          kernel=(1, 1), stride=stride,
                                          no_bias=True, workspace=workspace,
                                          name=name + "_sc")
        return conv3 + shortcut
    bn1 = mx_sym.BatchNorm(data, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                           axis=bn_axis, name=name + "_bn1")
    act1 = mx_sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = mx_sym.Convolution(act1, layout=layout, num_filter=num_filter, kernel=(3, 3),
                               stride=stride, pad=(1, 1), no_bias=True,
                               workspace=workspace, name=name + "_conv1")
    bn2 = mx_sym.BatchNorm(conv1, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                           axis=bn_axis, name=name + "_bn2")
    act2 = mx_sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = mx_sym.Convolution(act2, layout=layout, num_filter=num_filter, kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True,
                               workspace=workspace, name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = mx_sym.Convolution(act1, layout=layout, num_filter=num_filter, kernel=(1, 1),
                                      stride=stride, no_bias=True,
                                      workspace=workspace, name=name + "_sc")
    return conv2 + shortcut


def resnet(units, num_stage, filter_list, num_class, bottle_neck=True,
           bn_mom=0.9, workspace=512, small_input=False, layout="NCHW",
           stem="conv7"):
    bn_axis = -1 if layout == "NHWC" else 1
    data = mx_sym.Variable("data")
    data = mx_sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                            axis=bn_axis, name="bn_data")
    if small_input and stem != "conv7":
        raise ValueError(
            f"stem={stem!r} conflicts with small_input: the cifar-style "
            "3x3 stem takes raw HxWxC images, not s2d-transformed input")
    if small_input:  # cifar-style stem
        body = mx_sym.Convolution(data, layout=layout, num_filter=filter_list[0],
                                  kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                  no_bias=True, name="conv0",
                                  workspace=workspace)
    elif stem == "s2d":
        # Space-to-depth stem: the caller feeds data already
        # transformed to (N, H/2, W/2, 4C) NHWC, and the 7x7/s2 conv
        # becomes a dense 4x4/s1 conv over 12 input channels instead of
        # 3, with no strided backward pass.  Receptive field
        # matches the 7x7 (8x8 zero-padded) conv; train-from-scratch
        # equivalent, not checkpoint-compatible with stem="conv7".
        if layout != "NHWC":
            raise ValueError("s2d stem requires NHWC layout")
        body = mx_sym.Pad(data, mode="constant",
                          pad_width=(0, 0, 2, 1, 2, 1, 0, 0))
        body = mx_sym.Convolution(body, layout=layout,
                                  num_filter=filter_list[0],
                                  kernel=(4, 4), stride=(1, 1), pad=(0, 0),
                                  no_bias=True, name="conv0",
                                  workspace=workspace)
        body = mx_sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                                momentum=bn_mom, axis=bn_axis, name="bn0")
        body = mx_sym.Activation(body, act_type="relu", name="relu0")
        body = mx_sym.Pooling(body, layout=layout, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                              pool_type="max")
    else:  # imagenet stem
        body = mx_sym.Convolution(data, layout=layout, num_filter=filter_list[0],
                                  kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                                  no_bias=True, name="conv0",
                                  workspace=workspace)
        body = mx_sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                                momentum=bn_mom, axis=bn_axis, name="bn0")
        body = mx_sym.Activation(body, act_type="relu", name="relu0")
        body = mx_sym.Pooling(body, layout=layout, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                              pool_type="max")
    for i in range(num_stage):
        body = residual_unit(body, filter_list[i + 1],
                             (1 if i == 0 else 2, 1 if i == 0 else 2), False,
                             name=f"stage{i + 1}_unit1",
                             bottle_neck=bottle_neck, bn_mom=bn_mom,
                             workspace=workspace, layout=layout)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name=f"stage{i + 1}_unit{j + 2}",
                                 bottle_neck=bottle_neck, bn_mom=bn_mom,
                                 workspace=workspace, layout=layout)
    bn1 = mx_sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                           axis=bn_axis, name="bn1")
    relu1 = mx_sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = mx_sym.Pooling(relu1, layout=layout, global_pool=True, kernel=(7, 7),
                           pool_type="avg", name="pool1")
    flat = mx_sym.Flatten(pool1)
    fc1 = mx_sym.FullyConnected(flat, num_hidden=num_class, name="fc1")
    return mx_sym.SoftmaxOutput(fc1, name="softmax")


_DEPTH_CONFIGS = {
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               workspace=512, layout="NCHW", stem="conv7"):
    if num_layers not in _DEPTH_CONFIGS:
        raise ValueError(f"unsupported depth {num_layers}")
    units, bottle_neck = _DEPTH_CONFIGS[num_layers]
    if bottle_neck:
        filter_list = [64, 256, 512, 1024, 2048]
    else:
        filter_list = [64, 64, 128, 256, 512]
    small = image_shape[-1] < 64
    return resnet(units=units, num_stage=4, filter_list=filter_list,
                  num_class=num_classes, bottle_neck=bottle_neck,
                  workspace=workspace, small_input=small, layout=layout,
                  stem=stem)

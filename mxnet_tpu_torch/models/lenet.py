"""LeNet (reference example/image-classification/symbol_lenet.py)."""

from .. import symbol as mx_sym


def get_symbol(num_classes=10):
    data = mx_sym.Variable("data")
    # first conv
    conv1 = mx_sym.Convolution(data, kernel=(5, 5), num_filter=20)
    tanh1 = mx_sym.Activation(conv1, act_type="tanh")
    pool1 = mx_sym.Pooling(tanh1, pool_type="max", kernel=(2, 2), stride=(2, 2))
    # second conv
    conv2 = mx_sym.Convolution(pool1, kernel=(5, 5), num_filter=50)
    tanh2 = mx_sym.Activation(conv2, act_type="tanh")
    pool2 = mx_sym.Pooling(tanh2, pool_type="max", kernel=(2, 2), stride=(2, 2))
    # first fullc
    flatten = mx_sym.Flatten(pool2)
    fc1 = mx_sym.FullyConnected(flatten, num_hidden=500)
    tanh3 = mx_sym.Activation(fc1, act_type="tanh")
    # second fullc
    fc2 = mx_sym.FullyConnected(tanh3, num_hidden=num_classes)
    # loss
    lenet = mx_sym.SoftmaxOutput(fc2, name="softmax")
    return lenet

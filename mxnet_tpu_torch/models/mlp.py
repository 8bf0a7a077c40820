"""MLP (reference example/image-classification/symbol_mlp.py)."""

from .. import symbol as mx_sym


def get_symbol(num_classes=10):
    data = mx_sym.Variable("data")
    fc1 = mx_sym.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = mx_sym.Activation(fc1, name="relu1", act_type="relu")
    fc2 = mx_sym.FullyConnected(act1, name="fc2", num_hidden=64)
    act2 = mx_sym.Activation(fc2, name="relu2", act_type="relu")
    fc3 = mx_sym.FullyConnected(act2, name="fc3", num_hidden=num_classes)
    mlp = mx_sym.SoftmaxOutput(fc3, name="softmax")
    return mlp

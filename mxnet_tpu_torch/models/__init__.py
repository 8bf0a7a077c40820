"""Models of the port: the GPT family (the trainable model, its Symbol
``gpt_symbol``, checkpoint-shaped parameters and greedy decoding), the
explicitly-unrolled LSTM language model (``lstm_unroll``, and its Symbol
``lstm_unroll_symbol``; no kernel: the fused ``RNN`` op is the LSTM/GRU
kernel path), and the reference's image-classification zoo as Symbols
under the reference's names (``lenet``, ``mlp``, ``resnet``,
``inception_bn``, ``inception_bn_small``, ``googlenet``, ``vgg``,
``alexnet``) and the SSD detector (``ssd``, over the multibox ops).
``gpt_decode_config`` reads the decode config a ``gpt_symbol`` carries;
``gpt_generate(symbol=)`` and ``serve.Engine(symbol=)`` take it from
there."""

from . import lstm
from .generate import (detect_gpt_variant, gpt_decode_config, gpt_generate,
                       normalize_gpt_params, reconcile_decode_config)
from .inception import googlenet, inception_bn, inception_bn_small
from .lenet import get_symbol as lenet
from .lstm import lstm_unroll, lstm_unroll_symbol
from .mlp import get_symbol as mlp
from .resnet import get_symbol as resnet
from .ssd import get_symbol as ssd
from .transformer import GPT, gpt, gpt_arguments, gpt_params, gpt_symbol
from .vgg import alexnet, vgg

__all__ = ["gpt", "GPT", "gpt_generate", "normalize_gpt_params",
           "detect_gpt_variant", "gpt_decode_config",
           "reconcile_decode_config", "gpt_arguments", "gpt_params",
           "gpt_symbol", "lstm", "lstm_unroll", "lstm_unroll_symbol",
           "lenet", "mlp", "resnet", "inception_bn", "inception_bn_small",
           "googlenet", "vgg", "alexnet", "ssd"]

"""Models of the port: the GPT family (the trainable model, its Symbol
``gpt_symbol``, checkpoint-shaped parameters and greedy decoding) and the
explicitly-unrolled LSTM language model (``lstm_unroll``, and its Symbol
``lstm_unroll_symbol``; no kernel: the fused ``RNN`` op is the LSTM/GRU
kernel path)."""

from . import lstm
from .generate import detect_gpt_variant, gpt_generate, normalize_gpt_params
from .lstm import lstm_unroll, lstm_unroll_symbol
from .transformer import GPT, gpt, gpt_arguments, gpt_params, gpt_symbol

__all__ = ["gpt", "GPT", "gpt_generate", "normalize_gpt_params",
           "detect_gpt_variant", "gpt_arguments", "gpt_params", "gpt_symbol",
           "lstm", "lstm_unroll", "lstm_unroll_symbol"]

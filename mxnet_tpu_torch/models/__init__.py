"""GPT model family: the trainable model, checkpoint-shaped parameters
and greedy decoding."""

from .generate import detect_gpt_variant, gpt_generate, normalize_gpt_params
from .transformer import GPT, gpt, gpt_arguments, gpt_params

__all__ = ["gpt", "GPT", "gpt_generate", "normalize_gpt_params",
           "detect_gpt_variant", "gpt_arguments", "gpt_params"]

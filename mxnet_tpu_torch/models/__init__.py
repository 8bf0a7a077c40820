"""GPT model family: checkpoint-shaped parameters and greedy decoding."""

from .generate import detect_gpt_variant, gpt_generate, normalize_gpt_params
from .transformer import gpt_arguments, gpt_params

__all__ = ["gpt_generate", "normalize_gpt_params", "detect_gpt_variant",
           "gpt_arguments", "gpt_params"]

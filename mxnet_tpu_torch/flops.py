"""Analytic FLOP counts of GPT serving, and the card's peak rates.

The port of ``mxnet_tpu/flops.py``'s serving half: the closed forms
:func:`gpt_token_flops` and :func:`gpt_prefill_flops` are copies (one
MAC = 2 FLOPs, elementwise free), the MFU and MBU denominators of the
serve engine's performance attribution.  :func:`peak_flops_per_chip`
and :func:`peak_hbm_bytes_per_chip` read the CUDA card's name from
torch (NVIDIA data-sheet figures: dense bf16 tensor-core FLOP/s and HBM
bytes/s) and give None for a card they do not know, or for the CPU, as
the reference does off TPU.  :func:`count_flops` walks a Symbol graph,
which the port does not have yet (ROADMAP §A15): it raises.
"""

from __future__ import annotations

__all__ = ["count_flops", "peak_flops_per_chip", "peak_hbm_bytes_per_chip",
           "gpt_token_flops", "gpt_prefill_flops"]


def count_flops(symbol, **input_shapes):
    """Forward-pass FLOPs of a Symbol graph: not ported."""
    raise NotImplementedError(
        "flops.count_flops walks a Symbol graph, which is not ported yet "
        "(ROADMAP §A15: the training framework core)")


def gpt_token_flops(n_layers, d_model, num_heads, head_dim, kv_heads,
                    vocab, context, d_ff=None, swiglu=False):
    """Analytic forward FLOPs for ONE token of a normalized ``gpt()``
    checkpoint attending over ``context`` cached positions (GQA-aware).

    Counts the matmul-dominant terms only — QKV/out projections, the
    per-head score and weighted-sum dots against the KV cache, the MLP
    (gate included under ``swiglu``), and the LM head (1 MAC = 2
    FLOPs, elementwise free).  The serve programs pad to bucket shapes,
    so pass the PADDED context (table capacity), not the live sequence
    length.
    """
    d_attn = num_heads * head_dim
    d_kv = kv_heads * head_dim
    d_ff = int(d_ff) if d_ff else 4 * d_model
    per_layer = 2 * d_model * d_attn          # Q projection
    per_layer += 2 * 2 * d_model * d_kv       # K + V projections (GQA)
    per_layer += 2 * d_attn * d_model         # output projection
    # scores (q . k) and weighted sum (p . v), 2 FLOPs/MAC each, over
    # the full padded context
    per_layer += 4 * num_heads * head_dim * int(context)
    mlp = 2 * d_model * d_ff + 2 * d_ff * d_model      # up + down
    if swiglu:
        mlp += 2 * d_model * d_ff                      # gate
    per_layer += mlp
    return int(n_layers) * per_layer + 2 * d_model * int(vocab)


def gpt_prefill_flops(n_layers, d_model, num_heads, head_dim, kv_heads,
                      vocab, seq_len, d_ff=None, swiglu=False,
                      logits_positions=None):
    """Analytic forward FLOPs for a dense ``seq_len``-token prefill of a
    normalized ``gpt()`` checkpoint: attention costs ``context =
    seq_len`` per position (the full masked T x T score matrix), and
    ``logits_positions`` bounds the LM-head term (defaults to all
    positions)."""
    T = int(seq_len)
    per_tok = gpt_token_flops(n_layers, d_model, num_heads, head_dim,
                              kv_heads, vocab, context=T, d_ff=d_ff,
                              swiglu=swiglu)
    head = 2 * d_model * int(vocab)
    total = T * (per_tok - head)
    n_logits = T if logits_positions is None else int(logits_positions)
    return total + n_logits * head


# (name substring, dense bf16 FLOP/s, HBM bytes/s) by CUDA device name
# (NVIDIA's data sheet).  "NVIDIA H100 80GB HBM3" is the SXM part; other
# H100s (PCIe, NVL) report other names and stay unknown until a run on
# one checks their row
_CARDS = [
    ("h100 80gb hbm3", 989e12, 3.35e12),
]


def _card(device):
    """The ``_CARDS`` row of ``device`` (default: CUDA device 0), or
    None on the CPU, without CUDA, or for an unknown card."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    for row in _CARDS:
        if row[0] in name:
            return row
    return None


def peak_flops_per_chip(device=None):
    """Peak dense bf16 FLOP/s of the card, or None if unknown."""
    row = _card(device)
    return None if row is None else row[1]


def peak_hbm_bytes_per_chip(device=None):
    """Peak HBM bandwidth (bytes/s) of the card, or None if unknown —
    memory-bandwidth-utilization's denominator, the figure decode
    (bandwidth-bound) is judged against."""
    row = _card(device)
    return None if row is None else row[2]

"""Analytic FLOP counts of Symbol graphs and GPT serving, and the card's
peak rates.

The port of ``mxnet_tpu/flops.py``: :func:`count_flops` walks a Symbol
graph's matmul-dominant nodes (Convolution, Deconvolution,
FullyConnected, FlashAttention, the dot family) under concrete input
shapes, as the reference's; the closed forms :func:`gpt_token_flops` and
:func:`gpt_prefill_flops` are copies (one MAC = 2 FLOPs, elementwise
free), the MFU and MBU denominators of the serve engine's performance
attribution.  :func:`peak_flops_per_chip`
and :func:`peak_hbm_bytes_per_chip` read the CUDA card's name from
torch (NVIDIA data-sheet figures: dense bf16 tensor-core FLOP/s and HBM
bytes/s) and give None for a card they do not know, or for the CPU, as
the reference does off TPU.
"""

from __future__ import annotations

__all__ = ["count_flops", "peak_flops_per_chip", "peak_hbm_bytes_per_chip",
           "gpt_token_flops", "gpt_prefill_flops"]


def _prod(t):
    out = 1
    for v in t:
        out *= int(v)
    return out


def count_flops(symbol, **input_shapes) -> int:
    """Forward-pass FLOPs of ``symbol`` under the given input shapes
    (one MAC = 2 FLOPs).

    Counts Convolution / Deconvolution / FullyConnected / FlashAttention
    / dot-family nodes; everything else (the RNN op included, as in the
    reference) is treated as free.
    """
    internals = symbol.get_internals()
    _, out_shapes, _ = internals.infer_shape_partial(**input_shapes)
    heads = internals._heads
    shape_of = {}  # (node, idx) -> shape
    for (node, idx), shp in zip(heads, out_shapes):
        shape_of[(node, idx)] = shp

    total = 0
    for node, idx in heads:
        if idx != 0 or node.is_variable:
            continue
        op_name = node.op.name
        params = node.params
        out_shp = shape_of[(node, idx)]
        in_shp = (shape_of.get(node.inputs[0]) if node.inputs else None)
        if out_shp is None or in_shp is None:
            continue
        if op_name == "Convolution":
            kh, kw = params.kernel
            groups = getattr(params, "num_group", 1) or 1
            # output spatial positions x per-position dot of size
            # kh*kw*Cin/groups; layout-agnostic via element counts
            cin = (in_shp[-1] if getattr(params, "layout", "NCHW") == "NHWC"
                   else in_shp[1])
            total += 2 * _prod(out_shp) * kh * kw * cin // groups
        elif op_name == "Deconvolution":
            # transposed conv MACs scale with the INPUT extent: every
            # input position scatters a kh*kw*Cout patch
            kh, kw = params.kernel
            groups = getattr(params, "num_group", 1) or 1
            total += (2 * _prod(in_shp) * kh * kw
                      * params.num_filter // groups)
        elif op_name == "FullyConnected":
            in_dim = _prod(in_shp[1:])
            total += 2 * _prod(out_shp) * in_dim
        elif op_name == "FlashAttention":
            # (B, H, T, D): QK^T and PV are each 2*B*H*T^2*D
            b, h, t, d = in_shp
            total += 4 * b * h * t * t * d
        elif op_name in ("dot", "batch_dot", "linalg_gemm2"):
            rhs_shp = shape_of.get(node.inputs[1])
            if rhs_shp:
                # contraction length, transpose-flag agnostic:
                # |lhs|*|rhs| = (m k)(k n) and |out| = m n  =>  k^2
                k2 = (_prod(in_shp) * _prod(rhs_shp)) / max(_prod(out_shp), 1)
                total += int(2 * _prod(out_shp) * (k2 ** 0.5))
    return int(total)


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

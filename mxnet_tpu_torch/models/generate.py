"""Incremental (KV-cache) greedy decoding for the GPT model family.

The port of ``mxnet_tpu/models/generate.py``.  The reference runs the
whole generation loop as one ``lax.scan`` inside one jit; PyTorch runs
eagerly, so here the loop is a Python loop over positions with the
cache updated in place.  The numerics keep the reference's cast points:
norms, softmax, GELU and SiLU in float32, matmuls in the activation
dtype.  :func:`gpt_generate` is the single-request oracle the serving
engine is held against.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..context import resolve_device

__all__ = ["gpt_generate", "normalize_gpt_params", "detect_gpt_variant"]


def _ln(x, gamma, beta, eps=1e-5):
    xf = x.float()
    if beta is None:          # rmsnorm checkpoint: no shift, no centering
        ms = xf.square().mean(-1, keepdim=True)
        return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def _fc(x, w, b):
    # matmul then bias add, as two ops: a fused addmm would round a
    # bf16 product differently from the reference
    return x @ w.t().to(x.dtype) + b.to(x.dtype)


def _gelu(x):
    xf = x.float()
    return (0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def _split_rows(a, bounds):
    if isinstance(a, torch.Tensor):
        return torch.tensor_split(a, bounds, dim=0)
    return np.split(np.asarray(a), bounds, axis=0)


def normalize_gpt_params(params, name="gpt"):
    """Canonicalize a gpt() checkpoint for decoding: dequantize
    weight-only-int8 entries (``*_wscale``) and split ``fused_qkv``
    projections back into the per-tensor ``*_{q,k,v}_*`` layout every
    decoder addresses.  Values may be numpy arrays or torch tensors.
    Returns the input dict unchanged when neither applies."""
    try:
        tok_w = params[f"{name}_tok_embed_weight"]
    except KeyError:
        raise ValueError(
            f"params has no '{name}_tok_embed_weight' — wrong name "
            "prefix or not a gpt() parameter dict") from None
    d_model = tok_w.shape[1]
    if any(k.endswith("_wscale") for k in params):
        params = dict(params)
        for k in [k for k in params if k.endswith("_wscale")]:
            stem = k[: -len("_wscale")]
            wq, scale = params[stem + "_weight"], params.pop(k)
            if isinstance(wq, torch.Tensor):
                params[stem + "_weight"] = (wq.float()
                                            * scale.float()[:, None])
            else:
                params[stem + "_weight"] = (
                    np.asarray(wq, np.float32)
                    * np.asarray(scale, np.float32)[:, None])
    if f"{name}_l0_qkv_weight" in params:
        # GQA fused checkpoints emit (d_model + 2*d_kv) rows: split at
        # the boundaries rather than in thirds
        params = dict(params)
        rows = params[f"{name}_l0_qkv_weight"].shape[0]
        d_kv_f = (rows - d_model) // 2
        i = 0
        while f"{name}_l{i}_qkv_weight" in params:
            for kind in ("weight", "bias"):
                whole = params.pop(f"{name}_l{i}_qkv_{kind}")
                parts = _split_rows(whole, [d_model, d_model + d_kv_f])
                for x, part in zip(("q", "k", "v"), parts):
                    params[f"{name}_l{i}_{x}_{kind}"] = part
            i += 1
    return params


def detect_gpt_variant(params, num_heads, name="gpt"):
    """Model-variant flags recoverable from a NORMALIZED checkpoint:
    layer count, head-dim split, grouped-query kv_heads, rope-vs-learned
    positions (``pos_table`` is the table length, None for rope),
    SwiGLU MLP, tied LM head, and rmsnorm.  ``num_heads`` itself is not
    recoverable from shapes."""
    tok_w = params[f"{name}_tok_embed_weight"]
    d_model = tok_w.shape[1]
    pos_w = params.get(f"{name}_pos_embed_weight")
    n_layers = 0
    while f"{name}_l{n_layers}_q_weight" in params:
        n_layers += 1
    if n_layers == 0:
        raise ValueError(f"no '{name}_l0_q_weight' (or '_l0_qkv_weight') "
                         f"in params — wrong name prefix or not a gpt() "
                         "parameter dict")
    if d_model % num_heads:
        raise ValueError("num_heads must divide d_model")
    head_dim = d_model // num_heads
    return {
        "n_layers": n_layers,
        "d_model": d_model,
        "head_dim": head_dim,
        "kv_heads": params[f"{name}_l0_k_weight"].shape[0] // head_dim,
        "vocab": tok_w.shape[0],
        "pos_table": None if pos_w is None else pos_w.shape[1],
        "swiglu": f"{name}_l0_ff_gate_weight" in params,
        "tied": f"{name}_head_weight" not in params,
        "rmsnorm": f"{name}_l0_ln1_beta" not in params,
    }


def _rot(u, t):
    """RoPE rotation of (B, H, Dh) at scalar position ``t``."""
    half = u.shape[-1] // 2
    inv = 10000.0 ** (-torch.arange(half, dtype=torch.float32,
                                    device=u.device) / half)
    ang = float(t) * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    uf = u.float()
    u1, u2 = uf[..., :half], uf[..., half:]
    return torch.cat([u1 * cos - u2 * sin, u1 * sin + u2 * cos],
                     dim=-1).to(u.dtype)


@torch.no_grad()
def gpt_generate(params, prompt, max_new_tokens, num_heads=None,
                 temperature=0.0, top_k=None, window=None, name="gpt",
                 device="cuda", dtype=None):
    """Greedy continuation of ``prompt`` (batch, prompt_len) with a KV
    cache; returns ``(batch, prompt_len + max_new_tokens)`` numpy int32
    ids, prompt included.

    ``params`` is a gpt() parameter dict (numpy arrays, or torch
    tensors); it is carried to ``device`` (default ``"cuda"``, which
    raises when CUDA is absent) in ``dtype`` (default: the checkpoint's
    own).  ``num_heads`` and ``window`` (the radius the model was
    trained with, 0 = full attention) are not recoverable from weight
    shapes and must be passed.  Sampling (``temperature > 0``) is not
    ported yet (ROADMAP §A item 9)."""
    from ..convert import params_from_numpy

    if temperature or top_k:
        raise NotImplementedError(
            "gpt_generate: only greedy decoding (temperature=0) is ported;"
            " sampling waits for ROADMAP §A item 9")
    prompt = np.asarray(prompt)
    if prompt.ndim != 2:
        raise ValueError("prompt must be (batch, prompt_len)")
    if num_heads is None:
        raise ValueError("num_heads is required")
    window = 0 if window is None else int(window)
    if window < 0:
        raise ValueError(f"window must be >= 0 (got {window})")
    B, P = prompt.shape
    if P < 1:
        raise ValueError("prompt must hold at least one token")
    dev = resolve_device(device)
    params = params_from_numpy(params, dev, dtype=dtype, name=name)
    spec = detect_gpt_variant(params, num_heads, name)
    S = spec["pos_table"]
    T = P + max_new_tokens
    if S is not None and T > S:
        raise ValueError(
            f"prompt_len + max_new_tokens = {T} exceeds the model's "
            f"positional table ({S})")
    if max_new_tokens < 1:
        return np.asarray(prompt, np.int32)
    S_cache = T if S is None else S
    n_layers, head_dim = spec["n_layers"], spec["head_dim"]
    kv_heads = spec["kv_heads"]
    group = num_heads // kv_heads
    d_model = num_heads * head_dim
    rope, swiglu = S is None, spec["swiglu"]
    tied, rmsnorm = spec["tied"], spec["rmsnorm"]
    tok_w = params[f"{name}_tok_embed_weight"]
    cache_k = torch.zeros((n_layers, B, kv_heads, S_cache, head_dim),
                          dtype=tok_w.dtype, device=dev)
    cache_v = torch.zeros_like(cache_k)
    ar = torch.arange(S_cache, device=dev)
    prompt_t = torch.as_tensor(prompt, dtype=torch.long, device=dev)

    def step_token(tok, t):
        x = tok_w[tok]                                        # (B, D)
        if not rope:
            x = x + params[f"{name}_pos_embed_weight"][0, t]
        pos_mask = ar <= t
        if window:
            pos_mask = pos_mask & (ar > t - window)
        for i in range(n_layers):
            p = f"{name}_l{i}"
            h = _ln(x, params[f"{p}_ln1_gamma"],
                    None if rmsnorm else params[f"{p}_ln1_beta"])
            q = _fc(h, params[f"{p}_q_weight"], params[f"{p}_q_bias"])
            k = _fc(h, params[f"{p}_k_weight"], params[f"{p}_k_bias"])
            v = _fc(h, params[f"{p}_v_weight"], params[f"{p}_v_bias"])
            qh = q.reshape(B, num_heads, head_dim)
            kh = k.reshape(B, kv_heads, head_dim)
            vh = v.reshape(B, kv_heads, head_dim)
            if rope:
                qh, kh = _rot(qh, t), _rot(kh, t)
            # in-place cache write (the reference's .at[].set)
            cache_k[i, :, :, t, :] = kh
            cache_v[i, :, :, t, :] = vh
            qg = qh.reshape(B, kv_heads, group, head_dim)
            scores = torch.einsum("bkgd,bksd->bkgs", qg, cache_k[i])
            scores = scores / math.sqrt(head_dim)
            scores = scores.masked_fill(~pos_mask, float("-inf"))
            probs = torch.softmax(scores.float(), dim=-1)
            attn = torch.einsum("bkgs,bksd->bkgd", probs.to(x.dtype),
                                cache_v[i])
            x = x + _fc(attn.reshape(B, d_model),
                        params[f"{p}_proj_weight"], params[f"{p}_proj_bias"])
            h2 = _ln(x, params[f"{p}_ln2_gamma"],
                     None if rmsnorm else params[f"{p}_ln2_beta"])
            if swiglu:
                g = _fc(h2, params[f"{p}_ff_gate_weight"],
                        params[f"{p}_ff_gate_bias"])
                gf = g.float()
                up = ((gf * torch.sigmoid(gf)).to(g.dtype)
                      * _fc(h2, params[f"{p}_ff_up_weight"],
                            params[f"{p}_ff_up_bias"]))
            else:
                up = _gelu(_fc(h2, params[f"{p}_ff_up_weight"],
                               params[f"{p}_ff_up_bias"]))
            x = x + _fc(up, params[f"{p}_ff_down_weight"],
                        params[f"{p}_ff_down_bias"])
        final = _ln(x, params[f"{name}_ln_f_gamma"],
                    None if rmsnorm else params[f"{name}_ln_f_beta"])
        if tied:
            return final @ tok_w.t().to(final.dtype)
        return _fc(final, params[f"{name}_head_weight"],
                   params[f"{name}_head_bias"])

    ids = [prompt_t[:, t] for t in range(P)]
    for t in range(T - 1):
        tok = prompt_t[:, t] if t < P else ids[t]
        sampled = torch.argmax(step_token(tok, t), dim=-1)
        if t >= P - 1:
            ids.append(sampled)
    return torch.stack(ids, dim=1).to(torch.int32).cpu().numpy()

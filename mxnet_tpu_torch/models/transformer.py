"""GPT-style decoder-only transformer: the trainable model and its
checkpoint-shaped parameters.

:func:`gpt` is the port of ``mxnet_tpu/models/transformer.py`` ``gpt()``:
the same signature, returning a :class:`GPT` ``nn.Module`` in place of a
Symbol (for serving and ``parallel.ShardedTrainer``).
:func:`gpt_symbol` is the reference's ``gpt()`` itself: the same Symbol,
node for node, for the training frontend (``module.Module``).  The
``GPT`` module's parameters carry the reference checkpoint's names
(those of :func:`gpt_arguments`) and are created on the ``meta`` device,
like a Symbol's arguments, until a trainer places and initialises them.

The reference takes parameter shapes from the Symbol's ``infer_shape``;
:func:`gpt_params` writes the same parameter list out by hand: the same
names, in the same order, with the same shapes.  Random values are drawn
the way the reference's serving benchmarks draw them
(``tools/decode_bench.py`` ``make_params``): one ``RandomState(seed)``,
one ``randn`` per argument in argument order, weights scaled by 0.02,
biases zero, norm gains one.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn

from ..ops.attention import (FlashAttention, LayerNorm, RMSNorm, RoPE, gelu,
                             silu)
from ..ops.loss import SoftmaxCELoss, SoftmaxOutput
from ..ops.nn import Embedding, FullyConnected

__all__ = ["gpt", "GPT", "gpt_arguments", "gpt_params", "gpt_symbol"]


def gpt_arguments(vocab, seq_len, num_layers=2, d_model=128, num_heads=4,
                  kv_heads=None, d_ff=None, pos_embed="learned",
                  mlp="gelu", norm="layernorm", tie_embeddings=False,
                  name="gpt", fused_qkv=False):
    """``[(name, shape)]`` of a gpt() checkpoint in the Symbol's
    argument order (a tied head lists the embedding twice, as the
    Symbol does).  ``fused_qkv`` puts one ``*_qkv_weight``
    (d_model + 2 d_kv, d_model) and bias where the q/k/v ones were."""
    if d_model % num_heads:
        raise ValueError("d_model must divide into num_heads")
    if pos_embed not in ("learned", "rope"):
        raise ValueError(f"pos_embed must be learned|rope, got {pos_embed}")
    if mlp not in ("gelu", "swiglu"):
        raise ValueError(f"mlp must be gelu|swiglu, got {mlp}")
    if norm not in ("layernorm", "rmsnorm"):
        raise ValueError(f"norm must be layernorm|rmsnorm, got {norm}")
    d_ff = d_ff or 4 * d_model
    head_dim = d_model // num_heads
    kv_heads = kv_heads or num_heads
    if num_heads % kv_heads:
        raise ValueError("num_heads must be a multiple of kv_heads")
    d_kv = kv_heads * head_dim
    ln = ("gamma",) if norm == "rmsnorm" else ("gamma", "beta")

    def fc(stem, n_out, n_in):
        return [(f"{stem}_weight", (n_out, n_in)), (f"{stem}_bias", (n_out,))]

    args = [(f"{name}_tok_embed_weight", (vocab, d_model))]
    if pos_embed == "learned":
        args.append((f"{name}_pos_embed_weight", (1, seq_len, d_model)))
    for i in range(num_layers):
        p = f"{name}_l{i}"
        args += [(f"{p}_ln1_{g}", (d_model,)) for g in ln]
        if fused_qkv:
            args += fc(f"{p}_qkv", d_model + 2 * d_kv, d_model)
        else:
            args += (fc(f"{p}_q", d_model, d_model)
                     + fc(f"{p}_k", d_kv, d_model)
                     + fc(f"{p}_v", d_kv, d_model))
        args += fc(f"{p}_proj", d_model, d_model)
        args += [(f"{p}_ln2_{g}", (d_model,)) for g in ln]
        if mlp == "swiglu":
            args += fc(f"{p}_ff_gate", d_ff, d_model)
        args += fc(f"{p}_ff_up", d_ff, d_model)
        args += fc(f"{p}_ff_down", d_model, d_ff)
    args += [(f"{name}_ln_f_{g}", (d_model,)) for g in ln]
    if tie_embeddings:
        args.append((f"{name}_tok_embed_weight", (vocab, d_model)))
    else:
        args += fc(f"{name}_head", vocab, d_model)
    return args


def gpt_params(vocab, seq_len, num_layers=2, d_model=128, num_heads=4,
               kv_heads=None, d_ff=None, pos_embed="learned", mlp="gelu",
               norm="layernorm", tie_embeddings=False, name="gpt", seed=0,
               dtype=np.float32, scale=0.02, fused_qkv=False):
    """Random gpt() parameter dict as numpy arrays: the names and
    shapes ``mx.models.gpt(...).infer_shape`` gives, with the values
    ``make_params`` draws for ``seed``.  ``dtype`` is a numpy dtype; for
    bfloat16 keep float32 here and cast while carrying the dict to the
    device (``convert.params_from_numpy(..., dtype=torch.bfloat16)``),
    which rounds exactly as a numpy bfloat16 cast would."""
    rng = np.random.RandomState(seed)
    params = {}
    for arg, shp in gpt_arguments(
            vocab, seq_len, num_layers=num_layers, d_model=d_model,
            num_heads=num_heads, kv_heads=kv_heads, d_ff=d_ff,
            pos_embed=pos_embed, mlp=mlp, norm=norm,
            tie_embeddings=tie_embeddings, name=name, fused_qkv=fused_qkv):
        s = scale if arg.endswith("weight") else 0.0
        params[arg] = (rng.randn(*shp) * s + (
            1.0 if arg.endswith("gamma") else 0.0)).astype(dtype)
    return params


class GPT(nn.Module):
    """The network of :func:`gpt`.  ``forward(data, softmax_label)``
    takes (B, seq_len) integer token ids and next-token labels and
    returns the head's output: per-position probabilities
    (B * seq_len, vocab) for ``loss="softmax"``, the per-position NLL
    (B * seq_len,) for ``loss="ce"``.  Parameters are registered under
    their checkpoint names; a tied head uses the one embedding
    ``Parameter`` twice, so autograd sums both gradient paths."""

    def __init__(self, vocab_size, seq_len, num_layers, d_model, num_heads,
                 d_ff, causal, fused_qkv, attn_layout, attn_impl, kv_heads,
                 attn_window, pos_embed, loss, mlp, tie_embeddings, norm,
                 name):
        super().__init__()
        self.vocab_size, self.seq_len = vocab_size, seq_len
        self.num_layers, self.d_model = num_layers, d_model
        self.num_heads, self.kv_heads = num_heads, kv_heads
        self.head_dim = d_model // num_heads
        self.d_kv = kv_heads * self.head_dim
        self.d_ff, self.causal, self.fused_qkv = d_ff, causal, fused_qkv
        self.attn_layout, self.attn_impl = attn_layout, attn_impl
        self.attn_window, self.pos_embed, self.loss = (attn_window,
                                                       pos_embed, loss)
        self.mlp, self.tie_embeddings, self.norm = mlp, tie_embeddings, norm
        self.name = name
        for arg, shape in gpt_arguments(
                vocab_size, seq_len, num_layers=num_layers, d_model=d_model,
                num_heads=num_heads, kv_heads=kv_heads, d_ff=d_ff,
                pos_embed=pos_embed, mlp=mlp, norm=norm,
                tie_embeddings=tie_embeddings, name=name,
                fused_qkv=fused_qkv):
            if arg not in self._parameters:     # the tied head's repeat
                self.register_parameter(arg, nn.Parameter(
                    torch.empty(shape, device="meta")))

    def _p(self, name):
        return self._parameters[name]

    def _norm(self, x, stem):
        if self.norm == "rmsnorm":
            return RMSNorm(x, self._p(f"{stem}_gamma"))
        return LayerNorm(x, self._p(f"{stem}_gamma"), self._p(f"{stem}_beta"))

    def _fc(self, x, stem):
        return FullyConnected(x, self._p(f"{stem}_weight"),
                              self._p(f"{stem}_bias"))

    def _heads(self, x, n):
        x = x.reshape(-1, self.seq_len, n, self.head_dim)
        return x if self.attn_layout == "bshd" else x.transpose(1, 2)

    def forward(self, data, softmax_label):
        nm, d, S = self.name, self.d_model, self.seq_len
        h = Embedding(data, self._p(f"{nm}_tok_embed_weight"))  # (B, S, D)
        if self.pos_embed == "learned":
            h = h + self._p(f"{nm}_pos_embed_weight")
        for i in range(self.num_layers):
            p = f"{nm}_l{i}"
            # -- attention block (pre-norm)
            flat = self._norm(h, f"{p}_ln1").reshape(-1, d)
            if self.fused_qkv:
                qkv = self._fc(flat, f"{p}_qkv")
                q = qkv[:, :d]
                k = qkv[:, d:d + self.d_kv]
                v = qkv[:, d + self.d_kv:]
            else:
                q, k, v = (self._fc(flat, f"{p}_{x}") for x in "qkv")
            qh = self._heads(q, self.num_heads)
            kh = self._heads(k, self.kv_heads)
            if self.pos_embed == "rope":
                qh = RoPE(qh, layout=self.attn_layout)
                kh = RoPE(kh, layout=self.attn_layout)
            attn = FlashAttention(qh, kh, self._heads(v, self.kv_heads),
                                  causal=self.causal,
                                  window=self.attn_window,
                                  impl=self.attn_impl,
                                  layout=self.attn_layout)
            if self.attn_layout == "bhsd":
                attn = attn.transpose(1, 2)
            proj = self._fc(attn.reshape(-1, d), f"{p}_proj")
            h = h + proj.reshape(-1, S, d)
            # -- MLP block (pre-norm)
            flat2 = self._norm(h, f"{p}_ln2").reshape(-1, d)
            up = self._fc(flat2, f"{p}_ff_up")
            if self.mlp == "swiglu":
                act = silu(self._fc(flat2, f"{p}_ff_gate")) * up
            else:
                act = gelu(up)
            h = h + self._fc(act, f"{p}_ff_down").reshape(-1, S, d)
        final = self._norm(h, f"{nm}_ln_f").reshape(-1, d)
        if self.tie_embeddings:
            logits = FullyConnected(final, self._p(f"{nm}_tok_embed_weight"),
                                    no_bias=True)
        else:
            logits = self._fc(final, f"{nm}_head")
        label = softmax_label.reshape(-1)
        if self.loss == "ce":
            return SoftmaxCELoss(logits, label)
        return SoftmaxOutput(logits, label)


def gpt(vocab_size, seq_len, num_layers=2, d_model=128, num_heads=4,
        d_ff=None, dropout=0.0, causal=True, remat=False, fused_qkv=False,
        attn_layout="bhsd", attn_impl="auto", attn_sp_impl="ring",
        kv_heads=None, attn_window=0, pos_embed="learned", loss="softmax",
        mlp="gelu", tie_embeddings=False, norm="layernorm", name="gpt"):
    """The reference's ``gpt()`` as a :class:`GPT` module: pre-norm
    causal self-attention blocks over the ``FlashAttention`` op (the
    Hopper kernels on CUDA tensors with ``attn_impl="auto"``), GELU or
    SwiGLU MLPs, learned or rotary positions, LayerNorm or RMSNorm, a
    separate or tied head, and a SoftmaxOutput (``loss="softmax"``) or
    fused cross-entropy (``loss="ce"``) head.  Arguments as in the
    reference.  ``attn_sp_impl`` only acts under sequence parallelism,
    which the port does not have yet.  ``dropout > 0`` and
    ``remat=True`` are not ported yet and raise."""
    if dropout > 0:
        raise NotImplementedError("gpt(dropout>0) is not ported yet "
                                  "(ROADMAP §A16)")
    if remat:
        raise NotImplementedError("gpt(remat=True) is not ported yet "
                                  "(ROADMAP §A16)")
    if d_model % num_heads:
        raise ValueError("d_model must divide into num_heads")
    kv_heads = kv_heads or num_heads
    if num_heads % kv_heads:
        raise ValueError("num_heads must be a multiple of kv_heads")
    if loss not in ("softmax", "ce"):
        raise ValueError(f"loss must be softmax|ce, got {loss}")
    if attn_layout not in ("bhsd", "bshd"):
        raise ValueError(f"attn_layout must be bhsd|bshd, got {attn_layout}")
    if attn_impl not in ("auto", "flash", "xla"):
        raise ValueError(f"attn_impl must be auto|flash|xla, got {attn_impl}")
    if attn_sp_impl not in ("ring", "ulysses"):
        raise ValueError(f"attn_sp_impl must be ring|ulysses, got "
                         f"{attn_sp_impl}")
    if pos_embed == "rope" and (d_model // num_heads) % 2:
        raise ValueError("rope needs an even head_dim")
    return GPT(vocab_size, seq_len, num_layers, d_model, num_heads,
               d_ff or 4 * d_model, causal, fused_qkv, attn_layout,
               attn_impl, kv_heads, attn_window, pos_embed, loss, mlp,
               tie_embeddings, norm, name)


def gpt_symbol(vocab_size, seq_len, num_layers=2, d_model=128, num_heads=4,
        d_ff=None, dropout=0.0, causal=True, remat=False, fused_qkv=False,
        attn_layout="bhsd", attn_impl="auto", attn_sp_impl="ring",
        kv_heads=None, attn_window=0, pos_embed="learned", loss="softmax",
        mlp="gelu", tie_embeddings=False, norm="layernorm", name="gpt"):
    """The reference's ``gpt()``: a Symbol computing the next-token
    loss, built node for node from the port's symbol ops, so its JSON,
    arguments and shapes are the reference's.

    Inputs: ``data`` (batch, seq_len) token ids; ``softmax_label``
    (batch, seq_len) next-token targets.  Output: per-position softmax
    (batch*seq_len, vocab_size), or the (batch*seq_len,) NLL with
    ``loss="ce"``.  The options are the reference's (see its docstring
    and :func:`gpt`'s).  ``remat=True`` marks every block
    ``force_mirroring`` (recomputed in backward through
    ``torch.utils.checkpoint``); ``dropout`` adds Dropout ops after the
    projections.  ``attn_impl="auto"`` runs the Hopper flash kernels on
    the card and the dense formulation on the CPU; ``attn_sp_impl`` is
    carried into the graph and used by no one-device program.
    """
    if d_model % num_heads:
        raise ValueError("d_model must divide into num_heads")
    d_ff = d_ff or 4 * d_model
    head_dim = d_model // num_heads
    kv_heads = kv_heads or num_heads
    if num_heads % kv_heads:
        raise ValueError("num_heads must be a multiple of kv_heads")
    # GQA composes with fused_qkv: the fused projection emits
    # (d_model + 2*d_kv) columns and the slice bounds below use d_kv
    d_kv = kv_heads * head_dim

    from .. import symbol as sym

    def layer_scope(i):
        # mirror_stage separates per-layer checkpoint blocks: without it
        # consecutive mirrored layers would merge into one region whose
        # backward recomputes the entire stack
        if remat:
            return sym.AttrScope(force_mirroring="1", mirror_stage=str(i))
        return contextlib.nullcontext()

    if pos_embed not in ("learned", "rope"):
        raise ValueError(f"pos_embed must be learned|rope, got {pos_embed}")
    if loss not in ("softmax", "ce"):
        raise ValueError(f"loss must be softmax|ce, got {loss}")
    if mlp not in ("gelu", "swiglu"):
        raise ValueError(f"mlp must be gelu|swiglu, got {mlp}")
    if norm not in ("layernorm", "rmsnorm"):
        raise ValueError(f"norm must be layernorm|rmsnorm, got {norm}")

    def norm_layer(x, nm):
        if norm == "rmsnorm":
            return sym.RMSNorm(x, name=nm)
        return sym.LayerNorm(x, name=nm)
    if pos_embed == "rope" and head_dim % 2:
        raise ValueError("rope needs an even head_dim")
    data = sym.Variable("data")
    tok = sym.Embedding(data, name=f"{name}_tok_embed", input_dim=vocab_size,
                        output_dim=d_model)                  # (B, S, D)
    if pos_embed == "learned":
        pos = sym.Variable(f"{name}_pos_embed_weight",
                           shape=(1, seq_len, d_model))
        h = sym.broadcast_plus(tok, pos)
    else:
        h = tok              # rope: positions enter at each Q/K rotation

    for i in range(num_layers):
        p = f"{name}_l{i}"
        with layer_scope(i):
            # -- attention block (pre-LN) -------------------------------
            ln1 = norm_layer(h, f"{p}_ln1")
            flat = sym.Reshape(ln1, shape=(-1, d_model))
            if fused_qkv:
                qkv = sym.FullyConnected(flat, name=f"{p}_qkv",
                                         num_hidden=d_model + 2 * d_kv)
                q = sym.slice_axis(qkv, axis=1, begin=0, end=d_model)
                k = sym.slice_axis(qkv, axis=1, begin=d_model,
                                   end=d_model + d_kv)
                v = sym.slice_axis(qkv, axis=1, begin=d_model + d_kv,
                                   end=d_model + 2 * d_kv)
            else:
                q = sym.FullyConnected(flat, name=f"{p}_q",
                                       num_hidden=d_model)
                k = sym.FullyConnected(flat, name=f"{p}_k",
                                       num_hidden=d_kv)
                v = sym.FullyConnected(flat, name=f"{p}_v",
                                       num_hidden=d_kv)

            if attn_layout == "bshd":
                # sequence-major: (B, S, H, Dh) straight from the
                # projection reshape, no transpose in or out
                def heads(x, n):
                    return sym.Reshape(x, shape=(-1, seq_len, n,
                                                 head_dim))
            else:
                def heads(x, n):
                    x = sym.Reshape(x, shape=(-1, seq_len, n,
                                              head_dim))
                    return sym.SwapAxis(x, dim1=1, dim2=2)   # (B, n, S, Dh)

            qh, kh = heads(q, num_heads), heads(k, kv_heads)
            if pos_embed == "rope":
                qh = sym.RoPE(qh, layout=attn_layout)
                kh = sym.RoPE(kh, layout=attn_layout)
            attn = sym.FlashAttention(qh, kh, heads(v, kv_heads),
                                      name=f"{p}_attn", causal=causal,
                                      layout=attn_layout, impl=attn_impl,
                                      sp_impl=attn_sp_impl,
                                      window=attn_window)
            if attn_layout == "bshd":
                merged = sym.Reshape(attn, shape=(-1, d_model))
            else:
                merged = sym.Reshape(sym.SwapAxis(attn, dim1=1, dim2=2),
                                     shape=(-1, d_model))
            proj = sym.FullyConnected(merged, name=f"{p}_proj",
                                      num_hidden=d_model)
            if dropout > 0:
                proj = sym.Dropout(proj, p=dropout)
            h = h + sym.Reshape(proj, shape=(-1, seq_len, d_model))

            # -- MLP block (pre-LN) -------------------------------------
            ln2 = norm_layer(h, f"{p}_ln2")
            flat2 = sym.Reshape(ln2, shape=(-1, d_model))
            up = sym.FullyConnected(flat2, name=f"{p}_ff_up",
                                     num_hidden=d_ff)
            if mlp == "swiglu":
                gate = sym.FullyConnected(flat2, name=f"{p}_ff_gate",
                                          num_hidden=d_ff)
                act = sym.silu(gate) * up       # f32 silu, like gelu
            else:
                act = sym.gelu(up)
            down = sym.FullyConnected(act, name=f"{p}_ff_down",
                                      num_hidden=d_model)
            if dropout > 0:
                down = sym.Dropout(down, p=dropout)
            h = h + sym.Reshape(down, shape=(-1, seq_len, d_model))

    final = norm_layer(h, f"{name}_ln_f")
    final_flat = sym.Reshape(final, shape=(-1, d_model))
    if tie_embeddings:
        # same named variable as the Embedding: the executor binds one
        # array and sums both ops' gradient contributions
        tok_w = sym.Variable(f"{name}_tok_embed_weight")
        logits = sym.FullyConnected(final_flat, weight=tok_w,
                                    name=f"{name}_head",
                                    num_hidden=vocab_size, no_bias=True)
    else:
        logits = sym.FullyConnected(final_flat, name=f"{name}_head",
                                    num_hidden=vocab_size)
    label = sym.Variable("softmax_label")        # (batch, seq_len)
    label_flat = sym.Reshape(label, shape=(-1,))
    if loss == "ce":
        out = sym.SoftmaxCELoss(logits, label_flat, name="softmax")
    else:
        out = sym.SoftmaxOutput(logits, label_flat, name="softmax")
    # decode-time config NOT derivable from weight shapes (generate.py
    # detects kv_heads/rope/swiglu/tied from the checkpoint, but head
    # count and the trained sliding window are invisible there) —
    # persist it in the symbol so the two-artifact checkpoint carries it
    out._set_attr(__gpt_num_heads__=num_heads, __gpt_attn_window__=attn_window)
    return out

"""Checkpoint-shaped parameters for the GPT model family.

The reference builds ``models.gpt()`` as a Symbol and takes parameter
shapes from its ``infer_shape``.  The port has no Symbol yet, so
:func:`gpt_params` writes the same parameter list out by hand: the same
names, in the same order, with the same shapes.  Random values are drawn
the way the reference's serving benchmarks draw them
(``tools/decode_bench.py`` ``make_params``): one ``RandomState(seed)``,
one ``randn`` per argument in argument order, weights scaled by 0.02,
biases zero, norm gains one.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gpt_arguments", "gpt_params"]


def gpt_arguments(vocab, seq_len, num_layers=2, d_model=128, num_heads=4,
                  kv_heads=None, d_ff=None, pos_embed="learned",
                  mlp="gelu", norm="layernorm", tie_embeddings=False,
                  name="gpt"):
    """``[(name, shape)]`` of a gpt() checkpoint in the Symbol's
    argument order (a tied head lists the embedding twice, as the
    Symbol does)."""
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
        args += (fc(f"{p}_q", d_model, d_model) + fc(f"{p}_k", d_kv, d_model)
                 + fc(f"{p}_v", d_kv, d_model)
                 + fc(f"{p}_proj", d_model, d_model))
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
               dtype=np.float32, scale=0.02):
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
            tie_embeddings=tie_embeddings, name=name):
        s = scale if arg.endswith("weight") else 0.0
        params[arg] = (rng.randn(*shp) * s + (
            1.0 if arg.endswith("gamma") else 0.0)).astype(dtype)
    return params

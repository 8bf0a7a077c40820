"""Decode config from a Symbol: ``serve.Engine(symbol=, draft_symbol=)``,
``serve.spec.DraftWorker(symbol=)``, ``models.gpt_generate(symbol=)``,
``models.gpt_decode_config`` and ``models.reconcile_decode_config``
against the reference's, on the CPU.

The port's engine reads ``num_heads`` and the trained window from the
port's ``gpt_symbol`` (as built, and after ``model.save_checkpoint`` /
``load_checkpoint``, whose NDArray parameters it serves as they are) and
gives the reference engine's greedy tokens (``symbol=`` there too), with
and without a window and with a speculative draft read from
``draft_symbol=``.  An explicit value contradicting the symbol raises,
as does a symbol without the config attributes.  ``gpt_generate(symbol=)``
gives the reference's tokens, and without ``window`` or ``symbol`` it
warns (full attention assumed), as the reference's does.
"""

import warnings

import numpy as np
import pytest

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=64,
                 max_prefills_per_step=2, prefix_cache=False,
                 prefill_chunk=0)


def _symbols(variant, **extra):
    """(reference gpt symbol, port gpt_symbol) of one variant."""
    cfg = {**fx.VARIANTS[variant], **extra}
    with mx.sym.NameManager():
        ref = mx.models.gpt(fx.VOCAB, fx.SEQ, **cfg)
    with mt.sym.NameManager():
        port = mt.models.gpt_symbol(fx.VOCAB, fx.SEQ, **cfg)
    return ref, port


def _serve(eng, prompts, max_new=10):
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    eng.shutdown()
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("variant,window", [("gpt2", 0), ("llama", 0),
                                            ("gpt2", 6)])
def test_engine_symbol_tokens_equal_reference(variant, window):
    ref_sym, port_sym = _symbols(variant, attn_window=window)
    params = fx.ref_params(fx.ref_net(variant))
    prompts = fx.prompts(3)
    want = _serve(mx.serve.Engine(params, symbol=ref_sym, **ENGINE_KW),
                  prompts)
    eng = mt.serve.Engine(params, symbol=port_sym, device="cpu", **ENGINE_KW)
    assert (eng.num_heads, eng.window) == (fx.VARIANTS[variant]["num_heads"],
                                           window)
    assert _serve(eng, prompts) == want
    explicit = mt.serve.Engine(params, num_heads=eng.num_heads,
                               window=window, device="cpu", **ENGINE_KW)
    assert _serve(explicit, prompts) == want


def test_engine_serves_a_loaded_checkpoint(tmp_path):
    """``save_checkpoint`` then ``load_checkpoint``: the symbol carries its
    decode config through JSON, and the NDArray parameters serve as they
    are."""
    ref_sym, port_sym = _symbols("gpt2")
    params = fx.ref_params(fx.ref_net("gpt2"))
    prefix = str(tmp_path / "gpt")
    with mt.cpu():
        mt.model.save_checkpoint(prefix, 3, port_sym,
                                 {k: mt.nd.array(v) for k, v in params.items()},
                                 {})
        sym, args, aux = mt.model.load_checkpoint(prefix, 3)
    assert isinstance(args["gpt_tok_embed_weight"], mt.nd.NDArray) and not aux
    assert mt.models.gpt_decode_config(sym) == {"num_heads": 4, "window": 0}
    prompts = fx.prompts(2, seed=5)
    want = _serve(mx.serve.Engine(params, symbol=ref_sym, **ENGINE_KW),
                  prompts)
    eng = mt.serve.Engine(args, symbol=sym, device="cpu", **ENGINE_KW)
    assert _serve(eng, prompts) == want


def test_draft_symbol_spec_tokens_equal_reference():
    """A one-layer draft (the target's first layer) whose decode config
    comes from its own one-layer symbol."""
    ref_sym, port_sym = _symbols("gpt2")
    ref_draft_sym, port_draft_sym = _symbols("gpt2", num_layers=1)
    params = fx.ref_params(fx.ref_net("gpt2"))
    draft = {k: v for k, v in params.items() if not k.startswith("gpt_l1_")}
    prompts = fx.prompts(3, seed=9)
    want = _serve(mx.serve.Engine(params, symbol=ref_sym, spec_k=3,
                                  draft_params=draft,
                                  draft_symbol=ref_draft_sym, **ENGINE_KW),
                  prompts)
    eng = mt.serve.Engine(params, symbol=port_sym, spec_k=3,
                          draft_params=draft, draft_symbol=port_draft_sym,
                          device="cpu", **ENGINE_KW)
    assert eng._spec is not None
    got = _serve(eng, prompts)
    assert got == want
    assert eng.stats().spec_verifies > 0
    plain = mt.serve.Engine(params, symbol=port_sym, device="cpu",
                            **ENGINE_KW)
    assert _serve(plain, prompts) == got


@pytest.mark.parametrize("kw,match", [
    (dict(num_heads=2), "num_heads=2 contradicts"),
    (dict(window=4), "window=4 contradicts"),
    (dict(spec_k=2, draft_num_heads=2), "num_heads=2 contradicts"),
    (dict(spec_k=2, draft_window=3), "window=3 contradicts")])
def test_contradicting_config_raises(kw, match):
    _, port_sym = _symbols("gpt2")
    params = fx.ref_params(fx.ref_net("gpt2"))
    draft = {k: v for k, v in params.items() if not k.startswith("gpt_l1_")}
    if "spec_k" in kw:
        kw = dict(kw, draft_params=draft, draft_symbol=port_sym)
    with pytest.raises(ValueError, match=match):
        mt.serve.Engine(params, symbol=port_sym, device="cpu", **ENGINE_KW,
                        **kw)


def test_symbol_without_decode_config_raises():
    with mt.sym.NameManager():
        plain = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4)
    with pytest.raises(ValueError, match="__gpt_num_heads__"):
        mt.models.gpt_decode_config(plain)
    params = fx.ref_params(fx.ref_net("gpt2"))
    with pytest.raises(ValueError, match="__gpt_num_heads__"):
        mt.serve.Engine(params, symbol=plain, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="num_heads is required"):
        mt.serve.Engine(params, device="cpu", **ENGINE_KW)


def test_decode_config_matches_reference():
    for variant, window in (("gpt2", 0), ("llama", 7)):
        ref_sym, port_sym = _symbols(variant, attn_window=window)
        assert (mt.models.gpt_decode_config(port_sym)
                == mx.models.gpt_decode_config(ref_sym)
                == {"num_heads": 4, "window": window})
        assert (mt.models.reconcile_decode_config(port_sym, None, None)
                == mx.models.generate.reconcile_decode_config(ref_sym, None,
                                                              None))


def test_gpt_generate_symbol_and_its_warning():
    ref_sym, port_sym = _symbols("llama", attn_window=5)
    params = fx.ref_params(fx.ref_net("llama"))
    prompt = fx.prompts(1, seed=3)[0][None]
    want = np.asarray(mx.models.gpt_generate(params, prompt, 8,
                                             symbol=ref_sym))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = mt.models.gpt_generate(params, prompt, 8, symbol=port_sym,
                                     device="cpu")
        explicit = mt.models.gpt_generate(params, prompt, 8, num_heads=4,
                                          window=5, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(explicit, want)
    with pytest.warns(UserWarning, match="window not given"):
        full = mt.models.gpt_generate(params, prompt, 8, num_heads=4,
                                      device="cpu")
    with pytest.warns(UserWarning, match="window not given"):
        ref_full = mx.models.gpt_generate(params, prompt, 8, num_heads=4)
    np.testing.assert_array_equal(full, np.asarray(ref_full))
    with pytest.raises(ValueError, match="contradicts"):
        mt.models.gpt_generate(params, prompt, 8, symbol=port_sym,
                               window=0, device="cpu")

"""The serving engine's program layer (``serve/engine.py`` ``_Program``).

A program owns one int32 device buffer whose views are its inputs,
staged from one host buffer, and runs one body: on the CPU it calls the
body on those buffers, on CUDA it replays the graph it captured once.
The CPU tests hold the staging, padding and output path that both
devices share; the ``cuda`` test shows that a body reading a device value
on the host cannot be captured, and that the program then raises
instead of running the body eagerly.  This file imports no JAX, so the
``cuda`` test runs on the card as it stands.
"""

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.serve import engine as port_engine

ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=64,
                 max_prefills_per_step=2)


def _params():
    return mt.models.gpt_params(53, 96, num_layers=2, d_model=32,
                                num_heads=4, seed=3, scale=0.35)


def _engine(device="cpu", **kw):
    return mt.serve.Engine(_params(), num_heads=4, device=device,
                           **{**ENGINE_KW, **kw})


def test_program_stages_one_buffer_and_runs_its_body():
    seen = []

    def body(a, b):
        seen.append((a.clone(), b.clone()))
        return (a.sum() + b.sum(dim=1)).to(torch.int32)

    prog = port_engine._Program((("a", (3,)), ("b", (2, 4))), body,
                                torch.device("cpu"))
    assert not prog.captured and prog.calls == 0
    h = prog.stage()
    h["a"][:] = [1, 2, 3]
    h["b"][1, :2] = [10, 20]
    assert prog() == [6, 36]
    # the inputs are views of one device buffer, in field order
    assert seen[0][0].tolist() == [1, 2, 3]
    assert seen[0][1].tolist() == [[0, 0, 0, 0], [10, 20, 0, 0]]
    assert prog._inputs["b"].data_ptr() \
        == prog._inputs["a"].data_ptr() + 3 * 4
    # stage() zeroes every field: padding reads the null block
    h = prog.stage()
    assert not any(v.any() for v in h.values())
    h["a"][0] = 5
    assert prog() == [5, 5] and prog.calls == 2


def test_decode_program_pads_rows_to_the_null_block():
    eng = _engine()
    rng = np.random.RandomState(3)
    for n in (5, 9, 7):
        eng.submit(rng.randint(0, 53, (n,)).astype(np.int32),
                   max_new_tokens=6)
    for _ in range(3):
        eng.step()
    prog = eng._programs[("decode", 4)]
    h = prog._views
    live = [r for r in eng.scheduler.running]
    assert len(live) == 3 and prog.calls >= 1
    assert h["tables"].shape == (4, eng.table_width)
    assert h["toks"][3] == h["pos"][3] == 0 and not h["tables"][3].any()
    for i, r in enumerate(live):
        assert h["pos"][i] == r.cache_len - 1   # staged before the step
        t = eng.blocks.table(r.rid)
        assert list(h["tables"][i, :len(t)]) == t
        assert not h["tables"][i, len(t):].any()
    eng.run()
    eng.shutdown()
    assert eng._programs == {}


@pytest.mark.parametrize("window", [0, 3])
def test_prefill_logits_take_an_int_or_a_device_plen(window):
    eng = _engine()
    n, P = 11, 16
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, 53, P)
                            .astype(np.int32))
    blk = torch.arange(P) // 4 + 1
    off = torch.arange(P) % 4
    cfg = eng._cfg._replace(window=window)
    with torch.no_grad():
        a = port_engine._prefill_logits(cfg, P, eng.params,
                                        eng._cache_k.clone(),
                                        eng._cache_v.clone(), toks, n, blk,
                                        off)
        b = port_engine._prefill_logits(cfg, P, eng.params,
                                        eng._cache_k.clone(),
                                        eng._cache_v.clone(), toks,
                                        torch.tensor([n], dtype=torch.int32),
                                        blk, off)
    assert a.shape == b.shape == (1, 53)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_capture_of_a_host_read_raises_without_eager_retreat(
        monkeypatch):
    """A program body that reads a device value on the host (``.item()``)
    cannot be captured: the program raises, and nothing runs the body
    eagerly in its place, alone or inside the engine."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA-graph capture exists only on the "
                    "card; chip_smoke.py serves through captured graphs")
    calls = []

    def body(x):
        calls.append(1)
        return x + int(x.sum().item())

    with pytest.raises(RuntimeError):
        port_engine._Program((("x", (4,)),), body, torch.device("cuda"),
                             torch.cuda.graph_pool_handle())
    # the warm-up runs, then the failed capture; no eager call after it
    assert len(calls) == port_engine._WARM_RUNS + 1

    eng = _engine("cuda")
    decode = port_engine._decode

    def reading(cfg, toks, pos, tables, **kw):
        calls.append(int(pos.max().item()))
        return decode(cfg, toks, pos, tables, **kw)

    monkeypatch.setattr(port_engine, "_decode", reading)
    req = eng.submit(np.arange(9, dtype=np.int32), max_new_tokens=4)
    with pytest.raises(RuntimeError):
        eng.run()
    assert len(req.tokens) == 1           # the prefill's token only
    assert ("decode", 1) not in eng._programs
    assert eng.captures == 1              # the prefill program's graph

"""The port's export store (``mxnet_tpu_torch/aot/export_store.py``,
``Engine(aot_dir=)``) against the JAX reference's
(``mxnet_tpu/aot/export_store.py``; ``tests/test_aot.py``'s store and
restart gates).

An artifact is a ``torch.export`` program of one (kind, bucket) body,
with parameters, caches and adapter stacks as inputs.  The gates: a
store round trip, with stale, corrupt and truncated artifacts each
costing a counted trace and never a token; a cold engine that exports
and a warm one that loads every program of the cold one's manifest with
no fresh trace (its ``_token_layers`` made to raise, so nothing traces),
both giving the reference engine's tokens; the loaded decode program
writing its cache in place (a functionalized export does not, and the
engine refuses it); and the same restart with sampling, int8 K/V and
adapters on.  CPU, tiny models.
"""

import io
import json
import os
import shutil
import zipfile

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import aot as port_aot
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.aot import export_store
from mxnet_tpu_torch.serve import engine as port_engine

# small grids: two prompts prefilled in one step in one bucket, then
# decoded together: two programs
KW = dict(block_size=4, num_blocks=64, max_batch=2, max_model_len=32,
          prefix_cache=False, prefill_chunk=0, max_prefills_per_step=2)
PROMPT_LENS = (11, 14)
MAX_NEW = 6


@pytest.fixture(autouse=True)
def tel():
    telemetry.reset()
    telemetry.enable()
    yield
    telemetry.disable()
    telemetry.reset()


def _total(name, **labels):
    snap = telemetry.registry().snapshot().get(name, {"samples": []})
    return sum(s["value"] for s in snap["samples"]
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _traces():
    return _total("mxtpu_aot_programs_total", source="trace")


def _artifacts():
    return _total("mxtpu_aot_programs_total", source="artifact")


def _prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(0, fx.VOCAB, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _port(model, **kw):
    _, params, heads = model
    return mt.serve.Engine(params, num_heads=heads, device="cpu",
                           **{**KW, **kw})


def _serve(eng, prompts=None, **sub):
    reqs = [eng.submit(p, max_new_tokens=MAX_NEW, **sub)
            for p in (prompts or _prompts())]
    eng.run()
    assert all(r.status == "finished" for r in reqs)
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def llama():
    return fx.model("llama")


@pytest.fixture(scope="module")
def cold_store(llama, tmp_path_factory):
    """One cold llama engine's store, manifest and tokens (shared: each
    test damages or reads a copy)."""
    telemetry.reset()
    d = str(tmp_path_factory.mktemp("cold") / "aot")
    eng = _port(llama, aot_dir=d)
    toks = _serve(eng)
    man = eng.manifest()
    eng.shutdown()
    return d, man, toks


def _copy(store, tmp_path):
    d = str(tmp_path / "aot")
    shutil.copytree(store, d)
    return d


# -- the store ---------------------------------------------------------------
class _Tanh(torch.nn.Module):
    def forward(self, x):
        return torch.tanh(x @ x)


def test_store_roundtrip_stale_and_corrupt(tmp_path):
    """tests/test_aot.py's store gate: missing is a silent None; a
    saved program loads and runs; a header of another fingerprint is
    stale and a truncated blob corrupt, each a counted None."""
    store = port_aot.ExportStore(str(tmp_path / "aot"))
    fp = export_store.fingerprint(subsystem="t", bucket=4)
    assert fp["format"] == "mxtpu_torch.aot.v1"
    assert fp["device"] == "cpu" and fp["torch_version"] == torch.__version__
    assert store.load(fp) is None and store.entries() == []
    x = torch.ones(8, 8)
    ep = torch.export.export(_Tanh(), (x,))
    path = store.save(fp, ep)
    assert path and os.path.exists(path) and path.endswith(".ptexport")
    assert store.entries() == [(path, os.path.getsize(path))]
    loaded = store.load(fp)
    torch.testing.assert_close(loaded.module()(x), torch.tanh(x @ x))
    assert _total("mxtpu_aot_saves_total") == 1
    assert _total("mxtpu_aot_loads_total") == 1
    # stale: rewrite the header in place under another fingerprint
    raw = open(path, "rb").read()
    n = int.from_bytes(raw[8:16], "little")
    other = json.dumps({"fingerprint": dict(fp, bucket=8)},
                       sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(raw[:8] + len(other).to_bytes(8, "little") + other
                + raw[16 + n:])
    assert store.load(fp) is None
    assert _total("mxtpu_aot_errors_total", kind="stale") == 1
    # corrupt: a truncated blob loads as None, never raises
    store.save(fp, ep)
    with open(path, "wb") as f:
        f.write(open(path, "rb").read()[:60])
    assert store.load(fp) is None
    assert _total("mxtpu_aot_errors_total", kind="corrupt") == 1


def test_default_store_follows_env(monkeypatch, tmp_path, llama):
    monkeypatch.delenv(export_store.ENV_DIR, raising=False)
    assert export_store.default_store() is None
    monkeypatch.setenv(export_store.ENV_DIR, str(tmp_path))
    assert export_store.default_store().dir == str(tmp_path)
    eng = _port(llama)
    assert eng.statusz()["aot"] == {"dir": str(tmp_path), "artifacts": 0,
                                    "bytes": 0}
    eng.shutdown()


def test_program_fingerprint_keys_kind_bucket_and_config(llama, tmp_path):
    eng = _port(llama, aot_dir=str(tmp_path))
    fp = eng._aot_fp("decode", 2)
    assert fp["format"] == export_store.FORMAT
    assert (fp["kind"], fp["bucket"]) == ("decode", 2)
    assert "tp" not in fp and "quantize" not in fp
    digests = {export_store.digest(eng._aot_fp(k, b))
               for k, b in (("decode", 1), ("decode", 2), ("prefill", 2))}
    other = _port(llama, aot_dir=str(tmp_path), num_blocks=48)
    digests.add(export_store.digest(other._aot_fp("decode", 2)))
    assert len(digests) == 4
    eng.shutdown()
    other.shutdown()


# -- the restart gates -------------------------------------------------------
def _no_trace(monkeypatch):
    """Any body traced from now on raises: a warm engine that serves
    traced nothing."""
    def boom(*a, **k):
        raise AssertionError("a program body was traced")

    for name in ("_token_layers", "_dense_logits"):
        monkeypatch.setattr(port_engine, name, boom)


def test_cold_warm_restart_zero_fresh_traces(llama, cold_store, tmp_path,
                                             monkeypatch):
    """tests/test_aot.py's acceptance gate: the warm engine's
    ``warmup(manifest)`` loads every program of the cold one's manifest
    (``source="artifact"``), traces none, and serves the cold engine's
    tokens, which are the reference engine's."""
    store, man, toks_cold = cold_store
    d = _copy(store, tmp_path)
    assert len(port_aot.ExportStore(d).entries()) == len(man) >= 2
    net, params, _ = llama
    ref = mx.serve.Engine(params, symbol=net, **KW)
    assert _serve(ref) == toks_cold
    ref.shutdown()
    _no_trace(monkeypatch)
    warm = _port(llama, aot_dir=d)
    assert warm.warmup(man) == len(man)
    assert _traces() == 0
    assert _artifacts() == len(man)
    assert _total("mxtpu_aot_loads_total") == len(man)
    assert _serve(warm) == toks_cold
    assert _traces() == 0
    aot = warm.statusz()["aot"]
    assert aot["dir"] == d and aot["artifacts"] == len(man)
    assert aot["bytes"] > 0
    warm.shutdown()


@pytest.mark.parametrize("damage", ["truncated", "corrupt", "stale"])
def test_damaged_artifacts_cost_a_counted_trace(llama, cold_store,
                                                tmp_path, damage):
    """A torn, mangled or foreign artifact (the decode program's) costs a
    fresh trace (counted by kind), never a token; the others load."""
    store, man, toks_cold = cold_store
    d = _copy(store, tmp_path)
    probe = _port(llama, aot_dir=d)
    bucket = max(e["bucket"] for e in man if e["kind"] == "decode")
    damaged = probe._aot.path_for(probe._aot_fp("decode", bucket),
                                  label=f"serve-decode{bucket}")
    probe.shutdown()
    for path, _ in port_aot.ExportStore(d).entries():
        if path != damaged:
            continue
        raw = open(path, "rb").read()
        n = int.from_bytes(raw[8:16], "little")
        if damage == "truncated":
            raw = raw[:len(raw) // 2]
        elif damage == "corrupt":
            raw = raw[:16 + n] + b"\0" * (len(raw) - 16 - n)
        else:
            hdr = json.loads(raw[16:16 + n])
            hdr["fingerprint"]["num_blocks"] = 48
            other = json.dumps(hdr, sort_keys=True).encode()
            raw = raw[:8] + len(other).to_bytes(8, "little") + other \
                + raw[16 + n:]
        with open(path, "wb") as f:
            f.write(raw)
    eng = _port(llama, aot_dir=d)
    assert eng.warmup(man) == len(man)
    kind = "stale" if damage == "stale" else "corrupt"
    assert _total("mxtpu_aot_errors_total", kind=kind) == 1
    assert _traces() == 1 and _artifacts() == len(man) - 1
    assert _serve(eng) == toks_cold
    eng.shutdown()
    # the fresh trace was written through: the next start loads it
    again = _port(llama, aot_dir=d)
    again.warmup([{"kind": "decode", "bucket": bucket}])
    assert _traces() == 1 and _artifacts() == len(man)
    again.shutdown()


def test_loaded_decode_writes_its_cache_in_place(llama, cold_store,
                                                 tmp_path):
    """Walk the loaded decode program's graph: no copy, clone or
    out-of-place index write of a cache-sized tensor.  The same body
    exported and decomposed (functionalized) copies its caches, fails
    the check, and the engine refuses it (a counted trace)."""
    store, man, toks_cold = cold_store
    d = _copy(store, tmp_path)
    eng = _port(llama, aot_dir=d)
    bucket = max(e["bucket"] for e in man if e["kind"] == "decode")
    fp = eng._aot_fp("decode", bucket)
    label = f"serve-decode{bucket}"
    ep = port_aot.ExportStore(d).load(fp, label=label)
    module = ep.module()
    numel = eng._cache_k[0].numel()
    assert export_store.cache_copies(module, numel) == []
    writes = [n for n in module.graph.nodes if n.op == "call_function"
              and "index_put_" in str(n.target)]
    assert len(writes) == 2 * eng._cfg.n_layers        # K and V, each layer
    flat = ep.run_decompositions()
    assert export_store.cache_copies(flat.module(), numel) != []
    port_aot.ExportStore(d).save(fp, flat, label=label)
    eng.shutdown()
    eng = _port(llama, aot_dir=d)
    eng.warmup([{"kind": "decode", "bucket": bucket}])
    assert _total("mxtpu_aot_errors_total", kind="inplace") == 1
    assert _traces() == 1 and _artifacts() == 0
    eng.shutdown()


def test_unexportable_body_runs_traced_and_counted(llama, tmp_path,
                                                   monkeypatch):
    """A body ``torch.export`` refuses runs as traced, counted as an
    ``export`` error (the reference's rule), and saves nothing."""
    def refuse(*a, **k):
        raise RuntimeError("export refused")

    monkeypatch.setattr(torch.export, "export", refuse)
    eng = _port(llama, aot_dir=str(tmp_path))
    toks = _serve(eng)
    n = len(eng.manifest())
    assert _total("mxtpu_aot_errors_total", kind="export") == n
    assert _traces() == n and eng._aot.entries() == []
    eng.shutdown()
    monkeypatch.undo()
    plain = _port(llama)
    assert _serve(plain) == toks
    plain.shutdown()


def _adapter(eng, seed=1):
    rng = np.random.RandomState(seed)
    arrays = {stem: (rng.randn(2, din).astype(np.float32) * 0.3,
                     rng.randn(dout, 2).astype(np.float32) * 0.3)
              for stem, (dout, din) in eng.adapter_store.stems.items()}
    eng.adapter_store.register("a1", arrays, alpha=4.0)


@pytest.mark.parametrize("mode", ["sampling", "int8_kv", "adapters"])
def test_restart_with_feature_on(llama, tmp_path, monkeypatch, mode):
    """The restart gate with sampling (seeded: the same draws), int8 K/V
    and adapters (an adapter row beside a base row) on."""
    kw, sub = {}, {}
    if mode == "sampling":
        kw = dict(sampling=True, seed=3)
        sub = dict(temperature=0.8, top_k=5)
    elif mode == "int8_kv":
        kw = dict(kv_dtype="int8")
    else:
        kw = dict(adapters=3, adapter_rank=2)
    d = str(tmp_path / "aot")

    def serve(eng):
        if mode != "adapters":
            return _serve(eng, **sub)
        _adapter(eng)
        p = _prompts()
        reqs = [eng.submit(p[0], max_new_tokens=MAX_NEW, adapter_id="a1"),
                eng.submit(p[1], max_new_tokens=MAX_NEW)]
        eng.run()
        return [list(r.tokens) for r in reqs]

    cold = _port(llama, aot_dir=d, **kw)
    toks = serve(cold)
    man = cold.manifest()
    cold.shutdown()
    traces = _traces()
    _no_trace(monkeypatch)
    warm = _port(llama, aot_dir=d, **kw)
    assert warm.warmup(man) == len(man) and _artifacts() == len(man)
    assert serve(warm) == toks
    assert _traces() == traces
    warm.shutdown()


def test_exported_program_holds_no_weights(llama, cold_store):
    """The artifact is the program: parameters, caches and stacks are
    inputs, so no artifact holds the checkpoint's bytes."""
    store, man, _ = cold_store
    for path, _ in port_aot.ExportStore(store).entries():
        raw = open(path, "rb").read()
        blob = raw[16 + int.from_bytes(raw[8:16], "little"):]
        # the archive's weights, constants and sample inputs are empty:
        # the graph is all it holds
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            data = {i.filename: i.file_size for i in z.infolist()
                    if "/data/" in i.filename}
        assert data and max(data.values()) < 64, data
    ep = torch.export.load(io.BytesIO(blob))
    assert not ep.state_dict and not ep.constants
    assert ep.example_inputs is None
    names = [s.arg.name for s in ep.graph_signature.input_specs]
    assert any("params" in n for n in names)
    assert any("ck" in n for n in names)

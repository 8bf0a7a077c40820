"""The port's warm start (``mxnet_tpu_torch/aot``, ``Engine.warmup``)
against the JAX reference's (``mxnet_tpu/aot/warmup.py``,
``mxnet_tpu.serve.Engine.warmup``).

The manifest lines, their dedup, torn-line skip and env resolution are
the reference's, so either package's recorder writes a file the other's
loader reads.  The engine's warmup grid is the reference's for the same
config, bucket for bucket, and after ``warmup()`` traffic builds no new
program (on CUDA: captures no new graph) while emitting the reference's
tokens.  CPU, tiny models.
"""

import os

import numpy as np
import pytest
import torch

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)
from test_torch_engine import ENGINE_KW, _assert_same_streams

import mxnet_tpu as mx
from mxnet_tpu import aot as ref_aot
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import aot as port_aot

PKGS = {"ref": ref_aot, "port": port_aot}


@pytest.fixture(scope="module")
def gpt2():
    return fx.model("gpt2")


def _ref(model, **kw):
    net, params, _ = model
    return mx.serve.Engine(params, symbol=net, **{**ENGINE_KW, **kw})


def _port(model, **kw):
    _, params, heads = model
    return mt.serve.Engine(params, num_heads=heads, window=0, device="cpu",
                           **{**ENGINE_KW, **kw})


def _prompts():
    rng = np.random.RandomState(7)
    return [rng.randint(0, fx.VOCAB, (n,)).astype(np.int32)
            for n in (7, 12, 5)]


def _serve(eng, prompts, max_new=8):
    reqs = [eng.submit(p, max_new_tokens=max_new) for p in prompts]
    eng.run()
    assert all(r.status == "finished" for r in reqs)
    return reqs


# -- manifests ---------------------------------------------------------------
def _recorder_scenario(aot, path, monkeypatch):
    """tests/test_aot.py's recorder/loader scenario, on one package."""
    out = {}
    rec = aot.ManifestRecorder("spec-a", path)
    out["first"] = rec.record("prefill", 16)
    out["again"] = rec.record("prefill", 16)          # deduped
    rec.record("decode", 4)
    out["entries"] = rec.entries()
    aot.ManifestRecorder("spec-b", path).record("decode", 8)
    with open(path, "a") as f:
        f.write("not json\n")                          # torn tail line
    out["all"] = aot.load_manifest(path)
    out["mine"] = aot.load_manifest(path, spec_digest="spec-a")
    monkeypatch.setenv(aot.warmup.ENV_MANIFEST, path)
    out["env"] = aot.load_manifest(None)
    monkeypatch.delenv(aot.warmup.ENV_MANIFEST)
    out["unset"] = aot.load_manifest(None)
    out["absent"] = aot.load_manifest(path + ".absent")
    with open(path) as f:
        out["file"] = f.read()
    return out


def test_recorder_and_loader_match_reference(tmp_path, monkeypatch):
    got = {k: _recorder_scenario(a, str(tmp_path / f"{k}.jsonl"),
                                 monkeypatch)
           for k, a in PKGS.items()}
    assert got["port"] == got["ref"]
    port = got["port"]
    assert port["first"] is True and port["again"] is False
    assert [e["bucket"] for e in port["entries"]] == [16, 4]
    assert len(port["all"]) == 3 and len(port["env"]) == 3
    assert [(e["kind"], e["bucket"]) for e in port["mine"]] \
        == [("prefill", 16), ("decode", 4)]
    assert port["unset"] == [] and port["absent"] == []


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_loads_the_others_manifest(tmp_path, writer, reader):
    path = str(tmp_path / "m.jsonl")
    rec = PKGS[writer].ManifestRecorder("spec-w", path)
    for kind, bucket in (("decode", 2), ("prefill", 8), ("chunk", 4),
                         ("decode", 2)):
        rec.record(kind, bucket)
    want = [{"kind": k, "bucket": b}
            for k, b in (("decode", 2), ("prefill", 8), ("chunk", 4))]
    load = PKGS[reader].load_manifest
    assert load(path) == want
    assert load(path, spec_digest="spec-w") == want
    assert load(path, spec_digest="other") == []
    assert load(rec.entries()) == want


def test_fingerprint_digest_pins_the_program_key(gpt2):
    a, b = _port(gpt2), _port(gpt2)
    assert a._spec_digest == b._spec_digest
    fp = a._fingerprint()
    assert fp["device"] == "cpu" and fp["torch_version"]
    assert fp["cfg"]["paged_impl"] == "torch"
    assert port_aot.digest(fp) == port_aot.digest(dict(fp))
    for kw in (dict(num_blocks=48), dict(max_model_len=32),
               dict(block_size=8), dict(dtype=torch.bfloat16)):
        assert _port(gpt2, **kw)._spec_digest != a._spec_digest, kw


# -- the engine's warmup -----------------------------------------------------
@pytest.mark.parametrize("kw,n", [
    (dict(max_batch=2, max_model_len=16), 12),
    (dict(max_batch=3, max_model_len=24), 15),
    (dict(max_batch=4, max_model_len=64, prefill_chunk=8), 14)])
def test_warmup_grid_equals_reference(gpt2, kw, n):
    port = _port(gpt2, **kw)
    assert port._warmup_grid() == _ref(gpt2, **kw)._warmup_grid()
    assert port.warmup() == n == len(port._programs)
    assert sorted(port._programs) == sorted(
        (e["kind"], e["bucket"]) for e in port._warmup_grid())
    assert port.manifest() == []          # warmup never records
    assert port.captures == 0             # CPU: nothing captured


def test_warmup_range_and_kind_checks(gpt2):
    """Out-of-range and unknown entries are skipped, as the reference
    skips them; a spec-less hand-written grid replays in both."""
    junk = [{"kind": "decode", "bucket": 99},
            {"kind": "prefill", "bucket": 1000},
            {"kind": "chunk", "bucket": 1000},
            {"kind": "mystery", "bucket": 2},
            {"kind": "verify", "bucket": 2},
            {"kind": "decode", "bucket": 2}]
    kw = dict(max_batch=2, max_model_len=16)
    port = _port(gpt2, **kw)
    assert port.warmup(junk) == _ref(gpt2, **kw).warmup(junk) == 1
    assert list(port._programs) == [("decode", 2)]
    grid = [{"kind": "decode", "bucket": 3}, {"kind": "prefill", "bucket": 5},
            {"kind": "chunk", "bucket": 16}]
    kw["max_batch"] = 4
    port = _port(gpt2, **kw)
    assert port.warmup(grid) == _ref(gpt2, **kw).warmup(grid) == 3
    assert sorted(port._programs) == [("chunk", 16), ("decode", 4),
                                      ("prefill", 8)]


def test_foreign_manifest_is_skipped(gpt2, tmp_path):
    path = str(tmp_path / "m.jsonl")
    eng = _port(gpt2)
    _serve(eng, _prompts())
    eng.save_manifest(path)
    assert _port(gpt2, num_blocks=48).warmup(path) == 0
    assert _port(gpt2).warmup(path) == len(eng.manifest()) >= 2


def test_engine_records_manifest_to_env_path(gpt2, tmp_path, monkeypatch):
    path = str(tmp_path / "traffic.jsonl")
    monkeypatch.setenv(port_aot.ENV_MANIFEST, path)
    eng = _port(gpt2)
    _serve(eng, _prompts())
    eng.shutdown()
    on_disk = port_aot.load_manifest(path)
    assert sorted((e["kind"], e["bucket"]) for e in on_disk) \
        == sorted((e["kind"], e["bucket"]) for e in eng.manifest())
    assert len(on_disk) >= 3
    # warmup() with no argument replays the env manifest, and replay
    # must not re-append what it just read
    size = os.path.getsize(path)
    eng2 = _port(gpt2)
    assert eng2.warmup() == len(on_disk)
    assert os.path.getsize(path) == size
    eng2.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng2.warmup()


@pytest.mark.parametrize("how", ["manifest", "path", "grid"])
def test_warm_restart_builds_nothing_and_matches(gpt2, tmp_path, how):
    """The reference's cold/warm restart gate: engine A serves and hands
    its manifest on; engine B warms from it (or the full grid), then
    serves the same prompts building zero new programs, with A's tokens
    and the reference engine's."""
    prompts = _prompts()
    cold = _port(gpt2)
    toks_cold = _serve(cold, prompts)
    built = len(cold._programs)
    assert built >= 3
    src = {"manifest": cold.manifest(),
           "path": cold.save_manifest(str(tmp_path / "m.jsonl")),
           "grid": None}[how]
    cold.shutdown()
    assert cold._programs == {}
    warm = _port(gpt2)
    ready = warm.warmup(src)
    assert ready == (built if how != "grid" else len(warm._warmup_grid()))
    n = len(warm._programs)
    toks_warm = _serve(warm, prompts)
    assert len(warm._programs) == n       # zero fresh programs
    ref_toks = _serve(_ref(gpt2), prompts)
    _assert_same_streams(gpt2, 0, prompts, toks_cold, toks_warm)
    _assert_same_streams(gpt2, 0, prompts, ref_toks, toks_warm)

"""The PyTorch port's per-program performance attribution
(``mxnet_tpu_torch/telemetry/perf_attrib.py`` and its engine wiring)
against the JAX reference.

Ports ``tests/test_perf_attrib.py``'s engine cases:

  * cost table: after ``warmup()`` every program family (prefill, chunk,
    decode, draft, draft_chunk, verify, restore) is in the ``/statusz``
    perf section, each entry the reference engine's ``_analytic_cost``
    for the same config and bucket, exactly (the same closed forms):
    non-zero flops for every family but ``restore``, a pure copy, whose
    bytes are its entry (and so the only MBU numerator);
  * inertness: ``MXTPU_PERF_ATTRIB`` / ``MXTPU_PERF_ATTRIB_SAMPLE`` in
    any combination leave greedy tokens, ``_spec_digest`` and the
    program grid identical; sampling off records no timing;
  * three views agree: the statusz per-program sampled counts, the
    ``mxtpu_serve_program_seconds{kind,bucket}`` histogram counts and
    ``tools/metrics_report.py``'s rows; ``perf_summary()`` agrees with
    the statusz section.

On the CPU the host clock times a sampled call; the CUDA-event timing
of a captured graph is held by ``tests/test_torch_capture.py``'s
``cuda`` case and by ``chip_smoke.py``'s ``serve_telemetry`` phase.
"""

import os
import sys

import numpy as np
import pytest

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.telemetry as port_tel
from mxnet_tpu_torch.telemetry import perf_attrib

sys.path.insert(0, os.path.join(fx.REPO, "tools"))

VOCAB = fx.VOCAB
ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=32,
                 max_prefills_per_step=2)
ALL_FAMILIES = {"prefill", "chunk", "decode", "draft", "draft_chunk",
                "verify", "restore"}


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    for k in (perf_attrib.ENV_ENABLE, perf_attrib.ENV_SAMPLE):
        monkeypatch.delenv(k, raising=False)
    port_tel.disable()
    port_tel.reset()
    yield
    port_tel.disable()
    port_tel.reset()


@pytest.fixture(scope="module")
def model():
    _, params, heads = fx.model("gpt2")
    return params, heads


def _draft(params):
    return {k: v for k, v in params.items() if not k.startswith("gpt_l1_")}


def _engine(model, ref=False, **kw):
    params, heads = model
    kw = {**ENGINE_KW, **kw}
    if ref:
        return mx.serve.Engine(params, num_heads=heads, **kw)
    return mt.serve.Engine(params, num_heads=heads, device="cpu", **kw)


def _prompts(n=3, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (4 + 2 * i,)).astype(np.int32)
            for i in range(n)]


def _serve(eng, prompts, tokens=6):
    reqs = [eng.submit(p, max_new_tokens=tokens) for p in prompts]
    eng.run()
    assert all(r.status == "finished" for r in reqs)
    return [tuple(r.tokens) for r in reqs]


@pytest.mark.parametrize("variant", ["gpt2", "llama"])
def test_cost_table_all_families_equal_reference_analytic(variant):
    """After warmup every family this config can run is in the perf
    cost table, each (kind, bucket) holding exactly the reference
    engine's analytic (flops, bytes); no traffic, no timing."""
    _, params, heads = fx.model(variant)
    kw = dict(spec_k=2, draft_params=_draft(params), draft_num_heads=heads,
              draft_window=0, host_kv_bytes=1 << 24)
    eng = _engine((params, heads), **kw)
    ref = _engine((params, heads), ref=True, **kw)
    try:
        assert eng.warmup() > 0
        perf = eng.statusz()["perf"]
        assert perf is not None and perf["enabled"]
        rows = perf["programs"]
        assert {r["kind"] for r in rows} == ALL_FAMILIES
        assert {(r["kind"], r["bucket"]) for r in rows} == {
            (e["kind"], e["bucket"]) for e in eng._warmup_grid()}
        for r in rows:
            flops, nbytes = ref._analytic_cost(r["kind"], r["bucket"])
            assert (r["flops"], r["bytes_accessed"]) == (flops, nbytes), r
            if r["kind"] == "restore":
                assert r["flops"] is None and r["bytes_accessed"] > 0, r
                assert r["source"] is None
            else:
                assert r["flops"] > 0 and r["bytes_accessed"] is None, r
                assert r["source"] == "analytic"
            assert r["sampled"] == 0 and r["mean_s"] is None, r
            assert r["dispatches"] == 0
        assert perf["sampled_steps"] == 0
        assert perf["peak_flops_per_chip"] is None      # the CPU
        assert eng.perf_summary()["sampled"] == 0
    finally:
        eng.shutdown()
        ref.shutdown()


def test_cost_table_fills_on_a_replayed_manifest(model):
    """A warm start from another engine's manifest fills the cost table
    for every program it warms, before any traffic."""
    cold = _engine(model)
    _serve(cold, _prompts())
    manifest = cold.manifest()
    want = {(r["kind"], r["bucket"]): r["flops"]
            for r in cold.statusz()["perf"]["programs"]}
    cold.shutdown()
    warm = _engine(model)
    assert warm.warmup(manifest) == len(manifest)
    got = {(r["kind"], r["bucket"]): r["flops"]
           for r in warm.statusz()["perf"]["programs"]}
    assert got == want and all(f > 0 for f in got.values())
    warm.shutdown()


def test_sampling_and_kill_switch_inert(model, monkeypatch):
    prompts = _prompts()
    base = _engine(model)
    toks = _serve(base, prompts)
    digest, grid = base._spec_digest, sorted(base._programs)
    perf = base.statusz()["perf"]
    assert perf["sampled_steps"] == 0 and perf["tokens"] > 0
    assert all(r["sampled"] == 0 for r in perf["programs"])
    assert sum(r["dispatches"] for r in perf["programs"]) == sum(
        p.calls for p in base._programs.values())
    base.shutdown()

    monkeypatch.setenv(perf_attrib.ENV_SAMPLE, "1")
    sampled = _engine(model)
    assert _serve(sampled, prompts) == toks
    assert sampled._spec_digest == digest
    assert sorted(sampled._programs) == grid
    perf = sampled.statusz()["perf"]
    assert perf["sampled_steps"] > 0 and perf["sampled_tokens"] > 0
    assert perf["device_seconds"] > 0
    timed = [r for r in perf["programs"] if r["sampled"]]
    assert timed and all(r["mean_s"] > 0 for r in timed)
    assert sum(r["share"] for r in timed) == pytest.approx(1.0)
    # every call of a sampled step is timed: sample_every=1 times all
    for r in perf["programs"]:
        assert r["sampled"] == r["dispatches"]
    assert sampled.perf_summary()["sampled"] > 0
    sampled.shutdown()

    monkeypatch.setenv(perf_attrib.ENV_SAMPLE, "2")
    every2 = _engine(model)
    assert _serve(every2, prompts) == toks
    perf = every2.statusz()["perf"]
    assert 0 < perf["sampled_steps"] < every2._step_id
    every2.shutdown()

    monkeypatch.setenv(perf_attrib.ENV_ENABLE, "0")
    off = _engine(model)
    assert _serve(off, prompts) == toks
    assert off._spec_digest == digest
    assert off.statusz()["perf"] is None
    assert off.perf_summary() is None
    off.shutdown()


def test_three_view_agreement(model, monkeypatch):
    """statusz per-program sampled counts == the registry's
    mxtpu_serve_program_seconds{kind,bucket} histogram counts == the
    per-label rows metrics_report renders; perf_summary() == the
    section's summary columns."""
    import metrics_report

    port_tel.enable()
    monkeypatch.setenv(perf_attrib.ENV_SAMPLE, "1")
    eng = _engine(model)
    try:
        _serve(eng, _prompts())
        perf = eng.statusz()["perf"]
        by_label = {(r["kind"], str(r["bucket"])): r["sampled"]
                    for r in perf["programs"] if r["sampled"]}
        assert by_label
        snap = port_tel.snapshot()["metrics"]
        fam = snap["mxtpu_serve_program_seconds"]
        assert fam["kind"] == "histogram"
        hist = {(s["labels"]["kind"], s["labels"]["bucket"]): s["count"]
                for s in fam["samples"]}
        assert hist == by_label
        out = metrics_report.report(snap, "mxtpu_serve_program_seconds")
        rows = [ln for ln in out.splitlines()
                if ln.startswith("mxtpu_serve_program_seconds")]
        assert len(rows) == len(by_label)
        for kind, bucket in by_label:
            assert any(f"bucket={bucket},kind={kind}" in ln for ln in rows)
        summary = eng.perf_summary()
        assert summary["sampled"] == sum(by_label.values())
        for key in ("achieved_tflops", "mfu", "tok_flops",
                    "cost_per_1k_tokens_s"):
            assert summary[key] == perf[key], key
        gauge = snap["mxtpu_serve_cost_per_1k_tokens_seconds"]["samples"]
        assert gauge[0]["value"] == pytest.approx(
            perf["cost_per_1k_tokens_s"])
        tflops = {s["labels"]["kind"]: s["value"] for s in
                  snap["mxtpu_serve_achieved_tflops"]["samples"]}
        assert set(tflops) == {k for k, _ in by_label}
    finally:
        eng.shutdown()


def test_done_counts_without_timing_when_unarmed():
    """An unarmed call is a count and nothing else: t0() is None and no
    seconds are recorded (the CUDA path's event pair exists only on
    armed steps)."""
    pa = perf_attrib.PerfAttrib(clock=lambda: 1.0)
    assert pa.sample_every == 0 and pa._cuda is False
    pa.arm(1)
    t0 = pa.t0()
    assert t0 is None
    pa.done(t0, "decode", 4)
    pa.done(t0, "decode", 4)
    pa.on_step(8)
    st = pa.statusz()
    assert st["programs"][0]["dispatches"] == 2
    assert st["programs"][0]["sampled"] == 0 and st["device_seconds"] == 0
    assert st["tokens"] == 8

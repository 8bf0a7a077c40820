"""The PyTorch port's serving telemetry against the JAX reference's
(``mxnet_tpu_torch/serve/engine.py`` and ``telemetry/``).

The same traffic goes through the reference engine and the port engine
on one seeded checkpoint, with telemetry on in both packages, and the
views must agree: the same metric families with the same label sets
and equal counts wherever a count does not depend on time; the same
``/statusz`` sections, equal where their content does not depend on
time; the same request-trace timelines (preemption and both rejection
paths included); the same ``step`` flight records; the same flight
dumps with the same reasons (engine exception, deadline miss, rejection
rate, a NaN under ``MXTPU_NUMERIC_WATCH``, spec's low acceptance).
Every telemetry switch, alone and together, leaves the port's tokens,
``_spec_digest``, manifest and program grid as they are with telemetry
off; ``MXTPU_NUMERIC_WATCH`` alone changes the fingerprint.  The
reference's tools render the port's artifacts.

The reference's ``mxtpu_jax_*`` families (its ``jax.monitoring``
bridge) have no port counterpart on the CPU: the port's ``cudamon``
families count nvcc builds and CUDA-graph captures, which the CPU never
makes (``tests/test_torch_telemetry.py`` holds them).
"""

import gc
import json
import os
import sys
import urllib.request

import numpy as np
import pytest

import torch_port_fixtures as fx
from torch_port_fixtures import \
    collect_engines_after_module  # noqa: F401  (autouse)

import mxnet_tpu as mx
import mxnet_tpu.telemetry as ref_tel
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.telemetry as port_tel

sys.path.insert(0, os.path.join(fx.REPO, "tools"))

VOCAB = fx.VOCAB
PKGS = {"ref": ref_tel, "port": port_tel}
ENGINE_KW = dict(block_size=4, num_blocks=64, max_batch=4, max_model_len=64,
                 max_prefills_per_step=2)
# families whose values depend on time or on the process's history (a
# reference program found in its process-wide cache is not resolved
# again): compared by name and labels only
TIMED = ("_seconds", "mxtpu_aot_programs_total")
# statusz sections whose content does not depend on time
STATIC_SECTIONS = ("kv_blocks", "prefix_cache", "host_kv", "quant",
                   "sampling", "adapters", "spec", "kv_cache", "tenants",
                   "reject_reasons", "completed", "preemptions",
                   "queue_depth", "running", "max_batch", "max_model_len",
                   "numeric_watch")
TRACE_ENV = ("MXTPU_REQUEST_TRACE", "MXTPU_REQUEST_TRACE_FILE",
             "MXTPU_REQUEST_TRACE_SAMPLE", "MXTPU_FLIGHT_DIR",
             "MXTPU_FLIGHT_REJECT_RATE", "MXTPU_NUMERIC_WATCH",
             "MXTPU_PERF_ATTRIB", "MXTPU_PERF_ATTRIB_SAMPLE",
             "MXTPU_STEP_PROFILE", "MXTPU_SPEC_MIN_ACCEPT")


def _clean():
    for t in PKGS.values():
        t.disable()
        t.reset()
        t.flight.recorder().clear()


@pytest.fixture(autouse=True)
def clean_state(monkeypatch):
    for k in TRACE_ENV:
        monkeypatch.delenv(k, raising=False)
    _clean()
    yield
    _clean()


@pytest.fixture
def tel():
    for t in PKGS.values():
        t.enable()
    return PKGS


@pytest.fixture(scope="module")
def model():
    _, params, heads = fx.model("gpt2")
    return params, heads


def _engine(pkg, model, **kw):
    params, heads = model
    kw = {**ENGINE_KW, **kw}
    params = kw.pop("params", params)
    if pkg == "ref":
        return mx.serve.Engine(params, num_heads=heads, **kw)
    return mt.serve.Engine(params, num_heads=heads, device="cpu", **kw)


def _qf(pkg):
    return mx.serve.QueueFull if pkg == "ref" else mt.serve.QueueFull


def _prompts(ns=(7, 12, 5, 9), seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, VOCAB, (n,)).astype(np.int32) for n in ns]


def _contended(pkg, model, monkeypatch, trace_file, partial=None):
    """The reference's contended workload (``tests/test_observability
    .py``): preemption on a 20-block cache, a queue-full rejection at
    submit and a deadline rejection in the queue.  Returns (engine,
    requests, the engine's statusz after ``partial`` steps)."""
    monkeypatch.setenv("MXTPU_REQUEST_TRACE", "1")
    monkeypatch.setenv("MXTPU_REQUEST_TRACE_FILE", str(trace_file))
    t = {"now": 0.0}
    rng = np.random.RandomState(11)
    eng = _engine(pkg, model, num_blocks=20, max_queue=4,
                  clock=lambda: t["now"])
    prompts = [rng.randint(0, VOCAB, (n,)).astype(np.int32)
               for n in (8, 12, 16, 10)]
    reqs = [eng.submit(p, max_new_tokens=24) for p in prompts[:3]]
    late = eng.submit(rng.randint(0, VOCAB, (6,)).astype(np.int32),
                      max_new_tokens=4, deadline_s=0.5)
    with pytest.raises(_qf(pkg)):
        eng.submit(prompts[3], max_new_tokens=4)
    t["now"] = 1.0
    st = None
    if partial:
        for _ in range(partial):
            eng.step()
        st = eng.statusz()
    eng.run()
    assert all(r.status == "finished" for r in reqs)
    assert late.status == "rejected" and late.reject_reason == "deadline"
    assert eng.stats().preemptions > 0
    return eng, reqs + [late], st


def _families(snap):
    return {k: (v["kind"], tuple(v["label_names"])) for k, v in snap.items()
            if not k.startswith("mxtpu_jax_")}


def _values(snap):
    """{family: [(labels, value or count)]} of every count that does not
    depend on time."""
    out = {}
    for k, v in snap.items():
        if k.startswith("mxtpu_jax_") or k == TIMED[1]:
            continue
        if v["kind"] == "histogram":
            out[k] = [(s["labels"], s["count"]) for s in v["samples"]]
        elif not k.endswith(TIMED[0]):
            out[k] = [(s["labels"], s["value"]) for s in v["samples"]]
    return out


def _norm_request(r, order):
    return dict({k: v for k, v in r.items()
                 if k not in ("rid", "trace_id", "age_s")},
                order=order[r["rid"]])


def _trace_lines(path):
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    return [dict({k: v for k, v in ln.items()
                  if k not in ("rid", "trace_id")},
                 events=[{k: v for k, v in e.items() if k != "t"}
                         for e in ln["events"]]) for ln in lines]


def _steps(pkg):
    return [{k: v for k, v in e.items() if k != "t"}
            for e in PKGS[pkg].flight.recorder().events()
            if e["kind"] == "step"]


# -- the contended workload: every view agrees --------------------------------
def test_contended_workload_views_agree(tel, model, monkeypatch, tmp_path):
    got = {}
    for pkg in ("ref", "port"):
        eng, reqs, st = _contended(pkg, model, monkeypatch,
                                   tmp_path / f"{pkg}.jsonl", partial=2)
        got[pkg] = dict(
            tokens=[r.tokens for r in reqs], status=st,
            order={r.rid: i for i, r in enumerate(reqs)},
            snap=PKGS[pkg].registry().snapshot(), steps=_steps(pkg),
            stats=eng.stats(), final=eng.statusz())
        eng.shutdown()
        got[pkg]["trace"] = _trace_lines(tmp_path / f"{pkg}.jsonl")
    ref, port = got["ref"], got["port"]
    assert port["tokens"] == ref["tokens"]
    # metric families: names and label sets, and the untimed counts
    assert _families(port["snap"]) == _families(ref["snap"])
    assert _values(port["snap"]) == _values(ref["snap"])
    for name in ("mxtpu_serve_steps_total", "mxtpu_serve_completed_total",
                 "mxtpu_serve_rejections_total",
                 "mxtpu_serve_preemptions_total",
                 "mxtpu_serve_prefill_tokens_computed_total",
                 "mxtpu_serve_prefix_misses_total",
                 "mxtpu_step_phase_seconds"):
        assert _values(port["snap"])[name], name        # not vacuous
    rej = {s["labels"]["reason"]: s["value"] for s in
           port["snap"]["mxtpu_serve_rejections_total"]["samples"]}
    assert rej == {"deadline": 1.0, "queue_full": 1.0}
    # /statusz: the same sections, equal where time does not enter
    for which in ("status", "final"):
        assert set(port[which]) == set(ref[which])
        for sec in STATIC_SECTIONS:
            assert port[which][sec] == ref[which][sec], (which, sec)
    flight = [_norm_request(r, port["order"])
              for r in port["status"]["in_flight"]]
    assert flight and flight == [_norm_request(r, ref["order"])
                                 for r in ref["status"]["in_flight"]]
    assert (port["status"]["request_trace"]["traced"]
            == ref["status"]["request_trace"]["traced"] == 5)
    # request timelines: the same events with the same fields
    assert len(port["trace"]) == 5
    assert port["trace"] == ref["trace"]
    evs = [e["ev"] for ln in port["trace"] for e in ln["events"]]
    assert {"preempted", "resumed", "prefill_start", "prefill_end",
            "decode", "rejected", "finished"} <= set(evs)
    # the flight ring's step records
    assert port["steps"] and port["steps"] == ref["steps"]
    assert port["stats"].reject_reasons == ref["stats"].reject_reasons


@pytest.mark.parametrize("case", ["spec_host_int8", "sampling_adapters"])
def test_feature_sections_and_counts_agree(tel, model, case):
    """Spec decoding with the host tier over int8 K/V, and sampling with
    adapters: the spec, host_kv, quant, sampling and adapters sections
    and every untimed count agree (the spec and adapter counters, host
    offloads and restores, prefix hits, tokens saved)."""
    params, _ = model
    if case == "spec_host_int8":
        draft = {k: v for k, v in params.items()
                 if not k.startswith("gpt_l1_")}
        kw = dict(spec_k=3, draft_params=draft, draft_num_heads=4,
                  draft_window=0, host_kv_bytes=1 << 22, kv_dtype="int8",
                  num_blocks=16, max_model_len=48)
        # the host tier's churn: a prompt, three fills that push its
        # chain out of the 16-block cache, the prompt again
        first = _prompts((24,), seed=3)[0]
        prompts = [first] + _prompts((24, 24, 24), seed=5) + [first]
        submit = [{} for _ in prompts]
    else:
        rng = np.random.RandomState(11)
        stems = mt.serve.adapters.gpt_stems("gpt", 2, False, False, params)
        family = {f"tenant-{j}": {
            s: ((rng.randn(4, din) * 0.1).astype(np.float32),
                (rng.randn(dout, 4) * 0.1).astype(np.float32))
            for s, (dout, din) in stems.items()} for j in range(2)}
        kw = dict(sampling=True, adapters=3, adapter_rank=4)
        prompts = _prompts()
        submit = [dict(adapter_id=a, temperature=0.0, logprobs=2)
                  for a in (None, "tenant-0", "tenant-1", "tenant-0")]
    got = {}
    for pkg in ("ref", "port"):
        # a stopped clock: the tenants section's latencies read 0
        eng = _engine(pkg, model, clock=lambda: 0.0, **kw)
        if case == "sampling_adapters":
            for aid, arrays in family.items():
                eng.adapter_store.register(aid, arrays, alpha=8.0)
        reqs = []
        for p, s in zip(prompts, submit):
            reqs.append(eng.submit(p, max_new_tokens=8, **s))
            if case == "spec_host_int8":
                eng.run()                 # one at a time: evict, restore
        eng.run()
        got[pkg] = dict(tokens=[r.tokens for r in reqs], st=eng.statusz(),
                        snap=PKGS[pkg].registry().snapshot(),
                        steps=_steps(pkg))
        eng.shutdown()
        got[pkg]["after"] = eng.statusz()      # a shut-down engine's page
        PKGS[pkg].reset()
    ref, port = got["ref"], got["port"]
    assert port["tokens"] == ref["tokens"]
    assert set(port["st"]) == set(ref["st"])
    assert set(port["after"]) == set(ref["after"])
    for sec in ("alive", "spec", "kv_cache", "adapters", "sampling"):
        assert port["after"][sec] == ref["after"][sec], sec
    for sec in STATIC_SECTIONS:
        assert port["st"][sec] == ref["st"][sec], sec
    assert _families(port["snap"]) == _families(ref["snap"])
    assert _values(port["snap"]) == _values(ref["snap"])
    assert port["steps"] == ref["steps"]
    vals = _values(port["snap"])
    if case == "spec_host_int8":
        assert port["st"]["spec"]["k"] == 3 and port["st"]["quant"]
        assert port["st"]["host_kv"]["restores"] > 0
        for name in ("mxtpu_serve_spec_drafted_tokens_total",
                     "mxtpu_serve_spec_accepted_tokens_total",
                     "mxtpu_serve_host_kv_offloads_total",
                     "mxtpu_serve_host_kv_restored_tokens_total"):
            assert vals[name], name
        assert "host_kv_entries" in port["steps"][-1]
    else:
        assert port["st"]["adapters"]["loaded"]
        assert port["st"]["sampling"]["enabled"]
        assert vals["mxtpu_serve_adapter_tokens_total"]


# -- flight dumps: the same reasons --------------------------------------------
def _dumps(d):
    out = {}
    for f in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        with open(os.path.join(d, f)) as fh:
            payload = json.load(fh)
        extra = {k: v for k, v in payload.get("extra", {}).items()
                 if k not in ("traceback", "spec_digest", "rid")}
        out.setdefault(payload["reason"], []).append(extra)
    return out


def test_flight_dumps_same_reasons(model, monkeypatch, tmp_path):
    """An engine exception (forced), a deadline miss, a rejection rate
    over MXTPU_FLIGHT_REJECT_RATE and spec's low acceptance dump the same
    reasons with the same fields in both packages; a step() on a
    shut-down engine dumps nothing."""
    monkeypatch.setenv("MXTPU_FLIGHT_REJECT_RATE", "0.5")
    monkeypatch.setenv("MXTPU_SPEC_MIN_ACCEPT", "0.9")
    got = {}
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(d))
        PKGS[pkg].flight.recorder().clear()
        # engine exception: the ring dumped, then the error propagates
        eng = _engine(pkg, model)
        eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=4)

        def boom(req, decode_slots=0):
            raise RuntimeError("injected prefill failure")

        monkeypatch.setattr(eng, "_run_prefill", boom)
        with pytest.raises(RuntimeError, match="injected prefill failure"):
            eng.step()
        eng.shutdown()
        with pytest.raises(RuntimeError, match="shut down"):
            eng.step()
        # deadline miss, then the rejection rate (max_queue 1: every
        # second submit is refused)
        t = {"now": 0.0}
        eng = _engine(pkg, model, max_batch=1, max_queue=1,
                      clock=lambda: t["now"])
        a = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=8)
        eng.step()
        b = eng.submit(np.arange(1, 7, dtype=np.int32), max_new_tokens=4,
                       deadline_s=0.5)
        t["now"] = 1.0
        eng.run()
        assert a.status == "finished" and b.status == "rejected"
        prompt = np.arange(1, 9, dtype=np.int32)
        for _ in range(10):
            req = eng.submit(prompt, max_new_tokens=1)
            with pytest.raises(_qf(pkg)):
                eng.submit(prompt, max_new_tokens=1)
            eng.run()
            assert req.status == "finished"
        eng.shutdown()
        # spec's low acceptance, through the draft worker's window
        draft = {k: v for k, v in model[0].items()
                 if not k.startswith("gpt_l1_")}
        eng = _engine(pkg, model, spec_k=3, draft_params=draft,
                      draft_num_heads=4, draft_window=0)
        for _ in range(mt.serve.spec.MIN_WINDOW):
            eng._spec.on_verify(3, 0)
        eng.shutdown()
        got[pkg] = _dumps(d)
        with open(d / [f for f in os.listdir(d)
                       if f.endswith("engine_exception.json")][0]) as f:
            payload = json.load(f)
        assert "injected prefill failure" in payload["extra"]["traceback"]
        assert payload["extra"]["tp"] == 1
        kinds = [e["kind"] for e in payload["events"]]
        assert "request" in kinds and kinds[-1] == "error"
        assert payload["statusz"] and payload["registry"] is not None
    assert sorted(got["port"]) == ["deadline_miss", "engine_exception",
                                   "rejection_rate", "spec_low_acceptance"]
    assert {k: len(v) for k, v in got["port"].items()} == {
        k: 1 for k in got["port"]}
    assert got["port"] == got["ref"]


def test_numeric_watch_fires_on_nan_logits(model, monkeypatch, tmp_path):
    """A NaN weight under MXTPU_NUMERIC_WATCH: both packages count
    prefill and decode anomalies and write one (rate-limited)
    numeric_anomaly dump; the flag rode the tokens' copy, so the same
    engine with the watch off writes none."""
    params, heads = model
    bad = {k: v.copy() for k, v in params.items()}
    bad["gpt_l0_q_weight"][0, 0] = np.nan
    for watch in ("1", "0"):
        monkeypatch.setenv("MXTPU_NUMERIC_WATCH", watch)
        sites = {}
        for pkg in ("ref", "port"):
            d = tmp_path / f"{pkg}-{watch}"
            monkeypatch.setenv("MXTPU_FLIGHT_DIR", str(d))
            PKGS[pkg].reset()
            PKGS[pkg].flight.recorder().clear()
            eng = _engine(pkg, model, params=bad)
            assert eng._cfg.numeric_watch is (watch == "1")
            eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=3)
            eng.run()
            eng.shutdown()
            fam = PKGS[pkg].registry().snapshot().get(
                "mxtpu_numeric_anomalies_total", {"samples": []})
            sites[pkg] = ({s["labels"]["site"]: s["value"]
                           for s in fam["samples"]}, _dumps(d))
        assert sites["port"] == sites["ref"]
        if watch == "1":
            counts, dumps = sites["port"]
            assert counts == {"prefill_logits": 1.0, "decode_logits": 2.0}
            assert list(dumps) == ["numeric_anomaly"]
            assert dumps["numeric_anomaly"] == [
                {"site": "prefill_logits", "step": 1}]
        else:
            assert sites["port"] == ({}, {})


# -- inertness -----------------------------------------------------------------
SWITCHES = {
    "telemetry": {},
    "request_trace": {"MXTPU_REQUEST_TRACE": "1"},
    "flight_dir": {"MXTPU_FLIGHT_DIR": "flight"},
    "perf_sample": {"MXTPU_PERF_ATTRIB_SAMPLE": "1"},
    "perf_off": {"MXTPU_PERF_ATTRIB": "0"},
    "step_profile_off": {"MXTPU_STEP_PROFILE": "0"},
    "all": {"MXTPU_REQUEST_TRACE": "1", "MXTPU_FLIGHT_DIR": "flight",
            "MXTPU_PERF_ATTRIB_SAMPLE": "1", "MXTPU_FLIGHT_REJECT_RATE":
            "0.5"},
}


def _inert_run(model, spec=False):
    kw = {}
    if spec:
        draft = {k: v for k, v in model[0].items()
                 if not k.startswith("gpt_l1_")}
        kw = dict(spec_k=2, draft_params=draft, draft_num_heads=4,
                  draft_window=0)
    eng = _engine("port", model, **kw)
    reqs = [eng.submit(p, max_new_tokens=10) for p in _prompts()]
    eng.run()
    out = dict(tokens=[r.tokens for r in reqs], digest=eng._spec_digest,
               manifest=eng.manifest(), programs=sorted(eng._programs),
               calls={k: p.calls for k, p in eng._programs.items()},
               grid=eng._warmup_grid())
    eng.shutdown()
    return out


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
@pytest.mark.parametrize("switch", sorted(SWITCHES))
def test_telemetry_switches_are_inert(model, monkeypatch, tmp_path, switch,
                                      spec):
    off = _inert_run(model, spec)
    for k, v in SWITCHES[switch].items():
        monkeypatch.setenv(k, str(tmp_path / v) if v == "flight" else v)
    if "MXTPU_REQUEST_TRACE" in SWITCHES[switch]:
        monkeypatch.setenv("MXTPU_REQUEST_TRACE_FILE",
                           str(tmp_path / "rt.jsonl"))
    port_tel.enable()
    on = _inert_run(model, spec)
    assert on == off


def test_numeric_watch_alone_changes_the_fingerprint(model, monkeypatch):
    off = _inert_run(model)
    monkeypatch.setenv("MXTPU_NUMERIC_WATCH", "1")
    on = _inert_run(model)
    assert on["tokens"] == off["tokens"]
    assert on["digest"] != off["digest"]
    assert on["programs"] == off["programs"]
    eng = _engine("port", model)
    assert eng._fingerprint()["cfg"]["numeric_watch"] is True
    eng.shutdown()
    monkeypatch.delenv("MXTPU_NUMERIC_WATCH")
    eng = _engine("port", model)
    assert "numeric_watch" not in eng._fingerprint()["cfg"]
    eng.shutdown()


# -- port-only surfaces --------------------------------------------------------
def test_statusz_endpoint_live_state(tel, model):
    gc.collect()
    eng = _engine("port", model)
    eng.submit(np.arange(1, 20, dtype=np.int32), max_new_tokens=30)
    eng.submit(np.arange(1, 12, dtype=np.int32), max_new_tokens=30)
    for _ in range(3):
        eng.step()
    server = port_tel.serve_http(port_tel.registry(), 0)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        snap = json.loads(urllib.request.urlopen(
            f"{url}/statusz.json", timeout=10).read())
        assert snap["process"]["pid"] == os.getpid()
        assert snap["torch"]["version"]
        engines = [v for k, v in snap.items()
                   if k.startswith("serve.engine")]
        assert len(engines) == 1
        es = engines[0]
        assert es["alive"] and es["running"] == 2
        assert len(es["in_flight"]) == 2
        assert es["kv_blocks"]["in_use"] > 0
        assert es["kv_blocks"]["total"] == 63
        assert es["sharding"]["tp"] == 1 and es["aot"] == {"dir": None}
        assert es["sharding"]["params_bytes_per_device"]["cpu"] > 0
        assert es["step_profile"]["enabled"] and es["perf"]["enabled"]
        html = urllib.request.urlopen(f"{url}/statusz",
                                      timeout=10).read().decode()
        assert "serve.engine" in html
        body = urllib.request.urlopen(f"{url}/metrics",
                                      timeout=10).read().decode()
        assert "mxtpu_serve_running 2" in body
    finally:
        server.shutdown()
    eng.shutdown()
    assert not [k for k in port_tel.statusz.snapshot()
                if k.startswith("serve.engine")]


def test_request_chrome_tracks_and_spans(tel, model, monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_REQUEST_TRACE", "1")
    monkeypatch.setenv("MXTPU_REQUEST_TRACE_FILE", str(tmp_path / "rt.jsonl"))
    eng = _engine("port", model)
    eng.warmup()
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=4)
    eng.submit(np.arange(1, 14, dtype=np.int32), max_new_tokens=4)
    eng.run()
    eng.shutdown()
    events = port_tel.tracer().trace_events()
    req = [e for e in events if e.get("cat") == "request" and e["ph"] == "X"]
    assert {"queued", "prefill", "decode"} <= {e["name"] for e in req}
    tids = {e["tid"] for e in req}
    assert len(tids) == 2 and all(t >= 10_000 for t in tids)
    host = {e["name"] for e in events if e.get("cat") == "host"}
    assert {"serve.step", "serve.prefill", "serve.decode",
            "serve.warmup"} <= host


def test_request_trace_sampling_zero_keeps_the_flight_ring(model,
                                                           monkeypatch,
                                                           tmp_path):
    monkeypatch.setenv("MXTPU_REQUEST_TRACE", "1")
    monkeypatch.setenv("MXTPU_REQUEST_TRACE_FILE", str(tmp_path / "rt.jsonl"))
    monkeypatch.setenv("MXTPU_REQUEST_TRACE_SAMPLE", "0")
    eng = _engine("port", model)
    eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=3)
    eng.run()
    eng.shutdown()
    assert not os.path.exists(tmp_path / "rt.jsonl")
    kinds = {e["kind"] for e in port_tel.flight.recorder().events()}
    assert {"request", "step"} <= kinds


def test_tools_render_port_artifacts(tel, model, monkeypatch, tmp_path,
                                     capsys):
    """tools/metrics_report.py, trace_report.py (with --check) and
    perf_report.py render the port engine's artifacts."""
    import metrics_report
    import perf_report
    import trace_report

    monkeypatch.setenv("MXTPU_PERF_ATTRIB_SAMPLE", "1")
    eng, _, _ = _contended("port", model, monkeypatch,
                           tmp_path / "rt.jsonl")
    st = eng.statusz()
    eng.shutdown()
    out = str(tmp_path / "tel")
    paths = port_tel.dump(out)
    with open(paths["trace"]) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"serve.step", "serve.prefill", "serve.decode"} <= names
    for target in (out, paths["prometheus"], paths["jsonl"]):
        assert metrics_report.main([target, "--filter", "mxtpu_serve"]) == 0
        text = capsys.readouterr().out
        assert "mxtpu_serve_program_seconds" in text
        assert "bucket=" in text and "kind=decode" in text
    report = tmp_path / "trace.json"
    assert trace_report.main([str(tmp_path / "rt.jsonl"), "--json",
                              str(report), "--check"]) == 0
    with open(report) as f:
        summary = json.load(f)
    assert summary["requests"] == 5 and summary["complete"] == 5
    assert summary["reject_reasons"] == {"deadline": 1, "queue_full": 1}
    capsys.readouterr()
    sfile = tmp_path / "statusz.json"
    sfile.write_text(json.dumps(st))
    assert perf_report.main(["--file", str(sfile)]) == 0
    text = capsys.readouterr().out
    assert "decode" in text and "prefill" in text

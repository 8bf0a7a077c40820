"""The serving engine's program layer (``serve/engine.py`` ``_Program``).

A program owns one device buffer per input dtype whose views are its
inputs, each staged from one host buffer, and runs one body: on the CPU
it calls the body on those buffers, on CUDA it replays the graph it
captured once.  The CPU tests hold the staging (typed fields included:
the host tier's restore payload in the cache dtype, float32 scales and
probabilities), padding and output paths that both devices share.  The
``cuda`` tests show that a body reading a device value on the host
cannot be captured, and that the program then raises instead of running
the body eagerly; that a restore program restaged while its copy is
still queued waits for the copy (the staging fence); and that two
replays of a sampled decode graph with different seeds draw
differently; and that an adapters engine's rotated adapter mix replays
its warmed graphs; and that ``warmup()`` captures while a thread polls
the telemetry endpoints, after which ``PerfAttrib`` times each sampled
graph replay with CUDA events; and that an engine capturing lazily on
one thread leaves a sibling engine replaying on another thread
unharmed, both with their tokens, also after a capture that failed in
the process.  On the CPU, a capture (with CUDA's calls stood in for)
runs in ``"thread_local"`` mode and holds the profiler's capture lock:
a profiler start waits for it, or refuses after ``CAPTURE_WAIT_S``; and
a failed capture ends its stream's capture and takes its pool out of
the caching allocator's captures in progress.  This
file imports no JAX, so the ``cuda`` tests run on the card as they
stand.
"""

import contextlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler as profiler_mod
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


def test_typed_fields_stage_one_buffer_per_dtype():
    """Fields of one dtype share one buffer in field order; int32,
    float32 and int8 stage through numpy views, bfloat16 through CPU
    tensors; a tuple output comes back as numpy arrays, a None output
    as None."""
    seen = {}

    def body(i, f, b, j, q):
        seen.update(i=i.clone(), f=f.clone(), b=b.clone(), j=j.clone(),
                    q=q.clone())
        return (i * 2, f.sum(dim=1), b.float())

    fields = (("i", (2,)), ("f", (2, 3), torch.float32),
              ("b", (4,), torch.bfloat16), ("j", (3,)),
              ("q", (2, 2), torch.int8))
    prog = port_engine._Program(fields, body, torch.device("cpu"))
    h = prog.stage()
    assert isinstance(h["i"], np.ndarray) and isinstance(h["q"], np.ndarray)
    assert isinstance(h["f"], np.ndarray) and h["f"].dtype == np.float32
    assert isinstance(h["b"], torch.Tensor) and h["b"].dtype == torch.bfloat16
    h["i"][:] = [3, 4]
    h["f"][1] = [0.5, 1.5, 2.0]
    h["b"][:] = torch.tensor([1.0, -2.5, 0.0, 3.0])
    h["j"][2] = 9
    h["q"][0] = [-7, 100]
    out = prog()
    assert [o.dtype for o in out] == [np.int32, np.float32, np.float32]
    assert out[0].tolist() == [6, 8] and out[1].tolist() == [0.0, 4.0]
    assert out[2].tolist() == [1.0, -2.5, 0.0, 3.0]
    assert seen["q"].tolist() == [[-7, 100], [0, 0]]
    ins = prog._inputs
    assert ins["j"].data_ptr() == ins["i"].data_ptr() + 2 * 4
    assert ins["f"].dtype == torch.float32 and ins["b"].dtype == torch.bfloat16
    assert sorted(str(d) for d in prog._host) == [
        "torch.bfloat16", "torch.float32", "torch.int32", "torch.int8"]
    # stage() zeroes every buffer of every dtype
    h = prog.stage()
    assert not any(bool((torch.as_tensor(v) != 0).any()) for v in h.values())
    none = port_engine._Program((("x", (1,)),), lambda x: None,
                                torch.device("cpu"))
    none.stage()
    assert none() is None and none.calls == 1


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_restore_program_pads_to_the_null_block(kv_dtype):
    """The engine's restore program at bucket 4 with 3 blocks staged:
    the parked bytes land at their blocks, the padding row writes only
    the null block, and the payload fields carry the cache dtype (int8
    beside float32 scales under int8 K/V)."""
    eng = _engine(host_kv_bytes=1 << 20, kv_dtype=kv_dtype)
    prog = eng._program("restore", 4)
    h = prog.stage()
    L, bs, H, D = 2, 4, 4, 8
    want = {"hk": eng._cache_k.dtype, "hv": eng._cache_v.dtype}
    if kv_dtype:
        want.update(hks=torch.float32, hvs=torch.float32)
    assert {n: prog._inputs[n].dtype for n in want} == want
    assert prog._inputs["hk"].shape == (L, 4, bs, H, D)
    before = [t.clone() for t in (eng._cache_k, eng._cache_v)]
    rng = np.random.RandomState(2)
    blocks = [9, 3, 30]
    parts = []
    for i, blk in enumerate(blocks):
        arrays = tuple(torch.from_numpy(
            (rng.randn(*x.shape[:1] + x.shape[2:]) * 40).astype(
                np.float32)).to(x.dtype)
            for x in (prog._inputs[n] for n in want))
        parts.append(arrays)
        h["blks"][i] = blk
        for n, a in zip(want, arrays):
            dst = h[n][:, i]
            (torch.from_numpy(dst) if isinstance(dst, np.ndarray)
             else dst).copy_(a)
    assert prog() is None
    caches = [eng._cache_k, eng._cache_v] + (
        [eng._scale_k, eng._scale_v] if kv_dtype else [])
    for blk, arrays in zip(blocks, parts):
        for c, a in zip(caches, arrays):
            assert torch.equal(c[:, blk], a)
    untouched = [b for b in range(1, eng.num_blocks) if b not in blocks]
    for c, b0 in zip(caches, before):
        assert torch.equal(c[:, untouched], b0[:, untouched])
    eng.shutdown()


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


def _sibling_check():
    """Two engines in one process: A, warmed, replays its graphs round
    after round on one thread while B, not warmed, serves the same
    prompts on another and so captures its programs in traffic.  Both
    give A's uncontended tokens in every round, B captures more than 0
    graphs, A none, and neither raises."""
    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 53, (n,)).astype(np.int32)
               for n in (5, 9, 12, 7, 3, 10, 6, 8)]

    def serve(eng):
        reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        eng.run()
        return [list(r.tokens) for r in reqs]

    a = _engine("cuda")
    a.warmup()
    want = serve(a)
    a_caps = a.captures
    b = _engine("cuda")
    assert b.captures == 0
    stop, errors, rounds = threading.Event(), [], [0]

    def replay_a():
        try:
            while not stop.is_set():
                if serve(a) != want:
                    errors.append("A's tokens changed")
                rounds[0] += 1
        except Exception as e:       # a sibling's failure fails the test
            errors.append(repr(e))

    th = threading.Thread(target=replay_a)
    th.start()
    try:
        while not rounds[0] and not errors:
            time.sleep(0.001)
        got = serve(b)
    finally:
        stop.set()
        th.join(timeout=120)
    assert not th.is_alive() and not errors, errors
    assert got == want
    assert b.captures > 0 and a.captures == a_caps
    a.shutdown()
    b.shutdown()


def _host_read_body(calls):
    def body(x):
        calls.append(1)
        return x + int(x.sum().item())
    return body


@pytest.mark.cuda
def test_cuda_lazy_capture_beside_a_replaying_sibling():
    """The sibling check (``_sibling_check``): a capture in torch's
    default "global" mode would make A's stream sync illegal while B
    captures."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA-graph capture exists only on the "
                    "card; chip_smoke.py's serve_fleet_obs runs the same "
                    "check at full width")
    _sibling_check()


@pytest.mark.cuda
def test_cuda_sibling_capture_after_a_failed_capture(monkeypatch):
    """The sibling check after captures that failed in the process (the
    host-read case's, a program alone and one inside an engine).  When
    captures ran in ``torch.cuda.graph``, a failed one left this thread
    on the process's shared capture stream, and A then gave other
    tokens here (ROADMAP §C9)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA-graph capture exists only on the "
                    "card; chip_smoke.py's serve_fleet_obs runs the same "
                    "check at full width")
    _host_read_failures(monkeypatch)
    monkeypatch.undo()
    _sibling_check()


def _host_read_failures(monkeypatch):
    """A program body that reads a device value on the host
    (``.item()``) cannot be captured: the program raises, and nothing
    runs the body eagerly in its place, alone or inside the engine."""
    calls = []
    with pytest.raises(RuntimeError):
        port_engine._Program((("x", (4,)),), _host_read_body(calls),
                             torch.device("cuda"),
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


@pytest.mark.cuda
def test_cuda_capture_of_a_host_read_raises_without_eager_retreat(
        monkeypatch):
    """``_host_read_failures``."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA-graph capture exists only on the "
                    "card; chip_smoke.py serves through captured graphs")
    _host_read_failures(monkeypatch)


@pytest.mark.cuda
def test_cuda_restore_restaged_while_its_copy_is_queued():
    """A restore program called twice back to back, its first staging
    copy held behind a long kernel on the stream: the second ``stage()``
    waits for that copy (the program's event), so each call's blocks
    get its own bytes.  Without the fence the first copy would read the
    refilled buffer."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: pinned staging and graph replays "
                    "exist only on the card")
    eng = _engine("cuda", host_kv_bytes=1 << 20)
    prog = eng._program("restore", 2)
    shape = prog._inputs["hk"].shape
    vals = []
    for call, blks in enumerate(([5, 6], [7, 8])):
        torch.cuda._sleep(50_000_000)         # ~tens of ms on the stream
        h = prog.stage()
        h["blks"][:] = blks
        v = torch.full(shape, float(call + 1))
        for n in ("hk", "hv"):
            torch.from_numpy(h[n]).copy_(v)
        vals.append(v)
        prog()
    torch.cuda.synchronize()
    for blks, v in zip(([5, 6], [7, 8]), vals):
        for c in (eng._cache_k, eng._cache_v):
            assert torch.equal(c[:, blks].cpu(), v)
    eng.shutdown()


@pytest.mark.cuda
def test_cuda_sampled_decode_replays_draw_afresh():
    """The captured sampling-mode decode graph at fixed inputs: two
    replays with different seeds draw differently, the same seed draws
    the same, and greedy rows stay argmax."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA-graph capture exists only on the "
                    "card")
    eng = _engine("cuda", sampling=True)
    prog = eng._program("decode", 4)
    assert prog.captured

    def call(seed):
        h = prog.stage()
        h["toks"][:] = [5, 6, 7, 8]
        h["pos"][:] = [3, 3, 3, 3]
        h["tables"][:, 0] = [1, 2, 3, 4]
        h["temp"][:] = [0.0, 2.0, 2.0, 2.0]
        h["topp"][:] = 1.0
        h["seed"][0] = seed
        return prog()[0].tolist()

    draws = [call(s) for s in range(8)]
    assert len({tuple(d[1:]) for d in draws}) > 1
    assert len({d[0] for d in draws}) == 1
    assert call(3) == draws[3]
    eng.shutdown()


@pytest.mark.cuda
def test_cuda_rotated_adapter_mix_captures_nothing():
    """An adapters engine on the card: after ``warmup()``, a mixed batch
    of base and adapter rows and its rotation replay the warmed graphs
    (no capture), adapters loaded after the captures reach them, and an
    adapter row equals its merged-checkpoint engine's tokens."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA-graph capture exists only on the "
                    "card")
    from mxnet_tpu_torch.serve.adapters import gpt_stems

    params = _params()
    stems = gpt_stems("gpt", 2, False, False, params)
    rng = np.random.RandomState(11)
    family = {f"tenant-{j}": {s: ((rng.randn(4, din) * 0.1)
                                  .astype(np.float32),
                                  (rng.randn(dout, 4) * 0.1)
                                  .astype(np.float32))
                              for s, (dout, din) in stems.items()}
              for j in range(3)}
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, 53, (n,)).astype(np.int32)
               for n in (7, 12, 5, 9)]
    ids = [None, "tenant-0", "tenant-1", "tenant-2"]

    def serve(eng, adapter_ids):
        reqs = [eng.submit(p, max_new_tokens=8, adapter_id=a)
                for p, a in zip(prompts, adapter_ids)]
        eng.run()
        return [r.tokens for r in reqs]

    eng = mt.serve.Engine(params, num_heads=4, device="cuda", adapters=4,
                          adapter_rank=4, **ENGINE_KW)
    eng.warmup()
    captures = eng.captures
    assert captures == len(eng._programs) > 0
    for aid, arrays in family.items():
        eng.adapter_store.register(aid, arrays, alpha=8.0)
    mux = serve(eng, ids)
    mux2 = serve(eng, ids[1:] + ids[:1])
    assert eng.captures == captures and mux != mux2
    eng.shutdown()
    merged = dict(params)
    for s, (a, b) in family["tenant-0"].items():
        merged[f"{s}_weight"] = params[f"{s}_weight"] + 2.0 * (b @ a)
    ref = mt.serve.Engine(merged, num_heads=4, device="cuda", **ENGINE_KW)
    assert serve(ref, [None] * 4)[1] == mux[1]
    ref.shutdown()


@pytest.mark.cuda
def test_cuda_capture_under_live_statusz_and_event_timed_replays(
        monkeypatch):
    """``warmup()`` captures every program while a thread polls
    ``/statusz.json``, ``/metrics`` and ``/healthz`` (every provider reads
    host state only, so no capture is invalidated, and every response
    parses); then, sampling every step, PerfAttrib's CUDA-event time of
    the bucket-4 decode agrees with timed replays of the same graph, and
    its call counts equal the programs' own."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: CUDA-graph capture and CUDA-event "
                    "timing exist only on the card")
    from mxnet_tpu_torch import telemetry

    monkeypatch.setenv("MXTPU_PERF_ATTRIB_SAMPLE", "1")
    telemetry.reset()
    telemetry.enable()
    server = telemetry.serve_http(telemetry.registry(), 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    stop, errors, polls = threading.Event(), [], [0]

    def poll():
        while not stop.is_set():
            for path in ("/statusz.json", "/metrics", "/healthz"):
                try:
                    body = urllib.request.urlopen(url + path,
                                                  timeout=10).read()
                    if path != "/metrics":
                        json.loads(body)
                except Exception as e:       # a failed poll fails the test
                    errors.append(repr(e))
            polls[0] += 1

    try:
        eng = _engine("cuda")
        th = threading.Thread(target=poll)
        th.start()
        while not polls[0] and not errors:     # the poller is running
            stop.wait(0.01)
        try:
            ready = eng.warmup()
        finally:
            stop.set()
            th.join()
        assert not errors and polls[0] > 0
        assert ready == eng.captures == len(eng._programs) > 0
        rng = np.random.RandomState(5)
        for _ in range(2):
            for n in (7, 12, 5, 9):
                eng.submit(rng.randint(0, 53, (n,)).astype(np.int32),
                           max_new_tokens=16)
            eng.run()
        assert eng.captures == ready
        perf = eng.statusz()["perf"]
        rows = {(r["kind"], r["bucket"]): r for r in perf["programs"]}
        for key, prog in eng._programs.items():
            assert rows[key]["dispatches"] == prog.calls, key
            assert rows[key]["sampled"] == prog.calls, key
        row = rows[("decode", 4)]
        assert row["sampled"] > 0
        graph = eng._programs[("decode", 4)]._graph
        times = []
        for _ in range(20):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        replay_ms = sorted(times)[len(times) // 2]
        got_ms = 1e3 * row["mean_s"]
        # both bracket the replay alone; the engine's ran in traffic,
        # between other programs and with the host's launch latency
        assert abs(got_ms - replay_ms) <= 0.5 * replay_ms + 0.05, (
            got_ms, replay_ms)
        eng.shutdown()
    finally:
        server.shutdown()
        telemetry.disable()
        telemetry.reset()


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeGraph:
    """``torch.cuda.CUDAGraph`` stood in for: records its calls, and
    ``capture_end`` raises when ``end_raises``."""

    end_raises = False

    def __init__(self):
        self.calls = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.calls.append(("begin", capture_error_mode))
        _FakeGraph.hook()

    def capture_end(self):
        self.calls.append(("end",))
        self.t_end = time.monotonic()
        if self.end_raises:
            raise RuntimeError("operation failed due to a previous error "
                               "during capture")

    def pool(self):
        return (0, 7)

    @staticmethod
    def hook():
        pass


def _fake_cuda(monkeypatch):
    """Stand CUDA's streams, graph and event in for, so a capture's own
    code runs on the CPU; returns the graphs it made and the pools it
    took out of the allocator's captures."""
    graphs, ended = [], []

    def make_graph():
        g = _FakeGraph()
        graphs.append(g)
        return g

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Stream", lambda d=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", make_graph)
    monkeypatch.setattr(torch.cuda, "Event", object)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_endAllocateToPool",
                        lambda i, p: ended.append((i, p)), raising=False)
    return graphs, ended


def test_capture_holds_the_lock_against_profiler_start(monkeypatch,
                                                       tmp_path):
    """``_Program._capture`` captures in ``"thread_local"`` mode and
    holds the profiler's capture lock throughout: a ``profiler.start``
    on another thread that waits less than the capture lasts refuses
    (``ProfilerActive``), and one that waits longer starts only once
    the capture has ended.  CUDA's streams, graph and event are stood
    in for; the capture's own code runs."""
    seen, starts = {}, {}

    def start_on_thread(tag, wait_s):
        # the profiler is stopped on the thread that started it
        def run():
            try:
                profiler_mod.start(str(tmp_path / tag))
            except profiler_mod.ProfilerActive:
                starts[tag] = "refused"
                return
            starts[tag] = time.monotonic()
            profiler_mod.stop()

        monkeypatch.setattr(profiler_mod, "CAPTURE_WAIT_S", wait_s)
        th = threading.Thread(target=run)
        th.start()
        return th

    def during_capture():
        start_on_thread("short", 0.2).join(timeout=30)
        seen["late"] = start_on_thread("late", 60.0)
        time.sleep(0.3)
        seen["late_waited"] = "late" not in starts

    graphs, _ = _fake_cuda(monkeypatch)
    monkeypatch.setattr(_FakeGraph, "hook", staticmethod(during_capture))
    bodies = []
    prog = port_engine._Program((("x", (4,)),),
                                lambda x: bodies.append(1),
                                torch.device("cpu"))
    prog._capture(None)
    seen["late"].join(timeout=60)
    assert graphs[0].calls == [("begin", "thread_local"), ("end",)]
    assert len(bodies) == port_engine._WARM_RUNS + 1
    assert prog.captured
    assert starts["short"] == "refused"
    assert seen["late_waited"] and starts["late"] >= graphs[0].t_end
    assert profiler_mod.active_logdir() is None


@pytest.mark.parametrize("fault", ["body_raises", "end_raises",
                                   "body_raises_end_clean"])
def test_failed_capture_is_abandoned(monkeypatch, fault):
    """A capture that fails ends its stream's capture, takes its pool out
    of the caching allocator's captures in progress when torch did not
    (ROADMAP §C9: a leftover pool drew a sibling engine's later
    captures into it), re-raises the capture's own error, and releases
    the capture lock.  A body that raised inside a capture that still
    ends cleanly leaves torch's state as torch made it.  CUDA is stood
    in for."""
    graphs, ended = _fake_cuda(monkeypatch)
    monkeypatch.setattr(_FakeGraph, "end_raises",
                        fault != "body_raises_end_clean")
    calls = []

    def body(x):
        calls.append(1)
        if fault != "end_raises" and len(calls) > port_engine._WARM_RUNS:
            raise RuntimeError("the body's own error")

    with pytest.raises(RuntimeError) as err:
        port_engine._Program((("x", (4,)),), body, torch.device("cpu"),
                             (0, 7))._capture((0, 7))
    assert len(calls) == port_engine._WARM_RUNS + 1
    assert graphs[0].calls == [("begin", "thread_local"), ("end",)]
    want = ("during capture" if fault == "end_raises"
            else "the body's own error")
    assert want in str(err.value)
    assert ended == ([] if fault == "body_raises_end_clean"
                     else [(0, (0, 7))])
    assert profiler_mod.capture_lock.acquire(timeout=1.0)
    profiler_mod.capture_lock.release()

"""The PyTorch port stands alone: importing ``mxnet_tpu_torch`` loads
neither JAX, nor anything of the reference package, nor ml_dtypes (the
card's machine has none: bfloat16 host copies are torch tensors), and
its entry points
default to CUDA and refuse to run without it (no silent CPU fallback).
"""

import importlib
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu import base as ref_base  # noqa: E402
from mxnet_tpu_torch import base as port_base  # noqa: E402

_PROBE = r"""
import sys
import mxnet_tpu_torch
import mxnet_tpu_torch.base, mxnet_tpu_torch.context, mxnet_tpu_torch.convert
import mxnet_tpu_torch._build
import mxnet_tpu_torch.aot, mxnet_tpu_torch.aot.warmup
import mxnet_tpu_torch.aot.cache, mxnet_tpu_torch.aot.export_store
import mxnet_tpu_torch.models, mxnet_tpu_torch.models.generate
import mxnet_tpu_torch.models.transformer
import mxnet_tpu_torch.ops, mxnet_tpu_torch.ops.attention
import mxnet_tpu_torch.ops.paged_attention_cuda
import mxnet_tpu_torch.ops.flash_attention
import mxnet_tpu_torch.ops.flash_attention_cuda
import mxnet_tpu_torch.ops.rnn, mxnet_tpu_torch.ops.fused_lstm
import mxnet_tpu_torch.ops.fused_gru, mxnet_tpu_torch.ops.fused_rnn_cuda
import mxnet_tpu_torch.models.lstm
import mxnet_tpu_torch.ops.nn, mxnet_tpu_torch.ops.loss
import mxnet_tpu_torch.initializer
import mxnet_tpu_torch.parallel, mxnet_tpu_torch.parallel.trainer
import mxnet_tpu_torch.parallel.mesh, mxnet_tpu_torch.parallel.partition
import mxnet_tpu_torch.serve, mxnet_tpu_torch.serve.engine
import mxnet_tpu_torch.serve.kv_block_manager, mxnet_tpu_torch.serve.scheduler
import mxnet_tpu_torch.serve.stats, mxnet_tpu_torch.serve.adapters
import mxnet_tpu_torch.telemetry, mxnet_tpu_torch.telemetry.request_trace
import mxnet_tpu_torch.telemetry.timeseries
import mxnet_tpu_torch.telemetry.metrics, mxnet_tpu_torch.telemetry.exporters
import mxnet_tpu_torch.telemetry.tracing, mxnet_tpu_torch.telemetry.flight
import mxnet_tpu_torch.telemetry.statusz, mxnet_tpu_torch.telemetry.profiling
import mxnet_tpu_torch.telemetry.perf_attrib
import mxnet_tpu_torch.telemetry.cudamon
import mxnet_tpu_torch.profiler, mxnet_tpu_torch.flops
import mxnet_tpu_torch.fleet, mxnet_tpu_torch.fleet.faults
import mxnet_tpu_torch.fleet.replica, mxnet_tpu_torch.fleet.router
import mxnet_tpu_torch.fleet.supervisor, mxnet_tpu_torch.fleet.serve_replica
import mxnet_tpu_torch.fleet.collector, mxnet_tpu_torch.fleet.slo
import mxnet_tpu_torch.fleet.autoscaler, mxnet_tpu_torch.fleet.deploy
import mxnet_tpu_torch.fleet.catalog
import mxnet_tpu_torch.monitor
import mxnet_tpu_torch.ndarray, mxnet_tpu_torch.symbol
import mxnet_tpu_torch.executor, mxnet_tpu_torch.graph
import mxnet_tpu_torch.optimizer, mxnet_tpu_torch.lr_scheduler
import mxnet_tpu_torch.metric, mxnet_tpu_torch.callback, mxnet_tpu_torch.io
import mxnet_tpu_torch.model, mxnet_tpu_torch.module
import mxnet_tpu_torch.module.base_module, mxnet_tpu_torch.module.module
import mxnet_tpu_torch.module.executor_group
import mxnet_tpu_torch.random, mxnet_tpu_torch.registry
import mxnet_tpu_torch.param, mxnet_tpu_torch.attribute
import mxnet_tpu_torch.ops.op, mxnet_tpu_torch.ops.elementwise
import mxnet_tpu_torch.ops.reduce, mxnet_tpu_torch.ops.matrix
import mxnet_tpu_torch.ops.sample, mxnet_tpu_torch.ops.sequence
import mxnet_tpu_torch.module.bucketing_module
import mxnet_tpu_torch.module.sequential_module
import mxnet_tpu_torch.module.python_module
import mxnet_tpu_torch.executor_manager, mxnet_tpu_torch.rnn_io
import torch
# the port's own name starts with "mxnet_tpu": match the reference by
# exact key or by the "mxnet_tpu." prefix, never by bare prefix
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "mxnet_tpu", "ml_dtypes")
             or k.startswith(("jax.", "jaxlib.", "mxnet_tpu.",
                              "ml_dtypes.")))
print("BAD=" + ",".join(bad))
print("BUILT=" + ",".join(sorted(mxnet_tpu_torch._build.BUILD_SECONDS)))
print("TELEMETRY=" + str(mxnet_tpu_torch.telemetry.enabled()))
print("CUDA_INIT=" + str(torch.cuda.is_initialized()))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("BAD=")]
    assert line == ["BAD="], out.stdout
    # importing every module builds no CUDA source, and initialises no
    # CUDA context
    assert "BUILT=" in out.stdout.splitlines(), out.stdout
    assert "CUDA_INIT=False" in out.stdout.splitlines(), out.stdout


def test_port_with_telemetry_on_imports_neither_jax_nor_cuda(tmp_path):
    """With ``MXTPU_TELEMETRY=1`` the import enables telemetry (the
    reference's gate), and still loads no ``jax`` or reference module and
    initialises no CUDA context."""
    env = dict(os.environ, PYTHONPATH=REPO, MXTPU_TELEMETRY="1",
               MXTPU_TELEMETRY_DIR=str(tmp_path / "tel"))
    env.pop("MXTPU_TELEMETRY_HTTP_PORT", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "BAD=" in lines and "TELEMETRY=True" in lines, out.stdout
    assert "CUDA_INIT=False" in lines, out.stdout
    # the gate's atexit dump wrote the artifact set
    assert sorted(os.listdir(tmp_path / "tel")) == [
        "host_trace.json", "metrics.jsonl", "metrics.prom"]


def test_probe_would_see_a_reference_import():
    """The isolation probe is not vacuous: the same filter flags the
    reference package when it is imported."""
    probe = _PROBE.replace("import mxnet_tpu_torch\n",
                           "import mxnet_tpu_torch\nimport mxnet_tpu.base\n",
                           1)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "mxnet_tpu.base" in out.stdout


def _require_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")


@pytest.mark.parametrize("entry", ["resolve_device", "params_from_numpy",
                                   "gpt_generate", "Engine",
                                   "ShardedTrainer", "serve_replica",
                                   "gpu_context", "tpu_context",
                                   "default_context_array",
                                   "default_context_module_bind"])
def test_default_device_is_cuda_and_raises_without_it(entry):
    _require_no_cuda()
    import numpy as np

    params = {"gpt_tok_embed_weight": np.zeros((8, 4), np.float32),
              "gpt_l0_q_weight": np.zeros((4, 4), np.float32),
              "gpt_l0_k_weight": np.zeros((4, 4), np.float32)}
    calls = {
        "resolve_device": lambda: mt.resolve_device(),
        "params_from_numpy": lambda: mt.params_from_numpy(params),
        "gpt_generate": lambda: mt.models.gpt_generate(
            params, np.zeros((1, 2), np.int32), 2, num_heads=1, window=0),
        "Engine": lambda: mt.serve.Engine(params, num_heads=1),
        "ShardedTrainer": lambda: mt.parallel.ShardedTrainer(
            mt.models.gpt(8, 4, num_layers=1, d_model=4, num_heads=1),
            {"data": (1, 4), "softmax_label": (1, 4)}),
        # the fleet's process front (its --device defaults to cuda)
        "serve_replica": lambda: importlib.import_module(
            "mxnet_tpu_torch.fleet.serve_replica").main(
                ["--layers", "1", "--d-model", "8", "--heads", "2",
                 "--vocab", "16"]),
        # the training frontend: gpu/tpu contexts name cuda:i, and the
        # default context is gpu(0)
        "gpu_context": lambda: mt.nd.zeros((2,), ctx=mt.gpu(0)),
        "tpu_context": lambda: mt.nd.ones((2,), ctx=mt.tpu(0)),
        "default_context_array": lambda: mt.nd.array([1.0, 2.0]),
        "default_context_module_bind": lambda: mt.mod.Module(
            mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
                mt.sym.Variable("data"), num_hidden=2, name="fc"),
                name="softmax")).bind([("data", (2, 3))],
                                      [("softmax_label", (2,))]),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


def test_explicit_cpu_device_resolves():
    assert mt.resolve_device("cpu") == torch.device("cpu")


def test_tf32_is_off():
    """The reference's float32 is true float32."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("value", [None, "", "0", "1", "false", "False",
                                   "FALSE", "no", "off", "yes", "on", "7"])
def test_env_flag_matches_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("MXTPU_PORT_KNOB", raising=False)
    else:
        monkeypatch.setenv("MXTPU_PORT_KNOB", value)
    for default in (True, False):
        assert (port_base.env_flag("MXTPU_PORT_KNOB", default)
                == ref_base.env_flag("MXTPU_PORT_KNOB", default))


@pytest.mark.parametrize("value", [None, "", "12", "-3", "1.5", "x"])
def test_env_int_and_float_match_reference(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("MXTPU_PORT_KNOB", raising=False)
    else:
        monkeypatch.setenv("MXTPU_PORT_KNOB", value)
    assert (port_base.env_int("MXTPU_PORT_KNOB", 4)
            == ref_base.env_int("MXTPU_PORT_KNOB", 4))
    assert (port_base.env_float("MXTPU_PORT_KNOB", 0.5)
            == ref_base.env_float("MXTPU_PORT_KNOB", 0.5))


def test_telemetry_is_the_disabled_path():
    c = mt.telemetry.counter("x_total", "help", ("a",))
    c.labels(a="b").inc()
    mt.telemetry.gauge("g").set(3)
    mt.telemetry.histogram("h").observe(0.1)
    with mt.telemetry.span("s", k=1):
        pass
    assert not mt.telemetry.enabled()
    tr = mt.telemetry.request_trace.NOOP_TRACER
    assert tr.enabled is False
    tr.submitted(None), tr.event(None, "e"), tr.terminal(None, "t")


def test_kernel_build_is_lazy_and_targets_sm90a():
    """Importing the port builds nothing (the CPU has no nvcc) and the
    build keeps the ``a`` of sm_90a."""
    from mxnet_tpu_torch import _build

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_SECONDS == {}
    for src in ("paged_attention.cu", "flash_attention.cu", "flash_fwd_tc.cu",
                "tc_tile.cuh", "fused_rnn.cuh", "fused_lstm_fwd.cu",
                "fused_lstm_bwd.cu", "fused_gru_fwd.cu", "fused_gru_bwd.cu"):
        assert os.path.isfile(os.path.join(_build.CSRC_DIR, src))
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "/build/" in f.read().split()


def test_kernel_build_dir_and_missing_nvcc(monkeypatch, tmp_path):
    """Libraries land in MXTPU_TORCH_BUILD_DIR, else in the checkout's
    gitignored build/; without nvcc the first launch says how to fix it."""
    from mxnet_tpu_torch import _build

    monkeypatch.delenv("MXTPU_TORCH_BUILD_DIR", raising=False)
    assert _build.build_dir() == os.path.join(REPO, "build",
                                              "mxnet_tpu_torch")
    monkeypatch.setenv("MXTPU_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == str(tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    real_isfile = os.path.isfile
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False
                        if p.endswith("nvcc") else real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library("mxtt_paged_attention", ("paged_attention.cu",))
    assert list(tmp_path.iterdir()) == []


def test_kernel_build_compiles_each_unit_at_once_then_links(monkeypatch,
                                                           tmp_path):
    """One ``nvcc -c`` per ``.cu`` source (headers are hashed, not
    compiled), then one link; the objects are removed, and a unit that
    fails raises with nvcc's message."""
    from mxnet_tpu_torch import _build

    csrc, out, bin_ = (tmp_path / d for d in ("csrc", "out", "bin"))
    for d in (csrc, out, bin_):
        d.mkdir()
    (csrc / "k.cuh").write_text("// header\n")
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    log = tmp_path / "calls.txt"
    nvcc = bin_ / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'case "$*" in *bad.cu*) echo "bad.cu: error" >&2; exit 2;; esac\n'
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("MXTPU_TORCH_BUILD_DIR", str(out))
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    lib = _build.build_library("mxtt_fake", ("k.cuh", "a.cu", "b.cu"))
    calls = log.read_text().splitlines()
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert len(compiles) == 2 and len(calls) == 3
    assert all("arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) == [
        "a.cu", "b.cu"]
    assert calls[-1].startswith("-shared -o ")
    assert [p.name for p in out.iterdir()] == [os.path.basename(lib)]
    assert "mxtt_fake" in _build.BUILD_SECONDS
    (csrc / "bad.cu").write_text("// bad\n")
    with pytest.raises(RuntimeError, match="bad.cu: error"):
        _build.build_library("mxtt_bad", ("a.cu", "bad.cu"))
    assert [p.name for p in out.iterdir()] == [os.path.basename(lib)]


# the sensors' knobs (A14b-2) with a value each: the port reads every one
# with the reference's name and default
SENSOR_KNOBS = {"MXTPU_FLEET_COLLECT_INTERVAL": "2.5",
                "MXTPU_SLO_FAST_WINDOW": "7", "MXTPU_SLO_SLOW_WINDOW": "70",
                "MXTPU_SLO_FAST_BURN": "3", "MXTPU_SLO_SLOW_BURN": "1.5",
                "MXTPU_SLO_MIN_REQUESTS": "4",
                "MXTPU_PROFILEZ_ON_BURN": "0", "MXTPU_PROFILEZ_BURN_S": "2",
                "MXTPU_TIMESERIES_INTERVAL": "0.25",
                "MXTPU_TIMESERIES": "16"}


@pytest.mark.parametrize("set_env", [False, True], ids=["unset", "set"])
def test_sensor_knobs_are_honoured_as_the_reference(monkeypatch, set_env):
    """The collector's interval and SLO spec, the evaluator's windows,
    burns, minimum and burn capture, and the time-series ring's capacity
    and interval read the reference's knobs with its defaults."""
    import mxnet_tpu.fleet as ref_fleet
    from mxnet_tpu.telemetry import timeseries as ref_ts
    from mxnet_tpu_torch.telemetry import timeseries as port_ts

    for var, value in SENSOR_KNOBS.items():
        if set_env:
            monkeypatch.setenv(var, value)
        else:
            monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MXTPU_SLO_SPEC", "ttft_p99_ms=500;availability=0.99")
    monkeypatch.delenv("MXTPU_FLEET_COLLECT_PORT", raising=False)

    def read(fleet, ts):
        col = fleet.FleetCollector(urls=[])
        ev = col.slo
        ts._global_checked = False
        ring = ts.ring()
        out = (col.interval_s, col.port, [o.key for o in ev.objectives],
               ev.fast_s, ev.slow_s, ev.fast_burn, ev.slow_burn,
               ev.min_requests, ev.capture_on_burn, ev.capture_s,
               None if ring is None else (ring.capacity,
                                          ring.sample_interval_s))
        ts.configure(0)
        return out

    port = read(mt.fleet, port_ts)
    assert port == read(ref_fleet, ref_ts)
    assert (port[-1] is not None) == set_env

"""The PyTorch port stands alone: importing ``mxnet_tpu_torch`` loads
neither JAX nor anything of the reference package, and its entry points
default to CUDA and refuse to run without it (no silent CPU fallback).
"""

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
import mxnet_tpu_torch.models, mxnet_tpu_torch.models.generate
import mxnet_tpu_torch.models.transformer
import mxnet_tpu_torch.ops, mxnet_tpu_torch.ops.attention
import mxnet_tpu_torch.ops.paged_attention_cuda
import mxnet_tpu_torch.ops.flash_attention
import mxnet_tpu_torch.ops.flash_attention_cuda
import mxnet_tpu_torch.ops.nn, mxnet_tpu_torch.ops.loss
import mxnet_tpu_torch.initializer
import mxnet_tpu_torch.parallel, mxnet_tpu_torch.parallel.trainer
import mxnet_tpu_torch.serve, mxnet_tpu_torch.serve.engine
import mxnet_tpu_torch.serve.kv_block_manager, mxnet_tpu_torch.serve.scheduler
import mxnet_tpu_torch.serve.stats
import mxnet_tpu_torch.telemetry, mxnet_tpu_torch.telemetry.request_trace
import mxnet_tpu_torch.telemetry.timeseries
# the port's own name starts with "mxnet_tpu": match the reference by
# exact key or by the "mxnet_tpu." prefix, never by bare prefix
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "mxnet_tpu")
             or k.startswith(("jax.", "jaxlib.", "mxnet_tpu.")))
print("BAD=" + ",".join(bad))
print("BUILT=" + ",".join(sorted(mxnet_tpu_torch._build.BUILD_SECONDS)))
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("BAD=")]
    assert line == ["BAD="], out.stdout
    # importing every module builds no CUDA source
    assert "BUILT=" in out.stdout.splitlines(), out.stdout


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
                                   "ShardedTrainer"])
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
    for src in ("paged_attention.cu", "flash_attention.cu"):
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

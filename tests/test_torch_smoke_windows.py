"""chip_smoke.py's profile-window reader on the CPU: ``window_kernels``
reads only the device work launched inside a named range of a trace.

``serve_profile`` opens its window as such a range, one decode step after
the capture's start, because the capture's first CUDA graph replay can
reach the trace without its first kernels (ROADMAP §C14).  The traces
here are synthetic, in the capture's layout; on the card the same reader
holds each serve window's paged kernels against the launch counters.
This file imports no JAX.
"""

import gzip
import json

import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import chip_smoke

SPLIT, COMBINE = chip_smoke.PAGED_KERNELS


def _write_trace(logdir, events):
    run = logdir / "plugins" / "profile" / "r1"
    run.mkdir(parents=True)
    with gzip.open(run / "host.1.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
            "ts": ts, "dur": 5, "args": {"correlation": corr}}


def _device(cat, name, ts, corr, dur=10.0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _window(ts=100, dur=100):
    return {"ph": "X", "cat": "user_annotation",
            "name": chip_smoke.SERVE_WINDOW, "ts": ts, "dur": dur}


def test_window_kernels_reads_only_the_work_launched_in_the_range(tmp_path):
    events = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        _window(),
        # the warm step before the range: its replay lost a kernel
        _launch(50, 1), _device("kernel", SPLIT, 60, 1),
        # two replays inside the range, a copy, and the range's own
        # device-side annotation (no device work)
        _launch(120, 2), _device("kernel", SPLIT, 130, 2),
        _device("kernel", COMBINE, 140, 2, dur=2.0),
        _launch(150, 3), _device("kernel", SPLIT, 160, 3),
        _device("kernel", COMBINE, 170, 3, dur=2.0),
        _device("gpu_memcpy", "Memcpy HtoD", 152, 3, dur=1.0),
        _device("gpu_user_annotation", chip_smoke.SERVE_WINDOW, 100, 0,
                dur=100.0),
        # launched after the range closed
        _launch(250, 4), _device("kernel", SPLIT, 260, 4),
    ]
    _write_trace(tmp_path, events)
    ms, counts = chip_smoke.window_kernels(str(tmp_path),
                                           chip_smoke.SERVE_WINDOW)
    assert counts == {SPLIT: 2, COMBINE: 2, "Memcpy HtoD": 1}
    assert ms == pytest.approx({SPLIT: 0.02, COMBINE: 0.004,
                                "Memcpy HtoD": 0.001})
    assert chip_smoke.paged_instances(counts) == {SPLIT: 2, COMBINE: 2}


def test_window_kernels_sees_a_kernel_lost_inside_the_range(tmp_path):
    """A replay inside the range whose kernel record is missing shows as
    fewer instances than launches: the serve windows' check fails."""
    _write_trace(tmp_path, [
        _window(), _launch(120, 2), _device("kernel", COMBINE, 140, 2),
        _launch(150, 3), _device("kernel", SPLIT, 160, 3),
        _device("kernel", COMBINE, 170, 3)])
    _, counts = chip_smoke.window_kernels(str(tmp_path),
                                          chip_smoke.SERVE_WINDOW)
    assert chip_smoke.paged_instances(counts) == {SPLIT: 1, COMBINE: 2}


def test_window_kernels_wants_exactly_one_range(tmp_path):
    _write_trace(tmp_path, [_launch(120, 2), _device("kernel", SPLIT, 130, 2)])
    with pytest.raises(ValueError):
        chip_smoke.window_kernels(str(tmp_path), chip_smoke.SERVE_WINDOW)

"""The PyTorch port's compile-cache manager against the JAX reference
(``mxnet_tpu_torch/aot/cache.py`` over ``_build``'s nvcc build
directory).

Ports the cache cases of ``tests/test_aot.py`` (``:123-195``): entry
eviction oldest-access-first under ``max_entries`` and ``max_bytes``, a
stale toolkit namespace dropped wholesale and a fresh one kept, the
``statusz`` keys and the ``snapshot_to`` line schema of the reference's
``CompileCacheManager`` (read by ``tools/metrics_report.py``).  The
wiring: ``MXTPU_COMPILE_CACHE`` honoured at import (a subprocess) and
raising beside ``MXTPU_TORCH_BUILD_DIR``; ``build_library``'s miss ->
put -> hit counters and the mtime touch of a hit, a toolkit upgrade
starting a fresh namespace, a library built loading on a machine without
nvcc, ``MIN_COMPILE_SECS`` above 0 raising with its reason, and a
library pruned before its load built again.  This box has no nvcc: a
stub script under a temporary ``CUDA_HOME`` writes each output file,
which is never loaded.
"""

import json
import os
import subprocess
import sys
import time

import pytest

import torch_port_fixtures as fx

from mxnet_tpu.aot import cache as ref_cache
from mxnet_tpu_torch import _build
from mxnet_tpu_torch import telemetry as port_tel
from mxnet_tpu_torch.aot import cache
from mxnet_tpu_torch.telemetry import statusz

KNOBS = ("MXTPU_COMPILE_CACHE", "MXTPU_COMPILE_CACHE_MAX_BYTES",
         "MXTPU_COMPILE_CACHE_MAX_ENTRIES",
         "MXTPU_COMPILE_CACHE_MIN_COMPILE_SECS", "MXTPU_TORCH_BUILD_DIR")


@pytest.fixture(autouse=True)
def isolated(monkeypatch):
    """No knob from the environment, no active manager, the telemetry on
    and empty, and the process state restored after."""
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(cache, "_active", None)
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    monkeypatch.setattr(_build, "BUILD_LOGS", {})
    port_tel.reset()
    port_tel.enable()
    yield
    port_tel.disable()
    port_tel.reset()
    statusz.unregister("aot.compile_cache")


def _toolkit(tmp_path, release="12.4.131", name="cuda"):
    """A stub toolkit: ``bin/nvcc`` touches each ``-o`` output and logs
    its arguments; ``version.json`` names ``release`` (none if None)."""
    root = tmp_path / name
    (root / "bin").mkdir(parents=True)
    nvcc = root / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {root / "calls.txt"}\n'
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && echo lib > "$2"; shift; '
        "done\n")
    nvcc.chmod(0o755)
    if release is not None:
        (root / "version.json").write_text(json.dumps(
            {"cuda": {"version": release},
             "cuda_nvcc": {"version": release}}))
    return root


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """CUDA_HOME at a stub 12.4 toolkit and csrc/ at two tiny sources."""
    root = _toolkit(tmp_path)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setenv("CUDA_HOME", str(root))
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    return root


def _count(name):
    snap = port_tel.registry().snapshot()
    return sum(s["value"] for s in snap.get(name, {}).get("samples", ()))


def _counts():
    return tuple(_count(f"mxtpu_compile_cache_{k}")
                 for k in ("hits", "misses", "puts"))


def _plant(dir_, name, stamp, size=10):
    os.makedirs(dir_, exist_ok=True)
    path = os.path.join(dir_, name)
    with open(path, "wb") as f:
        f.write(b"x" * size)
    os.utime(path, (stamp, stamp))
    return path


# -- eviction -----------------------------------------------------------------
def test_cache_manager_eviction_policy(tmp_path, stub):
    """Entry-count eviction drops oldest-access first; a stale toolkit
    namespace is pruned wholesale, a recently touched one kept; a byte
    budget evicts oldest first (the reference's test over libraries)."""
    mgr = cache.CompileCacheManager(str(tmp_path / "cc"), max_entries=2)
    assert mgr.namespace == "nvcc-12.4-sm_90a"
    assert mgr.dir == str(tmp_path / "cc" / "nvcc-12.4-sm_90a")
    now = time.time()
    for i in range(4):
        _plant(mgr.dir, f"libf{i}-k{i}.so", now - 100 + i)
    _plant(mgr.dir, "libf9-k9.so.123.tmp", now - 500)   # not an entry
    fresh = _plant(str(tmp_path / "cc" / "nvcc-12.8-sm_90a"), "liblive-k.so",
                   now)
    stale_dir = str(tmp_path / "cc" / "nvcc-11.0-sm_90a")
    old = now - 15 * 86400
    _plant(stale_dir, "libold-k.so", old)
    os.utime(stale_dir, (old, old))
    removed = mgr.prune()
    assert removed >= 3              # 2 evictions + the stale namespace
    left = sorted(n for n in os.listdir(mgr.dir) if n.endswith(".so"))
    assert left == ["libf2-k2.so", "libf3-k3.so"]       # newest kept
    assert not os.path.exists(stale_dir)
    assert os.path.exists(fresh)
    assert os.path.exists(os.path.join(mgr.dir, "libf9-k9.so.123.tmp"))
    mgr2 = cache.CompileCacheManager(str(tmp_path / "cc"), max_bytes=10)
    assert mgr2.prune() >= 1
    assert [os.path.basename(p) for p, _, _ in mgr2._entries()] == [
        "libf3-k3.so"]


def test_eviction_follows_access_not_build_order(tmp_path, stub,
                                                 monkeypatch):
    """A hit touches the library's mtime: with two libraries and
    ``max_entries=1``, the one used last survives, not the one built
    last."""
    mgr = cache.enable(str(tmp_path / "cc"))
    first = _build.build_library("mxtt_first", ("a.cu",))
    second = _build.build_library("mxtt_second", ("b.cu",))
    for path, back in ((first, 200), (second, 100)):   # built in order
        os.utime(path, (time.time() - back,) * 2)
    assert _build.build_library("mxtt_first", ("a.cu",)) == first  # hit
    assert os.path.getmtime(first) > os.path.getmtime(second)
    assert _counts() == (1.0, 2.0, 2.0)
    mgr.max_entries = 1
    assert mgr.prune() == 1
    assert os.path.exists(first) and not os.path.exists(second)


# -- the reference's views ----------------------------------------------------
def test_statusz_keys_and_snapshot_schema_match_reference(tmp_path, stub):
    import mxnet_tpu.telemetry as ref_tel

    mgr = cache.enable(str(tmp_path / "port"), max_entries=3)
    _build.build_library("mxtt_a", ("a.cu",))
    _build.build_library("mxtt_a", ("a.cu",))
    ref_tel.reset()
    ref_tel.enable()
    try:
        ref = ref_cache.CompileCacheManager(str(tmp_path / "ref"),
                                            max_entries=3)
        os.makedirs(ref.dir)
        ref_tel.counter("mxtpu_compile_cache_hits",
                        "persistent compile-cache hits").inc()
        ref_tel.counter("mxtpu_compile_cache_misses",
                        "persistent compile-cache misses").inc()
        ref_tel.counter("mxtpu_compile_cache_puts",
                        "persistent compile-cache writes").inc()
        want_sz = ref.statusz()
        ref_line = json.loads(open(ref.snapshot_to()).read())
    finally:
        ref_tel.disable()
        ref_tel.reset()
    got_sz = statusz.snapshot()["aot.compile_cache"]
    assert set(got_sz) == set(want_sz)
    assert got_sz == dict(mgr.stats(), enabled=True, hits=1.0, misses=1.0,
                          puts=1.0)
    assert got_sz["entries"] == 1 and got_sz["max_entries"] == 3
    path = mgr.snapshot_to()
    assert path == os.path.join(mgr.dir, "cache_stats.jsonl")
    line = json.loads(open(path).read())
    assert set(line) == set(ref_line) == {"ts", "metrics"}
    assert set(line["metrics"]) == set(ref_line["metrics"])
    for name, fam in line["metrics"].items():
        want = ref_line["metrics"][name]
        assert set(fam) == set(want), name
        assert fam["kind"] == want["kind"]
        assert [set(s) for s in fam["samples"]] == [
            set(s) for s in want["samples"]], name
    sys.path.insert(0, os.path.join(fx.REPO, "tools"))
    import metrics_report

    metrics, _ = metrics_report.load_jsonl(path)
    assert metrics["mxtpu_compile_cache_dir_entries"]["samples"][0][
        "value"] == 1
    assert metrics["mxtpu_compile_cache_hits"]["samples"][0]["value"] == 1.0


# -- build_library through the manager ----------------------------------------
def test_build_library_miss_put_hit_and_touch(tmp_path, stub):
    mgr = cache.enable(str(tmp_path / "cc"))
    assert _build.build_dir() == mgr.dir
    lib = _build.build_library("mxtt_fake", ("a.cu",))
    assert os.path.dirname(lib) == mgr.dir
    assert _counts() == (0.0, 1.0, 1.0)
    calls = (stub / "calls.txt").read_text().splitlines()
    assert len(calls) == 2                      # one unit, one link
    stamp = time.time() - 3600
    os.utime(lib, (stamp, stamp))
    assert _build.build_library("mxtt_fake", ("a.cu",)) == lib
    assert _counts() == (1.0, 1.0, 1.0)
    assert os.path.getmtime(lib) > stamp + 3000  # the hit touched it
    assert len((stub / "calls.txt").read_text().splitlines()) == 2
    assert mgr.stats()["entries"] == 1


def test_toolkit_upgrade_starts_a_fresh_namespace(tmp_path, stub,
                                                  monkeypatch):
    """Another nvcc release: another namespace and another library name,
    so a library of the old toolkit is never loaded as a hit; the old
    namespace ages out by ``prune``."""
    base = str(tmp_path / "cc")
    old_mgr = cache.enable(base)
    old_lib = _build.build_library("mxtt_fake", ("a.cu",))
    new_root = _toolkit(tmp_path, release="12.8.93", name="cuda-12.8")
    monkeypatch.setenv("CUDA_HOME", str(new_root))
    monkeypatch.setattr(cache, "_active", None)
    new_mgr = cache.enable(base)
    assert new_mgr.namespace == "nvcc-12.8-sm_90a" != old_mgr.namespace
    new_lib = _build.build_library("mxtt_fake", ("a.cu",))
    assert os.path.basename(new_lib) != os.path.basename(old_lib)
    assert _counts() == (0.0, 2.0, 2.0)
    assert new_mgr.prune() == 0                 # the old one is recent
    old = time.time() - 15 * 86400
    os.utime(old_lib, (old, old))
    os.utime(old_mgr.dir, (old, old))
    assert new_mgr.prune() == 1
    assert not os.path.exists(old_mgr.dir) and os.path.exists(new_lib)


def test_toolkit_tag_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    json_root = _toolkit(tmp_path, release="12.9.86", name="j")
    assert _build.toolkit_tag(str(json_root / "bin" / "nvcc")) == "12.9"
    hdr_root = _toolkit(tmp_path, release=None, name="h")
    (hdr_root / "include").mkdir()
    (hdr_root / "include" / "cuda.h").write_text(
        "#ifndef __cuda_cuda_h__\n#define CUDA_VERSION 12090\n#endif\n")
    assert _build.toolkit_tag(str(hdr_root / "bin" / "nvcc")) == "12.9"
    bare = _toolkit(tmp_path, release=None, name="b")
    tag = _build.toolkit_tag(str(bare / "bin" / "nvcc"))
    assert tag.startswith("x") and len(tag) == 9
    monkeypatch.setenv("CUDA_HOME", str(json_root))
    assert _build.namespace() == "nvcc-12.9-sm_90a"
    _no_nvcc(monkeypatch, tmp_path)
    assert _build.namespace() == "nvcc-none-sm_90a"


def test_min_compile_secs_above_zero_raises(tmp_path, stub):
    """Every entry is an nvcc library that takes seconds to build: a
    threshold above 0 raises with that reason, 0 is the default."""
    for secs in (0.5, 60.0):
        with pytest.raises(ValueError, match="MIN_COMPILE_SECS.*nvcc"):
            cache.CompileCacheManager(str(tmp_path / "cc"),
                                      min_compile_secs=secs)
    assert cache.active() is None
    assert cache.enable(str(tmp_path / "cc"),
                        min_compile_secs=0).min_compile_secs == 0.0


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    real_isfile = os.path.isfile
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False
                        if p.endswith("nvcc") else real_isfile(p))
    assert _build._find_nvcc() is None


@pytest.mark.parametrize("managed", [False, True])
def test_a_built_library_loads_without_nvcc(tmp_path, stub, monkeypatch,
                                            managed):
    """A machine without the toolkit loads a library already built, in a
    plain build directory or in the cache's namespace used last (of two
    toolkits', the one touched last), as a hit; a library never built
    raises ``nvcc not found``."""
    base = str(tmp_path / "cc")
    if managed:
        cache.enable(base)
    else:
        monkeypatch.setenv("MXTPU_TORCH_BUILD_DIR", base)
    old = _build.build_library("mxtt_fake", ("a.cu",))
    monkeypatch.setenv("CUDA_HOME", str(_toolkit(tmp_path, "12.8.93",
                                                 "cuda-12.8")))
    if managed:
        monkeypatch.setattr(cache, "_active", None)
        cache.enable(base)
    new = _build.build_library("mxtt_fake", ("a.cu",))
    assert new != old and (os.path.dirname(new) != os.path.dirname(old)
                           ) is managed
    stamp = time.time() - 3600
    os.utime(old, (stamp - 60,) * 2)
    os.utime(new, (stamp,) * 2)
    _no_nvcc(monkeypatch, tmp_path)
    if managed:
        monkeypatch.setattr(cache, "_active", None)
        assert cache.enable(base).namespace == "nvcc-12.8-sm_90a"
    assert _build.build_library("mxtt_fake", ("a.cu",)) == new
    assert os.path.getmtime(new) > stamp + 3000     # touched
    assert _counts() == (1.0, 2.0, 2.0)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library("mxtt_other", ("b.cu",))


def test_library_pruned_before_its_load_is_built_again(tmp_path, stub,
                                                       monkeypatch):
    """A prune that unlinks a library between its hit and its load
    (another process enforcing the budget) costs a rebuild, not a
    failure."""
    cache.enable(str(tmp_path / "cc"))
    lib = _build.build_library("mxtt_fake", ("a.cu",))
    loads = []

    def cdll(path):
        loads.append(path)
        if len(loads) == 1:
            os.remove(path)                  # pruned by another process
            raise OSError(f"{path}: cannot open shared object file")
        return object()

    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    monkeypatch.setattr(_build, "_LOADED", {})
    assert _build.load_library("mxtt_fake", ("a.cu",)) is not None
    assert loads == [lib, lib] and os.path.exists(lib)
    assert _counts() == (1.0, 2.0, 2.0)         # the hit, then a rebuild


# -- the env wiring -----------------------------------------------------------
_PROBE = r"""
import json, os, sys
import mxnet_tpu_torch
from mxnet_tpu_torch import _build
from mxnet_tpu_torch.aot import cache
from mxnet_tpu_torch.telemetry import statusz
mgr = cache.active()
print(json.dumps({"dir": _build.build_dir(), "mgr_dir": mgr.dir,
                  "namespace": mgr.namespace,
                  "exists": os.path.isdir(mgr.dir),
                  "max_bytes": mgr.max_bytes, "max_entries": mgr.max_entries,
                  "min": mgr.min_compile_secs,
                  "statusz": sorted(statusz.snapshot()["aot.compile_cache"]),
                  "built": sorted(_build.BUILD_SECONDS),
                  "jax": "jax" in sys.modules}))
"""


def _probe(env_extra, tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in KNOBS}
    env.update(PYTHONPATH=fx.REPO, CUDA_HOME=str(_toolkit(tmp_path)),
               **env_extra)
    return subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, cwd=str(tmp_path),
                          timeout=300)


def test_compile_cache_env_is_honoured_at_import(tmp_path):
    base = str(tmp_path / "cc")
    out = _probe({"MXTPU_COMPILE_CACHE": base,
                  "MXTPU_COMPILE_CACHE_MAX_BYTES": "4096",
                  "MXTPU_COMPILE_CACHE_MAX_ENTRIES": "3",
                  "MXTPU_COMPILE_CACHE_MIN_COMPILE_SECS": "0"}, tmp_path)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    want_dir = os.path.join(base, "nvcc-12.4-sm_90a")
    assert got["dir"] == got["mgr_dir"] == want_dir and got["exists"]
    assert (got["max_bytes"], got["max_entries"], got["min"]) == (4096, 3,
                                                                  0.0)
    assert got["statusz"] == sorted(["dir", "entries", "bytes", "max_bytes",
                                     "max_entries", "enabled", "hits",
                                     "misses", "puts"])
    assert got["built"] == [] and got["jax"] is False


def test_both_build_dir_knobs_raise(tmp_path):
    out = _probe({"MXTPU_COMPILE_CACHE": str(tmp_path / "cc"),
                  "MXTPU_TORCH_BUILD_DIR": str(tmp_path / "b")}, tmp_path)
    assert out.returncode != 0
    assert "ValueError" in out.stderr
    assert "MXTPU_COMPILE_CACHE" in out.stderr
    assert "MXTPU_TORCH_BUILD_DIR" in out.stderr


def test_min_compile_secs_env_raises_at_import(tmp_path):
    out = _probe({"MXTPU_COMPILE_CACHE": str(tmp_path / "cc"),
                  "MXTPU_COMPILE_CACHE_MIN_COMPILE_SECS": "0.5"}, tmp_path)
    assert out.returncode != 0
    assert "ValueError" in out.stderr
    assert "MXTPU_COMPILE_CACHE_MIN_COMPILE_SECS" in out.stderr


def test_build_dir_knob_set_after_enable_raises(tmp_path, stub,
                                                monkeypatch):
    cache.enable(str(tmp_path / "cc"))
    monkeypatch.setenv("MXTPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(ValueError, match="MXTPU_TORCH_BUILD_DIR"):
        _build.build_dir()
    with pytest.raises(ValueError, match="MXTPU_COMPILE_CACHE"):
        cache.CompileCacheManager(str(tmp_path / "cc2")).enable()


def test_enable_is_idempotent_per_dir_and_env_unset_is_off(tmp_path, stub):
    assert cache.enable_from_env() is None and cache.active() is None
    mgr = cache.enable(str(tmp_path / "cc"))
    assert cache.enable(str(tmp_path / "cc")) is mgr
    other = cache.enable(str(tmp_path / "cc2"))
    assert other is not mgr and cache.active() is other
    assert ref_cache.CompileCacheManager.STALE_NAMESPACE_DAYS == \
        cache.CompileCacheManager.STALE_NAMESPACE_DAYS == 14

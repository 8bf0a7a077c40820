"""Run one fleet replica as a process: the port's ``serve.Engine`` behind
``fleet.ReplicaServer`` (/generate, /healthz, /drain, /statusz.json, ...).

    python -m mxnet_tpu_torch.fleet.serve_replica [--device cuda|cpu] ...

The process target ``fleet.Supervisor`` spawns, with the reference
process front's flags and ready line (``tools/serve_replica.py``), plus
``--device`` (default ``cuda``, which raises without a card) and
``--dtype``.  It builds a random GPT deterministically from ``--seed``:
the weights are the reference front's numpy draw (``RandomState(seed)``,
the gpt() argument order, the same scales), so every replica started
with the same model flags and seed, of either package, holds the same
float32 weights, and router retries are token-identical.

Startup is warm when the AOT env is set: ``MXTPU_AOT_DIR`` loads the
exported bucket programs instead of tracing them, and
``MXTPU_WARMUP_MANIFEST`` makes the engine build (on CUDA, capture)
every program the manifest lists before the ready line prints (the
drain -> restart path of a rolling restart).  The kernel libraries load
from ``MXTPU_TORCH_BUILD_DIR``: a parent that builds them first spares
every child its ``nvcc`` runs.

Faults: ``MXTPU_FAULT_SPEC`` arms the chaos injector; a *kill* fault here
is a real ``os._exit(1)`` mid-request.

Prints exactly one ready line to stdout once serving::

  {"ready": true, "port": N, "host": ..., "pid": ..., "replica_id":
   ..., "backend": "cuda", "device_name": ..., "ready_s": 1.23,
   "warmed": 10, ...}

then serves until SIGTERM/SIGINT (clean engine shutdown), the process is
killed, or, with ``--exit-on-drained``, a requested drain completes
(exit 0).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys
import time

import numpy as np

from ..models import gpt_arguments

_DTYPES = ("float32", "bfloat16")


def build_model(args):
    """``(gpt() config dict, numpy float32 params)`` from the CLI model
    flags: the reference front's draw, value for value (the gpt()
    argument order, a tied embedding drawn twice and the second draw
    kept, 0.35 for weights, 0 plus 1 for norm gains elsewhere)."""
    kv = args.kv_heads or max(1, args.heads // 4)
    cfg = dict(num_layers=args.layers, d_model=args.d_model,
               num_heads=args.heads, norm="rmsnorm", mlp="swiglu",
               pos_embed="rope", tie_embeddings=True, kv_heads=kv)
    rng = np.random.RandomState(args.seed)
    params = {}
    for name, shp in gpt_arguments(args.vocab, args.max_model_len, **cfg):
        # 0.35 weight scale gives greedy argmax varied (non-degenerate)
        # token sequences — the same recipe the serve tests use
        scale = 0.35 if name.endswith("weight") else 0.0
        params[name] = (rng.randn(*shp) * scale
                        + (1.0 if name.endswith("gamma") else 0.0)
                        ).astype(np.float32)
    return cfg, params


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="0 = ephemeral (read the ready line)")
    p.add_argument("--replica-id", default=None)
    # model config (all replicas of one fleet share these + --seed)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--d-model", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--kv-heads", type=int, default=None)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--version", default=None,
                   help="deploy identity tag (default: a short digest of "
                        "the model config + seed)")
    # engine config
    p.add_argument("--block-size", type=int, default=8)
    p.add_argument("--num-blocks", type=int, default=128)
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-queue", type=int, default=32)
    p.add_argument("--max-model-len", type=int, default=64)
    p.add_argument("--max-prefills", type=int, default=2)
    p.add_argument("--tenant-share", type=float, default=None)
    p.add_argument("--role", choices=("both", "prefill", "decode"),
                   default=None,
                   help="disaggregation role (default MXTPU_FLEET_ROLE "
                        "/ both)")
    p.add_argument("--host-kv-bytes", type=int, default=None,
                   help="host KV tier bytes (default "
                        "MXTPU_SERVE_HOST_KV_BYTES; a decode role without "
                        "one gets 256 MiB)")
    p.add_argument("--warmup", choices=("auto", "full", "none"),
                   default="auto",
                   help="auto: replay MXTPU_WARMUP_MANIFEST when set; "
                        "full: the whole bucket grid; none: capture on "
                        "traffic")
    p.add_argument("--model", default=None,
                   help="catalog model id (default MXTPU_FLEET_MODEL)")
    p.add_argument("--adapters", type=int, default=None)
    p.add_argument("--adapter-rank", type=int, default=None)
    p.add_argument("--exit-on-drained", action="store_true",
                   help="exit 0 once a requested drain completes")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--backend", "--platform", dest="platform",
                   default=None,
                   help="the reference front's platform flag: cpu, or "
                        "gpu/cuda (--device wins)")
    p.add_argument("--dtype", choices=_DTYPES, default=None,
                   help="parameter dtype (default: float32, the draw's)")
    return p.parse_args(argv)


def _device(args):
    if args.device:
        return args.device
    if args.platform in (None, "gpu", "cuda"):
        return "cuda"
    if args.platform == "cpu":
        return "cpu"
    raise SystemExit(f"--backend {args.platform!r}: the port runs on "
                     "cuda or cpu")


def main(argv=None):
    args = parse_args(argv)
    t0 = time.perf_counter()
    import torch

    from ..context import resolve_device
    from ..fleet import DEAD, ReplicaServer
    from ..serve import Engine

    device = resolve_device(_device(args))
    cfg, params = build_model(args)
    role = args.role or os.environ.get("MXTPU_FLEET_ROLE") or "both"
    host_kv = args.host_kv_bytes
    if host_kv is None and role == "decode" \
            and not os.environ.get("MXTPU_SERVE_HOST_KV_BYTES"):
        # a decode replica ingests handoff KV into the host tier
        host_kv = 256 << 20
    engine = Engine(
        params, num_heads=cfg["num_heads"], window=0, device=device,
        dtype=getattr(torch, args.dtype) if args.dtype else None,
        block_size=args.block_size, num_blocks=args.num_blocks,
        max_batch=args.max_batch, max_queue=args.max_queue,
        max_model_len=args.max_model_len,
        max_prefills_per_step=args.max_prefills,
        tenant_share=args.tenant_share, host_kv_bytes=host_kv,
        adapters=args.adapters, adapter_rank=args.adapter_rank)
    warmed = 0
    if args.warmup == "full" or (
            args.warmup == "auto"
            and os.environ.get("MXTPU_WARMUP_MANIFEST")):
        warmed = engine.warmup()

    version = args.version
    if version is None:
        # the weights are a pure function of the model flags + seed
        c = (f"{args.layers}/{args.d_model}/{args.heads}/"
             f"{args.kv_heads}/{args.vocab}/{args.max_model_len}/"
             f"{args.seed}")
        version = "cfg-" + hashlib.sha1(c.encode()).hexdigest()[:10]

    replica = ReplicaServer(
        engine, host=args.host, port=args.port,
        replica_id=args.replica_id, role=role, version=version,
        model=args.model,
        on_kill=lambda: os._exit(1))       # a kill fault is a real death
    replica.start()

    def _term(signum, frame):
        replica.stop()
        sys.exit(0)

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    print(json.dumps({
        "ready": True, "port": replica.port, "host": args.host,
        "pid": os.getpid(), "replica_id": replica.replica_id,
        "role": replica.role,
        "version": replica.version,
        "model": replica.model,
        "backend": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "dtype": str(engine.cache_dtype).replace("torch.", ""),
        "ready_s": round(time.perf_counter() - t0, 3),
        "warmed": warmed,
        "aot_dir": os.environ.get("MXTPU_AOT_DIR") or None,
        "fault_spec": os.environ.get("MXTPU_FAULT_SPEC") or None}),
        flush=True)

    while replica.state != DEAD:
        if args.exit_on_drained and replica.drained():
            time.sleep(0.2)        # let the drain's last polls see it
            replica.stop()
            return 0
        time.sleep(0.1)
    return 1        # hard-stopped (engine step failure): restart it


if __name__ == "__main__":
    sys.exit(main())

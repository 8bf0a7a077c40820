"""Registers and spills of a CUDA unit built with lines changed, and with
``--flash`` or ``--rnn`` the flash or fused-RNN kernels' float32 checks and
times on that build.

    python3 chip_ptxas_probe.py flash_dkv_f32tc.cu \
        "constexpr int D = 64;" "constexpr int D = 128;"

copies ``mxnet_tpu_torch/csrc/`` into a temporary directory, replaces
each OLD string (which must occur once) by the NEW one after it in the
named unit (or, with ``--file NAME``, in that source, a header the unit
includes), compiles that unit with the port's nvcc flags (``-Xptxas
-v``, sm_90a) and prints ptxas's report: what a limit such as a head dim
would cost before a kernel is built for it.

With ``--flash`` it then builds the port's flash library from the changed
sources (into a temporary build directory) and runs chip_smoke.py's
float32 flash checks at ``train`` and ``train_fused`` and its float32
timings at ``train`` on it, printing their JSON rows: a variant's ms and
its share of the float32 bound, beside the unit as built (run it with no
OLD NEW pairs, in the same call).  With ``--rnn`` it builds the fused-RNN
library from the changed sources and runs chip_smoke.py's float32 RNN
checks at the main shape and its float32 RNN timings, for the LSTM and the
GRU:

    python3 chip_ptxas_probe.py --rnn --file fused_rnn_bwd_f32tc.cuh \
        fused_lstm_bwd_f32tc.cu "constexpr int KG = 4;" \
        "constexpr int KG = 16;"

builds and times a draft of the float32 backward (a changed header
reaches both gate counts' units; the forward's, fused_rnn_fwd_f32tc.cuh
with fused_lstm_fwd_f32tc.cu, the same way); a run with no OLD NEW pairs
times the kernels as built.  Options go before the unit.  A failed check
is printed and the timing goes on.  Needs nvcc (the card's machine) and, with ``--flash`` or
``--rnn``, the card; exits 1 if a string is not found once or the
compile fails.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mxnet_tpu_torch import _build  # noqa: E402


def run_flash(csrc, build):
    """chip_smoke.py's float32 flash checks and timings on the library
    built from ``csrc``."""
    import torch

    import chip_smoke as cs

    os.environ[_build.ENV_BUILD_DIR] = build
    _build.CSRC_DIR = csrc
    print(json.dumps({"card": cs.card_line()}), flush=True)
    for tag in ("train", "train_fused"):
        try:
            cs.check_flash(tag, cs.FLASH_SHAPES[tag], torch.float32)
        except SystemExit as e:
            print(json.dumps({"check_failed": str(e)}), flush=True)
    cs.time_flash(cs.FLASH_SHAPES["train"], torch.float32)


def run_rnn(csrc, build):
    """chip_smoke.py's float32 fused-RNN checks at the main shape and its
    float32 timings on the library built from ``csrc``."""
    import torch

    import chip_smoke as cs

    os.environ[_build.ENV_BUILD_DIR] = build
    _build.CSRC_DIR = csrc
    print(json.dumps({"card": cs.card_line()}), flush=True)
    for mode in ("lstm", "gru"):
        try:
            cs.check_rnn(mode, "main", torch.float32)
        except SystemExit as e:
            print(json.dumps({"check_failed": str(e)}), flush=True)
    for mode in ("lstm", "gru"):
        cs.time_rnn(mode, torch.float32)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("unit", help="a .cu file under mxnet_tpu_torch/csrc/")
    ap.add_argument("edits", nargs="*", metavar="OLD NEW",
                    help="text to replace (once in the unit), its "
                         "replacement; as many pairs as needed")
    ap.add_argument("--flash", action="store_true",
                    help="run chip_smoke.py's float32 flash checks and "
                         "timings on the changed build")
    ap.add_argument("--rnn", action="store_true",
                    help="run chip_smoke.py's float32 fused-RNN checks and "
                         "timings on the changed build")
    ap.add_argument("--file", default=None,
                    help="the source under csrc/ the edits apply to "
                         "(default: the unit)")
    args = ap.parse_args()
    if len(args.edits) % 2:
        ap.error("OLD and NEW come in pairs")
    pairs = list(zip(args.edits[::2], args.edits[1::2]))
    with tempfile.TemporaryDirectory() as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(_build.CSRC_DIR, csrc)
        edited = args.file or args.unit
        path = os.path.join(csrc, edited)
        with open(path) as f:
            text = f.read()
        for old, new in pairs:
            if text.count(old) != 1:
                print(f"{old!r} occurs {text.count(old)} times in "
                      f"{edited}", file=sys.stderr)
                return 1
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        path = os.path.join(csrc, args.unit)
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                              os.path.join(tmp, "probe.o"), path],
                             capture_output=True, text=True)
        for old, new in pairs:
            print(f"{edited}: {old!r} -> {new!r}")
        print((res.stdout + res.stderr).strip(), flush=True)
        if res.returncode:
            return 1
        if args.flash:
            run_flash(csrc, os.path.join(tmp, "build"))
        if args.rnn:
            run_rnn(csrc, os.path.join(tmp, "build"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

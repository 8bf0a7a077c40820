"""Registers and spills of a CUDA unit built with one line changed.

    python3 chip_ptxas_probe.py flash_dkv_f32tc.cu \
        "constexpr int D = 64;" "constexpr int D = 128;"

copies ``mxnet_tpu_torch/csrc/`` into a temporary directory, replaces the
first string (which must occur once) by the second in the named unit,
compiles that unit with the port's nvcc flags (``-Xptxas -v``, sm_90a)
and prints ptxas's report: what a limit such as a head dim would cost
before a kernel is built for it.  Needs nvcc (the card's machine); exits
1 if the string is not found once or the compile fails.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from mxnet_tpu_torch import _build  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("unit", help="a .cu file under mxnet_tpu_torch/csrc/")
    ap.add_argument("old", help="text to replace (once in the unit)")
    ap.add_argument("new", help="its replacement")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        csrc = os.path.join(tmp, "csrc")
        shutil.copytree(_build.CSRC_DIR, csrc)
        path = os.path.join(csrc, args.unit)
        with open(path) as f:
            text = f.read()
        if text.count(args.old) != 1:
            print(f"{args.old!r} occurs {text.count(args.old)} times in "
                  f"{args.unit}", file=sys.stderr)
            return 1
        with open(path, "w") as f:
            f.write(text.replace(args.old, args.new))
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                              os.path.join(tmp, "probe.o"), path],
                             capture_output=True, text=True)
    print(f"{args.unit}: {args.old!r} -> {args.new!r}")
    print((res.stdout + res.stderr).strip())
    return 1 if res.returncode else 0


if __name__ == "__main__":
    sys.exit(main())

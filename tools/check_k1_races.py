"""Does the block-Thomas kernel (K1) give the same bits on every launch?

Launches each kernel of ``dlp_admm_torch/solvers/thomas.py`` on one fixed
KKT-style system (``chip_smoke.make_system``, seed 0) at the shapes the
float32 flagship and the multi-vehicle path give it:

* (2, 7, 19) float32, equilibrated: the warp kernel as float32 runs it;
* (2, 7, 19) float64, plain: the warp kernel as float64 runs it;
* (4, 7, 43) float64 and float32 (equilibrated): the wide kernel;

first once alone, then ``--reps`` times, each launch after other work on
the card that leaves other values in shared memory and other blocks in
flight (products and reductions of random sizes) and, every other launch,
from freshly allocated output and scratch over memory filled with NaN
bytes. A race between the kernel's threads, or a read of shared or device
memory the kernel did not write first, shows as an output whose bits differ
from the first launch's.

``--sanitize racecheck,initcheck`` also runs this script once more per tool
under the CUDA toolkit's ``compute-sanitizer`` (one launch per case) and
prints the end of its report.

Usage: python3 tools/check_k1_races.py [--reps N] [--sanitize TOOL,...]
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import chip_smoke  # noqa: E402
from check_torch_window import poison_allocator  # noqa: E402
from dlp_admm_torch.solvers import thomas  # noqa: E402

CASES = (((2, 7, 19), torch.float32, True),
         ((2, 7, 19), torch.float64, False),
         ((4, 7, 43), torch.float64, False),
         ((4, 7, 43), torch.float32, True))


def disturb(rng, dev):
    """Other work on the card between two launches."""
    n = int(rng.integers(16, 512))
    a = torch.randn(n, n, device=dev)
    (a @ a).softmax(-1).sum()
    garbage = torch.full((int(rng.integers(1, 64)) << 16,), 255,
                         dtype=torch.uint8, device=dev)
    del garbage


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--sanitize", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    dev = torch.device("cuda")
    thomas.build()
    rng = np.random.default_rng(1)
    for shape, dtype, eq in CASES:
        d, u, r = (torch.as_tensor(a, dtype=dtype, device=dev)
                   for a in chip_smoke.make_system(
                       np.random.default_rng(0), *shape, "kkt_saddle"))
        bits = torch.int64 if dtype == torch.float64 else torch.int32
        first = thomas.block_thomas_solve(d, u, r, eq).clone()
        torch.cuda.synchronize()
        differ = 0
        for i in range(args.reps):
            disturb(rng, dev)
            if i % 2:
                poison_allocator(dev)
            got = thomas.block_thomas_solve(d, u, r, eq)
            if not torch.equal(got.view(bits), first.view(bits)):
                differ += 1
        torch.cuda.synchronize()
        print(json.dumps(dict(
            shape=list(shape), dtype=str(dtype)[6:], equilibrate=eq,
            kernel=thomas.kernel_plan(*shape, dtype, eq)["kernel"],
            launches=args.reps + 1, launches_with_other_bits=differ,
            finite=bool(torch.isfinite(first).all()))), flush=True)
    for tool in [t for t in args.sanitize.split(",") if t]:
        exe = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/" \
            "compute-sanitizer"
        cmd = [exe, "--tool", tool, sys.executable, os.path.abspath(__file__),
               "--reps", "0"]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
            text, rc = out.stdout + out.stderr, out.returncode
        except (OSError, subprocess.TimeoutExpired) as e:
            text, rc = f"{type(e).__name__}: {e}", None
        print(f"compute-sanitizer --tool {tool}: exit {rc}\n"
              + "\n".join(text.splitlines()[-25:]), flush=True)
    print(chip_smoke.nvidia_smi())


if __name__ == "__main__":
    main()

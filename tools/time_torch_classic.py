"""Time the classic PI-ADMM layout of the PyTorch port, ``run_pi_admm()``'s
default (2 vehicles crossing, horizon 5, 45 MPC steps, float64).

Runs the default run once on ``--device`` (``cpu`` or ``cuda``) between two
synchronizes and prints one JSON line: ADMM iterations (the reference's
``sum_iter_num``), wall seconds, seconds per iteration, the CPU threads
torch uses, and on a card ``nvidia-smi``'s name and power limit.

Usage: python3 tools/time_torch_classic.py [--device cpu|cuda]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dlp_admm_torch.mpc import run_pi_admm  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    cuda = args.device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    t0 = time.perf_counter()
    res = run_pi_admm(device=args.device)
    sync()
    wall = time.perf_counter() - t0
    n = int(res.metrics.total_iterations)
    row = dict(device=args.device, iterations=n, wall_s=wall,
               s_per_iteration=wall / n, threads=torch.get_num_threads())
    if cuda:
        row["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    print(json.dumps(row))


if __name__ == "__main__":
    main()

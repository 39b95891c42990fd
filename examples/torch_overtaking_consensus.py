"""Flagship demo on the PyTorch port: consensus-ADMM OBCA overtaking of 2
vehicles (the counterpart of ``overtaking_consensus.py``, the reference's
``Distributed_planner/decentralized_overtaking_ADMM.py``).

Runs on the CUDA card, where every KKT solve of the staged interior-point
solver is the hand-written block-Thomas kernel; ``--device cpu`` is the only
way to the CPU (the kernel's plain version), and without a card the default
raises.

Run:  python examples/torch_overtaking_consensus.py [--steps N] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from dlp_admm_torch.config import (  # noqa: E402
    Formulation, ObcaConfig, SolverConfig)
from dlp_admm_torch.mpc import run_obca  # noqa: E402


def main(n_steps: int = 30, device=None, plot_path=None):
    """Run ``n_steps`` MPC steps; print the summary and the closest
    approach; return the ``RunResult``."""
    res = run_obca(
        Formulation.CONSENSUS,
        ocfg=ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                        max_admm_iters=15),
        scfg=SolverConfig(ip_iters=40, ip_tol=1e-6),
        n_steps=n_steps, plot_path=plot_path, device=device)
    d = np.linalg.norm(res.states[:, 0, :2] - res.states[:, 1, :2], axis=1)
    print(res.metrics.summary())
    print("min inter-vehicle distance: %.2f m" % d.min())
    if plot_path:
        print(f"trajectory plot: {plot_path}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    a = ap.parse_args()
    main(a.steps, a.device, plot_path="overtaking_consensus.png")

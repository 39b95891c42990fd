"""PI-ADMM demo on the PyTorch port: 2-vehicle intersection crossing with
adaptive-rho PI duals (the counterpart of ``crossing_pi_admm.py``).

Runs on the CUDA card; ``--device cpu`` is the only way to the CPU, and
without a card the default raises. Switch the layout with the first
argument (``classic``, the reference's ``casadi_old_PI_ADMM/main.py``, or
``pairwise``, its ``casadi/main.py``).

Run:  python examples/torch_crossing_pi_admm.py [classic|pairwise]
          [--steps N] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

from dlp_admm_torch.config import SolverConfig  # noqa: E402
from dlp_admm_torch.mpc import run_pi_admm  # noqa: E402


def main(layout: str = "pairwise", n_steps=None, device=None,
         plot_path=None):
    """Run the crossing (all its MPC steps unless ``n_steps``); print the
    run's summary and the closest approach; return the ``RunResult``."""
    res = run_pi_admm(scfg=SolverConfig(qp_iters=200, qp_tol=1e-7),
                      layout=layout, n_steps=n_steps, device=device,
                      plot_path=plot_path)
    d = np.linalg.norm(res.states[:, 0, :2] - res.states[:, 1, :2], axis=1)
    print(res.metrics.summary())
    print("min inter-vehicle distance: %.2f m" % d.min())
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("layout", nargs="?", default="pairwise",
                    choices=("classic", "pairwise"))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    a = ap.parse_args()
    main(a.layout, a.steps, a.device, plot_path=f"crossing_{a.layout}.png")

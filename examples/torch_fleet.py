"""Fleet demo on the PyTorch port: the consensus-OBCA flagship on the CUDA
card, a single run and a scenario batch (the counterpart of
``flagship_tpu_fleet.py``).

The production configuration: the 42-step overtaking run in float32
(equilibrated stage solves in the block-Thomas kernel, annealed local
prox; ``bench.py``'s float32 profile), then a 16-scenario perturbed batch
through ``parallel.consensus_spmd.run_scenario_batch``. The profile is the
same on every device: ``--device cpu`` runs it on the CPU (slowly), and
without a card the default raises.

Run:  python examples/torch_fleet.py [--steps N] [--batch-steps N]
          [--scenarios S] [--device cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dlp_admm_torch.config import ObcaConfig, SolverConfig  # noqa: E402
from dlp_admm_torch.models.obca import ConsensusObcaPlanner  # noqa: E402
from dlp_admm_torch.parallel import run_scenario_batch  # noqa: E402


def main(n_steps=None, batch_steps: int = 20, n_scen: int = 16,
         device=None, max_admm_iters: int = 50):
    """The single run (all 42 steps unless ``n_steps``) and the batch of
    ``n_scen`` scenarios over ``batch_steps`` steps, at the profile's ADMM
    cap unless ``max_admm_iters``; prints both and returns ``(single run
    outputs, batch outputs)``."""
    pl = ConsensusObcaPlanner(
        ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                   max_admm_iters=max_admm_iters),
        scfg=SolverConfig(ip_iters=40, ip_tol=1e-4),
        local_prox=700.0, prox_growth=1.5, prox_tau_max=1.0e9,
        dtype=torch.float32, device=device)
    name = (torch.cuda.get_device_name(pl.device)
            if pl.device.type == "cuda" else "cpu")
    print(f"device: {name}  dtype=float32")

    # single run: the reference's overtaking MPC
    t0 = time.time()
    single = pl.run_scan(n_steps)
    states, its, prs, dus, _ = single
    d = np.linalg.norm(states[:, 0, :2] - states[:, 1, :2], axis=-1)
    res_ok = int(((prs <= 0.01) & (dus <= 0.01)).sum())
    print(f"single run: {len(its)} steps in {time.time() - t0:.1f}s "
          f"(kernel builds included), res_ok {res_ok}/{len(its)}, min "
          f"distance {d.min():.2f} m")

    # fleet batch: perturbed scenarios through the batched step
    rng = np.random.default_rng(0)
    init0 = pl.refs[:, 0, :].double().cpu().numpy()
    inits = np.broadcast_to(init0, (n_scen,) + init0.shape).copy()
    inits[1:, :, :2] += 0.25 * rng.normal(size=(n_scen - 1, 2, 2))
    t0 = time.time()
    batch = run_scenario_batch(pl, inits, batch_steps)
    st, its_b, prs_b, dus_b, _, gaps = batch
    p = st[..., :2]
    d_lane = np.linalg.norm(p[:, :, 0] - p[:, :, 1], axis=-1).min(axis=0)
    print(f"fleet batch: {n_scen} scenarios x {batch_steps} steps in "
          f"{time.time() - t0:.1f}s, {int(its_b.sum())} consensus "
          f"iterations, per-lane min distance {d_lane.min():.2f}-"
          f"{d_lane.max():.2f} m, gap median {np.median(gaps):.4f}")
    return single, batch


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-steps", type=int, default=20)
    ap.add_argument("--scenarios", type=int, default=16)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    a = ap.parse_args()
    main(a.steps, a.batch_steps, a.scenarios, a.device)

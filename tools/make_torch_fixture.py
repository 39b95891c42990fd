"""Write the JAX reference run that the PyTorch port is held against.

Runs the consensus-OBCA flagship profile (2-vehicle overtaking, horizon 8,
rho 100, ADMM cap 50, annealed local prox 700 x 1.5, staged IP with
``ip_iters=40``, ``ip_tol=1e-6``) on the CPU in float64 through
``ConsensusObcaPlanner.run_scan(return_health=True)``, all 42 MPC steps, and
saves ``tests/data/consensus_obca_f64_ref.npz``:

    states [43, 2, 5], iterations [42], primal [42], dual [42],
    nlp_ok [42, 2], nlp_kkt [42, 2], gaps [42],
    profile (JSON string), commit (git revision of the tree that ran it)

``tests/test_torch_obca.py`` and ``chip_smoke.py`` read it.

Usage: python tools/make_torch_fixture.py [--steps N] [--out PATH]
"""
import argparse
import json
import os
import subprocess
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dlp_admm_tpu.config import ObcaConfig, SolverConfig  # noqa: E402
from dlp_admm_tpu.models.obca import ConsensusObcaPlanner  # noqa: E402

PROFILE = dict(
    ocfg=dict(horizon=8, min_dis=0.1, rho=100.0, max_admm_iters=50),
    scfg=dict(ip_iters=40, ip_tol=1e-6),
    planner=dict(local_prox=700.0, prox_growth=1.5, prox_tau_max=3.0e10),
    dtype="float64",
)
DEFAULT_OUT = os.path.join(ROOT, "tests", "data",
                           "consensus_obca_f64_ref.npz")


def make_planner():
    return ConsensusObcaPlanner(ObcaConfig(**PROFILE["ocfg"]),
                                scfg=SolverConfig(**PROFILE["scfg"]),
                                **PROFILE["planner"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None,
                    help="MPC steps (default: the whole 42-step run)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    t0 = time.perf_counter()
    states, its, prs, dus, _cvs, oks, kkts, gaps = make_planner().run_scan(
        n_steps=args.steps, return_health=True)
    secs = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(
        args.out, states=states, iterations=its, primal=prs, dual=dus,
        nlp_ok=oks, nlp_kkt=kkts, gaps=gaps,
        profile=np.asarray(json.dumps(PROFILE, sort_keys=True)),
        commit=np.asarray(commit))
    print(json.dumps(dict(out=os.path.relpath(args.out, ROOT),
                          steps=int(len(its)), seconds=round(secs, 1),
                          mean_iterations=float(its.mean()),
                          commit=commit)))


if __name__ == "__main__":
    main()

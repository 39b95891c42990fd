"""The port's run of bench.py's first metric from perturbed starts.

Runs ``PiAdmmEngine(layout="pairwise").run_fused_batch`` with the bench's
engine (16 vehicles, horizon 30, per-step cap 60, whole-run budget 210) on
its 32 seeded float32 starts (``tests/data/pi_admm_bench_f32_ref.npz``),
first as they are and then with normal noise of size ``--noise`` added to
them (one run per ``--seeds`` entry, the noise as
``tools/make_torch_fixture.py --profile pi_admm_f32 --noise EPS --seed N``
adds it to the JAX run's starts). Prints per run the capped steps, the
converged fraction, the minimum pairwise distance, the total iterations,
the wall seconds and the distance of the states from the JAX float32 run,
so the spread of the port's float32 numbers can be set beside JAX's.
``--eager`` also runs every start with the trips dispatched one by one (no
CUDA graph) and says whether its records equal the graphed run's bit for
bit.

Usage: python3 tools/perturbed_torch_pi_admm.py [--noise 1e-6]
           [--seeds 1 2 3] [--device cuda|cpu] [--eager]
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIXTURE = os.path.join(ROOT, "tests", "data", "pi_admm_bench_f32_ref.npz")


def eager_run(eng, xts, us, n_steps, iter_budget):
    """The fused loop with every trip dispatched eagerly (no graph)."""
    c = eng._fused_carry0(xts, us, n_steps)
    while bool((c["k"] < n_steps).any()):
        c = eng._fused_trip(c, n_steps, iter_budget)
    return {k: c[f"{src}_rec"].cpu().numpy() for k, src in (
        ("xt", "xt"), ("u_applied", "u"), ("iterations", "it"),
        ("primal_res", "r"), ("dual_res", "s"), ("converged", "cv"))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--noise", type=float, default=1e-6)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2, 3])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eager", action="store_true")
    args = ap.parse_args()
    import dlp_admm_torch  # noqa: F401  (TF32 off)
    from dlp_admm_torch.config import (DualUpdateConfig, PiAdmmConfig,
                                       SolverConfig)
    from dlp_admm_torch.models.pi_admm import PiAdmmEngine
    from dlp_admm_torch.scenarios import pi_admm_overtake_refs
    ref = np.load(FIXTURE)
    prof = json.loads(str(ref["profile"]))
    v = prof["num_veh"]
    cfg = PiAdmmConfig(num_veh=v, horizon=prof["horizon"],
                       speeds=tuple(8.0 if i % 2 == 0 else 4.0
                                    for i in range(v)),
                       iter_num=prof["iter_cap"], **prof["cfg"])
    refs, _ = pi_admm_overtake_refs(cfg)
    eng = PiAdmmEngine(cfg, DualUpdateConfig(**prof["dual"]),
                       SolverConfig(**prof["solver"]), refs=refs,
                       dtype=torch.float32, device=args.device,
                       **prof["engine"])
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    for seed in [None] + list(args.seeds):
        xts = ref["xts0"].astype(np.float64)
        if seed is not None:
            xts = xts + args.noise * np.random.default_rng(seed).normal(
                size=xts.shape)
        xts = xts.astype(np.float32)
        us = np.zeros(xts.shape[:2] + (prof["horizon"],), np.float32)
        sync()
        t0 = time.perf_counter()
        rec = eng.run_fused_batch(xts, us, prof["n_steps"],
                                  prof["iter_budget"])
        sync()
        wall = time.perf_counter() - t0
        rec = {k: x.cpu().numpy() for k, x in rec._asdict().items()}
        extra = {}
        if args.eager:
            eager = eager_run(eng, xts, us, prof["n_steps"],
                              prof["iter_budget"])
            extra = dict(eager_same_bits=all(
                np.array_equal(eager[k], rec[k]) for k in rec),
                eager_capped=int((~eager["converged"]).sum()))
        h = np.concatenate([xts[:, None], rec["xt"]], axis=1)[..., :2]
        d = np.linalg.norm(h[:, :, :, None] - h[:, :, None], axis=-1)
        capped = int((~rec["converged"]).sum())
        print(json.dumps(dict(
            device=str(eng.device),
            noise=0.0 if seed is None else args.noise, seed=seed,
            capped=capped,
            converged_fraction=1.0 - capped / rec["converged"].size,
            min_distance_m=float((d + 1e9 * np.eye(v)).min()),
            total_iterations=int(rec["iterations"].sum()),
            max_lane_total=int(rec["iterations"].sum(axis=1).max()),
            trips=eng.fused_trips, wall_s=wall,
            max_state_dist_from_jax=float(np.abs(rec["xt"]
                                                 - ref["xt"]).max()),
            **extra)), flush=True)
    if eng.device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()

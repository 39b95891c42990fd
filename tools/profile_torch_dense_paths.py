"""Time and profile the port's dense-IP planners on one CUDA card: the
bilevel and tightening family and ALADIN.

* ``runs``: ``chip_smoke.py`` phases 13 and 14 at their whole depth (the
  ``--full`` runs: ``run_obca(Formulation.BILEVEL | TIGHTENING |
  TIGHTENING_SLACK)``'s 42 / 62 / 62 MPC steps and the 4-vehicle
  tightening's 10 against ``tests/data/bilevel_ref.npz``, the ALADIN
  crossing's 45 against ``tests/data/aladin_ref.npz``), with their wall per
  step, IP trips and wall per trip or per ALADIN iteration;
* ``profile``: the bilevel planner's first local solve (its V local NLPs,
  one dense IP solve) and first dual solve (its P·T collision-dual QCQPs)
  of step 0, and one ALADIN iteration of the crossing at step 19 (the
  conflict onset) from the JAX run's state there and a zero steering warm
  start, each under ``torch.profiler`` (CPU and CUDA activities; a whole
  MPC step records millions of events, which the profiler takes many
  minutes to collect): kernels, device time (the kernels' summed
  durations) and wall per IP trip or per ALADIN iteration, the device's
  busy and idle share (one stream, so kernels do not overlap) and the five
  operations that take the most device time.

Prints ``nvidia-smi``'s name and power limit and one JSON line with all of
it (also written to ``--out``).

Usage: python3 tools/profile_torch_dense_paths.py [--skip-runs]
           [--out PATH.json]
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def _per(out, n, unit):
    """``profiled``'s numbers for one call, divided over its ``n``
    ``unit``s (IP trips or ALADIN iterations)."""
    return dict({k: v for k, v in out.items() if k != "trips"},
                **{unit: n,
                   f"kernels_per_{unit[:-1]}": out["kernels_per_trip"] / n,
                   f"device_ms_per_{unit[:-1]}":
                       out["device_ms_per_trip"] / n,
                   f"wall_ms_per_{unit[:-1]}": out["wall_ms_per_trip"] / n})


def profile_bilevel(profiled):
    """The first round of the bilevel planner's step 0: its V local NLPs
    and then its P·T dual QCQPs, each one dense IP solve, profiled apart."""
    from dlp_admm_torch.models.bilevel import (BilevelObcaPlanner,
                                               solve_collision_duals)
    pl = BilevelObcaPlanner(device="cuda")
    st, bs = pl.refs[:, 0, :], pl.create_state()
    ref_win = pl._ref_window(0)
    got = {}

    def local():
        got["loc"] = pl._local_solve(bs, st, ref_win, True)

    def duals():
        got["dual"] = solve_collision_duals(
            *got["pairs"], pl.ocfg.min_dis, pl.scfg, bs.lam)[1]
    local()                                                  # warm-up
    got["pairs"] = pl._new_halfspaces(got["loc"][0][:, 1:, :])[2:]
    duals()
    out_l = profiled(local, 1)
    out_d = profiled(duals, 1)
    return dict(local=_per(out_l, pl._trips(got["loc"][3]), "trips"),
                dual=_per(out_d, pl._trips(got["dual"]), "trips"))


def profile_aladin(profiled):
    """One ALADIN iteration of the crossing at step 19 (the conflict
    onset), from the JAX run's state there and a zero steering warm
    start."""
    from dlp_admm_torch.config import PiAdmmConfig, SolverConfig
    from dlp_admm_torch.models.aladin import AladinUnicyclePlanner
    ref = np.load(os.path.join(ROOT, "tests", "data", "aladin_ref.npz"))
    pl = AladinUnicyclePlanner(PiAdmmConfig(), scfg=SolverConfig(
        ip_iters=25, ip_tol=1e-7), device="cuda")
    xt = torch.as_tensor(ref["states"][19], device="cuda")
    u = torch.zeros((pl.v, pl.h), dtype=torch.float64, device="cuda")
    pos = pl._predict_own(u, xt, pl.spd).reshape(1, -1).expand(pl.v, -1)
    state = pl.engine.init_state(torch.cat([u, pos], dim=1))
    p = pl._agent_params(xt, 19)
    pl.engine.step(state, p)                                 # warm-up
    return _per(profiled(lambda: pl.engine.step(state, p), 1), 1,
                "iterations")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-runs", action="store_true",
                    help="profile only, without the whole runs")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("this profile needs a CUDA card")
    import chip_smoke
    from dlp_admm_torch.solvers import thomas
    from profile_torch_pi_admm import profiled
    smi = chip_smoke.nvidia_smi()
    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    if not args.skip_runs:
        paths = {}
        t0 = time.perf_counter()
        out["fixed_dual"] = chip_smoke.fixed_dual_path(thomas, paths, smi,
                                                       True)
        out["aladin"] = chip_smoke.aladin_path(thomas, paths, smi, True)
        out["runs_wall_s"] = time.perf_counter() - t0
        out["k1_launches"] = paths
    bil = profile_bilevel(profiled)
    out["profile_bilevel_local_solve"] = bil["local"]
    out["profile_bilevel_dual_solve"] = bil["dual"]
    out["profile_aladin_iteration"] = profile_aladin(profiled)
    for name in ("profile_bilevel_local_solve", "profile_bilevel_dual_solve",
                 "profile_aladin_iteration"):
        r = out[name]
        print(name, json.dumps({k: v for k, v in r.items()
                                if k not in ("top_ops", "top_kernels")}))
        for op in r["top_ops"]:
            print("   ", json.dumps(op))
    print(smi)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

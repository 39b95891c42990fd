"""Profile one MPC step of the PyTorch port's flagship on a CUDA card.

Runs the consensus-OBCA flagship (``--dtype f64``, the default, or ``f32``,
each with its profile) for one warm-up MPC step, then traces the same step
again with ``torch.profiler`` (CPU + CUDA activities) and reports where its
wall time goes:

* wall time of the step, IP trips made (block-Thomas solves / 2 in float64,
  / 3 in float32), wall per trip;
* device busy time (sum of kernel times) and the device's idle share;
* the block-Thomas kernels' launches, time per launch, and share of the
  device time and of the wall;
* kernel launches per trip, and the top operators by host time;
* the warp kernel's own ``clock64()`` split of one solve of the step's
  first local KKT system into load, equilibration, elimination, refinement,
  store and product, back substitution (its profiling build).

Prints one JSON line and, with ``--out PATH``, writes it with the operator
table to that file.

Usage: python3 tools/profile_torch_flagship.py [--dtype f64|f32] [--out PATH]
"""
import argparse
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dlp_admm_torch.config import ObcaConfig, SolverConfig  # noqa: E402
from dlp_admm_torch.models.obca import ConsensusObcaPlanner  # noqa: E402
from dlp_admm_torch.solvers import ip_staged, thomas  # noqa: E402

PHASES = ("load", "equilibrate", "eliminate", "refine", "store_product",
          "back_substitution")


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f64", "f32"), default="f64")
    ap.add_argument("--out", default=None,
                    help="also write the record and operator table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    f64 = args.dtype == "f64"
    pl = ConsensusObcaPlanner(
        ObcaConfig(horizon=8, min_dis=0.1, rho=100.0, max_admm_iters=50),
        scfg=SolverConfig(ip_iters=40, ip_tol=1e-6 if f64 else 1e-4),
        local_prox=700.0, prox_growth=1.5,
        prox_tau_max=3.0e10 if f64 else 1.0e9,
        dtype=torch.float64 if f64 else torch.float32)
    st, bs = pl.refs[:, 0, :], pl.create_bar_state()
    # warm-up (build, caches), keeping the first local KKT system
    kkt = {}
    solve = ip_staged.block_thomas_solve

    def keep_first(diag, upper, rhs):
        if rhs.shape[0] == pl.num_veh and not kkt:
            kkt["local"] = (diag.clone(), upper.clone(), rhs.clone())
        return solve(diag, upper, rhs)

    ip_staged.block_thomas_solve = keep_first
    try:
        pl._mpc_step(st, bs, 0)
    finally:
        ip_staged.block_thomas_solve = solve
    torch.cuda.synchronize()
    solves0 = pl.block_solves
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = pl._mpc_step(st, bs, 0)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    trips = (pl.block_solves - solves0) // (2 if f64 else 3)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.device_time for e in kernels) if kernels and hasattr(
        kernels[0], "device_time") else sum(_device_us(e)
                                            for e in prof.key_averages())
    k1 = [e for e in kernels if "thomas_" in e.name]
    k1_us = sum(getattr(e, "device_time", 0.0) for e in k1)
    _, clocks = thomas.launch_kernel(*kkt["local"], equilibrate=not f64,
                                     profile=True)
    clocks = clocks.double().mean(0).tolist()
    ka = prof.key_averages()
    top = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]
    rec = dict(
        device=torch.cuda.get_device_name(0), torch=torch.__version__,
        admm_iterations=int(out[2]), ip_trips=int(trips),
        wall_s=wall_s, wall_ms_per_trip=1e3 * wall_s / max(trips, 1),
        device_busy_s=device_us * 1e-6,
        device_idle_share=1.0 - device_us * 1e-6 / wall_s,
        kernel_launches=len(kernels),
        launches_per_trip=len(kernels) / max(trips, 1),
        dtype=args.dtype, block_thomas_launches=len(k1),
        block_thomas_us_per_launch=k1_us / max(len(k1), 1),
        block_thomas_clocks_local_kkt=dict(zip(PHASES, clocks)),
        block_thomas_device_s=k1_us * 1e-6,
        block_thomas_share_of_device=k1_us / max(device_us, 1e-9),
        block_thomas_share_of_wall=k1_us * 1e-6 / wall_s,
        top_host_ops=[dict(op=e.key, calls=e.count,
                           self_cpu_ms=e.self_cpu_time_total / 1e3)
                      for e in top])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(rec, table=ka.table(sort_by="self_cpu_time_total",
                                               row_limit=30)), f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "top_host_ops"}))
    for row in rec["top_host_ops"][:10]:
        print(json.dumps(row))


if __name__ == "__main__":
    main()

"""One conflict-window MPC step of the PyTorch port's float32 flagship, from
the JAX run's own carry (``tools/make_window_carries.py``).

Whole 42-step runs of the two planners cannot be compared step by step: the
conflict window is chaotic. Started from the same carry, one step can:

* ``--steps 13,14,...``: the step's ADMM iterations, residuals and NLP
  health through the IP loop the device takes (on a CUDA card a replayed
  CUDA graph), twice (is it repeatable?), beside JAX's iteration count;
* ``--eager N``: the first N of those steps again through the eager IP loop
  on the same device (on the card: is the graphed loop the eager one?);
* ``--kkt-step K`` (CUDA): every ``--every``-th KKT system of step K's first
  ``--kkt-iters`` ADMM iterations, all IP trips included (eager loop),
  solved by the warp kernel, the wide kernel and the plain version:
  the residual the staged solver's own verification looks at,
  ``max |A x - r| / (1 + max |r|)``, of each, and how many single solves
  each would have rejected (> 1e-4).

Usage: python3 tools/check_torch_window.py [--device cuda|cpu]
           [--carries PATH.npz] [--steps K,K,...] [--eager N]
           [--kkt-step K --kkt-iters N --every M]
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dlp_admm_torch.interop import bar_state_from_numpy  # noqa: E402
from dlp_admm_torch.models.obca import ConsensusObcaPlanner  # noqa: E402
from dlp_admm_torch.solvers import ip_staged, thomas  # noqa: E402

DEFAULT_CARRIES = os.path.join(ROOT, "_chipcheck", "carries_f32.npz")


def eager_trips(trip, carry, max_trips):
    """The IP loop without a CUDA graph (``solve_staged``'s CPU loop)."""
    trips = 0
    while trips < max_trips:
        carry = trip(carry)
        trips += 1
        if bool(carry.done.all()):
            break
    return carry, trips


def load_carry(data, k, dev):
    fields = {n[len(f"{k}_"):]: data[n] for n in data.files
              if n.startswith(f"{k}_") and n != f"{k}_state"}
    return (torch.as_tensor(data[f"{k}_state"], device=dev),
            bar_state_from_numpy(fields, dtype=torch.float32, device=dev))


def run_step(pl, data, k, dev, label):
    st, bs = load_carry(data, k, dev)
    t0 = time.perf_counter()
    out = pl._mpc_step(st, bs, k)
    if dev == "cuda":
        torch.cuda.synchronize()
    print(f"{label} step {k}: ADMM iterations {out[2]} (JAX "
          f"{int(data['iterations'][k])}), primal {float(out[3]):.4f}, dual "
          f"{float(out[4]):.4f}, nlp_ok {out[6].tolist()}, nlp_kkt "
          f"{out[7].tolist()}, {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def kkt_check(data, k, iters, every, dev):
    keep = ip_staged.block_thomas_solve
    systems, calls = [], [0]

    def sample(d, u, r):
        out = keep(d, u, r)
        calls[0] += 1
        if calls[0] % every == 0:
            systems.append((d.clone(), u.clone(), r.clone(), out.clone()))
        return out

    pl = ConsensusObcaPlanner(device=dev, **chip_smoke.flagship_profile(
        torch.float32, max_admm_iters=iters))
    ip_staged.block_thomas_solve = sample
    try:
        run_step(pl, data, k, dev, "eager, sampling")
    finally:
        ip_staged.block_thomas_solve = keep
    res = {"warp": [], "wide": [], "plain": []}
    for d, u, r, out in systems:
        a, rr = chip_smoke.dense_system(d.double(), u.double(), r.double())
        sols = dict(warp=out,
                    wide=thomas.launch_kernel(d, u, r, True, kernel="wide"),
                    plain=thomas.block_thomas_plain(d, u, r, True))
        for name, x in sols.items():
            xs = x.double().reshape(rr.shape)
            v = (a @ xs - rr).abs().amax((1, 2)) / (1.0 + rr.abs().amax((1, 2)))
            res[name].append(float(torch.nan_to_num(v, nan=float("inf")).max()))
    print(f"step {k}: {calls[0]} block solves, {len(systems)} sampled")
    for name, v in res.items():
        v = np.asarray(v)
        print(f"  {name}: residual median {np.median(v):.3e}, 90 % "
              f"{np.quantile(v, 0.9):.3e}, max {v.max():.3e}; "
              f"{int((v > 1e-4).sum())} of {len(v)} above 1e-4")
    w, p = np.asarray(res["warp"]), np.asarray(res["plain"])
    print(f"  warp more than 10 times the plain version's residual (and "
          f"above 1e-5): {int(((w > 10 * p) & (w > 1e-5)).sum())}; the "
          f"other way: {int(((p > 10 * w) & (p > 1e-5)).sum())}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--carries", default=DEFAULT_CARRIES)
    ap.add_argument("--steps", default="")
    ap.add_argument("--eager", type=int, default=0)
    ap.add_argument("--kkt-step", type=int, default=None)
    ap.add_argument("--kkt-iters", type=int, default=45)
    ap.add_argument("--every", type=int, default=30)
    args = ap.parse_args()
    dev = args.device
    data = np.load(args.carries)
    steps = [int(s) for s in args.steps.split(",") if s]
    graphed = ip_staged._trips_graphed
    path = "graphed" if dev == "cuda" else "eager"
    pl = ConsensusObcaPlanner(device=dev,
                              **chip_smoke.flagship_profile(torch.float32))
    for k in steps:
        run_step(pl, data, k, dev, path)
        run_step(pl, data, k, dev, path + ", again")
    ip_staged._trips_graphed = eager_trips
    try:
        if dev == "cuda":
            for k in steps[:args.eager]:
                run_step(pl, data, k, dev, "eager")
        if args.kkt_step is not None:
            if dev != "cuda":
                raise RuntimeError("--kkt-step compares CUDA kernels: it "
                                   "needs --device cuda")
            kkt_check(data, args.kkt_step, args.kkt_iters, args.every, dev)
    finally:
        ip_staged._trips_graphed = graphed
    if dev == "cuda":
        print(chip_smoke.nvidia_smi())


if __name__ == "__main__":
    main()

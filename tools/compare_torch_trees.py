"""Compare two checkouts of the PyTorch port on one CUDA card, in one process
tree: the block-Thomas kernel's time per solve, the flagship's float64
6-step slice and the 4-vehicle run, in turns (parent, change, change,
parent) so that both see the same card under the same power limit.

Each turn is a fresh Python process that imports ``dlp_admm_torch`` from one
checkout, lets it build its kernels, and

* times ``solvers.thomas.block_thomas_solve`` on diagonally dominant systems
  at the flagship's shapes, (S, T, B) = (2, 7, 19), (1, 7, 20), (256, 7, 19),
  float64 and float32, and at the wide kernel's, (4, 7, 33), (2, 7, 61),
  (1, 7, 80) float64 and (1, 7, 45), (2, 7, 61) float32 equilibrated (the
  multi-vehicle widths): 20 calls captured as one CUDA graph, replayed;
* runs ``mpc.run_obca(Formulation.CONSENSUS, n_steps=6, device="cuda")``
  with the float64 profile and keeps every step's wall time (the first step
  carries the set-up) and ADMM iteration count;
* runs the 4-vehicle run of ``tests/test_multivehicle.py`` (4 steps, ADMM
  cap 5, float64; KKT widths 33 and 80, the wide kernel's) the same way;
* with ``--centralized``: times K1 at the centralized planner's 4-vehicle
  shape (1, 14, 108), float64 and float32 equilibrated, and one 4-vehicle
  ``CentralizedObcaPlanner.solve_at`` (300 IP trips at most, as
  ``chip_smoke.py`` phase 11 gives it; each trip a replayed CUDA graph
  with two K1 launches) after a warm-up call: its wall, trips and wall per
  trip, and K1's share of a trip (two launches at the timed K1 time);
* with ``--big``: only K1 past the cluster kernel's reach, the 9-vehicle
  consensus edge (1, 7, 405) in float64 and the 11-vehicle edge
  (1, 7, 605) in float32 equilibrated, and the big kernel forced at
  (1, 7, 320) float64 beside the cluster kernel there (2 calls captured as
  one graph, replayed 5 times: a call takes up to seconds); then, once,
  in the change's tree, the plain version and one ``torch.linalg.solve``
  on the dense ``[S, T·B, T·B]`` matrix (the yardstick the port never
  calls) at the same shapes, with ``chip_smoke.py``'s bound.

Only entry points that every checkout of the port has are used, so the
parent may be any earlier commit (with ``--centralized``, one from the
commit that first solved B = 108 on the card on), unpacked with
``git archive`` into a directory of its own.

Usage: python3 tools/compare_torch_trees.py --parent DIR [--change DIR]
           [--centralized | --big] [--out PATH.json]
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (shape, dtype name, equilibrate)
CASES = tuple((sh, dt, False) for dt in ("float64", "float32")
              for sh in ((2, 7, 19), (1, 7, 20), (256, 7, 19))) + (
    ((4, 7, 33), "float64", False), ((2, 7, 61), "float64", False),
    ((1, 7, 80), "float64", False), ((1, 7, 45), "float32", True),
    ((2, 7, 61), "float32", True))
SLICE_STEPS = 6
CENTRALIZED_CASES = (((1, 14, 108), "float64", False),
                     ((1, 14, 108), "float32", True))
CEN_V4_IP_ITERS = 300
# (shape, dtype name, equilibrate, kernel forced or None)
BIG_CASES = (((1, 7, 405), "float64", False, None),
             ((1, 7, 605), "float32", True, None),
             ((1, 7, 320), "float64", False, "big"),
             ((1, 7, 320), "float64", False, None))


def big_worker(tree, yardsticks=False):
    """K1 at BIG_CASES in ``tree``; ``yardsticks``: the plain version and the
    library call instead, with the bound."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke
    import dlp_admm_torch  # noqa: F401  (sets the TF32 switches)
    from dlp_admm_torch.solvers import thomas
    rng = np.random.default_rng(0)
    rec = {"tree": tree}
    for (s, t, b), dt, eq, kernel in BIG_CASES:
        dtype = getattr(torch, dt)
        d, u, r = (torch.as_tensor(a, dtype=dtype, device="cuda") for a in
                   chip_smoke.make_system(rng, s, t, b, "diag_dominant"))
        key = f"{s}x{t}x{b} {dt}{' eq' if eq else ''}"
        if yardsticks:
            if kernel is not None:
                continue
            a, rr = chip_smoke.dense_system(d, u, r)
            rec[key] = dict(
                plain_ms=chip_smoke.graph_ms(
                    lambda: thomas.block_thomas_plain(d, u, r, eq), reps=1),
                library_ms=chip_smoke.time_ms(
                    lambda: torch.linalg.solve(a, rr), 5),
                **chip_smoke.bound(s, t, b, dtype, eq))
            continue
        plan = thomas.kernel_plan(s, t, b, dtype, eq, kernel)
        rec[key + (f" forced {kernel}" if kernel else "")] = dict(
            kernel=plan["kernel"], ms=chip_smoke.graph_ms(
                lambda: thomas.launch_kernel(d, u, r, eq, kernel), reps=2))
    print(json.dumps(rec), flush=True)


def worker(tree, centralized=False):
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import dlp_admm_torch  # noqa: F401  (sets the TF32 switches)
    from dlp_admm_torch.config import Formulation, ObcaConfig, SolverConfig
    from dlp_admm_torch.mpc import run_obca
    from dlp_admm_torch.solvers import thomas

    def graph_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            fn()
            graph.capture_begin()
            for _ in range(reps):
                fn()
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (5 * reps)

    rng = np.random.default_rng(0)
    k1 = {}
    for (s, t, b), dt, eq in CASES + (CENTRALIZED_CASES if centralized
                                      else ()):
        dtype = getattr(torch, dt)
        diag = rng.normal(size=(s, t, b, b))
        diag = 0.5 * (diag + np.swapaxes(diag, -1, -2)) \
            + (b + 2.0) * np.eye(b)
        upper = 0.3 * rng.normal(size=(s, t, b, b))
        d, u, r = (torch.as_tensor(a, dtype=dtype, device="cuda")
                   for a in (diag, upper, rng.normal(size=(s, t, b))))
        k1[f"{s}x{t}x{b} {dt}{' eq' if eq else ''}"] = graph_ms(
            lambda: thomas.block_thomas_solve(d, u, r, eq))
    res = run_obca(
        Formulation.CONSENSUS,
        ocfg=ObcaConfig(horizon=8, min_dis=0.1, rho=100.0, max_admm_iters=50),
        scfg=SolverConfig(ip_iters=40, ip_tol=1e-6), n_steps=SLICE_STEPS,
        device="cuda", dtype=torch.float64, local_prox=700.0, prox_growth=1.5,
        prox_tau_max=3.0e10)
    v4 = run_obca(
        Formulation.CONSENSUS,
        ocfg=ObcaConfig(num_veh=4, horizon=8, min_dis=0.1, max_admm_iters=5,
                        rho=100.0),
        scfg=SolverConfig(ip_iters=40, ip_tol=1e-6), n_steps=4,
        device="cuda", dtype=torch.float64, gate_pairs=True, gate_thres=12.0)
    rec = dict(
        tree=tree, k1_ms=k1, step_wall_s=list(res.metrics.step_times),
        iterations=list(res.metrics.iter_history),
        final_state=res.states[-1].tolist(),
        v4_step_wall_s=list(v4.metrics.step_times),
        v4_iterations=list(v4.metrics.iter_history),
        v4_final_state=v4.states[-1].tolist())
    if centralized:
        from dlp_admm_torch.config import VehicleConfig
        from dlp_admm_torch.models.obca import CentralizedObcaPlanner
        ref = np.load(os.path.join(tree, "tests", "data",
                                   "obca_centralized_v4_ref.npz"))
        prof = json.loads(str(ref["profile"]))

        def solve():
            pl = CentralizedObcaPlanner(
                ObcaConfig(**prof["ocfg"], num_veh=4), VehicleConfig(),
                SolverConfig(ip_iters=CEN_V4_IP_ITERS), device="cuda")
            return pl, pl.solve_at(pl.refs[:, 0, :], 0)
        solve()                 # builds, captures, warms the allocator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl, (_, _, _, sol) = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trips = int(sol.iterations)
        rec.update(cen_v4_wall_s=wall, cen_v4_trips=trips,
                   cen_v4_converged=bool(sol.converged),
                   cen_v4_block_solves=pl.block_solves,
                   cen_v4_ms_per_trip=1e3 * wall / trips,
                   cen_v4_k1_share=(pl.block_solves / trips)
                   * k1["1x14x108 float64"] / (1e3 * wall / trips))
    print(json.dumps(rec), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the commit to compare with")
    ap.add_argument("--change", default=ROOT)
    ap.add_argument("--centralized", action="store_true",
                    help="also time K1 at (1, 14, 108) and the 4-vehicle "
                         "centralized solve_at")
    ap.add_argument("--big", action="store_true",
                    help="only K1 past the cluster kernel's reach, and the "
                         "plain version and the library call there")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--yardsticks", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker and args.big:
        return big_worker(os.path.abspath(args.worker), args.yardsticks)
    if args.worker:
        return worker(os.path.abspath(args.worker), args.centralized)
    if not args.parent:
        ap.error("--parent is required")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    turns = []
    flags = (["--centralized"] if args.centralized else []) + (
        ["--big"] if args.big else [])

    def turn(name, extra=()):
        tree = os.path.abspath(getattr(args, name))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             *flags, *extra], capture_output=True, text=True, cwd=tree)
        if out.returncode != 0:
            raise RuntimeError(
                f"{name} ({tree}) failed:\n{out.stderr[-4000:]}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["turn"] = name
        print(json.dumps(rec), flush=True)
        return rec

    for name in ("parent", "change", "change", "parent"):
        turns.append(turn(name))

    def mean(xs):
        return sum(xs) / len(xs)

    summary = {"nvidia_smi": smi}
    if args.big:
        for name in ("parent", "change"):
            mine = [t for t in turns if t["turn"] == name]
            summary[name] = {k: dict(v, ms=mean([t[k]["ms"] for t in mine]),
                                     ms_turns=[t[k]["ms"] for t in mine])
                             for k, v in mine[0].items() if k not in (
                                 "tree", "turn")}
        summary["yardsticks"] = turn("change", ["--yardsticks"])
        print(json.dumps(summary), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(turns=turns, summary=summary), f, indent=1)
        print(smi)
        return
    for name in ("parent", "change"):
        mine = [t for t in turns if t["turn"] == name]
        summary[name] = dict(
            k1_ms={k: mean([t["k1_ms"][k] for t in mine])
                   for k in mine[0]["k1_ms"]},
            # steps after the first, which carries the set-up
            step_wall_s=mean([w for t in mine for w in t["step_wall_s"][1:]]),
            first_step_wall_s=mean([t["step_wall_s"][0] for t in mine]),
            iterations=mine[0]["iterations"],
            v4_step_wall_s=mean([w for t in mine
                                 for w in t["v4_step_wall_s"][1:]]),
            v4_first_step_wall_s=mean([t["v4_step_wall_s"][0]
                                       for t in mine]),
            v4_iterations=mine[0]["v4_iterations"])
        if args.centralized:
            summary[name].update({k: mean([t[k] for t in mine]) for k in (
                "cen_v4_wall_s", "cen_v4_ms_per_trip", "cen_v4_k1_share")},
                cen_v4_trips=[t["cen_v4_trips"] for t in mine],
                cen_v4_converged=[t["cen_v4_converged"] for t in mine])
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(turns=turns, summary=summary), f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()

"""Run the PyTorch port's float32 scenario batch (bench.py's third metric,
16 lanes x 2 vehicles x 20 steps) on a CUDA card from rounding-level
perturbations of its starts, one run per seed, and judge it lane by lane
against JAX's runs from the same starts.

The batch is 16 lanes of the flagship's chaotic conflict window, each lane
started from the flagship's start with 0.25 m of jitter (``default_rng(0)``,
``chip_smoke.batch_starts``). One run gives 16 lanes, but one run of each
side lands where the window sends it; runs from starts moved by noise far
below the residual thresholds show the spread. Each run adds normal noise
of size ``--noise`` to the whole ``[16, 2, 5]`` start, drawn from
``default_rng(seed)`` in float64 (:func:`moved_starts`), as
``tools/make_torch_fixture.py --profile batch_f32 --noise ... --seed ...``
draws it for the JAX batch, so run ``k`` here and there start from the
same points. ``--unmoved`` adds the run from the unmoved starts.

Per run it prints one JSON line and ``--out`` keeps, per lane, res_ok (its
steps with both residuals <= 0.01, bench.py:266), the steps at the ADMM
cap, the ADMM iterations and the residuals per step and the minimum centre
distance; per run the launches by kernel and variant, the staged block
solves and the wall. ``--device cpu`` runs on the CPU (the plain version; hours a run, so only
with ``--steps`` and ``--lanes`` to rehearse).

``judge`` applies Rule B of ``PERF.md`` §6: the port's
lanes are lower than JAX's if a one-sided Mann-Whitney test on the lanes'
res_ok gives p < 0.05; a Wilcoxon signed-rank test on the lanes paired by
start, and each run's total against bench.py's 272 of 320, are reported
beside it. Plain numpy and scipy: runs on the CPU.

Usage: python3 tools/perturbed_torch_batch.py [--noise EPS] [--seeds N ...]
           [--unmoved] [--device cuda|cpu] [--out PATH.json]
           [--steps N --lanes S (a rehearsal)]
       python3 tools/perturbed_torch_batch.py judge --port A.json [...]
           --jax X.npz [...] [--json PATH]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RES_TOL = 0.01          # bench.py:266
RES_OK_GATE = 272       # 85 % of 320 lane-steps, bench.py:266
ADMM_CAP = 50
ALPHA = 0.05
STEPS = 20              # bench.py:248


def label(seed):
    return "unmoved" if seed is None else f"seed{seed}"


def moved_starts(inits, noise, seed):
    """The batch's starts ``inits [S, 2, 5]`` with normal noise of size
    ``noise`` on every entry, drawn from ``default_rng(seed)`` in float64
    (``seed`` None: unmoved), as ``tools/make_torch_fixture.py
    --profile batch_f32 --noise --seed`` moves JAX's."""
    if seed is None or not noise:
        return inits
    return inits + noise * np.random.default_rng(seed).normal(
        size=inits.shape)


def lanes(its, prs, dus, states):
    """Per lane of a run's ``[S, n]`` records and ``states [n+1, S, 2, 5]``:
    res_ok, steps at the ADMM cap, minimum centre distance."""
    its, prs, dus = (np.asarray(x) for x in (its, prs, dus))
    p = np.asarray(states)[..., :2]
    dist = np.linalg.norm(p[:, :, 0] - p[:, :, 1], axis=-1).min(axis=0)
    return dict(res_ok=((prs <= RES_TOL) & (dus <= RES_TOL)).sum(
                    axis=1).tolist(),
                steps_at_cap=(its >= ADMM_CAP).sum(axis=1).tolist(),
                min_distance_m=dist.tolist())


def batch_starts(pl):
    """``chip_smoke.batch_run``'s starts of the planner ``pl``, rounded to
    its type as ``run_scenario_batch`` rounds them (JAX's float32 batch
    keeps them so before its noise is added)."""
    import chip_smoke
    prof = json.loads(str(np.load(chip_smoke.FIXTURE_BATCH)["profile"]))
    inits = chip_smoke.batch_starts(pl.refs[:, 0].double().cpu().numpy(),
                                    prof)
    return inits.astype(str(pl.dtype)[6:])


def one_run(args, seed):
    """One float32 batch run from the starts moved by ``args.noise``
    (``seed``; None: unmoved), with the launch counts set to 0 just before;
    its record."""
    import torch

    import chip_smoke
    from dlp_admm_torch.models.obca import ConsensusObcaPlanner
    from dlp_admm_torch.parallel.consensus_spmd import run_scenario_batch
    from dlp_admm_torch.solvers import thomas

    on_card = torch.device(args.device).type == "cuda"
    pl = ConsensusObcaPlanner(**chip_smoke.flagship_profile(torch.float32),
                              device=args.device)
    inits = moved_starts(batch_starts(pl), args.noise, seed)[:args.lanes]
    thomas.reset_counts()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    states, its, prs, dus, _, gaps = run_scenario_batch(pl, inits,
                                                        args.steps)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per = lanes(its, prs, dus, states)
    return dict(
        label=label(seed), noise=0.0 if seed is None else args.noise,
        seed=seed, device=args.device,
        lanes=int(its.shape[0]), steps=int(its.shape[1]),
        res_ok=int(sum(per["res_ok"])),
        steps_at_cap=int(sum(per["steps_at_cap"])),
        min_distance_m=float(min(per["min_distance_m"])),
        gap_median=float(np.median(gaps)),
        finite=bool(np.all(np.isfinite(states))),
        launches=dict(thomas.launches_by_kernel),
        launches_by_variant=dict(thomas.launches_by_variant),
        block_solves=pl.block_solves, wall_s=wall,
        lane_res_ok=per["res_ok"], lane_steps_at_cap=per["steps_at_cap"],
        lane_min_distance_m=per["min_distance_m"],
        iterations=np.asarray(its).tolist(),
        primal=np.asarray(prs).tolist(), dual=np.asarray(dus).tolist(),
        starts=np.asarray(inits).tolist())


def run_main(argv):
    import torch

    import chip_smoke
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--noise", type=float, default=1e-7)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2])
    ap.add_argument("--unmoved", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="MPC steps (default 20; fewer only to rehearse)")
    ap.add_argument("--lanes", type=int, default=None,
                    help="the first S lanes (default all 16; fewer only to "
                         "rehearse)")
    args = ap.parse_args(argv)
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card (or --device cpu)")
    smi = chip_smoke.nvidia_smi() if on_card else "cpu"
    runs = []
    for seed in ([None] if args.unmoved else []) + list(args.seeds):
        run = one_run(args, seed)
        runs.append(run)
        print(json.dumps({k: v for k, v in run.items() if k not in (
            "iterations", "primal", "dual", "starts")}), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(dict(runs=runs, nvidia_smi=smi), f)
    print(smi)


def jax_lanes(path):
    """One JAX batch run's per-lane record from ``make_torch_fixture.py
    --profile batch_f32 --out`` (label from the run's noise seed)."""
    d = np.load(path)
    prof = json.loads(str(d["profile"]))
    per = lanes(d["iterations"], d["primal"], d["dual"], d["states"])
    seed = prof.get("noise_seed") if prof.get("noise") else None
    return dict(label=label(seed), res_ok=int(sum(per["res_ok"])),
                lane_res_ok=per["res_ok"],
                lane_steps_at_cap=per["steps_at_cap"],
                lane_min_distance_m=per["min_distance_m"],
                iterations=np.asarray(d["iterations"]).tolist())


def rule_b(port_lanes, jax_lanes_):
    """Rule B on two sides' lanes (res_ok, paired by position): the
    one-sided Mann-Whitney p that the port's are lower, the two-sided
    Wilcoxon signed-rank p on the pairs (zero differences dropped; 1.0 when
    every pair is equal), each side's median and the fault flag."""
    from scipy.stats import mannwhitneyu, wilcoxon
    x = np.asarray(port_lanes, float)
    y = np.asarray(jax_lanes_, float)
    p_mw = float(mannwhitneyu(x, y, alternative="less",
                              method="asymptotic").pvalue)
    diff = x - y
    p_w = (float(wilcoxon(diff, zero_method="wilcox").pvalue)
           if np.any(diff != 0) else 1.0)
    return dict(n=len(x), port_median=float(np.median(x)),
                jax_median=float(np.median(y)),
                port_total=int(x.sum()), jax_total=int(y.sum()),
                p_mann_whitney_less=p_mw, p_wilcoxon=p_w,
                pairs_port_lower=int((diff < 0).sum()),
                pairs_port_higher=int((diff > 0).sum()),
                fault=p_mw < ALPHA)


def judge_main(argv):
    ap = argparse.ArgumentParser(description="Rule B: the port's float32 "
                                 "batch lanes against JAX's")
    ap.add_argument("--port", nargs="+", required=True)
    ap.add_argument("--jax", nargs="+", required=True)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    port = {}
    for path in args.port:
        with open(path) as f:
            for r in json.load(f)["runs"]:
                port[r["label"]] = r
    jax = {r["label"]: r for r in map(jax_lanes, args.jax)}
    labels = [lab for lab in jax if lab in port]
    if not labels:
        raise SystemExit("no run of the same start on both sides")
    runs = []
    for lab in labels:
        p, j = port[lab], jax[lab]
        moved = [a != b for a, b in zip(p["iterations"], j["iterations"])]
        runs.append(dict(label=lab, port_res_ok=p["res_ok"],
                         jax_res_ok=j["res_ok"], gate=RES_OK_GATE,
                         port_lanes=p["lane_res_ok"],
                         jax_lanes=j["lane_res_ok"],
                         lanes_other_iterations=int(sum(moved))))
        print(json.dumps(runs[-1]))
    for lab in labels:
        if lab != "unmoved" and "unmoved" in labels:
            for side, recs in (("port", port), ("jax", jax)):
                same = recs[lab]["iterations"] == recs["unmoved"]["iterations"]
                print(json.dumps(dict(label=lab, side=side,
                                      leaves_the_unmoved_run=not same)))
    verdict = rule_b(sum((port[lab]["lane_res_ok"] for lab in labels), []),
                     sum((jax[lab]["lane_res_ok"] for lab in labels), []))
    print(json.dumps(verdict))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(runs=runs, verdict=verdict), f, indent=1)


def main():
    if sys.argv[1:2] == ["judge"]:
        return judge_main(sys.argv[2:])
    return run_main(sys.argv[1:])


if __name__ == "__main__":
    main()

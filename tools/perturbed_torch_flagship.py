"""Run the PyTorch port's 42-step flagship on a CUDA card from rounding-level
perturbations of its start, one run per seed.

The conflict window of the overtaking run is chaotic: a change at the
rounding level (another elimination order, another summation order) sends
the ADMM iterates down another branch after a few steps there. One run
cannot say whether a change made the planner worse; several runs from
starts that differ by noise far below the residual thresholds show the
spread of each 42-step number. Each run adds normal noise of size ``--noise``
to the consensus iterate ``z_bar`` the run starts from, drawn as
``tools/make_torch_fixture.py --noise ... --seed ...`` draws it for the JAX
planner, so run ``k`` here and there start from the same point.

``--unmoved`` adds the run from the unmoved start (label ``unmoved``).

Prints one JSON line per run (the gates and pins of ``chip_smoke.py --full``,
the steps at the ADMM cap) and the card's name and power limit; ``--out``
keeps them with each run's per-step records (ADMM iterations, residual rows,
states). ``--jobs N`` runs the runs in N processes side by side, one torch
thread each (the runs are host-bound; their walls are then not those of a
run alone). ``--carries DIR`` writes, per run, the carry each step starts
from to ``DIR/carries_<label>.npz`` in ``tools/make_window_carries.py``'s
format, so that ``tools/check_torch_window.py`` and
``tools/jax_window_steps.py`` can start single steps from the run's own
states. ``--device cpu`` runs the same on the CPU (the plain version of the
kernels, the eager IP loop; hours per run), to tell what belongs to the
card's path.

Usage: python3 tools/perturbed_torch_flagship.py [--dtype f64|f32]
           [--noise EPS] [--seeds N ...] [--unmoved] [--jobs N]
           [--carries DIR] [--device cuda|cpu] [--out PATH.json]
           [--steps N (a rehearsal)]
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dlp_admm_torch.config import Formulation  # noqa: E402
from dlp_admm_torch.interop import bar_state_to_numpy  # noqa: E402
from dlp_admm_torch.models.obca import ConsensusObcaPlanner  # noqa: E402
from dlp_admm_torch.mpc import run_obca  # noqa: E402

KEYS = ("steps", "res_ok", "mean_iterations", "min_distance_m",
        "min_footprint_gap_m", "health", "gap_median", "gap_max", "gates",
        "pins", "iterations")
PER_STEP = ("residual_rows", "states")


def label(seed):
    return "unmoved" if seed is None else f"seed{seed}"


def moved_bar_state(bs, noise, seed):
    """The start ``bs`` with normal noise of size ``noise`` on ``z_bar``,
    drawn from ``default_rng(seed)`` in float64 and rounded to the state's
    type, as ``tools/make_torch_fixture.py --noise --seed`` moves JAX's."""
    eps = noise * np.random.default_rng(seed).normal(
        size=tuple(bs.z_bar.shape))
    return bs._replace(z_bar=bs.z_bar + torch.as_tensor(
        eps, dtype=bs.z_bar.dtype, device=bs.z_bar.device))


def one_run(args, seed, dtype, ref):
    """The 42-step run from the start moved by ``args.noise`` (``seed``;
    ``None``: unmoved); its record."""
    create = ConsensusObcaPlanner.create_bar_state
    mpc_step = ConsensusObcaPlanner._mpc_step
    carries = {}

    def noisy(self):
        return moved_bar_state(create(self), args.noise, seed)

    def keep_carry(self, init_state, bs, k):
        carries[f"{int(k)}_state"] = init_state.cpu().numpy()
        for name, v in bar_state_to_numpy(bs).items():
            carries[f"{int(k)}_{name}"] = v
        return mpc_step(self, init_state, bs, k)

    if seed is not None:
        ConsensusObcaPlanner.create_bar_state = noisy
    if args.carries:
        ConsensusObcaPlanner._mpc_step = keep_carry
    try:
        res = run_obca(Formulation.CONSENSUS, device=args.device,
                       n_steps=args.steps,
                       **chip_smoke.flagship_profile(dtype))
    finally:
        ConsensusObcaPlanner.create_bar_state = create
        ConsensusObcaPlanner._mpc_step = mpc_step
    rec = chip_smoke.full_record(res, ref, str(dtype)[6:])
    summary = res.metrics.summary()
    cap = chip_smoke.flagship_profile(dtype)["ocfg"].max_admm_iters
    run = dict({k: rec[k] for k in KEYS}, dtype=args.dtype,
               noise=0.0 if seed is None else args.noise, seed=seed,
               label=label(seed), device=args.device,
               steps_at_cap=int(sum(i >= cap for i in rec["iterations"])),
               wall_s=summary["total_time_s"],
               iterations_per_s=summary["iterations_per_s"])
    if args.carries:
        os.makedirs(args.carries, exist_ok=True)
        np.savez_compressed(
            os.path.join(args.carries, f"carries_{label(seed)}.npz"),
            iterations=np.asarray(rec["iterations"]), **carries)
    return run, {k: rec[k] for k in PER_STEP}


def side_by_side(args, seeds):
    """Each run in a process of its own, ``args.jobs`` at a time, one torch
    thread each; returns their records in the order of ``seeds``. Each
    process writes its record beside ``--out`` (``<out>.<label>.json``), so
    the runs that ended are kept if the call is cut."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    base = [sys.executable, os.path.abspath(__file__), "--dtype", args.dtype,
            "--noise", str(args.noise), "--device", args.device]
    if args.steps is not None:
        base += ["--steps", str(args.steps)]
    if args.carries:
        base += ["--carries", args.carries]
    stem = args.out or os.path.join(tempfile.mkdtemp(), "runs.json")
    out, todo, live = {}, list(seeds), {}
    while todo or live:
        while todo and len(live) < args.jobs:
            seed = todo.pop(0)
            path = f"{stem}.{label(seed)}.json"
            cmd = base + (["--unmoved", "--seeds"] if seed is None
                          else ["--seeds", str(seed)]) + ["--out", path]
            live[seed] = (subprocess.Popen(cmd, env=env,
                                           stdout=subprocess.DEVNULL), path)
        for seed, (proc, path) in list(live.items()):
            if proc.poll() is None:
                continue
            del live[seed]
            if proc.returncode != 0:
                for p, _ in live.values():
                    p.kill()
                raise RuntimeError(f"run {label(seed)} exited with "
                                   f"{proc.returncode}")
            with open(path) as f:
                out[label(seed)] = json.load(f)["runs"][0]
            print(json.dumps({k: v for k, v in out[label(seed)].items()
                              if k not in PER_STEP}), flush=True)
        if live:
            try:
                next(iter(live.values()))[0].wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
    return [out[label(s)] for s in seeds]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f64", "f32"), default="f32")
    ap.add_argument("--noise", type=float, default=1e-7)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2])
    ap.add_argument("--unmoved", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--carries", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=None,
                    help="MPC steps (default 42; fewer only to rehearse)")
    args = ap.parse_args()
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card (or --device cpu)")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    ref = np.load(chip_smoke.FIXTURE if args.dtype == "f64"
                  else chip_smoke.FIXTURE_F32)
    smi = chip_smoke.nvidia_smi() if on_card else "cpu"
    seeds = ([None] if args.unmoved else []) + list(args.seeds)
    if args.jobs > 1:
        runs = side_by_side(args, seeds)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(runs=runs, nvidia_smi=smi, jobs=args.jobs),
                          f, indent=1)
        print(smi)
        return
    runs = []
    for seed in seeds:
        run, steps = one_run(args, seed, dtype, ref)
        runs.append(dict(run, **steps))
        print(json.dumps(run), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(runs=runs, nvidia_smi=smi), f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()

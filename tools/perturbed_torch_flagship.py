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

Prints one JSON line per run (the gates and pins of ``chip_smoke.py --full``)
and the card's name and power limit; ``--out`` keeps them. ``--device cpu``
runs the same on the CPU (the plain version of the kernels, the eager IP
loop; hours per run), to tell what belongs to the card's path.

Usage: python3 tools/perturbed_torch_flagship.py [--dtype f64|f32]
           [--noise EPS] [--seeds N ...] [--device cuda|cpu] [--out PATH.json]
"""
import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dlp_admm_torch.config import Formulation  # noqa: E402
from dlp_admm_torch.models.obca import ConsensusObcaPlanner  # noqa: E402
from dlp_admm_torch.mpc import run_obca  # noqa: E402

KEYS = ("steps", "res_ok", "mean_iterations", "min_distance_m",
        "min_footprint_gap_m", "health", "gap_median", "gap_max", "gates",
        "pins", "iterations")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("f64", "f32"), default="f32")
    ap.add_argument("--noise", type=float, default=1e-7)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card (or --device cpu)")
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    ref = np.load(chip_smoke.FIXTURE if args.dtype == "f64"
                  else chip_smoke.FIXTURE_F32)
    smi = chip_smoke.nvidia_smi() if on_card else "cpu"
    create = ConsensusObcaPlanner.create_bar_state
    runs = []
    for seed in args.seeds:
        def noisy(self, seed=seed):
            bs = create(self)
            eps = args.noise * np.random.default_rng(seed).normal(
                size=tuple(bs.z_bar.shape))
            return bs._replace(z_bar=bs.z_bar + torch.as_tensor(
                eps, dtype=bs.z_bar.dtype, device=bs.z_bar.device))

        ConsensusObcaPlanner.create_bar_state = noisy
        try:
            res = run_obca(Formulation.CONSENSUS, device=args.device,
                           **chip_smoke.flagship_profile(dtype))
        finally:
            ConsensusObcaPlanner.create_bar_state = create
        rec = chip_smoke.full_record(res, ref, str(dtype)[6:])
        summary = res.metrics.summary()
        run = dict({k: rec[k] for k in KEYS}, dtype=args.dtype,
                   noise=args.noise, seed=seed, device=args.device,
                   wall_s=summary["total_time_s"],
                   iterations_per_s=summary["iterations_per_s"])
        runs.append(run)
        print(json.dumps(run), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(runs=runs, nvidia_smi=smi), f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()

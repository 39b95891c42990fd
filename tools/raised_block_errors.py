"""Both backward errors of the float32 flagship's KKT systems raised to
float64 (the staged solver's float32 KKT solve: K1's float64 equilibrated
variant), for K1, its plain version and LAPACK's LU, and the row where
each solution's entry-by-entry error is largest.

    python tools/raised_block_errors.py [--device cuda] [--sample]
        [--out FILE]

Systems: the first ``SLICE_CALLS`` KKT solves of the float32 flagship slice
(``run_obca(CONSENSUS)`` with ``chip_smoke.flagship_profile(float32)``,
stopped after them; on a CUDA device its eager ones), made on
``--device`` (its first is the block that ``chip_smoke.py`` phase 7
keeps); with ``--sample`` also each lane of
``tests/data/kkt_f32_sample.npz``. Arms: the plain version
(equilibrated, float64) on the CPU and on ``--device``, LAPACK's LU in
float64 (``torch.linalg.solve`` of the dense matrix) and, on a CUDA
device, the kernel (``thomas.launch_kernel(..., True)``). Scores:
``chip_smoke.backward_error``'s componentwise and row-wise errors per
block. Prints one JSON line per block, then each arm's ratio to the plain
version on ``--device`` (median, largest, blocks above 4 times), and the
worst row of each arm on the first block: its stage and equation, its
residual against ``|A_i| |x| + |r_i|``, its right-hand side, its nonzeros
and ``|A_i|_1`` beside ``max |x|``. About 30 s on the CPU.
"""
from __future__ import annotations

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
from dlp_admm_torch.mpc.driver import run_obca  # noqa: E402
from dlp_admm_torch.solvers import ip_staged, thomas  # noqa: E402


SLICE_CALLS = 60


class _Enough(Exception):
    pass


def slice_blocks(n_calls, device):
    """The float32 flagship slice's first ``n_calls`` KKT systems, as the
    staged solver hands them to its solve (float32). On a CUDA device only
    the eager calls count (each solve's first IP trip): a call recorded
    into a CUDA graph holds no values yet."""
    keep, got = ip_staged.block_thomas_solve, []
    graphed = torch.device(device).type == "cuda"

    def capture(diag, upper, rhs):
        if not (graphed and torch.cuda.is_current_stream_capturing()):
            got.append((diag.clone(), upper.clone(), rhs.clone()))
            if len(got) >= n_calls:
                raise _Enough
        return keep(diag, upper, rhs)
    ip_staged.block_thomas_solve = capture
    try:
        run_obca(Formulation.CONSENSUS, n_steps=1, device=device,
                 **chip_smoke.flagship_profile(torch.float32))
    except _Enough:
        pass
    finally:
        ip_staged.block_thomas_solve = keep
    return got


def sample_blocks(device):
    """Each lane of the committed KKT sample, one block a lane."""
    z = np.load(chip_smoke.FIXTURE_KKT)
    out = []
    for fam in sorted({k.split("_")[0] for k in z.files
                       if k.endswith("_rhs")}):
        arrays = [torch.as_tensor(z[f"{fam}_{k}"], device=device)
                  for k in ("d", "u", "rhs")]
        out += [tuple(a[i:i + 1] for a in arrays)
                for i in range(arrays[0].shape[0])]
    return out


def arms(device):
    """name -> solve of float64 ``(diag, upper, rhs)`` on ``device``."""
    def plain_cpu(d, u, r):
        return thomas.block_thomas_plain(d.cpu(), u.cpu(), r.cpu(),
                                         True).to(d.device)

    def lapack(d, u, r):
        a, rhs = chip_smoke.dense_system(d, u, r)
        return torch.linalg.solve(a, rhs).reshape(r.shape)
    out = {"plain": lambda d, u, r: thomas.block_thomas_plain(d, u, r, True),
           "plain_cpu": plain_cpu, "lapack": lapack}
    if torch.device(device).type == "cuda":
        out["kernel"] = lambda d, u, r: thomas.launch_kernel(d, u, r, True)
    return out


def worst_row(d, u, r, x):
    """Where ``x``'s entry-by-entry backward error is largest."""
    a, rhs = chip_smoke.dense_system(d, u, r)
    xs = x.reshape(rhs.shape)
    res = (a @ xs - rhs).abs()
    den = a.abs() @ xs.abs() + rhs.abs()
    comp = res / den.clamp(min=1e-300)
    s, i = divmod(int(comp.argmax()), comp.shape[1])
    row = a[s, i]
    b = r.shape[2]
    return dict(system=s, stage=i // b, equation=i % b,
                error=float(comp[s, i]), residual=float(res[s, i]),
                terms=float(den[s, i]), rhs=float(rhs[s, i]),
                nonzeros=int((row != 0).sum()),
                row_l1=float(row.abs().sum()),
                max_abs_x=float(xs[s].abs().max()))


def score(name, blocks, solves):
    """Per block and arm: (componentwise, row-wise) backward errors."""
    rows = []
    for i, (d, u, r) in enumerate(blocks):
        d, u, r = (x.double().contiguous() for x in (d, u, r))
        row = dict(set=name, block=i, shape=list(r.shape))
        for arm, solve in solves.items():
            row[arm] = chip_smoke.backward_error(d, u, r, solve(d, u, r))
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    for arm in solves:
        for k, measure in enumerate(("componentwise", "row-wise")):
            ratio = np.array([row[arm][k] / max(row["plain"][k], 1e-300)
                              for row in rows])
            summary[f"{arm} {measure}"] = dict(
                median_ratio=float(np.median(ratio)),
                max_ratio=float(ratio.max()),
                above_4x=int((ratio > 4).sum()), blocks=len(rows))
    return rows, summary


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    solves = arms(args.device)
    blocks = slice_blocks(SLICE_CALLS, args.device)
    out = dict(device=args.device)
    out["slice"], out["slice_summary"] = score("slice", blocks, solves)
    d, u, r = (x.double().contiguous() for x in blocks[0])
    out["first_block_worst_row"] = {
        arm: worst_row(d, u, r, solve(d, u, r))
        for arm, solve in solves.items()}
    if args.sample:
        out["sample"], out["sample_summary"] = score(
            "sample", sample_blocks(args.device), solves)
    for key in ("slice_summary", "first_block_worst_row", "sample_summary"):
        if key in out:
            print(key, json.dumps(out[key], indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()

"""Time K1's big kernel (``csrc/block_thomas_big.cu``) on one CUDA card under
several counts of CTAs a system, in turns, at the widths past the cluster
kernel's reach: the 9-vehicle consensus edge (1, 7, 405) in float64, the
11-vehicle edge (1, 7, 605) in float32 equilibrated and in float64, and the
big kernel forced at (1, 7, 320) float64.

For each count R the plan is ``solvers.thomas``'s with R CTAs a system (the
blocks in shared memory, the next stage prefetched where two tiles fit);
every count must give the bits of the plan's own count (the order of work
on each entry does not depend on R). Device time per solve: 20 calls
captured as one CUDA graph and replayed (``chip_smoke.graph_ms``), the
counts in turns (a, b, ..., b, a). Prints one JSON line per shape and the
card's name and power limit.

Usage: python3 tools/time_big_ctas.py [--out PATH.json]
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
from dlp_admm_torch.solvers import thomas  # noqa: E402

# (shape, dtype, equilibrate, CTA counts to time beside the plan's own)
CASES = (((1, 7, 405), torch.float64, False, (26,)),
         ((1, 7, 605), torch.float32, True, (19, 20)),
         ((1, 7, 605), torch.float64, False, ()),
         ((1, 7, 320), torch.float64, False, (11,)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = chip_smoke.nvidia_smi()
    keep = thomas.big_ctas
    rng = np.random.default_rng(0)
    rows = []
    for shape, dtype, eq, others in CASES:
        d, u, r = (torch.as_tensor(a, dtype=dtype, device="cuda")
                   for a in chip_smoke.make_system(rng, *shape,
                                                   "diag_dominant"))
        plan = thomas.kernel_plan(*shape, dtype, eq, kernel="big")["ctas"]
        counts = (plan,) + others
        times, outs = {}, {}
        want = thomas.launch_kernel(d, u, r, eq, "big")
        try:
            for ctas in counts + counts[::-1]:
                def forced(b, elem, smem_limit=thomas.H100_SMEM_LIMIT,
                           sm_count=thomas.H100_SM_COUNT, ctas=ctas):
                    return ctas, thomas.big_bytes(
                        b, elem, ctas, True, True) <= smem_limit, True
                thomas.big_ctas = forced
                outs[ctas] = thomas.launch_kernel(d, u, r, eq, "big")
                times.setdefault(ctas, []).append(chip_smoke.graph_ms(
                    lambda: thomas.launch_kernel(d, u, r, eq, "big")))
        finally:
            thomas.big_ctas = keep
        torch.cuda.synchronize()
        row = dict(shape=list(shape), dtype=str(dtype)[6:], equilibrated=eq,
                   plan_ctas=plan,
                   ms={c: sum(t) / len(t) for c, t in times.items()},
                   ms_turns=times,
                   same_bits={c: bool(torch.equal(o, want))
                              for c, o in outs.items()}, nvidia_smi=smi)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not all(row["same_bits"].values()):
            raise RuntimeError(f"the CTA counts give other bits at {shape}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()

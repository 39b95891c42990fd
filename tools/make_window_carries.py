"""Save the JAX float32 flagship's MPC carry before each of its first steps.

Runs the JAX planner (CPU, float32 profile, JAX's 64-bit mode off) step by
step and writes, for every step ``k <= --upto``, the state and the
``BarState`` fields the step starts from as ``<k>_state`` and
``<k>_<field>`` into one ``.npz``. ``tools/check_torch_window.py`` starts the
PyTorch port's step ``k`` from the same carry, on the CPU or on the card
(which has no JAX), so that one conflict-window step of the two can be
compared without the chaotic history before it. ``--keep 14`` writes only
the carries of the steps named (the committed fixture
``tests/data/consensus_obca_f32_carry14.npz``, which the card's
repeatability test starts window step 14 from, is
``--upto 14 --keep 14 --out tests/data/consensus_obca_f32_carry14.npz``).

Usage: python tools/make_window_carries.py [--upto 24] [--keep K,K,...]
           [--out PATH.npz]
"""
import argparse
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dlp_admm_tpu.config import ObcaConfig, SolverConfig  # noqa: E402
from dlp_admm_tpu.models.obca import ConsensusObcaPlanner  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "_chipcheck", "carries_f32.npz")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--upto", type=int, default=24)
    ap.add_argument("--keep", default="",
                    help="comma-separated steps to write (default: all)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()
    keep = {int(k) for k in args.keep.split(",") if k}
    pl = ConsensusObcaPlanner(
        ObcaConfig(horizon=8, min_dis=0.1, rho=100.0, max_admm_iters=50),
        scfg=SolverConfig(ip_iters=40, ip_tol=1e-4), local_prox=700.0,
        prox_growth=1.5, prox_tau_max=1.0e9, dtype=jnp.float32)
    st = jnp.asarray(pl.refs[:, 0, :], jnp.float32)
    bs = pl.create_bar_state()
    arrays, its = {}, []
    for k in range(args.upto + 1):
        if not keep or k in keep:
            arrays[f"{k}_state"] = np.array(st)
            for name, v in bs._asdict().items():
                arrays[f"{k}_{name}"] = np.array(v)
        out = pl._mpc_step(st, bs, jnp.asarray(k, jnp.int32))
        st, bs = out[0], out[1]
        its.append(int(out[2]))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, iterations=np.asarray(its), **arrays)
    print(f"{args.out}: carries of steps {sorted(keep) or f'0..{args.upto}'}"
          f", JAX ADMM iterations {its}")


if __name__ == "__main__":
    main()

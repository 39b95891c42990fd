"""Single MPC steps of the JAX float32 flagship from saved carries (CPU).

``tools/perturbed_torch_flagship.py --carries DIR`` saves the carry every
step of a port run starts from (``DIR/carries_<label>.npz``, the format of
``tools/make_window_carries.py``). From each carry ``k`` of ``--steps``
this tool runs JAX's step ``k`` once from the carry as saved and, with
``--noise EPS``, once more from the carry with ``z_bar`` moved by normal
noise of that size (``--seed``): the distance between those two is JAX's
own noise floor at that step. ``tools/compare_window_steps.py`` sets them
beside the port's steps from the same carries.

With ``--then``, JAX also takes the next step ``k + 1`` from its own step's
carry (``jax_then_<k+1>_<field>``): set beside JAX's step ``k + 1`` from
the port's carry ``k + 1``, it shows whether the carries the port's steps
leave are harder for the next step than those JAX's steps leave.

Per step it writes the ADMM iterations, the residuals, NLP health and
KKT, the consensus gap, the next state and the planned states of the next
carry (``local_x``), as ``<label>_<k>_<field>`` arrays into ``--out``.

Usage: python tools/jax_window_steps.py --carries PATH.npz --steps 10-30
           [--noise 1e-7 --seed 1] [--then] --out PATH.npz
"""
import argparse
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dlp_admm_tpu.config import ObcaConfig, SolverConfig  # noqa: E402
from dlp_admm_tpu.models.obca import (  # noqa: E402
    BarState, ConsensusObcaPlanner)

FIELDS = ("iterations", "primal", "dual", "nlp_ok", "nlp_kkt", "gap",
          "next_state", "local_x")


def step_list(text):
    """``"10-30"`` or ``"14,17,20"`` -> sorted step indices."""
    out = set()
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.update(range(int(a), int(b) + 1))
        elif part:
            out.add(int(part))
    return sorted(out)


def carry(data, k, noise=0.0, seed=0):
    bs = BarState(**{f: jnp.asarray(data[f"{k}_{f}"], jnp.float32)
                     for f in BarState._fields})
    if noise:
        eps = noise * np.random.default_rng(seed).normal(size=bs.z_bar.shape)
        bs = bs._replace(z_bar=bs.z_bar + eps.astype(np.float32))
    return jnp.asarray(data[f"{k}_state"], jnp.float32), bs


def record(out):
    st, bs, it, pr, du, _cv, ok, kkt, gap = out
    return dict(iterations=np.asarray(int(it)), primal=np.asarray(pr),
                dual=np.asarray(du), nlp_ok=np.asarray(ok),
                nlp_kkt=np.asarray(kkt), gap=np.asarray(gap),
                next_state=np.asarray(st), local_x=np.asarray(bs.local_x))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--carries", required=True)
    ap.add_argument("--steps", default="10-30")
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--then", action="store_true")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    data = np.load(args.carries)
    pl = ConsensusObcaPlanner(
        ObcaConfig(horizon=8, min_dis=0.1, rho=100.0, max_admm_iters=50),
        scfg=SolverConfig(ip_iters=40, ip_tol=1e-4), local_prox=700.0,
        prox_growth=1.5, prox_tau_max=1.0e9, dtype=jnp.float32)
    arrays = {}
    sides = [("jax", 0.0)] + ([("jax_moved", args.noise)] if args.noise
                              else [])
    for k in step_list(args.steps):
        if f"{k}_state" not in data.files:
            continue
        for label, noise in sides:
            t0 = time.perf_counter()
            st, bs = carry(data, k, noise, args.seed)
            out = pl._mpc_step(st, bs, jnp.asarray(k, jnp.int32))
            rec = record(out)
            for f in FIELDS:
                arrays[f"{label}_{k}_{f}"] = rec[f]
            if args.then and label == "jax":
                nxt = record(pl._mpc_step(out[0], out[1],
                                          jnp.asarray(k + 1, jnp.int32)))
                for f in FIELDS:
                    arrays[f"jax_then_{k + 1}_{f}"] = nxt[f]
            print(f"{label} step {k}: {int(rec['iterations'])} ADMM "
                  f"iterations, primal {float(rec['primal']):.4f}, dual "
                  f"{float(rec['dual']):.4f}, nlp_ok {rec['nlp_ok'].tolist()}"
                  f", {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(args.out, noise=np.asarray(args.noise),
                        seed=np.asarray(args.seed), **arrays)


if __name__ == "__main__":
    main()

"""Supply-chain MPC with the ALADIN coordinator on the PyTorch port (the
counterpart of ``supply_chain_aladin.py``; SURVEY.md C17).

Two companies (echelons) each control their own linear inventory dynamics
over a horizon; the flow shipped by company 1 must equal the flow received
by company 2, a shared variable handled as an ALADIN coupling constraint, so
neither company reveals its internal model to the other.

Per agent i, decision y_i = [x_i (T+1, NX) | u_i (T, NU)] flattened:
    dynamics  x[t+1] = x[t] + B_i u[t] - d_i      (h_i = 0)
    objective tracking to target inventory + effort
Coupling: u_0[t, OUT] - u_1[t, IN] = 0 for all t.

Runs on the CUDA card; ``--device cpu`` is the only way to the CPU.

Run:  python examples/torch_supply_chain_aladin.py [--iters N] [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dlp_admm_torch.config import SolverConfig  # noqa: E402
from dlp_admm_torch.models.aladin import (  # noqa: E402
    AladinEngine, AladinProblem)

NX, NU, T = 3, 2, 6
NY = (T + 1) * NX + T * NU


def split(y):
    return y[:(T + 1) * NX].reshape(T + 1, NX), y[(T + 1) * NX:].reshape(T,
                                                                          NU)


def make_problem():
    """The problem, its per-agent parameters and the initial inventories,
    as float64 host tensors (the engine moves them to its device)."""
    def t(a):
        return torch.tensor(a, dtype=torch.float64)

    # company 0: produces and ships (u[:, 1] = outbound flow)
    # company 1: receives (u[:, 0] = inbound flow) and sells
    b = t([[[1.0, -1.0], [0.5, 0.0], [0.0, 1.0]],
           [[1.0, -0.5], [0.0, 1.0], [0.5, 0.0]]])
    x_init = t([[2.0, 1.0, 1.0], [1.5, 0.8, 1.2]])

    def f(y, p):
        xs, us = split(y)
        return torch.sum((xs - p["target"]) ** 2) + 0.1 * torch.sum(us ** 2)

    def h(y, p):
        xs, us = split(y)
        rdyn = xs[1:] - (xs[:-1] + us @ p["b"].T - p["d"])
        return torch.cat([xs[0] - p["x0"], rdyn.reshape(-1)])

    # coupling rows: one per horizon step, u_0[t, 1] == u_1[t, 0]
    a = np.zeros((2, T, NY))
    for k in range(T):
        a[0, k, (T + 1) * NX + k * NU + 1] = 1.0     # company 0 outbound
        a[1, k, (T + 1) * NX + k * NU + 0] = -1.0    # company 1 inbound
    prob = AladinProblem(f=f, h=h, a_mats=t(a), b=torch.zeros(
        T, dtype=torch.float64))
    params = dict(b=b, d=t([[0.3, 0.1, 0.0], [0.0, 0.4, 0.2]]),
                  target=t([[2.0, 1.0, 1.0]] * 2), x0=x_init)
    return prob, params, x_init


def main(n_iters: int = 25, device=None):
    """Run ``n_iters`` ALADIN iterations; print the coupling residual and
    the inventories; raise if the flows disagree after a full run. Returns
    ``(AladinState, ys)``."""
    prob, params, x_init = make_problem()
    eng = AladinEngine(prob, rho=5.0, mu=1e4,
                       scfg=SolverConfig(ip_iters=40, ip_tol=1e-8),
                       device=device)
    params = {k: v.to(eng.device) for k, v in params.items()}
    y0 = torch.zeros((2, NY), dtype=torch.float64)
    y0[:, :(T + 1) * NX] = x_init[:, None, :].expand(2, T + 1, NX).reshape(
        2, -1)
    state, ys = eng.run(y0.to(eng.device), params, n_iters=n_iters)
    xs0, us0 = split(ys[0])
    xs1, us1 = split(ys[1])
    ship_gap = float((us0[:, 1] - us1[:, 0]).abs().max())
    print("coupling residual:", float(state.coupling_res))
    print("max |shipped - received|:", ship_gap)
    print("company0 inventories:\n", np.round(xs0.cpu().numpy(), 3))
    print("company1 inventories:\n", np.round(xs1.cpu().numpy(), 3))
    if n_iters >= 25 and not ship_gap < 1e-4:
        raise RuntimeError(f"flows must agree at convergence: {ship_gap}")
    return state, ys


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    a = ap.parse_args()
    main(a.iters, a.device)

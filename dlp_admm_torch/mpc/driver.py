"""Receding-horizon driver (port of ``dlp_admm_tpu/mpc/driver.py``).

So far the consensus-ADMM OBCA flagship
(``run_obca(Formulation.CONSENSUS, ...)``) and the pairwise PI-ADMM engine
(``run_pi_admm(layout="pairwise", ...)``) run here, with the JAX driver's
defaults. The other formulations and layouts and plotting are still to be
ported (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import (DualUpdateConfig, Formulation, ObcaConfig,
                      PiAdmmConfig, SolverConfig, VehicleConfig)
from ..utils.metrics import RunMetrics


@dataclasses.dataclass
class RunResult:
    states: np.ndarray          # [T+1, V, state_dim]
    metrics: RunMetrics
    extras: dict


def run_obca(formulation: Formulation = Formulation.CONSENSUS,
             ocfg: Optional[ObcaConfig] = None,
             vcfg: Optional[VehicleConfig] = None,
             scfg: SolverConfig = SolverConfig(),
             n_steps: Optional[int] = None,
             plot_path: Optional[str] = None,
             device=None, dtype=torch.float64,
             **planner_kwargs) -> RunResult:
    """Run the consensus-ADMM OBCA flagship end to end on ``device``
    (≙ ``decentralized_overtaking_ADMM.py``): the CUDA card unless the
    caller names another device, e.g. ``device="cpu"``; without a card the
    default raises. ``dtype`` is float64 or float32.

    ``metrics.step_times`` holds one wall time per MPC step; ``extras``
    holds ``converge_flags``, the planner's per-step ``residuals`` rows
    (``ConsensusObcaPlanner.run``) and the ``planner`` itself (whose
    ``block_solves`` counts the block-tridiagonal KKT solves of the run and
    whose ``carry`` is the final MPC carry).
    """
    from ..models.obca import ConsensusObcaPlanner

    if formulation is not Formulation.CONSENSUS:
        raise NotImplementedError(
            f"{formulation} is not ported yet (ROADMAP.md queue 1)")
    if plot_path is not None:
        raise NotImplementedError(
            "plotting is not ported yet (ROADMAP.md queue 1, item "
            "'mpc/driver.py and the utilities')")
    vcfg = vcfg or VehicleConfig()
    ocfg = ocfg or ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                              max_admm_iters=15)
    metrics = RunMetrics()
    pl = ConsensusObcaPlanner(ocfg, vcfg, scfg, dtype=dtype, device=device,
                              **planner_kwargs)
    states, iters, residuals, flags = pl.run(n_steps,
                                             step_timer=metrics.step_timer)
    for t, it in enumerate(iters):
        metrics.log_step(t, it, primal=residuals[t][0],
                         dual=residuals[t][1], converged=flags[t])
    return RunResult(states=states, metrics=metrics,
                     extras=dict(converge_flags=flags, residuals=residuals,
                                 planner=pl))


_TODO_LAYOUT = {
    "classic": "ROADMAP.md queue 1, item 13 ('models/pi_admm.py, classic "
               "layout')",
    "aladin": "ROADMAP.md queue 1, item 15 ('models/aladin.py')",
}


def run_pi_admm(cfg: Optional[PiAdmmConfig] = None,
                dual_cfg: DualUpdateConfig = DualUpdateConfig(),
                scfg: SolverConfig = SolverConfig(),
                layout: str = "classic",
                n_steps: Optional[int] = None,
                xt0: Optional[np.ndarray] = None,
                plot_path: Optional[str] = None,
                device=None, dtype=torch.float64,
                **engine_kwargs) -> RunResult:
    """Run the unicycle PI-ADMM planner (``pairwise`` ≙ ``casadi/main.py``)
    one MPC step at a time on ``device`` (the CUDA card unless the caller
    names another; without a card the default raises).

    ``states`` is ``[T, V, 3]`` (the state after each step); ``metrics``
    holds the per-step iterations, rho and dual range; ``extras`` the
    applied controls and the engine.
    """
    from ..models.pi_admm import PiAdmmEngine

    if layout in _TODO_LAYOUT:
        raise NotImplementedError(
            f"layout={layout!r} is not ported yet ({_TODO_LAYOUT[layout]})")
    if plot_path is not None:
        raise NotImplementedError(
            "plotting is not ported yet (ROADMAP.md queue 1, item "
            "'mpc/driver.py and the utilities')")
    cfg = cfg or PiAdmmConfig()
    eng = PiAdmmEngine(cfg, dual_cfg, scfg, layout=layout, dtype=dtype,
                       device=device, **engine_kwargs)
    metrics = RunMetrics()
    with metrics.step_timer():
        rec = eng.run(xt0=xt0, n_steps=n_steps)
    for t in range(len(rec.iterations)):
        metrics.log_step(t, int(rec.iterations[t]),
                         rho=float(rec.rho[t]),
                         dual_min=float(rec.dual_min[t]),
                         dual_max=float(rec.dual_max[t]))
    return RunResult(states=np.asarray(rec.xt), metrics=metrics,
                     extras={"u_applied": rec.u_applied, "engine": eng})

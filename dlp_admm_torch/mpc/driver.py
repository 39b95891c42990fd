"""Receding-horizon driver (port of ``dlp_admm_tpu/mpc/driver.py``).

So far the centralized joint OBCA planner
(``run_obca(Formulation.CENTRALIZED, ...)``), the consensus-ADMM OBCA
flagship (``run_obca(Formulation.CONSENSUS, ...)``) and both layouts of the
PI-ADMM engine (``run_pi_admm(layout="classic" | "pairwise", ...)``) run
here, with the JAX driver's defaults. The bilevel, tightening and ALADIN
formulations, the ALADIN layout and plotting are still to be ported
(ROADMAP queue 1, items 14-16).
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
    """Run an OBCA-line formulation end to end on ``device``: the CUDA
    card unless the caller names another device, e.g. ``device="cpu"``;
    without a card the default raises. ``dtype`` is float64 or float32.

    ``CENTRALIZED`` ≙ ``centralized_overtaking.py`` (horizon 15, ``min_dis``
    1.0, 35 MPC steps by default): ``metrics`` logs each step's IP
    iterations and ``kkt``; ``extras`` holds the applied ``controls``.
    ``CONSENSUS`` ≙ ``decentralized_overtaking_ADMM.py``: ``metrics`` logs
    each step's ADMM iterations and residuals; ``extras`` holds
    ``converge_flags`` and the planner's per-step ``residuals`` rows
    (``ConsensusObcaPlanner.run``). Both: ``metrics.step_times`` holds one
    wall time per MPC step, and ``extras["planner"]`` the planner, whose
    ``block_solves`` counts the block-tridiagonal KKT solves of the run.
    """
    from ..models.obca import CentralizedObcaPlanner, ConsensusObcaPlanner

    if formulation not in (Formulation.CENTRALIZED, Formulation.CONSENSUS):
        raise NotImplementedError(
            f"{formulation} is not ported yet (ROADMAP.md queue 1, "
            f"{_TODO_FORMULATION[formulation]})")
    if plot_path is not None:
        raise NotImplementedError(
            "plotting is not ported yet (ROADMAP.md queue 1, item "
            "'mpc/driver.py and the utilities')")
    vcfg = vcfg or VehicleConfig()
    metrics = RunMetrics()
    if formulation is Formulation.CENTRALIZED:
        ocfg = ocfg or ObcaConfig(horizon=15, min_dis=1.0)
        pl = CentralizedObcaPlanner(ocfg, vcfg, scfg, dtype=dtype,
                                    device=device, **planner_kwargs)
        states, ctrls, infos = pl.run(n_steps, step_timer=metrics.step_timer)
        for t, info in enumerate(infos):
            metrics.log_step(t, info["iters"], kkt=info["kkt"])
        return RunResult(states=states, metrics=metrics,
                         extras=dict(controls=ctrls, planner=pl))
    ocfg = ocfg or ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                              max_admm_iters=15)
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


_TODO_FORMULATION = {
    Formulation.BILEVEL: "item 14 ('models/bilevel.py')",
    Formulation.TIGHTENING: "item 14 ('models/bilevel.py')",
    Formulation.TIGHTENING_SLACK: "item 14 ('models/bilevel.py')",
    Formulation.ALADIN: "item 15 ('models/aladin.py')",
}
_TODO_LAYOUT = {
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
    """Run the unicycle PI-ADMM planner (``classic`` ≙
    ``casadi_old_PI_ADMM/main.py``, ``pairwise`` ≙ ``casadi/main.py``) one
    MPC step at a time on ``device`` (the CUDA card unless the caller names
    another; without a card the default raises).

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

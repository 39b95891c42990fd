"""Receding-horizon driver (port of ``dlp_admm_tpu/mpc/driver.py``).

Every formulation of ``run_obca`` (centralized, consensus, bilevel,
tightening, tightening with the slack direction, ALADIN) and every layout
of ``run_pi_admm`` (classic, pairwise, ALADIN) runs here, with the JAX
driver's defaults; ``plot_path`` draws the run's trajectories
(``utils.plotting``) as the JAX driver does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import (DualUpdateConfig, Formulation, ObcaConfig,
                      PiAdmmConfig, SolverConfig, VehicleConfig)
from ..utils.metrics import RunMetrics
from ..utils.plotting import plot_trajectories


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
    (``ConsensusObcaPlanner.run``). ``BILEVEL`` ≙ the MISC line and
    ``TIGHTENING`` / ``TIGHTENING_SLACK`` ≙
    ``decentralized_overtaking_tighting.py`` (horizon 8, ``min_dis`` 1.0):
    ``metrics`` logs each step's ``elastic``; ``extras`` holds the
    planner's per-step ``infos``. ``vcfg=None`` selects the formulation's
    reference default: T = 7 s, prob = 0.99 (the tighting line's
    ``veh_config.py:18``) for the tightening pair, the plain
    ``VehicleConfig`` for the rest; a caller's ``vcfg`` is always honoured.
    ``ALADIN`` delegates to ``run_pi_admm(layout="aladin")``. All:
    ``metrics.step_times`` holds one wall time per MPC step, and
    ``extras["planner"]`` the planner; the OBCA planners' ``block_solves``
    counts the block-tridiagonal KKT solves of the run. ``plot_path`` writes
    a PNG of the paths and footprints there (nothing without matplotlib).
    """
    from ..models.bilevel import (BilevelObcaPlanner, TighteningObcaPlanner,
                                  TighteningSlackObcaPlanner)
    from ..models.obca import CentralizedObcaPlanner, ConsensusObcaPlanner

    if formulation is Formulation.ALADIN:
        # a PiAdmmConfig-shaped instance (agents = vehicles, coupling =
        # consensus position copies), so delegate as JAX does
        return run_pi_admm(scfg=scfg, layout="aladin", n_steps=n_steps,
                           plot_path=plot_path, device=device, dtype=dtype,
                           **planner_kwargs)
    tightening = (Formulation.TIGHTENING, Formulation.TIGHTENING_SLACK)
    if vcfg is None:
        vcfg = (VehicleConfig(T=7.0, prob=0.99) if formulation in tightening
                else VehicleConfig())
    metrics = RunMetrics()
    if formulation is Formulation.CENTRALIZED:
        ocfg = ocfg or ObcaConfig(horizon=15, min_dis=1.0)
        pl = CentralizedObcaPlanner(ocfg, vcfg, scfg, dtype=dtype,
                                    device=device, **planner_kwargs)
        states, ctrls, infos = pl.run(n_steps, step_timer=metrics.step_timer)
        for t, info in enumerate(infos):
            metrics.log_step(t, info["iters"], kkt=info["kkt"])
        return _plotted(RunResult(states=states, metrics=metrics,
                                  extras=dict(controls=ctrls, planner=pl)),
                        plot_path, vcfg, formulation)
    if formulation is Formulation.BILEVEL or formulation in tightening:
        ocfg = ocfg or ObcaConfig(horizon=8, min_dis=1.0)
        cls = {Formulation.BILEVEL: BilevelObcaPlanner,
               Formulation.TIGHTENING: TighteningObcaPlanner,
               Formulation.TIGHTENING_SLACK: TighteningSlackObcaPlanner}[
                   formulation]
        pl = cls(ocfg, vcfg, scfg, dtype=dtype, device=device,
                 **planner_kwargs)
        states, infos = pl.run(n_steps, step_timer=metrics.step_timer)
        for t, info in enumerate(infos):
            metrics.log_step(t, 1, elastic=info["elastic"])
        return _plotted(RunResult(states=states, metrics=metrics,
                                  extras=dict(infos=infos, planner=pl)),
                        plot_path, vcfg, formulation)
    if formulation is not Formulation.CONSENSUS:
        raise ValueError(f"unknown formulation {formulation}")
    ocfg = ocfg or ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                              max_admm_iters=15)
    pl = ConsensusObcaPlanner(ocfg, vcfg, scfg, dtype=dtype, device=device,
                              **planner_kwargs)
    states, iters, residuals, flags = pl.run(n_steps,
                                             step_timer=metrics.step_timer)
    for t, it in enumerate(iters):
        metrics.log_step(t, it, primal=residuals[t][0],
                         dual=residuals[t][1], converged=flags[t])
    return _plotted(RunResult(states=states, metrics=metrics,
                              extras=dict(converge_flags=flags,
                                          residuals=residuals, planner=pl)),
                    plot_path, vcfg, formulation)


def _plotted(res: RunResult, plot_path, vcfg, formulation) -> RunResult:
    """Draw an OBCA run's paths and footprints at ``plot_path`` (JAX
    ``driver.py:109-110``)."""
    if plot_path:
        plot_trajectories(res.states, plot_path, vcfg,
                          title=formulation.value)
    return res


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
    MPC step at a time, or the ALADIN coordinator on the same problem
    (``layout="aladin"``), on ``device`` (the CUDA card unless the caller
    names another; without a card the default raises).

    PI-ADMM: ``states`` is ``[T, V, 3]`` (the state after each step);
    ``metrics`` holds the per-step iterations, rho and dual range;
    ``extras`` the applied controls and the engine. ALADIN: ``states`` is
    ``[T+1, V, 3]`` (the start included); ``metrics`` holds the per-step
    ALADIN iterations and wall times; ``extras`` the planner and the
    ``iterations``. ``plot_path`` writes a PNG of the paths there (nothing
    without matplotlib).
    """
    from ..models.pi_admm import PiAdmmEngine

    cfg = cfg or PiAdmmConfig()
    if layout == "aladin":
        from ..models.aladin import AladinUnicyclePlanner
        pl = AladinUnicyclePlanner(cfg, scfg=scfg, dtype=dtype, device=device,
                                   **engine_kwargs)
        metrics = RunMetrics()
        states, iters = pl.run(n_steps=n_steps,
                               step_timer=metrics.step_timer)
        for t, it in enumerate(iters):
            metrics.log_step(t, int(it))
        if plot_path:
            plot_trajectories(states, plot_path, footprints=False,
                              title="aladin")
        return RunResult(states=states, metrics=metrics,
                         extras={"planner": pl, "iterations": iters})
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
    states = np.asarray(rec.xt)
    if plot_path:
        plot_trajectories(states, plot_path, footprints=False,
                          title=f"pi_admm[{layout}]")
    return RunResult(states=states, metrics=metrics,
                     extras={"u_applied": rec.u_applied, "engine": eng})

"""Receding-horizon driver (port of ``dlp_admm_tpu/mpc/driver.py``).

So far only the consensus-ADMM OBCA flagship runs here:
``run_obca(Formulation.CONSENSUS, ...)`` with the JAX driver's defaults. The
other formulations, ``run_pi_admm`` and plotting are still to be ported
(ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Formulation, ObcaConfig, SolverConfig, VehicleConfig
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

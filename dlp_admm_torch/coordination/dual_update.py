"""Dual-update strategies for the (PI-)ADMM engines — the paper's core.

Port of ``dlp_admm_tpu/coordination/dual_update.py``: the three strategies x
three anti-windup modes of the reference (SURVEY.md C11) as pure functions
of ``(r, sum_err, diff_val, d_min)``:

* PLAIN          — dual ascent ``lam += rho * r``
* PI_SIGMOID     — ``kP = th1 - th2/(1+exp(-d_min))``, integrator advanced
  before the dual is formed (ref ``...PI_antiwindup.m:160-167``)
* PI_RECIPROCAL  — ``K_P = min(kp_num/d_min, kp_cap)``, optional adaptive
  ``rho = clip(rho_num/d_min, lo, hi)`` (ref ``casadi_old_PI_ADMM/main.py:135-151``)

Windup modes: NONE (no clip), SAT (clip only), SAT_BACKCALC (clip + feed
``lam_sat - lam_raw`` to the integrator next iteration). Every function
broadcasts over arbitrary leading axes. ``update_dual(..., lane_dims=L)``
treats the first L axes as independent lanes (one scenario each): the
adaptive ``rho`` is then one per lane, from that lane's own ``d_min``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DualStrategy, DualUpdateConfig, WindupMode


class DualState(NamedTuple):
    """Carry of the dual controller between ADMM iterations."""

    dual: torch.Tensor      # lambda (same shape as the consensus residual)
    sum_err: torch.Tensor   # PI integrator state
    diff_val: torch.Tensor  # anti-windup back-calculation feed
    rho: torch.Tensor       # scalar penalty (may be adapted per iteration)


def init_dual_state(shape, rho: float, dtype=torch.float32,
                    device="cpu") -> DualState:
    z = torch.zeros(shape, dtype=dtype, device=device)
    return DualState(dual=z, sum_err=z, diff_val=z,
                     rho=torch.tensor(rho, dtype=dtype, device=device))


def _apply_windup(raw: torch.Tensor, cfg: DualUpdateConfig):
    """Returns (saturated dual, back-calculation term)."""
    if cfg.windup is WindupMode.NONE:
        return raw, torch.zeros_like(raw)
    sat = torch.clamp(raw, -cfg.windup_sat, cfg.windup_sat)
    if cfg.windup is WindupMode.SAT:
        return sat, torch.zeros_like(raw)
    return sat, sat - raw


def update_dual(state: DualState, r: torch.Tensor, d_min: torch.Tensor,
                cfg: DualUpdateConfig, lane_dims: int = 0) -> DualState:
    """One dual update; ``r`` is the consensus error and ``d_min`` the minimum
    predicted inter-vehicle distance (scalar or broadcastable per pair).

    ``lane_dims``: the number of leading lane axes of ``r`` and ``d_min``
    (0: none). ``state.rho`` has the lane shape, and the adaptive ``rho``
    takes the minimum of ``d_min`` over each lane's own axes."""
    rho = state.rho
    d_min = torch.as_tensor(d_min, dtype=state.dual.dtype,
                            device=state.dual.device)
    if cfg.strategy is DualStrategy.PI_RECIPROCAL and cfg.adaptive_rho:
        # rho stays one number per lane — with per-pair d_min the lane's
        # minimum governs
        d_lo = (torch.min(d_min) if lane_dims == 0 else torch.amin(
            d_min, dim=tuple(range(lane_dims, d_min.ndim))))
        rho = torch.clamp(cfg.rho_num / d_lo, cfg.rho_lo,
                          cfg.rho_hi).to(state.dual.dtype)
    rho_out = rho
    # per-lane rho broadcast over each lane's cells
    rho = rho.reshape(rho.shape + (1,) * (r.ndim - rho.ndim))

    if cfg.strategy is DualStrategy.PLAIN:
        raw = state.dual + rho * r + state.diff_val
        sum_err = state.sum_err
    elif cfg.strategy is DualStrategy.PI_RECIPROCAL:
        # K_P from the previous integrator state; integrator advanced after
        # with back-calculation gain; optional distance-scheduled K_I
        k_p = torch.clamp(cfg.kp_num / d_min, max=cfg.kp_cap)
        k_i = cfg.ki_num / d_min if cfg.ki_adaptive else cfg.ki
        raw = state.sum_err + k_p * r
        sum_err = state.sum_err + k_i * r + cfg.backcalc_gain * state.diff_val
    elif cfg.strategy is DualStrategy.PI_SIGMOID:
        k_i = rho if cfg.ki_from_rho else cfg.ki
        k_p = cfg.sigmoid_th1 - cfg.sigmoid_th2 / (1.0 + torch.exp(-d_min))
        sum_err = state.sum_err + k_i * r + state.diff_val
        raw = sum_err + k_p * r
    else:  # pragma: no cover
        raise ValueError(f"unknown strategy {cfg.strategy}")

    dual, diff_val = _apply_windup(raw, cfg)
    return DualState(dual=dual, sum_err=sum_err, diff_val=diff_val,
                     rho=rho_out)

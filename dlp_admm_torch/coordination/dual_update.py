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
broadcasts over arbitrary leading axes.
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


def _apply_windup(raw: torch.Tensor, cfg: DualUpdateConfig):
    """Returns (saturated dual, back-calculation term)."""
    if cfg.windup is WindupMode.NONE:
        return raw, torch.zeros_like(raw)
    sat = torch.clamp(raw, -cfg.windup_sat, cfg.windup_sat)
    if cfg.windup is WindupMode.SAT:
        return sat, torch.zeros_like(raw)
    return sat, sat - raw


def update_dual(state: DualState, r: torch.Tensor, d_min: torch.Tensor,
                cfg: DualUpdateConfig) -> DualState:
    """One dual update; ``r`` is the consensus error and ``d_min`` the minimum
    predicted inter-vehicle distance (scalar or broadcastable per pair)."""
    rho = state.rho
    d_min = torch.as_tensor(d_min, dtype=state.dual.dtype,
                            device=state.dual.device)
    if cfg.strategy is DualStrategy.PI_RECIPROCAL and cfg.adaptive_rho:
        # rho stays a scalar — with per-pair d_min the global minimum governs
        rho = torch.clamp(cfg.rho_num / torch.min(d_min), cfg.rho_lo,
                          cfg.rho_hi).to(state.dual.dtype)

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
    return DualState(dual=dual, sum_err=sum_err, diff_val=diff_val, rho=rho)

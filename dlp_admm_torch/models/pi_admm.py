"""Unicycle PI-ADMM planner, classic (stacked) and pairwise (gated) layouts,
ported to PyTorch.

Port of ``PiAdmmEngine`` in ``dlp_admm_tpu/models/pi_admm.py``:

* **classic** (the default, ≙ ``casadi_old_PI_ADMM/main.py``): one stacked
  consensus state per vehicle, one joint edge QP over all vehicles with a
  hinge block per unordered pair, the PI dual update on the prediction
  rollout, and a stop test that can also ask for clearance;
* **pairwise** (≙ ``casadi/main.py``): per-ordered-pair consensus cells
  ``hat_pos[i, j]`` and duals, collision-pair gating via ``edge_mat``,
  per-pair edge subproblems.

Both solve their edge problems by sequential convexification (linearize the
nonlinear edge rollout, solve a slack-form hinge QP) and update the duals
with the PI controller with anti-windup and adaptive rho.

Every function carries a leading **lane** axis ``S`` (one scenario per lane)
where the JAX code is written for one lane and ``vmap``-ed: an iteration
solves the local QPs of all lanes as one batch ``[S·V, H, H]`` and the edge
QPs of all lanes' selected pairs as one batch ``[S·k, 3H, 3H]``. Every
quantity JAX computes per lane (the adaptive rho, the residual sums,
``none_active``, the per-edge tolerance scale, the budget cap) is reduced
over that lane's own axes.

Two drivers, as in JAX:

* the per-step driver (:meth:`PiAdmmEngine.run`, :meth:`run_scan`), either
  layout: one MPC step at a time, the ADMM loop a Python loop that reads
  ``done`` on the host once per iteration;
* the fused whole-run driver (:meth:`PiAdmmEngine.run_fused_batch`),
  pairwise layout only: one
  loop of "trips" over the whole run of every lane, a lane finishing its
  step inline and going on with its next. A trip has static shapes and no
  host read; on a CUDA device it is captured once as a CUDA graph and
  replayed, and the host reads whether any lane is still running once per
  chunk of trips. A lane past its last step is frozen (every write masked),
  so the records do not depend on the chunk size.

``PiAdmmEngine.run`` saves the ``(xt, u)`` carry (with
``carry_admm_state``, ``(xt, u, AdmmCarry)``) after every step with
``checkpoint_path``, in the JAX package's shapes of one lane, and continues
a saved run with ``resume=True`` (:mod:`..utils.checkpoint`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import scenarios
from ..config import DualUpdateConfig, PiAdmmConfig, SolverConfig
from ..coordination.dual_update import DualState, update_dual
from ..coordination.residuals import (min_pair_distance, per_edge_residuals,
                                      stacked_residuals)
from ..ops.dynamics import unicycle_rollout_edge, unicycle_rollout_local
from ..ops.pairs import num_pairs, pair_indices
from ..solvers.qp import _mv, solve_qp
from ..utils.checkpoint import resume_carry, save_carry
from .obca import resolve_device


# %% affine models of the rollouts -------------------------------------------

def _local_affine(xt_i, spd_i, horizon, dt, wheel_base):
    """``pos(u) = pos0 + B u`` of the locally-linearized rollout, closed form
    (``xt_i [..., 3]``, ``spd_i [...]`` -> ``pos0 [..., 2(H+1)]``,
    ``B [..., 2(H+1), H]``): with the Taylor heading th0 fixed,

        dx_k/du_m = -(dt^2 v^2 / L) sin(th0) * max(k - 1 - m, 0)
        dy_k/du_m = +(dt^2 v^2 / L) cos(th0) * max(k - 1 - m, 0)
    """
    dtype, dev = xt_i.dtype, xt_i.device
    zero = xt_i.new_zeros(xt_i.shape[:-1] + (horizon,))
    x0, y0, _ = unicycle_rollout_local(xt_i, zero, spd_i, dt, wheel_base)
    pose0 = torch.cat([x0, y0], dim=-1)
    th0 = xt_i[..., 2]
    c = dt * dt * spd_i * spd_i / wheel_base
    k = torch.arange(horizon + 1, dtype=dtype, device=dev)[:, None]
    m = torch.arange(horizon, dtype=dtype, device=dev)[None, :]
    ramp = torch.clamp(k - 1.0 - m, min=0.0)
    bx = (-c * torch.sin(th0))[..., None, None] * ramp
    by = (c * torch.cos(th0))[..., None, None] * ramp
    return pose0, torch.cat([bx, by], dim=-2)


def _edge_affine(xt_i, spd_i, u0_i, dt, wheel_base):
    """First-order model of the *nonlinear* edge rollout at ``u0``, closed
    form (the edge model is ``x_+ = x + dt v cos(th)``, ``th_+ = th + (dt v /
    L) u``, so ``th_k`` is linear in u):

        d x_k / d u_m = -(dt^2 v^2 / L) * sum_{j=m+1}^{k-1} sin(th_j)

    ``xt_i [..., 3]``, ``spd_i [...]``, ``u0_i [..., H]``."""
    h = u0_i.shape[-1]
    x, y, th = unicycle_rollout_edge(xt_i, u0_i, spd_i, dt, wheel_base)
    pose0 = torch.cat([x, y], dim=-1)
    c = (dt * dt * spd_i * spd_i / wheel_base)[..., None, None]
    # S[k] = sum_{j<k} sin(th_j), k = 0..H (th_j for j = 0..H-1)
    zero = th.new_zeros(th.shape[:-1] + (1,))
    s_cum = torch.cat([zero, torch.cumsum(torch.sin(th[..., :-1]), -1)], -1)
    c_cum = torch.cat([zero, torch.cumsum(torch.cos(th[..., :-1]), -1)], -1)
    k = torch.arange(h + 1, device=th.device)[:, None]
    m = torch.arange(h, device=th.device)[None, :]
    mask = (k >= m + 2).to(th.dtype)
    bx = -c * (s_cum[..., k] - s_cum[..., m + 1]) * mask
    by = c * (c_cum[..., k] - c_cum[..., m + 1]) * mask
    return pose0, torch.cat([bx, by], dim=-2)


# %% local (vehicle-side) QP --------------------------------------------------

def _second_diff(h: int) -> np.ndarray:
    d = np.zeros((max(h - 2, 0), h))
    for k in range(h - 2):
        d[k, k], d[k, k + 1], d[k, k + 2] = 1.0, -2.0, 1.0
    return d


def _first_diff(h: int) -> np.ndarray:
    d = np.zeros((max(h - 1, 0), h))
    for k in range(h - 1):
        d[k, k], d[k, k + 1] = -1.0, 1.0
    return d


class _LocalStatics(NamedTuple):
    d2: torch.Tensor       # [H-2, H] second difference (steering smoothness)
    a_con: torch.Tensor    # [H + H-1, H] box + rate constraint rows
    lo: torch.Tensor
    hi: torch.Tensor


def _local_statics(cfg: PiAdmmConfig, dtype, device="cpu") -> _LocalStatics:
    h = cfg.horizon
    kw = dict(dtype=dtype, device=device)
    d2 = torch.as_tensor(_second_diff(h), **kw)
    a_con = torch.as_tensor(np.vstack([np.eye(h), _first_diff(h)]), **kw)
    lo = torch.cat([torch.full((h,), -cfg.u_max, **kw),
                    torch.full((h - 1,), -cfg.du_max, **kw)])
    return _LocalStatics(d2, a_con, lo, -lo)


def _solve_local_qp(pos0, b_mat, ref_flat, hats, duals, al_w, rho, u_warm,
                    statics: _LocalStatics, cfg: PiAdmmConfig,
                    scfg: SolverConfig):
    """A batch of vehicles' primal QPs (ref ``cost_function_primal``,
    ``PI_ADMM_class.py:110-133``): ``pos0 [B, 2(H+1)]``, ``b_mat
    [B, 2(H+1), H]``, ``hats/duals [B, K, 2(H+1)]`` consensus/dual terms with
    weights ``al_w [B, K]``, ``rho [B]`` (each QP its lane's), ``u_warm
    [B, H]``. Returns ``(u [B, H], pos [B, 2(H+1)])``."""
    bsz = pos0.shape[0]
    btb = b_mat.mT @ b_mat
    eye = torch.eye(cfg.horizon, dtype=pos0.dtype, device=pos0.device)
    p_mat = (2.0 * cfg.p_norm * btb
             + 2.0 * statics.d2.T @ statics.d2
             + 2.0 * cfg.p_cost * eye
             + (rho * torch.sum(al_w, dim=-1))[:, None, None] * btb)
    q = _mv(2.0 * cfg.p_norm * b_mat.mT, pos0 - ref_flat)
    resid = pos0[:, None, :] - hats + duals           # [B, K, 2(H+1)]
    q = q + _mv(rho[:, None, None] * b_mat.mT,
                torch.sum(al_w[..., None] * resid, dim=-2))
    m = statics.lo.shape[0]
    sol = solve_qp(p_mat, q, statics.a_con.expand(bsz, m, cfg.horizon),
                   statics.lo.expand(bsz, m), statics.hi.expand(bsz, m),
                   scfg, x0=u_warm)
    return sol.x, pos0 + _mv(b_mat, sol.x)


# %% edge (coordinator-side) QP ----------------------------------------------

def _hinge_rows(be_i, be_j, pose0_i, pose0_j, last_dis, horizon):
    """Affine model of ``dis_temp_k`` for a batch of pairs at steps k = 1..H
    (``dis_temp_k(u) = 2 <last_dis, pos_j_k - pos_i_k> - ||last_dis||^2``,
    ref ``casadi/PI_ADMM_class.py:149-151``). ``be_* [B, 2(H+1), H]``,
    ``pose0_* [B, 2(H+1)]``, ``last_dis [B, 2]``. Returns
    ``(const [B, H], g_i [B, H, H], g_j [B, H, H])`` with ``dis_temp = const
    - g_i @ u_i + g_j @ u_j``."""
    h = horizon
    # rows of the flat pos vector: x_k at k, y_k at (H+1)+k, k = 1..H
    gx_i, gy_i = be_i[..., 1:h + 1, :], be_i[..., h + 2:, :]
    gx_j, gy_j = be_j[..., 1:h + 1, :], be_j[..., h + 2:, :]
    px_i, py_i = pose0_i[..., 1:h + 1], pose0_i[..., h + 2:]
    px_j, py_j = pose0_j[..., 1:h + 1], pose0_j[..., h + 2:]
    ldx, ldy = last_dis[..., 0:1], last_dis[..., 1:2]
    const = (2.0 * (ldx * (px_j - px_i) + ldy * (py_j - py_i))
             - (ldx * ldx + ldy * ldy))
    ldx, ldy = ldx[..., None], ldy[..., None]
    g_i = 2.0 * (ldx * gx_i + ldy * gy_i)
    g_j = 2.0 * (ldx * gx_j + ldy * gy_j)
    return const, g_i, g_j


def edge_qp_m(cfg: PiAdmmConfig) -> int:
    """Constraint-row count of the per-pair edge QP (for dual warm starts)."""
    h = cfg.horizon
    return 2 * h + 2 * (h - 1) + h + h


class _EdgeStatics(NamedTuple):
    """The edge QP's constant rows: box u (2H), rate (2(H-1)), t >= 0 (H),
    and their bounds."""
    a_const: torch.Tensor   # [2H + 2(H-1) + H, 3H]
    lo_c: torch.Tensor
    hi_c: torch.Tensor
    eye_h: torch.Tensor


def _edge_statics(cfg: PiAdmmConfig, dtype, device="cpu") -> _EdgeStatics:
    h = cfg.horizon
    kw = dict(dtype=dtype, device=device)
    d1 = _first_diff(h)
    z = np.zeros((h - 1, h))
    a_box = np.concatenate([np.eye(2 * h), np.zeros((2 * h, h))], axis=1)
    a_rate = np.block([[d1, z, z], [z, d1, z]])
    a_tpos = np.concatenate([np.zeros((h, 2 * h)), np.eye(h)], axis=1)
    lo_c = torch.cat([torch.full((2 * h,), -cfg.u_max, **kw),
                      torch.full((2 * (h - 1),), -cfg.du_max, **kw),
                      torch.zeros(h, **kw)])
    hi_c = torch.cat([torch.full((2 * h,), cfg.u_max, **kw),
                      torch.full((2 * (h - 1),), cfg.du_max, **kw),
                      torch.full((h,), float("inf"), **kw)])
    return _EdgeStatics(
        torch.as_tensor(np.concatenate([a_box, a_rate, a_tpos]), **kw),
        lo_c, hi_c, torch.eye(h, **kw))


def _solve_pair_edge_qp(xt_pair, spd_pair, pos_old_pair, dual_pair, last_dis,
                        u0, cfg: PiAdmmConfig, scfg: SolverConfig,
                        n_sqp: int = 2, y0=None, prox_tau: float = 0.0,
                        statics: Optional[_EdgeStatics] = None):
    """Edge subproblems of a batch of vehicle pairs via sequential
    convexification (the per-pair OSQP solve of ``casadi/main.py:120-153``).

    Decision per pair: ``w = [u_i (H), u_j (H), t (H)]``; objective ``2 beta
    sum(t) + Pcost ||u||^2 + rho/2 ||pos_old - pos_e(u) + dual||^2`` (+ the
    proximal ``tau/2 ||u - u_lin||^2``); constraints box/rate on u, ``t >=
    0``, ``t + dis_temp(u) >= thres^2``.

    ``xt_pair [B, 2, 3]``, ``spd_pair [B, 2]``, ``pos_old_pair / dual_pair
    [B, 2, 2(H+1)]``, ``last_dis [B, 2]``, ``u0 [B, 2, H]``, ``y0 [B, m]``.
    Returns ``(u_opt [B, 2, H], hat [B, 2 sides, 2 xy, H+1], converged [B],
    y_out [B, m])``.
    """
    h = cfg.horizon
    bsz = xt_pair.shape[0]
    dtype, dev = pos_old_pair.dtype, pos_old_pair.device
    n = 3 * h
    rho = cfg.rho
    st = statics if statics is not None else _edge_statics(cfg, dtype, dev)
    m_c = st.a_const.shape[0]
    a_const = st.a_const.expand(bsz, m_c, n)
    lo_c, hi_c = st.lo_c.expand(bsz, m_c), st.hi_c.expand(bsz, m_c)
    eye_2h = torch.eye(2 * h, dtype=dtype, device=dev)
    if y0 is None:
        y0 = torch.zeros((bsz, edge_qp_m(cfg)), dtype=dtype, device=dev)

    u_lin, y_warm = u0, y0
    conv = torch.zeros(bsz, dtype=torch.bool, device=dev)
    for _ in range(n_sqp):
        pose0_i, be_i = _edge_affine(xt_pair[:, 0], spd_pair[:, 0],
                                     u_lin[:, 0], cfg.dt, cfg.wheel_base)
        pose0_j, be_j = _edge_affine(xt_pair[:, 1], spd_pair[:, 1],
                                     u_lin[:, 1], cfg.dt, cfg.wheel_base)
        # affine pos_e(u) = c + Be u with c = pose0 - Be u_lin
        c_i = pose0_i - _mv(be_i, u_lin[:, 0])
        c_j = pose0_j - _mv(be_j, u_lin[:, 1])

        # quadratic objective blocks
        p_mat = torch.zeros((bsz, n, n), dtype=dtype, device=dev)
        p_mat[:, :2 * h, :2 * h] = (2.0 * cfg.p_cost + prox_tau) * eye_2h
        p_mat[:, :h, :h] += rho * be_i.mT @ be_i
        p_mat[:, h:2 * h, h:2 * h] += rho * be_j.mT @ be_j
        # AL linear terms: rho/2 ||d - Be u||^2, d = pos_old + dual - c
        d_i = pos_old_pair[:, 0] + dual_pair[:, 0] - c_i
        d_j = pos_old_pair[:, 1] + dual_pair[:, 1] - c_j
        q = torch.cat(
            [_mv(-rho * be_i.mT, d_i) - prox_tau * u_lin[:, 0],
             _mv(-rho * be_j.mT, d_j) - prox_tau * u_lin[:, 1],
             torch.full((bsz, h), 2.0 * cfg.beta, dtype=dtype, device=dev)],
            dim=-1)

        # hinge rows: t + dis_temp(u) >= thres^2
        const, g_i, g_j = _hinge_rows(be_i, be_j, c_i, c_j, last_dis, h)
        a_hinge = torch.cat([-g_i, g_j, st.eye_h.expand(bsz, h, h)], dim=-1)
        lo_h = cfg.dis_thres ** 2 - const
        hi_h = torch.full((bsz, h), float("inf"), dtype=dtype, device=dev)

        a_mat = torch.cat([a_const, a_hinge], dim=-2)
        lo = torch.cat([lo_c, lo_h], dim=-1)
        hi = torch.cat([hi_c, hi_h], dim=-1)
        w0 = torch.cat([u_lin.reshape(bsz, 2 * h),
                        torch.zeros((bsz, h), dtype=dtype, device=dev)], -1)
        sol = solve_qp(p_mat, q, a_mat, lo, hi, scfg, x0=w0, y0=y_warm)
        u_lin = sol.x[:, :2 * h].reshape(bsz, 2, h)
        y_warm, conv = sol.y, sol.converged
    # consensus trajectories from the true nonlinear edge rollout
    # (ref casadi/main.py:156-158)
    ex, ey, _ = unicycle_rollout_edge(xt_pair, u_lin, spd_pair, cfg.dt,
                                      cfg.wheel_base)
    return u_lin, torch.stack([ex, ey], dim=-2), conv, y_warm


def joint_edge_qp_m(cfg: PiAdmmConfig) -> int:
    """Constraint-row count of the joint (all-vehicle) edge QP."""
    v, h, p = cfg.num_veh, cfg.horizon, num_pairs(cfg.num_veh)
    return v * h + v * (h - 1) + p * h + p * h


def _joint_edge_statics(cfg: PiAdmmConfig, dtype,
                        device="cpu") -> _EdgeStatics:
    """The joint edge QP's constant rows: box on each u (VH), rate per
    vehicle (V(H-1)), t >= 0 (PH), and their bounds (``eye_h`` holds the
    hinge rows' ``[PH, PH]`` identity)."""
    v, h, p = cfg.num_veh, cfg.horizon, num_pairs(cfg.num_veh)
    kw = dict(dtype=dtype, device=device)
    a_box = np.concatenate([np.eye(v * h), np.zeros((v * h, p * h))], axis=1)
    a_rate = np.concatenate([np.kron(np.eye(v), _first_diff(h)),
                             np.zeros((v * (h - 1), p * h))], axis=1)
    a_tpos = np.concatenate([np.zeros((p * h, v * h)), np.eye(p * h)], axis=1)
    lo_c = torch.cat([torch.full((v * h,), -cfg.u_max, **kw),
                      torch.full((v * (h - 1),), -cfg.du_max, **kw),
                      torch.zeros(p * h, **kw)])
    hi_c = torch.cat([torch.full((v * h,), cfg.u_max, **kw),
                      torch.full((v * (h - 1),), cfg.du_max, **kw),
                      torch.full((p * h,), float("inf"), **kw)])
    return _EdgeStatics(
        torch.as_tensor(np.concatenate([a_box, a_rate, a_tpos]), **kw),
        lo_c, hi_c, torch.eye(p * h, **kw))


def _solve_joint_edge_qp(xt, spd, pos_old, dual, last_dis, u0,
                         cfg: PiAdmmConfig, scfg: SolverConfig,
                         n_sqp: int = 2, y0=None, prox_tau: float = 0.0,
                         statics: Optional[_EdgeStatics] = None):
    """Edge subproblems over ALL vehicles jointly, one per lane: the stacked
    formulation of the old reference line
    (``casadi_old_PI_ADMM/PI_ADMM_class.py:141-179``; MATLAB
    ``cost_function_edge.m:15-35``), by sequential convexification.

    Decision per lane ``w = [u_1..u_V (V H) | t_1..t_P (P H)]``; objective
    ``2 beta sum(t) + Pcost ||u||^2 + rho/2 sum_v ||pos_old_v - pos_e_v(u)
    + dual_v||^2`` (+ the proximal ``tau/2 ||u - u_lin||^2``); constraints
    box/rate per vehicle, ``t >= 0``, ``t_p + dis_temp_p(u_i, u_j) >=
    thres^2`` per unordered pair (a static loop over the pairs, as in JAX).

    ``xt [S, V, 3]``, ``spd [S, V]``, ``pos_old / dual [S, V, 2(H+1)]``,
    ``last_dis [S, P, 2]``, ``u0 [S, V, H]``, ``y0 [S, m]``. Returns
    ``(u_opt [S, V, H], hat [S, V, 2, H+1], converged [S], y_out [S, m])``.
    """
    v, h, p = cfg.num_veh, cfg.horizon, num_pairs(cfg.num_veh)
    idx_i, idx_j = pair_indices(v)
    bsz = xt.shape[0]
    dtype, dev = pos_old.dtype, pos_old.device
    n = v * h + p * h
    rho = cfg.rho
    st = (statics if statics is not None
          else _joint_edge_statics(cfg, dtype, dev))
    m_c = st.a_const.shape[0]
    a_const = st.a_const.expand(bsz, m_c, n)
    lo_c, hi_c = st.lo_c.expand(bsz, m_c), st.hi_c.expand(bsz, m_c)
    eye_vh = torch.eye(v * h, dtype=dtype, device=dev)
    if y0 is None:
        y0 = torch.zeros((bsz, joint_edge_qp_m(cfg)), dtype=dtype, device=dev)

    u_lin, y_warm = u0, y0
    conv = torch.zeros(bsz, dtype=torch.bool, device=dev)
    for _ in range(n_sqp):
        pose0, be = _edge_affine(xt, spd, u_lin, cfg.dt, cfg.wheel_base)
        # affine pos_e_v(u_v) = c_v + Be_v u_v
        c_aff = pose0 - _mv(be, u_lin)                         # [S, V, 2(H+1)]

        p_mat = torch.zeros((bsz, n, n), dtype=dtype, device=dev)
        p_mat[:, :v * h, :v * h] = (2.0 * cfg.p_cost + prox_tau) * eye_vh
        btb = rho * be.mT @ be                                 # [S, V, H, H]
        for i in range(v):
            p_mat[:, i * h:(i + 1) * h, i * h:(i + 1) * h] += btb[:, i]
        d_al = pos_old + dual - c_aff                          # [S, V, 2(H+1)]
        q_u = (-rho * _mv(be.mT, d_al)
               - prox_tau * u_lin).reshape(bsz, v * h)
        q = torch.cat([q_u, torch.full((bsz, p * h), 2.0 * cfg.beta,
                                       dtype=dtype, device=dev)], dim=-1)

        # hinge rows per pair: t_p + dis_temp_p(u_i, u_j) >= thres^2
        rows, consts = [], []
        for pi_ in range(p):
            i, j = int(idx_i[pi_]), int(idx_j[pi_])
            const, g_i, g_j = _hinge_rows(be[:, i], be[:, j], c_aff[:, i],
                                          c_aff[:, j], last_dis[:, pi_], h)
            row_u = torch.zeros((bsz, h, v * h), dtype=dtype, device=dev)
            row_u[:, :, i * h:(i + 1) * h] = -g_i
            row_u[:, :, j * h:(j + 1) * h] = g_j
            rows.append(torch.cat([row_u, st.eye_h[pi_ * h:(pi_ + 1) * h]
                                   .expand(bsz, h, p * h)], dim=-1))
            consts.append(const)
        a_mat = torch.cat([a_const] + rows, dim=-2)
        lo = torch.cat([lo_c, cfg.dis_thres ** 2 - torch.cat(consts, dim=-1)],
                       dim=-1)
        hi = torch.cat([hi_c, torch.full((bsz, p * h), float("inf"),
                                         dtype=dtype, device=dev)], dim=-1)
        w0 = torch.cat([u_lin.reshape(bsz, v * h),
                        torch.zeros((bsz, p * h), dtype=dtype, device=dev)],
                       dim=-1)
        sol = solve_qp(p_mat, q, a_mat, lo, hi, scfg, x0=w0, y0=y_warm)
        u_lin = sol.x[:, :v * h].reshape(bsz, v, h)
        y_warm, conv = sol.y, sol.converged
    ex, ey, _ = unicycle_rollout_edge(xt, u_lin, spd, cfg.dt, cfg.wheel_base)
    return u_lin, torch.stack([ex, ey], dim=-2), conv, y_warm


# %% engine -------------------------------------------------------------------

class StepRecord(NamedTuple):
    xt: torch.Tensor            # [..., V, 3] state after the step
    u_applied: torch.Tensor     # [..., V] first control of each vehicle
    iterations: torch.Tensor    # ADMM iterations used this step
    primal_res: torch.Tensor
    dual_res: torch.Tensor
    rho: torch.Tensor
    dual_min: torch.Tensor
    dual_max: torch.Tensor


class FusedRunRecord(NamedTuple):
    """Per-(lane, step) records of :meth:`PiAdmmEngine.run_fused_batch`,
    leading axes ``[n_lanes, n_steps]``."""

    xt: torch.Tensor            # [S, n_steps, V, 3] state after each step
    u_applied: torch.Tensor     # [S, n_steps, V]
    iterations: torch.Tensor    # [S, n_steps] ADMM iterations per step
    primal_res: torch.Tensor    # [S, n_steps]
    dual_res: torch.Tensor      # [S, n_steps]
    converged: torch.Tensor     # [S, n_steps] bool: the step's loop exited on
    # the residual test (False = stopped by the iteration cap / budget)


class AdmmCarry(NamedTuple):
    """Cross-MPC-step ADMM warm-start state of the pairwise engine, with a
    leading lane axis ``S`` (the JAX carry of one lane is ``S = 1``).

    With ``carry_admm_state=True`` the time-shifted consensus cells carry
    across steps; the PI dual-controller state (``dual``/``sum_err``/
    ``diff_val``) only with ``carry_dual_state=True`` (the JAX class
    docstring says why)."""

    hat: torch.Tensor        # [S, P, 2, 2, H+1] per-pair consensus cells
    hat_u: torch.Tensor      # [S, P, 2, H] edge-control warm starts
    ey: torch.Tensor         # [S, P, m] edge QP dual warm starts
    dual: torch.Tensor       # [S, P, 2, 2, H+1] ADMM duals
    sum_err: torch.Tensor    # PI integrator state
    diff_val: torch.Tensor   # anti-windup back-calculation feed
    active: torch.Tensor     # [S, P] pairs active at the previous step's end


def _one_lane(carry: tuple) -> tuple:
    """A one-lane carry (tensors and :class:`AdmmCarry`) without its lane
    axis: the JAX package's shapes, which its checkpoints hold."""
    return tuple(AdmmCarry(*(a[0] for a in c)) if isinstance(c, AdmmCarry)
                 else c[0] for c in carry)


def _with_lane(carry: tuple) -> tuple:
    """The inverse of :func:`_one_lane`."""
    return tuple(AdmmCarry(*(a[None] for a in c))
                 if isinstance(c, AdmmCarry) else c[None] for c in carry)


def _leaves(tree):
    """The tensors of a nested dict, in a fixed order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _select(mask, a, b):
    """``where(mask, a, b)`` leaf by leaf over two nested dicts; ``mask [S]``
    broadcasts over each leaf's trailing axes."""
    if isinstance(a, dict):
        return {k: _select(mask, a[k], b[k]) for k in a}
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


class PiAdmmEngine:
    """Receding-horizon PI-ADMM planner: ``layout="classic"`` (stacked
    consensus per vehicle, one joint edge QP) or ``"pairwise"`` (per-pair
    cells with proximity gating). Runs on ``device``: the CUDA card unless
    the caller names another (``device="cpu"``); without a card the default
    raises."""

    def __init__(self, cfg: PiAdmmConfig = PiAdmmConfig(),
                 dual_cfg: DualUpdateConfig = DualUpdateConfig(),
                 solver_cfg: SolverConfig = SolverConfig(),
                 layout: str = "classic",
                 refs: Optional[np.ndarray] = None,
                 n_sqp: int = 2,
                 al_mask_active_pairs: bool = True,
                 pair_budget: int = 10 ** 9,
                 carry_admm_state: bool = False,
                 carry_dual_state: bool = False,
                 edge_prox_tau: float = 0.0,
                 dtype=torch.float64, device=None):
        self.device = resolve_device(device)
        assert layout in ("classic", "pairwise")
        if carry_admm_state and layout != "pairwise":
            raise ValueError("carry_admm_state requires layout='pairwise'")
        self.cfg = cfg
        self.dual_cfg = dual_cfg
        self.solver_cfg = solver_cfg
        self.layout = layout
        self.n_sqp = n_sqp
        self.al_mask_active_pairs = al_mask_active_pairs
        self.carry_admm_state = carry_admm_state
        self.carry_dual_state = carry_dual_state
        # max pairs solved per iteration (closest-first); pairs beyond the
        # budget are treated as inactive that iteration
        self.pair_budget = pair_budget
        self.edge_prox_tau = edge_prox_tau
        self.dtype = dtype
        kw = dict(dtype=dtype, device=self.device)
        if refs is None:
            refs = scenarios.pi_admm_crossing_refs(cfg)
        self.refs = torch.as_tensor(np.asarray(refs), **kw)    # [V, 2, N]
        self.spd = torch.as_tensor(cfg.speeds, **kw)
        self.statics = _local_statics(cfg, dtype, self.device)
        self.edge_statics = (_edge_statics if layout == "pairwise" else
                             _joint_edge_statics)(cfg, dtype, self.device)
        self.n_pairs = num_pairs(cfg.num_veh)
        idx_i, idx_j = pair_indices(cfg.num_veh)
        self.idx_i = torch.as_tensor(idx_i, device=self.device)
        self.idx_j = torch.as_tensor(idx_j, device=self.device)
        self.side_of = self._side_of_map()
        self.spd_pairs = torch.stack([self.spd[self.idx_i],
                                      self.spd[self.idx_j]], dim=1)  # [P, 2]
        # executed trips of the last run_fused_batch call (chunks x chunk)
        self.fused_trips = 0
        self._stream = None

    # -- shared pieces ---------------------------------------------------

    def _ref_window(self, step_idx):
        """``[S, V, 2(H+1)]`` flattened reference slices (x block then y
        block) at each lane's step ``step_idx [S]``; the start is clamped as
        ``lax.dynamic_slice`` clamps it (ref ``PI_ADMM_class.py:116-117``)."""
        h1 = self.cfg.horizon + 1
        start = torch.clamp(step_idx, 0, self.refs.shape[-1] - h1)
        idx = start[:, None] + torch.arange(h1, device=self.device)
        win = self.refs[:, :, idx].permute(2, 0, 1, 3)       # [S, V, 2, H+1]
        return torch.cat([win[:, :, 0], win[:, :, 1]], dim=-1)

    def _spd_lanes(self, xt):
        return self.spd.expand(xt.shape[:-1])

    def _local_affines(self, xt):
        """Per-vehicle ``(pos0, B)`` of the affine local rollout of every
        lane, ``xt [S, V, 3]``."""
        return _local_affine(xt, self._spd_lanes(xt), self.cfg.horizon,
                             self.cfg.dt, self.cfg.wheel_base)

    def _local_solve(self, affines, u_warm, ref_flat, hats, duals, al_w, rho):
        """The local QPs of every lane as one batch ``[S·V]``; hats/duals
        ``[S, V, K, 2(H+1)]``, ``al_w [S, V, K]``, ``rho [S]``."""
        pos0_all, b_all = affines
        s, v = u_warm.shape[:2]
        flat = lambda t: t.reshape((s * v,) + t.shape[2:])  # noqa: E731
        u, pos_flat = _solve_local_qp(
            flat(pos0_all), flat(b_all), flat(ref_flat), flat(hats),
            flat(duals), flat(al_w), rho[:, None].expand(s, v).reshape(-1),
            flat(u_warm), self.statics, self.cfg, self.solver_cfg)
        h1 = self.cfg.horizon + 1
        pos = torch.stack([pos_flat[:, :h1], pos_flat[:, h1:]], dim=1)
        return (u.reshape(s, v, -1),
                pos.reshape(s, v, 2, h1))              # [S, V, H], [S, V, 2, H+1]

    def _plant_rollout(self, xt, u):
        """Prediction/plant rollout of the local controls
        (ref ``main.py:128,185``: ``dynamic_update_edge`` numeric)."""
        return unicycle_rollout_edge(xt, u, self._spd_lanes(xt), self.cfg.dt,
                                     self.cfg.wheel_base)

    def _seed(self, xt):
        """1-step seed positions ``[S, V, 2]`` (ref main.py:44-45)."""
        cfg = self.cfg
        return torch.stack(
            [xt[..., 0] + cfg.dt * self.spd * torch.cos(xt[..., 2]),
             xt[..., 1] + cfg.dt * self.spd * torch.sin(xt[..., 2])], dim=-1)

    # -- cross-step ADMM carry -----------------------------------------------

    def init_admm_carry(self, n_lanes: int = 1) -> AdmmCarry:
        """Zero carry ≙ the reference's per-step re-initialization."""
        p, h1 = self.n_pairs, self.cfg.horizon + 1
        kw = dict(dtype=self.dtype, device=self.device)
        cell = torch.zeros((n_lanes, p, 2, 2, h1), **kw)
        return AdmmCarry(
            hat=cell, hat_u=torch.zeros((n_lanes, p, 2, self.cfg.horizon), **kw),
            ey=torch.zeros((n_lanes, p, edge_qp_m(self.cfg)), **kw),
            dual=cell, sum_err=cell, diff_val=cell,
            active=torch.zeros((n_lanes, p), dtype=torch.bool,
                               device=self.device))

    def shift_admm_carry(self, c: AdmmCarry) -> AdmmCarry:
        """Advance the carry one MPC step: drop t=0, duplicate the tail on
        every horizon-indexed axis. The dual-controller state is reset unless
        ``carry_dual_state``."""
        sh = lambda a: torch.cat([a[..., 1:], a[..., -1:]], dim=-1)  # noqa
        if self.carry_dual_state:
            dual, sum_err, diff_val = sh(c.dual), sh(c.sum_err), sh(c.diff_val)
        else:
            dual = sum_err = diff_val = torch.zeros_like(c.dual)
        return AdmmCarry(hat=sh(c.hat), hat_u=sh(c.hat_u), ey=c.ey,
                         dual=dual, sum_err=sum_err, diff_val=diff_val,
                         active=c.active)

    def _side_of_map(self):
        """``[V, V-1, 2]`` (pair_idx, side) gather map: for vehicle i, its
        (V-1) AL terms live at these (pair, side) slots of the pair cells."""
        v = self.cfg.num_veh
        idx_i, idx_j = pair_indices(v)
        side_of = np.zeros((v, v - 1, 2), np.int64)
        for vi in range(v):
            k = 0
            for pi_, (a, b) in enumerate(zip(idx_i, idx_j)):
                if a == vi:
                    side_of[vi, k] = (pi_, 0)
                    k += 1
                elif b == vi:
                    side_of[vi, k] = (pi_, 1)
                    k += 1
        return torch.as_tensor(side_of, device=self.device)

    # -- one pairwise iteration ------------------------------------------

    def _select_pairs(self, d2min, k_budget):
        """The ``k_budget`` closest pairs of each lane, ``[S, k]``. JAX takes
        ``top_k(-d2min)``, which breaks ties by the lower index; a stable
        ascending sort picks the same set (results go back by index, so only
        the set matters), where ``torch.topk`` promises no tie order."""
        return torch.argsort(d2min, dim=-1, stable=True)[:, :k_budget]

    def _pairwise_iter(self, xt, seed, affines, ref_flat, side_of, c):
        """ONE pairwise consensus-ADMM iteration of every lane (local QPs ->
        gating -> per-pair edge QPs -> dual update -> residuals). Shared by
        the per-step loop and the fused whole-run loop.

        ``c`` maps: ``u [S,V,H]``, ``pos [S,V,2,H+1]``, ``hat``/``last_hat``/
        ``dual``/``sum_err``/``diff_val [S,P,2,2,H+1]``, ``hat_u [S,P,2,H]``,
        ``ey [S,P,m]``, ``rho [S]``, ``ever [S,P]``, ``it``, ``done``, ``r``,
        ``s [S]`` (JAX's carry with its ``DualState`` spread into ``dual``,
        ``sum_err``, ``diff_val``, ``rho``)."""
        cfg = self.cfg
        v, p = cfg.num_veh, self.n_pairs
        idx_i, idx_j = self.idx_i, self.idx_j
        k_budget = min(self.pair_budget, p)
        s_lanes = xt.shape[0]
        lanes = torch.arange(s_lanes, device=xt.device)[:, None]

        def gather_terms(cells):
            """[S,P,2,2,H+1] -> [S, V, V-1, 2(H+1)] per-vehicle AL terms."""
            flat = torch.cat([cells[..., 0, :], cells[..., 1, :]], dim=-1)
            return flat[:, side_of[..., 0], side_of[..., 1]]

        # AL weights masked to ever-active pairs
        if self.al_mask_active_pairs:
            w = c["ever"].to(self.dtype)[:, side_of[..., 0]]
        else:
            w = torch.ones((s_lanes, v, v - 1), dtype=self.dtype,
                           device=xt.device)
        u, pos = self._local_solve(affines, c["u"], ref_flat,
                                   gather_terms(c["hat"]),
                                   gather_terms(c["dual"]), w, c["rho"])

        # gating (ref casadi/main.py:108-118): squared distance of the
        # local rollouts vs the *unsquared* threshold, per pair
        d2 = ((pos[:, idx_i, 0] - pos[:, idx_j, 0]) ** 2
              + (pos[:, idx_i, 1] - pos[:, idx_j, 1]) ** 2)  # [S, P, H+1]
        active = torch.any(d2 < cfg.dis_thres, dim=-1)
        ever = torch.logical_or(c["ever"], active)

        # per-pair edge QPs of the k_budget closest pairs of every lane
        pos_flat = torch.cat([pos[..., 0, :], pos[..., 1, :]], dim=-1)
        dual_cells = c["dual"]
        dual_flat = torch.cat([dual_cells[..., 0, :], dual_cells[..., 1, :]],
                              dim=-1)                         # [S,P,2,2(H+1)]
        last_dis = seed[:, idx_j] - seed[:, idx_i]            # [S, P, 2]
        xt_pairs = torch.stack([xt[:, idx_i], xt[:, idx_j]], dim=2)
        pos_pairs_flat = torch.stack([pos_flat[:, idx_i], pos_flat[:, idx_j]],
                                     dim=2)                   # [S,P,2,2(H+1)]

        d2min = torch.amin(d2, dim=-1)
        if k_budget < p:
            sel = self._select_pairs(d2min, k_budget)
        else:
            sel = torch.arange(p, device=xt.device).expand(s_lanes, p)
        flat = lambda t: t.reshape((-1,) + t.shape[2:])  # noqa: E731
        hat_u_k, hat_k, _, ey_k = _solve_pair_edge_qp(
            flat(xt_pairs[lanes, sel]), flat(self.spd_pairs[sel]),
            flat(pos_pairs_flat[lanes, sel]), flat(dual_flat[lanes, sel]),
            flat(last_dis[lanes, sel]), flat(c["hat_u"][lanes, sel]), cfg,
            self.solver_cfg, self.n_sqp, y0=flat(c["ey"][lanes, sel]),
            prox_tau=self.edge_prox_tau, statics=self.edge_statics)
        unflat = lambda t: t.reshape((s_lanes, -1) + t.shape[1:])  # noqa
        hat_u_new = c["hat_u"].clone()
        hat_u_new[lanes, sel] = unflat(hat_u_k)
        hat_new = c["hat"].clone()
        hat_new[lanes, sel] = unflat(hat_k)
        ey = c["ey"].clone()
        ey[lanes, sel] = unflat(ey_k)

        m = active[:, :, None, None, None]
        hat = torch.where(m, hat_new, c["hat"])
        hat_u = torch.where(active[:, :, None, None], hat_u_new, c["hat_u"])

        # per-pair dual update (ref casadi/main.py:160-162): residual of each
        # side vs its consensus cell; d_min per pair, rho per lane
        pos_pairs = torch.stack([pos[:, idx_i], pos[:, idx_j]], dim=2)
        r_cells = pos_pairs - hat                             # [S,P,2,2,H+1]
        d_pair = torch.sqrt(torch.amin(d2, dim=-1))           # [S, P]
        dual_new = update_dual(
            DualState(c["dual"], c["sum_err"], c["diff_val"], c["rho"]),
            r_cells, d_pair[:, :, None, None, None], self.dual_cfg,
            lane_dims=1)
        rho = dual_new.rho.expand(s_lanes)
        # only active pairs move their dual state
        dual = torch.where(m, dual_new.dual, c["dual"])
        sum_err = torch.where(m, dual_new.sum_err, c["sum_err"])
        diff_val = torch.where(m, dual_new.diff_val, c["diff_val"])

        r, s = per_edge_residuals(pos_pairs[:, :, 0], hat[:, :, 0],
                                  c["last_hat"][:, :, 0], rho, active)
        none_active = torch.logical_and(
            torch.sum(active, dim=-1) == 0,
            torch.logical_not(c["ever"].any(dim=-1)))
        # per-edge tolerance scaling (PiAdmmConfig.eps_per_edge)
        scale = (torch.clamp(torch.sum(active.to(r.dtype), dim=-1), min=1.0)
                 if cfg.eps_per_edge else 1.0)
        converged = torch.logical_and(r <= cfg.eps_pri * scale,
                                      s <= cfg.eps_dual * scale)
        done = torch.logical_or(none_active, converged)
        return dict(u=u, pos=pos, hat=hat, hat_u=hat_u, ey=ey, last_hat=hat,
                    dual=dual, sum_err=sum_err, diff_val=diff_val, rho=rho,
                    ever=ever, it=c["it"] + 1, done=done, r=r, s=s)

    def _pairwise_carry0(self, u_warm, admm0: AdmmCarry):
        """Initial per-step iteration carry from the (possibly shifted)
        cross-step ADMM carry."""
        cfg = self.cfg
        s_lanes, v = u_warm.shape[:2]
        kw = dict(dtype=self.dtype, device=self.device)
        return dict(u=u_warm,
                    pos=torch.zeros((s_lanes, v, 2, cfg.horizon + 1), **kw),
                    hat=admm0.hat, hat_u=admm0.hat_u, ey=admm0.ey,
                    last_hat=admm0.hat, dual=admm0.dual,
                    sum_err=admm0.sum_err, diff_val=admm0.diff_val,
                    rho=torch.full((s_lanes,), cfg.rho, **kw),
                    ever=admm0.active,
                    it=torch.zeros(s_lanes, dtype=torch.int32,
                                   device=self.device),
                    done=torch.zeros(s_lanes, dtype=torch.bool,
                                     device=self.device),
                    r=torch.zeros(s_lanes, **kw), s=torch.zeros(s_lanes, **kw))

    @staticmethod
    def _admm_out(d) -> AdmmCarry:
        return AdmmCarry(hat=d["hat"], hat_u=d["hat_u"], ey=d["ey"],
                         dual=d["dual"], sum_err=d["sum_err"],
                         diff_val=d["diff_val"], active=d["ever"])

    # -- one MPC step (per-step driver) ------------------------------------

    def _mpc_step_pairwise(self, xt, u_warm, step_idx,
                           admm0: Optional[AdmmCarry] = None):
        """One MPC step of every lane: iterate until each lane is done or at
        the cap (a lane that stopped keeps its carry), reading the flags on
        the host once per iteration. Returns ``(xt_next, u, StepRecord,
        AdmmCarry)``."""
        cfg = self.cfg
        s_lanes = xt.shape[0]
        k = torch.full((s_lanes,), step_idx, dtype=torch.long,
                       device=self.device)
        ref_flat = self._ref_window(k)
        seed = self._seed(xt)
        affines = self._local_affines(xt)
        if admm0 is None:
            admm0 = self.init_admm_carry(s_lanes)
        c = self._pairwise_carry0(u_warm, admm0)
        going = torch.ones(s_lanes, dtype=torch.bool, device=self.device)
        while True:
            d = self._pairwise_iter(xt, seed, affines, ref_flat,
                                    self.side_of, c)
            c = _select(going, d, c)
            going = torch.logical_and(torch.logical_not(c["done"]),
                                      c["it"] < cfg.iter_num)
            if not bool(going.any()):        # one host read per iteration
                break
        xt_next, u, rec = self._finish_step(xt, c)
        return xt_next, u, rec, self._admm_out(c)

    def _mpc_step_classic(self, xt, u_warm, step_idx: int):
        """One MPC step of every lane in the classic layout: local QPs with
        one AL term per vehicle, one joint edge QP, the PI dual update on
        the prediction rollout, the stacked residuals and the stop test
        (with clearance where ``stop_needs_clearance``); the loop reads the
        flags on the host once per iteration, a lane that stopped keeps its
        carry. Returns ``(xt_next, u, StepRecord)``."""
        cfg = self.cfg
        s_lanes, v, h1 = xt.shape[0], cfg.num_veh, cfg.horizon + 1
        kw = dict(dtype=self.dtype, device=self.device)
        k = torch.full((s_lanes,), step_idx, dtype=torch.long,
                       device=self.device)
        ref_flat = self._ref_window(k)
        seed = self._seed(xt)
        affines = self._local_affines(xt)
        spd = self._spd_lanes(xt)
        last_dis = seed[:, self.idx_j] - seed[:, self.idx_i]  # [S, P, 2]
        al_w = torch.ones((s_lanes, v, 1), **kw)
        zero_cell = torch.zeros((s_lanes, v, 2, h1), **kw)

        def flat(cells):                 # [S, V, 2, H+1] -> [S, V, 2(H+1)]
            return torch.cat([cells[..., 0, :], cells[..., 1, :]], dim=-1)

        c = dict(u=u_warm, pos=zero_cell, hat=zero_cell,
                 hat_u=torch.zeros((s_lanes, v, cfg.horizon), **kw),
                 last_hat=zero_cell, dual=zero_cell, sum_err=zero_cell,
                 diff_val=zero_cell, rho=torch.full((s_lanes,), cfg.rho, **kw),
                 ey=torch.zeros((s_lanes, joint_edge_qp_m(cfg)), **kw),
                 it=torch.zeros(s_lanes, dtype=torch.int32,
                                device=self.device),
                 done=torch.zeros(s_lanes, dtype=torch.bool,
                                  device=self.device),
                 r=torch.zeros(s_lanes, **kw), s=torch.zeros(s_lanes, **kw))

        def body(c):
            # vehicle side
            u, pos = self._local_solve(affines, c["u"], ref_flat,
                                       flat(c["hat"])[:, :, None],
                                       flat(c["dual"])[:, :, None], al_w,
                                       c["rho"])
            # edge side: ONE joint QP over all vehicles with a hinge per
            # pair; for V = 2 it is exactly the single-pair problem
            hat_u, hat, _, ey = _solve_joint_edge_qp(
                xt, spd, flat(pos), flat(c["dual"]), last_dis, c["hat_u"],
                cfg, self.solver_cfg, self.n_sqp, y0=c["ey"],
                prox_tau=self.edge_prox_tau, statics=self.edge_statics)
            # dual update on the prediction rollout (ref main.py:128-151)
            px, py, _ = self._plant_rollout(xt, u)
            d_min = min_pair_distance(px, py, v)              # [S]
            dual = update_dual(
                DualState(c["dual"], c["sum_err"], c["diff_val"], c["rho"]),
                pos - hat, d_min[:, None, None, None], self.dual_cfg,
                lane_dims=1)
            rho = dual.rho.expand(s_lanes)
            r, s = stacked_residuals(pos, hat, c["last_hat"], rho)
            # clearance of the applied step, min over all pairs
            clearance = torch.amin(torch.sqrt(
                (px[:, self.idx_i, 1] - px[:, self.idx_j, 1]) ** 2
                + (py[:, self.idx_i, 1] - py[:, self.idx_j, 1]) ** 2), dim=-1)
            ok = torch.logical_and(r <= cfg.eps_pri, s <= cfg.eps_dual)
            if cfg.stop_needs_clearance:
                ok = torch.logical_and(ok, clearance > cfg.dis_thres)
            return dict(u=u, pos=pos, hat=hat, hat_u=hat_u, last_hat=hat,
                        dual=dual.dual, sum_err=dual.sum_err,
                        diff_val=dual.diff_val, rho=rho, ey=ey,
                        it=c["it"] + 1, done=ok, r=r, s=s)

        going = torch.ones(s_lanes, dtype=torch.bool, device=self.device)
        while True:
            c = _select(going, body(c), c)
            going = torch.logical_and(torch.logical_not(c["done"]),
                                      c["it"] < cfg.iter_num)
            if not bool(going.any()):        # one host read per iteration
                break
        return self._finish_step(xt, c)

    def _finish_step(self, xt, c):
        """Apply the first control and advance the plant
        (ref ``main.py:168-174``)."""
        px, py, pth = self._plant_rollout(xt, c["u"])
        xt_next = torch.stack([px[..., 1], py[..., 1], pth[..., 1]], dim=-1)
        dims = tuple(range(1, c["dual"].ndim))
        rec = StepRecord(xt=xt_next, u_applied=c["u"][..., 0],
                         iterations=c["it"], primal_res=c["r"],
                         dual_res=c["s"], rho=c["rho"],
                         dual_min=torch.amin(c["dual"], dim=dims),
                         dual_max=torch.amax(c["dual"], dim=dims))
        return xt_next, c["u"], rec

    # -- full MPC run: per-step driver ---------------------------------------

    def run_scan(self, xt0: Optional[np.ndarray] = None,
                 n_steps: Optional[int] = None) -> StepRecord:
        """Whole MPC run of one lane, step by step. Returns the stacked
        :class:`StepRecord` of numpy arrays (leading axis: steps), as the
        JAX ``run_scan``."""
        return self.run(xt0, n_steps)

    def run(self, xt0: Optional[np.ndarray] = None,
            n_steps: Optional[int] = None,
            checkpoint_path: Optional[str] = None,
            resume: bool = False) -> StepRecord:
        """MPC loop of one lane (the same trajectory as :meth:`run_scan`).
        ``checkpoint_path`` saves the ``(xt [V, 3], u [V, H])`` carry, with
        ``carry_admm_state`` ``(xt, u, AdmmCarry)``, after every step, in
        the JAX package's shapes; ``resume=True`` continues a saved run from
        its last completed step (the records of the completed steps are not
        replayed)."""
        cfg = self.cfg
        if xt0 is None:
            xt0 = scenarios.pi_admm_initial_states(cfg)
        xt = torch.as_tensor(np.asarray(xt0), dtype=self.dtype,
                             device=self.device)[None]
        u = torch.zeros((1, cfg.num_veh, cfg.horizon), dtype=self.dtype,
                        device=self.device)
        n_steps = cfg.n_mpc_steps if n_steps is None else n_steps
        admm = self.init_admm_carry(1)

        def carry():
            return (xt, u, admm) if self.carry_admm_state else (xt, u)
        restored, start = resume_carry(checkpoint_path, resume,
                                       _one_lane(carry()))
        xt, u, *rest = _with_lane(restored)
        admm = rest[0] if rest else admm
        records = []
        for step in range(start, n_steps):
            # shift-warm-start (ref main.py:85: init_u = [u[1:], u[-1]])
            u = torch.cat([u[..., 1:], u[..., -1:]], dim=-1)
            if self.layout == "classic":
                xt, u, rec = self._mpc_step_classic(xt, u, step)
            else:
                admm0 = (self.shift_admm_carry(admm) if self.carry_admm_state
                         else None)
                xt, u, rec, admm = self._mpc_step_pairwise(xt, u, step, admm0)
            records.append(rec)
            if checkpoint_path is not None:
                save_carry(checkpoint_path, _one_lane(carry()), step + 1)
        return StepRecord(*(torch.stack([getattr(r, f)[0] for r in records])
                            .cpu().numpy() for f in StepRecord._fields))

    # -- fused whole-run batched driver ------------------------------------

    def _start_carry(self, u_prev, admm_prev: AdmmCarry):
        """Per-step entry ≙ run_scan's shift-warm-start + carry shift (or the
        reference's per-step re-init when the carry is off)."""
        admm_s = (self.shift_admm_carry(admm_prev) if self.carry_admm_state
                  else self.init_admm_carry(u_prev.shape[0]))
        u_s = torch.cat([u_prev[..., 1:], u_prev[..., -1:]], dim=-1)
        return self._pairwise_carry0(u_s, admm_s)

    def _fused_trip(self, c, n_steps: int, iter_budget: Optional[int]):
        """One consensus iteration of every lane's current step, finished
        inline where it converges or caps (JAX's ``_fused_lane`` body).

        Static shapes, no host read. A lane past its last step
        (``k == n_steps``) changes nothing: its state and records are kept
        (JAX keeps iterating such a lane's ADMM carry but never reads it),
        and a record is written through a one-hot mask of the step, so the
        step index never leaves the records' range."""
        cfg = self.cfg
        xt, k = c["xt"], c["k"]
        d = self._pairwise_iter(xt, self._seed(xt), self._local_affines(xt),
                                self._ref_window(k), self.side_of, c["adm"])
        if iter_budget is None:
            cap_eff = cfg.iter_num
        else:
            # reserve one iteration for each remaining step
            reserve = n_steps - 1 - k
            cap_eff = torch.clamp(iter_budget - c["used"] - reserve, 1,
                                  cfg.iter_num)
        step_done = torch.logical_or(d["done"], d["it"] >= cap_eff)
        live = k < n_steps
        adv = torch.logical_and(step_done, live)

        # step finish, selected by adv (ref main.py:168-174)
        px, py, pth = self._plant_rollout(xt, d["u"])
        xt_next = torch.stack([px[..., 1], py[..., 1], pth[..., 1]], dim=-1)
        fresh = self._start_carry(d["u"], self._admm_out(d))
        adm = _select(adv, fresh, _select(live, d, c["adm"]))

        at = torch.logical_and(
            torch.arange(n_steps, device=k.device)[None, :] == k[:, None],
            adv[:, None])                                   # [S, n_steps]

        def scat(rec, val):
            m = at.reshape(at.shape + (1,) * (rec.ndim - 2))
            return torch.where(m, val[:, None], rec)

        return dict(adm=adm,
                    xt=torch.where(adv[:, None, None], xt_next, xt),
                    k=torch.where(adv, k + 1, k),
                    used=torch.where(adv, c["used"] + d["it"], c["used"]),
                    xt_rec=scat(c["xt_rec"], xt_next),
                    u_rec=scat(c["u_rec"], d["u"][..., 0]),
                    it_rec=scat(c["it_rec"], d["it"]),
                    cv_rec=scat(c["cv_rec"], d["done"]),
                    r_rec=scat(c["r_rec"], d["r"]),
                    s_rec=scat(c["s_rec"], d["s"]))

    def _capture_trip(self, trip, carry):
        """On a CUDA device: run ``trip`` once eagerly on a side stream (which
        also sets up the libraries' per-stream state there), then capture it
        once as a CUDA graph on that stream that advances a static carry by
        one trip in place. Returns ``(graph, static)``, ``static`` holding
        the carry after the eager trip."""
        dev = carry["xt"].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        stream, main = self._stream, torch.cuda.current_stream(dev)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            carry = trip(carry)
        main.wait_stream(stream)
        static = {k: ({kk: vv.clone() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.clone())
                  for k, v in carry.items()}
        stream.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            graph.capture_begin()
            for dst, src in zip(_leaves(static), _leaves(trip(static))):
                dst.copy_(src)
            graph.capture_end()
        main.wait_stream(stream)
        return graph, static

    def _trips(self, trip, carry, n_steps: int, chunk: int):
        """Run ``trip`` until no lane is live, reading that on the host once
        per ``chunk`` trips. On a CUDA device the first trip runs eagerly and
        every later one is a replay of its CUDA graph
        (:meth:`_capture_trip`). Returns ``(carry, trips)``."""
        trips = 0
        if carry["xt"].device.type != "cuda":
            while True:
                for _ in range(chunk):
                    carry = trip(carry)
                    trips += 1
                if not bool((carry["k"] < n_steps).any()):
                    return carry, trips
        graph, static = self._capture_trip(trip, carry)
        trips = 1
        while True:
            while trips % chunk:
                graph.replay()
                trips += 1
            if not bool((static["k"] < n_steps).any()):  # one read a chunk
                return static, trips
            graph.replay()
            trips += 1

    def _fused_carry0(self, xts, us, n_steps: int):
        """The fused loop's carry before its first trip: every lane at step
        0, ``xts [S, V, 3]``, ``us [S, V, H]`` (array-likes)."""
        kw = dict(dtype=self.dtype, device=self.device)
        xts = torch.as_tensor(np.asarray(xts) if not torch.is_tensor(xts)
                              else xts, **kw)
        us = torch.as_tensor(np.asarray(us) if not torch.is_tensor(us)
                             else us, **kw)
        s_lanes, v = xts.shape[:2]
        frec = torch.zeros((s_lanes, n_steps), **kw)
        return dict(adm=self._start_carry(us, self.init_admm_carry(s_lanes)),
                    xt=xts.clone(),
                    k=torch.zeros(s_lanes, dtype=torch.long,
                                  device=self.device),
                    used=torch.zeros(s_lanes, dtype=torch.int32,
                                     device=self.device),
                    xt_rec=torch.zeros((s_lanes, n_steps, v, 3), **kw),
                    u_rec=torch.zeros((s_lanes, n_steps, v), **kw),
                    it_rec=torch.zeros((s_lanes, n_steps), dtype=torch.int32,
                                       device=self.device),
                    cv_rec=torch.zeros((s_lanes, n_steps), dtype=torch.bool,
                                       device=self.device),
                    r_rec=frec, s_rec=frec.clone())

    def run_fused_batch(self, xts, us, n_steps: int,
                        iter_budget: Optional[int] = None,
                        chunk: int = 8) -> FusedRunRecord:
        """Fused whole-run driver over a batch of scenario lanes.

        ``xts [S, V, 3]``, ``us [S, V, H]`` -> :class:`FusedRunRecord` with
        ``[S, n_steps, ...]`` tensors on the engine's device. ``iter_budget``
        bounds each lane's total iterations (each step keeps at least one).
        The host checks for a live lane once per ``chunk`` trips; the trips
        executed (a multiple of ``chunk``, at least ``max_lane(sum_k
        iterations)``) are left in ``self.fused_trips``.
        """
        if self.layout != "pairwise":
            raise ValueError("run_fused_batch requires layout='pairwise'")
        out, self.fused_trips = self._trips(
            lambda c: self._fused_trip(c, n_steps, iter_budget),
            self._fused_carry0(xts, us, n_steps), n_steps, chunk)
        return FusedRunRecord(xt=out["xt_rec"], u_applied=out["u_rec"],
                              iterations=out["it_rec"],
                              primal_res=out["r_rec"], dual_res=out["s_rec"],
                              converged=out["cv_rec"])

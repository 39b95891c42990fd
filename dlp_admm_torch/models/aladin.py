"""ALADIN coordinator (Augmented-Lagrangian Alternating Direction Inexact
Newton), ported to PyTorch.

Port of ``dlp_admm_tpu/models/aladin.py`` (≙ ``Distributed_planner/ALADIN/
examples/ALADIN_fun.py``) for consensus problems

    min sum_i f_i(y_i)   s.t.  sum_i A_i y_i = b,   h_i(y_i) = 0,
                               g_i(y_i) >= 0 (optional)

One iteration (ref ``example2.py:184-281``):

1. the agents' proximal NLPs ``min f_i(y) + lam^T A_i y + rho/2 ||y -
   x_i||^2 s.t. h_i(y) = 0, g_i(y) >= 0``, all N as one dense IP solve
   (``solve_nlp_batch`` over N lanes);
2. active-set Jacobians: rows of h (and g) off their bound are zeroed
   (ref ``constraint_jac_approx`` ``:37-46``);
3. the modified gradient ``grad f_i + (J_real - J_active)^T kappa_i`` and
   the Hessian of the Lagrangian ``f_i + kappa^T h_i (+ kappa_g^T g_i)``,
   per agent under ``torch.func.vmap``, in reverse mode (``jacrev``,
   ``jacrev(grad)``);
4. the coupled equality QP over (dy, s) as one dense KKT solve
   (:func:`~..solvers.linalg.dense_solve`);
5. the full-step update, or with ``globalization="linesearch"`` the first
   of 6 step lengths that lowers an l1 merit.

Agents share one (f, h, g) structure; per-agent data is the parameter
pytree, whose tensor leaves carry a leading agent axis. ``run`` reads the
two termination residuals on the host once an iteration. No block-Thomas
kernel runs here. ``AladinEngine.run`` saves its ``AladinState`` after
every iteration with ``checkpoint_path`` and continues a saved run with
``resume=True`` (:mod:`..utils.checkpoint`).
"""
from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.func import grad, jacrev, vmap

from .. import scenarios
from ..config import PiAdmmConfig, SolverConfig
from ..ops.dynamics import unicycle_rollout_exact, unicycle_rollout_local
from ..solvers.ip import NLP, _lane_dims, solve_nlp_batch
from ..solvers.linalg import dense_solve
from ..utils.checkpoint import resume_carry, save_carry
from .obca import _check_dtype, resolve_device


class AladinProblem(NamedTuple):
    """min sum_i f(y_i, p_i)  s.t.  sum_i A_i y_i = b,  h(y_i, p_i) = 0,
    and optionally g(y_i, p_i) >= 0. ``f``, ``h`` and ``g`` take one agent's
    ``y [ny]`` and parameters and must be traceable by ``torch.func``.

    The agent NLPs enforce the inequalities exactly and the coupled QP holds
    the active set fixed: active rows of g join the ``C_i dy_i = 0`` rows,
    inactive rows are dropped."""

    f: Callable                      # (y [ny], p_i) -> scalar
    h: Callable                      # (y [ny], p_i) -> [mh] residuals
    a_mats: torch.Tensor             # [N, mc, ny] coupling matrices
    b: torch.Tensor                  # [mc]
    g: Optional[Callable] = None     # (y [ny], p_i) -> [mg] >= 0


class AladinState(NamedTuple):
    x: torch.Tensor              # [N, ny] primal iterates
    lam: torch.Tensor            # [mc] coupling multipliers
    coupling_res: torch.Tensor   # ||sum A_i y_i - b||_1 at the last iterate
    step_norm: torch.Tensor      # rho * ||y - x||_1 (ref termination)


def _vmap_agents(fn, p):
    """``fn(y, p_i)`` mapped over the agent axis of ``y`` and of ``p``'s
    tensor leaves."""
    return vmap(fn, in_dims=(0, _lane_dims(p)))


class AladinEngine:
    """Reusable ALADIN iteration: batched agents, one dense KKT solve for
    the coupled QP. The problem's tensors are moved to ``device`` (the CUDA
    card unless the caller names another; without a card the default
    raises); the dtype is theirs.

    ``globalization="linesearch"`` enables the l1-penalty backtracking of
    the third-party notebooks (ref ``ALADIN_with_linesearch.ipynb``): one
    alpha scales the (y - x), dy and lambda moves, the first of {1, 1/2,
    ..., 2^-5} that lowers ``phi = sum f_i + pen (||sum A_i x_i - b||_1 +
    sum ||h_i||_1 + sum relu(-g_i))``, else the last; ``"full_step"`` is
    the plain ALADIN of ``ALADIN_fun.py`` with the step weights ``alpha``.
    """

    def __init__(self, problem: AladinProblem, rho: float = 10.0,
                 mu: float = 1e4,
                 scfg: SolverConfig = SolverConfig(),
                 alpha: tuple = (1.0, 1.0, 1.0),
                 active_tol: float = 1e-6,
                 hess_reg: float = 1e-6,
                 globalization: str = "full_step",
                 merit_penalty: float = 1e3,
                 device=None):
        if globalization not in ("full_step", "linesearch"):
            raise ValueError(f"unknown globalization {globalization!r}")
        self.device = resolve_device(device)
        self.problem = problem = problem._replace(
            a_mats=problem.a_mats.to(self.device),
            b=problem.b.to(self.device))
        self.rho, self.mu = rho, mu
        self.scfg = scfg
        self.alpha = alpha
        self.active_tol = active_tol
        self.hess_reg = hess_reg
        self.globalization = globalization
        self.merit_penalty = merit_penalty

        def sub_f(y, q):
            p_i, a_i, lam, x_i = q
            return (problem.f(y, p_i) + lam @ (a_i @ y)
                    + rho / 2 * torch.sum((y - x_i) ** 2))

        def sub_ce(y, q):
            return problem.h(y, q[0])

        def sub_ci(y, q):
            if problem.g is None:
                return y.new_zeros((0,))
            return problem.g(y, q[0])

        self._sub_nlp = NLP(sub_f, sub_ce, sub_ci)

    def init_state(self, x0: torch.Tensor) -> AladinState:
        x0 = torch.as_tensor(x0).to(self.device)
        mc = self.problem.b.shape[0]
        inf = torch.tensor(float("inf"), dtype=x0.dtype, device=self.device)
        return AladinState(x=x0, lam=x0.new_zeros(mc), coupling_res=inf,
                           step_norm=inf)

    def _derive(self, ys, p, kappas, kappas_g):
        """Per agent: the active-set Jacobian ``C_i`` (h rows, then g rows),
        the modified gradient and the regularized Hessian of the
        Lagrangian."""
        prob = self.problem
        ny = ys.shape[1]

        def derive_one(y_i, p_i, kappa_i, kappa_g_i):
            h_val = prob.h(y_i, p_i)
            j_real = jacrev(prob.h)(y_i, p_i)
            active = torch.abs(h_val) <= self.active_tol
            c_i = torch.where(active[:, None], j_real, 0.0)
            g_i = grad(prob.f)(y_i, p_i) + (j_real - c_i).mT @ kappa_i

            def lag(y):
                val = prob.f(y, p_i) + kappa_i @ prob.h(y, p_i)
                if prob.g is not None:
                    val = val + kappa_g_i @ prob.g(y, p_i)
                return val

            if prob.g is not None:
                g_val = prob.g(y_i, p_i)
                jg_real = jacrev(prob.g)(y_i, p_i)
                cg_i = torch.where((g_val <= self.active_tol)[:, None],
                                   jg_real, 0.0)
                g_i = g_i + (jg_real - cg_i).mT @ kappa_g_i
                c_i = torch.cat([c_i, cg_i], dim=0)
            h_i = jacrev(grad(lag))(y_i)
            h_i = h_i + self.hess_reg * torch.eye(ny, dtype=y_i.dtype,
                                                  device=y_i.device)
            return c_i, g_i, h_i

        return vmap(derive_one, in_dims=(0, _lane_dims(p), 0, 0))(
            ys, p, kappas, kappas_g)

    def _coupled_qp(self, state: AladinState, ys, c_all, g_all, h_all):
        """The coupled equality QP over w = [dy (N·ny) | s (mc)] as one
        dense KKT solve; returns ``(dy [N, ny], lam_qp [mc])``.
        Constraints: ``sum A_i dy_i - s = b - sum A_i y_i`` and
        ``C_i dy_i = 0`` (inactive rows are zero, regularized by the
        -1e-9 I block)."""
        prob = self.problem
        n_agents, mc, ny = prob.a_mats.shape
        mh = c_all.shape[1]
        kw = dict(dtype=ys.dtype, device=ys.device)
        nv = n_agents * ny + mc
        big_h = torch.zeros((nv, nv), **kw)
        big_h[:n_agents * ny, :n_agents * ny] = torch.block_diag(*h_all)
        big_h[n_agents * ny:, n_agents * ny:] = self.mu * torch.eye(mc, **kw)
        big_g = torch.cat([g_all.reshape(-1), state.lam])
        a_row = torch.cat([torch.cat(list(prob.a_mats), dim=1),
                           -torch.eye(mc, **kw)], dim=1)
        c_rows = torch.zeros((n_agents * mh, nv), **kw)
        for i in range(n_agents):
            c_rows[i * mh:(i + 1) * mh, i * ny:(i + 1) * ny] = c_all[i]
        eq = torch.cat([a_row, c_rows], dim=0)
        m_eq = eq.shape[0]
        rhs_eq = torch.cat([
            prob.b - torch.einsum('imn,in->m', prob.a_mats, ys),
            torch.zeros(n_agents * mh, **kw)])
        kkt = torch.cat([torch.cat([big_h, eq.mT], dim=1),
                         torch.cat([eq, -1e-9 * torch.eye(m_eq, **kw)],
                                   dim=1)], dim=0)
        sol = dense_solve(kkt, torch.cat([-big_g, rhs_eq]))
        return sol[:n_agents * ny].reshape(n_agents, ny), sol[nv:nv + mc]

    def _merit(self, x_all, p):
        prob = self.problem
        pen = self.merit_penalty
        fs = _vmap_agents(prob.f, p)(x_all, p)
        hs = _vmap_agents(prob.h, p)(x_all, p)
        coup = torch.einsum('imn,in->m', prob.a_mats, x_all) - prob.b
        val = (torch.sum(fs) + pen * torch.sum(torch.abs(coup))
               + pen * torch.sum(torch.abs(hs)))
        if prob.g is not None:
            gs = _vmap_agents(prob.g, p)(x_all, p)
            val = val + pen * torch.sum(torch.relu(-gs))
        return val

    def step(self, state: AladinState, p):
        """One ALADIN iteration; returns ``(AladinState, ys [N, ny])``,
        ``ys`` the agent NLPs' solutions."""
        prob = self.problem
        n_agents = prob.a_mats.shape[0]
        # 1. the agents' proximal NLPs (ref example2.py:188-207)
        q = (p, prob.a_mats, state.lam.expand(n_agents, -1), state.x)
        sol = solve_nlp_batch(self._sub_nlp, state.x, q, self.scfg)
        # the IP's Lagrangian is f - y^T h - z^T g; the reference's kappa
        # belongs to f + kappa^T h (IPOPT), so kappa = -y and kappa_g = -z
        ys, kappas, kappas_g = sol.x, -sol.y, -sol.z
        # 2./3. active-set Jacobians, modified gradients, Hessians
        c_all, g_all, h_all = self._derive(ys, p, kappas, kappas_g)
        # 4. the coupled QP
        dy, lam_qp = self._coupled_qp(state, ys, c_all, g_all, h_all)
        # 5. the step (ref example2.py:258-281)
        if self.globalization == "linesearch":
            alphas = torch.pow(0.5, torch.arange(6, dtype=ys.dtype,
                                                 device=ys.device))
            phi0 = self._merit(state.x, p)
            phis = vmap(lambda a: self._merit(
                state.x + a * (ys - state.x) + a * dy, p))(alphas)
            ok = phis < phi0
            a_sel = torch.where(ok.any(),
                                alphas[torch.argmax(ok.to(torch.int32))],
                                alphas[-1])
            x_new = state.x + a_sel * (ys - state.x) + a_sel * dy
            lam_new = state.lam + a_sel * (lam_qp - state.lam)
        else:
            a1, a2, a3 = self.alpha
            x_new = state.x + a1 * (ys - state.x) + a2 * dy
            lam_new = state.lam + a3 * (lam_qp - state.lam)
        coupling_res = torch.sum(torch.abs(
            torch.einsum('imn,in->m', prob.a_mats, ys) - prob.b))
        step_norm = self.rho * torch.sum(torch.abs(ys - state.x))
        return AladinState(x=x_new, lam=lam_new, coupling_res=coupling_res,
                           step_norm=step_norm), ys

    def run(self, x0: torch.Tensor, p, n_iters: int = 30,
            tol: Optional[float] = 1e-6,
            checkpoint_path: Optional[str] = None, resume: bool = False):
        """Host loop with the reference's termination test
        (``example2.py:211-216``): ``||sum A_i y_i - b||_1 <= tol`` and
        ``rho ||y - x||_1 <= tol``, read once an iteration. Returns
        ``(AladinState, ys)``. ``checkpoint_path`` saves the
        ``AladinState`` after every iteration; ``resume=True`` continues a
        saved run from its last completed iteration."""
        p = pytree.tree_map(
            lambda a: a.to(self.device) if torch.is_tensor(a) else a, p)
        state, start = resume_carry(checkpoint_path, resume,
                                    self.init_state(x0))
        ys = state.x
        for it in range(start, n_iters):
            state, ys = self.step(state, p)
            if checkpoint_path is not None:
                save_carry(checkpoint_path, state, it + 1)
            if tol is not None and (float(state.coupling_res) <= tol
                                    and float(state.step_norm) <= tol):
                break
        return state, ys


class AladinUnicyclePlanner:
    """ALADIN as a planner coordinator on the unicycle consensus problem
    (the crossing of ``casadi_old_PI_ADMM/main.py``).

    * **agents = vehicles**: agent i's decision is ``y_i = [u_i (H) |
      P_i (V·2H)]``, its own steering sequence and a local copy of every
      vehicle's xy trajectory over the horizon;
    * **equalities** ``h_i``: its own slice of the copy equals its affine
      unicycle rollout (``ops.dynamics.unicycle_rollout_local``);
    * **inequalities** ``g_i``: steering and steering-rate limits (ref
      ``casadi/PI_ADMM_class.py:181-192``);
    * **objective** ``f_i``: tracking + effort on the own slice plus the
      smoothed collision hinge ``beta relu(thres^2 - ||dp||^2)^2`` against
      the other vehicles' copies, halved (each pair appears in two agents),
      its onset at ``dis_thres + hinge_margin``;
    * **coupling** ``P_i - P_{i+1} = 0``.

    Per MPC step ALADIN iterates to the reference termination or
    ``max_iters``; the first control advances the plant through the exact
    rollout (``ops.dynamics.unicycle_rollout_exact``). ``device`` defaults
    to the CUDA card; ``dtype`` is float64 or float32.
    """

    def __init__(self, cfg: Optional[PiAdmmConfig] = None, rho: float = 50.0,
                 mu: float = 1e4, scfg: SolverConfig = SolverConfig(),
                 max_iters: int = 30, term_tol: float = 1e-2,
                 globalization: str = "linesearch",
                 hinge_margin: float = 0.3,
                 dtype=torch.float64, device=None):
        _check_dtype(dtype)
        self.cfg = cfg = cfg or PiAdmmConfig()
        self.v = v = cfg.num_veh
        self.h = h = cfg.horizon
        self.dtype = dtype
        self.device = resolve_device(device)
        self.max_iters, self.term_tol = max_iters, term_tol
        self.hinge_margin = float(hinge_margin)
        kw = dict(dtype=dtype, device=self.device)
        self.refs = torch.as_tensor(scenarios.pi_admm_crossing_refs(cfg),
                                    **kw)                       # [V, 2, N]
        self.spd = torch.as_tensor(np.asarray(cfg.speeds), **kw)
        ny = h + v * 2 * h
        mc = (v - 1) * 2 * h * v
        # coupling: for each consecutive pair (i, i+1), rows P_i - P_{i+1}
        a_mats = torch.zeros((v, mc, ny), **kw)
        blk = 2 * h * v
        eye = torch.eye(blk, **kw)
        for i in range(v):
            if i < v - 1:      # +P_i rows of pair (i, i+1)
                a_mats[i, i * blk:(i + 1) * blk, h:] = eye
            if i > 0:          # -P_i rows of pair (i-1, i)
                a_mats[i, (i - 1) * blk:i * blk, h:] = -eye
        self._prob = AladinProblem(f=self._f, h=self._h, a_mats=a_mats,
                                   b=torch.zeros((mc,), **kw), g=self._g)
        self.engine = AladinEngine(self._prob, rho=rho, mu=mu, scfg=scfg,
                                   globalization=globalization,
                                   device=self.device)
        self._agents = torch.arange(v, device=self.device)

    def _split(self, y):
        return y[:self.h], y[self.h:].reshape(self.v, self.h, 2)

    @staticmethod
    def _own(p_all, idx):
        """The agent's own slice ``p_all[idx]`` of the copies (an index
        with a dimension, which ``vmap`` maps without a host read)."""
        return p_all.index_select(0, idx.reshape(1))[0]

    def _f(self, y, p_i):
        cfg = self.cfg
        u, p_all = self._split(y)
        own = self._own(p_all, p_i["idx"])
        obj = (cfg.p_norm * torch.sum((own - p_i["ref"]) ** 2)
               + cfg.p_cost * torch.sum(u ** 2))
        # smoothed pairwise hinge vs every copy (ref cost_function_edge
        # ``casadi_old_PI_ADMM/PI_ADMM_class.py:141-179``), squared for
        # C^1 smoothness, halved because each pair appears in two agents
        d2 = torch.sum((own[None] - p_all) ** 2, dim=-1)        # [V, H]
        mask = (self._agents != p_i["idx"]).to(y.dtype)
        thres = cfg.dis_thres + self.hinge_margin
        hinge = torch.relu(thres ** 2 - d2) ** 2
        return obj + 0.5 * cfg.beta * torch.sum(mask[:, None] * hinge)

    def _predict_own(self, u, xt, spd):
        """Affine local rollout positions for steps 1..H: ``[..., H, 2]``."""
        xs, ys_, _ = unicycle_rollout_local(xt, u, spd, self.cfg.dt,
                                            self.cfg.wheel_base)
        return torch.stack([xs[..., 1:], ys_[..., 1:]], dim=-1)

    def _h(self, y, p_i):
        u, p_all = self._split(y)
        own = self._own(p_all, p_i["idx"])
        return (own - self._predict_own(u, p_i["xt"], p_i["spd"])).reshape(-1)

    def _g(self, y, p_i):
        """Steering magnitude and rate limits (|u| <= pi/6, |du| <= pi/9)."""
        cfg = self.cfg
        u, _ = self._split(y)
        du = u[1:] - u[:-1]
        return torch.cat([cfg.u_max - u, u + cfg.u_max,
                          cfg.du_max - du, du + cfg.du_max])

    def _agent_params(self, xt, step_idx: int):
        """The agents' parameters (leading axis V): the reference window
        from ``step_idx + 1``, start clamped in bounds as
        ``lax.dynamic_slice_in_dim`` clamps it."""
        start = min(max(int(step_idx) + 1, 0), self.refs.shape[2] - self.h)
        ref_win = self.refs[:, :, start:start + self.h]         # [V, 2, H]
        return dict(idx=self._agents, ref=ref_win.transpose(1, 2),
                    xt=xt, spd=self.spd)

    def mpc_step(self, xt, u_warm, step_idx: int):
        """One MPC step: ALADIN to termination (one host read of its two
        residuals an iteration), then the first control applied through
        the exact plant rollout. Returns ``(xt_next [V, 3], u [V, H],
        iterations)``."""
        p = self._agent_params(xt, step_idx)
        pos_warm = self._predict_own(u_warm, xt, self.spd)     # [V, H, 2]
        pos_warm = pos_warm.reshape(1, -1).expand(self.v, -1)
        state = self.engine.init_state(torch.cat([u_warm, pos_warm], dim=1))
        it = 0
        for it in range(1, self.max_iters + 1):
            state, _ = self.engine.step(state, p)
            if (float(state.coupling_res) <= self.term_tol
                    and float(state.step_norm) <= self.term_tol):
                break
        u = state.x[:, :self.h]
        xs, ys_, ths = unicycle_rollout_exact(xt, u[:, :1], self.spd,
                                              self.cfg.dt,
                                              self.cfg.wheel_base)
        xt_next = torch.stack([xs[:, 1], ys_[:, 1], ths[:, 1]], dim=-1)
        return xt_next, u, it

    def run(self, n_steps: Optional[int] = None, step_timer=None):
        """Receding-horizon loop (ref ``casadi_old_PI_ADMM/main.py:41-174``
        structure), the warm start shifted by one step. Returns ``(states
        [n+1, V, 3], iterations [n])`` on the host. ``step_timer``, a
        context-manager factory such as ``RunMetrics.step_timer``, wraps
        each step."""
        timer = step_timer or contextlib.nullcontext
        n_steps = self.cfg.n_mpc_steps if n_steps is None else n_steps
        xt = torch.as_tensor(scenarios.pi_admm_initial_states(self.cfg),
                             dtype=self.dtype, device=self.device)
        u = torch.zeros((self.v, self.h), dtype=self.dtype,
                        device=self.device)
        states, iters = [xt.cpu().numpy()], []
        for k in range(n_steps):
            with timer():
                xt, u, it = self.mpc_step(xt, u, k)
                # shift the warm start (ref main.py:83)
                u = torch.cat([u[:, 1:], u[:, -1:]], dim=1)
                states.append(xt.cpu().numpy())
            iters.append(it)
        return np.stack(states), np.asarray(iters)

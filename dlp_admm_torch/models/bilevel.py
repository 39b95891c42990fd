"""Bilevel (MISC) and constraint-tightening OBCA planners, ported to
PyTorch.

Port of ``dlp_admm_tpu/models/bilevel.py``:

* :class:`BilevelObcaPlanner` (≙ ``Distributed_planner/decentralized_MISC/
  optimizer.py``): the local NLPs carry no collision duals; the duals are
  fixed data from the edge, which solves only the lower-level collision-dual
  problem ``min b_0^T l_0 + b_1^T l_1 s.t. A_0^T l_0 + A_1^T l_1 = 0,
  -sum b^T l >= d_min, ||A_i^T l_i|| <= 1, 0 <= l <= 5`` (ref
  ``optimizer.py:223-257``);
* :class:`TighteningObcaPlanner` (≙ ``decentralized_tighting/
  optimizer_ori.py``): one local pass and one edge pass per MPC step, the
  locals using the previous step's (A, b, lambda) with the collision rows
  off at t = 0, predictions shifted by 2 steps with the tail duplicated;
* :class:`TighteningSlackObcaPlanner` (≙ ``decentralized_tighting/
  optimizer.py``): the same with the explicit separating direction ``s``.

As in JAX, the collision duals live per unordered pair as ``[P, 2, T, 4]``
(side 0 = the lower-indexed vehicle), the per-pair dual problems of all
(pair, timestep) lanes are one dense IP solve (``solve_nlp_batch`` over
``P·T`` lanes) and the V local NLPs another (V lanes), each vehicle taking
its K = V-1 neighbour rows as fixed data. The IP loop reads ``done`` on the
host once per trip; the JAX ``lax.scan`` over the bilevel rounds is a
Python loop here. No block-Thomas kernel runs on these paths.

``run`` saves the ``(init_state, FixedDualState)`` carry after every step
with ``checkpoint_path`` and continues a saved run with ``resume=True``
(:mod:`..utils.checkpoint`).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import vmap

from .. import scenarios
from ..config import ObcaConfig, SolverConfig, VehicleConfig
from ..ops.geometry import halfspaces
from ..ops.pairs import pair_indices
from ..solvers.ip import NLP, solve_nlp_batch
from ..utils.checkpoint import resume_carry, save_carry
from .obca import (_box_bounds, _box_residuals, _check_dtype, _dyn_residual,
                   _RecedingHorizon, resolve_device)

# %% shared: the lower-level collision-dual problem ---------------------------


def _dual_nlp(min_dis: float, lam_hi: float = 5.0) -> NLP:
    """Per-(pair, timestep) collision-dual QCQP over x = [l_0 (4), l_1 (4)]
    (8 variables, 2 equality and 19 inequality rows). Parameters p:
    ``a0/a1 [4, 2]``, ``b0/b1 [4]``. Ref MISC
    ``edge_generate_constrain/_object`` ``optimizer.py:223-257``."""

    def f(x, p):
        return p["b0"] @ x[:4] + p["b1"] @ x[4:]

    def ce(x, p):
        return p["a0"].mT @ x[:4] + p["a1"].mT @ x[4:]

    def ci(x, p):
        sep = -p["b0"] @ x[:4] - p["b1"] @ x[4:] - min_dis
        n0 = 0.95 ** 2 - torch.sum((p["a0"].mT @ x[:4]) ** 2)
        n1 = 0.95 ** 2 - torch.sum((p["a1"].mT @ x[4:]) ** 2)
        return torch.cat([torch.stack([sep, n0, n1]), x, lam_hi - x])

    return NLP(f, ce, ci)


def _dual_slack_nlp(min_dis: float, lam_hi: float = 1.0e4) -> NLP:
    """Per-(pair, timestep) collision-dual problem with an explicit
    separating direction s (the ``decentralized_tighting/optimizer.py``
    variant): x = [l_0 (4), l_1 (4), s (2)],

        min b_0^T l_0 + b_1^T l_1
        s.t. A_0^T l_0 + s = 0,  A_1^T l_1 - s = 0
             -b_0^T l_0 - b_1^T l_1 >= min_dis
             ||s||^2 <= 1,  -1 <= s <= 1,  0 <= l <= 1e4

    (ref ``optimizer.py:236-274``)."""

    def f(x, p):
        return p["b0"] @ x[:4] + p["b1"] @ x[4:8]

    def ce(x, p):
        s = x[8:]
        return torch.cat([p["a0"].mT @ x[:4] + s, p["a1"].mT @ x[4:8] - s])

    def ci(x, p):
        lam = x[:8]
        s = x[8:]
        sep = -p["b0"] @ x[:4] - p["b1"] @ x[4:8] - min_dis
        sn = 1.0 - torch.sum(s ** 2)
        return torch.cat([torch.stack([sep, sn]), lam, lam_hi - lam,
                          1.0 - s, 1.0 + s])

    return NLP(f, ce, ci)


def _pair_lanes(a_pair, b_pair):
    """``[P, 2, T, ...]`` pair sides -> the dual solve's ``P·T`` lanes."""
    p_, t = b_pair.shape[0], b_pair.shape[2]
    return dict(a0=a_pair[:, 0].reshape(p_ * t, 4, 2),
                a1=a_pair[:, 1].reshape(p_ * t, 4, 2),
                b0=b_pair[:, 0].reshape(p_ * t, 4),
                b1=b_pair[:, 1].reshape(p_ * t, 4))


def solve_collision_duals(a_pair, b_pair, min_dis: float, scfg: SolverConfig,
                          lam_warm=None):
    """One dense IP solve over all pairs and timesteps: ``a_pair
    [P, 2, T, 4, 2]``, ``b_pair [P, 2, T, 4]`` -> ``(lam [P, 2, T, 4],
    NLPSolution over P·T lanes)``. Where a lane did not converge (the
    predicted trajectories interpenetrate, so no separating certificate
    exists) ``lam_warm`` is kept."""
    p_, t = b_pair.shape[0], b_pair.shape[2]
    if lam_warm is None:
        x0 = torch.full((p_ * t, 8), 0.5, dtype=b_pair.dtype,
                        device=b_pair.device)
    else:
        x0 = torch.cat([lam_warm[:, 0], lam_warm[:, 1]],
                       dim=-1).reshape(p_ * t, 8)
    sol = solve_nlp_batch(_dual_nlp(min_dis), x0,
                          _pair_lanes(a_pair, b_pair), scfg)
    lam = torch.stack([sol.x[:, :4].reshape(p_, t, 4),
                       sol.x[:, 4:].reshape(p_, t, 4)], dim=1)
    if lam_warm is not None:
        ok = sol.converged.reshape(p_, 1, t, 1)
        lam = torch.where(ok, lam, lam_warm)
    return lam, sol


def solve_collision_duals_slack(a_pair, b_pair, min_dis: float,
                                scfg: SolverConfig, lam_warm=None,
                                s_warm=None):
    """The slack variant of :func:`solve_collision_duals`: returns ``(lam
    [P, 2, T, 4], s [P, T, 2], sol)`` with the same warm-keep policy."""
    p_, t = b_pair.shape[0], b_pair.shape[2]
    if lam_warm is None:
        x0 = torch.cat([
            torch.full((p_ * t, 8), 0.5, dtype=b_pair.dtype,
                       device=b_pair.device),
            torch.zeros((p_ * t, 2), dtype=b_pair.dtype,
                        device=b_pair.device)], dim=1)
    else:
        x0 = torch.cat([lam_warm[:, 0], lam_warm[:, 1], s_warm],
                       dim=-1).reshape(p_ * t, 10)
    sol = solve_nlp_batch(_dual_slack_nlp(min_dis), x0,
                          _pair_lanes(a_pair, b_pair), scfg)
    lam = torch.stack([sol.x[:, :4].reshape(p_, t, 4),
                       sol.x[:, 4:8].reshape(p_, t, 4)], dim=1)
    s = sol.x[:, 8:].reshape(p_, t, 2)
    if lam_warm is not None:
        ok = sol.converged.reshape(p_, t, 1)
        lam = torch.where(ok[:, None], lam, lam_warm)
        s = torch.where(ok, s, s_warm)
    return lam, s, sol


# %% shared: fixed-dual local NLP --------------------------------------------


class _FixedDualLocal:
    """Local tracking NLP whose collision rows take FIXED duals as data.

    x = [X (5N) | U (2(N-1)) | e1 (K(N-1)) | e2 (2K(N-1))]; per neighbour
    slot k, the (5a) separation row and the (5b) dual-feasibility coupling
    rows of ref ``decentralized_MISC/optimizer.py:101-133`` with the duals
    replaced by bar-state data, both elastic (l1 exact penalty via e1/e2).

    ``coupling`` selects the (5b) form: ``"other_a"``, A(X)^T lam_self +
    A_other^T lam_other = 0; ``"slack"``, A(X)^T lam_self + sgn * s_bar = 0
    with sgn = +1 for the lower-indexed vehicle of the pair, -1 for the
    higher. Its functions take one vehicle's ``x`` and parameters and are
    mapped over the V vehicles by ``solve_nlp_batch``.
    """

    def __init__(self, ocfg: ObcaConfig, vcfg: VehicleConfig, dtype, device,
                 coupling: str = "other_a"):
        if coupling not in ("other_a", "slack"):
            raise ValueError(f"unknown coupling {coupling!r}")
        self.ocfg, self.vcfg, self.dtype = ocfg, vcfg, dtype
        self.coupling = coupling
        n = ocfg.horizon
        k = ocfg.num_veh - 1
        self.K = k
        self.sizes = dict(x=5 * n, u=2 * (n - 1), e1=k * (n - 1),
                          e2=2 * k * (n - 1))
        self.elastic_w = 1.0e7
        self._box = _box_bounds(ocfg, vcfg, dtype=dtype, device=device)
        self.nlp = NLP(self._obj, self._ce, self._ci)

    def split(self, x):
        """``x [..., n]`` -> ``(X [..., N, 5], U [..., N-1, 2],
        e1 [..., K, N-1], e2 [..., K, N-1, 2])``."""
        n = self.ocfg.horizon
        s = self.sizes
        lead = x.shape[:-1]
        o_u = s["x"]
        o_e1 = o_u + s["u"]
        o_e2 = o_e1 + s["e1"]
        return (x[..., :s["x"]].reshape(lead + (n, 5)),
                x[..., o_u:o_e1].reshape(lead + (n - 1, 2)),
                x[..., o_e1:o_e2].reshape(lead + (self.K, n - 1)),
                x[..., o_e2:].reshape(lead + (self.K, n - 1, 2)))

    def _obj(self, x, p):
        xs, us, e1, e2 = self.split(x)
        err = xs[1:] - p["ref_win"][1:]
        return (self.ocfg.r_ctrl * torch.sum(us ** 2)
                + self.ocfg.q_state * torch.sum(err ** 2)
                + self.elastic_w * (torch.sum(e1) + torch.sum(e2)))

    def _ce(self, x, p):
        xs, us, _, _ = self.split(x)
        return _dyn_residual(xs, us, p["init_state"], self.vcfg)

    def _raw_rows(self, xs, p):
        """(5a) separation margin [K, T] and (5b) coupling residual
        [K, T, 2] per neighbour slot, gated by ``p["active"]`` (the
        tightening variant skips the collision rows at t_step == 0,
        ``optimizer_ori.py:98-99``)."""
        a_self, b_self = halfspaces(xs[1:], self.vcfg,
                                    self.ocfg.use_delay_tightening)
        sep = (-torch.einsum('ti,kti->kt', b_self, p["lam_self"])
               - torch.einsum('kti,kti->kt', p["other_b"], p["lam_other"])
               - self.ocfg.min_dis)
        atl = torch.einsum('tij,kti->ktj', a_self, p["lam_self"])
        if self.coupling == "slack":
            g = atl + p["sgn"][:, None, None] * p["s_bar"]
        else:
            g = atl + torch.einsum('ktij,kti->ktj', p["other_a"],
                                   p["lam_other"])
        sep = torch.where(p["active"], sep, 1.0)
        g = torch.where(p["active"], g, 0.0)
        return sep, g

    def _ci(self, x, p):
        xs, us, e1, e2 = self.split(x)
        sep, g = self._raw_rows(xs, p)
        boxes = _box_residuals(xs, us, self._box)
        return torch.cat([(sep + e1).reshape(-1), e1.reshape(-1),
                          (e2 - g).reshape(-1), (e2 + g).reshape(-1),
                          e2.reshape(-1), boxes])

    def warm(self, ref_win, p):
        """Warm start of one vehicle: the reference window, zero controls,
        and elastic slacks just above the rows' violation there."""
        s = self.sizes
        sep, g = self._raw_rows(ref_win, p)
        e1 = (torch.clamp(-sep, min=0.0) + 0.01).reshape(-1)
        e2 = (torch.abs(g) + 0.01).reshape(-1)
        return torch.cat([ref_win.reshape(-1), ref_win.new_zeros(s["u"]),
                          e1, e2])


class FixedDualState(NamedTuple):
    """Exchange state: halfspaces + per-pair duals (ref MISC/tighting
    ``mid_state``). ``lam [P, 2, T, 4]`` holds the dual pair of each
    unordered vehicle pair (side 0 = the lower-indexed vehicle); ``s
    [P, T, 2]`` is the separating direction of the tightening slack variant
    (zeros in the other planners)."""

    a_mat: torch.Tensor   # [V, T, 4, 2]
    b: torch.Tensor       # [V, T, 4]
    lam: torch.Tensor     # [P, 2, T, 4]
    s: torch.Tensor       # [P, T, 2]


class _FixedDualPlannerBase(_RecedingHorizon):
    """What the bilevel and tightening planners share: the pair and
    neighbour-slot maps, the batched local solve and the MPC loop.
    ``device`` defaults to the CUDA card (:func:`~.obca.resolve_device`);
    ``dtype`` is float64 or float32."""

    coupling = "other_a"

    def __init__(self, ocfg: ObcaConfig, vcfg: VehicleConfig,
                 scfg: SolverConfig, refs: Optional[np.ndarray],
                 dtype=torch.float64, device=None):
        _check_dtype(dtype)
        self.ocfg, self.vcfg, self.scfg = ocfg, vcfg, scfg
        self.dtype = dtype
        self.device = resolve_device(device)
        if refs is None:
            refs = scenarios.ref_traj_overtake(vcfg, ocfg.num_veh)
        self.refs = torch.as_tensor(np.asarray(refs), dtype=dtype,
                                    device=self.device)
        v = ocfg.num_veh
        self.num_veh, self.K = v, v - 1
        idx_i, idx_j = pair_indices(v)
        nbr = np.array([[j for j in range(v) if j != i]
                        for i in range(v)], dtype=np.int64).reshape(v, v - 1)
        pid = np.zeros((v, v), dtype=np.int64)
        side = np.zeros((v, v), dtype=np.int64)
        for p_, (a, bb) in enumerate(zip(idx_i, idx_j)):
            pid[a, bb] = pid[bb, a] = p_
            side[a, bb] = 0          # a is the lower-indexed member
            side[bb, a] = 1
        rows = np.arange(v)[:, None]
        ix = dict(dtype=torch.long, device=self.device)
        self.idx_i = torch.as_tensor(idx_i, **ix)
        self.idx_j = torch.as_tensor(idx_j, **ix)
        self.n_pairs = len(idx_i)
        self._nbr = torch.as_tensor(nbr, **ix)                     # [V, K]
        self._slot_pid = torch.as_tensor(pid[rows, nbr], **ix)     # [V, K]
        self._slot_side = torch.as_tensor(side[rows, nbr], **ix)   # [V, K]
        # +1 on the lower-indexed side of each pair, -1 on the higher
        self._sgn = (1.0 - 2.0 * self._slot_side).to(dtype)
        self.local = _FixedDualLocal(ocfg, vcfg, dtype, self.device,
                                     self.coupling)

    def _pair_halfspaces(self, a_mat, b):
        """Gather per-vehicle halfspaces to per-pair sides:
        ``([P, 2, T, 4, 2], [P, 2, T, 4])``."""
        a_pair = torch.stack([a_mat[self.idx_i], a_mat[self.idx_j]], dim=1)
        b_pair = torch.stack([b[self.idx_i], b[self.idx_j]], dim=1)
        return a_pair, b_pair

    def _new_halfspaces(self, xs_pred):
        """Halfspaces of predicted states ``[V, T, 5]``, per vehicle and per
        pair side: ``(a_mat, b, a_pair, b_pair)``."""
        a_new, b_new = halfspaces(xs_pred, self.vcfg,
                                  self.ocfg.use_delay_tightening)
        return (a_new, b_new) + self._pair_halfspaces(a_new, b_new)

    def create_state(self) -> FixedDualState:
        """Halfspaces of the reference window's steps 1..N-1 and the duals
        solved on them."""
        n = self.ocfg.horizon
        a0, b0, a_pair, b_pair = self._new_halfspaces(self.refs[:, 1:n, :])
        s0 = torch.zeros((self.n_pairs, n - 1, 2), dtype=self.dtype,
                         device=self.device)
        if self.coupling == "slack":
            lam, s0, _ = solve_collision_duals_slack(
                a_pair, b_pair, self.ocfg.min_dis, self.scfg)
        else:
            lam, _ = solve_collision_duals(a_pair, b_pair, self.ocfg.min_dis,
                                           self.scfg)
        return FixedDualState(a_mat=a0, b=b0, lam=lam, s=s0)

    def _local_params(self, bs: FixedDualState, init_state, ref_win,
                      active: bool):
        """Per-vehicle parameters of the V local NLPs (leading axis V):
        lam_self[i, k] is the side of pair (i, nbr[i, k]) that i owns."""
        v = self.num_veh
        p = dict(init_state=init_state, ref_win=ref_win,
                 lam_self=bs.lam[self._slot_pid, self._slot_side],
                 other_b=bs.b[self._nbr],
                 lam_other=bs.lam[self._slot_pid, 1 - self._slot_side],
                 active=torch.full((v,), bool(active), device=self.device))
        if self.coupling == "slack":
            p["s_bar"] = bs.s[self._slot_pid]                 # [V, K, T, 2]
            p["sgn"] = self._sgn
        else:
            p["other_a"] = bs.a_mat[self._nbr]
        return p

    def _local_solve(self, bs: FixedDualState, init_state, ref_win,
                     active: bool):
        """All V local NLPs as one dense IP solve: ``(X [V, N, 5],
        U [V, N-1, 2], max elastic slack [V], NLPSolution)``."""
        p = self._local_params(bs, init_state, ref_win, active)
        x0 = vmap(self.local.warm)(ref_win, p)
        sol = solve_nlp_batch(self.local.nlp, x0, p, self.scfg)
        xs, us, e1, e2 = self.local.split(sol.x)
        e = torch.maximum(torch.amax(e1, dim=(-2, -1)),
                          torch.amax(e2, dim=(-3, -2, -1)))
        return xs, us, e, sol

    @staticmethod
    def _trips(sol) -> int:
        """IP trips a batched solve ran: its slowest lane's iterations."""
        return int(sol.iterations.max())

    def _shifted_duals(self, bs: FixedDualState, xs):
        """The tightening edge pass: halfspaces of the predictions shifted
        by two steps with the tail duplicated (``optimizer_ori.py:
        187-206``), then the duals re-solved from ``bs``'s."""
        n = self.ocfg.horizon
        shift_idx = torch.clamp(torch.arange(2, n + 1, device=self.device),
                                max=n - 1)
        a_new, b_new, a_pair, b_pair = self._new_halfspaces(
            xs[:, shift_idx, :])
        if self.coupling == "slack":
            lam, s_new, dsol = solve_collision_duals_slack(
                a_pair, b_pair, self.ocfg.min_dis, self.scfg, bs.lam, bs.s)
        else:
            lam, dsol = solve_collision_duals(
                a_pair, b_pair, self.ocfg.min_dis, self.scfg, bs.lam)
            s_new = bs.s
        return FixedDualState(a_mat=a_new, b=b_new, lam=lam, s=s_new), dsol

    def run(self, n_steps: Optional[int] = None, step_timer=None,
            checkpoint_path: Optional[str] = None, resume: bool = False):
        """MPC loop; returns ``(states [n+1, V, 5], infos)``, one dict per
        step of ``elastic`` and ``dual_kkt`` (as the JAX ``run``) and the
        IP trips the step's local and dual solves ran (``local_trips``,
        ``dual_trips``). ``step_timer``, a context-manager factory such as
        ``RunMetrics.step_timer``, wraps each step (its host reads
        included). ``checkpoint_path`` saves the ``(init_state,
        FixedDualState)`` carry after every step; ``resume=True`` continues
        a saved run from its last completed step."""
        timer = step_timer or contextlib.nullcontext
        n_steps = self._n_steps(n_steps)
        init_state = self.refs[:, 0, :]
        bs = self.create_state()
        (init_state, bs), start = resume_carry(checkpoint_path, resume,
                                               (init_state, bs))
        states, infos = [init_state.cpu().numpy()], []
        for t in range(start, n_steps):
            with timer():
                init_state, bs, info = self._mpc_step(init_state, bs, t)
                states.append(init_state.cpu().numpy())
            infos.append({k: float(v) if torch.is_tensor(v) else v
                          for k, v in info.items()})
            if checkpoint_path is not None:
                save_carry(checkpoint_path, (init_state, bs), t + 1)
        self.carry = (init_state, bs)
        return np.stack(states), infos


class BilevelObcaPlanner(_FixedDualPlannerBase):
    """MISC bilevel alternation (ref ``decentralized_MISC/optimizer.py``):
    per MPC step, ``n_rounds`` rounds of (local NLPs -> halfspace update ->
    edge dual solve), with no convergence test."""

    def __init__(self, ocfg: ObcaConfig = ObcaConfig(horizon=8, min_dis=1.0),
                 vcfg: VehicleConfig = VehicleConfig(),
                 scfg: SolverConfig = SolverConfig(),
                 refs: Optional[np.ndarray] = None, n_rounds: int = 3,
                 dtype=torch.float64, device=None):
        self.n_rounds = n_rounds
        super().__init__(ocfg, vcfg, scfg, refs, dtype, device)

    def _mpc_step(self, init_state, bs: FixedDualState, step_idx: int):
        ref_win = self._ref_window(step_idx)
        loc_trips = dual_trips = 0
        for _ in range(self.n_rounds):
            xs, us, e, sol = self._local_solve(bs, init_state, ref_win, True)
            a_new, b_new, a_pair, b_pair = self._new_halfspaces(xs[:, 1:, :])
            lam, dsol = solve_collision_duals(
                a_pair, b_pair, self.ocfg.min_dis, self.scfg, bs.lam)
            bs = FixedDualState(a_mat=a_new, b=b_new, lam=lam, s=bs.s)
            loc_trips += self._trips(sol)
            dual_trips += self._trips(dsol)
        info = dict(elastic=torch.amax(e), dual_kkt=dsol.kkt_error.max(),
                    local_trips=loc_trips, dual_trips=dual_trips)
        return xs[:, 1, :], bs, info


class TighteningObcaPlanner(_FixedDualPlannerBase):
    """Sequential constraint-tightening planner (ref ``decentralized_tighting/
    optimizer_ori.py``): one local pass with the previous step's
    (A, b, lambda), collision rows off at t = 0, and one edge dual re-solve
    per MPC step on the predictions shifted by two steps. The default
    vehicle config is T = 7 s, prob = 0.99 (ref
    ``decentralized_tighting/veh_config.py:18``)."""

    def __init__(self, ocfg: ObcaConfig = ObcaConfig(horizon=8, min_dis=1.0),
                 vcfg: VehicleConfig = VehicleConfig(T=7.0, prob=0.99),
                 scfg: SolverConfig = SolverConfig(),
                 refs: Optional[np.ndarray] = None, dtype=torch.float64,
                 device=None):
        super().__init__(ocfg, vcfg, scfg, refs, dtype, device)

    def _mpc_step(self, init_state, bs: FixedDualState, step_idx: int):
        ref_win = self._ref_window(step_idx)
        xs, us, e, sol = self._local_solve(bs, init_state, ref_win,
                                           step_idx > 0)
        bs, dsol = self._shifted_duals(bs, xs)
        info = dict(elastic=torch.amax(e), dual_kkt=dsol.kkt_error.max(),
                    local_trips=self._trips(sol),
                    dual_trips=self._trips(dsol))
        return xs[:, 1, :], bs, info


class TighteningSlackObcaPlanner(TighteningObcaPlanner):
    """Constraint tightening with the explicit separating-direction slack
    (ref ``decentralized_tighting/optimizer.py``): the local (5b) rows
    couple A(X)^T lam to the shared direction ``+-s_bar``, and the edge
    re-solves the duals and the direction together under ||s||^2 <= 1."""

    coupling = "slack"

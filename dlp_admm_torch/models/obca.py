"""OBCA planners, ported to PyTorch: the centralized joint NLP and the
consensus-ADMM decomposition (the flagship).

Port of ``dlp_admm_tpu/models/obca.py``:

* :class:`CentralizedObcaPlanner` (≙ the reference's
  ``centralized/optimizer.py`` + ``centralized_overtaking{,_stochastic}.py``):
  one joint NLP over all vehicles' states, controls and collision duals,
  solved receding-horizon, by default with the staged solver as one lane
  whose N-1 stages are the horizon steps;
* :class:`ConsensusObcaPlanner` (≙ ``decentralized/optimizer.py`` +
  ``decentralized_overtaking_ADMM.py``): per-vehicle NLPs over (X_i, U_i,
  lambda, elastic slacks) with augmented-Lagrangian coupling to an edge/RSU
  consensus NLP over Z = (states, lambda), and dual ascent (+ saturation) on
  lambda_bar.

In the consensus planner both NLP families are by default solved by the
staged interior-point solver (:mod:`..solvers.ip_staged`): the V local NLPs
as one batch of V lanes, the edge NLP as one lane whose stages are the
horizon steps. Every KKT solve of either goes through the block-Thomas CUDA
kernel on a CUDA device. ``use_staged=False`` solves the locals as dense
NLPs and ``edge_mode="joint"`` / ``"per_step"`` the edge as one dense NLP or
one per horizon step, all with the dense solver (:mod:`..solvers.ip`), whose
KKT solves are ``torch.linalg``'s, as they are XLA's in JAX.

The JAX version runs the consensus ADMM loop as a ``lax.while_loop`` on the device;
here it is a Python loop whose one host read per iteration is the ``done``
flag, and whose carry stays on the planner's device. Collision constraint
blocks (paper eq. (4)/(5)/(6)):

    (4a)  -b_i(x_i)^T l_i - b_j(x_j)^T l_j >= d_min
    (4b)  A_i(x_i)^T l_i + A_j(x_j)^T l_j  = 0
    (4c)  ||A_i(x_i)^T l_i||^2 <= 1,  l >= 0

The consensus planner carries every option of the JAX one: the edge's
proximal term (``edge_prox``), the branch commitment (``branch_commit``,
``commit_after``, ``commit_w``) and the fixed-length traced step
``mpc_step_trace``. ``ConsensusObcaPlanner.run`` saves its ``(init_state,
BarState)`` carry after every step with ``checkpoint_path`` and continues
a saved run with ``resume=True`` (:mod:`..utils.checkpoint`). The
scenario-batched step of :mod:`..parallel.consensus_spmd` builds its
parameters with this planner's methods.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import scenarios
from ..config import (DualStrategy, DualUpdateConfig, ObcaConfig,
                      SolverConfig, VehicleConfig, WindupMode)
from ..coordination.dual_update import DualState, update_dual
from ..ops.dynamics import bicycle_rhs
from ..ops.geometry import halfspaces
from ..ops.pairs import pair_indices
from ..solvers.ip import NLP, NLPSolution, solve_nlp, solve_nlp_batch
from ..solvers.ip_staged import StagedNLP, solve_staged
from ..utils.checkpoint import resume_carry, save_carry

def resolve_device(device=None) -> torch.device:
    """The device a planner runs on: the CUDA card unless the caller names
    another. Raises where the card is asked for (by name or by default) and
    there is none; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the planner runs on a CUDA card by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


def _box_bounds(ocfg: ObcaConfig, vcfg: VehicleConfig, **kw):
    """(lo_x [5], hi_x [5], hi_u [2]) of the state/control boxes, made once
    per planner: a host-to-device copy inside a stage function would run on
    every IP trip and cannot be captured into a CUDA graph."""
    lo_x = torch.tensor([0.0, -ocfg.max_y, -vcfg.max_v, -2 * math.pi,
                         -vcfg.max_front_wheel_angle], **kw)
    hi_x = torch.tensor([ocfg.max_x, ocfg.max_y, vcfg.max_v, 2 * math.pi,
                         vcfg.max_front_wheel_angle], **kw)
    hi_u = torch.tensor([vcfg.max_acc, vcfg.max_steer_rate], **kw)
    return lo_x, hi_x, hi_u


def _dyn_residual(x_states, u_ctrls, init_state, cfg: VehicleConfig):
    """Init + Euler dynamics equality residuals of one vehicle,
    ``x_states [N, 5]``, ``u_ctrls [N-1, 2]`` (ref
    ``decentralized/optimizer.py:84-100``, vectorized over the horizon)."""
    r0 = x_states[0] - init_state
    f = bicycle_rhs(x_states[:-1], u_ctrls, cfg)
    r_dyn = x_states[1:] - (x_states[:-1] + cfg.dt * f)
    return torch.cat([r0, r_dyn.reshape(-1)])


def _box_residuals(x_states, u_ctrls, bounds):
    """State/control box bounds as >= 0 residuals
    (ref ``local_generate_variable`` ``optimizer.py:131-142``)."""
    lo_x, hi_x, hi_u = bounds
    return torch.cat([
        (x_states - lo_x).reshape(-1), (hi_x - x_states).reshape(-1),
        (u_ctrls + hi_u).reshape(-1), (hi_u - u_ctrls).reshape(-1)])


def _check_dtype(dtype):
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"dtype must be float64 or float32, got {dtype}")


class _RecedingHorizon:
    """What both OBCA planners share: a step's reference window and the
    run's length (``refs``, ``ocfg``, ``vcfg`` are the planner's)."""

    def _ref_window(self, step_idx: int):
        """refs[:, k:k+N] with the start clamped in bounds, as
        ``lax.dynamic_slice_in_dim`` clamps it."""
        n = self.ocfg.horizon
        start = min(max(int(step_idx), 0), self.refs.shape[1] - n)
        return self.refs[:, start:start + n]

    def _n_steps(self, n_steps):
        """The reference's run, ``T / dt - N`` MPC steps, unless given."""
        total = int(self.vcfg.T / self.vcfg.dt - self.ocfg.horizon)
        return total if n_steps is None else n_steps


# %% centralized joint planner ------------------------------------------------


class CentralizedObcaPlanner(_RecedingHorizon):
    """Joint OBCA NLP over all vehicles, receding horizon (ref
    ``centralized/optimizer.py:8-194``; horizon 15, R = 0.1 I, Q = I).

    Generalizes the reference's 2-vehicle collision block to all unordered
    pairs with per-(pair, side) duals. ``use_staged`` (the default) solves
    the NLP with the staged solver as one lane of ``N - 1`` stages, each
    holding every step-``k+1`` decision block ``[X (5V) | U (2V) | LAM
    (8P)]``; its KKT blocks, ``7V + 8P`` wide plus ``5V`` dynamics rows and
    ``2P`` pairing rows, go through the block-Thomas kernel on a CUDA
    device. ``use_staged=False`` solves the same problem with the dense
    solver (``torch.linalg``). ``warm_mode`` ``"reference"`` re-seeds every
    step from the reference window (the reference's ``initialize()``);
    ``"previous"`` shifts the previous optimum. ``device`` defaults to the
    CUDA card (:func:`resolve_device`); ``dtype`` is float64 or float32 (in
    float32 the staged solver solves its KKT systems raised to float64,
    every stage solve equilibrated).
    """

    def __init__(self, ocfg: ObcaConfig = ObcaConfig(horizon=15),
                 vcfg: VehicleConfig = VehicleConfig(),
                 scfg: SolverConfig = SolverConfig(),
                 refs: Optional[np.ndarray] = None,
                 r_ctrl: float = 0.1, q_state: float = 1.0,
                 warm_mode: str = "reference",
                 use_staged: bool = True,
                 dtype=torch.float64, device=None):
        if warm_mode not in ("reference", "previous"):
            raise ValueError(f"unknown warm_mode {warm_mode!r}")
        _check_dtype(dtype)
        self.ocfg, self.vcfg, self.scfg = ocfg, vcfg, scfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.r_ctrl, self.q_state = r_ctrl, q_state
        self.use_staged = bool(use_staged)
        self.warm_mode = warm_mode
        if refs is None:
            refs = scenarios.ref_traj_overtake(vcfg, ocfg.num_veh)
        self.refs = torch.as_tensor(np.asarray(refs), dtype=dtype,
                                    device=self.device)    # [V, T/dt+1, 5]
        idx_i, idx_j = pair_indices(ocfg.num_veh)
        self.idx_i = torch.as_tensor(idx_i, dtype=torch.long,
                                     device=self.device)
        self.idx_j = torch.as_tensor(idx_j, dtype=torch.long,
                                     device=self.device)
        v, n, p = ocfg.num_veh, ocfg.horizon, len(idx_i)
        self.n_pairs = p
        self._sizes = dict(x=v * 5 * n, u=v * 2 * (n - 1),
                           lam=p * 2 * 4 * (n - 1))
        self._box = _box_bounds(ocfg, vcfg, dtype=dtype, device=self.device)
        self._nlp = NLP(self._objective, self._ce, self._ci)
        self._staged_nlp = StagedNLP(self._stage_f, self._stage_ce_link,
                                     self._stage_ce, self._stage_ci)
        # block-Thomas solves made by this planner's staged solves
        self.block_solves = 0

    # x layout: [X (V,N,5) | U (V,N-1,2) | LAM (P,2,N-1,4)]
    def _split(self, x):
        v, n, p = self.ocfg.num_veh, self.ocfg.horizon, self.n_pairs
        s = self._sizes
        xs = x[:s["x"]].reshape(v, n, 5)
        us = x[s["x"]:s["x"] + s["u"]].reshape(v, n - 1, 2)
        lam = x[s["x"] + s["u"]:].reshape(p, 2, n - 1, 4)
        return xs, us, lam

    def _objective(self, x, p):
        """Tracking + effort (ref ``generate_object`` ``optimizer.py:104-115``)."""
        xs, us, _ = self._split(x)
        err = xs[:, 1:, :] - p["ref_win"][:, 1:, :]
        return (self.r_ctrl * torch.sum(us ** 2)
                + self.q_state * torch.sum(err ** 2))

    def _halfspaces_at(self, xs):
        """[V, N-1, 4, 2], [V, N-1, 4] halfspaces of steps 1..N-1
        (ref ``generate_constrain`` ``optimizer.py:168-181``)."""
        return halfspaces(xs[:, 1:, :], self.vcfg,
                          self.ocfg.use_delay_tightening)

    def _ce(self, x, p):
        """Init + dynamics per vehicle, then (4b) ``A_i^T l_pi + A_j^T l_pj
        = 0`` per pair per step."""
        xs, us, lam = self._split(x)
        dyn = torch.cat([_dyn_residual(xs[i], us[i], p["init_state"][i],
                                       self.vcfg)
                         for i in range(self.ocfg.num_veh)])
        a_mat, _ = self._halfspaces_at(xs)
        at_li = torch.einsum('ptij,pti->ptj', a_mat[self.idx_i], lam[:, 0])
        at_lj = torch.einsum('ptij,pti->ptj', a_mat[self.idx_j], lam[:, 1])
        return torch.cat([dyn, (at_li + at_lj).reshape(-1)])

    def _ci(self, x, p):
        """(4a) separation, (4c) dual norm (one side per pair suffices given
        4b, as ref ``optimizer.py:192-194``), lambda >= 0, boxes."""
        xs, us, lam = self._split(x)
        a_mat, b = self._halfspaces_at(xs)
        bl_i = torch.einsum('pti,pti->pt', b[self.idx_i], lam[:, 0])
        bl_j = torch.einsum('pti,pti->pt', b[self.idx_j], lam[:, 1])
        sep = -bl_i - bl_j - self.ocfg.min_dis
        at_li = torch.einsum('ptij,pti->ptj', a_mat[self.idx_i], lam[:, 0])
        nrm = 1.0 - torch.sum(at_li ** 2, dim=-1)
        boxes = torch.cat([_box_residuals(xs[i], us[i], self._box)
                           for i in range(self.ocfg.num_veh)])
        return torch.cat([sep.reshape(-1), nrm.reshape(-1), lam.reshape(-1),
                          boxes])

    # -- staged (block-tridiagonal) form ----------------------------------
    # Stage k = 0..N-2 holds every step-(k+1) decision block:
    # w_k = [X[:, k+1, :] (V*5) | U[:, k, :] (V*2) | LAM[:, :, k, :] (P*8)].
    # Dynamics couple adjacent stages; the OBCA rows live within a stage.

    def _stage_split(self, w):
        v = self.ocfg.num_veh
        xs = w[:5 * v].reshape(v, 5)
        us = w[5 * v:7 * v].reshape(v, 2)
        lam = w[7 * v:].reshape(self.n_pairs, 2, 4)
        return xs, us, lam

    def _stage_params(self, init_state, ref_win):
        """Per-stage parameters of the one lane, ``[1, N-1, ...]``."""
        t = self.ocfg.horizon - 1
        first = torch.zeros((1, t), dtype=self.dtype, device=self.device)
        first[0, 0] = 1.0
        return dict(first=first,
                    ref=ref_win[:, 1:, :].movedim(1, 0)[None],   # [1, T, V, 5]
                    init=init_state.expand((1, t) + init_state.shape))

    def _stage_f(self, w, pk):
        xs, us, _ = self._stage_split(w)
        return (self.r_ctrl * torch.sum(us ** 2)
                + self.q_state * torch.sum((xs - pk["ref"]) ** 2))

    def _stage_ce_link(self, w_prev, w, pk):
        xs, us, _ = self._stage_split(w)
        xp = torch.where(pk["first"] > 0, pk["init"],
                         self._stage_split(w_prev)[0])
        f = bicycle_rhs(xp, us, self.vcfg)
        return (xs - (xp + self.vcfg.dt * f)).reshape(-1)

    def _stage_ce(self, w, pk):
        xs, _, lam = self._stage_split(w)
        a_mat, _ = halfspaces(xs, self.vcfg, self.ocfg.use_delay_tightening)
        at_li = torch.einsum('pij,pi->pj', a_mat[self.idx_i], lam[:, 0])
        at_lj = torch.einsum('pij,pi->pj', a_mat[self.idx_j], lam[:, 1])
        return (at_li + at_lj).reshape(-1)

    def _stage_ci(self, w, pk):
        xs, us, lam = self._stage_split(w)
        a_mat, b = halfspaces(xs, self.vcfg, self.ocfg.use_delay_tightening)
        bl_i = torch.einsum('pi,pi->p', b[self.idx_i], lam[:, 0])
        bl_j = torch.einsum('pi,pi->p', b[self.idx_j], lam[:, 1])
        sep = -bl_i - bl_j - self.ocfg.min_dis
        at_li = torch.einsum('pij,pi->pj', a_mat[self.idx_i], lam[:, 0])
        nrm = 1.0 - torch.sum(at_li ** 2, dim=-1)
        boxes = _box_residuals(xs, us, self._box)
        return torch.cat([sep, nrm, lam.reshape(-1), boxes])

    def _to_staged(self, x):
        """Dense decision vector -> staged ``[N-1, b]`` (same variables)."""
        xs, us, lam = self._split(x)
        t = self.ocfg.horizon - 1
        return torch.cat([xs[:, 1:].movedim(1, 0).reshape(t, -1),
                          us.movedim(1, 0).reshape(t, -1),
                          lam.movedim(2, 0).reshape(t, -1)], dim=1)

    def _from_staged(self, w, init_state):
        t = self.ocfg.horizon - 1
        v, p = self.ocfg.num_veh, self.n_pairs
        xs_t = w[:, :5 * v].reshape(t, v, 5)
        us_t = w[:, 5 * v:7 * v].reshape(t, v, 2)
        lam_t = w[:, 7 * v:].reshape(t, p, 2, 4)
        xs = torch.cat([init_state[None], xs_t]).movedim(0, 1)   # [V, N, 5]
        return xs, us_t.movedim(0, 1), lam_t.movedim(0, 2)

    def _flat(self, xs, us, lam):
        return torch.cat([xs.reshape(-1), us.reshape(-1), lam.reshape(-1)])

    def _warm_start(self, ref_win):
        """States = the reference window, u = 0, lambda = 10 (ref x0)."""
        kw = dict(dtype=self.dtype, device=self.device)
        return torch.cat([ref_win.reshape(-1),
                          torch.zeros(self._sizes["u"], **kw),
                          torch.full((self._sizes["lam"],), 10.0, **kw)])

    def _shift_warm(self, x_prev):
        """Shift the previous optimum one step (drop t=0, duplicate the
        tail), the warm start of ``warm_mode='previous'``; the shifted tail
        state is advanced through the dynamics, so the warm start stays
        dynamics-feasible end to end."""
        xs, us, lam = self._split(x_prev)

        def shift(a, ax):
            n = a.shape[ax]
            return torch.cat([a.narrow(ax, 1, n - 1), a.narrow(ax, n - 1, 1)],
                             dim=ax)
        xs_s, us_s = shift(xs, 1), shift(us, 1)
        tail = xs_s[:, -2] + self.vcfg.dt * bicycle_rhs(
            xs_s[:, -2], us_s[:, -1], self.vcfg)
        xs_s = torch.cat([xs_s[:, :-1], tail[:, None]], dim=1)
        return self._flat(xs_s, us_s, shift(lam, 2))

    def _solve(self, init_state, step_idx: int, x_warm):
        """One joint solve from ``x_warm``; returns ``(xs [V, N, 5],
        us [V, N-1, 2], lam [P, 2, N-1, 4], NLPSolution)`` on the planner's
        device (the staged form's solution carries no multipliers)."""
        ref_win = self._ref_window(step_idx)
        if self.use_staged:
            ssol = solve_staged(self._staged_nlp, self._to_staged(x_warm)[None],
                                self._stage_params(init_state, ref_win),
                                self.scfg)
            self.block_solves += ssol.block_solves
            xs, us, lam = self._from_staged(ssol.w[0], init_state)
            empty = torch.zeros((0,), dtype=self.dtype, device=self.device)
            sol = NLPSolution(x=self._flat(xs, us, lam), y=empty, z=empty,
                              s=empty, kkt_error=ssol.kkt_error[0],
                              iterations=ssol.iterations[0],
                              converged=ssol.converged[0])
            return xs, us, lam, sol
        sol = solve_nlp(self._nlp, x_warm,
                        dict(init_state=init_state, ref_win=ref_win),
                        self.scfg)
        return (*self._split(sol.x), sol)

    def solve_at(self, init_state, step_idx: int):
        """One joint solve with the reference warm start (the unit the MPC
        loop repeats)."""
        if not torch.is_tensor(init_state):
            init_state = torch.as_tensor(np.array(init_state))
        init_state = init_state.to(dtype=self.dtype, device=self.device)
        return self._solve(init_state, step_idx,
                           self._warm_start(self._ref_window(step_idx)))

    def run_scan(self, n_steps: Optional[int] = None):
        """Whole MPC run with the (state, warm-start) carry on the planner's
        device; returns host arrays ``(states [n+1, V, 5], ctrls [n, V, 2],
        kkts [n], iters [n], convs [n])``, as the JAX ``run_scan``."""
        states, ctrls, infos = self.run(n_steps)
        return (states, ctrls,
                np.asarray([i["kkt"] for i in infos]),
                np.asarray([i["iters"] for i in infos], dtype=np.int32),
                np.asarray([i["converged"] for i in infos], dtype=bool))

    def run(self, n_steps: Optional[int] = None, step_timer=None):
        """MPC loop (ref ``centralized_overtaking.py:21-56``): apply the
        optimizer's own next state as the plant update. Returns ``(states
        [n+1, V, 5], controls [n, V, 2], infos)``, one dict of ``kkt``,
        ``iters``, ``converged`` per step. ``step_timer``, a context-manager
        factory such as ``RunMetrics.step_timer``, wraps each step (its host
        reads included)."""
        timer = step_timer or contextlib.nullcontext
        n_steps = self._n_steps(n_steps)
        init_state = self.refs[:, 0, :]
        x_warm = self._warm_start(self._ref_window(0))
        states, controls, infos = [init_state.cpu().numpy()], [], []
        for t in range(n_steps):
            with timer():
                xs, us, lam, sol = self._solve(init_state, t, x_warm)
                if self.warm_mode == "previous":
                    x_warm = self._shift_warm(sol.x)
                else:
                    x_warm = self._warm_start(self._ref_window(t + 1))
                init_state = xs[:, 1, :]
                states.append(init_state.cpu().numpy())
            controls.append(us[:, 0, :].cpu().numpy())
            infos.append(dict(kkt=float(sol.kkt_error),
                              iters=int(sol.iterations),
                              converged=bool(sol.converged)))
        return np.stack(states), np.stack(controls), infos


# %% consensus-ADMM planner (the flagship) -------------------------------------


class BarState(NamedTuple):
    """The vehicle<->RSU exchange state (ref ``mid_state``
    ``decentralized/optimizer.py:351-373``); leading vehicle axis.
    ``F = 5 + 4 (V-1)`` is the per-vehicle consensus width."""

    z_bar: torch.Tensor      # [V, N-1, F] edge consensus (states + lambda)
    a_mat: torch.Tensor      # [V, N-1, 4, 2] broadcast halfspace normals
    b: torch.Tensor          # [V, N-1, 4]
    lamb_bar: torch.Tensor   # [V, N-1, F] ADMM duals
    lamb_ij: torch.Tensor    # [V, V-1, N-1, 4] collision duals per nbr slot
    local_x: torch.Tensor    # [V, N-1, 5] latest local states


# warm-start table for lamb_ij (ref optimizer.py:357-371 hard-codes this for
# the 2-vehicle overtaking scenario, N_horz = 8)
_LAMB_IJ_TABLE = np.array(
    [[[1.49, 0.566, 0.566, 1.49], [1.438, 0.514, 0.514, 1.438],
      [1.387, 0.462, 0.462, 1.387], [1.336, 0.411, 0.411, 1.336],
      [1.287, 0.361, 0.361, 1.287], [1.238, 0.312, 0.312, 1.238],
      [1.191, 0.263, 0.263, 1.191]],
     [[1.436] * 4, [1.325] * 4, [1.213] * 4, [1.1] * 4,
      [0.986] * 4, [0.871] * 4, [0.755] * 4]])


class ConsensusObcaPlanner(_RecedingHorizon):
    """Consensus-ADMM OBCA planner, generalized to N vehicles with the
    JAX version's neighbour-slot layout (slot k of vehicle i holds its OBCA
    duals against neighbour ``nbr[i, k]``; for V = 2, F = 9 as in the
    reference). See ``dlp_admm_tpu.models.obca.ConsensusObcaPlanner`` for the
    rationale of every option; the defaults are the same.

    ``device`` and ``dtype`` place every tensor of the planner. ``device``
    defaults to the CUDA card (:func:`resolve_device`); ``dtype`` is
    float64 or float32. In float32 the staged solver raises its KKT
    systems to float64, equilibrates every stage solve inside the
    block-Thomas kernel, and refines twice in float32, and the
    flagship's profile is ``ip_tol=1e-4``, ``prox_tau_max=1e9`` (the
    float64 profile's 1e-6 is below the float32 noise floor of the scaled
    KKT residuals, and its 3e10 prox tail swamps the KKT conditioning).
    """

    def __init__(self, ocfg: ObcaConfig = ObcaConfig(),
                 vcfg: VehicleConfig = VehicleConfig(),
                 scfg: SolverConfig = SolverConfig(),
                 refs: Optional[np.ndarray] = None,
                 lamb_ij_mode: str = "track_edge",
                 dual_cfg: Optional[DualUpdateConfig] = None,
                 local_warm_mode: str = "previous",
                 gate_pairs: bool = False, gate_thres: float = 10.0,
                 use_staged: bool = True, edge_mode: str = "staged",
                 lamb_bar_decay: float = 0.5,
                 lamb_ij_relax: float = 0.3,
                 lamb_ij_hysteresis: bool = False,
                 edge_prox: float = 0.0,
                 branch_commit: bool = False, commit_after: int = 6,
                 commit_w: float = 1000.0, local_prox: float = 0.0,
                 prox_after: int = 0, prox_growth: float = 1.0,
                 prox_adaptive: bool = False, prox_tau_max: float = 3.0e10,
                 dtype=torch.float64, device=None):
        if lamb_ij_mode not in ("frozen", "track_local", "track_edge"):
            raise ValueError(f"unknown lamb_ij_mode {lamb_ij_mode!r}")
        if local_warm_mode not in ("reference", "previous"):
            raise ValueError(f"unknown local_warm_mode {local_warm_mode!r}")
        if edge_mode not in ("joint", "per_step", "staged"):
            raise ValueError(f"unknown edge_mode {edge_mode!r}")
        _check_dtype(dtype)
        self.ocfg, self.vcfg, self.scfg = ocfg, vcfg, scfg
        self.lamb_ij_mode = lamb_ij_mode
        self.local_warm_mode = local_warm_mode
        self.use_staged = bool(use_staged)
        self.edge_mode = edge_mode
        # plain ascent + saturation on lamb_bar (see the JAX constructor)
        self.dual_cfg = dual_cfg if dual_cfg is not None else DualUpdateConfig(
            strategy=DualStrategy.PLAIN, windup=WindupMode.SAT,
            windup_sat=20.0, adaptive_rho=False)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.gate_pairs, self.gate_thres = gate_pairs, gate_thres
        if refs is None:
            refs = scenarios.ref_traj_overtake(vcfg, ocfg.num_veh)
        self.refs = self._t(refs)                        # [V, T/dt+1, 5]
        v, n = ocfg.num_veh, ocfg.horizon
        self.num_veh = v
        self.K = v - 1                                   # neighbour slots
        self.N_FULL = 5 + 4 * self.K                     # consensus width F
        nbr = np.array([[j for j in range(v) if j != i] for i in range(v)],
                       dtype=np.int64).reshape(v, self.K)
        # rev[i, k] = slot of vehicle i in the list of its k-th neighbour
        rev = np.array([[i if i < j else i - 1 for j in nbr[i]]
                        for i in range(v)], dtype=np.int64).reshape(v, self.K)
        idx_i, idx_j = pair_indices(v)                   # P unordered pairs
        pid = np.zeros((v, v), dtype=np.int64)
        for p_, (a, bb) in enumerate(zip(idx_i, idx_j)):
            pid[a, bb] = pid[bb, a] = p_
        # index maps as long tensors on the planner's device
        ix = dict(dtype=torch.long, device=self.device)
        self._nbr = torch.as_tensor(nbr, **ix)                   # [V, K]
        self._rev = torch.as_tensor(rev, **ix)                   # [V, K]
        self.idx_i = torch.as_tensor(idx_i, **ix)
        self.idx_j = torch.as_tensor(idx_j, **ix)
        self._slot_i = self.idx_j - 1   # slot of j in i's list (i < j)
        self._slot_j = self.idx_i       # slot of i in j's list
        self._pair_id = torch.as_tensor(
            pid[np.arange(v)[:, None], nbr], **ix)               # [V, K]
        self._box = _box_bounds(ocfg, vcfg, dtype=dtype, device=self.device)
        self.elastic_w = 1.0e7
        self.cert_norm_bound = 0.95
        self._loc_sizes = dict(x=5 * n, u=2 * (n - 1),
                               lam=self.K * 4 * (n - 1),
                               e=self.K * (n - 1))
        self.lamb_bar_decay = float(lamb_bar_decay)
        self.lamb_ij_relax = float(lamb_ij_relax)
        # freeze the certificate exchange on iterations where the primal
        # residual rose (the limit-cycle breaker of the JAX planner)
        self.lamb_ij_hysteresis = bool(lamb_ij_hysteresis)
        self.local_prox = float(local_prox)
        self.prox_after = int(prox_after)
        self.prox_growth = float(prox_growth)
        self.prox_tau_max = float(prox_tau_max)
        # adaptive ratchet: hold tau while the primal residual falls, grow
        # it by prox_growth when it rises (instead of the scheduled anneal)
        self.prox_adaptive = bool(prox_adaptive)
        # edge proximal term edge_prox/2 ||z - z_prev||^2 to the previous
        # consensus iterate (see the JAX constructor)
        self.edge_prox = float(edge_prox)
        # branch commitment: from ADMM iteration commit_after on, the edge
        # pays commit_w * relu(-<d(z), d_bar>)^2 per (pair, step) for
        # leaving the pass side frozen in d_bar
        self.branch_commit = bool(branch_commit)
        self.commit_after = int(commit_after)
        self.commit_w = float(commit_w)
        self._local_nlp = NLP(self._local_obj, self._local_ce, self._local_ci)
        self._edge_nlp = NLP(self._edge_obj, self._edge_ce, self._edge_ci)
        self._edge_nlp_t = NLP(self._edge_obj_t, self._edge_ce_t,
                               self._edge_ci_t)
        self._local_staged = StagedNLP(self._loc_stage_f,
                                       self._loc_stage_ce_link,
                                       self._loc_stage_ce,
                                       self._loc_stage_ci)
        self._edge_staged = StagedNLP(self._edge_obj_t,
                                      self._edge_stage_ce_link,
                                      self._edge_ce_t, self._edge_ci_t)
        # block-Thomas solves made by this planner's staged solves (each
        # solve covers all lanes of one NLP family at once)
        self.block_solves = 0
        # (state [V, 5], BarState) after the last step of run / run_scan,
        # on the planner's device
        self.carry = None

    def _t(self, a):
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    # -- local problem (ref optimizer.py:40-201) -------------------------

    def _loc_split(self, x):
        """Dense local vector(s) ``[..., nx]`` -> states [..., N, 5],
        controls [..., N-1, 2], duals [..., K, N-1, 4], slacks [..., K, N-1]."""
        n = self.ocfg.horizon
        s = self._loc_sizes
        lead = x.shape[:-1]
        o1 = s["x"]
        o2 = o1 + s["u"]
        o3 = o2 + s["lam"]
        xs = x[..., :o1].reshape(lead + (n, 5))
        us = x[..., o1:o2].reshape(lead + (n - 1, 2))
        lam = x[..., o2:o3].reshape(lead + (self.K, n - 1, 4))
        e = x[..., o3:].reshape(lead + (self.K, n - 1))
        return xs, us, lam, e

    # dense local form (use_staged=False): one vehicle's x [nx], p its slice
    # of _local_params

    def _s_full(self, xs, lam):
        """Consensus row S = (X_t, lambda blocks) per step: [N-1, F]."""
        n = self.ocfg.horizon
        lam_flat = lam.movedim(0, 1).reshape(n - 1, 4 * self.K)
        return torch.cat([xs[1:], lam_flat], dim=-1)

    def _local_obj(self, x, p):
        """Tracking + effort + AL (ref ``local_generate_object``
        ``optimizer.py:150-168``): obj += lamb_bar^T S + rho/2 ||S - Z||^2
        with S = (X_t, lambda_t)."""
        xs, us, lam, e = self._loc_split(x)
        err = xs[1:] - p["ref_win"][1:]
        obj = (self.ocfg.r_ctrl * torch.sum(us ** 2)
               + self.ocfg.q_state * torch.sum(err ** 2))
        s_full = self._s_full(xs, lam)                         # [N-1, F]
        obj = obj + torch.sum(p["lamb_bar"] * s_full)
        obj = obj + p["rho"] / 2 * torch.sum((s_full - p["z_bar"]) ** 2)
        obj = obj + self.elastic_w * torch.sum(e)
        if self.local_prox:
            obj = obj + p["prox_tau"] / 2 * torch.sum((x - p["x_prev"]) ** 2)
        return obj

    def _local_ce(self, x, p):
        """Init + dynamics + (5b) pairing equalities per neighbour slot
        (ref ``local_generate_constrain`` ``optimizer.py:84-124``)."""
        xs, us, lam, _ = self._loc_split(x)
        dyn = _dyn_residual(xs, us, p["init_state"], self.vcfg)
        a_self, _ = halfspaces(xs[1:], self.vcfg,
                               self.ocfg.use_delay_tightening)
        at_l = torch.einsum('tij,kti->ktj', a_self, lam)        # [K, N-1, 2]
        other = torch.einsum('ktij,kti->ktj', p["other_a"], p["other_lij"])
        pairing = p["mask"][:, None, None] * (at_l + other)
        return torch.cat([dyn, pairing.reshape(-1)])

    def _local_ci(self, x, p):
        """(5a) separation (elastic) per slot, (4c) dual norm, lambda >= 0,
        e >= 0, boxes. Masked-out slots get trivially satisfied rows."""
        xs, us, lam, e = self._loc_split(x)
        a_self, b_self = halfspaces(xs[1:], self.vcfg,
                                    self.ocfg.use_delay_tightening)
        sep = (-torch.einsum('ti,kti->kt', b_self, lam)
               - torch.einsum('kti,kti->kt', p["other_b"], p["other_lij"])
               - self.ocfg.min_dis + e)
        sep = p["mask"][:, None] * sep + (1.0 - p["mask"][:, None])
        at_l = torch.einsum('tij,kti->ktj', a_self, lam)
        nrm = 1.0 - torch.sum(at_l ** 2, dim=-1)                # [K, N-1]
        boxes = _box_residuals(xs, us, self._box)
        return torch.cat([sep.reshape(-1), nrm.reshape(-1),
                          lam.reshape(-1), e.reshape(-1), boxes])

    # staged local form: stage k = 0..N-2 holds w_k = [x_{k+1} (5) | u_k (2)
    # | lam[:, k, :] (4K) | e[:, k] (K)]; dynamics are the only coupling rows

    def _loc_stage_split(self, w):
        k = self.K
        return w[:5], w[5:7], w[7:7 + 4 * k].reshape(k, 4), w[7 + 4 * k:]

    def _loc_to_staged(self, x):
        """[V, nx] -> [V, N-1, b_loc]."""
        xs, us, lam, e = self._loc_split(x)
        v, t = x.shape[0], self.ocfg.horizon - 1
        return torch.cat([xs[:, 1:], us,
                          lam.movedim(2, 1).reshape(v, t, 4 * self.K),
                          e.transpose(1, 2)], dim=-1)

    def _loc_from_staged(self, w, init_state):
        """[V, N-1, b_loc], init [V, 5] -> [V, nx]."""
        v, t, k = w.shape[0], w.shape[1], self.K
        xs = torch.cat([init_state[:, None], w[..., :5]], dim=1)
        us = w[..., 5:7]
        lam = w[..., 7:7 + 4 * k].reshape(v, t, k, 4).movedim(1, 2)
        e = w[..., 7 + 4 * k:].transpose(1, 2)
        return torch.cat([xs.reshape(v, -1), us.reshape(v, -1),
                          lam.reshape(v, -1), e.reshape(v, -1)], dim=-1)

    def _loc_stage_f(self, w, pk):
        xs, us, lam, e = self._loc_stage_split(w)
        obj = (self.ocfg.r_ctrl * torch.sum(us ** 2)
               + self.ocfg.q_state * torch.sum((xs - pk["ref"]) ** 2))
        s_full = torch.cat([xs, lam.reshape(-1)])
        obj = obj + pk["lamb_bar"] @ s_full
        obj = obj + pk["rho"] / 2 * torch.sum((s_full - pk["z_bar"]) ** 2)
        obj = obj + self.elastic_w * torch.sum(e)
        if self.local_prox:
            obj = obj + pk["prox_tau"] / 2 * torch.sum((w - pk["w_prev"]) ** 2)
        return obj

    def _loc_stage_ce_link(self, w_prev, w, pk):
        xs, us, _, _ = self._loc_stage_split(w)
        xp = torch.where(pk["first"] > 0, pk["init"], w_prev[:5])
        return xs - (xp + self.vcfg.dt * bicycle_rhs(xp, us, self.vcfg))

    def _loc_stage_ce(self, w, pk):
        xs, _, lam, _ = self._loc_stage_split(w)
        a_self, _ = halfspaces(xs, self.vcfg, self.ocfg.use_delay_tightening)
        at_l = torch.einsum('ij,ki->kj', a_self, lam)             # [K, 2]
        other = torch.einsum('kij,ki->kj', pk["other_a"], pk["other_lij"])
        return (pk["mask"][:, None] * (at_l + other)).reshape(-1)

    def _loc_stage_ci(self, w, pk):
        xs, us, lam, e = self._loc_stage_split(w)
        a_self, b_self = halfspaces(xs, self.vcfg,
                                    self.ocfg.use_delay_tightening)
        sep = (-torch.einsum('i,ki->k', b_self, lam)
               - torch.einsum('ki,ki->k', pk["other_b"], pk["other_lij"])
               - self.ocfg.min_dis + e)
        sep = pk["mask"] * sep + (1.0 - pk["mask"])
        at_l = torch.einsum('ij,ki->kj', a_self, lam)
        nrm = 1.0 - torch.sum(at_l ** 2, dim=-1)
        boxes = _box_residuals(xs, us, self._box)
        return torch.cat([sep, nrm, lam.reshape(-1), e, boxes])

    def _neighbour_data(self, bs: BarState):
        """What each vehicle reads of its neighbours (ref optimizer.py:
        107-118): halfspaces [V, K, N-1, 4, 2], [V, K, N-1, 4] and the
        neighbours' duals against it [V, K, N-1, 4]."""
        return (bs.a_mat[self._nbr], bs.b[self._nbr],
                bs.lamb_ij[self._nbr, self._rev])

    def _local_staged_params(self, bs: BarState, init_state, ref_win, rho,
                             mask_veh):
        """Per-(vehicle, stage) parameters ``[V, N-1, ...]`` of the staged
        local solves."""
        v, t = self.num_veh, self.ocfg.horizon - 1
        other_a, other_b, other_lij = self._neighbour_data(bs)
        first = torch.zeros((t,), dtype=self.dtype, device=self.device)
        first[0] = 1.0
        return dict(
            first=first.expand(v, t),
            init=init_state[:, None, :].expand(v, t, 5),
            ref=ref_win[:, 1:, :],
            z_bar=bs.z_bar,
            lamb_bar=bs.lamb_bar,
            other_a=other_a.movedim(2, 1),                  # [V, T, K, 4, 2]
            other_b=other_b.movedim(2, 1),
            other_lij=other_lij.movedim(2, 1),
            mask=mask_veh[:, None, :].expand(v, t, self.K),
            rho=rho.expand(v, t))

    def _local_warm(self, ref_win, bs: BarState, mask_veh):
        """All-vehicle reference warm start ``[V, nx]`` (states = ref
        window, u = 0, lambda = 1 as in ``local_initialize``
        ``optimizer.py:50-55``) plus elastic slacks set to the actual
        separation violation — the separation rows of the JAX
        ``_local_ci`` at that point — so the start point is feasible."""
        s = self._loc_sizes
        v = self.num_veh
        _, other_b, other_lij = self._neighbour_data(bs)
        x0 = torch.cat([
            ref_win.reshape(v, -1),
            torch.zeros((v, s["u"]), dtype=self.dtype, device=self.device),
            torch.ones((v, s["lam"]), dtype=self.dtype, device=self.device),
            torch.zeros((v, s["e"]), dtype=self.dtype, device=self.device)],
            dim=-1)
        xs, _, lam, e = self._loc_split(x0)
        _, b_self = halfspaces(xs[:, 1:], self.vcfg,
                               self.ocfg.use_delay_tightening)
        sep = (-torch.einsum('vti,vkti->vkt', b_self, lam)
               - torch.einsum('vkti,vkti->vkt', other_b, other_lij)
               - self.ocfg.min_dis + e)
        m = mask_veh[:, :, None]
        sep = m * sep + (1.0 - m)
        e_warm = torch.clamp(-sep, min=0.0) + 0.01
        return torch.cat([x0[:, :-s["e"]], e_warm.reshape(v, -1)], dim=-1)

    def _local_params(self, bs: BarState, init_state, ref_win, rho, mask_veh):
        """Per-vehicle parameters ``[V, ...]`` of the dense local NLPs (and
        of :meth:`_local_warm_one`): the JAX ``_local_params``."""
        other_a, other_b, other_lij = self._neighbour_data(bs)
        return dict(init_state=init_state, ref_win=ref_win, other_a=other_a,
                    other_b=other_b, other_lij=other_lij, z_bar=bs.z_bar,
                    lamb_bar=bs.lamb_bar, mask=mask_veh,
                    rho=rho.expand(self.num_veh))

    def _local_warm_one(self, ref_i, p_i):
        """One vehicle's reference warm start ``[nx]`` from its slice of
        :meth:`_local_params`, as the JAX ``_local_warm_one`` builds it:
        the slacks from the separation rows of :meth:`_local_ci`. The same
        point as :meth:`_local_warm`; the batched step maps this one over
        its lanes, as the JAX batched step does."""
        s = self._loc_sizes
        kw = dict(dtype=self.dtype, device=self.device)
        x0 = torch.cat([ref_i.reshape(-1), torch.zeros((s["u"],), **kw),
                        torch.ones((s["lam"],), **kw),
                        torch.zeros((s["e"],), **kw)])
        sep = self._local_ci(x0, p_i)[:s["e"]]
        return torch.cat([x0[:-s["e"]], torch.clamp(-sep, min=0.0) + 0.01])

    # -- edge problem (ref optimizer.py:239-328) ---------------------------

    def _edge_lam(self, z):
        """Per-vehicle per-slot duals from the consensus row: [V, K, N-1, 4]."""
        n = self.ocfg.horizon
        lam = z[:, :, 5:].reshape(self.num_veh, n - 1, self.K, 4)
        return lam.movedim(1, 2)

    def _edge_lam_t(self, z):
        """[V, F] one-step consensus row -> [V, K, 4] duals."""
        return z[:, 5:].reshape(self.num_veh, self.K, 4)

    # joint edge (edge_mode="joint"): one NLP over Z [V, N-1, F] flattened

    def _edge_split(self, x):
        return x.reshape(self.num_veh, self.ocfg.horizon - 1, self.N_FULL)

    def _edge_obj(self, x, p):
        """obj = -sum_i Z_i lamb_bar_i + rho/2 sum_i ||local_fullx_i - Z_i||^2
        (ref ``edge_generate_object`` ``optimizer.py:297-307``)."""
        z = self._edge_split(x)
        obj = (-torch.sum(z * p["lamb_bar"])
               + p["rho"] / 2 * torch.sum((p["local_fullx"] - z) ** 2))
        return self._edge_options(obj, z, p)

    def _edge_ce(self, x, p):
        """(6b): A(z_i)^T l_i^(j) + A(z_j)^T l_j^(i) = 0 per unordered pair
        (ref ``edge_generate_constrain`` ``optimizer.py:259-279``)."""
        z = self._edge_split(x)
        a_mat, _ = halfspaces(z[:, :, :5], self.vcfg,
                              self.ocfg.use_delay_tightening)
        at_l = torch.einsum('vtij,vkti->vktj', a_mat, self._edge_lam(z))
        rows = (at_l[self.idx_i, self._slot_i]
                + at_l[self.idx_j, self._slot_j])              # [P, N-1, 2]
        return (p["pair_mask"][:, None, None] * rows).reshape(-1)

    def _edge_ci(self, x, p):
        """(6c) separation >= min_dis per pair (hard); (4c) dual-norm bound
        at 0.95; z-state box; lambda >= 0."""
        z = self._edge_split(x)
        a_mat, b = halfspaces(z[:, :, :5], self.vcfg,
                              self.ocfg.use_delay_tightening)
        lam = self._edge_lam(z)
        bl = torch.einsum('vti,vkti->vkt', b, lam)             # [V, K, N-1]
        sep = (-bl[self.idx_i, self._slot_i]
               - bl[self.idx_j, self._slot_j] - self.ocfg.min_dis)
        sep = (p["pair_mask"][:, None] * sep
               + (1.0 - p["pair_mask"][:, None]))
        at_l = torch.einsum('vtij,vkti->vktj', a_mat, lam)
        nrm = self.cert_norm_bound ** 2 - torch.sum(at_l ** 2, dim=-1)
        zs = z[:, :, :5]
        box = torch.cat([(zs + 1000.0).reshape(-1),
                         (1000.0 - zs).reshape(-1)])
        return torch.cat([sep.reshape(-1), nrm.reshape(-1),
                          z[:, :, 5:].reshape(-1), box])

    # per-step edge: one horizon step's Z [V, F] flattened. The edge problem
    # has no temporal coupling, so edge_mode="per_step" solves these as
    # independent dense NLPs and the default "staged" as the stages of one
    # staged NLP with NO link rows (block-diagonal KKT, one shared line
    # search)

    def _edge_obj_t(self, w, pk):
        z = w.reshape(self.num_veh, self.N_FULL)
        obj = (-torch.sum(z * pk["lamb_bar"])
               + pk["rho"] / 2 * torch.sum((pk["local_fullx"] - z) ** 2))
        return self._edge_options(obj, z, pk)

    def _edge_options(self, obj, z, p):
        """``obj`` plus the optional edge terms (JAX ``obca.py:799-804``) of
        ``z [V, (N-1,) F]``: the proximal ``edge_prox/2 ||z - z_prev||^2``
        and the branch commitment ``commit_w sum relu(-<d, d_bar>)^2`` on
        the pair offsets ``d = z_i - z_j`` (positions)."""
        if self.edge_prox:
            obj = obj + self.edge_prox / 2 * torch.sum((z - p["z_prev"]) ** 2)
        if self.branch_commit:
            d = z[self.idx_i, ..., :2] - z[self.idx_j, ..., :2]
            dot = torch.sum(d * p["d_bar"], dim=-1)
            obj = obj + self.commit_w * torch.sum(torch.relu(-dot) ** 2)
        return obj

    def _edge_stage_ce_link(self, w_prev, w, pk):
        return torch.zeros((0,), dtype=w.dtype, device=w.device)

    def _edge_ce_t(self, w, pk):
        z = w.reshape(self.num_veh, self.N_FULL)
        a_mat, _ = halfspaces(z[:, :5], self.vcfg,
                              self.ocfg.use_delay_tightening)
        at_l = torch.einsum('vij,vki->vkj', a_mat, self._edge_lam_t(z))
        rows = (at_l[self.idx_i, self._slot_i]
                + at_l[self.idx_j, self._slot_j])               # [P, 2]
        return (pk["pair_mask"][:, None] * rows).reshape(-1)

    def _edge_ci_t(self, w, pk):
        z = w.reshape(self.num_veh, self.N_FULL)
        a_mat, b = halfspaces(z[:, :5], self.vcfg,
                              self.ocfg.use_delay_tightening)
        lam = self._edge_lam_t(z)
        bl = torch.einsum('vi,vki->vk', b, lam)
        sep = (-bl[self.idx_i, self._slot_i]
               - bl[self.idx_j, self._slot_j] - self.ocfg.min_dis)
        sep = pk["pair_mask"] * sep + (1.0 - pk["pair_mask"])
        at_l = torch.einsum('vij,vki->vkj', a_mat, lam)
        nrm = self.cert_norm_bound ** 2 - torch.sum(at_l ** 2, dim=-1)
        zs = z[:, :5]
        box = torch.cat([(zs + 1000.0).reshape(-1),
                         (1000.0 - zs).reshape(-1)])
        return torch.cat([sep, nrm.reshape(-1), z[:, 5:].reshape(-1), box])

    # -- bar-state plumbing ----------------------------------------------

    def _facing_certificates(self, ref0):
        """Unit-weight facing-face separating duals per (vehicle, slot):
        [V, K, N-1, 4], scaled to norm 0.95 (see ``create_bar_state``)."""
        a0, _ = halfspaces(ref0, self.vcfg, self.ocfg.use_delay_tightening)
        pos = ref0[:, :, :2]                                   # [V, N-1, 2]
        c_dir = pos[self._nbr] - pos[:, None]                  # [V, K, N-1, 2]
        c_dir = c_dir / torch.clamp(
            torch.linalg.norm(c_dir, dim=-1, keepdim=True), min=1e-9)
        align = torch.einsum('vtij,vktj->vkti', a0, c_dir)     # [V, K, N-1, 4]
        # torch.argmax returns the first maximal index on ties, as JAX does
        face = torch.nn.functional.one_hot(torch.argmax(align, dim=-1), 4)
        return self.cert_norm_bound * face.to(self.dtype)

    def _zip_z(self, local_x, lamb_ij):
        """Pack (states [V, N-1, 5], duals [V, K, N-1, 4]) into Z [V, N-1, F]."""
        v, t = local_x.shape[0], local_x.shape[1]
        lam_flat = lamb_ij.movedim(1, 2).reshape(v, t, 4 * self.K)
        return torch.cat([local_x, lam_flat], dim=-1)

    def create_bar_state(self) -> BarState:
        """Initial exchange state, seeded from the reference-trajectory
        window so the first local NLP is well-posed (the JAX version's
        documented deviation from the reference's zero A/b)."""
        v, n = self.num_veh, self.ocfg.horizon
        ref0 = self.refs[:, 1:n, :]                      # [V, N-1, 5]
        a0, b0 = halfspaces(ref0, self.vcfg, self.ocfg.use_delay_tightening)
        if self.lamb_ij_mode == "track_edge":
            lamb_ij = self._facing_certificates(ref0)
        elif v == 2 and n == 8:
            lamb_ij = self._t(_LAMB_IJ_TABLE)[:, None]
        else:
            lamb_ij = 1e-3 * torch.ones((v, self.K, n - 1, 4),
                                        dtype=self.dtype, device=self.device)
        return BarState(
            z_bar=self._zip_z(ref0, lamb_ij), a_mat=a0, b=b0,
            lamb_bar=1e-3 * torch.ones((v, n - 1, self.N_FULL),
                                       dtype=self.dtype, device=self.device),
            lamb_ij=lamb_ij, local_x=ref0)

    def shift_bar_state(self, bs: BarState, batch_dims: int = 0) -> BarState:
        """Horizon warm-start shift (ref ``iterate_next_state``
        ``optimizer.py:337-344``): drop step 0, duplicate the tail.
        ``batch_dims`` extra leading axes (the batched step's scenario lanes)
        offset the shift axis."""
        def shift(a, axis):
            axis += batch_dims
            return torch.cat([a.narrow(axis, 1, a.shape[axis] - 1),
                              a.narrow(axis, a.shape[axis] - 1, 1)], dim=axis)
        return BarState(
            z_bar=shift(bs.z_bar, 1), a_mat=shift(bs.a_mat, 1),
            b=shift(bs.b, 1), lamb_bar=shift(bs.lamb_bar, 1),
            lamb_ij=shift(bs.lamb_ij, 2), local_x=shift(bs.local_x, 1))

    def _pair_proximity_mask(self, local_x):
        """[P] activity mask: pair within ``gate_thres`` anywhere in horizon."""
        if not self.gate_pairs:
            return torch.ones((len(self.idx_i),), dtype=self.dtype,
                              device=self.device)
        pos = local_x[:, :, :2]
        d2 = torch.sum((pos[self.idx_i] - pos[self.idx_j]) ** 2, dim=-1)
        return torch.any(d2 < self.gate_thres ** 2, dim=-1).to(self.dtype)

    def check_converge(self, bs: BarState, thres: float = 0.1):
        """Coupled-constraint satisfaction on the exchanged solution
        (ref ``check_converge`` ``optimizer.py:225-235``), all pairs; a
        0-dim bool tensor on the planner's device."""
        at_l = torch.einsum('vtij,vkti->vktj', bs.a_mat, bs.lamb_ij)
        eq = (at_l[self.idx_i, self._slot_i]
              + at_l[self.idx_j, self._slot_j])                # [P, N-1, 2]
        bl = torch.einsum('vti,vkti->vkt', bs.b, bs.lamb_ij)
        sep = (-bl[self.idx_i, self._slot_i]
               - bl[self.idx_j, self._slot_j])                 # [P, N-1]
        return torch.logical_and(torch.all(torch.abs(eq) <= thres),
                                 torch.all(sep >= self.ocfg.min_dis))

    # -- one MPC step -----------------------------------------------------

    def _prox_tau(self, it: int) -> float:
        """Annealed local prox weight of ADMM iteration ``it``, grown and
        clamped in the planner's dtype as the JAX planner does."""
        if it < self.prox_after:
            return 0.0
        grown = self.local_prox * torch.tensor(
            self.prox_growth, dtype=self.dtype) ** (it - self.prox_after)
        return min(float(grown), self.prox_tau_max)

    def _prox_taus(self) -> torch.Tensor:
        """:meth:`_prox_tau` of every ADMM iteration ``[max_admm_iters]`` on
        the planner's device: the batched step's lanes look their weight up
        here, so each lane gets the single planner's value bit for bit."""
        return torch.tensor([self._prox_tau(k)
                             for k in range(self.ocfg.max_admm_iters)],
                            dtype=self.dtype, device=self.device)

    def _local_lane_params(self, bs: BarState, init_state, ref_win, rho,
                           mask_veh):
        """The local solves' parameters ``[V, ...]`` in the mode's form:
        per (vehicle, stage) for the staged solver, per vehicle for the
        dense one."""
        build = (self._local_staged_params if self.use_staged
                 else self._local_params)
        return build(bs, init_state, ref_win, rho, mask_veh)

    def _solve_locals(self, x0, x_prev, init_state, p, prox_tau):
        """The local NLPs of L lanes (the vehicles of one scenario, or of
        several) in one solve: ``x0``, ``x_prev [L, nx]``, ``init_state
        [L, 5]``, ``p`` from :meth:`_local_lane_params` with L leading;
        ``prox_tau`` a number or one weight per lane ``[L]``. Returns the
        solutions ``[L, nx]`` and the solver's record."""
        n_l, t = x0.shape[0], self.ocfg.horizon - 1
        if self.local_prox:
            if torch.is_tensor(prox_tau):
                tau = prox_tau[:, None].expand(n_l, t)
            else:
                tau = torch.full((n_l, t), prox_tau, dtype=self.dtype,
                                 device=self.device)
        if not self.use_staged:
            if self.local_prox:
                p = dict(p, x_prev=x_prev, prox_tau=tau[:, 0])
            lsol = solve_nlp_batch(self._local_nlp, x0, p, self.scfg)
            return lsol.x, lsol
        if self.local_prox:
            p = dict(p, w_prev=self._loc_to_staged(x_prev), prox_tau=tau)
        lsol = solve_staged(self._local_staged, self._loc_to_staged(x0), p,
                            self.scfg)
        self.block_solves += lsol.block_solves
        return self._loc_from_staged(lsol.w, init_state), lsol

    def _solve_edges(self, z_bar, local_fullx, lamb_bar, pair_mask, rho,
                     d_bar=None):
        """The edge consensus NLPs of S lanes (scenarios) in one solve, in
        the ``edge_mode``'s form, warm-started at the previous consensus
        iterate: ``z_bar``, ``local_fullx``, ``lamb_bar [S, V, N-1, F]``,
        ``pair_mask [S, P]``; with ``branch_commit`` the frozen sides
        ``d_bar [S, P, N-1, 2]``. Returns ``z_bar [S, V, N-1, F]`` and the
        solver's record."""
        s, v, t, f = z_bar.shape
        opts = {}
        if self.edge_prox:
            opts["z_prev"] = z_bar              # the previous iterate
        if self.branch_commit:
            opts["d_bar"] = d_bar
        if self.edge_mode == "joint":
            pe = dict(lamb_bar=lamb_bar, local_fullx=local_fullx,
                      rho=rho.expand(s), pair_mask=pair_mask, **opts)
            esol = solve_nlp_batch(self._edge_nlp, z_bar.reshape(s, -1), pe,
                                   self.scfg)
            return esol.x.reshape(s, v, t, f), esol
        pe = dict(lamb_bar=lamb_bar.movedim(2, 1),
                  local_fullx=local_fullx.movedim(2, 1),
                  rho=rho.expand(s, t),
                  pair_mask=pair_mask[:, None].expand(
                      (s, t) + pair_mask.shape[1:]),
                  **{k: a.movedim(2, 1) for k, a in opts.items()})
        z0 = z_bar.movedim(2, 1).reshape(s, t, v * f)
        if self.edge_mode == "staged":
            # one lane per scenario whose stages are the horizon steps
            esol = solve_staged(self._edge_staged, z0, pe, self.scfg)
            self.block_solves += esol.block_solves
            z_t = esol.w
        else:
            # per_step: every (scenario, step) an NLP of its own
            esol = solve_nlp_batch(
                self._edge_nlp_t, z0.reshape(s * t, v * f),
                {k: a.reshape((s * t,) + a.shape[2:]) for k, a in pe.items()},
                self.scfg)
            z_t = esol.x
        return z_t.reshape(s, t, v, f).movedim(1, 2), esol

    def _admm_iteration(self, c: dict, it: int, init_state, ref_win, rho):
        """One ADMM iteration: local NLPs -> bar-state broadcast -> edge
        NLP -> certificate exchange -> dual update."""
        ocfg = self.ocfg
        bs = c["bs"]
        pair_mask = self._pair_proximity_mask(bs.local_x)
        mask_veh = pair_mask[self._pair_id]                    # [V, K]
        prox_tau = (c["prox_tau"].expand(self.num_veh) if self.prox_adaptive
                    else self._prox_tau(it))
        if self.local_warm_mode == "previous":
            x0 = c["loc_x"]
        else:
            # reference semantics: re-initialize from the reference
            # trajectory every iteration (local_initialize :50-55)
            x0 = self._local_warm(ref_win, bs, mask_veh)
        loc_x, lsol = self._solve_locals(
            x0, c["loc_x"], init_state,
            self._local_lane_params(bs, init_state, ref_win, rho, mask_veh),
            prox_tau)
        xs, us, lam, _ = self._loc_split(loc_x)
        # bar_state_update (ref optimizer.py:205-222)
        a_new, b_new = halfspaces(xs[:, 1:, :], self.vcfg,
                                  ocfg.use_delay_tightening)
        lamb_ij = lam if self.lamb_ij_mode == "track_local" else bs.lamb_ij
        bs = bs._replace(a_mat=a_new, b=b_new, local_x=xs[:, 1:, :],
                         lamb_ij=lamb_ij)
        local_fullx = self._zip_z(bs.local_x, bs.lamb_ij)
        z_bar, esol = self._solve_edges(bs.z_bar[None], local_fullx[None],
                                        bs.lamb_bar[None], pair_mask[None],
                                        rho, c["d_bar"][None])
        z_bar = z_bar[0]
        bs = bs._replace(z_bar=z_bar)
        d_bar = c["d_bar"]
        if self.branch_commit and it + 1 == self.commit_after:
            # freeze the pass side (JAX obca.py:1231-1254): the lateral axis
            # is the lower-index vehicle's heading normal, one side per pair
            # from the horizon sum of the lateral gaps, an exact tie +1
            th_i = z_bar[self.idx_i, :, 3]                     # [P, N-1]
            lat = torch.stack([-torch.sin(th_i), torch.cos(th_i)], dim=-1)
            d_now = z_bar[self.idx_i, :, :2] - z_bar[self.idx_j, :, :2]
            side = torch.sum(torch.sum(d_now * lat, dim=-1), dim=-1)
            sign = torch.where(side >= 0.0, 1.0, -1.0).to(self.dtype)
            d_bar = sign[:, None, None] * lat
        if self.lamb_ij_mode == "track_edge":
            # neighbours plan against the (relaxed) consensus certificates
            th = self.lamb_ij_relax
            if self.lamb_ij_hysteresis:
                # hold them while the primal residual rises
                th = torch.where(c["primal"] > c["primal_prev"], 0.0,
                                 torch.tensor(th, dtype=self.dtype,
                                              device=self.device))
            bs = bs._replace(lamb_ij=th * self._edge_lam(z_bar)
                             + (1.0 - th) * bs.lamb_ij)
        # dual update on lamb_bar: consensus error r = local_fullx - z_bar
        pos = bs.local_x[:, :, :2]
        d_min = torch.min(torch.linalg.norm(
            pos[self.idx_i] - pos[self.idx_j], dim=-1))
        cons_err = local_fullx - z_bar
        dual_rho = ocfg.rho if ocfg.dual_rho is None else ocfg.dual_rho
        dual_new = update_dual(
            DualState(dual=bs.lamb_bar, sum_err=c["sum_err"],
                      diff_val=c["diff_val"],
                      rho=torch.tensor(dual_rho, dtype=self.dtype,
                                       device=self.device)),
            cons_err, d_min, self.dual_cfg)
        bs = bs._replace(lamb_bar=dual_new.dual)
        # the actual consensus gap ||local - z||_1 beside the change-based
        # residuals of the reference (driver :82-90)
        gap = torch.sum(torch.abs(cons_err))
        primal = torch.sum(torch.abs(us - c["us_prev"]))
        dual = (torch.sum(torch.abs(bs.lamb_bar - c["lamb_prev"]))
                / torch.clamp(dual_new.rho, min=1.0))
        t_scale = (self.num_veh / 2.0) if ocfg.thres_per_veh else 1.0
        done = torch.logical_and(primal <= ocfg.primal_thres * t_scale,
                                 dual <= ocfg.dual_thres * t_scale)
        nlp_ok = torch.stack([torch.mean(lsol.converged.to(self.dtype)),
                              torch.mean(esol.converged.to(self.dtype))])
        nlp_kkt = torch.stack([torch.max(lsol.kkt_error),
                               torch.max(esol.kkt_error)])
        if self.prox_adaptive:
            # grow tau where the primal residual rose
            tau_next = torch.clamp(torch.where(
                primal > c["primal"], c["prox_tau"] * self.prox_growth,
                c["prox_tau"]), max=self.prox_tau_max)
        else:
            # the carry holds this iteration's weight, as JAX's does
            tau_next = torch.tensor(prox_tau, dtype=self.dtype,
                                    device=self.device)
        return dict(bs=bs, us_prev=us, lamb_prev=bs.lamb_bar, xs=xs,
                    loc_x=loc_x, nlp_ok=nlp_ok, nlp_kkt=nlp_kkt,
                    sum_err=dual_new.sum_err, diff_val=dual_new.diff_val,
                    done=done, primal=primal, dual=dual, gap=gap,
                    primal_prev=c["primal"], d_bar=d_bar, prox_tau=tau_next)

    def _admm_start(self, bar_state_prev: BarState, step_idx: int):
        """``(carry, ref_win, rho)`` at the start of one MPC step's ADMM
        loop (the JAX ``_admm_parts``' ``c0``)."""
        v, n = self.num_veh, self.ocfg.horizon
        ref_win = self._ref_window(step_idx)                   # [V, N, 5]
        kw = dict(dtype=self.dtype, device=self.device)
        rho = torch.tensor(self.ocfg.rho, **kw)
        inf = torch.tensor(math.inf, **kw)
        zeros_f = torch.zeros((v, n - 1, self.N_FULL), **kw)
        mask0 = self._pair_proximity_mask(bar_state_prev.local_x)[
            self._pair_id]
        c = dict(bs=bar_state_prev, us_prev=torch.zeros((v, n - 1, 2), **kw),
                 lamb_prev=bar_state_prev.lamb_bar, xs=ref_win,
                 loc_x=self._local_warm(ref_win, bar_state_prev, mask0),
                 sum_err=zeros_f, diff_val=zeros_f,
                 nlp_ok=torch.ones((2,), **kw),
                 nlp_kkt=torch.zeros((2,), **kw),
                 primal=inf, dual=inf, gap=inf, primal_prev=inf,
                 d_bar=torch.zeros((len(self.idx_i), n - 1, 2), **kw),
                 prox_tau=torch.tensor(self.local_prox, **kw))
        return c, ref_win, rho

    def _mpc_step(self, init_state, bar_state_prev: BarState, step_idx: int):
        """One MPC step: the ADMM loop until both residuals are under their
        thresholds or ``max_admm_iters`` is reached, then the MPC advance.

        Returns ``(next_state [V, 5], shifted BarState, iterations (int),
        primal, dual, converged_flag, nlp_ok [2], nlp_kkt [2], gap)``; every
        tensor stays on the planner's device.
        """
        c, ref_win, rho = self._admm_start(bar_state_prev, step_idx)
        it = 0
        while it < self.ocfg.max_admm_iters:
            c = self._admm_iteration(c, it, init_state, ref_win, rho)
            it += 1
            if bool(c["done"]):           # the one host read per iteration
                break
        # MPC advance from the converged/capped carry (driver :99-102)
        next_state = c["xs"][:, 1, :]
        converged_flag = self.check_converge(c["bs"])
        bs = c["bs"]
        if self.lamb_bar_decay != 1.0:
            bs = bs._replace(lamb_bar=self.lamb_bar_decay * bs.lamb_bar)
        return (next_state, self.shift_bar_state(bs), it, c["primal"],
                c["dual"], converged_flag, c["nlp_ok"], c["nlp_kkt"], c["gap"])

    def mpc_step_trace(self, init_state, bar_state_prev: BarState, step_idx,
                       n_iters: int):
        """Run EXACTLY ``n_iters`` ADMM iterations of one MPC step (no early
        exit) and return the final carry (a dict, ``it`` included) and the
        per-iteration history ``dict(primal, dual, gap, nlp_ok [n, 2],
        nlp_kkt [n, 2], zy_gap, d_nrm)`` with a leading axis ``[n_iters]``:
        the JAX ``mpc_step_trace``, the tool for watching the
        conflict-window limit cycle. ``zy_gap`` is the mean lateral gap of
        the two vehicles' consensus rows (0 for V != 2), ``d_nrm`` the mean
        norm of the first vehicle of each pair's certificate image
        ``A(z)^T lambda``."""
        c, ref_win, rho = self._admm_start(bar_state_prev, step_idx)
        keys = ("primal", "dual", "gap", "nlp_ok", "nlp_kkt", "zy_gap",
                "d_nrm")
        hist = {k: [] for k in keys}
        for it in range(n_iters):
            c = self._admm_iteration(c, it, init_state, ref_win, rho)
            z = c["bs"].z_bar
            a_e, _ = halfspaces(z[:, :, :5], self.vcfg,
                                self.ocfg.use_delay_tightening)
            at_le = torch.einsum('vtij,vkti->vktj', a_e, self._edge_lam(z))
            d_now = at_le[self.idx_i, self._slot_i]
            zy = z[:, :, 1]                              # consensus y
            rec = dict(primal=c["primal"], dual=c["dual"], gap=c["gap"],
                       nlp_ok=c["nlp_ok"], nlp_kkt=c["nlp_kkt"],
                       zy_gap=(torch.mean(zy[0] - zy[1]) if self.num_veh == 2
                               else torch.zeros((), dtype=self.dtype,
                                                device=self.device)),
                       d_nrm=torch.mean(torch.linalg.norm(d_now, dim=-1)))
            for k in keys:
                hist[k].append(rec[k])
        c["it"] = torch.tensor(n_iters, dtype=torch.int32, device=self.device)
        return c, {k: torch.stack(a) if a else torch.zeros(
            (0,), dtype=self.dtype, device=self.device)
            for k, a in hist.items()}

    def run_scan(self, n_steps: Optional[int] = None,
                 return_health: bool = False):
        """Whole MPC run with the (state, BarState) carry on the device;
        returns host arrays ``(states [n+1, V, 5], iters [n], primal [n],
        dual [n], conv [n])``, plus ``(nlp_ok [n, 2], nlp_kkt [n, 2],
        gap [n])`` when ``return_health`` — the JAX ``run_scan``'s outputs."""
        n_steps = self._n_steps(n_steps)
        st = self.refs[:, 0, :]
        bs = self.create_bar_state()
        rows = []
        for k in range(n_steps):
            st, bs, it, pr, du, cv, ok, kkt, gap = self._mpc_step(st, bs, k)
            rows.append((st, it, pr, du, cv, ok, kkt, gap))
        self.carry = (st, bs)
        states = torch.stack([self.refs[:, 0, :]] + [r[0] for r in rows])
        host = [torch.stack([r[i] for r in rows]).cpu().numpy() if rows
                else np.zeros((0,)) for i in (2, 3, 4, 5, 6, 7)]
        its = np.asarray([r[1] for r in rows], dtype=np.int32)
        out = (states.cpu().numpy(), its, host[0], host[1], host[2])
        if return_health:
            out += (host[3], host[4], host[5])
        return out

    def run(self, n_steps: Optional[int] = None, step_timer=None,
            checkpoint_path: Optional[str] = None, resume: bool = False):
        """MPC loop returning ``(states, iters, residuals, flags)`` as the
        JAX ``run`` does; each residual row is ``(primal, dual,
        loc_conv_frac, edge_conv_frac, loc_kkt_max, edge_kkt_max, gap)``:
        the JAX row plus the actual consensus gap ``||local - z||_1``.

        ``step_timer``, a context-manager factory such as
        ``RunMetrics.step_timer``, wraps each step (its host reads included,
        so the time covers the device work). ``checkpoint_path`` saves the
        ``(init_state, BarState)`` carry after every step; ``resume=True``
        continues a saved run from its last completed step (the records of
        the completed steps are not replayed), on this planner's device.
        """
        timer = step_timer or contextlib.nullcontext
        n_steps = self._n_steps(n_steps)
        init_state = self.refs[:, 0, :]
        bs = self.create_bar_state()
        (init_state, bs), start = resume_carry(checkpoint_path, resume,
                                               (init_state, bs))
        states = [init_state.cpu().numpy()]
        iters, residuals, flags = [], [], []
        for t in range(start, n_steps):
            with timer():
                (init_state, bs, it, pr, du, cv, nlp_ok, nlp_kkt,
                 gap) = self._mpc_step(init_state, bs, t)
                states.append(init_state.cpu().numpy())
            iters.append(int(it))
            ok, kk = nlp_ok.cpu().numpy(), nlp_kkt.cpu().numpy()
            residuals.append((float(pr), float(du), float(ok[0]),
                              float(ok[1]), float(kk[0]), float(kk[1]),
                              float(gap)))
            flags.append(bool(cv))
            if checkpoint_path is not None:
                save_carry(checkpoint_path, (init_state, bs), t + 1)
        self.carry = (init_state, bs)
        return np.stack(states), np.array(iters), residuals, flags

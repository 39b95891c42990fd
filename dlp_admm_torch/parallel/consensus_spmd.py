"""Scenario-batched consensus-ADMM MPC step of the OBCA flagship.

Port of ``dlp_admm_tpu/parallel/consensus_spmd.py`` on one device. The JAX
module runs the step under ``shard_map`` over a ``(scenario, vehicle)``
mesh; on a 1x1 mesh (``run_scenario_batch``, bench metric 3) it is one
ADMM loop whose carry has a leading scenario axis S. That is what this
module does on one CUDA card (or the CPU): every lane is one scenario,

* the local NLPs of all S·V (scenario, vehicle) pairs are ONE solve
  (staged: ``w0 [S·V, N-1, b]``, every KKT solve one block-Thomas launch
  over S·V systems; dense: S·V lanes of the dense solver);
* the edge NLPs of all S scenarios are ONE solve (staged ``[S, N-1, V·F]``;
  joint: S lanes; per_step: S·(N-1) lanes);
* the residual and gap sums, the minimum distance that feeds the dual
  update, the stop test, the annealed (or adaptive) prox weight and the
  certificate hysteresis are per lane;
* a lane that is done, or at ``max_admm_iters``, keeps being solved with
  the others but its carry is frozen (a per-leaf ``torch.where``), as a
  vmapped ``while_loop`` does; the host reads "any lane active" once per
  ADMM iteration.

Every per-iteration parameter is built with the planner's OWN methods
(``_local_params``, ``_local_staged_params``, ``_local_warm_one``,
``_zip_z``, ``_edge_lam``, ``check_converge``) mapped over the lanes with
``torch.func.vmap``, and the solves go through the planner's
``_solve_locals`` / ``_solve_edges``, so a lane equals the same scenario run
alone by construction (to rounding: the batch's reductions and library
kernels may sum in another order). Partitioning the vehicle axis over
several devices (the JAX module's ``all_gather`` / ``psum``) is not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import vmap

from ..coordination.dual_update import DualState, update_dual
from ..models.obca import BarState
from ..ops.geometry import halfspaces


def run_scenario_batch(planner, init_states, n_steps: int):
    """Scenario-batched flagship MPC run: ``init_states [S, V, 5]``, every
    lane starting from ``planner.create_bar_state()``. Returns host numpy
    arrays ``(states [n+1, S, V, 5], iters, primal, dual, conv, gap)``
    with ``[S, n]`` trailing leaves, as the JAX ``run_scenario_batch``."""
    step = make_consensus_spmd_step(planner)
    st = torch.as_tensor(np.asarray(init_states), dtype=planner.dtype,
                         device=planner.device)
    s = st.shape[0]
    bs = BarState(*(a.expand((s,) + a.shape).clone()
                    for a in planner.create_bar_state()))
    sts, rows = [st], []
    for k in range(n_steps):
        st, bs, it, pr, du, cv, gap = step(st, bs, k)
        sts.append(st)
        rows.append((it, pr, du, cv, gap))
    outs = tuple(torch.stack([r[i] for r in rows], dim=1).cpu().numpy()
                 if rows else np.zeros((s, 0)) for i in range(5))
    return (torch.stack(sts).cpu().numpy(),) + outs


def make_consensus_spmd_step(planner, mesh=None):
    """Build the scenario-batched MPC step of a ``ConsensusObcaPlanner``.

    Returns ``step(init_states [S, V, 5], bar_state, step_idx)`` with
    ``bar_state`` leaves carrying a leading scenario axis ``[S, V, ...]``;
    outputs ``(next_state [S, V, 5], bar_state, iters [S], primal [S],
    dual [S], converged [S], gap [S])`` on the planner's device. The block
    solves it makes are added to ``planner.block_solves``.

    ``mesh`` must be None: the step runs on the planner's one device.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the batched step runs on one device; partitioning the vehicle "
            "axis over devices is not ported yet (ROADMAP.md queue 1, item "
            "'parallel/mesh.py and parallel/multihost.py')")
    ocfg = planner.ocfg
    v, n = planner.num_veh, ocfg.horizon
    t, f_width = n - 1, planner.N_FULL
    kw = dict(dtype=planner.dtype, device=planner.device)
    max_it = ocfg.max_admm_iters
    rho = torch.tensor(ocfg.rho, **kw)
    rho_dual = ocfg.rho if ocfg.dual_rho is None else ocfg.dual_rho
    t_scale = (v / 2.0) if ocfg.thres_per_veh else 1.0
    taus = planner._prox_taus()                        # [max_admm_iters]
    pid, idx_i, idx_j = planner._pair_id, planner.idx_i, planner.idx_j

    # the planner's parameter methods, one lane per scenario
    lane = (0, 0, None, None, 0)          # (bs, init, ref_win, rho, mask)
    v_params = vmap(planner._local_params, in_dims=lane)
    v_lane_params = vmap(planner._local_lane_params, in_dims=lane)
    v_warm = vmap(vmap(planner._local_warm_one))
    v_mask = vmap(planner._pair_proximity_mask)
    v_zip = vmap(planner._zip_z)
    v_edge_lam = vmap(planner._edge_lam)
    v_converged = vmap(planner.check_converge)

    def flat(a):                          # [S, V, ...] -> [S·V, ...]
        return a.reshape((-1,) + a.shape[2:])

    def step(init_states, bar_state: BarState, step_idx: int):
        s = init_states.shape[0]
        ref_win = planner._ref_window(step_idx)                # [V, N, 5]
        ref_b = ref_win.expand(s, v, n, 5)
        init_flat = flat(init_states)

        def masks(bs):
            pair_mask = v_mask(bs.local_x)                     # [S, P]
            return pair_mask, pair_mask[:, pid]                # [S, V, K]

        def body(c):
            bs = c["bs"]
            active = torch.logical_and(~c["done"], c["it"] < max_it)
            pair_mask, mask_veh = masks(bs)
            if planner.prox_adaptive:
                prox_tau = c["prox_tau"]
            else:
                # the anneal of each lane's own iteration count
                prox_tau = taus[torch.clamp(c["it"], max=max_it - 1)]
            if planner.local_warm_mode == "previous":
                x0 = c["loc_x"]
            else:
                x0 = v_warm(ref_b, v_params(bs, init_states, ref_win, rho,
                                            mask_veh))
            p = v_lane_params(bs, init_states, ref_win, rho, mask_veh)
            loc_flat, _ = planner._solve_locals(
                flat(x0), flat(c["loc_x"]), init_flat,
                {k: flat(a) for k, a in p.items()},
                prox_tau.repeat_interleave(v))
            loc_x = loc_flat.reshape(s, v, -1)
            xs, us, lam, _ = planner._loc_split(loc_x)
            # bar_state_update (ref optimizer.py:205-222)
            a_new, b_new = halfspaces(xs[:, :, 1:], planner.vcfg,
                                      ocfg.use_delay_tightening)
            lamb_ij = (lam if planner.lamb_ij_mode == "track_local"
                       else bs.lamb_ij)
            bs = bs._replace(a_mat=a_new, b=b_new, local_x=xs[:, :, 1:],
                             lamb_ij=lamb_ij)
            local_fullx = v_zip(bs.local_x, bs.lamb_ij)        # [S, V, T, F]
            z_bar, _ = planner._solve_edges(bs.z_bar, local_fullx,
                                            bs.lamb_bar, pair_mask, rho)
            bs = bs._replace(z_bar=z_bar)
            if planner.lamb_ij_mode == "track_edge":
                th = planner.lamb_ij_relax
                if planner.lamb_ij_hysteresis:
                    # per lane: hold the certificates while its primal
                    # residual rises
                    th = torch.where(c["primal"] > c["primal_prev"], 0.0,
                                     torch.full((s,), th, **kw))
                    th = th[:, None, None, None, None]
                bs = bs._replace(lamb_ij=th * v_edge_lam(z_bar)
                                 + (1.0 - th) * bs.lamb_ij)
            # dual ascent; each lane's own minimum distance
            pos = bs.local_x[..., :2]
            d_min = torch.amin(torch.linalg.norm(
                pos[:, idx_i] - pos[:, idx_j], dim=-1), dim=(1, 2))  # [S]
            cons_err = local_fullx - z_bar
            dual_new = update_dual(
                DualState(dual=bs.lamb_bar, sum_err=c["sum_err"],
                          diff_val=c["diff_val"],
                          rho=torch.full((s,), rho_dual, **kw)),
                cons_err, d_min[:, None, None, None], planner.dual_cfg,
                lane_dims=1)
            bs = bs._replace(lamb_bar=dual_new.dual)
            # residuals (ref driver :82-90) and the consensus gap, per lane;
            # the dual delta normalized by the dual step size
            primal = torch.abs(us - c["us_prev"]).sum(dim=(1, 2, 3))
            dual = (torch.abs(bs.lamb_bar - c["lamb_prev"]).sum(dim=(1, 2, 3))
                    / max(rho_dual, 1.0))
            gap = torch.abs(cons_err).sum(dim=(1, 2, 3))
            lane_done = torch.logical_and(
                primal <= ocfg.primal_thres * t_scale,
                dual <= ocfg.dual_thres * t_scale)
            tau_next = prox_tau
            if planner.prox_adaptive:
                tau_next = torch.clamp(torch.where(
                    primal > c["primal"], prox_tau * planner.prox_growth,
                    prox_tau), max=planner.prox_tau_max)
            new = dict(bs=bs, us_prev=us, lamb_prev=bs.lamb_bar, xs=xs,
                       loc_x=loc_x, sum_err=dual_new.sum_err,
                       diff_val=dual_new.diff_val, it=c["it"] + 1,
                       done=torch.logical_or(c["done"], lane_done),
                       primal=primal, dual=dual, gap=gap,
                       primal_prev=c["primal"], prox_tau=tau_next)

            # lanes that were not active this iteration keep their carry
            def sel(new_leaf, old_leaf):
                act = active.reshape((s,) + (1,) * (new_leaf.dim() - 1))
                return torch.where(act, new_leaf, old_leaf)
            out = {k: sel(a, c[k]) for k, a in new.items() if k != "bs"}
            out["bs"] = BarState(*map(sel, bs, c["bs"]))
            return out

        _, mask_veh0 = masks(bar_state)
        zeros_f = torch.zeros((s, v, t, f_width), **kw)
        inf = torch.full((s,), math.inf, **kw)
        c = dict(bs=bar_state,
                 us_prev=torch.zeros((s, v, t, 2), **kw),
                 lamb_prev=bar_state.lamb_bar, xs=ref_b,
                 loc_x=v_warm(ref_b, v_params(bar_state, init_states,
                                              ref_win, rho, mask_veh0)),
                 sum_err=zeros_f, diff_val=zeros_f,
                 it=torch.zeros((s,), dtype=torch.int32,
                                device=planner.device),
                 done=torch.zeros((s,), dtype=torch.bool,
                                  device=planner.device),
                 primal=inf, primal_prev=inf, dual=inf, gap=inf,
                 prox_tau=torch.full((s,), planner.local_prox, **kw))
        # one host read per ADMM iteration: is any lane still active
        while bool(torch.logical_and(~c["done"], c["it"] < max_it).any()):
            c = body(c)
        # the convergence check on the final exchange state, BEFORE the
        # dual decay, then the MPC advance (driver :99-102)
        conv = v_converged(c["bs"])
        bs_out = c["bs"]
        if planner.lamb_bar_decay != 1.0:
            bs_out = bs_out._replace(
                lamb_bar=planner.lamb_bar_decay * bs_out.lamb_bar)
        return (c["xs"][:, :, 1], planner.shift_bar_state(bs_out,
                                                           batch_dims=1),
                c["it"], c["primal"], c["dual"], conv, c["gap"])

    return step

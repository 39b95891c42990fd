"""Scenario-batched consensus-ADMM MPC step of the OBCA flagship, on one
device or with the vehicle axis partitioned over ranks.

Port of ``dlp_admm_tpu/parallel/consensus_spmd.py``. The JAX module runs the
step under ``shard_map`` over a ``(scenario, vehicle)`` mesh; on a 1x1 mesh
(``run_scenario_batch``, bench metric 3) it is one ADMM loop whose carry has
a leading scenario axis S. On one CUDA card (or the CPU) every lane is one
scenario:

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

With a mesh of ranks (:mod:`.mesh`) each rank holds its block ``[S_blk,
vb]`` of the scenarios and vehicles, as JAX's shard does:

* the initial states and every ``BarState`` leaf are gathered over the
  vehicle group (the vehicles -> RSU message, one packed
  ``dist.all_gather``) into the full-vehicle view, on which each
  iteration's parameters are built with the planner's own methods and then
  sliced to the block; the rank solves only its ``S_blk·vb`` local NLPs
  (staged: K1 at ``(S_blk·vb, N-1, b)``);
* every rank repeats the edge (RSU) solve for itself on the gathered
  payload and keeps its block of the solution (no return traffic);
* the residual and gap sums (JAX's ``psum``) gather the per-vehicle terms
  and sum them over the full view in the one-device order, so every rank
  of a vehicle group reads the same bits at its stop test and takes the
  same number of ADMM iterations; ranks of other scenario blocks never
  wait for each other.

The collectives sit between solves, at the ADMM level, outside the staged
solver's captured CUDA graphs. On one device the gathers and block slices
are the identity, so the code is the same.

Every per-iteration parameter is built with the planner's OWN methods
(``_local_params``, ``_local_staged_params``, ``_local_warm_one``,
``_zip_z``, ``_edge_lam``, ``check_converge``) mapped over the lanes with
``torch.func.vmap``, and the solves go through the planner's
``_solve_locals`` / ``_solve_edges``, so a lane equals the same scenario run
alone by construction (to rounding: the batch's reductions and library
kernels may sum in another order).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import vmap

from ..coordination.dual_update import DualState, update_dual
from ..models.obca import BarState
from ..ops.geometry import halfspaces
from .mesh import all_gather_cat


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

    Returns ``step(init_states, bar_state, step_idx)`` with ``bar_state``
    leaves carrying a leading scenario axis ``[S, V, ...]``; outputs
    ``(next_state [S, V, 5], bar_state, iters [S], primal [S], dual [S],
    converged [S], gap [S])`` on the planner's device. The block solves it
    makes are added to ``planner.block_solves``.

    ``mesh`` (a :class:`~.mesh.PlannerMesh` with process groups) partitions
    the vehicle axis: this rank passes and gets its own block
    ``[S_blk, V / n_vehicle, ...]`` of every input and output (the
    per-scenario outputs ``[S_blk]``), solves only that block's local
    NLPs, and repeats the edge solve for itself on the gathered state, as
    the JAX step does under ``shard_map``. ``mesh=None`` or a 1x1 mesh
    without process groups is the one-device step.
    """
    for name, on in (("edge_prox", planner.edge_prox != 0.0),
                     ("branch_commit", planner.branch_commit)):
        if on:
            # the JAX batch builds its edge parameters without z_prev or
            # d_bar (its consensus_spmd.py:182-199), so it cannot run them
            raise ValueError(
                f"{name} is an option of ConsensusObcaPlanner's own step: "
                f"the batched step builds no edge parameters for it, as in "
                f"the JAX package")
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
    sharded = mesh is not None and mesh.distributed
    ax_v = mesh.n_vehicle if sharded else 1
    if v % ax_v:
        raise ValueError(f"num_veh {v} must divide the vehicle axis {ax_v}")
    vb = v // ax_v                        # vehicles of this rank's block
    lo = mesh.vehicle_idx * vb if sharded else 0

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

    def gather(*blocks):
        """Vehicle blocks ``[S, vb, ...]`` -> full ``[S, V, ...]``: the
        vehicles -> RSU message (one packed all-gather over the vehicle
        group); the identity on one device."""
        if not sharded:
            return blocks
        return all_gather_cat(mesh, "vehicle", blocks, 1)

    def gather_bs(bs):
        return BarState(*gather(*bs))

    def blk(tree):
        """Full view ``[S, V, ...]`` -> this rank's vehicle block."""
        if not sharded:
            return tree
        if isinstance(tree, dict):
            return {k: a.narrow(1, lo, vb) for k, a in tree.items()}
        return tree.narrow(1, lo, vb)

    def step(init_states, bar_state: BarState, step_idx: int):
        s = init_states.shape[0]
        ref_win = planner._ref_window(step_idx)                # [V, N, 5]
        ref_b = ref_win[lo:lo + vb].expand(s, vb, n, 5)
        init_full, = gather(init_states)

        def masks(bsf):
            pair_mask = v_mask(bsf.local_x)                    # [S, P]
            return pair_mask, pair_mask[:, pid]                # [S, V, K]

        def body(c):
            bs = c["bs"]
            active = torch.logical_and(~c["done"], c["it"] < max_it)
            bsf = gather_bs(bs)           # the RSU's full-vehicle view
            pair_mask, mask_veh = masks(bsf)
            if planner.prox_adaptive:
                prox_tau = c["prox_tau"]
            else:
                # the anneal of each lane's own iteration count
                prox_tau = taus[torch.clamp(c["it"], max=max_it - 1)]
            if planner.local_warm_mode == "previous":
                x0 = c["loc_x"]
            else:
                x0 = v_warm(ref_b, blk(v_params(bsf, init_full, ref_win, rho,
                                                mask_veh)))
            # the parameters built on the full view, sliced to the block
            p = blk(v_lane_params(bsf, init_full, ref_win, rho, mask_veh))
            loc_flat, _ = planner._solve_locals(
                flat(x0), flat(c["loc_x"]), flat(init_states),
                {k: flat(a) for k, a in p.items()},
                prox_tau.repeat_interleave(vb))
            loc_x = loc_flat.reshape(s, vb, -1)
            xs, us, lam, _ = planner._loc_split(loc_x)
            # bar_state_update (ref optimizer.py:205-222)
            a_new, b_new = halfspaces(xs[:, :, 1:], planner.vcfg,
                                      ocfg.use_delay_tightening)
            lamb_ij = (lam if planner.lamb_ij_mode == "track_local"
                       else bs.lamb_ij)
            bs = bs._replace(a_mat=a_new, b=b_new, local_x=xs[:, :, 1:],
                             lamb_ij=lamb_ij)
            # vehicles -> RSU: the fresh payload for the edge solve, which
            # every rank repeats on the full view
            locx_full, lij_full = gather(bs.local_x, bs.lamb_ij)
            local_fullx = v_zip(locx_full, lij_full)           # [S, V, T, F]
            z_full, _ = planner._solve_edges(bsf.z_bar, local_fullx,
                                             bsf.lamb_bar, pair_mask, rho)
            # RSU -> vehicles: the own block of the replicated solution
            bs = bs._replace(z_bar=blk(z_full))
            if planner.lamb_ij_mode == "track_edge":
                th = planner.lamb_ij_relax
                if planner.lamb_ij_hysteresis:
                    # per lane: hold the certificates while its primal
                    # residual rises
                    th = torch.where(c["primal"] > c["primal_prev"], 0.0,
                                     torch.full((s,), th, **kw))
                    th = th[:, None, None, None, None]
                bs = bs._replace(lamb_ij=th * blk(v_edge_lam(z_full))
                                 + (1.0 - th) * bs.lamb_ij)
            # dual ascent on the own block; each lane's own minimum distance
            pos = locx_full[..., :2]
            d_min = torch.amin(torch.linalg.norm(
                pos[:, idx_i] - pos[:, idx_j], dim=-1), dim=(1, 2))  # [S]
            cons_err = blk(local_fullx) - bs.z_bar
            dual_new = update_dual(
                DualState(dual=bs.lamb_bar, sum_err=c["sum_err"],
                          diff_val=c["diff_val"],
                          rho=torch.full((s,), rho_dual, **kw)),
                cons_err, d_min[:, None, None, None], planner.dual_cfg,
                lane_dims=1)
            bs = bs._replace(lamb_bar=dual_new.dual)
            # residuals (ref driver :82-90) and the consensus gap, per lane,
            # summed over the full vehicle view in the one-device order on
            # every rank (so every rank takes the same stop decision); the
            # dual delta normalized by the dual step size
            pr_t, du_t, gap_t = gather(
                torch.abs(us - c["us_prev"]),
                torch.abs(bs.lamb_bar - c["lamb_prev"]), torch.abs(cons_err))
            primal = pr_t.sum(dim=(1, 2, 3))
            dual = du_t.sum(dim=(1, 2, 3)) / max(rho_dual, 1.0)
            gap = gap_t.sum(dim=(1, 2, 3))
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

        _, mask_veh0 = masks(gather_bs(bar_state))
        zeros_f = torch.zeros((s, vb, t, f_width), **kw)
        inf = torch.full((s,), math.inf, **kw)
        c = dict(bs=bar_state,
                 us_prev=torch.zeros((s, vb, t, 2), **kw),
                 lamb_prev=bar_state.lamb_bar, xs=ref_b,
                 loc_x=v_warm(ref_b, blk(v_params(
                     gather_bs(bar_state), init_full, ref_win, rho,
                     mask_veh0))),
                 sum_err=zeros_f, diff_val=zeros_f,
                 it=torch.zeros((s,), dtype=torch.int32,
                                device=planner.device),
                 done=torch.zeros((s,), dtype=torch.bool,
                                  device=planner.device),
                 primal=inf, primal_prev=inf, dual=inf, gap=inf,
                 prox_tau=torch.full((s,), planner.local_prox, **kw))
        # one host read per ADMM iteration: is any lane still active (the
        # same answer on every rank of a vehicle group)
        while bool(torch.logical_and(~c["done"], c["it"] < max_it).any()):
            c = body(c)
        # the convergence check on the final exchange state, BEFORE the
        # dual decay, then the MPC advance (driver :99-102)
        conv = v_converged(gather_bs(c["bs"]))
        bs_out = c["bs"]
        if planner.lamb_bar_decay != 1.0:
            bs_out = bs_out._replace(
                lamb_bar=planner.lamb_bar_decay * bs_out.lamb_bar)
        return (c["xs"][:, :, 1], planner.shift_bar_state(bs_out,
                                                           batch_dims=1),
                c["it"], c["primal"], c["dual"], conv, c["gap"])

    return step

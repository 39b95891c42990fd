"""Structured interior-point solver for temporally-staged NLPs.

Port of ``dlp_admm_tpu/solvers/ip_staged.py``. The OBCA subproblems are
optimal-control problems whose KKT systems are block-tridiagonal under a
time-major variable ordering (SURVEY.md §7.4):

* the NLP is declared **per stage**: ``w[k]`` holds every step-``k`` decision
  block; constraints split into *link* equalities (coupling ``w[k-1] ->
  w[k]``) and *stage* equalities/inequalities;
* all derivatives are per-stage blocks built with ``torch.func``, mapped
  over every (lane, stage) pair with ``vmap``;
* the condensed KKT solve is a **block-Thomas factorization**, routed to the
  hand-written kernel of :mod:`.thomas` for CUDA tensors.

Unlike the JAX version, which solves one instance and is ``vmap``-ed over
vehicles, :func:`solve_staged` is **natively batched over a leading lane axis
S**: ``w0 [S, T, b]``, every parameter ``[S, T, ...]``. The barrier ``mu``,
the regularization ``delta``, ``done``, the step length, the merit weight
``nu`` and the fraction-to-boundary minimum are per-lane ``[S]`` tensors,
and all S lanes share one block-Thomas launch per solve. The iteration logic
(slack barrier, fraction-to-boundary, l1-merit backtracking over 6 step
lengths, gradient scaling, NaN guard, solve verification) is the JAX
version's.

Where the JAX version evaluates the objective gradient, the three constraint
Jacobians and the Lagrangian Hessian as separate vmapped transforms, here one
``jacrev`` of the stage Lagrangian's gradient yields them together per IP
trip: the Hessian, the Jacobians of the scaled constraint rows, and (as
auxiliary outputs) the gradient and the values. The stationarity residual is
that gradient, ``d/dw_k`` of stage k plus ``d/dw_prev`` of stage k+1 — the
same quantity as the JAX ``resid_dual``, with the sums taken in another
order. Eager ``torch.func`` costs host time per traced operation, so fewer
passes are what keeps a trip cheap; on a CUDA device the trip is captured
once per solve as a CUDA graph and replayed (:func:`_trips_graphed`).

Stage convention: stages ``k = 0..T-1``. ``ce_link(w_prev, w_k, p_k)`` is
evaluated for every ``k`` with ``w_prev = w[k-1]`` (a zero ghost block at
``k = 0``); builders gate the ghost read with a per-stage flag in ``p``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import grad, jacrev, vmap

from ..config import SolverConfig
from . import thomas

N_ALPHAS = 6          # backtracking step lengths a_max * 0.5**i


class StagedNLP(NamedTuple):
    """min sum_k f_stage(w_k, p_k)
    s.t.  ce_link(w_{k-1}, w_k, p_k) = 0    (dynamics-style coupling)
          ce_stage(w_k, p_k) = 0            (within-stage equalities)
          ci_stage(w_k, p_k) >= 0           (within-stage inequalities)

    Each function takes one stage's unbatched tensors (the solver maps it
    over lanes and stages with ``torch.func.vmap``), so it must be
    traceable by ``torch.func``: no in-place writes, no host reads.
    """

    f_stage: Callable     # (w_k, p_k) -> scalar
    ce_link: Callable     # (w_prev, w_k, p_k) -> [ml]
    ce_stage: Callable    # (w_k, p_k) -> [ms]
    ci_stage: Callable    # (w_k, p_k) -> [q]


class StagedSolution(NamedTuple):
    w: torch.Tensor           # [S, T, b]
    y_link: torch.Tensor      # [S, T, ml] link-equality multipliers
    y_stage: torch.Tensor     # [S, T, ms] stage-equality multipliers
    z: torch.Tensor           # [S, T, q]  inequality multipliers (>= 0)
    s: torch.Tensor           # [S, T, q]  slacks (> 0)
    kkt_error: torch.Tensor   # [S]
    iterations: torch.Tensor  # [S] int32
    converged: torch.Tensor   # [S] bool
    block_solves: int         # block-Thomas solves made (each over all S)


def _prev(w):
    """w_{k-1} with a zero ghost block at k = 0 (stage axis 1)."""
    return torch.cat([torch.zeros_like(w[:, :1]), w[:, :-1]], dim=1)


def _amax(x, dims=(1, 2)):
    """Per-lane max over ``dims`` of a non-negative tensor with JAX's
    ``initial=0.0`` semantics: 0 for an empty reduction (``torch.amax``
    raises on empty input)."""
    if x.numel() == 0:
        return x.new_zeros(x.shape[0])
    return torch.clamp(torch.amax(x, dim=dims), min=0.0)


def _ftb(v, dv, tau, dims=(1, 2)):
    """Per-lane fraction-to-boundary over ``dims`` of a [S, ...] tensor:
    the largest alpha in (0, 1] with ``v + alpha dv >= (1 - tau) v``."""
    neg = dv < 0
    ratio = torch.where(neg, -tau * v / torch.where(neg, dv, -1.0), 1.0)
    return torch.clamp(torch.amin(ratio, dim=dims), max=1.0)


def kkt_variant(dtype: torch.dtype) -> tuple[torch.dtype, bool]:
    """The element type and the variant (equilibrated or not) of the K1
    solve that :func:`block_thomas_solve` runs for data of ``dtype``:
    float64 data as it is; float32 data raised to float64, equilibrated."""
    return torch.float64, dtype != torch.float64


def block_thomas_solve(diag, upper, rhs):
    """Batched symmetric block-tridiagonal solve ``diag [S, T, B, B]``,
    ``upper [S, T, B, B]`` (entry T-1 ignored), ``rhs [S, T, B]`` ->
    ``[S, T, B]``: the kernel of :mod:`.thomas` (its plain version on CPU),
    in the element type and variant :func:`kkt_variant` names.

    Float32 data is raised to float64 and solved by the equilibrated
    variant (each per-stage solve equilibrated and refined once inside the
    kernel, as JAX's ``linalg.equil_solve`` does), and the solution is cast
    back to float32; the refinements' residuals and the verification stay in
    float32. The planner's annealed-prox Hessians mix O(1e6) curvature rows
    with O(1) constraint rows and near-zero multiplier diagonals: a float32
    solve of them, equilibrated or not, rejects about one lane system in
    nine, on the card and in JAX alike, and the port's float32 runs lost
    steps under the residual thresholds by it where JAX's did not (PERF.md
    §6)."""
    real, equilibrate = kkt_variant(rhs.dtype)
    out = thomas.block_thomas_solve(
        diag.to(real).contiguous(), upper.to(real).contiguous(),
        rhs.to(real).contiguous(), equilibrate=equilibrate)
    return out.to(rhs.dtype)


class _Carry(NamedTuple):
    """The IP loop's carry; per-lane scalars are ``[S]``."""

    w: torch.Tensor
    s: torch.Tensor
    yl: torch.Tensor
    ys: torch.Tensor
    z: torch.Tensor
    mu: torch.Tensor
    delta: torch.Tensor
    done: torch.Tensor
    iters: torch.Tensor


_capture_streams: dict = {}
# one graph memory pool per device, shared by every solve's capture, with
# the last graph captured into it (``dev -> (pool, graph)``). With a pool of
# its own per capture, the card's reserved memory grew with every solve:
# the allocator frees a released pool's blocks only when an allocation
# fails, and never during a capture, so a long batched run ran out of
# memory inside one. Each graph is replayed only inside its own solve,
# before the next capture, so a later capture may reuse the blocks of an
# earlier one. The last graph is kept until the next capture has joined
# the pool: a pool that no graph holds any more is released, and joining
# it then fails.
_capture_pools: dict = {}
# diagnostics: when set, called as ``on_trip(trip, carry, trips)`` before the
# first IP trip of a solve (``trips`` 0) and after every trip of either loop
# (``trips`` counting from 1); it may read the device, and may run the pure
# function ``trip`` on the carry it is given
on_trip = None


def _trips_eager(trip, carry, max_trips):
    """The IP loop, one eager trip after another; ``done`` is read on the
    host after each trip and the loop stops once every lane is done.
    Returns ``(carry, trips)``."""
    trips = 0
    if on_trip is not None:
        on_trip(trip, carry, trips)
    while trips < max_trips:
        carry = trip(carry)
        trips += 1
        if on_trip is not None:
            on_trip(trip, carry, trips)
        if bool(carry.done.all()):        # one host read per trip
            break
    return carry, trips


def _trips_graphed(trip, carry, max_trips):
    """The IP loop on a CUDA device, as the eager loop but replayed.

    One trip is a few thousand small kernels whose host dispatch (eager
    ``torch.func``) costs far more than their device time. So the first
    trip runs eagerly on a side stream (which also sets up the libraries'
    per-stream state there), the trip is then captured once as a CUDA graph
    on that stream, and every later trip is one replay of it that updates
    the carry in place. As in the eager loop, ``done`` is read on the host
    after each trip and the loop stops once every lane is done.
    Returns ``(carry, trips)``.
    """
    dev = carry.w.device
    stream = _capture_streams.get(dev)
    if stream is None:
        stream = _capture_streams[dev] = torch.cuda.Stream(dev)
    if on_trip is not None:
        on_trip(trip, carry, 0)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        carry = trip(carry)
    torch.cuda.current_stream(dev).wait_stream(stream)
    trips = 1
    if on_trip is not None:
        on_trip(trip, carry, trips)
    if trips == max_trips or bool(carry.done.all()):
        return carry, trips
    static = _Carry(*(x.clone() for x in carry))
    stream.wait_stream(torch.cuda.current_stream(dev))

    graph = torch.cuda.CUDAGraph()
    pool, _ = _capture_pools.get(dev) or (torch.cuda.graph_pool_handle(),
                                          None)
    before = dict(thomas.captured_by_variant)
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        for dst, src in zip(static, trip(static)):
            dst.copy_(src)
        graph.capture_end()
    _capture_pools[dev] = (pool, graph)
    variants = {k: n - before.get(k, 0)
                for k, n in thomas.captured_by_variant.items()}
    while trips < max_trips:
        thomas.replay(graph, variants)
        trips += 1
        if on_trip is not None:
            on_trip(trip, static, trips)
        if bool(static.done.all()):        # one host read per trip
            break
    return static, trips


def solve_staged(snlp: StagedNLP, w0: torch.Tensor, p: dict,
                 cfg: SolverConfig = SolverConfig(),
                 yl0: Optional[torch.Tensor] = None,
                 ys0: Optional[torch.Tensor] = None,
                 z0: Optional[torch.Tensor] = None) -> StagedSolution:
    """Solve S staged NLP instances (lanes) at once.

    ``w0 [S, T, b]``; ``p`` maps names to ``[S, T, ...]`` tensors (one slice
    per lane and stage). Same algorithm as the JAX ``solve_staged``; the IP
    loop runs at most ``cfg.ip_iters`` trips and stops early once every lane
    is done (a done lane's carry is frozen, so the remaining trips would
    change nothing).

    The solve runs with the autograd engine's device threads off
    (``torch.autograd.set_multithreading_enabled(False)``). With them on,
    the first-order backward pass inside ``vmap(jacrev(grad))`` runs on the
    engine's CUDA worker thread, so the nodes of the second-order pass are
    numbered by two thread-local counters, and the engine, which runs ready
    nodes in the order of those numbers, sums gradient contributions in an
    order that depends on how many nodes each thread has made since the
    process began: the same solve then gives other bits in another call
    (``tools/check_torch_window.py --repeat``, PERF.md). On the calling
    thread alone every node comes from one counter and the order is that of
    the program.
    """
    with torch.autograd.set_multithreading_enabled(False):
        return _solve_staged(snlp, w0, p, cfg, yl0, ys0, z0)


def _solve_staged(snlp, w0, p, cfg, yl0, ys0, z0):
    dtype, dev = w0.dtype, w0.device
    n_s, t, b = w0.shape
    n_st = n_s * t

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def flat(a):                       # [L, T, ...] -> [L*T, ...]
        return a.reshape((a.shape[0] * t,) + a.shape[2:])

    def lanes(x):                      # [S] -> broadcastable over [S, T, *]
        return x[:, None, None]

    p0 = {k: v[0, 0] for k, v in p.items()}
    ml = snlp.ce_link(w0[0, 0], w0[0, 0], p0).shape[0]
    ms = snlp.ce_stage(w0[0, 0], p0).shape[0]
    q = snlp.ci_stage(w0[0, 0], p0).shape[0]
    m = ml + ms + q
    tau = 0.995
    sigma_mu = 0.2
    tol = cfg.ip_tol
    eps_reg = 1e-8
    g_max = 100.0

    # -- per-stage functions of v2 = (w_prev, w_k) -------------------------
    def stage_values(v2, p_k, sc_k):
        """Objective and the scaled rows [link | stage | ineq] of one stage."""
        w_prev, w_k = v2[:b], v2[b:]
        rows = []
        if ml:
            rows.append(snlp.ce_link(w_prev, w_k, p_k))
        if ms:
            rows.append(snlp.ce_stage(w_k, p_k))
        if q:
            rows.append(snlp.ci_stage(w_k, p_k))
        cons = sc_k * torch.cat(rows) if rows else v2.new_zeros(0)
        return snlp.f_stage(w_k, p_k), cons

    def lag_stage(v2, p_k, y_k, sc_k, c):
        """Stage-k Lagrangian contribution (scaled) and its values."""
        f, cons = stage_values(v2, p_k, sc_k)
        return c * f - y_k @ cons, (f, cons)

    def second_order(v2, p_k, y_k, sc_k, c):
        g, (f, cons) = grad(lag_stage, has_aux=True)(v2, p_k, y_k, sc_k, c)
        return (g, cons), (g, f, cons)

    v_values = vmap(stage_values)
    v_first = vmap(grad(lag_stage, has_aux=True))
    v_second = vmap(jacrev(second_order, has_aux=True))

    pf = {k: flat(v) for k, v in p.items()}

    def v2_of(w):
        return flat(torch.cat([_prev(w), w], dim=-1))

    # gradient-based scaling (ip.py:90-103), frozen at w0: one objective
    # factor per lane, one factor per constraint row
    ones_sc = torch.ones((n_st, m), dtype=dtype, device=dev)
    raw_g = vmap(grad(lambda v2, p_k: snlp.f_stage(v2[b:], p_k)))(
        v2_of(w0), pf)[:, b:].reshape(n_s, t, b)
    c_f = torch.clamp(g_max / torch.clamp(_amax(raw_g.abs()), min=1e-8),
                      max=1.0)                                   # [S]
    if m:
        raw_j = vmap(jacrev(lambda v2, p_k, sc_k: stage_values(
            v2, p_k, sc_k)[1]))(v2_of(w0), pf, ones_sc)          # [S*T, m, 2b]
        # link rows: max over both (w_prev, w_k) blocks; the stage and
        # inequality rows do not depend on w_prev, so the same max applies
        sc = torch.clamp(g_max / torch.clamp(raw_j.abs().amax(-1), min=1e-8),
                         max=1.0).reshape(n_s, t, m)
    else:
        sc = zeros(n_s, t, 0)
    s_l, s_s, s_i = sc[..., :ml], sc[..., ml:ml + ms], sc[..., ml + ms:]
    sc_f = flat(sc)
    c_f_st = c_f[:, None].expand(n_s, t).reshape(n_st)

    def split(cons):
        return cons[..., :ml], cons[..., ml:ml + ms], cons[..., ml + ms:]

    def values(w, pfl, scl):
        """(sum_k f per lane, scaled rows [L, T, m]) at ``w [L, T, b]``."""
        n_l = w.shape[0]
        f, cons = v_values(v2_of(w), pfl, scl)
        return f.reshape(n_l, t).sum(1), cons.reshape(n_l, t, m)

    def merit(f_sum, cons, s, mu, nu, cf):
        cl, cs, ci = split(cons)
        barrier = -mu * torch.log(torch.clamp(s, min=1e-300)).sum((1, 2))
        infeas = (cl.abs().sum((1, 2)) + cs.abs().sum((1, 2))
                  + (ci - s).abs().sum((1, 2)))
        return cf * f_sum + barrier + nu * infeas

    def resid_dual(g):
        """Stationarity residual [S, T, b]: d/dw_k of stage k's Lagrangian
        plus d/dw_prev of stage k+1's (its link rows)."""
        nxt = torch.cat([g[:, 1:, :b], zeros(n_s, 1, b)], dim=1)
        return g[..., b:] + nxt

    def first_order(w, y):
        """Lagrangian gradient [S, T, 2b] and the scaled rows at ``w``."""
        g, (_, cons) = v_first(v2_of(w), pf, flat(y), sc_f, c_f_st)
        return g.reshape(n_s, t, 2 * b), cons.reshape(n_s, t, m)

    def kkt_error(g, cons, s, z):
        cl, cs, ci = split(cons)
        err = _amax(resid_dual(g).abs())
        err = torch.maximum(err, _amax(cl.abs()))
        err = torch.maximum(err, _amax(cs.abs()))
        err = torch.maximum(err, _amax((ci - s).abs()))
        err = torch.maximum(err, _amax((s * z).abs()))
        return err

    # the line search evaluates all N_ALPHAS trial points of all lanes in one
    # batch of S * N_ALPHAS lanes (lane-major)
    def rep(a):
        return a.repeat_interleave(N_ALPHAS, dim=0)

    pf_ls = {k: flat(rep(v)) for k, v in p.items()}
    sc_ls = flat(rep(sc))
    c_f_ls = rep(c_f)

    s = torch.clamp(split(values(w0, pf, sc_f)[1])[2], min=1e-2)
    z = torch.ones((n_s, t, q), dtype=dtype, device=dev) if z0 is None else z0
    yl = zeros(n_s, t, ml) if yl0 is None else yl0
    ys = zeros(n_s, t, ms) if ys0 is None else ys0
    mu = torch.full((n_s,), cfg.ip_mu0, dtype=dtype, device=dev)
    if q:
        mu = torch.maximum(mu, (s * z).mean((1, 2)))
    delta = torch.full((n_s,), 1e-8, dtype=dtype, device=dev)
    done = torch.zeros((n_s,), dtype=torch.bool, device=dev)
    iters = torch.zeros((n_s,), dtype=torch.int32, device=dev)
    eye_b = torch.eye(b, dtype=dtype, device=dev)
    eye_ml = torch.eye(ml, dtype=dtype, device=dev).expand(n_s, t, ml, ml)
    eye_ms = torch.eye(ms, dtype=dtype, device=dev).expand(n_s, t, ms, ms)
    halvings = torch.pow(0.5, torch.arange(N_ALPHAS, dtype=dtype, device=dev))
    ones = torch.ones((n_s,), dtype=dtype, device=dev)
    n_refine = 1 if dtype == torch.float64 else 2
    bb = b + ml + ms                      # KKT block width

    def trip(carry):
        """One IP trip: the next carry, done lanes frozen. No host reads,
        so it can be captured as a CUDA graph."""
        w, s, yl, ys, z, mu, delta, done, iters = carry
        # per-stage derivative blocks: one reverse-over-reverse pass
        (hh, jc), (g, f, cons) = v_second(
            v2_of(w), pf, flat(torch.cat([yl, ys, z], dim=-1)), sc_f, c_f_st)
        hh = hh.reshape(n_s, t, 2 * b, 2 * b)
        jc = jc.reshape(n_s, t, m, 2 * b)
        g = g.reshape(n_s, t, 2 * b)
        f_sum, cons = f.reshape(n_s, t).sum(1), cons.reshape(n_s, t, m)
        q_blk = hh[..., b:, b:]           # d2/dw_k^2 of stage k
        p_blk = hh[..., :b, :b]           # d2/dw_prev^2 of stage k
        c_blk = hh[..., :b, b:]           # d2/dw_prev dw_k of stage k
        # H_kk = Q_k + P_{k+1};  H_{k,k+1} = C_{k+1}^T
        h_diag = q_blk + torch.cat([p_blk[:, 1:], zeros(n_s, 1, b, b)], dim=1)
        h_off = torch.cat([c_blk[:, 1:].transpose(-1, -2),
                           zeros(n_s, 1, b, b)], dim=1)
        jl_p = jc[..., :ml, :b]           # B_k: link rows w.r.t. w_{k-1}
        jl_c = jc[..., :ml, b:]           # A_k: link rows w.r.t. w_k
        js = jc[..., ml:ml + ms, b:]
        ji = jc[..., ml + ms:, b:]

        c_l, c_s, c_i = split(cons)
        r_i = c_i - s
        r_c = s * z - lanes(mu)
        s_safe = torch.clamp(s, min=1e-12)
        sigma = z / s_safe

        # condensed diag: H_kk + J_k^T Sigma J_k + delta I
        h_cond = (h_diag + torch.einsum('stqb,stq,stqc->stbc', ji, sigma, ji)
                  + delta[:, None, None, None] * eye_b)
        rhs_x = -(resid_dual(g) + torch.einsum(
            'stqb,stq->stb', ji, r_c / s_safe + sigma * r_i))

        # per-stage KKT blocks [S, T, B, B] / [S, T, B]
        d_blk = torch.cat([
            torch.cat([h_cond, jl_c.transpose(-1, -2), js.transpose(-1, -2)],
                      dim=-1),
            torch.cat([jl_c, -eps_reg * eye_ml, zeros(n_s, t, ml, ms)],
                      dim=-1),
            torch.cat([js, zeros(n_s, t, ms, ml), -eps_reg * eye_ms],
                      dim=-1)], dim=-2)
        # U_k: rows (w_k) x cols (w_{k+1}, yl_{k+1}, ys_{k+1})
        b_next = torch.cat([jl_p[:, 1:], zeros(n_s, 1, ml, b)], dim=1)
        u_top = torch.cat([h_off, b_next.transpose(-1, -2),
                           zeros(n_s, t, b, ms)], dim=-1)
        u_blk = torch.cat([u_top, zeros(n_s, t, ml + ms, bb)], dim=-2)
        rhs = torch.cat([rhs_x, -c_l, -c_s], dim=-1)          # [S, T, B]
        u_prev = torch.cat([zeros(n_s, 1, bb, bb), u_blk[:, :-1]], dim=1)

        def tridiag_residual(vec):
            nxt = torch.cat([vec[:, 1:], zeros(n_s, 1, bb)], dim=1)
            prv = torch.cat([zeros(n_s, 1, bb), vec[:, :-1]], dim=1)
            return (torch.einsum('stij,stj->sti', d_blk, vec)
                    + torch.einsum('stij,stj->sti', u_blk, nxt)
                    + torch.einsum('stji,stj->sti', u_prev, prv) - rhs)

        sol = block_thomas_solve(d_blk, u_blk, rhs)
        # iterative refinement: block Thomas pivots only within a stage and
        # loses accuracy on ill-conditioned stages; each correction is one
        # more block solve
        for _r in range(n_refine):
            sol = sol - block_thomas_solve(d_blk, u_blk, tridiag_residual(sol))
        # solve verification: a (near-)singular leading block yields finite
        # garbage the NaN guard misses; one tridiagonal matvec checks the
        # residual, and a bad solve becomes a zero step + delta escalation
        lin_res = tridiag_residual(sol)
        res_tol = 1e-4 * (1.0 + _amax(rhs.abs()))
        bad = torch.logical_or(~torch.isfinite(sol).all(dim=2).all(dim=1),
                               _amax(lin_res.abs()) > res_tol)
        sol = torch.where(lanes(bad), torch.zeros_like(sol), sol)
        dw = sol[..., :b]
        dyl = -sol[..., b:b + ml]
        dys = -sol[..., b + ml:]
        ds = torch.einsum('stqb,stb->stq', ji, dw) + r_i
        dz = -(r_c + z * ds) / s_safe

        a_p_max = _ftb(s, ds, tau) if q else ones
        a_d = _ftb(z, dz, tau) if q else ones

        nu = 2.0 * torch.maximum(
            _amax(yl.abs()), torch.maximum(_amax(ys.abs()), _amax(z.abs())))
        nu = torch.clamp(nu, min=10.0)
        phi0 = merit(f_sum, cons, s, mu, nu, c_f)
        alphas = a_p_max[:, None] * halvings                     # [S, 6]
        w_try = (w[:, None] + alphas[..., None, None] * dw[:, None]).reshape(
            (n_s * N_ALPHAS, t, b))
        s_try = torch.clamp(s[:, None] + alphas[..., None, None] * ds[:, None],
                            min=1e-12).reshape((n_s * N_ALPHAS, t, q))
        phis = merit(*values(w_try, pf_ls, sc_ls), s_try, rep(mu), rep(nu),
                     c_f_ls).reshape(n_s, N_ALPHAS)
        ok = torch.logical_and(
            phis < (phi0 + 1e-10 * phi0.abs() + 1e-12)[:, None],
            torch.isfinite(phis))
        # first accepted step length: argmax of an integer mask returns the
        # first maximal index
        first_ok = torch.argmax(ok.to(torch.int32), dim=1)
        any_ok = torch.logical_and(ok.any(dim=1), ~bad)
        # full rejection -> ZERO step (never walk up the merit) + delta bump
        a_p = torch.where(any_ok, alphas.gather(1, first_ok[:, None])[:, 0],
                          0.0)
        a_d2 = torch.where(any_ok, a_d, 0.0)
        delta_next = torch.where(
            any_ok, torch.clamp(delta * 0.2, min=1e-9),
            torch.clamp(torch.clamp(delta, min=1e-6) * 10.0, max=1e6))

        w_new = w + lanes(a_p) * dw
        s_new = torch.clamp(s + lanes(a_p) * ds, min=1e-12)
        yl_new = yl + lanes(a_d2) * dyl
        ys_new = ys + lanes(a_d2) * dys
        z_new = torch.clamp(z + lanes(a_d2) * dz, min=1e-12) if q else z
        if q:
            mu_new = torch.clamp(sigma_mu * (s_new * z_new).mean((1, 2)),
                                 min=tol / 10)
        else:
            mu_new = torch.full_like(mu, tol / 10)

        g_new, cons_new = first_order(
            w_new, torch.cat([yl_new, ys_new, z_new], dim=-1))
        now_done = kkt_error(g_new, cons_new, s_new, z_new) < tol

        def keep(new, old):
            return torch.where(done.reshape((-1,) + (1,) * (new.dim() - 1)),
                               old, new)

        return _Carry(keep(w_new, w), keep(s_new, s), keep(yl_new, yl),
                      keep(ys_new, ys), keep(z_new, z), keep(mu_new, mu),
                      keep(delta_next, delta),
                      torch.logical_or(done, now_done),
                      iters + (~done).to(torch.int32))

    carry = _Carry(w0, s, yl, ys, z, mu, delta, done, iters)
    loop = _trips_graphed if dev.type == "cuda" else _trips_eager
    carry, trips = loop(trip, carry, cfg.ip_iters)
    w, s, yl, ys, z, _, _, done, iters = carry
    block_solves = trips * (1 + n_refine)

    g_fin, cons_fin = first_order(w, torch.cat([yl, ys, z], dim=-1))
    # unscale multipliers/slacks (ip.py:215-218)
    yl_out = s_l * yl / lanes(c_f) if ml else yl
    ys_out = s_s * ys / lanes(c_f) if ms else ys
    z_out = s_i * z / lanes(c_f) if q else z
    s_out = s / torch.clamp(s_i, min=1e-12) if q else s
    return StagedSolution(w=w, y_link=yl_out, y_stage=ys_out, z=z_out,
                          s=s_out, kkt_error=kkt_error(g_fin, cons_fin, s, z),
                          iterations=iters, converged=done,
                          block_solves=block_solves)

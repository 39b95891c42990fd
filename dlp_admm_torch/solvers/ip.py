"""Batched dense primal-dual interior-point NLP solver.

Port of ``dlp_admm_tpu/solvers/ip.py``: min f(x, p) s.t. ce(x, p) = 0,
ci(x, p) >= 0, with slacks and a log barrier on the inequalities,
gradient-based scaling frozen at ``x0``, one dense solve of the condensed
KKT system over (dx, dy) per trip, fraction-to-boundary and a backtracking
line search over 6 step lengths on an l1 merit, a NaN guard that turns a
failed solve into a zero step and a larger regularization, and
freeze-on-done lanes.

Unlike the JAX version, which solves one instance and is ``vmap``-ed,
:func:`solve_nlp_batch` is natively batched over a leading lane axis S, as
:func:`..ip_staged.solve_staged` is: ``x0 [S, n]`` and every tensor leaf of
``p`` ``[S, ...]``; every per-lane scalar of the loop (barrier, merit weight,
regularization, step lengths, ``done``) is ``[S]``. :func:`solve_nlp` is
one instance, as in JAX.

Derivatives come from ``torch.func`` in reverse mode: one ``jacrev`` of the
scaled Lagrangian's gradient per trip gives the Hessian, the Jacobian of the
scaled constraint rows, and (as auxiliary outputs) the gradient and the
values. The stationarity residual is that gradient, the JAX
``grad_f - je^T y - ji^T z`` with its sums taken in another order. JAX runs
all ``ip_iters`` trips (a fixed-length scan); here the loop stops once every
lane is done, which changes nothing since a done lane's carry is frozen.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.utils._pytree as pytree
from torch.func import grad, jacrev, vmap

from ..config import SolverConfig
from .ip_staged import N_ALPHAS, _amax, _ftb
from .linalg import dense_solve


class NLP(NamedTuple):
    """Problem spec: min f(x, p)  s.t.  ce(x, p) = 0,  ci(x, p) >= 0.

    Each function takes one instance's unbatched ``x [n]`` and parameters
    (the solver maps it over lanes with ``torch.func.vmap``), so it must be
    traceable by ``torch.func``: no in-place writes, no host reads."""

    f: Callable
    ce: Callable
    ci: Callable


class NLPSolution(NamedTuple):
    x: torch.Tensor           # [S, n]
    y: torch.Tensor           # [S, m_e] equality multipliers
    z: torch.Tensor           # [S, m_i] inequality multipliers (>= 0)
    s: torch.Tensor           # [S, m_i] slacks (>= 0)
    kkt_error: torch.Tensor   # [S] max KKT residual at exit
    iterations: torch.Tensor  # [S] int32
    converged: torch.Tensor   # [S] bool


def _lane_dims(p):
    """``vmap`` in_dims of a parameter pytree: 0 for a tensor leaf, None
    (shared by every lane) for anything else, ``None`` itself included."""
    return pytree.tree_map(
        lambda a: 0 if isinstance(a, torch.Tensor) else None, p)


def solve_nlp(nlp: NLP, x0: torch.Tensor, p,
              cfg: SolverConfig = SolverConfig(),
              y0: Optional[torch.Tensor] = None,
              z0: Optional[torch.Tensor] = None) -> NLPSolution:
    """Solve one instance ``x0 [n]`` (every tensor of ``p`` unbatched);
    the solution has no lane axis, as the JAX ``solve_nlp``."""
    def one(a):
        return a[None] if isinstance(a, torch.Tensor) else a
    sol = solve_nlp_batch(nlp, x0[None], pytree.tree_map(one, p), cfg,
                          None if y0 is None else y0[None],
                          None if z0 is None else z0[None])
    return NLPSolution(*(a[0] for a in sol))


def solve_nlp_batch(nlp: NLP, x0: torch.Tensor, p,
                    cfg: SolverConfig = SolverConfig(),
                    y0: Optional[torch.Tensor] = None,
                    z0: Optional[torch.Tensor] = None) -> NLPSolution:
    """Solve S instances at once: ``x0 [S, n]``, a leading lane axis on
    every tensor of ``p`` (and on ``y0``, ``z0``). Runs with the autograd
    engine's device threads off, as ``solve_staged`` does, so that a run
    on the card repeats bit for bit."""
    with torch.autograd.set_multithreading_enabled(False):
        return _solve(nlp, x0, p, cfg, y0, z0)


def _solve(nlp, x0, p, cfg, y0, z0):
    dtype, dev = x0.dtype, x0.device
    n_s, n = x0.shape
    p_dims = _lane_dims(p)
    p_first = pytree.tree_map(
        lambda a: a[0] if isinstance(a, torch.Tensor) else a, p)
    m_e = nlp.ce(x0[0], p_first).shape[0]
    m_i = nlp.ci(x0[0], p_first).shape[0]
    m = m_e + m_i
    tau = 0.995
    sigma_mu = 0.2
    tol = cfg.ip_tol
    g_max = 100.0

    def rows(x, p_i):
        return torch.cat([nlp.ce(x, p_i), nlp.ci(x, p_i)])

    def values(x, p_i, sc, cf):
        """Scaled objective and scaled rows ``[ce | ci]`` of one lane."""
        return cf * nlp.f(x, p_i), sc * rows(x, p_i)

    def lag(x, p_i, yz, sc, cf):
        f, cons = values(x, p_i, sc, cf)
        return f - yz @ cons, (f, cons)

    def second(x, p_i, yz, sc, cf):
        g, (f, cons) = grad(lag, has_aux=True)(x, p_i, yz, sc, cf)
        return (g, cons), (g, f, cons)

    in_dims = (0, p_dims, 0, 0, 0)
    v_values = vmap(values, in_dims=(0, p_dims, 0, 0))
    v_grad = vmap(grad(lag, has_aux=True), in_dims=in_dims)
    v_second = vmap(jacrev(second, has_aux=True), in_dims=in_dims)

    # gradient-based scaling (ip.py:90-103), frozen at x0: one objective
    # factor per lane, one factor per constraint row
    raw_g = vmap(grad(nlp.f), in_dims=(0, p_dims))(x0, p)
    g_top = _amax(raw_g.abs(), (1,))
    c_f = torch.clamp(g_max / torch.clamp(g_top, min=1e-8), max=1.0)  # [S]
    if m:
        raw_j = vmap(jacrev(rows), in_dims=(0, p_dims))(x0, p)     # [S, m, n]
        sc = torch.clamp(g_max / torch.clamp(raw_j.abs().amax(-1), min=1e-8),
                         max=1.0)
    else:
        sc = x0.new_zeros(n_s, 0)
    s_e, s_i = sc[:, :m_e], sc[:, m_e:]

    def merit(f, cons, s, mu, nu):
        barrier = -mu * torch.log(torch.clamp(s, min=1e-300)).sum(1)
        infeas = cons[:, :m_e].abs().sum(1) + (cons[:, m_e:] - s).abs().sum(1)
        return f + barrier + nu * infeas

    def kkt_error(x, s, y, z):
        g, (_, cons) = v_grad(x, p, torch.cat([y, z], dim=1), sc, c_f)
        err = _amax(g.abs(), (1,))
        err = torch.maximum(err, _amax(cons[:, :m_e].abs(), (1,)))
        err = torch.maximum(err, _amax((cons[:, m_e:] - s).abs(), (1,)))
        return torch.maximum(err, _amax((s * z).abs(), (1,)))

    # the line search evaluates all N_ALPHAS trial points of all lanes in one
    # batch of S * N_ALPHAS lanes (lane-major)
    def rep(a):
        return a.repeat_interleave(N_ALPHAS, dim=0)

    p_ls = pytree.tree_map(
        lambda a: rep(a) if isinstance(a, torch.Tensor) else a, p)
    sc_ls, c_f_ls = rep(sc), rep(c_f)

    s = torch.clamp(v_values(x0, p, sc, c_f)[1][:, m_e:], min=1e-2)
    z = torch.ones((n_s, m_i), dtype=dtype, device=dev) if z0 is None else z0
    y = torch.zeros((n_s, m_e), dtype=dtype, device=dev) if y0 is None else y0
    mu = torch.full((n_s,), cfg.ip_mu0, dtype=dtype, device=dev)
    if m_i:
        mu = torch.maximum(mu, (s * z).mean(1))
    delta = torch.full((n_s,), 1e-8, dtype=dtype, device=dev)
    done = torch.zeros((n_s,), dtype=torch.bool, device=dev)
    iters = torch.zeros((n_s,), dtype=torch.int32, device=dev)
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    reg_e = -1e-8 * torch.eye(m_e, dtype=dtype, device=dev).expand(
        n_s, m_e, m_e)
    halvings = torch.pow(0.5, torch.arange(N_ALPHAS, dtype=dtype, device=dev))
    ones = torch.ones((n_s,), dtype=dtype, device=dev)

    def trip(x, s, y, z, mu, delta, done, iters):
        (hh, jc), (g, f, cons) = v_second(x, p, torch.cat([y, z], dim=1), sc,
                                          c_f)
        je, ji = jc[:, :m_e], jc[:, m_e:]
        c_e = cons[:, :m_e]
        r_i = cons[:, m_e:] - s
        r_c = s * z - mu[:, None]
        s_safe = torch.clamp(s, min=1e-12)
        sigma = z / s_safe
        h = (hh + torch.einsum('sqn,sq,sqk->snk', ji, sigma, ji)
             + delta[:, None, None] * eye_n)
        rhs_x = -(g + torch.einsum('sqn,sq->sn', ji, r_c / s_safe
                                   + sigma * r_i))
        # KKT system over (dx, lam), lam = -dy
        kkt = torch.cat([torch.cat([h, je.transpose(1, 2)], dim=2),
                         torch.cat([je, reg_e], dim=2)], dim=1)
        sol = dense_solve(kkt, torch.cat([rhs_x, -c_e], dim=1))
        # NaN guard: a singular KKT system must not poison the iterate; take
        # a zero step and let the delta bump below re-regularize
        bad = ~torch.isfinite(sol).all(dim=1)
        sol = torch.where(bad[:, None], torch.zeros_like(sol), sol)
        dx = sol[:, :n]
        dy = -sol[:, n:]
        ds = torch.einsum('sqn,sn->sq', ji, dx) + r_i
        dz = -(r_c + z * ds) / s_safe

        a_p_max = _ftb(s, ds, tau, (1,)) if m_i else ones
        a_d = _ftb(z, dz, tau, (1,)) if m_i else ones
        nu = torch.clamp(2.0 * _amax(torch.cat([y, z], dim=1).abs(), (1,)),
                         min=10.0)
        phi0 = merit(f, cons, s, mu, nu)
        alphas = a_p_max[:, None] * halvings                     # [S, 6]
        x_try = (x[:, None] + alphas[..., None] * dx[:, None]).reshape(
            n_s * N_ALPHAS, n)
        s_try = torch.clamp(s[:, None] + alphas[..., None] * ds[:, None],
                            min=1e-12).reshape(n_s * N_ALPHAS, m_i)
        phis = merit(*v_values(x_try, p_ls, sc_ls, c_f_ls), s_try, rep(mu),
                     rep(nu)).reshape(n_s, N_ALPHAS)
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
        a_d = torch.where(any_ok, a_d, 0.0)
        delta_next = torch.where(
            any_ok, torch.clamp(delta * 0.2, min=1e-9),
            torch.clamp(torch.clamp(delta, min=1e-6) * 10.0, max=1e6))

        x_new = x + a_p[:, None] * dx
        s_new = torch.clamp(s + a_p[:, None] * ds, min=1e-12)
        y_new = y + a_d[:, None] * dy
        z_new = torch.clamp(z + a_d[:, None] * dz, min=1e-12) if m_i else z
        # adaptive barrier: mu <- sigma_mu * complementarity
        if m_i:
            mu_new = torch.clamp(sigma_mu * (s_new * z_new).mean(1),
                                 min=tol / 10)
        else:
            mu_new = torch.full_like(mu, tol / 10)
        now_done = kkt_error(x_new, s_new, y_new, z_new) < tol

        def keep(new, old):
            return torch.where(done.reshape((-1,) + (1,) * (new.dim() - 1)),
                               old, new)

        return (keep(x_new, x), keep(s_new, s), keep(y_new, y),
                keep(z_new, z), keep(mu_new, mu), keep(delta_next, delta),
                torch.logical_or(done, now_done),
                iters + (~done).to(torch.int32))

    carry = (x0, s, y, z, mu, delta, done, iters)
    for _ in range(cfg.ip_iters):
        carry = trip(*carry)
        if bool(carry[6].all()):             # one host read per trip
            break
    x, s, y, z, _, _, done, iters = carry
    err = kkt_error(x, s, y, z)
    # unscale multipliers/slacks back to the original problem
    cf = c_f[:, None]
    y_out = s_e * y / cf if m_e else y
    z_out = s_i * z / cf if m_i else z
    s_out = s / torch.clamp(s_i, min=1e-12) if m_i else s
    return NLPSolution(x=x, y=y_out, z=z_out, s=s_out, kkt_error=err,
                       iterations=iters, converged=done)

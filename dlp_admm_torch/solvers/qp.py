"""Batched dense OSQP-style QP solver (operator splitting / ADMM).

Port of ``dlp_admm_tpu/solvers/qp.py``. Problem form (OSQP standard form):

    minimize    1/2 x^T P x + q^T x
    subject to  l <= A x <= u

The JAX solver is written for one QP and ``vmap``-ed; here every function
works natively on a batch: ``P [B, n, n]``, ``q [B, n]``, ``A [B, m, n]``,
``l, u [B, m]`` (any number of leading batch axes, none for one QP). Every
reduction that JAX takes per QP under ``vmap`` (the Ruiz cost normalisation,
the Newton-Schulz seed's infinity norm, the residual maxima and the rho
factor) runs over that QP's own axes only. The recipe is OSQP's:

* modified Ruiz equilibration of [[P, A^T], [A, 0]] + cost normalization;
* splitting iteration with over-relaxation ``alpha``;
* adaptive ``rho``: the iteration runs in segments; between segments rho is
  rescaled by sqrt(primal_res / dual_res), the per-segment factor clipped to
  [0.2, 1.9], and the condensed KKT inverse refreshed by Newton-Schulz;
* iterates of a QP freeze once both unscaled residuals are under
  ``cfg.qp_tol`` (masking, no data-dependent exit).

The condensed KKT matrix ``P + sigma I + rho A^T A`` is inverted once per
solve, by Newton-Schulz from a cold seed (``qp_kkt="ns"``) or by Cholesky
(``"chol"``); a failed Cholesky factor gives NaN, as JAX's does, and never
raises. This module runs no hand-written kernel: its work is batched
matmuls, a Cholesky, clips and reductions, as in the JAX package, where no
Pallas kernel carries it either.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SolverConfig


class QPSolution(NamedTuple):
    x: torch.Tensor           # primal solution [..., n]
    y: torch.Tensor           # dual solution for l <= Ax <= u rows [..., m]
    z: torch.Tensor           # constraint values A x (projected) [..., m]
    primal_res: torch.Tensor  # ||Ax - z||_inf at exit (unscaled) [...]
    dual_res: torch.Tensor    # ||Px + q + A^T y||_inf at exit (unscaled)
    iterations: torch.Tensor  # iterations until the tolerance was met (int32)
    converged: torch.Tensor   # both residuals below cfg.qp_tol at exit


def _mv(a, x):
    """Batched matrix-vector product ``a [B, r, c] @ x [B, c] -> [B, r]``."""
    return (a @ x.unsqueeze(-1)).squeeze(-1)


def _amax(x, dim=-1):
    return torch.amax(torch.abs(x), dim=dim)


def _ruiz_equilibrate(p_mat, q, a_mat, n_iters: int = 5):
    """Modified Ruiz scaling (OSQP §5.1) of a batch: infinity-norm
    equilibration of the stacked KKT matrix plus cost normalization. Returns
    scaled data and the diagonal scalings (d [B, n], e [B, m], c [B])."""
    d = torch.ones_like(q)
    e = torch.ones(a_mat.shape[:-1], dtype=q.dtype, device=q.device)
    c = torch.ones(q.shape[:-1], dtype=q.dtype, device=q.device)
    ps, qs, as_ = p_mat, q, a_mat
    for _ in range(n_iters):
        # column inf-norms of [[P],[A]] and rows of [A^T]
        col_p = _amax(ps, -2)
        col_a = _amax(as_, -2)
        delta_d = 1.0 / torch.sqrt(torch.clamp(torch.maximum(col_p, col_a),
                                               min=1e-8))
        row_a = _amax(as_, -1)
        delta_e = 1.0 / torch.sqrt(torch.clamp(row_a, min=1e-8))
        ps = delta_d[..., :, None] * ps * delta_d[..., None, :]
        qs = delta_d * qs
        as_ = delta_e[..., :, None] * as_ * delta_d[..., None, :]
        d = d * delta_d
        e = e * delta_e
        # cost normalization, per QP
        gamma = 1.0 / torch.clamp(
            torch.maximum(torch.mean(_amax(ps, -2), dim=-1), _amax(qs)),
            min=1e-8)
        ps = gamma[..., None, None] * ps
        qs = gamma[..., None] * qs
        c = c * gamma
    return ps, qs, as_, d, e, c


def _spd_inverse(k_mat: torch.Tensor) -> torch.Tensor:
    """Exact inverse of a batch of SPD matrices via Cholesky; a matrix whose
    factorization fails gives NaN (JAX's failed factor), nothing raises."""
    n = k_mat.shape[-1]
    chol, info = torch.linalg.cholesky_ex(k_mat)
    chol = torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)
    eye = torch.eye(n, dtype=k_mat.dtype, device=k_mat.device)
    l_inv = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                          upper=False)
    return l_inv.mT @ l_inv


def _ns_cold_inverse(k_mat: torch.Tensor, n_iters: int) -> torch.Tensor:
    """Inverse of a batch of SPD matrices by Newton-Schulz from the cold
    seed ``X0 = I / ||K||_inf`` (each matrix its own norm): ``eig(X0 K) in
    (0, 1]``, so the iteration contracts."""
    n = k_mat.shape[-1]
    norm_inf = torch.amax(torch.sum(torch.abs(k_mat), dim=-1), dim=-1)
    x0 = (torch.eye(n, dtype=k_mat.dtype, device=k_mat.device)
          / norm_inf[..., None, None])
    return _ns_refresh(k_mat, x0, n_iters)


def _ns_refresh(k_new: torch.Tensor, x_old: torch.Tensor,
                n_iters: int = 8) -> torch.Tensor:
    """Newton-Schulz refresh ``X <- X (2I - K X)``: re-converges an inverse
    after the matrix moved (the caller clips the rho step factor below 2,
    which keeps ``I - X_old K_new`` inside the unit disk)."""
    n = k_new.shape[-1]
    eye2 = 2.0 * torch.eye(n, dtype=k_new.dtype, device=k_new.device)
    x = x_old
    for _ in range(n_iters):
        x = x @ (eye2 - k_new @ x)
    return x


def solve_qp(p_mat: torch.Tensor, q: torch.Tensor, a_mat: torch.Tensor,
             lo: torch.Tensor, hi: torch.Tensor,
             cfg: SolverConfig = SolverConfig(),
             x0: Optional[torch.Tensor] = None,
             y0: Optional[torch.Tensor] = None) -> QPSolution:
    """Solve a batch of QPs: ``p_mat [..., n, n]``, ``q [..., n]``,
    ``a_mat [..., m, n]``, ``lo/hi [..., m]`` (infinities allowed), the
    leading axes (none for one QP) shared by every operand.

    The iteration runs in ``cfg.qp_segments`` segments of ``cfg.qp_iters //
    qp_segments`` steps with rho re-scaled and the KKT inverse refreshed
    between segments; a QP's iterates freeze once both of its unscaled
    residuals drop below ``cfg.qp_tol``.
    """
    lead = q.shape[:-1]
    n, m = q.shape[-1], lo.shape[-1]
    flat = lambda t, *tail: t.reshape((-1,) + tail)  # noqa: E731
    sol = _solve_qp_batched(
        flat(p_mat, n, n), flat(q, n), flat(a_mat, m, n), flat(lo, m),
        flat(hi, m), cfg, None if x0 is None else flat(x0, n),
        None if y0 is None else flat(y0, m))
    return QPSolution(*(t.reshape(lead + t.shape[1:]) for t in sol))


def _solve_qp_batched(p_mat, q, a_mat, lo, hi, cfg, x0, y0) -> QPSolution:
    """:func:`solve_qp` on one leading batch axis ``B``
    (``_solve_qp_f32`` of the JAX package, batched)."""
    bsz, n = q.shape
    m = lo.shape[-1]
    dtype, dev = q.dtype, q.device
    sigma, alpha = cfg.qp_sigma, cfg.qp_alpha

    ps, qs, as_, d, e, c = _ruiz_equilibrate(p_mat, q, a_mat)
    los = e * lo
    his = e * hi

    x = torch.zeros_like(q) if x0 is None else x0 / d
    y = (torch.zeros((bsz, m), dtype=dtype, device=dev) if y0 is None
         else c[:, None] * y0 / e)
    z = torch.clamp(_mv(as_, x), los, his)

    eye_n = torch.eye(n, dtype=dtype, device=dev)
    ata = as_.mT @ as_
    ast = as_.mT

    n_segments = cfg.qp_segments
    seg_len = max(cfg.qp_iters // n_segments, 1)

    def unscaled_residuals(x, z, y):
        prim = _amax((_mv(as_, x) - z) / e)
        dual = _amax((_mv(ps, x) + qs + _mv(ast, y)) / (c[:, None] * d))
        return prim, dual

    rho = torch.full((bsz,), cfg.qp_rho, dtype=dtype, device=dev)
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    iters = torch.zeros(bsz, dtype=torch.int32, device=dev)
    kkt_inv = None
    for seg_idx in range(n_segments):
        rho_c = rho[:, None]
        kkt = ps + sigma * eye_n + rho[:, None, None] * ata
        if seg_idx == 0:
            kkt_inv = (_ns_cold_inverse(kkt, cfg.qp_ns_iters)
                       if cfg.qp_kkt == "ns" else _spd_inverse(kkt))
        else:
            kkt_inv = _ns_refresh(kkt, kkt_inv)

        # residuals only at segment boundaries: a converged iterate is a
        # fixed point, so the extra in-segment iterations are no-ops
        x_n, z_n, y_n = x, z, y
        for _ in range(seg_len):
            rhs = sigma * x_n - qs + _mv(ast, rho_c * z_n - y_n)
            x_t = _mv(kkt_inv, rhs)
            z_t = _mv(as_, x_t)
            x_new = alpha * x_t + (1 - alpha) * x_n
            z_relax = alpha * z_t + (1 - alpha) * z_n
            z_new = torch.clamp(z_relax + y_n / rho_c, los, his)
            y_n = y_n + rho_c * (z_relax - z_new)
            x_n, z_n = x_new, z_new
        keep = done[:, None]
        x = torch.where(keep, x, x_n)
        z = torch.where(keep, z, z_n)
        y = torch.where(keep, y, y_n)
        prim, dual = unscaled_residuals(x, z, y)
        now_done = torch.logical_and(prim < cfg.qp_tol, dual < cfg.qp_tol)
        iters = iters + seg_len * torch.logical_not(done).to(torch.int32)
        done = torch.logical_or(done, now_done)

        # adaptive rho (OSQP §5.2): balance the scaled residual ratio
        ax = _mv(as_, x)
        px = _mv(ps, x)
        aty = _mv(ast, y)
        prim_s = _amax(ax - z)
        dual_s = _amax(px + qs + aty)
        prim_rel = prim_s / torch.clamp(torch.maximum(_amax(ax), _amax(z)),
                                        min=1e-8)
        dual_rel = dual_s / torch.clamp(
            torch.maximum(_amax(px), torch.maximum(_amax(aty), _amax(qs))),
            min=1e-8)
        # the per-segment factor is clipped to keep the Newton-Schulz
        # refresh contractive (factor < 2, see _ns_refresh)
        factor = torch.clamp(torch.sqrt(prim_rel / torch.clamp(dual_rel,
                                                               min=1e-12)),
                             0.2, 1.9)
        new_rho = torch.clamp(rho * factor, 1e-6, 1e6)
        rho = torch.where(done, rho, new_rho)
    prim, dual = unscaled_residuals(x, z, y)
    # unscale solution
    return QPSolution(d * x, e * y / c[:, None], z / e, prim, dual, iters,
                      done)


def solve_qp_batch(p_mat, q, a_mat, lo, hi, cfg: SolverConfig = SolverConfig(),
                   x0=None, y0=None) -> QPSolution:
    """Batch-of-QPs front end (leading batch axis on every operand): the
    counterpart of the JAX ``vmap`` over :func:`solve_qp`, which already
    takes batches here."""
    if x0 is None:
        x0 = torch.zeros_like(q)
    if y0 is None:
        y0 = torch.zeros_like(lo)
    return solve_qp(p_mat, q, a_mat, lo, hi, cfg, x0, y0)


def quadratic_from_fn(fn, x_ref: torch.Tensor, *args):
    """Extract (P, q) of a quadratic scalar function around ``x_ref``:
    ``P = hess``, ``q = grad - P x_ref`` (exact for quadratics; the
    Gauss/Newton model at ``x_ref`` otherwise)."""
    grad = torch.func.grad(fn)(x_ref, *args)
    p_mat = torch.func.hessian(fn)(x_ref, *args)
    q = grad - p_mat @ x_ref
    return p_mat, q

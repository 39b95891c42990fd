"""Dense linear solves of the dense interior-point solver.

Port of ``dlp_admm_tpu/solvers/linalg.py``. The JAX module routes float64 on
a TPU through a mixed-precision scheme (the TPU has no float64 LU); CUDA and
the CPU factor float64 natively, so :func:`dense_solve` is the library's
batched LU solve everywhere. These dense solves ran no Pallas kernel in JAX,
so ``torch.linalg`` carries them here too.
"""
from __future__ import annotations

import torch


def dense_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``solve(a, b)`` by batched LU (``torch.linalg.solve_ex``). Where a
    system is singular the solution is NaN, as a zero pivot makes it in JAX
    (``torch.linalg.solve`` raises instead): the dense IP solver's guard
    turns a non-finite solve into a zero step. ``b`` may be a vector or a
    matrix of right-hand sides per system."""
    x, info = torch.linalg.solve_ex(a, b)
    bad = (info != 0).reshape(info.shape + (1,) * (x.dim() - info.dim()))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def equil_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-max (Ruiz) equilibrated :func:`dense_solve` plus one refinement
    pass (JAX ``linalg.equil_solve``): solve ``(D A D) y = D b``,
    ``x = D y`` with ``D = 1 / sqrt(max_j |a_ij|)``, so that rows of very
    different scales factor accurately in float32."""
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b[..., None]
    r = torch.amax(a.abs(), dim=-1)
    d = 1.0 / torch.sqrt(torch.clamp(r, min=1e-30))
    a_s = a * d[..., :, None] * d[..., None, :]
    c = b * d[..., :, None]
    y = dense_solve(a_s, c)
    y = y + dense_solve(a_s, c - a_s @ y)
    x = y * d[..., :, None]
    return x[..., 0] if vec else x

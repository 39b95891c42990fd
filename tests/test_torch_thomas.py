"""The block-Thomas kernel's plain PyTorch version against the JAX package,
and the CUDA kernel against the plain version (on a card only).

References:
* ``thomas_pallas.block_thomas_solve_pallas`` run as the JAX package runs it
  on the CPU (Pallas interpret mode), on diagonally dominant systems, where
  partial pivoting swaps no rows: the same recursion with the same pivot
  floor, so only summation order differs — 1e-12 in float64, 1e-5
  (relative to the solution's scale) in float32;
* vmapped ``ip_staged.block_thomas_solve`` (LU with partial pivoting per
  stage, float64): the same solution of a well-posed system, reached by
  another elimination — 1e-9 relative on diagonally dominant systems and on
  saddle systems with a zero leading block (which need row swaps), 1e-7 on
  KKT-style saddle systems (condition ~1e8 from the -1e-8 blocks).

The CUDA kernel itself is held against the plain version in
``tests/test_torch_cuda.py``, which imports no JAX so it runs on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dlp_admm_torch.solvers import thomas
from dlp_admm_tpu.solvers.ip_staged import block_thomas_solve as jax_thomas
from dlp_admm_tpu.solvers.thomas_pallas import block_thomas_solve_pallas


def make_system(seed, s, t, b, kind="diag_dominant"):
    """Symmetric block-tridiagonal systems (numpy float64), the generator
    ``chip_smoke.py`` uses on the card."""
    return chip_smoke.make_system(np.random.default_rng(seed), s, t, b, kind)


def _dense(diag, upper):
    t, b = diag.shape[0], diag.shape[1]
    m = np.zeros((t * b, t * b))
    for k in range(t):
        m[k * b:(k + 1) * b, k * b:(k + 1) * b] = diag[k]
        if k + 1 < t:
            m[k * b:(k + 1) * b, (k + 1) * b:(k + 2) * b] = upper[k]
            m[(k + 1) * b:(k + 2) * b, k * b:(k + 1) * b] = upper[k].T
    return m


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_plain_matches_pallas_interpret(dtype, tol):
    diag, upper, rhs = (a.astype(dtype) for a in make_system(0, 4, 7, 19))
    want = np.asarray(block_thomas_solve_pallas(
        jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(rhs)))
    got = thomas.block_thomas_plain(*(torch.as_tensor(a)
                                      for a in (diag, upper, rhs))).numpy()
    assert got.dtype == dtype
    assert _rel(got, want) < tol, _rel(got, want)


@pytest.mark.parametrize("shape", [(2, 7, 19), (1, 7, 20)])
@pytest.mark.parametrize("kind,tol", [("diag_dominant", 1e-9),
                                      ("kkt_saddle", 1e-7),
                                      ("zero_lead", 1e-9)])
def test_plain_matches_pivoted_lu_thomas(shape, kind, tol):
    diag, upper, rhs = make_system(1, *shape, kind=kind)
    want = np.asarray(jax.vmap(jax_thomas)(
        jnp.asarray(diag), jnp.asarray(upper), jnp.asarray(rhs)))
    # the wrapper takes the plain version for CPU tensors
    got = thomas.block_thomas_solve(*(torch.as_tensor(a)
                                      for a in (diag, upper, rhs))).numpy()
    assert _rel(got, want) < tol, _rel(got, want)
    # and it solves the system
    for s in range(shape[0]):
        res = _dense(diag[s], upper[s]) @ got[s].reshape(-1) - rhs[s].ravel()
        assert np.abs(res).max() < 1e-8 * np.abs(rhs).max()


def test_upper_with_t_minus_1_blocks():
    """``upper`` may carry T-1 blocks; entry T-1 of a T-block upper is
    ignored."""
    diag, upper, rhs = (torch.as_tensor(a) for a in make_system(2, 3, 5, 6))
    full = thomas.block_thomas_solve(diag, upper, rhs)
    short = thomas.block_thomas_solve(diag, upper[:, :-1].contiguous(), rhs)
    torch.testing.assert_close(full, short, rtol=0, atol=0)


def test_pivot_floor_keeps_zero_pivot_finite():
    diag = torch.zeros(1, 2, 3, 3, dtype=torch.float64)
    upper = torch.zeros(1, 2, 3, 3, dtype=torch.float64)
    out = thomas.block_thomas_plain(diag, upper,
                                    torch.ones(1, 2, 3, dtype=torch.float64))
    assert torch.isfinite(out).all()
    assert float(out.abs().max()) == pytest.approx(1e30)    # 1 / floor


def test_cpu_tensors_do_not_launch():
    before = thomas.launches
    thomas.block_thomas_solve(*(torch.as_tensor(a)
                                for a in make_system(3, 2, 7, 19)))
    assert thomas.launches == before


def test_wrapper_rejects_bad_inputs():
    d, u, r = (torch.as_tensor(a) for a in make_system(4, 2, 4, 5))
    with pytest.raises(ValueError):
        thomas.block_thomas_solve(d[:, :3], u, r)           # diag shape
    with pytest.raises(ValueError):
        thomas.block_thomas_solve(d, u[:, :2], r)           # upper length
    with pytest.raises(TypeError):
        thomas.block_thomas_solve(d.float(), u, r)          # mixed dtypes
    with pytest.raises(TypeError):
        thomas.block_thomas_solve(*(a.to(torch.int64) for a in (d, u, r)))
    # no kernel, no fallback for other devices
    with pytest.raises(ValueError, match="no block-Thomas kernel"):
        thomas.block_thomas_solve(*(a.to("meta") for a in (d, u, r)))

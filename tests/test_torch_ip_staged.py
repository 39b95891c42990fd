"""The port's staged interior-point solver against the JAX one, on the
problems of ``tests/test_ip_staged.py`` (constrained tracking with
dynamics links, per-stage equalities) plus a link-free problem, as a single
lane and as a batch of lanes.

Tolerance: the same algorithm on the same float64 data; the KKT blocks are
solved by block Thomas without pivoting here and with pivoted LU in JAX, so
iterates agree to rounding — solutions within 1e-9, equal iteration counts.

In float32 both sides equilibrate and refine each stage solve and refine the
block-tridiagonal solve twice (three block solves a trip); each carries
float32 rounding of its own through some ten IP trips that end at
``ip_tol=1e-4``, so solutions agree within 2e-3 (the tolerance of the JAX
package's own float32 pin) and iteration counts within one trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch.config import SolverConfig as TSolverConfig
from dlp_admm_torch.solvers import ip_staged as tip
from dlp_admm_tpu.config import SolverConfig as JSolverConfig
from dlp_admm_tpu.solvers import ip_staged as jip

T_STAGES, NX, NU = 6, 2, 1
B_W = NX + NU
A_DYN = np.array([[1.0, 0.1], [0.0, 1.0]])
B_DYN = np.array([[0.005], [0.1]])
REF = np.stack([np.linspace(0.8, -0.5, T_STAGES), np.zeros(T_STAGES)],
               axis=-1)
U_MAX = 0.8
TOL = 1e-9


def _params(x_inits, dtype=np.float64):
    """Per-lane, per-stage parameters (numpy) for initial states [S, NX]."""
    return {k: v.astype(dtype) for k, v in _params64(x_inits).items()}


def _params64(x_inits):
    s = len(x_inits)
    first = np.zeros((s, T_STAGES))
    first[:, 0] = 1.0
    last = np.zeros((s, T_STAGES))
    last[:, -1] = 1.0
    return dict(first=first, last=last,
                ref=np.broadcast_to(REF, (s, T_STAGES, NX)).copy(),
                init=np.broadcast_to(np.asarray(x_inits)[:, None],
                                     (s, T_STAGES, NX)).copy())


def _spec(xp, stage_eq=False, link=True, dtype=np.float64):
    """The tracking NLP written once for both frameworks (``xp`` = jnp or
    torch); ``stage_eq`` pins u on the last stage, ``link=False`` drops the
    dynamics rows."""
    a_dyn = xp.asarray(A_DYN.astype(dtype))
    b_dyn = xp.asarray(B_DYN.astype(dtype))

    def f_stage(w, p):
        x, u = w[:NX], w[NX:]
        return xp.sum((x - p["ref"]) ** 2) + 0.1 * xp.sum(u ** 2)

    def ce_link(w_prev, w, p):
        if not link:
            return xp.zeros((0,), dtype=w.dtype)
        x_prev = xp.where(p["first"] > 0, p["init"], w_prev[:NX])
        return w[:NX] - (a_dyn @ x_prev + b_dyn @ w[NX:])

    def ce_stage(w, p):
        if stage_eq:
            return p["last"] * w[NX:]
        return xp.zeros((0,), dtype=w.dtype)

    def ci_stage(w, p):
        u = w[NX:]
        return xp.concatenate([U_MAX + u, U_MAX - u]) if xp is jnp \
            else xp.cat([U_MAX + u, U_MAX - u])

    return f_stage, ce_link, ce_stage, ci_stage


def _solve_both(x_inits, ip_tol, dtype=np.float64, **spec_kw):
    p = _params(x_inits, dtype)
    s = len(x_inits)
    w0 = np.zeros((s, T_STAGES, B_W), dtype)
    spec_kw["dtype"] = dtype
    jsol = jax.vmap(lambda w, pp: jip.solve_staged(
        jip.StagedNLP(*_spec(jnp, **spec_kw)), w, pp,
        JSolverConfig(ip_iters=40, ip_tol=ip_tol)))(
            jnp.asarray(w0), {k: jnp.asarray(v) for k, v in p.items()})
    tsol = tip.solve_staged(
        tip.StagedNLP(*_spec(torch, **spec_kw)), torch.as_tensor(w0),
        {k: torch.as_tensor(v) for k, v in p.items()},
        TSolverConfig(ip_iters=40, ip_tol=ip_tol))
    return jsol, tsol


def _assert_same(jsol, tsol):
    np.testing.assert_array_equal(tsol.iterations.numpy(),
                                  np.asarray(jsol.iterations))
    np.testing.assert_array_equal(tsol.converged.numpy(),
                                  np.asarray(jsol.converged))
    for name in ("w", "y_link", "y_stage", "z", "s"):
        np.testing.assert_allclose(getattr(tsol, name).numpy(),
                                   np.asarray(getattr(jsol, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_allclose(tsol.kkt_error.numpy(),
                               np.asarray(jsol.kkt_error), rtol=0, atol=TOL)
    # one solve + one refinement per trip (float64); the loop stops when
    # the slowest lane is done
    assert tsol.block_solves == 2 * int(tsol.iterations.max())


@pytest.mark.parametrize("x_inits", [[[1.0, 0.0]],
                                     [[1.0, 0.0], [0.4, -0.3], [-0.6, 0.5]]],
                         ids=["one_lane", "three_lanes"])
def test_constrained_tracking(x_inits):
    jsol, tsol = _solve_both(x_inits, 1e-8)
    assert bool(tsol.converged.all())
    _assert_same(jsol, tsol)
    # the control bound is active (an interior optimum would make the
    # comparison vacuous)
    assert float(tsol.w[0, :, NX:].abs().max()) > 0.75


@pytest.mark.parametrize("x_inits", [[[1.0, 0.0]], [[1.0, 0.0], [0.2, 0.1]]],
                         ids=["one_lane", "two_lanes"])
def test_stage_equalities(x_inits):
    jsol, tsol = _solve_both(x_inits, 1e-8, stage_eq=True)
    _assert_same(jsol, tsol)
    assert float(tsol.w[:, -1, NX:].abs().max()) < 1e-6


def test_no_link_rows():
    """ml = 0 (the edge NLP's shape): the stages decouple, one shared line
    search."""
    jsol, tsol = _solve_both([[1.0, 0.0], [0.0, 1.0]], 1e-8, link=False)
    assert tsol.y_link.shape == (2, T_STAGES, 0)
    _assert_same(jsol, tsol)


def test_lanes_freeze_independently():
    """A lane's result does not depend on the other lanes in the batch."""
    _, both = _solve_both([[1.0, 0.0], [-0.9, 0.7]], 1e-8)
    _, alone = _solve_both([[-0.9, 0.7]], 1e-8)
    torch.testing.assert_close(both.w[1:], alone.w, rtol=0, atol=1e-13)
    assert int(both.iterations[1]) == int(alone.iterations[0])


# -- float32: equilibrated stage solves, two refinement passes ---------------

@pytest.mark.parametrize("spec_kw", [dict(), dict(stage_eq=True),
                                     dict(link=False)],
                         ids=["tracking", "stage_eq", "no_link"])
def test_float32_matches_jax(spec_kw):
    jsol, tsol = _solve_both([[1.0, 0.0], [0.4, -0.3]], 1e-4,
                             dtype=np.float32, **spec_kw)
    assert tsol.w.dtype == torch.float32
    assert np.asarray(jsol.w).dtype == np.float32
    # the link-free problem stalls at a KKT error of 0.8 in float32 on both
    # sides (every trip's step is rejected): the same verdict is the parity
    np.testing.assert_array_equal(tsol.converged.numpy(),
                                  np.asarray(jsol.converged))
    assert bool(tsol.converged.all()) == ("link" not in spec_kw)
    np.testing.assert_allclose(tsol.kkt_error.numpy(),
                               np.asarray(jsol.kkt_error), rtol=0, atol=2e-3)
    assert np.abs(tsol.iterations.numpy()
                  - np.asarray(jsol.iterations)).max() <= 1
    for name in ("w", "y_link", "y_stage", "z", "s"):
        np.testing.assert_allclose(getattr(tsol, name).numpy(),
                                   np.asarray(getattr(jsol, name)),
                                   rtol=2e-3, atol=2e-3, err_msg=name)
    # one solve and two refinements per trip
    assert tsol.block_solves == 3 * int(tsol.iterations.max())


def test_float32_solves_are_equilibrated(monkeypatch):
    """The staged solver asks the block-Thomas wrapper for the equilibrated
    variant exactly when the data is not float64, and solves float32 data
    raised to float64."""
    seen = []
    plain = tip.thomas.block_thomas_solve

    def spy(diag, upper, rhs, equilibrate=False):
        seen.append((rhs.dtype, equilibrate))
        return plain(diag, upper, rhs, equilibrate)

    monkeypatch.setattr(tip.thomas, "block_thomas_solve", spy)
    for dtype in (np.float64, np.float32):
        _solve_both([[1.0, 0.0]], 1e-4, dtype=dtype)
    assert {(torch.float64, False), (torch.float64, True)} == set(seen)


def test_float32_literals_behave_as_in_jax():
    """``clamp(s, min=1e-300)`` in the merit's barrier underflows to a clamp
    at 0 in float32 on both sides (the slacks are kept >= 1e-12 elsewhere);
    the 1e-12 floors and ``ip_tol / 10`` are float32 normals."""
    z = np.zeros(2, np.float32)
    assert float(torch.clamp(torch.as_tensor(z), min=1e-300)[0]) == 0.0
    assert float(jnp.clip(jnp.asarray(z), 1e-300, None)[0]) == 0.0
    for lit in (1e-12, 1e-5, 1e-8, 1e-9):
        got = float(torch.clamp(torch.as_tensor(z), min=lit)[0])
        assert got == float(np.float32(lit)) > 0.0

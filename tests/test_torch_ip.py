"""The port's dense interior-point solver (``dlp_admm_torch/solvers/ip.py``)
and its linear solves (``solvers/linalg.py``) against the JAX package, on
the CPU.

The cases of ``tests/test_ip.py`` go through both solvers from the same
start: in float64 the iterates agree within 1e-10 and the iteration counts
and flags are equal (both sides run the same algorithm; the derivatives
and the LU solves sum in another order); in float32 within 1e-4 of the
solution's scale, with JAX's 64-bit mode off as on its accelerator. The
known optima of ``tests/test_ip.py`` are held too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch.config import SolverConfig as TSolverConfig
from dlp_admm_torch.solvers import ip as tip
from dlp_admm_torch.solvers.linalg import dense_solve, equil_solve
from dlp_admm_tpu.config import SolverConfig as JSolverConfig
from dlp_admm_tpu.solvers import ip as jip
from dlp_admm_tpu.solvers import linalg as jlinalg

CFG = dict(ip_iters=60, ip_tol=1e-8)
TOL = {np.float64: 1e-10, np.float32: 1e-4}


def _rng_qp():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(6, 6))
    return (r @ r.T + 6 * np.eye(6), rng.normal(size=6),
            rng.normal(size=(3, 6)), rng.normal(size=3))


def _case(name, xp):
    """``(f, ce, ci, x0, p, expected x or None)`` of a ``tests/test_ip.py``
    case, written with the array namespace ``xp`` (``jnp`` or ``torch``)."""
    def arr(*v):
        return xp.stack(list(v))

    def no(x, p):
        return x[:0] * 0.0

    rosen = (lambda x, p: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2)
    if name == "rosenbrock":
        return rosen, no, no, [-1.2, 1.0], None, [1.0, 1.0]
    if name == "quadratic_bowl":
        return (lambda x, p: ((x - p) ** 2).sum(), no, no, [0.0] * 3,
                [1.0, -2.0, 3.0], [1.0, -2.0, 3.0])
    if name == "circle":
        return (lambda x, p: x[0] + x[1],
                lambda x, p: arr(x[0] ** 2 + x[1] ** 2 - 1.0), no,
                [0.5, -0.8], None, [-2 ** -0.5, -2 ** -0.5])
    if name == "rosenbrock_on_line":
        return rosen, lambda x, p: arr(x[0] + x[1] - 1.0), no, [0.5, 0.5], \
            None, None
    if name == "active_bound":
        return (lambda x, p: (x[0] - 3.0) ** 2, no,
                lambda x, p: arr(1.0 - x[0]), [0.0], None, [1.0])
    if name == "inactive_bound":
        return (lambda x, p: (x[0] - 3.0) ** 2, no,
                lambda x, p: arr(10.0 - x[0]), [0.0], None, [3.0])
    if name == "qp":
        p_mat, q, a_mat, b = _rng_qp()
        kkt = np.block([[p_mat, a_mat.T], [a_mat, np.zeros((3, 3))]])
        want = np.linalg.solve(kkt, np.concatenate([-q, b]))[:6]
        return (lambda x, p: 0.5 * x @ p["P"] @ x + p["q"] @ x,
                lambda x, p: p["A"] @ x - p["b"], no, [0.0] * 6,
                dict(P=p_mat, q=q, A=a_mat, b=b), want)
    if name == "obca_dual":
        # separation of [0, 1] and [2, 3] as the OBCA dual: distance 1
        def f(x, p):
            b1, b2 = p["b1"], p["b2"]
            return -(-(b1 @ x[:2]) - b2 @ x[2:])

        def ce(x, p):
            return arr(p["a"] @ x[:2] + p["a"] @ x[2:])

        def ci(x, p):
            return xp.concatenate([x, arr(1.0 - (p["a"] @ x[:2]) ** 2)])
        return (f, ce, ci, [0.1, 0.6, 0.6, 0.1],
                dict(a=[1.0, -1.0], b1=[1.0, 0.0], b2=[3.0, -2.0]), None)
    raise KeyError(name)


CASES = ("rosenbrock", "quadratic_bowl", "circle", "rosenbrock_on_line",
         "active_bound", "inactive_bound", "qp", "obca_dual")


def _to(tree, conv):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: conv(v) for k, v in tree.items()}
    return conv(tree)


def _both(name, dtype):
    """Solve case ``name`` with JAX and the port from the same start."""
    jf, jce, jci, x0, p, want = _case(name, jnp)
    tf, tce, tci, _, _, _ = _case(name, torch)
    jsol = jip.solve_nlp(
        jip.NLP(jf, jce, jci), jnp.asarray(x0, dtype),
        _to(p, lambda v: jnp.asarray(v, dtype)), JSolverConfig(**CFG))
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    tsol = tip.solve_nlp(
        tip.NLP(tf, tce, tci), torch.tensor(x0, dtype=tdt),
        _to(p, lambda v: torch.tensor(np.asarray(v), dtype=tdt)),
        TSolverConfig(**CFG))
    return jsol, tsol, want


def _close(got, want, tol, name):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


@pytest.mark.parametrize("name", CASES)
def test_solve_nlp_matches_jax_float64(name):
    jsol, tsol, want = _both(name, np.float64)
    assert int(tsol.iterations) == int(jsol.iterations)
    assert bool(tsol.converged) == bool(jsol.converged)
    for field in ("x", "y", "z", "s"):
        _close(getattr(tsol, field).numpy(), getattr(jsol, field),
               TOL[np.float64], field)
    assert float(tsol.kkt_error) < 1e-7
    if want is not None:
        _close(tsol.x.numpy(), want, 1e-6, "known optimum")


@pytest.mark.parametrize("name", ("quadratic_bowl", "active_bound", "qp",
                                  "obca_dual"))
def test_solve_nlp_matches_jax_float32(name):
    with jax.enable_x64(False):
        jsol, tsol, _ = _both(name, np.float32)
        jx = np.asarray(jsol.x)
    assert tsol.x.dtype == torch.float32
    _close(tsol.x.numpy(), jx, TOL[np.float32], "x")


def test_known_multipliers_and_values():
    """``tests/test_ip.py``'s checks beyond the optimum: the active bound's
    multiplier 4, the inactive one's ~0, the OBCA dual's separation 1."""
    _, sol, _ = _both("active_bound", np.float64)
    assert abs(float(sol.z[0]) - 4.0) < 1e-5
    _, sol, _ = _both("inactive_bound", np.float64)
    assert float(sol.z[0]) < 1e-6
    _, sol, _ = _both("obca_dual", np.float64)
    assert bool(sol.converged)
    x = sol.x.numpy()
    assert abs(-(np.array([1.0, 0.0]) @ x[:2]) - np.array([3.0, -2.0])
               @ x[2:] - 1.0) < 1e-5


def test_batch_matches_single_and_jax_vmap():
    """``solve_nlp_batch`` over 4 lanes equals each lane solved alone and
    the JAX ``solve_nlp_batch`` (``tests/test_ip.py::TestBatch``)."""
    rng = np.random.default_rng(1)
    p = rng.normal(size=(4, 3))

    def f(xp):
        return lambda x, q: ((x - q) ** 2).sum() + 0.1 * (x ** 4).sum()

    def ci(xp):
        return lambda x, q: xp.stack([x[0] + 5.0])

    cfg = dict(ip_iters=60, ip_tol=1e-8)
    jb = jip.solve_nlp_batch(
        jip.NLP(f(jnp), lambda x, q: x[:0], ci(jnp)), jnp.zeros((4, 3)),
        jnp.asarray(p), JSolverConfig(**cfg))
    nlp = tip.NLP(f(torch), lambda x, q: x[:0], ci(torch))
    tb = tip.solve_nlp_batch(nlp, torch.zeros(4, 3, dtype=torch.float64),
                             torch.tensor(p), TSolverConfig(**cfg))
    assert tb.x.shape == (4, 3) and tb.iterations.shape == (4,)
    _close(tb.x.numpy(), jb.x, 1e-10, "batch vs JAX")
    np.testing.assert_array_equal(tb.iterations.numpy(), np.asarray(
        jb.iterations))
    for i in range(4):
        one = tip.solve_nlp(nlp, torch.zeros(3, dtype=torch.float64),
                            torch.tensor(p[i]), TSolverConfig(**cfg))
        _close(tb.x[i].numpy(), one.x.numpy(), 1e-12, f"lane {i}")
        assert int(one.iterations) == int(tb.iterations[i])


def test_dense_solve_singular_is_not_finite():
    """A singular system gives non-finite values (JAX's LU divides by the
    zero pivot; ``torch.linalg.solve`` would raise), and only in its own
    lane of a batch."""
    a = torch.tensor([[[1.0, 2.0], [2.0, 4.0]], [[2.0, 0.0], [0.0, 4.0]]],
                     dtype=torch.float64)
    b = torch.tensor([[1.0, 1.0], [2.0, 4.0]], dtype=torch.float64)
    x = dense_solve(a, b)
    assert not bool(torch.isfinite(x[0]).any())
    torch.testing.assert_close(x[1], torch.tensor([1.0, 1.0],
                                                  dtype=torch.float64))
    want = np.asarray(jnp.linalg.solve(jnp.asarray(a.numpy()),
                                       jnp.asarray(b.numpy())))
    assert not np.isfinite(want[0]).all()


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_equil_solve_matches_jax(rhs):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3, 6, 6)) + 6 * np.eye(6)
    a[:, ::2] *= 1e3                     # rows of 1e3 beside rows of 1
    b = rng.normal(size=(3, 6) if rhs == "vector" else (3, 6, 2))
    want = np.asarray(jlinalg.equil_solve(jnp.asarray(a), jnp.asarray(b)))
    got = equil_solve(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        np.einsum('sij,sj...->si...', a, got), b, atol=1e-9)

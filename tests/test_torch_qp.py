"""The port's batched QP solver against ``dlp_admm_tpu/solvers/qp.py``, on
the CPU.

The same numpy-seeded problems go through the JAX solver (one QP, or
``vmap`` over a batch) and the port's natively batched one, in float64 and
float32, with the condensed KKT matrix inverted by Newton-Schulz (``ns``)
and by Cholesky (``chol``), in 4 rho segments (the default) and, for the
batches and the warm start, also in 1 (the bench's). Cases: those of
``tests/test_qp.py`` and random batches of 8 at n = 12, m = 23 and n = 18,
m = 34. Both sides run the same iteration with sums taken in another order,
so the iterates agree to rounding: the solution and residuals within
``TOL[dtype]`` times the solution's scale (at least 1), iteration counts and
``converged`` flags equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch import config as tcfg
from dlp_admm_torch.solvers import qp as tqp
from dlp_admm_tpu import config as jcfg
from dlp_admm_tpu.solvers import qp as jqp

TOL = {"float64": 1e-10, "float32": 1e-4}
# the f64 budget of tests/test_qp.py; in float32 a tolerance float32 can
# meet, so that some QPs stop early and the done-masking is exercised
SOLVER = {"float64": dict(qp_iters=400, qp_tol=1e-9),
          "float32": dict(qp_iters=400, qp_tol=1e-4)}


def random_qp(rng, n, m, lead=()):
    """Random strictly convex QP(s) with box-type constraints
    (``tests/test_qp.py``'s generator, with leading batch axes)."""
    r = rng.normal(size=lead + (n, n))
    p_mat = r @ np.swapaxes(r, -1, -2) + n * np.eye(n)
    q = rng.normal(size=lead + (n,))
    a_mat = rng.normal(size=lead + (m, n))
    lo = rng.uniform(-2, -0.5, size=lead + (m,))
    hi = rng.uniform(0.5, 2, size=lead + (m,))
    return [p_mat, q, a_mat, lo, hi]


def make_case(name):
    """(p, q, a, lo, hi, x0, y0) as numpy float64; x0/y0 may be None."""
    if name == "unconstrained":
        p, q, a, _, _ = random_qp(np.random.default_rng(0), 6, 3)
        return p, q, a, np.full(3, -1e6), np.full(3, 1e6), None, None
    if name == "equality":
        rng = np.random.default_rng(1)
        p, q, a, _, _ = random_qp(rng, 8, 3)
        b = rng.normal(size=3)
        return p, q, a, b, b, None, None
    if name.startswith("inequality"):
        rng = np.random.default_rng(int(name[-1]))
        return (*random_qp(rng, 10, 6), None, None)
    if name == "active_box":
        return (2 * np.eye(1), np.array([-6.0]), np.eye(1), np.array([-1.0]),
                np.array([1.0]), None, None)
    if name == "batch5":
        rng = np.random.default_rng(5)
        probs = [random_qp(rng, 7, 4) for _ in range(5)]
        return (*(np.stack([pr[i] for pr in probs]) for i in range(5)),
                None, None)
    if name == "warm_start":
        rng = np.random.default_rng(6)
        p, q, a, lo, hi = random_qp(rng, 7, 4)
        return p, q, a, lo, hi, 0.1 * rng.normal(size=7), rng.normal(size=4)
    n, m = dict(random12=(12, 23), random18=(18, 34))[name]
    rng = np.random.default_rng(n)
    p, q, a, lo, hi = random_qp(rng, n, m, lead=(8,))
    return p, q, a, lo, hi, 0.1 * rng.normal(size=(8, n)), None


CASES = ("unconstrained", "equality", "inequality2", "inequality3",
         "inequality4", "active_box", "batch5", "warm_start", "random12",
         "random18")


def solve_both(case, dtype, kkt, segments):
    p, q, a, lo, hi, x0, y0 = make_case(case)
    batched = q.ndim == 2
    kw = dict(SOLVER[dtype], qp_kkt=kkt, qp_segments=segments)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [None if x is None else jnp.asarray(x, jd)
             for x in (p, q, a, lo, hi)]
    targs = [None if x is None else torch.as_tensor(x, dtype=td)
             for x in (p, q, a, lo, hi)]
    jw = [None if x is None else jnp.asarray(x, jd) for x in (x0, y0)]
    tw = [None if x is None else torch.as_tensor(x, dtype=td)
          for x in (x0, y0)]
    jf = jqp.solve_qp_batch if batched else jqp.solve_qp
    tf = tqp.solve_qp_batch if batched else tqp.solve_qp
    want = jax.jit(lambda *args: jf(*args[:5], jcfg.SolverConfig(**kw),
                                    *args[5:]))(*jargs, *jw)
    got = tf(*targs, tcfg.SolverConfig(**kw), *tw)
    return got, want


# every case in 4 segments; the batches and the warm start also in 1
CONFIGS = [(case, seg) for case in CASES for seg in (4, 1)
           if seg == 4 or case in ("batch5", "warm_start", "random12",
                                   "random18")]


@pytest.mark.parametrize("kkt", ["ns", "chol"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case,segments", CONFIGS)
def test_solve_qp_matches_jax(case, dtype, kkt, segments):
    got, want = solve_both(case, dtype, kkt, segments)
    scale = max(1.0, float(np.abs(np.asarray(want.x)).max()))
    for name in ("x", "y", "z", "primal_res", "dual_res"):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape and g.dtype == w.dtype, name
        s = max(scale, float(np.abs(w).max())) if name == "y" else scale
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL[dtype] * s,
                                   err_msg=name)
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    assert got.iterations.dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_batch_equals_one_qp_at_a_time(dtype):
    """The natively batched solve equals the same QPs solved one by one:
    every reduction stays inside its QP."""
    p, q, a, lo, hi, x0, _ = make_case("random18")
    td = getattr(torch, dtype)
    args = [torch.as_tensor(x, dtype=td) for x in (p, q, a, lo, hi, x0)]
    cfg = tcfg.SolverConfig(**SOLVER[dtype])
    batch = tqp.solve_qp_batch(*args[:5], cfg, x0=args[5])
    for b in range(q.shape[0]):
        one = tqp.solve_qp(*(x[b] for x in args[:5]), cfg, x0=args[5][b])
        for name, x in one._asdict().items():
            torch.testing.assert_close(getattr(batch, name)[b], x,
                                       rtol=0, atol=TOL[dtype], msg=name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_failed_cholesky_gives_nan_on_both_sides(dtype):
    """A non-SPD condensed KKT matrix under ``qp_kkt="chol"``: JAX's failed
    factor is NaN, and so is the port's (``cholesky_ex``), which raises
    nothing."""
    rng = np.random.default_rng(9)
    p, q, a, lo, hi = random_qp(rng, 6, 4, lead=(3,))
    p[1] = -p[1]                      # the second QP is not convex
    kw = dict(SOLVER[dtype], qp_kkt="chol")
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(lambda *args: jqp.solve_qp_batch(
        *args, jcfg.SolverConfig(**kw)))(
            *(jnp.asarray(x, jd) for x in (p, q, a, lo, hi)))
    got = tqp.solve_qp_batch(*(torch.as_tensor(x, dtype=td)
                               for x in (p, q, a, lo, hi)),
                             tcfg.SolverConfig(**kw))
    assert np.all(np.isnan(np.asarray(want.x[1])))
    assert torch.isnan(got.x[1]).all()
    assert not bool(got.converged[1]) and not bool(want.converged[1])
    for b in (0, 2):
        assert torch.isfinite(got.x[b]).all()
        np.testing.assert_allclose(got.x[b].numpy(), np.asarray(want.x[b]),
                                   rtol=0, atol=TOL[dtype] * 10)


def test_quadratic_from_fn_matches_jax():
    """(P, q) of a quadratic through ``torch.func`` equals JAX's and the
    closed form (``tests/test_qp.py::TestQuadraticFromFn``)."""
    rng = np.random.default_rng(7)
    p = rng.normal(size=(5, 5))
    p = p @ p.T + np.eye(5)
    q = rng.normal(size=5)
    x_ref = rng.normal(size=5)

    def jfn(x):
        return 0.5 * x @ jnp.asarray(p) @ x + jnp.asarray(q) @ x + 3.0

    def tfn(x):
        pt, qt = torch.as_tensor(p), torch.as_tensor(q)
        return 0.5 * x @ pt @ x + qt @ x + 3.0

    pj, qj = jax.jit(lambda x: jqp.quadratic_from_fn(jfn, x))(
        jnp.asarray(x_ref))
    pt, qt = tqp.quadratic_from_fn(tfn, torch.as_tensor(x_ref))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-12)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-12)
    np.testing.assert_allclose(pt.numpy(), p, atol=1e-9)
    np.testing.assert_allclose(qt.numpy(), q, atol=1e-8)

"""The ALADIN coordinator of the PyTorch port against the JAX package, on
the CPU.

Live JAX on the same inputs: ``AladinEngine.step`` on the four problems of
``tests/test_aladin.py`` (consensus quadratics with the full step and the
line search, agents on circles) and on ``examples/supply_chain_aladin.py``'s
problem, rebuilt here in both frameworks. The committed run
``tests/data/aladin_ref.npz`` (``tools/make_torch_fixture.py --profile
aladin``) holds the crossing of ``tests/test_aladin.py::
test_crossing_scenario_collision_free`` (45 MPC steps, 397 ALADIN
iterations) and the driver dispatch of ``test_driver_dispatch``. The JAX
tests' closed-form and centralized oracles are mirrored on the port.

Tolerances, float64: the engine's ``x``, ``lam`` and ``ys`` within 1e-8 of
JAX over three iterations (both run the same IP steps, the same active
sets and the same LU solve of the coupled KKT system, in another order of
summation); the crossing's states within 1e-6 with equal ALADIN iterations
per step, up to the step where JAX, its start moved by 1e-12, leaves
itself (``chaotic_from``, 22); the active sets and the line search are
discrete choices, so the runs may part there at the rounding level.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch import config as tcfg
from dlp_admm_torch.models import aladin as ta
from dlp_admm_torch.mpc import run_obca, run_pi_admm
from dlp_admm_torch.solvers.ip import NLP as TNLP
from dlp_admm_torch.solvers.ip import solve_nlp as t_solve_nlp
from dlp_admm_tpu import config as jcfg
from dlp_admm_tpu.models import aladin as ja

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURE = os.path.join(DATA, "aladin_ref.npz")
SCFG = dict(ip_iters=40, ip_tol=1e-9)
ENGINE_TOL = 1e-8
STATE_TOL = 1e-6
# the crossing steps run here: through the conflict onset (step 19, JAX's
# first step of 17 iterations) and two steps into the window
CROSSING_STEPS = 21


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Run this module's eager small-tensor work on one CPU thread (3-4x
    faster here than on eight, which contend), then restore the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return np.load(FIXTURE)


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=msg)


# -- the problems, once per framework ----------------------------------------

def _problems(m):
    """The engine problems of tests/test_aladin.py and the supply chain, in
    the array module ``m`` (``jnp`` or ``torch``): name -> (f, h,
    a_mats, b, params, x0, engine keywords)."""
    arr = (jnp.asarray if m is jnp
           else lambda a: torch.tensor(np.asarray(a, dtype=np.float64)))

    def empty(y, p):
        return y[:0] * 0.0

    def quad(y, p):
        return m.sum((y - p) ** 2)

    out = {}
    a2 = np.array([[[1.0]], [[-1.0]]])
    for name, glob in (("two_agent_average", "full_step"),
                       ("linesearch_consensus", "linesearch")):
        out[name] = (quad, empty, arr(a2), arr(np.zeros(1)),
                     arr([[3.0], [7.0]]), arr(np.zeros((2, 1))),
                     dict(rho=1.0, mu=1e4, globalization=glob))
    out["three_agent_weighted"] = (
        lambda y, p: p[0][0] * m.sum((y - p[1]) ** 2), empty,
        arr([[[1.0], [0.0]], [[-1.0], [1.0]], [[0.0], [-1.0]]]),
        arr(np.zeros(2)), (arr([[1.0], [2.0], [3.0]]),
                           arr([[0.0], [3.0], [6.0]])),
        arr(np.zeros((3, 1))), dict(rho=1.0))

    def circle(y, p):
        return (m.sum((y - p) ** 2) - 1.0).reshape(1)

    out["agents_on_circles"] = (
        quad, circle, arr([[[1.0, 0], [0, 1.0]], [[-1.0, 0], [0, -1.0]]]),
        arr(np.zeros(2)), arr([[0.0, 0.0], [1.0, 0.0]]),
        arr([[0.4, 0.4], [0.45, 0.35]]), dict(rho=5.0, mu=1e4))
    out["supply_chain"] = _supply_chain(m, arr)
    return out


# examples/supply_chain_aladin.py's problem: two companies' inventories
NX, NU, T = 3, 2, 6
NY = (T + 1) * NX + T * NU


def _supply_chain(m, arr):
    cat = jnp.concatenate if m is jnp else torch.cat

    def split(y):
        return (y[:(T + 1) * NX].reshape(T + 1, NX),
                y[(T + 1) * NX:].reshape(T, NU))

    def f(y, p):
        xs, us = split(y)
        return m.sum((xs - p["target"]) ** 2) + 0.1 * m.sum(us ** 2)

    def h(y, p):
        xs, us = split(y)
        rdyn = xs[1:] - (xs[:-1] + us @ p["b"].T - p["d"])
        return cat([xs[0] - p["x0"], rdyn.reshape(-1)])

    a0, a1 = np.zeros((T, NY)), np.zeros((T, NY))
    for t in range(T):
        a0[t, (T + 1) * NX + t * NU + 1] = 1.0     # company 0 outbound
        a1[t, (T + 1) * NX + t * NU + 0] = -1.0    # company 1 inbound
    x_init = np.array([[2.0, 1.0, 1.0], [1.5, 0.8, 1.2]])
    params = dict(
        b=arr([[[1.0, -1.0], [0.5, 0.0], [0.0, 1.0]],
               [[1.0, -0.5], [0.0, 1.0], [0.5, 0.0]]]),
        d=arr([[0.3, 0.1, 0.0], [0.0, 0.4, 0.2]]),
        target=arr([[2.0, 1.0, 1.0]] * 2), x0=arr(x_init))
    y0 = np.zeros((2, NY))
    y0[:, :(T + 1) * NX] = np.tile(x_init[:, None, :],
                                   (1, T + 1, 1)).reshape(2, -1)
    return (f, h, arr(np.stack([a0, a1])), arr(np.zeros(T)), params,
            arr(y0), dict(rho=5.0, mu=1e4,
                          scfg=dict(ip_iters=40, ip_tol=1e-8)))


def _engine(m, name, device="cpu"):
    f, h, a, b, p, x0, kw = _problems(m)[name]
    kw = dict(kw)
    scfg = kw.pop("scfg", SCFG)
    if m is jnp:
        prob = ja.AladinProblem(f=f, h=h, a_mats=a, b=b)
        return ja.AladinEngine(prob, scfg=jcfg.SolverConfig(**scfg),
                               **kw), p, x0
    prob = ta.AladinProblem(f=f, h=h, a_mats=a, b=b)
    return ta.AladinEngine(prob, scfg=tcfg.SolverConfig(**scfg),
                           device=device, **kw), p, x0


NAMES = ("two_agent_average", "three_agent_weighted", "agents_on_circles",
         "linesearch_consensus", "supply_chain")


@pytest.mark.parametrize("name", NAMES)
def test_engine_steps_match_jax(name):
    """Three ALADIN iterations from the same start: ``x``, ``lam`` and the
    agents' NLP solutions ``ys`` within 1e-8 after each, and the two
    termination residuals."""
    je, jp, jx0 = _engine(jnp, name)
    te, tp, tx0 = _engine(torch, name)
    js, ts = je.init_state(jx0), te.init_state(tx0)
    for it in range(3):
        js, jys = je.step(js, jp)
        ts, tys = te.step(ts, tp)
        for got, want, what in ((ts.x, js.x, "x"), (ts.lam, js.lam, "lam"),
                                (tys, jys, "ys")):
            _close(got, want, ENGINE_TOL, f"{what}, iteration {it}")
        _close(ts.coupling_res, js.coupling_res, ENGINE_TOL)
        _close(ts.step_norm, js.step_norm, ENGINE_TOL)


def _run(name, n_iters):
    eng, p, x0 = _engine(torch, name)
    return eng.run(x0, p, n_iters=n_iters)


def test_two_agent_average():
    """min (y1-3)^2 + (y2-7)^2 s.t. y1 = y2: both 5, multiplier -4."""
    state, ys = _run("two_agent_average", 20)
    _close(ys, 5.0, 1e-5)
    assert float(state.coupling_res) < 1e-5
    _close(state.lam[0], -4.0, 1e-4)


def test_three_agent_weighted():
    """Three agents sharing one scalar: the weighted mean 4."""
    _, ys = _run("three_agent_weighted", 30)
    _close(ys, 4.0, 1e-4)


def test_linesearch_converges_on_consensus():
    """The l1-merit line search (ALADIN_with_linesearch.ipynb) reaches the
    same consensus."""
    _, ys = _run("linesearch_consensus", 30)
    _close(ys, 5.0, 1e-4)


def test_agents_on_circles():
    """Two agents on unit circles around their anchors, coupled to agree:
    on their circles, and at the centralized oracle's point (one NLP over
    the shared point, solved by the port's IP solver)."""
    state, ys = _run("agents_on_circles", 40)
    p = torch.tensor([[0.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    assert float(state.coupling_res) < 1e-4
    _close(((ys - p) ** 2).sum(1), 1.0, 1e-4)
    nlp = TNLP(f=lambda x, q: (torch.sum((x - q[0]) ** 2)
                               + torch.sum((x - q[1]) ** 2)),
               ce=lambda x, q: torch.stack([torch.sum((x - q[0]) ** 2),
                                            torch.sum((x - q[1]) ** 2)]) - 1,
               ci=lambda x, q: x[:0])
    oracle = t_solve_nlp(nlp, torch.tensor([0.5, 0.5], dtype=torch.float64),
                         p, tcfg.SolverConfig(**SCFG))
    _close(ys[0], oracle.x, 1e-3)


def test_supply_chain_flows_agree():
    """examples/supply_chain_aladin.py's check: shipped equals received at
    convergence."""
    state, ys = _run("supply_chain", 25)
    us0 = ys[0, (T + 1) * NX:].reshape(T, NU)
    us1 = ys[1, (T + 1) * NX:].reshape(T, NU)
    assert float((us0[:, 1] - us1[:, 0]).abs().max()) < 1e-4


# -- the planner ----------------------------------------------------------------

@pytest.fixture(scope="module")
def crossing():
    """The crossing's first steps on the port (the planner and solver
    budget of test_crossing_scenario_collision_free)."""
    pl = ta.AladinUnicyclePlanner(tcfg.PiAdmmConfig(),
                                  scfg=tcfg.SolverConfig(ip_iters=25,
                                                         ip_tol=1e-7),
                                  device="cpu")
    return pl.run(n_steps=CROSSING_STEPS)


def test_committed_fixture(ref):
    assert ref["states"].shape == (46, 2, 3)
    assert ref["iterations"].shape == (45,)
    assert int(ref["iterations"].sum()) < 500
    assert 0 < int(ref["chaotic_from"]) <= 45
    assert ref["dispatch_states"].shape == (4, 2, 3)
    assert len(str(ref["commit"])) == 40


def test_crossing_matches_jax(ref, crossing):
    """Equal ALADIN iterations per step and states within 1e-6 of JAX,
    through the conflict onset."""
    states, iters = crossing
    n = min(CROSSING_STEPS, int(ref["chaotic_from"]))
    assert iters[:n].tolist() == ref["iterations"][:n].tolist()
    _close(states[:n + 1], ref["states"][:n + 1], STATE_TOL)
    # the conflict window has begun: ALADIN iterates more than once
    assert iters.max() > 10


def test_crossing_gates_so_far(crossing):
    """test_crossing_scenario_collision_free's gates on the steps run:
    finite, clearance above the scenario's 1.5 m."""
    states, _ = crossing
    assert np.all(np.isfinite(states))
    d = np.linalg.norm(states[:, 0, :2] - states[:, 1, :2], axis=-1)
    assert d.min() > 1.5


def test_driver_dispatch(ref):
    """tests/test_aladin.py::test_driver_dispatch on the port:
    ``run_obca(Formulation.ALADIN)`` reaches the planner through
    ``run_pi_admm(layout="aladin")``; its states and iterations are JAX's."""
    res = run_obca(tcfg.Formulation.ALADIN, n_steps=3, device="cpu",
                   scfg=tcfg.SolverConfig(ip_iters=15, ip_tol=1e-6))
    assert res.states.shape[0] == 4
    assert np.all(np.isfinite(res.states))
    assert "iterations" in res.extras
    assert isinstance(res.extras["planner"], ta.AladinUnicyclePlanner)
    assert res.extras["iterations"].tolist() == \
        ref["dispatch_iterations"].tolist()
    _close(res.states, ref["dispatch_states"], STATE_TOL)
    assert len(res.metrics.step_times) == 3
    assert res.metrics.iter_history == res.extras["iterations"].tolist()


def test_engine_refusals_and_float32(tmp_path):
    """Unknown globalizations and dtypes are refused, a checkpointed run
    saves its ``AladinState`` (resumed it ends where the run ended), and a
    float32 planner constructs and runs."""
    eng, p, x0 = _engine(torch, "two_agent_average")
    path = str(tmp_path / "al.npz")
    st, ys = eng.run(x0, p, n_iters=2, tol=None, checkpoint_path=path)
    st2, ys2 = eng.run(x0, p, n_iters=2, tol=None, checkpoint_path=path,
                       resume=True)
    assert torch.equal(st2.x, st.x) and torch.equal(ys2, st.x)
    with pytest.raises(ValueError, match="globalization"):
        ta.AladinEngine(eng.problem, globalization="other", device="cpu")
    with pytest.raises(TypeError, match="float64 or float32"):
        ta.AladinUnicyclePlanner(device="cpu", dtype=torch.float16)
    pl = ta.AladinUnicyclePlanner(scfg=tcfg.SolverConfig(ip_iters=15,
                                                         ip_tol=1e-4),
                                  device="cpu", dtype=torch.float32)
    res = run_pi_admm(layout="aladin", n_steps=1, device="cpu",
                      dtype=torch.float32,
                      scfg=tcfg.SolverConfig(ip_iters=15, ip_tol=1e-4))
    assert res.states.dtype == np.float32 and np.all(np.isfinite(res.states))
    assert pl.engine.problem.a_mats.dtype == torch.float32

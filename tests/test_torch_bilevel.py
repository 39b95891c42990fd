"""The bilevel and tightening planners of the PyTorch port against the JAX
package, on the CPU.

Live JAX on seeded numpy inputs: the collision-dual solves of both
variants, the fixed-dual local NLP's rows in both couplings with the
collision rows on and off, and one MPC step of each planner from one shared
mid-run carry (JAX's, carried across with ``interop``). The runs against
the committed JAX runs are in ``tests/test_torch_bilevel_runs.py``. The JAX
tests' own gates are mirrored on the port.

Tolerances, float64: the dual solves' ``lam`` and ``s`` within 1e-8 with
equal ``converged``; the NLP rows within 1e-12 (the same arithmetic in
another order of summation); states within 1e-6 of JAX (as every earlier
slice), ``elastic`` (the largest elastic slack) within 1e-12 plus 1e-6 of
its size and ``dual_kkt`` (the dual solve's KKT error at exit) within
1e-12 plus 1e-4 of its size: both are an IP iterate's slack and residual
at exit, which JAX itself, its references moved by 1e-12, moves by up to
2.6e-8 and 3.2e-7 of their size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch import config as tcfg
from dlp_admm_torch import interop
from dlp_admm_torch.models import bilevel as tb
from dlp_admm_tpu import config as jcfg
from dlp_admm_tpu.models import bilevel as jb
from dlp_admm_tpu.ops.geometry import halfspaces as j_halfspaces

SCFG = dict(ip_iters=40, ip_tol=1e-6)
STATE_TOL = 1e-6
ELASTIC_TOL = (1e-12, 1e-6)       # absolute, relative
DUAL_KKT_TOL = (1e-12, 1e-4)
PLANNERS = {"bilevel": ("BilevelObcaPlanner", dict(n_rounds=2)),
            "tightening": ("TighteningObcaPlanner", {}),
            "tightening_slack": ("TighteningSlackObcaPlanner", {})}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Run this module's eager small-tensor work on one CPU thread (3-4x
    faster here than on eight, which contend), then restore the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _port(name, **kw):
    cls, extra = PLANNERS[name]
    return getattr(tb, cls)(scfg=tcfg.SolverConfig(**SCFG), device="cpu",
                            **{**extra, **kw})


def _jax(name):
    cls, extra = PLANNERS[name]
    return getattr(jb, cls)(scfg=jcfg.SolverConfig(**SCFG), **extra)


def straight_states(x0, v, n, lane=0.0):
    x = x0 + v * 0.1 * np.arange(n)
    return np.stack([x, np.full(n, lane), np.full(n, v),
                     np.zeros(n), np.zeros(n)], axis=-1)


# -- the lower-level dual solves ---------------------------------------------

def _pair_case(seed, p_=3, t=5):
    """Seeded pairs of vehicles along a horizon: ``(a_pair, b_pair)`` from
    the JAX geometry, and a warm start of the duals and the direction."""
    rng = np.random.default_rng(seed)
    st = np.zeros((p_, 2, t, 5))
    st[..., 0] = rng.uniform(0, 30, (p_, 2, 1)) + 1.5 * np.arange(t)
    st[..., 1] = rng.uniform(-4, 4, (p_, 2, 1))
    st[..., 2] = 10.0
    st[..., 3] = rng.uniform(-0.3, 0.3, (p_, 2, t))
    a, b = j_halfspaces(jnp.asarray(st))
    return (np.asarray(a), np.asarray(b), rng.uniform(0.05, 1.0,
                                                      (p_, 2, t, 4)),
            rng.uniform(-0.7, 0.7, (p_, t, 2)))


def _lanes(lam):
    """``[P, 2, T, 4]`` -> ``[P·T, 8]``, the dual solve's lanes."""
    lam = np.asarray(lam)
    return np.concatenate([lam[:, 0], lam[:, 1]], -1).reshape(-1, 8)


@pytest.mark.parametrize("slack", [False, True])
@pytest.mark.parametrize("seed,warm", [(0, False), (2, True)])
def test_collision_duals_match_jax(slack, seed, warm):
    """Both dual variants over P·T = 15 lanes, cold and warm: equal
    ``converged`` and trips per lane, and ``lam`` (and ``s``) within 1e-8
    on every converged lane. Where a lane does not converge (the two
    vehicles overlap, so no certificate exists) a warm start is kept on
    both sides, so the whole tensor is held; a cold lane's iterate after
    its 40 trips is no solution, and JAX's own moves by up to 4e-5 there
    under a 1e-15 relative change of ``a`` (seed 0, lane 5), so the cold
    case holds only that it is finite."""
    a, b, lam_w, s_w = _pair_case(seed)
    t = lambda x: torch.tensor(x)  # noqa: E731
    jkw = dict(lam_warm=jnp.asarray(lam_w)) if warm else {}
    tkw = dict(lam_warm=t(lam_w)) if warm else {}
    if slack:
        if warm:
            jkw["s_warm"], tkw["s_warm"] = jnp.asarray(s_w), t(s_w)
        jl, js, jsol = jb.solve_collision_duals_slack(
            jnp.asarray(a), jnp.asarray(b), 1.0, jcfg.SolverConfig(**SCFG),
            **jkw)
        tl, ts, tsol = tb.solve_collision_duals_slack(
            t(a), t(b), 1.0, tcfg.SolverConfig(**SCFG), **tkw)
        ok = np.asarray(jsol.converged)
        held = slice(None) if warm else ok
        _close(ts.reshape(-1, 2)[held], np.asarray(js).reshape(-1, 2)[held],
               1e-8)
    else:
        jl, jsol = jb.solve_collision_duals(
            jnp.asarray(a), jnp.asarray(b), 1.0, jcfg.SolverConfig(**SCFG),
            **jkw)
        tl, tsol = tb.solve_collision_duals(
            t(a), t(b), 1.0, tcfg.SolverConfig(**SCFG), **tkw)
    assert tl.shape == (3, 2, 5, 4)
    ok = np.asarray(jsol.converged)
    np.testing.assert_array_equal(tsol.converged.numpy(), ok)
    held = slice(None) if warm else ok
    _close(_lanes(tl)[held], _lanes(jl)[held], 1e-8)
    assert bool(torch.isfinite(tl).all())
    np.testing.assert_array_equal(tsol.iterations.numpy(),
                                  np.asarray(jsol.iterations))


def _separated():
    states = np.stack([straight_states(0.0, 10.0, 5),
                       straight_states(10.0, 10.0, 5)])
    a, b = j_halfspaces(jnp.asarray(states))
    return torch.tensor(np.asarray(a))[None], torch.tensor(np.asarray(b))[None]


def test_separated_duals_measure_distance():
    """tests/test_bilevel.py: two rectangles 10 m apart (bumper gap 6.5 m):
    -sum b^T lam is the gap scaled by the 0.95 norm bound."""
    a, b = _separated()
    lam, sol = tb.solve_collision_duals(a, b, 1.0, tcfg.SolverConfig(**SCFG))
    assert bool(sol.converged.all())
    val = -(torch.einsum('ti,ti->t', b[0, 0], lam[0, 0])
            + torch.einsum('ti,ti->t', b[0, 1], lam[0, 1]))
    _close(val, 6.5 * 0.95, 1e-3)


def test_slack_duals_agree_with_plain():
    """tests/test_bilevel.py: the slack variant's separation is the gap,
    its direction the unit +-x axis, and A^T lam = -s."""
    a, b = _separated()
    lam, s, sol = tb.solve_collision_duals_slack(a, b, 1.0,
                                                 tcfg.SolverConfig(**SCFG))
    assert bool(sol.converged.all())
    val = -(torch.einsum('ti,ti->t', b[0, 0], lam[0, 0])
            + torch.einsum('ti,ti->t', b[0, 1], lam[0, 1]))
    _close(val, 6.5, 1e-3)
    _close(s[0, :, 0].abs(), 1.0, 1e-3)
    _close(s[0, :, 1], 0.0, 1e-3)
    g0 = torch.einsum('tij,ti->tj', a[0, 0], lam[0, 0])
    _close(g0, -s[0], 1e-4)


def test_overlap_keeps_warm_certificates():
    """tests/test_bilevel.py: overlapping rectangles have no certificate;
    no lane converges (the port stops its trips once every lane is done,
    JAX runs all of them: a frozen lane makes them the same) and the warm
    duals are kept."""
    states = np.stack([straight_states(0.0, 10.0, 3),
                       straight_states(1.0, 10.0, 3)])
    a, b = j_halfspaces(jnp.asarray(states))
    warm = torch.full((1, 2, 3, 4), 0.123, dtype=torch.float64)
    lam, sol = tb.solve_collision_duals(
        torch.tensor(np.asarray(a))[None], torch.tensor(np.asarray(b))[None],
        1.0, tcfg.SolverConfig(**SCFG), lam_warm=warm)
    assert not bool(sol.converged.any())
    _close(lam, 0.123, 0.0)


# -- the fixed-dual local NLP ------------------------------------------------

def _local_case(coupling, active, seed=3):
    """One vehicle's local NLP at 3 vehicles (K = 2 neighbour slots,
    horizon 8): a decision vector near a straight reference and seeded
    bar-state data."""
    rng = np.random.default_rng(seed)
    n, k = 8, 2
    ref_win = straight_states(5.0, 10.0, n) + rng.normal(0, 0.1, (n, 5))
    xs = ref_win + rng.normal(0, 0.2, (n, 5))
    x = np.concatenate([xs.reshape(-1), rng.normal(0, 0.5, 2 * (n - 1)),
                        rng.uniform(0, 0.1, k * (n - 1)),
                        rng.uniform(0, 0.1, 2 * k * (n - 1))])
    nb = np.stack([straight_states(x0, 10.0, n)[1:] for x0 in (-8.0, 18.0)])
    a_o, b_o = (np.asarray(v) for v in j_halfspaces(jnp.asarray(nb)))
    p = dict(init_state=ref_win[0] + 0.05, ref_win=ref_win,
             lam_self=rng.uniform(0, 1, (k, n - 1, 4)), other_b=b_o,
             lam_other=rng.uniform(0, 1, (k, n - 1, 4)),
             active=np.asarray(active))
    if coupling == "slack":
        p["s_bar"] = rng.normal(0, 0.5, (k, n - 1, 2))
        p["sgn"] = np.array([1.0, -1.0])
    else:
        p["other_a"] = a_o
    return x, p


@pytest.mark.parametrize("coupling", ["other_a", "slack"])
@pytest.mark.parametrize("active", [True, False])
def test_fixed_dual_local_rows_match_jax(coupling, active):
    """Objective, equality rows, inequality rows (the (5a) separation and
    (5b) coupling rows, elastic, then the boxes) and the warm start of one
    vehicle's local NLP, within 1e-12; with ``active`` off the collision
    rows are the constants 1 and 0."""
    ocfg = dict(num_veh=3, horizon=8, min_dis=1.0)
    jl = jb._FixedDualLocal(jcfg.ObcaConfig(**ocfg), jcfg.VehicleConfig(),
                            jnp.float64, coupling)
    tl = tb._FixedDualLocal(tcfg.ObcaConfig(**ocfg), tcfg.VehicleConfig(),
                            torch.float64, "cpu", coupling)
    x, p = _local_case(coupling, active)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    xj, xt = jnp.asarray(x), torch.tensor(x)
    for fn in ("_obj", "_ce", "_ci"):
        _close(getattr(tl, fn)(xt, tp), getattr(jl, fn)(xj, jp), 1e-12,
               msg=fn)
    _close(tl.warm(torch.tensor(p["ref_win"]), tp),
           jl.warm(jnp.asarray(p["ref_win"]), jp), 1e-12)
    sep, g = tl._raw_rows(tl.split(xt)[0], tp)
    if not active:
        assert bool((sep == 1.0).all()) and bool((g == 0.0).all())
    else:
        assert sep.shape == (2, 7) and g.shape == (2, 7, 2)


# -- the planners --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_planners():
    return {name: _jax(name) for name in PLANNERS}


@pytest.mark.parametrize("name", sorted(PLANNERS))
def test_mpc_step_from_shared_carry_matches_jax(jax_planners, name):
    """One MPC step (step 2) of each planner from JAX's carry after two
    steps, carried across with ``interop``: next state, every field of the
    exchange state and the step's numbers."""
    jp = jax_planners[name]
    st, bs = jnp.asarray(jp.refs[:, 0, :]), jp.create_state()
    for k in range(2):
        st, bs, _ = jp._mpc_step(st, bs, jnp.asarray(k, jnp.int32))
    pl = _port(name)
    tbs = interop.fixed_dual_state_from_numpy(
        {f: np.asarray(v) for f, v in bs._asdict().items()})
    tst, tbs, tinfo = pl._mpc_step(torch.tensor(np.asarray(st)), tbs, 2)
    st, bs, info = jp._mpc_step(st, bs, jnp.asarray(2, jnp.int32))
    _close(tst, st, STATE_TOL)
    got = interop.fixed_dual_state_to_numpy(tbs)
    for f, v in bs._asdict().items():
        _close(got[f], v, 1e-8, msg=f)
    _close(tinfo["elastic"], info["elastic"], *ELASTIC_TOL)
    _close(tinfo["dual_kkt"], info["dual_kkt"], *DUAL_KKT_TOL)
    assert tinfo["local_trips"] >= 1 and tinfo["dual_trips"] >= 1


def test_interop_round_trip(jax_planners):
    """FixedDualState and AladinState go across and back unchanged."""
    bs = jax_planners["tightening_slack"].create_state()
    arrays = {f: np.asarray(v) for f, v in bs._asdict().items()}
    back = interop.fixed_dual_state_to_numpy(
        interop.fixed_dual_state_from_numpy(bs))
    for f in arrays:
        np.testing.assert_array_equal(back[f], arrays[f])
    from dlp_admm_tpu.models.aladin import AladinState
    st = AladinState(x=jnp.ones((2, 3)), lam=jnp.arange(4.0),
                     coupling_res=jnp.asarray(0.5), step_norm=jnp.asarray(2.0))
    back = interop.aladin_state_to_numpy(interop.aladin_state_from_numpy(st))
    for f, v in st._asdict().items():
        np.testing.assert_array_equal(back[f], np.asarray(v))


def test_tightening_skips_collision_rows_at_t0(jax_planners):
    """At step 0 the collision rows are off (optimizer_ori.py:98-99): the
    first solve is pure tracking even with poisoned bar data; the port and
    JAX take the same step from it."""
    pl = _port("tightening")
    bs = pl.create_state()
    bs = bs._replace(b=bs.b + 100.0)
    nxt, _, _ = pl._mpc_step(pl.refs[:, 0, :], bs, 0)
    _close(nxt[:, 1], 0.0, 1e-3)
    jp = jax_planners["tightening"]
    jbs = jp.create_state()
    jnxt, _, _ = jp._mpc_step(jnp.asarray(jp.refs[:, 0, :]),
                              jbs._replace(b=jbs.b + 100.0),
                              jnp.asarray(0, jnp.int32))
    _close(nxt, jnxt, STATE_TOL)


def test_planner_defaults_and_refusals(tmp_path):
    """JAX's defaults (horizon 8, min_dis 1.0, 3 bilevel rounds, T = 7 s
    and prob 0.99 for tightening), float32 construction, and what the port
    refuses: other dtypes, unknown couplings, a checkpoint of another
    planner configuration."""
    bl = tb.BilevelObcaPlanner(device="cpu")
    assert (bl.ocfg.horizon, bl.ocfg.min_dis, bl.n_rounds) == (8, 1.0, 3)
    tg = tb.TighteningSlackObcaPlanner(device="cpu", dtype=torch.float32)
    assert (tg.vcfg.T, tg.vcfg.prob) == (7.0, 0.99)
    assert tg.refs.dtype == torch.float32 and tg.local.coupling == "slack"
    with pytest.raises(TypeError, match="float64 or float32"):
        tb.TighteningObcaPlanner(device="cpu", dtype=torch.float16)
    with pytest.raises(ValueError, match="coupling"):
        tb._FixedDualLocal(tcfg.ObcaConfig(), tcfg.VehicleConfig(),
                           torch.float64, "cpu", "other")
    path = str(tmp_path / "run.npz")
    from dlp_admm_torch.utils import save_carry
    save_carry(path, (bl.refs[:, 0, :], bl.create_state()), 1)
    other = tb.BilevelObcaPlanner(tcfg.ObcaConfig(horizon=5, min_dis=1.0),
                                  device="cpu")
    with pytest.raises(ValueError, match="shape"):
        other.run(n_steps=2, checkpoint_path=path, resume=True)


def test_float32_step_runs():
    """A float32 tightening step constructs and runs: finite, on track."""
    pl = tb.TighteningObcaPlanner(scfg=tcfg.SolverConfig(ip_iters=20,
                                                         ip_tol=1e-4),
                                  device="cpu", dtype=torch.float32)
    nxt, bs, info = pl._mpc_step(pl.refs[:, 0, :], pl.create_state(), 0)
    assert nxt.dtype == torch.float32 and bool(torch.isfinite(nxt).all())
    assert bs.lam.dtype == torch.float32
    _close(nxt[:, 1], 0.0, 1e-2)

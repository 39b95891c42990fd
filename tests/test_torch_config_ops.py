"""The PyTorch port's configs, scenarios, geometry, dynamics, pair indexing
and dual updates against the JAX package, on the same numpy inputs.

Tolerance: 1e-12 (absolute and relative) in float64 — the same closed-form
arithmetic on both sides; only libm's last-ulp rounding of the
transcendentals may differ.
"""
import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dlp_admm_torch.config as tcfg
import dlp_admm_tpu.config as jcfg
from dlp_admm_torch import scenarios as tscen
from dlp_admm_torch.coordination import dual_update as tdual
from dlp_admm_torch.ops import dynamics as tdyn
from dlp_admm_torch.ops import geometry as tgeo
from dlp_admm_torch.ops import pairs as tpairs
from dlp_admm_tpu import scenarios as jscen
from dlp_admm_tpu.coordination import dual_update as jdual
from dlp_admm_tpu.ops import dynamics as jdyn
from dlp_admm_tpu.ops import geometry as jgeo
from dlp_admm_tpu.ops import pairs as jpairs

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = torch.float64


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _states(seed, shape=(3, 7)):
    """Random vehicle states (x, y, v, heading, steer) in planner ranges."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(-50, 50, shape + (2,)), rng.uniform(0, 20, shape + (1,)),
        rng.uniform(-np.pi, np.pi, shape + (1,)),
        rng.uniform(-0.5, 0.5, shape + (1,))], axis=-1)


# -- config ------------------------------------------------------------------

DATACLASSES = ["VehicleConfig", "DualUpdateConfig", "PiAdmmConfig",
               "ObcaConfig", "SolverConfig"]
ENUMS = ["Formulation", "DualStrategy", "WindupMode"]


def _field_spec(cls):
    """(name, default, annotation) per field; enum defaults by name, since
    the two packages define their own (equal) enum classes."""
    def norm(v):
        return (type(v).__name__, v.name, v.value) \
            if isinstance(v, enum.Enum) else v
    return [(f.name, norm(f.default), f.type)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclass_fields_and_defaults(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert _field_spec(tc) == _field_spec(jc)
    assert tc.__dataclass_params__.frozen == jc.__dataclass_params__.frozen
    # properties and derived values of the default instances
    props = [p for p, v in vars(jc).items() if isinstance(v, property)]
    assert props == [p for p, v in vars(tc).items() if isinstance(v, property)]
    for p in props:
        assert getattr(tc(), p) == getattr(jc(), p), p


def test_pi_admm_per_pair_variant():
    assert dataclasses.asdict(tcfg.PiAdmmConfig.per_pair()) == \
        dataclasses.asdict(jcfg.PiAdmmConfig.per_pair())


@pytest.mark.parametrize("name", ENUMS)
def test_enum_members(name):
    je, te = getattr(jcfg, name), getattr(tcfg, name)
    assert issubclass(te, enum.Enum)
    assert [(m.name, m.value) for m in te] == [(m.name, m.value) for m in je]


# -- scenarios ---------------------------------------------------------------

@pytest.mark.parametrize("num_veh", [2, 3, 8])
def test_ref_traj_overtake(num_veh):
    for vcfg in (tcfg.VehicleConfig(), tcfg.VehicleConfig(T=7.0)):
        jv = jcfg.VehicleConfig(**dataclasses.asdict(vcfg))
        np.testing.assert_array_equal(tscen.ref_traj_overtake(vcfg, num_veh),
                                      jscen.ref_traj_overtake(jv, num_veh))


def test_other_scenarios():
    v = tcfg.VehicleConfig()
    np.testing.assert_array_equal(
        tscen.ref_traj_intersection(v, 4),
        jscen.ref_traj_intersection(jcfg.VehicleConfig(), 4))
    pc_t, pc_j = tcfg.PiAdmmConfig(num_veh=4, speeds=(4.0, 8.0, 5.0, 6.0)), \
        jcfg.PiAdmmConfig(num_veh=4, speeds=(4.0, 8.0, 5.0, 6.0))
    np.testing.assert_array_equal(tscen.pi_admm_crossing_refs(pc_t),
                                  jscen.pi_admm_crossing_refs(pc_j))
    for a, b in zip(tscen.pi_admm_overtake_refs(pc_t),
                    jscen.pi_admm_overtake_refs(pc_j)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tscen.pi_admm_initial_states(pc_t),
                                  jscen.pi_admm_initial_states(pc_j))


# -- geometry ----------------------------------------------------------------

@pytest.mark.parametrize("tightening", [False, True])
def test_halfspaces_both_forms(tightening):
    st = _states(1)
    jv, tv = jcfg.VehicleConfig(), tcfg.VehicleConfig()
    a_j, b_j = jgeo.halfspaces(jnp.asarray(st), jv, tightening)
    a_t, b_t = tgeo.halfspaces(torch.as_tensor(st), tv, tightening)
    assert a_t.dtype == b_t.dtype == F64
    np.testing.assert_allclose(_np(a_t), np.asarray(a_j), **TOL)
    np.testing.assert_allclose(_np(b_t), np.asarray(b_j), **TOL)


@pytest.mark.parametrize("base_link", [False, True])
def test_vertices_and_rotation_forms(base_link):
    st = _states(2)
    jv, tv = jcfg.VehicleConfig(), tcfg.VehicleConfig()
    np.testing.assert_allclose(
        _np(tgeo.vehicle_vertices(torch.as_tensor(st), tv, base_link)),
        np.asarray(jgeo.vehicle_vertices(jnp.asarray(st), jv, base_link)),
        **TOL)
    for tf, jf in ((tgeo.halfspaces_rot, jgeo.halfspaces_rot),
                   (tgeo.halfspaces_prob, jgeo.halfspaces_prob)):
        for x, y in zip(tf(torch.as_tensor(st), tv, base_link),
                        jf(jnp.asarray(st), jv, base_link)):
            np.testing.assert_allclose(_np(x), np.asarray(y), **TOL)


def test_normalize_angle():
    a = np.linspace(-20.0, 20.0, 257)
    np.testing.assert_allclose(
        _np(tgeo.normalize_angle(torch.as_tensor(a))),
        np.asarray(jgeo.normalize_angle(jnp.asarray(a))), **TOL)


def test_geometry_keeps_float32():
    """Constants take the caller's dtype (no silent upcast)."""
    a, b = tgeo.halfspaces_rot(torch.as_tensor(_states(3), dtype=torch.float32))
    assert a.dtype == b.dtype == torch.float32


# -- dynamics, pairs ---------------------------------------------------------

def test_bicycle_rhs():
    rng = np.random.default_rng(4)
    st, u = _states(4), rng.normal(size=(3, 7, 2))
    np.testing.assert_allclose(
        _np(tdyn.bicycle_rhs(torch.as_tensor(st), torch.as_tensor(u),
                             tcfg.VehicleConfig())),
        np.asarray(jdyn.bicycle_rhs(jnp.asarray(st), jnp.asarray(u),
                                    jcfg.VehicleConfig())), **TOL)


def test_bicycle_rhs_coupled():
    """The centralized variant (tests/test_dynamics.py:42-54's quantity)
    against JAX, and equal to the plain bicycle within rounding."""
    rng = np.random.default_rng(6)
    st, u = _states(6), rng.normal(size=(3, 7, 2))
    got = tdyn.bicycle_rhs_coupled(torch.as_tensor(st), torch.as_tensor(u))
    np.testing.assert_allclose(
        _np(got), np.asarray(jdyn.bicycle_rhs_coupled(jnp.asarray(st),
                                                      jnp.asarray(u))), **TOL)
    np.testing.assert_allclose(
        _np(got), _np(tdyn.bicycle_rhs(torch.as_tensor(st),
                                       torch.as_tensor(u))),
        rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("rollout", ["euler_rollout", "rk4_rollout"])
def test_rollouts_match_jax(rollout):
    """Euler and RK4 rollouts of the bicycle over 12 steps on a batch of
    starts (tests/test_dynamics.py:32-40), ``us [H, ...]`` time-major."""
    rng = np.random.default_rng(7)
    x0, us = _states(7, (3,)), rng.uniform(-1, 1, size=(12, 3, 2))
    got = getattr(tdyn, rollout)(tdyn.bicycle_rhs, torch.as_tensor(x0),
                                 torch.as_tensor(us), 0.1)
    want = getattr(jdyn, rollout)(jdyn.bicycle_rhs, jnp.asarray(x0),
                                  jnp.asarray(us), 0.1)
    assert got.shape == (13, 3, 5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_rk4_more_accurate_than_euler():
    """tests/test_dynamics.py:172-190 on the port: circular motion, RK4
    beats Euler against the exact circle."""
    def rhs(x, u):
        return torch.stack([-x[..., 1], x[..., 0]], dim=-1)

    x0, us, dt = torch.tensor([1.0, 0.0], dtype=F64), torch.zeros(50, 1), 0.1
    t = dt * np.arange(51)
    exact = np.stack([np.cos(t), np.sin(t)], axis=-1)
    err_eu = np.abs(_np(tdyn.euler_rollout(rhs, x0, us, dt)) - exact).max()
    err_rk = np.abs(_np(tdyn.rk4_rollout(rhs, x0, us, dt)) - exact).max()
    assert err_rk < err_eu / 100
    assert err_rk < 1e-5


@pytest.mark.parametrize("num_veh", [2, 3, 5, 16])
def test_pair_indices(num_veh):
    for a, b in zip(tpairs.pair_indices(num_veh),
                    jpairs.pair_indices(num_veh)):
        np.testing.assert_array_equal(a, b)


# -- dual update: 3 strategies x 3 windups -----------------------------------

@pytest.mark.parametrize("strategy", ["PLAIN", "PI_SIGMOID", "PI_RECIPROCAL"])
@pytest.mark.parametrize("windup", ["NONE", "SAT", "SAT_BACKCALC"])
def test_update_dual(strategy, windup):
    rng = np.random.default_rng(5)
    shape = (2, 7, 9)
    dual, sum_err, diff_val = (rng.normal(scale=12.0, size=shape)
                               for _ in range(3))
    r = rng.normal(scale=8.0, size=shape)
    d_min = rng.uniform(0.5, 6.0, size=(7, 1))   # broadcast per step
    kw = dict(windup_sat=15.0, adaptive_rho=True, ki_adaptive=True)
    jc = jcfg.DualUpdateConfig(strategy=jcfg.DualStrategy[strategy],
                               windup=jcfg.WindupMode[windup], **kw)
    tc = tcfg.DualUpdateConfig(strategy=tcfg.DualStrategy[strategy],
                               windup=tcfg.WindupMode[windup], **kw)
    js = jdual.DualState(jnp.asarray(dual), jnp.asarray(sum_err),
                         jnp.asarray(diff_val), jnp.asarray(2.0))
    ts = tdual.DualState(*(torch.as_tensor(a) for a in (dual, sum_err,
                                                         diff_val)),
                         torch.tensor(2.0, dtype=F64))
    got = tdual.update_dual(ts, torch.as_tensor(r), torch.as_tensor(d_min), tc)
    want = jdual.update_dual(js, jnp.asarray(r), jnp.asarray(d_min), jc)
    for name, x, y in zip(tdual.DualState._fields, got, want):
        np.testing.assert_allclose(_np(x), np.asarray(y), err_msg=name, **TOL)


@pytest.mark.parametrize("strategy", ["PLAIN", "PI_SIGMOID", "PI_RECIPROCAL"])
def test_update_dual_per_lane(strategy):
    """``lane_dims=1``: a batch of 3 lanes (one scenario each) gives each
    lane the JAX update of that lane alone; the adaptive rho takes each
    lane's own minimum distance, not the minimum over all lanes."""
    rng = np.random.default_rng(8)
    shape = (3, 6, 2, 2, 5)                      # [S, P, sides, xy, H+1]
    dual, sum_err, diff_val, r = (rng.normal(scale=9.0, size=shape)
                                  for _ in range(4))
    d_min = rng.uniform(0.5, 6.0, size=(3, 6, 1, 1, 1))
    rho = rng.uniform(1.0, 5.0, size=3)
    kw = dict(windup_sat=15.0, adaptive_rho=True)
    jc = jcfg.DualUpdateConfig(strategy=jcfg.DualStrategy[strategy], **kw)
    tc = tcfg.DualUpdateConfig(strategy=tcfg.DualStrategy[strategy], **kw)
    got = tdual.update_dual(
        tdual.DualState(*(torch.as_tensor(a) for a in (dual, sum_err,
                                                       diff_val, rho))),
        torch.as_tensor(r), torch.as_tensor(d_min), tc, lane_dims=1)
    assert got.rho.shape == (3,)
    for s in range(3):
        want = jdual.update_dual(
            jdual.DualState(*(jnp.asarray(a[s]) for a in (dual, sum_err,
                                                          diff_val, rho))),
            jnp.asarray(r[s]), jnp.asarray(d_min[s]), jc)
        for name, x, y in zip(tdual.DualState._fields, got, want):
            np.testing.assert_allclose(_np(x[s]), np.asarray(y),
                                       err_msg=name, **TOL)
    z = tdual.init_dual_state((2, 3), 2.5, F64)
    zj = jdual.init_dual_state((2, 3), 2.5, jnp.float64)
    for name, x, y in zip(tdual.DualState._fields, z, zj):
        np.testing.assert_array_equal(_np(x), np.asarray(y), err_msg=name)

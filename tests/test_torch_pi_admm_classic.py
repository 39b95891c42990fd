"""The classic (stacked) PI-ADMM layout of the PyTorch port against the JAX
package, on the CPU.

The JAX outputs come from the committed run
``tests/data/pi_admm_classic_ref.npz`` (``tools/make_torch_fixture.py
--profile classic``): ``run_pi_admm()``'s 45 steps, the step from which the
JAX run itself, its start moved by 1e-12, leaves itself (``chaotic_from``),
and the joint edge QP at 2 and 3 vehicles on numpy-seeded inputs. One joint
edge QP is also run through JAX live.

Tolerances: the joint edge QP within 1e-6 of JAX with the solver budget of
``tests/test_pi_admm.py::TestJointEdgeQp`` (``qp_iters=200,
qp_tol=1e-9``), where both sides stop on the same residual test after
summing in other orders; the whole run equal in iterations and within 1e-6
in states up to ``chaotic_from``; float64 throughout. The engine tests
mirror ``tests/test_pi_admm.py``'s classic cases with their own gates.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch import config as tcfg
from dlp_admm_torch.models import pi_admm as tpi
from dlp_admm_torch.mpc import run_pi_admm
from dlp_admm_tpu import config as jcfg
from dlp_admm_tpu.models import pi_admm as jpi

F64 = torch.float64
QP_TOL = 1e-6
STATE_TOL = 1e-6
FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "pi_admm_classic_ref.npz")
QP_SOLVER = dict(qp_iters=200, qp_tol=1e-9)
# tests/test_pi_admm.py's solver budget and its start 1 s from the crossing
SCFG = dict(qp_iters=120, qp_tol=1e-6)
XT_NEAR = np.array([[-3.0, 0.0, 0.0], [0.0, 6.0, -np.pi / 2]])
QP_ARGS = ("xt", "spd", "pos_old", "dual", "last_dis", "u0")


@pytest.fixture(scope="module")
def ref():
    return np.load(FIXTURE)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _qp_case(ref, v):
    inp = {k: ref[f"qp_{v}_in_{k}"] for k in QP_ARGS}
    cfg = tcfg.PiAdmmConfig(num_veh=v, speeds=tuple(inp["spd"]))
    return cfg, inp


def _port_joint(cfg, inp):
    """The port's joint edge QP on one input, as one lane."""
    args = [_t(inp[k])[None] for k in QP_ARGS]
    return tpi._solve_joint_edge_qp(*args, cfg,
                                    tcfg.SolverConfig(**QP_SOLVER))


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=msg)


def min_distance(xt):
    return float(np.linalg.norm(xt[:, 0, :2] - xt[:, 1, :2], axis=-1).min())


def _engine(dual_cfg=None, cfg=None, **kw):
    return tpi.PiAdmmEngine(cfg or tcfg.PiAdmmConfig(),
                            dual_cfg or tcfg.DualUpdateConfig(),
                            tcfg.SolverConfig(**SCFG), layout="classic",
                            device="cpu", **kw)


# -- the joint edge QP --------------------------------------------------------

@pytest.mark.parametrize("v", [2, 3])
def test_joint_edge_qp_matches_jax(ref, v):
    """n = VH + PH, m = VH + V(H-1) + 2PH: 15 and 28 at 2 vehicles, 30 and
    57 at 3; controls and the edge rollouts within 1e-6 of JAX."""
    cfg, inp = _qp_case(ref, v)
    h, p = cfg.horizon, v * (v - 1) // 2
    assert tpi.joint_edge_qp_m(cfg) == {2: 28, 3: 57}[v]
    u, hat, conv, y = _port_joint(cfg, inp)
    assert u.shape == (1, v, h) and hat.shape == (1, v, 2, h + 1)
    assert y.shape == (1, tpi.joint_edge_qp_m(cfg))
    assert v * h + p * h == {2: 15, 3: 30}[v]
    _close(u[0], ref[f"qp_{v}_out_u"], QP_TOL, "controls")
    _close(hat[0], ref[f"qp_{v}_out_hat"], QP_TOL, "edge rollouts")
    assert bool(conv[0]) == bool(ref[f"qp_{v}_out_converged"])


def test_joint_edge_qp_live_jax(ref):
    """The 2-vehicle case through JAX run live equals the fixture, and the
    port equals both."""
    cfg, inp = _qp_case(ref, 2)
    want = jpi._solve_joint_edge_qp(
        *(jnp.asarray(inp[k]) for k in QP_ARGS),
        jcfg.PiAdmmConfig(num_veh=2, speeds=tuple(inp["spd"])),
        jcfg.SolverConfig(**QP_SOLVER))
    np.testing.assert_array_equal(np.asarray(want[0]), ref["qp_2_out_u"])
    u, hat, _, _ = _port_joint(cfg, inp)
    _close(u[0], want[0], QP_TOL)
    _close(hat[0], want[1], QP_TOL)


def test_joint_equals_pair_at_two_vehicles(ref):
    """For 2 vehicles the joint problem IS the single-pair problem
    (tests/test_pi_admm.py:210-231, on the port)."""
    cfg, inp = _qp_case(ref, 2)
    uj, hatj, _, _ = _port_joint(cfg, inp)
    up, hatp, _, _ = tpi._solve_pair_edge_qp(
        _t(inp["xt"])[None], _t(inp["spd"])[None], _t(inp["pos_old"])[None],
        _t(inp["dual"])[None], _t(inp["last_dis"])[None, 0],
        _t(inp["u0"])[None], cfg, tcfg.SolverConfig(**QP_SOLVER))
    _close(uj, up, QP_TOL)
    _close(hatj, hatp, QP_TOL)


# -- the whole run ------------------------------------------------------------

def test_committed_classic_fixture(ref):
    assert ref["xt"].shape == (45, 2, 3)
    assert ref["iterations"].shape == (45,)
    assert 0 < int(ref["chaotic_from"]) <= 45
    assert len(str(ref["commit"])) == 40 and "ab_solver" in str(
        ref["profile"])
    # the paper's claim in JAX: PI-reciprocal beats plain by more than 30 %
    assert ref["ab_pi_iterations"].sum() < 0.7 * ref[
        "ab_plain_iterations"].sum()


def test_default_run_matches_jax(ref):
    """``run_pi_admm()`` with its defaults (the classic layout, all 45
    steps) on the CPU: equal iterations and states within 1e-6 up to the
    step where JAX leaves itself; finite and collision-free throughout."""
    res = run_pi_admm(device="cpu")
    eng = res.extras["engine"]
    assert eng.layout == "classic" and eng.device.type == "cpu"
    its = np.asarray(res.metrics.iter_history)
    strict = int(ref["chaotic_from"])
    assert res.states.shape == (45, 2, 3)
    np.testing.assert_array_equal(its[:strict], ref["iterations"][:strict])
    _close(res.states[:strict], ref["xt"][:strict], STATE_TOL)
    assert np.all(np.isfinite(res.states))
    assert min_distance(res.states) > 1.0


# -- tests/test_pi_admm.py's classic cases on the port ------------------------

def test_converges_and_avoids_collision():
    rec = _engine().run(xt0=XT_NEAR, n_steps=10)
    assert np.all(np.isfinite(rec.xt))
    assert rec.iterations.max() <= 100
    assert np.abs(rec.u_applied).max() > 0.05
    assert min_distance(rec.xt) > 1.0
    step_len = np.linalg.norm(np.diff(rec.xt[:, 0, :2], axis=0), axis=1)
    np.testing.assert_allclose(step_len, 0.4, atol=0.15)


def test_no_conflict_tracks_reference():
    xt0 = np.array([[-10.0, 0.0, 0.0], [0.0, 20.0, -np.pi / 2]])
    rec = _engine().run(xt0=xt0, n_steps=3)
    assert np.abs(rec.u_applied).max() < 0.02
    assert rec.iterations.max() <= 5
    np.testing.assert_allclose(rec.xt[-1, 0, 0], -10 + 3 * 0.4, atol=0.05)
    np.testing.assert_allclose(rec.xt[-1, 1, 1], 20 - 3 * 0.8, atol=0.05)


@pytest.mark.parametrize("strategy", ["PLAIN", "PI_SIGMOID"])
def test_other_strategies_run(strategy):
    dual_cfg = (tcfg.DualUpdateConfig(strategy=tcfg.DualStrategy.PLAIN,
                                      windup=tcfg.WindupMode.SAT,
                                      adaptive_rho=False)
                if strategy == "PLAIN" else tcfg.DualUpdateConfig(
                    strategy=tcfg.DualStrategy.PI_SIGMOID,
                    windup=tcfg.WindupMode.SAT_BACKCALC, windup_sat=30.0,
                    ki=3.0, adaptive_rho=False))
    rec = _engine(dual_cfg).run(xt0=XT_NEAR, n_steps=6)
    assert np.all(np.isfinite(rec.xt))
    assert min_distance(rec.xt) > 0.8


def test_classic_three_vehicles():
    cfg = tcfg.PiAdmmConfig(num_veh=3, speeds=(4.0, 8.0, 4.0))
    xt0 = np.array([[-3.0, 0.0, 0.0], [0.0, 6.0, -np.pi / 2],
                    [3.0, 4.0, np.pi]])
    rec = _engine(cfg=cfg).run(xt0=xt0, n_steps=5)
    assert np.all(np.isfinite(rec.xt))
    assert rec.xt.shape == (5, 3, 3)
    steps = np.linalg.norm(np.diff(
        np.concatenate([xt0[None, :, :2], rec.xt[:, :, :2]]), axis=0),
        axis=-1)
    assert steps.min() > 0.05


# -- what the classic layout refuses -----------------------------------------

def test_classic_refuses_the_pairwise_options():
    with pytest.raises(ValueError, match="carry_admm_state"):
        _engine(carry_admm_state=True)
    with pytest.raises(ValueError, match="run_fused_batch"):
        _engine().run_fused_batch(np.zeros((1, 2, 3)), np.zeros((1, 2, 5)),
                                  2)


def test_aladin_layout_still_raises(tmp_path):
    """``layout="aladin"`` dispatches to the ALADIN planner (its states
    include the start, its extras the planner and the iterations); it
    raises only where every layout does: on the default device without a
    card. ``plot_path`` draws its run."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_pi_admm(layout="aladin", n_steps=1)
    path = str(tmp_path / "aladin.png")
    res = run_pi_admm(layout="aladin", device="cpu", n_steps=2,
                      scfg=tcfg.SolverConfig(ip_iters=25, ip_tol=1e-7),
                      plot_path=path)
    assert os.path.getsize(path) > 0
    assert res.states.shape == (3, 2, 3) and np.all(np.isfinite(res.states))
    assert res.extras["iterations"].tolist() == [1, 1]
    assert type(res.extras["planner"]).__name__ == "AladinUnicyclePlanner"

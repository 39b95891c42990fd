"""The bilevel and tightening planners of the PyTorch port against the
committed JAX runs, on the CPU.

``tests/data/bilevel_ref.npz`` (``tools/make_torch_fixture.py --profile
bilevel``) holds ``tests/test_bilevel.py``'s 12-step runs (the bilevel
planner with 2 rounds; the tightening pair's are the first 12 steps of its
driver run), the driver's default runs that ``chip_smoke.py`` holds the
card to, and the 4-vehicle tightening of ``tests/test_multivehicle.py``.
The port runs the 12 steps (the tightening pair through ``run_obca``) and
is held to them and to the JAX tests' gates. Live JAX checks are in
``tests/test_torch_bilevel.py``.

Tolerances, float64: states within 1e-6 of JAX, per step ``elastic``
(the largest elastic slack: about 2e-8 where the collision rows hold, up
to 2.4 where stale bar data violates them) within 1e-12 plus 1e-6 of its
size, and ``dual_kkt`` (the dual solve's KKT error at exit: about 8e-7
where every lane converges, up to 6e3 where one has no certificate)
within 1e-12 plus 1e-4 of its size, up to the step where JAX, its
references moved by 1e-12, leaves itself (``<run>_chaotic_from``). Both
are an IP iterate's slack and residual at exit: JAX itself, its
references moved by 1e-12, moves them by up to 2.6e-8 and 3.2e-7 of their
size (the 4-vehicle run; 3e-11 and 1.4e-8 in the 2-vehicle runs), so the
tolerances sit 40x and 300x above that, as 1e-6 does over the states'.
"""
import os

import numpy as np
import pytest
import torch

from dlp_admm_torch import config as tcfg
from dlp_admm_torch.models import bilevel as tb
from dlp_admm_torch.mpc import run_obca

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURE = os.path.join(DATA, "bilevel_ref.npz")
SCFG = dict(ip_iters=40, ip_tol=1e-6)
STATE_TOL = 1e-6
ELASTIC_TOL = (1e-12, 1e-6)       # absolute, relative
DUAL_KKT_TOL = (1e-12, 1e-4)
PLANNERS = ("bilevel", "tightening", "tightening_slack")


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


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_committed_fixture(ref):
    for name, steps in (("bilevel", 42), ("tightening", 62),
                        ("tightening_slack", 62)):
        assert ref[f"{name}_states"].shape == (steps + 1, 2, 5)
        assert ref[f"{name}_elastic"].shape == (steps,)
        assert 0 < int(ref[f"{name}_chaotic_from"]) <= steps
    assert ref["test_bilevel_states"].shape == (13, 2, 5)
    assert ref["v4_states"].shape == (11, 4, 5)
    assert 0 < int(ref["test_bilevel_chaotic_from"]) <= 12
    assert 0 < int(ref["v4_chaotic_from"]) <= 10
    assert len(str(ref["commit"])) == 40


@pytest.fixture(scope="module")
def runs():
    """tests/test_bilevel.py's 12-step runs on the port: the bilevel
    planner with 2 rounds, the tightening pair through the driver."""
    out = {"bilevel": tb.BilevelObcaPlanner(
        scfg=tcfg.SolverConfig(**SCFG), n_rounds=2, device="cpu").run(
            n_steps=12)}
    for name, form in (("tightening", tcfg.Formulation.TIGHTENING),
                       ("tightening_slack",
                        tcfg.Formulation.TIGHTENING_SLACK)):
        res = run_obca(form, scfg=tcfg.SolverConfig(**SCFG), n_steps=12,
                       device="cpu")
        out[name] = (res.states, res.extras["infos"])
    return out


@pytest.mark.parametrize("name", PLANNERS)
def test_twelve_steps_match_jax(ref, runs, name):
    """States within 1e-6 of the committed JAX run and ``elastic`` and
    ``dual_kkt`` per step within their tolerances, up to JAX's chaotic
    step (the tightening pair's 12 steps are its driver run's first)."""
    states, infos = runs[name]
    key = "test_bilevel" if name == "bilevel" else name
    strict = min(12, int(ref[f"{key}_chaotic_from"]))
    _close(states[:strict + 1], ref[f"{key}_states"][:strict + 1],
           STATE_TOL)
    el = np.asarray([i["elastic"] for i in infos])
    kkt = np.asarray([i["dual_kkt"] for i in infos])
    _close(el[:strict], ref[f"{key}_elastic"][:strict], *ELASTIC_TOL)
    _close(kkt[:strict], ref[f"{key}_dual_kkt"][:strict], *DUAL_KKT_TOL)


@pytest.mark.parametrize("name", PLANNERS)
def test_keeps_separation(runs, name):
    """tests/test_bilevel.py's gates: finite states, and the rear vehicle
    brakes to roughly a car length plus ``min_dis`` (centre distance
    > 3.5 m)."""
    states, _ = runs[name]
    assert states.shape == (13, 2, 5)
    assert np.all(np.isfinite(states))
    d = np.linalg.norm(states[:, 0, :2] - states[:, 1, :2], axis=1)
    assert d.min() > 3.5

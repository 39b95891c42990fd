"""The consensus planner's last options in the port against JAX, live on the
CPU: the edge's proximal term (``edge_prox``), the branch commitment
(``branch_commit``, ``commit_after``, ``commit_w``) and the fixed-length
traced step ``mpc_step_trace``; and the batched step's refusal of the two
options (JAX's batch builds no edge parameters for them).

Both sides start from the same carry: the JAX flagship float64 run's
``(state, BarState)`` at step 11, inside the conflict window
(``tests/data/obca_options_ref.npz``, ``python tools/make_torch_fixture.py
--profile options``), with the flagship's float64 profile and the ADMM cap
cut to 4 iterations (``commit_after`` 2) to keep the CPU cost small. Both
sides run the same algorithm on the same data; the KKT blocks are factored
with the port's pivoted block-Thomas recursion here and with JAX's LU, so
the results agree to rounding, as in ``tests/test_torch_obca.py``: states,
``z_bar`` and ``d_bar`` within 1e-9, equal ADMM iteration counts, the
traced history within a relative 1e-6.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch import config as tcfg
from dlp_admm_torch.interop import bar_state_from_numpy, bar_state_to_numpy
from dlp_admm_torch.models.obca import BarState
from dlp_admm_torch.models.obca import ConsensusObcaPlanner as TPlanner
from dlp_admm_torch.parallel.consensus_spmd import make_consensus_spmd_step
from dlp_admm_tpu import config as jcfg
from dlp_admm_tpu.models.obca import BarState as JBarState
from dlp_admm_tpu.models.obca import ConsensusObcaPlanner as JPlanner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "obca_options_ref.npz")
OCFG = dict(horizon=8, min_dis=0.1, rho=100.0, max_admm_iters=4)
SCFG = dict(ip_iters=40, ip_tol=1e-6)
PLANNER = dict(local_prox=700.0, prox_growth=1.5, prox_tau_max=3.0e10)
STEP = 11
TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carry():
    """JAX's flagship carry at step 11: numpy state and ``BarState``."""
    ref = np.load(FIXTURE)
    return ref["carry_state"], {f: ref[f"carry_bs_{f}"]
                                for f in BarState._fields}


def _planners(**kw):
    return (JPlanner(jcfg.ObcaConfig(**OCFG), scfg=jcfg.SolverConfig(**SCFG),
                     **PLANNER, **kw),
            TPlanner(tcfg.ObcaConfig(**OCFG), scfg=tcfg.SolverConfig(**SCFG),
                     device="cpu", **PLANNER, **kw))


def _jax_bs(bs):
    return JBarState(**{k: jnp.asarray(v) for k, v in bs.items()})


def _close(got, want, name, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float), rtol=0,
                               atol=tol, err_msg=name)


@pytest.mark.parametrize("kw", [dict(edge_prox=1.0),
                                dict(branch_commit=True, commit_after=2)],
                         ids=["edge_prox", "branch_commit"])
def test_option_step_matches_jax(carry, kw):
    """One MPC step with the option from the carry: the next state, every
    ``BarState`` leaf and the iteration count as JAX's."""
    state, bs = carry
    jpl, tpl = _planners(**kw)
    want = jax.jit(jpl._mpc_step_impl)(jnp.asarray(state), _jax_bs(bs),
                                       jnp.asarray(STEP, jnp.int32))
    got = tpl._mpc_step(torch.as_tensor(state), bar_state_from_numpy(bs),
                        STEP)
    _close(got[0].numpy(), want[0], "next state")
    for k, v in bar_state_to_numpy(got[1]).items():
        _close(v, getattr(want[1], k), k)
    assert got[2] == int(want[2])
    assert bool(got[5]) == bool(want[5])
    for i in (3, 4, 8):                   # primal, dual, gap
        np.testing.assert_allclose(float(got[i]), float(want[i]), rtol=1e-6,
                                   atol=TOL)


def test_mpc_step_trace_matches_jax(carry):
    """``mpc_step_trace`` with both options on: exactly ``n_iters`` ADMM
    iterations (past the cap's early exit), the per-iteration history and
    the final carry, ``d_bar`` frozen at ``commit_after``, as JAX's."""
    state, bs = carry
    n_iters = OCFG["max_admm_iters"] + 1
    jpl, tpl = _planners(edge_prox=1.0, branch_commit=True, commit_after=2)
    j_c, j_hist = jpl.mpc_step_trace(jnp.asarray(state), _jax_bs(bs),
                                     jnp.asarray(STEP, jnp.int32), n_iters)
    t_c, t_hist = tpl.mpc_step_trace(torch.as_tensor(state),
                                     bar_state_from_numpy(bs), STEP, n_iters)
    assert sorted(t_hist) == sorted(j_hist)
    for k, v in j_hist.items():
        assert t_hist[k].shape == v.shape, k
        np.testing.assert_allclose(t_hist[k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=TOL, err_msg=k)
    assert int(t_c["it"]) == int(j_c["it"]) == n_iters
    for k in ("xs", "loc_x", "d_bar", "prox_tau"):
        _close(t_c[k].numpy(), j_c[k], k)
    for k, v in bar_state_to_numpy(t_c["bs"]).items():
        _close(v, getattr(j_c["bs"], k), k)
    assert np.abs(t_c["d_bar"].numpy()).max() > 0.5    # frozen, unit rows


def test_committed_options_fixture():
    """The fixture is the tool's: its profile is ``OPTIONS`` with the
    flagship's float64 planner, its carry is at ``OPTIONS["step"]`` (this
    file's step), and every run has its chaos flag."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", os.path.join(ROOT, "tools",
                                           "make_torch_fixture.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ref = np.load(FIXTURE)
    prof = json.loads(str(ref["profile"]))
    want = json.loads(json.dumps(dict(tool.OPTIONS,
                                      planner=tool.PROFILES["f64"]),
                                 sort_keys=True))
    assert prof == want and prof["step"] == STEP
    assert ref["carry_state"].shape == (2, 5)
    for run in prof["runs"]:
        assert f"{run}__chaotic" in ref
    assert ref["trace__hist_primal"].shape == (prof["trace_iters"],)


@pytest.mark.parametrize("kw", [dict(edge_prox=1.0),
                                dict(branch_commit=True)],
                         ids=["edge_prox", "branch_commit"])
def test_batched_step_refuses_the_options(kw):
    """The batched (and the vehicle-sharded) step builds no ``z_prev`` or
    ``d_bar`` edge parameters, as JAX's batch (its
    ``consensus_spmd.py:182-199``): it refuses the options and says why."""
    _, tpl = _planners(**kw)
    with pytest.raises(ValueError, match="builds no edge parameters"):
        make_consensus_spmd_step(tpl)

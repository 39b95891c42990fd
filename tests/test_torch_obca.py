"""The consensus-OBCA flagship slice of the PyTorch port against the JAX
package, on the CPU in float64.

Profile: the flagship's (horizon 8, rho 100, annealed local prox 700 x 1.5,
``ip_iters=40``, ``ip_tol=1e-6``) with the ADMM cap cut to 4 iterations to
keep the CPU cost small. Both sides run the same algorithm on the same
data; the KKT blocks are factored without pivoting here and with pivoted LU
in JAX, so results agree to rounding: states and carries within 1e-9,
equal ADMM iteration counts.

In float32 (the flagship's second profile: ``ip_tol=1e-4``,
``prox_tau_max=1e9``, equilibrated stage solves, two refinement passes) each
side carries float32 rounding of its own through every IP trip, and the IP
solves stop at a KKT error of 1e-4, so two steps agree within 2e-3 on
states of up to 20 (m, m/s). The JAX float32 planner runs with JAX's 64-bit
mode off (``jax.enable_x64(False)``), as it does on its accelerator.
"""
import ast
import importlib.util
import json
import os
import subprocess
import sys

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch import config as tcfg
from dlp_admm_torch.interop import bar_state_from_numpy, bar_state_to_numpy
from dlp_admm_torch.models.obca import ConsensusObcaPlanner as TPlanner
from dlp_admm_torch.models.obca import resolve_device
from dlp_admm_torch.mpc import run_obca as t_run_obca
from dlp_admm_tpu import config as jcfg
from dlp_admm_tpu.models.obca import BarState as JBarState
from dlp_admm_tpu.models.obca import ConsensusObcaPlanner as JPlanner
from dlp_admm_tpu.mpc import run_obca as j_run_obca

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "consensus_obca_f64_ref.npz")
OCFG = dict(horizon=8, min_dis=0.1, rho=100.0, max_admm_iters=4)
SCFG = dict(ip_iters=40, ip_tol=1e-6)
PLANNER = dict(local_prox=700.0, prox_growth=1.5)
TOL = 1e-9


def _jax_planner(ocfg=OCFG, **kw):
    return JPlanner(jcfg.ObcaConfig(**ocfg), scfg=jcfg.SolverConfig(**SCFG),
                    **{**PLANNER, **kw})


def _port_planner(ocfg=OCFG, **kw):
    return TPlanner(tcfg.ObcaConfig(**ocfg), scfg=tcfg.SolverConfig(**SCFG),
                    device="cpu", **{**PLANNER, **kw})


@pytest.fixture(scope="module")
def planners():
    return _jax_planner(), _port_planner()


def _close(got, want, name, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float),
                               rtol=tol, atol=tol, err_msg=name)


def test_slice_two_steps_matches_jax(planners):
    jpl, tpl = planners
    j_states, j_its, j_res, j_flags = jpl.run(n_steps=2)
    t_states, t_its, t_res, t_flags = tpl.run(n_steps=2)
    assert t_states.shape == j_states.shape == (3, 2, 5)
    _close(t_states, j_states, "states")
    np.testing.assert_array_equal(t_its, j_its)
    # residual rows: primal, dual, local/edge converged fraction, local/edge
    # worst KKT error (the port appends the consensus gap)
    _close([r[:6] for r in t_res], j_res, "residuals")
    assert t_flags == j_flags
    assert tpl.block_solves > 0


def _carry_after_step0(jpl):
    init0 = jnp.asarray(jpl.refs[:, 0, :])
    out = jpl._mpc_step(init0, jpl.create_bar_state(),
                        jnp.asarray(0, jnp.int32))
    return np.array(out[0]), {k: np.array(v)
                              for k, v in out[1]._asdict().items()}


@pytest.mark.parametrize("perturb", [0.0, 1.0], ids=["exact", "perturbed"])
def test_carry_across_from_jax_step(planners, perturb):
    """Run JAX step 0, carry its (state, BarState) into both, run step 1 on
    both. The perturbed case moves the consensus iterate and its duals off
    the converged point, so step 1 needs several ADMM iterations (annealed
    prox, dual updates and certificate exchange all exercised)."""
    jpl, tpl = planners
    st1, bs1 = _carry_after_step0(jpl)
    rng = np.random.default_rng(7)
    bs1["z_bar"] = bs1["z_bar"] + perturb * rng.normal(
        scale=0.05, size=bs1["z_bar"].shape)
    bs1["lamb_bar"] = bs1["lamb_bar"] + perturb * rng.normal(
        scale=0.5, size=bs1["lamb_bar"].shape)
    j_out = jpl._mpc_step(jnp.asarray(st1),
                          JBarState(**{k: jnp.asarray(v)
                                       for k, v in bs1.items()}),
                          jnp.asarray(1, jnp.int32))
    t_out = tpl._mpc_step(torch.as_tensor(st1),
                          bar_state_from_numpy(bs1, device="cpu"), 1)
    assert t_out[2] == int(j_out[2])                        # ADMM iterations
    if perturb:
        assert t_out[2] > 1
    _close(t_out[0], j_out[0], "next state")
    t_bs = bar_state_to_numpy(t_out[1])
    for k, v in j_out[1]._asdict().items():
        _close(t_bs[k], v, k)
    for name, i in (("primal", 3), ("dual", 4), ("nlp_ok", 6),
                    ("nlp_kkt", 7), ("gap", 8)):
        _close(t_out[i], j_out[i], name)
    assert bool(t_out[5]) == bool(j_out[5])                 # converged flag


def test_run_obca_result_matches_jax_keys():
    jres = j_run_obca(jcfg.Formulation.CONSENSUS,
                      ocfg=jcfg.ObcaConfig(**OCFG),
                      scfg=jcfg.SolverConfig(**SCFG), n_steps=2, **PLANNER)
    tres = t_run_obca(tcfg.Formulation.CONSENSUS,
                      ocfg=tcfg.ObcaConfig(**OCFG),
                      scfg=tcfg.SolverConfig(**SCFG), n_steps=2,
                      device="cpu", **PLANNER)
    assert type(tres).__name__ == type(jres).__name__ == "RunResult"
    assert set(vars(tres)) == set(vars(jres))
    assert set(tres.metrics.summary()) == set(jres.metrics.summary())
    assert set(tres.metrics.extras) == set(jres.metrics.extras)
    assert set(jres.extras) <= set(tres.extras)
    assert tres.metrics.iter_history == jres.metrics.iter_history
    assert tres.extras["converge_flags"] == jres.extras["converge_flags"]
    _close(tres.states, jres.states, "states")
    for k in ("primal", "dual"):
        _close(tres.metrics.extras[k], jres.metrics.extras[k], k)
    assert len(tres.metrics.step_times) == 2       # one wall time per step
    st, bs = tres.extras["planner"].carry
    assert st.device.type == "cpu" and all(
        x.device.type == "cpu" for x in bs)


def _fixture_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", os.path.join(ROOT, "tools",
                                           "make_torch_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_committed_fixture_matches_jax_run():
    """The committed JAX reference run (``tools/make_torch_fixture.py``)
    is what the JAX package computes here: its first 2 steps, rerun."""
    tool = _fixture_tool()
    ref = np.load(FIXTURE)
    assert json.loads(str(ref["profile"])) == json.loads(
        json.dumps(tool.PROFILE, sort_keys=True))
    assert ref["states"].shape == (43, 2, 5) and len(ref["iterations"]) == 42
    states, its, prs, dus, _, oks, kkts, gaps = tool.make_planner().run_scan(
        n_steps=2, return_health=True)
    _close(states, ref["states"][:3], "states", tol=1e-12)
    np.testing.assert_array_equal(its, ref["iterations"][:2])
    for name, got in (("primal", prs), ("dual", dus), ("nlp_ok", oks),
                      ("nlp_kkt", kkts), ("gaps", gaps)):
        _close(got, ref[name][:2], name, tol=1e-12)


# -- more than two vehicles (the wide kernel's widths on the card) -----------

V4_FIXTURE = os.path.join(ROOT, "tests", "data",
                          "consensus_obca_v4_f64_ref.npz")


def test_committed_v4_fixture():
    """The committed 4-vehicle JAX run (``tools/make_torch_fixture.py
    --profile v4``) is ``tests/test_multivehicle.py``'s configuration and
    passes that test's own checks."""
    tool = _fixture_tool()
    ref = np.load(V4_FIXTURE)
    prof = tool.PROFILES["v4"]
    assert json.loads(str(ref["profile"])) == json.loads(
        json.dumps(prof, sort_keys=True))
    assert prof["ocfg"] == dict(num_veh=4, horizon=8, min_dis=0.1,
                                max_admm_iters=5, rho=100.0)
    assert ref["states"].shape == (5, 4, 5) and len(ref["iterations"]) == 4
    assert ref["capped_states"].shape == (2, 4, 5)
    assert ref["v3_capped_states"].shape == (2, 3, 5)
    assert ref["capped_iterations"].tolist() == [2]
    states = ref["states"]
    np.testing.assert_allclose(states[:, 0, 0], 2.0 * np.arange(5), atol=0.5)
    np.testing.assert_allclose(states[:, 2, 0], 2.0 * np.arange(5), atol=0.5)
    lane_y = np.array([0.0, 0.0, 6.0, 6.0])
    assert np.abs(states[:, :, 1] - lane_y[None]).max() < 2.0


def test_three_vehicle_capped_step_matches_jax():
    """The multi-vehicle path (neighbour slots, pair gating at 3 pairs, the
    edge problem's 3 pairs) against the JAX planner on the CPU: the first
    step of the 4-vehicle configuration with 3 vehicles and the ADMM cap cut
    to 2 (KKT widths 26 and 45; on the card 45 is the wide kernel's). The
    4-vehicle step takes about 45 s on the CPU; the card holds it and the
    4 steps against the same fixture (``chip_smoke.py`` phase 6)."""
    ref = np.load(V4_FIXTURE)
    prof = json.loads(str(ref["profile"]))
    res = t_run_obca(
        tcfg.Formulation.CONSENSUS,
        ocfg=tcfg.ObcaConfig(**dict(prof["ocfg"], num_veh=3,
                                    max_admm_iters=prof["capped_admm_iters"])),
        scfg=tcfg.SolverConfig(**prof["scfg"]), n_steps=1, device="cpu",
        **prof["planner"])
    assert res.metrics.iter_history == ref["v3_capped_iterations"].tolist()
    _close(res.states, ref["v3_capped_states"], "states")
    assert res.extras["planner"].block_solves > 0


# -- pieces of the planner ---------------------------------------------------

@pytest.mark.parametrize("mode", ["frozen", "track_local", "track_edge"])
def test_create_and_shift_bar_state_match_jax(mode):
    jpl, tpl = _jax_planner(lamb_ij_mode=mode), _port_planner(
        lamb_ij_mode=mode)
    jbs, tbs = jpl.create_bar_state(), tpl.create_bar_state()
    for jb, tb in ((jbs, tbs), (jpl.shift_bar_state(jbs),
                                tpl.shift_bar_state(tbs))):
        got = bar_state_to_numpy(tb)
        for k, v in jb._asdict().items():
            _close(got[k], v, k, tol=1e-14)
    assert bool(tpl.check_converge(tbs)) == bool(jpl.check_converge(jbs))
    # the reference warm start of the locals
    ref_win = jpl.refs[:, :OCFG["horizon"]]
    mask = jnp.ones((2, 1))
    want = jpl._local_warm(ref_win, jpl._local_params(
        jbs, jpl.refs[:, 0], ref_win, jnp.asarray(100.0), mask))
    got = tpl._local_warm(tpl._ref_window(0), tbs,
                          torch.ones(2, 1, dtype=torch.float64))
    _close(got, want, "local warm start", tol=1e-14)


def test_interop_round_trip(planners):
    jpl, _ = planners
    arrays = {k: np.asarray(v)
              for k, v in jpl.create_bar_state()._asdict().items()}
    back = bar_state_to_numpy(bar_state_from_numpy(arrays))
    assert set(back) == set(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    # a JAX BarState itself is accepted too (field-wise np.asarray)
    bs = bar_state_from_numpy(jpl.create_bar_state())
    assert bs.z_bar.dtype == torch.float64


def test_reference_window_clamps_like_dynamic_slice(planners):
    _, tpl = planners
    n, length = OCFG["horizon"], tpl.refs.shape[1]
    torch.testing.assert_close(tpl._ref_window(10 ** 6),
                               tpl.refs[:, length - n:], rtol=0, atol=0)
    torch.testing.assert_close(tpl._ref_window(-3), tpl.refs[:, :n],
                               rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(branch_commit=True),
                                dict(edge_prox=1.0)],
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_unported_options_raise(kw):
    """The planner takes both options (``tests/test_torch_obca_options.py``
    holds its runs against JAX); the batched step, which JAX's batch cannot
    run them in either, refuses them."""
    tpl = TPlanner(device="cpu", **kw)
    assert tpl.branch_commit == kw.get("branch_commit", False)
    assert tpl.edge_prox == kw.get("edge_prox", 0.0)
    from dlp_admm_torch.parallel.consensus_spmd import (
        make_consensus_spmd_step)
    with pytest.raises(ValueError, match="builds no edge parameters"):
        make_consensus_spmd_step(tpl)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int64])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError, match="float64 or float32"):
        TPlanner(device="cpu", dtype=dtype)


def test_run_obca_rejects_unported_formulations(tmp_path):
    """No formulation is refused any more: BILEVEL reaches the bilevel
    planner (on the CPU when asked; without a card the default device
    raises, as for every planner), and ``plot_path`` draws its run."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_run_obca(tcfg.Formulation.BILEVEL, n_steps=1)
    path = str(tmp_path / "bilevel.png")
    res = t_run_obca(tcfg.Formulation.BILEVEL, n_steps=1, device="cpu",
                     scfg=tcfg.SolverConfig(ip_iters=30, ip_tol=1e-6),
                     n_rounds=1, plot_path=path)
    assert type(res.extras["planner"]).__name__ == "BilevelObcaPlanner"
    assert res.states.shape == (2, 2, 5) and np.all(np.isfinite(res.states))
    assert os.path.getsize(path) > 0


# -- float32 -----------------------------------------------------------------

F32_OCFG = dict(OCFG, max_admm_iters=2)
F32_SCFG = dict(ip_iters=12, ip_tol=1e-4)
F32_PLANNER = dict(PLANNER, prox_tau_max=1.0e9)


def test_float32_two_steps_match_jax():
    """Two MPC steps of the float32 profile (ADMM cap 2 and 12 IP trips, to
    keep the CPU cost small) against the JAX planner."""
    with jax.enable_x64(False):
        jpl = JPlanner(jcfg.ObcaConfig(**F32_OCFG),
                       scfg=jcfg.SolverConfig(**F32_SCFG), dtype=jnp.float32,
                       **F32_PLANNER)
        j_states, j_its, j_res, _ = jpl.run(n_steps=2)
    tpl = TPlanner(tcfg.ObcaConfig(**F32_OCFG),
                   scfg=tcfg.SolverConfig(**F32_SCFG), dtype=torch.float32,
                   device="cpu", **F32_PLANNER)
    t_states, t_its, t_res, _ = tpl.run(n_steps=2)
    assert t_states.dtype == np.float32 == np.asarray(j_states).dtype
    st, bs = tpl.carry
    assert st.dtype == torch.float32 and all(
        x.dtype == torch.float32 for x in bs)
    np.testing.assert_array_equal(t_its, j_its)
    _close(t_states, j_states, "states", tol=2e-3)
    # three block solves per IP trip: the solve and two refinements
    assert tpl.block_solves > 0 and tpl.block_solves % 3 == 0


def test_float32_prox_clamp_and_growth_follow_dtype():
    kw = dict(local_prox=700.0, prox_growth=1.5, device="cpu")
    f32 = TPlanner(dtype=torch.float32, prox_tau_max=1.0e9, **kw)
    f64 = TPlanner(dtype=torch.float64, **kw)
    assert f32._prox_tau(0) == f64._prox_tau(0) == 700.0
    assert f32._prox_tau(49) == 1.0e9 and f64._prox_tau(49) == 3.0e10
    # grown in the planner's dtype, as the JAX planner does
    assert f32._prox_tau(30) == float(
        np.float32(700.0) * np.float32(1.5) ** np.float32(30))
    assert f64._prox_tau(30) == 700.0 * 1.5 ** 30
    # and every constant tensor of the planner has its dtype
    assert all(t.dtype == torch.float32 for t in f32._box)
    assert f32.refs.dtype == torch.float32
    assert all(x.dtype == torch.float32 for x in f32.create_bar_state())


def test_committed_float32_fixture():
    """The committed JAX float32 run (``tools/make_torch_fixture.py
    --profile f32``) is the profile the tool names, and passes the JAX
    bench's float32 gate (at least 39 of 42 steps under the residual
    thresholds, minimum centre distance above 3.8 m)."""
    tool = _fixture_tool()
    ref = np.load(FIXTURE.replace("f64", "f32"))
    assert json.loads(str(ref["profile"])) == json.loads(
        json.dumps(tool.PROFILES["f32"], sort_keys=True))
    assert ref["states"].shape == (43, 2, 5) and len(ref["iterations"]) == 42
    assert ref["states"].dtype == np.float32
    res_ok = (ref["primal"] <= 0.011) & (ref["dual"] <= 0.011)
    p = ref["states"][..., :2]
    assert int(res_ok.sum()) >= 39
    assert np.linalg.norm(p[:, 0] - p[:, 1], axis=-1).min() > 3.8


def test_interop_carries_float32():
    tpl = _port_planner(dtype=torch.float32, prox_tau_max=1.0e9)
    arrays = bar_state_to_numpy(tpl.create_bar_state())
    assert all(a.dtype == np.float32 for a in arrays.values())
    back = bar_state_from_numpy(arrays, dtype=torch.float32)
    assert all(x.dtype == torch.float32 for x in back)
    for k, a in arrays.items():
        np.testing.assert_array_equal(getattr(back, k).numpy(), a)


# -- the default device ------------------------------------------------------

def test_default_device_is_the_card_and_nothing_falls_back():
    """With no ``device`` argument the entry points run on the CUDA card;
    where there is none they raise instead of running on the CPU."""
    for fn in (TPlanner.__init__, t_run_obca):
        assert inspect.signature(fn).parameters["device"].default is None
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert TPlanner().refs.device.type == "cuda"
    else:
        for ask in (resolve_device, TPlanner, lambda: TPlanner(device="cuda"),
                    lambda: t_run_obca(n_steps=1),
                    lambda: t_run_obca(n_steps=1, dtype=torch.float32)):
            with pytest.raises(RuntimeError, match="CUDA card"):
                ask()


# -- the port stands alone ---------------------------------------------------

def _imported_names(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "dlp_admm_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        for name in _imported_names(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "dlp_admm_tpu"), (f, name)


def test_import_leaves_jax_out():
    code = ("import sys\n"
            "import dlp_admm_torch, dlp_admm_torch.interop, "
            "dlp_admm_torch.mpc, dlp_admm_torch.solvers.thomas\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dlp_admm_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)

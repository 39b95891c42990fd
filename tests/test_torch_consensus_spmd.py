"""The port's scenario-batched consensus-OBCA step
(``dlp_admm_torch/parallel/consensus_spmd.py``) and the planner modes it
honours, against the JAX package on the CPU.

JAX's step runs on a 1x1 ``(scenario, vehicle)`` mesh, as JAX's
``run_scenario_batch`` does (bench metric 3). Tracing and compiling one
case of it costs JAX half a minute to a minute and a half here, so its
outputs for the cases below (the five of ``tests/test_consensus_spmd.py``,
the modes, float32) are the committed file
``tests/data/consensus_spmd_cases_ref.npz``
(``python tools/make_torch_fixture.py --profile spmd``), and
``test_committed_cases_fixture_matches_jax`` reruns one case live. Both
sides take the same perturbed starts (numpy, from a seed) and the same
batched ``BarState``. Tolerances in float64: states and every ``BarState``
field within 1e-8, equal ADMM iteration counts and converged flags,
consensus gap within rtol 1e-6 (the solvers' sums and factorizations differ
in order only). In float32 (JAX's 64-bit mode off, as on its accelerator)
within 1e-2: each side carries its own float32 rounding through every IP
trip. A lane of the port's batch is held to the same scenario run alone by
the port's single planner within 1e-12: only the batch's reductions sum in
another order.
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
from dlp_admm_torch.parallel.consensus_spmd import (
    make_consensus_spmd_step as t_make_step, run_scenario_batch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
CASES_FIXTURE = os.path.join(DATA, "consensus_spmd_cases_ref.npz")
TOL = 1e-8
MIRRORED = ("two_vehicle_reference_problem",
            "four_vehicle_blocks_with_gating", "track_local_mode",
            "staged_default_mode", "annealed_prox_profile")
MODES = ("use_staged=False-edge_mode=per_step",
         "edge_mode=joint-prox_adaptive-lamb_ij_hysteresis")


def _fixture_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixture", os.path.join(ROOT, "tools",
                                           "make_torch_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cases():
    ref = np.load(CASES_FIXTURE)
    return ref, json.loads(str(ref["profile"]))


def _case(cases, name):
    """The port's planner of case ``name`` and the case's arrays: ``init``,
    ``bs`` (the batched ``BarState`` fields), ``out`` (JAX's step: ``out[i]``
    its i-th output, ``out[1]`` the ``BarState`` fields) and, where
    recorded, ``step1`` (JAX's next step from that output)."""
    ref, prof = cases
    case = prof[name]
    kw = dict(dict(use_staged=False, edge_mode="joint"),
              **case.get("planner", {}))
    dtype = getattr(torch, case.get("dtype", "float64"))
    tpl = TPlanner(tcfg.ObcaConfig(
        num_veh=case["num_veh"], horizon=case["horizon"],
        max_admm_iters=case.get("max_admm_iters", 2), rho=100.0),
        scfg=tcfg.SolverConfig(**case.get("scfg", dict(ip_iters=5,
                                                         ip_tol=1e-6))),
        dtype=dtype, device="cpu", **kw)

    def outputs(tag):
        if f"{name}__{tag}_0" not in ref:
            return None
        out = {i: ref[f"{name}__{tag}_{i}"] for i in (0, 2, 3, 4, 5, 6)}
        out[1] = {f: ref[f"{name}__{tag}_1_{f}"] for f in BarState._fields}
        return out

    return tpl, dict(init=ref[f"{name}__init"],
                     bs={f: ref[f"{name}__bs_{f}"] for f in BarState._fields},
                     out=outputs("out"), step1=outputs("step1"))


def _port_step(tpl, init, bs, step_idx=0):
    return t_make_step(tpl)(torch.as_tensor(init, dtype=tpl.dtype),
                            bar_state_from_numpy(bs, dtype=tpl.dtype),
                            step_idx)


def _compare(t_out, j_out, tol=TOL, same_counts=True):
    np.testing.assert_allclose(t_out[0].numpy(), j_out[0], rtol=0, atol=tol,
                               err_msg="next state")
    got = bar_state_to_numpy(t_out[1])
    for k, v in j_out[1].items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=tol, err_msg=k)
    if same_counts:
        np.testing.assert_array_equal(t_out[2].numpy(), j_out[2])
        np.testing.assert_array_equal(t_out[5].numpy(), j_out[5])
        np.testing.assert_allclose(t_out[6].numpy(), j_out[6], rtol=1e-6,
                                   atol=tol)


def test_committed_cases_fixture_matches_jax(cases):
    """The committed cases are what the JAX package computes: their
    configurations are the tool's, and one case (``track_local_mode``, the
    cheapest) rerun live gives the file's numbers."""
    ref, prof = cases
    tool = _fixture_tool()
    assert prof == json.loads(json.dumps(tool.SPMD_CASES, sort_keys=True))
    assert set(prof) == set(MIRRORED + MODES + ("float32_staged_profile",))
    from jax.sharding import Mesh
    from dlp_admm_tpu.parallel.consensus_spmd import make_consensus_spmd_step
    name = "track_local_mode"
    pl, init, bs = tool.spmd_case(name)
    np.testing.assert_array_equal(init, ref[f"{name}__init"])
    step = make_consensus_spmd_step(pl, Mesh(np.array(jax.devices()[:1])
                                             .reshape(1, 1),
                                             ("scenario", "vehicle")))
    _, flat = tool.spmd_outputs(step, init, bs, 0)
    for k, x in flat.items():
        np.testing.assert_allclose(x, ref[f"{name}__{k}"], rtol=0,
                                   atol=1e-12, err_msg=k)


# -- (a) the cases of tests/test_consensus_spmd.py --------------------------

@pytest.mark.parametrize("name", MIRRORED)
def test_batched_step_matches_jax_spmd_step(cases, name):
    tpl, c = _case(cases, name)
    blocks = tpl.block_solves
    t_out = _port_step(tpl, c["init"], c["bs"])
    assert t_out[0].shape == c["init"].shape
    assert t_out[2].dtype == torch.int32 and t_out[5].dtype == torch.bool
    _compare(t_out, c["out"])
    # staged solves go through the block-Thomas kernel (its plain version
    # here): the locals of every (scenario, vehicle) and every edge at once
    assert (tpl.block_solves > blocks) == tpl.use_staged


def test_batched_bar_state_carried_across_from_jax(cases):
    """JAX's batched ``BarState`` and states after step 0, carried across
    through ``interop``, give JAX's step 1 in the port."""
    tpl, c = _case(cases, "two_vehicle_reference_problem")
    assert c["step1"] is not None
    _compare(_port_step(tpl, c["out"][0], c["out"][1], step_idx=1),
             c["step1"])


# -- (b) the planner modes, in the batched step and the single planner ------

@pytest.mark.parametrize("name", MODES)
def test_modes_match_jax(cases, name):
    """One MPC step (ADMM cap 4) of 2 lanes with the modes set: the port's
    batched step against JAX's, and the port's single planner on each lane
    against the same JAX lane (JAX's batched step equals its single step by
    construction, ``tests/test_consensus_spmd.py``)."""
    tpl, c = _case(cases, name)
    j_out = c["out"]
    t_out = _port_step(tpl, c["init"], c["bs"])
    _compare(t_out, j_out)
    assert (j_out[2] > 2).all()
    one = {k: v[0] for k, v in c["bs"].items()}
    for lane in range(len(c["init"])):
        s_out = tpl._mpc_step(torch.as_tensor(c["init"][lane]),
                              bar_state_from_numpy(one), 0)
        assert s_out[2] == int(j_out[2][lane])
        np.testing.assert_allclose(s_out[0].numpy(), j_out[0][lane], rtol=0,
                                   atol=TOL)
        got = bar_state_to_numpy(s_out[1])
        for k, v in j_out[1].items():
            np.testing.assert_allclose(got[k], v[lane], rtol=0, atol=TOL,
                                       err_msg=k)
    if tpl.prox_adaptive:
        # the ratchet and the hysteresis acted: without them the same step
        # lands elsewhere
        kw = dict(use_staged=True, edge_mode="joint", local_prox=700.0,
                  prox_growth=1.5)
        plain = TPlanner(tpl.ocfg, scfg=tpl.scfg, device="cpu", **kw)
        other = _port_step(plain, c["init"], c["bs"])
        assert float((other[1].z_bar - t_out[1].z_bar).abs().max()) > 1e-6


# -- (d) float32 -------------------------------------------------------------

def test_float32_batched_step_matches_jax(cases):
    """The staged float32 profile (``ip_tol=1e-4``, ``prox_tau_max=1e9``,
    equilibrated stage solves): one step (ADMM cap 2) of 2 lanes."""
    tpl, c = _case(cases, "float32_staged_profile")
    t_out = _port_step(tpl, c["init"], c["bs"])
    assert t_out[0].dtype == torch.float32
    assert all(x.dtype == torch.float32 for x in t_out[1])
    np.testing.assert_array_equal(t_out[2].numpy(), c["out"][2])
    _compare(t_out, c["out"], tol=1e-2, same_counts=False)


# -- (c) a lane of the batch is the scenario run alone ---------------------

def test_batch_lane_equals_single_run():
    """``tests/test_obca.py``'s batch check on the port: 3 lanes (lane 0
    unperturbed, the others moved by 0.3 m) of the flagship's float64
    profile at an ADMM cap of 3 through ``run_scenario_batch`` for 2 MPC
    steps. Lane 0 stops after 1 iteration a step and the others run to the
    cap; lane 0 equals the single planner's ``run_scan`` within 1e-12, with
    equal iteration counts."""
    tpl = TPlanner(tcfg.ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                                   max_admm_iters=3),
                   scfg=tcfg.SolverConfig(ip_iters=40, ip_tol=1e-6),
                   device="cpu", local_prox=700.0, prox_growth=1.5)
    n_steps, n_scen = 2, 3
    init0 = tpl.refs[:, 0, :].numpy()
    inits = np.broadcast_to(init0, (n_scen,) + init0.shape).copy()
    rng = np.random.default_rng(1)
    inits[1:, :, :2] += 0.3 * rng.normal(size=(n_scen - 1, 2, 2))
    st_b, its_b, prs_b, dus_b, cvs_b, gaps_b = run_scenario_batch(
        tpl, inits, n_steps)
    assert st_b.shape == (n_steps + 1, n_scen, 2, 5)
    assert its_b.shape == prs_b.shape == gaps_b.shape == (n_scen, n_steps)
    assert cvs_b.dtype == bool and its_b.dtype == np.int32
    assert np.all(np.isfinite(st_b)) and tpl.block_solves > 0
    assert its_b[:, 0].tolist() == [1, 3, 3]
    st_s, its_s, prs_s, dus_s, _ = tpl.run_scan(n_steps=n_steps)
    np.testing.assert_allclose(st_b[:, 0], st_s, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(its_b[0], its_s)
    for got, want in ((prs_b[0], prs_s), (dus_b[0], dus_s)):
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_prox_weight_per_lane_follows_the_single_planner(dtype):
    """The batched step's per-lane anneal is the single planner's
    ``_prox_tau`` at every iteration, bit for bit, and JAX's
    ``local_prox * growth ** k`` in the planner's dtype (within one unit in
    the last place: the two libraries' ``pow``) with the clamp at the
    dtype's ``prox_tau_max``."""
    tau_max = 3.0e10 if dtype == "float64" else 1.0e9
    tpl = TPlanner(device="cpu", dtype=getattr(torch, dtype),
                   local_prox=700.0, prox_growth=1.5, prox_tau_max=tau_max)
    taus = tpl._prox_taus()
    assert taus.dtype == getattr(torch, dtype) and len(taus) == 50
    assert [float(x) for x in taus] == [tpl._prox_tau(k) for k in range(50)]
    with jax.enable_x64(dtype == "float64"):
        k = jnp.arange(50).astype(dtype)
        want = np.asarray(jnp.minimum(700.0 * 1.5 ** k, tau_max)
                          .astype(dtype))
    assert want.dtype == np.dtype(dtype) and float(taus[-1]) == tau_max
    np.testing.assert_allclose(taus.numpy(), want, rtol=np.finfo(dtype).eps,
                               atol=0)


def _jax_planner(num_veh, **kw):
    from dlp_admm_tpu import config as jcfg
    from dlp_admm_tpu.models.obca import ConsensusObcaPlanner as JPlanner
    return JPlanner(jcfg.ObcaConfig(num_veh=num_veh, horizon=8, rho=100.0),
                    **kw)


def test_warm_start_constructions_agree():
    """The batched step's first ``loc_x`` (the dense warm start mapped over
    lanes, ``_local_warm_one`` of ``_local_params``, as JAX builds it even
    in staged mode) equals the single planner's ``_local_warm`` and the
    JAX ``_local_warm``, at 3 vehicles with gated pairs."""
    kw = dict(gate_pairs=True, gate_thres=12.0)
    jpl = _jax_planner(3, **kw)
    tpl = TPlanner(tcfg.ObcaConfig(num_veh=3, horizon=8, rho=100.0),
                   device="cpu", **kw)
    init = tpl.refs[:, 0, :] + 0.1
    ref_win = tpl._ref_window(0)
    bs = tpl.create_bar_state()
    mask = tpl._pair_proximity_mask(bs.local_x)[tpl._pair_id]
    rho = torch.tensor(100.0, dtype=torch.float64)
    p = tpl._local_params(bs, init, ref_win, rho, mask)
    got = torch.func.vmap(tpl._local_warm_one)(ref_win, p)
    torch.testing.assert_close(got, tpl._local_warm(ref_win, bs, mask),
                               rtol=0, atol=1e-14)
    want = jpl._local_warm(jpl.refs[:, :8], jpl._local_params(
        jpl.create_bar_state(), jnp.asarray(init.numpy()), jpl.refs[:, :8],
        jnp.asarray(100.0), jnp.asarray(mask.numpy())))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-14)


def test_batched_helpers_match_jax():
    """``shift_bar_state(batch_dims=1)`` and the per-lane
    ``check_converge`` against JAX's on a batched ``BarState`` of 3
    vehicles, 2 lanes."""
    jpl = _jax_planner(3)
    tpl = TPlanner(tcfg.ObcaConfig(num_veh=3, horizon=8, rho=100.0),
                   device="cpu")
    rng = np.random.default_rng(2)
    arrays = {k: np.stack([np.asarray(v)] * 2) + 0.01 * rng.normal(
        size=(2,) + v.shape) for k, v in jpl.create_bar_state()
        ._asdict().items()}
    arrays["lamb_ij"][1] = -arrays["lamb_ij"][1]     # lane 1: bad duals
    j_bs = type(jpl.create_bar_state())(**{k: jnp.asarray(v)
                                           for k, v in arrays.items()})
    t_bs = bar_state_from_numpy(arrays)
    got = bar_state_to_numpy(tpl.shift_bar_state(t_bs, batch_dims=1))
    for k, v in jpl.shift_bar_state(j_bs, batch_dims=1)._asdict().items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    conv = torch.func.vmap(tpl.check_converge)(t_bs)
    assert conv.shape == (2,) and conv.dtype == torch.bool
    want = np.asarray(jax.vmap(jpl.check_converge)(j_bs))
    np.testing.assert_array_equal(conv.numpy(), want)
    assert want.tolist() == [True, False]


def test_batched_step_runs_on_one_device_only(cases):
    """Without process groups the mesh is 1x1 and the step is the
    one-device step, bit for bit (the vehicle-sharded step over gloo ranks
    is ``tests/test_torch_mesh.py``'s)."""
    from dlp_admm_torch.parallel.mesh import planner_mesh
    tpl, arr = _case(cases, "track_local_mode")
    mesh = planner_mesh()
    assert not mesh.distributed
    got = t_make_step(tpl, mesh)(torch.as_tensor(arr["init"]),
                                 bar_state_from_numpy(arr["bs"]), 0)
    want = _port_step(tpl, arr["init"], arr["bs"])
    for a, b in zip(got, want):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


# -- the committed JAX fixture of the bench's batch -------------------------

BATCH_FIXTURE = os.path.join(DATA, "consensus_obca_batch_f64_ref.npz")


def test_committed_batch_fixture():
    """``tools/make_torch_fixture.py --profile batch`` wrote JAX's
    ``run_scenario_batch`` of bench.py's third metric (the float64
    flagship profile, 16 starts, 0.25 m jitter from ``default_rng(0)``,
    lane 0 unperturbed); its lane 0 is the single-scenario run of
    ``consensus_obca_f64_ref.npz``."""
    ref = np.load(BATCH_FIXTURE)
    flagship = np.load(os.path.join(DATA, "consensus_obca_f64_ref.npz"))
    prof = json.loads(str(ref["profile"]))
    assert prof["n_scen"] == 16 and prof["jitter"] == 0.25
    assert prof["seed"] == 0 and prof["planner"] == json.loads(
        str(flagship["profile"]))
    n = prof["steps"]
    s = ref["states"]
    assert s.shape == (n + 1, 16, 2, 5) and ref["iterations"].shape == (16, n)
    for k in ("primal", "dual", "converged", "gaps"):
        assert ref[k].shape == (16, n), k
    init0 = flagship["states"][0]
    np.testing.assert_array_equal(s[0, 0], init0)
    moved = np.abs(s[0, 1:, :, :2] - init0[:, :2]).max(axis=(1, 2))
    assert (moved > 0).all() and (moved < 1.5).all()
    np.testing.assert_allclose(s[:, 0], flagship["states"][:n + 1],
                               rtol=0, atol=1e-8)
    np.testing.assert_array_equal(ref["iterations"][0],
                                  flagship["iterations"][:n])
    chaotic = ref["chaotic_from"]
    assert chaotic.shape == (16,) and ((chaotic >= 0) & (chaotic <= n)).all()

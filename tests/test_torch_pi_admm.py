"""The PI-ADMM pairwise engine of the PyTorch port against the JAX package,
on the CPU.

The same numpy-seeded inputs go through ``dlp_admm_tpu`` and
``dlp_admm_torch``: the unicycle rollouts, the pair and residual helpers,
the closed-form affine models, one batch of local QPs and of edge QPs, one
pairwise iteration started from a JAX carry of the bench's 16-vehicle
workload (``tests/data/pi_admm_bench_f64_ref.npz``), and the fused
whole-run driver at ``tests/test_pi_admm.py::TestFusedRunner``'s shape.
Float64 throughout, except the bench-quality slices, which run float32 as
the bench does. Both sides sum in other orders, so values agree to rounding
grown through the iterations: within ``TOL`` (1e-12) for single functions,
1e-8 on states over whole runs, and iteration counts are equal.

Within the port, exactly: one lane alone equals the same lane in a batch,
and the fused driver's records do not depend on its chunk size.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch import config as tcfg
from dlp_admm_torch.coordination import residuals as tres
from dlp_admm_torch.interop import admm_carry_from_numpy, admm_carry_to_numpy
from dlp_admm_torch.models import pi_admm as tpi
from dlp_admm_torch.mpc import run_pi_admm
from dlp_admm_torch.ops import dynamics as tdyn
from dlp_admm_torch.ops import pairs as tpairs
from dlp_admm_torch.scenarios import pi_admm_overtake_refs
from dlp_admm_tpu import config as jcfg
from dlp_admm_tpu.coordination import residuals as jres
from dlp_admm_tpu.models import pi_admm as jpi
from dlp_admm_tpu.ops import dynamics as jdyn
from dlp_admm_tpu.ops import pairs as jpairs

F64 = torch.float64
TOL = 1e-12
DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURE = os.path.join(DATA, "pi_admm_bench_f64_ref.npz")
FIXTURE_F32 = os.path.join(DATA, "pi_admm_bench_f32_ref.npz")
# the bench's solver budget (bench.py:94-96)
BENCH_SOLVER = dict(qp_iters=16, qp_tol=1e-4, qp_segments=1, qp_ns_iters=10,
                    qp_unroll=16)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def close(got, want, atol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=msg)


# -- ops ------------------------------------------------------------------

@pytest.mark.parametrize("which", ["local", "edge", "exact"])
def test_unicycle_rollouts_match_jax(which):
    rng = np.random.default_rng(11)
    xt = rng.normal(size=(3, 4, 3))
    u = rng.uniform(-0.5, 0.5, size=(3, 4, 9))
    spd = rng.uniform(2.0, 9.0, size=(3, 4))
    name = f"unicycle_rollout_{which}"
    want = getattr(jdyn, name)(jnp.asarray(xt), jnp.asarray(u),
                               jnp.asarray(spd), 0.1, 1.0)
    got = getattr(tdyn, name)(_t(xt), _t(u), _t(spd), 0.1, 1.0)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 4, 10)
        close(g, w)


def test_pairs_match_jax():
    rng = np.random.default_rng(3)
    v = 5
    per_vehicle = rng.normal(size=(v, 3, 2))
    assert tpairs.num_pairs(v) == jpairs.num_pairs(v) == 10
    gi, gj = tpairs.pair_gather(_t(per_vehicle), v)
    wi, wj = jpairs.pair_gather(jnp.asarray(per_vehicle), v)
    close(gi, wi)
    close(gj, wj)
    close(tpairs.pair_scatter_sum(gi, 2.0 * gj, v),
          jpairs.pair_scatter_sum(wi, 2.0 * wj, v))
    x, y = rng.normal(scale=2.0, size=(2, v, 7))
    np.testing.assert_array_equal(
        tpairs.proximity_mask(_t(x), _t(y), 2.0, v).numpy(),
        np.asarray(jpairs.proximity_mask(jnp.asarray(x), jnp.asarray(y),
                                         2.0, v)))
    # the reference's semantics: squared distance < unsquared threshold
    mask = tpairs.proximity_mask(_t([[0.0, 0.0], [1.2, 1.2], [10.0, 10.0]]),
                                 torch.zeros((3, 2), dtype=F64), 2.0, 3)
    assert mask.tolist() == [True, False, False]


def test_residuals_match_jax_and_reduce_per_lane():
    """The JAX functions on one lane; the port's on a batch of 3 lanes gives
    each lane's JAX value."""
    rng = np.random.default_rng(4)
    s, v, p, h1 = 3, 4, 6, 9
    pos, hat, last = rng.normal(size=(3, s, v, 2, h1))
    pos_i, hat_i, last_i = rng.normal(size=(3, s, p, 2, h1))
    rho = rng.uniform(1.0, 5.0, size=s)
    active = rng.uniform(size=(s, p)) < 0.5
    x, y = rng.normal(scale=3.0, size=(2, s, v, h1))
    got_st = tres.stacked_residuals(_t(pos), _t(hat), _t(last), _t(rho))
    got_pe = tres.per_edge_residuals(_t(pos_i), _t(hat_i), _t(last_i),
                                     _t(rho), torch.as_tensor(active))
    got_md = tres.min_pair_distance(_t(x), _t(y), v)
    for k in range(s):
        want_st = jres.stacked_residuals(pos[k], hat[k], last[k], rho[k])
        want_pe = jres.per_edge_residuals(pos_i[k], hat_i[k], last_i[k],
                                          rho[k], jnp.asarray(active[k]))
        for g, w in zip(got_st + got_pe, want_st + want_pe):
            close(g[k], w)
        close(got_md[k], jres.min_pair_distance(x[k], y[k], v))


# -- affine models and the two QP families ---------------------------------

def test_affine_models_match_jax():
    rng = np.random.default_rng(7)
    xt = rng.normal(size=(4, 3))
    spd = rng.uniform(2.0, 9.0, size=4)
    u0 = 0.3 * rng.normal(size=(4, 12))
    want = jax.jit(jax.vmap(lambda a, b: jpi._local_affine(
        a, b, 12, 0.1, 1.0)))(jnp.asarray(xt), jnp.asarray(spd))
    got = tpi._local_affine(_t(xt), _t(spd), 12, 0.1, 1.0)
    for g, w in zip(got, want):
        close(g, w)
    want = jax.jit(jax.vmap(lambda a, b, c: jpi._edge_affine(
        a, b, c, 0.1, 1.0)))(jnp.asarray(xt), jnp.asarray(spd),
                             jnp.asarray(u0))
    got = tpi._edge_affine(_t(xt), _t(spd), _t(u0), 0.1, 1.0)
    for g, w in zip(got, want):
        close(g, w)


def _small_cfg(**kw):
    return dict(dict(horizon=8, num_veh=4, speeds=(8.0, 4.0, 8.0, 4.0),
                     dis_thres=2.0), **kw)


def test_solve_local_qp_matches_jax():
    """One batch of 5 vehicles' local QPs (K = 3 AL terms each)."""
    rng = np.random.default_rng(5)
    h, b, k = 8, 5, 3
    jc, tc = jcfg.PiAdmmConfig(**_small_cfg()), tcfg.PiAdmmConfig(
        **_small_cfg())
    xt = rng.normal(size=(b, 3))
    spd = rng.uniform(3.0, 8.0, size=b)
    ref = rng.normal(size=(b, 2 * (h + 1)))
    hats, duals = rng.normal(size=(2, b, k, 2 * (h + 1)))
    al_w = (rng.uniform(size=(b, k)) < 0.7).astype(float)
    rho = rng.uniform(1.0, 5.0, size=b)
    u_warm = 0.1 * rng.normal(size=(b, h))
    jsc, tsc = (jcfg.SolverConfig(**BENCH_SOLVER),
                tcfg.SolverConfig(**BENCH_SOLVER))
    jst = jpi._local_statics(jc, jnp.float64)

    @jax.jit
    def jax_local(xt, spd, *rest):
        pos0, bm = jax.vmap(lambda a, c: jpi._local_affine(
            a, c, h, 0.1, 1.0))(xt, spd)
        return jax.vmap(lambda *a: jpi._solve_local_qp(*a, jst, jc, jsc))(
            pos0, bm, *rest)

    want = jax_local(*(jnp.asarray(a) for a in (xt, spd, ref, hats, duals,
                                                 al_w, rho, u_warm)))
    tpos0, tbm = tpi._local_affine(_t(xt), _t(spd), h, 0.1, 1.0)
    got = tpi._solve_local_qp(tpos0, tbm, _t(ref), _t(hats), _t(duals),
                              _t(al_w), _t(rho), _t(u_warm),
                              tpi._local_statics(tc, F64), tc, tsc)
    for g, w in zip(got, want):
        close(g, w, atol=1e-10 * max(1.0, float(np.abs(w).max())))


def test_solve_pair_edge_qp_matches_jax():
    """One batch of 4 pairs' edge QPs, two SQP rounds, the bench's proximal
    term and warm-started duals."""
    rng = np.random.default_rng(6)
    h, b = 8, 4
    jc, tc = jcfg.PiAdmmConfig(**_small_cfg()), tcfg.PiAdmmConfig(
        **_small_cfg())
    xt = rng.normal(size=(b, 2, 3))
    xt[:, 1, 0] += 2.0
    spd = rng.uniform(3.0, 8.0, size=(b, 2))
    pos_old = rng.normal(size=(b, 2, 2 * (h + 1)))
    dual = 0.1 * rng.normal(size=(b, 2, 2 * (h + 1)))
    last_dis = rng.normal(size=(b, 2))
    u0 = 0.1 * rng.normal(size=(b, 2, h))
    y0 = 0.1 * rng.normal(size=(b, jpi.edge_qp_m(jc)))
    jsc, tsc = (jcfg.SolverConfig(**BENCH_SOLVER),
                tcfg.SolverConfig(**BENCH_SOLVER))
    want = jax.jit(jax.vmap(lambda *a: jpi._solve_pair_edge_qp(
        *a[:6], jc, jsc, 2, y0=a[6], prox_tau=2.0)))(
            *(jnp.asarray(a) for a in (xt, spd, pos_old, dual, last_dis, u0,
                                       y0)))
    got = tpi._solve_pair_edge_qp(
        *(_t(a) for a in (xt, spd, pos_old, dual, last_dis, u0)), tc, tsc, 2,
        y0=_t(y0), prox_tau=2.0)
    for name, g, w in zip(("u", "hat", "converged", "y"), got, want):
        assert g.shape == w.shape, name
        # the hinge rows' duals reach 1e5 (beta over the slack scaling)
        close(g, w, atol=1e-10 * max(1.0, float(np.abs(w).max())), msg=name)


def test_argsort_selection_matches_top_k_on_ties():
    """Symmetric starts give exact ties in the pairs' distances: the stable
    ascending sort picks the set that ``lax.top_k(-d2min)`` picks."""
    d2min = np.array([[4.0, 1.0, 4.0, 1.0, 9.0, 4.0, 1.0, 4.0],
                      [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])
    eng = _engine(_small_cfg(), torch.float64)
    for k in (1, 2, 3, 4, 5, 7):
        got = eng._select_pairs(_t(d2min), k).numpy()
        _, want = jax.lax.top_k(-jnp.asarray(d2min), k)
        for lane in range(2):
            assert set(got[lane]) == set(np.asarray(want[lane])), (k, lane)


# -- the engine --------------------------------------------------------------

def _engine(cfg_kw, dtype, refs=None, **kw):
    kw = dict(dict(layout="pairwise", n_sqp=1, carry_admm_state=True), **kw)
    return tpi.PiAdmmEngine(
        tcfg.PiAdmmConfig(**cfg_kw), tcfg.DualUpdateConfig(windup_sat=200.0),
        tcfg.SolverConfig(**BENCH_SOLVER), refs=refs, dtype=dtype,
        device="cpu", **kw)


def _bench_engine(prof, dtype):
    """bench.py's engine (its first metric) from a fixture's profile."""
    v = prof["num_veh"]
    cfg_kw = dict(num_veh=v, horizon=prof["horizon"],
                  speeds=tuple(8.0 if i % 2 == 0 else 4.0 for i in range(v)),
                  iter_num=prof["iter_cap"], **prof["cfg"])
    refs, _ = pi_admm_overtake_refs(tcfg.PiAdmmConfig(**cfg_kw))
    return tpi.PiAdmmEngine(
        tcfg.PiAdmmConfig(**cfg_kw), tcfg.DualUpdateConfig(**prof["dual"]),
        tcfg.SolverConfig(**prof["solver"]), refs=refs, dtype=dtype,
        device="cpu", **prof["engine"])


# TestFusedRunner's configuration (tests/test_pi_admm.py)
FUSED = dict(num_veh=4, horizon=8, speeds=(8.0, 4.0, 8.0, 4.0), dis_thres=3.5,
             iter_num=20, eps_pri=0.5, eps_dual=0.5,
             stop_needs_clearance=False, eps_per_edge=True)
FUSED_STEPS = 16


@pytest.fixture(scope="module")
def fused():
    """The JAX fused batch at TestFusedRunner's shape (2 lanes, 16 steps),
    and the port's engine and starts."""
    refs, xt0 = pi_admm_overtake_refs(tcfg.PiAdmmConfig(**FUSED))
    rng = np.random.default_rng(0)
    xts = np.asarray(xt0)[None] + np.concatenate(
        [0.4 * rng.normal(size=(2, 4, 2)), np.zeros((2, 4, 1))], axis=-1)
    jeng = jpi.PiAdmmEngine(
        jcfg.PiAdmmConfig(**FUSED), jcfg.DualUpdateConfig(windup_sat=200.0),
        jcfg.SolverConfig(**BENCH_SOLVER), layout="pairwise", refs=refs,
        n_sqp=1, carry_admm_state=True, dtype=jnp.float64)
    want = jeng.run_fused_batch(jnp.asarray(xts), jnp.zeros((2, 4, 8)),
                                FUSED_STEPS)
    want = {k: np.asarray(x) for k, x in want._asdict().items()}
    eng = _engine(FUSED, F64, refs=refs)
    got = eng.run_fused_batch(xts, np.zeros((2, 4, 8)), FUSED_STEPS)
    return dict(eng=eng, xts=xts, want=want, got=got)


def test_fused_batch_matches_jax(fused):
    got, want = fused["got"], fused["want"]
    np.testing.assert_array_equal(got.iterations.numpy(), want["iterations"])
    np.testing.assert_array_equal(got.converged.numpy(), want["converged"])
    for name in ("xt", "u_applied", "primal_res", "dual_res"):
        close(getattr(got, name), want[name], atol=1e-8, msg=name)
    # the conflict window engages (multi-iteration steps)
    assert want["iterations"].sum(axis=1).max() > FUSED_STEPS


def test_fused_batch_equals_per_step_driver(fused):
    eng, got = fused["eng"], fused["got"]
    for lane in range(2):
        rec = eng.run_scan(xt0=fused["xts"][lane], n_steps=FUSED_STEPS)
        np.testing.assert_array_equal(got.iterations[lane].numpy(),
                                      rec.iterations)
        for name in ("xt", "u_applied", "primal_res"):
            close(getattr(got, name)[lane], getattr(rec, name), atol=1e-12,
                  msg=name)


def test_one_lane_alone_equals_that_lane_in_the_batch(fused):
    eng, got = fused["eng"], fused["got"]
    alone = eng.run_fused_batch(fused["xts"][1:], np.zeros((1, 4, 8)),
                                FUSED_STEPS)
    np.testing.assert_array_equal(alone.iterations[0].numpy(),
                                  got.iterations[1].numpy())
    for name in FUSED_FIELDS:
        close(getattr(alone, name)[0], getattr(got, name)[1], msg=name)


FUSED_FIELDS = ("xt", "u_applied", "primal_res", "dual_res", "converged")


def test_chunk_sizes_give_the_same_bits(fused):
    """Trips past a lane's last step change nothing, so the host's chunk of
    trips between two reads does not move a bit of the records."""
    eng, got = fused["eng"], fused["got"]
    trips = {}
    for chunk in (1, 7):
        rec = eng.run_fused_batch(fused["xts"], np.zeros((2, 4, 8)),
                                  FUSED_STEPS, chunk=chunk)
        trips[chunk] = eng.fused_trips
        for name, x in rec._asdict().items():
            assert torch.equal(x, getattr(got, name)), (chunk, name)
    totals = got.iterations.sum(dim=1).max().item()
    assert trips[1] == totals and trips[7] % 7 == 0 and trips[7] >= totals


def test_committed_bench_fixtures():
    """The JAX runs of bench.py's first metric that chip_smoke.py holds the
    card to: 2 float64 lanes and the bench's own 32 float32 lanes."""
    for path, lanes in ((FIXTURE, 2), (FIXTURE_F32, 32)):
        ref = np.load(path)
        prof = json.loads(str(ref["profile"]))
        assert (prof["num_veh"], prof["horizon"], prof["n_steps"],
                prof["iter_budget"], prof["lanes"]) == (16, 30, 12, 210, lanes)
        assert ref["xt"].shape == (lanes, 12, 16, 3)
        assert ref["iterations"].shape == ref["converged"].shape == (lanes, 12)
        assert np.all(np.isfinite(ref["xt"]))
        assert len(str(ref["commit"])) == 40
    assert float(np.load(FIXTURE_F32)["min_distance_m"]) > 1.0


def test_pairwise_iteration_from_a_jax_carry():
    """One iteration of step 1 of the bench's 16-vehicle workload (lane 0,
    float64), started from JAX's carry after step 0 through ``interop``."""
    ref = np.load(FIXTURE)
    eng = _bench_engine(json.loads(str(ref["profile"])), F64)
    carry = admm_carry_from_numpy(
        {k: ref[f"carry0_{k}"] for k in tpi.AdmmCarry._fields})
    back = admm_carry_to_numpy(carry)
    for k in tpi.AdmmCarry._fields:
        np.testing.assert_array_equal(back[k][0], ref[f"carry0_{k}"])
    xt = _t(ref["carry0_xt"])[None]
    u = _t(ref["carry0_u"])[None]
    u = torch.cat([u[..., 1:], u[..., -1:]], dim=-1)
    c0 = eng._pairwise_carry0(u, eng.shift_admm_carry(carry))
    d = eng._pairwise_iter(xt, eng._seed(xt), eng._local_affines(xt),
                           eng._ref_window(torch.tensor([1])), eng.side_of,
                           c0)
    for k, x in d.items():
        want = ref["iter1_hat" if k == "last_hat" else f"iter1_{k}"]
        assert x[0].shape == want.shape, k
        if x.dtype == torch.bool or k == "it":
            np.testing.assert_array_equal(x[0].numpy(), want, err_msg=k)
        else:
            # the edge duals reach 1e4-1e5: their error scales with them
            close(x[0], want, atol=1e-9 * max(1.0, float(np.abs(want).max())),
                  msg=k)
    assert int(d["ever"].sum()) > 0       # the carry holds active pairs


def test_bench_width_first_steps_match_jax():
    """The first 2 MPC steps of lane 0 of the bench's 16-vehicle, horizon-30
    workload (float64), per-step driver, against the JAX fused run."""
    ref = np.load(FIXTURE)
    eng = _bench_engine(json.loads(str(ref["profile"])), F64)
    rec = eng.run_scan(xt0=ref["xts0"][0], n_steps=2)
    np.testing.assert_array_equal(rec.iterations, ref["iterations"][0, :2])
    close(rec.xt, ref["xt"][0, :2], atol=1e-8)


def run_bench_slice_port(start_at_pass=False, num_veh=8, horizon=16,
                         n_scen=2, n_steps=6, seed=0, perturb=0.5):
    """tests/test_bench_quality.py's ``run_bench_slice`` on the port, float32
    on the CPU: the same engine settings, starts and fused driver."""
    speeds = tuple(8.0 if i % 2 == 0 else 4.0 for i in range(num_veh))
    cfg_kw = dict(num_veh=num_veh, horizon=horizon, speeds=speeds,
                  dis_thres=2.0, iter_num=30, eps_pri=1.0, eps_dual=1.0,
                  stop_needs_clearance=False, eps_per_edge=True)
    refs, xt0 = pi_admm_overtake_refs(tcfg.PiAdmmConfig(**cfg_kw))
    if start_at_pass:
        xt0 = xt0.copy()
        xt0[0::2, 0] = xt0[1::2, 0] - 2.0
    eng = _engine(cfg_kw, torch.float32, refs=refs, pair_budget=24)
    rng = np.random.default_rng(seed)
    xts = (xt0[None] + np.concatenate([
        perturb * rng.normal(size=(n_scen,) + xt0[:, :2].shape),
        np.zeros((n_scen, num_veh, 1))], axis=-1)).astype(np.float32)
    rec = eng.run_fused_batch(xts, np.zeros((n_scen, num_veh, horizon),
                                            np.float32), n_steps)
    iters = rec.iterations.numpy()
    h = np.concatenate([xts[None], np.moveaxis(rec.xt.numpy(), 1, 0)])
    p = h[..., :2]
    d = np.linalg.norm(p[:, :, :, None, :] - p[:, :, None, :, :], axis=-1)
    d += 1e9 * np.eye(num_veh)
    conv_frac = 1.0 - np.sum(iters >= cfg_kw["iter_num"]) / iters.size
    return h, float(d.min()), float(conv_frac), int(iters.sum())


@pytest.mark.parametrize("case", ["bench_gates", "adversarial_cold_start"])
def test_bench_quality_on_the_port(case):
    """Both slices of tests/test_bench_quality.py, with its gates."""
    h, min_dist, conv_frac, total = run_bench_slice_port(
        start_at_pass=case == "adversarial_cold_start")
    assert np.all(np.isfinite(h))
    if case == "bench_gates":
        assert min_dist > 1.0, min_dist
        assert conv_frac >= 0.90, conv_frac
    else:
        assert min_dist > 0.7, min_dist
        assert conv_frac >= 0.6, conv_frac
        assert total > 50, total


def test_default_device_is_the_card_and_nothing_falls_back():
    """Without ``device=`` the engine and ``run_pi_admm`` run on the CUDA
    card and raise where there is none; with ``device="cpu"`` their default
    layout, the classic one, runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpi.PiAdmmEngine(layout="pairwise")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpi.PiAdmmEngine()
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pi_admm(layout="pairwise", n_steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_pi_admm(n_steps=1)
    assert tpi.PiAdmmEngine(device="cpu").layout == "classic"
    res = run_pi_admm(device="cpu", n_steps=2)
    assert res.states.shape == (2, 2, 3) and np.all(np.isfinite(res.states))
    assert res.extras["engine"].layout == "classic"
    res = run_pi_admm(layout="pairwise", n_steps=2, device="cpu",
                      xt0=np.array([[-3.0, 0.0, 0.0], [0.0, 6.0, -np.pi / 2]]))
    assert res.states.shape == (2, 2, 3) and np.all(np.isfinite(res.states))
    assert res.extras["engine"].device.type == "cpu"

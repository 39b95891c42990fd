"""The centralized joint OBCA planner of the PyTorch port against the JAX
package, on the CPU.

The JAX outputs come from the committed runs
``tests/data/obca_centralized_ref.npz`` (``tools/make_torch_fixture.py
--profile centralized``: ``run_obca(Formulation.CENTRALIZED)``'s 35 steps,
``solve_at`` in the staged and the dense form) and
``tests/data/obca_centralized_v4_ref.npz`` (``--profile centralized_v4``:
one staged ``solve_at`` with 3 and with 4 vehicles). One ``solve_at`` is
also run through JAX live. On the CPU every staged KKT solve goes through
the block-Thomas kernels' plain version.

Tolerances, float64: decision vectors and states within 1e-6 of JAX with
equal IP iterations, as both sides take the same IP steps and differ only
in the order of their sums. At 3 vehicles JAX needs 58 trips from the
reference warm start and no trip count is pinned: the two sides reach the
same optimum along paths that part at the rounding level. The planner tests
mirror ``tests/test_obca.py``'s centralized cases with their own gates.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch import config as tcfg
from dlp_admm_torch.models.obca import CentralizedObcaPlanner as TPlanner
from dlp_admm_torch.mpc import run_obca
from dlp_admm_torch.ops.geometry import halfspaces
from dlp_admm_torch.solvers import thomas
from dlp_admm_tpu import config as jcfg
from dlp_admm_tpu.models.obca import CentralizedObcaPlanner as JPlanner

TOL = 1e-6
DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURE = os.path.join(DATA, "obca_centralized_ref.npz")
FIXTURE_V4 = os.path.join(DATA, "obca_centralized_v4_ref.npz")
OCFG = dict(horizon=15, min_dis=1.0)
SCFG = dict(ip_iters=40, ip_tol=1e-6)


@pytest.fixture(scope="module")
def ref():
    return np.load(FIXTURE)


def _planner(use_staged=True, **ocfg):
    return TPlanner(tcfg.ObcaConfig(**{**OCFG, **ocfg}),
                    scfg=tcfg.SolverConfig(**SCFG), use_staged=use_staged,
                    device="cpu")


def _close(got, want, atol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def run3():
    """``run_obca(Formulation.CENTRALIZED)`` with its defaults on the CPU,
    3 steps (the driver's default run is 35)."""
    return run_obca(tcfg.Formulation.CENTRALIZED, device="cpu", n_steps=3)


def test_committed_fixtures(ref):
    assert ref["states"].shape == (36, 2, 5)
    assert ref["iterations"].shape == (35,)
    assert 0 < int(ref["chaotic_from"]) <= 35
    # the first 4 solves converge, then the conflict caps them at 40 trips
    assert ref["converged"][:4].all() and not ref["converged"].all()
    assert ref["staged_0_x"].shape == (318,)
    assert len(str(ref["commit"])) == 40
    v4 = np.load(FIXTURE_V4)
    assert v4["v3_states"].shape == (3, 15, 5)
    assert v4["v4_states"].shape == (4, 15, 5)
    assert bool(v4["v3_converged"]) and bool(v4["v4_converged"])


@pytest.mark.parametrize("form,step", [("staged", 0), ("staged", 3),
                                       ("dense", 0)])
def test_solve_at_matches_jax(ref, form, step):
    """One joint solve (318 decision variables at 2 vehicles, horizon 15)
    from the run's state at ``step``: the staged form runs one lane of
    14 stages, 34 wide with the link and pairing rows; the dense form one
    dense KKT system."""
    pl = _planner(use_staged=form == "staged")
    xs, us, lam, sol = pl.solve_at(ref["states"][step], step)
    assert xs.shape == (2, 15, 5) and us.shape == (2, 14, 2)
    assert lam.shape == (1, 2, 14, 4)
    _close(sol.x, ref[f"{form}_{step}_x"])
    assert int(sol.iterations) == int(ref[f"{form}_{step}_iterations"])
    assert bool(sol.converged) == bool(ref[f"{form}_{step}_converged"])
    if form == "staged":
        # two block solves a trip in float64 (one and one refinement)
        assert pl.block_solves == 2 * int(sol.iterations)
    # duals non-negative and norm-bounded (tests/test_obca.py:29-39)
    assert float(lam.min()) >= -1e-8
    a_mat, _ = halfspaces(xs[:, 1:, :], pl.vcfg, False)
    at_l = torch.einsum('tij,ti->tj', a_mat[0], lam[0, 0])
    assert bool((torch.linalg.norm(at_l, dim=-1) <= 1.0 + 1e-6).all())


def test_solve_at_live_jax():
    """The staged solve at step 0 through JAX live and the port."""
    jp = JPlanner(jcfg.ObcaConfig(**OCFG), scfg=jcfg.SolverConfig(**SCFG))
    _, _, _, want = jp.solve_at(jp.refs[:, 0, :], 0)
    pl = _planner()
    _, _, _, got = pl.solve_at(np.asarray(jp.refs[:, 0, :]), 0)
    _close(got.x, want.x)
    assert int(got.iterations) == int(want.iterations)


def test_run_obca_matches_jax(ref, run3):
    """The driver's default run, its first 3 steps: states within 1e-6 and
    equal IP iterations; the applied controls and the planner returned."""
    assert run3.states.shape == (4, 2, 5)
    _close(run3.states, ref["states"][:4])
    assert run3.metrics.iter_history == ref["iterations"][:3].tolist()
    _close(run3.metrics.extras["kkt"], ref["kkt"][:3], 1e-9)
    _close(run3.extras["controls"], ref["controls"][:3])
    assert run3.extras["planner"].block_solves == 2 * sum(
        run3.metrics.iter_history)
    assert len(run3.metrics.step_times) == 3


def test_tracks_when_separated(run3):
    """tests/test_obca.py:18-27 on the port: the vehicles track their 20 /
    10 m/s references at the start."""
    states = run3.states
    np.testing.assert_allclose(states[:, 0, 0], 2.0 * np.arange(4),
                               atol=0.02)
    np.testing.assert_allclose(states[:, 1, 0], 20 + 1.0 * np.arange(4),
                               atol=0.02)
    np.testing.assert_allclose(states[:, :, 1], 0.0, atol=0.02)


def test_delay_tightening_variant_runs():
    """tests/test_obca.py:41-47 on the port (the stochastic variant)."""
    pl = _planner(use_delay_tightening=True)
    states, _, infos = pl.run(n_steps=2)
    assert states.shape == (3, 2, 5) and np.all(np.isfinite(states))


def test_three_vehicle_solve_at_matches_jax():
    """3 vehicles (KKT blocks 66 wide, the wide kernel's class 80 on the
    card) on the plain version: the same optimum as JAX, both converged."""
    v4 = np.load(FIXTURE_V4)
    pl = TPlanner(tcfg.ObcaConfig(**OCFG, num_veh=3),
                  scfg=tcfg.SolverConfig(ip_iters=80), device="cpu")
    xs, _, _, sol = pl.solve_at(pl.refs[:, 0, :], 0)
    assert bool(sol.converged)
    _close(xs, v4["v3_states"])
    _close(sol.x, v4["v3_x"])


def test_warm_modes_and_dtypes():
    """``warm_mode='previous'`` shifts the last optimum with a dynamics-
    feasible tail; unknown modes and dtypes are refused."""
    pl = _planner()
    x = torch.arange(sum(pl._sizes.values()), dtype=torch.float64)
    xs, us, lam = pl._split(pl._shift_warm(x))
    xs0, us0, lam0 = pl._split(x)
    torch.testing.assert_close(xs[:, :-1], xs0[:, 1:])
    torch.testing.assert_close(us[:, -1], us0[:, -1])
    torch.testing.assert_close(lam[:, :, :-1], lam0[:, :, 1:])
    with pytest.raises(ValueError, match="warm_mode"):
        TPlanner(warm_mode="other", device="cpu")
    with pytest.raises(TypeError, match="float64 or float32"):
        TPlanner(dtype=torch.float16, device="cpu")


def test_kernel_plan_at_the_centralized_widths():
    """The launch plans of the staged solve's KKT blocks at horizon 15
    (T = 14): 7V + 8P decision columns, 5V dynamics rows and 2P pairing
    rows a stage, so B = 34, 66, 108 at 2, 3, 4 vehicles."""
    widths = {v: 7 * v + 8 * p + 5 * v + 2 * p
              for v, p in ((2, 1), (3, 3), (4, 6))}
    assert widths == {2: 34, 3: 66, 4: 108}
    f64, f32 = torch.float64, torch.float32
    plan = thomas.kernel_plan(1, 14, 34, f64)
    assert (plan["kernel"], plan["bp"], plan["warps"]) == ("wide", 48, 9)
    plan = thomas.kernel_plan(1, 14, 34, f32, equilibrate=True)
    assert (plan["kernel"], plan["bp"], plan["warps"]) == ("wide", 48, 9)
    plan = thomas.kernel_plan(1, 14, 66, f64)
    assert (plan["kernel"], plan["bp"], plan["smem_bytes"]) == (
        "wide", 80, 81856)
    # 4 vehicles are past the wide kernel's float64 range (97) and its
    # float32 equilibrated range (106): the cluster kernel, 4 CTAs of 256
    # threads, 7 panels, 2 C and 2 [U | g] blocks a CTA, the next stage
    # prefetched; the big kernel, forced, runs one CTA a panel and one more,
    # each holding a C and a [U | g] block, the next stage prefetched (70 KB
    # of the 227 KB a CTA may have in float64)
    for dtype, eq, smem in ((f64, False, 137520), (f32, True, 69168)):
        plan = thomas.kernel_plan(1, 14, 108, dtype, equilibrate=eq)
        assert plan == dict(kernel="cluster", cluster=4, prefetch=True,
                            threads=256, blocks=4, padded=112, panels=7,
                            c_blocks=2, rhs_blocks=2, smem_bytes=smem)
    plan = thomas.kernel_plan(1, 14, 108, f64, kernel="big")
    assert plan == dict(kernel="big", ctas=8, groups=1, blocks=8,
                        threads=256, padded=112, panels=7, c_blocks=1,
                        rhs_blocks=1, prefetch=True, tile_in_smem=True,
                        co_resident=132, smem_bytes=71856)
    plan = thomas.kernel_plan(1, 14, 108, f32, equilibrate=True,
                              kernel="big")
    assert plan == dict(kernel="big", ctas=8, groups=1, blocks=8,
                        threads=256, padded=112, panels=7, c_blocks=1,
                        rhs_blocks=1, prefetch=True, tile_in_smem=True,
                        co_resident=132, smem_bytes=36144)
    # the wide kernel forced past its classes still refuses
    with pytest.raises(ValueError, match="B <= 97"):
        thomas.kernel_plan(1, 14, 108, f64, kernel="wide")
    with pytest.raises(ValueError, match="B <= 106"):
        thomas.kernel_plan(1, 14, 108, f32, equilibrate=True, kernel="wide")


@pytest.mark.parametrize("b,dtype,eq,kernel,bp,smem", [
    (22, torch.float64, False, "warp", 32, 98912),
    (22, torch.float32, True, "warp", 32, 55176),
    (45, torch.float64, False, "wide", 48, 43840),
    (76, torch.float64, False, "wide", 80, 99792),
    (76, torch.float32, True, "wide", 80, 50560)])
def test_kernel_plan_at_fourteen_stages(b, dtype, eq, kernel, bp, smem):
    """The plans of the synthetic T = 14 shapes chip_smoke.py times beside
    the path's own: the warp kernel's 32-wide build keeps all 14 stages'
    X_k | y_k in shared memory, the wide kernel at 76 runs 16 warps."""
    plan = thomas.kernel_plan(1, 14, b, dtype, eq)
    assert (plan["kernel"], plan["bp"], plan["smem_bytes"]) == (
        kernel, bp, smem)
    if kernel == "warp":
        assert plan["hist_in_smem"]
    elif b == 76:
        assert plan["warps"] == 16


@pytest.mark.parametrize("b,dtype,eq,in_smem,smem", [
    (98, torch.float64, False, True, 160544),
    (81, torch.float64, True, True, 110704),
    (139, torch.float32, False, True, 159776),
    (107, torch.float32, True, True, 95648),
    (118, torch.float64, False, True, 231024),
    (119, torch.float64, False, False, 7360),
    (168, torch.float32, False, True, None),
    (169, torch.float32, False, False, None),
    (264, torch.float64, False, False, 16048),
    (264, torch.float32, True, False, 8656)])
def test_kernel_plan_past_the_wide_classes(b, dtype, eq, in_smem, smem):
    """Every width past the wide kernel's classes goes to the cluster
    kernel (up to its reach). The big kernel, forced onto them, is a grid
    of one CTA a panel and one more, its blocks in their shared memory, for
    each of the 7 systems at once; so it holds on chip every width that the
    one-block big kernel before it held (``in_smem``: its tile [B, 2B+1]
    in the 232,448 bytes a block may have, float64 up to 118, float32 up
    to 168, in ``smem`` bytes where given) and those it kept in a device
    workspace, as the synthetic 264."""
    assert thomas.kernel_plan(7, 7, b, dtype, eq)["kernel"] == "cluster"
    elem = dtype.itemsize
    # the one-block kernel's layout: the pivot row and row j [2, 2B+1],
    # three B-vectors and, in shared memory, the tile; 16 warps'
    # candidates and int[B]
    one_block = (-(-elem * (2 * (2 * b + 1) + 3 * b
                            + (b * (2 * b + 1) if in_smem else 0)) // 16) * 16
                 + 12 * 16 + -(-4 * b // 16) * 16)
    assert (one_block <= thomas.H100_SMEM_LIMIT) and (
        smem is None or one_block == smem)
    plan = thomas.kernel_plan(7, 7, b, dtype, eq, kernel="big")
    r = plan["ctas"]
    assert (plan["kernel"], plan["groups"], plan["blocks"],
            plan["tile_in_smem"]) == ("big", 7, 7 * r, True)
    assert plan["smem_bytes"] == thomas.big_bytes(
        b, elem, r, plan["prefetch"], True) <= thomas.H100_SMEM_LIMIT
    assert r == -(-b // 16) + 1


@pytest.mark.parametrize("shape", [(1, 14, 108), (1, 7, 264)],
                         ids=["s1-t14-b108", "s1-t7-b264"])
def test_plain_version_solves_the_big_widths(shape):
    """The kernels' plain version, which the cluster and big kernels are
    held to on the card, against ``torch.linalg.solve`` on the assembled
    dense matrix of a diagonally dominant system at the 4-vehicle
    centralized width and a synthetic 264 (float64, 1e-12 relative: both
    are backward stable on a system conditioned near 1)."""
    rng = np.random.default_rng(3)
    s, t, b = shape
    diag = rng.normal(size=(s, t, b, b))
    diag = 0.5 * (diag + np.swapaxes(diag, -1, -2)) + (b + 2.0) * np.eye(b)
    upper = 0.3 * rng.normal(size=(s, t, b, b))
    rhs = rng.normal(size=(s, t, b))
    d, u, r = (torch.as_tensor(a) for a in (diag, upper, rhs))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)    # 30x faster here on these small tensors
    try:
        got = thomas.block_thomas_solve(d, u, r)
    finally:
        torch.set_num_threads(n_threads)
    a = torch.zeros((s, t * b, t * b), dtype=torch.float64)
    for k in range(t):
        i = slice(k * b, (k + 1) * b)
        a[:, i, i] = d[:, k]
        if k + 1 < t:
            j = slice((k + 1) * b, (k + 2) * b)
            a[:, i, j] = u[:, k]
            a[:, j, i] = u[:, k].transpose(-1, -2)
    want = torch.linalg.solve(a, r.reshape(s, t * b)).reshape(s, t, b)
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 1e-12, rel


def test_default_device_is_the_card_and_unported_formulations_raise():
    """Without a card every planner's default device raises, the fixed-dual
    family's and ALADIN's too; no formulation is refused any more: each
    dispatches on the CPU (tests/test_driver_utils.py::
    test_run_obca_tightening: the tightening pair's default vehicle config
    is T = 7 s, prob 0.99; ::test_run_obca_honors_caller_vcfg: a caller's
    reaches the planner)."""
    forms = tcfg.Formulation
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TPlanner()
        for form in forms:
            with pytest.raises(RuntimeError, match="CUDA"):
                run_obca(form, n_steps=1)
    scfg = tcfg.SolverConfig(ip_iters=30, ip_tol=1e-6)
    res = run_obca(forms.TIGHTENING, scfg=scfg, n_steps=2, device="cpu")
    assert res.states.shape == (3, 2, 5) and np.all(np.isfinite(res.states))
    assert res.extras["planner"].vcfg.T == 7.0
    assert res.extras["planner"].vcfg.prob == 0.99
    vcfg = tcfg.VehicleConfig(T=6.0, prob=0.9)
    res = run_obca(forms.TIGHTENING_SLACK, vcfg=vcfg, scfg=scfg, n_steps=1,
                   device="cpu")
    assert res.extras["planner"].vcfg == vcfg
    res = run_obca(forms.BILEVEL, scfg=scfg, n_steps=1, device="cpu",
                   n_rounds=1)
    assert res.extras["planner"].vcfg == tcfg.VehicleConfig()
    assert res.metrics.extras["elastic"][0] < 1e-6
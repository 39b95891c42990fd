"""The tools that judge the float32 flagship and the float32 scenario batch
against JAX (PERF.md §6, Rules J and B), and the launch counts by
variant.

* ``tools/make_torch_fixture.py --stage-f64`` swaps JAX's staged KKT solve
  for a float64 one on the host (``stage_solve_f64``); it must trace with
  the 64-bit mode off under ``jit`` and ``vmap`` and give the float64
  block-Thomas solution rounded to float32.
* ``make_torch_fixture.py --profile batch_f32 --noise --seed`` and
  ``tools/perturbed_torch_batch.py`` must move the batch's starts the same
  way, so that lane ``i`` of run ``k`` starts from the same point on both
  sides.
* ``perturbed_torch_batch.py judge`` applies Rule B; it is held here on
  numpy-seeded lanes and on one case checked by hand.
* ``tools/raised_block_errors.py`` locates a solution's worst equation.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch.solvers import thomas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(ROOT, "tests", "data", "kkt_f32_sample.npz")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fixture():
    return _tool("make_torch_fixture")


@pytest.fixture(scope="module")
def batch_tool():
    return _tool("perturbed_torch_batch")


@pytest.fixture(scope="module")
def lanes():
    """The first 24 lane systems of each width of the float32 KKT sample."""
    d = np.load(SAMPLE)
    return [tuple(d[f"b{b}_{k}"][:24] for k in ("d", "u", "rhs"))
            for b in (19, 20)]


def _dense(d, u, r):
    """The assembled ``[S, T·B, T·B]`` float64 matrix of the systems."""
    s, t, b = r.shape
    a = np.zeros((s, t * b, t * b))
    for k in range(t):
        a[:, k * b:(k + 1) * b, k * b:(k + 1) * b] = d[:, k]
        if k < t - 1:
            a[:, k * b:(k + 1) * b, (k + 1) * b:(k + 2) * b] = u[:, k]
            a[:, (k + 1) * b:(k + 2) * b, k * b:(k + 1) * b] = np.swapaxes(
                u[:, k], -1, -2)
    return a


def test_stage_f64_recursion_is_jaxs_in_float64(fixture, lanes):
    """The host recursion is JAX's own block-Thomas solve run in float64
    (64-bit mode on, ``jnp.linalg.solve`` a stage): 1e-10 relative at the
    median lane, 1e-8 at the worst (the two float64 solves round apart on
    the sample's worst-conditioned lanes; 5.1e-10 measured)."""
    from dlp_admm_tpu.solvers import ip_staged as jip
    for d, u, r in lanes:
        got = fixture.thomas_f64_host(d, u, r)
        want = np.asarray(jax.vmap(jip.block_thomas_solve)(
            *(jnp.asarray(x, jnp.float64) for x in (d, u, r))))
        assert got.dtype == np.float64
        rel = (np.linalg.norm((got - want).reshape(len(r), -1), axis=1)
               / np.linalg.norm(want.reshape(len(r), -1), axis=1))
        assert np.median(rel) <= 1e-10 and rel.max() <= 1e-8, rel


def test_stage_f64_against_a_dense_float64_solve(fixture, lanes):
    """Against ``torch.linalg.solve`` of the assembled raised system: the
    same normwise backward error as a backward-stable float64 solve (the
    systems' 2-norm condition numbers reach 1e15-1e23, so two such solves
    part by up to about 2e-7 in the solution: held to 1e-6)."""
    for d, u, r in lanes:
        a = _dense(d.astype(np.float64), u.astype(np.float64), r)
        rr = r.reshape(len(r), -1).astype(np.float64)
        want = torch.linalg.solve(torch.as_tensor(a),
                                  torch.as_tensor(rr)).numpy()
        got = fixture.thomas_f64_host(d, u, r).reshape(len(r), -1)
        back = (np.linalg.norm(np.einsum("sij,sj->si", a, got) - rr, axis=1)
                / (np.linalg.norm(a, axis=(1, 2)) * np.linalg.norm(got, axis=1)
                   + np.linalg.norm(rr, axis=1)))
        assert back.max() <= 1e-15, back.max()
        fwd = (np.linalg.norm(got - want, axis=1)
               / np.linalg.norm(want, axis=1))
        assert fwd.max() <= 1e-6, fwd.max()


def test_stage_f64_traces_in_float32_under_jit_and_vmap(fixture, lanes):
    """With the 64-bit mode off, the stand-in under ``jit`` of a ``vmap``
    (and a ``vmap`` of a ``vmap`` with an unbatched ``upper``) returns the
    float64 solution rounded to float32, bit for bit."""
    d, u, r = lanes[0]
    want = fixture.thomas_f64_host(d, u, r).astype(np.float32)
    with jax.enable_x64(False):
        got = jax.jit(jax.vmap(fixture.stage_solve_f64))(d, u, r)
        assert got.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(got), want)
        two = jax.jit(jax.vmap(jax.vmap(fixture.stage_solve_f64),
                               in_axes=(0, None, 0)))(
            np.stack([d[:3], d[:3]]), u[:3], np.stack([r[:3], r[3:6]]))
    np.testing.assert_array_equal(np.asarray(two[0]), want[:3])
    np.testing.assert_array_equal(
        np.asarray(two[1]),
        fixture.thomas_f64_host(d[:3], u[:3], r[3:6]).astype(np.float32))


def test_use_stage_f64_swaps_jaxs_stage_solve(fixture, monkeypatch):
    from dlp_admm_tpu.solvers import ip_staged as jip
    monkeypatch.setattr(jip, "block_thomas_solve", jip.block_thomas_solve)
    fixture.use_stage_f64()
    assert jip.block_thomas_solve is fixture.stage_solve_f64


@pytest.mark.parametrize("seed", [1, 2])
def test_both_sides_move_the_batch_starts_alike(fixture, batch_tool, seed):
    """The JAX batch's starts (64-bit mode off, as the float32 run makes
    them) and the port's, moved by the same seed, are the same numbers;
    the noise survives the rounding to float32 in some entries."""
    import chip_smoke
    from dlp_admm_torch.models.obca import ConsensusObcaPlanner
    with jax.enable_x64(False):
        jax_starts = fixture.batch_starts(fixture.make_planner("f32"))
    pl = ConsensusObcaPlanner(device="cpu",
                              **chip_smoke.flagship_profile(torch.float32))
    port_starts = batch_tool.batch_starts(pl)
    np.testing.assert_array_equal(port_starts, jax_starts)
    a = fixture.moved_starts(jax_starts, 1e-7, seed)
    b = batch_tool.moved_starts(port_starts, 1e-7, seed)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (16, 2, 5)
    moved = a.astype(np.float32) != jax_starts.astype(np.float32)
    assert moved.any() and not moved.all()
    np.testing.assert_array_equal(batch_tool.moved_starts(port_starts, 1e-7,
                                                          None), port_starts)


def test_rule_b_lanes_and_p_values(batch_tool):
    """Per-lane res_ok counts both residuals <= 0.01; the rule's p-values on
    numpy-seeded lanes, and one case checked by hand: lanes 1, 2, 3 against
    4, 5, 6 give U = 0, z = (0 - 4.5 + 0.5) / sqrt(5.25) = -1.7457, p =
    0.0404."""
    rng = np.random.default_rng(3)
    prs = rng.uniform(0.0, 0.02, size=(16, 20))
    dus = rng.uniform(0.0, 0.02, size=(16, 20))
    its = rng.integers(1, 51, size=(16, 20))
    states = rng.normal(size=(21, 16, 2, 5))
    per = batch_tool.lanes(its, prs, dus, states)
    for i in range(16):
        assert per["res_ok"][i] == sum(
            1 for k in range(20) if prs[i, k] <= 0.01 and dus[i, k] <= 0.01)
        assert per["steps_at_cap"][i] == int((its[i] == 50).sum())
    assert np.isclose(per["min_distance_m"][3], min(
        np.hypot(*(states[k, 3, 0, :2] - states[k, 3, 1, :2]))
        for k in range(21)))
    hand = batch_tool.rule_b([1, 2, 3], [4, 5, 6])
    assert hand["p_mann_whitney_less"] == pytest.approx(0.040428, abs=1e-6)
    assert hand["fault"] and hand["pairs_port_lower"] == 3
    base = rng.integers(10, 21, size=48)
    same = batch_tool.rule_b(base, base)
    assert not same["fault"] and same["p_wilcoxon"] == 1.0
    low = batch_tool.rule_b(base - 3, base)
    assert low["fault"] and low["p_wilcoxon"] < 1e-6
    assert not batch_tool.rule_b(base + 3, base)["fault"]


def test_launches_are_counted_by_variant():
    """Launch counts by kernel, element type and variant: a wrapper's or a
    replay's counts add up, the counts by kernel are their sums, and
    ``reset_counts`` clears them."""
    thomas.reset_counts()
    assert thomas.variant_name("warp", torch.float64, True) == "warp f64 eq"
    assert thomas.variant_name("wide", torch.float32, False) == "wide f32"
    thomas._count({"warp f64 eq": 2})
    thomas._count({"warp f64": 1})

    class Graph:
        def replay(self):
            pass
    thomas.replay(Graph(), {"warp f64 eq": 1, "warp f32 eq": 2,
                            "wide f64": 0})
    assert thomas.launches == 6
    assert thomas.launches_by_variant == {"warp f64 eq": 3, "warp f64": 1,
                                          "warp f32 eq": 2}
    assert thomas.launches_by_kernel == {"warp": 6, "wide": 0, "cluster": 0,
                                         "big": 0}
    thomas.reset_counts()
    assert thomas.launches == 0 and thomas.launches_by_variant == {}
    assert not any(thomas.launches_by_kernel.values())


def test_worst_row_of_a_block():
    """``tools/raised_block_errors.py`` finds the equation where a
    solution's entry-by-entry backward error is largest, and tells its
    stage, right-hand side, nonzeros and size."""
    tool = _tool("raised_block_errors")
    d = torch.tensor([[[[4.0, 1.0], [1.0, 3.0]], [[5.0, 0.0], [0.0, 2.0]]]],
                     dtype=torch.float64)
    u = torch.zeros_like(d)
    u[0, 0, 0, 0] = 1.0
    r = torch.tensor([[[1.0, 0.0], [0.0, 0.0]]], dtype=torch.float64)
    x = thomas.block_thomas_plain(d, u, r, True)
    assert float(x[0, 1, 1]) == 0.0       # equation (1, 1) reads 2 x = 0
    x[0, 1, 1] = 1e-6
    row = tool.worst_row(d, u, r, x)
    assert (row["system"], row["stage"], row["equation"]) == (0, 1, 1)
    assert row["error"] == 1.0 and row["rhs"] == 0.0
    assert row["residual"] == pytest.approx(2e-6)
    assert (row["nonzeros"], row["row_l1"]) == (1, 2.0)
    assert row["max_abs_x"] == float(x.abs().max())


def test_float32_kkt_solves_run_in_float64_equilibrated(lanes, monkeypatch):
    """The staged solver's float32 KKT call reaches the plain version on the
    CPU in float64 with ``equilibrate=True``, and its result comes back as
    the float64 solution cast to float32; float64 data is solved as it is,
    unequilibrated."""
    from dlp_admm_torch.solvers import ip_staged
    seen = []
    plain = thomas.block_thomas_plain

    def spy(diag, upper, rhs, equilibrate=False):
        seen.append((diag.dtype, upper.dtype, rhs.dtype, equilibrate))
        return plain(diag, upper, rhs, equilibrate)

    monkeypatch.setattr(thomas, "block_thomas_plain", spy)
    d, u, r = (torch.as_tensor(x[:4]) for x in lanes[0])
    got = ip_staged.block_thomas_solve(d, u, r)
    assert got.dtype == torch.float32
    assert seen == [(torch.float64,) * 3 + (True,)]
    want = plain(d.double(), u.double(), r.double(), True).float()
    assert torch.equal(got, want)
    assert ip_staged.kkt_variant(torch.float32) == (torch.float64, True)
    seen.clear()
    ip_staged.block_thomas_solve(d.double(), u.double(), r.double())
    assert seen == [(torch.float64,) * 3 + (False,)]
    assert ip_staged.kkt_variant(torch.float64) == (torch.float64, False)


def test_rule_j_on_the_shared_starts_table():
    """Rule J on the committed table of JAX's float64-stage runs: J-flat
    (they are not higher than JAX's float32 runs: p 0.889), and apart from
    neither card side by the two-sided test."""
    judge = _tool("judge_f32_flagship")
    out = judge.rule_j(judge.shared_rows("jax_stage_f64"))
    assert out["n"] == 17 and out["verdict"] == "J-flat"
    assert out["p_up"] == pytest.approx(0.8888, abs=1e-4)
    assert out["vs_card_k1_f64"]["p_res_ok"] == pytest.approx(0.1294,
                                                              abs=1e-4)


# res_ok per lane of the float32 batch from the unmoved starts and seeds 1
# and 2 at 1e-7 (16 lanes each): JAX on the CPU, the port on an H100 with
# its float32 KKT solves in float32 and with them in float64 (PERF.md §6)
BATCH_LANES = dict(
    jax=(19, 20, 18, 18, 19, 20, 20, 18, 20, 14, 19, 17, 19, 16, 19, 20,
         17, 14, 19, 20, 16, 19, 19, 17, 19, 18, 20, 20, 18, 17, 19, 19,
         18, 18, 16, 18, 20, 19, 19, 17, 19, 20, 18, 20, 18, 19, 17, 18),
    float32_solve=(
        19, 19, 19, 16, 14, 18, 17, 15, 16, 17, 18, 19, 17, 16, 15, 17,
        19, 16, 19, 20, 17, 19, 20, 17, 15, 16, 19, 16, 14, 14, 20, 19,
        19, 20, 17, 17, 19, 19, 19, 18, 19, 17, 19, 20, 18, 14, 18, 19),
    float64_solve=(
        19, 19, 16, 17, 16, 18, 19, 14, 20, 18, 19, 15, 19, 18, 19, 19,
        18, 18, 20, 18, 16, 20, 20, 18, 17, 18, 16, 20, 17, 18, 20, 19,
        18, 19, 15, 19, 18, 20, 16, 18, 18, 17, 19, 17, 16, 16, 18, 19))


@pytest.mark.parametrize("side, p_mw, p_w, fault", [
    ("float32_solve", 0.0173, 0.0183, True),
    ("float64_solve", 0.0669, 0.0802, False)])
def test_rule_b_on_the_measured_lanes(batch_tool, side, p_mw, p_w, fault):
    out = batch_tool.rule_b(BATCH_LANES[side], BATCH_LANES["jax"])
    assert out["n"] == 48 and out["fault"] == fault
    assert out["p_mann_whitney_less"] == pytest.approx(p_mw, abs=1e-4)
    assert out["p_wilcoxon"] == pytest.approx(p_w, abs=1e-4)

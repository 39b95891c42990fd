"""``tools/kkt_corpus.py``, the paired comparison of float32 KKT solves on
identical systems (PERF.md §6), on the CPU.

* The tool's JAX arm is JAX's own float32 stage solve inside its staged
  solver: ``dlp_admm_tpu.solvers.ip_staged.block_thomas_solve`` with the
  refinement and verification of ``ip_staged.py:336-365``, vmapped over
  the lanes as the JAX planner vmaps its solve over vehicles, 64-bit mode
  off, matmul precision float32. Held bit for bit against that code
  written out here, on systems the port's planner gives its KKT solve in
  the committed step-14 carry's step (the first IP trips, cut short).
  Vmapped and one lane at a time the same solve differs (by up to 3.5 in
  one solution entry of these systems), so the reference is vmapped too.
* The capture keeps the blocks bit for bit, and the run's own ``bad`` is
  the staged solver's verification of its own solve.
* The rule's statistics (an exact McNemar test on ``bad``, a Wilcoxon
  signed-rank test on the log error ratios) give the known answer on a
  case made from a numpy seed.
* ``chip_smoke.py`` phase 7's check of the committed sample
  (``tests/data/kkt_f32_sample.npz``) runs on the CPU, where the staged
  solver's block solve is the plain version.
* The run-level judgements: ``tools/judge_f32_flagship.py
  --shared-starts`` gives the p-values PERF.md §6 records from its table
  of the 17 shared starts, and ``tools/judge_pi_admm_f32.py``'s rule
  flags what it should.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import binomtest

import chip_smoke
from dlp_admm_torch.solvers import ip_staged, thomas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARRY14 = os.path.join(ROOT, "tests", "data",
                       "consensus_obca_f32_carry14.npz")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def kc():
    return _tool("kkt_corpus")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Run this module's small-tensor work on one CPU thread, then restore
    the count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def systems(kc):
    """The first 3 KKT systems (first calls of 3 IP trips) of step 14 of the
    float32 flagship from its committed carry, on the CPU."""
    return kc.capture_step(np.load(CARRY14), 14, "cpu", 3)


def _jax_stage_solve(d_blk, u_blk, rhs):
    """dlp_admm_tpu/solvers/ip_staged.py:336-365 for one lane: the solve,
    n_refine = 2 refinements in float32, the verification."""
    from dlp_admm_tpu.solvers import ip_staged as jip
    t, bb = rhs.shape
    dtype = rhs.dtype
    u_pad = jnp.concatenate([u_blk[:t - 1], jnp.zeros((1, bb, bb), dtype)],
                            axis=0)
    u_prev = jnp.concatenate([jnp.zeros((1, bb, bb), dtype), u_pad[:-1]],
                             axis=0)

    def tridiag_residual(vec):
        nxt = jnp.concatenate([vec[1:], jnp.zeros((1, bb), dtype)], axis=0)
        prv = jnp.concatenate([jnp.zeros((1, bb), dtype), vec[:-1]], axis=0)
        return (jnp.einsum('tij,tj->ti', d_blk, vec)
                + jnp.einsum('tij,tj->ti', u_pad, nxt)
                + jnp.einsum('tji,tj->ti', u_prev, prv) - rhs)

    sol = jip.block_thomas_solve(d_blk, u_blk, rhs)
    for _ in range(2):
        sol = sol - jip.block_thomas_solve(d_blk, u_blk,
                                           tridiag_residual(sol))
    lin_res = tridiag_residual(sol)
    res_tol = 1e-4 * (1.0 + jnp.max(jnp.abs(rhs), initial=0.0))
    bad = jnp.logical_or(
        jnp.logical_not(jnp.all(jnp.isfinite(sol))),
        jnp.max(jnp.abs(lin_res), initial=0.0) > res_tol)
    return sol, bad


def test_jax_arm_is_jaxs_stage_solve_bit_for_bit(kc, systems):
    arm = kc.jax_arm()
    ref = jax.jit(jax.vmap(_jax_stage_solve))
    for rec in systems:
        assert rec["r"].dtype == np.float32 and rec["r"].shape == (2, 7, 19)
        sol, bad, scaled = arm(rec["d"], rec["u"], rec["r"])
        with jax.enable_x64(False), jax.default_matmul_precision("float32"):
            want, want_bad = (np.asarray(x) for x in ref(
                jnp.asarray(rec["d"]), jnp.asarray(rec["u"]),
                jnp.asarray(rec["r"])))
        assert sol.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(sol.view(np.uint32),
                                      want.view(np.uint32))
        np.testing.assert_array_equal(bad, want_bad)
        assert np.all(np.isfinite(scaled))


def test_capture_keeps_blocks_and_the_runs_own_verification(kc, systems):
    steps = [rec["step"] for rec in systems]
    assert steps == [14, 14, 14]
    assert [rec["trip"] for rec in systems] == [1, 2, 3]
    packed = kc.pack(systems, "carry14", {14})
    d, u, r = kc.unpack(packed, "b19")
    for name, got in (("d", d), ("u", u), ("r", r)):
        want = np.concatenate([rec[name] for rec in systems])
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32), err_msg=name)
    # on the CPU the staged solver's block solve is the plain version: the
    # run's own bad is the verification of the plain version's solve
    for rec in systems:
        _, bad, _ = chip_smoke.ip_solve(
            ip_staged, ip_staged.block_thomas_solve,
            *(torch.as_tensor(rec[k]) for k in ("d", "u", "r")))
        np.testing.assert_array_equal(bad.numpy(), rec["bad_run"])
    assert packed["b19_capped"].all() and len(packed["b19_call"]) == 6


def test_paired_rule_gives_the_known_answer(kc):
    rng = np.random.default_rng(13)
    n = 400
    err_b = 10.0 ** rng.normal(-5.0, 1.0, n)
    bad_b = rng.random(n) < 0.05
    # A: errors 10^0.5 times B's (so median log ratio 0.5), 20 more rejects
    err_a = err_b * 10.0 ** (0.5 + 0.1 * rng.normal(size=n))
    bad_a = bad_b.copy()
    extra = rng.choice(np.flatnonzero(~bad_b), 20, replace=False)
    bad_a[extra] = True
    back = rng.choice(np.flatnonzero(bad_b), 2, replace=False)
    bad_a[back] = False
    a_only, b_only, p = kc.mcnemar(bad_a, bad_b)
    assert (a_only, b_only) == (20, 2)
    assert p == pytest.approx(binomtest(20, 22, 0.5).pvalue, rel=1e-9)
    assert p < 0.01
    lost, det = kc.loses(bad_a, err_a, bad_b, err_b)
    assert lost and det["by_bad"] and det["by_error"]
    assert det["log_ratio_median"] == pytest.approx(0.5, abs=0.02)
    assert det["wilcoxon_p"] < 1e-50
    won, det_ba = kc.loses(bad_b, err_b, bad_a, err_a)
    assert not won and not det_ba["by_bad"] and not det_ba["by_error"]
    # the same errors with a median ratio of 10^0.2: significant, too small
    err_c = err_b * 10.0 ** (0.2 + 0.1 * rng.normal(size=n))
    lost, det = kc.loses(bad_b, err_c, bad_b, err_b)
    assert det["wilcoxon_p"] < 1e-50 and not lost
    # no difference: symmetric noise, same flags
    err_d = err_b * 10.0 ** (0.05 * rng.normal(size=n))
    lost, det = kc.loses(bad_b, err_d, bad_b, err_b)
    assert not lost and det["mcnemar_p"] == 1.0 and det["wilcoxon_p"] > 0.01
    # the outcome from the deciding pairs
    row = dict(a_loses=False, b_loses=False)
    arms = ("kernel_cuda", "plain_cuda", "plain_cpu", "jax")
    pairs = [dict(row, a=a, b=b) for i, a in enumerate(arms)
             for b in arms[i + 1:]]
    assert kc.outcome(pairs, *arms[:3]) == "C"
    for p in pairs:
        p["a_loses"] = p["b"] == "jax"
    assert kc.outcome(pairs, *arms[:3]) == "A"
    for p in pairs:
        p["a_loses"] = (p["a"], p["b"]) == ("kernel_cuda", "plain_cuda")
    assert kc.outcome(pairs, *arms[:3]) == "B"


def test_forward_error_floor_and_cap(kc):
    truth = np.array([[1.0, -2.0, np.nan], [0.5, 0.5, 0.5]])
    x = np.array([[1.0, -2.0, 0.0], [np.inf, 0.5, 0.5]], np.float32)
    err = kc.errors(x, truth)
    assert err[0] == kc.ERR_FLOOR and err[1] == kc.ERR_CAP
    x = np.array([[1.1, -2.0, 0.0], [0.5, 0.5, 0.4]], np.float32)
    np.testing.assert_allclose(kc.errors(x, truth),
                               [0.1 / 2.0, 0.1 / 0.5], rtol=1e-6)


def test_phase7_sample_check_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    z = np.load(chip_smoke.FIXTURE_KKT)
    assert os.path.getsize(chip_smoke.FIXTURE_KKT) <= 4 * 2 ** 20
    assert z["b19_d"].dtype == z["b20_rhs"].dtype == np.float32
    assert z["b19_truth"].dtype == np.float64
    out = chip_smoke.kkt_sample(thomas, ip_staged, "cpu")
    n = len(z["b19_rhs"]) + len(z["b20_rhs"])
    assert out["kernel"] == out["plain"] and out["kernel"]["systems"] == n
    assert out["kernel_vs_plain"] == dict(kernel_only_bad=0, plain_only_bad=0,
                                          mcnemar_p=1.0)
    assert out["stored_jax"]["bad"] == int(z["b19_jax_bad"].sum()
                                           + z["b20_jax_bad"].sum())


@pytest.mark.parametrize("n, p_res_ok, p_dist, fault",
                         [(11, 0.0194, 0.0439, True),
                          (17, 0.0769, 0.176, False)])
def test_shared_starts_table_gives_its_judgement(n, p_res_ok, p_dist,
                                                 fault):
    judge = _tool("judge_f32_flagship")
    card = judge.shared_rows("card")[:n]
    jax_rows = judge.shared_rows("jax")[:n]
    out = judge.judge(card, jax_rows)
    assert out["p_res_ok"] == pytest.approx(p_res_ok, abs=1e-3)
    assert out["p_min_distance"] == pytest.approx(p_dist, abs=1e-3)
    assert out["fault"] is fault
    res = judge.against_shared(card)[f"first_{n}"]
    assert res["vs_jax"] == out and res["vs_card"]["p_res_ok"] == 1.0


@pytest.mark.parametrize("shift, fault", [(0, False), (12, True)])
def test_pi_admm_rule(shift, fault):
    judge = _tool("judge_pi_admm_f32")
    jax_caps = [11, 16, 14, 25, 15, 19, 14, 33, 15, 13, 26, 15, 12, 21, 20]
    out = judge.judge([c + shift for c in jax_caps], jax_caps)
    assert out["fault"] is fault

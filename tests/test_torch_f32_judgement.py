"""The tools that judge the port's float32 flagship against JAX over shared
starts (PERF.md §6): both sides start from the same moved state for
the same seed, and the rules flag what they should.

``tools/perturbed_torch_flagship.py`` (the port, on the card) and
``tools/make_torch_fixture.py --profile f32 --noise --seed`` (JAX, on the
CPU) each move the start's ``z_bar`` by seeded normal noise; a comparison
of the two sides' runs means something only if run ``k`` starts from the
same point on both. ``tools/judge_f32_flagship.py`` and
``tools/compare_window_steps.py`` apply the rules; they are held here on
made-up numbers.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch.interop import bar_state_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def starts():
    """The float32 flagship's start on both sides: the port's planner on
    the CPU and JAX's (64-bit mode off), and the tools' noise functions."""
    import chip_smoke
    from dlp_admm_torch.models.obca import ConsensusObcaPlanner
    port = _tool("perturbed_torch_flagship")
    fixture = _tool("make_torch_fixture")
    pl = ConsensusObcaPlanner(device="cpu",
                              **chip_smoke.flagship_profile(torch.float32))
    with jax.enable_x64(False):
        jbs = fixture.make_planner("f32").create_bar_state()
        jbs = jbs._replace(**{k: np.asarray(v)
                              for k, v in jbs._asdict().items()})
    return port, fixture, pl.create_bar_state(), jbs


def test_the_unmoved_starts_agree(starts):
    _, _, tbs, jbs = starts
    for name, t in bar_state_to_numpy(tbs).items():
        j = getattr(jbs, name)
        assert t.dtype == j.dtype == np.float32, name
        np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("seed", [1, 4, 10])
def test_both_sides_draw_the_same_start_noise(starts, seed):
    """Seed ``seed`` at 1e-7 moves the port's start and JAX's to the same
    float32 bits, and moves them."""
    port, fixture, tbs, jbs = starts
    t = port.moved_bar_state(tbs, 1e-7, seed).z_bar.numpy()
    with jax.enable_x64(False):
        j = np.asarray(fixture.moved_bar_state(
            jbs._replace(z_bar=jnp.asarray(jbs.z_bar)), 1e-7, seed).z_bar)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)
    assert np.any(t != tbs.z_bar.numpy())
    other = port.moved_bar_state(tbs, 1e-7, seed + 1).z_bar.numpy()
    assert np.any(other != t)


def _row(label, res_ok, dist):
    return dict(label=label, res_ok=res_ok, steps_at_cap=0,
                min_distance_m=dist, min_footprint_gap_m=0.3, health=0.4,
                gap_median=0.008, gap_max=0.5)


@pytest.mark.parametrize("shift, fault", [(0, False), (-5, True)])
def test_judgement_rule(shift, fault):
    """The rule of PERF.md §6: a side lower than JAX's with one-sided
    Mann-Whitney p < 0.05 on res_ok (or centre distance) is a fault; the
    same spread is not."""
    judge = _tool("judge_f32_flagship")
    jax_res = [39, 40, 41, 32, 34, 39, 39, 40, 40, 39, 41]
    jax_rows = [_row(f"j{i}", r, 3.5 + 0.05 * i)
                for i, r in enumerate(jax_res)]
    port_rows = [_row(f"p{i}", r + shift, 3.5 + 0.05 * i)
                 for i, r in enumerate(jax_res)]
    out = judge.judge(port_rows, jax_rows)
    assert out["fault"] is fault
    assert (out["p_res_ok"] < judge.ALPHA) is fault
    assert out["p_min_distance"] > judge.ALPHA


@pytest.mark.parametrize("offset, biased", [(0.0, False), (0.05, True)])
def test_window_steps_lean_rule(offset, biased):
    """A side whose steps sit as far from JAX's as JAX's own moved steps,
    in both directions, is not biased; one that sits farther and one way
    is."""
    cmp = _tool("compare_window_steps")
    rng = np.random.default_rng(0)
    moved = 0.01 * rng.normal(size=21)
    side = 0.01 * rng.normal(size=21) + offset
    out = cmp.lean(side, moved)
    assert out["biased"] is biased

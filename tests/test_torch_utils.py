"""Checkpoint/resume, profiler traces and plotting of the PyTorch port,
against the JAX package, on the CPU.

Mirrors ``tests/test_driver_utils.py``'s ``TestCheckpoint``,
``TestEngineCheckpointResume`` and ``TestMetrics``. The JAX runs come from
the committed ``tests/data/checkpoint_ref.npz`` (``tools/make_torch_fixture.py
--profile checkpoint``): each planner at the JAX tests' tiny configuration,
run uninterrupted and checkpointed at step 2 by JAX's own ``save_carry``.

Tolerances, float64: a resumed run equals the uninterrupted one to 1e-12
with equal iteration counts (it replays the same operations from a carry
that the file holds bit for bit). The port's step-2 checkpoint leaves equal
JAX's in number, shape, dtype and structure string, and agree within 1e-12
of each leaf's largest magnitude (at most 1.4e-13 of it, measured; the
consensus duals of size 10 differ by 1.4e-12); in the classic PI-ADMM
layout within 1e-8, the tolerance ``tests/test_torch_pi_admm_classic.py``
holds that layout's runs to against JAX: its QP loops stop on a tolerance,
so the order of the sums moves the controls by 3.5e-10 of their size after
two steps. The uninterrupted runs agree with JAX's within 1e-9 (measured
4e-11 at most), with equal iteration counts.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch import config as tcfg
from dlp_admm_torch.models.aladin import AladinEngine, AladinProblem
from dlp_admm_torch.models.bilevel import BilevelObcaPlanner
from dlp_admm_torch.models.obca import BarState, ConsensusObcaPlanner
from dlp_admm_torch.models.pi_admm import PiAdmmEngine
from dlp_admm_torch.mpc import run_obca, run_pi_admm
from dlp_admm_torch.utils import (RunMetrics, load_carry,
                                  plot_iteration_history, plot_trajectories,
                                  save_carry, trace)
from dlp_admm_torch.utils.checkpoint import flatten
from dlp_admm_tpu.models.obca import BarState as JBarState
from dlp_admm_tpu.utils import checkpoint as jckpt

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURE = os.path.join(DATA, "checkpoint_ref.npz")
RESUME_TOL = 1e-12
LEAF_TOL = {"pi_admm_classic": 1e-8}   # of the leaf's largest magnitude
RUN_TOL = 1e-9


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
    data = np.load(FIXTURE)
    return data, json.loads(str(data["profile"]))


# -- save_carry / load_carry -------------------------------------------------

class TestCheckpoint:
    def test_roundtrip_pytree(self, tmp_path):
        carry = {"a": torch.arange(6.0, dtype=torch.float64).reshape(2, 3),
                 "b": (torch.tensor(3), torch.ones(4, dtype=torch.float32))}
        path = str(tmp_path / "ckpt.npz")
        save_carry(path, carry, step=7)
        like = {"a": torch.zeros(2, 3, dtype=torch.float64),
                "b": (torch.tensor(0), torch.zeros(4, dtype=torch.float32))}
        restored, step = load_carry(path, like)
        assert step == 7
        assert torch.equal(restored["a"], carry["a"])
        assert restored["b"][1].dtype == torch.float32
        assert torch.equal(restored["b"][0], carry["b"][0])

    def test_rejects_mismatched_carry(self, tmp_path):
        carry = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
        path = str(tmp_path / "ckpt.npz")
        save_carry(path, carry, step=1)
        with pytest.raises(ValueError, match="shape"):
            load_carry(path, {"a": torch.zeros(3, 3), "b": torch.zeros(4)})
        with pytest.raises(ValueError, match="leaves|treedef"):
            load_carry(path, {"a": torch.zeros(2, 3),
                              "b": (torch.zeros(4), torch.zeros(2))})
        with pytest.raises(ValueError, match="treedef"):
            load_carry(path, (torch.zeros(2, 3), torch.zeros(4)))

    def test_leaves_come_back_in_the_like_dtype(self, tmp_path):
        path = str(tmp_path / "ckpt.npz")
        save_carry(path, (torch.full((2,), 1.5, dtype=torch.float64),),
                   step=3)
        (x,), step = load_carry(path, (torch.zeros(2, dtype=torch.float32),))
        assert x.dtype == torch.float32 and step == 3
        assert torch.equal(x, torch.full((2,), 1.5))

    @pytest.mark.parametrize("case", ["bar_state", "dict", "list_none",
                                      "one_tuple"])
    def test_structure_string_is_jax_s(self, case):
        """The ``.tree`` sidecar's structure string and the leaf order are
        ``jax.tree.flatten``'s, so leaf i means the same in both packages."""
        rng = np.random.default_rng(0)
        arrs = [rng.normal(size=(2, k + 1)) for k in range(6)]
        make = {
            "bar_state": lambda c, bs: (c(arrs[0]), bs(*map(c, arrs))),
            "dict": lambda c, bs: {"z": c(arrs[0]), "a": (c(arrs[1]),
                                                          c(arrs[2]))},
            "list_none": lambda c, bs: [c(arrs[0]), None, {"x": c(arrs[1])}],
            "one_tuple": lambda c, bs: (c(arrs[3]),),
        }[case]
        leaves, structure = flatten(make(torch.as_tensor, BarState))
        j_leaves, j_def = jax.tree.flatten(make(jnp.asarray, JBarState))
        assert structure == str(j_def)
        assert len(leaves) == len(j_leaves)
        for a, b in zip(leaves, j_leaves):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_files_cross_between_packages(self, tmp_path):
        """A port file loads in JAX and a JAX file in the port."""
        rng = np.random.default_rng(1)
        arrs = [rng.normal(size=(2, 3)) for _ in range(7)]
        t_carry = (torch.as_tensor(arrs[0]),
                   BarState(*map(torch.as_tensor, arrs[1:])))
        j_carry = (jnp.asarray(arrs[0]), JBarState(*map(jnp.asarray,
                                                       arrs[1:])))
        t_path, j_path = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
        save_carry(t_path, t_carry, 4)
        jckpt.save_carry(j_path, j_carry, 5)
        (j_st, j_bs), j_step = jckpt.load_carry(t_path, j_carry)
        (t_st, t_bs), t_step = load_carry(j_path, t_carry)
        assert (j_step, t_step) == (4, 5)
        np.testing.assert_array_equal(np.asarray(j_bs.local_x), arrs[6])
        assert isinstance(t_bs, BarState)
        np.testing.assert_array_equal(t_bs.lamb_ij.numpy(), arrs[5])
        np.testing.assert_array_equal(t_st.numpy(), arrs[0])


# -- checkpoint / resume of every planner ------------------------------------

def _planner_run(name, c, checkpoint_path=None, resume=False, steps=None):
    """The port's run of case ``name`` of the fixture's ``CHECKPOINT``:
    ``(states [n, ...], iterations or None)``; ALADIN: ``(x, ys)``."""
    steps = c["steps"] if steps is None else steps
    kw = dict(checkpoint_path=checkpoint_path, resume=resume)
    if name == "consensus":
        pl = ConsensusObcaPlanner(tcfg.ObcaConfig(**c["ocfg"]),
                                  scfg=tcfg.SolverConfig(**c["scfg"]),
                                  device="cpu")
        states, its, _, _ = pl.run(n_steps=steps, **kw)
        return states, its
    if name == "bilevel":
        pl = BilevelObcaPlanner(tcfg.ObcaConfig(**c["ocfg"]),
                                scfg=tcfg.SolverConfig(**c["scfg"]),
                                n_rounds=c["n_rounds"], device="cpu")
        return pl.run(n_steps=steps, **kw)[0], None
    if name == "aladin":
        f64 = dict(dtype=torch.float64)
        prob = AladinProblem(
            f=lambda y, p: torch.sum((y - p) ** 2),
            h=lambda y, p: torch.zeros((0,), dtype=y.dtype),
            a_mats=torch.tensor(c["a_mats"], **f64),
            b=torch.zeros(1, **f64))
        eng = AladinEngine(prob, rho=c["rho"], mu=c["mu"],
                           scfg=tcfg.SolverConfig(**c["scfg"]), device="cpu")
        targets = torch.tensor(c["targets"], **f64)
        st, ys = eng.run(torch.zeros(targets.shape, **f64), targets,
                         n_iters=steps, tol=None, **kw)
        return st.x.numpy(), ys.numpy()
    eng = PiAdmmEngine(tcfg.PiAdmmConfig(**c["cfg"]), tcfg.DualUpdateConfig(),
                       tcfg.SolverConfig(**c["scfg"]), layout=c["layout"],
                       device="cpu", **c["engine"])
    rec = eng.run(xt0=np.asarray(c["xt0"]), n_steps=steps, **kw)
    return rec.xt, rec.iterations


CASES = ["consensus", "bilevel", "aladin", "pi_admm", "pi_admm_classic"]


@pytest.mark.parametrize("name", CASES)
def test_resume_matches_uninterrupted_and_jax(ref, tmp_path, name):
    """Run to step 2 with a checkpoint, resume to the end with a new
    planner object: the resumed steps equal the uninterrupted run's
    (iteration counts too); the step-2 file holds JAX's leaves; the
    uninterrupted run is JAX's."""
    data, prof = ref
    c = prof[name]
    k = c["ckpt_at"]
    path = str(tmp_path / f"{name}.npz")
    full = _planner_run(name, c)
    _planner_run(name, c, checkpoint_path=path, steps=k)
    saved = dict(np.load(path))
    with open(path + ".tree") as f:
        tree = json.load(f)
    tail = _planner_run(name, c, checkpoint_path=path, resume=True)

    # the resumed tail against the uninterrupted run
    if name == "aladin":
        np.testing.assert_allclose(tail[0], full[0], rtol=0, atol=RESUME_TOL)
        np.testing.assert_allclose(tail[1], full[1], rtol=0, atol=RESUME_TOL)
    else:
        # OBCA: the states from step k on (the resumed run's start is the
        # saved state); PI-ADMM: the states after steps k+1 .. n
        np.testing.assert_allclose(tail[0], full[0][k:], rtol=0,
                                   atol=RESUME_TOL)
        if full[1] is not None:
            np.testing.assert_array_equal(tail[1], full[1][k:])

    # the step-k checkpoint against JAX's save_carry file of that step
    n = int(data[f"{name}__n_leaves"])
    assert tree["n_leaves"] == n
    assert tree["treedef"] == str(data[f"{name}__treedef"])
    assert int(saved["__step__"]) == int(data[f"{name}__step"]) == k
    for i in range(n):
        got, want = saved[f"leaf_{i}"], data[f"{name}__leaf_{i}"]
        assert got.shape == want.shape and got.dtype == want.dtype, i
        if want.dtype == np.bool_:
            np.testing.assert_array_equal(got, want)
        else:
            tol = LEAF_TOL.get(name, 1e-12) * max(1.0, float(np.abs(
                want).max(initial=0.0)))
            np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                       err_msg=f"leaf {i}")

    # the uninterrupted run against JAX's
    if name == "aladin":
        np.testing.assert_allclose(full[0], data["aladin__x"], rtol=0,
                                   atol=RUN_TOL)
        np.testing.assert_allclose(full[1], data["aladin__ys"], rtol=0,
                                   atol=RUN_TOL)
    else:
        np.testing.assert_allclose(full[0], data[f"{name}__states"], rtol=0,
                                   atol=RUN_TOL)
        if full[1] is not None:
            np.testing.assert_array_equal(full[1],
                                          data[f"{name}__iterations"])


def test_pi_admm_resume_without_the_carry(tmp_path):
    """``tests/test_driver_utils.py``'s exact PI-ADMM case: the pairwise
    layout without the cross-step carry, 6 steps resumed from step 3, saves
    ``(xt [V, 3], u [V, H])``."""
    cfg = tcfg.PiAdmmConfig(iter_num=4)
    xt0 = np.array([[-3.0, 0.0, 0.0], [0.0, 6.0, -np.pi / 2]])
    eng = PiAdmmEngine(cfg, tcfg.DualUpdateConfig(),
                       tcfg.SolverConfig(qp_iters=120, qp_tol=1e-6),
                       layout="pairwise", device="cpu")
    full = eng.run(xt0=xt0, n_steps=6)
    path = str(tmp_path / "run.npz")
    eng.run(xt0=xt0, n_steps=3, checkpoint_path=path)
    saved = np.load(path)
    assert saved["leaf_0"].shape == (2, 3)
    assert saved["leaf_1"].shape == (2, cfg.horizon)
    tail = eng.run(xt0=xt0, n_steps=6, checkpoint_path=path, resume=True)
    np.testing.assert_allclose(tail.xt, full.xt[3:], rtol=0, atol=RESUME_TOL)
    np.testing.assert_array_equal(tail.iterations, full.iterations[3:])


# -- metrics, profiler trace, plots ------------------------------------------

class TestMetrics:
    def test_summary(self):
        m = RunMetrics()
        with m.step_timer():
            pass
        m.log_step(0, 5, rho=1.0)
        m.log_step(1, 7, rho=2.0)
        s = m.summary()
        assert s["total_iterations"] == 12
        assert s["steps"] == 2
        assert m.extras["rho"] == [1.0, 2.0]

    def test_profiler_trace_writes_a_chrome_trace(self, tmp_path):
        with trace("off") as path:
            assert path is None
        one = torch.ones(8, 8, dtype=torch.float64)
        with trace("mat", enabled=True, trace_dir=str(tmp_path)) as path:
            one @ one
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any("mm" in str(e.get("name", "")) for e in events)


def _png_shape(path):
    import matplotlib.image as mpimg
    return mpimg.imread(path).shape


def test_drivers_plot_their_runs(tmp_path):
    """``plot_path`` on both drivers writes a PNG (footprints for the OBCA
    states), as the JAX driver does."""
    obca_png = str(tmp_path / "obca.png")
    res = run_obca(tcfg.Formulation.CONSENSUS,
                   ocfg=tcfg.ObcaConfig(horizon=5, max_admm_iters=2,
                                        rho=100.0),
                   scfg=tcfg.SolverConfig(ip_iters=5, ip_tol=1e-6),
                   n_steps=1, plot_path=obca_png, device="cpu")
    assert res.states.shape == (2, 2, 5)
    pi_png = str(tmp_path / "pi.png")
    res = run_pi_admm(tcfg.PiAdmmConfig(iter_num=4), layout="pairwise",
                      scfg=tcfg.SolverConfig(qp_iters=120, qp_tol=1e-6),
                      n_steps=2, plot_path=pi_png, device="cpu")
    assert res.states.shape == (2, 2, 3)
    hist_png = plot_iteration_history(res.metrics.iter_history,
                                      str(tmp_path / "its.png"))
    traj_png = plot_trajectories(torch.as_tensor(res.states),
                                 str(tmp_path / "traj.png"),
                                 footprints=False)
    for p in (obca_png, pi_png, hist_png, traj_png):
        h, w = _png_shape(p)[:2]
        assert h > 100 and w > 100, p

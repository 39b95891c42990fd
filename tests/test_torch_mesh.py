"""The port's device mesh over ``torch.distributed`` ranks
(``dlp_admm_torch/parallel/mesh.py``, ``multihost.py`` and the vehicle-sharded
``make_consensus_spmd_step(planner, mesh)``) against the JAX package on the
CPU, the counterpart of ``tests/test_consensus_spmd.py``,
``tests/test_multihost.py`` and
``tests/test_driver_utils.py::TestShardingEquivalence``.

Each run spawns gloo ranks on the CPU through
``tools/multihost_smoke_torch.py`` (one torch thread a rank, a timeout on
every process); each rank writes its blocks, which are stitched here. The
cases are those of ``tests/data/consensus_spmd_cases_ref.npz`` (inputs made
with numpy from a seed): the 2-vehicle reference problem on 1x2, 2x1 and
2x2 meshes (2 and 4 ranks), 4 vehicles in 2-vehicle blocks with gating,
``track_local``, the staged default mode and the annealed-prox profile.

Tolerances: against JAX's sharded step on the matching mesh of the 8 CPU
devices (``tests/data/consensus_spmd_mesh_ref.npz``, ``python
tools/make_torch_fixture.py --profile mesh``; one case rerun live), JAX's
own: atol 1e-8 on the states and ``z_bar``, equal ADMM iterations and
converged flags. Against the port's one-device batched step, 1e-12: the
step builds every parameter on the gathered full view and sums the residuals
over it in the one-device order, so only the batch sizes of the local
solves differ.
"""
import glob
import importlib.util
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlp_admm_torch.models.obca import BarState
from dlp_admm_torch.parallel import multihost
from dlp_admm_torch.parallel.consensus_spmd import make_consensus_spmd_step
from dlp_admm_torch.parallel.mesh import (PlannerMesh, Sharding,
                                          gather_scenarios, planner_mesh,
                                          replicated, scenario_sharding,
                                          shard_scenarios)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tools", "multihost_smoke_torch.py")
MESH_FIXTURE = os.path.join(ROOT, "tests", "data",
                            "consensus_spmd_mesh_ref.npz")
JAX_TOL = 1e-8
ONE_DEVICE_TOL = 1e-12
RANK_TIMEOUT_S = 300
SPMD = ("two_vehicle_reference_problem", "four_vehicle_blocks_with_gating",
        "track_local_mode", "staged_default_mode", "annealed_prox_profile")
BATCH = ("batch_pairwise", "batch_classic", "batch_consensus")
# the ranks of each spawn: (world, mesh, cases)
RUNS = {"1x2": (2, "1,2", SPMD),
        "2x1": (2, "2,1", ("two_vehicle_reference_problem",) + BATCH),
        "2x2": (4, "2,2", ("two_vehicle_reference_problem",))}
MESH_CASES = [(c, m) for m, (_, _, cases) in RUNS.items() for c in cases
              if c not in BATCH]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(world, out_dir, *args):
    """Run ``world`` gloo ranks of the rank script at once; returns their
    outputs. Every rank has a timeout; a rank that fails fails the run."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, SCRIPT, str(r), str(world), str(port), "--device",
         "cpu", "--backend", "gloo", "--out", str(out_dir), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every mesh's ranks, run once for the module: mesh -> rank files."""
    files = {}
    for name, (world, mesh, cases) in RUNS.items():
        out = tmp_path_factory.mktemp(f"mesh_{name}")
        args = ["--mesh", mesh]
        for c in cases:
            args += ["--case", c]
        spawn(world, out, *args)
        files[name] = [np.load(f) for f in sorted(glob.glob(
            str(out / "rank*.npz")))]
        assert len(files[name]) == world
    return files


def stitch(ranks, case):
    """The full outputs of ``case`` from the ranks' blocks: leaves with a
    vehicle axis placed by each rank's ``[s_lo, s_hi, v_lo, v_hi]``, the
    per-scenario leaves by its scenario block (equal bit for bit on every
    rank of a vehicle group)."""
    keys = sorted(k[len(case) + 2:] for k in ranks[0].files
                  if k.startswith(case + "__out"))
    full = {}
    for k in keys:
        blocks = [(r[f"{case}__index"], r[f"{case}__{k}"]) for r in ranks]
        n_s = max(ix[1] for ix, _ in blocks)
        n_v = max(ix[3] for ix, _ in blocks)
        per_vehicle = n_v > 0 and blocks[0][1].ndim >= 2 and \
            blocks[0][1].shape[1] == blocks[0][0][3] - blocks[0][0][2]
        shape = ((n_s, n_v) if per_vehicle else (n_s,)) + \
            blocks[0][1].shape[2 if per_vehicle else 1:]
        out = np.zeros(shape, blocks[0][1].dtype)
        seen = np.zeros(shape[:2 if per_vehicle else 1], bool)
        for ix, a in blocks:
            at = (slice(ix[0], ix[1]), slice(ix[2], ix[3])) if per_vehicle \
                else (slice(ix[0], ix[1]),)
            if seen[at].all():
                np.testing.assert_array_equal(out[at], a, err_msg=k)
            out[at], seen[at] = a, True
        assert seen.all(), k
        full[k] = out
    return full


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device batched step of every case: name -> outputs."""
    mod = _load(SCRIPT, "multihost_smoke_torch")
    out = {}
    for name in SPMD:
        pl, init, bs = mod.spmd_case(name, torch.device("cpu"))
        out[name] = mod.flatten(name, make_consensus_spmd_step(pl)(init,
                                                                   bs, 0))
    for name in BATCH:
        eng, inputs = mod.batch_case(name, torch.device("cpu"))
        if name == "batch_consensus":
            res = make_consensus_spmd_step(eng)(*inputs, 0)
        elif name == "batch_classic":
            res = eng._mpc_step_classic(*inputs, 0)
        else:
            res = eng._mpc_step_pairwise(*inputs, 0)[:3]
        out[name] = mod.flatten(name, res)
    return out


def _check(got, want, tol):
    """States and every ``BarState`` leaf within ``tol``; equal ADMM
    iterations and converged flags."""
    np.testing.assert_allclose(got["out_0"], want["out_0"], rtol=0, atol=tol,
                               err_msg="next state")
    for f in BarState._fields:
        np.testing.assert_allclose(got[f"out_1_{f}"], want[f"out_1_{f}"],
                                   rtol=0, atol=tol, err_msg=f)
    np.testing.assert_array_equal(got["out_2"], want["out_2"])
    np.testing.assert_array_equal(got["out_5"], want["out_5"])


@pytest.mark.parametrize("case,mesh", MESH_CASES,
                         ids=[f"{c}-{m}" for c, m in MESH_CASES])
def test_sharded_step_matches_jax_and_one_device(runs, one_device, case,
                                                 mesh):
    """The vehicle-sharded step on the mesh: within JAX's tolerance of
    JAX's sharded step on the same mesh (equal iterations and converged
    flags), within 1e-12 of the port's one-device step."""
    got = stitch(runs[mesh], case)
    ref = np.load(MESH_FIXTURE)
    jax_key = f"{case}@{mesh}__"
    want = {k[len(jax_key):]: ref[k] for k in ref.files
            if k.startswith(jax_key)}
    _check(got, want, JAX_TOL)
    mine = {k[len(case) + 2:]: v for k, v in one_device[case].items()}
    _check(got, mine, ONE_DEVICE_TOL)
    for i in (3, 4, 6):                   # primal, dual, gap
        np.testing.assert_allclose(got[f"out_{i}"], mine[f"out_{i}"],
                                   rtol=ONE_DEVICE_TOL, atol=0)


def test_mesh_fixture_matches_jax_live():
    """The committed JAX outputs are what JAX's sharded step computes: the
    cheapest case rerun live on its 1x2 mesh of the 8 CPU devices."""
    from dlp_admm_tpu.parallel.consensus_spmd import \
        make_consensus_spmd_step as j_step
    from dlp_admm_tpu.parallel.mesh import planner_mesh as j_mesh
    tool = _load(os.path.join(ROOT, "tools", "make_torch_fixture.py"),
                 "make_torch_fixture")
    ref = np.load(MESH_FIXTURE)
    assert json.loads(str(ref["profile"])) == [list(c) for c in
                                               tool.MESH_CASES]
    name = "track_local_mode"
    pl, init, bs = tool.spmd_case(name)
    out = j_step(pl, j_mesh(1, 2))(jnp.asarray(init), bs,
                                   jnp.asarray(0, jnp.int32))
    np.testing.assert_allclose(np.asarray(out[0]), ref[f"{name}@1x2__out_0"],
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(out[2]),
                                  ref[f"{name}@1x2__out_2"])
    assert jax.device_count() == 8


@pytest.mark.parametrize("name", BATCH)
def test_sharded_batch_step_matches_single_device(runs, one_device, name):
    """``sharded_batch_step`` over a 2x1 mesh: each rank steps its scenario
    block through the engine's lane-batched step; the stitched blocks equal
    the single-device step (JAX's own test: atol 1e-10, equal
    iterations)."""
    got = stitch(runs["2x1"], name)
    want = {k[len(name) + 2:]: v for k, v in one_device[name].items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-10,
                                   err_msg=k)
    its = "out_2" if name == "batch_consensus" else "out_2_iterations"
    np.testing.assert_array_equal(got[its], want[its])


def test_two_rank_smoke(tmp_path):
    """The counterpart of ``tests/test_multihost.py``: two ranks run the
    scenario-sharded PI-ADMM step and the vehicle-sharded consensus step
    collectively, each checking its blocks against its own single-device
    run."""
    outs = spawn(2, tmp_path)
    for r, out in enumerate(outs):
        assert f"rank {r}/2: process group on gloo" in out, out[-3000:]
        assert f"MULTIHOST_OK process={r}/2" in out, out[-3000:]
        assert f"MULTIHOST_CONSENSUS_OK process={r}/2" in out, out[-3000:]


def test_rank_stats_count_the_exchange(runs):
    """Every rank of a vehicle group gathered (the 1x2 run's collectives
    were counted with their bytes); the 2x1 run's vehicle groups have one
    rank each and still went through the collective."""
    for mesh in ("1x2", "2x1"):
        for r in runs[mesh]:
            st = json.loads(str(r["stats"]))
            assert st["calls"] > 0 and st["bytes"] > 0, (mesh, st)


def test_initialize_is_a_noop_for_one_process():
    import torch.distributed as dist
    assert multihost.initialize() is None
    assert multihost.initialize(num_processes=1, process_id=0) is None
    assert not dist.is_initialized()
    assert multihost.default_backend(2, "cpu") == "gloo"


def test_multihost_planner_mesh_keeps_vehicle_groups_on_a_host(monkeypatch):
    """A vehicle axis that does not divide a host's ranks would cross a
    host: refused, as JAX's ``local_device_count % n_vehicle``."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="must divide the 3 ranks"):
        multihost.multihost_planner_mesh(n_vehicle=2)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    with pytest.raises(ValueError, match="must divide the 1 ranks"):
        multihost.multihost_planner_mesh(n_vehicle=2)
    mesh = multihost.multihost_planner_mesh()
    assert mesh.shape == dict(scenario=1, vehicle=1) and not mesh.distributed


def test_one_process_mesh_degenerates_to_one_by_one():
    """Without a process group the mesh is 1x1 (JAX's on one device):
    blocks are the whole arrays and the gathers the identity;
    ``make_global_batch`` keeps every scenario."""
    mesh = planner_mesh()
    assert mesh.shape == dict(scenario=1, vehicle=1) and not mesh.distributed
    with pytest.raises(ValueError, match="needs a process group"):
        planner_mesh(n_scenario=2)
    a = torch.arange(24.0).reshape(4, 2, 3)
    tree = dict(x=a, y=(a[:, 0],))
    sh = shard_scenarios(mesh, tree)
    assert torch.equal(sh["x"], a) and torch.equal(sh["y"][0], a[:, 0])
    assert gather_scenarios(mesh, sh)["x"] is sh["x"]
    assert replicated(mesh).index(a.shape) == ()
    got = multihost.make_global_batch(mesh, dict(x=a.numpy()))
    assert torch.equal(got["x"], a)
    # the index arithmetic of a rank of a 2x2 mesh
    rank3 = PlannerMesh(2, 2, scenario_idx=1, vehicle_idx=1)
    sv = Sharding(rank3, ("scenario", "vehicle"))
    assert sv.index((4, 2, 5)) == (slice(2, 4), slice(1, 2))
    assert scenario_sharding(rank3).index((4,)) == (slice(2, 4),)
    with pytest.raises(ValueError, match="does not split"):
        sv.index((3, 2))


def test_vehicle_axis_must_divide_the_vehicles():
    from dlp_admm_torch import config as tcfg
    from dlp_admm_torch.models.obca import ConsensusObcaPlanner
    pl = ConsensusObcaPlanner(tcfg.ObcaConfig(horizon=5), device="cpu")
    mesh = PlannerMesh(1, 3, vehicle_group=object())
    with pytest.raises(ValueError, match="must divide the vehicle axis 3"):
        make_consensus_spmd_step(pl, mesh)

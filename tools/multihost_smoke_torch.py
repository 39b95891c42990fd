"""Per-rank script of the port's multi-process runs over ``torch.distributed``.

Run once per rank, all ranks at once (the tests and ``chip_smoke.py`` spawn
them):

    python tools/multihost_smoke_torch.py <rank> <world> <port> \\
        --device cpu|cuda --backend gloo|nccl [--mesh S,V] [--case NAME]... \\
        [--steps N] [--out DIR]

Every rank joins the process group at ``localhost:<port>``
(``parallel.multihost.initialize``), builds the ``(scenario, vehicle)``
mesh and runs its cases:

* no ``--case`` (the counterpart of ``tools/multihost_smoke.py``): the
  scenario-sharded pairwise PI-ADMM step (``sharded_batch_step``) and the
  vehicle-sharded consensus-OBCA step (``make_consensus_spmd_step`` with
  the mesh), each held against the same step run by this rank alone on its
  device; prints ``MULTIHOST_OK`` and ``MULTIHOST_CONSENSUS_OK``;
* a case of ``tests/data/consensus_spmd_cases_ref.npz`` (its inputs and
  planner): one vehicle-sharded consensus step on the mesh;
* ``batch_pairwise``, ``batch_classic``, ``batch_consensus``: one step of
  ``sharded_batch_step`` on the rank's scenario block;
* ``bench``: ``bench.py``'s third metric at its width (16 scenarios x 2
  vehicles, the flagship's float64 profile, the starts of
  ``tests/data/consensus_obca_batch_f64_ref.npz``) through the
  vehicle-sharded step for ``--steps`` MPC steps, with the wall per step,
  the collectives' seconds, the rank's block-Thomas launches and block
  solves, the KKT shapes and the reserved device memory.

With ``--out DIR`` each rank writes its blocks to ``DIR/rank<r>.npz``
(keys ``<case>__<field>``; ``<case>__index`` the rank's
``[s_lo, s_hi, v_lo, v_hi]``, ``<case>__info`` a JSON record); what it
prints goes to its own standard output, which the parent reads.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

DATA = os.path.join(ROOT, "tests", "data")
CASES_FIXTURE = os.path.join(DATA, "consensus_spmd_cases_ref.npz")
BATCH_FIXTURE = os.path.join(DATA, "consensus_obca_batch_f64_ref.npz")
BATCH_CASES = ("batch_pairwise", "batch_classic", "batch_consensus")


def spmd_case(name, device):
    """The port's planner of case ``name`` of the committed cases fixture,
    its starts ``[S, V, 5]`` and batched ``BarState``, on ``device``."""
    from dlp_admm_torch import config as tcfg
    from dlp_admm_torch.interop import bar_state_from_numpy
    from dlp_admm_torch.models.obca import BarState, ConsensusObcaPlanner
    ref = np.load(CASES_FIXTURE)
    case = json.loads(str(ref["profile"]))[name]
    kw = dict(dict(use_staged=False, edge_mode="joint"),
              **case.get("planner", {}))
    dtype = getattr(torch, case.get("dtype", "float64"))
    pl = ConsensusObcaPlanner(
        tcfg.ObcaConfig(num_veh=case["num_veh"], horizon=case["horizon"],
                        max_admm_iters=case.get("max_admm_iters", 2),
                        rho=100.0),
        scfg=tcfg.SolverConfig(**case.get("scfg", dict(ip_iters=5,
                                                       ip_tol=1e-6))),
        dtype=dtype, device=device, **kw)
    init = torch.as_tensor(ref[f"{name}__init"], dtype=dtype, device=device)
    bs = bar_state_from_numpy(
        {f: ref[f"{name}__bs_{f}"] for f in BarState._fields}, dtype=dtype,
        device=device)
    return pl, init, bs


def bench_case(device):
    """``bench.py``'s third metric: the flagship's float64 profile
    (``bench.py:194-212``) and the batch fixture's 16 starts."""
    from dlp_admm_torch import config as tcfg
    from dlp_admm_torch.models.obca import BarState, ConsensusObcaPlanner
    pl = ConsensusObcaPlanner(
        tcfg.ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                        max_admm_iters=50),
        scfg=tcfg.SolverConfig(ip_iters=40, ip_tol=1e-6), local_prox=700.0,
        prox_growth=1.5, prox_tau_max=3.0e10, dtype=torch.float64,
        device=device)
    init = torch.as_tensor(np.load(BATCH_FIXTURE)["states"][0],
                           dtype=torch.float64, device=device)
    s = init.shape[0]
    bs = BarState(*(a.expand((s,) + a.shape).clone()
                    for a in pl.create_bar_state()))
    return pl, init, bs


def batch_case(name, device):
    """``(engine, inputs)`` of a ``sharded_batch_step`` case, the
    counterparts of ``tests/test_driver_utils.py::TestShardingEquivalence``:
    8 lanes of the PI-ADMM engine (``iter_num`` 5) from 0.05 m noise
    (``default_rng(0)``), or 4 lanes of the consensus planner (horizon 8,
    ADMM cap 2, ``ip_iters`` 6)."""
    from dlp_admm_torch import config as tcfg
    from dlp_admm_torch import scenarios
    from dlp_admm_torch.models.obca import BarState, ConsensusObcaPlanner
    from dlp_admm_torch.models.pi_admm import PiAdmmEngine
    kw = dict(dtype=torch.float64, device=device)
    if name == "batch_consensus":
        pl = ConsensusObcaPlanner(
            tcfg.ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                            max_admm_iters=2),
            scfg=tcfg.SolverConfig(ip_iters=6, ip_tol=1e-6), device=device)
        init = pl.refs[:, 0, :].expand(4, 2, 5).clone()
        bs = BarState(*(a.expand((4,) + a.shape).clone()
                        for a in pl.create_bar_state()))
        return pl, (init, bs)
    cfg = tcfg.PiAdmmConfig(iter_num=5)
    eng = PiAdmmEngine(cfg, tcfg.DualUpdateConfig(),
                       tcfg.SolverConfig(qp_iters=120, qp_tol=1e-6),
                       layout=name[len("batch_"):], device=device)
    xt0 = np.asarray(scenarios.pi_admm_initial_states(cfg))
    xt0[:, :2] *= 0.25
    rng = np.random.default_rng(0)
    xts = xt0[None] + 0.05 * rng.normal(size=(8,) + xt0.shape)
    return eng, (torch.as_tensor(xts, **kw),
                 torch.zeros((8, cfg.num_veh, cfg.horizon), **kw))


def flatten(prefix, out):
    """A step's outputs as ``{prefix__out_<i>[_<leaf>]: numpy}``."""
    flat = {}
    for i, x in enumerate(out):
        if hasattr(x, "_fields"):
            for f, a in x._asdict().items():
                flat[f"{prefix}__out_{i}_{f}"] = a.detach().cpu().numpy()
        else:
            flat[f"{prefix}__out_{i}"] = x.detach().cpu().numpy()
    return flat


def run_spmd(name, mesh, device):
    from dlp_admm_torch.parallel.consensus_spmd import \
        make_consensus_spmd_step
    from dlp_admm_torch.parallel.mesh import Sharding, tree_map
    pl, init, bs = spmd_case(name, device)
    sv = Sharding(mesh, ("scenario", "vehicle"))
    step = make_consensus_spmd_step(pl, mesh)
    out = step(sv.take(init), tree_map(sv.take, bs), 0)
    idx = sv.index(init.shape)
    rec = flatten(name, out)
    rec[f"{name}__index"] = np.array([idx[0].start, idx[0].stop,
                                      idx[1].start, idx[1].stop])
    return rec


def run_batch(name, mesh, device):
    from dlp_admm_torch.parallel.mesh import (scenario_sharding,
                                              shard_scenarios,
                                              sharded_batch_step)
    eng, inputs = batch_case(name, device)
    out = sharded_batch_step(eng, mesh)(*shard_scenarios(mesh, inputs), 0)
    idx = scenario_sharding(mesh).index(inputs[0].shape)
    rec = flatten(name, out)
    rec[f"{name}__index"] = np.array([idx[0].start, idx[0].stop, 0, 0])
    return rec


def run_bench(mesh, device, n_steps):
    """The bench batch through the vehicle-sharded step, ``n_steps`` MPC
    steps, with the rank's numbers."""
    from dlp_admm_torch.parallel.consensus_spmd import \
        make_consensus_spmd_step
    from dlp_admm_torch.parallel.mesh import Sharding, tree_map
    from dlp_admm_torch.solvers import ip_staged, thomas
    pl, init, bs = bench_case(device)
    sv = Sharding(mesh, ("scenario", "vehicle"))
    step = make_consensus_spmd_step(pl, mesh)
    st, bs = sv.take(init), tree_map(sv.take, bs)
    shapes = set()
    solve = ip_staged.block_thomas_solve

    def seen(diag, upper, rhs):          # the KKT shapes of this rank
        shapes.add(tuple(rhs.shape))
        return solve(diag, upper, rhs)

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sts, rows, walls = [st], [], []
    ip_staged.block_thomas_solve = seen
    try:
        sync()
        thomas.reset_counts()
        coll0 = dict(mesh.stats)
        for k in range(n_steps):
            t0 = time.perf_counter()
            st, bs, it, pr, du, cv, gap = step(st, bs, k)
            sync()
            walls.append(time.perf_counter() - t0)
            sts.append(st)
            rows.append((it, pr, du, cv, gap))
        launches = dict(thomas.launches_by_kernel)
    finally:
        ip_staged.block_thomas_solve = solve
    idx = sv.index(init.shape)
    rec = {"bench__states": torch.stack(sts).cpu().numpy(),
           "bench__index": np.array([idx[0].start, idx[0].stop,
                                     idx[1].start, idx[1].stop])}
    for i, f in enumerate(("iterations", "primal", "dual", "converged",
                           "gap")):
        rec[f"bench__{f}"] = torch.stack([r[i] for r in rows],
                                         dim=1).cpu().numpy()
    executed = int(rec["bench__iterations"].max(axis=0).sum())
    coll_s = mesh.stats["seconds"] - coll0["seconds"]
    info = dict(
        steps=n_steps, wall_s=sum(walls), wall_per_step_s=walls,
        executed_admm_iterations=executed,
        wall_per_executed_iteration_s=sum(walls) / max(executed, 1),
        collective_calls=mesh.stats["calls"] - coll0["calls"],
        collective_bytes=mesh.stats["bytes"] - coll0["bytes"],
        collective_s=coll_s, collective_share=coll_s / sum(walls),
        launches=launches, block_solves=pl.block_solves,
        kkt_shapes=sorted(shapes))
    if cuda:
        info.update(memory_reserved_gib=torch.cuda.memory_reserved(
            device) / 2 ** 30, max_memory_reserved_gib=torch.cuda.
            max_memory_reserved(device) / 2 ** 30)
    rec["bench__info"] = np.asarray(json.dumps(info))
    return rec, info


def run_smoke(rank, world, mesh, device):
    """The counterpart of ``tools/multihost_smoke.py``: both sharded steps,
    each held against this rank's own single-device run."""
    from dlp_admm_torch.parallel.consensus_spmd import \
        make_consensus_spmd_step
    from dlp_admm_torch.parallel.mesh import (Sharding, shard_scenarios,
                                              sharded_batch_step, tree_map)
    eng, inputs = batch_case("batch_pairwise", device)
    got = sharded_batch_step(eng, mesh)(*shard_scenarios(mesh, inputs), 0)
    want = shard_scenarios(mesh, eng._mpc_step_pairwise(*inputs, 0)[0])
    if not torch.allclose(got[0], want, rtol=0, atol=1e-10):
        raise RuntimeError("the scenario-sharded PI-ADMM step differs from "
                           "the single-device step")
    print(f"MULTIHOST_OK process={rank}/{world} "
          f"local_scen={got[0].shape[0]}", flush=True)
    pl, init, bs = spmd_case("track_local_mode", device)
    sv = Sharding(mesh, ("scenario", "vehicle"))
    got = make_consensus_spmd_step(pl, mesh)(sv.take(init),
                                             tree_map(sv.take, bs), 0)
    want = make_consensus_spmd_step(pl)(init, bs, 0)
    if not torch.allclose(got[0], sv.take(want[0]), rtol=0, atol=1e-12):
        raise RuntimeError("the vehicle-sharded consensus step differs from "
                           "the single-device step")
    print(f"MULTIHOST_CONSENSUS_OK process={rank}/{world} "
          f"block={list(got[0].shape)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: parallel.multihost.default_backend")
    ap.add_argument("--mesh", default=None,
                    help="S,V: the mesh's scenario and vehicle sizes "
                         "(default: one vehicle group of every rank)")
    ap.add_argument("--case", action="append", default=[])
    ap.add_argument("--steps", type=int, default=1,
                    help="MPC steps of the bench case")
    ap.add_argument("--out", default=None)
    ap.add_argument("--threads", type=int, default=1,
                    help="torch CPU threads of this rank")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    import torch.distributed as dist

    from dlp_admm_torch.parallel import multihost
    from dlp_admm_torch.parallel.mesh import planner_mesh
    backend = multihost.initialize(f"localhost:{args.port}", args.world,
                                   args.rank, backend=args.backend,
                                   device=args.device)
    device = torch.device("cpu")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda and no CUDA card")
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        if args.mesh:
            n_s, n_v = (int(x) for x in args.mesh.split(","))
            mesh = planner_mesh(n_scenario=n_s, n_vehicle=n_v)
        else:
            mesh = multihost.multihost_planner_mesh(n_vehicle=args.world)
        records = {}
        if not args.case:
            run_smoke(args.rank, args.world, mesh, device)
        for name in args.case:
            t0 = time.perf_counter()
            if name == "bench":
                rec, info = run_bench(mesh, device, args.steps)
                print(f"rank {args.rank} bench: {json.dumps(info)}",
                      flush=True)
            elif name in BATCH_CASES:
                rec = run_batch(name, mesh, device)
            else:
                rec = run_spmd(name, mesh, device)
            records.update(rec)
            print(f"RANK_OK rank={args.rank} case={name} backend={backend} "
                  f"mesh={mesh.n_scenario}x{mesh.n_vehicle} "
                  f"seconds={time.perf_counter() - t0:.2f}", flush=True)
        records["stats"] = np.asarray(json.dumps(mesh.stats))
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            np.savez(os.path.join(args.out, f"rank{args.rank}.npz"),
                     **records)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

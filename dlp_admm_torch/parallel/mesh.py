"""A ``(scenario, vehicle)`` mesh over ``torch.distributed`` ranks.

Port of ``dlp_admm_tpu/parallel/mesh.py``. The JAX mesh lays the planner's
parallel axes over devices; here one rank (process) is one mesh point:

* ``scenario``: independent MPC rollouts, pure data parallelism; ranks of
  one scenario group never exchange data during a step;
* ``vehicle``: per-vehicle local solves within one scenario; the bar-state
  broadcast becomes an all-gather over the vehicle group and the consensus
  sums an all-gather of the per-vehicle terms
  (:mod:`.consensus_spmd`).

Ranks are laid out vehicle-fastest: rank ``r`` sits at ``divmod(r,
n_vehicle)``, so a vehicle group is consecutive ranks. Each rank holds one
process group per axis: ``vehicle_group`` (its scenario block's ranks) and
``scenario_group`` (the ranks of its vehicle block). The groups are plain
``dist.new_group``s, made with the world's backend, so one code path runs on
gloo (the CPU, or ranks that share one card) and on NCCL. Without a process
group the mesh degenerates to 1x1 and every function here is the identity,
as the JAX mesh on one device.

A rank holds blocks of the leading axes (:class:`Sharding`); every payload
that crosses ranks goes through :func:`all_gather_cat`.
"""
from __future__ import annotations

import datetime
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

# a collective or group creation that waits longer than this fails the run
TIMEOUT_S = 90


@dataclass
class PlannerMesh:
    """One rank's view of the mesh: its coordinates and one process group
    per axis (None on the degenerate 1x1 mesh). ``stats`` counts the
    collectives this rank made (calls, bytes gathered, wall seconds with
    the device synchronized on both sides)."""

    n_scenario: int
    n_vehicle: int
    scenario_idx: int = 0
    vehicle_idx: int = 0
    scenario_group: Optional[object] = None
    vehicle_group: Optional[object] = None
    stats: dict = field(default_factory=lambda: dict(
        calls=0, bytes=0, seconds=0.0))

    @property
    def shape(self) -> dict:
        return dict(scenario=self.n_scenario, vehicle=self.n_vehicle)

    @property
    def distributed(self) -> bool:
        """True where the mesh has process groups (even a one-rank world)."""
        return self.vehicle_group is not None

    def coord(self, axis: str) -> int:
        return self.scenario_idx if axis == "scenario" else self.vehicle_idx

    def group(self, axis: str):
        return self.scenario_group if axis == "scenario" else \
            self.vehicle_group


def planner_mesh(n_scenario: Optional[int] = None,
                 n_vehicle: int = 1) -> PlannerMesh:
    """Build a ``(scenario, vehicle)`` mesh over the ranks of the process
    group. ``n_scenario`` defaults to ``world // n_vehicle``; the mesh must
    hold every rank. Without a process group this degenerates to a 1x1
    mesh (SURVEY.md §7.6): everything still runs, on one device."""
    if not dist.is_initialized():
        if (n_scenario or 1) * n_vehicle != 1:
            raise ValueError(f"a {n_scenario}x{n_vehicle} mesh needs a "
                             f"process group (multihost.initialize)")
        return PlannerMesh(1, 1)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_scenario is None:
        n_scenario = max(world // n_vehicle, 1)
    if n_scenario * n_vehicle != world:
        raise ValueError(f"a {n_scenario}x{n_vehicle} mesh must hold all "
                         f"{world} ranks")
    s_idx, v_idx = divmod(rank, n_vehicle)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    groups = {}
    # every rank creates every group, in the same order
    for s in range(n_scenario):
        g = dist.new_group([s * n_vehicle + v for v in range(n_vehicle)],
                           timeout=timeout)
        if s == s_idx:
            groups["vehicle"] = g
    for v in range(n_vehicle):
        g = dist.new_group([s * n_vehicle + v for s in range(n_scenario)],
                           timeout=timeout)
        if v == v_idx:
            groups["scenario"] = g
    return PlannerMesh(n_scenario, n_vehicle, s_idx, v_idx,
                       groups["scenario"], groups["vehicle"])


def all_gather_cat(mesh: PlannerMesh, axis: str, tensors, dim: int):
    """The one place where a payload crosses ranks: every tensor of
    ``tensors`` (one dtype and device, equal leading ``dim`` axes
    ``[d0, ..., d_{dim-1}, blk, ...]``) gathered over the ``axis`` group
    and concatenated along ``dim`` in rank order, as one packed
    ``dist.all_gather``. Returns the list of full tensors."""
    group = mesh.group(axis)
    lead = tensors[0].shape[:dim + 1]
    flat = [t.reshape(lead + (-1,)) for t in tensors]
    sizes = [f.shape[-1] for f in flat]
    payload = torch.cat(flat, dim=-1).contiguous()
    parts = [torch.empty_like(payload)
             for _ in range(dist.get_world_size(group))]
    cuda = payload.is_cuda
    if cuda:
        torch.cuda.synchronize(payload.device)
    t0 = time.perf_counter()
    dist.all_gather(parts, payload, group=group)
    if cuda:
        torch.cuda.synchronize(payload.device)
    st = mesh.stats
    st["seconds"] += time.perf_counter() - t0
    st["calls"] += 1
    st["bytes"] += payload.numel() * payload.element_size() * len(parts)
    full = torch.cat(parts, dim=dim).split(sizes, dim=-1)
    # contiguous, so a sum over the result takes the order it takes on a
    # tensor computed in place
    return [f.reshape(t.shape[:dim] + (-1,) + t.shape[dim + 1:]).contiguous()
            for f, t in zip(full, tensors)]


class Sharding:
    """Which block of its leading axes a rank holds: ``axes[i]`` is the
    mesh axis that splits array axis ``i`` (the JAX ``PartitionSpec``)."""

    def __init__(self, mesh: PlannerMesh, axes=()):
        self.mesh, self.axes = mesh, tuple(axes)

    def index(self, shape) -> tuple:
        """The rank's slice of each leading axis of an array of ``shape``."""
        idx = []
        for i, axis in enumerate(self.axes):
            n, parts = shape[i], self.mesh.shape[axis]
            if n % parts:
                raise ValueError(f"axis {i} of length {n} does not split "
                                 f"into {parts} {axis} blocks")
            blk = n // parts
            k = self.mesh.coord(axis)
            idx.append(slice(k * blk, (k + 1) * blk))
        return tuple(idx)

    def take(self, a):
        """This rank's block of ``a`` (a tensor, contiguous)."""
        return a[self.index(a.shape)].contiguous()

    def gather(self, a):
        """Rebuild the full array on every rank from the blocks."""
        if not self.mesh.distributed:
            return a
        for i in reversed(range(len(self.axes))):
            a, = all_gather_cat(self.mesh, self.axes[i], [a], i)
        return a


def scenario_sharding(mesh: PlannerMesh) -> Sharding:
    """Leading-axis blocks over the scenario mesh dimension."""
    return Sharding(mesh, ("scenario",))


def replicated(mesh: PlannerMesh) -> Sharding:
    """Every rank holds the whole array."""
    return Sharding(mesh, ())


def tree_map(fn, tree):
    """``fn`` on every leaf of a tuple / NamedTuple / list / dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_scenarios(mesh: PlannerMesh, tree):
    """This rank's scenario block of a scenario-batched tree (leading axis
    = scenario)."""
    return tree_map(scenario_sharding(mesh).take, tree)


def gather_scenarios(mesh: PlannerMesh, tree):
    """The full scenario axis of every leaf, rebuilt on every rank from the
    blocks of :func:`shard_scenarios`."""
    return tree_map(scenario_sharding(mesh).gather, tree)


def sharded_batch_step(engine, mesh: PlannerMesh):
    """A scenario-batched MPC step of ``engine`` over ``mesh``: pure data
    parallelism, each rank stepping its scenario block (from
    :func:`shard_scenarios`) through the engine's lane-batched step; the
    per-scenario math is replicated over the vehicle mesh dimension.

    ``engine`` is a :class:`~dlp_admm_torch.models.pi_admm.PiAdmmEngine`
    (either layout: ``step(xts [S_blk, V, 3], us [S_blk, V, H], step_idx)
    -> (xt_next, u, StepRecord)``) or a
    :class:`~dlp_admm_torch.models.obca.ConsensusObcaPlanner`
    (``step(init_states [S_blk, V, 5], bar_state, step_idx)``, the outputs
    of the one-device batched step). For the vehicle axis partitioned (local
    solves per vehicle block, the bar-state exchange an all-gather) use
    :func:`~dlp_admm_torch.parallel.consensus_spmd.make_consensus_spmd_step`
    with the mesh."""
    from ..models.obca import ConsensusObcaPlanner
    from ..models.pi_admm import PiAdmmEngine
    from .consensus_spmd import make_consensus_spmd_step
    if isinstance(engine, ConsensusObcaPlanner):
        return make_consensus_spmd_step(engine)
    if not isinstance(engine, PiAdmmEngine):
        raise TypeError(f"no batched step for {type(engine).__name__}")
    if engine.layout == "classic":
        return engine._mpc_step_classic

    def step(xts, us, step_idx):
        return engine._mpc_step_pairwise(xts, us, step_idx)[:3]
    return step

"""Multi-process entry point: process-group init and a host-aware mesh.

Port of ``dlp_admm_tpu/parallel/multihost.py`` to ``torch.distributed``.
One process is one rank; the JAX package's "devices of a host" become the
ranks that run on one host (the local world size):

* :func:`initialize` wraps ``torch.distributed.init_process_group`` (a
  no-op for one process, as in JAX) with a stated backend and a short
  timeout, so a rank that hangs fails the run instead of blocking it;
* :func:`multihost_planner_mesh` lays a ``(scenario, vehicle)`` mesh over
  every rank so that **a vehicle group never crosses a host**: the
  per-iteration exchange of the consensus step (``consensus_spmd.py``)
  stays inside a host, and the scenario axis spans hosts;
* :func:`make_global_batch`: every rank passes the same full-size arrays
  and keeps only its own scenario block.

``tools/multihost_smoke_torch.py`` is the per-rank script that the tests
(gloo ranks on the CPU) and ``chip_smoke.py`` (ranks on the card) spawn.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import TIMEOUT_S, planner_mesh, scenario_sharding, tree_map


def default_backend(num_processes: int, device=None) -> str:
    """The backend :func:`initialize` takes unless it is named: ``gloo`` on
    the CPU; on CUDA ``nccl`` when every rank of a host has a card of its
    own, and ``gloo`` (which takes CUDA tensors) when ranks share a card,
    since NCCL refuses two ranks on one GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device=None) -> Optional[str]:
    """Join the process group (multi-process entry). No-op, returning None,
    when ``num_processes`` is None or 1 and no ``coordinator_address`` is
    given: one process runs everything unchanged.

    ``coordinator_address`` is ``host:port`` of rank 0 (``localhost:<any
    free port>`` on one machine); ``backend`` defaults to
    :func:`default_backend` for ``device`` (the card unless named). The
    backend taken is printed and returned; nothing switches to another
    backend when it fails. With ``nccl`` each rank takes the card of its
    local rank."""
    if num_processes in (None, 1) and coordinator_address is None:
        return None
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    if backend is None:
        backend = default_backend(num_processes, device)
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    print(f"rank {process_id}/{num_processes}: process group on {backend}",
          flush=True)
    return backend


def local_world_size() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` where the launcher sets it,
    else every rank of the group (one host), else 1."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return dist.get_world_size() if dist.is_initialized() else 1


def multihost_planner_mesh(n_vehicle: int = 1):
    """``(scenario, vehicle)`` mesh over every rank, host-aligned. Ranks
    are laid out vehicle-fastest, so each vehicle group is ``n_vehicle``
    consecutive ranks; it stays inside one host when the local world size
    divides by ``n_vehicle``, which is required."""
    n_local = local_world_size()
    if n_local % n_vehicle:
        raise ValueError(
            f"vehicle axis {n_vehicle} must divide the {n_local} ranks of "
            f"each host (the vehicle collectives must stay inside a host)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    return planner_mesh(n_scenario=world // n_vehicle, n_vehicle=n_vehicle)


def make_global_batch(mesh, tree, device=None):
    """Every rank passes the same full-size host arrays (leading axis =
    scenario) and gets its own scenario block as tensors on ``device``
    (the multi-process counterpart of
    :func:`~dlp_admm_torch.parallel.mesh.shard_scenarios`)."""
    sh = scenario_sharding(mesh)

    def one(a):
        a = np.asarray(a)
        return torch.as_tensor(np.ascontiguousarray(a[sh.index(a.shape)]),
                               device=device)
    return tree_map(one, tree)

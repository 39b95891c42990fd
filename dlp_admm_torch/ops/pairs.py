"""Collision-pair indexing and masked pairwise reductions.

Port of ``dlp_admm_tpu/ops/pairs.py``: dense tensors over *all* unordered
pairs plus a boolean activity mask replace the reference's data-dependent
``np.where(edge_mat == 1)`` gathers (``casadi/main.py:108-162``). At 16
vehicles that is P = 120 pair slots; per-vehicle aggregation of pair
quantities is a segment sum written as one-hot matmuls. Every function takes
the vehicle (or pair) axis first, as the JAX functions do.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def pair_indices(num_veh: int):
    """Static (i, j) index arrays of the P = n(n-1)/2 unordered pairs, i < j,
    as numpy arrays (callers move them to their device as long tensors)."""
    return np.triu_indices(num_veh, k=1)


def num_pairs(num_veh: int) -> int:
    return num_veh * (num_veh - 1) // 2


def _index(num_veh: int, device):
    idx_i, idx_j = pair_indices(num_veh)
    return (torch.as_tensor(idx_i, device=device),
            torch.as_tensor(idx_j, device=device))


def pair_gather(per_vehicle: torch.Tensor, num_veh: int):
    """``[V, ...]`` per-vehicle tensor -> the ``[P, ...]`` i- and j-side
    tensors of every pair (``pos_old[2*veh1:2*(veh1+1)]`` per active edge,
    ``casadi/main.py:130``)."""
    idx_i, idx_j = _index(num_veh, per_vehicle.device)
    return per_vehicle[idx_i], per_vehicle[idx_j]


def _scatter_matrices(num_veh: int, dtype=torch.float32, device="cpu"):
    """One-hot ``[P, V]`` matrices mapping pair slots to their member
    vehicles."""
    idx_i, idx_j = pair_indices(num_veh)
    p = len(idx_i)
    m_i = np.zeros((p, num_veh))
    m_j = np.zeros((p, num_veh))
    m_i[np.arange(p), idx_i] = 1.0
    m_j[np.arange(p), idx_j] = 1.0
    return (torch.as_tensor(m_i, dtype=dtype, device=device),
            torch.as_tensor(m_j, dtype=dtype, device=device))


def pair_scatter_sum(per_pair_i: torch.Tensor, per_pair_j: torch.Tensor,
                     num_veh: int) -> torch.Tensor:
    """Sum per-pair contributions back onto vehicles (segment sum):
    ``per_pair_i[p]`` goes to pair p's i-side vehicle, ``per_pair_j[p]`` to
    its j-side vehicle; returns ``[V, ...]`` totals."""
    m_i, m_j = _scatter_matrices(num_veh, per_pair_i.dtype, per_pair_i.device)
    flat_i = per_pair_i.reshape(per_pair_i.shape[0], -1)
    flat_j = per_pair_j.reshape(per_pair_j.shape[0], -1)
    out = m_i.T @ flat_i + m_j.T @ flat_j
    return out.reshape((num_veh,) + tuple(per_pair_i.shape[1:]))


def proximity_mask(x: torch.Tensor, y: torch.Tensor, dis_thres: float,
                   num_veh: int) -> torch.Tensor:
    """``[P]`` active-pair mask: pair (i, j) is active iff the predicted
    trajectories ``x, y [V, H+1]`` come within ``dis_thres`` anywhere in the
    horizon. As the reference's ``edge_mat`` build (``casadi/main.py:110-116``)
    does, the *squared* distance is compared with the unsquared threshold."""
    xi, xj = pair_gather(x, num_veh)
    yi, yj = pair_gather(y, num_veh)
    d2 = (xi - xj) ** 2 + (yi - yj) ** 2
    return torch.any(d2 < dis_thres, dim=-1)

"""Collision-pair indexing (port of ``dlp_admm_tpu/ops/pairs.py``).

Only the static index map is ported so far; ``num_pairs`` and the masked
pairwise reductions (``pair_gather``, ``pair_scatter_sum``,
``proximity_mask``) belong to the PI-ADMM line and are still to be ported
(ROADMAP queue 1).
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def pair_indices(num_veh: int):
    """Static (i, j) index arrays of the P = n(n-1)/2 unordered pairs, i < j,
    as numpy arrays (callers move them to their device as long tensors)."""
    return np.triu_indices(num_veh, k=1)

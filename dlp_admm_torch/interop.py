"""Carry state across between the JAX package and the port.

The system has no weights: its state is the MPC carry, the current vehicle
states and the :class:`~dlp_admm_torch.models.obca.BarState` exchange state.
These helpers convert a ``BarState`` taken from the JAX package field by
field through ``np.asarray`` (a mapping of numpy arrays) to the port's and
back, so both implementations can start from one mid-run state.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.obca import BarState


def bar_state_from_numpy(arrays, device="cpu",
                         dtype=torch.float64) -> BarState:
    """``BarState`` from a mapping (or a NamedTuple) of array-likes."""
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    return BarState(**{k: torch.tensor(np.asarray(arrays[k]), dtype=dtype,
                                       device=device)
                       for k in BarState._fields})


def bar_state_to_numpy(bs: BarState) -> dict:
    """Field name -> numpy array (on the host) of a port ``BarState``."""
    return {k: v.detach().cpu().numpy() for k, v in bs._asdict().items()}

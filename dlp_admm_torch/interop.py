"""Carry state across between the JAX package and the port.

The system has no weights: its state is the MPC carry, the current vehicle
states and the exchange state of a planner, the OBCA line's
:class:`~dlp_admm_torch.models.obca.BarState` and the PI-ADMM line's
:class:`~dlp_admm_torch.models.pi_admm.AdmmCarry`. These helpers convert
either, taken from the JAX package field by field through ``np.asarray`` (a
mapping of numpy arrays), to the port's and back, so both implementations
can start from one mid-run state.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.obca import BarState
from .models.pi_admm import AdmmCarry


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


def admm_carry_from_numpy(arrays, device="cpu",
                          dtype=torch.float64) -> AdmmCarry:
    """``AdmmCarry`` from a mapping (or a NamedTuple) of array-likes. A JAX
    carry of one lane (``hat [P, 2, 2, H+1]``) gets the port's lane axis in
    front (``S = 1``); a batched one (``[S, P, ...]``) keeps its lanes."""
    if not isinstance(arrays, Mapping):
        arrays = arrays._asdict()
    one_lane = np.asarray(arrays["hat"]).ndim == 4
    out = {}
    for k in AdmmCarry._fields:
        a = np.asarray(arrays[k])
        a = a[None] if one_lane else a
        out[k] = torch.tensor(a, device=device,
                              dtype=torch.bool if k == "active" else dtype)
    return AdmmCarry(**out)


def admm_carry_to_numpy(c: AdmmCarry) -> dict:
    """Field name -> numpy array (on the host) of a port ``AdmmCarry``
    (with its lane axis)."""
    return {k: v.detach().cpu().numpy() for k, v in c._asdict().items()}

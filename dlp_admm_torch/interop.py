"""Carry state across between the JAX package and the port.

The system has no weights: its state is the MPC carry, the current vehicle
states and the exchange state of a planner: the consensus OBCA planner's
:class:`~dlp_admm_torch.models.obca.BarState`, the PI-ADMM line's
:class:`~dlp_admm_torch.models.pi_admm.AdmmCarry`, the bilevel and
tightening planners' :class:`~dlp_admm_torch.models.bilevel.FixedDualState`
and the ALADIN iterate :class:`~dlp_admm_torch.models.aladin.AladinState`.
These helpers convert each, taken from the JAX package field by field
through ``np.asarray`` (a mapping of numpy arrays), to the port's and back,
so both implementations can start from one mid-run state.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .models.aladin import AladinState
from .models.bilevel import FixedDualState
from .models.obca import BarState
from .models.pi_admm import AdmmCarry


def _fields(arrays):
    return arrays if isinstance(arrays, Mapping) else arrays._asdict()


def _from_numpy(cls, arrays, device, dtype):
    arrays = _fields(arrays)
    return cls(**{k: torch.tensor(np.asarray(arrays[k]), dtype=dtype,
                                  device=device) for k in cls._fields})


def _to_numpy(state) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def bar_state_from_numpy(arrays, device="cpu",
                         dtype=torch.float64) -> BarState:
    """``BarState`` from a mapping (or a NamedTuple) of array-likes."""
    return _from_numpy(BarState, arrays, device, dtype)


def bar_state_to_numpy(bs: BarState) -> dict:
    """Field name -> numpy array (on the host) of a port ``BarState``."""
    return _to_numpy(bs)


def fixed_dual_state_from_numpy(arrays, device="cpu",
                                dtype=torch.float64) -> FixedDualState:
    """``FixedDualState`` from a mapping (or a NamedTuple) of array-likes
    (``a_mat [V, T, 4, 2]``, ``b [V, T, 4]``, ``lam [P, 2, T, 4]``,
    ``s [P, T, 2]``; neither side has a lane axis)."""
    return _from_numpy(FixedDualState, arrays, device, dtype)


def fixed_dual_state_to_numpy(bs: FixedDualState) -> dict:
    """Field name -> numpy array (on the host) of a ``FixedDualState``."""
    return _to_numpy(bs)


def aladin_state_from_numpy(arrays, device="cpu",
                            dtype=torch.float64) -> AladinState:
    """``AladinState`` from a mapping (or a NamedTuple) of array-likes
    (``x [N, ny]``, ``lam [mc]``, the two residuals as 0-d arrays)."""
    return _from_numpy(AladinState, arrays, device, dtype)


def aladin_state_to_numpy(state: AladinState) -> dict:
    """Field name -> numpy array (on the host) of an ``AladinState``."""
    return _to_numpy(state)


def admm_carry_from_numpy(arrays, device="cpu",
                          dtype=torch.float64) -> AdmmCarry:
    """``AdmmCarry`` from a mapping (or a NamedTuple) of array-likes. A JAX
    carry of one lane (``hat [P, 2, 2, H+1]``) gets the port's lane axis in
    front (``S = 1``); a batched one (``[S, P, ...]``) keeps its lanes."""
    arrays = _fields(arrays)
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
    return _to_numpy(c)

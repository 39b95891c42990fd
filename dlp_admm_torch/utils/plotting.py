"""Trajectory and footprint plots (port of
``dlp_admm_tpu/utils/plotting.py``), the reference's visual oracle.

Every reference driver ends with a matplotlib plot of the vehicles' paths
and, in the OBCA line, their rectangle footprints. matplotlib is optional:
without it every function returns ``None`` and draws nothing.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import VehicleConfig
from ..ops.geometry import vehicle_vertices

_COLORS = ["tab:blue", "tab:red", "tab:green", "tab:orange", "tab:purple",
           "tab:brown", "tab:pink", "tab:gray"]


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        return None


def plot_trajectories(states, path: str,
                      cfg: VehicleConfig = VehicleConfig(),
                      footprints: bool = True, title: str = ""):
    """``states [T, V, >=2]`` (x, y, ...) -> PNG at ``path``; returns
    ``path``, or ``None`` without matplotlib.

    Draws each vehicle's path and, with ``footprints`` and states of at
    least 4 entries (heading at 3), its rectangle footprint at up to 20 of
    the recorded states.
    """
    plt = _plt()
    if plt is None:
        return None
    states = np.asarray(states.cpu() if torch.is_tensor(states) else states,
                        dtype=np.float64)
    t, v = states.shape[:2]
    fig, ax = plt.subplots(figsize=(10, 6))
    for i in range(v):
        c = _COLORS[i % len(_COLORS)]
        ax.plot(states[:, i, 0], states[:, i, 1], "o-", ms=2.5, lw=0.8,
                color=c, label=f"vehicle {i}")
        if footprints and states.shape[-1] >= 4:
            for k in range(0, t, max(t // 20, 1)):
                verts = vehicle_vertices(torch.as_tensor(states[k, i]),
                                         cfg).numpy()
                poly = np.vstack([verts, verts[:1]])
                ax.plot(poly[:, 0], poly[:, 1], color=c, lw=0.5, alpha=0.5)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_iteration_history(iter_history, path: str, title: str = ""):
    """Iterations per MPC step (the reference's ``iter_his`` plot) -> PNG
    at ``path``; ``None`` without matplotlib."""
    plt = _plt()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.bar(np.arange(len(iter_history)), iter_history, color="tab:blue")
    ax.set_xlabel("MPC step")
    ax.set_ylabel("ADMM iterations")
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path

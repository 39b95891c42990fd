"""Polytope geometry: vehicle footprints and halfspace representations.

Port of ``dlp_admm_tpu/ops/geometry.py`` (itself a port of the reference's
``Distributed_planner/decentralized/util.py``):

* :func:`vehicle_vertices`        — ref ``util.py:12-46``
* :func:`halfspaces_from_vertices`— ref ``util.py:48-68``
* :func:`halfspaces_rot`          — ref ``util.py:103-127``
* :func:`halfspaces_prob`         — ref ``util.py:70-101`` (chance-constrained
  communication-delay tightening)

Closed-form tensor ops over an arbitrary batch prefix; every function is
traceable by ``torch.func`` (no in-place writes), since the staged solver
differentiates through them. Constants take the caller's dtype and device.

Halfspace convention (matching the reference): the rectangle is
``{p : A @ p <= b}`` with 4 rows, each row an outward unit normal.
"""
from __future__ import annotations

import math

import torch

from ..config import VehicleConfig


def normalize_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi] (ref ``util.py:6-10``)."""
    two_pi = 2.0 * math.pi
    a = torch.remainder(torch.remainder(angle, two_pi) + two_pi, two_pi)
    return torch.where(a > math.pi, a - two_pi, a)


def vehicle_vertices(state: torch.Tensor, cfg: VehicleConfig = VehicleConfig(),
                     base_link: bool = False) -> torch.Tensor:
    """Rectangle corners ``[..., 4, 2]`` of a vehicle at ``state`` (x, y at
    ``[..., 0:2]``, heading at ``[..., 3]``), in the reference's order
    (front-left, front-right, rear-right, rear-left)."""
    x, y, heading = state[..., 0], state[..., 1], state[..., 3]
    c, s = torch.cos(heading), torch.sin(heading)
    if base_link:
        fwd, back = cfg.baselink_to_front, cfg.baselink_to_rear
    else:
        fwd = back = cfg.length / 2
    half_w = cfg.width / 2
    vx = torch.stack([x + fwd * c - half_w * s,
                      x + fwd * c + half_w * s,
                      x - back * c + half_w * s,
                      x - back * c - half_w * s], dim=-1)
    vy = torch.stack([y + fwd * s + half_w * c,
                      y + fwd * s - half_w * c,
                      y - back * s - half_w * c,
                      y - back * s + half_w * c], dim=-1)
    return torch.stack([vx, vy], dim=-1)


def halfspaces_from_vertices(points: torch.Tensor):
    """Halfspace form ``(A [..., 4, 2], b [..., 4])`` of a convex
    quadrilateral from its 4 cyclic corners ``[..., 4, 2]``: per edge
    p1 -> p2, ``A_row = [p1y - p2y, p2x - p1x] / n``,
    ``b = (p2x p1y - p2y p1x) / n``, ``n = ||p2 - p1||``."""
    p1 = points
    p2 = torch.cat([points[..., 1:, :], points[..., :1, :]], dim=-2)
    nx = p1[..., 1] - p2[..., 1]
    ny = p2[..., 0] - p1[..., 0]
    norm = torch.sqrt(nx * nx + ny * ny)
    a_rows = torch.stack([nx, ny], dim=-1) / norm[..., None]
    b = (p2[..., 0] * p1[..., 1] - p2[..., 1] * p1[..., 0]) / norm
    return a_rows, b


def _rot_form(state: torch.Tensor, cfg: VehicleConfig, base_link: bool,
              shift):
    """Shared body of the rotation-matrix halfspace forms (ref util.py:91-99)."""
    x, y, heading = state[..., 0], state[..., 1], state[..., 3]
    c, s = torch.cos(heading), torch.sin(heading)
    # A = [R^T; -R^T], rows are unit normals of the axis-aligned body box
    a_mat = torch.stack([
        torch.stack([c, s], dim=-1),
        torch.stack([-s, c], dim=-1),
        torch.stack([-c, -s], dim=-1),
        torch.stack([s, -c], dim=-1),
    ], dim=-2)  # [..., 4, 2]
    if base_link:
        b0 = [cfg.baselink_to_front, cfg.width / 2,
              cfg.baselink_to_rear, cfg.width / 2]
    else:
        b0 = [cfg.length / 2, cfg.width / 2, cfg.length / 2, cfg.width / 2]
    # made on the device without a host copy, so a CUDA graph can hold it
    b0 = torch.stack([torch.full_like(x, v) for v in b0], dim=-1)
    pos = torch.stack([x, y], dim=-1) + shift
    b = b0 + torch.einsum('...ij,...j->...i', a_mat, pos)
    return a_mat, b


def halfspaces_rot(state: torch.Tensor, cfg: VehicleConfig = VehicleConfig(),
                   base_link: bool = False):
    """Rotation-matrix halfspace form ``A = [R^T; -R^T]``, ``b = b0 + A @ pos``
    (ref ``util.py:103-127``). Row order differs from
    :func:`halfspaces_from_vertices`; the set is the same."""
    return _rot_form(state, cfg, base_link, 0.0)


def halfspaces_prob(state: torch.Tensor, cfg: VehicleConfig = VehicleConfig(),
                    base_link: bool = False):
    """Chance-constrained halfspaces under stochastic communication delay
    (ref ``util.py:70-101``): the position is shifted by the mean delay
    displacement plus a Cantelli term ``sqrt(prob/(1-prob)) * (var * v *
    dir)^2`` before forming the rotation halfspaces."""
    v, heading = state[..., 2], state[..., 3]
    c, s = torch.cos(heading), torch.sin(heading)
    delta_avg = torch.stack([cfg.avg_delay * v * c, cfg.avg_delay * v * s],
                            dim=-1)
    delta_var = torch.stack([(cfg.var_delay * v * c) ** 2,
                             (cfg.var_delay * v * s) ** 2], dim=-1)
    shift = delta_avg + math.sqrt(cfg.prob / (1.0 - cfg.prob)) * delta_var
    return _rot_form(state, cfg, base_link, shift)


def halfspaces(state: torch.Tensor, cfg: VehicleConfig = VehicleConfig(),
               use_delay_tightening: bool = False):
    """Dispatch used by the OBCA planners (ref optimizer.py:109-113):
    vertex form, or the chance-tightened rotation form. Both return
    ``A [..., 4, 2]``, ``b [..., 4]``."""
    if use_delay_tightening:
        return halfspaces_prob(state, cfg)
    return halfspaces_from_vertices(vehicle_vertices(state, cfg))

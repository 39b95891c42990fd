"""Vehicle dynamics (port of ``dlp_admm_tpu/ops/dynamics.py``).

Only the 5-state kinematic bicycle of the OBCA line is ported so far:
:func:`bicycle_rhs`, ref ``Distributed_planner/decentralized/optimizer.py:61-82``
(``local_build_model``). The coupled bicycle variant, the unicycle rollouts
and the Euler/RK4 rollouts are still to be ported (ROADMAP queue 1).
"""
from __future__ import annotations

import torch

from ..config import VehicleConfig

# State = (x, y, v, theta, steer), control = (acc, steer_rate).


def bicycle_rhs(state: torch.Tensor, control: torch.Tensor,
                cfg: VehicleConfig = VehicleConfig()) -> torch.Tensor:
    """dx/dt of the kinematic bicycle (ref ``decentralized/optimizer.py:75-77``).

    ``beta = atan(lr*tan(steer)/(lr+lf))``;
    ``[v cos(th+b), v sin(th+b), a, v/lr sin(b), steer_rate]``.
    """
    v, theta, steer = state[..., 2], state[..., 3], state[..., 4]
    a, steer_rate = control[..., 0], control[..., 1]
    beta = torch.atan(cfg.lr * torch.tan(steer) / (cfg.lr + cfg.lf))
    return torch.stack([
        v * torch.cos(theta + beta),
        v * torch.sin(theta + beta),
        a,
        v / cfg.lr * torch.sin(beta),
        steer_rate,
    ], dim=-1)

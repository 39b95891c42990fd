"""ADMM residuals and stopping rules (port of
``dlp_admm_tpu/coordination/residuals.py``, SURVEY.md C13).

* classic (stacked) form — ref ``casadi_old_PI_ADMM/main.py:153-161``:
  ``r_k = ||pos - hat||_F``, ``s_k = ||rho (hat_prev - hat)||_F`` over the
  whole stacked state;
* per-edge form — ref ``casadi/main.py:164-178``: sums of ``2 * ||.||_F``
  per *active* pair.

Each function also takes leading lane axes in front of the JAX shapes and
then reduces per lane; ``rho`` has the lane shape (a scalar without lanes).
"""
from __future__ import annotations

import torch


def _per_lane(rho, like, trailing):
    """``rho`` with ``trailing`` unit axes, to broadcast over ``like``."""
    rho = torch.as_tensor(rho, dtype=like.dtype, device=like.device)
    return rho.reshape(rho.shape + (1,) * trailing)


def stacked_residuals(pos, hat_pos, last_hat, rho):
    """Frobenius residuals over the stacked ``[..., V, 2, H+1]`` tensors."""
    dims = (-3, -2, -1)
    r = torch.sqrt(torch.sum((pos - hat_pos) ** 2, dim=dims))
    s = torch.sqrt(torch.sum((_per_lane(rho, pos, 3) * (last_hat - hat_pos))
                             ** 2, dim=dims))
    return r, s


def per_edge_residuals(pos_i, hat_i, last_hat_i, rho, active):
    """Masked per-pair residual sums.

    ``pos_i/hat_i/last_hat_i``: ``[..., P, 2, H+1]`` i-side tensors per pair;
    ``active``: ``[..., P]`` mask. Ref ``casadi/main.py:165-173`` counts each
    active pair with weight 2 (both ordered directions).
    """
    r_p = 2.0 * torch.sqrt(torch.sum((pos_i - hat_i) ** 2, dim=(-2, -1)))
    s_p = 2.0 * torch.sqrt(torch.sum(
        (_per_lane(rho, pos_i, 3) * (last_hat_i - hat_i)) ** 2, dim=(-2, -1)))
    w = active.to(pos_i.dtype)
    return torch.sum(w * r_p, dim=-1), torch.sum(w * s_p, dim=-1)


def min_pair_distance(x, y, num_veh):
    """Minimum over time and pairs of the inter-vehicle distance;
    ``x, y [..., V, H+1]`` predicted positions
    (ref ``casadi_old_PI_ADMM/main.py:129-134``)."""
    from ..ops.pairs import pair_indices
    idx_i, idx_j = pair_indices(num_veh)
    d = torch.sqrt((x[..., idx_i, :] - x[..., idx_j, :]) ** 2
                   + (y[..., idx_i, :] - y[..., idx_j, :]) ** 2)
    return torch.amin(d, dim=(-2, -1))

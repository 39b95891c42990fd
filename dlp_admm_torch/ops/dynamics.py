"""Vehicle dynamics (port of ``dlp_admm_tpu/ops/dynamics.py``).

* :func:`bicycle_rhs` — 5-state kinematic bicycle of the OBCA line,
  ref ``Distributed_planner/decentralized/optimizer.py:61-82``
  (``local_build_model``);
* :func:`bicycle_rhs_coupled` — the centralized variant with
  ``theta_dot = v/(lr+lf) * cos(beta) * tan(steer)``,
  ref ``Distributed_planner/centralized/optimizer.py:68-70``;
* :func:`euler_rollout` / :func:`rk4_rollout` — forward-Euler and RK4
  rollouts of any right-hand side;
* :func:`unicycle_rollout_local` / :func:`unicycle_rollout_edge` — 3-state
  linearized unicycle rollouts of the PI-ADMM line, ref
  ``casadi/PI_ADMM_class.py:45-105``;
* :func:`unicycle_rollout_exact` — the exact ``tan(u)`` unicycle plant, ref
  ``dynamic_update_simulation.m``.

Every function carries an arbitrary batch prefix. The rollouts are scans
over the horizon, written as Python loops over its H steps on batched
tensors.
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


def bicycle_rhs_coupled(state: torch.Tensor, control: torch.Tensor,
                        cfg: VehicleConfig = VehicleConfig()) -> torch.Tensor:
    """Centralized-planner variant of the heading rate (ref
    ``centralized/optimizer.py:68-69``): ``theta_dot = v/(lr+lf) *
    cos(beta) * tan(steer)``; the other rows are :func:`bicycle_rhs`'s."""
    v, theta, steer = state[..., 2], state[..., 3], state[..., 4]
    a, steer_rate = control[..., 0], control[..., 1]
    beta = torch.atan(cfg.lr * torch.tan(steer) / (cfg.lr + cfg.lf))
    return torch.stack([
        v * torch.cos(theta + beta),
        v * torch.sin(theta + beta),
        a,
        v / (cfg.lr + cfg.lf) * torch.cos(beta) * torch.tan(steer),
        steer_rate,
    ], dim=-1)


def euler_rollout(rhs, x0: torch.Tensor, us: torch.Tensor,
                  dt: float) -> torch.Tensor:
    """Forward-Euler rollout ``x[k+1] = x[k] + dt * rhs(x[k], u[k])`` (the
    equality-constraint discretization of ``decentralized/optimizer.py:
    92-100``). ``us [H, ...]``; returns the trajectory with ``x0``,
    ``[H+1, ...]``."""
    xs = [x0]
    for k in range(us.shape[0]):
        xs.append(xs[-1] + dt * rhs(xs[-1], us[k]))
    return torch.stack(xs)


def rk4_rollout(rhs, x0: torch.Tensor, us: torch.Tensor,
                dt: float) -> torch.Tensor:
    """Classic RK4 rollout with zero-order-hold controls (the integrator of
    the ALADIN optimal-control notebooks); shapes as
    :func:`euler_rollout`."""
    xs = [x0]
    for k in range(us.shape[0]):
        x, u = xs[-1], us[k]
        k1 = rhs(x, u)
        k2 = rhs(x + 0.5 * dt * k1, u)
        k3 = rhs(x + 0.5 * dt * k2, u)
        k4 = rhs(x + dt * k3, u)
        xs.append(x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4))
    return torch.stack(xs)


# 3-state linearized unicycle (PI-ADMM line). State = (x, y, theta),
# control = steering angle u; constant speed per vehicle; wheel base L.


def unicycle_rollout_local(xt: torch.Tensor, u: torch.Tensor,
                           spd: torch.Tensor, dt: float, wheel_base: float):
    """Vehicle-side rollout linearized about the *current* heading
    (``dynamic_update_local``, ``casadi/PI_ADMM_class.py:45-70``): with
    ``th0 = xt[2]`` fixed, ``x_dot = -v sin(th0) th_k + v cos(th0) + v th0
    sin(th0)``, ``y_dot = v cos(th0) th_k + v sin(th0) - v th0 cos(th0)``,
    ``th_{k+1} = th_k + v/L u_k dt``. Linear in ``u``.

    ``xt [..., 3]``, ``u [..., H]``, ``spd [...]``; returns ``(x, y, theta)``
    each ``[..., H+1]`` including the current state.
    """
    th0 = xt[..., 2]
    sin0, cos0 = torch.sin(th0), torch.cos(th0)
    # theta is a cumulative sum of inputs: th_k = th0 + dt*v/L * cumsum(u)[:k]
    dth = dt * spd[..., None] / wheel_base * u
    theta = torch.cat(
        [th0[..., None], th0[..., None] + torch.cumsum(dth, dim=-1)], dim=-1)
    x_dot = (-spd[..., None] * sin0[..., None] * theta[..., :-1]
             + (spd * cos0 + spd * th0 * sin0)[..., None])
    y_dot = (spd[..., None] * cos0[..., None] * theta[..., :-1]
             + (spd * sin0 - spd * th0 * cos0)[..., None])
    x = torch.cat([xt[..., 0:1],
                   xt[..., 0:1] + torch.cumsum(dt * x_dot, dim=-1)], dim=-1)
    y = torch.cat([xt[..., 1:2],
                   xt[..., 1:2] + torch.cumsum(dt * y_dot, dim=-1)], dim=-1)
    return x, y, theta


def _scan_rollout(xt, u, step):
    """Run ``step(x, y, th, u_k)`` over the last axis of ``u`` from ``xt``;
    returns ``(x, y, theta)`` each ``[..., H+1]``."""
    x, y, th = xt[..., 0], xt[..., 1], xt[..., 2]
    xs, ys, ths = [x], [y], [th]
    for k in range(u.shape[-1]):
        x, y, th = step(x, y, th, u[..., k])
        xs.append(x)
        ys.append(y)
        ths.append(th)
    return (torch.stack(xs, dim=-1), torch.stack(ys, dim=-1),
            torch.stack(ths, dim=-1))


def unicycle_rollout_edge(xt: torch.Tensor, u: torch.Tensor,
                          spd: torch.Tensor, dt: float, wheel_base: float):
    """Edge-side rollout re-linearized about the propagated heading
    (``dynamic_update_edge``, ``casadi/PI_ADMM_class.py:77-105``): the
    Taylor point is ``theta_pred[k]`` itself, so the state moves by the
    reference's linearized form evaluated at ``th_k``. Shapes as
    :func:`unicycle_rollout_local`."""
    v = spd

    def step(x, y, th, uk):
        # written exactly as the reference's linearized form evaluated at th
        x_dot = -v * torch.sin(th) * th + (v * torch.cos(th)
                                            + v * th * torch.sin(th))
        y_dot = v * torch.cos(th) * th + (v * torch.sin(th)
                                           - v * th * torch.cos(th))
        th_dot = v / wheel_base * uk
        return x + dt * x_dot, y + dt * y_dot, th + dt * th_dot

    return _scan_rollout(xt, u, step)


def unicycle_rollout_exact(xt: torch.Tensor, u: torch.Tensor,
                           spd: torch.Tensor, dt: float, wheel_base: float):
    """Exact nonlinear unicycle used as the simulation plant
    (``dynamic_update_simulation.m:1-22``): ``x_dot = v cos(th)``, ``y_dot =
    v sin(th)``, ``th_dot = v/L tan(u)``. Shapes as
    :func:`unicycle_rollout_local`."""
    v = spd

    def step(x, y, th, uk):
        return (x + dt * v * torch.cos(th), y + dt * v * torch.sin(th),
                th + dt * v / wheel_base * torch.tan(uk))

    return _scan_rollout(xt, u, step)

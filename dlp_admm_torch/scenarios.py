"""Reference-trajectory generators for the canonical scenarios.

A numpy-only copy of ``dlp_admm_tpu/scenarios.py`` (pinned equal by
``tests/test_torch_config_ops.py``). One module replacing the per-package
copies in the reference:

* overtaking (OBCA line)    — ``Distributed_planner/decentralized/veh_config.py:30-47``
* intersection (OBCA line)  — ``Distributed_planner/centralized/veh_config.py:50-67``
* crossing (PI-ADMM line)   — ``casadi/PI_ADMM_class.py:30-37`` straight-line refs

All generators return arrays with a leading vehicle axis so they batch/shard
cleanly over the vehicle mesh dimension; a ``num_veh`` > 2 tiles vehicles into
parallel lanes so the 16-vehicle benchmark scenario is well defined.
"""
from __future__ import annotations

import numpy as np

from .config import PiAdmmConfig, VehicleConfig


def ref_traj_overtake(cfg: VehicleConfig, num_veh: int = 2) -> np.ndarray:
    """Overtaking references: vehicles in the same lane at different speeds.

    Ref ``decentralized/veh_config.py:30-47``: v = 20 and 10 m/s, x starts 0 and
    20 m, straight lane y=0. Returns ``[num_veh, T/dt+1, 5]`` (x, y, v, heading,
    steer). For ``num_veh > 2`` additional vehicle pairs are stacked into
    adjacent lanes (y offset 6 m per pair) with the same speed pattern.
    """
    n = int(cfg.T / cfg.dt) + 1
    trajs = []
    for i in range(num_veh):
        fast = i % 2 == 0
        v = 20.0 if fast else 10.0
        x0 = 0.0 if fast else 20.0
        lane_y = 6.0 * (i // 2)
        x = np.linspace(x0, x0 + v * cfg.T, n)
        tr = np.stack([x, np.full(n, lane_y), np.full(n, v),
                       np.zeros(n), np.zeros(n)], axis=-1)
        trajs.append(tr)
    return np.stack(trajs)


def ref_traj_intersection(cfg: VehicleConfig, num_veh: int = 2) -> np.ndarray:
    """Intersection references: one straight lane crossed at right angles.

    Ref ``centralized/veh_config.py:50-67``: veh1 along +x at 10 m/s, veh2 along
    -y at 10 m/s crossing at (v*T/2, 0) with heading -pi/2. Extra vehicles
    alternate between the two legs with 8 m spacing.
    """
    n = int(cfg.T / cfg.dt) + 1
    v = 10.0
    trajs = []
    for i in range(num_veh):
        gap = 8.0 * (i // 2)
        if i % 2 == 0:
            x = np.linspace(-gap, -gap + v * cfg.T, n)
            tr = np.stack([x, np.zeros(n), np.full(n, v),
                           np.zeros(n), np.zeros(n)], axis=-1)
        else:
            y = np.linspace(v * cfg.T / 2 + gap, -v * cfg.T / 2 + gap, n)
            tr = np.stack([np.full(n, v * cfg.T / 2), y, np.full(n, v),
                           np.full(n, -np.pi / 2), np.zeros(n)], axis=-1)
        trajs.append(tr)
    return np.stack(trajs)


def pi_admm_crossing_refs(cfg: PiAdmmConfig) -> np.ndarray:
    """Straight-line crossing references of the PI-ADMM line.

    Ref ``casadi_old_PI_ADMM/PI_ADMM_class.py:30-37``: vehicle A moves x from
    -10 to 10 along y=0; vehicle B moves y from 20 to -20 along x=0. Returns
    ``[num_veh, 2, N_step]`` (rows x, y). Extra vehicles alternate between the
    two axes with parallel offsets (4 m per pair), preserving the crossing
    pattern for the 16-vehicle benchmark.
    """
    n = int(cfg.total_time / cfg.dt)
    refs = []
    for i in range(cfg.num_veh):
        off = 4.0 * (i // 2)
        if i % 2 == 0:
            x = np.linspace(-10.0, 10.0, n)
            refs.append(np.stack([x, np.full(n, off)]))
        else:
            y = np.linspace(20.0, -20.0, n)
            refs.append(np.stack([np.full(n, off), y]))
    return np.stack(refs)


def pi_admm_overtake_refs(cfg: PiAdmmConfig):
    """Overtaking references for the unicycle PI-ADMM line (benchmark
    workload: BASELINE.md, 16-vehicle H=30 overtaking batch).

    Vehicles are paired into lanes (y = 6 m per pair): the even vehicle is
    fast and starts behind, the odd one slow and ahead — the fast one must
    dodge laterally around its lane partner. Returns ``(refs [V, 2, N],
    initial_states [V, 3])``; speeds are taken from ``cfg.speeds``.
    """
    n = int(cfg.total_time / cfg.dt)
    refs, states = [], []
    for i in range(cfg.num_veh):
        lane = 6.0 * (i // 2)
        v = cfg.speeds[i]
        x0 = -10.0 if i % 2 == 0 else 0.0
        x = x0 + v * cfg.dt * np.arange(n)
        refs.append(np.stack([x, np.full(n, lane)]))
        states.append([x0, lane, 0.0])
    return np.stack(refs), np.array(states)


def pi_admm_initial_states(cfg: PiAdmmConfig) -> np.ndarray:
    """Initial (x, y, theta) per vehicle (ref ``casadi_old_PI_ADMM/main.py:23``)."""
    states = []
    for i in range(cfg.num_veh):
        off = 4.0 * (i // 2)
        if i % 2 == 0:
            states.append([-10.0, off, 0.0])
        else:
            states.append([off, 20.0, -np.pi / 2])
    return np.array(states)

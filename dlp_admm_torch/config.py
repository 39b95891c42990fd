"""Configuration tree of the PyTorch port.

A standalone copy of ``dlp_admm_tpu/config.py`` (same classes, fields and
defaults, pinned by ``tests/test_torch_config_ops.py``): importing the JAX
package's module would import JAX. The single config system replacing the
five copy-pasted config sites of the reference (SURVEY.md §2.4):

* ``VehicleConfig``   — geometry/limits/delay     (ref: Distributed_planner/decentralized/veh_config.py:5-27)
* ``PiAdmmConfig``    — PI-ADMM hyperparameters    (ref: casadi/PI_ADMM_class.py:13-28,
                        casadi_old_PI_ADMM/PI_ADMM_class.py:13-28, MATLAB param structs)
* ``DualUpdateConfig``— dual-update strategy knobs (ref: C11 sites, e.g.
                        casadi_old_PI_ADMM/main.py:128-151,
                        matlab_old_files/ADMM_CVX_two_veh_intesection_PI_antiwindup.m:152-188)
* ``ObcaConfig``      — OBCA planner knobs         (ref: Distributed_planner/decentralized/optimizer.py:10-37)
* ``SolverConfig``    — iteration budgets for the batched TPU solvers (replacing
                        IPOPT/OSQP options dicts, e.g. decentralized/optimizer.py:173-177)

All classes are frozen dataclasses (static configuration); array-valued
scenario data lives in ``scenarios.py`` instead.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple


class Formulation(enum.Enum):
    """Which decomposition of the joint planning problem to run (SURVEY.md §2.4)."""

    CENTRALIZED = "centralized"       # one joint NLP (ref: centralized/optimizer.py)
    CONSENSUS = "consensus"           # consensus ADMM, local S=(X, lambda) vs edge Z
    BILEVEL = "bilevel"               # MISC: edge solves only the collision-dual problem
    TIGHTENING = "tightening"         # one local + one edge pass per MPC step
    TIGHTENING_SLACK = "tightening_slack"  # + explicit separating-direction s
    ALADIN = "aladin"                 # ALADIN coordinator


class DualStrategy(enum.Enum):
    """Dual-update strategy for the (PI-)ADMM engines (ref C11)."""

    PLAIN = "plain"                   # dual ascent: lam += rho * r
    PI_SIGMOID = "pi_sigmoid"         # kP = th1 - th2/(1+exp(-dmin)), kI = rho
    PI_RECIPROCAL = "pi_reciprocal"   # K_P = min(kp_num/dmin, kp_cap), K_I fixed


class WindupMode(enum.Enum):
    """Anti-windup handling of the saturated dual (ref C11)."""

    NONE = "none"
    SAT = "sat"                       # clip only
    SAT_BACKCALC = "sat_backcalc"     # clip + back-calculation feed to the integrator


@dataclasses.dataclass(frozen=True)
class VehicleConfig:
    """Vehicle geometry, limits and communication-delay statistics.

    Mirrors ``Distributed_planner/decentralized/veh_config.py:5-27`` exactly.
    """

    length: float = 3.5
    width: float = 2.0
    baselink_to_front: float = 3.0
    wheel_base: float = 2.5
    lf: float = 1.5
    max_front_wheel_angle: float = 0.6   # rad
    dt: float = 0.1
    T: float = 5.0                       # scenario period [s]
    max_acc: float = 5.0
    max_v: float = 20.0
    max_steer_rate: float = 20.0
    # communication delay ~ N(avg, var); chance-constraint tightening level `prob`
    # (ref veh_config.py:22-27; decentralized_tighting uses prob=0.99, T=7)
    avg_delay: float = 0.05
    var_delay: float = 0.025
    prob: float = 0.95

    @property
    def baselink_to_rear(self) -> float:
        return self.length - self.baselink_to_front

    @property
    def lr(self) -> float:
        return self.wheel_base - self.lf

    @property
    def min_radius(self) -> float:
        return self.wheel_base / math.tan(self.max_front_wheel_angle)

    @property
    def n_sim_steps(self) -> int:
        return int(round(self.T / self.dt))


@dataclasses.dataclass(frozen=True)
class DualUpdateConfig:
    """Knobs for the dual-update strategies (ref C11).

    Defaults follow the Python adaptive-rho PI line
    (``casadi_old_PI_ADMM/main.py:128-151``): K_P = min(5/d, 2.5), K_I = 3,
    rho = clip(4/d, 1, 5), windup_sat = 20, back-calculation gain 2.
    The MATLAB sigmoid schedule (``ADMM_CVX_..._PI_antiwindup.m:160``) uses
    kP = th1 - th2/(1+exp(-dmin)) with th1=5, th2=3 and kI = rho.
    """

    strategy: DualStrategy = DualStrategy.PI_RECIPROCAL
    windup: WindupMode = WindupMode.SAT_BACKCALC
    windup_sat: float = 20.0
    # PI_RECIPROCAL schedule
    kp_num: float = 5.0
    kp_cap: float = 2.5
    ki: float = 3.0
    backcalc_gain: float = 2.0
    # MATLAB adp sub-variant (ADMM_CVX_two_veh_intesection_adp_PI_
    # antiwindup1.m:116-148): the integrator gain is ALSO distance-scheduled,
    # K_I = ki_num / d_min (its K_P cap is 3, vs the Python port's 2.5 —
    # set kp_cap accordingly when reproducing that file)
    ki_adaptive: bool = False
    ki_num: float = 3.0
    # adaptive rho = clip(rho_num / dmin, rho_lo, rho_hi); set lo == hi to disable
    adaptive_rho: bool = True
    rho_num: float = 4.0
    rho_lo: float = 1.0
    rho_hi: float = 5.0
    # PI_SIGMOID schedule
    sigmoid_th1: float = 5.0
    sigmoid_th2: float = 3.0
    # PI_SIGMOID integrator gain: the MATLAB reference couples kI to the
    # penalty (``param.kI = param.rho``, ADMM_CVX_..._PI_antiwindup.m:21);
    # True (default) reproduces that coupling, False uses the fixed ``ki``
    ki_from_rho: bool = True


@dataclasses.dataclass(frozen=True)
class PiAdmmConfig:
    """Hyperparameters of the unicycle PI-ADMM planner.

    Mirrors the Bunch in ``casadi_old_PI_ADMM/PI_ADMM_class.py:13-28`` by
    default (horizon 5, beta 1e4, Pnorm 5, eps_pri 1). The evolved per-pair
    variant (``casadi/PI_ADMM_class.py:13-28``) uses horizon=15, dis_thres=2,
    beta=10, Pnorm=1, eps_pri=20.
    """

    dt: float = 0.1
    total_time: float = 5.0              # `Nt`
    wheel_base: float = 1.0              # `L`
    horizon: int = 5                     # `num_ho`
    num_veh: int = 2
    dis_thres: float = 1.5
    speeds: Tuple[float, ...] = (4.0, 8.0)
    beta: float = 1.0e4                  # collision hinge weight
    p_norm: float = 5.0                  # tracking weight
    p_cost: float = 1.0                  # control-effort weight
    iter_num: int = 100                  # ADMM iteration cap
    rho: float = 1.0
    eps_pri: float = 1.0
    eps_dual: float = 1.0
    # control limits (ref nonlcon_function: |u| <= pi/6, |du| <= pi/9)
    u_max: float = math.pi / 6
    du_max: float = math.pi / 9
    # require min inter-vehicle distance > dis_thres before stopping
    # (ref casadi_old_PI_ADMM/main.py:157; the per-pair variant drops this)
    stop_needs_clearance: bool = True
    # scale eps_pri/eps_dual by the number of ACTIVE collision pairs: the
    # reference's per-edge residual (casadi/main.py:167-173) sums one term
    # per active edge against a FIXED eps_pri tuned for its single-pair
    # scenario — at V >> 2 a fixed total tolerance is arbitrarily stricter
    # per edge, so the honest N-vehicle generalization is per-edge tolerance
    eps_per_edge: bool = False

    @property
    def n_mpc_steps(self) -> int:
        return int(self.total_time / self.dt - self.horizon)

    @classmethod
    def per_pair(cls) -> "PiAdmmConfig":
        """The evolved per-collision-pair variant (``casadi/PI_ADMM_class.py:13-28``)."""
        return cls(horizon=15, dis_thres=2.0, beta=10.0, p_norm=1.0,
                   rho=2.0, eps_pri=20.0, eps_dual=1.0,
                   stop_needs_clearance=False)


@dataclasses.dataclass(frozen=True)
class ObcaConfig:
    """Knobs of the OBCA planner family (ref decentralized/optimizer.py:10-37)."""

    num_veh: int = 2
    horizon: int = 8                     # N_horz (centralized uses 15, tighting 7+1)
    min_dis: float = 0.1                 # minimum set-distance requirement
    use_delay_tightening: bool = False   # `prob` flag: chance-tightened halfspaces
    primal_thres: float = 0.01
    dual_thres: float = 0.01
    # scale the residual thresholds by num_veh/2: the reference's 0.01
    # values gate SUMS over all vehicles' controls / duals, tuned for its
    # 2-vehicle driver (decentralized_overtaking_ADMM.py:82-90) — at V=8
    # the same totals are 4x stricter per vehicle, and every step caps
    # (measured, tools/exp_obca_batch.py v8). The OBCA analogue of the PI
    # line's eps_per_edge. Off by default = exact reference semantics.
    thres_per_veh: bool = False
    rho: float = 1.0
    # dual-ascent step size; None couples it to the AL penalty `rho` (the
    # standard ADMM choice, and the reference's: lambda_update(1) with
    # rho = 1, decentralized_overtaking_ADMM.py:42,79). A smaller explicit
    # value damps the dual when the saturation bound would otherwise rail.
    dual_rho: Optional[float] = None
    max_admm_iters: int = 50             # ref decentralized_overtaking_ADMM.py:86
    # objective weights (ref decentralized_overtaking_ADMM.py:56-58)
    r_ctrl: float = 1.0e4
    q_state: float = 1.0e5
    max_x: float = 150.0
    max_y: float = 20.0


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Iteration budgets for the batched solvers.

    Replaces the IPOPT/OSQP option dicts (ref decentralized/optimizer.py:173-177,
    casadi/main.py:95-96). Convergence is tracked with per-lane masks
    (SURVEY.md §7 hard part 2).
    """

    # interior-point NLP solver
    ip_iters: int = 40
    ip_mu0: float = 1.0e-1
    ip_tol: float = 1.0e-6
    # OSQP-style QP solver
    qp_iters: int = 100
    qp_rho: float = 0.1
    qp_sigma: float = 1.0e-6
    qp_alpha: float = 1.6
    qp_tol: float = 1.0e-6
    # condensed-KKT inverse strategy of the QP solver: "ns" (Newton-Schulz
    # from a diagonal seed) or "chol" (exact, via Cholesky)
    qp_kkt: str = "ns"
    qp_ns_iters: int = 18
    # number of QP iteration segments (rho adapted between segments)
    qp_segments: int = 4
    # unroll factor of the QP splitting iteration
    qp_unroll: int = 1

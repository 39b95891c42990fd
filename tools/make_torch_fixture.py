"""Write the JAX reference run that the PyTorch port is held against.

Runs the consensus-OBCA flagship (2-vehicle overtaking, horizon 8, rho 100,
ADMM cap 50, annealed local prox 700 x 1.5, staged IP with ``ip_iters=40``)
on the CPU through ``ConsensusObcaPlanner.run_scan(return_health=True)``, all
42 MPC steps, in one of its two profiles (``bench.py``):

* ``f64``: float64, ``ip_tol=1e-6``, ``prox_tau_max=3e10``, saved as
  ``tests/data/consensus_obca_f64_ref.npz``;
* ``f32``: float32, ``ip_tol=1e-4``, ``prox_tau_max=1e9`` (equilibrated
  stage solves, two refinement passes), run with JAX's 64-bit mode off as
  the accelerator runs it, saved as ``tests/data/consensus_obca_f32_ref.npz``;
* ``v4``: the 4-vehicle run of ``tests/test_multivehicle.py``
  (``TestConsensusMultiVehicle.test_four_vehicle_two_lane_overtake``: two
  overtaking pairs in adjacent lanes, horizon 8, rho 100, ADMM cap 5,
  ``ip_iters=40``, ``ip_tol=1e-6``, pairs gated at 12 m, float64) through
  ``ConsensusObcaPlanner.run``, 4 MPC steps, and the same configuration's
  first step with the ADMM cap cut to 2 (``capped_*``), and that capped
  step with 3 vehicles (``v3_capped_*``: the CPU test's, whose edge width
  45 is also the wide kernel's and which costs a third of the 4-vehicle
  step on the CPU), saved as ``tests/data/consensus_obca_v4_f64_ref.npz``.
  Its KKT widths (locals 33, edge 80) are the wide kernel's.
* ``v9``: one consensus MPC step of 9 vehicles with ``tools/exp_obca_batch.py
  v8``'s planner settings (horizon 8, ``min_dis`` 0.1, rho 100, local prox
  700 x 1.5 up to 1e9, ``ip_iters=40``, ``ip_tol=1e-4``) in float64 with
  the ADMM cap cut to 2, through ``ConsensusObcaPlanner.run``
  (``states [2, 9, 5]``, ``iterations [1]``), and the same step from a
  ``z_bar`` moved by 1e-12 (``moved_states``, ``moved_iterations``,
  ``moved_state_err``, ``chaotic``: whether the moved step leaves the
  unmoved one by more than 1e-6 or takes other ADMM iteration counts),
  saved as ``tests/data/consensus_obca_v9_f64_ref.npz`` (about 2.5
  minutes). Its edge KKT width is 405 (5V + 10 V(V-1)/2).

* ``pi_admm``: ``bench.py``'s first workload (the pairwise PI-ADMM engine,
  16 vehicles overtaking in 8 lanes, horizon 30, per-step cap 60, whole-run
  budget 210, ``pair_budget`` 24, ``edge_prox_tau`` 2, cross-step consensus
  carry) at float64, on the first 2 of the bench's 32 seeded starts
  (``default_rng(0)``, 0.5 m noise), 12 MPC steps through
  ``run_fused_batch``; also the lane-0 ``AdmmCarry`` after step 0 (the
  per-step driver's) and one ``_pairwise_iter`` of step 1 started from it,
  saved as ``tests/data/pi_admm_bench_f64_ref.npz``;
* ``pi_admm_f32``: ``bench.py``'s own float32 run of that workload (32
  lanes, 12 steps), saved as ``tests/data/pi_admm_bench_f32_ref.npz``;
* ``batch``: ``bench.py``'s third workload (``:239-283``), the
  scenario-batched flagship through ``parallel.consensus_spmd.
  run_scenario_batch`` in the float64 profile: 16 starts, the flagship's
  start plus 0.25 m normal jitter on the positions from ``default_rng(0)``,
  lane 0 unperturbed, over its first ``BATCH["steps"]`` (6) of 20 MPC
  steps (about 4 minutes a run on the CPU), saved as
  ``tests/data/consensus_obca_batch_f64_ref.npz``; also ``chaotic_from
  [16]``, per lane the first step at which the same run with its starts
  moved by 1e-12 (``BATCH["chaos_seeds"]``) leaves it by more than 1e-6 or
  takes other ADMM iteration counts (the number of steps where it never
  does);
* ``batch_f32``: the same workload whole in the float32 profile (16 lanes
  x 20 steps, JAX's 64-bit mode off), a tool run that saves nothing unless
  ``--out`` is given and prints res_ok (of 320), the steps at the ADMM cap,
  the smallest centre distance and the median consensus gap: the CPU
  record beside the port's ``chip_smoke.py --full-batch``;
* ``spmd``: the five cases of ``tests/test_consensus_spmd.py``, the
  planner modes the batched step honours and a float32 case, each one JAX
  ``make_consensus_spmd_step`` call on a 1x1 mesh (``SPMD_CASES``), and for
  the first case a second step from the first's output, saved as
  ``tests/data/consensus_spmd_cases_ref.npz`` (keys ``<case>__<field>``:
  ``init``, ``bs_<leaf>``, ``out_<i>`` and, for step 1, ``step1_<i>``, the
  ``BarState`` outputs as ``out_1_<leaf>``; ``profile`` maps each case to
  its configuration). ``tests/test_torch_consensus_spmd.py`` holds the port
  to it and checks one case against JAX run live.

* ``classic``: the classic PI-ADMM layout, ``run_pi_admm()``'s defaults
  (2 vehicles crossing, horizon 5, all 45 MPC steps, PI-reciprocal dual
  update with back-calculation and adaptive rho, ``SolverConfig()``) through
  ``PiAdmmEngine(layout="classic").run``; ``chaotic_from``, the first step
  at which the same run with its start moved by 1e-12 (``chaos_seeds``)
  leaves it by more than 1e-6 or takes other iteration counts; the two
  A/Bs of ``tests/test_pi_vs_plain.py`` (``ab_*``: PI-reciprocal against
  plain dual ascent at ``qp_iters=120``; ``sig_*``: the sigmoid schedule
  against saturated plain ascent at the MATLAB file's operating point);
  and the joint edge QP (``_solve_joint_edge_qp``) at 2 and 3 vehicles on
  numpy-seeded inputs (``qp_<V>_in_*``, ``qp_<V>_out_*``), saved as
  ``tests/data/pi_admm_classic_ref.npz``;
* ``centralized``: ``run_obca(Formulation.CENTRALIZED)``'s defaults (the
  joint NLP of 2 overtaking vehicles, horizon 15, ``min_dis`` 1.0, staged
  IP with ``ip_iters=40``, reference warm start, 35 MPC steps) through
  ``CentralizedObcaPlanner.run`` (``states``, ``controls``, ``iterations``,
  ``kkt``, ``converged``), ``chaotic_from`` as above with the references
  moved by 1e-12, ``solve_at`` at the steps ``solve_steps`` from the run's
  states in the staged (``staged_*``) and at step 0 in the dense form
  (``dense_*``), and the centralized side of
  ``tests/test_parity_oracle.py``'s conflict case (``oracle_*``: ``min_dis``
  0.5, ``warm_mode="previous"``, 30 steps), saved as
  ``tests/data/obca_centralized_ref.npz``;
* ``centralized_v4``: one staged ``solve_at`` of the joint NLP at step 0
  with 3 and with 4 vehicles (``v3_*``, ``v4_*``; ``ip_iters`` 80 and 150,
  the trips JAX needs there), and the 4-vehicle solve from starts moved by
  1e-12 with 300 trips (``v4_moved_iterations``, ``_converged``,
  ``_state_err``: the largest state distance from the unmoved solve), saved
  as
  ``tests/data/obca_centralized_v4_ref.npz``;
* ``bilevel``: ``run_obca(Formulation.BILEVEL | TIGHTENING |
  TIGHTENING_SLACK)``'s defaults (2 vehicles, horizon 8, ``min_dis`` 1.0,
  ``SolverConfig()``, 3 bilevel rounds, T = 7 s and prob 0.99 for
  tightening; 42 / 62 / 62 MPC steps) through the planners' ``run``
  (``<planner>_states``, ``_elastic``, ``_dual_kkt``, ``_chaotic_from``
  with the references moved by 1e-12), ``tests/test_bilevel.py``'s
  12-step bilevel run with 2 rounds (``test_bilevel_*``) and the 4-vehicle
  tightening of ``tests/test_multivehicle.py`` (``v4_*``, 10 steps), saved
  as ``tests/data/bilevel_ref.npz``;
* ``aladin``: the ALADIN crossing of ``tests/test_aladin.py``
  (``AladinUnicyclePlanner(PiAdmmConfig())``, ``ip_iters`` 25, ``ip_tol``
  1e-7, 45 steps: ``states``, ``iterations``, ``chaotic_from`` with the
  start moved by 1e-12, and those moved runs' ``moved_total_iterations``
  and ``moved_min_distance_m``) and ``run_obca(Formulation.ALADIN)``'s
  3-step dispatch of its ``test_driver_dispatch`` (``dispatch_*``), saved
  as ``tests/data/aladin_ref.npz``;
* ``checkpoint``: the checkpoint/resume configurations of
  ``tests/test_driver_utils.py::TestEngineCheckpointResume`` (``CHECKPOINT``:
  the consensus and bilevel planners, the ALADIN toy, the PI-ADMM engine in
  the pairwise layout with the cross-step carry and in the classic layout),
  each run uninterrupted (``<case>__states`` and ``<case>__iterations``;
  ALADIN: ``__x``, ``__lam``, ``__ys``) and run to its ``ckpt_at`` step with
  ``checkpoint_path``, the JAX ``save_carry`` file's leaves, leaf count,
  structure string and step kept as ``<case>__leaf_<i>``,
  ``__n_leaves``, ``__treedef``, ``__step``; saved as
  ``tests/data/checkpoint_ref.npz`` (about a minute on the CPU);
* ``mesh``: JAX's ``make_consensus_spmd_step`` with the vehicle axis
  partitioned, on the meshes of ``MESH_CASES`` over the first devices of
  the 8 CPU devices (``tests/conftest.py``'s): the cases of ``spmd`` on
  1x2, 2x1 and 2x2 (keys ``<case>@<S>x<V>__out_<i>[_<leaf>]``), saved as
  ``tests/data/consensus_spmd_mesh_ref.npz`` (about 4 minutes);
* ``options``: the consensus planner's options (``OPTIONS``) at the
  flagship's float64 profile with the ADMM cap cut to 6, one MPC step
  each from the flagship run's
  carry at step ``OPTIONS["step"]`` (``carry_state``, ``carry_bs_<leaf>``):
  ``edge_prox``, ``branch_commit`` (with a small ``commit_after``) and
  ``mpc_step_trace`` of a planner with both at a fixed ``n_iters``
  (``<run>__out_<i>[_<leaf>]``; the trace's ``trace__xs``, ``__z_bar``,
  ``__d_bar`` and ``__hist_<key>``), and per run ``<run>__chaotic``,
  whether the same step from the carry's state moved by 1e-12 (two seeds)
  leaves it by more than 1e-6 or takes other iteration counts, saved as
  ``tests/data/obca_options_ref.npz`` (about 4 minutes).

Each OBCA file holds

    states [43, 2, 5], iterations [42], primal [42], dual [42],
    nlp_ok [42, 2], nlp_kkt [42, 2], gaps [42],
    profile (JSON string), commit (git revision of the tree that ran it)

(``v4``: ``states [5, 4, 5]``, ``iterations [4]``, ``primal``, ``dual``,
``nlp_ok``, ``nlp_kkt``, ``capped_states [2, 4, 5]``,
``capped_iterations [1]``, ``v3_capped_states [2, 3, 5]``,
``v3_capped_iterations [1]``, no ``gaps``.) ``tests/test_torch_obca.py`` and
``chip_smoke.py`` read it. The PI-ADMM files hold the fused batch's
records ``xt [S, 12, 16, 3]``, ``u_applied [S, 12, 16]``, ``iterations``,
``primal_res``, ``dual_res``, ``converged`` (each ``[S, 12]``), ``xts0``
(the starts), ``min_distance_m`` and ``profile``/``commit``; the float64 file
also ``carry0_*`` (the ``AdmmCarry`` fields, ``xt``, ``u``) and ``iter1_*``
(the iteration's carry but ``last_hat``, which is its ``hat``).

``--noise EPS`` adds normal noise of that size (``--seed``) to the consensus
iterate ``z_bar`` the run starts from and saves nothing unless ``--out`` is
given: a rounding-level change of the start shows how far the 42-step
numbers printed at the end (steps under the residual thresholds, centre
distance, NLP health, consensus gap) are properties of the planner and how
far of one trajectory through the conflict window. With ``--profile
pi_admm`` the noise goes on the lanes' start states instead, and the run
prints, per lane and step, its largest state distance from the committed
float64 fixture and where the iteration counts part: a rounding-level change
of the start shows at which (lane, step) the JAX run leaves itself
(``pi_admm_f32``: the same against the float32 fixture, with the run's
capped steps, converged fraction and minimum distance).

With ``--profile batch`` the noise goes on the 16 starts, and the run prints
per (lane, step) its largest state distance from the committed fixture;
with ``batch_f32`` it goes on the whole ``[16, 2, 5]`` start as well, and
the run prints its res_ok per lane (``--out`` keeps the starts, each
lane's iterations and residuals): ``tools/perturbed_torch_batch.py judge``
sets it beside the port's batch from the same starts.

``--stage-f64`` (``f32`` only) runs JAX's float32 flagship with every KKT
solve of its staged solver in float64 (:func:`stage_solve_f64`: the
block-Thomas recursion on the host, one ``np.linalg.solve`` a stage,
through ``jax.pure_callback``; the refinements' residuals and the solve's
verification stay JAX's own, in float32); it saves nothing unless
``--out`` is given. ``tools/judge_f32_flagship.py --stage-f64`` judges
such runs.

With ``--profile classic``, ``centralized`` or ``aladin`` the noise goes
on the start (the references, for ``centralized``), and the run prints per
step its largest state distance from the committed fixture (``aladin``:
its iterations, their total and the minimum distance).

Usage: python tools/make_torch_fixture.py
           [--profile f64|f32|v4|v9|pi_admm|pi_admm_f32|batch|batch_f32|
                      spmd|classic|
                      centralized|centralized_v4|bilevel|aladin|checkpoint|
                      mesh|options]
           [--steps N] [--out PATH] [--noise EPS --seed N] [--stage-f64]
"""
import argparse
import json
import os
import subprocess
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"
# the 8 CPU devices of tests/conftest.py, which the mesh profile lays out
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dlp_admm_tpu.config import ObcaConfig, SolverConfig  # noqa: E402
from dlp_admm_tpu.models.obca import ConsensusObcaPlanner  # noqa: E402

PROFILE = dict(
    ocfg=dict(horizon=8, min_dis=0.1, rho=100.0, max_admm_iters=50),
    scfg=dict(ip_iters=40, ip_tol=1e-6),
    planner=dict(local_prox=700.0, prox_growth=1.5, prox_tau_max=3.0e10),
    dtype="float64",
)
PROFILES = dict(
    f64=PROFILE,
    f32=dict(PROFILE, scfg=dict(ip_iters=40, ip_tol=1e-4),
             planner=dict(local_prox=700.0, prox_growth=1.5,
                          prox_tau_max=1.0e9),
             dtype="float32"),
    v4=dict(ocfg=dict(num_veh=4, horizon=8, min_dis=0.1, max_admm_iters=5,
                      rho=100.0),
            scfg=dict(ip_iters=40, ip_tol=1e-6),
            planner=dict(gate_pairs=True, gate_thres=12.0),
            dtype="float64", steps=4, capped_admm_iters=2),
    v9=dict(ocfg=dict(num_veh=9, horizon=8, min_dis=0.1, rho=100.0,
                      max_admm_iters=2),
            scfg=dict(ip_iters=40, ip_tol=1e-4),
            planner=dict(local_prox=700.0, prox_growth=1.5,
                         prox_tau_max=1.0e9),
            dtype="float64", steps=1, chaos_noise=1e-12, chaos_seed=1,
            chaos_tol=1e-6))


# bench.py:55-107, the PI-ADMM workload of its first metric
PI_ADMM = dict(num_veh=16, horizon=30, n_scen=32, n_steps=12, iter_budget=210,
               iter_cap=60, noise=0.5, seed=0,
               cfg=dict(dis_thres=2.0, eps_pri=1.0, eps_dual=1.0,
                        stop_needs_clearance=False, eps_per_edge=True),
               dual=dict(windup_sat=200.0),
               solver=dict(qp_iters=16, qp_tol=1e-4, qp_segments=1,
                           qp_ns_iters=10, qp_unroll=16),
               engine=dict(layout="pairwise", n_sqp=1, pair_budget=24,
                           carry_admm_state=True, edge_prox_tau=2.0))
PI_ADMM_LANES = dict(pi_admm=2, pi_admm_f32=32)

# bench.py:239-283, the scenario-batched workload of its third metric
BATCH = dict(n_scen=16, jitter=0.25, seed=0, steps=6, planner=PROFILE,
             chaos_noise=1e-12, chaos_seeds=(1, 2), chaos_tol=1e-6)
BATCH_F32_STEPS = 20     # bench.py:248

# tests/test_consensus_spmd.py's cases (its _setup: ADMM cap 2, ip_iters 5,
# rho 100, dense locals and the joint edge unless named), the modes of the
# batched step (ADMM cap 4) and a float32 case of the staged profile
_SPMD_MODES = dict(max_admm_iters=4, num_veh=2, horizon=6, n_scen=2)
SPMD_CASES = {
    "two_vehicle_reference_problem": dict(num_veh=2, horizon=8, n_scen=4),
    "four_vehicle_blocks_with_gating": dict(
        num_veh=4, horizon=5, n_scen=4,
        planner=dict(gate_pairs=True, gate_thres=12.0)),
    "track_local_mode": dict(num_veh=2, horizon=5, n_scen=2,
                             planner=dict(lamb_ij_mode="track_local")),
    "staged_default_mode": dict(
        num_veh=2, horizon=6, n_scen=2,
        planner=dict(use_staged=True, edge_mode="staged")),
    "annealed_prox_profile": dict(
        num_veh=2, horizon=6, n_scen=2,
        planner=dict(use_staged=True, edge_mode="staged", local_prox=700.0,
                     prox_growth=1.5, prox_tau_max=1.0e9)),
    # dense local NLPs and the edge as one dense NLP per horizon step
    "use_staged=False-edge_mode=per_step": dict(
        _SPMD_MODES, planner=dict(use_staged=False, edge_mode="per_step")),
    # staged locals, the joint edge, the adaptive prox ratchet and the
    # certificate hysteresis (both act from the third ADMM iteration on)
    "edge_mode=joint-prox_adaptive-lamb_ij_hysteresis": dict(
        _SPMD_MODES, planner=dict(
            use_staged=True, edge_mode="joint", local_prox=700.0,
            prox_growth=1.5, prox_adaptive=True, lamb_ij_hysteresis=True)),
    "float32_staged_profile": dict(
        num_veh=2, horizon=8, n_scen=2, dtype="float32",
        scfg=dict(ip_iters=12, ip_tol=1e-4),
        planner=dict(use_staged=True, edge_mode="staged", local_prox=700.0,
                     prox_growth=1.5, prox_tau_max=1.0e9)),
}
SPMD_CARRIED = "two_vehicle_reference_problem"

# the vehicle-sharded step of the spmd cases on (scenario, vehicle) meshes
MESH_CASES = (("two_vehicle_reference_problem", 1, 2),
              ("two_vehicle_reference_problem", 2, 1),
              ("two_vehicle_reference_problem", 2, 2),
              ("four_vehicle_blocks_with_gating", 1, 2),
              ("track_local_mode", 1, 2),
              ("staged_default_mode", 1, 2),
              ("annealed_prox_profile", 1, 2))

# the consensus planner's options, one flagship float64 step each (its ADMM
# cap cut to 6) from the flagship run's carry at a step inside the
# conflict window
OPTIONS = dict(step=11, ocfg=dict(max_admm_iters=6), chaos_noise=1e-12,
               chaos_seeds=(1, 2), chaos_tol=1e-6, trace_iters=6,
               runs=dict(edge_prox=dict(edge_prox=1.0),
                         branch_commit=dict(branch_commit=True,
                                            commit_after=3),
                         trace=dict(edge_prox=1.0, branch_commit=True,
                                    commit_after=3)))

# the classic PI-ADMM layout: run_pi_admm()'s defaults, the A/Bs of
# tests/test_pi_vs_plain.py and the joint edge QP cases of
# tests/test_pi_admm.py::TestJointEdgeQp (its solver budget)
CLASSIC = dict(
    chaos_noise=1e-12, chaos_seeds=(1, 2), chaos_tol=1e-6,
    ab_solver=dict(qp_iters=120, qp_tol=1e-6),
    ab_pi=dict(strategy="PI_RECIPROCAL", windup="SAT_BACKCALC",
               adaptive_rho=True),
    ab_plain=dict(strategy="PLAIN", windup="NONE", adaptive_rho=False),
    sig_cfg=dict(horizon=8, dis_thres=2.0, beta=1000.0, p_norm=5.0, rho=3.5,
                 eps_pri=2.0, eps_dual=2.0),
    sig_plain=dict(strategy="PLAIN", windup="SAT", windup_sat=30.0,
                   adaptive_rho=False),
    sig_pi=dict(strategy="PI_SIGMOID", windup="SAT_BACKCALC",
                windup_sat=30.0, adaptive_rho=False),
    qp_solver=dict(qp_iters=200, qp_tol=1e-9), qp_seed=5)
# run_obca(Formulation.CENTRALIZED)'s defaults (dlp_admm_tpu/mpc/driver.py:
# 63-70) and the centralized side of tests/test_parity_oracle.py:100-140
CENTRALIZED = dict(
    ocfg=dict(horizon=15, min_dis=1.0), steps=35, solve_steps=(0, 3),
    chaos_noise=1e-12, chaos_seeds=(1, 2), chaos_tol=1e-6,
    oracle=dict(ocfg=dict(horizon=15, min_dis=0.5, rho=100.0,
                          max_admm_iters=50),
                scfg=dict(ip_iters=40, ip_tol=1e-6), warm_mode="previous",
                steps=30))
CENTRALIZED_V4 = dict(ocfg=dict(horizon=15, min_dis=1.0),
                      ip_iters={3: 80, 4: 150},
                      # the 4-vehicle solve from starts moved by 1e-12, each
                      # with 300 trips: where JAX itself converges to the
                      # same optimum and where it does not
                      moved=dict(noise=1e-12, seeds=[1, 2, 3, 4, 5, 6],
                                 ip_iters=300))
# the fixed-dual family: run_obca(BILEVEL | TIGHTENING | TIGHTENING_SLACK)'s
# defaults (dlp_admm_tpu/mpc/driver.py:57-98: horizon 8, min_dis 1.0,
# SolverConfig(), 3 bilevel rounds, T = 7 s and prob 0.99 for tightening),
# tests/test_bilevel.py's 12-step runs (its SCFG is SolverConfig()'s
# budget; the bilevel test takes 2 rounds) and the 4-vehicle tightening of
# tests/test_multivehicle.py:90-104
BILEVEL = dict(
    planners=("bilevel", "tightening", "tightening_slack"),
    ocfg=dict(horizon=8, min_dis=1.0), scfg=dict(ip_iters=40, ip_tol=1e-6),
    n_rounds=3, test_steps=12, test_n_rounds=2,
    v4=dict(ocfg=dict(num_veh=4, horizon=8, min_dis=1.0), steps=10),
    chaos_noise=1e-12, chaos_seeds=(1, 2), chaos_tol=1e-6)
# the ALADIN crossing of tests/test_aladin.py:142-176 (PiAdmmConfig(), 45
# steps) and the driver dispatch of its test_driver_dispatch
ALADIN = dict(scfg=dict(ip_iters=25, ip_tol=1e-7), steps=45,
              dispatch=dict(scfg=dict(ip_iters=15, ip_tol=1e-6), steps=3),
              chaos_noise=1e-12, chaos_seeds=(1, 2), chaos_tol=1e-6)

# the checkpoint/resume configurations of tests/test_driver_utils.py::
# TestEngineCheckpointResume (and the classic PI-ADMM layout beside the
# pairwise one, whose carry here includes the cross-step AdmmCarry): each
# run uninterrupted for ``steps`` and checkpointed at ``ckpt_at``
_PI_XT0 = [[-3.0, 0.0, 0.0], [0.0, 6.0, -1.5707963267948966]]
CHECKPOINT = dict(
    consensus=dict(ocfg=dict(horizon=5, max_admm_iters=2, rho=100.0),
                   scfg=dict(ip_iters=5, ip_tol=1e-6), steps=4, ckpt_at=2),
    bilevel=dict(ocfg=dict(horizon=5, min_dis=1.0),
                 scfg=dict(ip_iters=5, ip_tol=1e-6), n_rounds=1, steps=4,
                 ckpt_at=2),
    aladin=dict(a_mats=[[[1.0]], [[-1.0]]], targets=[[3.0], [7.0]],
                rho=1.0, mu=1e4, scfg=dict(ip_iters=25, ip_tol=1e-9),
                steps=6, ckpt_at=2),
    pi_admm=dict(cfg=dict(iter_num=4), scfg=dict(qp_iters=120, qp_tol=1e-6),
                 layout="pairwise", engine=dict(carry_admm_state=True),
                 xt0=_PI_XT0, steps=6, ckpt_at=2),
    pi_admm_classic=dict(cfg=dict(iter_num=4),
                         scfg=dict(qp_iters=120, qp_tol=1e-6),
                         layout="classic", engine={}, xt0=_PI_XT0, steps=6,
                         ckpt_at=2))


def default_out(name):
    if name in PI_ADMM_LANES:
        stem = "f64" if name == "pi_admm" else "f32"
        return os.path.join(ROOT, "tests", "data",
                            f"pi_admm_bench_{stem}_ref.npz")
    if name == "spmd":
        return os.path.join(ROOT, "tests", "data",
                            "consensus_spmd_cases_ref.npz")
    if name == "mesh":
        return os.path.join(ROOT, "tests", "data",
                            "consensus_spmd_mesh_ref.npz")
    if name == "options":
        return os.path.join(ROOT, "tests", "data", "obca_options_ref.npz")
    if name == "classic":
        return os.path.join(ROOT, "tests", "data", "pi_admm_classic_ref.npz")
    if name in ("bilevel", "aladin", "checkpoint"):
        return os.path.join(ROOT, "tests", "data", f"{name}_ref.npz")
    if name.startswith("centralized"):
        return os.path.join(ROOT, "tests", "data",
                            f"obca_{name}_ref.npz")
    stem = {"v4": "v4_f64", "v9": "v9_f64",
            "batch": "batch_f64"}.get(name, name)
    return os.path.join(ROOT, "tests", "data",
                        f"consensus_obca_{stem}_ref.npz")


DEFAULT_OUT = default_out("f64")


def make_planner(name="f64", **ocfg):
    """The JAX planner of profile ``name`` (``ocfg`` overrides fields of its
    ``ObcaConfig``). The float32 planner needs JAX's 64-bit mode off
    (``jax.enable_x64(False)`` around its use)."""
    prof = PROFILES[name]
    return ConsensusObcaPlanner(ObcaConfig(**{**prof["ocfg"], **ocfg}),
                                scfg=SolverConfig(**prof["scfg"]),
                                dtype=getattr(jax.numpy, prof["dtype"]),
                                **prof["planner"])


def write_v4(out, commit):
    """The 4-vehicle run and its capped first step, through ``run`` as
    ``tests/test_multivehicle.py`` calls it."""
    prof = PROFILES["v4"]
    t0 = time.perf_counter()
    states, its, res, _ = make_planner("v4").run(n_steps=prof["steps"])
    capped, capped_its, _, _ = make_planner(
        "v4", max_admm_iters=prof["capped_admm_iters"]).run(n_steps=1)
    v3, v3_its, _, _ = make_planner(
        "v4", max_admm_iters=prof["capped_admm_iters"], num_veh=3).run(
            n_steps=1)
    res = np.asarray(res, dtype=np.float64)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out, states=np.asarray(states), iterations=np.asarray(its),
        primal=res[:, 0], dual=res[:, 1], nlp_ok=res[:, 2:4],
        nlp_kkt=res[:, 4:6], capped_states=np.asarray(capped),
        capped_iterations=np.asarray(capped_its),
        v3_capped_states=np.asarray(v3),
        v3_capped_iterations=np.asarray(v3_its),
        profile=np.asarray(json.dumps(prof, sort_keys=True)),
        commit=np.asarray(commit))
    print(json.dumps(dict(
        out=os.path.relpath(out, ROOT), profile="v4",
        seconds=round(time.perf_counter() - t0, 1),
        iterations=np.asarray(its).tolist(),
        capped_iterations=np.asarray(capped_its).tolist(),
        v3_capped_iterations=np.asarray(v3_its).tolist(), commit=commit)))


def write_v9(out, commit):
    """The 9-vehicle step, and the same step from a ``z_bar`` moved by
    ``chaos_noise``."""
    prof = PROFILES["v9"]
    t0 = time.perf_counter()
    planner = make_planner("v9")
    states, its, _, _ = planner.run(n_steps=prof["steps"])
    bs0 = planner.create_bar_state()
    eps = prof["chaos_noise"] * np.random.default_rng(
        prof["chaos_seed"]).normal(size=bs0.z_bar.shape)
    bs0 = bs0._replace(z_bar=bs0.z_bar + eps.astype(bs0.z_bar.dtype))
    planner.create_bar_state = lambda: bs0
    moved, moved_its, _, _ = planner.run(n_steps=prof["steps"])
    states, moved = np.asarray(states), np.asarray(moved)
    err = float(np.abs(moved - states).max())
    chaotic = bool(err > prof["chaos_tol"] or not np.array_equal(
        np.asarray(its), np.asarray(moved_its)))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out, states=states, iterations=np.asarray(its),
        moved_states=moved, moved_iterations=np.asarray(moved_its),
        moved_state_err=np.asarray(err), chaotic=np.asarray(chaotic),
        profile=np.asarray(json.dumps(prof, sort_keys=True)),
        commit=np.asarray(commit))
    print(json.dumps(dict(
        out=os.path.relpath(out, ROOT), profile="v9",
        seconds=round(time.perf_counter() - t0, 1),
        iterations=np.asarray(its).tolist(),
        moved_iterations=np.asarray(moved_its).tolist(),
        moved_state_err=err, chaotic=chaotic,
        finite=bool(np.all(np.isfinite(states))), commit=commit)))


def bench_engine(dtype):
    """``bench.py``'s PI-ADMM engine and its seeded starts ``[32, 16, 3]``
    (float64 numpy, as bench.py makes them before its cast)."""
    from dlp_admm_tpu.config import DualUpdateConfig, PiAdmmConfig
    from dlp_admm_tpu.models.pi_admm import PiAdmmEngine
    from dlp_admm_tpu.scenarios import pi_admm_overtake_refs
    b = PI_ADMM
    v = b["num_veh"]
    speeds = tuple(8.0 if i % 2 == 0 else 4.0 for i in range(v))
    cfg = PiAdmmConfig(num_veh=v, horizon=b["horizon"], speeds=speeds,
                       iter_num=b["iter_cap"], **b["cfg"])
    refs, xt0 = pi_admm_overtake_refs(cfg)
    eng = PiAdmmEngine(cfg, DualUpdateConfig(**b["dual"]),
                       SolverConfig(**b["solver"]), refs=refs, dtype=dtype,
                       **b["engine"])
    rng = np.random.default_rng(b["seed"])
    xts = xt0[None] + np.concatenate([
        b["noise"] * rng.normal(size=(b["n_scen"],) + xt0[:, :2].shape),
        np.zeros((b["n_scen"], v, 1))], axis=-1)
    return eng, xts


def write_pi_admm(name, out, commit, noise=0.0, seed=0):
    """The fused batch of bench.py's first metric on the first lanes of its
    starts; in float64 also the lane-0 carry after step 0 and one iteration
    of step 1 from it. With ``noise``, the starts get normal noise of that
    size (``seed``), nothing is saved, and the distance per (lane, step)
    from the committed float64 fixture is printed."""
    jnp = jax.numpy
    f64 = name == "pi_admm"
    dtype = jnp.float64 if f64 else jnp.float32
    b = PI_ADMM
    eng, xts = bench_engine(dtype)
    xts = np.asarray(xts[:PI_ADMM_LANES[name]], np.float64 if f64
                     else np.float32)
    s, v, h = xts.shape[0], b["num_veh"], b["horizon"]
    if noise:
        xts = xts + noise * np.random.default_rng(seed).normal(size=xts.shape)
    t0 = time.perf_counter()
    rec = eng.run_fused_batch(jnp.asarray(xts), jnp.zeros((s, v, h), dtype),
                              b["n_steps"], b["iter_budget"])
    jax.block_until_ready(rec.xt)
    secs = time.perf_counter() - t0
    rec = {k: np.asarray(x) for k, x in rec._asdict().items()}
    hist = np.concatenate([xts[:, None], rec["xt"]], axis=1)[..., :2]
    d = np.linalg.norm(hist[:, :, :, None] - hist[:, :, None], axis=-1)
    min_dist = float((d + 1e9 * np.eye(v)).min())
    if noise:
        ref = np.load(default_out(name))
        err = np.abs(rec["xt"] - ref["xt"][:s]).max(axis=(2, 3))
        capped = int((~rec["converged"]).sum())
        print(json.dumps(dict(
            profile=name, noise=noise, seed=seed, seconds=round(secs, 1),
            iterations=rec["iterations"].tolist(),
            fixture_iterations=ref["iterations"][:s].tolist(),
            max_state_dist_per_step=err.tolist(), capped=capped,
            converged_fraction=1.0 - capped / rec["converged"].size,
            min_distance_m=min_dist, commit=commit)))
        return
    extra = {}
    if f64:
        xt = jnp.asarray(xts[0])
        u = jnp.zeros((v, h), dtype)
        xt1, u1, carry, _ = eng._mpc_step_carry(
            xt, u, eng.init_admm_carry(), jnp.asarray(0, jnp.int32))
        extra.update({f"carry0_{k}": np.asarray(x)
                      for k, x in carry._asdict().items()})
        extra.update(carry0_xt=np.asarray(xt1), carry0_u=np.asarray(u1))
        # one iteration of step 1, as the per-step driver starts it
        u_s = jnp.concatenate([u1[:, 1:], u1[:, -1:]], axis=1)
        c0 = eng._pairwise_carry0(u_s, eng.shift_admm_carry(carry))
        cfg = eng.cfg
        seed = jnp.stack(
            [xt1[:, 0] + cfg.dt * eng.spd * jnp.cos(xt1[:, 2]),
             xt1[:, 1] + cfg.dt * eng.spd * jnp.sin(xt1[:, 2])], axis=1)
        it = jax.jit(lambda c: eng._pairwise_iter(
            xt1, seed, eng._local_affines(xt1),
            eng._ref_window(jnp.asarray(1, jnp.int32)), eng._side_of_map(),
            c))(c0)
        for k, x in it.items():
            if k == "last_hat":               # the iteration's hat again
                continue
            if k == "dual":
                extra.update({f"iter1_{f}": np.asarray(y)
                              for f, y in x._asdict().items()})
            else:
                extra[f"iter1_{k}"] = np.asarray(x)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out, xts0=xts, min_distance_m=np.asarray(min_dist), **rec, **extra,
        profile=np.asarray(json.dumps(dict(b, lanes=s, dtype=str(
            np.dtype(dtype))), sort_keys=True)),
        commit=np.asarray(commit))
    capped = int((~rec["converged"]).sum())
    print(json.dumps(dict(
        out=os.path.relpath(out, ROOT), profile=name, lanes=s,
        seconds=round(secs, 1), iterations=rec["iterations"].tolist()
        if s <= 4 else rec["iterations"].sum(axis=1).tolist(),
        converged_fraction=1.0 - capped / rec["converged"].size,
        capped=capped, min_distance_m=min_dist, commit=commit)))


def spmd_case(name):
    """The JAX planner of ``SPMD_CASES[name]``, its perturbed starts
    ``[S, V, 5]`` (``tests/test_consensus_spmd.py``'s ``_setup``: 0.05 m
    on the positions from ``default_rng(0)``) and the batched ``BarState``.
    A float32 case needs JAX's 64-bit mode off."""
    case = SPMD_CASES[name]
    kw = dict(dict(use_staged=False, edge_mode="joint"),
              **case.get("planner", {}))
    dtype = case.get("dtype", "float64")
    v, n_scen = case["num_veh"], case["n_scen"]
    pl = ConsensusObcaPlanner(
        ObcaConfig(num_veh=v, horizon=case["horizon"],
                   max_admm_iters=case.get("max_admm_iters", 2), rho=100.0),
        scfg=SolverConfig(**case.get("scfg", dict(ip_iters=5, ip_tol=1e-6))),
        dtype=getattr(jax.numpy, dtype), **kw)
    rng = np.random.default_rng(0)
    init = np.broadcast_to(np.asarray(pl.refs[:, 0, :]),
                           (n_scen, v, 5)).copy()
    init[:, :, :2] += 0.05 * rng.normal(size=(n_scen, v, 2))
    bs = jax.tree.map(lambda a: jax.numpy.broadcast_to(a, (n_scen,) + a.shape),
                      pl.create_bar_state())
    return pl, init.astype(dtype), bs


def spmd_outputs(step, init, bs, k):
    """One JAX batched step as a flat dict of numpy arrays (the
    ``BarState`` output field by field)."""
    out = step(jax.numpy.asarray(init), bs, jax.numpy.asarray(k, "int32"))
    flat = {f"out_1_{f}": np.asarray(x) for f, x in out[1]._asdict().items()}
    flat.update({f"out_{i}": np.asarray(x) for i, x in enumerate(out)
                 if i != 1})
    return out, flat


def write_spmd(out, commit):
    from jax.sharding import Mesh
    from dlp_admm_tpu.parallel.consensus_spmd import make_consensus_spmd_step
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                ("scenario", "vehicle"))
    t0 = time.perf_counter()
    arrays = {}
    for name, case in SPMD_CASES.items():
        jax.config.update("jax_enable_x64",
                          case.get("dtype", "float64") == "float64")
        pl, init, bs = spmd_case(name)
        step = make_consensus_spmd_step(pl, mesh)
        res, flat = spmd_outputs(step, init, bs, 0)
        rec = dict(init=init, **{f"bs_{f}": np.asarray(x)
                                 for f, x in bs._asdict().items()}, **flat)
        if name == SPMD_CARRIED:
            _, flat1 = spmd_outputs(step, np.asarray(res[0]), res[1], 1)
            rec.update({f"step1_{k[4:]}": x for k, x in flat1.items()})
        arrays.update({f"{name}__{k}": x for k, x in rec.items()})
        print(json.dumps(dict(case=name, iterations=np.asarray(res[2])
                              .tolist(), converged=np.asarray(res[5])
                              .tolist())), flush=True)
    jax.config.update("jax_enable_x64", True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, **arrays, profile=np.asarray(json.dumps(
        SPMD_CASES, sort_keys=True)), commit=np.asarray(commit))
    print(json.dumps(dict(out=os.path.relpath(out, ROOT), profile="spmd",
                          seconds=round(time.perf_counter() - t0, 1),
                          commit=commit)))


def write_mesh(out, commit):
    from dlp_admm_tpu.parallel.consensus_spmd import make_consensus_spmd_step
    from dlp_admm_tpu.parallel.mesh import planner_mesh
    t0 = time.perf_counter()
    arrays = {}
    for name, n_s, n_v in MESH_CASES:
        pl, init, bs = spmd_case(name)
        step = make_consensus_spmd_step(pl, planner_mesh(n_s, n_v))
        res, flat = spmd_outputs(step, init, bs, 0)
        arrays.update({f"{name}@{n_s}x{n_v}__{k}": x
                       for k, x in flat.items()})
        print(json.dumps(dict(case=name, mesh=[n_s, n_v],
                              iterations=np.asarray(res[2]).tolist())),
              flush=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, **arrays, profile=np.asarray(json.dumps(
        MESH_CASES)), commit=np.asarray(commit))
    print(json.dumps(dict(out=os.path.relpath(out, ROOT), profile="mesh",
                          seconds=round(time.perf_counter() - t0, 1),
                          commit=commit)))


def options_carry():
    """The flagship float64 run's ``(state [V, 5], BarState)`` carry at
    ``OPTIONS["step"]``, step by step through ``_mpc_step_impl``."""
    pl = make_planner("f64")
    step = jax.jit(pl._mpc_step_impl)
    st = jax.numpy.asarray(pl.refs[:, 0, :])
    bs = pl.create_bar_state()
    for k in range(OPTIONS["step"]):
        st, bs = step(st, bs, jax.numpy.asarray(k, "int32"))[:2]
    return np.asarray(st), bs


def options_run(name, state, bs):
    """One run of ``OPTIONS["runs"][name]`` from ``(state, bs)`` at the
    carry's step: ``(flat outputs, states to compare, iterations)``."""
    o = OPTIONS
    prof = PROFILES["f64"]
    pl = ConsensusObcaPlanner(ObcaConfig(**{**prof["ocfg"], **o["ocfg"]}),
                              scfg=SolverConfig(**prof["scfg"]),
                              **prof["planner"], **o["runs"][name])
    k = jax.numpy.asarray(o["step"], "int32")
    if name == "trace":
        c, hist = pl.mpc_step_trace(jax.numpy.asarray(state), bs, k,
                                    o["trace_iters"])
        flat = {"trace__xs": np.asarray(c["xs"]),
                "trace__z_bar": np.asarray(c["bs"].z_bar),
                "trace__d_bar": np.asarray(c["d_bar"])}
        flat.update({f"trace__hist_{h}": np.asarray(x)
                     for h, x in hist.items()})
        return flat, flat["trace__xs"], o["trace_iters"]
    out = jax.jit(pl._mpc_step_impl)(jax.numpy.asarray(state), bs, k)
    flat = {f"{name}__out_1_{f}": np.asarray(x)
            for f, x in out[1]._asdict().items()}
    flat.update({f"{name}__out_{i}": np.asarray(x) for i, x in
                 enumerate(out) if i != 1})
    return flat, flat[f"{name}__out_0"], int(out[2])


def write_options(out, commit):
    o = OPTIONS
    t0 = time.perf_counter()
    state, bs = options_carry()
    arrays = dict(carry_state=state, **{f"carry_bs_{f}": np.asarray(x)
                                        for f, x in bs._asdict().items()})
    for name in o["runs"]:
        flat, states, its = options_run(name, state, bs)
        chaotic = False
        for sd in o["chaos_seeds"]:
            moved = state + o["chaos_noise"] * np.random.default_rng(
                sd).normal(size=state.shape)
            _, m_states, m_its = options_run(name, moved, bs)
            chaotic |= bool(m_its != its or np.abs(
                m_states - states).max() > o["chaos_tol"])
        arrays.update(flat, **{f"{name}__chaotic": np.asarray(chaotic)})
        print(json.dumps(dict(run=name, iterations=its, chaotic=chaotic)),
              flush=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, **arrays, profile=np.asarray(json.dumps(
        dict(o, planner=PROFILES["f64"]), sort_keys=True)),
        commit=np.asarray(commit))
    print(json.dumps(dict(out=os.path.relpath(out, ROOT), profile="options",
                          seconds=round(time.perf_counter() - t0, 1),
                          commit=commit)))


def batch_starts(pl):
    """bench.py:249-255: the flagship's start plus 0.25 m jitter on every
    lane's positions but lane 0's, ``[16, 2, 5]``."""
    b = BATCH
    init0 = np.asarray(pl.refs[:, 0, :])
    inits = np.broadcast_to(init0, (b["n_scen"],) + init0.shape).copy()
    pert = b["jitter"] * np.random.default_rng(b["seed"]).normal(
        size=(b["n_scen"], 2, 2))
    pert[0] = 0.0
    inits[:, :, :2] += pert
    return inits


def write_batch(out, commit, noise=0.0, seed=0):
    """JAX's ``run_scenario_batch`` of bench.py's third metric over the
    first ``BATCH["steps"]`` steps. With ``noise``, the starts are moved by
    normal noise of that size (``seed``), nothing is saved and the
    distances per (lane, step) from the committed fixture are printed;
    without, the file gets ``chaotic_from`` from the runs moved by
    ``chaos_noise`` (``chaos_seeds``)."""
    from dlp_admm_tpu.parallel.consensus_spmd import run_scenario_batch
    b = BATCH
    pl = make_planner("f64")
    inits = batch_starts(pl)

    def run(start):
        t0 = time.perf_counter()
        res = run_scenario_batch(pl, start, b["steps"])
        return [np.asarray(x) for x in res], time.perf_counter() - t0

    def parting(res, ref_states, ref_its):
        """Per lane, the first step at which ``res`` is more than
        ``chaos_tol`` from the reference run or takes other iterations."""
        err = np.abs(res[0][1:] - ref_states[1:]).max(axis=(2, 3)).T
        bad = (err > b["chaos_tol"]) | (res[1] != ref_its)
        first = np.where(bad.any(axis=1), bad.argmax(axis=1), b["steps"])
        return first, err

    if noise:
        ref = np.load(default_out("batch"))
        moved = inits + noise * np.random.default_rng(seed).normal(
            size=inits.shape)
        res, secs = run(moved)
        first, err = parting(res, ref["states"], ref["iterations"])
        print(json.dumps(dict(
            profile="batch", noise=noise, seed=seed, seconds=round(secs, 1),
            iterations=res[1].tolist(),
            fixture_iterations=ref["iterations"].tolist(),
            max_state_dist_per_step=err.tolist(),
            parts_from=first.tolist(), commit=commit)))
        return
    res, secs = run(inits)
    states, its, prs, dus, cvs, gaps = res
    chaotic = np.full(b["n_scen"], b["steps"])
    for sd in b["chaos_seeds"]:
        moved = inits + b["chaos_noise"] * np.random.default_rng(sd).normal(
            size=inits.shape)
        first, _ = parting(run(moved)[0], states, its)
        chaotic = np.minimum(chaotic, first)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out, states=states, iterations=its, primal=prs, dual=dus,
        converged=cvs, gaps=gaps, chaotic_from=chaotic,
        profile=np.asarray(json.dumps(b, sort_keys=True)),
        commit=np.asarray(commit))
    p = states[..., :2]
    print(json.dumps(dict(
        out=os.path.relpath(out, ROOT), profile="batch",
        steps=b["steps"], seconds=round(secs, 1), iterations=its.tolist(),
        chaotic_from=chaotic.tolist(),
        res_ok=int(((prs <= 0.01) & (dus <= 0.01)).sum()),
        min_distance_m=float(np.linalg.norm(p[:, :, 0] - p[:, :, 1],
                                            axis=-1).min()),
        gap_median=float(np.median(gaps)), commit=commit)))


def moved_starts(inits, noise, seed):
    """The batch's starts ``inits`` with normal noise of size ``noise`` on
    every entry, drawn from ``default_rng(seed)`` in float64, as
    :func:`write_batch` moves them (``tools/perturbed_torch_batch.py``
    moves the port's so)."""
    if not noise:
        return inits
    return inits + noise * np.random.default_rng(seed).normal(
        size=inits.shape)


def write_batch_f32(out, commit, steps=None, noise=0.0, seed=0):
    """JAX's float32 ``run_scenario_batch`` of bench.py's third metric,
    whole (16 lanes x 2 vehicles x 20 steps, ``bench.py:248-283``), on the
    CPU: the record ``chip_smoke.py --full-batch`` prints beside the port's
    float32 batch (``JAX_BATCH_F32_CPU``). Prints res_ok against bench.py's
    gate (0.01 residuals, 272 of 320) and per lane, the steps at the ADMM
    cap, the smallest centre distance and the median consensus gap;
    ``--out`` keeps the run (each lane's states, iterations and residuals).
    With ``noise``, the starts are moved as :func:`moved_starts` moves
    them."""
    from dlp_admm_tpu.parallel.consensus_spmd import run_scenario_batch
    steps = steps or BATCH_F32_STEPS
    pl = make_planner("f32")
    inits = moved_starts(batch_starts(pl), noise, seed)
    t0 = time.perf_counter()
    states, its, prs, dus, cvs, gaps = [np.asarray(x) for x in
                                        run_scenario_batch(pl, inits, steps)]
    secs = time.perf_counter() - t0
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.savez_compressed(
            out, states=states, iterations=its, primal=prs, dual=dus,
            converged=cvs, gaps=gaps, starts=inits,
            profile=np.asarray(json.dumps(
                dict(BATCH, planner=PROFILES["f32"], steps=steps,
                     noise=noise, noise_seed=seed), sort_keys=True)),
            commit=np.asarray(commit))
    p = states[..., :2]
    ok = (prs <= 0.01) & (dus <= 0.01)
    at_cap = its >= PROFILES["f32"]["ocfg"]["max_admm_iters"]
    print(json.dumps(dict(
        out=os.path.relpath(out, ROOT) if out else None, profile="batch_f32",
        noise=noise, seed=seed,
        steps=steps, lanes=int(its.size), seconds=round(secs, 1),
        res_ok=int(ok.sum()), steps_at_cap=int(at_cap.sum()),
        min_distance_m=float(np.linalg.norm(p[:, :, 0] - p[:, :, 1],
                                            axis=-1).min()),
        gap_median=float(np.median(gaps)),
        lane_res_ok=ok.sum(axis=1).tolist(),
        lane_steps_at_cap=at_cap.sum(axis=1).tolist(), iterations=its.tolist(),
        commit=commit)))


def _parting(states, its, ref_states, ref_its, tol, n):
    """The first step at which a run is more than ``tol`` from the
    reference run or takes other iteration counts (``n`` where never)."""
    err = np.abs(np.asarray(states) - np.asarray(ref_states)).reshape(
        len(its), -1).max(axis=1)
    bad = (err > tol) | (np.asarray(its) != np.asarray(ref_its))
    return (int(bad.argmax()) if bad.any() else n), err


def _dual_cfg(kw):
    from dlp_admm_tpu.config import DualStrategy, DualUpdateConfig, WindupMode
    kw = dict(kw)
    kw["strategy"] = DualStrategy[kw["strategy"]]
    kw["windup"] = WindupMode[kw["windup"]]
    return DualUpdateConfig(**kw)


def classic_qp_case(v, seed):
    """Numpy-seeded inputs of one joint edge QP at ``v`` vehicles: the
    2-vehicle case of ``tests/test_pi_admm.py::TestJointEdgeQp`` and a
    3-vehicle crossing in the same manner."""
    from dlp_admm_tpu.config import PiAdmmConfig
    cfg = PiAdmmConfig(num_veh=v, speeds=(4.0, 8.0, 4.0)[:v])
    h, p = cfg.horizon, v * (v - 1) // 2
    rng = np.random.default_rng(seed)
    xt = np.array([[-1.0, 0.0, 0.1], [0.5, 2.0, -1.4], [2.0, 1.0, 3.0]])[:v]
    return cfg, dict(xt=xt, spd=np.asarray(cfg.speeds),
                     pos_old=rng.normal(size=(v, 2 * (h + 1))),
                     dual=0.1 * rng.normal(size=(v, 2 * (h + 1))),
                     last_dis=rng.normal(size=(p, 2)),
                     u0=0.1 * rng.normal(size=(v, h)))


def write_classic(out, commit, noise=0.0, seed=0):
    """The classic layout's default run, its chaotic step, the two A/Bs and
    the joint edge QP cases. With ``noise``, only the default run from a
    moved start, printed against the committed fixture."""
    from dlp_admm_tpu.config import (DualUpdateConfig, PiAdmmConfig,
                                     SolverConfig)
    from dlp_admm_tpu.models.pi_admm import (PiAdmmEngine,
                                             _solve_joint_edge_qp)
    from dlp_admm_tpu.scenarios import pi_admm_initial_states
    b = CLASSIC
    cfg = PiAdmmConfig()
    xt0 = np.asarray(pi_admm_initial_states(cfg))

    def run(start, cfg=cfg, dual=DualUpdateConfig(), scfg=SolverConfig()):
        t0 = time.perf_counter()
        rec = PiAdmmEngine(cfg, dual, scfg, layout="classic").run(xt0=start)
        return ({k: np.asarray(x) for k, x in rec._asdict().items()},
                time.perf_counter() - t0)

    n = cfg.n_mpc_steps
    if noise:
        ref = np.load(default_out("classic"))
        rec, secs = run(xt0 + noise * np.random.default_rng(seed).normal(
            size=xt0.shape))
        first, err = _parting(rec["xt"], rec["iterations"], ref["xt"],
                              ref["iterations"], b["chaos_tol"], n)
        print(json.dumps(dict(
            profile="classic", noise=noise, seed=seed, seconds=round(secs, 1),
            iterations=rec["iterations"].tolist(),
            fixture_iterations=ref["iterations"].tolist(),
            max_state_dist_per_step=err.tolist(), parts_from=first,
            commit=commit)))
        return
    rec, secs = run(xt0)
    chaotic = n
    for sd in b["chaos_seeds"]:
        moved, _ = run(xt0 + b["chaos_noise"] * np.random.default_rng(
            sd).normal(size=xt0.shape))
        chaotic = min(chaotic, _parting(moved["xt"], moved["iterations"],
                                        rec["xt"], rec["iterations"],
                                        b["chaos_tol"], n)[0])
    ab_scfg = SolverConfig(**b["ab_solver"])
    ab = {name: run(xt0, dual=_dual_cfg(b[f"ab_{name}"]), scfg=ab_scfg)[0]
          for name in ("pi", "plain")}
    sig_cfg = PiAdmmConfig(**b["sig_cfg"])
    sig = {name: run(pi_admm_initial_states(sig_cfg), cfg=sig_cfg,
                     dual=_dual_cfg(b[f"sig_{name}"]), scfg=ab_scfg)[0]
           for name in ("pi", "plain")}
    extra = {}
    for name, r in list(ab.items()) + [(f"sig_{k}", r)
                                       for k, r in sig.items()]:
        key = name if name.startswith("sig") else f"ab_{name}"
        extra[f"{key}_xt"] = r["xt"]
        extra[f"{key}_iterations"] = r["iterations"]
    for v in (2, 3):
        qcfg, inp = classic_qp_case(v, b["qp_seed"])
        jnp = jax.numpy
        outs = _solve_joint_edge_qp(
            *(jnp.asarray(inp[k]) for k in ("xt", "spd", "pos_old", "dual",
                                            "last_dis", "u0")),
            qcfg, SolverConfig(**b["qp_solver"]))
        extra.update({f"qp_{v}_in_{k}": x for k, x in inp.items()})
        extra.update({f"qp_{v}_out_{k}": np.asarray(x) for k, x in zip(
            ("u", "hat", "converged", "y"), outs)})
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, xt0=xt0, **rec, chaotic_from=np.asarray(chaotic),
                        **extra,
                        profile=np.asarray(json.dumps(b, sort_keys=True)),
                        commit=np.asarray(commit))
    d = np.linalg.norm(rec["xt"][:, 0, :2] - rec["xt"][:, 1, :2], axis=-1)
    print(json.dumps(dict(
        out=os.path.relpath(out, ROOT), profile="classic",
        seconds=round(secs, 1), iterations=rec["iterations"].tolist(),
        sum_iter_num=int(rec["iterations"].sum()), chaotic_from=chaotic,
        min_distance_m=float(d.min()),
        ab_sum_iter_num={k: int(r["iterations"].sum()) for k, r in ab.items()},
        sig_sum_iter_num={k: int(r["iterations"].sum())
                          for k, r in sig.items()},
        commit=commit)))


def _centralized(prof, refs=None, **kw):
    from dlp_admm_tpu.config import VehicleConfig
    from dlp_admm_tpu.models.obca import CentralizedObcaPlanner
    return CentralizedObcaPlanner(ObcaConfig(**prof["ocfg"]), VehicleConfig(),
                                  SolverConfig(**prof.get("scfg", {})),
                                  refs=refs, **kw)


def write_centralized(out, commit, noise=0.0, seed=0):
    """``run_obca(Formulation.CENTRALIZED)``'s run, its chaotic step, staged
    and dense ``solve_at`` and the parity oracle's centralized run. With
    ``noise``, only the run with the references moved, printed against the
    committed fixture."""
    b = CENTRALIZED
    pl = _centralized(b)
    refs = np.asarray(pl.refs)

    def run(r):
        t0 = time.perf_counter()
        states, ctrls, infos = _centralized(b, refs=r).run(b["steps"])
        return (np.asarray(states), np.asarray(ctrls),
                np.asarray([i["iters"] for i in infos]),
                np.asarray([i["kkt"] for i in infos]),
                np.asarray([i["converged"] for i in infos]),
                time.perf_counter() - t0)

    def moved(sd, eps):
        return refs + eps * np.random.default_rng(sd).normal(size=refs.shape)

    if noise:
        ref = np.load(default_out("centralized"))
        states, _, its, _, _, secs = run(moved(seed, noise))
        first, err = _parting(states[1:], its, ref["states"][1:],
                              ref["iterations"], b["chaos_tol"], b["steps"])
        print(json.dumps(dict(
            profile="centralized", noise=noise, seed=seed,
            seconds=round(secs, 1), iterations=its.tolist(),
            fixture_iterations=ref["iterations"].tolist(),
            max_state_dist_per_step=err.tolist(), parts_from=first,
            commit=commit)))
        return
    states, ctrls, its, kkts, cvs, secs = run(refs)
    chaotic = b["steps"]
    for sd in b["chaos_seeds"]:
        st2, _, its2, _, _, _ = run(moved(sd, b["chaos_noise"]))
        chaotic = min(chaotic, _parting(st2[1:], its2, states[1:], its,
                                        b["chaos_tol"], b["steps"])[0])
    extra = {}
    for k in b["solve_steps"]:
        xs, _, _, sol = pl.solve_at(states[k], k)
        extra.update({f"staged_{k}_x": np.asarray(sol.x),
                      f"staged_{k}_iterations": np.asarray(sol.iterations),
                      f"staged_{k}_kkt": np.asarray(sol.kkt_error),
                      f"staged_{k}_converged": np.asarray(sol.converged)})
    xs, _, _, sol = _centralized(b, use_staged=False).solve_at(states[0], 0)
    extra.update(dense_0_x=np.asarray(sol.x),
                 dense_0_iterations=np.asarray(sol.iterations),
                 dense_0_kkt=np.asarray(sol.kkt_error),
                 dense_0_converged=np.asarray(sol.converged))
    o = b["oracle"]
    t0 = time.perf_counter()
    o_states, _, _, o_its, o_cv = _centralized(
        o, warm_mode=o["warm_mode"]).run_scan(n_steps=o["steps"])
    o_secs = time.perf_counter() - t0
    extra.update(oracle_states=np.asarray(o_states),
                 oracle_iterations=np.asarray(o_its),
                 oracle_converged=np.asarray(o_cv))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, states=states, controls=ctrls, iterations=its,
                        kkt=kkts, converged=cvs,
                        chaotic_from=np.asarray(chaotic), **extra,
                        profile=np.asarray(json.dumps(b, sort_keys=True)),
                        commit=np.asarray(commit))
    p = states[..., :2]
    print(json.dumps(dict(
        out=os.path.relpath(out, ROOT), profile="centralized",
        seconds=round(secs, 1), iterations=its.tolist(),
        converged=int(cvs.sum()), chaotic_from=chaotic,
        min_center_distance_m=float(np.linalg.norm(p[:, 0] - p[:, 1],
                                                   axis=-1).min()),
        solve_at_iterations={k: int(extra[f"staged_{k}_iterations"])
                             for k in b["solve_steps"]},
        dense_iterations=int(extra["dense_0_iterations"]),
        oracle_seconds=round(o_secs, 1),
        oracle_converged=int(np.sum(o_cv)), commit=commit)))


def write_centralized_v4(out, commit):
    """One staged ``solve_at`` of the joint NLP at step 0 with 3 and with 4
    vehicles."""
    b = CENTRALIZED_V4
    extra = {}
    for v, iters in b["ip_iters"].items():
        pl = _centralized(dict(ocfg=dict(b["ocfg"], num_veh=v),
                               scfg=dict(ip_iters=iters)))
        t0 = time.perf_counter()
        xs, _, _, sol = pl.solve_at(pl.refs[:, 0, :], 0)
        extra.update({f"v{v}_x": np.asarray(sol.x),
                      f"v{v}_states": np.asarray(xs),
                      f"v{v}_iterations": np.asarray(sol.iterations),
                      f"v{v}_kkt": np.asarray(sol.kkt_error),
                      f"v{v}_converged": np.asarray(sol.converged),
                      f"v{v}_seconds": np.asarray(time.perf_counter() - t0)})
    m = b["moved"]
    pl = _centralized(dict(ocfg=dict(b["ocfg"], num_veh=4),
                           scfg=dict(ip_iters=m["ip_iters"])))
    moved = []
    for sd in m["seeds"]:
        init = np.asarray(pl.refs[:, 0, :])
        init = init + m["noise"] * np.random.default_rng(sd).normal(
            size=init.shape)
        xs, _, _, sol = pl.solve_at(init, 0)
        moved.append((int(sol.iterations), bool(sol.converged),
                      float(np.abs(np.asarray(xs)
                                   - extra["v4_states"]).max())))
    extra.update(v4_moved_iterations=np.asarray([r[0] for r in moved]),
                 v4_moved_converged=np.asarray([r[1] for r in moved]),
                 v4_moved_state_err=np.asarray([r[2] for r in moved]))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, **extra,
                        profile=np.asarray(json.dumps(
                            {k: v if k != "ip_iters" else {str(a): c for a, c
                                                           in v.items()}
                             for k, v in b.items()}, sort_keys=True)),
                        commit=np.asarray(commit))
    print(json.dumps(dict(
        out=os.path.relpath(out, ROOT), profile="centralized_v4",
        **{k: (x.tolist() if x.ndim == 0 else None) for k, x in extra.items()
           if x.ndim == 0}, commit=commit)))


def _fixed_dual(name, steps, refs=None, n_rounds=None, num_veh=None):
    """One JAX run of the fixed-dual planner ``name`` with the driver's
    defaults: ``(states [n+1, V, 5], elastic [n], dual_kkt [n], seconds)``."""
    from dlp_admm_tpu.config import VehicleConfig
    from dlp_admm_tpu.models import bilevel
    b = BILEVEL
    ocfg = ObcaConfig(**(b["v4"]["ocfg"] if num_veh else b["ocfg"]))
    scfg = SolverConfig(**b["scfg"])
    if name == "bilevel":
        pl = bilevel.BilevelObcaPlanner(
            ocfg, VehicleConfig(), scfg, refs=refs,
            n_rounds=n_rounds or b["n_rounds"])
    else:
        cls = (bilevel.TighteningSlackObcaPlanner
               if name == "tightening_slack"
               else bilevel.TighteningObcaPlanner)
        pl = cls(ocfg, VehicleConfig(T=7.0, prob=0.99), scfg, refs=refs)
    t0 = time.perf_counter()
    states, infos = pl.run(n_steps=steps)
    return (np.asarray(states),
            np.asarray([float(i["elastic"]) for i in infos]),
            np.asarray([float(i["dual_kkt"]) for i in infos]),
            time.perf_counter() - t0, np.asarray(pl.refs))


def write_bilevel(out, commit):
    """The fixed-dual family's driver runs (``<planner>_*``) with their
    chaotic steps, ``tests/test_bilevel.py``'s 12-step bilevel run
    (``test_bilevel_*``; the tightening tests' 12 steps are the first 12
    of the driver runs) and the 4-vehicle tightening (``v4_*``)."""
    b = BILEVEL
    extra, summary = {}, {}
    for name in b["planners"]:
        states, el, kkt, secs, refs = _fixed_dual(name, None)
        n = len(el)
        chaotic = n
        for sd in b["chaos_seeds"]:
            moved = refs + b["chaos_noise"] * np.random.default_rng(
                sd).normal(size=refs.shape)
            st2 = _fixed_dual(name, None, refs=moved)[0]
            chaotic = min(chaotic, _parting(st2[1:], np.zeros(n), states[1:],
                                            np.zeros(n), b["chaos_tol"], n)[0])
        d = np.linalg.norm(states[:, 0, :2] - states[:, 1, :2], axis=-1)
        extra.update({f"{name}_states": states, f"{name}_elastic": el,
                      f"{name}_dual_kkt": kkt,
                      f"{name}_chaotic_from": np.asarray(chaotic)})
        summary[name] = dict(steps=n, seconds=round(secs, 1),
                             chaotic_from=chaotic,
                             min_center_distance_m=float(d.min()))
    for key, name, kw in (
            ("test_bilevel", "bilevel", dict(n_rounds=b["test_n_rounds"])),
            ("v4", "tightening", dict(num_veh=4))):
        steps = b["v4"]["steps"] if key == "v4" else b["test_steps"]
        states, el, kkt, secs, refs = _fixed_dual(name, steps, **kw)
        chaotic = steps
        for sd in b["chaos_seeds"]:
            moved = refs + b["chaos_noise"] * np.random.default_rng(
                sd).normal(size=refs.shape)
            st2 = _fixed_dual(name, steps, refs=moved, **kw)[0]
            chaotic = min(chaotic, _parting(
                st2[1:], np.zeros(steps), states[1:], np.zeros(steps),
                b["chaos_tol"], steps)[0])
        extra.update({f"{key}_states": states, f"{key}_elastic": el,
                      f"{key}_dual_kkt": kkt,
                      f"{key}_chaotic_from": np.asarray(chaotic)})
        summary[key] = dict(steps=steps, seconds=round(secs, 1),
                            chaotic_from=chaotic)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(out, **extra,
                        profile=np.asarray(json.dumps(b, sort_keys=True)),
                        commit=np.asarray(commit))
    print(json.dumps(dict(out=os.path.relpath(out, ROOT), profile="bilevel",
                          **summary, commit=commit)))


def _aladin_run(scfg, steps, xt0=None):
    """The JAX ALADIN crossing, ``AladinUnicyclePlanner.run``'s loop from
    ``xt0`` (its own start where None): ``(states, iterations, seconds)``."""
    import jax.numpy as jnp
    from dlp_admm_tpu.config import PiAdmmConfig
    from dlp_admm_tpu.models.aladin import AladinUnicyclePlanner
    from dlp_admm_tpu.scenarios import pi_admm_initial_states
    cfg = PiAdmmConfig()
    pl = AladinUnicyclePlanner(cfg, scfg=SolverConfig(**scfg))
    xt = jnp.asarray(pi_admm_initial_states(cfg) if xt0 is None else xt0)
    u = jnp.zeros((pl.v, pl.h))
    states, iters = [np.asarray(xt)], []
    t0 = time.perf_counter()
    for k in range(steps):
        xt, u, it = pl.mpc_step(xt, u, k)
        u = jnp.concatenate([u[:, 1:], u[:, -1:]], axis=1)
        states.append(np.asarray(xt))
        iters.append(it)
    return np.stack(states), np.asarray(iters), time.perf_counter() - t0


def write_aladin(out, commit, noise=0.0, seed=0):
    """The ALADIN crossing (``states``, ``iterations``) with its chaotic
    step and the moved runs' totals, and ``run_obca(Formulation.ALADIN)``'s
    dispatch run (``dispatch_*``). With ``noise``, only the crossing from a
    moved start, printed against the committed fixture."""
    from dlp_admm_tpu.config import Formulation, PiAdmmConfig
    from dlp_admm_tpu.mpc.driver import run_obca
    from dlp_admm_tpu.scenarios import pi_admm_initial_states
    b = ALADIN
    xt0 = np.asarray(pi_admm_initial_states(PiAdmmConfig()))
    n = b["steps"]
    if noise:
        ref = np.load(default_out("aladin"))
        st2, its2, secs = _aladin_run(
            b["scfg"], n, xt0 + noise * np.random.default_rng(seed).normal(
                size=xt0.shape))
        first, err = _parting(st2[1:], its2, ref["states"][1:],
                              ref["iterations"], b["chaos_tol"], n)
        print(json.dumps(dict(
            profile="aladin", noise=noise, seed=seed, seconds=round(secs, 1),
            iterations=its2.tolist(), total_iterations=int(its2.sum()),
            min_distance_m=float(np.linalg.norm(
                st2[:, 0, :2] - st2[:, 1, :2], axis=-1).min()),
            parts_from=first, commit=commit)))
        return
    states, its, secs = _aladin_run(b["scfg"], b["steps"])
    chaotic = n
    moved_runs = []
    for sd in b["chaos_seeds"]:
        st2, its2, _ = _aladin_run(
            b["scfg"], n, xt0 + b["chaos_noise"] * np.random.default_rng(
                sd).normal(size=xt0.shape))
        chaotic = min(chaotic, _parting(st2[1:], its2, states[1:], its,
                                        b["chaos_tol"], n)[0])
        moved_runs.append(dict(
            total_iterations=int(its2.sum()),
            min_distance_m=float(np.linalg.norm(
                st2[:, 0, :2] - st2[:, 1, :2], axis=-1).min())))
    dsp = run_obca(Formulation.ALADIN, n_steps=b["dispatch"]["steps"],
                   scfg=SolverConfig(**b["dispatch"]["scfg"]))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out, states=states, iterations=its, chaotic_from=np.asarray(chaotic),
        moved_total_iterations=np.asarray(
            [r["total_iterations"] for r in moved_runs]),
        moved_min_distance_m=np.asarray(
            [r["min_distance_m"] for r in moved_runs]),
        dispatch_states=np.asarray(dsp.states),
        dispatch_iterations=np.asarray(dsp.extras["iterations"]),
        profile=np.asarray(json.dumps(b, sort_keys=True)),
        commit=np.asarray(commit))
    d = np.linalg.norm(states[:, 0, :2] - states[:, 1, :2], axis=-1)
    print(json.dumps(dict(
        out=os.path.relpath(out, ROOT), profile="aladin",
        seconds=round(secs, 1), iterations=its.tolist(),
        total_iterations=int(its.sum()), chaotic_from=chaotic,
        min_distance_m=float(d.min()), moved_runs=moved_runs,
        commit=commit)))


def _checkpoint_case(name, d):
    """One case of ``CHECKPOINT``: the uninterrupted run and the step
    ``ckpt_at`` checkpoint of the JAX planner, as ``{key: array}``."""
    import jax.numpy as jnp
    from dlp_admm_tpu.config import DualUpdateConfig, PiAdmmConfig
    from dlp_admm_tpu.models.aladin import AladinEngine, AladinProblem
    from dlp_admm_tpu.models.bilevel import BilevelObcaPlanner
    from dlp_admm_tpu.models.pi_admm import PiAdmmEngine
    c = CHECKPOINT[name]
    path = os.path.join(d, f"{name}.npz")
    out = {}
    if name == "consensus":
        pl = ConsensusObcaPlanner(ObcaConfig(**c["ocfg"]),
                                  scfg=SolverConfig(**c["scfg"]))
        states, its, _, _ = pl.run(n_steps=c["steps"])
        pl.run(n_steps=c["ckpt_at"], checkpoint_path=path)
        out.update(states=states, iterations=its)
    elif name == "bilevel":
        pl = BilevelObcaPlanner(ObcaConfig(**c["ocfg"]),
                                scfg=SolverConfig(**c["scfg"]),
                                n_rounds=c["n_rounds"])
        states, _ = pl.run(n_steps=c["steps"])
        pl.run(n_steps=c["ckpt_at"], checkpoint_path=path)
        out.update(states=states)
    elif name == "aladin":
        prob = AladinProblem(
            f=lambda y, p: jnp.sum((y - p) ** 2),
            h=lambda y, p: jnp.zeros((0,), y.dtype),
            a_mats=jnp.asarray(np.asarray(c["a_mats"])),
            b=jnp.zeros(1))
        eng = AladinEngine(prob, rho=c["rho"], mu=c["mu"],
                           scfg=SolverConfig(**c["scfg"]))
        targets = jnp.asarray(np.asarray(c["targets"]))
        x0 = jnp.zeros(targets.shape)
        st, ys = eng.run(x0, targets, n_iters=c["steps"], tol=None)
        eng.run(x0, targets, n_iters=c["ckpt_at"], tol=None,
                checkpoint_path=path)
        out.update(x=np.asarray(st.x), lam=np.asarray(st.lam),
                   ys=np.asarray(ys))
    else:
        eng = PiAdmmEngine(PiAdmmConfig(**c["cfg"]), DualUpdateConfig(),
                           SolverConfig(**c["scfg"]), layout=c["layout"],
                           **c["engine"])
        xt0 = np.asarray(c["xt0"])
        rec = eng.run(xt0=xt0, n_steps=c["steps"])
        eng.run(xt0=xt0, n_steps=c["ckpt_at"], checkpoint_path=path)
        out.update(states=np.asarray(rec.xt),
                   iterations=np.asarray(rec.iterations))
    data = np.load(path)
    with open(path + ".tree") as f:
        tree = json.load(f)
    for i in range(tree["n_leaves"]):
        out[f"leaf_{i}"] = data[f"leaf_{i}"]
    out.update(n_leaves=np.asarray(tree["n_leaves"]),
               treedef=np.asarray(tree["treedef"]),
               step=data["__step__"])
    return {f"{name}__{k}": np.asarray(v) for k, v in out.items()}


def write_checkpoint(out, commit):
    """Every case of ``CHECKPOINT`` (see the module doc)."""
    import tempfile
    t0 = time.perf_counter()
    arrays = {}
    with tempfile.TemporaryDirectory() as d:
        for name in CHECKPOINT:
            arrays.update(_checkpoint_case(name, d))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out, **arrays,
        profile=np.asarray(json.dumps(CHECKPOINT, sort_keys=True)),
        commit=np.asarray(commit))
    print(json.dumps(dict(
        out=os.path.relpath(out, ROOT), profile="checkpoint",
        seconds=round(time.perf_counter() - t0, 1),
        n_leaves={n: int(arrays[f"{n}__n_leaves"]) for n in CHECKPOINT},
        commit=commit)))


def thomas_f64_host(diag, upper, rhs):
    """The block-Thomas recursion of ``dlp_admm_tpu/solvers/ip_staged.py``
    (``block_thomas_solve``) in float64 on the host, one
    ``np.linalg.solve`` a stage: ``diag [..., T, B, B]``, ``upper [...,
    T or T-1, B, B]``, ``rhs [..., T, B]`` (leading axes broadcast, as
    ``jax.pure_callback``'s ``expand_dims`` batching passes them) ->
    ``[..., T, B]`` float64."""
    d = np.asarray(diag, np.float64)
    u = np.asarray(upper, np.float64)
    r = np.asarray(rhs, np.float64)
    t, b = r.shape[-2:]
    lead = np.broadcast_shapes(d.shape[:-3], u.shape[:-3], r.shape[:-2])
    d = np.broadcast_to(d, lead + d.shape[-3:])
    u = np.broadcast_to(u, lead + u.shape[-3:])[..., :t - 1, :, :]
    r = np.broadcast_to(r, lead + (t, b))
    zero = np.zeros(lead + (b, b))
    xs, ys = [], []
    x_prev, y_prev, u_prev = zero, np.zeros(lead + (b,)), zero
    for k in range(t):
        u_k = u[..., k, :, :] if k < t - 1 else zero
        ut = np.swapaxes(u_prev, -1, -2)
        c_k = d[..., k, :, :] - ut @ x_prev
        g_k = r[..., k, :] - (ut @ y_prev[..., None])[..., 0]
        sol = np.linalg.solve(c_k, np.concatenate([u_k, g_k[..., None]],
                                                   axis=-1))
        x_prev, y_prev, u_prev = sol[..., :b], sol[..., b], u_k
        xs.append(x_prev)
        ys.append(y_prev)
    z = np.zeros(lead + (b,))
    out = [None] * t
    for k in reversed(range(t)):
        z = ys[k] - (xs[k] @ z[..., None])[..., 0]
        out[k] = z
    return np.stack(out, axis=-2)


def stage_solve_f64(diag, upper, rhs):
    """A stand-in for ``dlp_admm_tpu.solvers.ip_staged.block_thomas_solve``
    that solves in float64: ``(diag, upper, rhs)`` raised to float64 on the
    host (:func:`thomas_f64_host`) through ``jax.pure_callback``, the result
    cast back to ``rhs``'s type. It traces with JAX's 64-bit mode off,
    under ``jit``, ``vmap`` and the planner's ``while_loop``."""
    def host(d, u, r):
        return thomas_f64_host(d, u, r).astype(r.dtype)
    return jax.pure_callback(host, jax.ShapeDtypeStruct(rhs.shape, rhs.dtype),
                             diag, upper, rhs, vmap_method="expand_dims")


def use_stage_f64():
    """Every KKT solve of JAX's staged solver (the solve and both
    refinements; the verification stays JAX's own) through
    :func:`stage_solve_f64`. Call before the planner is first traced."""
    from dlp_admm_tpu.solvers import ip_staged
    ip_staged.block_thomas_solve = stage_solve_f64


def moved_bar_state(bs, noise, seed):
    """The start ``bs`` with normal noise of size ``noise`` on ``z_bar``,
    drawn from ``default_rng(seed)`` in float64 and rounded to the state's
    type (``tools/perturbed_torch_flagship.py`` moves the port's so)."""
    eps = noise * np.random.default_rng(seed).normal(size=bs.z_bar.shape)
    return bs._replace(z_bar=bs.z_bar + eps.astype(bs.z_bar.dtype))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", choices=sorted(PROFILES) + sorted(
        PI_ADMM_LANES) + ["batch", "batch_f32", "spmd", "classic",
                          "centralized",
                          "centralized_v4", "bilevel", "aladin",
                          "checkpoint", "mesh", "options"],
                    default="f64")
    ap.add_argument("--steps", type=int, default=None,
                    help="MPC steps (default: the whole 42-step run)")
    ap.add_argument("--out", default=None,
                    help="default: tests/data/consensus_obca_<profile>_ref.npz"
                         " (nothing with --noise)")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="size of the normal noise added to the starting z_bar")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stage-f64", action="store_true",
                    help="f32: every KKT solve of the staged solver in "
                         "float64 on the host (stage_solve_f64)")
    args = ap.parse_args()
    if args.stage_f64 and args.profile != "f32":
        ap.error("--stage-f64 serves the f32 profile")
    if not args.noise and not args.stage_f64 and args.profile != "batch_f32":
        args.out = args.out or default_out(args.profile)
    jax.config.update("jax_enable_x64",
                      args.profile not in ("f32", "pi_admm_f32", "batch_f32"))
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    if args.profile == "v4":
        return write_v4(args.out, commit)
    if args.profile == "v9":
        return write_v9(args.out, commit)
    if args.profile == "batch":
        return write_batch(args.out, commit, args.noise, args.seed)
    if args.stage_f64:
        use_stage_f64()
    if args.profile == "batch_f32":
        return write_batch_f32(args.out, commit, args.steps, args.noise,
                               args.seed)
    if args.profile == "spmd":
        return write_spmd(args.out, commit)
    if args.profile == "classic":
        return write_classic(args.out, commit, args.noise, args.seed)
    if args.profile == "centralized":
        return write_centralized(args.out, commit, args.noise, args.seed)
    if args.profile == "centralized_v4":
        return write_centralized_v4(args.out, commit)
    if args.profile == "bilevel":
        return write_bilevel(args.out, commit)
    if args.profile == "aladin":
        return write_aladin(args.out, commit, args.noise, args.seed)
    if args.profile == "checkpoint":
        return write_checkpoint(args.out, commit)
    if args.profile == "mesh":
        return write_mesh(args.out, commit)
    if args.profile == "options":
        return write_options(args.out, commit)
    if args.profile in PI_ADMM_LANES:
        return write_pi_admm(args.profile, args.out, commit, args.noise,
                             args.seed)
    t0 = time.perf_counter()
    planner = make_planner(args.profile)
    if args.noise:
        bs0 = moved_bar_state(planner.create_bar_state(), args.noise,
                              args.seed)
        planner.create_bar_state = lambda: bs0
    states, its, prs, dus, _cvs, oks, kkts, gaps = planner.run_scan(
        n_steps=args.steps, return_health=True)
    secs = time.perf_counter() - t0
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        np.savez_compressed(
            args.out, states=states, iterations=its, primal=prs, dual=dus,
            nlp_ok=oks, nlp_kkt=kkts, gaps=gaps,
            profile=np.asarray(json.dumps(PROFILES[args.profile],
                                          sort_keys=True)),
            commit=np.asarray(commit))
    p = states[..., :2]
    print(json.dumps(dict(
        out=os.path.relpath(args.out, ROOT) if args.out else None,
        profile=args.profile, noise=args.noise, seed=args.seed,
        stage_f64=args.stage_f64, steps=int(len(its)),
        seconds=round(secs, 1),
        mean_iterations=float(its.mean()),
        steps_at_cap=int((its >= PROFILES[args.profile]["ocfg"][
            "max_admm_iters"]).sum()),
        res_ok=int(((prs <= 0.011) & (dus <= 0.011)).sum()),
        min_distance_m=float(np.linalg.norm(p[:, 0] - p[:, 1], axis=-1).min()),
        health=float(np.mean(oks == 1.0)), gap_median=float(np.median(gaps)),
        gap_max=float(gaps.max()), commit=commit)))


if __name__ == "__main__":
    main()

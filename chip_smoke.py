"""Smoke run of the PyTorch port on one CUDA card.

Drives ``dlp_admm_torch`` (never JAX) through its main paths and checks it:

1. device: a CUDA card is required; prints its name and power limit;
2. build: compiles the four block-Thomas kernels (``dlp_admm_torch/csrc/``:
   ``warp``, one warp per system for B <= 32, ``wide``, one block per
   system up to its width classes, ``cluster``, a thread-block cluster per
   system past them as far as the cluster holds the tile on chip, and
   ``big``, a grid of co-resident CTAs per system past that, each built
   once per element type) for ``sm_90a``, one ``nvcc`` per library, side by
   side; prints the build time and what ``ptxas`` says, and fails if the
   warp kernel at the flagship's width bound, a wide-kernel build that a
   driven path launches, a cluster-kernel or a big-kernel build spills
   registers (the other wide builds' spills are printed); prints how many
   clusters of the cluster kernel's plans, and how many CTAs of the big
   kernel's, the card runs at once;
3. kernel vs plain version on the card, float64 and float32, plain and
   equilibrated, at (S, T, B) = (2, 7, 19), (1, 7, 20), (32, 7, 19),
   (256, 7, 19) (warp kernel, and the wide kernel forced onto the same
   shapes), (4, 7, 33), (4, 7, 43), (2, 7, 61), (1, 7, 80), (2, 7, 80),
   (1, 7, 97) (wide kernel; float64 equilibrated past 80 goes to the
   cluster kernel), (16, 7, 20), (16, 7, 19) and, at the recursion length
   T = 14 of the
   centralized planner, (1, 14, 22), (1, 14, 34), (1, 14, 45), (1, 14, 66),
   (1, 14, 76), and (1, 14, 108) (the 4-vehicle centralized width),
   (2, 7, 264) (synthetic) and (1, 7, 320) (the 8-vehicle consensus edge
   width), which the cluster kernel solves, with the big kernel forced
   onto the same calls beside it (timed beside it at 108, 264 and 320),
   and
   (1, 7, 405) in float64 (the 9-vehicle consensus edge width) and
   (1, 7, 605) in float32 equilibrated (the 11-vehicle one), which the big
   kernel solves, on diagonally dominant,
   KKT-style saddle, zero-leading-block saddle and (equilibrated only)
   badly scaled systems made with numpy from a fixed seed (tolerances
   below); one big-kernel solve at (1, 7, 405) captured in a CUDA graph
   and replayed three times gives the eager call's bits each time;
   at each shape a path gives K1 (``PATH_SHAPES``, and (1, 7, 605) float32
   equilibrated and (2, 7, 264); the float32 flagship's and batch's shapes
   also in float64 equilibrated, the variant their solves run), the device
   time of both kernels in turns, of the plain version and of one ``torch.linalg.solve``
   on the assembled dense matrix (a yardstick the port never calls),
   beside the roofline bound; the cluster kernel also forced at
   (1, 14, 66) and (1, 7, 80), and its clock64() split at (1, 14, 108) and
   (2, 7, 264), the big kernel's at (1, 7, 405) and (1, 7, 605);
4. the float64 slice: ``dlp_admm_torch.mpc.run_obca(Formulation.CONSENSUS)``
   on the card with the flagship's float64 profile, first 6 MPC steps, held
   against the committed JAX run ``tests/data/consensus_obca_f64_ref.npz``
   (states within 1e-6, equal ADMM iteration counts), with the kernels'
   launch count equal to the staged solver's block-solve count;
5. the float32 slice: the same entry point with ``dtype=torch.float32`` and
   the flagship's float32 profile, held against
   ``tests/data/consensus_obca_f32_ref.npz`` (tolerance below); every
   launch of a slice, of the batch (10) and of ``--full`` (8) is of the
   variant ``ip_staged.kkt_variant`` names for its data (the float32 KKT
   solves: K1's float64 equilibrated variant on the raised blocks, no
   float32 launch);
6. the multi-vehicle path: one MPC step of 4 vehicles in float64 and of 3
   vehicles in float32 (KKT widths 33/80 and 26/45, which the wide kernel
   and the warp kernel's 32-wide build solve), each held against the same
   step run on the kernels' plain version, the 4-vehicle step also against
   the committed JAX run ``tests/data/consensus_obca_v4_f64_ref.npz`` (its
   capped first step), and that JAX run's 4 steps of
   ``tests/test_multivehicle.py`` (ADMM cap 5) through ``run_obca``, held
   against it (states within 1e-6, equal ADMM iteration counts);
7. the kernels against their plain version on the KKT blocks those runs
   gave them (by solution and by backward error), the kernels line's
   blocks and the float64 batch's timed as in 3, and the clock64() split
   of both kernels' profiling builds on them (a float32 block also raised
   to float64 through the float64 equilibrated variant, the one its path
   runs); then the committed float32
   KKT systems of the card's flagship runs (``tests/data/
   kkt_f32_sample.npz``, ``tools/kkt_corpus.py``), each solved by K1's
   float32 equilibrated variant and by its plain version as the staged
   solver solved them before its float32 solves ran in float64 (two
   refinements, the residual verification), and by the staged solver's
   own solve: their ``bad`` counts and median forward
   errors beside JAX's stored ones; fails if K1 rejects more of them than
   its plain version with an exact McNemar p < 0.01;
8. ``--full``: all 42 steps of both profiles (and the whole runs of
   phases 13 and 14). The run fails on the gates
   that hold whichever branch the chaotic conflict window takes (42 steps,
   finite states, overtake completed, footprints apart by more than
   ``min_dis``, at least 39 of 42 steps under the residual thresholds); the
   other pins of ``tests/test_flagship_convergence.py`` are printed;
9. the PI-ADMM path, ``PiAdmmEngine(layout="pairwise").run_fused_batch``
   at the width of ``bench.py``'s first metric (16 vehicles, horizon 30,
   per-step cap 60, whole-run budget 210, 24 pairs a lane, 12 MPC steps):
   in float64 on the first 2 of the bench's seeded starts, held against the
   committed JAX run ``tests/data/pi_admm_bench_f64_ref.npz`` (equal
   iteration counts, states within 1e-6, up to the (lane, step) where the
   JAX run itself, its start moved by 1e-12, leaves itself; the rest is
   printed); in float32 on the bench's own 32 lanes, one warm-up call and
   one timed call, held to ``bench.py``'s gates (finite states, minimum
   pairwise distance > 1.0 m, converged fraction >= 0.93) with the JAX
   float32 run ``tests/data/pi_admm_bench_f32_ref.npz`` printed beside it;
   a second call and a call with a chunk of one trip give the same bits in
   every record; no block-Thomas kernel is launched on this path;
10. the scenario-batched driver of ``bench.py``'s third metric,
   ``dlp_admm_torch.parallel.consensus_spmd.run_scenario_batch`` at its
   full width (16 perturbed overtaking scenarios x 2 vehicles, the
   flagship's float64 profile): over the first 2 of the committed JAX
   run's 6 steps (``tests/data/consensus_obca_batch_f64_ref.npz``)
   equal ADMM iterations per lane and states within 1e-6 up to the
   (lane, step) where JAX itself, its starts moved by 1e-12, leaves itself
   (the rest printed); lane 0 also against the single-scenario fixture;
   the slowest lane run alone through the same driver (S = 1, its wall per
   ADMM iteration beside the batch's) against its lane in the batch;
   the block-Thomas launches equal to the block solves, at (32, 7, 19) for
   the locals and (16, 7, 20) for the edges; the float32 profile over 2
   steps on ``bench.py:266``'s gates (finite states, minimum centre distance
   > 3.0 m, at least 85 % of the lane-steps under the 0.01 residuals); one
   batched step of 2 lanes with dense locals and the joint edge
   (``tests/data/consensus_spmd_cases_ref.npz``'s first case) on the card
   against the same step on the CPU (and JAX's printed beside). The
   kernels are timed at the batch's shapes in 3 and 7.
   ``--full-batch``: the bench's 16 x 20 run in both profiles, the float64
   one gated on ``bench.py:266``, the float32 one reported, its res_ok per
   lane beside JAX's CPU run's (``JAX_BATCH_F32_CPU_LANES``); wall,
   lane-iterations/s, executed ADMM iterations (the slowest lane's, summed
   over steps) and loop efficiency printed beside the single-scenario run.

11. the centralized joint planner, ``run_obca(Formulation.CENTRALIZED)``
   with its defaults (2 vehicles overtaking, horizon 15, ``min_dis`` 1.0,
   float64) over its first 8 of 35 MPC steps (``CEN_SMOKE_STEPS``): its
   staged solve is one lane of 14 stages, so
   K1 runs at (1, 14, 34); held against the committed JAX run
   ``tests/data/obca_centralized_ref.npz`` (equal IP iterations and states
   within 1e-6 up to the step where the JAX run, its references moved by
   1e-12, leaves itself; the rest printed), the launches equal to the block
   solves, all at (1, 14, 34); wall per step, IP trips per step and graph
   replays printed. One 3-vehicle ``solve_at`` (K1 at (1, 14, 66)) on the
   kernels, on their plain version and against
   ``tests/data/obca_centralized_v4_ref.npz``; the same for 4 vehicles (K1
   at (1, 14, 108), the cluster kernel, launches equal to its block solves;
   JAX's own solve is chaotic there, 4 of 6 starts moved by 1e-12 ending
   7-9 m away, so its convergence and distance from JAX and from the
   plain-version run are printed, not gated; JAX's 6 moved starts run on
   the kernels, and at least as many as in JAX must converge to JAX's
   states within 1e-6).
   The centralized side of ``tests/test_parity_oracle.py``'s conflict case
   (``min_dis`` 0.5, ``warm_mode="previous"``, 30 steps) on its gates
   (finite states, footprint gap >= 0.8 ``min_dis``, >= 24 of 30 steps
   converged, overtake gain > 15 m), JAX's numbers beside; 3 float32 steps
   (``ip_tol=1e-4``, the equilibrated kernel at T = 14) on
   ``tests/test_obca.py:18-27``'s tracking gates; one consensus MPC step
   of 8 vehicles (``tools/exp_obca_batch.py v8``'s planner settings,
   float64, ADMM cap 2), K1 at (8, 7, 61) (wide) and (1, 7, 320) (cluster),
   and the same step of 9 vehicles, K1 at (9, 7, 68) (wide) and
   (1, 7, 405) (big), each on the kernels and on their plain version:
   states within 1e-9 (at 9 vehicles, where every IP solve stops at its
   40-trip cap, within the fixed 1e-5; the plain version's own run, its
   z_bar moved by 1e-12, printed beside), equal ADMM iterations and IP
   trips, launches equal to block solves; the 9-vehicle step also against
   the committed JAX run
   ``tests/data/consensus_obca_v9_f64_ref.npz`` (states within 1e-6, equal
   ADMM iterations, unless JAX, its ``z_bar`` moved by 1e-12, leaves
   itself there: then the distance is printed, not gated);
12. the classic PI-ADMM layout, ``run_pi_admm()`` with its defaults (2
   vehicles crossing, horizon 5, float64), its first 12 steps (JAX's own
   chaotic step is 22; ``--full`` all 45) held against
   ``tests/data/pi_admm_classic_ref.npz`` (equal iterations and states
   within 1e-6 up to that step); the paper's A/B of
   ``tests/test_pi_vs_plain.py:43-52`` on the card (PI-reciprocal's
   ``sum_iter_num`` under 0.7 x plain's, both runs finite with a minimum
   distance over 0.8 m; JAX's counts printed beside); no block-Thomas
   kernel launched on this path; ``--full`` adds the sigmoid schedule's
   safety A/B (``test_pi_vs_plain.py:54``);
13. the fixed-dual family, ``run_obca(Formulation.BILEVEL |
   TIGHTENING | TIGHTENING_SLACK)`` with the driver's defaults (2 vehicles,
   horizon 8, ``min_dis`` 1.0, float64), the first 3 MPC steps of each
   (``--full``: all 42 / 62 / 62), each held
   against its committed JAX run ``tests/data/bilevel_ref.npz`` (states
   within 1e-6, per step ``elastic`` within 1e-12 plus 1e-6 and
   ``dual_kkt`` within 1e-12 plus 1e-4 of its size, up to the step where
   JAX, its references
   moved by 1e-12, leaves itself; the rest printed) and gated on
   ``tests/test_bilevel.py``'s gates (finite states, centre distance
   > 3.5 m); the 4-vehicle tightening of
   ``tests/test_multivehicle.py::test_four_vehicle_tightening`` (10 steps,
   dual solves of 42 lanes) on its gates (lanes within 2 m, each lane's
   pair > 3.5 m apart) and against the same file; wall per MPC step and the
   IP trips per step of the local and the dual solves printed; no
   block-Thomas kernel launched;
14. ALADIN, ``run_pi_admm(layout="aladin")`` on the crossing of
   ``tests/test_aladin.py::test_crossing_scenario_collision_free``
   (``PiAdmmConfig()``, 2 vehicles, horizon 5, ``ip_iters`` 25,
   ``ip_tol`` 1e-7, float64), its first 8 steps (``--full``: all 45;
   JAX's own chaotic step is 22), against ``tests/data/aladin_ref.npz``
   (equal ALADIN iterations per step and states within 1e-6 up to JAX's
   own chaotic step, 22) and on that test's gates (finite, clearance
   > 1.5 m; with ``--full`` also both crossing legs completed and fewer
   than 500 iterations in all); ``run_obca(Formulation.ALADIN)``'s 3-step
   dispatch against the same file; wall per ALADIN iteration and per MPC
   step printed; no block-Thomas kernel launched;
15. checkpoint and resume (``dlp_admm_torch.utils``): the flagship's
   float64 profile at ``run_obca``'s ADMM cap (15) run 4 MPC steps
   uninterrupted, and 2 steps with
   ``checkpoint_path`` then resumed to step 4 by a new planner object; the
   pairwise PI-ADMM engine (6 steps, 3 + 3), the bilevel planner with one
   round (4 steps, 2 + 2) and an ALADIN toy (6 iterations, 3 + 3) at
   ``tests/test_driver_utils.py``'s configurations: each resumed run equal
   bit for bit to its uninterrupted run, the resumed flagship steps'
   launches equal to their block solves; ``RunMetrics(trace_path=...)``
   around those runs streams one record a logged step through the native
   trace logger (which must be built), read back equal to the history;
   ``utils.metrics.trace`` around one flagship MPC step (ADMM cap 1)
   writes a profiler trace whose kernel events name K1; ``plot_path`` on
   both drivers (a PNG, or nothing without matplotlib, printed);
16. the vehicle axis over ranks (``parallel.mesh``, ``parallel.multihost``):
   ``tools/multihost_smoke_torch.py`` ranks that share the one card run
   the batch of phase 10 (16 scenarios x 2 vehicles, float64, staged
   locals and edges) through ``make_consensus_spmd_step(planner, mesh)``
   (its first 2 MPC steps on 1x2, its first on the others): on a 1x2
   mesh over gloo (one vehicle a rank;
   CUDA tensors in the collectives, since NCCL refuses two ranks on one
   GPU) and a 2x1 scenario mesh over gloo, equal ADMM iterations and
   converged flags and states within 1e-12 of phase 10's one-device run
   (whether bit for bit printed), and a one-rank NCCL world, bit for bit;
   in each rank the K1 launches equal its block solves, at its blocks'
   shapes ((16, 7, 19) and (16, 7, 20) on 1x2; (16, 7, 19) and (8, 7, 20)
   on 2x1); wall per executed ADMM iteration (phase 10's beside), the
   collectives' share of it and each rank's reserved memory printed;
17. the consensus planner's options: one flagship float64 MPC step each
   (ADMM cap 6) of ``edge_prox=1.0``, ``branch_commit`` (``commit_after``
   3) and ``mpc_step_trace`` (6 iterations, both options) from JAX's carry at
   step 11, on the kernels, against ``tests/data/obca_options_ref.npz``
   (states within 1e-6 and equal ADMM iterations where JAX, its start
   moved by 1e-12, does not leave itself) and against the same run on the
   kernels' plain version (1e-9, equal iterations), launches equal to
   block solves.

Each phase prints its wall seconds on a line of its own ("phase N ...:
X s"). To keep the run under 1,000 s on the card with phases 16-17
(1,199 s before these cuts, 956 s with the first half of them, on one
card each), the default run drives 3 fixed-dual steps (was 6), 8 ALADIN
steps (was 22), 2 float64 batch steps (was 6; the slowest lane alone its
first, was all), 8 centralized steps (was 35) and 12 classic PI-ADMM
steps (was 23); phase 3 times only the path shapes, in the variant the
staged solver asks for (float64 plain, float32 equilibrated; was every
shape in both, and the cluster kernel forced at 66 and 80 beside the
wide kernel), the big kernel beside the cluster kernel at 108 only, and
solves each system's plain version once for all the kernels held to
it; phase 7 times the kernels line's blocks and the float64 batch's (was
every block); phase 16 runs 2 steps on 1x2 and 1 on the others; phase 17
caps the options' steps at 6 ADMM iterations.

Every path is driven with the launch counts set to 0 just before and read
just after. Prints, before the last line, one JSON object with the kernels'
numbers and the ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failure raises (exit code != 0) and
prints no result.

Usage: python3 chip_smoke.py [--full] [--full-batch] [--out PATH.json]
"""
import argparse
import contextlib
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
FIXTURE = os.path.join(DATA, "consensus_obca_f64_ref.npz")
FIXTURE_F32 = os.path.join(DATA, "consensus_obca_f32_ref.npz")
FIXTURE_V4 = os.path.join(DATA, "consensus_obca_v4_f64_ref.npz")
FIXTURE_PI = os.path.join(DATA, "pi_admm_bench_f64_ref.npz")
FIXTURE_PI_F32 = os.path.join(DATA, "pi_admm_bench_f32_ref.npz")
FIXTURE_BATCH = os.path.join(DATA, "consensus_obca_batch_f64_ref.npz")
FIXTURE_CASES = os.path.join(DATA, "consensus_spmd_cases_ref.npz")
FIXTURE_CEN = os.path.join(DATA, "obca_centralized_ref.npz")
FIXTURE_CEN_V4 = os.path.join(DATA, "obca_centralized_v4_ref.npz")
FIXTURE_CLASSIC = os.path.join(DATA, "pi_admm_classic_ref.npz")
FIXTURE_BILEVEL = os.path.join(DATA, "bilevel_ref.npz")
FIXTURE_ALADIN = os.path.join(DATA, "aladin_ref.npz")
FIXTURE_OPTIONS = os.path.join(DATA, "obca_options_ref.npz")
FIXTURE_V9 = os.path.join(DATA, "consensus_obca_v9_f64_ref.npz")
# float32 KKT systems of the card's flagship runs (tools/kkt_corpus.py)
FIXTURE_KKT = os.path.join(DATA, "kkt_f32_sample.npz")
RANK_SCRIPT = os.path.join(ROOT, "tools", "multihost_smoke_torch.py")
SHAPES = ((2, 7, 19), (1, 7, 20), (32, 7, 19), (256, 7, 19))   # B <= 32
# the batched driver's edge solves (its locals are (32, 7, 19) above), and a
# rank's locals on phase 16's 1x2 mesh
BATCH_SHAPES = ((16, 7, 20), (16, 7, 19))
# B > 32: the 4-vehicle local and edge widths 33 and 80, the 3-vehicle edge
# width 45 (at 43), the 8-vehicle local width 61, and 97, the float64 bound
# (float64 equilibrated, 80 is the bound and a width the earlier wide
# kernel did not hold; past it the cluster kernel solves)
WIDE_SHAPES = ((4, 7, 33), (4, 7, 43), (2, 7, 61), (1, 7, 80), (2, 7, 80),
               (1, 7, 97))
# T = 14 (horizon 15): the centralized planner's staged KKT blocks at 2 and
# 3 vehicles (34 and 66: 7V + 8P decision columns, 5V dynamics rows, 2P
# pairing rows) and the stage decision widths 22, 45 and 76 of 2, 3 and 4
# vehicles (the warp kernel's 32-wide build, the wide kernel's classes 48
# and 80) at the recursion length no earlier path drove
T14_SHAPES = ((1, 14, 22), (1, 14, 34), (1, 14, 45), (1, 14, 66),
              (1, 14, 76))
# past the wide kernel's classes, where the cluster kernel runs (the big
# kernel forced beside it): the 4-vehicle centralized KKT width (past the
# wide kernel's float64 range, 97, and its float32 equilibrated range, 106),
# a synthetic 264 and the 8-vehicle consensus edge width, 5V + 10 V(V-1)/2;
# past the cluster's reach, where the big kernel runs: the 9-vehicle edge
# width in float64 and the 11-vehicle one in float32 equilibrated (the
# staged solver's variant of each type; PAST_REACH)
BIG_SHAPES = ((1, 14, 108), (2, 7, 264), (1, 7, 320), (1, 7, 405),
              (1, 7, 605))
PAST_REACH = {(1, 7, 405): (torch.float64, (False, True)),
              (1, 7, 605): (torch.float32, (True,))}
# the wide kernel's path shapes, where the cluster kernel is also timed
# (printed, not gated)
CLUSTER_FORCED_SHAPES = ((1, 14, 66), (1, 7, 80))
# one consensus MPC step of 8 and of 9 vehicles: tools/exp_obca_batch.py
# v8's planner settings in float64 (the staged edge, ADMM cap 2); its solves
# on the kernels and on the plain version part only at the rounding level.
# At 8 vehicles the step keeps that: states within 1e-9. At 9 every IP solve
# stops at its 40-trip cap, unconverged, and the step amplifies rounding:
# JAX's own step, its z_bar moved by 1e-12 (MOVE_NOISE), parts from itself
# by 0.018 (the fixture's moved_state_err), and on an H100 the kernels' run
# parts from the plain version's by 3.14e-6. Its gate is fixed at 1e-5,
# and the plain version's own moved run is printed beside it (PERF.md);
# phase 7 holds each of the step's KKT blocks to the plain version
V8_STATE_TOL = 1e-9
V9_STATE_TOL = 1e-5
MOVE_NOISE, MOVE_SEED = 1e-12, 1
KINDS = ("diag_dominant", "kkt_saddle", "zero_lead")
EQ_KINDS = KINDS + ("badly_scaled",)
# (kind, equilibrate): the badly scaled kind is what equilibration is for;
# unequilibrated, kernel and plain version each lose it in their own way
VARIANTS = tuple((k, False) for k in KINDS) + tuple((k, True)
                                                    for k in EQ_KINDS)
# kernel vs plain version: both run the same recursion with the same pivot
# choice, pivot floor, scaling and refinement; only the order of summation
# inside each product differs (and fused multiply-adds), so the gap is
# rounding amplified by the blocks' conditioning
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# ... and on the KKT systems the planner's runs gave the kernels. In float32
# those are conditioned near 1 / eps (multiplier diagonals of -1e-8 beside
# prox curvature of 1e3 and more), so two eliminations that differ only in
# the order of rounding agree to their condition number times 6e-8 (5e-4 on
# the flagship's first local system). The staged solver does not lean on
# that: it refines every solve twice against the residual. So there the
# kernel is also held to the plain version's backward error, entry by entry:
# each row's residual over |A_i| |x| + |r_i|.
# The centralized planner's float64 KKT block (T = 14) is held row by row
# instead, each row's residual over |A_i|_1 max|x| + |r_i|: its solution
# spans 12 orders of magnitude (1e-12 to 724) and some of its rows have a
# zero right-hand side, so the entry-by-entry measure is noise for any
# elimination there (on an H100, LAPACK's LU scores 1.0 on it, which the
# run records beside the block, and the plain version 0.030). Both measures
# are printed for every block.
ROWWISE_PATHS = ("centralized float64", "centralized V=4 float64")
# the staged solver's float32 use of K1 (ip_staged.py): two refinements, and
# a solve whose tridiagonal residual passes 1e-4 (1 + max|rhs|) is rejected
IP_REFINE_F32, IP_RES_TOL = 2, 1e-4
# phase 7's committed KKT systems: the kernel loses to its plain version
# there if it rejects more of them with an exact McNemar p below this (the
# rule of tools/kkt_corpus.py)
KKT_SAMPLE_ALPHA = 0.01
RUN_TOL = {torch.float64: 1e-10, torch.float32: 5e-3}
STATE_TOL = 1e-6            # port vs JAX fixture, float64 states
# IP trips of the centralized solve_at with 4 vehicles: JAX converges in 109
# of its 150 (obca_centralized_v4_ref.npz), the port on the CPU in 160 to
# the same optimum (states 1.5e-8 from JAX's); the paths part at the
# rounding level, as at 3 vehicles (77 trips against JAX's 58). JAX's starts
# moved by 1e-12 are given 300 trips in the same file
CEN_V4_IP_ITERS = 300
# float32 slice vs the JAX float32 run: both stop each MPC step's ADMM loop
# once two change-based residuals are under 0.01, from iterates that carry
# float32 rounding through hundreds of IP trips, so they stop at different
# iterates within that threshold of one fixed point (and not always after
# the same number of iterations). Positions and speeds (up to 80 m, 20 m/s)
# then agree to about 1e-3; the port on the CPU is 1.6e-3 from the same run.
STATE_TOL_F32 = 1e-2
SMOKE_STEPS = 6
# PI-ADMM bench, float64: per lane, the first step at which the JAX run,
# its start moved by 1e-12, leaves itself (`python tools/make_torch_fixture.py
# --profile pi_admm --noise 1e-12 --seed 1|2|3`: lane 0 at step 4, the
# step its loop caps at 60 iterations, by 0.05-0.17 m; lane 1 at step 2, 42
# iterations, by 3e-4-8.5e-4 m; before them by at most 1.3e-6). Rounding is
# amplified as much there, so the strict check stops before them.
PI_CHAOTIC_FROM = (4, 2)
# bench.py:32-33, the gates of its first metric
PI_MIN_DIST_GATE = 1.0
PI_CONV_FRAC_GATE = 0.93
# bench.py:239-283, its third metric: 16 scenarios x 20 MPC steps, the
# gates of :266 (minimum centre distance, share of lane-steps under the
# 0.01 residuals) and the float32 steps the default run takes
BATCH_STEPS = 20
# the default run's float64 batch: the first 2 of the fixture's 6 steps
# (6 before phases 16-17 joined the run), all before JAX's chaotic step
BATCH_SMOKE_STEPS = 2
# the shapes phase 3 times (in the staged solver's variant of each type):
# the ones a driven path gives K1; the synthetic ones are held to the plain
# version untimed (their rows in PERF.md are earlier PRs')
PATH_SHAPES = ((2, 7, 19), (1, 7, 20), (32, 7, 19), (16, 7, 20), (16, 7, 19),
               (4, 7, 33),
               (1, 7, 80), (1, 14, 34), (1, 14, 66), (1, 14, 108),
               (1, 7, 320), (1, 7, 405))
# the shapes the float32 flagship and batch give K1, whose solves run in
# float64 equilibrated (ip_staged.kkt_variant): timed in that variant too
F32_PATH_SHAPES = ((2, 7, 19), (1, 7, 20), (32, 7, 19), (16, 7, 20))
# ... and the 11-vehicle edge width, which no driven path gives K1, timed
# for the big kernel's row in float32 equilibrated, and the synthetic 264,
# where the cluster kernel is timed beside the big kernel
TIMED_SYNTH_SHAPES = ((1, 7, 605), (2, 7, 264))
# the run blocks phase 7 times: those of the kernels line and the batch's
TIMED_RUN_BLOCKS = (("slice float64", (2, 7, 19)),
                    ("slice float32", (2, 7, 19)),
                    ("multi-vehicle V=4 float64", (1, 7, 80)),
                    ("centralized float64", (1, 14, 34)),
                    ("centralized V=4 float64", (1, 14, 108)),
                    ("consensus V=8 float64", (1, 7, 320)),
                    ("consensus V=9 float64", (1, 7, 405)),
                    ("batch float64", (32, 7, 19)),
                    ("batch float64", (16, 7, 20)))
# the default run's depth on the centralized planner (35 steps before
# phases 16-17; JAX leaves itself from step 5) and the classic layout (23,
# through JAX's own chaotic step 22, before them)
CEN_SMOKE_STEPS = 8
CLASSIC_SMOKE_STEPS = 12
BATCH_MIN_DIST_GATE = 3.0
BATCH_RES_OK_SHARE = 0.85
BATCH_F32_SMOKE_STEPS = 2
# the JAX package's record of that run (BENCH_r05.json, float32 on its
# accelerator): quality only
JAX_BATCH_QUALITY = dict(res_ok="288/320", min_distance_m=3.53,
                         gap_median=0.00844)
# JAX's float32 batch of that run on the CPU (tools/make_torch_fixture.py
# --profile batch_f32, about 20 minutes), printed beside the port's
JAX_BATCH_F32_CPU = dict(res_ok="296/320", steps_at_cap=26,
                         min_distance_m=3.638, gap_median=0.00825)
# ... and that run's res_ok per lane (steps of 20 under the 0.01
# residuals), printed beside the port's lanes (PERF.md §6)
JAX_BATCH_F32_CPU_LANES = (19, 20, 18, 18, 19, 20, 20, 18, 20, 14, 19, 17,
                           19, 16, 19, 20)
# JAX's float32 flagship on the CPU from the unmoved start and from seeds
# 1-10 with 1e-7 normal noise on z_bar (tools/make_torch_fixture.py
# --profile f32 [--noise 1e-7 --seed N]), printed beside --full's one
# float32 run: one run of the chaotic conflict window says little, so its
# numbers are set in JAX's spread, not gated on it (PERF.md §6)
JAX_F32_CPU_RUNS = dict(
    res_ok=(39, 40, 41, 32, 34, 39, 39, 40, 40, 39, 41),
    steps_at_cap=(3, 2, 1, 10, 8, 3, 4, 2, 2, 3, 1),
    min_distance_m=(4.0504, 3.7607, 4.2056, 3.7637, 3.2687, 4.3209, 3.3812,
                    4.2946, 4.0095, 3.6396, 4.2917),
    health=(0.4286, 0.4643, 0.4643, 0.4762, 0.4167, 0.4643, 0.5119, 0.2738,
            0.4405, 0.4048, 0.3452))
# tests/test_parity_oracle.py:100-140, the centralized side's gates
ORACLE_MARGIN = 0.8          # footprint gap >= 0.8 min_dis
ORACLE_MIN_CONVERGED = 24    # of 30 steps
ORACLE_MIN_GAIN_M = 15.0     # overtake gain
# tests/test_pi_vs_plain.py:43-52: PI-reciprocal below 0.7x plain
PI_AB_RATIO = 0.7
PI_AB_MIN_DIST = 0.8
# the fixed-dual family against its JAX runs, per step (the tolerances of
# tests/test_torch_bilevel_runs.py): ``elastic`` and ``dual_kkt`` are an IP
# iterate's slack and residual at exit, so rounding moves them more than
# the states: JAX itself, its references moved by 1e-12, moves them by up
# to 2.6e-8 and 3.2e-7 of their size (the 4-vehicle run; the 2-vehicle
# runs 3e-11 and 1.4e-8), so they are held 40x and 300x above that
ELASTIC_TOL = (1e-12, 1e-6)             # absolute, relative
DUAL_KKT_TOL = (1e-12, 1e-4)
# the steps the default run drives (driver's defaults otherwise; the JAX
# fixture holds the whole 42 / 62 / 62 steps, which --full runs; 12 before
# phase 15 joined the run, 6 before phases 16-17 did, each cut to keep the
# whole run under 1,000 s) and the gates of tests/test_bilevel.py and
# tests/test_multivehicle.py:90-104
FIXED_DUAL_SMOKE_STEPS = 3
FIXED_DUAL_MIN_DIST = 3.5
V4_LANE_Y = (0.0, 0.0, 6.0, 6.0)
V4_LANE_TOL_M = 2.0
# tests/test_aladin.py:142-176's gates on the crossing; the default run
# drives its first 8 steps (22 before phases 16-17 joined the run: through
# the conflict onset, up to the step where JAX, its start moved by 1e-12,
# leaves itself), --full all 45
ALADIN_MIN_DIST = 1.5
ALADIN_MAX_TOTAL_ITERS = 500
ALADIN_SMOKE_STEPS = 8
# phase 16: the bench batch's first MPC steps through the vehicle-sharded
# step (all before JAX's own chaotic step, 6), held to phase 10's
# one-device run; a rank process that takes longer than this fails
SHARDED_STEPS = 2            # the 1x2 run; the 2x1 and NCCL runs take 1
SHARDED_TOL = 1e-12
RANK_TIMEOUT_S = 600
# phase 17: the options' runs on the kernels against their plain version
OPTIONS_PLAIN_TOL = 1e-9
DEVICE = "cuda"
# NVIDIA H100 SXM data sheet: HBM3 rate and the card's peaks for the type:
# FP64 on the tensor cores (67 TFLOP/s; the vector units give half that),
# FP32 outside them (TF32 keeps too few digits for these solves)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 67.0e12, torch.float32: 67.0e12}
SM_COUNT = 132          # one system runs on one SM: its bound is 1/132 of that
REPLACES = "dlp_admm_tpu/solvers/thomas_pallas.py:145"
# the 42-step float64 run of the block-per-system kernel the port began
# with (NVIDIA H100 80GB HBM3, 700 W), printed beside --full
EARLIER_FULL_F64 = dict(res_ok=42, mean_iterations=16.0,
                        min_distance_m=3.443, min_footprint_gap_m=0.251,
                        health=0.929, gap_median=0.0085, gap_max=0.373,
                        wall_s=409.6, iterations_per_s=1.643)


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def phase(records, name):
    """Time one phase: its wall seconds printed on a line of their own and
    kept in ``records["phase_s"]``."""
    t0 = time.perf_counter()
    yield
    sec = records.setdefault("phase_s", {})[name] = time.perf_counter() - t0
    log(f"phase {name}: {sec:.1f} s")


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def dump(path, records):
    if path:
        with open(path, "w") as f:
            json.dump(records, f, indent=1)


def make_system(rng, s, t, b, kind):
    """Symmetric block-tridiagonal [S, T, B, B] / upper / rhs (numpy f64):
    ``diag_dominant``; ``kkt_saddle``, KKT-style blocks (H, J^T; J, -eps I);
    ``zero_lead``, the same saddle with the constraint rows first and a zero
    (1, 1) block, which only an elimination that swaps rows can factor;
    ``badly_scaled``, the saddle with rows of 1e6 beside rows of 1, for the
    equilibrated variant."""
    if kind == "diag_dominant":
        diag = rng.normal(size=(s, t, b, b))
        diag = 0.5 * (diag + np.swapaxes(diag, -1, -2)) + (b + 2.0) * np.eye(b)
        upper = 0.3 * rng.normal(size=(s, t, b, b))
    else:
        m = b // 4
        n = b - m
        r = rng.normal(size=(s, t, n, n))
        j = rng.normal(size=(s, t, m, n))
        h, c = (slice(m, b), slice(0, m)) if kind == "zero_lead" \
            else (slice(0, n), slice(n, b))
        hess = r @ np.swapaxes(r, -1, -2) + np.eye(n)
        if kind == "badly_scaled":
            # every other primal row and column carries 1e3: curvature of
            # 1e6 beside constraint rows of 1 and multiplier diagonals of
            # -1e-8, as the annealed prox makes the planner's stage blocks
            sc = np.where(np.arange(n) % 2 == 0, 1.0e3, 1.0)
            hess = hess * sc[:, None] * sc[None, :]
        diag = np.zeros((s, t, b, b))
        diag[..., h, h] = hess
        diag[..., h, c] = np.swapaxes(j, -1, -2)
        diag[..., c, h] = j
        diag[..., c, c] = 0.0 if kind == "zero_lead" else -1e-8 * np.eye(m)
        upper = np.zeros((s, t, b, b))
        upper[..., h, h] = 0.1 * rng.normal(size=(s, t, n, n))
    upper[:, t - 1] = 0.0
    return diag, upper, rng.normal(size=(s, t, b))


def thomas_work(s, t, b, elem, equilibrate):
    """(bytes, floating-point operations) one solve of ``S`` systems needs:
    every input read once (the T-1 used blocks of ``upper``) and the output
    written once; per stage the Gauss-Jordan updates right of each pivot on
    ``[C | U | g]`` (the last stage has no U columns), the products
    ``U^T [X | y]`` between stages and the back substitution; equilibrated,
    also the scaling, the residual and the second elimination of its B+1
    (last stage: 1) columns."""
    n_bytes = elem * s * (t * b * b + (t - 1) * b * b + 2 * t * b)
    flops = 0
    for k in range(t):
        extra = (b if k < t - 1 else 0) + 1     # columns right of C
        flops += sum(2 * b * (b - 1 - j + extra) for j in range(b))
        if equilibrate:
            flops += 3 * b * (b + extra)            # D C D, D [U | g], D Y
            flops += 2 * b * b * extra              # residual
            flops += 2 * b * b * extra + b * extra  # multipliers again, Y + dY
        if k < t - 1:
            flops += 2 * b * b * (b + 1)            # U_k^T [X_k | y_k]
            flops += 2 * b * b                      # z_k = y_k - X_k z_{k+1}
    return n_bytes, s * flops


def bound(s, t, b, dtype, equilibrate):
    """The least time the card could take for one solve: the larger of bytes
    over the memory rate and operations over the vector peak."""
    elem = torch.empty((), dtype=dtype).element_size()
    n_bytes, flops = thomas_work(s, t, b, elem, equilibrate)
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS[dtype]
    # each system is one block on one SM: at most min(S, SM_COUNT) SMs work
    one_sm = flops / (PEAK_FLOPS[dtype] * min(s, SM_COUNT) / SM_COUNT)
    return dict(bound_ms=1e3 * max(by_bytes, by_ops),
                bound_us=1e6 * max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                sm_bound_us=1e6 * max(by_bytes, one_sm),
                bytes=n_bytes, flops=flops)


def dense_system(diag, upper, rhs):
    """The block-tridiagonal system as one dense ``[S, T B, T B]`` matrix
    and ``[S, T B, 1]`` right-hand side (for the library yardstick)."""
    s, t, b = rhs.shape
    a = diag.new_zeros((s, t * b, t * b))
    for k in range(t):
        i = slice(k * b, (k + 1) * b)
        a[:, i, i] = diag[:, k]
        if k + 1 < t:
            j = slice((k + 1) * b, (k + 2) * b)
            a[:, i, j] = upper[:, k]
            a[:, j, i] = upper[:, k].transpose(-1, -2)
    return a, rhs.reshape(s, t * b, 1).clone()


def time_ms(fn, reps):
    """Time per call of ``fn`` called eagerly (host dispatch included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20):
    """Device time per call of ``fn``: ``reps`` calls captured as one CUDA
    graph and replayed, which keeps host dispatch out, as in the IP loop."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn()
        graph.capture_begin()
        for _ in range(reps):
            fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return time_ms(graph.replay, 5) / reps


def timings(thomas, diag, upper, rhs, equilibrate, other=None):
    """Device times of one solve: the kernel the wrapper picks (``ms``), a
    second kernel forced onto the same call (``<other>_ms``: the wide
    kernel where the wrapper picks the warp kernel, the big kernel where it
    picks the cluster kernel, unless ``other`` names one or is False for
    none; the two timed in turns: picked, other, other, picked), the plain
    version, and the library yardstick."""
    s, t, b = rhs.shape

    def run(kernel):
        return lambda: thomas.launch_kernel(diag, upper, rhs, equilibrate,
                                            kernel)

    # a call past 264 wide takes milliseconds: fewer calls a graph
    reps = 20 if b < 264 else 5

    name = thomas.kernel_plan(s, t, b, rhs.dtype, equilibrate)["kernel"]
    if other is None:
        other = {"warp": "wide", "cluster": "big"}.get(name)
    row = {}
    if other:
        turns = [graph_ms(run(k), reps) for k in (name, other, other, name)]
        row.update({"ms": 0.5 * (turns[0] + turns[3]),
                    f"{other}_ms": 0.5 * (turns[1] + turns[2]),
                    "ms_turns": turns})
    else:
        row.update(ms=graph_ms(run(name), reps))
    row["us_per_pivot"] = 1e3 * row["ms"] / (t * b)
    # past the wide classes one plain call is tens of thousands of kernels:
    # a graph of one call, replayed, instead of five
    row["plain_ms"] = graph_ms(
        lambda: thomas.block_thomas_plain(diag, upper, rhs, equilibrate),
        reps=1 if b > 97 else 5)
    a, r = dense_system(diag, upper, rhs)
    # eager calls between two events: the solver's error check reads the
    # device, which a stream capture does not allow
    row["library_ms"] = time_ms(lambda: torch.linalg.solve(a, r), 20)
    row.update(bound(s, t, b, rhs.dtype, equilibrate), picked=name)
    return row


def backward_error(diag, upper, rhs, x):
    """``(componentwise, row-wise)`` backward errors of ``x``, in float64,
    max over rows and systems: ``|A x - r|_i / (|A_i| |x| + |r_i|)`` and
    ``|A x - r|_i / (|A_i|_1 max|x| + |r_i|)``."""
    a, r = dense_system(diag.double(), upper.double(), rhs.double())
    xs = x.double().reshape(r.shape)
    res = (a @ xs - r).abs()
    scale = a.abs().sum(-1, keepdim=True) * xs.abs().amax(dim=(1, 2),
                                                          keepdim=True)
    return (float((res / (a.abs() @ xs.abs() + r.abs()).clamp(
                min=1e-300)).max()),
            float((res / (scale + r.abs()).clamp(min=1e-300)).max()))


def tridiag_residual(d, u, r, vec):
    """``ip_staged.py``'s ``tridiag_residual`` of ``vec`` for the system
    ``d [S, T, B, B]``, ``u [S, T, B, B]``, ``r [S, T, B]``, op for op."""
    n_s, _, bb = r.shape
    zeros = r.new_zeros
    u_prev = torch.cat([zeros(n_s, 1, bb, bb), u[:, :-1]], dim=1)
    nxt = torch.cat([vec[:, 1:], zeros(n_s, 1, bb)], dim=1)
    prv = torch.cat([zeros(n_s, 1, bb), vec[:, :-1]], dim=1)
    return (torch.einsum('stij,stj->sti', d, vec)
            + torch.einsum('stij,stj->sti', u, nxt)
            + torch.einsum('stji,stj->sti', u_prev, prv) - r)


def ip_verify(ip_staged, d, u, r, sol):
    """The staged solver's solve verification of ``sol``: ``(bad, scaled
    residual)`` per lane, ``max|lin_res| / (1 + max|rhs|)``."""
    top = ip_staged._amax(r.abs())
    res = ip_staged._amax(tridiag_residual(d, u, r, sol).abs())
    bad = torch.logical_or(~torch.isfinite(sol).all(dim=2).all(dim=1),
                           res > IP_RES_TOL * (1.0 + top))
    return bad, res / (1.0 + top)


def ip_solve(ip_staged, solve, d, u, r):
    """``solve`` used as the staged solver uses its block solve in float32:
    one solve, two refinements, the verification. Returns the solution
    before a rejected one is zeroed, ``bad`` and the scaled residual."""
    sol = solve(d, u, r)
    for _ in range(IP_REFINE_F32):
        sol = sol - solve(d, u, tridiag_residual(d, u, r, sol))
    return (sol,) + ip_verify(ip_staged, d, u, r, sol)


def forward_error(x, x_true):
    """``max|x - x*| / max|x*|`` per system, in float64."""
    x_true = torch.as_tensor(x_true, dtype=torch.float64, device=x.device)
    err = (x.double() - x_true).abs().amax((1, 2)) / x_true.abs().amax(
        (1, 2)).clamp(min=1e-300)
    return torch.nan_to_num(err, nan=float("inf"))


def mcnemar_p(a_only, b_only):
    """Exact two-sided McNemar p on the discordant pairs of two paired
    flags (the binomial at 1/2, the smaller tail doubled)."""
    n = a_only + b_only
    tail = sum(math.comb(n, i) for i in range(min(a_only, b_only) + 1))
    return min(1.0, 2.0 * tail / 2.0 ** n)


def kkt_sample(thomas, ip_staged, smi):
    """The committed float32 KKT systems of the card's flagship runs where
    K1's and its plain version's errors differ most from JAX's
    (``tools/kkt_corpus.py report --sample``): the kernel and the plain
    version, each as the staged solver uses it, beside the ``bad`` flags
    and forward errors stored with them (JAX's computed on the CPU, the
    card arms' in the corpus's own solves). Fails if the kernel loses to
    its plain version by the corpus's rule on ``bad``: it rejects more of
    them, with an exact McNemar p below KKT_SAMPLE_ALPHA. On these systems
    a rejection is decided by rounding in the verification's residual (on
    an H100 the same lanes gave K1 196 and the plain version 200 in the
    corpus's batches, 201 and 198 in this phase's), so a bare count is a
    coin flip between two arms the corpus shows equal. The staged solver's
    own solve (the systems raised to float64 and solved by the float64
    equilibrated variant, ``ip_staged.kkt_variant``) is reported beside
    them as ``path``."""
    z = np.load(FIXTURE_KKT)
    fams = sorted({k.split("_")[0] for k in z.files if k.endswith("_rhs")})
    out, flags = dict(nvidia_smi=smi), {}
    for arm, solve in (("kernel", lambda d, u, r: thomas.block_thomas_solve(
                           d, u, r, True)),
                       ("plain", lambda d, u, r: thomas.block_thomas_plain(
                           d, u, r, True)),
                       ("path", ip_staged.block_thomas_solve)):
        bad, err = [], []
        for f in fams:
            d, u, r = (torch.as_tensor(z[f"{f}_{k}"], device=DEVICE)
                       for k in ("d", "u", "rhs"))
            sol, b, _ = ip_solve(ip_staged, solve, d, u, r)
            bad.append(b.cpu())
            err.append(forward_error(sol, z[f"{f}_truth"]).cpu())
        flags[arm] = torch.cat(bad)
        err = torch.cat(err)
        out[arm] = dict(systems=int(err.numel()), bad=int(flags[arm].sum()),
                        err_median=float(err.median()))
    k_only = int((flags["kernel"] & ~flags["plain"]).sum())
    p_only = int((flags["plain"] & ~flags["kernel"]).sum())
    out["kernel_vs_plain"] = dict(kernel_only_bad=k_only,
                                  plain_only_bad=p_only,
                                  mcnemar_p=mcnemar_p(k_only, p_only))
    for arm in map(str, z["arms"]):      # as tools/kkt_corpus.py solved them
        bad = np.concatenate([z[f"{f}_{arm}_bad"] for f in fams])
        err = np.concatenate([z[f"{f}_{arm}_err"] for f in fams])
        out["stored_" + arm] = dict(bad=int(bad.sum()),
                                    err_median=float(np.median(err)))
    log("kkt sample: " + json.dumps(out))
    if k_only > p_only and out["kernel_vs_plain"]["mcnemar_p"] < \
            KKT_SAMPLE_ALPHA:
        raise RuntimeError(f"kkt sample: the kernel rejects "
                           f"{out['kernel']['bad']} systems, its plain "
                           f"version {out['plain']['bad']} ({k_only} / "
                           f"{p_only} alone, McNemar p "
                           f"{out['kernel_vs_plain']['mcnemar_p']:.3g})")
    return out


def compare(thomas, diag, upper, rhs, label, equilibrate=False, kernel=None,
            timed=False, run_block=False, rowwise=False, other=None,
            want=None):
    """Kernel vs plain version on the same card tensors; raises past TOL
    (``run_block``: past RUN_TOL, or a backward error above 4 times the
    plain version's and 10 units of rounding; componentwise, or with
    ``rowwise`` row by row). ``want``: the plain version's solution of
    these tensors where the caller has it already."""
    t0 = time.perf_counter()
    got = thomas.launch_kernel(diag, upper, rhs, equilibrate, kernel)
    if want is None:
        want = thomas.block_thomas_plain(diag, upper, rhs, equilibrate)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{label}: kernel output not finite")
    abs_err = float((got - want).abs().max())
    rel_err = abs_err / max(float(want.abs().max()), 1e-300)
    tol = (RUN_TOL if run_block else TOL)[rhs.dtype]
    s, t, b = rhs.shape
    row = dict(case=label, shape=[s, t, b], dtype=str(rhs.dtype)[6:],
               equilibrate=equilibrate,
               kernel=kernel or thomas.kernel_plan(
                   s, t, b, rhs.dtype, equilibrate)["kernel"],
               max_abs_err=abs_err, max_rel_err=rel_err, tol=tol)
    if run_block:
        (row["backward_err"], row["rowwise_backward_err"]) = \
            backward_error(diag, upper, rhs, got)
        (row["plain_backward_err"],
         row["plain_rowwise_backward_err"]) = backward_error(
            diag, upper, rhs, want)
        row["gate"] = "row-wise" if rowwise else "componentwise"
        if rowwise:
            # the evidence for the row-wise gate: LAPACK's LU on the same
            # block, in float64, scored by both measures
            a, r = dense_system(diag.double(), upper.double(), rhs.double())
            (row["library_backward_err"],
             row["library_rowwise_backward_err"]) = backward_error(
                diag, upper, rhs, torch.linalg.solve(a, r))
    if timed:
        row.update(timings(thomas, diag, upper, rhs, equilibrate, other))
    row["wall_s"] = time.perf_counter() - t0
    log(json.dumps(row))
    if not rel_err <= tol:
        raise RuntimeError(f"{label}: kernel vs plain rel err {rel_err:.3e} "
                           f"> {tol:.0e}")
    key = "rowwise_backward_err" if rowwise else "backward_err"
    if run_block and not row[key] <= max(
            4.0 * row["plain_" + key],
            10.0 * torch.finfo(rhs.dtype).eps):
        raise RuntimeError(f"{label}: {row['gate']} backward error "
                           f"{row[key]:.3e} against the plain version's "
                           f"{row['plain_' + key]:.3e}")
    return row


def report_build(logs, wide_builds, main_path_plans):
    """Print ``ptxas``'s numbers per kernel instantiation; returns them as
    records. Raises if the warp kernel's 20-wide build (the flagship's
    B = 19 and 20) or a build of the wide kernel that a driven path launches
    (``main_path_plans``: (dtype, equilibrated, plan); and the profiling
    builds) uses a stack frame or spills; the other wide builds' spills are
    printed; every big- and cluster-kernel build must be free of
    spills."""
    rows = []
    for name, text in logs.items():
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = dict(library=name, function=m.group(1))
                rows.append(entry)
            elif entry is not None:
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
                if m:
                    entry.update(stack=int(m.group(1)),
                                 spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
                m = re.search(r"Used (\d+) registers", line)
                if m:
                    entry["registers"] = int(m.group(1))
    for r in rows:
        # template arguments <T, BP, EQ, PROF> in the mangled name
        m = re.search(r"thomas_warp_kernelI([df])Li(\d+)ELb([01])ELb([01])E",
                      r["function"])
        if m:
            r.update(dtype="f64" if m.group(1) == "d" else "f32",
                     bp=int(m.group(2)), equilibrated=m.group(3) == "1",
                     profiling=m.group(4) == "1")
        # <T, NCL, RPW, NT, MAXW, EQ, PROF>
        m = re.search(r"thomas_wide_kernelI([df])Li(\d+)ELi(\d+)ELi(\d+)E"
                      r"Li(\d+)ELb([01])ELb([01])E", r["function"])
        if m:
            r.update(dtype="f64" if m.group(1) == "d" else "f32",
                     ncl=int(m.group(2)), rpw=int(m.group(3)),
                     nt=int(m.group(4)), max_warps=int(m.group(5)),
                     equilibrated=m.group(6) == "1",
                     profiling=m.group(7) == "1")
        # <EQ, TILE, PROF>, the element type in Params<T>
        m = re.search(r"thomas_big_kernelILb([01])ELb([01])ELb([01])E\S*?"
                      r"ParamsI([df])E", r["function"])
        if m:
            r.update(dtype="f64" if m.group(4) == "d" else "f32",
                     equilibrated=m.group(1) == "1",
                     tile_in_smem=m.group(2) == "1",
                     profiling=m.group(3) == "1", big=True)
        # <EQ, PROF>, the element type in Params<T>
        m = re.search(r"thomas_cluster_kernelILb([01])ELb([01])E\S*?"
                      r"ParamsI([df])E", r["function"])
        if m:
            r.update(dtype="f64" if m.group(3) == "d" else "f32",
                     equilibrated=m.group(1) == "1",
                     profiling=m.group(2) == "1", cluster=True)
        log("  " + json.dumps(r))
    flagship = [r for r in rows if r.get("bp") == 20 and not r["profiling"]]
    if len(flagship) != 4:
        raise RuntimeError(f"expected 4 warp-kernel builds at width 20 in "
                           f"the compiler's output, found {len(flagship)}")
    wide = [r for r in rows if "ncl" in r]
    if len(wide) != wide_builds:
        raise RuntimeError(f"expected {wide_builds} wide-kernel builds in the "
                           f"compiler's output, found {len(wide)}")

    def spills(r):
        return bool(r.get("stack", 1) or r.get("spill_stores", 1)
                    or r.get("spill_loads", 1))
    # the wide builds the driven paths launch: the profiling builds, the
    # classes of the 4-vehicle (33, 80, float64) and 3-vehicle (45, float32
    # equilibrated) consensus widths and of the centralized widths (34 and
    # 66 float64, 34 float32 equilibrated)
    on_path = [r for r in wide if r["profiling"] or any(
        (r["dtype"], r["equilibrated"], r["ncl"], r["rpw"], r["nt"])
        == (dt, eq, p["ncl"], p["rpw"], p["nt"])
        for dt, eq, p in main_path_plans)]
    # per type: plain and equilibrated, the blocks in shared memory or in
    # the workspace, and the profiling builds (shared memory)
    big = [r for r in rows if r.get("big")]
    if len(big) != 12:
        raise RuntimeError(f"expected 12 big-kernel builds in the compiler's "
                           f"output, found {len(big)}")
    cluster = [r for r in rows if r.get("cluster")]
    if len(cluster) != 8:
        raise RuntimeError(f"expected 8 cluster-kernel builds in the "
                           f"compiler's output, found {len(cluster)}")
    bad = [r for r in flagship + on_path + big + cluster if spills(r)]
    if bad:
        raise RuntimeError(f"a kernel build spills: {bad}")
    off = [r for r in wide if spills(r) and r not in on_path]
    for r in off:
        log("  spills (a class no driven path launches): " + json.dumps(r))
    return rows


def flagship_profile(dtype=torch.float64, max_admm_iters=50):
    from dlp_admm_torch.config import ObcaConfig, SolverConfig
    # bench.py:207-212 with the float64 settings of bench.py:196-199 or the
    # float32 settings of bench.py:194
    f64 = dtype == torch.float64
    return dict(ocfg=ObcaConfig(horizon=8, min_dis=0.1, rho=100.0,
                                max_admm_iters=max_admm_iters),
                scfg=SolverConfig(ip_iters=40, ip_tol=1e-6 if f64 else 1e-4),
                local_prox=700.0, prox_growth=1.5,
                prox_tau_max=3.0e10 if f64 else 1.0e9, dtype=dtype)


class CaptureFirst:
    """Stands in for ``ip_staged.block_thomas_solve`` during a run and keeps
    the first KKT system of each shape it is given."""

    def __init__(self, solve):
        self.solve, self.systems = solve, {}

    def __call__(self, diag, upper, rhs):
        key = tuple(rhs.shape)
        if key not in self.systems:
            self.systems[key] = (diag.clone(), upper.clone(), rhs.clone())
        return self.solve(diag, upper, rhs)


def plain_solve(thomas, ip_staged):
    """The staged solver's KKT solve with the kernels' plain version in
    place of K1, in the element type and variant ``ip_staged.kkt_variant``
    names (a stand-in for ``ip_staged.block_thomas_solve``)."""
    def solve(diag, upper, rhs):
        real, equilibrate = ip_staged.kkt_variant(rhs.dtype)
        return thomas.block_thomas_plain(
            diag.to(real), upper.to(real), rhs.to(real),
            equilibrate).to(rhs.dtype)
    return solve


def drive(thomas, ip_staged, run, solve=None):
    """Run ``run()`` with the launch counts set to 0 just before and read
    just after, keeping the first KKT system of each shape. ``solve``
    replaces the staged solver's block solve (with the plain version).
    The run's launches by kernel variant are kept in :data:`last_variants`
    until the next call."""
    keep = ip_staged.block_thomas_solve
    cap = CaptureFirst(solve or keep)
    ip_staged.block_thomas_solve = cap
    try:
        thomas.reset_counts()
        res = run()
        torch.cuda.synchronize()
        counts = dict(thomas.launches_by_kernel)
        last_variants.clear()
        last_variants.update(thomas.launches_by_variant)
    finally:
        ip_staged.block_thomas_solve = keep
    return res, counts, cap.systems


# the launches by kernel variant (``thomas.variant_name``) of the run that
# drive() drove last
last_variants: dict = {}


def check_variants(name, dtype, kernel="warp"):
    """Every KKT solve of the run driven last went to the K1 variant that
    the staged solver names for ``dtype`` data (``ip_staged.kkt_variant``):
    float32 data to the float64 equilibrated variant, no float32 launch
    left. Returns the launches by variant."""
    from dlp_admm_torch.solvers import ip_staged, thomas
    want = thomas.variant_name(kernel, *ip_staged.kkt_variant(dtype))
    log(f"{name}: launches by variant {last_variants}")
    if set(last_variants) != {want} or last_variants[want] <= 0:
        raise RuntimeError(f"{name}: launches by variant {last_variants}, "
                           f"expected {want} alone")
    return dict(last_variants)


def check_counts(name, counts, block_solves, expect):
    """Launches == block solves, and each kernel in ``expect`` launched."""
    log(f"{name}: kernel launches {counts}, staged block solves "
        f"{block_solves}")
    if sum(counts.values()) != block_solves or block_solves <= 0:
        raise RuntimeError(f"{name}: kernel launches {counts} != block "
                           f"solves {block_solves}")
    for k in expect:
        if counts[k] <= 0:
            raise RuntimeError(f"{name}: the {k} kernel was never launched")


def check_slice(name, res, pl, ref, counts, dev, tol, same_iterations):
    states = res.states
    n = len(res.metrics.iter_history)
    if n != SMOKE_STEPS or states.shape != (SMOKE_STEPS + 1, 2, 5):
        raise RuntimeError(f"{name} ran {n} steps, states {states.shape}")
    if not np.all(np.isfinite(states)):
        raise RuntimeError(f"{name} states not finite")
    err = float(np.abs(states - ref["states"][:n + 1]).max())
    its = np.asarray(res.metrics.iter_history)
    log(f"{name}: max |state - JAX fixture| = {err:.3e} (tol {tol:.0e}); "
        f"ADMM iterations {its.tolist()}, JAX "
        f"{ref['iterations'][:n].tolist()}")
    if not err <= tol:
        raise RuntimeError(f"{name} states differ from the JAX fixture: "
                           f"{err}")
    if same_iterations and not np.array_equal(its, ref["iterations"][:n]):
        raise RuntimeError(f"{name}: ADMM iterations {its.tolist()} != JAX "
                           f"{ref['iterations'][:n].tolist()}")
    check_counts(name, counts, pl.block_solves, ("warp",))
    check_variants(name, pl.dtype)
    st, bs = pl.carry
    for field, x in [("state", st)] + list(bs._asdict().items()):
        if x.device.type != dev.type or x.dtype != pl.dtype:
            raise RuntimeError(f"{name}: final carry {field} is {x.dtype} "
                               f"on {x.device}")


def slice_record(name, res, ref, counts, block_solves):
    m = res.metrics
    p = res.states[..., :2]
    rows = res.extras["residuals"]
    per_step = [dict(step=t, iterations=m.iter_history[t], primal=r[0],
                     dual=r[1], gap=r[6], wall_s=m.step_times[t])
                for t, r in enumerate(rows)]
    for row in per_step:
        log(json.dumps(row))
    summary = m.summary()
    out = dict(steps=per_step, summary=summary, launches=counts,
               block_solves=block_solves,
               jax_iterations=ref["iterations"][:len(rows)].tolist(),
               min_center_distance_m=float(
                   np.linalg.norm(p[:, 0] - p[:, 1], axis=-1).min()),
               max_state_err_vs_jax=float(
                   np.abs(res.states - ref["states"][:len(rows) + 1]).max()))
    log(f"{name}: {summary['steps']} steps, wall "
        f"{summary['total_time_s']:.3f} s, "
        f"{summary.get('iterations_per_s', 0.0):.3f} ADMM it/s, min centre "
        f"distance {out['min_center_distance_m']:.4f} m")
    return out


def multi_vehicle(thomas, ip_staged, run_obca, Formulation, num_veh, dtype,
                  expect, tol, ref=None):
    """One MPC step of ``num_veh`` vehicles (two ADMM iterations, pairs
    gated as in tests/test_multivehicle.py) on the kernels, and the same
    step on their plain version; with ``ref`` (the 4-vehicle JAX fixture)
    also held against its capped step (states within STATE_TOL, equal ADMM
    iterations). Returns the record and the KKT systems."""
    from dlp_admm_torch.config import ObcaConfig, SolverConfig
    f64 = dtype == torch.float64
    name = f"multi-vehicle V={num_veh} {str(dtype)[6:]}"

    def run():
        return run_obca(
            Formulation.CONSENSUS,
            ocfg=ObcaConfig(num_veh=num_veh, horizon=8, min_dis=0.1,
                            rho=100.0, max_admm_iters=2),
            scfg=SolverConfig(ip_iters=40, ip_tol=1e-6 if f64 else 1e-4),
            n_steps=1, dtype=dtype, gate_pairs=True, gate_thres=12.0)

    plain = plain_solve(thomas, ip_staged)
    res, counts, systems = drive(thomas, ip_staged, run)
    pl = res.extras["planner"]
    check_counts(name, counts, pl.block_solves, expect)
    want, plain_counts, _ = drive(thomas, ip_staged, run, solve=plain)
    if sum(plain_counts.values()):
        raise RuntimeError(f"{name}: the plain run launched {plain_counts}")
    if res.states.shape != (2, num_veh, 5) or not np.all(
            np.isfinite(res.states)):
        raise RuntimeError(f"{name}: states {res.states.shape} not finite")
    err = float(np.abs(res.states - want.states).max())
    log(f"{name}: KKT shapes {sorted(systems)}, max |state - plain-version "
        f"run| = {err:.3e} (tol {tol:.0e}), wall "
        f"{res.metrics.step_times[0]:.2f} s against "
        f"{want.metrics.step_times[0]:.2f} s")
    if not err <= tol:
        raise RuntimeError(f"{name}: states differ from the plain-version "
                           f"run: {err}")
    if ref is not None:
        jax_err = float(np.abs(res.states - ref["capped_states"]).max())
        log(f"{name}: max |state - JAX capped step| = {jax_err:.3e} (tol "
            f"{STATE_TOL:.0e}); ADMM iterations {res.metrics.iter_history}, "
            f"JAX {ref['capped_iterations'].tolist()}")
        if not (jax_err <= STATE_TOL and res.metrics.iter_history
                == ref["capped_iterations"].tolist()):
            raise RuntimeError(f"{name}: the capped step differs from the "
                               f"JAX fixture")
    rec = dict(launches=counts, block_solves=pl.block_solves,
               kkt_shapes=sorted(systems), max_state_err_vs_plain=err,
               iterations=res.metrics.iter_history,
               wall_s=res.metrics.step_times[0],
               plain_wall_s=want.metrics.step_times[0])
    return rec, systems


def v4_against_jax(thomas, ip_staged, run_obca, Formulation, ref):
    """The run of tests/test_multivehicle.py (4 vehicles in two lanes, 4 MPC
    steps, ADMM cap 5, pairs gated at 12 m) on the kernels, held against
    the committed JAX run: states within STATE_TOL, equal ADMM iteration
    counts, and the wide kernel launched."""
    from dlp_admm_torch.config import ObcaConfig, SolverConfig
    prof = json.loads(str(ref["profile"]))
    name = "4-vehicle run vs JAX"
    res, counts, _ = drive(thomas, ip_staged, lambda: run_obca(
        Formulation.CONSENSUS, ocfg=ObcaConfig(**prof["ocfg"]),
        scfg=SolverConfig(**prof["scfg"]), n_steps=prof["steps"],
        dtype=torch.float64, **prof["planner"]))
    check_counts(name, counts, res.extras["planner"].block_solves, ("wide",))
    its = list(res.metrics.iter_history)
    if res.states.shape != ref["states"].shape or not np.all(
            np.isfinite(res.states)):
        raise RuntimeError(f"{name}: states {res.states.shape} not finite "
                           f"or not {ref['states'].shape}")
    err = float(np.abs(res.states - ref["states"]).max())
    log(f"{name}: max |state - JAX fixture| = {err:.3e} (tol "
        f"{STATE_TOL:.0e}); ADMM iterations {its}, JAX "
        f"{ref['iterations'].tolist()}; wall {sum(res.metrics.step_times):.2f}"
        f" s for {len(its)} steps")
    if not err <= STATE_TOL:
        raise RuntimeError(f"{name}: states differ from the JAX fixture: "
                           f"{err}")
    if its != ref["iterations"].tolist():
        raise RuntimeError(f"{name}: ADMM iterations {its} != JAX "
                           f"{ref['iterations'].tolist()}")
    return dict(launches=counts, max_state_err_vs_jax=err, iterations=its,
                jax_iterations=ref["iterations"].tolist(),
                step_wall_s=list(res.metrics.step_times))


def main():
    ap = argparse.ArgumentParser(description="PyTorch port smoke run on CUDA")
    ap.add_argument("--full", action="store_true",
                    help="also run all 42 MPC steps of both profiles, "
                         "the classic PI-ADMM sigmoid A/B, and the whole "
                         "bilevel, tightening and ALADIN runs")
    ap.add_argument("--full-batch", action="store_true",
                    help="also run bench.py's 16 x 20 scenario batch in "
                         "both profiles")
    ap.add_argument("--out", default=None,
                    help="write every record of this run to this JSON file")
    args = ap.parse_args()
    records = {}
    try:
        smoke(args, records)
    except BaseException:
        dump(args.out, records)        # what ran, kept for diagnosis
        raise


def smoke(args, records):
    """The phases in their order; ``records`` gathers every result."""
    t_start = time.perf_counter()

    # -- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA card")
    import dlp_admm_torch  # noqa: F401  (sets the TF32 switches)
    from dlp_admm_torch.config import Formulation
    from dlp_admm_torch.mpc import run_obca
    from dlp_admm_torch.solvers import ip_staged, thomas
    refs = {torch.float64: np.load(FIXTURE),
            torch.float32: np.load(FIXTURE_F32)}
    ref_v4 = np.load(FIXTURE_V4)
    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log(f"device: {kind}; torch {torch.__version__}, cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # -- 2. build -------------------------------------------------------
    with phase(records, "2 build"):
        t0 = time.perf_counter()
        ptxas = thomas.build()
        build_s = time.perf_counter() - t0
        log(f"build: {', '.join(ptxas)} in {build_s:.2f} s")
        # every width class of each type, plain and (where built) equilibrated,
        # and one profiling build of each type
        wide_builds = sum(len(thomas.wide_classes(dt, eq))
                          for dt in thomas.WIDE_CLASSES
                          for eq in (False, True)) + 2
        main_path_plans = [
            (str(dt)[6:].replace("float", "f"), eq,
             thomas.kernel_plan(1, 7, b, dt, eq)) for dt, eq, b in (
                (torch.float64, False, 33), (torch.float64, False, 80),
                (torch.float32, True, 45), (torch.float64, False, 34),
                (torch.float64, False, 66), (torch.float32, True, 34))]
        records.update(build_s=build_s, ptxas=report_build(ptxas, wide_builds,
                                                           main_path_plans))
        # clusters of the cluster kernel's plans the card runs at once; a launch
        # of S systems takes ceil(S / that) waves
        occ = records["cluster_occupancy"] = []
        for b in (108, 264, 320):
            for dt, eq in ((torch.float64, False), (torch.float32, True)):
                plan = thomas.kernel_plan(1, 7, b, dt, eq)
                n = thomas.cluster_max_active(b, dt, eq)
                row = dict(b=b, dtype=str(dt)[6:], equilibrated=eq,
                           cluster=plan["cluster"], prefetch=plan["prefetch"],
                           smem_bytes=plan["smem_bytes"], max_active_clusters=n,
                           waves={k: -(-k // max(n, 1))
                                  for k in (1, 2, 16)})
                log("  " + json.dumps(row))
                occ.append(row)
                if n < 1:
                    raise RuntimeError(f"the card runs no cluster of the plan "
                                       f"{plan}")
        # CTAs of the big kernel's plans the card holds at once (every CTA
        # of a launch must be: a group's CTAs wait on each other's flags)
        occ = records["big_occupancy"] = []
        for b, dt, eq in ((405, torch.float64, False),
                          (605, torch.float32, True)):
            n = thomas.big_co_resident(b, dt, eq)
            plan = thomas.kernel_plan(1, 7, b, dt, eq, co_resident=n)
            row = dict(b=b, dtype=str(dt)[6:], equilibrated=eq,
                       ctas=plan["ctas"], prefetch=plan["prefetch"],
                       tile_in_smem=plan["tile_in_smem"],
                       smem_bytes=plan["smem_bytes"], co_resident_ctas=n,
                       systems_at_once=n // plan["ctas"])
            log("  " + json.dumps(row))
            occ.append(row)
            if n < plan["ctas"]:
                raise RuntimeError(f"the card cannot hold the CTAs of the "
                                   f"plan {plan} at once")

    # -- 3. kernel vs plain version -------------------------------------
    with phase(records, "3 kernels vs plain"):
        rng = np.random.default_rng(0)
        synth = records["kernel_vs_plain"] = []
        for dtype in (torch.float64, torch.float32):
            for s, t, b in (SHAPES + WIDE_SHAPES + BATCH_SHAPES + T14_SHAPES
                            + BIG_SHAPES):
                for kind_, eq in VARIANTS:
                    if (s, t, b) in PAST_REACH and (
                            dtype != PAST_REACH[s, t, b][0]
                            or eq not in PAST_REACH[s, t, b][1]):
                        continue
                    d, u, r = (torch.as_tensor(a, dtype=dtype, device=dev)
                               for a in make_system(rng, s, t, b, kind_))
                    label = (f"{kind_} S={s} T={t} B={b} {str(dtype)[6:]}"
                             f"{' equilibrated' if eq else ''}")
                    # timed at the path shapes in the variant the staged
                    # solver asks for in each type (every shape in both
                    # variants until phases 16-17 joined the run)
                    timed = kind_ == "diag_dominant" and (
                        eq == (dtype != torch.float64)
                        and (s, t, b) in PATH_SHAPES + TIMED_SYNTH_SHAPES
                        or eq and dtype == torch.float64
                        and (s, t, b) in F32_PATH_SHAPES)
                    # the big kernel is timed beside the cluster kernel
                    # where that is timed (108, 320) and at 264
                    other = None
                    want = thomas.block_thomas_plain(d, u, r, eq)
                    synth.append(compare(thomas, d, u, r, label, eq,
                                         timed=timed, other=other,
                                         want=want))
                    if b <= thomas.WARP_MAX_B:
                        synth.append(compare(thomas, d, u, r, label, eq,
                                             kernel="wide", want=want))
                    if (s, t, b) in BIG_SHAPES and b <= 384:
                        synth.append(compare(thomas, d, u, r, label, eq,
                                             kernel="big", want=want))
            # the cluster kernel at the wide kernel's path shapes, in the variant
            # the staged solver asks for (timed beside the wide kernel until
            # phases 16-17 joined the run)
            for s, t, b in CLUSTER_FORCED_SHAPES:
                eq = dtype != torch.float64
                d, u, r = (torch.as_tensor(a, dtype=dtype, device=dev)
                           for a in make_system(rng, s, t, b, "diag_dominant"))
                synth.append(compare(
                    thomas, d, u, r, f"diag_dominant S={s} T={t} B={b} "
                    f"{str(dtype)[6:]}{' equilibrated' if eq else ''}", eq,
                    kernel="cluster"))
        records["cluster_clock_split"] = cluster_split(thomas, rng, dev)
        records["big_graph_replay"] = big_graph_replay(thomas, rng, dev)

    # -- 4, 5. the slices -----------------------------------------------
    with phase(records, "4-5 slices"):
        systems = {}
        paths = {}
        variants = records["launches_by_variant"] = {}
        for name, dtype, tol, same_its in (
                ("slice float64", torch.float64, STATE_TOL, True),
                ("slice float32", torch.float32, STATE_TOL_F32, False)):
            res, counts, kkt = drive(
                thomas, ip_staged, lambda: run_obca(
                    Formulation.CONSENSUS, n_steps=SMOKE_STEPS,
                    **flagship_profile(dtype)))
            pl = res.extras["planner"]
            check_slice(name, res, pl, refs[dtype], counts, dev, tol, same_its)
            records[name] = slice_record(name, res, refs[dtype], counts,
                                         pl.block_solves)
            records[name]["launches_by_variant"] = dict(last_variants)
            variants[name] = dict(last_variants)
            if len(kkt) != 2:
                raise RuntimeError(f"{name}: expected local and edge KKT "
                                   f"shapes, got {sorted(kkt)}")
            systems[name] = kkt
            paths[name] = counts

    # -- 6. the multi-vehicle path --------------------------------------
    with phase(records, "6 multi-vehicle"):
        for num_veh, dtype, expect, tol in (
                (4, torch.float64, ("wide",), STATE_TOL),
                (3, torch.float32, ("warp", "wide"), STATE_TOL_F32)):
            name = f"multi-vehicle V={num_veh} {str(dtype)[6:]}"
            records[name], systems[name] = multi_vehicle(
                thomas, ip_staged, run_obca, Formulation, num_veh, dtype, expect,
                tol, ref_v4 if num_veh == 4 else None)
            paths[name] = records[name]["launches"]
        name = "4-vehicle run vs JAX"
        records[name] = v4_against_jax(thomas, ip_staged, run_obca, Formulation,
                                       ref_v4)
        paths[name] = records[name]["launches"]

    # -- 10. the scenario-batched driver (bench.py's third metric) -----
    with phase(records, "10 scenario batch"):
        records["batch"], one_device = batch_path(
            thomas, ip_staged, paths, systems, refs,
            records["slice float64"], smi)

    # -- 11. the centralized joint planner (K1 at T = 14) --------------
    with phase(records, "11 centralized"):
        records["centralized"] = centralized_path(thomas, ip_staged, paths,
                                                  systems, smi)

    # -- 7. the kernels on the KKT blocks those runs gave them ----------
    with phase(records, "7 kernels on run blocks"):
        real = records["kernel_on_run_blocks"] = []
        for name, kkt in systems.items():
            for key in sorted(kkt):
                d, u, r = kkt[key]
                real.append(dict(compare(
                    thomas, d, u, r, f"{name} KKT S={key[0]} T={key[1]} "
                    f"B={key[2]}", r.dtype != torch.float64,
                    timed=(name, key) in TIMED_RUN_BLOCKS, run_block=True,
                    rowwise=name in ROWWISE_PATHS), path=name))
                if r.dtype == torch.float32:
                    # the variant the path runs: the block raised to float64,
                    # equilibrated (ip_staged.kkt_variant). Held row by row:
                    # the float32 slice's first local block has an equation
                    # (stage 0, 13) of two entries and a zero right-hand side
                    # whose terms sum to 4.7e-16 beside a solution of 1.9e3,
                    # so the entry-by-entry measure asks for that entry to
                    # 1e-31 and is noise for any elimination: the same block
                    # made on the CPU scores 1.2e-11 by the plain version and
                    # 1.0 by LAPACK's LU (tools/raised_block_errors.py)
                    real.append(dict(compare(
                        thomas, d.double(), u.double(), r.double(),
                        f"{name} KKT S={key[0]} T={key[1]} B={key[2]} "
                        f"raised to float64", True,
                        timed=(name, key) in TIMED_RUN_BLOCKS,
                        run_block=True, rowwise=True),
                        path=name + " raised"))
        records["clock_split"] = clock_split(thomas, systems)
        records["kkt_sample"] = kkt_sample(thomas, ip_staged, smi)

    # -- 9. the PI-ADMM path (bench.py's first metric) -----------------
    with phase(records, "9 PI-ADMM"):
        records["pi_admm"] = pi_admm_path(thomas, paths, smi)

    # -- 12. the classic PI-ADMM layout (run_pi_admm's default) --------
    with phase(records, "12 classic PI-ADMM"):
        records["classic"] = classic_path(thomas, paths, smi, args.full)

    # -- 13. the bilevel and tightening planners ------------------------
    with phase(records, "13 fixed-dual"):
        records["fixed_dual"] = fixed_dual_path(thomas, paths, smi, args.full)

    # -- 14. ALADIN -------------------------------------------------------
    with phase(records, "14 ALADIN"):
        records["aladin"] = aladin_path(thomas, paths, smi, args.full)

    # -- 15. checkpoint / resume, the trace stream, profiling, plots -----
    with phase(records, "15 checkpoint/resume"):
        records["resume"] = resume_path(thomas, ip_staged, paths, smi)

    # -- 16. the vehicle axis over ranks that share the card ------------
    with phase(records, "16 sharded"):
        records["sharded"] = sharded_path(thomas, paths, one_device,
                                          records["batch"]["float64"], smi)

    # -- 17. the consensus planner's options ----------------------------
    with phase(records, "17 options"):
        records["options"] = options_path(thomas, ip_staged, paths, smi)

    # -- 8. --full ------------------------------------------------------
    failures = []
    if args.full:
        records["full"] = {}
        for dtype in (torch.float64, torch.float32):
            name = str(dtype)[6:]
            res, counts, _ = drive(
                thomas, ip_staged, lambda: run_obca(
                    Formulation.CONSENSUS, **flagship_profile(dtype)))
            check_counts(f"full {name}", counts,
                         res.extras["planner"].block_solves, ("warp",))
            records["full"][name] = dict(
                full_record(res, refs[dtype], name), launches=counts,
                launches_by_variant=check_variants(f"full {name}", dtype))
            if dtype == torch.float32:
                records["full"][name]["beside_jax_cpu"] = beside_jax_f32(
                    records["full"][name])
            dump(args.out, records)    # kept for diagnosis if a gate fails
        failed = {name: [g for g, ok in rec["gates"].items() if not ok]
                  for name, rec in records["full"].items()}
        failed["ALADIN crossing"] = [
            g for g, ok in records["aladin"]["run_gates"].items() if not ok]
        if any(failed.values()):
            failures.append(f"--full gates failed: {failed}")

    if args.full_batch:
        records["full_batch"] = full_batch(thomas, ip_staged, records, smi,
                                           args.out)
        gates = records["full_batch"]["float64"]["gates"]
        if not all(gates.values()):
            failures.append(f"--full-batch float64 fails bench.py's gates: "
                            f"{gates}")
    if failures:
        dump(args.out, records)
        raise RuntimeError("; ".join(failures))

    kernels = {"kernels": [
        kernel_entry("warp", real, paths, "slice float64", (2, 7, 19),
                     at_shapes=(("slice float32 raised", (2, 7, 19)),
                                ("slice float32", (2, 7, 19))),
                     variants=records["launches_by_variant"]),
        kernel_entry("wide", real, paths, "multi-vehicle V=4 float64",
                     (1, 7, 80), at_shapes=(
                         ("centralized float64", (1, 14, 34)),)),
        kernel_entry("cluster", real, paths, "centralized V=4 float64",
                     (1, 14, 108), at_shapes=(
                         ("consensus V=8 float64", (1, 7, 320)),)),
        kernel_entry("big", real, paths, "consensus V=9 float64",
                     (1, 7, 405))]}
    wall = time.perf_counter() - t_start
    records.update(kernels, paths=paths, device=kind, nvidia_smi=smi,
                   wall_s=wall)
    dump(args.out, records)
    log(f"chip_smoke.py wall (build included): {wall:.1f} s")
    log(json.dumps(kernels))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


def batch_starts(init0, prof):
    """bench.py:249-255: ``init0 [2, 5]`` plus normal jitter of
    ``prof["jitter"]`` m (``default_rng(prof["seed"])``) on every lane's
    positions but lane 0's, ``[n_scen, 2, 5]``."""
    n = prof["n_scen"]
    inits = np.broadcast_to(init0, (n,) + init0.shape).copy()
    pert = prof["jitter"] * np.random.default_rng(prof["seed"]).normal(
        size=(n, 2, 2))
    pert[0] = 0.0
    inits[:, :, :2] += pert
    return inits


def batch_run(thomas, ip_staged, dtype, n_steps, prof):
    """``run_scenario_batch`` of bench.py's third metric on the card, driven
    with the launch counts set to 0 just before; returns the planner, the
    starts, the host arrays, the wall seconds, the counts and the first KKT
    system of each shape."""
    from dlp_admm_torch.models.obca import ConsensusObcaPlanner
    from dlp_admm_torch.parallel.consensus_spmd import run_scenario_batch
    pl = ConsensusObcaPlanner(**flagship_profile(dtype), device=DEVICE)
    inits = batch_starts(pl.refs[:, 0].double().cpu().numpy(), prof)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_scenario_batch(pl, inits, n_steps)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    (res, wall), counts, kkt = drive(thomas, ip_staged, run)
    log(f"batch {str(dtype)[6:]}, {n_steps} steps: device memory reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB, peak "
        f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB")
    return pl, inits, res, wall, counts, kkt


def batch_numbers(res, wall, smi):
    """bench.py's numbers of a batch run (``:262-283``) and the loop's:
    executed ADMM iterations (the slowest lane's, summed over steps) and
    loop efficiency (lane total / (executed x lanes))."""
    states, its, prs, dus, _, gaps = res
    p = states[..., :2]
    n_lanes, n_steps = its.shape
    res_ok = int(((prs <= 0.01) & (dus <= 0.01)).sum())
    executed = int(its.max(axis=0).sum())
    out = dict(
        lanes=n_lanes, steps=n_steps, wall_s=wall,
        wall_per_step_s=wall / n_steps,
        lane_iterations=int(its.sum()),
        lane_iterations_per_s=float(its.sum()) / wall,
        executed_admm_iterations=executed,
        wall_per_executed_iteration_s=wall / executed,
        loop_efficiency=float(its.sum()) / (executed * n_lanes),
        res_ok=res_ok, res_ok_needed=int(np.ceil(BATCH_RES_OK_SHARE
                                                 * its.size)),
        min_distance_m=float(np.linalg.norm(p[:, :, 0] - p[:, :, 1],
                                            axis=-1).min()),
        gap_median=float(np.median(gaps)), gap_max=float(gaps.max()),
        finite=bool(np.all(np.isfinite(states))), nvidia_smi=smi)
    out["gates"] = {
        "finite states": out["finite"],
        f"min distance > {BATCH_MIN_DIST_GATE} m":
            out["min_distance_m"] > BATCH_MIN_DIST_GATE,
        f"res_ok >= {BATCH_RES_OK_SHARE:.0%} of lane-steps":
            res_ok >= BATCH_RES_OK_SHARE * its.size}
    return out


def batch_path(thomas, ip_staged, paths, systems, refs, single, smi):
    """Phase 10: the scenario batch at bench width on the card, float64
    against the JAX fixture, float32 on the bench's gates, and a dense /
    joint batched step against the CPU. Returns the records and the float64
    run's host arrays (phase 16 holds the sharded step to them)."""
    out = {}
    ref = np.load(FIXTURE_BATCH)
    prof = json.loads(str(ref["profile"]))
    n = min(BATCH_SMOKE_STEPS, prof["steps"])
    # -- 10.1 float64 against the JAX run ---------------------------------
    name = "batch float64"
    pl, inits, res, wall, counts, kkt = batch_run(
        thomas, ip_staged, torch.float64, n, prof)
    if not np.array_equal(inits, ref["states"][0]):
        raise RuntimeError(f"{name}: the starts are not the fixture's")
    check_counts(name, counts, pl.block_solves, ("warp",))
    shapes = sorted(kkt)
    log(f"{name}: KKT shapes {shapes}")
    want = sorted([(2 * prof["n_scen"], 7, 19), (prof["n_scen"], 7, 20)])
    if shapes != want:
        raise RuntimeError(f"{name}: KKT shapes {shapes}, expected the "
                           f"locals' and the edges' {want}")
    systems[name] = kkt
    paths[name] = counts
    states, its = res[0], res[1]
    err = np.abs(states[1:] - ref["states"][1:n + 1]).max(axis=(2, 3)).T
    chaotic = np.minimum(ref["chaotic_from"], n)
    lanes = []
    for lane in range(its.shape[0]):
        strict = int(chaotic[lane])
        row = dict(lane=lane, iterations=its[lane].tolist(),
                   jax_iterations=ref["iterations"][lane, :n].tolist(),
                   max_state_err_per_step=err[lane].tolist(),
                   strict_steps=strict)
        log(f"{name} vs JAX: " + json.dumps(row))
        lanes.append(row)
        if not np.array_equal(its[lane, :strict],
                              ref["iterations"][lane, :strict]):
            raise RuntimeError(f"{name} lane {lane}: iterations differ from "
                               f"JAX before step {strict}")
        if strict and not err[lane, :strict].max() <= STATE_TOL:
            raise RuntimeError(f"{name} lane {lane}: states "
                               f"{err[lane, :strict].max():.3e} from JAX "
                               f"before step {strict}")
    one = refs[torch.float64]
    strict = int(chaotic[0])
    lane0 = float(np.abs(states[:strict + 1, 0]
                         - one["states"][:strict + 1]).max())
    log(f"{name}: lane 0 vs the single-scenario fixture {lane0:.3e} over "
        f"{strict} steps, iterations {its[0].tolist()} against "
        f"{one['iterations'][:n].tolist()}")
    if not (lane0 <= STATE_TOL and np.array_equal(
            its[0, :strict], one["iterations"][:strict])):
        raise RuntimeError(f"{name}: lane 0 differs from the single-scenario "
                           f"fixture")
    nums = batch_numbers(res, wall, smi)
    slice_s = single["summary"]
    nums.update(
        lane0_vs_single_fixture=lane0, lanes_vs_jax=lanes,
        launches=counts, block_solves=pl.block_solves, kkt_shapes=shapes,
        single_scenario=dict(
            path="slice float64", wall_per_admm_iteration_s=slice_s[
                "total_time_s"] / max(1, sum(
                    r["iterations"] for r in single["steps"])),
            iterations_per_s=slice_s.get("iterations_per_s")))
    log(f"{name}: " + json.dumps({k: v for k, v in nums.items()
                                  if k != "lanes_vs_jax"}))
    out["float64"] = nums
    out["one_lane"] = one_lane(thomas, ip_staged, pl, inits, res, nums)
    one_device = res
    # -- 10.2 float32, bench.py's gates over its first steps --------------
    name = "batch float32"
    pl, _, res, wall, counts, kkt = batch_run(
        thomas, ip_staged, torch.float32, BATCH_F32_SMOKE_STEPS, prof)
    check_counts(name, counts, pl.block_solves, ("warp",))
    by_variant = check_variants(name, torch.float32)
    systems[name] = kkt
    paths[name] = counts
    nums = batch_numbers(res, wall, smi)
    nums.update(launches=counts, launches_by_variant=by_variant,
                block_solves=pl.block_solves,
                kkt_shapes=sorted(kkt), iterations=res[1].tolist())
    log(f"{name}: " + json.dumps(nums))
    if not all(nums["gates"].values()):
        raise RuntimeError(f"{name} fails bench.py's gates: {nums['gates']}")
    out["float32"] = nums
    out["dense_joint_step"] = dense_joint_step(thomas, paths)
    return out, one_device


def one_lane(thomas, ip_staged, pl, inits, res, nums):
    """S = 1 beside S = 16: the batch's slowest lane (the most ADMM
    iterations over the run, as many as the batch executed) run alone
    through the same driver over the run's first step; equal iterations
    and states within 1e-6 of its lane in the batch (the distance
    printed), and its wall per ADMM iteration beside the batch's wall per
    executed iteration."""
    from dlp_admm_torch.parallel.consensus_spmd import run_scenario_batch
    its = res[1]
    lane = int(its.sum(axis=1).argmax())
    n = 1                # its first step (every step of the batch before)
    its = its[:, :n]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alone = run_scenario_batch(pl, inits[lane:lane + 1], n)
        torch.cuda.synchronize()
        return alone, time.perf_counter() - t0

    (alone, wall), counts, _ = drive(thomas, ip_staged, run)
    err = float(np.abs(alone[0][:, 0] - res[0][:n + 1, lane]).max())
    row = dict(lane=lane, iterations=alone[1][0].tolist(),
               batch_iterations=its[lane].tolist(), wall_s=wall,
               admm_iterations=int(alone[1].sum()),
               wall_per_admm_iteration_s=wall / max(1, int(alone[1].sum())),
               batch_wall_per_executed_iteration_s=nums[
                   "wall_per_executed_iteration_s"],
               max_state_err_vs_batch_lane=err, launches=counts)
    log("batch float64, one lane alone: " + json.dumps(row))
    if not (np.array_equal(alone[1][0], its[lane]) and err <= STATE_TOL):
        raise RuntimeError(f"lane {lane} alone differs from its lane in the "
                           f"batch: {row}")
    return row


def dense_joint_step(thomas, paths):
    """One batched step of 2 lanes with dense local NLPs and the joint edge
    (the first case of ``tests/test_consensus_spmd.py``) on the card, held
    against the same step on the CPU: equal iterations and flags, states and
    ``z_bar`` within 1e-8; JAX's outputs printed beside."""
    from dlp_admm_torch.config import ObcaConfig, SolverConfig
    from dlp_admm_torch.interop import bar_state_from_numpy
    from dlp_admm_torch.models.obca import BarState, ConsensusObcaPlanner
    from dlp_admm_torch.parallel.consensus_spmd import (
        make_consensus_spmd_step)
    ref = np.load(FIXTURE_CASES)
    name = "two_vehicle_reference_problem"
    case = json.loads(str(ref["profile"]))[name]
    lanes = 2
    init = ref[f"{name}__init"][:lanes]
    bs = {f: ref[f"{name}__bs_{f}"][:lanes] for f in BarState._fields}
    outs, walls = {}, {}
    for dev in (DEVICE, "cpu"):
        pl = ConsensusObcaPlanner(
            ObcaConfig(num_veh=case["num_veh"], horizon=case["horizon"],
                       max_admm_iters=2, rho=100.0),
            scfg=SolverConfig(ip_iters=5, ip_tol=1e-6), use_staged=False,
            edge_mode="joint", device=dev)
        step = make_consensus_spmd_step(pl)
        thomas.reset_counts()
        t0 = time.perf_counter()
        o = step(torch.as_tensor(init, device=dev),
                 bar_state_from_numpy(bs, device=dev), 0)
        if dev == DEVICE:
            torch.cuda.synchronize()
            paths["batch dense/joint step"] = dict(thomas.launches_by_kernel)
        walls[dev] = time.perf_counter() - t0
        outs[dev] = [o[0].cpu().numpy(), o[1].z_bar.cpu().numpy(),
                     o[2].cpu().numpy(), o[5].cpu().numpy()]
    card, cpu = outs[DEVICE], outs["cpu"]
    row = dict(
        lanes=lanes, iterations=card[2].tolist(),
        cpu_iterations=cpu[2].tolist(),
        max_state_err_vs_cpu=float(np.abs(card[0] - cpu[0]).max()),
        max_z_bar_err_vs_cpu=float(np.abs(card[1] - cpu[1]).max()),
        max_state_err_vs_jax=float(np.abs(
            card[0] - ref[f"{name}__out_0"][:lanes]).max()),
        wall_s=walls[DEVICE], cpu_wall_s=walls["cpu"],
        launches=paths["batch dense/joint step"])
    log("batch dense/joint step, card vs CPU: " + json.dumps(row))
    if not (np.array_equal(card[2], cpu[2]) and np.array_equal(card[3], cpu[3])
            and row["max_state_err_vs_cpu"] <= 1e-8
            and row["max_z_bar_err_vs_cpu"] <= 1e-8):
        raise RuntimeError(f"the dense/joint batched step on the card differs "
                           f"from the CPU: {row}")
    return row


def full_batch(thomas, ip_staged, records, smi, out_path):
    """``--full-batch``: bench.py's 16 x 20 scenario batch in both profiles,
    with bench.py:266's gates evaluated (the caller fails the run on the
    float64 ones; the float32 ones are reported) and the single-scenario
    numbers of the same card beside them: the 42-step runs of ``--full``
    where it ran, else the 6-step slices, and phase 10's lane run alone."""
    prof = json.loads(str(np.load(FIXTURE_BATCH)["profile"]))
    full = records.get("full", {})
    single = {dt: dict(iterations_per_s=r["summary"].get("iterations_per_s"),
                       wall_s=r["summary"].get("total_time_s"))
              for dt, r in full.items()}
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = f"full batch {str(dtype)[6:]}"
        pl, _, res, wall, counts, _ = batch_run(thomas, ip_staged, dtype,
                                                BATCH_STEPS, prof)
        check_counts(name, counts, pl.block_solves, ("warp",))
        by_variant = check_variants(name, dtype)
        nums = batch_numbers(res, wall, smi)
        if dtype == torch.float32:
            # one run of a chaotic window each: set beside, not gated
            lanes = ((res[2] <= 0.01) & (res[3] <= 0.01)).sum(axis=1)
            nums.update(lane_res_ok=lanes.tolist(),
                        jax_cpu_lane_res_ok=list(JAX_BATCH_F32_CPU_LANES))
            log(f"{name}: res_ok per lane {lanes.tolist()}, JAX on the CPU "
                f"{list(JAX_BATCH_F32_CPU_LANES)}")
        nums.update(launches=counts, launches_by_variant=by_variant,
                    block_solves=pl.block_solves,
                    iterations=res[1].tolist(),
                    jax_quality=JAX_BATCH_QUALITY,
                    jax_cpu=(JAX_BATCH_F32_CPU if dtype == torch.float32
                             else None),
                    single_scenario_same_card=single.get(str(dtype)[6:])
                    or records["slice " + str(dtype)[6:]]["summary"],
                    one_lane_alone=records["batch"]["one_lane"])
        log(f"{name}: " + json.dumps(nums))
        out[str(dtype)[6:]] = nums
        records["full_batch"] = out
        dump(out_path, records)        # kept for diagnosis if a gate fails
    return out


def bench_engine(prof, dtype):
    """``bench.py``'s PI-ADMM engine (its first metric) on the card, from a
    fixture's profile."""
    from dlp_admm_torch.config import (DualUpdateConfig, PiAdmmConfig,
                                       SolverConfig)
    from dlp_admm_torch.models.pi_admm import PiAdmmEngine
    from dlp_admm_torch.scenarios import pi_admm_overtake_refs
    v = prof["num_veh"]
    cfg = PiAdmmConfig(num_veh=v, horizon=prof["horizon"],
                       speeds=tuple(8.0 if i % 2 == 0 else 4.0
                                    for i in range(v)),
                       iter_num=prof["iter_cap"], **prof["cfg"])
    refs, _ = pi_admm_overtake_refs(cfg)
    return PiAdmmEngine(cfg, DualUpdateConfig(**prof["dual"]),
                        SolverConfig(**prof["solver"]), refs=refs,
                        dtype=dtype, device=DEVICE, **prof["engine"])


def fused_run(thomas, eng, prof, xts, chunk=None):
    """One ``run_fused_batch`` call on the card between two synchronizes;
    returns the records as numpy arrays, the wall seconds, the trips the
    loop executed and the block-Thomas launches (counted and captured)
    during the call, which must be none."""
    kw = {} if chunk is None else dict(chunk=chunk)
    us = np.zeros(xts.shape[:2] + (prof["horizon"],), xts.dtype)
    thomas.reset_counts()
    captured = dict(thomas.captured)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = eng.run_fused_batch(xts, us, prof["n_steps"], prof["iter_budget"],
                              **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = dict(thomas.launches_by_kernel)
    k1_captured = {k: n - captured[k] for k, n in thomas.captured.items()}
    if any(k1.values()) or any(k1_captured.values()):
        raise RuntimeError(f"the PI-ADMM path launched block-Thomas kernels: "
                           f"{k1}, captured {k1_captured}")
    rec = {k: x.cpu().numpy() for k, x in rec._asdict().items()}
    return rec, wall, eng.fused_trips, k1


def fused_quality(xts, rec):
    """bench.py's quality numbers: minimum pairwise distance over every
    visited state, converged fraction, capped lanes, finiteness."""
    h = np.concatenate([xts[:, None], rec["xt"]], axis=1)[..., :2]
    d = np.linalg.norm(h[:, :, :, None] - h[:, :, None], axis=-1)
    v = h.shape[2]
    capped = int(np.sum(~rec["converged"]))
    return dict(min_distance_m=float((d + 1e9 * np.eye(v)).min()),
                converged_fraction=1.0 - capped / rec["converged"].size,
                capped_lanes=capped, finite=bool(np.all(np.isfinite(h))))


def same_bits(name, a, b):
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise RuntimeError(f"{name}: {k} differs")


def pi_admm_path(thomas, paths, smi):
    """Phase 9: the PI-ADMM pairwise engine's fused batch at the width of
    bench.py's first metric, float64 against the JAX fixture and float32 on
    the bench's own run, repeatability and chunking."""
    out = {}
    # -- 9.1 float64, the fixture's 2 lanes ------------------------------
    ref = np.load(FIXTURE_PI)
    prof = json.loads(str(ref["profile"]))
    eng = bench_engine(prof, torch.float64)
    rec, wall, trips, k1 = fused_run(thomas, eng, prof, ref["xts0"])
    paths["PI-ADMM fused batch float64"] = k1
    err = np.abs(rec["xt"] - ref["xt"]).max(axis=(2, 3))        # [S, steps]
    rows = []
    for lane in range(err.shape[0]):
        strict = PI_CHAOTIC_FROM[lane]
        row = dict(lane=lane, iterations=rec["iterations"][lane].tolist(),
                   jax_iterations=ref["iterations"][lane].tolist(),
                   max_state_err_per_step=err[lane].tolist(),
                   strict_steps=strict)
        log("PI-ADMM float64 vs JAX: " + json.dumps(row))
        rows.append(row)
        if not np.array_equal(rec["iterations"][lane, :strict],
                              ref["iterations"][lane, :strict]):
            raise RuntimeError(f"PI-ADMM float64 lane {lane}: iterations "
                               f"differ from JAX before step {strict}")
        if not err[lane, :strict].max() <= STATE_TOL:
            raise RuntimeError(f"PI-ADMM float64 lane {lane}: states "
                               f"{err[lane, :strict].max():.3e} from JAX "
                               f"before step {strict}")
    out["float64"] = dict(lanes=rows, wall_s=wall, trips=trips,
                          quality=fused_quality(ref["xts0"], rec),
                          jax_quality=dict(min_distance_m=float(
                              ref["min_distance_m"])))
    # -- 9.2 float32, bench.py's own run ----------------------------------
    ref32 = np.load(FIXTURE_PI_F32)
    prof32 = json.loads(str(ref32["profile"]))
    xts = ref32["xts0"]
    eng = bench_engine(prof32, torch.float32)
    warm, warm_wall, _, _ = fused_run(thomas, eng, prof32, xts)
    rec, wall, trips, k1 = fused_run(thomas, eng, prof32, xts)
    paths["PI-ADMM fused batch float32"] = k1
    one, _, one_trips, _ = fused_run(thomas, eng, prof32, xts, chunk=1)
    # -- 9.3 repeatability and chunking -----------------------------------
    same_bits("PI-ADMM float32, second call", warm, rec)
    same_bits("PI-ADMM float32, chunk 1", one, rec)
    q = fused_quality(xts, rec)
    its = rec["iterations"]
    totals = its.sum(axis=1)
    jq = dict(min_distance_m=float(ref32["min_distance_m"]),
              converged_fraction=1.0 - float(np.sum(~ref32["converged"]))
              / ref32["converged"].size,
              capped_lanes=int(np.sum(~ref32["converged"])),
              lane_totals=ref32["iterations"].sum(axis=1).tolist())
    row = dict(wall_s=wall, warmup_wall_s=warm_wall,
               iterations_per_s=float(its.sum()) / wall,
               total_iterations=int(its.sum()), executed_trips=trips,
               chunk_one_trips=one_trips,
               max_lane_total=int(totals.max()),
               loop_efficiency=float(totals.mean()) / trips,
               lane_totals=totals.tolist(), **q, jax_cpu_run=jq,
               nvidia_smi=smi)
    log("PI-ADMM float32 bench run: " + json.dumps(row))
    if not (q["finite"] and q["min_distance_m"] > PI_MIN_DIST_GATE
            and q["converged_fraction"] >= PI_CONV_FRAC_GATE):
        raise RuntimeError(f"PI-ADMM float32 bench run fails bench.py's "
                           f"gates: {q}")
    out["float32"] = row
    return out


class CountReplays:
    """Stands in for ``thomas.replay`` during a run and counts the CUDA graph
    replays of the staged solver's IP trips."""

    def __init__(self, replay):
        self.replay, self.n = replay, 0

    def __call__(self, graph, variants):
        self.n += 1
        return self.replay(graph, variants)


def drive_centralized(thomas, ip_staged, run, solve=None):
    """:func:`drive` that also counts the graph replays and times the run
    between two synchronizes; returns ``(result, counts, systems, replays,
    wall_s)``."""
    keep = thomas.replay
    counter = thomas.replay = CountReplays(keep)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    try:
        (res, wall), counts, kkt = drive(thomas, ip_staged, timed, solve)
    finally:
        thomas.replay = keep
    return res, counts, kkt, counter.n, wall


def oracle_gates(states, converged, min_dis):
    """tests/test_parity_oracle.py:100-140's gates on the centralized run:
    finite states, footprint gap >= 0.8 min_dis at every visited state, at
    least 24 of 30 steps converged, an overtake gain over 15 m."""
    from dlp_admm_torch.ops.geometry import vehicle_vertices
    corners = vehicle_vertices(torch.as_tensor(states,
                                               dtype=torch.float64)).numpy()
    gap = float(min(polygon_gap(c[0], c[1]) for c in corners))
    gain = float((states[-1, 0, 0] - states[-1, 1, 0])
                 - (states[0, 0, 0] - states[0, 1, 0]))
    nums = dict(min_footprint_gap_m=gap, converged=int(np.sum(converged)),
                overtake_gain_m=gain,
                finite=bool(np.all(np.isfinite(states))))
    gates = {"finite states": nums["finite"],
             f"footprint gap >= {ORACLE_MARGIN} min_dis":
                 gap >= ORACLE_MARGIN * min_dis,
             f"converged >= {ORACLE_MIN_CONVERGED}/30":
                 nums["converged"] >= ORACLE_MIN_CONVERGED,
             f"overtake gain > {ORACLE_MIN_GAIN_M} m":
                 gain > ORACLE_MIN_GAIN_M}
    return nums, gates


def centralized_solve_at(thomas, ip_staged, paths, systems, ref, prof, v,
                         kernel, width, plain):
    """One staged ``solve_at`` of the centralized planner with ``v``
    vehicles at step 0 on the kernels (all its K1 launches by ``kernel`` at
    (1, 14, ``width``), as many as its block solves) and on their plain
    version on the card, held against JAX's solve in
    ``tests/data/obca_centralized_v4_ref.npz``: both converged, states
    within STATE_TOL of JAX's and of each other; the IP trips printed beside
    JAX's, as the two reach the same optimum along paths that part at the
    rounding level. Where JAX itself, its start moved by 1e-12, leaves its
    optimum (the file's ``v{v}_moved_*``: at 4 vehicles 4 of 6 moved starts
    end 7-9 m away after 300 trips), the solve is chaotic and, as every
    strict check of this script stops where JAX leaves itself, the
    comparison is printed and not gated; instead JAX's moved starts are
    solved on the kernels, and at least as many of them as in JAX must
    reach JAX's optimum (converged, states within STATE_TOL). The KKT
    blocks of the path are still held to the plain version in phase 7."""
    from dlp_admm_torch.config import ObcaConfig, SolverConfig, VehicleConfig
    from dlp_admm_torch.models.obca import CentralizedObcaPlanner
    name = f"centralized V={v} float64"
    trips = CEN_V4_IP_ITERS if v == 4 else prof["ip_iters"][str(v)]

    def solve(seed=None):
        pl = CentralizedObcaPlanner(
            ObcaConfig(**prof["ocfg"], num_veh=v), VehicleConfig(),
            SolverConfig(ip_iters=trips), device=DEVICE)
        init = pl.refs[:, 0, :]
        if seed is not None:        # the fixture's start moved by its noise
            m = prof["moved"]
            init = init + torch.as_tensor(
                m["noise"] * np.random.default_rng(seed).normal(
                    size=tuple(init.shape)), dtype=init.dtype,
                device=init.device)
        return pl, pl.solve_at(init, 0)

    (pl, (xs, _, _, sol)), counts, kkt, replays, wall = drive_centralized(
        thomas, ip_staged, solve)
    check_counts(name, counts, pl.block_solves, (kernel,))
    if counts[kernel] != pl.block_solves or sorted(kkt) != [(1, 14, width)]:
        raise RuntimeError(f"{name}: launches {counts} at {sorted(kkt)}, "
                           f"expected {pl.block_solves} of {kernel} at "
                           f"(1, 14, {width})")
    (_, (xs_p, _, _, sol_p)), plain_counts, _, _, wall_p = \
        drive_centralized(thomas, ip_staged, solve, solve=plain)
    if sum(plain_counts.values()):
        raise RuntimeError(f"{name}: the plain run launched {plain_counts}")
    systems[name] = kkt
    paths[name] = counts
    xs, xs_p = xs.cpu().numpy(), xs_p.cpu().numpy()
    row = dict(kkt_shapes=sorted(kkt), iterations=int(sol.iterations),
               plain_iterations=int(sol_p.iterations),
               jax_iterations=int(ref[f"v{v}_iterations"]), ip_iters=trips,
               converged=bool(sol.converged),
               plain_converged=bool(sol_p.converged),
               jax_converged=bool(ref[f"v{v}_converged"]),
               max_state_err_vs_plain=float(np.abs(xs - xs_p).max()),
               max_state_err_vs_jax=float(np.abs(
                   xs - ref[f"v{v}_states"]).max()),
               max_x_err_vs_jax=float(np.abs(
                   sol.x.cpu().numpy() - ref[f"v{v}_x"]).max()),
               wall_s=wall, plain_wall_s=wall_p, launches=counts,
               block_solves=pl.block_solves, graph_replays=replays)
    moved = f"v{v}_moved_converged"
    if moved in ref.files:
        row.update(jax_moved_iterations=ref[f"v{v}_moved_iterations"].tolist(),
                   jax_moved_converged=ref[moved].tolist(),
                   jax_moved_state_err=ref[f"v{v}_moved_state_err"].tolist())
    row["strict"] = moved not in ref.files or bool(
        np.all(ref[moved]) and np.max(ref[f"v{v}_moved_state_err"])
        <= STATE_TOL)
    log(f"{name}: " + json.dumps(row))
    if not np.all(np.isfinite(xs)) or xs.shape != ref[f"v{v}_states"].shape:
        raise RuntimeError(f"{name}: states {xs.shape} not finite")
    if not row["strict"]:
        # JAX's own moved starts, on the kernels: at least as many must
        # reach JAX's optimum (converged, states within STATE_TOL) as
        # reached it in JAX
        runs = []
        for seed in prof["moved"]["seeds"]:
            (plm, (xm, _, _, solm)), cm, km, _, wm = drive_centralized(
                thomas, ip_staged, lambda: solve(seed))
            if cm[kernel] != plm.block_solves or sorted(km) != [
                    (1, 14, width)] or not np.all(np.isfinite(
                        xm.cpu().numpy())):
                raise RuntimeError(f"{name} moved start {seed}: launches "
                                   f"{cm} at {sorted(km)} or states not "
                                   f"finite")
            err = float(np.abs(xm.cpu().numpy()
                               - ref[f"v{v}_states"]).max())
            runs.append(dict(seed=seed, iterations=int(solm.iterations),
                             converged=bool(solm.converged),
                             max_state_err_vs_jax=err, wall_s=wm,
                             launches=cm, block_solves=plm.block_solves,
                             at_jax=bool(solm.converged)
                             and err <= STATE_TOL))
        jax_at = int(np.sum(np.asarray(ref[moved])
                            & (ref[f"v{v}_moved_state_err"] <= STATE_TOL)))
        row.update(moved_runs=runs, moved_at_jax=sum(
            r["at_jax"] for r in runs), jax_moved_at_jax=jax_at)
        log(f"{name} from JAX's moved starts: " + json.dumps(dict(
            runs=runs, at_jax=row["moved_at_jax"], jax_at_jax=jax_at)))
        if row["moved_at_jax"] < jax_at:
            raise RuntimeError(f"{name}: {row['moved_at_jax']} of the moved "
                               f"starts reach JAX's optimum on the card, "
                               f"{jax_at} in JAX")
    if row["strict"] and not (
            row["converged"] and row["plain_converged"]
            and row["max_state_err_vs_plain"] <= STATE_TOL
            and row["max_state_err_vs_jax"] <= STATE_TOL):
        raise RuntimeError(f"{name}: differs from the plain-version run or "
                           f"from JAX: {row}")
    return row


def centralized_path(thomas, ip_staged, paths, systems, smi):
    """Phase 11: the centralized joint planner on the card. Its staged solve
    is one lane of 14 stages (horizon 15), so every IP trip's KKT solves go
    through K1 at T = 14."""
    from dlp_admm_torch.config import (Formulation, ObcaConfig, SolverConfig,
                                       VehicleConfig)
    from dlp_admm_torch.models.obca import CentralizedObcaPlanner
    from dlp_admm_torch.mpc import run_obca
    out = {}
    ref = np.load(FIXTURE_CEN)
    prof = json.loads(str(ref["profile"]))

    plain = plain_solve(thomas, ip_staged)

    # -- 11.1 run_obca(CENTRALIZED), float64, against the JAX run ---------
    name = "centralized float64"
    n = min(prof["steps"], CEN_SMOKE_STEPS)
    res, counts, kkt, replays, wall = drive_centralized(
        thomas, ip_staged, lambda: run_obca(Formulation.CENTRALIZED,
                                            n_steps=n))
    pl = res.extras["planner"]
    check_counts(name, counts, pl.block_solves, ("wide",))
    if sorted(kkt) != [(1, 14, 34)]:
        raise RuntimeError(f"{name}: KKT shapes {sorted(kkt)}, expected "
                           f"[(1, 14, 34)]")
    systems[name] = kkt
    paths[name] = counts
    its = np.asarray(res.metrics.iter_history)
    if res.states.shape != (n + 1, 2, 5) or not np.all(
            np.isfinite(res.states)):
        raise RuntimeError(f"{name}: states {res.states.shape} not finite "
                           f"or not {(n + 1, 2, 5)}")
    err = np.abs(res.states[1:] - ref["states"][1:n + 1]).max(axis=(1, 2))
    strict = min(int(ref["chaotic_from"]), n)
    # a solve converged where its final KKT error is under ip_tol (1e-6)
    row = dict(iterations=its.tolist(),
               jax_iterations=ref["iterations"][:n].tolist(),
               max_state_err_per_step=err.tolist(), strict_steps=strict,
               converged=int(np.sum(np.asarray(
                   res.metrics.extras["kkt"]) < pl.scfg.ip_tol)),
               jax_converged=int(ref["converged"][:n].sum()))
    log(f"{name} vs JAX: " + json.dumps(row))
    if not np.array_equal(its[:strict], ref["iterations"][:strict]):
        raise RuntimeError(f"{name}: IP iterations differ from JAX before "
                           f"step {strict}")
    if not err[:strict].max() <= STATE_TOL:
        raise RuntimeError(f"{name}: states {err[:strict].max():.3e} from "
                           f"JAX before step {strict}")
    steps = res.metrics.step_times
    nums = dict(row, wall_s=wall, wall_per_step_s=wall / n,
                step_wall_s=steps, ip_trips=int(its.sum()),
                ip_trips_per_step=float(its.mean()), graph_replays=replays,
                launches=counts, block_solves=pl.block_solves,
                kkt_shapes=sorted(kkt), nvidia_smi=smi,
                reserved_gib=torch.cuda.memory_reserved() / 2**30)
    log(f"{name}: {n} steps, wall {wall:.3f} s ({wall / n:.4f} s a step), "
        f"{int(its.sum())} IP trips ({float(its.mean()):.2f} a step), "
        f"{replays} graph replays, K1 {counts}")
    out["float64"] = nums

    # -- 11.2 3 and 4 vehicles: K1 at (1, 14, 66) and (1, 14, 108) -------
    v4 = np.load(FIXTURE_CEN_V4)
    v4prof = json.loads(str(v4["profile"]))
    for v, kernel, width in ((3, "wide", 66), (4, "cluster", 108)):
        out[f"v{v}"] = centralized_solve_at(
            thomas, ip_staged, paths, systems, v4, v4prof, v, kernel, width,
            plain)

    # -- 11.3 tests/test_parity_oracle.py's gates, centralized side -------
    name = "centralized oracle float64"
    o = prof["oracle"]
    plo = CentralizedObcaPlanner(
        ObcaConfig(**o["ocfg"]), VehicleConfig(), SolverConfig(**o["scfg"]),
        warm_mode=o["warm_mode"], device=DEVICE)
    (states, _, _, _, cvs), counts, kkt, replays, wall = drive_centralized(
        thomas, ip_staged, lambda: plo.run_scan(o["steps"]))
    check_counts(name, counts, plo.block_solves, ("wide",))
    paths[name] = counts
    nums, gates = oracle_gates(states, cvs, o["ocfg"]["min_dis"])
    jax_nums, _ = oracle_gates(ref["oracle_states"], ref["oracle_converged"],
                               o["ocfg"]["min_dis"])
    row = dict(nums, gates=gates, jax=jax_nums, wall_s=wall,
               launches=counts, graph_replays=replays,
               max_state_err_vs_jax=float(np.abs(
                   states - ref["oracle_states"]).max()))
    log(f"{name}: " + json.dumps(row))
    if not all(gates.values()):
        raise RuntimeError(f"{name} fails the parity oracle's gates: {gates}")
    out["oracle"] = row

    # -- 11.4 float32, tests/test_obca.py:18-27's tracking gates ----------
    name = "centralized float32"
    res, counts, kkt, replays, wall = drive_centralized(
        thomas, ip_staged, lambda: run_obca(
            Formulation.CENTRALIZED, n_steps=3, dtype=torch.float32,
            scfg=SolverConfig(ip_iters=40, ip_tol=1e-4)))
    pl = res.extras["planner"]
    check_counts(name, counts, pl.block_solves, ("wide",))
    systems[name] = kkt
    paths[name] = counts
    st = res.states
    kkts = np.asarray(res.metrics.extras["kkt"])
    gates = {"converged every step": bool(np.all(kkts < pl.scfg.ip_tol)),
             "finite states": bool(np.all(np.isfinite(st))),
             "tracks 20 / 10 m/s within 0.02 m": bool(
                 np.abs(st[:, 0, 0] - 2.0 * np.arange(4)).max() <= 0.02
                 and np.abs(st[:, 1, 0] - 20 - np.arange(4)).max() <= 0.02
                 and np.abs(st[:, :, 1]).max() <= 0.02)}
    row = dict(iterations=res.metrics.iter_history, kkt=kkts.tolist(),
               max_state_err_vs_f64_fixture=float(np.abs(
                   st - ref["states"][:4]).max()),
               gates=gates, wall_s=wall, launches=counts,
               graph_replays=replays, kkt_shapes=sorted(kkt))
    log(f"{name}: " + json.dumps(row))
    if not all(gates.values()):
        raise RuntimeError(f"{name} fails the tracking gates: {gates}")
    out["float32"] = row

    # -- 11.5 one consensus step of 8 vehicles (the 320-wide edge) and of
    # 9 (the 405-wide edge, past the cluster's reach) ---------------------
    out["consensus V=8"] = consensus_step(thomas, ip_staged, paths, systems,
                                          smi, 8, "cluster", V8_STATE_TOL)
    out["consensus V=9"] = consensus_step(thomas, ip_staged, paths, systems,
                                          smi, 9, "big", V9_STATE_TOL,
                                          np.load(FIXTURE_V9))
    return out


def consensus_step(thomas, ip_staged, paths, systems, smi, num_veh, kernel,
                   state_tol, ref=None):
    """One consensus MPC step of ``num_veh`` vehicles with
    ``tools/exp_obca_batch.py v8``'s planner settings (horizon 8, ``min_dis``
    0.1, rho 100, prox 700 x 1.5, ``ip_iters`` 40, ``ip_tol`` 1e-4) in
    float64, the staged edge, ADMM cap 2: at 8 vehicles its locals solve at
    (8, 7, 61) and its edge at (1, 7, 320), at 9 at (9, 7, 68) and
    (1, 7, 405). On the kernels and on their plain version, on the card:
    states within ``state_tol``, equal ADMM iterations and IP trips,
    launches equal to block solves, ``kernel`` launched. ``ref``: the JAX
    run of the same step, held to STATE_TOL and equal ADMM iterations
    unless JAX, its start moved by 1e-12, leaves itself (``chaotic``),
    where the distance is printed; with it the plain version's run, its
    ``z_bar`` moved by MOVE_NOISE as JAX's was, is printed beside JAX's
    moved run."""
    from dlp_admm_torch.config import Formulation, ObcaConfig, SolverConfig
    from dlp_admm_torch.models import obca
    from dlp_admm_torch.mpc import run_obca
    name = f"consensus V={num_veh} float64"

    def run():
        return run_obca(
            Formulation.CONSENSUS,
            ocfg=ObcaConfig(num_veh=num_veh, horizon=8, min_dis=0.1,
                            rho=100.0, max_admm_iters=2),
            scfg=SolverConfig(ip_iters=40, ip_tol=1e-4), n_steps=1,
            dtype=torch.float64, local_prox=700.0, prox_growth=1.5,
            prox_tau_max=1.0e9)

    def plain(diag, upper, rhs):
        return thomas.block_thomas_plain(diag, upper, rhs, False)

    @contextlib.contextmanager
    def moved():
        """The planner's first z_bar moved by MOVE_NOISE (numpy's normal
        draws from MOVE_SEED, as the JAX fixture's moved run)."""
        keep = obca.ConsensusObcaPlanner.create_bar_state

        def create_bar_state(self):
            bs = keep(self)
            eps = MOVE_NOISE * np.random.default_rng(MOVE_SEED).normal(
                size=tuple(bs.z_bar.shape))
            return bs._replace(z_bar=bs.z_bar + torch.as_tensor(
                eps, dtype=bs.z_bar.dtype, device=bs.z_bar.device))
        obca.ConsensusObcaPlanner.create_bar_state = create_bar_state
        try:
            yield
        finally:
            obca.ConsensusObcaPlanner.create_bar_state = keep

    def counted(solve=None):
        """drive() with every staged solve's IP trips recorded, and the
        wall between two synchronizes."""
        trips, keep = [], obca.solve_staged

        def solve_staged(*a, **kw):
            sol = keep(*a, **kw)
            trips.append(int(sol.iterations.max()))
            return sol
        obca.solve_staged = solve_staged
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, counts, kkt = drive(thomas, ip_staged, run, solve)
            wall = time.perf_counter() - t0
        finally:
            obca.solve_staged = keep
        return res, counts, kkt, trips, wall

    res, counts, kkt, trips, wall = counted()
    pl = res.extras["planner"]
    check_counts(name, counts, pl.block_solves, (kernel,))
    want, plain_counts, _, plain_trips, plain_wall = counted(plain)
    if sum(plain_counts.values()):
        raise RuntimeError(f"{name}: the plain run launched {plain_counts}")
    if res.states.shape != (2, num_veh, 5) or not np.all(
            np.isfinite(res.states)):
        raise RuntimeError(f"{name}: states {res.states.shape} not finite")
    err = float(np.abs(res.states - want.states).max())
    systems[name] = kkt
    paths[name] = counts
    row = dict(kkt_shapes=sorted(kkt), launches=counts,
               block_solves=pl.block_solves,
               plain_block_solves=want.extras["planner"].block_solves,
               iterations=res.metrics.iter_history,
               plain_iterations=want.metrics.iter_history, ip_trips=trips,
               plain_ip_trips=plain_trips, max_state_err_vs_plain=err,
               state_tol=state_tol, wall_s=wall, plain_wall_s=plain_wall,
               nvidia_smi=smi)
    if ref is not None:
        with moved():
            mwant, mcounts, _, mtrips, _ = counted(plain)
        if sum(mcounts.values()):
            raise RuntimeError(f"{name}: the plain run launched {mcounts}")
        row.update(max_state_err_vs_jax=float(np.abs(
            res.states - ref["states"]).max()),
            jax_iterations=ref["iterations"].tolist(),
            jax_chaotic=bool(ref["chaotic"]),
            jax_moved_state_err=float(ref["moved_state_err"]),
            plain_moved_state_err=float(np.abs(
                mwant.states - want.states).max()),
            plain_moved_ip_trips=mtrips,
            plain_moved_iterations=mwant.metrics.iter_history,
            plain_moved_state_err_vs_jax_moved=float(np.abs(
                mwant.states - ref["moved_states"]).max()))
    log(f"{name}: " + json.dumps(row))
    if not (err <= state_tol and trips == plain_trips
            and res.metrics.iter_history == want.metrics.iter_history):
        raise RuntimeError(f"{name}: differs from the plain-version run "
                           f"(states {err:.3e} against {state_tol:.3e}"
                           f", trips {trips} against {plain_trips})")
    if ref is not None and not ref["chaotic"] and not (
            row["max_state_err_vs_jax"] <= STATE_TOL
            and res.metrics.iter_history == ref["iterations"].tolist()):
        raise RuntimeError(f"{name}: differs from the JAX run (states "
                           f"{row['max_state_err_vs_jax']:.3e}, ADMM "
                           f"iterations {res.metrics.iter_history} against "
                           f"{ref['iterations'].tolist()})")
    return row


def k1_free_run(thomas, name, paths, run, owner):
    """``run()`` on the card between two synchronizes, with the
    block-Thomas counts set to 0 just before and read just after: the path
    must launch and capture none, and ``extras[owner]`` (the engine or
    planner) must sit on the card. Returns the result and the wall
    seconds."""
    thomas.reset_counts()
    captured = dict(thomas.captured)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = dict(thomas.launches_by_kernel)
    k1_captured = {k: c - captured[k] for k, c in thomas.captured.items()}
    if any(k1.values()) or any(k1_captured.values()):
        raise RuntimeError(f"{name} launched block-Thomas kernels: {k1}, "
                           f"captured {k1_captured}")
    if res.extras[owner].device.type != torch.device(DEVICE).type:
        raise RuntimeError(f"{name} ran on {res.extras[owner].device}")
    paths[name] = k1
    return res, wall


def classic_run(thomas, name, paths, **kw):
    """``run_pi_admm(**kw)`` through :func:`k1_free_run`."""
    from dlp_admm_torch.mpc import run_pi_admm
    return k1_free_run(thomas, name, paths, lambda: run_pi_admm(**kw),
                       "engine")


def _dual_cfg(kw):
    from dlp_admm_torch.config import DualStrategy, DualUpdateConfig, WindupMode
    kw = dict(kw, strategy=DualStrategy[kw["strategy"]],
              windup=WindupMode[kw["windup"]])
    return DualUpdateConfig(**kw)


def classic_path(thomas, paths, smi, full):
    """Phase 12: the classic PI-ADMM layout, ``run_pi_admm()``'s default, on
    the card: the default run against the JAX fixture, the paper's A/B of
    PI-reciprocal against plain dual ascent, and with ``full`` the sigmoid
    schedule's safety A/B."""
    from dlp_admm_torch.config import PiAdmmConfig, SolverConfig
    out = {}
    ref = np.load(FIXTURE_CLASSIC)
    prof = json.loads(str(ref["profile"]))
    # -- 12.1 run_pi_admm() against the JAX run ----------------------------
    name = "PI-ADMM classic float64"
    # the default run drives the first CLASSIC_SMOKE_STEPS of the steps
    # held strictly (through JAX's own chaotic step), --full all of them
    n = len(ref["xt"]) if full else min(int(ref["chaotic_from"]) + 1,
                                        CLASSIC_SMOKE_STEPS)
    strict = min(int(ref["chaotic_from"]), n)
    res, wall = classic_run(thomas, name, paths, n_steps=n)
    its = np.asarray(res.metrics.iter_history)
    ref = {k: ref[k][:n] if k in ("xt", "iterations") else ref[k]
           for k in ref.files}
    err = np.abs(res.states - ref["xt"]).max(axis=(1, 2))
    d = np.linalg.norm(res.states[:, 0, :2] - res.states[:, 1, :2], axis=-1)
    row = dict(iterations=its.tolist(),
               jax_iterations=ref["iterations"].tolist(),
               max_state_err_per_step=err.tolist(), strict_steps=strict,
               sum_iter_num=int(its.sum()),
               jax_sum_iter_num=int(ref["iterations"].sum()),
               min_distance_m=float(d.min()), wall_s=wall,
               wall_per_step_s=wall / len(its),
               wall_per_iteration_s=wall / max(int(its.sum()), 1),
               nvidia_smi=smi)
    log(f"{name} vs JAX: " + json.dumps(row))
    if res.states.shape != ref["xt"].shape or not np.all(
            np.isfinite(res.states)):
        raise RuntimeError(f"{name}: states {res.states.shape} not finite")
    if not np.array_equal(its[:strict], ref["iterations"][:strict]):
        raise RuntimeError(f"{name}: iterations differ from JAX before step "
                           f"{strict}")
    if not err[:strict].max() <= STATE_TOL:
        raise RuntimeError(f"{name}: states {err[:strict].max():.3e} from "
                           f"JAX before step {strict}")
    out["default"] = row

    # -- 12.2 the paper's A/B, tests/test_pi_vs_plain.py:43-52 -------------
    def ab(tag, cfg=None):
        got = {}
        for arm in ("pi", "plain"):
            r, w = classic_run(
                thomas, f"PI-ADMM classic A/B {tag} {arm}", paths,
                cfg=cfg, dual_cfg=_dual_cfg(prof[f"{tag}_{arm}"]),
                scfg=SolverConfig(**prof["ab_solver"]))
            x = r.states
            key = f"{tag}_{arm}" if tag == "sig" else f"ab_{arm}"
            got[arm] = dict(
                sum_iter_num=int(r.metrics.total_iterations),
                jax_sum_iter_num=int(ref[f"{key}_iterations"].sum()),
                min_distance_m=float(np.linalg.norm(
                    x[:, 0, :2] - x[:, 1, :2], axis=-1).min()),
                jax_min_distance_m=float(np.linalg.norm(
                    ref[f"{key}_xt"][:, 0, :2] - ref[f"{key}_xt"][:, 1, :2],
                    axis=-1).min()),
                finite=bool(np.all(np.isfinite(x))), wall_s=w)
        log(f"PI-ADMM classic A/B {tag}: " + json.dumps(got))
        return got

    got = ab("ab")
    ok = (got["pi"]["sum_iter_num"] < PI_AB_RATIO
          * got["plain"]["sum_iter_num"]
          and all(a["finite"] and a["min_distance_m"] > PI_AB_MIN_DIST
                  for a in got.values()))
    out["ab"] = dict(got, gate_passed=ok)
    if not ok:
        raise RuntimeError(f"PI-ADMM classic A/B fails test_pi_vs_plain's "
                           f"gates: {got}")
    if full:
        # -- 12.3 --full: the sigmoid schedule's safety A/B ----------------
        cfg = PiAdmmConfig(**prof["sig_cfg"])
        got = ab("sig", cfg)
        ok = (got["plain"]["min_distance_m"] < cfg.dis_thres
              < got["pi"]["min_distance_m"])
        out["sig"] = dict(got, gate_passed=ok)
        if not ok:
            raise RuntimeError(f"PI-ADMM classic sigmoid A/B fails "
                               f"test_pi_vs_plain's gates: {got}")
    return out


def _per_step_err(states, ref_states):
    return np.abs(states - ref_states).reshape(len(states), -1).max(axis=1)


def fixed_dual_path(thomas, paths, smi, full):
    """Phase 13: the bilevel, tightening and tightening-slack planners
    through ``run_obca`` with the driver's defaults, their first
    ``FIXED_DUAL_SMOKE_STEPS`` steps (``full``: all 42 / 62 / 62), against
    their JAX runs and on tests/test_bilevel.py's gates, then the
    4-vehicle tightening's 10 steps. The local and dual solves are dense IP
    solves (``torch.linalg``); no block-Thomas kernel runs."""
    from dlp_admm_torch.config import Formulation, ObcaConfig
    from dlp_admm_torch.mpc import run_obca
    ref = np.load(FIXTURE_BILEVEL)
    out = {}
    runs = [(name, getattr(Formulation, name.upper()), {}, name)
            for name in ("bilevel", "tightening", "tightening_slack")]
    runs.append(("tightening V=4", Formulation.TIGHTENING,
                 dict(ocfg=ObcaConfig(num_veh=4, horizon=8, min_dis=1.0)),
                 "v4"))
    for name, form, kw, key in runs:
        n = len(ref[f"{key}_elastic"])
        if key != "v4" and not full:
            n = FIXED_DUAL_SMOKE_STEPS
        want = ref[f"{key}_states"][:n + 1]
        ref_el, ref_kkt = ref[f"{key}_elastic"][:n], ref[f"{key}_dual_kkt"][:n]
        res, wall = k1_free_run(
            thomas, f"{name} float64", paths,
            lambda: run_obca(form, n_steps=n, **kw), "planner")
        states, infos = res.states, res.extras["infos"]
        el = np.asarray([i["elastic"] for i in infos])
        kkt = np.asarray([i["dual_kkt"] for i in infos])
        loc = np.asarray([i["local_trips"] for i in infos])
        dual = np.asarray([i["dual_trips"] for i in infos])
        strict = min(n, int(ref[f"{key}_chaotic_from"]))
        err = _per_step_err(states, want)
        p = states[..., :2]
        row = dict(
            steps=n, strict_steps=strict, max_state_err=float(err.max()),
            max_state_err_strict=float(err[:strict + 1].max()),
            max_elastic_rel_err=float(np.max(np.abs(el - ref_el)
                                             / np.abs(ref_el))),
            max_dual_kkt_rel_err=float(np.max(np.abs(kkt - ref_kkt)
                                              / np.abs(ref_kkt))),
            wall_s=wall, wall_per_step_s=wall / n,
            step_times_s=[min(res.metrics.step_times),
                          max(res.metrics.step_times)],
            local_trips_per_step=float(loc.mean()),
            dual_trips_per_step=float(dual.mean()),
            local_trips=int(loc.sum()), dual_trips=int(dual.sum()),
            wall_per_trip_ms=1e3 * wall / int(loc.sum() + dual.sum()),
            dual_lanes=res.extras["planner"].n_pairs * 7, nvidia_smi=smi)
        if key == "v4":
            lane_err = float(np.abs(states[:, :, 1]
                                    - np.asarray(V4_LANE_Y)).max())
            pair_d = [float(np.linalg.norm(p[:, a] - p[:, b],
                                           axis=-1).min())
                      for a, b in ((0, 1), (2, 3))]
            row.update(max_lane_err_m=lane_err, min_pair_distance_m=pair_d)
            gates = {"finite": bool(np.all(np.isfinite(states))),
                     f"lanes within {V4_LANE_TOL_M} m":
                         lane_err < V4_LANE_TOL_M,
                     f"lane pairs > {FIXED_DUAL_MIN_DIST} m":
                         min(pair_d) > FIXED_DUAL_MIN_DIST}
        else:
            d = float(np.linalg.norm(p[:, 0] - p[:, 1], axis=-1).min())
            row.update(min_center_distance_m=d)
            gates = {"finite": bool(np.all(np.isfinite(states))),
                     f"centre distance > {FIXED_DUAL_MIN_DIST} m":
                         d > FIXED_DUAL_MIN_DIST}
        log(f"{name} float64 vs JAX: " + json.dumps(row))
        if states.shape != want.shape or not all(gates.values()):
            raise RuntimeError(f"{name}: states {states.shape}, gates "
                               f"{gates}")
        if not err[:strict + 1].max() <= STATE_TOL:
            raise RuntimeError(f"{name}: states {err[:strict + 1].max():.3e}"
                               f" from JAX before step {strict}")
        np.testing.assert_allclose(el[:strict], ref_el[:strict],
                                   rtol=ELASTIC_TOL[1],
                                   atol=ELASTIC_TOL[0],
                                   err_msg=f"{name} elastic")
        np.testing.assert_allclose(kkt[:strict], ref_kkt[:strict],
                                   rtol=DUAL_KKT_TOL[1],
                                   atol=DUAL_KKT_TOL[0],
                                   err_msg=f"{name} dual_kkt")
        out[name] = dict(row, gates=gates)
    return out


def aladin_path(thomas, paths, smi, full):
    """Phase 14: the ALADIN crossing through ``run_pi_admm(layout=
    "aladin")``, its first ``ALADIN_SMOKE_STEPS`` steps (``full``: all 45),
    against its JAX run and on tests/test_aladin.py's gates (those of the
    whole run only with ``full``: they fail the run at its end, so that
    the other ``--full`` records are kept), and ``run_obca(Formulation.
    ALADIN)``'s dispatch. The agents' NLPs are dense IP solves and the
    coupled QP one dense solve; no block-Thomas kernel runs."""
    from dlp_admm_torch.config import Formulation, SolverConfig
    from dlp_admm_torch.mpc import run_obca, run_pi_admm
    ref = np.load(FIXTURE_ALADIN)
    prof = json.loads(str(ref["profile"]))
    name = "ALADIN crossing float64"
    n = prof["steps"] if full else ALADIN_SMOKE_STEPS
    res, wall = k1_free_run(
        thomas, name, paths, lambda: run_pi_admm(
            layout="aladin", scfg=SolverConfig(**prof["scfg"]), n_steps=n),
        "planner")
    states, its = res.states, np.asarray(res.extras["iterations"])
    strict = min(n, int(ref["chaotic_from"]))
    err = _per_step_err(states, ref["states"][:n + 1])
    d = np.linalg.norm(states[:, 0, :2] - states[:, 1, :2], axis=-1)
    total = int(its.sum())
    row = dict(iterations=its.tolist(),
               jax_iterations=ref["iterations"][:n].tolist(),
               strict_steps=strict, total_iterations=total,
               jax_total_iterations=int(ref["iterations"][:n].sum()),
               jax_moved_total_iterations=ref[
                   "moved_total_iterations"].tolist(),
               jax_moved_min_distance_m=ref["moved_min_distance_m"].tolist(),
               max_state_err_strict=float(err[:strict + 1].max()),
               max_state_err=float(err.max()),
               min_distance_m=float(d.min()), wall_s=wall,
               wall_per_step_s=wall / n, wall_per_iteration_s=wall / total,
               step_times_s=[min(res.metrics.step_times),
                             max(res.metrics.step_times)],
               nvidia_smi=smi)
    gates = {"finite": bool(np.all(np.isfinite(states))),
             f"clearance > {ALADIN_MIN_DIST} m": float(d.min())
             > ALADIN_MIN_DIST}
    run_gates = {"vehicle 0 crossed": float(states[-1, 0, 0]) > 5.0,
                 "vehicle 1 crossed": float(states[-1, 1, 1]) < -5.0,
                 f"iterations < {ALADIN_MAX_TOTAL_ITERS}":
                     total < ALADIN_MAX_TOTAL_ITERS} if full else {}
    log(f"{name} vs JAX: " + json.dumps(dict(row, gates=gates,
                                             run_gates=run_gates)))
    if states.shape != (n + 1, 2, 3) or not all(gates.values()):
        raise RuntimeError(f"{name}: states {states.shape}, gates {gates}")
    if not np.array_equal(its[:strict], ref["iterations"][:strict]):
        raise RuntimeError(f"{name}: iterations differ from JAX before step "
                           f"{strict}")
    if not err[:strict + 1].max() <= STATE_TOL:
        raise RuntimeError(f"{name}: states {err[:strict + 1].max():.3e} "
                           f"from JAX before step {strict}")
    dsp = prof["dispatch"]
    res, dwall = k1_free_run(
        thomas, "ALADIN dispatch float64", paths, lambda: run_obca(
            Formulation.ALADIN, n_steps=dsp["steps"],
            scfg=SolverConfig(**dsp["scfg"])), "planner")
    derr = float(np.abs(res.states - ref["dispatch_states"]).max())
    dits = np.asarray(res.extras["iterations"])
    log(f"ALADIN dispatch vs JAX: iterations {dits.tolist()} (JAX "
        f"{ref['dispatch_iterations'].tolist()}), states {derr:.3e}, "
        f"wall {dwall:.3f} s")
    if derr > STATE_TOL or not np.array_equal(dits,
                                              ref["dispatch_iterations"]):
        raise RuntimeError("ALADIN dispatch differs from JAX")
    return dict(row, gates=gates, run_gates=run_gates, dispatch=dict(
        iterations=dits.tolist(), max_state_err=derr, wall_s=dwall))


CLUSTER_PHASES = ("panel factor", "publish and cluster barrier",
                  "panel updates", "stage product", "copies",
                  "back substitution")
BIG_PHASES = ("panel factor and publish", "flag and barrier waits",
              "panel updates", "stage product", "copies",
              "back substitution")
PHASES = {"warp": ("load", "equilibrate", "eliminate", "refine",
                   "store and product", "back substitution"),
          "wide": ("load and product", "equilibrate", "eliminate", "refine",
                   "store", "back substitution")}


def _same(name, pairs):
    """Raise unless every (label, a, b) holds the same bits."""
    for label, a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or not np.array_equal(a, b):
            raise RuntimeError(f"{name}: the resumed run's {label} differs "
                               f"from the uninterrupted run's")


def _streamed(name, work_dir, history, logs):
    """``RunMetrics(trace_path=...)`` fed ``logs`` ((step, iterations,
    extras), ...): one record a step, read back with ``read_tracelog``,
    steps and iterations equal to ``history``."""
    from dlp_admm_torch.utils import RunMetrics, read_tracelog
    path = os.path.join(work_dir, f"{name.replace(' ', '_')}.dlplog")
    m = RunMetrics(trace_path=path)
    for step, its, kv in logs:
        m.log_step(step, its, **kv)
    m.close()
    back = read_tracelog(path)
    if (back.shape != (len(history), m.trace_record_floats)
            or back[:, 1].tolist() != [float(i) for i in history]
            or back[:, 0].tolist() != [float(t) for t, _, _ in logs]
            or m.iter_history != list(history)):
        raise RuntimeError(f"{name}: the trace stream read back "
                           f"{back.tolist()} for {list(history)}")
    return int(back.shape[0])


def resume_path(thomas, ip_staged, paths, smi):
    """Phase 15: checkpoint / resume of four planners on the card, each
    resumed run bit for bit its uninterrupted run; the native trace stream,
    the profiler trace and the drivers' plots."""
    import tempfile
    from dlp_admm_torch.config import (DualUpdateConfig, Formulation,
                                       ObcaConfig, PiAdmmConfig,
                                       SolverConfig)
    from dlp_admm_torch.models.aladin import AladinEngine, AladinProblem
    from dlp_admm_torch.models.bilevel import BilevelObcaPlanner
    from dlp_admm_torch.models.obca import ConsensusObcaPlanner
    from dlp_admm_torch.models.pi_admm import PiAdmmEngine
    from dlp_admm_torch.mpc import run_obca, run_pi_admm
    from dlp_admm_torch.utils import (native_available, plot_trajectories,
                                      trace)
    t_phase = time.perf_counter()
    if not native_available():
        raise RuntimeError("the native trace logger did not build")
    out = {}
    work = tempfile.mkdtemp(prefix="chip_smoke_resume_")

    # -- 15.1 the flagship, float64: 4 steps, and 2 + 2 resumed ------------
    # (the float64 profile at run_obca's ADMM cap, 15)
    name = "resume consensus float64"
    prof = flagship_profile(torch.float64, max_admm_iters=15)
    ckpt = os.path.join(work, "consensus.npz")
    (full_st, full_its, full_res, _), _, _ = drive(
        thomas, ip_staged, lambda: ConsensusObcaPlanner(
            **prof, device=DEVICE).run(n_steps=4))
    ConsensusObcaPlanner(**prof, device=DEVICE).run(n_steps=2,
                                                    checkpoint_path=ckpt)
    fresh = ConsensusObcaPlanner(**prof, device=DEVICE)
    (tail_st, tail_its, _, _), counts, kkt = drive(
        thomas, ip_staged, lambda: fresh.run(n_steps=4, checkpoint_path=ckpt,
                                             resume=True))
    check_counts(name, counts, fresh.block_solves, ("warp",))
    _same(name, (("states", tail_st, full_st[2:]),
                 ("ADMM iterations", tail_its, full_its[2:])))
    st, bs = fresh.carry
    dev = torch.device(DEVICE).type
    if st.device.type != dev or bs.z_bar.device.type != dev:
        raise RuntimeError(f"{name}: the resumed carry left the card")
    paths[name] = counts
    records = _streamed(name, work, full_its.tolist(), [
        (t, int(it), dict(primal=r[0], dual=r[1]))
        for t, (it, r) in enumerate(zip(full_its, full_res))])
    out["consensus"] = dict(iterations=full_its.tolist(),
                            resumed_iterations=tail_its.tolist(),
                            launches=counts, block_solves=fresh.block_solves,
                            kkt_shapes=sorted(kkt), trace_records=records)
    log(f"{name}: " + json.dumps(out["consensus"]))

    # -- 15.2 the pairwise PI-ADMM engine: 6 steps, 3 + 3 ------------------
    name = "resume PI-ADMM pairwise float64"
    xt0 = np.array([[-3.0, 0.0, 0.0], [0.0, 6.0, -np.pi / 2]])

    def engine():
        return PiAdmmEngine(PiAdmmConfig(iter_num=4), DualUpdateConfig(),
                            SolverConfig(qp_iters=120, qp_tol=1e-6),
                            layout="pairwise", device=DEVICE)
    ckpt = os.path.join(work, "pi_admm.npz")
    full = engine().run(xt0=xt0, n_steps=6)
    engine().run(xt0=xt0, n_steps=3, checkpoint_path=ckpt)
    tail = engine().run(xt0=xt0, n_steps=6, checkpoint_path=ckpt,
                        resume=True)
    _same(name, (("states", tail.xt, full.xt[3:]),
                 ("iterations", tail.iterations, full.iterations[3:]),
                 ("controls", tail.u_applied, full.u_applied[3:])))
    records = _streamed(name, work, full.iterations.tolist(), [
        (t, int(it), dict(rho=float(full.rho[t])))
        for t, it in enumerate(full.iterations)])
    out["pi_admm"] = dict(iterations=full.iterations.tolist(),
                          trace_records=records)
    log(f"{name}: " + json.dumps(out["pi_admm"]))

    # -- 15.3 bilevel, one round: 4 steps, 2 + 2 ---------------------------
    name = "resume bilevel float64"

    def bilevel():
        return BilevelObcaPlanner(ObcaConfig(horizon=5, min_dis=1.0),
                                  scfg=SolverConfig(ip_iters=5, ip_tol=1e-6),
                                  n_rounds=1, device=DEVICE)
    ckpt = os.path.join(work, "bilevel.npz")
    full_st, full_infos = bilevel().run(n_steps=4)
    bilevel().run(n_steps=2, checkpoint_path=ckpt)
    tail_st, tail_infos = bilevel().run(n_steps=4, checkpoint_path=ckpt,
                                        resume=True)
    _same(name, (("states", tail_st, full_st[2:]),
                 ("elastic", [i["elastic"] for i in tail_infos],
                  [i["elastic"] for i in full_infos[2:]])))
    records = _streamed(name, work, [1] * 4, [
        (t, 1, dict(elastic=i["elastic"])) for t, i in enumerate(full_infos)])
    out["bilevel"] = dict(elastic=[i["elastic"] for i in full_infos],
                          trace_records=records)
    log(f"{name}: " + json.dumps(out["bilevel"]))

    # -- 15.4 the ALADIN engine on a toy: 6 iterations, 3 + 3 --------------
    name = "resume ALADIN float64"
    f64 = dict(dtype=torch.float64, device=DEVICE)
    prob = AladinProblem(
        f=lambda y, p: torch.sum((y - p) ** 2),
        h=lambda y, p: torch.zeros((0,), dtype=y.dtype, device=y.device),
        a_mats=torch.tensor([[[1.0]], [[-1.0]]], **f64),
        b=torch.zeros(1, **f64))
    eng = AladinEngine(prob, rho=1.0, mu=1e4,
                       scfg=SolverConfig(ip_iters=25, ip_tol=1e-9),
                       device=DEVICE)
    targets = torch.tensor([[3.0], [7.0]], **f64)
    x0 = torch.zeros((2, 1), **f64)
    ckpt = os.path.join(work, "aladin.npz")
    full_state, full_ys = eng.run(x0, targets, n_iters=6, tol=None)
    eng.run(x0, targets, n_iters=3, tol=None, checkpoint_path=ckpt)
    tail_state, tail_ys = eng.run(x0, targets, n_iters=6, tol=None,
                                  checkpoint_path=ckpt, resume=True)
    _same(name, [(f, getattr(tail_state, f).cpu(),
                  getattr(full_state, f).cpu())
                 for f in tail_state._fields] + [
        ("ys", tail_ys.cpu(), full_ys.cpu())])
    out["aladin"] = dict(x=full_state.x.cpu().flatten().tolist())
    log(f"{name}: " + json.dumps(out["aladin"]))

    # -- 15.5 the profiler around one flagship MPC step (ADMM cap 1: the
    # profiler records every host operation, and an uncapped step's eager
    # trips and captures make millions of events) ----------------------------
    name = "profiled flagship step"
    pl = ConsensusObcaPlanner(**flagship_profile(torch.float64,
                                                 max_admm_iters=1),
                              device=DEVICE)
    pl.run(n_steps=1)                  # warm: the first step's set-up
    with trace("flagship_step", enabled=True, trace_dir=work) as path:
        pl.run(n_steps=1)
        torch.cuda.synchronize()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [str(e.get("name", "")) for e in events
               if e.get("cat") == "kernel"]
    k1 = sorted({k for k in kernels if "thomas_" in k})
    out["profiler"] = dict(events=len(events), kernel_events=len(kernels),
                           k1_kernels=k1, trace_bytes=os.path.getsize(path))
    log(f"{name}: " + json.dumps(out["profiler"]))
    if not k1:
        raise RuntimeError(f"{name}: no kernel event names K1 among "
                           f"{len(kernels)} kernel events")

    # -- 15.6 the drivers' plots --------------------------------------------
    pngs = {}
    obca_png = os.path.join(work, "obca.png")
    res = run_obca(Formulation.CONSENSUS,
                   ocfg=ObcaConfig(horizon=5, max_admm_iters=2, rho=100.0),
                   scfg=SolverConfig(ip_iters=5, ip_tol=1e-6), n_steps=1,
                   plot_path=obca_png, device=DEVICE)
    pngs["run_obca"] = os.path.exists(obca_png)
    pi_png = os.path.join(work, "pi_admm.png")
    res = run_pi_admm(PiAdmmConfig(iter_num=4), layout="pairwise",
                      scfg=SolverConfig(qp_iters=120, qp_tol=1e-6),
                      n_steps=2, plot_path=pi_png, device=DEVICE)
    pngs["run_pi_admm"] = os.path.exists(pi_png)
    pngs["plot_trajectories"] = plot_trajectories(
        res.states, os.path.join(work, "direct.png"), footprints=False)
    if len({bool(v) for v in pngs.values()}) != 1:
        raise RuntimeError(f"the drivers' plots disagree: {pngs}")
    out["plots"] = dict(pngs, matplotlib=bool(pngs["run_obca"]))
    log(f"plots: {json.dumps(out['plots'])} (a PNG where matplotlib is "
        f"installed, else nothing)")
    shutil.rmtree(work, ignore_errors=True)
    out.update(wall_s=time.perf_counter() - t_phase, nvidia_smi=smi)
    return out


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(world, mesh, backend, steps):
    """Run ``world`` ranks of ``tools/multihost_smoke_torch.py`` on the card
    at once (the bench case, ``steps`` MPC steps, ``mesh`` "S,V"); prints
    their output here (never after this script's last line) and returns
    each rank's records. A rank that exits non-zero or outlives
    RANK_TIMEOUT_S fails the phase; every rank is stopped on the way
    out."""
    port = free_port()
    with tempfile.TemporaryDirectory() as out:
        procs = [subprocess.Popen(
            [sys.executable, RANK_SCRIPT, str(r), str(world), str(port),
             "--device", torch.device(DEVICE).type, "--backend", backend,
             "--mesh", mesh,
             "--case", "bench", "--steps", str(steps), "--out", out,
             "--threads", "4"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        texts = []
        try:
            for p in procs:
                texts.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        for r, (p, text) in enumerate(zip(procs, texts)):
            for line in text.splitlines()[-30:]:
                log(f"  [{mesh} {backend} rank {r}] {line}")
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of the {mesh} mesh over "
                                   f"{backend} exited {p.returncode}")
        return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
                for r in range(world)]


def stitch_bench(ranks, n_scen, n_veh, steps):
    """The full ``(states [steps+1, S, V, 5], iterations [S, steps],
    converged [S, steps])`` from the ranks' blocks; the per-scenario leaves
    must be equal bit for bit on every rank of a vehicle group."""
    states = np.full((steps + 1, n_scen, n_veh, 5), np.nan)
    its = np.full((n_scen, steps), -1)
    conv = np.zeros((n_scen, steps), bool)
    seen = np.zeros(n_scen, bool)
    for r in ranks:
        s0, s1, v0, v1 = r["bench__index"]
        states[:, s0:s1, v0:v1] = r["bench__states"]
        if seen[s0:s1].all() and not (
                np.array_equal(its[s0:s1], r["bench__iterations"])
                and np.array_equal(conv[s0:s1], r["bench__converged"])):
            raise RuntimeError("ranks of one vehicle group took other "
                               "iterations or flags")
        its[s0:s1] = r["bench__iterations"]
        conv[s0:s1] = r["bench__converged"]
        seen[s0:s1] = True
    if not (seen.all() and np.all(np.isfinite(states))):
        raise RuntimeError("the ranks' blocks do not cover the batch")
    return states, its, conv


def sharded_path(thomas, paths, one_device, batch_nums, smi):
    """Phase 16: the vehicle-sharded consensus step
    (``make_consensus_spmd_step(planner, mesh)``) at bench metric 3's width
    (16 scenarios x 2 vehicles, the flagship's float64 profile, staged
    locals and edges) over ranks that share the one card, its first
    SHARDED_STEPS MPC steps on the 1x2 mesh (its first step on the others),
    held to phase 10's one-device run of the same batch on this card
    (``one_device``): on a 1x2 mesh over gloo (one vehicle a rank, CUDA
    tensors in the collectives; NCCL refuses two ranks on one GPU) and a
    2x1 scenario mesh over gloo, equal iterations and converged flags and
    states within SHARDED_TOL; on a one-rank NCCL world, bit for bit. In each rank the K1 launches equal its block solves, at
    its blocks' shapes (locals (S_blk·vb, 7, 19), edges (S_blk, 7, 20))."""
    states1, its1, _, _, conv1, _ = one_device
    n_scen, n_veh = its1.shape[0], states1.shape[2]
    out = dict(one_device=dict(
        path=f"batch float64 (phase 10, {BATCH_SMOKE_STEPS} steps)",
        wall_per_executed_iteration_s=batch_nums[
            "wall_per_executed_iteration_s"]), nvidia_smi=smi)
    log(f"phase 16 on {smi}: the one-device batch (phase 10) took "
        f"{out['one_device']['wall_per_executed_iteration_s']:.4f} s an "
        f"executed ADMM iteration")
    for world, mesh, backend, n in ((2, "1,2", "gloo", SHARDED_STEPS),
                                    (2, "2,1", "gloo", 1),
                                    (1, "1,1", "nccl", 1)):
        name = f"sharded {mesh.replace(',', 'x')} {backend}"
        t0 = time.perf_counter()
        ranks = spawn_ranks(world, mesh, backend, n)
        wall = time.perf_counter() - t0
        states, its, conv = stitch_bench(ranks, n_scen, n_veh, n)
        err = float(np.abs(states - states1[:n + 1]).max())
        bits = bool(np.array_equal(states, states1[:n + 1]))
        same = bool(np.array_equal(its, its1[:, :n])
                    and np.array_equal(conv, conv1[:, :n]))
        n_s, n_v = (int(x) for x in mesh.split(","))
        want = sorted([(n_scen // n_s * n_veh // n_v, 7, 19),
                       (n_scen // n_s, 7, 20)])
        per_rank = []
        for r, rec in enumerate(ranks):
            info = json.loads(str(rec["bench__info"]))
            shapes = sorted(tuple(x) for x in info["kkt_shapes"])
            per_rank.append(dict(
                rank=r, index=rec["bench__index"].tolist(),
                launches=info["launches"],
                block_solves=info["block_solves"], kkt_shapes=shapes,
                wall_s=info["wall_s"],
                wall_per_executed_iteration_s=info[
                    "wall_per_executed_iteration_s"],
                executed_admm_iterations=info["executed_admm_iterations"],
                collective_calls=info["collective_calls"],
                collective_bytes=info["collective_bytes"],
                collective_share=info["collective_share"],
                memory_reserved_gib=info.get("memory_reserved_gib"),
                max_memory_reserved_gib=info.get("max_memory_reserved_gib")))
            paths[f"{name} rank {r}"] = info["launches"]
            check_counts(f"{name} rank {r}", info["launches"],
                         info["block_solves"], ("warp",))
            if shapes != want:
                raise RuntimeError(f"{name} rank {r}: KKT shapes {shapes}, "
                                   f"expected {want}")
        row = dict(mesh=mesh, backend=backend, ranks=world, steps=n,
                   max_state_err_vs_one_device=err, bit_equal=bits,
                   same_iterations_and_flags=same, iterations=its.tolist(),
                   spawn_wall_s=wall, per_rank=per_rank)
        log(f"{name}: " + json.dumps(row))
        log(f"{name}: states {'equal bit for bit to' if bits else 'within '}"
            f"{'' if bits else f'{err:.3e} of'} phase 10's one-device run")
        out[name] = row
        if not (same and err <= SHARDED_TOL):
            raise RuntimeError(f"{name}: differs from the one-device run "
                               f"(states {err:.3e}, same iterations and "
                               f"flags: {same})")
        if backend == "nccl" and not bits:
            raise RuntimeError(f"{name}: the one-rank world is not bit-equal "
                               f"to the one-device step")
    return out


def options_path(thomas, ip_staged, paths, smi):
    """Phase 17: the consensus planner's options, one flagship float64 MPC
    step each (the fixture's ADMM cap, 6) from JAX's carry at the
    fixture's step, on the kernels:
    ``edge_prox``, ``branch_commit`` and ``mpc_step_trace`` of a planner
    with both at the fixture's ``trace_iters``. Each run is held against
    the committed JAX run ``tests/data/obca_options_ref.npz`` (states within
    STATE_TOL, equal ADMM iterations; where JAX, its start moved by 1e-12,
    leaves itself, the comparison is printed, not gated) and against the
    same run on the kernels' plain version (OPTIONS_PLAIN_TOL, equal
    iterations), the launches equal to its block solves."""
    from dlp_admm_torch.config import ObcaConfig, SolverConfig
    from dlp_admm_torch.interop import bar_state_from_numpy
    from dlp_admm_torch.models.obca import BarState, ConsensusObcaPlanner
    ref = np.load(FIXTURE_OPTIONS)
    prof = json.loads(str(ref["profile"]))
    k = prof["step"]
    state = torch.as_tensor(ref["carry_state"], device=DEVICE)
    bs = bar_state_from_numpy({f: ref[f"carry_bs_{f}"]
                               for f in BarState._fields}, device=DEVICE)

    def plain(diag, upper, rhs):
        return thomas.block_thomas_plain(diag, upper, rhs, False)

    out = dict(step=k, nvidia_smi=smi)
    for run, kw in prof["runs"].items():
        name = f"option {run}"
        pl = ConsensusObcaPlanner(
            ObcaConfig(**{**prof["planner"]["ocfg"], **prof["ocfg"]}),
            scfg=SolverConfig(**prof["planner"]["scfg"]),
            **prof["planner"]["planner"], **kw, device=DEVICE)

        def one():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if run == "trace":
                c, hist = pl.mpc_step_trace(state, bs, k,
                                            prof["trace_iters"])
                res = (c["xs"].cpu().numpy(), prof["trace_iters"],
                       c["d_bar"].cpu().numpy(),
                       hist["primal"].cpu().numpy())
            else:
                o = pl._mpc_step(state, bs, k)
                res = (o[0].cpu().numpy(), int(o[2]),
                       o[1].z_bar.cpu().numpy(), float(o[3]))
            return res, time.perf_counter() - t0

        solves0 = pl.block_solves
        (got, wall), counts, _ = drive(thomas, ip_staged, one)
        check_counts(name, counts, pl.block_solves - solves0, ("warp",))
        (want, plain_wall), plain_counts, _ = drive(thomas, ip_staged, one,
                                                    solve=plain)
        if sum(plain_counts.values()):
            raise RuntimeError(f"{name}: the plain run launched "
                               f"{plain_counts}")
        if run == "trace":
            jax_states, jax_its = ref["trace__xs"], prof["trace_iters"]
        else:
            jax_states, jax_its = ref[f"{run}__out_0"], int(
                ref[f"{run}__out_2"])
        jax_err = float(np.abs(got[0] - jax_states).max())
        plain_err = max(float(np.abs(a - b).max())
                        for a, b in zip(got[:3:2], want[:3:2]))
        chaotic = bool(ref[f"{run}__chaotic"])
        row = dict(option=kw, iterations=got[1], jax_iterations=jax_its,
                   plain_iterations=want[1], max_state_err_vs_jax=jax_err,
                   jax_leaves_itself=chaotic,
                   max_err_vs_plain=plain_err, launches=counts,
                   wall_s=wall, plain_wall_s=plain_wall)
        if run == "trace":
            row.update(d_bar_frozen=bool(np.abs(got[2]).max() > 0.5),
                       max_d_bar_err_vs_jax=float(np.abs(
                           got[2] - ref["trace__d_bar"]).max()),
                       max_primal_rel_err_vs_jax=float(np.abs(
                           got[3] - ref["trace__hist_primal"]).max()
                           / np.abs(ref["trace__hist_primal"]).max()))
        log(f"{name}: " + json.dumps(row))
        paths[name] = counts
        out[run] = row
        if not (plain_err <= OPTIONS_PLAIN_TOL and got[1] == want[1]):
            raise RuntimeError(f"{name}: differs from its plain-version run "
                               f"({plain_err:.3e}, iterations {got[1]} "
                               f"against {want[1]})")
        if not chaotic and not (jax_err <= STATE_TOL and got[1] == jax_its
                                and row.get("max_d_bar_err_vs_jax", 0.0)
                                <= STATE_TOL):
            raise RuntimeError(f"{name}: differs from the JAX run "
                               f"({jax_err:.3e}, iterations {got[1]} "
                               f"against {jax_its})")
    return out


def clock_split(thomas, systems):
    """The profiling builds' clock64() split of one solve of a run's KKT
    system: the warp kernel on the float64 and float32 slices' local
    systems, the wide kernel on the 4-vehicle edge system (float64) and the
    3-vehicle edge system (float32, equilibrated), the cluster kernel on the
    4-vehicle centralized block and the 8-vehicle edge; clocks of the first
    system, and per pivot step in the elimination."""
    out = []
    for name, path, key in (
            ("warp", "slice float64", (2, 7, 19)),
            ("warp", "slice float32", (2, 7, 19)),
            ("wide", "multi-vehicle V=4 float64", (1, 7, 80)),
            ("wide", "multi-vehicle V=3 float32", (1, 7, 45)),
            ("cluster", "centralized V=4 float64", (1, 14, 108)),
            ("cluster", "consensus V=8 float64", (1, 7, 320)),
            ("big", "consensus V=9 float64", (1, 7, 405))):
        d, u, r = systems[path][key]
        eq = r.dtype != torch.float64
        _, clocks = thomas.launch_kernel(d, u, r, eq, kernel=name,
                                         profile=True)
        if name in ("cluster", "big"):
            row = dict(cluster_clock_row(clocks, key, name), path=path)
        else:
            c = clocks[0].tolist()
            row = dict(kernel=name, path=path, shape=list(key),
                       dtype=str(r.dtype)[6:],
                       clocks=dict(zip(PHASES[name], c)),
                       total_clocks=sum(c),
                       eliminate_clocks_per_pivot=c[2] / (key[1] * key[2]))
        log(json.dumps(row))
        out.append(row)
    return out


def cluster_clock_row(clocks, shape, kernel="cluster"):
    """The cluster or big kernel's clocks ``[S, R, 6]`` of one solve, first
    system: per CTA, the first CTA's per stage, and the panel factors summed
    over the CTAs (they are one serial chain: a CTA factors its panels
    while the others wait at the next cluster barrier or flag)."""
    c = clocks[0].cpu().numpy()
    t, b = shape[1], shape[2]
    names = CLUSTER_PHASES if kernel == "cluster" else BIG_PHASES
    first = dict(zip(names, c[0].tolist()))
    return dict(kernel=kernel, shape=list(shape), cluster=int(c.shape[0]),
                first_cta=first,
                first_cta_per_stage={k: v / t for k, v in first.items()},
                per_cta=[dict(zip(names, x)) for x in c.tolist()],
                factor_chain_clocks=int(c[:, 0].sum()),
                factor_clocks_per_pivot=float(c[:, 0].sum()) / (t * b),
                first_cta_total=int(c[0].sum()))


def cluster_split(thomas, rng, dev):
    """Phase 3's clock64() split of the cluster kernel at (1, 14, 108) and
    (2, 7, 264), float64 and float32 equilibrated, and of the big kernel at
    (1, 7, 405) float64 and (1, 7, 605) float32 equilibrated, on KKT-style
    saddle systems; the profiling build gives the same bits as the
    other."""
    out = []
    for kernel, shapes in (("cluster", ((1, 14, 108), (2, 7, 264))),
                           ("big", ((1, 7, 405), (1, 7, 605)))):
        for shape in shapes:
            for dtype in (torch.float64, torch.float32):
                if kernel == "big" and dtype != PAST_REACH[shape][0]:
                    continue
                eq = dtype != torch.float64
                d, u, r = (torch.as_tensor(a, dtype=dtype, device=dev)
                           for a in make_system(rng, *shape, "kkt_saddle"))
                got, clocks = thomas.launch_kernel(d, u, r, eq, kernel=kernel,
                                                   profile=True)
                want = thomas.launch_kernel(d, u, r, eq, kernel=kernel)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"the {kernel} kernel's profiling "
                                       f"build differs at {shape} {dtype}")
                row = dict(cluster_clock_row(clocks, shape, kernel),
                           dtype=str(dtype)[6:], equilibrated=eq)
                log(json.dumps(row))
                out.append(row)
    return out


def big_graph_replay(thomas, rng, dev):
    """One big-kernel solve at (1, 7, 405) float64 captured in a CUDA graph
    and replayed three times: each replay gives the eager call's bits, and
    the capture records one launch, each replay counts one."""
    d, u, r = (torch.as_tensor(a, dtype=torch.float64, device=dev)
               for a in make_system(rng, 1, 7, 405, "kkt_saddle"))
    want = thomas.launch_kernel(d, u, r, False)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    captured = thomas.captured["big"]
    with torch.cuda.stream(stream):
        graph.capture_begin()
        got = thomas.launch_kernel(d, u, r, False)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    if thomas.captured["big"] != captured + 1:
        raise RuntimeError("the captured big-kernel solve was not counted")
    same = []
    for _ in range(3):
        got.fill_(float("nan"))
        before = thomas.launches_by_kernel["big"]
        thomas.replay(graph, {"big f64": 1})
        torch.cuda.synchronize()
        same.append(bool(torch.equal(got, want))
                    and thomas.launches_by_kernel["big"] == before + 1)
    log(f"big kernel at (1, 7, 405) float64, captured and replayed: same "
        f"bits as the eager call {same}")
    if not all(same):
        raise RuntimeError("a replayed big-kernel solve differs from the "
                           "eager call")
    return dict(shape=[1, 7, 405], replays_same_bits=same)


def kernel_entry(name, real, paths, path, shape, at_shapes=(),
                 variants=None):
    """One kernel's line: launches over every driven path, and the error
    against the plain version and the times on the KKT system of ``shape``
    that ``path`` gave it; ``worst_rel_err`` is the largest relative error
    on any path's system (held to RUN_TOL and to the plain version's
    backward error by :func:`compare`). ``at_shapes`` ((path, shape), ...)
    adds the same numbers at other shapes as sub-records, with the
    launches of that path; a path ``"<p> raised"`` is path ``p``'s block
    raised to float64. ``variants`` (path -> launches by variant) adds each
    sub-record's launches of its own variant on its path."""
    rows = [r for r in real if r["kernel"] == name]

    def numbers(p, shp):
        at = next(r for r in rows if r["path"] == p and tuple(r["shape"]) == shp)
        return dict(
            max_abs_err=at["max_abs_err"], max_rel_err=at["max_rel_err"],
            tol=at["tol"], shape=list(shp), dtype=at["dtype"], ms=at["ms"],
            plain_ms=at["plain_ms"], bound_ms=at["bound_ms"],
            bound_us=at["bound_us"], bound_by=at["bound_by"],
            one_sm_bound_ms=1e-3 * at["sm_bound_us"],
            library_ms=at["library_ms"], us_per_pivot=at["us_per_pivot"])

    launches = sum(c[name] for c in paths.values())
    if launches <= 0:
        raise RuntimeError(f"no driven path launched the {name} kernel")
    out = dict(name=f"block_thomas_{name}", route="cuda",
               source=f"dlp_admm_torch/csrc/block_thomas_{name}.cu",
               replaces=REPLACES, launches=launches,
               launches_by_path={p: c[name] for p, c in paths.items()},
               worst_rel_err=max(r["max_rel_err"] for r in rows),
               **numbers(path, shape))
    def variant_launches(p, shp):
        at = next(r for r in rows
                  if r["path"] == p and tuple(r["shape"]) == shp)
        v = f"{name} {'f32' if at['dtype'] == 'float32' else 'f64'}" + (
            " eq" if at["equilibrate"] else "")
        on = (variants or {}).get(p.removesuffix(" raised"), {})
        return v, on.get(v, 0)

    if at_shapes:
        out["at_shapes"] = []
        for p, shp in at_shapes:
            v, n = variant_launches(p, shp)
            out["at_shapes"].append(dict(
                numbers(p, shp), path=p, variant=v, launches_of_variant=n,
                launches=paths[p.removesuffix(" raised")][name]))
    return out


def polygon_gap(p, q):
    """Distance between convex polygons ``p``, ``q`` [n, 2] in cyclic
    order; 0 when they touch or overlap (separating-axis test)."""
    def separated(a, b):
        for i in range(len(a)):
            e = a[(i + 1) % len(a)] - a[i]
            n = np.array([-e[1], e[0]])
            if (a @ n).max() < (b @ n).min() or (b @ n).max() < (a @ n).min():
                return True
        return False

    def point_seg(x, a, b):
        ab = b - a
        t = np.clip(np.dot(x - a, ab) / np.dot(ab, ab), 0.0, 1.0)
        return np.linalg.norm(x - (a + t * ab))

    if not (separated(p, q) or separated(q, p)):
        return 0.0
    return min(point_seg(x, b[i], b[(i + 1) % len(b)])
               for a, b in ((p, q), (q, p)) for x in a for i in range(len(b)))


def beside_jax_f32(rec):
    """The float32 run's steps at the ADMM cap, NLP health and minimum
    centre distance beside JAX's 11 CPU runs (``JAX_F32_CPU_RUNS``);
    printed, not gated."""
    cap = flagship_profile(torch.float32)["ocfg"].max_admm_iters
    jx = JAX_F32_CPU_RUNS
    out = dict(
        steps_at_cap=int(sum(i >= cap for i in rec["iterations"])),
        jax_steps_at_cap=[min(jx["steps_at_cap"]), max(jx["steps_at_cap"])],
        health=rec["health"], jax_health_unmoved=jx["health"][0],
        jax_health=[min(jx["health"]), max(jx["health"])],
        min_distance_m=rec["min_distance_m"],
        jax_min_distance_m=[min(jx["min_distance_m"]),
                            max(jx["min_distance_m"])],
        res_ok=rec["res_ok"], jax_res_ok=[min(jx["res_ok"]),
                                          max(jx["res_ok"])])
    log("full float32 beside JAX's 11 CPU runs (unmoved, seeds 1-10 at "
        "1e-7): " + json.dumps(out))
    return out


def full_record(res, ref, name):
    """The 42-step run's numbers. ``gates`` are the checks that hold
    whichever branch the conflict window takes, and fail the run; ``pins``
    are the other pins of tests/test_flagship_convergence.py:38-74 (one
    trajectory's values), reported with the JAX run's beside them."""
    from dlp_admm_torch.ops.geometry import vehicle_vertices
    m = res.metrics
    rows = res.extras["residuals"]
    states = res.states
    its = np.asarray(m.iter_history)
    prs = np.array([r[0] for r in rows])
    dus = np.array([r[1] for r in rows])
    oks = np.array([[r[2], r[3]] for r in rows])
    gaps = np.array([r[6] for r in rows])
    p = states[..., :2]
    d = np.linalg.norm(p[:, 0] - p[:, 1], axis=-1)
    res_ok = (prs <= 0.011) & (dus <= 0.011)
    n = len(its)
    # the reference's own safety oracle: the vehicles' footprints never meet
    corners = vehicle_vertices(torch.as_tensor(states,
                                               dtype=torch.float64)).numpy()
    footprint_gap = float(min(polygon_gap(c[0], c[1]) for c in corners))
    gates = {
        "steps == 42": n == 42,
        "finite states": bool(np.all(np.isfinite(states))),
        "overtake completed": bool(states[0, 0, 0] < states[0, 1, 0]
                                   and states[-1, 0, 0] > states[-1, 1, 0]),
        "footprint gap > min_dis (0.1 m)": footprint_gap > 0.1,
        "res_ok >= 39/42": int(res_ok.sum()) >= 39,
    }
    pins = {
        "res_ok >= 40/42": int(res_ok.sum()) >= 40,
        "res_ok == (its < 50)": bool(np.array_equal(res_ok, its < 50)),
        "mean iterations < 24": float(its.mean()) < 24.0,
        "min distance > 3.8 m": float(d.min()) > 3.8,
        "nlp health >= 0.9": float(np.mean(oks == 1.0)) >= 0.9,
        "gap median < 0.02": float(np.median(gaps)) < 0.02,
        "gap max < 1.0": float(gaps.max()) < 1.0,
    }
    jp = ref["states"][..., :2]
    jax_run = dict(
        res_ok=int(((ref["primal"] <= 0.011) & (ref["dual"] <= 0.011)).sum()),
        mean_iterations=float(ref["iterations"].mean()),
        min_distance_m=float(np.linalg.norm(jp[:, 0] - jp[:, 1],
                                            axis=-1).min()),
        health=float(np.mean(ref["nlp_ok"] == 1.0)),
        gap_median=float(np.median(ref["gaps"])),
        gap_max=float(ref["gaps"].max()))
    k = min(n, len(ref["iterations"]))
    out = dict(
        steps=n, res_ok=int(res_ok.sum()), mean_iterations=float(its.mean()),
        min_distance_m=float(d.min()), min_footprint_gap_m=footprint_gap,
        health=float(np.mean(oks == 1.0)),
        gap_median=float(np.median(gaps)), gap_max=float(gaps.max()),
        summary=m.summary(), iterations=its.tolist(),
        step_wall_s=m.step_times, residual_rows=rows,
        states=states.tolist(), gates=gates, pins=pins, jax_cpu_run=jax_run,
        vs_jax=dict(
            max_state_err=float(np.abs(states[:k + 1]
                                       - ref["states"][:k + 1]).max()),
            first_state_err_above_1e_6=next(
                (t for t in range(k + 1) if np.abs(
                    states[t] - ref["states"][t]).max() > STATE_TOL), None),
            steps_with_other_iterations=[
                t for t in range(k) if its[t] != ref["iterations"][t]]))
    log(f"full {name}: " + json.dumps({x: out[x] for x in (
        "steps", "res_ok", "mean_iterations", "min_distance_m",
        "min_footprint_gap_m", "health", "gap_median", "gap_max", "gates",
        "pins", "jax_cpu_run", "vs_jax")}))
    if name == "float64":
        log("full float64, the block-per-system kernel's earlier run: "
            + json.dumps(EARLIER_FULL_F64))
    log(f"full {name}: wall {m.summary()['total_time_s']:.3f} s, "
        f"{m.summary()['iterations_per_s']:.3f} ADMM it/s")
    return out


if __name__ == "__main__":
    main()

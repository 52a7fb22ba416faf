#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card: known- and
unknown-association serving, the dense EKF engine, config 3
(``lidar20_full``: lidar sim, clustering, circle fit, batch-trailing EKF)
at B=1024 worlds with the buffered perception path beside it, configs
1 and 2 (``loop5_known``, ``course12_noisy``: the fake sensor, the bench
entry's path) on both batched engines, with the batch sweep, and config 4
(``run_bigmap``) for 8 worlds, deferred and sequential.

    python3 chip_smoke.py

Run from the repository root. It needs a CUDA card and the port package
beside this file; without either it exits nonzero and prints no result.
It imports nothing of JAX. Phases, one JSON line each:

1. device  -- card name and power limit (nvidia-smi), torch/CUDA versions,
              the TF32 switches (all off);
2. build   -- the four CUDA sources under ``csrc/`` built, one ``nvcc``
              each, all at once (seconds; registers, shared memory and
              spill bytes of every kernel from ptxas);
3. grid_update against its plain version at N=2048, M=8 on the card;
4. seq_scan against its plain version at N=2048, M=8, from a state after
   300 ticks with unseen slots left, on a tick that mixes updates, inits,
   a repeated slot, an out-of-range id and an invalid slot;
5. main path -- ``ServingEngine`` at N=2048, M=8 for T=320 ticks through
   the kernels (every landmark is initialized in the first N/M=256 ticks,
   the rest are update-only): both launch counters equal T, ``n_seen`` is
   N, the state matches the plain path run on the card and the JAX
   reference's golden fixture ``tests/fixtures/serving_n2048_golden.json``;
6. timing  -- ms per tick for the kernel and plain paths, and ms per call
   of each kernel and its plain version (medians over repeats);
7. cov_update against its plain version at D=4224 (the padded dense state
   of N=2048), with the update flag on and off;
8. seq_scan_unknown against its plain version at N=2048, M=8 on (a) the
   state of phase 4 on a tick that mixes an exact revisit (match), a point
   between the gates (skip), a far point (new) and an invalid slot, and
   (b) the full map of phase 5, where a far point first overflows and the
   rest of the tick is inert;
9. serving_unknown -- the unknown-association main path,
   ``bigmap.make_unknown_runner`` at N=2048, M=8 for T=320 ticks from an
   empty map through the kernels: the seq_scan counter equals T,
   ``n_seen`` and ``seen`` equal the plain path on the card after every
   tick, the state is within the scale tolerance of the plain path and
   matches ``tests/fixtures/serving_unknown_n2048_golden.json`` with equal
   decisions; the smallest relative gate margin of the plain path is
   printed, so a rounding tie can be told from a fault;
10. dense -- the dense-engine main path on ``benchmarks/
   bench_dense_serving.py``'s workload (N=2048, a converged map, exact
   measurements, twist 0): ``pallas_update='on'`` padded to D=4224 for 32
   ticks (the cov_update counter equals 32 x 8), against ``'off'`` on the
   card, against serving (known) on the same workload through
   ``state_from_dense`` / ``state_to_dense``, and against
   ``tests/fixtures/dense_n2048_golden.json``;
11. dense_timing -- ms per tick of the four rows of that benchmark (dense
   'off', dense 'on', serving known, serving unknown) and of serving
   unknown's plain path, and ms per call of cov_update and of the unknown
   scan beside their plain versions;
12. circle_moments against its plain version at C=16384, P=64 on the
   clusters of a real batch of scans (config 3's sim after 25 ticks), with
   counts overwritten in places to 0, 1-3, exactly P and more than P and
   every row at and past a count poisoned with NaN; once more at C=1001,
   P=45; and the circle fits behind both moment routes. Then (phase
   circle_fit) the whole-fit kernel on the same three sets of clusters (as
   the scan gave them, with the edge counts, and at C=1001, P=45): its
   moments within the same bounds of the plain version's and equal to the
   moment kernel's, its centre, radius and ok equal BIT FOR BIT to the
   plain chain on its own moments and to the moment kernel's route; and
   the tail kernel bit for bit against the plain chain on the segmented
   path's own moments of the same scans. A difference fails the phase
   after naming the first differing cluster, the first of the tail's
   intermediates where the kernel's trace and the plain version's part,
   and the branch each took;
13. config3 -- ``pipeline/driver.run_scenario_batch_lanes(lidar20_full)``
   at B=1024 worlds, f32, T_CONFIG3 ticks: the first 8 worlds take their
   slip draws from ``tests/fixtures/lidar20_golden.json`` (7 noisy, 1
   deterministic), the rest from a seeded ``torch.Generator``. Everything
   finite; the fixture worlds equal the JAX run in detections and
   ``n_seen`` at every tick, poses within stated bounds, the
   deterministic world's ATE within 1e-3 m; median-world ATE, diverged
   fraction and median ``n_seen`` over all worlds; the smallest margins of
   a split, a circle and a gate decision to their thresholds; the tail
   kernel's counter equals the ticks run (path A's fit);
14. perception_buffered -- on every tick's (1024, 360) scans of phase 13,
   ``detect_landmarks(segmented=False)`` through the whole-fit kernel:
   ``valid`` equal to phase 13's segmented detections and to the
   plain-version route on the card, positions within stated bounds; the
   circle_fit counter equals the ticks run. On every 50th tick's clusters
   also the tensor-form fit (``fit_circles(componentized=False)``, behind
   the moment kernel): its counter equals those ticks, its fits held to
   the whole-fit kernel's within the phase-12 bounds;
15. config3_timing -- ms per tick and worlds x ticks / s of config 3,
   split by host clock into noise, sim, perception and filter; device
   kernels a tick of the whole tick and of path A's perception stage
   (``torch.profiler``); ms per call (CUDA events), device ms
   (``torch.profiler``) and plain ms of circle_moments, circle_fit and
   circle_fit_tail, and the fit's latency floor: one dependent read of
   device memory (the scan's probe) + the tail's dependent chain (the fit
   kernel's probe: one warp, each fit waiting for the last); the library
   calls that compute what grid_update and cov_update compute
   (``torch.baddbmm``, ``torch.addmm``), timed here and used nowhere in
   the port.

16. kernel_scaling -- the serving tick's two kernels at N = 2048, 8192 and
   16384 (M=8): the known-association tick through ``ServingEngine`` until
   the map is full, then ms per tick (known, unknown); ``seq_scan`` (known
   and unknown, a tick with matches and skips) and ``grid_update`` held
   against their plain versions at every N; every ``seq_scan`` output
   bit-equal between the smallest cluster that holds the map and the
   chosen one; ms a wrapper call by CUDA events and the kernel alone by
   ``torch.profiler``, beside the byte bound and the share of it reached;
   and for the scan the latency floor of its serial chain: M x (barriers
   x the barrier + one dependent read of device memory + an update's
   scalar chain), each term timed apart from the kernel by its probe
   kernel; beside it the kernel's own phase clock, a split of its time.
17. configs12 -- the main path of the port's bench entry
   (``python -m shermbot_navigation_tpu_torch.bench``), which launches none
   of the four kernels (every counter is read and must stay 0), f32, 600
   ticks: (a) config 1 at B=16384 on the lanes engine, every world's ATE
   within 1e-4 m of ``tests/fixtures/loop5_golden.json``'s JAX f32 ATE
   and of the C++ ``--deterministic`` ATE (``native/baseline``, built with
   ``make`` where absent), ``n_seen`` equal to the fixture
   at every tick, poses within ``CONFIGS12_POSE_TOL``, the ATE spread
   printed; (b) the same at B=1024 through ``run_scenario_batch`` (the
   dense engine under ``torch.func.vmap``) against the lanes engine on the
   same noise; (c) config 2 at B=2048 on the lanes engine, the first 8
   worlds on ``tests/fixtures/course12_golden.json``'s draws (7 noisy, 1
   deterministic): ``n_seen`` equal to the fixture at every tick, each
   fixture world's parting tick (the first tick a pose is off by more than
   the bound; none before ``CONFIG2_EARLY``) with the smallest relative
   gate margin just before it, the deterministic world's ATE within 1e-3
   m; median-world ATE, diverged fraction and median NEES over all worlds
   (never a pooled RMSE); then ``run_scenario_batch`` on the first 100
   ticks of the first 256 worlds against the lanes run; (d)
   ``course12_tuned`` at B=2048: no world may diverge; (e) config 1's
   batch sweep on the lanes engine from B=256 by 4x past 262144 while
   world x ticks / s grows by more than 10% and a full run's outputs fit,
   the saturation point, and ``torch.profiler`` over 4 ticks of each
   config on each engine: device kernels a tick, busy ms, idle share.
18. config4 -- config 4 for B4=8 worlds at N=2048, M=8 (``run_bigmap``'s
   width), each with its own map, through ``blocked_ekf``'s batched
   deferred tick (kernels 1 and 2 launched once a tick for all worlds)
   and its sequential tick (no kernel). The worlds differ
   (``config4_inputs``: world b from tick 4 b, ids shifted by 8 b, some
   measurements invalid) and fill their maps through the kernels for 264
   ticks. (a) ``config4_kernels``: on the next tick, known and unknown,
   each world's scan outputs and grid pass from the one launch for 8
   worlds are bit-equal to its own one-world launch, and held to the
   plain versions (the scan at SCAN_TOL on the same words and
   SCAN_TOL_ROW_FOR_COLUMN on the same inputs, the grid pass at
   GRID_ATOL); (b) ``config4_deferred_vs_sequential``: 32 ticks of both
   ticks, known and unknown: each measurement's kind and slot, ``n_seen``
   and ``seen`` equal at every tick, the state within DEFERRED_SEQ_TOL;
   (c) ``config4_main_path``: ``run_bigmap(batch=8)`` with every counter
   set to 0 just before: each kernel launched 32 times (once a tick),
   every world bit-equal to ``run_bigmap(batch=1)``, and the unknown
   runner's likewise; (d) ``config4_times``: ms a tick, deferred and
   sequential, at B = 1, 8, 32, 128 (N=2048) and deferred at B=8,
   N=8192, with device kernels a tick and the idle share by
   ``torch.profiler``; both kernels at B=8 by CUDA events and profiler
   beside their plain versions, bounds and (grid pass) ``torch.baddbmm``,
   and the scan's latency floor under its batched plan.

Then the card line as nvidia-smi prints it, the kernels line, and last
``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import base64
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import shermbot_navigation_tpu_torch  # noqa: F401  (pins f32 on the card)
from shermbot_navigation_tpu_torch import bench
from shermbot_navigation_tpu_torch.models import ekf_batch, ekf_slam
from shermbot_navigation_tpu_torch.models.ekf_slam import EKFConfig
from shermbot_navigation_tpu_torch.ops import circle_fit, clustering
from shermbot_navigation_tpu_torch.ops import diff_drive, se2, smallalg
from shermbot_navigation_tpu_torch.ops import landmark_detection
from shermbot_navigation_tpu_torch.ops.kernels import _build
from shermbot_navigation_tpu_torch.ops.kernels import circle_fit as cfk
from shermbot_navigation_tpu_torch.ops.kernels import circle_moments as cmk
from shermbot_navigation_tpu_torch.ops.kernels import cov_update as cu
from shermbot_navigation_tpu_torch.ops.kernels import grid_update as gu
from shermbot_navigation_tpu_torch.ops.kernels import seq_scan as sq
from shermbot_navigation_tpu_torch.ops.landmark_detection import (
    detect_landmarks)
from shermbot_navigation_tpu_torch.parallel import bigmap, blocked_ekf
from shermbot_navigation_tpu_torch.pipeline import driver, serving
from shermbot_navigation_tpu_torch.pipeline.config import get_scenario
from shermbot_navigation_tpu_torch.sim import tube_world

ROOT = Path(__file__).resolve().parent
PKG = "shermbot_navigation_tpu_torch"
FIXTURES = ROOT / "tests" / "fixtures"
GOLDEN = FIXTURES / "serving_n2048_golden.json"
GOLDEN_UNKNOWN = FIXTURES / "serving_unknown_n2048_golden.json"
GOLDEN_DENSE = FIXTURES / "dense_n2048_golden.json"
GOLDEN_LIDAR = FIXTURES / "lidar20_golden.json"
GOLDEN_LOOP5 = FIXTURES / "loop5_golden.json"
GOLDEN_COURSE12 = FIXTURES / "course12_golden.json"
N, M, T = 2048, 8, 320
D_PAD = 4224       # the benchmark's padded dense state: 3+2N up to k*128
T_DENSE = 32
B3 = 1024          # config 3's worlds: the batch the reference's programs use
T_CONFIG3 = 600    # ticks of lidar20_full (the scenario's own length)
C3, P3 = 16, 64    # cluster slots a world, point rows a cluster
SCALING_SIZES = (2048, 8192, 16384)   # map sizes of the kernel_scaling phase
SCALING_SEEN = 1792    # slots its short run sweeps (phase 4's: N - N/8)
# kernel_scaling holds the scan to its plain version twice, on two states
# (phase 4's at this N, and the full map the timed ticks run on).
# (1) On the same words: the plain version is handed the transposed planes,
# so its exact column g is the row g the kernel reads (PARITY D13). Bound:
# SCAN_TOL of scale, at every N, on both states.
# (2) On the same inputs. The two then differ by the planes' f32 asymmetry
# (printed), which grows with the ticks run and which the gain amplifies:
# no property of the kernel, and the f64 readings printed beside the check
# say so (each of kernel, plain and plain-on-transposed-planes against the
# f64 plain version on the same inputs). Bound: SCAN_TOL on phase 4's
# state at N=2048 and 8192; SCAN_TOL_ROW_FOR_COLUMN on the full map at
# every N and on phase 4's state at N=16384, where SCAN_TOL was tried
# first and failed (NVIDIA H100 80GB HBM3), always on Kb (at N=16384 on
# HSb too): the full maps of N=2048 (1.08e-4 of scale, asymmetry 3.4e-5)
# and N=8192 (5.5e-4, asymmetry 4.3e-4, which also failed a first bound of
# 5e-4), phase 4's state at N=16384 (1.8e-4); the full map of N=16384
# reads 7.2e-4 (asymmetry 1.9e-3). Where it failed, the kernel
# is as near to the f64 plain version as the f32 plain version that reads
# the same words, while the f32 plain version that reads the column is
# nearer or no nearer: full map at N=8192 5.5e-4 / 5.5e-4 / 2.4e-5 of
# scale, at N=2048 1.07e-4 / 1.07e-4 / 1.9e-6; phase 4's state at N=16384
# 1.8e-4 / 1.8e-4 / 2.2e-4. So this bound is set from those readings, as
# a guard against a change of that picture, and the same-words check above
# is the one that holds the kernel's arithmetic; a wrong replay term or
# component moves an output by a fraction of its scale.
SCAN_TOL_ROW_FOR_COLUMN = 1e-3
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOPS = 67e12            # f32 outside the tensor cores, same sheet

# seq_scan kernel vs its plain version on identical inputs, and the kernel
# path vs the plain path over the main run: both f32, differing in
# summation order, in libm ulps of atan2f/sinf/cosf and, for the scan, in
# reading grid column g as row g of the planes (PARITY D13). After 300
# ticks the planes' f32 asymmetry has grown to ~3e-5 (printed below), and
# the gain K = S H^T psi^-1 with psi ~ R = 1e-3 amplifies it: the plain
# version itself moves Kb by 4.2e-4 (of 19.7) when handed the transposed
# planes. So each output is held to max|kernel - plain| <= SCAN_TOL *
# max(1, max|plain|); diag4 over seen slots (unseen ones hold the INT_MAX
# prior and must match exactly). A wrong replay term or component moves
# an output by a fraction of its scale, orders above this bound.
SCAN_TOL = 1e-4
# grid_update with random O(1) operands: the K=16 product sums ~10 in
# magnitude, so 16 f32 roundings bound the order difference near 1e-5.
GRID_ATOL = 1e-4

# The card's run against the JAX golden fixture (XLA path, CPU, f32) after
# 320 ticks: two f32 implementations with different summation orders and
# libm, over a chain of 2560 updates. The port's plain path on a CPU
# lands at pose_xy 7.0e-6 m, heading 1.4e-6, cov_rr 1.6e-8, relative sums
# 2.3e-6 (mean_m), 2.6e-6 (diag4), 1.1e-5 (grid), grid samples 3.7e-5
# (entries 0.003..4.3). The bounds leave more than 10x of headroom and
# stay far below the scale of a wrong update (metres for positions, 5e-4
# for the robot covariance, 0.1..4 for the grid).
GOLD_TOL = {"pose_xy": 1e-4, "heading": 1e-4, "cov_rr": 2e-7,
            "sum_mean_m_rel": 5e-5, "sum_diag4_rel": 5e-5,
            "sum_cov_mm_rel": 2e-4, "grid_samples": 5e-4}

# cov_update with random O(1) operands at D=4224: each output is a
# 2-term sum of products of magnitude ~10 subtracted from an O(1) entry, so
# the kernel and the plain version's two matmuls differ by a few f32 ulps
# of 10 (~1e-6). With the flag off the kernel must copy exactly.
COV_ATOL = 1e-5

# The unknown path against the JAX golden fixture (XLA path, CPU, f32)
# after 320 ticks: association decisions (n_seen after every tick) must be
# equal; the state differs by summation order and libm over 2560 gated
# measurements. The port's plain path on a CPU keeps every decision and
# lands at pose_xy 4.7e-6 m, heading 2.6e-7, cov_rr 3.6e-8 (entries
# 1e-4..5e-3), grid samples 2.1e-6, relative sums 1.2e-6 (mean_m) and,
# over the seen slots, 2.8e-7 (diag4), 3.2e-6 (grid), 1.6e-5 (cov_rm, a
# signed sum). Its smallest relative margin of a score to a gate is
# 1.8e-4. The bounds leave more than 10x of headroom; a changed decision
# is caught exactly by n_seen, and by the state's distance from the plain
# path on the card.
GOLD_UNKNOWN_TOL = {"pose_xy": 5e-5, "heading": 5e-6, "cov_rr": 5e-7,
                    "sum_mean_m_rel": 2e-5, "sum_diag4_seen_rel": 5e-6,
                    "sum_cov_mm_seen_rel": 5e-5, "sum_cov_rm_seen_rel": 2e-4,
                    "grid_samples": 5e-5}

# The dense engine on the card, 32 ticks of the benchmark workload:
# exact measurements, so the updates shrink and correlate the covariance
# while the means move only by rounding (dz is the f32 rounding of z,
# <= 4e-6 at 65 m, so a landmark coordinate |x| <= 46 may move by one ulp,
# 3.8e-6, in one implementation and not the other). The covariance carries
# the check: a missed or doubled update moves a landmark block by ~1e-3.
# On a CPU the port's plain routes differ by: 'on' vs 'off' mean 0.0, cov
# 9.3e-10; serving vs 'off' mean 7.1e-15, cov 1.1e-8; against the JAX
# golden fixture 'off' / 'on' / serving land at mean_r 1.7e-9, cov_rr
# 2.5e-11, relative sums of means 1.6e-13, of the diagonal 8.6e-11 /
# 6.2e-11 / 2.2e-9, of all entries 4.0e-11 / 4.9e-11 / 3.1e-9, cov samples
# 9.3e-10 / 9.3e-10 / 4.7e-9. Bounds: >= 10x those on the covariance; five
# ulps of the largest coordinate on the means.
DENSE_TOL = {"mean": 2e-5, "cov": 2e-7}
GOLD_DENSE_TOL = {"mean_r": 1e-7, "max_abs_mean_shift": 2e-5,
                  "cov_rr": 1e-9, "sum_mean_m_rel": 1e-6,
                  "sum_diag_rel": 1e-7, "sum_cov_rel": 1e-7,
                  "cov_samples": 1e-7}

# circle_moments kernel vs its plain version on the same clusters: both
# f32; the kernel sums each cluster's <= 64 terms over 32 lanes and a
# shuffle tree, the plain version with torch.sum. The centroid (a sum of
# coordinates <= 1 m over the count) moves by a few 1e-8 m, so every
# centered coordinate (~0.04 m on a tube) moves by that much, and the
# moment sums by <= 64 such terms: the bound is the reference's own pin for
# its TPU kernel against XLA (moments rtol 1e-5, atol 1e-4) with the
# absolute part tightened 10x, |k - p| <= MOM_ATOL + MOM_RTOL |p|; centroid
# and z-bar within CENT_ATOL. The fits behind the two routes: ``valid``
# must be equal. Centre and radius are within FIT_ATOL (the reference's
# pin) except on a small share of fits that the ill-conditioned chain
# behind the moments moves by centimetres: this scenario's lidar is
# noise-free, so a tube's arc is an exact circle and its moment matrix has
# a smallest eigenvalue of 0 up to f32 rounding, of either sign. A negative
# one is clamped to 0 and the fit takes the null vector; a positive one
# (1e-10, say) passes the 1e-12 rank-deficiency switch and the fit solves
# a near-singular 4x4 system instead. Measured on one batch of scans
# (NVIDIA H100 80GB HBM3): the two moment routes take different branches
# on 836 of 10240 valid fits and still agree to 1e-4 on all but 8 of them
# (6 with a changed branch, 2 inside the near-singular solve), which land
# 1..5 cm apart; over a 600-tick run 0.14% of the detections. The
# reference records the same between its own engines (1 fit of 481). The
# bound is on that share (FIT_SWITCH_SHARE); the phase prints the branch
# changes beside it.
MOM_RTOL, MOM_ATOL, CENT_ATOL, FIT_ATOL = 1e-5, 1e-5, 1e-6, 1e-4
FIT_SWITCH_SHARE = 0.01
# Path B's positions against path A's segmented detections and against the
# plain-moments route: within PERCEPTION_POS_TOL (the reference's f32 pin
# for buffered against segmented) except the share at the switch above
# (measured 0.31% against path A, whose one-hot matmul sums in a third
# order, and 0.14% against the plain route); the detection masks are equal
# everywhere.
# Config 3 on the card against the JAX run of the golden fixture (XLA,
# CPU, f32), world by world. Two f32 implementations of this scenario
# cannot agree tick for tick over 600 ticks, for three reasons measured
# with the port's f32 run on a CPU against the same fixture:
# (1) the commanded wheel angles are running sums that pass 64 rad at tick
# 239 (ulp 7.6e-6); from there to 128 rad XLA's fused multiply-add and two
# separately rounded operations differ by one ulp per simulator substep,
# always the same way: 7.9e-6 rad of heading a tick, 1.9e-3 rad by tick
# 480, where the drift stops. Before tick 200 the simulators agree to
# 2.3e-6.  (2) The collision nudge is a threshold decision worth 0.02 m
# (tube_world.cpp:387), so a pose that differs by 1e-3 m takes a nudge a
# tick earlier or later: the true pose may be one nudge apart for a while
# (measured 1.98e-2).  (3) Detections appear and vanish as tubes cross the
# 1 m range, and the first-hit gate at 0.01 decides on margins of 2e-5
# relative (PARITY P17), so the noisy worlds' landmark counts part ways
# (final n_seen 13..16 against 13..16, apart by 2 at most; detections per
# tick equal on 97.3..98.7% of the ticks, never apart by more than 2, and
# equal on every tick before tick 245; the card's run gives the same
# shares). What does hold, and is held here: the simulator before tick
# 200 (sim_early), the deterministic world's n_seen at every tick and its
# ATE within 1e-3 m, every fixture world's ATE (measured 2.7e-3 at most)
# and the shares above, each with headroom. Tick-for-tick equality with
# JAX is held in f64 by tests/test_torch_driver.py, and path B's
# detections are held equal to path A's on every tick below.
CONFIG3_EARLY = 200
CONFIG3_TOL = {"sim_early": 2e-5, "true_pose": 4e-2, "odom_pose": 5e-3,
               "n_detections_share": 0.95, "n_detections_diff": 3,
               "n_seen_final": 3, "deterministic_ate": 1e-3, "ate": 1e-2}
PERCEPTION_POS_TOL = 1e-3

# Phase 17, configs 1 and 2. Worlds: config 1 at bench.py's batch, its
# dense engine at B=1024; config 2 and course12_tuned at the batch the
# JAX package reports them at (BENCH_NOTES.md); the dense engine of
# config 2 on its first 100 ticks.
B1, B1_VMAPPED = 16384, 1024
B2, B2_VMAPPED, T2_VMAPPED = 2048, 256, 100
# Poses against the JAX f32 run (and the two engines against each other):
# two f32 implementations part by the rounding of the wheel-angle sums,
# which XLA fuses (cmd_wheels + u * eta in one rounding) and the port
# rounds twice. In a noise-free world that error is the same every substep
# and grows linearly: on the CPU the port's config-1 odometry reaches
# 5.6e-5 in 600 ticks (its SLAM pose 4.8e-7), and config 2's deterministic
# world 1e-3 at tick ~360 (its noisy worlds stay within 1e-5). 1e-3 m is
# the largest bound allowed; parting beyond it is reported, not hidden.
CONFIGS12_POSE_TOL = 1e-3
CONFIG1_ATE_TOL = 1e-4         # against the JAX f32 and C++ ATE, every world
CONFIG2_DET_ATE_TOL = 1e-3     # config 2's deterministic world against JAX
CONFIG2_EARLY = 300    # no fixture world of config 2 parts before this tick
PARTING_WINDOW = 10    # ticks before a parting searched for its gate margin
SWEEP_BATCHES = (256, 1024, 4096, 16384, 65536, 262144)
SWEEP_TICKS = 20       # timed ticks a sweep point, after 2 warm ticks
SWEEP_GROWTH = 1.10    # a 4x larger batch must gain this much to go on
PROFILE_TICKS = 4
# the (B, T, ...) outputs: three poses, n_seen and NEES, f32/int32
OUTPUT_BYTES_PER_WORLD_TICK = 4 * (3 * 3 + 2)

# Phase 18, config 4 for B worlds: BASELINE config 4's "single host 8
# chips" is 8 robots on one card, each with its own N=2048 map, M=8,
# T=32 (run_bigmap's defaults). The worlds differ (config4_inputs) and
# first fill their maps through the kernels for FILL4 > N/M ticks, so the
# checked ticks revisit (updates) and init the slots left unseen.
B4 = 8
T4 = 32
FILL4 = 264
B4_SWEEP = (1, 8, 32, 128)     # worlds timed at N=2048 (grid 0.07-8.6 GB)
N4_LARGE = 8192                # the map timed at B4 (grid 8.6 GB)
# Deferred (the kernels, one grid pass a tick) against sequential (no
# kernel, M grid passes a tick) over T4 ticks of the filled maps, f32: the
# same semantics in another summation order (the deferred tick subtracts
# a tick's rank-2 terms as one sum; the scan reads grid column g as row g,
# PARITY D13). On a CPU (plain versions, exact columns, 2 of the worlds)
# the two part by at most 1.9e-6 of each field's scale after 32 ticks of
# 464 (known) and 382 (unknown) updates: cov_rm 6.5e-8 of 0.035, the seen
# grid 7.2e-6 of 5.9, cov_rr 5.6e-9 of 0.0036, mean_m 6.8e-10 of 46, all
# decisions equal. The card adds D13: the scan itself is held to
# SCAN_TOL_ROW_FOR_COLUMN of scale against the plain version on the same
# inputs, and the state takes that bound. A missed, doubled or misplaced
# update moves a field by a fraction of its scale and a changed decision
# is caught exactly.
DEFERRED_SEQ_TOL = SCAN_TOL_ROW_FOR_COLUMN

KERNELS = {
    "grid_update": {
        "source": f"{PKG}/csrc/grid_update.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/grid_update.py:87"},
    "seq_scan": {
        "source": f"{PKG}/csrc/seq_scan.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/seq_scan.py:455"},
    "seq_scan_unknown": {
        "source": f"{PKG}/csrc/seq_scan.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/seq_scan.py:455"},
    "cov_update": {
        "source": f"{PKG}/csrc/cov_update.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/cov_update.py:70"},
    "circle_moments": {
        "source": f"{PKG}/csrc/circle_fit.cu",
        "replaces":
            "shermbot_navigation_tpu/ops/pallas/circle_moments.py:73"},
    # the moments of the TPU kernel and the chain XLA fused behind it
    # (shermbot_navigation_tpu/ops/circle_fit.py:133, _fit_tail_c)
    "circle_fit": {
        "source": f"{PKG}/csrc/circle_fit.cu",
        "replaces":
            "shermbot_navigation_tpu/ops/pallas/circle_moments.py:73"},
    # the chain alone, where the TPU's moments were XLA segment sums
    "circle_fit_tail": {
        "source": f"{PKG}/csrc/circle_fit.cu",
        "replaces": "shermbot_navigation_tpu/ops/circle_fit.py:133"},
    # kernels 1 and 2 launched once for config 4's 8 worlds (phase 18)
    "grid_update_batched": {
        "source": f"{PKG}/csrc/grid_update.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/grid_update.py:87"},
    "seq_scan_batched": {
        "source": f"{PKG}/csrc/seq_scan.cu",
        "replaces": "shermbot_navigation_tpu/ops/pallas/seq_scan.py:455"},
}
# f32 operations of one cluster's fit tail, counted from csrc/circle_fit.cu:
# a Jacobi rotation is 75 multiplies, adds and subtracts and three calls
# of atan2f, cosf and sinf, each counted as 20 (their CUDA math library
# paths run 15-40 instructions); 48 rotations and the symmetrization a
# decomposition, two of them, and ~380 for Y, Q, the solve and the circle.
TAIL_FLOPS = 2 * (48 * (75 + 3 * 20) + 32) + 380


def emit(**obj):
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise AssertionError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def close_err(got, want, atol):
    """(max |got - want|, within atol everywhere)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err <= atol


def scale_err(got, want, seen=None, tol=SCAN_TOL):
    """(max |got - want|, within tol * max(1, max |want|)); with
    ``seen``, lanes (last axis) outside it must be equal exactly."""
    if seen is not None:
        if not torch.equal(got[..., ~seen], want[..., ~seen]):
            return float("inf"), False
        got, want = got[..., seen], want[..., seen]
    err = float((got.double() - want.double()).abs().max())
    return err, err <= tol * max(1.0, float(want.abs().max()))


def cuda_ms(fn, inner: int, repeats: int = 5) -> float:
    """Median over repeats of (CUDA-event time of ``inner`` calls) / inner."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def grid_operands(rng, dev, n=N):
    """Random grid-pass operands at n, M with rowT/colT holding ties,
    repeated op indices and -1."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 31)))
    f = lambda *s: torch.randn(s, generator=gen, device=dev)
    rowt = rng.integers(-1, M, n).astype(np.int32)
    colt = rng.integers(-1, M, n).astype(np.int32)
    colt[::7] = rowt[::7]                      # ties at equal op index
    return (f(2, 2, n, n), f(2, n, 2 * M), f(2, 2 * M, n), f(2, 2, M, n),
            f(2, 2, n, M), torch.from_numpy(rowt).to(dev),
            torch.from_numpy(colt).to(dev))


def grid_errors(ops):
    """grid_update against its plain version on ``ops``: (max abs error of
    the pass, max abs error of the overwrite replay alone, which has no
    arithmetic and must be exact)."""
    got = gu.fused_grid_update(ops[0].clone(), *ops[1:], use_kernel=True)
    torch.cuda.synchronize()
    err = float((got - gu.reference_grid_update(*ops)).abs().max())
    del got
    rep = (ops[0], torch.zeros_like(ops[1]), torch.zeros_like(ops[2])
           ) + ops[3:]
    replay_err = float((gu.fused_grid_update(rep[0].clone(), *rep[1:],
                                             use_kernel=True)
                        - gu.reference_grid_update(*rep)).abs().max())
    return err, replay_err


def phase_grid(dev):
    ops = grid_operands(np.random.default_rng(0), dev)
    err, replay_err = grid_errors(ops)
    emit(phase="grid_update", N=N, M=M, max_abs_err=err, atol=GRID_ATOL,
         replay_max_abs_err=replay_err,
         plan=gu.launch_plan(N, N, M))
    if not err <= GRID_ATOL or replay_err != 0.0:
        fail(f"grid_update disagrees with its plain version: {err}, "
             f"replay {replay_err}")
    return ops, err


def state_scan_args(st, n):
    """The scan's first eight arguments from a batch-1 blocked state."""
    return (st.mean_r[0], st.mean_m[0].T.contiguous(), st.cov_rr[0],
            st.cov_rm[0].permute(0, 2, 1).reshape(6, n), st.diag4[0],
            st.seen[0], st.n_seen[0], st.cov_mm[0].reshape(4, n, n))


def scan_inputs(dev, cfg, n=N, seen=None):
    """A state after T-20 ticks (300) of a schedule that sweeps the first
    ``seen`` slots (default: all but the top eighth) and leaves the rest
    unseen, and one tick mixing updates, inits, a repeated slot, an
    out-of-range id and an invalid slot."""
    eng = serving.ServingEngine(cfg, M, *bigmap.noise(device=dev),
                                robot_pose=[0.0, 0.0, 0.0], device=dev)
    wl = bigmap.make_workload(n, T, M, device=dev)
    u = n - n // 8 if seen is None else seen
    wl = wl._replace(schedule=wl.schedule % u)
    for t in range(T - 20):
        zs, ids, tw = bigmap.measurements(wl, t)
        eng.tick(tw, zs, ids=ids)
    ids = torch.tensor([5, u + 4, 5, u + 4, n + 5, (4 * u // 7) & ~7, u + 5,
                        7], dtype=torch.int32, device=dev)
    valid = torch.tensor([1, 1, 1, 1, 1, 1, 1, 0], dtype=torch.bool,
                         device=dev)
    # measurements of these ids (the out-of-range one clamped)
    wl = wl._replace(schedule=ids.clamp(0, n - 1)[None].expand(T, M))
    zs, _, _ = bigmap.measurements(wl, T - 20)
    _, R = bigmap.noise(device=dev)
    return state_scan_args(eng.state, n) + (zs, valid, ids, R)


SCAN_NAMES = ("mean_r", "mm2", "cov_rr", "rm6", "diag4", "seen", "n_seen",
              "Kb", "HSb", "CRb", "gb", "kindb")
SCAN_DISCRETE = {"seen", "n_seen", "gb", "kindb"}


def scan_compare(got, want, tol=SCAN_TOL):
    """The scan kernel's outputs against the plain version's: (max abs
    error of each continuous output, names that disagree). Discrete
    outputs must be equal, continuous ones within ``tol`` of scale."""
    errs, bad = {}, []
    for name, g, w in zip(SCAN_NAMES, got, want):
        if name in SCAN_DISCRETE:
            if not torch.equal(g, w):
                bad.append(name)
            continue
        errs[name], ok = scale_err(g, w, want[5] if name == "diag4" else None,
                                   tol)
        if not ok:
            bad.append(name)
    return errs, bad


def phase_scan(args):
    want = sq.reference_seq_scan(*args)
    got = sq.deferred_seq_scan(*args, use_kernel=True)
    torch.cuda.synchronize()
    errs, bad = scan_compare(got, want)
    planes = args[7].reshape(2, 2, N, N)
    asym = float((planes - planes.permute(1, 0, 3, 2)).abs().max())
    emit(phase="seq_scan", N=N, M=M, kinds=got[-1].tolist(),
         gb=got[-2].tolist(),
         discrete_equal=not any(b in SCAN_DISCRETE for b in bad),
         max_abs_err=errs, scale_tol=SCAN_TOL, grid_asymmetry=asym,
         plan=sq.launch_plan(N, M))
    if bad:
        fail(f"seq_scan disagrees with its plain version on {bad}")
    kinds = set(got[-1].tolist())
    if not {0, 1, 2} <= kinds:
        fail(f"the scan test tick lacks a branch: kinds {kinds}")
    return max(errs.values())


def serve(dev, cfg, wl, ticks, use_kernel):
    eng = serving.ServingEngine(cfg, M, *bigmap.noise(device=dev),
                                robot_pose=[0.0, 0.0, 0.0], device=dev,
                                seq_kernel=use_kernel, grid_kernel=use_kernel)
    for t in range(ticks):
        zs, ids, tw = bigmap.measurements(wl, t)
        eng.tick(tw, zs, ids=ids)
    torch.cuda.synchronize()
    return eng


def golden_errors(st, golden):
    """Differences of a final state from the golden fixture."""
    mean_r = st.mean_r[0].double().cpu()
    true = torch.tensor(golden["true_pose"], dtype=torch.float64)
    pos = golden["grid_samples"]["positions"]
    grid = st.cov_mm[0]
    samples = torch.stack([grid[a, b, r, c] for a, b, r, c in pos]
                          ).double().cpu()
    rel = lambda x, y: abs(x - y) / abs(y)
    pose_err = float(torch.hypot(*(mean_r[1:] - true[1:])))
    return {
        "pose_xy": float((mean_r[1:] - torch.tensor(golden["mean_r"][1:],
                                                    dtype=torch.float64)
                          ).abs().max()),
        "heading": abs(float(se2.normalize_angle(
            mean_r[0] - golden["mean_r"][0]))),
        "cov_rr": float((st.cov_rr[0].double().cpu().reshape(-1)
                         - torch.tensor(golden["cov_rr"], dtype=torch.float64)
                         ).abs().max()),
        "sum_mean_m_rel": rel(float(st.mean_m.double().sum()),
                              golden["sum_mean_m"]),
        "sum_diag4_rel": rel(float(st.diag4.double().sum()),
                             golden["sum_diag4"]),
        "sum_cov_mm_rel": rel(float(st.cov_mm.double().sum()),
                              golden["sum_cov_mm"]),
        "grid_samples": float((samples - torch.tensor(
            golden["grid_samples"]["values"], dtype=torch.float64)
                               ).abs().max()),
    }, pose_err


def phase_main(dev, cfg):
    golden = json.loads(GOLDEN.read_text())
    if (golden["N"], golden["M"], golden["T"]) != (N, M, T):
        fail(f"golden fixture is for {golden['N'], golden['M'], golden['T']}")
    wl = bigmap.make_workload(N, T, M, device=dev)

    gu.fused_grid_update.launches = 0
    sq.deferred_seq_scan.launches = 0
    t0 = time.perf_counter()
    eng = serve(dev, cfg, wl, T, None)
    seconds = time.perf_counter() - t0
    launches = {"grid_update": gu.fused_grid_update.launches,
                "seq_scan": sq.deferred_seq_scan.launches}
    plain = serve(dev, cfg, wl, T, False)

    st, ps = eng.state, plain.state
    vs_plain, plain_bad = {}, []
    for k in st._fields:
        a, b = getattr(st, k), getattr(ps, k)
        if a.dtype in (torch.bool, torch.int32):
            vs_plain[k], ok = bool(torch.equal(a, b)), bool(torch.equal(a, b))
        else:
            vs_plain[k], ok = scale_err(a, b)
        if not ok:
            plain_bad.append(k)
    gold, pose_err = golden_errors(st, golden)
    finite = all(bool(torch.isfinite(x).all()) for x in st
                 if x.dtype.is_floating_point)
    emit(phase="main_path", N=N, M=M, T=T, seconds=seconds,
         launches=launches, n_seen=eng.n_seen, pose_err=pose_err,
         golden_pose_err=golden["pose_err"], finite=finite,
         vs_plain_on_card=vs_plain, scale_tol=SCAN_TOL, vs_golden=gold, golden_tol=GOLD_TOL)
    if launches != {"grid_update": T, "seq_scan": T}:
        fail(f"main path launched {launches}, want {T} each")
    if eng.n_seen != N or not finite or not math.isfinite(pose_err):
        fail(f"main path state: n_seen {eng.n_seen}, finite {finite}, "
             f"pose_err {pose_err}")
    if plain_bad:
        fail(f"kernel path and plain path disagree on {plain_bad}")
    for k, tol in GOLD_TOL.items():
        if not gold[k] <= tol:
            fail(f"golden fixture mismatch on {k}: {gold[k]} > {tol}")
    return eng, plain, wl, launches


def phase_timing(eng, plain, wl, grid_ops, scan_args):

    def tick_ms(e, t0, ticks, repeats=5):
        out = []
        t = t0
        for _ in range(repeats):
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(ticks):
                zs, ids, tw = bigmap.measurements(wl, t)
                e.tick(tw, zs, ids=ids)
                t += 1
            torch.cuda.synchronize()
            out.append((time.perf_counter() - start) * 1e3 / ticks)
        return statistics.median(out)

    per_tick = {"kernel": tick_ms(eng, T, 50), "plain": tick_ms(plain, T, 10)}
    cov, rest = grid_ops[0], grid_ops[1:]
    grid = lambda: gu.fused_grid_update(cov, *rest, use_kernel=True)
    scan = lambda: sq.deferred_seq_scan(*scan_args, use_kernel=True)
    per_call = {
        "grid_update": {
            "ms": cuda_ms(grid, 50),
            "device_ms": profiled_device_ms(grid, "grid_update", 20),
            "plain_ms": cuda_ms(lambda: gu.reference_grid_update(cov, *rest),
                                5)},
        "seq_scan": {
            "ms": cuda_ms(scan, 50),
            "device_ms": profiled_device_ms(scan, "seq_scan", 20),
            "plain_ms": cuda_ms(lambda: sq.reference_seq_scan(*scan_args),
                                5)},
    }
    emit(phase="timing", N=N, M=M, ms_per_tick=per_tick,
         ms_per_call=per_call,
         note="ms per tick: host clock around synchronized blocks of "
              "update-only ticks; ms per call: CUDA events over wrapper "
              "calls, medians of 5; device_ms: the kernel alone by "
              "torch.profiler")
    return per_call


def phase_cov(dev):
    """cov_update against its plain version at D=4224, flag on and off."""
    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)
                                    ).to(dev)
    ops = (f(D_PAD, D_PAD), f(D_PAD, 2),
           torch.tensor([[2.0, -0.3], [-0.3, 1.5]], device=dev), f(2),
           f(D_PAD))
    errs = {}
    for flag in (True, False):
        apply = torch.tensor(flag, device=dev)
        want = cu.reference_kalman_update(*ops, apply=apply)
        got = cu.fused_kalman_update(*ops, apply=apply, use_kernel=True)
        torch.cuda.synchronize()
        errs[flag] = max(close_err(g, w, COV_ATOL)[0]
                         for g, w in zip(got, want))
    emit(phase="cov_update", D=D_PAD, max_abs_err=errs[True],
         flag_off_max_abs_err=errs[False], atol=COV_ATOL)
    if not errs[True] <= COV_ATOL or errs[False] != 0.0:
        fail(f"cov_update disagrees with its plain version: {errs}")
    return ops, errs[True]


def _z_at(mean_r, p):
    """Exact range-bearing (f64) of point ``p`` (2,) from pose ``mean_r``."""
    dx, dy = p[0] - mean_r[1], p[1] - mean_r[2]
    return torch.stack([torch.hypot(dx, dy), se2.normalize_angle(
        torch.atan2(dy, dx) - mean_r[0])])


def pick_slots(args):
    """Seen slots of the scan's input state whose exact revisit is a
    first-hit MATCH at that slot, and whose 5-cm-long revisit lands
    between the gates (a SKIP) -- chosen with the plain association,
    because the reference's first-hit rule lets an earlier, uncertain
    landmark take a measurement. Returns (match slots, skip slots)."""
    mean_r, mm2, cov_rr, rm6, diag4, seen = args[:6]
    R = args[11]
    mr, mm = mean_r.double(), mm2.double()
    match, skip = [], []
    for s in torch.nonzero(seen).flatten().tolist()[::7]:
        for long_, out in ((0.0, match), (0.05, skip)):
            z = (_z_at(mr, mm[:, s]) + torch.tensor([long_, 0.0],
                                                    device=mm.device)).float()
            hit, first, d, _ = blocked_ekf._associate_comp(
                mean_r, mm2, cov_rr, rm6, seen, z, R, diag4, new_gate=60.0,
                wrap_innovation=False)
            if long_ == 0.0 and bool(hit) and int(first) == s and \
                    float(d) < 0.001:
                out.append(s)
            if long_ and bool(hit) and 0.05 < float(d) < 30.0:
                out.append(s)
        if len(match) >= 3 and len(skip) >= 2:
            break
    return match, skip


def unknown_tick(args, plan):
    """The scan's arguments with this tick's measurements: ``plan`` lists
    ``(what, slot)`` -- "match" the exact range-bearing of landmark
    ``slot`` from the input state, "skip" that range 5 cm long, "far" a
    point 1 km off the map, "invalid" a valid=False slot; no ids."""
    mr, mm = args[0].double(), args[1].double()
    zs, valid = [], []
    for what, s in plan:
        p = mm[:, s] + (1000.0 if what == "far" else 0.0)
        zs.append(_z_at(mr, p) + torch.tensor(
            [0.05 if what == "skip" else 0.0, 0.0], device=mm.device))
        valid.append(what != "invalid")
    return args[:8] + (torch.stack(zs).float(),
                       torch.tensor(valid, device=mm.device), None, args[11])


def phase_scan_unknown(partial_args, full_args):
    """The unknown branch against its plain version on (a) and (b)."""
    match, skip = pick_slots(partial_args)
    if len(match) < 2 or not skip:
        fail(f"no clean match/skip slots in the scan state: {match}, {skip}")
    plans = {
        "partial": [("match", match[0]), ("skip", skip[0]), ("far", 20),
                    ("invalid", 3), ("match", match[1]), ("far", 40),
                    ("skip", skip[-1]), ("match", match[0])],
        "full_overflow": [("far", 20), ("match", match[0]),
                          ("skip", skip[0]), ("match", match[1]),
                          ("far", 30), ("invalid", 3), ("match", match[-1]),
                          ("skip", skip[-1])],
    }
    out, kinds_all, worst = {}, set(), 0.0
    for case, base in (("partial", partial_args),
                       ("full_overflow", full_args)):
        args = unknown_tick(base, plans[case])
        margins = []
        want = sq.reference_seq_scan(*args, known=False,
                                     gate_margins=margins)
        got = sq.deferred_seq_scan(*args, known=False, use_kernel=True)
        torch.cuda.synchronize()
        errs, bad = scan_compare(got, want)
        kinds = got[-1].tolist()
        kinds_all |= set(kinds)
        worst = max(worst, max(errs.values()))
        out[case] = dict(plan=plans[case], kinds=kinds, gb=got[-2].tolist(),
                         n_seen_in=int(base[6]), n_seen_out=int(got[6]),
                         discrete_equal=not any(b in SCAN_DISCRETE
                                                for b in bad),
                         max_abs_err=errs,
                         min_gate_margin=float(torch.stack(margins).min()))
        if bad:
            emit(phase="seq_scan_unknown", **out)
            fail(f"seq_scan (unknown, {case}) disagrees with its plain "
                 f"version on {bad}")
    emit(phase="seq_scan_unknown", N=N, M=M, scale_tol=SCAN_TOL, **out)
    if not {0, 1, 2} <= kinds_all:
        fail(f"the unknown scan ticks lack a branch: kinds {kinds_all}")
    full = out["full_overflow"]
    if full["kinds"] != [0] * M or full["n_seen_out"] != N:
        fail(f"overflow did not stop the tick: {full['kinds']}")
    return worst, unknown_tick(partial_args, plans["partial"])


def unknown_golden_errors(st, golden):
    """Differences of the unknown path's final state from its fixture
    (sums over the seen slots, which fill in order)."""
    ns = int(st.n_seen[0])
    gold, _ = golden_errors(st, golden)
    rel = lambda x, y: abs(x - y) / abs(y)
    gold.pop("sum_diag4_rel")
    gold.pop("sum_cov_mm_rel")
    gold["sum_diag4_seen_rel"] = rel(float(st.diag4[0, :, :ns].double()
                                           .sum()), golden["sum_diag4_seen"])
    gold["sum_cov_mm_seen_rel"] = rel(
        float(st.cov_mm[0, :, :, :ns, :ns].double().sum()),
        golden["sum_cov_mm_seen"])
    gold["sum_cov_rm_seen_rel"] = rel(float(st.cov_rm[0, :, :ns].double()
                                            .sum()),
                                      golden["sum_cov_rm_seen"])
    return gold


def run_unknown(dev, cfg, wl, use_kernel, margins=None):
    """T unknown ticks from an empty map, one runner call a tick; returns
    the final state and (n_seen, seen) after every tick, on the card."""
    run = bigmap.make_unknown_runner(cfg, M, dev, seq_kernel=use_kernel,
                                     grid_kernel=use_kernel,
                                     gate_margins=margins)
    Q, R = bigmap.noise(device=dev)
    st = blocked_ekf.init(cfg, 1, device=dev)
    hist = []
    for t in range(T):
        st = run(st, wl, Q, R, t, 1)
        hist.append((st.n_seen.clone(), st.seen.clone()))
    torch.cuda.synchronize()
    return st, hist


def phase_serving_unknown(dev, cfg):
    golden = json.loads(GOLDEN_UNKNOWN.read_text())
    if (golden["N"], golden["M"], golden["T"]) != (N, M, T):
        fail(f"golden fixture is for {golden['N'], golden['M'], golden['T']}")
    wl = bigmap.make_workload(N, T, M, device=dev)

    gu.fused_grid_update.launches = 0
    sq.deferred_seq_scan.launches = 0
    t0 = time.perf_counter()
    st, hist = run_unknown(dev, cfg, wl, None)
    seconds = time.perf_counter() - t0
    launches = {"grid_update": gu.fused_grid_update.launches,
                "seq_scan": sq.deferred_seq_scan.launches}
    margins = []
    ps, phist = run_unknown(dev, cfg, wl, False, margins)

    per_tick_equal = all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                         for a, b in zip(hist, phist))
    n_seen_ticks = [int(x[0][0]) for x in hist]
    decisions_equal = n_seen_ticks == golden["n_seen_per_tick"]
    first_diff = next((t for t, (a, b) in enumerate(
        zip(n_seen_ticks, golden["n_seen_per_tick"])) if a != b), None)
    vs_plain, plain_bad = {}, []
    for k in st._fields:
        a, b = getattr(st, k), getattr(ps, k)
        if a.dtype in (torch.bool, torch.int32):
            vs_plain[k] = ok = bool(torch.equal(a, b))
        else:
            vs_plain[k], ok = scale_err(a, b)
        if not ok:
            plain_bad.append(k)
    gold = unknown_golden_errors(st, golden)
    finite = all(bool(torch.isfinite(x).all()) for x in st
                 if x.dtype.is_floating_point)
    margin = float(torch.stack(margins).min())
    emit(phase="serving_unknown", N=N, M=M, T=T, seconds=seconds,
         launches=launches, n_seen=int(st.n_seen[0]),
         golden_n_seen=golden["n_seen"], finite=finite,
         seen_equal_plain_every_tick=per_tick_equal,
         decisions_equal_golden=decisions_equal,
         first_tick_differing_from_golden=first_diff,
         min_gate_margin_plain=margin, vs_plain_on_card=vs_plain,
         scale_tol=SCAN_TOL, vs_golden=gold, golden_tol=GOLD_UNKNOWN_TOL)
    if launches != {"grid_update": T, "seq_scan": T}:
        fail(f"unknown path launched {launches}, want {T} each")
    if not per_tick_equal or plain_bad:
        fail(f"unknown kernel path and plain path disagree: per-tick seen "
             f"{per_tick_equal}, fields {plain_bad}")
    if not finite or not decisions_equal:
        fail(f"unknown path state: finite {finite}, decisions equal to the "
             f"golden fixture {decisions_equal} (first tick {first_diff})")
    for k, tol in GOLD_UNKNOWN_TOL.items():
        if not gold[k] <= tol:
            fail(f"unknown golden fixture mismatch on {k}: {gold[k]} > {tol}")
    return launches


def seeded_dense(cfg, dev):
    """``bench_dense_serving.make_seeded_state``: every landmark seen at
    its grid position, covariance diag 0.01 on the logical dims, zero on
    the padded tail. Returns (state, landmarks (N, 2) f64)."""
    D = cfg.dim
    side = math.ceil(math.sqrt(N))
    ii = torch.arange(N, dtype=torch.float64)
    lms = torch.stack([(torch.remainder(ii, side) - side / 2) * 2.0,
                       (torch.div(ii, side, rounding_mode="floor")
                        - side / 2) * 2.0], dim=-1)
    st = ekf_slam.init(cfg, [0.0, 0.0, 0.0], device=dev)
    mean = st.mean.clone()
    mean[3:3 + 2 * N] = lms.reshape(-1).to(dev, torch.float32)
    diag = torch.zeros(D, device=dev)
    diag[:3 + 2 * N] = 0.01
    return st._replace(mean=mean, cov=torch.diag(diag),
                       n_seen=torch.tensor(N, dtype=torch.int32, device=dev),
                       seen=torch.ones(N, dtype=torch.bool, device=dev)), lms


def dense_schedule(lms, ticks, dev):
    """``bench_dense_serving.make_schedule``: tick t measures ids
    [tM, tM+M) mod N exactly (computed in f64, stored f32)."""
    ids = (torch.arange(ticks)[:, None] * M + torch.arange(M)[None]) % N
    p = lms[ids]
    zs = torch.stack([torch.hypot(p[..., 0], p[..., 1]),
                      torch.atan2(p[..., 1], p[..., 0])], dim=-1)
    return zs.to(dev, torch.float32), ids.to(dev, torch.int32)


def dense_noise(dev):
    return (torch.eye(3, device=dev) * 1e-6, torch.eye(2, device=dev) * 1e-3)


def run_dense(cfg, st, sched, t0, ticks):
    zs, ids = sched
    dev = st.mean.device
    Q, R = dense_noise(dev)
    tw = torch.zeros(3, device=dev)
    valid = torch.ones(M, dtype=torch.bool, device=dev)
    n = zs.shape[0]
    for t in range(t0, t0 + ticks):
        st = ekf_slam.known_association_step(cfg, st, tw, zs[t % n], valid,
                                             ids[t % n], Q, R)
    return st


def dense_configs():
    """'on' (padded, the kernel), 'off' (unpadded, plain), serving."""
    return (EKFConfig(num_landmarks=N, pad_state_to=D_PAD,
                      pallas_update="on", symmetrize=False),
            EKFConfig(num_landmarks=N, pallas_update="off",
                      symmetrize=False),
            EKFConfig(num_landmarks=N, symmetrize=False))


def serving_on_dense(cfg_srv, cfg_off, dev, known=True, use_kernel=None):
    seeded, _ = seeded_dense(cfg_off, dev)
    return serving.ServingEngine(cfg_srv, M, *dense_noise(dev), known=known,
                                 dense_state=seeded, device=dev,
                                 seq_kernel=use_kernel,
                                 grid_kernel=use_kernel)


def dense_golden_errors(st, golden):
    """Differences of a dense final state (logical part) from the
    fixture."""
    D = golden["D"]
    mean, cov = st.mean[:D].double().cpu(), st.cov[:D, :D].double().cpu()
    seeded, _ = seeded_dense(dense_configs()[1], "cpu")
    rel = lambda x, y: abs(x - y) / abs(y)
    pos = torch.tensor(golden["cov_samples"]["positions"])
    return {
        "mean_r": float((mean[:3] - torch.tensor(golden["mean_r"],
                                                 dtype=torch.float64)
                         ).abs().max()),
        "max_abs_mean_shift": abs(float((mean - seeded.mean.double())
                                        .abs().max())
                                  - golden["max_abs_mean_shift"]),
        "cov_rr": float((cov[:3, :3].reshape(-1) - torch.tensor(
            golden["cov_rr"], dtype=torch.float64)).abs().max()),
        "sum_mean_m_rel": rel(float(mean[3:].sum()), golden["sum_mean_m"]),
        "sum_diag_rel": rel(float(torch.diagonal(cov).sum()),
                            golden["sum_diag"]),
        "sum_cov_rel": rel(float(cov.sum()), golden["sum_cov"]),
        "cov_samples": float((cov[pos[:, 0], pos[:, 1]] - torch.tensor(
            golden["cov_samples"]["values"], dtype=torch.float64)
                              ).abs().max()),
    }


def phase_dense(dev):
    golden = json.loads(GOLDEN_DENSE.read_text())
    cfg_on, cfg_off, cfg_srv = dense_configs()
    if (golden["N"], golden["M"], golden["T"], golden["D"]) != (
            N, M, T_DENSE, 3 + 2 * N):
        fail(f"dense golden fixture is for {golden['N'], golden['T']}")
    seeded_on, lms = seeded_dense(cfg_on, dev)
    sched = dense_schedule(lms, T_DENSE, dev)

    cu.fused_kalman_update.launches = 0
    t0 = time.perf_counter()
    on = run_dense(cfg_on, seeded_on, sched, 0, T_DENSE)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = cu.fused_kalman_update.launches

    off = run_dense(cfg_off, seeded_dense(cfg_off, dev)[0], sched, 0,
                    T_DENSE)
    srv = serving_on_dense(cfg_srv, cfg_off, dev)
    zs, ids = sched
    for t in range(T_DENSE):
        srv.tick(torch.zeros(3, device=dev), zs[t], ids=ids[t])
    srv_dense = serving.state_to_dense(cfg_off, srv.state)
    torch.cuda.synchronize()

    D = 3 + 2 * N
    diff = lambda a, b: float((a.double() - b.double()).abs().max())
    vs_off = {"mean": diff(on.mean[:D], off.mean),
              "cov": diff(on.cov[:D, :D], off.cov)}
    vs_srv = {"mean": diff(on.mean[:D], srv_dense.mean),
              "cov": diff(on.cov[:D, :D], srv_dense.cov)}
    tail_zero = not bool(on.mean[D:].any() or on.cov[D:].any()
                         or on.cov[:, D:].any())
    discrete = (int(on.n_seen) == int(off.n_seen) == int(srv.n_seen) == N
                and bool(on.seen.all()))
    finite = bool(torch.isfinite(on.cov).all() and torch.isfinite(on.mean)
                  .all())
    gold = dense_golden_errors(on, golden)
    emit(phase="dense", N=N, M=M, T=T_DENSE, D=D_PAD, seconds=seconds,
         launches={"cov_update": launches}, finite=finite,
         padded_tail_zero=tail_zero, vs_off_on_card=vs_off,
         vs_serving_on_card=vs_srv, tol=DENSE_TOL, vs_golden=gold,
         golden_tol=GOLD_DENSE_TOL)
    if launches != T_DENSE * M:
        fail(f"dense path launched cov_update {launches} times, want "
             f"{T_DENSE * M}")
    if not (finite and tail_zero and discrete):
        fail(f"dense state: finite {finite}, tail zero {tail_zero}, "
             f"n_seen/seen {discrete}")
    for name, errs in (("'off'", vs_off), ("serving", vs_srv)):
        for k, tol in DENSE_TOL.items():
            if not errs[k] <= tol:
                fail(f"dense 'on' vs {name}: {k} {errs[k]} > {tol}")
    for k, tol in GOLD_DENSE_TOL.items():
        if not gold[k] <= tol:
            fail(f"dense golden fixture mismatch on {k}: {gold[k]} > {tol}")
    return launches, (on, off, srv, sched)


def phase_dense_timing(dev, dense, cov_ops, unk_args):
    """ms per tick of the benchmark's four rows and of serving unknown's
    plain path, taken in turns (each round times one block of every row,
    the order reversed every other round) so that host noise falls on all
    rows alike; host clock around synchronized blocks, medians. ms per
    call of cov_update and the unknown scan beside their plain versions
    (CUDA events)."""
    on, off, srv, _ = dense
    cfg_on, cfg_off, cfg_srv = dense_configs()
    _, lms = seeded_dense(cfg_off, "cpu")
    zs, ids = dense_schedule(lms, 512, dev)
    tw = torch.zeros(3, device=dev)
    state = {"on": on, "off": off}

    def dense_tick(key, cfg):
        def tick(t):
            state[key] = run_dense(cfg, state[key], (zs, ids), t, 1)
        return tick

    unk = serving_on_dense(cfg_srv, cfg_off, dev, known=False)
    unk_plain = serving_on_dense(cfg_srv, cfg_off, dev, known=False,
                                 use_kernel=False)
    for e in (unk, unk_plain):
        e.tick(tw, zs[0])                       # warm
    # row: (tick function, ticks a block, rounds)
    rows = {
        "dense_off": (dense_tick("off", cfg_off), 8, 6),
        "dense_on": (dense_tick("on", cfg_on), 8, 6),
        "serving_known": (lambda t: srv.tick(tw, zs[t % 512],
                                             ids=ids[t % 512]), 20, 6),
        "serving_unknown": (lambda t: unk.tick(tw, zs[t % 512]), 20, 6),
        "serving_unknown_plain": (
            lambda t: unk_plain.tick(tw, zs[t % 512]), 3, 2),
    }
    clock = {k: T_DENSE for k in rows}
    times = {k: [] for k in rows}
    order = list(rows)
    for rnd in range(6):
        for k in (order if rnd % 2 == 0 else order[::-1]):
            tick, ticks, rounds = rows[k]
            if rnd >= rounds:
                continue
            torch.cuda.synchronize()
            start = time.perf_counter()
            for _ in range(ticks):
                tick(clock[k])
                clock[k] += 1
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - start) * 1e3 / ticks)
    per_tick = {k: statistics.median(v) for k, v in times.items()}
    spread = {k: [min(v), max(v)] for k, v in times.items()}
    cov_call = lambda: cu.fused_kalman_update(*cov_ops, use_kernel=True)
    unk_call = lambda: sq.deferred_seq_scan(*unk_args, known=False,
                                            use_kernel=True)
    per_call = {
        "cov_update": {
            "ms": cuda_ms(cov_call, 50),
            "device_ms": profiled_device_ms(cov_call, "cov_update", 20),
            "plain_ms": cuda_ms(lambda: cu.reference_kalman_update(
                *cov_ops), 20)},
        "seq_scan_unknown": {
            "ms": cuda_ms(unk_call, 50),
            "device_ms": profiled_device_ms(unk_call, "seq_scan", 20),
            "plain_ms": cuda_ms(lambda: sq.reference_seq_scan(
                *unk_args, known=False), 5)},
    }
    emit(phase="dense_timing", N=N, M=M, D_on=D_PAD, D_off=3 + 2 * N,
         ms_per_tick=per_tick, ms_per_tick_min_max=spread,
         ms_per_call=per_call, n_seen_unknown=unk.n_seen,
         note="bench_dense_serving workload, symmetrize=False; ms per "
              "tick: host clock around synchronized blocks taken in turns, "
              "median of 6 blocks (plain: of 2); ms per call: CUDA events, "
              "medians of 5")
    return per_call


def lidar_fixture():
    """The JAX golden run of ``lidar20_full`` (8 worlds, CPU, f32) and its
    replayed slip normals ``(T, 7, S, 2)``."""
    golden = json.loads(GOLDEN_LIDAR.read_text())
    slip = np.frombuffer(base64.b64decode(golden["slip_normals_f32_b64"]),
                         "<f4").reshape(golden["slip_normals_shape"])
    return golden, slip


def real_scans(dev, scn, ticks=25, seed=3):
    """The ``(B3, 360)`` scans of config 3's sim after ``ticks`` ticks."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    last = {}
    driver.run_scenario_batch_lanes(
        scn, gen, B3, steps=ticks, device=dev,
        on_tick=lambda t, obs, zs, valid: last.update(scan=obs.scan))
    return last["scan"]


def moment_errors(got, want):
    """Kernel outputs ``(m16, cent, zbar)`` against the plain version's:
    (max abs errors, worst ratio of a moment's error to its bound, ok)."""
    m_err = (got[0].double() - want[0].double()).abs()
    ratio = float((m_err / (MOM_ATOL + MOM_RTOL * want[0].double().abs())
                   ).max())
    errs = {"m16": float(m_err.max()),
            "centroid": close_err(got[1], want[1], CENT_ATOL)[0],
            "zbar": close_err(got[2], want[2], CENT_ATOL)[0]}
    ok = (ratio <= 1.0 and errs["centroid"] <= CENT_ATOL
          and errs["zbar"] <= CENT_ATOL)
    return errs, ratio, ok


def phase_circle_moments(dev, scn):
    """Kernel 4 against its plain version at the main shapes, on real
    clusters with edge counts, and at an odd C and P."""
    scan = real_scans(dev, scn)
    params = scn.world_params(device=dev)
    clusters = clustering.cluster_scan(scan, params.scan_min, params.scan_max,
                                       max_clusters=C3, max_points=P3)
    C = B3 * C3
    rng = np.random.default_rng(4)
    pts = clusters.points.reshape(C, P3, 2).clone()
    cnt = clusters.counts.reshape(C).clone()
    real_counts = cnt.clone()
    # every 7th cluster: an empty one, 1-3 points, exactly P, more than P;
    # the last two on noisy arcs of a tube-sized circle filling all P rows
    arc = rng.uniform(0.0, math.pi, (C, P3))
    ring = np.stack([0.5 + 0.04 * np.cos(arc), 0.3 + 0.04 * np.sin(arc)], -1)
    ring += rng.normal(scale=1e-3, size=ring.shape)
    ring = torch.from_numpy(ring.astype(np.float32)).to(dev)
    over = torch.from_numpy(rng.integers(P3 + 1, 3 * P3, C).astype(np.int32)
                            ).to(dev)
    few = torch.from_numpy(rng.integers(1, 4, C).astype(np.int32)).to(dev)
    k = torch.arange(C, device=dev) % 7
    cnt = torch.where(k == 0, torch.zeros_like(cnt), cnt)
    cnt = torch.where(k == 1, torch.minimum(few, torch.clamp_min(cnt, 1)), cnt)
    full = (k == 2) | (k == 3)
    pts = torch.where(full[:, None, None], ring, pts)
    cnt = torch.where(k == 2, torch.full_like(cnt, P3), cnt)
    cnt = torch.where(k == 3, over, cnt)
    # rows at and past the count may hold anything: poison them
    row = torch.arange(P3, device=dev)
    pts = torch.where((row[None, :] >= cnt[:, None])[..., None],
                      torch.full_like(pts, float("nan")), pts)

    want = cmk.circle_moments_raw(pts, cnt, use_kernel=False)
    got = cmk.circle_moments_raw(pts, cnt, use_kernel=True)
    torch.cuda.synchronize()
    errs, ratio, ok = moment_errors(got, want)
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    n_equal = bool(torch.equal(got[0][:, 15], want[0][:, 15]))

    # a C that is no multiple of 8 and a P that is no multiple of 32, in
    # the leading-batch form (7, 143) that the wrapper flattens
    Co, Po = 7 * 143, 45
    opts = torch.from_numpy(rng.normal(size=(7, 143, Po, 2)).astype(
        np.float32)).to(dev)
    ocnt = torch.from_numpy(rng.integers(0, Po + 9, (7, 143)).astype(
        np.int64)).to(dev)
    owant = cmk.circle_moments_raw(opts, ocnt, use_kernel=False)
    ogot = cmk.circle_moments_raw(opts, ocnt, use_kernel=True)
    torch.cuda.synchronize()
    oerrs, oratio, ook = moment_errors(ogot, owant)
    shapes_ok = [tuple(g.shape) for g in ogot] == [
        (7, 143, 16), (7, 143, 2), (7, 143)]

    # the fits behind both routes, on the real clusters as the scan gave
    # them (no overwritten counts)
    fk = circle_fit.fit_circles(clusters, use_kernel=True)
    fp = circle_fit.fit_circles(clusters, use_kernel=False)
    torch.cuda.synchronize()
    both = fk.valid & fp.valid
    dpos = torch.where(both, (fk.center - fp.center).abs().amax(-1),
                       torch.zeros_like(fk.radius))
    drad = torch.where(both, (fk.radius - fp.radius).abs(),
                       torch.zeros_like(fk.radius))
    dfit = torch.maximum(dpos, drad)
    # which branch of the fit each route takes: the smallest eigenvalue of
    # the moment matrix against the fit's rank-deficiency switch
    def rank_deficient(use_kernel):
        m16, _, _ = cmk.circle_moments_raw(clusters.points, clusters.counts,
                                           use_kernel=use_kernel)
        lam, _ = smallalg.eigh4_jacobi_c([m16[..., i] for i in range(16)])
        return torch.sqrt(torch.clamp_min(lam[0], 0.0)) < 1e-12

    flips = (rank_deficient(True) != rank_deficient(False)) & both
    off = dfit > FIT_ATOL
    fits = {"valid_equal": bool(torch.equal(fk.valid, fp.valid)),
            "n_valid": int(both.sum()),
            "max_abs_err": float(dfit.max()),
            "n_over_1e-4": int(off.sum()),
            "n_over_1e-3": int((dfit > 1e-3).sum()),
            "n_over_1e-2": int((dfit > 1e-2).sum()),
            "n_branch_flips": int(flips.sum()),
            "n_over_1e-4_with_branch_flip": int((off & flips).sum()),
            "max_abs_err_same_branch": float(
                torch.where(flips, torch.zeros_like(dfit), dfit).max())}
    emit(phase="circle_moments", C=C, P=P3,
         counts={"zero": int((cnt == 0).sum()),
                 "one_to_three": int(((cnt >= 1) & (cnt <= 3)).sum()),
                 "exactly_P": int((cnt == P3).sum()),
                 "over_P": int((cnt > P3).sum()),
                 "max": int(cnt.max()),
                 "real_mean": float(real_counts.float().mean()),
                 "real_max": int(real_counts.max())},
         max_abs_err=errs, worst_ratio_to_bound=ratio, finite=finite,
         count_entry_equal=n_equal,
         odd={"C": Co, "P": Po, "max_abs_err": oerrs,
              "worst_ratio_to_bound": oratio, "shapes_ok": shapes_ok},
         fits=fits, rtol=MOM_RTOL, atol=MOM_ATOL, centroid_atol=CENT_ATOL,
         fit_atol=FIT_ATOL)
    if not (ok and finite and n_equal):
        fail(f"circle_moments disagrees with its plain version: {errs}, "
             f"ratio {ratio}, finite {finite}, count entry {n_equal}")
    if not (ook and shapes_ok):
        fail(f"circle_moments at C={Co}, P={Po}: {oerrs}, ratio {oratio}, "
             f"shapes {shapes_ok}")
    if not fits["valid_equal"] or fits["n_over_1e-4"] > FIT_SWITCH_SHARE * \
            fits["n_valid"]:
        fail(f"fits behind the kernel and the plain moments differ: {fits}")
    sets = {"real": (clusters.points, clusters.counts, clusters.valid),
            "edge_counts": (pts, cnt, (cnt >= 3) & (torch.arange(
                C, device=dev) % 11 != 5)),
            "odd": (opts, ocnt, ocnt >= 3)}
    return ((clusters.points, clusters.counts),
            max(errs["m16"], oerrs["m16"]), scan, sets)


def same_bits(g, w):
    """Elementwise: equal bit for bit (any NaN equals any NaN)."""
    if not g.is_floating_point():
        return g == w
    return (g.view(torch.int32) == w.view(torch.int32)) | (
        torch.isnan(g) & torch.isnan(w))


def first_difference(got, want):
    """The first cluster (flat index) where the fits ``(center, radius,
    ok)`` differ in any bit, or None."""
    C = got[2].numel()
    same = torch.ones(C, dtype=torch.bool, device=got[2].device)
    for g, w in zip(got, want):
        same &= same_bits(g, w).reshape(C, -1).all(-1)
    bad = torch.nonzero(~same)
    return None if bad.numel() == 0 else int(bad[0])


def diagnose(c, m16, cent, zbar, cnt, valid):
    """Where cluster ``c``'s tail parts from the plain version: the
    kernel's trace (``circle_fit.trace``) against the plain chain's on the
    card, op by op, and the branch each took."""
    m16, cent = m16.reshape(-1, 16), cent.reshape(-1, 2)
    zbar, cnt, valid = zbar.reshape(-1), cnt.reshape(-1), valid.reshape(-1)
    names = cfk.trace_names()
    trace = []
    cfk._fit_tail_c([m16[c:c + 1, k] for k in range(16)], cent[c:c + 1, 0],
                    cent[c:c + 1, 1], zbar[c:c + 1], cnt[c:c + 1],
                    valid[c:c + 1], trace=trace)
    plain = torch.cat([v.reshape(1).float() for _, v in trace])
    got = cfk.trace(m16[c], cent[c, 0], cent[c, 1], zbar[c],
                    bool(valid[c]) and int(cnt[c]) >= 4)
    differ = torch.nonzero(~same_bits(got, plain))
    i = int(differ[0]) if differ.numel() else None
    rank = names.index("rank_deficient")
    return {"cluster": c, "count": int(cnt[c]),
            "first_op": None if i is None else names[i],
            "kernel_value": None if i is None else float(got[i]),
            "plain_value": None if i is None else float(plain[i]),
            "kernel_rank_deficient": bool(got[rank]),
            "plain_rank_deficient": bool(plain[rank])}


def phase_circle_fit(dev, scn, scan, sets):
    """The whole-fit kernel and the tail kernel against their plain
    versions on the card, bit for bit (see the module docstring, phase
    12)."""
    out, bad = {}, []
    for name, (pts, cnt, valid) in sets.items():
        got = cfk.circle_fit_raw(pts, cnt, valid, use_kernel=True)
        mom = cmk.circle_moments_raw(pts, cnt, use_kernel=True)
        torch.cuda.synchronize()
        plain_mom = cmk.circle_moments_raw(pts, cnt, use_kernel=False)
        errs, ratio, ok = moment_errors(got[3:], plain_mom)
        m16, cent, zbar = got[3:]
        own = cfk._fit_tail_c([m16[..., k] for k in range(16)],
                              cent[..., 0], cent[..., 1], zbar, cnt, valid)
        route = cfk._fit_tail_c([mom[0][..., k] for k in range(16)],
                                mom[1][..., 0], mom[1][..., 1], mom[2], cnt,
                                valid)
        diff_own = first_difference(got[:3], own)
        diff_route = first_difference(got[:3], route)
        out[name] = {
            "C": got[2].numel(), "P": pts.shape[-2],
            "moments_max_abs_err": errs, "worst_ratio_to_bound": ratio,
            "moments_equal_moment_kernel": all(
                bool(same_bits(a, b).all()) for a, b in zip(got[3:], mom)),
            "first_difference_vs_plain_chain": diff_own,
            "first_difference_vs_moment_kernel_route": diff_route,
            "n_ok": int(got[2].sum()),
            "max_abs_err": max(float((a.double() - b.double()).abs()
                                     .nan_to_num(0.0).max())
                               for a, b in zip(got[:2], own[:2]))}
        if not (ok and out[name]["moments_equal_moment_kernel"]):
            bad.append(f"{name}: moments")
        for key, diff in (("plain_chain", diff_own),
                          ("moment_kernel_route", diff_route)):
            if diff is not None:
                out[name][f"diagnosis_vs_{key}"] = diagnose(
                    diff, m16, cent, zbar, cnt, valid)
                bad.append(f"{name}: fit vs {key}")

    params = scn.world_params(device=dev)
    tail_in = landmark_detection._segment_fit_inputs(
        scan, params.scan_min, params.scan_max, C3, P3)[:6]
    got = cfk.fit_tail(*tail_in, use_kernel=True)
    torch.cuda.synchronize()
    want = cfk.fit_tail(*tail_in, use_kernel=False)
    diff = first_difference(got, want)
    out["tail_on_path_a_moments"] = {
        "C": got[2].numel(), "n_ok": int(got[2].sum()),
        "first_difference_vs_plain_chain": diff,
        "max_abs_err": max(float((a.double() - b.double()).abs()
                                 .nan_to_num(0.0).max())
                           for a, b in zip(got[:2], want[:2]))}
    if diff is not None:
        mom, cx, cy, zbar, cnt, valid = tail_in
        m16 = torch.stack(cfk.components(mom), -1)
        out["tail_on_path_a_moments"]["diagnosis"] = diagnose(
            diff, m16, torch.stack([cx, cy], -1), zbar, cnt, valid)
        bad.append("tail on path A's moments")
    emit(phase="circle_fit", **out, rtol=MOM_RTOL, atol=MOM_ATOL,
         centroid_atol=CENT_ATOL,
         note="fits must equal the plain chain bit for bit; "
              "first_difference: flat index of the first cluster that "
              "differs (null: none)")
    if bad:
        fail(f"circle_fit / circle_fit_tail differ from their plain "
             f"versions: {bad}")
    return (max(out[name]["max_abs_err"] for name in sets),
            out["tail_on_path_a_moments"]["max_abs_err"])


def noise_sequence(scn, dev, B, T, seed):
    """A run's noise ``(T, B, ...)`` from a seeded generator."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ticks = [driver.draw_noise(scn, gen, (B,)) for _ in range(T)]
    return tube_world.TickNoise(*(torch.stack(f) for f in zip(*ticks)))


def config3_noise(scn, dev, gslip, T, seed=11):
    """The run's noise sequence ``(T, B3, ...)``: a seeded generator's
    draws, with the slip normals of the first worlds taken from the golden
    fixture (its noisy worlds, then zeros for its deterministic world)."""
    seq = noise_sequence(scn, dev, B3, T, seed)
    nf = gslip.shape[1]
    seq.slip[:, :nf] = torch.from_numpy(gslip[:T].copy()).to(dev)
    seq.slip[:, nf] = 0.0
    return seq


def reset_counters():
    for fn in (gu.fused_grid_update, sq.deferred_seq_scan,
               cu.fused_kalman_update, cmk.circle_moments_raw,
               cfk.circle_fit_raw, cfk.fit_tail):
        fn.launches = 0


def fit_launches():
    return {"circle_fit": cfk.circle_fit_raw.launches,
            "circle_fit_tail": cfk.fit_tail.launches,
            "circle_moments": cmk.circle_moments_raw.launches}


def kernel_launches():
    """Every kernel's launch counter (the two scan branches share one)."""
    return {"grid_update": gu.fused_grid_update.launches,
            "seq_scan": sq.deferred_seq_scan.launches,
            "cov_update": cu.fused_kalman_update.launches, **fit_launches()}


def phase_config3(dev, scn):
    """Path A: config 3 end to end at B3 worlds."""
    golden, gslip = lidar_fixture()
    T = T_CONFIG3
    nfix = golden["B"]
    if golden["scenario"] != scn.name or golden["T"] < T:
        fail(f"lidar fixture is for {golden['scenario']}, T={golden['T']}")
    noise = config3_noise(scn, dev, gslip, T)
    scans = torch.empty((T, B3, 360), device=dev)
    zs_all = torch.empty((T, B3, C3, 2), device=dev)
    valid_all = torch.empty((T, B3, C3), dtype=torch.bool, device=dev)

    def keep(t, obs, zs, valid):
        scans[t], zs_all[t], valid_all[t] = obs.scan, zs, valid

    margins = {}
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = driver.run_scenario_batch_lanes(scn, noise, B3, steps=T,
                                           device=dev, margins=margins,
                                           on_tick=keep)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fit_launches()
    del noise

    finite = all(bool(torch.isfinite(x).all()) for x in outs
                 if x.dtype.is_floating_point) and bool(
        torch.isfinite(zs_all[valid_all]).all())
    # the fixture worlds against the JAX run, world by world
    n_det = valid_all[:, :nfix].sum(-1).T.cpu()                # (nfix, T)
    g_det = torch.tensor(golden["n_detections"])[:, :T]
    g_seen = torch.tensor(golden["n_seen"])[:, :T]
    n_seen = outs.n_seen[:nfix].cpu().long()
    early = min(T, CONFIG3_EARLY)
    det_world = nfix - 1
    ev = golden["pose_every"]
    ns = T // ev
    pose_err, pose_err_early = {}, {}
    for f in ("true_pose", "odom_pose", "slam_pose"):
        got = getattr(outs, f)[:nfix, ev - 1::ev][:, :ns].double().cpu()
        want = torch.tensor(golden[f], dtype=torch.float64)[:, :ns]
        d = got - want
        d[..., 0] = se2.normalize_angle(d[..., 0])
        pose_err[f] = float(d.abs().max())
        pose_err_early[f] = float(d[:, :early // ev].abs().max())
    ate = bench.world_ate(outs)
    ate_fix = ate[:nfix].cpu()
    ate_err = (ate_fix - torch.tensor(golden["ate"], dtype=torch.float64)
               ).abs().tolist() if T == golden["T"] else None
    fixture = {
        "worlds": nfix,
        "n_detections_equal_early": bool(torch.equal(n_det[:, :early],
                                                     g_det[:, :early])),
        "n_detections_equal_share": (n_det == g_det).double().mean(-1)
        .tolist(),
        "n_detections_max_diff": int((n_det - g_det).abs().max()),
        "n_seen_equal_ticks": (n_seen == g_seen).sum(-1).tolist(),
        "n_seen_final": n_seen[:, -1].tolist(),
        "golden_n_seen_final": g_seen[:, -1].tolist(),
        "deterministic_n_seen_equal": bool(torch.equal(n_seen[det_world],
                                                       g_seen[det_world])),
        "pose_max_abs_err": pose_err, "pose_max_abs_err_early":
        pose_err_early, "early_ticks": early, "ate": ate_fix.tolist(),
        "golden_ate": golden["ate"], "ate_abs_err": ate_err}
    last_seen = outs.n_seen[:, -1]
    emit(phase="config3", scenario=scn.name, B=B3, T=T, seconds=seconds,
         ms_per_tick=seconds * 1e3 / T, finite=finite,
         launches=launches, fixture=fixture,
         tol=CONFIG3_TOL,
         all_worlds={"median_ate": float(ate.median()),
                     "diverged_fraction": float((ate > 1.0).double().mean()),
                     "median_n_seen": float(last_seen.float().median()),
                     "min_n_seen": int(last_seen.min()),
                     "max_n_seen": int(last_seen.max()),
                     "detections_per_tick": float(
                         valid_all.sum(-1).float().mean())},
         min_margins={k: float(v) for k, v in margins.items()},
         note="margins: split |jump - 0.04| m, std |std - 10| deg, gate "
              "relative distance of a score to a gate")
    if not finite:
        fail("config 3 produced non-finite values")
    if launches != {"circle_fit": 0, "circle_fit_tail": T,
                    "circle_moments": 0}:
        fail(f"path A launched {launches}, want circle_fit_tail {T}")
    tol = CONFIG3_TOL
    if not fixture["n_detections_equal_early"]:
        fail(f"fixture worlds: detections per tick differ from the JAX run "
             f"within the first {early} ticks")
    if min(fixture["n_detections_equal_share"]) < tol["n_detections_share"] \
            or fixture["n_detections_max_diff"] > tol["n_detections_diff"]:
        fail(f"fixture worlds: detections per tick against the JAX run: "
             f"{fixture['n_detections_equal_share']}, max difference "
             f"{fixture['n_detections_max_diff']}")
    if not fixture["deterministic_n_seen_equal"]:
        fail("the deterministic world's n_seen differs from the JAX run")
    if (n_seen[:, -1] - g_seen[:, -1]).abs().max() > tol["n_seen_final"]:
        fail(f"fixture worlds: final n_seen {fixture['n_seen_final']} "
             f"against {fixture['golden_n_seen_final']}")
    for f in ("true_pose", "odom_pose"):
        if not pose_err_early[f] <= tol["sim_early"]:
            fail(f"fixture worlds: {f} off by {pose_err_early[f]} within "
                 f"the first {early} ticks")
        if not pose_err[f] <= tol[f]:
            fail(f"fixture worlds: {f} off by {pose_err[f]} > {tol[f]}")
    if ate_err is not None:
        if not ate_err[det_world] <= tol["deterministic_ate"]:
            fail(f"deterministic world's ATE {ate_fix[det_world]} against "
                 f"the JAX f32 value {golden['ate'][det_world]}")
        if not max(ate_err) <= tol["ate"]:
            fail(f"fixture worlds' ATE off by {ate_err}")
    return scans, zs_all, valid_all, launches["circle_fit_tail"]


def phase_perception_buffered(dev, scn, scans, zs_all, valid_all):
    """Path B: the buffered perception entry, through kernel 4, on every
    tick's scans of path A."""
    params = scn.world_params(device=dev)
    T = scans.shape[0]
    kw = dict(max_clusters=C3, max_points=P3)
    lo, hi = params.scan_min, params.scan_max
    count = lambda *s: torch.zeros(s, dtype=torch.int64, device=dev)
    worst = {"vs_path_a": torch.zeros((), device=dev),
             "vs_plain": torch.zeros((), device=dev)}
    # detections off by more than 1e-4, PERCEPTION_POS_TOL and 1e-2
    steps = torch.tensor([1e-4, PERCEPTION_POS_TOL, 1e-2], device=dev)
    over = {k: count(3) for k in worst}
    n_det = count()
    mismatch = {"vs_path_a_valid": count(), "vs_plain_valid": count()}

    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf = [detect_landmarks(scans[t], lo, hi, segmented=False, **kw)
           for t in range(T)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fit_launches()

    # the tensor-form fit route on every 50th tick's clusters, behind the
    # moment kernel, held to the whole-fit kernel's fits (phase 12's rule)
    picked = range(0, T, 50)
    clusters = [clustering.cluster_scan(scans[t], lo, hi, **kw)
                for t in picked]
    reset_counters()
    torch.cuda.synchronize()
    tensor_form = [circle_fit.fit_circles(c, componentized=False)
                   for c in clusters]
    torch.cuda.synchronize()
    launches_tf = fit_launches()
    tf = {"ticks": len(clusters), "valid_mismatches": 0, "n_valid": 0,
          "n_over_1e-4": 0, "max_abs_err": 0.0}
    for c, f in zip(clusters, tensor_form):
        k = circle_fit.fit_circles(c)
        tf["valid_mismatches"] += int((k.valid != f.valid).sum())
        both = k.valid & f.valid
        d = torch.where(both, torch.maximum(
            (k.center - f.center).abs().amax(-1), (k.radius - f.radius).abs()),
            torch.zeros_like(k.radius))
        tf["n_valid"] += int(both.sum())
        tf["n_over_1e-4"] += int((d > FIT_ATOL).sum())
        tf["max_abs_err"] = max(tf["max_abs_err"], float(d.max()))
    del clusters, tensor_form

    for t in range(T):
        plain = detect_landmarks(scans[t], lo, hi, segmented=False,
                                 use_kernel=False, **kw)
        b = buf[t]
        # path A kept its detections in polar form: back to positions
        r, th = zs_all[t][..., 0], zs_all[t][..., 1]
        seg_pos = torch.stack([r * torch.cos(th), r * torch.sin(th)], -1)
        mismatch["vs_path_a_valid"] += (b.valid != valid_all[t]).sum()
        mismatch["vs_plain_valid"] += (b.valid != plain.valid).sum()
        n_det += b.valid.sum()
        for name, pos in (("vs_path_a", seg_pos),
                          ("vs_plain", plain.positions)):
            d = torch.where(b.valid, (b.positions - pos).abs().amax(-1),
                            torch.zeros_like(r))
            worst[name] = torch.maximum(worst[name], d.max())
            over[name] += (d[..., None] > steps).sum((0, 1))
    torch.cuda.synchronize()
    bad = {k: int(v) for k, v in mismatch.items()}
    n = int(n_det)
    pos = {k: {"max_abs_err": float(worst[k]),
               "n_over_1e-4_tol_1e-2": over[k].tolist()} for k in worst}
    emit(phase="perception_buffered", B=B3, T=T, C=B3 * C3, P=P3,
         seconds=seconds, ms_per_tick=seconds * 1e3 / T,
         launches=launches, detections=n,
         mismatches=bad, positions=pos, pos_tol=PERCEPTION_POS_TOL,
         share_over_pos_tol={k: v["n_over_1e-4_tol_1e-2"][1] / max(n, 1)
                             for k, v in pos.items()},
         switch_share=FIT_SWITCH_SHARE, tensor_form_fit=dict(
             tf, launches=launches_tf, fit_atol=FIT_ATOL))
    if launches != {"circle_fit": T, "circle_fit_tail": 0,
                    "circle_moments": 0}:
        fail(f"path B launched {launches}, want circle_fit {T}")
    if any(bad.values()):
        fail(f"path B's detections differ: {bad}")
    for k, v in pos.items():
        if v["n_over_1e-4_tol_1e-2"][1] > FIT_SWITCH_SHARE * n:
            fail(f"path B positions {k}: {v} of {n} detections")
    if launches_tf["circle_moments"] != tf["ticks"]:
        fail(f"the tensor-form fit launched {launches_tf}, want "
             f"circle_moments {tf['ticks']}")
    if tf["valid_mismatches"] or tf["n_over_1e-4"] > \
            FIT_SWITCH_SHARE * tf["n_valid"]:
        fail(f"the tensor-form fit differs from the whole-fit kernel: {tf}")
    return launches["circle_fit"], launches_tf["circle_moments"]


def profiled_device_ms(fn, kernel: str, calls: int):
    """Device time of one launch of the kernel whose name holds
    ``kernel``, from ``torch.profiler`` over ``calls`` calls of ``fn``;
    None where the profiler reports no device time (a diagnostic beside
    the CUDA-event time, which for a kernel this short measures the
    wrapper's pace on the host)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(4):      # a profile now and then comes back empty
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total",
                        getattr(ev, "cuda_time_total", 0))
            if kernel in ev.key and ev.count and t:
                total += t
                count += ev.count
        if count:
            return total / count / 1e3
    return None


def profile_serving_ticks(eng, wl, t0, ticks):
    """Device time of ``ticks`` known-association serving ticks by
    ``torch.profiler`` (device activity only): kernels and busy ms a tick,
    and the split between the scan, the grid pass and the rest."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(t0, t0 + ticks):
            zs, ids, tw = bigmap.measurements(wl, t)
            eng.tick(tw, zs, ids=ids)
        torch.cuda.synchronize()
    rows = [(ev.key, ev.count, getattr(ev, "device_time_total",
                                       getattr(ev, "cuda_time_total", 0)))
            for ev in prof.key_averages()]
    busy = sum(r[2] for r in rows) / 1e3 / ticks
    if not busy:
        return None
    part = lambda key: sum(r[2] for r in rows if key in r[0]) / 1e3 / ticks
    scan, grid = part("seq_scan"), part("grid_update")
    top = sorted(((r[0][:60], r[2] / 1e3 / ticks) for r in rows
                  if "seq_scan" not in r[0] and "grid_update" not in r[0]),
                 key=lambda kv: -kv[1])[:3]
    return {"ticks": ticks, "kernels": sum(r[1] for r in rows) / ticks,
            "busy_ms": busy, "seq_scan_ms": scan, "grid_update_ms": grid,
            "rest_ms": busy - scan - grid, "rest_top_ms": dict(top)}


def profile_config3(dev, scn, ticks, ms_per_tick):
    """Device kernels a tick and the device's idle share over ``ticks``
    ticks of config 3, from ``torch.profiler`` (device activity only):
    idle = 1 - device busy time a tick / the unprofiled ``ms_per_tick``."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        driver.run_scenario_batch_lanes(scn, gen, B3, steps=ticks, device=dev)
        torch.cuda.synchronize()
    rows = [(ev.key, ev.count, getattr(ev, "device_time_total",
                                       getattr(ev, "cuda_time_total", 0)))
            for ev in prof.key_averages()]
    busy_ms = sum(r[2] for r in rows) / 1e3 / ticks
    if not busy_ms:
        return None
    by_name = {}
    for key, _, total in rows:
        # ATen's kernels are templates: keep the kernel and its functor
        name = key.replace("void at::native::", "").replace(
            "at::native::", "")[:80]
        by_name[name] = by_name.get(name, 0.0) + total / ticks
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"ticks": ticks,
            "device_kernels_per_tick": sum(r[1] for r in rows) / ticks,
            "device_busy_ms_per_tick": busy_ms,
            "device_idle_share": 1.0 - busy_ms / ms_per_tick,
            "top_us_per_tick": dict(top)}


def library_ms(grid_ops, cov_ops):
    """The one PyTorch call that computes what kernel 1 computes on a tick
    without inits (``torch.baddbmm`` on the four planes) and what kernel
    3's covariance pass computes (``torch.addmm``); timed as yardsticks,
    used nowhere in the port."""
    grid, a, b = grid_ops[0], grid_ops[1], grid_ops[2]
    g4 = grid.reshape(4, N, N)
    a4 = a[:, None].expand(2, 2, N, 2 * M).reshape(4, N, 2 * M)
    b4 = b[None].expand(2, 2, 2 * M, N).reshape(4, 2 * M, N)
    cov, sht, psi = cov_ops[0], cov_ops[1], cov_ops[2]
    K = sht @ torch.linalg.inv(psi)
    shtT = sht.T.contiguous()
    return {
        "grid_update": cuda_ms(lambda: torch.baddbmm(g4, a4, b4, alpha=-1.0),
                               50),
        "cov_update": cuda_ms(lambda: torch.addmm(cov, K, shtT, alpha=-1.0),
                              50)}


def serving_work(n):
    """(bytes, f32 operations) of the serving tick's kernels at map size
    ``n``: each input read once, each output written once."""
    work = {
        # grid in and out; A, B, rowK, colK, the two index rows
        "grid_update": (4 * (2 * 4 * n * n + 2 * 2 * n * 2 * M
                             + 2 * 4 * M * n + 2 * n),
                        2 * 4 * n * n * 2 * M),
        # strips in and out (12 n floats + seen), the measured landmarks'
        # grid columns (M x 4 n), Kb/HSb/CRb out; the grid itself is not
        # read beyond those columns
        "seq_scan": (4 * (2 * 12 * n + 4 * M * n + 3 * 4 * M * n) + 2 * n,
                     M * n * 100)}
    work["seq_scan_unknown"] = (work["seq_scan"][0],
                                work["seq_scan"][1] + M * n * 100)
    return work


def bound_of(nbytes, flops):
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return {"bound_ms": max(tb, tf) * 1e3,
            "bound_by": "bytes" if tb >= tf else "operations",
            "bytes": nbytes, "operations": flops}


def kernel_bounds(cm_counts):
    """The least time the card could take for each kernel's work at this
    run's shapes: bytes (each input read once, each output written once)
    over the memory rate against f32 operations over the f32 rate."""
    D = D_PAD
    cnt = torch.clamp(cm_counts.reshape(-1), 0, P3)
    C = cnt.numel()
    work = {
        **serving_work(N),
        # cov in and out; SHt, mean in and out
        "cov_update": (4 * (2 * D * D + 2 * D + 2 * D), 4 * D * D),
        # the rows below each count, the counts, 19 floats a cluster out
        "circle_moments": (8 * int(cnt.sum()) + 4 * C + 76 * C,
                           30 * int(cnt.sum())),
        # the same in, and valid; the moments and the fit out (13 bytes)
        "circle_fit": (8 * int(cnt.sum()) + 5 * C + 76 * C + 13 * C,
                       30 * int(cnt.sum()) + TAIL_FLOPS * C),
        # 10 moments, cx, cy, zbar, count, valid in; the fit out
        "circle_fit_tail": ((13 * 4 + 4 + 1) * C + 13 * C, TAIL_FLOPS * C),
    }
    return {k: bound_of(*w) for k, w in work.items()}


def fit_chain_floor(dev, m16, cent, zbar, ok):
    """The latency floor of a fit, a measurement: one dependent read of
    device memory (the scan's probe, one thread block) + the tail's
    dependent chain (``circle_fit.chain_probe``: one warp, lane l fitting
    the l-th well-posed cluster of this run, each fit waiting for the
    last's radius). CUDA events over 20 against 40 fits (2000 against
    4000 reads)."""
    idx = torch.nonzero(ok.reshape(-1))[:32, 0]
    if idx.numel() < 32:
        fail("fewer than 32 fitted clusters for the chain probe")
    staged = torch.cat([m16.reshape(-1, 16)[idx], cent.reshape(-1, 2)[idx],
                        zbar.reshape(-1, 1)[idx]], -1).contiguous()
    one = cuda_ms(lambda: cfk.chain_probe(staged, 20), 3)
    two = cuda_ms(lambda: cfk.chain_probe(staged, 40), 3)
    fit_ns = (two - one) / 20 * 1e6
    one = cuda_ms(lambda: sq.chain_probe("dependent_read", 1, 32, 2000, dev),
                  3)
    two = cuda_ms(lambda: sq.chain_probe("dependent_read", 1, 32, 4000, dev),
                  3)
    read_ns = (two - one) / 2000 * 1e6
    return {"tail_chain_ns": fit_ns, "dependent_read_ns": read_ns,
            "floor_ms": (fit_ns + read_ns) / 1e6}


def profile_perception(scan, lo, hi, calls=4):
    """Device kernels and busy ms a call of path A's perception stage
    (``detect_landmarks``, segmented) on config 3's scans, from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    detect_landmarks(scan, lo, hi, max_clusters=C3, max_points=P3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            detect_landmarks(scan, lo, hi, max_clusters=C3, max_points=P3)
        torch.cuda.synchronize()
    rows = [(ev.count, getattr(ev, "device_time_total",
                               getattr(ev, "cuda_time_total", 0)))
            for ev in prof.key_averages()]
    busy = sum(r[1] for r in rows) / 1e3 / calls
    return {"calls": calls, "device_kernels_per_call":
            sum(r[0] for r in rows) / calls,
            "device_busy_ms_per_call": busy} if busy else None


def phase_config3_timing(dev, scn, cm_ops, grid_ops, cov_ops):
    """ms per tick of config 3 whole and by stage, kernel 4 per call, and
    the library yardsticks of kernels 1 and 3."""
    params = scn.world_params(device=dev)
    wcfg, ecfg = scn.world_config(), scn.ekf_config()
    Q, R = scn.noise_matrices(device=dev)
    dparams = diff_drive.DiffDriveParams(params.wheel_base, params.wheel_rad)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    block = 10
    cmds = driver.command_twist(scn, block, device=dev)
    st = {"sense": driver.init_sense(params, torch.float32, (B3,)),
          "filt": ekf_batch.init(ecfg, B3, device=dev)}
    stage = {k: [] for k in ("noise", "sim", "perception", "filter")}

    def lap(key, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        stage[key][-1] += t1 - t0
        return t1

    def staged_block():
        """``block`` ticks with a synchronize after each stage (the body
        of ``driver.sense_tick`` and the filter call, stage by stage)."""
        for v in stage.values():
            v.append(0.0)
        torch.cuda.synchronize()
        start = t = time.perf_counter()
        for i in range(block):
            noise = driver.draw_noise(scn, gen, (B3,))
            t = lap("noise", t)
            world = st["sense"].world
            for k in range(scn.sim_substeps):
                world = tube_world.step_dynamics(wcfg, params, world, cmds[i],
                                                 scn.dt, noise.substep(k))
            obs = tube_world.observe(wcfg, params, world, noise.obs)
            twist = diff_drive.wheels_to_twist(
                dparams, obs.joint_states - st["sense"].odom.wheels)
            odom = diff_drive.step(dparams, st["sense"].odom,
                                   obs.joint_states)
            st["sense"] = driver.SenseState(world=world, odom=odom)
            t = lap("sim", t)
            det = detect_landmarks(obs.scan, params.scan_min, params.scan_max,
                                   max_clusters=C3, max_points=P3)
            zs = ekf_slam.cartesian2polar(det.positions[..., 0],
                                          det.positions[..., 1])
            t = lap("perception", t)
            st["filt"] = ekf_batch.step(ecfg, st["filt"], twist, zs,
                                        det.valid, Q, R)
            t = lap("filter", t)
        return (t - start) * 1e3 / block

    def whole_block():
        torch.cuda.synchronize()
        start = time.perf_counter()
        driver.run_scenario_batch_lanes(scn, gen, B3, steps=block, device=dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3 / block

    def buffered_block():
        scan = st["scan"]
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(block):
            detect_landmarks(scan, params.scan_min, params.scan_max,
                             max_clusters=C3, max_points=P3, segmented=False)
        torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3 / block

    st["scan"] = real_scans(dev, scn, ticks=5)
    rows = {"whole": whole_block, "staged": staged_block,
            "perception_buffered": buffered_block}
    times = {k: [] for k in rows}
    order = list(rows)
    for rnd in range(5):
        for k in (order if rnd % 2 == 0 else order[::-1]):
            times[k].append(rows[k]())
    # the first round warms allocators and libm tables: drop it
    per_tick = {k: statistics.median(v[1:]) for k, v in times.items()}
    spread = {k: [min(v[1:]), max(v[1:])] for k, v in times.items()}
    split = {k: statistics.median(v[1:]) * 1e3 / block
             for k, v in stage.items()}
    pts, cnt = cm_ops
    valid = cnt >= 3
    lo, hi = params.scan_min, params.scan_max
    tail_in = landmark_detection._segment_fit_inputs(st["scan"], lo, hi, C3,
                                                     P3)[:6]
    calls = {
        "circle_moments": (
            lambda: cmk.circle_moments_raw(pts, cnt, use_kernel=True),
            lambda: cmk.circle_moments_raw(pts, cnt, use_kernel=False),
            "circle_fit_kernel"),
        "circle_fit": (
            lambda: cfk.circle_fit_raw(pts, cnt, valid, use_kernel=True),
            lambda: cfk.circle_fit_raw(pts, cnt, valid, use_kernel=False),
            "circle_fit_kernel"),
        "circle_fit_tail": (
            lambda: cfk.fit_tail(*tail_in, use_kernel=True),
            lambda: cfk.fit_tail(*tail_in, use_kernel=False),
            "circle_fit_tail_kernel")}
    per_call = {name: {"ms": cuda_ms(fn, 200),
                       "plain_ms": cuda_ms(plain, 5 if name == "circle_moments"
                                           else 2, 3),
                       "device_ms": profiled_device_ms(fn, key, 50)}
                for name, (fn, plain, key) in calls.items()}
    bounds = kernel_bounds(cnt)
    fit = cfk.circle_fit_raw(pts, cnt, valid, use_kernel=True)
    floor = fit_chain_floor(dev, fit[3], fit[4], fit[5], fit[2])
    for name in calls:
        d = per_call[name]["device_ms"]
        per_call[name].update(
            bound_ms=bounds[name]["bound_ms"],
            bound_by=bounds[name]["bound_by"],
            share_of_bound=bounds[name]["bound_ms"] / d if d else None)
        if name != "circle_moments":
            per_call[name]["share_of_latency_floor"] = (
                floor["floor_ms"] / d if d else None)
    lib = library_ms(grid_ops, cov_ops)
    emit(phase="config3_timing", scenario=scn.name, B=B3,
         profile=profile_config3(dev, scn, 4, per_tick["whole"]),
         perception_profile=profile_perception(st["scan"], lo, hi),
         ms_per_tick=per_tick, ms_per_tick_min_max=spread,
         world_ticks_per_s=B3 * 1e3 / per_tick["whole"],
         staged_split_ms=split, ms_per_call=per_call, fit_latency_floor=floor,
         library_ms=lib,
         note="ms per tick: host clock around synchronized blocks of 10 "
              "ticks taken in turns, median of 4 (a first round dropped); "
              "'staged' synchronizes after every stage and 'whole' is "
              "run_scenario_batch_lanes with its set-up; ms per call: "
              "CUDA events over wrapper calls, medians of 5, the clusters "
              "warm in L2 as the caller leaves them; device_ms: the "
              "kernel alone by torch.profiler; plain_ms: the plain "
              "version on the card; library_ms: torch.baddbmm on the four "
              "grid planes, torch.addmm on the covariance")
    return per_call, lib


def chain_floor(dev, plan):
    """The latency floor of the scan's serial chain, a measurement:
    barriers x the barrier + one dependent read of device memory + an
    update's scalar chain. Each term is timed apart from the kernel by the
    scan's probe kernel under the plan's cluster and threads (CUDA events
    over 2000 against 4000 rounds): the cluster barrier alone, a pointer
    chase through 64 MB, and the replicated scalar arithmetic of an update
    (the kernel's own two functions, in every thread, with no lane work,
    no barrier and no memory traffic)."""
    c, th = plan["cluster"], plan["threads"]
    ns = {}
    for mode in sq.PROBE_MODES:
        one = cuda_ms(lambda: sq.chain_probe(mode, c, th, 2000, dev), 3)
        two = cuda_ms(lambda: sq.chain_probe(mode, c, th, 4000, dev), 3)
        ns[mode] = (two - one) / 2000 * 1e6
    out = {f"{mode}_ns": t for mode, t in ns.items()}
    for name, barriers in (("seq_scan", 2), ("seq_scan_unknown", 3)):
        per_meas = (barriers * ns["barrier"] + ns["dependent_read"]
                    + ns["scalar_chain"])
        out[name] = {"barriers_a_measurement": barriers,
                     "floor_ms": M * per_meas / 1e6}
    return out


def phase_split(known_args, unk_args):
    """Where an update measurement's cycles go, layer by layer, from the
    scan's clocked instance (``seq_scan.phase_clock``): a split of the
    kernel's own time, no term of the floor."""
    out = {}
    for name, args, kw in (("seq_scan", known_args, {}),
                           ("seq_scan_unknown", unk_args, {"known": False})):
        res, cycles = sq.phase_clock(*args, **kw)
        torch.cuda.synchronize()
        upd = res[11] == 1
        if not bool(upd.any()):
            fail(f"the {name} tick of the phase clock has no update")
        spans = cycles[upd].mean(0)
        out[name] = {"update_measurements": int(upd.sum()),
                     "cycles_of_an_update": dict(zip(sq.PHASES,
                                                     spans.tolist())),
                     "measurement_cycles": float(spans.sum())}
    return out


def transposed_planes(args):
    """The scan's arguments with the frozen planes transposed (comp (p, q)
    <- plane (q, p) transposed): handed these, the plain version reads as
    its exact column g the very words the kernel reads as row g (PARITY
    D13), and the planes' f32 asymmetry drops out of the comparison."""
    n = args[7].shape[-1]
    planes_t = (args[7].reshape(2, 2, n, n).permute(1, 0, 3, 2).contiguous()
                .reshape(4, n, n))
    return args[:7] + (planes_t,) + args[8:]


def in_f64(args):
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def f64_distance(outs, exact):
    """max |out - exact| of each continuous output of the scan (diag4 over
    the seen slots: the unseen ones hold the INT_MAX prior)."""
    seen = exact[5]
    return {name: float((o[..., seen].double() - e[..., seen]).abs().max()
                        if name == "diag4" else (o.double() - e).abs().max())
            for name, o, e in zip(SCAN_NAMES, outs, exact)
            if name not in SCAN_DISCRETE}


def scan_checks(known_args, unk_args, same_input_tol, plan=None, small=None):
    """Both branches of the scan against the plain version: on the same
    words (the transposed planes) within SCAN_TOL of scale, on the same
    inputs within ``same_input_tol``, discrete outputs equal; beside them
    the distance of kernel, plain and plain-on-transposed-planes from the
    f64 plain version on the same inputs. With ``plan``, also every output
    of the chosen cluster against the smallest cluster that holds the map,
    bit for bit."""
    checks = {}
    for name, args, kw in (("seq_scan", known_args, {}),
                           ("seq_scan_unknown", unk_args, {"known": False})):
        got = sq.deferred_seq_scan(*args, use_kernel=True, **kw)
        plain = sq.reference_seq_scan(*args, **kw)
        plain_t = sq.reference_seq_scan(*transposed_planes(args), **kw)
        exact = sq.reference_seq_scan(*in_f64(args), **kw)
        errs_t, bad_t = scan_compare(got, plain_t, SCAN_TOL)
        errs, bad = scan_compare(got, plain, same_input_tol)
        scale = {k: float((w[..., plain[5]] if k == "diag4" else w).abs()
                          .max()) for k, w in zip(SCAN_NAMES, plain)
                 if k in errs}
        planes = args[7].reshape(2, 2, *args[7].shape[1:])
        checks[name] = {
            "kinds": got[11].tolist(),
            "max_abs_err_transposed_planes": errs_t,
            "disagree_transposed_planes": bad_t,
            "max_abs_err": errs, "disagree": bad,
            "same_input_tol": same_input_tol, "scale": scale,
            "grid_asymmetry": float(
                (planes - planes.permute(1, 0, 3, 2)).abs().max()),
            "max_abs_err_to_f64": {
                who: f64_distance(out, exact)
                for who, out in (("kernel", got), ("plain", plain),
                                 ("plain_transposed_planes", plain_t))}}
        del plain, plain_t, exact, planes
        if plan is None:
            continue
        other = sq.deferred_seq_scan(*args, use_kernel=True, cluster=small,
                                     **kw)
        torch.cuda.synchronize()
        checks[name].update(
            bit_equal_cluster=[small, plan["cluster"]],
            bit_equal=all(torch.equal(a, b) for a, b in zip(got, other)))
    return checks


def phase_kernel_scaling(dev):
    """The serving tick's two kernels over the map sizes (see the module
    docstring, phase 16). The scan is held to its plain version twice: on
    the state of phase 4 at this N (300 ticks over the first 1792 slots,
    the rest unseen; a tick with updates, inits, a repeated slot, an
    out-of-range id and an invalid slot; unknown: matches, skips and new
    landmarks); and on the full map the timed ticks run on. Each time on
    the same words and on the same inputs (``scan_checks``; the bounds are
    stated beside ``SCAN_TOL_ROW_FOR_COLUMN``)."""
    rows = {}
    for n in SCALING_SIZES:
        cfg = EKFConfig(num_landmarks=n)
        Q, R = bigmap.noise(device=dev)
        fill = -(-n // M) + 8
        wl = bigmap.make_workload(n, fill + 128, M, device=dev)
        engines = {"known": serving.ServingEngine(
            cfg, M, Q, R, device=dev, robot_pose=[0.0, 0.0, 0.0]),
            "unknown": serving.ServingEngine(cfg, M, Q, R, device=dev,
                                             known=False)}
        eng = engines["known"]
        tol = {"state_of_phase_4": SCAN_TOL if n <= 8192
               else SCAN_TOL_ROW_FOR_COLUMN,
               "full_map": SCAN_TOL_ROW_FOR_COLUMN}
        plan = sq.launch_plan(n, M)
        small = next(c for c in (1, 2, 4, 8, 16)
                     if c * sq.MAX_THREADS * sq.LANE_CHOICES[-1] >= n)
        valid = torch.ones(M, dtype=torch.bool, device=dev)
        partial = scan_inputs(dev, cfg, n, seen=SCALING_SEEN)
        match, skip = pick_slots(partial)
        if len(match) < 2 or not skip:
            fail(f"no clean match/skip slots at N={n}: {match}, {skip}")
        checks = scan_checks(partial, unknown_tick(partial, [
            ("match", match[0]), ("skip", skip[0]), ("far", 20),
            ("invalid", 3), ("match", match[1]), ("far", 40),
            ("skip", skip[-1]), ("match", match[0])]),
            tol["state_of_phase_4"], plan, small)
        del partial
        for t in range(fill):
            zs, ids, tw = bigmap.measurements(wl, t)
            eng.tick(tw, zs, ids=ids)
        clock, per_tick = fill, {}
        for key, e in engines.items():
            e.state = eng.state          # the full map; the grid is shared
            blocks = []
            for _ in range(3):
                torch.cuda.synchronize()
                start = time.perf_counter()
                for _ in range(20):
                    zs, ids, tw = bigmap.measurements(wl, clock)
                    e.tick(tw, zs, ids=ids if key == "known" else None)
                    clock += 1
                torch.cuda.synchronize()
                blocks.append((time.perf_counter() - start) * 1e3 / 20)
            per_tick[key] = statistics.median(blocks)
            eng.state = e.state
        tick_profile = profile_serving_ticks(eng, wl, clock, 5)
        clock += 5
        st = eng.state
        n_seen = int(st.n_seen[0])
        zs, ids, _ = bigmap.measurements(wl, clock)
        known_args = state_scan_args(st, n) + (zs, valid, ids, R)
        match, skip = pick_slots(known_args)
        if len(match) < 2 or not skip:
            fail(f"no clean match/skip slots on the full map at N={n}: "
                 f"{match}, {skip}")
        unk_args = unknown_tick(known_args, [
            ("match", match[0]), ("skip", skip[0]), ("match", match[1]),
            ("invalid", 3), ("match", match[-1]), ("skip", skip[-1]),
            ("match", match[0]), ("match", match[1])])

        full_map = scan_checks(known_args, unk_args, tol["full_map"])

        calls = {
            "seq_scan": lambda: sq.deferred_seq_scan(*known_args,
                                                     use_kernel=True),
            "seq_scan_unknown": lambda: sq.deferred_seq_scan(
                *unk_args, known=False, use_kernel=True)}
        res = calls["seq_scan"]()
        tick_ops = blocked_ekf.grid_operands(*res[7:12])
        calls["grid_update"] = lambda: gu.fused_grid_update(
            st.cov_mm[0], *tick_ops, use_kernel=True)
        work = serving_work(n)
        timing = {}
        for name, call in calls.items():
            key = "grid_update" if name == "grid_update" else "seq_scan"
            timing[name] = {"ms": cuda_ms(call, 30, 3),
                            "device_ms": profiled_device_ms(call, key, 10),
                            **bound_of(*work[name])}
            d = timing[name]["device_ms"]
            timing[name]["share_of_bound"] = (timing[name]["bound_ms"] / d
                                              if d else None)
        floor = chain_floor(dev, plan)
        split = phase_split(known_args, unk_args)
        for name in ("seq_scan", "seq_scan_unknown"):
            d = timing[name]["device_ms"]
            floor[name]["share_of_floor"] = (floor[name]["floor_ms"] / d
                                             if d else None)
        del engines, eng, e, st, known_args, unk_args, res, tick_ops, calls
        del call
        torch.cuda.empty_cache()
        rnd = grid_operands(np.random.default_rng(n), dev, n)
        grid_err, replay_err = grid_errors(rnd)
        del rnd
        torch.cuda.empty_cache()
        rows[str(n)] = {
            "n_seen": n_seen, "ms_per_tick": per_tick,
            "device_per_known_tick": tick_profile, "seq_scan_plan": plan,
            "grid_update_plan": gu.launch_plan(n, n, M),
            "checks_after_ticks": T - 20, "checks_seen_slots": SCALING_SEEN,
            "checks": checks, "checks_full_map": full_map,
            "grid_update_max_abs_err": grid_err,
            "grid_update_replay_max_abs_err": replay_err,
            "kernels": timing, "latency_floor": floor,
            "phase_clock": split}
        emit(phase="kernel_scaling", N=n, M=M, **rows[str(n)],
             scale_tol=SCAN_TOL, same_input_tol=tol, grid_atol=GRID_ATOL,
             note="ms per tick: host clock around synchronized blocks of 20 "
                  "update-only ticks on the full map, median of 3; ms: CUDA "
                  "events over wrapper calls; device_ms: the kernel alone by "
                  "torch.profiler; the grid pass is timed on the tick's own "
                  "operands (no init) and checked on random ones (most rows "
                  "and columns replayed)")
        for name, c in checks.items():
            held = c["disagree"] + c["disagree_transposed_planes"]
            if held or not c["bit_equal"]:
                fail(f"{name} at N={n}: disagrees on {held}, bit-equal "
                     f"across clusters {c['bit_equal']}")
            if not {1, 2} <= set(c["kinds"]):
                fail(f"{name} at N={n}: the tick lacks a branch "
                     f"{c['kinds']}")
        for name, c in full_map.items():
            held = c["disagree"] + c["disagree_transposed_planes"]
            if held or 1 not in c["kinds"]:
                fail(f"{name} on the full map at N={n}: disagrees on "
                     f"{held}, kinds {c['kinds']}")
        if not grid_err <= GRID_ATOL or replay_err != 0.0:
            fail(f"grid_update at N={n}: {grid_err}, replay {replay_err}")
    return rows


# ---------------------------------------------------------------------------
# Phase 17: configs 1 and 2 (the main path of the port's bench entry)
# ---------------------------------------------------------------------------

def cpp_deterministic_ate(scenario):
    """ATE of the C++ baseline's ``--deterministic`` run of ``scenario``
    (the bench entry's ``measure_cpp``, which builds it with ``make`` where
    absent); None where there is neither the binary nor ``make``."""
    if not bench.BASELINE_BIN.exists() and shutil.which("make") is None:
        return None
    return bench.measure_cpp(scenario, runs=1)["ate"]


def pose_errors(outs, want, ticks):
    """(worlds, ticks) largest |got - want| over the poses in ``want``,
    heading wrapped; ``want`` maps a pose field to a (worlds, ticks, 3)
    f64 tensor on the card, taken at the run's ``ticks``."""
    errs = []
    for f, w in want.items():
        d = getattr(outs, f)[:w.shape[0], ticks].double() - w
        d[..., 0] = se2.normalize_angle(d[..., 0])
        errs.append(d.abs().amax(-1))
    return torch.stack(errs).amax(0)


def timed_run(run, *args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = run(*args, **kw)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def all_finite(outs):
    return all(bool(torch.isfinite(x).all()) for x in outs
               if x.dtype.is_floating_point)


def phase_config1(dev):
    """Config 1 (``loop5_known``) at B1 worlds on the lanes engine against
    the JAX golden fixture and the C++ deterministic run."""
    golden = json.loads(GOLDEN_LOOP5.read_text())
    scn = get_scenario("loop5_known")
    T = golden["T"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    reset_counters()
    outs, seconds = timed_run(driver.run_scenario_batch_lanes, scn, gen, B1,
                              steps=T, device=dev)
    launches = kernel_launches()
    ev = golden["pose_every"]
    at = torch.arange(ev - 1, T, ev, device=dev)
    # noise-free: every world of the run is held to the fixture's world 0
    want = {f: torch.tensor(golden[f][0], dtype=torch.float64,
                            device=dev)[None].expand(B1, -1, -1)
            for f in ("true_pose", "odom_pose", "slam_pose")}
    pose_err = float(pose_errors(outs, want, at).max())
    g_seen = torch.tensor(golden["n_seen"][0], dtype=torch.int32, device=dev)
    n_seen_equal = bool((outs.n_seen == g_seen).all())
    ate = bench.world_ate(outs)
    g_ate = golden["ate"][0]
    cpp_ate = cpp_deterministic_ate("loop5_known")
    ate_err = float((ate - g_ate).abs().max())
    cpp_err = None if cpp_ate is None else float((ate - cpp_ate).abs().max())
    emit(phase="configs12_config1", scenario=scn.name, engine="lanes", B=B1,
         T=T, seconds=seconds, ms_per_tick=seconds * 1e3 / T,
         world_ticks_per_s=B1 * T / seconds, finite=all_finite(outs),
         launches=launches, n_seen_equal_every_tick=n_seen_equal,
         pose_max_abs_err=pose_err, pose_tol=CONFIGS12_POSE_TOL,
         ate={"min": float(ate.min()), "median": float(ate.median()),
              "max": float(ate.max()), "spread": float(ate.max() - ate.min())},
         golden_ate=g_ate, ate_max_abs_err_vs_golden=ate_err,
         cpp_deterministic_ate=cpp_ate, ate_max_abs_err_vs_cpp=cpp_err,
         ate_tol=CONFIG1_ATE_TOL,
         note="config 1 has no noise (every draw is scaled by zero), so "
              "every world is the fixture's world; its draws come from a "
              "seeded generator")
    if not all_finite(outs):
        fail("config 1 produced non-finite values")
    if any(launches.values()):
        fail(f"config 1 launched {launches}: its path has no kernel")
    if not n_seen_equal:
        fail("config 1: n_seen differs from the JAX run")
    if not pose_err <= CONFIGS12_POSE_TOL:
        fail(f"config 1: poses off the JAX run by {pose_err}")
    if not ate_err <= CONFIG1_ATE_TOL:
        fail(f"config 1: a world's ATE is off the JAX f32 ATE {g_ate} by "
             f"{ate_err}")
    if cpp_err is not None and not cpp_err <= CONFIG1_ATE_TOL:
        fail(f"config 1: a world's ATE is off the C++ ATE {cpp_ate} by "
             f"{cpp_err}")
    return scn, golden


def engines_agree(dense, lanes, tol):
    """(n_seen equal at every tick, largest pose difference) of two runs
    of the same worlds on the same noise."""
    ticks = torch.arange(dense.n_seen.shape[1], device=dense.n_seen.device)
    want = {f: getattr(lanes, f).double()
            for f in ("true_pose", "odom_pose", "slam_pose")}
    err = float(pose_errors(dense, want, ticks).max())
    return bool(torch.equal(dense.n_seen, lanes.n_seen)), err, err <= tol


def phase_config1_vmapped(dev, scn, golden):
    """Config 1 through ``run_scenario_batch`` (the dense engine under
    ``torch.func.vmap``) against the lanes engine on the same noise."""
    T = golden["T"]
    noise = noise_sequence(scn, dev, B1_VMAPPED, T, seed=22)
    reset_counters()
    dense, s_dense = timed_run(driver.run_scenario_batch, scn, noise,
                               B1_VMAPPED, steps=T, device=dev)
    launches = kernel_launches()
    lanes, s_lanes = timed_run(driver.run_scenario_batch_lanes, scn, noise,
                               B1_VMAPPED, steps=T, device=dev)
    del noise
    seen_eq, err, ok = engines_agree(dense, lanes, CONFIGS12_POSE_TOL)
    ate = bench.world_ate(dense)
    ate_err = float((ate - golden["ate"][0]).abs().max())
    emit(phase="configs12_config1_vmapped", scenario=scn.name, B=B1_VMAPPED,
         T=T, ms_per_tick={"vmapped": s_dense * 1e3 / T,
                           "lanes": s_lanes * 1e3 / T},
         world_ticks_per_s={"vmapped": B1_VMAPPED * T / s_dense,
                            "lanes": B1_VMAPPED * T / s_lanes},
         finite=all_finite(dense), launches=launches,
         n_seen_equal_every_tick=seen_eq, pose_max_abs_diff=err,
         pose_tol=CONFIGS12_POSE_TOL, ate_max_abs_err_vs_golden=ate_err)
    if not all_finite(dense):
        fail("run_scenario_batch produced non-finite values")
    if any(launches.values()):
        fail(f"run_scenario_batch launched {launches}: no kernel expected")
    if not (seen_eq and ok):
        fail(f"run_scenario_batch against the lanes engine: n_seen equal "
             f"{seen_eq}, poses off by {err}")
    if not ate_err <= CONFIG1_ATE_TOL:
        fail(f"run_scenario_batch: ATE off the JAX f32 ATE by {ate_err}")


def course12_fixture():
    golden = json.loads(GOLDEN_COURSE12.read_text())
    f32 = lambda key, shape: np.frombuffer(
        base64.b64decode(golden[key]), "<f4").reshape(shape)
    normals = {k: f32(f"{k}_normals_f32_b64", golden["normals_shape"])
               for k in ("twist", "slip")}
    poses = {f: f32(f"{f}_f32_b64", golden["pose_shape"])
             for f in ("true_pose", "odom_pose", "slam_pose")}
    return golden, normals, poses


def phase_config2(dev):
    """Config 2 (``course12_noisy``) at B2 worlds on the lanes engine: the
    first 8 worlds take the fixture's draws (7 noisy, 1 deterministic),
    the rest a seeded generator's."""
    golden, normals, poses = course12_fixture()
    scn = get_scenario("course12_noisy")
    T, nfix = golden["T"], golden["B"]
    noise = noise_sequence(scn, dev, B2, T, seed=23)
    for k in ("twist", "slip"):
        f = getattr(noise, k)
        f[:, :nfix - 1] = torch.from_numpy(normals[k].copy()).to(dev)
        f[:, nfix - 1] = 0.0
    trace, margins = [], {}
    reset_counters()
    outs, seconds = timed_run(driver.run_scenario_batch_lanes, scn, noise, B2,
                              steps=T, device=dev, margins=margins,
                              gate_trace=trace)
    launches = kernel_launches()
    trace = torch.stack(trace)                                  # (T, B2)
    want = {f: torch.from_numpy(p.copy()).to(dev, torch.float64)
            for f, p in poses.items()}
    ticks = torch.arange(T, device=dev)
    err = pose_errors(outs, want, ticks).cpu()                  # (nfix, T)
    g_seen = torch.tensor(golden["n_seen"], dtype=torch.int32)
    seen_eq = (outs.n_seen[:nfix].cpu() == g_seen).all(-1).tolist()
    worlds = []
    for w in range(nfix):
        over = torch.nonzero(err[w] > CONFIGS12_POSE_TOL)
        part = int(over[0, 0]) if over.numel() else None
        row = {"world": w, "n_seen_equal_every_tick": seen_eq[w],
               "pose_max_abs_err_to_parting": float(
                   err[w, :part].max()) if part != 0 else None,
               "parting_tick": part}
        if part is not None:
            # each pose's error where the world parts, and the closest gate
            # decision of the ticks just before it (a tie reads near 0)
            at = ticks[part:part + 1]
            row["pose_err_at_parting"] = {
                f: float(pose_errors(outs, {f: p[:, at]}, at)[w, 0])
                for f, p in want.items()}
            lo = max(0, part - PARTING_WINDOW)
            win = trace[lo:part + 1, w]
            row["min_gate_margin_window"] = [lo, part]
            row["min_gate_margin"] = float(win.min())
            row["min_gate_margin_tick"] = lo + int(win.argmin())
        worlds.append(row)
    ate = bench.world_ate(outs)
    det = nfix - 1
    det_err = abs(float(ate[det]) - golden["ate"][det])
    cpp_ate = cpp_deterministic_ate("course12_noisy")
    det_cpp_err = None if cpp_ate is None else abs(float(ate[det]) - cpp_ate)
    emit(phase="configs12_config2", scenario=scn.name, engine="lanes", B=B2,
         T=T, seconds=seconds, ms_per_tick=seconds * 1e3 / T,
         world_ticks_per_s=B2 * T / seconds, finite=all_finite(outs),
         launches=launches, fixture_worlds=worlds,
         fixture_ate=ate[:nfix].tolist(), golden_ate=golden["ate"],
         deterministic_ate_abs_err=det_err,
         cpp_deterministic_ate=cpp_ate,
         deterministic_ate_abs_err_vs_cpp=det_cpp_err,
         pose_tol=CONFIGS12_POSE_TOL,
         early_ticks=CONFIG2_EARLY,
         all_worlds={"median_ate": float(ate.median()),
                     "diverged_fraction": float((ate > 1.0).double().mean()),
                     "median_nees": float(outs.nees.median()),
                     "median_n_seen_final": float(
                         outs.n_seen[:, -1].float().median())},
         min_gate_margin=float(margins["gate"]),
         note="parting: the first tick a pose of a fixture world is off "
              "the JAX run by more than pose_tol; the gate margin is the "
              "relative distance of a score to a gate, over the world's "
              "decisions of the ticks just before it")
    if not all_finite(outs):
        fail("config 2 produced non-finite values")
    if any(launches.values()):
        fail(f"config 2 launched {launches}: its path has no kernel")
    if not all(seen_eq):
        fail(f"config 2: n_seen differs from the JAX run in fixture worlds "
             f"{[w for w in range(nfix) if not seen_eq[w]]}")
    early = [r["world"] for r in worlds if r["parting_tick"] is not None
             and r["parting_tick"] < CONFIG2_EARLY]
    if early:
        fail(f"config 2: fixture worlds {early} part from the JAX run "
             f"before tick {CONFIG2_EARLY}")
    if not det_err <= CONFIG2_DET_ATE_TOL:
        fail(f"config 2: the deterministic world's ATE {float(ate[det])} "
             f"against the JAX f32 {golden['ate'][det]}")
    return scn, noise, outs


def phase_config2_vmapped(dev, scn, noise, lanes):
    """``run_scenario_batch`` on the first T2_VMAPPED ticks of config 2's
    first B2_VMAPPED worlds, against the lanes run of phase 17c."""
    T, B = T2_VMAPPED, B2_VMAPPED
    part = tube_world.TickNoise(*(f[:T, :B] for f in noise))
    dense, seconds = timed_run(driver.run_scenario_batch, scn, part, B,
                               steps=T, device=dev)
    ref = driver.TickOutput(*(f[:B, :T] for f in lanes))
    seen_eq, err, ok = engines_agree(dense, ref, CONFIGS12_POSE_TOL)
    emit(phase="configs12_config2_vmapped", scenario=scn.name, B=B, T=T,
         ms_per_tick=seconds * 1e3 / T, finite=all_finite(dense),
         n_seen_equal_every_tick=seen_eq, pose_max_abs_diff=err,
         pose_tol=CONFIGS12_POSE_TOL)
    if not (all_finite(dense) and seen_eq and ok):
        fail(f"config 2 through run_scenario_batch against the lanes run: "
             f"n_seen equal {seen_eq}, poses off by {err}")


def phase_course12_tuned(dev):
    """``course12_tuned`` (nearest-neighbour gating, wrapped innovations,
    multiplicative slip) at B2 worlds: no world may diverge."""
    scn = get_scenario("course12_tuned")
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    outs, seconds = timed_run(driver.run_scenario_batch_lanes, scn, gen, B2,
                              device=dev)
    ate = bench.world_ate(outs)
    diverged = int((ate > 1.0).sum())
    emit(phase="configs12_course12_tuned", B=B2, T=scn.steps,
         ms_per_tick=seconds * 1e3 / scn.steps, finite=all_finite(outs),
         median_ate=float(ate.median()),
         p99_ate=float(torch.quantile(ate, 0.99)), max_ate=float(ate.max()),
         diverged=diverged, median_nees=float(outs.nees.median()))
    if not all_finite(outs) or diverged:
        fail(f"course12_tuned: {diverged} of {B2} worlds diverged")


def profile_ticks(run, scn, dev, B, ticks=PROFILE_TICKS):
    """Unprofiled ms a tick over 3 x ``ticks`` ticks, then device kernels a
    tick, device busy ms a tick and the device's idle share over ``ticks``
    profiled ticks (``torch.profiler``, device activity only)."""
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    run(scn, gen, B, steps=2, device=dev)
    _, seconds = timed_run(run, scn, gen, B, steps=3 * ticks, device=dev)
    ms = seconds * 1e3 / (3 * ticks)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(scn, gen, B, steps=ticks, device=dev)
        torch.cuda.synchronize()
    rows = [(ev.count, getattr(ev, "device_time_total",
                               getattr(ev, "cuda_time_total", 0)))
            for ev in prof.key_averages()]
    busy = sum(r[1] for r in rows) / 1e3 / ticks
    return {"scenario": scn.name, "engine": run.__name__, "B": B,
            "ms_per_tick": ms,
            "device_kernels_per_tick": sum(r[0] for r in rows) / ticks,
            "device_busy_ms_per_tick": busy or None,
            "device_idle_share": 1.0 - busy / ms if busy else None}


def phase_sweep(dev, scn1, scn2):
    """Config 1's batch sweep on the lanes engine (SWEEP_TICKS ticks a
    point after 2 warm ticks), continued by 4x while throughput grows by
    more than SWEEP_GROWTH and the outputs of a full run would take less
    than half the free device memory; then the profiled ticks of both
    configs on both engines."""
    rows, B = [], SWEEP_BATCHES[0]
    free = torch.cuda.mem_get_info(dev)[0]
    while True:
        gen = torch.Generator(device=dev)
        gen.manual_seed(26)
        driver.run_scenario_batch_lanes(scn1, gen, B, steps=2, device=dev)
        _, seconds = timed_run(driver.run_scenario_batch_lanes, scn1, gen, B,
                               steps=SWEEP_TICKS, device=dev)
        rows.append({"B": B, "ms_per_tick": seconds * 1e3 / SWEEP_TICKS,
                     "world_ticks_per_s": B * SWEEP_TICKS / seconds})
        torch.cuda.empty_cache()
        growing = len(rows) < 2 or (rows[-1]["world_ticks_per_s"]
                                    > SWEEP_GROWTH
                                    * rows[-2]["world_ticks_per_s"])
        fits = 4 * B * scn1.steps * OUTPUT_BYTES_PER_WORLD_TICK < free / 2
        if not fits or (B >= SWEEP_BATCHES[-1] and not growing):
            break
        B *= 4
    # the card saturates at the smallest batch within SWEEP_GROWTH of the
    # sweep's best throughput (a host-bound point's ms a tick moves by
    # 10-40% between runs, so one 4x step is no reliable test)
    best = max(r["world_ticks_per_s"] for r in rows)
    for r in rows:
        r["share_of_best"] = r["world_ticks_per_s"] / best
    sat = min(r["B"] for r in rows
              if r["world_ticks_per_s"] * SWEEP_GROWTH >= best)
    profiles = [profile_ticks(run, scn, dev, B)
                for scn, B in ((scn1, B1), (scn2, B2))
                for run in (driver.run_scenario_batch_lanes,
                            driver.run_scenario_batch)]
    emit(phase="configs12_sweep", scenario=scn1.name, engine="lanes",
         ticks_per_point=SWEEP_TICKS, rows=rows, saturates_at_B=sat,
         growth_threshold=SWEEP_GROWTH, profiles=profiles,
         note="idle share = 1 - device busy ms a tick / unprofiled ms a "
              "tick; the ticks run eagerly, one launch an op")
    return rows, sat, profiles


def phase_configs12(dev):
    """Phase 17: configs 1 and 2, ``course12_tuned`` and the sweep."""
    scn1, golden1 = phase_config1(dev)
    phase_config1_vmapped(dev, scn1, golden1)
    scn2, noise, outs2 = phase_config2(dev)
    phase_config2_vmapped(dev, scn2, noise, outs2)
    del noise, outs2
    torch.cuda.empty_cache()
    phase_course12_tuned(dev)
    phase_sweep(dev, scn1, scn2)


# ---------------------------------------------------------------------------
# Phase 18: config 4 for B worlds
# ---------------------------------------------------------------------------

def config4_inputs(wl, t, B, nearest=False):
    """Tick ``t``'s inputs ``(twist (B, 3), zs (B, M, 2), valid (B, M),
    ids (B, M))`` for B worlds that differ: world b is the workload run
    from tick 4 b with ids shifted by b M (``nearest``: the M landmarks
    nearest its true pose instead, as a range sensor sees them), and its
    measurement m is invalid where (t + b + m) % 11 == 0 (so its slot
    stays unseen until the sweep comes back). Made on the workload's
    device, all worlds at once."""
    n = wl.landmarks.shape[0]
    m = wl.schedule.shape[1]
    dev = wl.cmd.device
    b = torch.arange(B, device=dev)
    tt = t + 4 * b
    pose = bigmap._true_pose(wl.cmd, (tt + 1).to(wl.cmd.dtype))   # (3, B)
    if nearest:
        d2 = ((wl.landmarks[None] - pose[1:].T[:, None]) ** 2).sum(-1)
        ids = d2.topk(m, dim=1, largest=False).indices
    else:
        ids = (wl.schedule[tt % wl.schedule.shape[0]] + b[:, None] * m) % n
    lm = wl.landmarks[ids.long()]
    zs = ekf_slam.cartesian2polar(lm[..., 0] - pose[1][:, None],
                                  lm[..., 1] - pose[2][:, None])
    zs = torch.stack([zs[..., 0],
                      se2.normalize_angle(zs[..., 1] - pose[0][:, None])],
                     dim=-1)
    valid = (t + b[:, None] + torch.arange(m, device=dev)[None]) % 11 != 0
    return (wl.cmd[0].expand(B, 3), zs, valid, ids.to(torch.int32))


def config4_start(cfg, wl, B):
    """B empty maps, world b's robot at the workload's true pose of tick
    4 b."""
    st = blocked_ekf.init(cfg, B, device=wl.cmd.device)
    tt = 4 * torch.arange(B, device=wl.cmd.device)
    st.mean_r[:] = bigmap._true_pose(wl.cmd, tt.to(wl.cmd.dtype)).T
    return st


def config4_run(step, st, wl, t0, ticks, known, Q, R, decisions=None,
                nearest=False):
    """``ticks`` ticks of :func:`config4_inputs` from tick ``t0``; with
    ``decisions``, each tick's n_seen and seen are appended beside the
    step's own record."""
    for t in range(t0, t0 + ticks):
        tw, zs, valid, ids = config4_inputs(wl, t, st.mean_r.shape[0],
                                            nearest)
        st = step(st, tw, zs, valid, *((ids,) if known else ()), Q, R)
        if decisions is not None:
            decisions.append((st.n_seen.clone(), st.seen.clone()))
    return st


def clone_state(st):
    return blocked_ekf.BlockedState(*(x.clone() for x in st))


def config4_scan_args(cfg, st, wl, t, Q, R, known, nearest=False):
    """The scan's batched arguments on tick ``t`` of the worlds (the
    post-predict state) and the frozen planes."""
    tw, zs, valid, ids = config4_inputs(wl, t, st.mean_r.shape[0], nearest)
    p = blocked_ekf._predict_shard(cfg, st, tw, Q)
    B, n = p.mean_r.shape[0], p.mean_m.shape[1]
    return (p.mean_r, p.mean_m.transpose(1, 2).contiguous(), p.cov_rr,
            p.cov_rm.permute(0, 1, 3, 2).reshape(B, 6, n), p.diag4, p.seen,
            p.n_seen, p.cov_mm.reshape(B, 4, n, n), zs, valid,
            ids if known else None, R)


def world_args(args, b):
    return tuple(x if i == 11 or x is None else x[b]
                 for i, x in enumerate(args))


def config4_kernels(cfg, st, wl, Q, R):
    """(a) One tick of the differing worlds through both kernels, each
    launched once for the B worlds: every world's outputs bit-equal to its
    own one-world launch, and held to the plain version (the scan on the
    same words at SCAN_TOL, on the same inputs at SCAN_TOL_ROW_FOR_COLUMN;
    the grid pass at GRID_ATOL). Known association takes the sweep's ids
    (revisits, and inits of the slots left unseen), unknown the landmarks
    nearest each robot (matches and skips)."""
    out, timing = {}, {}
    for name, known in (("seq_scan", True), ("seq_scan_unknown", False)):
        args = config4_scan_args(cfg, st, wl, FILL4, Q, R, known,
                                 nearest=not known)
        kw = {} if known else {"known": False}
        got = sq.deferred_seq_scan(*args, use_kernel=True, **kw)
        own_equal = True
        errs_t, errs, bad = {}, {}, []
        for b in range(B4):
            one = world_args(args, b)
            alone = sq.deferred_seq_scan(*one, use_kernel=True, **kw)
            gb = [x[b] for x in got]
            own_equal &= all(torch.equal(x, y) for x, y in zip(gb, alone))
            e_t, bad_t = scan_compare(
                gb, sq.reference_seq_scan(*transposed_planes(one), **kw))
            e, bad_s = scan_compare(gb, sq.reference_seq_scan(*one, **kw),
                                    SCAN_TOL_ROW_FOR_COLUMN)
            bad += [f"world {b} {k}" for k in bad_t + bad_s]
            for k in e_t:
                errs_t[k] = max(errs_t.get(k, 0.0), e_t[k])
                errs[k] = max(errs.get(k, 0.0), e[k])
        kinds = got[11]
        out[name] = {
            "bit_equal_to_own_launches": own_equal,
            "kinds_a_world": [sorted(set(k.tolist())) for k in kinds],
            "n_seen": args[6].tolist(),
            "max_abs_err_transposed_planes": errs_t, "max_abs_err": errs,
            "disagree": bad}
        if not own_equal or bad:
            fail(f"{name} at B={B4}: own launches equal {own_equal}, "
                 f"disagree {bad}")
        if len({tuple(k.tolist()) for k in kinds}) < 2 or not bool(
                (kinds == 1).any()):
            fail(f"{name} at B={B4}: the worlds' ticks do not differ or "
                 f"hold no update: {kinds.tolist()}")
        if known:
            ops = blocked_ekf.grid_operands(*got[7:])
            grid_in = args[7].reshape(B4, 2, 2, N, N)
            timing["seq_scan"] = (args, got)
    cov = gu.fused_grid_update(grid_in.clone(), *ops, use_kernel=True)
    own = all(torch.equal(cov[b], gu.fused_grid_update(
        grid_in[b].clone(), *(x[b] for x in ops), use_kernel=True))
        for b in range(B4))
    err = max(float((cov[b] - gu.reference_grid_update(
        grid_in[b], *(x[b] for x in ops))).abs().max()) for b in range(B4))
    out["grid_update"] = {"bit_equal_to_own_launches": own,
                          "max_abs_err": err, "atol": GRID_ATOL}
    if not own or not err <= GRID_ATOL:
        fail(f"grid_update at B={B4}: own launches equal {own}, err {err}")
    timing["grid_update"] = (grid_in, ops)
    return out, timing


def seen_only(x, y, mask):
    """``x`` and ``y`` with the entries outside ``mask`` zeroed, after
    checking that those entries are equal (the unseen slots hold the prior
    in both, untouched)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if not torch.equal(torch.where(mask, zero, x), torch.where(mask, zero, y)):
        return None
    return torch.where(mask, x, zero), torch.where(mask, y, zero)


def config4_deferred_vs_sequential(cfg, st, wl, Q, R):
    """(b) T4 ticks of the differing worlds from the filled maps through
    the deferred tick (the kernels) and the sequential one (no kernel),
    known and unknown, each robot observing its M nearest landmarks (the
    sweep's far landmarks would all fall in the first-hit gray zone with
    unknown association): the decisions (each measurement's kind and
    slot, n_seen, seen) equal at every tick, the state within
    DEFERRED_SEQ_TOL of scale (the grid and diag4 over the seen slots; the
    unseen ones equal)."""
    out = {}
    for name, known in (("known", True), ("unknown", False)):
        recs, runs = {}, {}
        for deferred in (True, False):
            dec, per_tick = [], []
            make = (blocked_ekf.make_deferred_step if deferred
                    else blocked_ekf.make_sequential_step)
            step = make(cfg, M, st.mean_r.device, known=known, decisions=dec)
            runs[deferred] = config4_run(step, clone_state(st), wl, FILL4,
                                         T4, known, Q, R, per_tick,
                                         nearest=True)
            recs[deferred] = [d + p for d, p in zip(dec, per_tick)]
        torch.cuda.synchronize()
        first_diff = next((t for t, (x, y) in enumerate(zip(recs[True],
                                                            recs[False]))
                           if not all(map(torch.equal, x, y))), None)
        kinds = torch.stack([r[0] for r in recs[True]])
        a, b = runs.pop(True), runs.pop(False)
        errs = {f: scale_err(getattr(a, f), getattr(b, f),
                             tol=DEFERRED_SEQ_TOL)
                for f in ("mean_r", "mean_m", "cov_rr", "cov_rm")}
        seen = a.seen
        for f, mask in (("diag4", seen[:, None, :]),
                        ("cov_mm", (seen[:, None, None, :, None]
                                    & seen[:, None, None, None, :]))):
            pair = seen_only(getattr(a, f), getattr(b, f), mask)
            errs[f] = ((float("inf"), False) if pair is None
                       else scale_err(*pair, tol=DEFERRED_SEQ_TOL))
            del pair
        out[name] = {
            "decisions_equal_every_tick": first_diff is None,
            "first_differing_tick": first_diff,
            "updates": int((kinds == 1).sum()),
            "inits": int((kinds == 2).sum()),
            "no_ops": int((kinds == 0).sum()),
            "n_seen": a.n_seen.tolist(),
            "max_abs_err": {k: v[0] for k, v in errs.items()},
            "tol_of_scale": DEFERRED_SEQ_TOL}
        del a, b
        torch.cuda.empty_cache()
        if first_diff is not None or not all(v[1] for v in errs.values()):
            fail(f"config 4 {name}: deferred and sequential part: "
                 f"{out[name]}")
        if not out[name]["updates"]:
            fail(f"config 4 {name}: the ticks hold no update")
    return out


def config4_main_path(dev, cfg):
    """(c) ``run_bigmap(batch=B4)`` through the kernels, the counters set to
    0 just before and read just after (each kernel once a tick, not B4
    times); every world bit-equal to ``run_bigmap(batch=1)``, and the same
    for the unknown runner."""
    reset_counters()
    st8, wl = bigmap.run_bigmap(N=N, T=T4, M=M, batch=B4, device=dev)
    torch.cuda.synchronize()
    launches = kernel_launches()
    st1, _ = bigmap.run_bigmap(N=N, T=T4, M=M, batch=1, device=dev)
    Q, R = bigmap.noise(device=dev)
    unk = [bigmap.make_unknown_runner(cfg, M, dev, batch=b)(
        blocked_ekf.init(cfg, b, device=dev), wl, Q, R, 0, T4)
        for b in (B4, 1)]
    torch.cuda.synchronize()
    equal = {name: all(torch.equal(getattr(a, f)[w], getattr(b, f)[0])
                       for f in a._fields for w in range(B4))
             for name, a, b in (("known", st8, st1),
                                ("unknown", unk[0], unk[1]))}
    true = bigmap._true_pose(wl.cmd, torch.tensor(float(T4), device=dev))
    out = {"launches": {k: v for k, v in launches.items() if v},
           "bit_equal_to_batch_1": equal,
           "n_seen": {"known": st8.n_seen.tolist(),
                      "unknown": unk[0].n_seen.tolist()},
           "finite": bool(all(torch.isfinite(x).all() for x in st8
                              if x.is_floating_point())),
           "pose_err_m": float((st8.mean_r[:, 1:] - true[1:]).norm(dim=1)
                               .max())}
    if (launches["grid_update"] != T4 or launches["seq_scan"] != T4
            or any(v for k, v in launches.items()
                   if k not in ("grid_update", "seq_scan"))):
        fail(f"run_bigmap(batch={B4}) launched {launches}, not each of "
             f"the two kernels once a tick")
    if not all(equal.values()) or not out["finite"]:
        fail(f"run_bigmap(batch={B4}): {out}")
    if st8.n_seen.tolist() != [T4 * M] * B4:
        fail(f"run_bigmap(batch={B4}) n_seen {st8.n_seen.tolist()}")
    return out, launches


def profile_config4_ticks(run_ticks, ticks, ms_per_tick):
    """Device kernels a tick, busy ms, idle share and the two kernels'
    device ms a tick over ``run_ticks(ticks)``, from ``torch.profiler``
    (device activity only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_ticks(ticks)
        torch.cuda.synchronize()
    rows = [(ev.key, ev.count, getattr(ev, "device_time_total",
                                       getattr(ev, "cuda_time_total", 0)))
            for ev in prof.key_averages()]
    busy = sum(r[2] for r in rows) / 1e3 / ticks
    if not busy:
        return None
    part = lambda key: sum(r[2] for r in rows if key in r[0]) / 1e3 / ticks
    return {"ticks": ticks, "device_kernels_per_tick":
            sum(r[1] for r in rows) / ticks,
            "device_busy_ms_per_tick": busy,
            "device_idle_share": 1.0 - busy / ms_per_tick,
            "seq_scan_ms": part("seq_scan"),
            "grid_update_ms": part("grid_update")}


def config4_times(dev, wl0, st0):
    """(d) ms a tick of the deferred and the sequential tick at
    B = 1, 8, 32, 128 from world 0's filled map (known ids, the sweep's
    revisits: updates), and of the deferred tick at B=8, N=8192 from empty
    maps; host clock around synchronized ticks, with a profile of the
    deferred ticks beside."""
    rows = {}
    Q, R = bigmap.noise(device=dev)
    for n, batches, deferreds in ((N, B4_SWEEP, (True, False)),
                                  (N4_LARGE, (B4,), (True,))):
        c = EKFConfig(num_landmarks=n)
        wl = wl0 if n == N else bigmap.make_workload(n, 64, M, device=dev)
        for B in batches:
            for deferred in deferreds:
                if n == N:
                    st = blocked_ekf.BlockedState(*(
                        x[:1].expand(B, *x.shape[1:]).clone() for x in st0))
                    t0 = FILL4
                else:
                    st, t0 = blocked_ekf.init(c, B, device=dev), 0
                run = bigmap.make_runner(c, M, dev, batch=B,
                                         deferred=deferred)
                warm, ticks = (2, 8) if deferred else (1, 3)
                st = run(st, wl, Q, R, t0, warm)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st = run(st, wl, Q, R, t0 + warm, ticks)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t1) / ticks * 1e3
                key = f"N={n} B={B} {'deferred' if deferred else 'sequential'}"
                rows[key] = {"ms_per_tick": ms,
                             "world_ticks_per_s": B / ms * 1e3,
                             "grid_gb": 16 * n * n * B / 1e9}
                holder = [st]

                def more(k, t=t0 + warm + ticks):
                    holder[0] = run(holder[0], wl, Q, R, t, k)
                rows[key]["profile"] = profile_config4_ticks(
                    more, 3 if deferred else 1, ms)
                st = holder[0]
                if deferred and B > B4:
                    # the scan under the plan chosen for B clusters against
                    # the default cluster, which cannot hold them all at once
                    args = config4_scan_args(c, st, wl, t0, Q, R, True)
                    rows[key]["seq_scan_device_ms"] = {
                        str(sq.launch_plan(n, M, batch=B, max_active=lambda
                                           pl: sq.max_active_clusters(pl, M))
                            ["cluster"]): profiled_device_ms(
                                lambda: sq.deferred_seq_scan(*args), "seq_scan",
                                5),
                        "8 (default)": profiled_device_ms(
                            lambda: sq.deferred_seq_scan(*args, cluster=8),
                            "seq_scan", 5)}
                    del args
                del st, run, holder
                torch.cuda.empty_cache()
    return rows


def config4_kernel_rows(dev, timing, plan_kw):
    """The two kernels at B4 worlds for the kernels line: ms a call (CUDA
    events), device ms (profiler), the plain versions' ms, the bounds of
    B4 worlds' work, the library call that computes the grid pass
    (``torch.baddbmm`` on the 4 B4 planes, used nowhere in the port), and
    the scan's latency floor under its plan."""
    args, _ = timing["seq_scan"]
    grid_in, ops = timing["grid_update"]
    g = grid_in.clone()
    rows = {
        "grid_update": {
            "ms": cuda_ms(lambda: gu.fused_grid_update(g, *ops), 20),
            "device_ms": profiled_device_ms(
                lambda: gu.fused_grid_update(g, *ops), "grid_update", 10),
            "plain_ms": cuda_ms(lambda: gu.reference_grid_update(grid_in,
                                                                 *ops),
                                1, 3)},
        "seq_scan": {
            "ms": cuda_ms(lambda: sq.deferred_seq_scan(*args), 20),
            "device_ms": profiled_device_ms(
                lambda: sq.deferred_seq_scan(*args), "seq_scan", 10),
            "plain_ms": cuda_ms(lambda: sq.deferred_seq_scan(
                *args, use_kernel=False), 1, 1)}}
    a, b = ops[0], ops[1]
    g4 = grid_in.reshape(B4 * 4, N, N)
    a4 = a[:, :, None].expand(B4, 2, 2, N, 2 * M).reshape(B4 * 4, N, 2 * M)
    b4 = b[:, None].expand(B4, 2, 2, 2 * M, N).reshape(B4 * 4, 2 * M, N)
    rows["grid_update"]["library_ms"] = cuda_ms(
        lambda: torch.baddbmm(g4, a4, b4, alpha=-1.0), 20)
    rows["seq_scan"]["library_ms"] = None
    work = serving_work(N)
    for k in rows:
        rows[k].update(bound_of(B4 * work[k][0], B4 * work[k][1]))
    plan = sq.launch_plan(N, M, batch=B4, **plan_kw)
    rows["seq_scan"]["plan"] = plan
    rows["seq_scan"]["latency_floor_ms"] = chain_floor(dev, plan)[
        "seq_scan"]["floor_ms"]
    rows["grid_update"]["plan"] = gu.launch_plan(N, N, M, batch=B4)
    return rows


def phase_config4_batch(dev):
    """Phase 18: config 4 for B4 worlds (see the module docstring)."""
    cfg = EKFConfig(num_landmarks=N)
    Q, R = bigmap.noise(device=dev)
    wl = bigmap.make_workload(N, FILL4 + T4 + 4 * B4 + 1, M, device=dev)
    t0 = time.perf_counter()
    st = config4_run(blocked_ekf.make_deferred_step(cfg, M, dev),
                     config4_start(cfg, wl, B4), wl, 0, FILL4, True, Q, R)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    kernels, timing = config4_kernels(cfg, st, wl, Q, R)
    emit(phase="config4_kernels", N=N, M=M, B=B4, fill_ticks=FILL4,
         fill_s=fill_s, **kernels)
    dvs = config4_deferred_vs_sequential(cfg, st, wl, Q, R)
    emit(phase="config4_deferred_vs_sequential", N=N, M=M, B=B4, T=T4,
         **dvs)
    main, launches = config4_main_path(dev, cfg)
    emit(phase="config4_main_path", N=N, M=M, B=B4, T=T4, **main)
    max_active = lambda plan: sq.max_active_clusters(plan, M)
    rows = config4_kernel_rows(dev, timing, {"max_active": max_active})
    del timing
    times = config4_times(dev, wl, st)
    emit(phase="config4_times", M=M, nvidia_smi=nvidia_smi(),
         kernels_at_B8={k: {kk: vv for kk, vv in v.items()}
                        for k, v in rows.items()}, ticks=times,
         plans={f"B={b}": sq.launch_plan(N, M, batch=b,
                                         max_active=max_active)
                for b in B4_SWEEP})
    errs = {"grid_update": kernels["grid_update"]["max_abs_err"],
            "seq_scan": max(kernels["seq_scan"][
                "max_abs_err_transposed_planes"].values())}
    return launches, errs, rows


def ptxas_resources(text: str):
    """Registers, shared memory and spill bytes of every kernel, from
    ``nvcc -Xptxas -v``'s output."""
    rows, cur = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            short = re.search(r"\d([a-z_]+_kernel)(?:ILi(\d+)ELi(\d+)E|"
                              r"ILb(\d)E)?", name)
            cur = {"kernel": short.group(1) + (
                f"<{short.group(2)},{short.group(3)}>" if short.group(2)
                else f"<{short.group(4)}>" if short.group(4)
                else "") if short else name}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            cur.update(registers=int(m.group(1)),
                       static_smem_bytes=int(smem.group(1)) if smem else 0)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = nvidia_smi()

    emit(phase="device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         allow_tf32_cudnn=torch.backends.cudnn.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision())
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        fail("TF32 is on")

    built = _build.build()
    emit(phase="build", seconds=built["seconds"], libraries=built["paths"],
         kernels=ptxas_resources(built["ptxas"]))

    cfg = EKFConfig(num_landmarks=N)
    grid_ops, grid_err = phase_grid(dev)
    scan_args = scan_inputs(dev, cfg)
    scan_err = phase_scan(scan_args)
    eng, plain, wl, launches = phase_main(dev, cfg)
    # the full map of the main path, before the timing ticks change it
    full = eng.state
    full_args = (full.mean_r[0], full.mean_m[0].T.contiguous(),
                 full.cov_rr[0], full.cov_rm[0].permute(0, 2, 1)
                 .reshape(6, N), full.diag4[0].clone(), full.seen[0].clone(),
                 full.n_seen[0].clone(), full.cov_mm[0].reshape(4, N, N)
                 .clone()) + scan_args[8:]
    per_call = phase_timing(eng, plain, wl, grid_ops, scan_args)

    cov_ops, cov_err = phase_cov(dev)
    unk_err, unk_args = phase_scan_unknown(scan_args, full_args)
    unk_launches = phase_serving_unknown(dev, cfg)
    dense_launches, dense = phase_dense(dev)
    per_call.update(phase_dense_timing(dev, dense, cov_ops, unk_args))
    del eng, plain, dense, full, full_args

    scn = get_scenario("lidar20_full")
    cm_ops, cm_err, scan, sets = phase_circle_moments(dev, scn)
    fit_err, tail_err = phase_circle_fit(dev, scn, scan, sets)
    del scan, sets
    scans, zs_all, valid_all, tail_launches = phase_config3(dev, scn)
    fit_launches_b, cm_launches = phase_perception_buffered(
        dev, scn, scans, zs_all, valid_all)
    del scans, zs_all, valid_all
    cm_call, lib = phase_config3_timing(dev, scn, cm_ops, grid_ops, cov_ops)
    per_call.update(cm_call)
    phase_kernel_scaling(dev)
    torch.cuda.empty_cache()
    phase_configs12(dev)
    torch.cuda.empty_cache()
    b_launches, b_errs, b_rows = phase_config4_batch(dev)

    launches = dict(launches, seq_scan_unknown=unk_launches["seq_scan"],
                    cov_update=dense_launches, circle_moments=cm_launches,
                    circle_fit=fit_launches_b, circle_fit_tail=tail_launches)
    errs = {"grid_update": grid_err, "seq_scan": scan_err,
            "seq_scan_unknown": unk_err, "cov_update": cov_err,
            "circle_moments": cm_err, "circle_fit": fit_err,
            "circle_fit_tail": tail_err}
    paths = {"grid_update": "serving known", "seq_scan": "serving known",
             "seq_scan_unknown": "serving unknown",
             "cov_update": "dense pallas_update='on'",
             "circle_moments": "the tensor-form fit of config 3's "
                               "clusters, every 50th tick",
             "circle_fit": "config 3's scans through buffered perception "
                           "(path B)",
             "circle_fit_tail": "config 3's segmented perception (path A)"}
    bounds = kernel_bounds(cm_ops[1])
    for k in ("grid_update", "seq_scan"):
        key = f"{k}_batched"
        launches[key], errs[key] = b_launches[k], b_errs[k]
        per_call[key] = b_rows[k]
        bounds[key] = b_rows[k]
        lib[key] = b_rows[k]["library_ms"]
        paths[key] = (f"config 4 at {B4} worlds, run_bigmap(batch={B4}), "
                      f"one launch a tick")
    kernels = [dict(name=k, route="cuda", source=v["source"],
                    replaces=v["replaces"], launches=launches[k],
                    max_abs_err=errs[k], ms=per_call[k]["ms"],
                    plain_ms=per_call[k]["plain_ms"],
                    bound_ms=bounds[k]["bound_ms"],
                    bound_by=bounds[k]["bound_by"],
                    library_ms=lib.get(k),
                    device_ms=per_call[k].get("device_ms"),
                    bytes=bounds[k]["bytes"],
                    operations=bounds[k]["operations"], path=paths[k])
               for k, v in KERNELS.items()]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

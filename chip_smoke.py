#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each printing its own lines (any failure exits non-zero):
  (a) build every CUDA kernel from ``mmdet3d_gaussian_tpu_torch/csrc``;
      nvcc time and ptxas registers / spills per kernel;
  (b) each kernel against its plain PyTorch version on the card, on the
      exact inputs the full-width main paths hand it (captured from one
      warm-up predict, from one warm full-width train step with dense
      targets, and from one bf16 predict and one bf16 dense-target train
      step): max error; device time (torch.profiler: the summed durations
      of what each call ran on the card, host time left out) of the
      kernel, the plain version and a one-call library yardstick where
      PyTorch has one; the kernel's time per call on the host's clock (CUDA
      events over back-to-back calls, its wrapper's host work included);
      and the bound.  K7 must equal its plain version; every kernel of the
      bf16 paths (K1, K3, K4, K5, K6, K7, and K2 on bf16 rows) is also
      checked, and timed, on the bf16 paths' inputs.  K4: the path each of
      the step's 19 + 19 calls takes (all must take a vectorized path: the
      convolutions write channels last, so the rows path), bitwise equal
      results over repeated launches, and the largest
      and the smallest call's time against its bound; K2 and K7: the grid,
      tiles a block and store width they run with; K5: the share s of near
      pairs (its cull predicate ``near_pairs_plain``) and the boxes'
      spread, the plain IoU and the kernel exactly 0 on every far pair, its
      bound (near pairs in full plus the cull of every pair) beside the
      all-pairs bound (no cull) and the time of ``zero_`` on its
      output, and three recorded cases (``clustered``, ``all near`` and
      ``none near`` boxes, :func:`k5_boxes`) held to the plain version and
      timed; K6: the device ms of its pack and sweep kernels apart (by
      their profiler names), the predict's kept share of the valid
      candidates per problem, its bound (the strict upper triangle of the
      IoU, valid and keep), and seven recorded cases (none suppressed, all
      suppressed, the chain, random symmetric at thr 0.25 and 0.8, K =
      1,024 and 512: :func:`k6_matrix`) held exactly to the plain version
      and timed; K1 (reduce, mapback, winner with its per-row mask) and
      K3 (forward, backward): the body K1 runs (float4; the smoke fails on
      the single-float one), the device time cold (inputs rotated over
      copies totalling over twice the L2) and warm (the same inputs again)
      beside the bound and the device time of an empty kernel (the launch
      floor), K1 reduce against ``torch.segment_reduce`` cold and warm (the
      smoke fails if it is slower), K3's forward bitwise equal over 10
      calls, and a ``zero_`` of K3 backward's output (its floor);
  (c) TINY predict and one TINY train step on the card against the same
      port on the CPU, in f32 and in bf16 (card bf16 held to CPU bf16 at
      under half of CPU bf16's distance from CPU f32; the same rule run on
      the card's f32 must fail); then the same for the TINY hard model
      (``voxelize_mode='hard'``) on ``crowded_batch``, where pillars
      overflow ``max_points`` and live pillars overflow ``max_voxels``;
      then the TINY MVF model (odd view canvases): a predict and a dense
      train step; then the TINY PV-RCNN (``tests/test_pvrcnn.py``'s
      widths): voxel coords, every sparse level's sites and overflow, the
      FPS indices and the raw-point and level-0 ball queries equal, a
      predict, and a train step on a batch with RPN and RoI positives
      (loss terms, gradients, running statistics);
  (d) the f32 predict path: PointPillars KITTI 3-class at full width
      (dynamic voxelize on the plain canvas, ``s2d_canvas='off'``, batch
      4 x 16384 points, random weights from a seed with a zero cls bias so
      scores clear the threshold) answering 6 requests (3 batches x 2
      rounds); launch counts are zeroed just before and read just after,
      and every predict kernel must have run; then NMS candidate and
      suppression counts, and a torch.profiler run of 5 more predicts for
      the device-busy share and the kernels with the most device time;
  (d16) the bf16 predict path (``compute_dtype='bfloat16'``, the s2d canvas
      on through ``'auto'``, K7 in place of K2) the same way; then the f32
      predict with the s2d canvas on (the f32 default, ``'auto'``: K7 on
      f32 rows, checked equal to its plain version at full width) against
      off, in turns, both with a zero cls bias, with launch counts;
  (t) the f32 train path (plain canvas): the same model trained by
      ``train_step`` on one repeated batch (sparse targets,
      ``pos_cap=1024``), 3 warm-up and 10 timed steps, launch counts zeroed
      before the timed steps; step time, peak memory, loss terms per step
      (finite, descending); then 3 steps with dense targets
      (``pos_cap=0``), where K3 runs; then a torch.profiler run of 3 more
      steps;
  (t16) the bf16 train path (s2d canvas, K7) the same way: sparse targets,
      then dense targets (K3 on the f32 cast of the bf16 box map);
  (h) the hard paths, the KITTI config's own mode and the entry point's
      default (``PointPillarsDetector()``: the packed encoder, always the
      plain canvas, K2): phase (b) on their inputs first (K2 on the pillar
      rows of an f32 and a bf16 predict and train step, equal to its plain
      version, the predicts' timed; K1 on the sorted encoder's inputs: the
      3-channel cluster sum, the 64-channel max of rank-masked rows, the
      winner form in a step, the bf16 predict's max on the f32 cast of its
      rows and that cast's time, with the body each call takes); then the
      f32 predict answering 6 requests (zero cls bias; K2, K5, K6 once
      each, K1 never) with its profile;
  (h16) the same in bf16 (K2 on bf16 rows); then in f32 and in bf16 the
      sorted encoder against the packed one with the same weights (pillar
      rows, predictions) and the two predicts timed in turns;
  (ht), (ht16) the hard train step in f32 and bf16: 3 warm-up and 10 timed
      sparse-target steps (K4 19 + 19, K2 1, K1 never), 3 dense-target
      steps (K3) and a profile of 3 steps;
  (L) train and evaluate from the flagship config
      (``configs/kitti/hv_pointpillars_secfpn_kld5tau1_12x4_160e_kitti-3d-
      3class.py``) through the port's CLIs: a KITTI-format tree written in
      a temporary directory (48 train and 24 val frames of 19,000-20,000
      points, 3-5 Car, 1-2 Pedestrian and 1 Cyclist a frame, camera-frame
      annotations through a KITTI-like calib, a GT database), a derived
      config that moves only the data paths (``samples_per_gpu=12``,
      ``Pad3D`` 20,000, the full train pipeline); the eval ops' library
      built by g++ (the phase fails on the numpy path); the train pipeline
      timed serially over the 12 samples of one batch; ``tools.train`` in
      a subprocess for 8
      steps (one epoch of the RepeatDataset, steps 6-8 under
      torch.profiler: the device-busy share), then the checkpoint restored
      bitwise on the card and ``--resume-from ckpt_8.pt --max-steps 10``;
      ``tools.test`` on ``ckpt_10.pt`` with ``--metric kitti`` (timed
      alone), ``--metric cowa``, ``--bf16 --metric kitti`` and
      ``--format-only --out`` (those three at once), every AP finite in
      [0, 100]; each CLI run's kernel launches zeroed before its ``main``
      and read after it (K4 19 + 19 and K2 once a step; K2, K5, K6 once a
      val batch); then K4 and K2 on one loop step's inputs at B = 12, K5
      on the rotated predict's boxes of a val batch of 12 (K6 there equal),
      K2 on a bf16 predict's rows of that batch and K6 on
      ``nms_normal_bev``'s IoU of it, held to their plain versions and
      timed; the step wall's median, the wait on the prefetch queue, peak
      memory, eval frames/s and the phase's wall (under ``L_LIMIT_S``);
  (n) CenterPoint on nuScenes, the gwd5 config
      (``configs/nuscenes/centerpoint_02pillar_second_secfpn_gwd5_8x4_
      cyclic_20e_nus.py``: dynamic pillars on the 512 x 512 s2d canvas,
      SECOND, the neck at strides 0.5, 1, 2, the 6-task CenterGDHead) at
      full width, random weights from a seed with the heatmap biases
      zeroed: ``synthetic_nus_batch`` (4 x 60,000 five-channel points
      falling off with range, 20,000-30,000 live pillars a sample, printed
      with the truncated count); K1, K7, K5 and K6 on one predict's inputs
      held to their plain versions and timed beside their bounds, circle
      NMS (a radius a task) on the same candidates through K6 equal to the
      plain sweep; 6 requests with launch counts; a profile, the head's
      share of the device time; the predict with circle NMS (one K6 launch
      a radius);
  (n16) the same predict in bf16, launches and latency;
  (nt) the gwd5 train step (its config's code_weights list has one entry
      too many and fails the loss in both packages: the step takes
      ``CP_CODE_WEIGHTS``) on one repeated batch of 30-40 GT boxes a sample
      of the 10 classes with velocities: K1's winner form and K4 on every
      BatchNorm of a step (62 + 62) held to their plain versions, 3
      warm-up and 10 timed steps with every loss term, launches, step time
      and peak memory, a 3-step profile; one step of the plain CenterHead
      config;
  (N) the gwd5 config through the CLIs on a nuScenes-format tree written
      in a temporary directory (8 + 8 frames of a key frame and 9 sweeps,
      ``CBGSDataset`` as configured; data paths and code_weights moved):
      ``tools.train`` 3 steps at B = 4, ``tools.test --metric nds`` and
      ``--metric iou3d_err`` on its checkpoint, every metric finite,
      launches per CLI run, the step wall and the wait on the queue;
  (m) MVF on KITTI, the ``pillarmvf_pointpillars_secfpn_8x4_160e_kitti-
      3d-3class`` config (cartesian and cylindrical views, towers on 432 x
      496 and 411 x 32 canvases, SECOND and the neck to 384 channels, the
      KLD anchor head) at full width, random weights from a seed with the
      cls bias zeroed, ``synthetic_batch`` B = 4 x 16,384: the points live
      in each view and after the cross-view mask, the live voxels of each
      view; K1 (3 reduces, 4 mapbacks), K2 (the three canvases), K5 and
      K6 on one predict's inputs held to their plain versions and timed
      beside their bounds and yardsticks; 6 requests with launch counts; a
      profile and the view towers' share of it;
  (mt) its f32 train step: K1's winner form (3 maxes), K4 on its 35 + 35
      BatchNorms and K3 on a dense step held to their plain versions; 3
      warm-up and 10 sparse-target steps, 3 dense-target steps, a 3-step
      profile, and the step time through ``engine.timing.
      chain_time_state_band`` beside the host-clock median;
  (mc) the ``pillarmvf_centerpoint`` config: 3 predicts (K5 and K6 on B x
      3 problems) and 3 steps, every output finite, launch counts;
  (M) the MVF config through the port's converters and CLIs: a raw KITTI
      tree (velodyne, calib, label_2, ImageSets) written in a temporary
      directory, ``tools.data_converter.kitti_converter`` and
      ``create_gt_database`` run on it as modules, ``tools.train`` 3
      steps at the config's batch and ``tools.test`` under both KITTI
      metrics, launches per CLI run, the step wall and the wait on the
      queue;
  (p) PV-RCNN on KITTI, the ``hv_pvrcnn_secfpn_4x4_80e_kitti-3d-3class``
      config's model at full width (``KITTI_PVRCNN``: sparse shape 41 x
      1,600 x 1,408, 2,048 keypoints, 128 proposals, grid 6), random
      weights from a seed, ``synthetic_batch`` B = 4 x 16,384 over its
      range: the live voxels and each sparse level's live sites per sample
      with the cumulative overflow (the capacity truncates batch-major);
      the voxel coords, every level's sites, the FPS indices and the
      ball queries of the raw-point and level-0 SA held exactly to the
      port on the CPU on the same batch; K1 (the voxel mean's sums), K5 at
      4 x 512 and 4 x 128 and K6 after each on one predict's inputs held to
      their plain versions and timed beside their bounds; 6 requests with
      launch counts (K1 1, K5 2, K6 2, nothing else); a profile, and the
      device ms of the sparse encoder, FPS, the SA ball queries and
      RoI-grid pooling run alone with their shares of the predict;
  (pt) its train step on one repeated batch with 4-8 GT boxes a sample
      (the first two made RPN and RoI positives): K4 on the 14 + 14
      BatchNorms, K1, K5 and K6 held to their plain versions; 3 warm-up and
      10 timed steps (every loss term finite, the sum of the RPN and
      semantic terms, whose targets stay put, going down; the sparse
      overflow metric, launches, step time, peak memory) and a 3-step
      profile;
  (P) the PV-RCNN config through the CLIs on a KITTI-format tree (12 + 8
      frames, data paths moved): a first step from the config's random
      init on each augmented batch of two passes (every term and weight
      finite; the batches where the JAX package's corner loss would be
      NaN counted); ``tools.train`` 3 steps at the config's
      B = 4 and learning rate (every loss term finite), ``tools.test
      --metric kitti`` on its checkpoint (every AP finite in [0, 100]),
      launches per CLI run, the step wall and the wait on the queue;
  (x) MVX on KITTI (``engine/mvx.py``: ``KITTI_MVX_MODEL``, the KITTI
      3-class GD anchor head) at full width, random weights from a seed
      with the cls bias zeroed, ``synthetic_mvx_batch`` B = 4 x 16,384 with
      images of 384 x 1280 (mmdet3d's MVX KITTI test scale): phase (c)
      first for the TINY MVX (``tests/test_mvx_fusion.py``'s widths on an
      odd 36 x 68 image: a predict and a dense train step card vs CPU, the
      image backbone's gradient not zero); K1 (reduce, mapback), K2, K5 and
      K6 on one f32 predict's inputs held to their plain versions and
      timed beside their bounds; 6 requests with launch counts (K1 1 + 1,
      K2, K5, K6 once, never K7); the share of points on the image; a
      profile, the image branch's and the fusion's device ms run alone and
      their shares, the image branch's FFT or Winograd kernels, if any;
  (x16) the same predict in bf16 (K2 on bf16 rows);
  (xt) the f32 train step: K1's winner, K4 on its 39 + 39 BatchNorms (each
      on its rows path) and K3 on a dense step held to their plain
      versions; the image backbone's gradient norm; the fusion's backward
      alone (``index_add_`` against plain indexing's sorted
      ``index_put_``); the image branch's and SECOND's forward and
      backward with cuDNN's heuristics and its benchmark mode; 3 warm-up
      and 10 sparse-target steps, 3 dense-target steps, a 3-step profile.
      ``python3 chip_smoke.py --only mvx`` runs (a) and these phases alone
      and prints no result line;
  (w) Waymo PointPillars (``configs/waymo/hv_pointpillars_secfpn_gwd5_
      sbn_8x4_2x_waymo-3d-3class.py`` through the CLIs' ``build_detector``:
      hard voxelize at 0.32 m over +-74.88 m, a 468 x 468 canvas, the
      first stage at stride 1, the 384-channel neck, 1,314,144 aligned
      anchors a sample) at full width, random weights from a seed with the
      cls bias zeroed, B = 4 x 180,000 five-channel points from
      :func:`waymo_scene` (ground rings, walls, points on 20-40 boxes):
      the live pillars per sample and how many the 32,000 cap drops; K2,
      K5 and K6 on one predict's inputs held to their plain versions and
      timed beside their bounds and yardsticks; 6 requests with launch
      counts (K2, K5, K6 once, never K1 or K7); a profile;
  (wt) the Waymo f32 train step: K4's 19 + 19 calls and K3 (its gwd3d
      form) on a dense step held to their plain versions; 3 warm-up and
      10 sparse-target steps, 3 dense-target steps, a 3-step profile;
  (wd) data parallel on the card: the full-width Waymo step on two gloo
      ranks on the one card (NCCL refuses two ranks on one device) at
      global B = 4 (2 + 2), 2 steps, against one rank on the 4 samples
      (loss terms, every gradient, running statistics; ranks' parameters
      bitwise equal; K4's all-reduced sums against the plain moments of
      the 4 samples) and the host time of the step's 38 BatchNorm
      all-reduces; the same 38 over NCCL on one rank; ``torchrun
      --nproc_per_node 1`` of the train CLI with ``--distributed`` (NCCL,
      world 1) for 3 steps on a Waymo-format tree written here (8 train
      and 4 val frames, 6-column bins, the config with only its data
      paths moved), then the test CLI with ``--metric waymo`` on its
      checkpoint (every value finite in [0, 1]), launches per CLI run;
      (w)-(wd) within 150 s.  ``python3 chip_smoke.py --only waymo`` runs
      (a) and these phases alone and prints no result line;
  (ps) point-axis sharding (``ShardedPointPillarsDetector``: the dense-
      canvas pillar encoder, a mean by ``index_add_``, then SECOND,
      SECONDFPN and the GD anchor head at KITTI 3-class full width, f32),
      within PS_LIMIT_S: the TINY sharded detector card vs CPU (a predict,
      a dense-target step); at full width with ``point_axis=None``, B = 4
      x 16,384, random weights from a seed with the cls bias zeroed: K5
      and K6 on one predict's inputs, K3 and K4 (19 + 19) on a dense step's
      held to their plain versions and timed beside their bounds; 6
      predicts (K5, K6 once, never K1, K2 or K7), 3 warm-up and 10 sparse
      steps (K4 19 + 19), 3 dense steps (K3 1 + 1), profiles, the dense-
      canvas sums timed alone; then two gloo ranks on the card as a 1 x 2
      (data, points) grid, 2 dense-target steps with the dense and with
      the sparse merge against one rank on the whole batch (loss terms,
      gradients with the BatchNorm sums replayed, running statistics,
      the ranks' states bitwise equal), each merge's bytes and time
      alone, and the pillar reduces of a sample merged over the ranks
      against one rank (count and max equal, sums to rounding).
      ``--only ps`` runs (a) and (ps) alone; ``--only dp4`` ends with the
      same checks on one NCCL rank a card, 2 x 2 and 1 x 4 grids, each
      step timed beside one card's (``--only dp4 sharded``: these alone);
  (ex) the serving export (``engine/export.py``): the KITTI flagship
      predict (hard, f32), KITTI dynamic bf16 on the s2d canvas and
      CenterPoint nuScenes (gwd5, f32), B = 4 x 16,384 and 4 x 60,000
      points, each exported with ``torch.export`` (its seconds), loaded in
      one fresh python that imports torch and the loader only, run on two
      batches (one not the example) and held to the eager predict
      (integers equal, floats within ``EX_TOL``), its launches per call
      equal to the eager predict's, its median ms on CUDA events beside
      the eager one's (over the same calls, in this process); last of
      all phases, after (L); one
      ``profiling.trace`` of the flagship predict summarized by
      ``tools/misc/summarize_trace``; each registered op's host dispatch
      cost against its CUDA implementation called directly.  Phase (b)'s
      ``call_ms`` goes through the ops.  ``--only export`` runs (a) and
      (ex) alone;
  (e) one JSON line listing the kernels (with their launches on the hard
      paths and K2's and K1's numbers there, under ``loop`` the launches
      of each CLI run and the numbers on the loop's inputs, under
      ``centerpoint`` the launches of each CenterPoint path and the
      numbers on its inputs, under ``mvf`` those of the MVF paths, by
      call, under ``pvrcnn`` those of the PV-RCNN paths, under ``mvx``
      those of the MVX paths, under ``waymo`` those of the Waymo paths and
      under ``dp`` the launches of the data-parallel CLI runs and K4's
      all-reduced check, under ``sharded`` the launches of each point-
      sharded path and the numbers on its inputs), the card's name and
      power limit from
      nvidia-smi, and the result line.

f32 runs with TF32 off for matmuls and cuDNN convolutions; the bf16 paths
compute in bf16 on f32 parameters, as the JAX package's mixed precision.
The script exits non-zero, printing no result, without a CUDA device or
outside a checkout of the repository.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the device-time instruments live in the port (engine/profiling.py); the
# script runs from the repository root, which is on the path
from mmdet3d_gaussian_tpu_torch.engine.profiling import (  # noqa: E402
    EVENTS_KEY, PROFILER_MISSES, cuda_ms, cuda_spans, device_ms,
    device_ms_by_name)

# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W limit): HBM3
# bytes/s, and f32 operations/s outside the tensor cores. The data sheet's
# 67 TFLOP/s counts a fused multiply-add as two operations; the kernels
# below do compares, selects, adds and single multiplies, one operation
# per issued instruction, so their peak is half of it.
PEAK_BYTES = 3.35e12
PEAK_F32_OPS = 67e12 / 2
# the H100's L2 cache (50 MB): K4's single-call timings and the cold times
# of K1 and K3 rotate through copies of their inputs of twice this size
L2_BYTES = 50 * 2 ** 20
# BatchNorm2d's eps in the model (the forward yardstick takes it)
BN_EPS = 1e-3

# f32 operations per pair that the rotated IoU needs (each add, sub, mul,
# div, abs, min/max, compare, select and sin/cos counted once): the steps of
# csrc/rotated_iou.cu, with its 24-slot sort counted as the best-known
# 24-input sorting network of 120 comparators instead of the kernel's 276
IOU_OPS_PER_PAIR = (4          # cos, sin of both boxes
                    + 72       # corners of both boxes
                    + 144      # 8 corner-inside tests
                    + 440      # 16 edge intersections
                    + 124      # valid count and centroid
                    + 288      # 24 pseudo-angle keys
                    + 840      # 120 compare-swaps x (1 compare + 6 selects)
                    + 72       # collapse invalid slots
                    + 100      # shoelace
                    + 8)       # area clamp and division
# f32 operations per pair of the cull test that K5 runs on every pair: two
# subtractions, two products and a sum for d^2, a sum and a product for
# (R_a + R_b)^2, two compares and their and
CULL_OPS_PER_PAIR = 10
# K5's recorded cases (phase (b)): boxes of P problems of K, like the
# predict's NMS candidates
K5_P, K5_K = 12, 1024

# K6's recorded cases (phase (b)): (case, K, thr) for P problems of K
# candidates, like the predict's NMS (:func:`k6_matrix`)
K6_P = 12
K6_CASES = (('none suppressed', 1024, 0.25), ('all suppressed', 1024, 0.25),
            ('chain', 1024, 0.25), ('random', 1024, 0.25),
            ('random', 1024, 0.8), ('random', 512, 0.25),
            ('random', 512, 0.8))

# Phase (c): head maps may differ between card and CPU by MAP_TOL. Decode
# scales a map error by its derivative: the anchor's BEV diagonal for x and
# y, the anchor height plus half the box height for z (z delta and log h
# delta both move it), the box's own size for w, l, h (exp(delta) * anchor
# = the decoded size), 1 for yaw. Each box element may differ by MAP_TOL
# times that derivative plus f32 rounding of its own magnitude.
MAP_TOL = 1e-4
ROUND_TOL = 8 * torch.finfo(torch.float32).eps

# f32 operations per anchor of the decoded-box GD loss in the main path's
# configuration (kld3d, fun log1p, tau 1), each add, mul, div, select,
# compare and transcendental counted once: decode of pred and target (36),
# Gaussian parameters of both (34), inverse pred and target covariances
# (30), centre term (19), shape term with 6 logs (24), sqrt, log1p and tau
# saturation (9), weighting and sum (2).  The function needs them for
# weighted anchors only, plus one test of every weight; the backward needs
# ~3x the forward's operations, for anchors with weight > 0 only.  Both
# stay bytes-bound at any count within a few times of this one.
GD_OPS_PER_ANCHOR = 154

TPU = 'mmdet3d_gaussian_tpu/ops/pallas/'
SRC = 'mmdet3d_gaussian_tpu_torch/csrc/'
# kernel -> (source, TPU kernel it replaces, the path that launches it)
KERNELS = {
    'segment_reduce': (SRC + 'segment_reduce.cu',
                       TPU + 'segment_kernel.py:171', 'predict'),
    'segment_reduce_mapback': (SRC + 'segment_reduce.cu',
                               TPU + 'segment_kernel.py:171', 'predict'),
    'bev_splat': (SRC + 'bev_splat.cu', TPU + 'bev_splat_kernel.py:218',
                  'predict'),
    'bev_splat_pairs': (SRC + 'bev_splat.cu',
                        TPU + 'bev_splat_kernel.py:162', 'predict_bf16'),
    'rotated_iou': (SRC + 'rotated_iou.cu', TPU + 'rotated_iou_kernel.py:166',
                    'predict'),
    'nms_sweep': (SRC + 'nms_sweep.cu', TPU + 'nms_kernel.py:37', 'predict'),
    'segment_max_winner': (SRC + 'segment_reduce.cu',
                           TPU + 'segment_kernel.py:263', 'train'),
    'bn_moments': (SRC + 'bn_moments.cu', TPU + 'bn_kernel.py:101', 'train'),
    'bn_grad_moments': (SRC + 'bn_moments.cu', TPU + 'bn_kernel.py:120',
                        'train'),
    'gd_loss_fwd': (SRC + 'gd_loss.cu', TPU + 'gd_loss_kernel.py:244',
                    'train_dense'),
    'gd_loss_bwd': (SRC + 'gd_loss.cu', TPU + 'gd_loss_kernel.py:268',
                    'train_dense'),
}
# launches per train step: one BN forward and backward for each of the 19
# BatchNorm2d layers (16 in SECOND, 3 in SECONDFPN), one winner pass for the
# encoder's final voxel max; K3 once each way per dense-target step
TRAIN_LAUNCHES = {'bn_moments': 19, 'bn_grad_moments': 19,
                  'segment_max_winner': 1}
DENSE_LAUNCHES = {'gd_loss_fwd': 1, 'gd_loss_bwd': 1}
# launches per request or step on each path (the f32 paths splat with K2
# on the plain canvas, the bf16 paths, and the f32 predict with the s2d
# canvas on, with K7 on the s2d canvas)
PREDICT_LAUNCHES = {'segment_reduce': 1, 'segment_reduce_mapback': 1,
                    'bev_splat': 1, 'rotated_iou': 1, 'nms_sweep': 1}
PREDICT_S2D_LAUNCHES = dict(PREDICT_LAUNCHES, bev_splat=0,
                            bev_splat_pairs=1)
TRAIN_BF16_LAUNCHES = dict(TRAIN_LAUNCHES, bev_splat_pairs=1)
DENSE_BF16_LAUNCHES = {**TRAIN_BF16_LAUNCHES, **DENSE_LAUNCHES}
# the f32 paths' model, and the bf16 one
F32_MODEL = dict(voxelize_mode='dynamic', s2d_canvas='off')
BF16_MODEL = dict(voxelize_mode='dynamic', compute_dtype='bfloat16')
# the hard paths: the KITTI config's own mode and the port's default
# (PointPillarsDetector() with no model config: the packed encoder), in f32
# and bf16, and the sorted encoder; always the plain canvas (K2).  K1 runs
# on the sorted encoder only: a predict reduces twice (the 3-channel
# cluster sum, the 64-channel max), a train step sums once and takes the
# max's winner form once
HARD16_MODEL = dict(compute_dtype='bfloat16')
SORTED_MODEL = dict(hard_encoder='sorted')
NO_K1 = {'segment_reduce': 0, 'segment_reduce_mapback': 0,
         'segment_max_winner': 0}
HARD_PREDICT_LAUNCHES = {'bev_splat': 1, 'bev_splat_pairs': 0,
                         'rotated_iou': 1, 'nms_sweep': 1, **NO_K1}
HARD_TRAIN_LAUNCHES = {'bn_moments': 19, 'bn_grad_moments': 19,
                       'bev_splat': 1, 'bev_splat_pairs': 0, **NO_K1}
HARD_DENSE_LAUNCHES = {**HARD_TRAIN_LAUNCHES, **DENSE_LAUNCHES}
SORTED_PREDICT_LAUNCHES = dict(HARD_PREDICT_LAUNCHES, segment_reduce=2)
SORTED_TRAIN_LAUNCHES = dict(HARD_TRAIN_LAUNCHES, segment_reduce=1,
                             segment_max_winner=1)

TINY_MODEL = dict(
    voxel_size=(0.4, 0.4, 4.0),
    point_cloud_range=(0., -12.8, -3., 25.6, 12.8, 1.),
    max_points_per_voxel=16,
    max_voxels_per_sample=1024,
    voxelize_mode='dynamic',
    encoder_cfg=dict(in_channels=4, feat_channels=(16,)),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                      layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
    neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                  upsample_strides=(1, 2, 4)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=48),
)
TINY_HEAD = dict(test_cfg=dict(use_rotate_nms=True, nms_thr=0.01,
                               score_thr=0.05, nms_pre=128, max_num=32))
TINY_F32 = dict(TINY_MODEL, s2d_canvas='off')
TINY_BF16 = dict(TINY_MODEL, compute_dtype='bfloat16')
TINY_HARD = dict(TINY_MODEL, voxelize_mode='hard')
# the TINY MVF model: the cartesian view on the TINY canvas (64 x 64) and a
# cylindrical view of 39 x 11 cells (both odd: the towers' deconvs crop)
TINY_MVF = dict(TINY_MODEL, voxelize_mode='mvf', encoder_cfg=dict(
    in_channels=4, feat_channels=16, views=('cartesian', 'cylindrical'),
    voxel_size=((0.4, 0.4, 4.0), (0.04, 0.4, 40.0)),
    point_cloud_range=(TINY_MODEL['point_cloud_range'],
                       (-0.78, -3.0, 0.0, 0.78, 1.4, 40.0))))
TINY_HARD16 = dict(TINY_HARD, compute_dtype='bfloat16')
# the hard TINY phases' batch (crowded_batch): 12 piles of 40 points a
# sample against max_points 16, ~1,600 live pillars a sample against
# max_voxels 1,024
TINY_HARD_SEED = 6
# Phase (c) in bf16: the card's bf16 run is held to the CPU's bf16 run.
# Each head map, loss term and parameter gradient must be nearer to CPU
# bf16 than GAP_SHARE of CPU bf16's own distance from CPU f32 (the rule of
# tests/test_torch_bf16.py against JAX): a missing or misplaced cast moves
# a value about that whole distance, so the same comparison made with the
# card's f32 run must fail it; and within BF16_MAP_TOL of CPU bf16 (maps:
# of the largest value; loss terms: relative).
GAP_SHARE = 0.5
BF16_MAP_TOL = 2e-2
BATCH, POINTS, SEEDS, ROUNDS = 4, 16384, (0, 1, 2), 2
# passes of a splat and of its yardstick, timed in turns
YARDSTICK_ROUNDS = 6
WARM_STEPS, TIMED_STEPS, DENSE_STEPS, LR = 3, 10, 3, 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def clone_like(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with its strides (a channel slice stays one)."""
    out = torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                              device=t.device)
    return out.copy_(t)


def cold_ms(fn, args, iters=50):
    """(mean device ms of ``fn(*args)`` with every tensor of ``args``
    rotated over copies that total over twice the L2, so that each call
    reads its inputs from HBM and not from the last call's L2; the number
    of copies)."""
    first = tuple(clone_like(a) if isinstance(a, torch.Tensor) else a
                  for a in args)
    nbytes = sum(a.untyped_storage().nbytes() for a in first
                 if isinstance(a, torch.Tensor))
    n_copies = 1 + -(-2 * L2_BYTES // max(nbytes, 1))
    sets = [first] + [tuple(clone_like(a) if isinstance(a, torch.Tensor)
                            else a for a in args)
                      for _ in range(n_copies - 1)]
    copies = itertools.cycle(sets)
    ms = device_ms(lambda: fn(*next(copies)), iters)
    del sets, copies
    return ms, n_copies


_FLOOR = {}


def launch_floor() -> float:
    """Device ms of the port's empty kernel, launched as every kernel is:
    the floor of a kernel whose bytes take less than a launch."""
    if 'ms' not in _FLOOR:
        from mmdet3d_gaussian_tpu_torch.ops import _cuda
        dev = torch.device('cuda', torch.cuda.current_device())
        _FLOOR['ms'] = device_ms(lambda: _cuda.launch('empty', dev), 200)
    return _FLOOR['ms']


def cold_warm(results, name, fn, args, card, note='', iters=50):
    """Add the cold time (:func:`cold_ms`) and the launch floor to
    ``results[name]`` (whose ``ms`` is the warm time) and print both with
    the bound and its share of each."""
    r = results[name]
    r['cold_ms'], n_copies = cold_ms(fn, args, iters)
    r['floor_ms'] = launch_floor()
    b = r['bound_ms']
    print(f'(b) {name}{note}: cold {r["cold_ms"]:.4f} ms (inputs in turn '
          f'from {n_copies} copies, over twice the L2), warm {r["ms"]:.4f} '
          f'ms; bound {b:.4f} ms ({r["bound_by"]}) = {b / r["cold_ms"]:.0%} '
          f'of cold, {b / r["ms"]:.0%} of warm; empty-kernel launch floor '
          f'{r["floor_ms"]:.4f} ms [{card}]')


def record_calls(run, patches):
    """Run ``run()`` with the kernel wrappers ``patches`` ((module,
    attribute, kernel name), ...) wrapped to record the arguments of every
    call; -> {kernel name: [args, ...]}."""
    seen, originals = {}, []
    for mod, attr, name in patches:
        fn = getattr(mod, attr)
        originals.append((mod, attr, fn))

        def rec(*args, _fn=fn, _name=name):
            seen.setdefault(_name, []).append(args)
            return _fn(*args)
        setattr(mod, attr, rec)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for mod, attr, fn in originals:
            setattr(mod, attr, fn)
    return seen


def predict_patches():
    from mmdet3d_gaussian_tpu_torch.ops import nms, scatter, voxelize
    return [(scatter, 'segment_reduce', 'segment_reduce'),
            (scatter, 'segment_reduce_mapback', 'segment_reduce_mapback'),
            (voxelize, 'bev_splat', 'bev_splat'),
            (voxelize, 'bev_splat_pairs', 'bev_splat_pairs'),
            (nms, 'iou_bev_pairwise', 'rotated_iou'),
            (nms, 'suppress_sweep', 'nms_sweep')]


def capture_inputs(det, batch, per_request):
    """Run one predict and record the arguments of each kernel's first
    call; every kernel of ``per_request`` (launches per request) must be
    called as often as it says."""
    seen = record_calls(lambda: det.predict(batch), predict_patches())
    got = {k: len(v) for k, v in seen.items()}
    want = {k: n for k, n in per_request.items() if n}
    check(got == want, f'predict called {got}, want {want}')
    return {k: v[0] for k, v in seen.items()}


def bound(bytes_, ops):
    """(least ms, 'bytes' | 'operations') for moving ``bytes_`` and doing
    ``ops`` f32 operations at the card's published peaks."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def report(results, name, card, err, tol, ok, kernel, plain, library,
           iters, plain_iters, bytes_, ops, note=''):
    """Time one kernel, its plain version and its library yardstick (if
    any), store its phase-(b) numbers, print them, fail on ``ok`` False."""
    check(ok, f'{name}: kernel disagrees with plain version (max_abs_err '
          f'{err:.3g}, tol {tol})')
    ms = device_ms(kernel, iters)
    call_ms = cuda_ms(kernel, iters)
    plain_ms = device_ms(plain, plain_iters, warmup=1)
    library_ms = device_ms(library, iters) if library else None
    bound_ms, bound_by = bound(bytes_, ops)
    results[name] = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by, bytes=bytes_,
                         operations=ops)
    lib = 'none' if library_ms is None else f'{library_ms:.4f} ms'
    print(f'(b) {name}: max_abs_err={err:.3g} (tol {tol}){note} '
          f'kernel={ms:.4f} ms (per call on the host clock {call_ms:.4f}) '
          f'plain={plain_ms:.4f} ms library={lib} '
          f'bound={bound_ms:.4f} ms ({bound_by}) [{card}]')


def kernel_checks(inputs, card, note=''):
    """Phase (b), predict kernels: each vs its plain version on the
    captured inputs (K1 and K2 where the predict ran them)."""
    from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou, segment
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    results = {}

    def record(name, kernel, plain, library, err, tol, bytes_, ops, iters,
               plain_iters, exact=None):
        eq = ('' if exact is None else f' exact_equal={exact}') + note
        report(results, name, card, err, f'{tol:g}',
               err <= tol and exact is not False, kernel, plain, library,
               iters, plain_iters, bytes_, ops, eq)

    # K1 reduce form (final per-voxel max, 64 channels) and mapback form,
    # where the predict ran them (not the point-sharded one)
    if 'segment_reduce' in inputs:
        data, starts, counts, op = inputs['segment_reduce']
        out = segment.segment_reduce(data, starts, counts, op)
        ref = segment.segment_reduce_plain(data, starts, counts, op)
        n_live = int(torch.count_nonzero(counts))
        rows = int(counts.sum())
        lengths = counts[:n_live].long()
        check(bool((counts[n_live:] == 0).all()), 'live voxels not first')
        live_rows = data[:rows]
        record('segment_reduce',
               lambda: segment.segment_reduce(data, starts, counts, op),
               lambda: segment.segment_reduce_plain(data, starts, counts, op),
               lambda: torch.segment_reduce(live_rows, op, lengths=lengths,
                                            unsafe=True),
               float((out - ref).abs().max()), 0.0,
               *k1_work('reduce', data, None, starts, counts), 200, 10)
        check_k1_path('segment_reduce', data, note)
        cold_warm(results, 'segment_reduce', segment.segment_reduce,
                  (data, starts, counts, op), card, note, 200)
        lib_cold, _ = cold_ms(
            lambda d: torch.segment_reduce(d[:rows], op, lengths=lengths,
                                           unsafe=True), (data,), 200)
        r = results['segment_reduce']
        r['library_cold_ms'] = lib_cold
        print(f'(b) segment_reduce{note}: torch.segment_reduce cold '
              f'{lib_cold:.4f} ms, warm {r["library_ms"]:.4f} ms [{card}]')
        check(r['ms'] < r['library_ms'] and r['cold_ms'] < lib_cold,
              'K1 reduce is slower than torch.segment_reduce')

        # K1 mapback form (cluster mean: xyz + ones column, 4 channels)
        data, ids, starts, counts, op = inputs['segment_reduce_mapback']
        out = segment.segment_reduce_mapback(data, ids, starts, counts, op)
        ref = segment.segment_reduce_mapback_plain(data, ids, starts,
                                                   counts, op)
        record('segment_reduce_mapback',
               lambda: segment.segment_reduce_mapback(data, ids, starts,
                                                      counts, op),
               lambda: segment.segment_reduce_mapback_plain(data, ids, starts,
                                                            counts, op),
               None, float((out - ref).abs().max()), 1e-4,
               *k1_work('mapback', data, ids, starts, counts), 200, 10)
        check_k1_path('segment_reduce_mapback', data, note)
        cold_warm(results, 'segment_reduce_mapback',
                  segment.segment_reduce_mapback,
                  (data, ids, starts, counts, op), card, note, 200)

    # K2 BEV splat
    if 'bev_splat' in inputs:
        feats, lin, ncell = inputs['bev_splat']
        out = voxelize.bev_splat(feats, lin, ncell)
        ref = voxelize.bev_splat_plain(feats, lin, ncell)
        live = lin < ncell
        lin_live, feats_live = lin[live].long(), feats[live]
        canvas = torch.zeros_like(ref)
        k2 = lambda: voxelize.bev_splat(feats, lin, ncell)  # noqa: E731
        lib = lambda: canvas.zero_().index_copy_(  # noqa: E731
            0, lin_live, feats_live)
        record('bev_splat', k2,
               lambda: voxelize.bev_splat_plain(feats, lin, ncell), lib,
               float((out - ref).abs().max()), 0.0,
               feats.numel() * 4 + lin.numel() * 4
               + ncell * feats.shape[1] * 4, 0, 50, 10)
        check(torch.equal(canvas, ref), 'index_copy_ yardstick disagrees')
        print_splat_plan('bev_splat', feats, lin, out, 1, card)
        check_yardstick(results, 'bev_splat', '', k2, lib, card)
        print(f'(b) bev_splat: zero fill of the canvas alone '
              f'{cuda_ms(canvas.zero_, 50):.4f} ms '
              f'({ncell * feats.shape[1] * 4} bytes) [{card}]')
        splat_densities(feats, lin, ncell, card)

    # K5 rotated IoU
    (boxes,) = inputs['rotated_iou']
    p, k = boxes.shape[:2]
    out = rotated_iou.iou_bev_pairwise(boxes)
    ref = rotated_iou.iou_bev_pairwise_plain(boxes)
    thr = 0.01
    overlap = float((ref > thr).float().mean())
    print(f'(b) rotated_iou inputs{note}: {p} problems x {k} boxes, share '
          f'of pairs with IoU > {thr}: {overlap:.4f}')
    check(overlap > 0, 'rotated IoU inputs do not overlap')
    n_near = k5_cull(boxes, out, ref, card, f'predict inputs{note}')
    record('rotated_iou', lambda: rotated_iou.iou_bev_pairwise(boxes),
           lambda: rotated_iou.iou_bev_pairwise_plain(boxes), None,
           float((out - ref).abs().max()), 1e-5, *k5_work(boxes, n_near),
           20, 2)
    results['rotated_iou']['near_share'] = n_near / (p * k * k)
    k5_bounds(results['rotated_iou'], out, boxes, card, note)
    del ref

    # K6 NMS sweep, on the main path's IoU and valid mask
    iou, valid, thr = inputs['nms_sweep']
    keep = nms.suppress_sweep(iou, valid, thr)
    ref = nms.suppress_sweep_plain(iou, valid, thr)
    exact = bool(torch.equal(keep, ref))
    n_valid = valid.sum(1)
    share = (ref.sum(1) / n_valid.clamp(min=1)).tolist()
    print(f'(b) nms_sweep inputs{note}: {valid.shape[0]} problems x '
          f'{valid.shape[1]} candidates, thr {thr}; valid per problem '
          f'{n_valid.tolist()}, kept share of the valid '
          f'{[round(x, 4) for x in share]}')
    record('nms_sweep', lambda: nms.suppress_sweep(iou, valid, thr),
           lambda: nms.suppress_sweep_plain(iou, valid, thr), None,
           float((keep.int() - ref.int()).abs().max()), 0.0,
           *k6_work(valid, ref), 50, 2, exact=exact)
    results['nms_sweep']['kept_share'] = share
    results['nms_sweep']['split'] = k6_split(
        lambda: nms.suppress_sweep(iou, valid, thr), card,
        f'predict inputs{note}')
    return results


def k1_work(form, data, ids, starts, counts):
    """(bytes, operations) K1's ``form`` needs: each input read once (the
    rows of the live segments, the segment bounds, the ids where the form
    reads them; rows past the live segments, trash, are not needed), each
    output written once (the mask as bytes), one operation an element
    of the live rows."""
    n, c = data.shape
    v = counts.shape[0]
    live = int(counts.sum())
    ops = live * c
    if form == 'reduce':
        return live * c * 4 + v * 8 + v * c * 4, ops
    if form == 'mapback':
        return live * c * 4 + n * c * 4 + n * 4 + v * 8, n * c
    return live * c * 4 + v * 8 + n * 4 + v * c * 4 + n * c, ops  # winner


def k3_work(pred2, w_a):
    """{'fwd' | 'bwd': (bytes, operations)}, (anchors with weight > 0,
    with weight < 0): every weight is read, and of the rest only what the
    weighted anchors need: pred, target and anchor (21 floats) where w > 0,
    target and anchor (14) where w < 0; an anchor with w == 0 adds 0 and
    has a 0 gradient.  The backward writes every gradient row."""
    m, k7 = pred2.shape
    anchors = m * k7 // 7
    n_pos = int((w_a > 0).sum())
    n_neg = int(((w_a != 0) & ~(w_a > 0)).sum())
    fwd = ((anchors + 21 * n_pos + 14 * n_neg) * 4 + 4,
           anchors + (n_pos + n_neg) * GD_OPS_PER_ANCHOR)
    bwd = ((anchors + 21 * n_pos + 7 * anchors + 1) * 4,
           anchors + n_pos * 3 * GD_OPS_PER_ANCHOR)
    return dict(fwd=fwd, bwd=bwd), (n_pos, n_neg)


def check_k1_path(name, data, note):
    """Print the body K1 runs on ``data`` and fail unless it is the
    16-byte one (the main path hands it fresh, 64- or 4-channel rows)."""
    from mmdet3d_gaussian_tpu_torch.ops import segment
    vec = segment.vectorized(data)
    print(f'(b) {name}{note}: {data.shape[0]} rows x {data.shape[1]} '
          f'channels, {"float4" if vec else "single-float"} body')
    check(vec, f'{name}: a main-path call took the single-float body')


def k6_work(valid, keep):
    """(bytes, operations) the sweep needs: the strict upper triangle of
    the IoU read once, valid read and keep written once; a compare of every
    upper IoU and, for each kept row, one update of each later column."""
    p, k = valid.shape
    upper = p * k * (k - 1) // 2
    pos = torch.arange(k, device=keep.device)
    return upper * 4 + 2 * p * k, upper + int(((k - 1 - pos) * keep).sum())


def k6_split(fn, card, what):
    """Phase (b), K6: the device ms of its two kernels, the pack and the
    sweep, by their profiler names.  -> {'pack': ms, 'sweep': ms}."""
    by_name = device_ms_by_name(fn, 50)
    if EVENTS_KEY in by_name:
        print(f'(b) nms_sweep ({what}): pack and sweep not measured (no '
              f'profiler trace) [{card}]')
        return {'pack': None, 'sweep': None}
    split = {part: sum(ms for name, ms in by_name.items()
                       if f'nms_{part}_kernel' in name)
             for part in ('pack', 'sweep')}
    check(split['pack'] > 0 and split['sweep'] > 0,
          f'nms_sweep ({what}): the profiler saw no pack or no sweep kernel '
          f'({sorted(by_name)})')
    print(f'(b) nms_sweep ({what}): pack {split["pack"]:.4f} ms, sweep '
          f'{split["sweep"]:.4f} ms [{card}]')
    return split


def k6_matrix(case, k, thr, seed=0, p=K6_P):
    """(iou (p, k, k) f32, valid (p, k) bool) on the card, of one of K6's
    recorded cases: ``none suppressed`` (every IoU below thr),
    ``all suppressed`` (every IoU above: row 0 keeps alone), ``chain``
    (iou[i, i+1] above alone: every other row kept) or ``random`` (a
    uniform symmetric matrix; the mean of two U(0, 1))."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    u = torch.rand(p, k, k, device='cuda', generator=gen)
    valid = torch.ones(p, k, dtype=torch.bool, device='cuda')
    if case == 'none suppressed':
        iou = u * thr
    elif case == 'all suppressed':
        iou = 1.0 + u
    elif case == 'chain':
        iou = torch.zeros_like(u)
        i = torch.arange(k - 1, device='cuda')
        iou[:, i, i + 1] = 1.0
    else:
        iou = (u + u.transpose(1, 2)) / 2
    return iou.contiguous(), valid


def k6_expected(case, valid):
    """The keep mask a K6 case must give, where it is known (else None)."""
    pos = torch.arange(valid.shape[1], device=valid.device)
    return {'none suppressed': valid,
            'all suppressed': (pos == 0).expand_as(valid),
            'chain': (pos % 2 == 0).expand_as(valid)}.get(case)


def k6_cases(card):
    """Phase (b), recorded: K6 on :data:`K6_CASES`, each held exactly to
    its plain version (and to its known answer), timed, with its pack and
    sweep split and bound.  -> {case: its numbers}."""
    from mmdet3d_gaussian_tpu_torch.ops import nms
    out = {}
    for case, k, thr in K6_CASES:
        name = f'{case}, K={k}, thr={thr}'
        iou, valid = k6_matrix(case, k, thr)
        got = nms.suppress_sweep(iou, valid, thr)
        ref = nms.suppress_sweep_plain(iou, valid, thr)
        check(torch.equal(got, ref),
              f'nms_sweep ({name}) disagrees with its plain version')
        want = k6_expected(case, valid)
        check(want is None or torch.equal(ref, want),
              f'nms_sweep ({name}): the plain version is wrong')
        ms = device_ms(lambda: nms.suppress_sweep(iou, valid, thr), 50)
        b_ms, b_by = bound(*k6_work(valid, ref))
        kept = float(ref.float().mean())
        print(f'(b) nms_sweep ({name}): exact_equal=True kernel={ms:.4f} ms '
              f'kept share {kept:.4f} bound={b_ms:.4f} ms ({b_by}) [{card}]')
        out[name] = dict(ms=ms, bound_ms=b_ms, bound_by=b_by,
                         kept_share=kept, exact=True, split=k6_split(
                             lambda: nms.suppress_sweep(iou, valid, thr),
                             card, name))
        del iou
    return out


def k5_cull(boxes, out, ref, card, what):
    """Phase (b), K5: the share s of near pairs (``near_pairs_plain``, the
    kernel's cull predicate) and the spread of the boxes; fails unless the
    sizes are positive and both the plain IoU ``ref`` and the kernel's
    ``out`` are exactly 0 on every far pair.  -> the number of near
    pairs."""
    from mmdet3d_gaussian_tpu_torch.ops import rotated_iou
    near = rotated_iou.near_pairs_plain(boxes)
    n_near, total = int(near.sum()), near.numel()
    check(bool((boxes[..., 2:4] > 0).all()),
          f'rotated_iou {what}: a box size is not positive')
    far = ~near
    check(bool((ref[far] == 0).all()),
          f'rotated_iou {what}: the plain IoU is not 0 on a far pair')
    check(bool((out[far] == 0).all()),
          f'rotated_iou {what}: the kernel is not 0 on a far pair')
    q = torch.tensor([0.0, 0.05, 0.5, 0.95, 1.0], device=boxes.device)

    def quant(t):
        return '/'.join(f'{v:.3f}' for v in t.reshape(-1).quantile(q)
                        .tolist())
    ctr = boxes[..., :2] - boxes[..., :2].mean(1, keepdim=True)
    print(f'(b) rotated_iou {what}: near share s = {n_near / total:.6f} '
          f'({n_near} of {total} pairs; IoU > 0 on '
          f'{int((ref > 0).sum())}); w quantiles 0/5/50/95/100 % '
          f'{quant(boxes[..., 2])} m, h {quant(boxes[..., 3])} m, centre '
          f'distance from the problem mean {quant(ctr.norm(dim=-1))} m '
          f'[{card}]')
    return n_near


def k5_work(boxes, n_near):
    """(bytes, operations) the function needs on ``boxes`` with ``n_near``
    near pairs: each box read and each IoU written once; the polygon of
    the near pairs and the cull test of every pair."""
    p, k = boxes.shape[:2]
    return (boxes.numel() * 4 + p * k * k * 4,
            n_near * IOU_OPS_PER_PAIR + p * k * k * CULL_OPS_PER_PAIR)


def k5_bounds(r, out, boxes, card, note=''):
    """Phase (b), K5: the all-pairs bound (every pair in full, the bound of
    a design without the cull) beside the function's bound ``r['bound_ms']``
    (:func:`k5_work`), and the time to write the output alone
    (``zero_``)."""
    r['bound_all_pairs_ms'] = bound(k5_work(boxes, 0)[0],
                                    out.numel() * IOU_OPS_PER_PAIR)[0]
    r['zero_fill_ms'] = device_ms(out.zero_, 20)
    print(f'(b) rotated_iou bounds{note}: near pairs in full + cull '
          f'{r["bound_ms"]:.4f} ms ({r["bound_by"]}), all pairs in full '
          f'{r["bound_all_pairs_ms"]:.4f} ms; zero fill of '
          f'the {out.numel() * 4} output bytes {r["zero_fill_ms"]:.4f} ms '
          f'[{card}]')


def k5_boxes(case, seed=0, p=K5_P, k=K5_K):
    """(p, k, 5) f32 boxes of one of K5's recorded cases, from a seed:
    ``clustered``, k boxes around 64 object centres over the KITTI range
    (sigma 0.6 m; each object's class size and yaw, jittered), the
    candidates of a trained model; ``all near``, centres in a 0.5 m square
    and sides of at least 0.6 m, so every pair is near; ``none near``,
    centres on a 10 m grid, so only a box and itself are near (the cost of
    the cull and the write alone)."""
    gen = torch.Generator().manual_seed(seed)
    if case == 'clustered':
        sizes = torch.tensor([[3.9, 1.6], [0.8, 0.6], [1.76, 0.6]])
        n_obj = 64
        ctr = torch.rand(p, n_obj, 2, generator=gen) * torch.tensor(
            [69.12, 79.36]) - torch.tensor([0.0, 39.68])
        cls = torch.randint(0, 3, (p, n_obj), generator=gen)
        yaw = (torch.rand(p, n_obj, generator=gen) * 2 - 1) * math.pi
        obj = torch.randint(0, n_obj, (p, k), generator=gen)
        xy = (ctr.gather(1, obj[..., None].expand(-1, -1, 2))
              + 0.6 * torch.randn(p, k, 2, generator=gen))
        wh = (sizes[cls.gather(1, obj)]
              * torch.exp(0.1 * torch.randn(p, k, 2, generator=gen)))
        yaw = yaw.gather(1, obj) + 0.1 * torch.randn(p, k, generator=gen)
    else:
        if case == 'all near':
            xy = torch.tensor([35.0, 0.0]) + (
                torch.rand(p, k, 2, generator=gen) - 0.5) * 0.5
        else:
            n = torch.arange(k)
            xy = (10.0 * torch.stack([n % 32, n // 32], -1).float())
            xy = xy.expand(p, k, 2)
        wh = torch.rand(p, k, 2, generator=gen) * torch.tensor(
            [3.9, 1.4]) + 0.6
        yaw = (torch.rand(p, k, generator=gen) * 2 - 1) * math.pi
    return torch.cat([xy, wh, yaw[..., None]], -1).float().cuda()


def k5_cases(card):
    """Phase (b), recorded: K5 on the ``clustered``, ``all near`` and
    ``none near`` boxes (:func:`k5_boxes`), each held to its plain version
    within 1e-5 and exactly 0 on every far pair, with its device time and
    near share s.  -> {case: its numbers}."""
    from mmdet3d_gaussian_tpu_torch.ops import rotated_iou
    out = {}
    for case in ('clustered', 'all near', 'none near'):
        boxes = k5_boxes(case)
        got = rotated_iou.iou_bev_pairwise(boxes)
        ref = rotated_iou.iou_bev_pairwise_plain(boxes)
        err = float((got - ref).abs().max())
        check(err <= 1e-5, f'rotated_iou ({case}) disagrees with its plain '
              f'version: max_abs_err {err:.3g}')
        n_near = k5_cull(boxes, got, ref, card, case)
        if case == 'all near':
            check(n_near == got.numel(), 'all near: a pair is far')
        if case == 'none near':
            check(n_near == boxes.shape[0] * boxes.shape[1],
                  'none near: a pair of two boxes is near')
        del ref
        ms = device_ms(lambda: rotated_iou.iou_bev_pairwise(boxes), 20)
        b_ms, b_by = bound(*k5_work(boxes, n_near))
        s = n_near / got.numel()
        out[case] = dict(ms=ms, max_abs_err=err, near_share=s,
                         bound_ms=b_ms, bound_by=b_by)
        print(f'(b) rotated_iou ({case}): max_abs_err={err:.3g} (tol 1e-5) '
              f'kernel={ms:.4f} ms near share s = {s:.6f} '
              f'bound={b_ms:.4f} ms ({b_by}) [{card}]')
        k5_bounds(out[case], got, boxes, card, f' ({case})')
    return out


def splat_densities(feats, lin, ncell, card):
    """Phase (b), recorded: K2 on the predict's rows placed otherwise on the
    same canvas (no row; the rows packed at its front, so a few blocks
    hold them all; every 8th cell), equal to its plain version, timed
    beside ``zero_`` + ``index_copy_``."""
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    n, dev = int((lin < ncell).sum()), lin.device
    trash = torch.full_like(lin, ncell)
    step = torch.arange(n, dtype=torch.int32, device=dev)
    for name, ids in (('no row', trash),
                      ('rows packed at the front', torch.cat([step,
                                                              trash[n:]])),
                      ('every 8th cell', torch.cat([step * 8, trash[n:]]))):
        out = voxelize.bev_splat(feats, ids, ncell)
        check(torch.equal(out, voxelize.bev_splat_plain(feats, ids, ncell)),
              f'bev_splat disagrees with its plain version ({name})')
        live = ids < ncell
        lin_live, feats_live, canvas = ids[live].long(), feats[live], out
        ms = device_ms(lambda: voxelize.bev_splat(feats, ids, ncell), 20)
        lib = device_ms(lambda: canvas.zero_().index_copy_(0, lin_live,
                                                           feats_live), 20)
        print(f'(b) bev_splat, {name} ({int(live.sum())} rows): kernel '
              f'{ms:.4f} ms, zero_ + index_copy_ {lib:.4f} ms [{card}]')


def print_splat_plan(name, feats, ids, out, halves, card, note=''):
    """Phase (b): the grid and store width the splat runs with on this
    card, and its blocks' runs over ``ids`` (``voxelize.splat_runs``): the
    most key rows and rows a block takes, and the largest block cost
    (half-rows written plus rows read) against the mean."""
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    plan = voxelize.splat_plan(feats, out, halves)
    first, below = voxelize.splat_runs(ids, out.shape[0], halves,
                                       plan['grid'])
    keys, got = first.diff(), below.diff()
    cost = halves * keys + got
    print(f'(b) {name} plan ({feats.dtype}, {tuple(out.shape)} canvas'
          f'{note}): grid {plan["grid"]} blocks, {plan["tiles"]} tiles of '
          f'256 half-rows, {plan["vector_bytes"]}-byte stores, slot width '
          f'shift {plan["shift"]}; runs cut by cost at key rows: at most '
          f'{int(keys.max())} key rows and {int(got.max())} rows a block, '
          f'largest block cost / mean '
          f'{float(cost.max() / cost.float().mean()):.4f} [{card}]')


def check_yardstick(results, name, note, kernel, library, card,
                    rounds=YARDSTICK_ROUNDS):
    """Phase (b): a splat must be no slower than ``zero_`` +
    ``index_copy_`` on the same inputs.  The two are timed in turns
    (kernel, yardstick, yardstick, kernel, ...; ``rounds`` device-time
    passes of 20 calls each) and compared by their medians, so that a drift
    of the card's clocks between two passes does not decide; the medians
    become the entry's ``ms`` and ``library_ms``."""
    times = {'ms': [], 'library_ms': []}
    fns = (('ms', kernel), ('library_ms', library))
    for r in range(rounds):
        for key, fn in (fns if r % 2 == 0 else fns[::-1]):
            times[key].append(device_ms(fn, 20))
    res = results[name]
    res.update({k: statistics.median(v) for k, v in times.items()})
    print(f'(b) {name}{note}: kernel {res["ms"]:.4f} ms, zero_ + '
          f'index_copy_ {res["library_ms"]:.4f} ms (medians of {rounds} '
          f'passes in turns) [{card}]')
    check(res['ms'] <= res['library_ms'],
          f'{name}{note}: {res["ms"]:.4f} ms, slower than zero_ + '
          f'index_copy_ ({res["library_ms"]:.4f} ms)')


def falloff_cells(n, trunk, seed=0):
    """``n`` distinct cells of the batch-``BATCH`` BEV canvas of ``trunk``
    (sorted linear ids ``(b * ny + iy) * nx + ix``), drawn without
    replacement with weight 1 / r^2, r the distance of the cell's centre
    from the sensor (the origin of the point-cloud frame; at least one
    cell): a LiDAR sweep's density falling with range."""
    nx, ny = trunk.nx, trunk.ny
    vx, vy = trunk.voxel_size[:2]
    x0, y0 = trunk.point_cloud_range[:2]
    x = x0 + (torch.arange(nx, device='cuda') + 0.5) * vx
    y = y0 + (torch.arange(ny, device='cuda') + 0.5) * vy
    r2 = (x[None, :] ** 2 + y[:, None] ** 2).clamp(min=vx * vy)
    gen = torch.Generator(device='cuda').manual_seed(seed)
    cells = torch.multinomial((1 / r2).reshape(-1).repeat(BATCH), n,
                              replacement=False, generator=gen)
    return cells.sort().values


def falloff_ids(n, v, ncell, trunk):
    """The ids of ``v`` rows, ``n`` of them live at :func:`falloff_cells`
    and the rest past the canvas: (K2's cell ids on the ``ncell`` plain
    canvas; K7's paired-cell ids and parities on the s2d canvas of the same
    cells), int32."""
    cells = falloff_cells(n, trunk)
    nx, ny = trunk.nx, trunk.ny
    b, rem = cells // (nx * ny), cells % (nx * ny)
    iy, ix = rem // nx, rem % nx
    parity = (iy % 2) * 2 + ix % 2
    half = ((b * (ny // 2) + iy // 2) * (nx // 2) + ix // 2) * 4 + parity
    half = half.sort().values                  # half-row ids 2 lin2 + par
    ncell2 = ncell // 2
    pad = v - n
    k2_ids = torch.cat([cells, torch.full((pad,), ncell, device='cuda')])
    lin2 = torch.cat([half // 2, torch.full((pad,), ncell2, device='cuda')])
    par = torch.cat([half % 2, torch.zeros(pad, device='cuda',
                                           dtype=torch.long)])
    return k2_ids.int(), lin2.int(), par.int()


def splat_falloff(k2_inputs, trunk, card):
    """Phase (b): K2 and K7, f32 and bf16, on the predict's rows placed at
    cells whose density falls as 1 / r^2 from the sensor
    (:func:`falloff_cells`, the K7 ids the same cells on the s2d canvas):
    equal to their plain versions, and no slower than ``zero_`` +
    ``index_copy_``."""
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    feats, lin, ncell = k2_inputs
    k2_ids, lin2, par = falloff_ids(int((lin < ncell).sum()), lin.shape[0],
                                    ncell, trunk)
    ncell2 = ncell // 2
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        rows = feats.to(dtype)
        note = f' ({str(dtype)[6:]}, density 1/r^2)'
        out = voxelize.bev_splat(rows, k2_ids, ncell)
        check(torch.equal(out, voxelize.bev_splat_plain(rows, k2_ids, ncell)),
              f'bev_splat disagrees with its plain version{note}')
        live = k2_ids < ncell
        lin_live, rows_live = k2_ids[live].long(), rows[live]
        results['bev_splat'] = {}
        print_splat_plan('bev_splat', rows, k2_ids, out, 1, card, note)
        check_yardstick(
            results, 'bev_splat', note,
            lambda: voxelize.bev_splat(rows, k2_ids, ncell),
            lambda: out.zero_().index_copy_(0, lin_live, rows_live), card)
        out = voxelize.bev_splat_pairs(rows, lin2, par, ncell2)
        check(torch.equal(out, voxelize.bev_splat_pairs_plain(
            rows, lin2, par, ncell2)),
            f'bev_splat_pairs disagrees with its plain version{note}')
        ids = voxelize.pair_rows(lin2, par, ncell2)[live]
        half_rows = out.view(2 * ncell2, -1)
        results['bev_splat_pairs'] = {}
        print_splat_plan('bev_splat_pairs', rows, lin2, out, 2, card, note)
        check_yardstick(
            results, 'bev_splat_pairs', note + ' (yardstick on the half-row '
            'view)',
            lambda: voxelize.bev_splat_pairs(rows, lin2, par, ncell2),
            lambda: half_rows.zero_().index_copy_(0, ids, rows_live), card)


def splat_pairs_check(results, args, card, note):
    """K7 on one predict's arguments: equal to its plain version; timed,
    with ``zero_`` + ``index_copy_`` on the half-row view as its
    yardstick."""
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    feats, lin2, par, ncell2 = args
    out = voxelize.bev_splat_pairs(feats, lin2, par, ncell2)
    ref = voxelize.bev_splat_pairs_plain(feats, lin2, par, ncell2)
    err = float((out.float() - ref.float()).abs().max())
    exact = bool(torch.equal(out, ref))
    c, esize = feats.shape[1], feats.element_size()
    live = lin2 < ncell2
    both = int((live[1:] & (lin2[1:] == lin2[:-1])).sum())
    print(f'(b) bev_splat_pairs inputs{note}: {feats.shape[0]} rows x {c} '
          f'{feats.dtype} ({int(live.sum())} live; {both} paired cells '
          f'with both parities) onto {ncell2} x {2 * c}')
    ids, rows_live = voxelize.pair_rows(lin2, par, ncell2)[live], feats[live]
    canvas = torch.zeros_like(ref)
    half_rows = canvas.view(2 * ncell2, c)
    k7 = lambda: voxelize.bev_splat_pairs(  # noqa: E731
        feats, lin2, par, ncell2)
    lib = lambda: half_rows.zero_().index_copy_(  # noqa: E731
        0, ids, rows_live)
    report(results, 'bev_splat_pairs', card, err, '0, equal',
           exact and err == 0, k7,
           lambda: voxelize.bev_splat_pairs_plain(feats, lin2, par, ncell2),
           lib, 50, 10, feats.numel() * esize + 2 * lin2.numel() * 4
           + ncell2 * 2 * c * esize, 0, f' exact_equal={exact}{note}')
    check(torch.equal(canvas, ref), 'index_copy_ yardstick disagrees')
    print_splat_plan('bev_splat_pairs', feats, lin2, out, 2, card)
    check_yardstick(results, 'bev_splat_pairs', note, k7, lib, card)


def bf16_kernel_checks(pred_inputs, train_inputs, k2_inputs, card):
    """Phase (b) on the bf16 paths: K7 on the inputs of one full-width
    bf16 predict (timed) and of one bf16 dense-target train step; K1, K5
    and K6 on the bf16 predict's inputs; K1 winner, K3 and K4 on the bf16
    step's; K2 on the f32 predict's rows cast to bf16 (what the plain
    canvas gets in bf16).  -> (K7's numbers, {kernel: its numbers on the
    bf16 paths})."""
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    results, bf16 = {}, {}
    check(all(args[0].dtype == torch.bfloat16
              for args in train_inputs['bn_moments']),
          'K4 did not read bf16 activations in the bf16 train step')
    ((feats, lin2, par, ncell2),) = train_inputs['bev_splat_pairs']
    out = voxelize.bev_splat_pairs(feats, lin2, par, ncell2)
    exact = bool(torch.equal(
        out, voxelize.bev_splat_pairs_plain(feats, lin2, par, ncell2)))
    print(f'(b) bev_splat_pairs on the bf16 train step: {feats.shape[0]} '
          f'rows x {feats.shape[1]} {feats.dtype} onto {ncell2} x '
          f'{2 * feats.shape[1]}; exact_equal={exact}')
    check(exact, 'K7 disagrees with its plain version on the train step')
    check(pred_inputs['bev_splat_pairs'][0].dtype == torch.bfloat16,
          'the bf16 predict splat f32 rows')
    splat_pairs_check(results, pred_inputs['bev_splat_pairs'], card,
                      ' (bf16 predict)')

    # K2 in bf16 on the plain canvas
    feats, lin, ncell = k2_inputs
    f16 = feats.bfloat16()
    out = voxelize.bev_splat(f16, lin, ncell)
    ref = voxelize.bev_splat_plain(f16, lin, ncell)
    exact = bool(torch.equal(out, ref))
    live = lin < ncell
    lin_live, f16_live = lin[live].long(), f16[live]
    canvas16 = torch.zeros_like(ref)
    k2 = lambda: voxelize.bev_splat(f16, lin, ncell)  # noqa: E731
    lib = lambda: canvas16.zero_().index_copy_(  # noqa: E731
        0, lin_live, f16_live)
    report(bf16, 'bev_splat', card, float((out.float() - ref.float()).abs()
                                            .max()), '0, equal', exact,
           k2, lambda: voxelize.bev_splat_plain(f16, lin, ncell), lib,
           50, 10, f16.numel() * 2 + lin.numel() * 4
           + ncell * f16.shape[1] * 2, 0, f' exact_equal={exact} (bf16)')
    print_splat_plan('bev_splat', f16, lin, out, 1, card)
    check_yardstick(bf16, 'bev_splat', ' (bf16)', k2, lib, card)
    bf16.update(kernel_checks(pred_inputs, card, ' (bf16 predict)'))
    bf16.update(train_kernel_checks(train_inputs, card,
                                    ' (bf16 dense step)'))
    bf16_bn_eval(train_inputs['bn_moments'][0][0], card)
    return results, bf16


def bf16_bn_eval(x, card):
    """The port's bf16 eval BatchNorm (FastBatchNorm's formula, written
    out) against cuDNN's bf16 inference BatchNorm, on one bf16 activation
    of the train step with random statistics: how many outputs round
    differently.  Recorded, not checked."""
    from mmdet3d_gaussian_tpu_torch.models.backbones import BatchNorm2d
    c = x.shape[1]
    gen = torch.Generator(device=x.device).manual_seed(0)
    bn = BatchNorm2d(c, eps=1e-3).to(x.device).eval()
    with torch.no_grad():
        for t, lo, hi in ((bn.running_mean, -1.0, 1.0),
                          (bn.running_var, 0.5, 2.0), (bn.weight, 0.5, 1.5),
                          (bn.bias, -0.5, 0.5)):
            t.copy_(torch.rand(c, device=x.device, generator=gen)
                    * (hi - lo) + lo)
        ours = bn(x)
        cudnn = torch.nn.functional.batch_norm(
            x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False,
            0.0, bn.eps)
    differ = float((ours != cudnn).float().mean())
    err = float(((ours.float() - cudnn.float()).abs()
                 / ours.float().abs().clamp(min=1e-30)).max())
    print(f'(b) bf16 eval BatchNorm, {tuple(x.shape)}: the written-out '
          f'formula and cuDNN round {differ:.4%} of the outputs differently '
          f'(largest relative difference {err:.3g}) [{card}]')


def tiny_batch(seed, dev, hard=False):
    """The TINY phases' batch: ``synthetic_batch`` (2 x 1,024 points), or
    for the hard paths ``crowded_batch`` (2 x 2,048, seed TINY_HARD_SEED),
    so that hard voxelize truncates pillars and drops pillars on the
    card."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import (crowded_batch,
                                                            synthetic_batch)
    if hard:
        return crowded_batch(2, 2048, 8, seed=TINY_HARD_SEED,
                             pc_range=TINY_MODEL['point_cloud_range'],
                             voxel_size=TINY_MODEL['voxel_size'], device=dev)
    return synthetic_batch(2, 1024, 8, seed=seed,
                           pc_range=TINY_MODEL['point_cloud_range'],
                           device=dev)


def tiny_card_vs_cpu(card, cfg=TINY_F32, hard=False, tag=None,
                     detector=None, head=TINY_HEAD, batch_fn=None):
    """Phase (c): the same seeded TINY detector on the card and the CPU
    (``detector``: its class, PointPillarsDetector by default; ``batch_fn``
    (seed, device) -> batch, :func:`tiny_batch` by default)."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import PointPillarsDetector
    tag = tag or ('TINY hard' if hard else 'TINY')
    detector = detector or PointPillarsDetector
    batch_fn = batch_fn or (lambda seed, dev: tiny_batch(seed, dev, hard))
    outs = {}
    for dev in ('cuda', 'cpu'):
        det = detector(cfg, head, device=dev, seed=1)
        with torch.no_grad():
            det.trunk.bbox_head.conv_cls.bias.zero_()
        batch = batch_fn(3, dev)
        if hard:
            with torch.inference_mode():
                sc = det.trunk.pillars(batch['points'],
                                       batch['points_mask'])[2]
            check(int(sc.num_overflow) > 0
                  and int(sc.voxel_counts.max())
                  > cfg['max_points_per_voxel'],
                  'the hard TINY batch neither drops nor truncates')
        maps = [m.cpu() for m in det.apply_eval(batch)]
        dets = [d.cpu() for d in det.predict(batch)]
        outs[dev] = (maps, dets)
    anchors = det.anchors.reshape(-1, 7)
    (gm, gd), (cm, cd) = outs['cuda'], outs['cpu']
    map_err = max(float((a - b).abs().max()) for a, b in zip(gm, cm))
    valid_eq = torch.equal(gd[3], cd[3])
    labels_eq = valid_eq and torch.equal(gd[2][gd[3]], cd[2][cd[3]])
    print(f'(c) {tag} predict card vs CPU: head-map max_abs_err='
          f'{map_err:.3g} (tol {MAP_TOL:g}) valid_equal={valid_eq} '
          f'labels_equal={labels_eq} valid={int(gd[3].sum())} [{card}]')
    check(map_err <= MAP_TOL, f'{tag} head maps differ between card and CPU')
    check(valid_eq and labels_eq, f'{tag} detections differ')
    check(int(gd[3].sum()) > 0, f'{tag} predict kept no detection')
    ref = cd[0][cd[3]][:, :7]
    diff = (gd[0][gd[3]][:, :7] - ref).abs()
    diag = float(torch.sqrt(anchors[:, 3] ** 2 + anchors[:, 4] ** 2).max())
    height = float(anchors[:, 5].max())
    deriv = torch.stack([torch.full_like(ref[:, 0], diag),
                         torch.full_like(ref[:, 0], diag),
                         height + ref[:, 5].abs() / 2,
                         ref[:, 3].abs(), ref[:, 4].abs(), ref[:, 5].abs(),
                         torch.ones_like(ref[:, 0])], -1)
    tol = MAP_TOL * deriv + ROUND_TOL * ref.abs()
    for col, name in enumerate(('x', 'y', 'z', 'w', 'l', 'h', 'yaw')):
        i = int(diff[:, col].argmax())
        print(f'(c) {tag} box {name}: max_abs_err='
              f'{float(diff[i, col]):.3g} at |box|='
              f'{float(ref[i, col].abs()):.4g}, tol there '
              f'{float(tol[i, col]):.3g}; largest err/tol '
              f'{float((diff[:, col] / tol[:, col]).max()):.3g}')
    score_err = float((gd[1][gd[3]] - cd[1][cd[3]]).abs().max())
    print(f'(c) {tag} scores max_abs_err={score_err:.3g} (tol 1e-5) '
          f'[{card}]')
    check(bool((diff <= tol).all()), f'{tag} boxes differ')
    check(score_err <= 1e-5, f'{tag} scores differ')


def tiny_predict(cfg, dev, hard=False):
    """Head maps and detections of the TINY detector (seed 1, zero cls
    bias) on ``dev``."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import PointPillarsDetector
    det = PointPillarsDetector(cfg, TINY_HEAD, device=dev, seed=1)
    with torch.no_grad():
        det.trunk.bbox_head.conv_cls.bias.zero_()
    batch = tiny_batch(3, dev, hard)
    return dict(maps=[m.cpu() for m in det.apply_eval(batch)],
                dets=[d.cpu() for d in det.predict(batch)])


def tiny_step(cfg, dev, sums=None, hard=False):
    """One TINY train step (seed 2) on ``dev``: loss terms, parameter
    gradients and the output of every leaf module in its forward (in call
    order).  ``sums``: an empty list, which the forward BatchNorm sums of
    the step (K4's ``moments`` on the card, in call order; on the hard
    paths the pillar encoder's ``masked_sums`` too) are appended to; or
    such a list, filled, whose sums then stand in for the step's own."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import PointPillarsDetector
    from mmdet3d_gaussian_tpu_torch.models import voxel_encoders
    from mmdet3d_gaussian_tpu_torch.ops import bn
    det = PointPillarsDetector(cfg, TINY_HEAD, device=dev, seed=2)
    batch = tiny_batch(0, dev, hard)
    acts, originals = {}, {}
    replay = iter(list(sums)) if sums else None

    def keep(name):
        def hook(_mod, _inp, out):
            if isinstance(out, torch.Tensor):
                acts[name] = out.detach().cpu()
        return hook

    def moments(x):
        if replay is None:
            out = originals['moments'](x)
            sums.append(tuple(o.cpu() for o in out))
            return out
        out = next(replay)
        check(out[0].shape == x.shape[1:2], 'replayed BatchNorm sums out of '
              'step')
        return out

    def masked_sums(flat, mask=None):
        # the encoder's statistics are differentiated through: a replayed
        # sum keeps the gradient of the run's own
        out = originals['masked_sums'](flat, mask)
        if replay is None:
            sums.append(tuple(torch.as_tensor(o).detach().cpu()
                              for o in out))
            return out
        card = next(replay)
        check(card[1].shape == flat.shape[1:2], 'replayed encoder sums out '
              'of step')
        return tuple(o + (c - o).detach() for o, c in zip(out, card))
    hooks = [m.register_forward_hook(keep(n))
             for n, m in det.trunk.named_modules()
             if n and not list(m.children())]
    if sums is not None:
        originals['moments'] = bn.moments
        bn.moments = moments
        if hard:
            originals['masked_sums'] = voxel_encoders.masked_sums
            voxel_encoders.masked_sums = masked_sums
    try:
        total, losses = det.loss(det.apply_train(batch), batch)
        params = dict(det.trunk.named_parameters())
        grads = torch.autograd.grad(total, list(params.values()))
    finally:
        for h in hooks:
            h.remove()
        for name, fn in originals.items():
            setattr(voxel_encoders if name == 'masked_sums' else bn, name,
                    fn)
    check(replay is None or next(replay, None) is None,
          'replayed BatchNorm sums left over')
    return dict(acts=acts,
                losses={k: float(v.detach()) for k, v in losses.items()},
                grads={k: g.cpu() for k, g in zip(params, grads)})


def rel(a, b):
    """max |a - b| / max |b| (losses: |a - b| / |b|)."""
    if isinstance(b, float):
        return abs(a - b) / abs(b)
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def against(got, ref, f32):
    """[(what, error, gap)]: each head map, loss term and parameter
    gradient of the run ``got`` against the bf16 run ``ref``, and ``ref``'s
    own distance from the f32 run ``f32``, measured the same way (runs:
    (predict, step) pairs)."""
    rows = [(f'map {i}', rel(a, b), rel(f, b)) for i, (a, b, f) in
            enumerate(zip(got[0]['maps'], ref[0]['maps'], f32[0]['maps']))]
    for kind in ('losses', 'grads'):
        rows += [(k, rel(got[1][kind][k], b), rel(f32[1][kind][k], b))
                 for k, b in ref[1][kind].items()]
    return rows


def ratios(rows):
    return [e / max(g, 1e-30) for _, e, g in rows]


def tiny_bf16_card_vs_cpu(card, cfg16=TINY_BF16, cfg32=TINY_MODEL,
                          hard=False):
    """Phase (c) in bf16: the TINY detector in bf16 (s2d canvas, through
    ``'auto'``) on the card against bf16 on the CPU.

    In a bf16 train step every BatchNorm rounds its output to bf16 from f32
    batch statistics.  K4 sums in another order than the CPU, so a few
    outputs of the first BatchNorm round the other way, and the statistics
    of each later BatchNorm carry that on, until card and CPU differ about
    as much as bf16 from f32 (printed).  (The backward's sums do not carry
    on so: nothing there is normalized again.)  So the CPU's bf16 step is
    run with the card's forward BatchNorm sums (K4 is held to its plain
    version in (b)), and
    every head map (predict), loss term and gradient of the card must be
    nearer to it than GAP_SHARE of its distance from the CPU's f32 step, and
    within BF16_MAP_TOL.  The same procedure from the card's f32 run must
    fail that rule: it is what a path that skipped its casts would give.
    On the hard paths (``hard``: the TINY hard model on the crowded batch)
    the pillar encoder's BatchNorm sums are replayed too: its bf16 linear
    layer's output is normalized with them."""
    tag = 'TINY hard bf16' if hard else 'TINY bf16'
    runs, sums16, sums32 = {}, [], []
    for name, cfg, dev, sums in (
            ('card', cfg16, 'cuda', sums16),
            ('card_f32', cfg32, 'cuda', sums32),
            ('cpu', cfg16, 'cpu', None),
            ('cpu_f32', cfg32, 'cpu', None),
            ('cpu_card_sums', cfg16, 'cpu', sums16),
            ('cpu_card_f32_sums', cfg16, 'cpu', sums32)):
        runs[name] = (runs['cpu'][0] if name.startswith('cpu_card')
                      else tiny_predict(cfg, dev, hard),
                      tiny_step(cfg, dev, sums, hard))
    g16, c16 = runs['card'], runs['cpu']
    check(all(m.dtype == torch.bfloat16 for m in g16[0]['maps']
              + c16[0]['maps']), 'maps not bf16')
    gd = g16[0]['dets']
    check(int(gd[3].sum()) > 0 and bool(torch.isfinite(gd[0]).all()),
          f'{tag} predict kept no finite detection')
    print(f'(c) {tag} detections: {int(gd[3].sum())} valid on the card, '
          f'{int(c16[0]["dets"][3].sum())} on the CPU')
    for ref, what in (('cpu', 'its own sums'),
                      ('cpu_card_sums', "the card's BatchNorm sums")):
        acts = runs[ref][1]['acts']
        differ = [(n, rel(a, acts[n]), float((a != acts[n]).float().mean()))
                  for n, a in g16[1]['acts'].items()]
        shown = [d for d in differ if d[1] > 0]
        shown = shown[:3] + shown[-1:] if len(shown) > 4 else shown
        print(f'(c) {tag} train forward, card vs CPU with {what}: '
              f'{sum(d[1] == 0 for d in differ)} of {len(differ)} leaf '
              f'outputs equal; of the others, first and last (max error / '
              f'largest value, share of elements that differ): '
              + '; '.join(f'{n} {e:.3g} {sh:.3g}' for n, e, sh in shown))
    plain = against(g16, c16, runs['cpu_f32'])
    top = max(plain, key=lambda r: r[1])
    print(f'(c) {tag} card vs CPU with its own BatchNorm sums (recorded, '
          f'not checked): error / (CPU bf16 vs CPU f32 gap) up to '
          f'{max(ratios(plain)):.3g}, median '
          f'{statistics.median(ratios(plain)):.3g} over {len(plain)} values; '
          f'largest error {top[1]:.3g} at {top[0]} (gap {top[2]:.3g})')
    rows = against(g16, runs['cpu_card_sums'], runs['cpu_f32'])
    for kind, sel in (('head maps', lambda r: r[0].startswith('map')),
                      ('loss terms', lambda r: r[0] in c16[1]['losses']),
                      ('gradients', lambda r: r[0] in c16[1]['grads'])):
        part = sorted((r for r in rows if sel(r)),
                      key=lambda r: -r[1] / max(r[2], 1e-30))
        print(f'(c) {tag} {kind}, card vs CPU bf16 with the card\'s '
              f'BatchNorm sums (error, CPU bf16 vs f32 gap, ratio; limit '
              f'{GAP_SHARE:g}), largest ratios: '
              + '; '.join(f'{n} {e:.3g} {g:.3g} {e / max(g, 1e-30):.3g}'
                          for n, e, g in part[:3]) + f' [{card}]')
    mutant = ratios(against(runs['card_f32'], runs['cpu_card_f32_sums'],
                            runs['cpu_f32']))
    print(f'(c) {tag}: f32 on the card by the same procedure: ratios from '
          f'{min(mutant):.3g} to {max(mutant):.3g} over {len(mutant)} values '
          f'(each must reach {GAP_SHARE:g})')
    bad = [r for r in rows if not r[1] < GAP_SHARE * r[2]
           or (not r[0] in c16[1]['grads'] and r[1] > BF16_MAP_TOL)]
    check(not bad, f'{tag} card and CPU differ: {bad[:5]}')
    check(min(mutant) >= GAP_SHARE,
          'the bf16 rule passes the card f32 run: it cannot see a missing '
          'cast')


def capture_train_inputs(det, batch, state, per_step):
    """Run one train step with the train-path kernel wrappers wrapped to
    record every call's arguments (K4: all 19 BatchNorms, forward and
    backward; K1 winner; K3 forward and backward; K7); each kernel must be
    called as often as ``per_step`` says."""
    from mmdet3d_gaussian_tpu_torch.ops import bn, gd_loss, scatter, voxelize
    patches = [(bn, 'moments', 'bn_moments'),
               (bn, 'grad_moments', 'bn_grad_moments'),
               (scatter, 'segment_max_winner', 'segment_max_winner'),
               (gd_loss, 'gd_loss_fwd', 'gd_loss_fwd'),
               (gd_loss, 'gd_loss_bwd', 'gd_loss_bwd'),
               (voxelize, 'bev_splat_pairs', 'bev_splat_pairs')]
    out = []
    seen = record_calls(
        lambda: out.append(det.train_step(batch, state)[0]), patches)
    got = {k: len(v) for k, v in seen.items()}
    want = {k: n for k, n in per_step.items() if n}
    check(got == want, f'train step called {got}, want {want}')
    return seen, out[0]


def check_k4(results, inputs, card, note=''):
    """K4 on every BatchNorm of one train step (the calls recorded in
    ``inputs``), f32 or bf16 activations: f32 sums in another order, each
    held to 1e-5 of the per-channel sum of magnitudes; times, bytes and
    bound summed over the step's calls."""
    from mmdet3d_gaussian_tpu_torch.ops import bn

    def rows_of(t):
        return bn._channels_last_2d(t).float()

    def lib_bwd(g, x, mean, inv):
        return torch.batch_norm_backward_reduce(g, x, mean, inv, None, True,
                                                False, False)

    for name in ('bn_moments', 'bn_grad_moments'):
        calls = inputs[name]
        fwd = name == 'bn_moments'
        kern = bn.moments if fwd else bn.grad_moments
        plain = bn.moments_plain if fwd else bn.grad_moments_plain
        err = rel = 0.0
        bytes_ = ops = 0
        shapes, paths, sizes = [], [], []
        for args in calls:
            x = args[0] if fwd else args[1]
            m, cc = rows_of(x).shape
            shapes.append(f'{m}x{cc}')
            paths.append(bn.kernel_plan(x, None if fwd else args[0]).path)
            got, want = kern(*args), plain(*args)
            check(all(all(torch.equal(a, b) for a, b in zip(got, kern(*args)))
                      for _ in range(2)),
                  f'{name}: repeated launches differ')
            if fwd:
                mags = (rows_of(x).abs().sum(0), (rows_of(x) ** 2).sum(0))
            else:
                g, _, mean, inv = args
                xhat = (rows_of(x) - mean) * inv
                mags = (rows_of(g).abs().sum(0),
                        (rows_of(g) * xhat).abs().sum(0))
            check(all(a.dtype == torch.float32 for a in got),
                  f'{name} sums not f32')
            for a, b, mag in zip(got, want, mags):
                err = max(err, float((a - b).abs().max()))
                rel = max(rel, float(((a - b).abs() / mag.clamp(
                    min=1e-30)).max()))
            call_bytes = (1 if fwd else 2) * m * cc * x.element_size() \
                + (2 if fwd else 4) * cc * 4
            sizes.append((call_bytes, args))
            bytes_ += call_bytes
            ops += (2 if fwd else 4) * m * cc
        dtype = str(calls[0][0].dtype).replace('torch.', '')
        print(f'(b) {name}{note}: {len(calls)} calls of one step, {dtype} '
              f'rows x channels {shapes}; max error / per-channel sum of '
              f'magnitudes {rel:.3g}; bitwise equal over 3 launches each')
        print(f'(b) {name}{note}: path per call {paths}')
        check(all(p.endswith('-vector') for p in paths),
              f'{name}: a main-path call took a scalar path')
        sizes.sort(key=lambda s: s[0])
        for what, (nbytes, args) in (('largest', sizes[-1]),
                                     ('smallest', sizes[0])):
            x = args[0] if fwd else args[1]
            t, n_copies = cold_ms(kern, args, 50)
            b_ms = bound(nbytes, 0)[0]
            print(f'(b) {name}{note}: {what} call {tuple(x.shape)}: '
                  f'{t:.4f} ms, bound {b_ms:.4f} ms ({t / b_ms:.2f}x; inputs '
                  f'in turn from {n_copies} copies, over twice the L2) '
                  f'[{card}]')

        def lib(fwd=fwd, calls=calls):
            for args in calls:
                if fwd:
                    torch.batch_norm_stats(args[0], BN_EPS)
                else:
                    lib_bwd(*args)
        report(results, name, card, err, '1e-5 of the sum of magnitudes',
               rel <= 1e-5, lambda k=kern, c=calls: [k(*a) for a in c],
               lambda p=plain, c=calls: [p(*a) for a in c], lib, 20, 3,
               bytes_, ops, f' ({dtype}; times, bytes and bound summed over '
               f'the step){note}')


def train_kernel_checks(inputs, card, note=''):
    """Phase (b), train kernels, on the inputs of one full-width dense
    train step.  K4's numbers are sums over the step's 19 calls."""
    from mmdet3d_gaussian_tpu_torch.ops import gd_loss, segment
    results = {}

    # K1 winner form, where the step ran it (the dynamic encoder): the
    # final per-voxel max (64 channels) and its per-row winner mask
    if 'segment_max_winner' in inputs:
        ((data, ids, starts, counts),) = inputs['segment_max_winner']
        out, mask = segment.segment_max_winner(data, ids, starts, counts)
        ref, ref_m = segment.segment_max_winner_plain(data, ids, starts,
                                                      counts)
        exact = bool(torch.equal(out, ref) and torch.equal(mask, ref_m))
        report(results, 'segment_max_winner', card,
               float((out - ref).abs().max()), '0, masks equal', exact,
               lambda: segment.segment_max_winner(data, ids, starts, counts),
               lambda: segment.segment_max_winner_plain(data, ids, starts,
                                                        counts), None,
               200, 5, *k1_work('winner', data, ids, starts, counts),
               f' exact_equal={exact}{note}')
        check_k1_path('segment_max_winner', data, note)
        cold_warm(results, 'segment_max_winner', segment.segment_max_winner,
                  (data, ids, starts, counts), card, note, 200)

    check_k4(results, inputs, card, note)

    # K3: the dense decoded-box GD loss and its d(pred)
    ((pred2, tgt2, w_a, anc2, hw, cfg),) = inputs['gd_loss_fwd']
    ((gout, *_),) = inputs['gd_loss_bwd']
    work, (n_pos, n_neg) = k3_work(pred2, w_a)
    print(f'(b) gd_loss inputs{note}: {pred2.shape[0]} rows x '
          f'{pred2.shape[1] // 7} anchors, config {cfg}, {n_pos} anchors '
          f'with weight > 0, {n_neg} with weight < 0, box map {pred2.dtype}')
    check(n_pos > 0, 'no positive anchor in the dense step')
    check(pred2.dtype == torch.float32, 'K3 was given a non-f32 box map')
    args = (tgt2, w_a, anc2, hw, cfg)
    got = gd_loss.gd_loss_fwd(pred2, *args)
    want = gd_loss.anchor_gd_loss_plain(pred2, *args)
    err = abs(float(got) - float(want))
    check(all(torch.equal(gd_loss.gd_loss_fwd(pred2, *args), got)
              for _ in range(10)), 'K3 forward is not bitwise repeatable')
    report(results, 'gd_loss_fwd', card, err, '1e-5 relative',
           err <= 1e-5 * abs(float(want)),
           lambda: gd_loss.gd_loss_fwd(pred2, *args),
           lambda: gd_loss.anchor_gd_loss_plain(pred2, *args), None, 50, 5,
           *work['fwd'], note)
    dgot = gd_loss.gd_loss_bwd(gout, pred2, *args)
    dwant = gd_loss.gd_loss_bwd_plain(gout, pred2, *args)
    diff = (dgot - dwant).abs()
    report(results, 'gd_loss_bwd', card, float(diff.max()),
           '5e-6 + 1e-4 |plain|', bool((diff <= 5e-6 + 1e-4 * dwant.abs())
                                        .all()),
           lambda: gd_loss.gd_loss_bwd(gout, pred2, *args),
           lambda: gd_loss.gd_loss_bwd_plain(gout, pred2, *args), None, 50,
           5, *work['bwd'], note)
    cold_warm(results, 'gd_loss_fwd', gd_loss.gd_loss_fwd, (pred2, *args),
              card, note)
    cold_warm(results, 'gd_loss_bwd', gd_loss.gd_loss_bwd,
              (gout, pred2, *args), card, note)
    # the floor of the backward: writing its (M, A*7) output once
    dz = torch.empty(pred2.shape, dtype=torch.float32, device=pred2.device)
    zero_ms = results['gd_loss_bwd']['zero_fill_ms'] = device_ms(dz.zero_,
                                                                 50)
    print(f'(b) gd_loss_bwd{note}: zero_ of its {tuple(dz.shape)} f32 output '
          f'{zero_ms:.4f} ms [{card}]')
    return results


def tiny_train_card_vs_cpu(card, cfg=TINY_F32, hard=False, head=TINY_HEAD,
                           tag=None, detector=None, batch_fn=None):
    """Phase (c): one TINY train step (sparse targets) from the same seed,
    weights and batch on the card and on the CPU: loss terms, every
    parameter gradient, and after the AdamW step the running statistics,
    Adam's moments and the weights.

    Adam's first step moves a weight by lr * (g / (|g| + eps) + wd * w):
    about lr whatever |g|, so where g is near 0 a tiny gradient difference
    may move the weight either way.  The weights are therefore held tightly
    only where |mu| (the clipped gradient times 1 - b1) is at least 1e-2 of
    its parameter's largest, far above the gradient tolerance, so card and
    CPU agree on its sign; there a sign flip or a dropped update (lr apart)
    fails a tolerance of 1e-2 lr.  ``detector`` and ``batch_fn`` as in
    :func:`tiny_card_vs_cpu`.  -> the card's gradients."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import PointPillarsDetector
    tag = tag or ('TINY hard' if hard else 'TINY')
    detector = detector or PointPillarsDetector
    batch_fn = batch_fn or (lambda seed, dev: tiny_batch(seed, dev, hard))
    out = {}
    for dev in ('cuda', 'cpu'):
        det = detector(cfg, head, device=dev, seed=2)
        batch = batch_fn(0, dev)
        total, losses = det.loss(det.apply_train(batch), batch)
        params = dict(det.trunk.named_parameters())
        grads = torch.autograd.grad(total, list(params.values()))
        state = det.init_train(LR, total_steps=100)
        state, _ = det.train_step(batch, state)
        out[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                    {k: g.cpu() for k, g in zip(params, grads)},
                    {k: v.detach().cpu().float()
                     for k, v in det.trunk.state_dict().items()},
                    {k: (state.opt_state.mu[k].cpu(),
                         state.opt_state.nu[k].cpu()) for k in params})
    (lc, gc, sc, mc), (lp, gp, sp, mp) = out['cuda'], out['cpu']
    check(min(lp.values()) > 0, f'a {tag} loss term is 0: {lp}')
    loss_rel = max(abs(lc[k] - lp[k]) / abs(lp[k]) for k in lp)
    grad_rel = max(float((gc[k] - gp[k]).abs().max() / gp[k].abs().max())
                   for k in gp)
    stat_err = max(float((sc[k] - sp[k]).abs().max()) for k in sp
                   if 'running' in k)
    mu_rel = max(float((mc[k][0] - mp[k][0]).abs().max()
                       / mp[k][0].abs().max()) for k in mp)
    nu_rel = max(float((mc[k][1] - mp[k][1]).abs().max()
                       / mp[k][1].abs().max()) for k in mp)
    w_err, w_all, n_sel, n_all = 0.0, 0.0, 0, 0
    for k in mp:
        mu = mp[k][0].abs()
        sel = (mu >= 1e-2 * mu.max()) & (mu > 1e-6)
        diff = (sc[k] - sp[k]).abs()
        w_err = max(w_err, float(diff[sel].max()))
        w_all = max(w_all, float(diff.max()))
        n_sel, n_all = n_sel + int(sel.sum()), n_all + sel.numel()
    print(f'(c) {tag} train step card vs CPU: loss terms {lc} vs {lp}, '
          f'largest relative error {loss_rel:.3g} (tol 1e-4); gradients '
          f'max error / max |grad| per parameter {grad_rel:.3g} (tol 1e-4); '
          f'running statistics max_abs_err {stat_err:.3g} (tol 1e-4); '
          f'Adam mu and nu max error / max per parameter {mu_rel:.3g} and '
          f'{nu_rel:.3g} (tol 1e-4, 2e-4); weights after the step where '
          f'|mu| >= 1e-2 max ({n_sel} of {n_all}) max_abs_err {w_err:.3g} '
          f'(tol {1e-2 * LR:g}), all weights {w_all:.3g} (lr {LR:g}) '
          f'[{card}]')
    check(loss_rel <= 1e-4, f'{tag} train losses differ')
    check(grad_rel <= 1e-4, f'{tag} train gradients differ')
    check(stat_err <= 1e-4, f'{tag} running statistics differ')
    check(mu_rel <= 1e-4 and nu_rel <= 2e-4, f'{tag} Adam moments differ')
    check(w_err <= 1e-2 * LR, f'{tag} weights after the step differ')
    check(w_all <= 2.5 * LR,
          f'a {tag} weight moved more than one Adam step')
    return gc


def timed_steps(det, batch, state, per_step, tag, card, points=POINTS,
                falling=('loss',)):
    """WARM_STEPS then TIMED_STEPS train steps on one repeated batch of
    ``points`` points a sample; the launch counts are zeroed before the
    timed steps and every kernel of ``per_step`` must run that often per
    step; every loss term must be finite and the sum of the ``falling``
    terms must go down.  -> (launches, state, summary)."""
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    rows, times = [], []
    for i in range(WARM_STEPS + TIMED_STEPS):
        if i == WARM_STEPS:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _cuda.reset_launches()
            rows.clear()
            times.clear()
        t0 = time.perf_counter()
        state, metrics = det.train_step(batch, state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append({k: float(v) for k, v in metrics.items()})
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for i, r in enumerate(rows):
        print(f'{tag} step {i} {json.dumps(r)}')
        check(all(map(math.isfinite, r.values())), 'non-finite loss')
    first, last = (sum(r[k] for k in falling) for r in (rows[0], rows[-1]))
    print(f'{tag} {" + ".join(falling)}: {first:.4f} -> {last:.4f}')
    check(last < first, f'{" + ".join(falling)} on a repeated batch did '
          f'not go down')
    print(f'{tag} main path: {TIMED_STEPS} timed train steps, launches '
          f'{launches}')
    for name, per in per_step.items():
        check(launches[name] == per * TIMED_STEPS,
              f'{name} launched {launches[name]} times in {TIMED_STEPS} '
              f'steps, want {per} per step')
    med = statistics.median(times)
    b = batch['points'].shape[0]
    print(f'{tag} train step median {med * 1e3:.3f} ms (min '
          f'{min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) over '
          f'{TIMED_STEPS} steps of {b}x{points} points; '
          f'{b * points / med:.0f} points/s; max_memory_allocated '
          f'{peak / 2**20:.1f} MiB; loss {rows[0]["loss"]:.4f} -> '
          f'{rows[-1]["loss"]:.4f} [{card}]')
    return launches, state, dict(
        step_ms=med * 1e3, step_min_ms=min(times) * 1e3,
        step_max_ms=max(times) * 1e3, points_per_s=b * points / med,
        peak_mib=peak / 2**20, loss_first=rows[0]['loss'],
        loss_last=rows[-1]['loss'])


def dense_steps(det, batch, state, per_step, tag, card):
    """Phase (t) or (t16), dense targets: DENSE_STEPS steps, where K3
    runs; every kernel of ``per_step`` must run that often per step."""
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    rows, times = [], []
    _cuda.reset_launches()
    for _ in range(DENSE_STEPS):
        t0 = time.perf_counter()
        state, metrics = det.train_step(batch, state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rows.append({k: float(v) for k, v in metrics.items()})
    launches = dict(_cuda.LAUNCHES)
    for i, r in enumerate(rows):
        print(f'{tag} dense step {i} {json.dumps(r)}')
        check(all(map(math.isfinite, r.values())), 'non-finite dense loss')
    med = statistics.median(times)
    print(f'{tag} dense targets: {DENSE_STEPS} steps, launches {launches}, '
          f'median {med * 1e3:.3f} ms [{card}]')
    for name, per in per_step.items():
        check(launches[name] == per * DENSE_STEPS,
              f'{name} launched {launches[name]} times in '
              f'{DENSE_STEPS} dense steps, want {per} per step')
    return launches, state, med * 1e3


def predict_requests(det, batches, rounds=ROUNDS):
    """-> (per-request seconds, outputs) of ``rounds`` passes over
    ``batches``, each request ending in a synchronize."""
    times, outs = [], []
    for _ in range(rounds):
        for batch in batches:
            t0 = time.perf_counter()
            out = det.predict(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            outs.append(out)
    return times, outs


def main_path(det, batches, per_request, tag, card, out_rows=100,
              num_classes=3, box_dim=7, points=POINTS):
    """Phase (d) or (d16) (or (n), (n16)): the full-width predict path
    answering requests; every kernel of ``per_request`` must run that
    often per request; each answer is ``out_rows`` boxes of ``box_dim``
    a sample with labels below ``num_classes``."""
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    times, outs = predict_requests(det, batches)
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_req = len(times)
    print(f'{tag} main path: {n_req} predicts, launches {launches}')
    for name, per in per_request.items():
        check(launches[name] == per * n_req, f'{name} launched '
              f'{launches[name]} times in {n_req} predicts, want {per} each')
    b = batches[0]['points'].shape[0]
    for boxes, scores, labels, valid in outs:
        check(tuple(boxes.shape) == (b, out_rows, box_dim), 'boxes shape')
        check(bool(torch.isfinite(boxes).all()
                   and torch.isfinite(scores).all()), 'non-finite output')
        check(bool(valid.any(dim=1).all()), 'a sample kept no detection')
        check(bool(((labels >= 0) & (labels < num_classes)).all()),
              'labels range')
    med = statistics.median(times)
    print(f'{tag} predict latency median {med * 1e3:.3f} ms '
          f'(min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}) over '
          f'{n_req} requests of {b}x{points} points; '
          f'{b * points / med:.0f} points/s; max_memory_allocated '
          f'{peak / 2**20:.1f} MiB [{card}]')
    return launches, dict(latency_ms=med * 1e3, points_per_s=b * points
                          / med, peak_mib=peak / 2**20)


def s2d_on_off(det_on, det_off, batches, card):
    """The f32 predict with the s2d canvas on against off, in turns (off,
    on, on, off), 6 requests each, each turn's launch counts zeroed before
    and read after (on: K7 once a request, no K2; off: K2, no K7); times
    only recorded.  -> (medians, launches with the canvas on)."""
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    times = {'off': [], 'on': []}
    launches = {'off': {}, 'on': {}}
    for which in ('off', 'on', 'on', 'off'):
        det = det_on if which == 'on' else det_off
        _cuda.reset_launches()
        times[which] += predict_requests(det, batches, rounds=1)[0]
        for name, n in _cuda.LAUNCHES.items():
            launches[which][name] = launches[which].get(name, 0) + n
    for which, per in (('on', PREDICT_S2D_LAUNCHES),
                       ('off', PREDICT_LAUNCHES)):
        n_req = len(times[which])
        for name in ('bev_splat', 'bev_splat_pairs'):
            want = per.get(name, 0) * n_req
            check(launches[which][name] == want,
                  f'f32 predict, s2d canvas {which}: {name} launched '
                  f'{launches[which][name]} times in {n_req} predicts, want '
                  f'{want}')
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    print(f'(d16) f32 predict, s2d canvas on {med["on"]:.3f} ms vs off '
          f'{med["off"]:.3f} ms (medians of {len(times["on"])} requests each, '
          f'in turns off, on, on, off; zero cls bias in both); launches with '
          f'it on {launches["on"]} [{card}]')
    return {f'f32_s2d_{k}_ms': v for k, v in med.items()}, launches['on']


def nms_counts(det, batch):
    """Valid NMS candidates and suppressions per (sample, class) of one
    request (run after the main path's counts were read)."""
    from mmdet3d_gaussian_tpu_torch.ops.nms import nms_bev
    with torch.inference_mode():
        cls, bbox, dirp = det.apply_eval(batch)[:3]
        b_sorted, _, v_sorted = det.head.select_candidates(
            cls, bbox, dirp, det.anchors)
        b, c, k = v_sorted.shape
        keep = nms_bev(b_sorted[..., [0, 1, 3, 4, 6]].reshape(b * c, k, 5),
                       det.head.test_cfg['nms_thr'],
                       v_sorted.reshape(b * c, k)).reshape(b, c, k)
    valid = v_sorted.sum(-1).cpu()
    kept = keep.sum(-1).cpu()
    share = (kept / valid.clamp(min=1)).round(decimals=4)
    print(f'(d) NMS valid candidates per sample x class {valid.tolist()}, '
          f'kept {kept.tolist()} (share of the valid {share.tolist()}), '
          f'suppressed {int((valid - kept).sum())}')
    check(bool((valid > 0).any(dim=1).all()),
          'a sample has no valid NMS candidate')
    check(int((valid - kept).sum()) > 0, 'the sweep suppressed nothing')


def capture_hard(run, per):
    """Run ``run()`` (one predict or train step of a hard path) recording
    the calls of K2, K1 (reduce, winner) and K4; each must be called as
    often as ``per`` says.  -> {kernel name: [args, ...]}."""
    from mmdet3d_gaussian_tpu_torch.ops import bn, scatter, voxelize
    patches = [(voxelize, 'bev_splat', 'bev_splat'),
               (scatter, 'segment_reduce', 'segment_reduce'),
               (scatter, 'segment_max_winner', 'segment_max_winner'),
               (bn, 'moments', 'bn_moments'),
               (bn, 'grad_moments', 'bn_grad_moments')]
    seen = record_calls(run, patches)
    got = {k: len(v) for k, v in seen.items()}
    want = {name: per[name] for _, _, name in patches if per.get(name)}
    check(got == want, f'hard path called {got}, want {want}')
    return seen


def hard_splat_checks(calls, card):
    """Phase (b), K2 on the hard paths' pillar rows (``calls``: {what:
    (feats, lin, ncell)}; f32 and bf16, from a predict and a train step):
    each equal to its plain version; the predicts' rows timed beside the
    bound, the plain version and ``zero_`` + ``index_copy_`` (recorded).
    -> {what: numbers}."""
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    results = {}
    for what, (feats, lin, ncell) in calls.items():
        out = voxelize.bev_splat(feats, lin, ncell)
        ref = voxelize.bev_splat_plain(feats, lin, ncell)
        exact = bool(torch.equal(out, ref))
        live = lin < ncell
        print(f'(b) bev_splat inputs ({what}): {feats.shape[0]} rows x '
              f'{feats.shape[1]} {feats.dtype}, {int(live.sum())} live onto '
              f'{ncell} cells, ids ascending '
              f'{bool((lin[1:] >= lin[:-1]).all())}; exact_equal={exact}')
        check(exact, f'K2 disagrees with its plain version ({what})')
        if 'step' in what:
            continue
        lin_live, rows_live = lin[live].long(), feats[live]
        canvas = torch.zeros_like(ref)
        esize = feats.element_size()
        report(results, what, card, 0.0, '0, equal', True,
               lambda: voxelize.bev_splat(feats, lin, ncell),
               lambda: voxelize.bev_splat_plain(feats, lin, ncell),
               lambda: canvas.zero_().index_copy_(0, lin_live, rows_live),
               50, 10, feats.numel() * esize + lin.numel() * 4
               + ncell * feats.shape[1] * esize, 0,
               f' exact_equal={exact} ({what})')
        r = results[what]
        print(f'(b) bev_splat ({what}): kernel / zero_ + index_copy_ '
              f'{r["ms"] / r["library_ms"]:.3f} (recorded) [{card}]')
    return results


def sorted_k1_checks(pred, step, pred16, card):
    """Phase (b), K1 on the sorted hard encoder's inputs: the f32 predict's
    3-channel cluster sum and 64-channel max of rank-masked rows, the f32
    train step's sum and winner form, the bf16 predict's max (on the f32
    cast of its bf16 rows, exact for a max): each against its plain
    version (max and winner exact, sums within 4 f32 ulps of the largest
    count times the largest value); the body each call takes (printed, not
    checked: the 3-channel sum takes the single-float one); device times
    beside the bound, and the cast's device time.  -> {what: numbers}."""
    from mmdet3d_gaussian_tpu_torch.ops import segment
    results = {}
    cases = [('sum, f32 predict', 'segment_reduce', pred['segment_reduce'][0]),
             ('max, f32 predict', 'segment_reduce', pred['segment_reduce'][1]),
             ('sum, f32 step', 'segment_reduce', step['segment_reduce'][0]),
             ('winner, f32 step', 'segment_max_winner',
              step['segment_max_winner'][0]),
             ('max, bf16 predict', 'segment_reduce',
              pred16['segment_reduce'][1])]
    for what, kern, args in cases:
        data, counts = args[0], args[-1] if kern == 'segment_max_winner' \
            else args[2]
        vec = segment.vectorized(data)
        body = 'float4' if vec else 'single-float'
        if kern == 'segment_max_winner':
            out, mask = segment.segment_max_winner(*args)
            ref, ref_m = segment.segment_max_winner_plain(*args)
            err = float((out - ref).abs().max())
            ok = bool(torch.equal(out, ref) and torch.equal(mask, ref_m))
            tol, work = '0, masks equal', k1_work('winner', *args)
            kernel = lambda a=args: segment.segment_max_winner(*a)
            plain = lambda a=args: segment.segment_max_winner_plain(*a)
        else:
            _, starts, cnt, op = args
            out = segment.segment_reduce(*args)
            ref = segment.segment_reduce_plain(*args)
            err = float((out - ref).abs().max())
            if op == 'max':
                ok, tol = bool(torch.equal(out, ref)), '0, equal'
            else:
                bound_err = 4 * torch.finfo(torch.float32).eps * float(
                    cnt.max()) * float(data.abs().max())
                ok, tol = err <= bound_err, f'{bound_err:.3g}'
            work = k1_work('reduce', data, None, starts, cnt)
            kernel = lambda a=args: segment.segment_reduce(*a)
            plain = lambda a=args: segment.segment_reduce_plain(*a)
        print(f'(b) {kern} ({what}): {data.shape[0]} rows x {data.shape[1]} '
              f'channels, {body} body, {int((counts > 0).sum())} live '
              f'segments, largest {int(counts.max())} rows')
        report(results, what, card, err, tol, ok, kernel, plain, None, 100, 5,
               *work, f' ({what})')
        results[what]['body'] = body
        if what.endswith('bf16 predict'):
            rows16 = data.bfloat16()
            check(torch.equal(rows16.float(), data),
                  'bf16 rows do not round-trip through their f32 cast')
            cast = device_ms(lambda: rows16.float(), 50)
            results[what]['cast_ms'] = cast
            print(f'(b) segment_reduce ({what}): the cast of the bf16 rows '
                  f'to f32 {cast:.4f} ms beside K1 {results[what]["ms"]:.4f} '
                  f'ms [{card}]')
    return results


def pillar_rows(det, batch):
    with torch.inference_mode():
        return det.trunk.pillars(batch['points'], batch['points_mask'])[0]


def sorted_vs_packed(det_p, det_s, batches, card, tag):
    """The sorted hard encoder against the packed one with the same
    weights: pillar rows (f32 within 1e-5; bf16 within one bf16 step) and
    predictions (equal where the rows are), then the two predicts timed in
    turns (packed, sorted, sorted, packed; one request of each batch a
    turn), each turn's launch counts zeroed before and read after (K1
    reduce twice a sorted predict, never in a packed one); the device time
    of each encoder (voxelize and pillar rows) with its largest kernels,
    and a profile of the sorted predict.  -> numbers."""
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    rows_p, rows_s = pillar_rows(det_p, batches[0]), pillar_rows(det_s,
                                                                 batches[0])
    f32 = rows_p.dtype == torch.float32
    err = float((rows_p.float() - rows_s.float()).abs().max())
    differ = float((rows_p != rows_s).float().mean())
    tol = 1e-5 if f32 else 2.0 ** -7
    close = bool(torch.allclose(rows_s.float(), rows_p.float(), rtol=tol,
                                atol=tol if f32 else 0.0))
    outs = [(det_p.predict(b), det_s.predict(b)) for b in batches]
    equal = all(all(torch.equal(a, b) for a, b in zip(p, q)) for p, q in outs)
    valid_eq = all(torch.equal(p[3], q[3]) for p, q in outs)
    print(f'{tag} sorted vs packed encoder, same weights: pillar rows '
          f'{tuple(rows_p.shape)} {rows_p.dtype} max_abs_err {err:.3g} '
          f'(tol {tol:g}{" relative" if not f32 else ""}), share that '
          f'differ {differ:.3g}; predictions of {len(batches)} requests '
          f'equal={equal} (valid equal={valid_eq})')
    check(close, f'{tag} sorted and packed pillar rows differ')
    check(equal or differ > 0, f'{tag} equal rows gave other predictions')
    times = {'packed': [], 'sorted': []}
    launches = {'packed': {}, 'sorted': {}}
    for which in ('packed', 'sorted', 'sorted', 'packed'):
        det = det_s if which == 'sorted' else det_p
        _cuda.reset_launches()
        times[which] += predict_requests(det, batches, rounds=1)[0]
        for name, n in _cuda.LAUNCHES.items():
            launches[which][name] = launches[which].get(name, 0) + n
    for which, per in (('sorted', SORTED_PREDICT_LAUNCHES),
                       ('packed', HARD_PREDICT_LAUNCHES)):
        n_req = len(times[which])
        for name, want in per.items():
            check(launches[which][name] == want * n_req,
                  f'{tag} {which}: {name} launched {launches[which][name]} '
                  f'times in {n_req} predicts, want {want} each')
    encoders = {}
    for which, det in (('packed', det_p), ('sorted', det_s)):
        by_name = device_ms_by_name(lambda d=det: pillar_rows(d, batches[0]),
                                    5)
        encoders[which] = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f'{tag} {which} encoder (voxelize + pillar rows, '
              f'{rows_p.dtype}): {encoders[which]:.4f} device ms; most: '
              + '; '.join(f'{ms:.4f} {name[:60]}' for name, ms in top)
              + f' [{card}]')
    busy = device_profile(lambda: det_s.predict(batches[0]), 'predict',
                          f'{tag} sorted', card, 5)
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    print(f'{tag} predict, sorted encoder {med["sorted"]:.3f} ms vs packed '
          f'{med["packed"]:.3f} ms (medians of {len(times["sorted"])} '
          f'requests each, in turns packed, sorted, sorted, packed; zero cls '
          f'bias); launches with the sorted encoder {launches["sorted"]} '
          f'[{card}]')
    return dict(sorted_ms=med['sorted'], packed_ms=med['packed'],
                encoder_device_ms=encoders, rows_max_abs_err=err,
                rows_share_differ=differ, predictions_equal=equal,
                sorted_profile=busy), launches['sorted']


def hard_detectors(seed=0, **cfg):
    """The hard paths' predict detectors from one seed: the packed encoder
    (the entry point's default) and the sorted one with its weights, both
    with a zero cls bias so that scores clear the threshold."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import PointPillarsDetector
    det_p = PointPillarsDetector(cfg or None, device='cuda', seed=seed)
    det_s = PointPillarsDetector(dict(cfg, **SORTED_MODEL), device='cuda',
                                 seed=seed)
    det_s.trunk.load_state_dict(det_p.trunk.state_dict())
    check(det_p.trunk.voxelize_mode == 'hard' and not det_p.trunk.s2d
          and det_s.trunk.hard_encoder == 'sorted', 'hard detectors')
    for det in (det_p, det_s):
        with torch.no_grad():
            det.trunk.bbox_head.conv_cls.bias.zero_()
    return det_p, det_s


def hard_phases(batches, card):
    """Phases (b) on the hard paths' inputs, (h), (h16), sorted against
    packed, (ht) and (ht16).  -> (K2 numbers, K1 numbers, launches per
    hard path, end-to-end summaries)."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import PointPillarsDetector
    det, det_s = hard_detectors()
    det16, det16_s = hard_detectors(**HARD16_MODEL)
    with torch.inference_mode():
        _, _, sc = det.trunk.pillars(batches[0]['points'],
                                     batches[0]['points_mask'])
    print(f'(h) voxels {int(sc.num_voxels)} of capacity {sc.max_voxels}, '
          f'overflow {int(sc.num_overflow)}; pillars over '
          f'{det.trunk.max_points_per_voxel} points '
          f'{int((sc.voxel_counts > det.trunk.max_points_per_voxel).sum())}, '
          f'largest {int(sc.voxel_counts.max())} points')
    b0 = batches[0]
    tdet = PointPillarsDetector(device='cuda', seed=0)
    tdet_s = PointPillarsDetector(SORTED_MODEL, device='cuda', seed=0)
    tdet16 = PointPillarsDetector(HARD16_MODEL, device='cuda', seed=0)
    states = {k: d.init_train(LR, total_steps=100)
              for k, d in (('t', tdet), ('s', tdet_s), ('t16', tdet16))}
    states['t'], _ = tdet.train_step(b0, states['t'])       # warm-up
    states['s'], _ = tdet_s.train_step(b0, states['s'])
    states['t16'], _ = tdet16.train_step(b0, states['t16'])
    calls = {}
    with torch.inference_mode():                       # (b) hard
        calls['f32 predict'] = capture_hard(lambda: det.predict(b0),
                                            HARD_PREDICT_LAUNCHES)
        calls['bf16 predict'] = capture_hard(lambda: det16.predict(b0),
                                             HARD_PREDICT_LAUNCHES)
        calls['sorted predict'] = capture_hard(lambda: det_s.predict(b0),
                                               SORTED_PREDICT_LAUNCHES)
        calls['sorted bf16 predict'] = capture_hard(
            lambda: det16_s.predict(b0), SORTED_PREDICT_LAUNCHES)
    holder = {}

    def step(key, d):
        def run():
            holder[key] = d.train_step(b0, states[key])[0]
        return run
    calls['f32 step'] = capture_hard(step('t', tdet), HARD_TRAIN_LAUNCHES)
    calls['sorted step'] = capture_hard(step('s', tdet_s),
                                        SORTED_TRAIN_LAUNCHES)
    calls['bf16 step'] = capture_hard(step('t16', tdet16),
                                      HARD_TRAIN_LAUNCHES)
    states.update(holder)
    check(calls['bf16 predict']['bev_splat'][0][0].dtype == torch.bfloat16
          and calls['bf16 step']['bev_splat'][0][0].dtype == torch.bfloat16,
          'the bf16 hard paths splat non-bf16 rows')
    with torch.no_grad():
        k2 = hard_splat_checks({what: calls[what]['bev_splat'][0] for what in
                                ('f32 predict', 'bf16 predict', 'f32 step',
                                 'bf16 step')}, card)
        k1 = sorted_k1_checks(calls['sorted predict'], calls['sorted step'],
                              calls['sorted bf16 predict'], card)
    del calls, tdet_s
    states.pop('s')
    torch.cuda.empty_cache()
    launches, e2e = {}, {}
    for tag, d, key in (('(h)', det, 'predict'),
                        ('(h16)', det16, 'predict_bf16')):
        launches[key], e2e[key] = main_path(d, batches,
                                            HARD_PREDICT_LAUNCHES, tag, card)
        e2e[key].update(device_profile(lambda d=d: d.predict(b0), 'predict',
                                       tag, card, 5))
    for tag, p, q, key in (('(h)', det, det_s, 'sorted'),
                           ('(h16)', det16, det16_s, 'sorted_bf16')):
        e2e[key], launches[f'predict_{key}'] = sorted_vs_packed(
            p, q, batches, card, tag)
    del det, det_s, det16, det16_s
    torch.cuda.empty_cache()
    for tag, d, key, dt in (('(ht)', tdet, 't', None),
                            ('(ht16)', tdet16, 't16', 'bfloat16')):
        name = 'train' if dt is None else 'train_bf16'
        launches[name], states[key], e2e[name] = timed_steps(
            d, b0, states[key], HARD_TRAIN_LAUNCHES, tag, card)
        ddet = PointPillarsDetector(dict(compute_dtype=dt), dict(pos_cap=0),
                                    device='cuda', seed=0)
        ddet.trunk.load_state_dict(d.trunk.state_dict())
        dstate = ddet.init_train(LR, total_steps=100)
        launches[name + '_dense'], _, e2e[name]['dense_step_ms'] = \
            dense_steps(ddet, b0, dstate, HARD_DENSE_LAUNCHES, tag, card)
        del ddet, dstate
        one = [states[key]]

        def one_step(d=d, one=one):
            one[0] = d.train_step(b0, one[0])[0]
        e2e[name].update(device_profile(one_step, 'train step', tag, card,
                                        3))
        del one
        torch.cuda.empty_cache()
    n = {'predict': len(SEEDS) * ROUNDS, 'predict_bf16': len(SEEDS) * ROUNDS,
         'predict_sorted': 2 * len(SEEDS), 'predict_sorted_bf16':
         2 * len(SEEDS), 'train': TIMED_STEPS, 'train_bf16': TIMED_STEPS,
         'train_dense': DENSE_STEPS, 'train_bf16_dense': DENSE_STEPS}
    per = {path: {k: v / n[path] for k, v in counts.items() if v}
           for path, counts in launches.items()}
    print(f'(h) launches per predict or step on the hard paths {per} '
          f'[{card}]')
    return k2, k1, per, e2e


# ---------------------------------------------------------------- phase (L)
# Train and evaluate from the flagship config through the port's CLIs, on a
# KITTI-format tree that the script writes at the config's own scale.
FLAGSHIP = ('configs/kitti/'
            'hv_pointpillars_secfpn_kld5tau1_12x4_160e_kitti-3d-3class.py')
L_TRAIN, L_VAL, L_STEPS, L_RESUME_STEPS = 48, 24, 8, 10
L_PROFILE = (5, 8)          # the train run profiles steps 6, 7 and 8
# the phase must end within this: 1.3 times its slowest wall measured so
# far, 188.2 s (PERF.md, PR 10).  The flagship train pipeline takes
# 0.46-0.77 s a sample on the card's host, so the ten steps of 12 samples
# alone take 55-95 s
L_LIMIT_S = 245.0
# K5's plain version is run on this many problems at a time (its pairwise
# temporaries of 12 problems of 1,024 boxes take some GiB)
K5_PLAIN_CHUNK = 12
# a KITTI-like camera for the LiDAR frames (KITTI's P2 focal length and
# principal point; cam x = -y, y = -z, z = x), so the official metric's
# image gates see boxes of KITTI's pixel heights
L_CALIB = dict(
    R0_rect=[[1., 0., 0., 0.], [0., 1., 0., 0.], [0., 0., 1., 0.],
             [0., 0., 0., 1.]],
    Tr_velo_to_cam=[[0., -1., 0., 0.], [0., 0., -1., 0.], [1., 0., 0., 0.],
                    [0., 0., 0., 1.]],
    P2=[[721.5377, 0., 609.5593, 0.], [0., 721.5377, 172.854, 0.],
        [0., 0., 1., 0.]])
L_IMAGE = (375, 1242)
L_GROUND_Z = -1.73          # the KITTI velodyne's height over the road
L_CLASSES = ('Pedestrian', 'Cyclist', 'Car')
# KITTI mean sizes (dx = length, dy = width, dz = height), in class order
L_SIZES = ((0.8, 0.6, 1.73), (1.76, 0.6, 1.73), (3.9, 1.6, 1.56))
# per train step: every BatchNorm's moments both ways, one splat (hard
# voxelize, packed encoder); per val batch of 12: one splat, one rotated
# IoU and one sweep
LOOP_STEP_LAUNCHES = {'bn_moments': 19, 'bn_grad_moments': 19,
                      'bev_splat': 1}
LOOP_PREDICT_LAUNCHES = {'bev_splat': 1, 'rotated_iou': 1, 'nms_sweep': 1}
CLI_RUNNER = r'''
import json, sys
import torch.distributed as dist
from mmdet3d_gaussian_tpu_torch.ops import _cuda
from mmdet3d_gaussian_tpu_torch.tools import train, test
_cuda.reset_launches()
{'train': train, 'test': test}[sys.argv[2]].main(sys.argv[3:])
with open(sys.argv[1], 'w') as f:
    json.dump(_cuda.LAUNCHES, f)
if dist.is_initialized():
    dist.destroy_process_group()
'''


def kitti_scene(rng):
    """One LiDAR frame: 19,000-20,000 points (ground, clutter, points
    inside the boxes; x, y, z, intensity) and its GT boxes (3-5 Car, 1-2
    Pedestrian, 1 Cyclist at KITTI sizes, apart, in front of the camera
    and inside the anchor range), labels in class order."""
    import numpy as np
    from mmdet3d_gaussian_tpu_torch.datasets.pipelines import (
        _points_in_boxes_np)
    labels = sorted([2] * rng.randint(3, 6) + [0] * rng.randint(1, 3) + [1])
    boxes = []
    for lab in labels:
        size = np.asarray(L_SIZES[lab]) * rng.uniform(0.9, 1.1, 3)
        for _ in range(100):
            x = rng.uniform(6.0, 55.0)
            y = rng.uniform(-1, 1) * min(0.7 * x, 35.0)
            if all(math.hypot(x - b[0], y - b[1]) > 0.5 * (
                    math.hypot(*size[:2]) + math.hypot(*b[3:5])) + 0.5
                   for b in boxes):
                break
        boxes.append([x, y, L_GROUND_Z, *size, rng.uniform(-math.pi,
                                                           math.pi)])
    boxes = np.asarray(boxes, np.float32)
    n_points = rng.randint(19000, 20001)
    inside = []
    for b in boxes:     # nearer objects return more points
        n = int(np.clip(6000 / b[0], 20, 600))
        local = rng.uniform(-0.5, 0.5, (n, 3)) * b[3:6]
        c, s = math.cos(b[6]), math.sin(b[6])
        xy = local[:, :2] @ np.array([[c, s], [-s, c]]) + b[:2]
        inside.append(np.c_[xy, local[:, 2] + b[2] + b[5] / 2])
    inside = np.concatenate(inside)

    def sector(n):      # the camera's field of view, denser near
        x = 69.0 * np.sqrt(rng.uniform(0.002, 1, n))
        return x, rng.uniform(-1, 1, n) * np.minimum(1.2 * x, 39.6)
    n_clutter = 3000
    n_ground = n_points - len(inside) - n_clutter
    gx, gy = sector(n_ground)
    cx, cy = sector(n_clutter)
    rest = np.r_[np.c_[gx, gy, L_GROUND_Z + rng.normal(0, 0.03, n_ground)],
                 np.c_[cx, cy, rng.uniform(L_GROUND_Z, 0.8, n_clutter)]]
    rest = rest[~_points_in_boxes_np(rest, boxes).any(-1)]
    pts = np.r_[inside, rest]
    pts = np.c_[pts, rng.rand(len(pts))].astype(np.float32)
    return pts[rng.permutation(len(pts))], boxes, np.asarray(labels)


def write_kitti_tree(root, seed=0, n_train=L_TRAIN, n_val=L_VAL):
    """A KITTI-format tree under ``root`` (``n_train`` and ``n_val``
    frames): ``training/velodyne_reduced``,
    ``kitti_infos_{train,val}.pkl`` (camera-frame annotations through
    ``L_CALIB``, as KITTI's converter writes them) and a GT database of the
    train frames in the format of
    ``tools/data_converter/create_gt_database.py`` (that tool imports the
    JAX package).  -> {split: frames}, {class: database objects}."""
    import pickle
    import numpy as np
    from mmdet3d_gaussian_tpu_torch.datasets.kitti import KittiDataset
    from mmdet3d_gaussian_tpu_torch.datasets.pipelines import (
        _points_in_boxes_np)
    rng = np.random.RandomState(seed)
    calib = {k: np.asarray(v) for k, v in L_CALIB.items()}
    os.makedirs(os.path.join(root, 'training', 'velodyne_reduced'))
    os.makedirs(os.path.join(root, 'kitti_gt_database'))
    infos, db = {'train': [], 'val': []}, {}
    for i in range(n_train + n_val):
        split = 'train' if i < n_train else 'val'
        pts, boxes, labels = kitti_scene(rng)
        pts.tofile(os.path.join(root, 'training', 'velodyne_reduced',
                                f'{i:06d}.bin'))
        per_cls = [np.c_[boxes[labels == c], np.ones(((labels == c).sum(),
                                                      1))].astype(np.float32)
                   for c in range(3)]
        anno = KittiDataset.lidar_det_to_kitti_anno(per_cls, calib, L_IMAGE,
                                                    L_CLASSES)
        check(len(anno['name']) == len(boxes), 'a GT box left the image')
        anno.pop('score')
        inside = _points_in_boxes_np(pts[:, :3], boxes)
        height = anno['bbox'][:, 3] - anno['bbox'][:, 1]
        anno['difficulty'] = np.where(height >= 40, 0, np.where(
            height >= 25, 1, 2)).astype(np.int32)
        anno['num_points_in_gt'] = inside.sum(0).astype(np.int32)
        infos[split].append(dict(
            point_cloud=dict(velodyne_path=f'training/velodyne/{i:06d}.bin'),
            image=dict(image_shape=L_IMAGE), calib=calib, annos=anno))
        if split == 'val':
            continue
        for j, name in enumerate(anno['name']):
            obj = pts[inside[:, j]].copy()
            obj[:, :3] -= boxes[j, :3]          # centre-relative patch
            path = os.path.join('kitti_gt_database', f'{i:06d}_{name}_{j}.bin')
            obj.tofile(os.path.join(root, path))
            db.setdefault(str(name), []).append(dict(
                name=str(name), path=path, gt_idx=j, box3d_lidar=boxes[j],
                num_points_in_gt=int(inside[:, j].sum()),
                difficulty=int(anno['difficulty'][j])))
    for split, frames in infos.items():
        with open(os.path.join(root, f'kitti_infos_{split}.pkl'), 'wb') as f:
            pickle.dump(frames, f)
    with open(os.path.join(root, 'kitti_dbinfos_train.pkl'), 'wb') as f:
        pickle.dump(db, f)
    return {k: len(v) for k, v in infos.items()}, {k: len(v)
                                                    for k, v in db.items()}


def move_data_paths(cfg, root):
    """Set the flagship config's data paths (train and val info pkls and
    data roots, the GT database's info pkl and root) under ``root``."""
    train = cfg['data']['train']['dataset']
    val = cfg['data']['val']
    sampler = next(t for t in train['pipeline']
                   if t['type'] == 'ObjectSample')['db_sampler']
    where = ((train, 'data_root', ''), (train, 'ann_file',
                                        'kitti_infos_train.pkl'),
             (val, 'data_root', ''), (val, 'ann_file', 'kitti_infos_val.pkl'),
             (sampler, 'data_root', ''),
             (sampler, 'info_path', 'kitti_dbinfos_train.pkl'))
    for d, key, name in where:
        d[key] = os.path.join(root, name)


def derived_config(tmp, root, repo, config=FLAGSHIP):
    """Write ``tmp/local.py``: ``_base_`` the ``config`` file (the
    flagship by default) by absolute path, only its data paths moved under
    ``root``; check that it loads to that config with those paths changed
    and nothing else.  -> (its path, the loaded config)."""
    from mmdet3d_gaussian_tpu_torch.utils.config import Config
    base = os.path.join(repo, config)
    want = Config.fromfile(base).to_dict()
    move_data_paths(want, root)
    train = want['data']['train']['dataset']
    val = want['data']['val']
    text = (f'_base_ = [{base!r}]\n'
            f'data = dict(\n'
            f'    train=dict(dataset=dict(data_root={train["data_root"]!r}, '
            f'ann_file={train["ann_file"]!r},\n'
            f'                            pipeline={train["pipeline"]!r})),\n'
            f'    val=dict(data_root={val["data_root"]!r}, '
            f'ann_file={val["ann_file"]!r}))\n')
    path = os.path.join(tmp, 'local.py')
    with open(path, 'w') as f:
        f.write(text)
    cfg = Config.fromfile(path)
    check(cfg.to_dict() == want, f'the derived config differs from '
          f'{config} beyond its data paths')
    return path, cfg


def run_cli(tool, args, cwd, root):
    """Run the port's ``tool`` CLI (``train`` or ``test``) in a subprocess
    from ``cwd``, its kernel launch counts zeroed before ``main`` and read
    after it.  -> (stdout, launches, seconds); fails on a non-zero exit."""
    counts = os.path.join(cwd, f'launches_{tool}_{time.monotonic_ns()}.json')
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, '-c', CLI_RUNNER, counts, tool,
                          *args], cwd=cwd, env=env, capture_output=True,
                         text=True, timeout=600)
    seconds = time.perf_counter() - t0
    check(out.returncode == 0, f'{tool} {args} exited {out.returncode}: '
          f'{out.stderr[-3000:]}')
    with open(counts) as f:
        launches = {k: v for k, v in json.load(f).items() if v}
    return out.stdout, launches, seconds


def check_launches(what, got, per, n):
    want = {k: v * n for k, v in per.items()}
    check(got == want, f'{what}: launches {got}, want {want}')


def read_log(work):
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        return [json.loads(line) for line in f]


def trace_busy(path):
    """(window ms, device busy ms) of a ``torch.profiler`` chrome trace:
    the span of all its events, and the union of its kernel, copy and fill
    intervals on the card."""
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and 'dur' in e]
    device = [(e['ts'], e['ts'] + e['dur']) for e in events
              if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
    if not device:
        return None, 0.0
    start = min(e['ts'] for e in events)
    end = max(e['ts'] + e['dur'] for e in events)
    return (end - start) / 1e3, union_us(device) / 1e3


def report_json(stdout):
    """The JSON report the test CLI prints last."""
    return json.loads(stdout[stdout.rindex('\n{') + 1:])


def check_aps(report, what):
    check(len(report) > 0, f'{what}: empty report')
    bad = {k: v for k, v in report.items()
           if not (math.isfinite(v) and 0.0 <= v <= 100.0)}
    check(not bad, f'{what}: APs outside [0, 100] or not finite: {bad}')


def k5_plain_chunked(boxes):
    """K5's plain version on (P, K, 5) boxes, ``K5_PLAIN_CHUNK`` problems
    at a time (the problems are independent)."""
    from mmdet3d_gaussian_tpu_torch.ops import rotated_iou
    return torch.cat([rotated_iou.iou_bev_pairwise_plain(
        boxes[i:i + K5_PLAIN_CHUNK])
        for i in range(0, boxes.shape[0], K5_PLAIN_CHUNK)])


def loop_k5_checks(results, boxes, valid, thr, n, card):
    """Phase (L), K5 at the loop's shape (3 classes x ``n`` frames of
    1,024 candidates): on the rotated predict's own boxes (early in
    training many of their sizes overflow), NaN exactly where its plain
    version is NaN and within 1e-5 elsewhere, as the gpu tests hold it, and
    timed; then on the ``clustered`` recorded case at the same shape."""
    from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou
    p, k = boxes.shape[:2]
    out = rotated_iou.iou_bev_pairwise(boxes)
    ref = k5_plain_chunked(boxes)
    nan = ref.isnan()
    same_nan = bool(torch.equal(out.isnan(), nan))
    err = float((out - ref)[~nan].abs().max()) if (~nan).any() else 0.0
    sound = (torch.isfinite(boxes).all(-1)
             & (boxes[..., 2:4] > 0).all(-1))
    near = rotated_iou.near_pairs_plain(boxes)
    n_near = int(near.sum())
    same_keep = bool(torch.equal(nms.suppress_sweep_plain(out, valid, thr),
                                 nms.suppress_sweep_plain(ref, valid, thr)))
    print(f'(L) rotated_iou on the rotated predict of a val batch of {n}: '
          f'{p} problems x {k} boxes, {int(sound.sum())} of finite positive '
          f'size ({int((~torch.isfinite(boxes).all(-1)).sum())} not '
          f'finite); plain NaN on {int(nan.sum())} pairs, kernel NaN on the '
          f'same: {same_nan}; share of the other pairs with IoU > 0.01 '
          f'{float((ref[~nan] > 0.01).float().mean()):.4f}; near share '
          f'{n_near / out.numel():.6f}; NMS keep from kernel and plain IoU '
          f'equal: {same_keep} [{card}]')
    check(same_nan, 'K5 is NaN on other pairs than its plain version on '
          'the loop\'s boxes')
    check(same_keep, 'the NMS keep from K5 differs from the one from its '
          'plain version on the loop\'s boxes')
    report(results, 'rotated_iou', card, err, '1e-05', err <= 1e-5,
           lambda: rotated_iou.iou_bev_pairwise(boxes),
           lambda: k5_plain_chunked(boxes), None, 20, 1,
           *k5_work(boxes, n_near), f' (rotated predict, val batch of {n}, '
           f'NaN on the same pairs)')
    results['rotated_iou']['near_share'] = n_near / out.numel()
    results['rotated_iou']['sound_boxes'] = int(sound.sum())
    del out, ref, near, nan
    cboxes = k5_boxes('clustered', p=p, k=k)
    out = rotated_iou.iou_bev_pairwise(cboxes)
    ref = k5_plain_chunked(cboxes)
    err = float((out - ref).abs().max())
    check(err <= 1e-5, f'rotated_iou (clustered, {p} problems) disagrees '
          f'with its plain version: max_abs_err {err:.3g}')
    n_near = k5_cull(cboxes, out, ref, card, f'clustered, {p} problems')
    del ref
    ms = device_ms(lambda: rotated_iou.iou_bev_pairwise(cboxes), 20)
    b_ms, b_by = bound(*k5_work(cboxes, n_near))
    results['rotated_iou']['clustered'] = dict(
        ms=ms, max_abs_err=err, near_share=n_near / out.numel(),
        bound_ms=b_ms, bound_by=b_by)
    print(f'(L) rotated_iou (clustered, {p} problems x {k}): max_abs_err='
          f'{err:.3g} (tol 1e-5) kernel={ms:.4f} ms bound={b_ms:.4f} ms '
          f'({b_by}) [{card}]')


def loop_kernel_checks(cfg, det, batch, val_batch, card):
    """Phase (L), kernels on the loop's inputs: one train step at B = 12
    on a batch of the train pipeline (K2, K4's 19 + 19 calls); the rotated
    predict on a val batch of 12 (K5 on its 3 x 12 problems:
    :func:`loop_k5_checks`; K6 there equal); a bf16 predict on it (K2 on
    bf16 rows); and the predict with axis-aligned NMS on it (K6 on
    ``nms_normal_bev``'s IoU).  Each held to its plain version; the val
    batch's K5, the bf16 K2 and the axis K6 timed.  -> {kernel:
    numbers}."""
    from mmdet3d_gaussian_tpu_torch.ops import nms, voxelize
    from mmdet3d_gaussian_tpu_torch.parallel.train_state import (
        make_optimizer)
    from mmdet3d_gaussian_tpu_torch.tools.common import build_detector
    from mmdet3d_gaussian_tpu_torch.utils.config import Config
    state = det.init_train(optimizer=make_optimizer(1e-4, 100))
    state, _ = det.train_step(batch, state)              # warm-up
    calls = capture_hard(lambda: det.train_step(batch, state),
                         LOOP_STEP_LAUNCHES)
    results, n = {}, cfg.data['samples_per_gpu']
    with torch.no_grad():
        check_k4(results, calls, card, ' (loop, B = 12)')
        results.update(hard_splat_checks(
            {'loop train batch': calls['bev_splat'][0]}, card))

    # the rotated predict (the config's own NMS): K5 on every class's
    # candidates of the 12 frames, K6 on their IoU
    with torch.inference_mode():
        seen = record_calls(lambda: det.predict(val_batch), [
            (nms, 'iou_bev_pairwise', 'rotated_iou'),
            (nms, 'suppress_sweep', 'nms_sweep')])
        check({k: len(v) for k, v in seen.items()}
              == {'rotated_iou': 1, 'nms_sweep': 1},
              f'the rotated predict called {seen.keys()}')
        (boxes,) = seen['rotated_iou'][0]
        iou, valid, thr = seen['nms_sweep'][0]
        loop_k5_checks(results, boxes, valid, thr, n, card)
        exact = bool(torch.equal(nms.suppress_sweep(iou, valid, thr),
                                 nms.suppress_sweep_plain(iou, valid, thr)))
        print(f'(L) nms_sweep on the rotated predict of a val batch of '
              f'{n}: {valid.shape[0]} problems x {valid.shape[1]} candidates, '
              f'exact_equal={exact}')
        check(exact, 'K6 disagrees with its plain version on the rotated '
              'predict of a val batch')
        del seen, boxes, iou, valid

    # a bf16 predict (the test CLI's --bf16): K2 on its bf16 pillar rows
    det16 = build_detector(cfg, 'cuda', model_overrides=dict(
        compute_dtype='bfloat16'))
    det16.trunk.load_state_dict(det.trunk.state_dict())
    with torch.inference_mode():
        seen = record_calls(lambda: det16.predict(val_batch),
                            [(voxelize, 'bev_splat', 'bev_splat')])
        check(len(seen.get('bev_splat', ())) == 1
              and seen['bev_splat'][0][0].dtype == torch.bfloat16,
              'the bf16 predict did not splat bf16 rows once')
        results.update(hard_splat_checks(
            {'loop bf16 predict': seen['bev_splat'][0]}, card))
    del det16, seen

    acfg = Config(cfg.to_dict())
    acfg.head['test_cfg']['use_rotate_nms'] = False
    adet = build_detector(acfg, 'cuda')
    adet.trunk.load_state_dict(det.trunk.state_dict())
    with torch.inference_mode():
        seen = record_calls(lambda: adet.predict(val_batch),
                            [(nms, 'suppress_sweep', 'nms_sweep')])
    check(len(seen['nms_sweep']) == 1, 'axis-aligned NMS did not sweep once')
    iou, valid, thr = seen['nms_sweep'][0]
    keep = nms.suppress_sweep(iou, valid, thr)
    ref = nms.suppress_sweep_plain(iou, valid, thr)
    exact = bool(torch.equal(keep, ref))
    n_valid = valid.sum(1)
    print(f'(L) nms_sweep on nms_normal_bev inputs: {valid.shape[0]} '
          f'problems x {valid.shape[1]} candidates, thr {thr}; valid '
          f'{n_valid.tolist()}, kept {ref.sum(1).tolist()}')
    report(results, 'nms_normal_bev', card,
           float((keep.int() - ref.int()).abs().max()), '0', exact,
           lambda: nms.suppress_sweep(iou, valid, thr),
           lambda: nms.suppress_sweep_plain(iou, valid, thr), None, 50, 2,
           *k6_work(valid, ref), f' exact_equal={exact} (nms_normal_bev, '
           f'val batch of {n})')
    return results


def loop_phase(repo, card):
    """Phase (L): the flagship config trained and evaluated through the
    port's CLIs on a KITTI-format tree written here.  -> (kernel numbers
    on the loop's inputs, launches per CLI run, summary)."""
    import pickle
    import tempfile
    from mmdet3d_gaussian_tpu_torch.core.evaluation import native
    from mmdet3d_gaussian_tpu_torch.datasets.pipelines import collate_batch
    from mmdet3d_gaussian_tpu_torch.engine.loop import (
        build_dataloader, load_checkpoint, restore_checkpoint, to_device)
    from mmdet3d_gaussian_tpu_torch.parallel.train_state import (
        make_optimizer_from_cfg)
    from mmdet3d_gaussian_tpu_torch.tools.common import build_detector
    t_phase = time.perf_counter()
    summary, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_loop_') as tmp:
        root = os.path.join(tmp, 'kitti')
        frames, objects = write_kitti_tree(root)
        cfg_path, cfg = derived_config(tmp, root, repo)
        print(f'(L) KITTI-format tree: {frames} frames, GT database '
              f'{objects}; config {FLAGSHIP} with its data paths moved '
              f'(samples_per_gpu {cfg.data["samples_per_gpu"]}, workers '
              f'{cfg.data.get("workers_per_gpu", 2)}, Pad3D '
              f'{cfg.data["train"]["dataset"]["pipeline"][-1]["num_points"]}'
              f') [{time.perf_counter() - t_phase:.1f} s]')

        # the evaluators' C++ library, built here before the test CLIs load
        # it: without it they would time the numpy path
        t0 = time.perf_counter()
        check(native.available(), 'the eval ops library did not build')
        print(f'(L) eval ops library {native.library_path()} '
              f'[{time.perf_counter() - t0:.1f} s]')

        # the train pipeline alone, serially, in this process, with the
        # time of each transform, over the samples of the batch that the
        # kernels are checked on
        ds, _ = build_dataloader(cfg, 'train')
        n_samples = cfg.data['samples_per_gpu']
        spent = {}

        def timed(transform):
            name = type(transform).__name__

            def run(results):
                t0 = time.perf_counter()
                out = transform(results)
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
                return out
            return run
        ds.dataset.pipeline.transforms = [
            timed(t) for t in ds.dataset.pipeline.transforms]
        t0 = time.perf_counter()
        samples = [ds[i] for i in range(n_samples)]
        per_sample = (time.perf_counter() - t0) / n_samples
        per_transform = {k: v * 1e3 / n_samples for k, v in spent.items()}
        n_pts = [int(s['points_mask'].sum()) for s in samples]
        n_gt = [int(s['gt_valid'].sum()) for s in samples]
        print(f'(L) train pipeline: {per_sample * 1e3:.1f} ms a sample, '
              f'serial over {n_samples} samples (points after '
              f'Pad3D {min(n_pts)}-{max(n_pts)}, GT boxes '
              f'{min(n_gt)}-{max(n_gt)}); ms a sample by transform '
              f'{ {k: round(v, 2) for k, v in per_transform.items()} }')
        summary.update(pipeline_ms_per_sample=per_sample * 1e3,
                       pipeline_ms_by_transform=per_transform)

        # train: one epoch of the RepeatDataset (8 steps), then resume
        work = os.path.join(tmp, 'work')
        out, runs, secs = run_cli('train', [
            cfg_path, '--work-dir', work, '--max-steps', str(L_STEPS),
            '--log-interval', '1', '--profile-steps', *map(str, L_PROFILE)],
            tmp, repo)
        check_launches('(L) train CLI', runs, LOOP_STEP_LAUNCHES, L_STEPS)
        launches['train'] = runs
        log = read_log(work)
        check([r['step'] for r in log] == list(range(1, L_STEPS + 1)),
              f'train log steps {[r["step"] for r in log]}')
        check(all(math.isfinite(r[k]) for r in log for k in (
            'loss', 'grad_norm', 'loss_cls', 'loss_bbox', 'loss_dir')),
            'a non-finite loss in the train log')
        for name in (f'ckpt_{L_STEPS}.pt', f'meta_{L_STEPS}.json'):
            check(os.path.exists(os.path.join(work, name)), f'no {name}')
        walls = [b['time'] - a['time'] for a, b in zip(log, log[1:])]
        peak = log[-1].get('memory', float('nan'))      # absent on a CPU
        waits = [r['data_time'] for r in log]
        med_all = statistics.median(walls[1:])          # steps 3..8
        med_plain = statistics.median(walls[1:L_PROFILE[0] - 1])
        window, busy = trace_busy(os.path.join(work, 'profile',
                                               'trace.json'))
        summary.update(
            step_wall_ms_median=med_all * 1e3,
            step_wall_ms_median_unprofiled=med_plain * 1e3,
            data_wait_ms_median=statistics.median(waits[2:]) * 1e3,
            peak_mib=peak, train_cli_s=secs,
            loss_first=log[0]['loss'], loss_last=log[-1]['loss'])
        print(f'(L) train CLI: {L_STEPS} steps at B = '
              f'{cfg.data["samples_per_gpu"]} in {secs:.1f} s; step wall '
              f'median over steps 3-{L_STEPS} {med_all * 1e3:.1f} ms '
              f'(steps 3-{L_PROFILE[0]}, profiler off, '
              f'{med_plain * 1e3:.1f}); wait on the prefetch queue per step '
              f'{[round(w * 1e3, 1) for w in waits]} ms; loss '
              f'{log[0]["loss"]:.4f} -> {log[-1]["loss"]:.4f}; peak '
              f'{peak:.1f} MiB; launches {runs} [{card}]')
        if window is None:
            print('(L) profile: no device time recorded; busy share not '
                  'measured')
        else:
            summary.update(profiled_window_ms=window, device_busy_ms=busy,
                           busy_share=busy / window)
            print(f'(L) profile of steps {L_PROFILE[0] + 1}-{L_PROFILE[1]} '
                  f'(torch.profiler in the loop): window {window:.1f} ms, '
                  f'device busy {busy:.1f} ms, busy share '
                  f'{100 * busy / window:.1f}% [{card}]')

        # resume: the card restores the checkpoint bitwise, count 8
        ckpt8 = os.path.join(work, f'ckpt_{L_STEPS}.pt')
        saved = load_checkpoint(ckpt8)
        det = build_detector(cfg, 'cuda', seed=1)
        state = det.init_train(optimizer=make_optimizer_from_cfg(
            cfg, L_RESUME_STEPS))
        state = restore_checkpoint(ckpt8, det, state)
        check(all(torch.equal(v.cpu(), saved['state_dict'][k])
                  for k, v in det.trunk.state_dict().items()),
              'restored parameters differ from the saved ones')
        check(state.opt_state.count == L_STEPS and state.step == L_STEPS,
              f'restored count {state.opt_state.count}, step {state.step}')
        check(all(torch.equal(state.opt_state.mu[k].cpu(), v)
                  for k, v in saved['opt_state']['mu'].items()),
              'restored moments differ from the saved ones')
        out, runs, secs = run_cli('train', [
            cfg_path, '--work-dir', work, '--max-steps', str(L_RESUME_STEPS),
            '--log-interval', '1', '--resume-from', ckpt8], tmp, repo)
        check_launches('(L) resumed train CLI', runs, LOOP_STEP_LAUNCHES,
                       L_RESUME_STEPS - L_STEPS)
        launches['train_resume'] = runs
        steps = [r['step'] for r in read_log(work)]
        check(steps == list(range(1, L_RESUME_STEPS + 1)),
              f'log steps after the resume {steps}')
        ckpt10 = os.path.join(work, f'ckpt_{L_RESUME_STEPS}.pt')
        check(load_checkpoint(ckpt10)['opt_state']['count']
              == L_RESUME_STEPS, 'the resumed run did not count on from 8')
        print(f'(L) resume from ckpt_{L_STEPS}.pt: parameters and moments '
              f'restored bitwise on the card, AdamW count {L_STEPS}; steps '
              f'{L_STEPS + 1}-{L_RESUME_STEPS} logged, ckpt_'
              f'{L_RESUME_STEPS}.pt written, {secs:.1f} s; launches {runs}')

        # evaluate: official KITTI metric alone (timed), then the flexible
        # metric, bf16 and --format-only together
        n_batches = -(-L_VAL // cfg.data['samples_per_gpu'])
        test = [cfg_path, ckpt10]
        out, runs, secs = run_cli('test', test + ['--metric', 'kitti'],
                                  tmp, repo)
        check_launches('(L) test CLI', runs, LOOP_PREDICT_LAUNCHES,
                       n_batches)
        launches['test'] = runs
        check(f'frames {L_VAL},' in out and 'AP11' in out and 'AP40' in out,
              'the test CLI printed no KITTI AP11/AP40 report')
        check_aps(report_json(out), 'kitti')
        line = next(x for x in out.splitlines() if x.startswith('frames '))
        ev = next(x for x in out.splitlines() if x.startswith('evaluate '))
        summary.update(test_cli_s=secs, predict_line=line, evaluate_line=ev)
        print(f'(L) test CLI --metric kitti: {line}; {ev}; '
              f'{secs:.1f} s; launches {runs} [{card}]')
        pkl = os.path.join(tmp, 'results.pkl')
        jobs = {'cowa': ['--metric', 'cowa'],
                'bf16': ['--bf16', '--metric', 'kitti'],
                'format': ['--format-only', '--out', pkl]}
        with ThreadPoolExecutor(len(jobs)) as pool:
            futs = {k: pool.submit(run_cli, 'test', test + a, tmp, repo)
                    for k, a in jobs.items()}
            done = {k: f.result() for k, f in futs.items()}
        for k, (out, runs, secs) in done.items():
            check_launches(f'(L) test CLI {k}', runs, LOOP_PREDICT_LAUNCHES,
                           n_batches)
            launches[f'test_{k}'] = runs
            check(f'frames {L_VAL},' in out, f'{k}: not {L_VAL} frames')
            if k != 'format':
                check_aps(report_json(out), k)
            print(f'(L) test CLI {" ".join(jobs[k])}: '
                  f'{out.splitlines()[0]}; {secs:.1f} s (three runs at '
                  f'once); launches {runs}')
        check('AP11' in done['bf16'][0], 'bf16: no AP11 report')
        with open(pkl, 'rb') as f:
            results = pickle.load(f)
        check(len(results) == L_VAL and all(
            len(r) == 3 and all(a.ndim == 2 and a.shape[1] == 8 for a in r)
            for r in results), 'the --out results are malformed')

        # kernels on the loop's inputs
        det.trunk.load_state_dict(load_checkpoint(ckpt10)['state_dict'])
        batch = to_device(collate_batch(samples), det.device)
        vds, _ = build_dataloader(cfg, 'val')
        val_batch = to_device(collate_batch(
            [vds[i] for i in range(cfg.data['samples_per_gpu'])]),
            det.device)
        results = loop_kernel_checks(cfg, det, batch, val_batch, card)
    wall = time.perf_counter() - t_phase
    summary['phase_s'] = wall
    print(f'(L) phase wall {wall:.1f} s [{card}]')
    check(wall < L_LIMIT_S, f'phase (L) took {wall:.1f} s')
    return results, launches, summary


# ------------------------------------------------- phases (n) to (N)
# CenterPoint on nuScenes: the gwd5 config (CenterGDHead) at its full
# width, and the plain CenterHead config for one step
CP_CONFIG = ('configs/nuscenes/'
             'centerpoint_02pillar_second_secfpn_gwd5_8x4_cyclic_20e_nus.py')
CP_PLAIN_CONFIG = ('configs/nuscenes/'
                   'centerpoint_02pillar_second_secfpn_8x4_cyclic_20e_nus.py')
CP_DEVICE = 'cuda'
# B samples of N five-channel points padded to G GT rows (the dataset
# config's samples_per_gpu and Pad3D), requests from three seeds
CP_BATCH, CP_POINTS, CP_GT, CP_SEEDS = 4, 60000, 128, (0, 1, 2)
# the gwd5 config's code_weights has 12 entries for its 11-channel box code
# (yaw mode, velocity on): the loss raises in the JAX package (a broadcast
# error) and in the port (ValueError).  The train phases use its evident
# intent, the plain config's weights with the yaw channel: 1 for the box
# and the direction, 0.2 for the velocity
CP_CODE_WEIGHTS = [1.0] * 7 + [1.0, 1.0, 0.2, 0.2]
# mmdet3d's nuScenes CenterPoint test_cfg min_radius, one a task
CP_CIRCLE_RADII = [4.0, 12.0, 10.0, 1.0, 0.85, 0.175]
# a predict: K1 reduce and mapback once (the dynamic encoder), K7 (the s2d
# canvas), K5 and K6 once over every (sample, task) problem
CP_PREDICT_LAUNCHES = {'segment_reduce': 1, 'segment_reduce_mapback': 1,
                       'bev_splat_pairs': 1, 'rotated_iou': 1,
                       'nms_sweep': 1}
# a train step: every BatchNorm's moments both ways (19 in the trunk, the
# shared conv's, 6 tasks x 7 towers in yaw mode, x 6 in the plain head),
# the encoder's winner and mapback, one splat
CP_STEP_LAUNCHES = {'bn_moments': 62, 'bn_grad_moments': 62,
                    'segment_max_winner': 1, 'segment_reduce_mapback': 1,
                    'bev_splat_pairs': 1}
CP_PLAIN_STEP_LAUNCHES = dict(CP_STEP_LAUNCHES, bn_moments=56,
                              bn_grad_moments=56)
# phase (N): a nuScenes-format tree of train and val frames, each a key
# frame and the sweeps the config loads, of CP_SWEEP_POINTS points each
CP_TRAIN_FRAMES, CP_VAL_FRAMES, CP_CLI_STEPS = 8, 8, 3
CP_SWEEPS, CP_SWEEP_POINTS = 9, 6000
NUS_CLASSES = ('car', 'truck', 'trailer', 'bus', 'construction_vehicle',
               'bicycle', 'motorcycle', 'pedestrian', 'traffic_cone',
               'barrier')


def cp_configs(repo):
    """(model, head) of the gwd5 config and of the plain config."""
    from mmdet3d_gaussian_tpu_torch.utils.config import Config
    out = []
    for path in (CP_CONFIG, CP_PLAIN_CONFIG):
        cfg = Config.fromfile(os.path.join(repo, path)).to_dict()
        out.append((cfg['model'], cfg['head']))
    return out


def cp_batches(seeds=CP_SEEDS):
    from mmdet3d_gaussian_tpu_torch.engine.detector import synthetic_nus_batch
    return [synthetic_nus_batch(CP_BATCH, CP_POINTS, CP_GT, seed=s,
                                device=CP_DEVICE) for s in seeds]


def cp_detector(model, head, **model_over):
    """A CenterPoint detector from a seed with the heatmap biases zeroed,
    so that the candidates clear the score threshold and NMS has work."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import CenterPointDetector
    from mmdet3d_gaussian_tpu_torch.models.dense_heads.centerpoint_head \
        import SeparateHead
    det = CenterPointDetector(dict(model, **model_over), head,
                              device=CP_DEVICE, seed=0)
    check(det.trunk.s2d, 'the CenterPoint config did not take the s2d canvas')
    with torch.no_grad():
        for m in det.trunk.bbox_head.modules():
            if isinstance(m, SeparateHead):
                m.heatmap[-1].bias.zero_()
    return det


def cp_kernel_checks(inputs, card):
    """K1 (reduce, mapback), K7, K5 and K6 on one full-width CenterPoint
    predict's inputs, each held to its plain version at phase (b)'s
    tolerance, timed beside its bound and, where PyTorch has one, its
    one-call yardstick (printed, not held: a first measurement at these
    shapes)."""
    from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou, segment
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    results, note = {}, ' (centerpoint predict)'

    def record(name, kernel, plain, library, err, tol, ok, work, iters,
               plain_iters):
        report(results, name, card, err, tol, ok, kernel, plain, library,
               iters, plain_iters, *work, note)

    data, starts, counts, op = inputs['segment_reduce']
    out = segment.segment_reduce(data, starts, counts, op)
    ref = segment.segment_reduce_plain(data, starts, counts, op)
    n_live = int(torch.count_nonzero(counts))
    rows, lengths = int(counts.sum()), counts[:n_live].long()
    err = float((out - ref).abs().max())
    record('segment_reduce',
           lambda: segment.segment_reduce(data, starts, counts, op),
           lambda: segment.segment_reduce_plain(data, starts, counts, op),
           lambda: torch.segment_reduce(data[:rows], op, lengths=lengths,
                                        unsafe=True), err, '0', err == 0,
           k1_work('reduce', data, None, starts, counts), 100, 5)
    print(f'(n) segment_reduce inputs: {data.shape[0]} rows x '
          f'{data.shape[1]} channels into {n_live} live of '
          f'{counts.shape[0]} voxels')

    # the cluster sums of nuScenes xyz reach ~1e3 m near the sensor, where
    # phase (b)'s absolute 1e-4 is an f32 summation-order difference: the
    # sum is held, as K4's are, to 1e-5 of its segment's sum of magnitudes
    data, ids, starts, counts, op = inputs['segment_reduce_mapback']
    out = segment.segment_reduce_mapback(data, ids, starts, counts, op)
    ref = segment.segment_reduce_mapback_plain(data, ids, starts, counts, op)
    mags = segment.segment_reduce_mapback_plain(data.abs(), ids, starts,
                                                counts, op)
    err = float((out - ref).abs().max())
    rel = float(((out - ref).abs() / mags.clamp(min=1e-30)).max())
    print(f'(n) segment_reduce_mapback: max error {err:.3g}, of the '
          f'segment\'s sum of magnitudes {rel:.3g}; largest sum of '
          f'magnitudes {float(mags.max()):.1f}')
    record('segment_reduce_mapback',
           lambda: segment.segment_reduce_mapback(data, ids, starts, counts,
                                                  op),
           lambda: segment.segment_reduce_mapback_plain(data, ids, starts,
                                                        counts, op),
           None, err, '1e-5 of the sum of magnitudes', rel <= 1e-5,
           k1_work('mapback', data, ids, starts, counts), 100, 5)

    feats, lin2, par, ncell2 = inputs['bev_splat_pairs']
    out = voxelize.bev_splat_pairs(feats, lin2, par, ncell2)
    ref = voxelize.bev_splat_pairs_plain(feats, lin2, par, ncell2)
    c = feats.shape[1]
    live = lin2 < ncell2
    ids_l, rows_l = voxelize.pair_rows(lin2, par, ncell2)[live], feats[live]
    canvas = torch.zeros_like(ref)
    half_rows = canvas.view(2 * ncell2, c)
    lib = lambda: half_rows.zero_().index_copy_(  # noqa: E731
        0, ids_l, rows_l)
    lib()
    check(torch.equal(canvas, ref), 'index_copy_ yardstick disagrees')
    print(f'(n) bev_splat_pairs inputs: {feats.shape[0]} rows x {c} '
          f'{feats.dtype} ({int(live.sum())} live) onto {ncell2} x {2 * c}')
    record('bev_splat_pairs',
           lambda: voxelize.bev_splat_pairs(feats, lin2, par, ncell2),
           lambda: voxelize.bev_splat_pairs_plain(feats, lin2, par, ncell2),
           lib, float((out.float() - ref.float()).abs().max()), '0, equal',
           bool(torch.equal(out, ref)),
           (feats.numel() * feats.element_size() + 2 * lin2.numel() * 4
            + ncell2 * 2 * c * feats.element_size(), 0), 50, 5)

    (boxes,) = inputs['rotated_iou']
    p, k = boxes.shape[:2]
    out = rotated_iou.iou_bev_pairwise(boxes)
    ref = rotated_iou.iou_bev_pairwise_plain(boxes)
    print(f'(n) rotated_iou inputs: {p} problems (samples x tasks) x {k} '
          f'candidates, share of pairs with IoU > 0.01: '
          f'{float((ref > 0.01).float().mean()):.4f}')
    n_near = k5_cull(boxes, out, ref, card, 'centerpoint predict inputs')
    err = float((out - ref).abs().max())
    record('rotated_iou', lambda: rotated_iou.iou_bev_pairwise(boxes),
           lambda: rotated_iou.iou_bev_pairwise_plain(boxes), None, err,
           '1e-5', err <= 1e-5, k5_work(boxes, n_near), 50, 3)
    results['rotated_iou']['near_share'] = n_near / (p * k * k)

    iou, valid, thr = inputs['nms_sweep']
    keep = nms.suppress_sweep(iou, valid, thr)
    ref = nms.suppress_sweep_plain(iou, valid, thr)
    exact = bool(torch.equal(keep, ref))
    share = float(ref.sum() / valid.sum().clamp(min=1))
    print(f'(n) nms_sweep inputs: {p} problems x {k}, thr {thr}; valid '
          f'{int(valid.sum())} of {valid.numel()}, kept share of the valid '
          f'{share:.4f}')
    record('nms_sweep', lambda: nms.suppress_sweep(iou, valid, thr),
           lambda: nms.suppress_sweep_plain(iou, valid, thr), None,
           float((keep.int() - ref.int()).abs().max()), '0, equal', exact,
           k6_work(valid, ref), 50, 3)
    results['nms_sweep']['kept_share'] = share

    # circle NMS (the sweep on -d^2 with threshold -min_radius) on the same
    # candidates, each task at its radius: the kernel's keep equal to the
    # plain sweep's
    centers = boxes[..., :2].contiguous()
    n_task = len(CP_CIRCLE_RADII)
    kept, total = 0, 0
    for t, r in enumerate(CP_CIRCLE_RADII):
        c_t, v_t = centers[t::n_task].contiguous(), valid[t::n_task]
        got = nms.circle_nms(c_t, r, v_t)
        d2 = ((c_t[:, :, None] - c_t[:, None]) ** 2).sum(-1)
        want = nms.suppress_sweep_plain(-d2, v_t, -r)
        check(torch.equal(got, want), f'circle NMS task {t}: the K6 keep '
              f'differs from the plain sweep')
        kept, total = kept + int(want.sum()), total + int(v_t.sum())
    print(f'(n) circle NMS on the same candidates (min_radius a task '
          f'{CP_CIRCLE_RADII}): K6 keep equal to the plain sweep in every '
          f'task, kept {kept} of {total} valid [{card}]')
    results['nms_sweep']['circle_kept_share'] = kept / max(total, 1)
    return results


def cp_predict_phase(det, batches, tag, card):
    """(n) or (n16): the predict answering len(batches) x ROUNDS
    requests with launch counts, its profile and the head's share of it.
    -> (launches, summary)."""
    launches, e2e = main_path(
        det, batches, CP_PREDICT_LAUNCHES, tag, card,
        out_rows=det.head.test_cfg['post_max_size'], num_classes=10,
        box_dim=9, points=CP_POINTS)
    e2e.update(device_profile(lambda: det.predict(batches[0]), 'predict',
                              tag, card, 5))
    seen = []
    hook = det.trunk.bbox_head.register_forward_hook(
        lambda mod, args, out: seen.append(args[0]))
    det.predict(batches[0])
    hook.remove()
    with torch.inference_mode():
        head_ms = device_ms(lambda: det.trunk.bbox_head(seen[0]), 5)
    e2e['head_ms'] = head_ms
    if e2e.get('device_busy_ms'):
        e2e['head_share'] = head_ms / e2e['device_busy_ms']
        print(f'{tag} the head (shared conv and the 6 tasks\' towers, '
              f'{tuple(seen[0].shape)} in) takes {head_ms:.3f} device ms '
              f'a predict, {100 * e2e["head_share"]:.1f}% of the device '
              f'busy time [{card}]')
    return launches, e2e


def cp_step_checks(det, batch, state, card):
    """(nt): K1's winner form and K4 on every BatchNorm of one full-width
    step, held to their plain versions and timed.  -> (results, state)."""
    from mmdet3d_gaussian_tpu_torch.ops import segment
    capture = {k: v for k, v in CP_STEP_LAUNCHES.items()
               if k != 'segment_reduce_mapback'}
    inputs, state = capture_train_inputs(det, batch, state, capture)
    results, note = {}, ' (centerpoint step)'
    with torch.no_grad():
        ((data, ids, starts, counts),) = inputs['segment_max_winner']
        out, mask = segment.segment_max_winner(data, ids, starts, counts)
        ref, ref_m = segment.segment_max_winner_plain(data, ids, starts,
                                                      counts)
        exact = bool(torch.equal(out, ref) and torch.equal(mask, ref_m))
        report(results, 'segment_max_winner', card,
               float((out - ref).abs().max()), '0, masks equal', exact,
               lambda: segment.segment_max_winner(data, ids, starts, counts),
               lambda: segment.segment_max_winner_plain(data, ids, starts,
                                                        counts), None,
               100, 3, *k1_work('winner', data, ids, starts, counts),
               f' exact_equal={exact}{note}')
        check_k4(results, inputs, card, note)
    return results, state


def write_nus_tree(root, seed=0):
    """A nuScenes-format tree (mmdet3d's info schema): CP_TRAIN_FRAMES +
    CP_VAL_FRAMES frames, each a key frame of CP_SWEEP_POINTS five-channel
    points (x, y, z, intensity, ring) and CP_SWEEPS earlier sweeps, turned
    and shifted a little a sweep with their timestamps 0.05 s apart, and
    30-40 GT boxes of the 10 classes with velocities (synthetic_nus_batch's
    scenes).  -> {split: info pickle path}."""
    import pickle
    from mmdet3d_gaussian_tpu_torch.engine.detector import synthetic_nus_batch
    os.makedirs(os.path.join(root, 'samples'), exist_ok=True)
    paths = {}
    frame = 0
    for split, n in (('train', CP_TRAIN_FRAMES), ('val', CP_VAL_FRAMES)):
        infos = []
        for _ in range(n):
            scene = synthetic_nus_batch(1 + CP_SWEEPS, CP_SWEEP_POINTS, 40,
                                        seed=seed + frame, sweeps=1,
                                        device='cpu')
            pts = scene['points'].numpy()
            pts[..., 4] = np.random.RandomState(frame).randint(
                0, 32, pts.shape[:2])
            g = int(scene['gt_valid'][0].sum())
            gt = scene['gt_bboxes'][0, :g].numpy()
            names = np.asarray(NUS_CLASSES)[scene['gt_labels'][0, :g]
                                            .numpy()]
            stamp = 1_000_000 * (100 + frame)
            key = os.path.join(root, 'samples', f'{frame:05d}.bin')
            pts[0].tofile(key)
            sweeps = []
            for s in range(1, 1 + CP_SWEEPS):
                path = os.path.join(root, 'samples', f'{frame:05d}_{s}.bin')
                pts[s].tofile(path)
                ang = 0.01 * s
                sweeps.append(dict(
                    data_path=path,
                    sensor2lidar_rotation=np.array(
                        [[np.cos(ang), -np.sin(ang), 0],
                         [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                        np.float32),
                    sensor2lidar_translation=np.array([0.4 * s, 0, 0],
                                                      np.float32),
                    timestamp=stamp - 50_000 * s))
            infos.append(dict(lidar_path=key, timestamp=stamp,
                              sweeps=sweeps, gt_boxes=gt[:, :7],
                              gt_names=names, gt_velocity=gt[:, 7:9]))
            frame += 1
        paths[split] = os.path.join(root, f'nuscenes_infos_{split}.pkl')
        with open(paths[split], 'wb') as f:
            pickle.dump(dict(infos=infos), f)
    return paths


def cp_derived_config(tmp, root, paths, repo):
    """Write ``tmp/centerpoint_local.py``: ``_base_`` the gwd5 config by
    absolute path, its data paths moved under ``root`` and its
    code_weights set to CP_CODE_WEIGHTS; check that it loads to the gwd5
    config with those changed and nothing else.  -> (path, config)."""
    from mmdet3d_gaussian_tpu_torch.utils.config import Config
    base = os.path.join(repo, CP_CONFIG)
    want = Config.fromfile(base).to_dict()
    want['data']['train']['dataset'].update(data_root=root,
                                            ann_file=paths['train'])
    want['data']['val'].update(data_root=root, ann_file=paths['val'])
    want['head']['code_weights'] = CP_CODE_WEIGHTS
    text = (f'_base_ = [{base!r}]\n'
            f'head = dict(code_weights={CP_CODE_WEIGHTS!r})\n'
            f'data = dict(\n'
            f'    train=dict(dataset=dict(data_root={root!r}, '
            f'ann_file={paths["train"]!r})),\n'
            f'    val=dict(data_root={root!r}, ann_file={paths["val"]!r}))\n')
    path = os.path.join(tmp, 'centerpoint_local.py')
    with open(path, 'w') as f:
        f.write(text)
    cfg = Config.fromfile(path)
    check(cfg.to_dict() == want, 'the derived config differs from the gwd5 '
          'config beyond its data paths and code_weights')
    return path, cfg


def cp_cli_phase(repo, card):
    """(N): the gwd5 config through the port's CLIs on a nuScenes-format
    tree written here: train CP_CLI_STEPS steps, then test under both
    nuScenes metrics.  -> (launches per CLI run, summary)."""
    import tempfile
    t_phase = time.perf_counter()
    summary, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_nus_') as tmp:
        root = os.path.join(tmp, 'nuscenes')
        paths = write_nus_tree(root)
        cfg_path, cfg = cp_derived_config(tmp, root, paths, repo)
        b = cfg.data['samples_per_gpu']
        print(f'(N) nuScenes-format tree: {CP_TRAIN_FRAMES} train and '
              f'{CP_VAL_FRAMES} val frames of 1 + {CP_SWEEPS} sweeps x '
              f'{CP_SWEEP_POINTS} points; config {CP_CONFIG} with its data '
              f'paths moved and code_weights {CP_CODE_WEIGHTS} (B {b}, '
              f'{cfg.data["train"]["type"]}) '
              f'[{time.perf_counter() - t_phase:.1f} s]')
        work = os.path.join(tmp, 'work')
        out, runs, secs = run_cli('train', [
            cfg_path, '--work-dir', work, '--max-steps', str(CP_CLI_STEPS),
            '--log-interval', '1'], tmp, repo)
        check_launches('(N) train CLI', runs, CP_STEP_LAUNCHES, CP_CLI_STEPS)
        launches['train'] = runs
        log = read_log(work)
        check([r['step'] for r in log] == list(range(1, CP_CLI_STEPS + 1)),
              f'train log steps {[r["step"] for r in log]}')
        terms = [k for k in log[0] if k.startswith('task')]
        check(len(terms) == 18 and all(
            math.isfinite(r[k]) for r in log for k in terms + ['loss']),
            'a missing or non-finite loss term in the train log')
        walls = [bb['time'] - a['time'] for a, bb in zip(log, log[1:])]
        waits = [r['data_time'] for r in log]
        summary.update(
            train_cli_s=secs, step_wall_ms=[w * 1e3 for w in walls],
            data_wait_ms=[w * 1e3 for w in waits],
            peak_mib=log[-1].get('memory', float('nan')),
            loss=[r['loss'] for r in log])
        print(f'(N) train CLI: {CP_CLI_STEPS} steps at B = {b} in '
              f'{secs:.1f} s; step wall (between log lines) '
              f'{[round(w * 1e3, 1) for w in walls]} ms; wait on the '
              f'prefetch queue {[round(w * 1e3, 1) for w in waits]} ms; loss '
              f'{[round(r["loss"], 4) for r in log]}; peak '
              f'{summary["peak_mib"]:.1f} MiB; launches {runs} [{card}]')

        ckpt = os.path.join(work, f'ckpt_{CP_CLI_STEPS}.pt')
        n_batches = -(-CP_VAL_FRAMES // b)
        jobs = {'nds': ('NDS', ['--metric', 'nds']),
                'iou3d_err': ('mAIE', ['--metric', 'iou3d_err'])}
        with ThreadPoolExecutor(len(jobs)) as pool:
            futs = {k: pool.submit(run_cli, 'test', [cfg_path, ckpt] + a,
                                   tmp, repo)
                    for k, (_, a) in jobs.items()}
            done = {k: f.result() for k, f in futs.items()}
        for k, (out, runs, secs) in done.items():
            check_launches(f'(N) test CLI {k}', runs, CP_PREDICT_LAUNCHES,
                           n_batches)
            launches[f'test_{k}'] = runs
            check(f'frames {CP_VAL_FRAMES},' in out,
                  f'{k}: not {CP_VAL_FRAMES} frames')
            rep = report_json(out)
            check(jobs[k][0] in rep and all(map(math.isfinite,
                                                rep.values())),
                  f'{k}: no {jobs[k][0]} or a non-finite metric: {rep}')
            summary[f'test_{k}'] = {m: rep[m] for m in rep
                                    if '_' not in m or m == jobs[k][0]}
            summary[f'test_{k}_s'] = secs
            print(f'(N) test CLI --metric {k}: {out.splitlines()[0]}; '
                  f'{secs:.1f} s (two runs at once); launches {runs}; '
                  f'{json.dumps(summary[f"test_{k}"])}')
    wall = time.perf_counter() - t_phase
    summary['phase_s'] = wall
    print(f'(N) phase wall {wall:.1f} s [{card}]')
    return launches, summary


def centerpoint_phases(repo, card):
    """Phases (n), (n16), (nt) and (N).  -> (kernel numbers, launches by
    path, summaries)."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import CenterPointDetector
    t0 = time.perf_counter()
    (model, head), (pmodel, phead) = cp_configs(repo)
    batches = cp_batches()
    det = cp_detector(model, head)
    with torch.inference_mode():
        _, coords, sc = det.trunk.pillars(batches[0]['points'],
                                          batches[0]['points_mask'])
        per = torch.bincount(coords[:int(sc.num_voxels), 0].long(),
                             minlength=CP_BATCH).tolist()
    print(f'(n) gwd5 CenterPoint, {CP_BATCH} x {CP_POINTS} points a '
          f'request: live pillars a sample {per} (capacity '
          f'{det.trunk.max_voxels_per_sample} a sample, {sc.max_voxels} '
          f'for the batch), truncated {int(sc.num_overflow)}; canvas '
          f'{det.trunk.nx} x {det.trunk.ny}, feature map '
          f'{det.featmap_size}')
    check(all(20000 <= n <= 30000 for n in per),
          f'live pillars a sample {per}, want 20,000-30,000')
    inputs = capture_inputs(det, batches[0], CP_PREDICT_LAUNCHES)
    with torch.inference_mode():
        results = cp_kernel_checks(inputs, card)
    del inputs
    launches, summary = {}, {}
    launches['predict'], summary['predict'] = cp_predict_phase(
        det, batches, '(n)', card)
    # circle NMS through the whole predict: one K6 launch a distinct radius
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    rotate_cfg = dict(det.head.test_cfg)
    det.head.test_cfg.update(nms_type='circle', min_radius=CP_CIRCLE_RADII)
    _cuda.reset_launches()
    boxes, scores, labels, valid = det.predict(batches[0])
    torch.cuda.synchronize()
    circle = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    det.head.test_cfg = rotate_cfg
    check(circle.get('nms_sweep') == len(set(CP_CIRCLE_RADII))
          and 'rotated_iou' not in circle, f'circle predict launches '
          f'{circle}')
    check(bool(torch.isfinite(boxes).all() and valid.any(1).all()),
          'circle predict: non-finite boxes or a sample kept nothing')
    launches['predict_circle'] = circle
    print(f'(n) the predict with circle NMS: launches {circle}, '
          f'{int(valid.sum())} boxes kept [{card}]')
    del det
    torch.cuda.empty_cache()

    det16 = cp_detector(model, head, compute_dtype='bfloat16')
    launches['predict_bf16'], summary['predict_bf16'] = cp_predict_phase(
        det16, batches, '(n16)', card)
    del det16
    torch.cuda.empty_cache()

    # (nt): the gwd5 train step at full width on one repeated batch
    thead = dict(head, code_weights=CP_CODE_WEIGHTS)
    tdet = CenterPointDetector(model, thead, device=CP_DEVICE, seed=0)
    tbatch = batches[0]
    n_gt = tbatch['gt_valid'].sum(1).tolist()
    print(f'(nt) gwd5 train step, {CP_BATCH} x {CP_POINTS} points, GT boxes '
          f'a sample {n_gt} of {len(NUS_CLASSES)} classes with velocities; '
          f'code_weights {CP_CODE_WEIGHTS}')
    state = tdet.init_train(LR, total_steps=100)
    state, _ = tdet.train_step(tbatch, state)          # warm-up
    step_k, state = cp_step_checks(tdet, tbatch, state, card)
    results.update(step_k)
    launches['train'], state, summary['train'] = timed_steps(
        tdet, tbatch, state, CP_STEP_LAUNCHES, '(nt)', card,
        points=CP_POINTS)
    holder = [state]

    def one_step():
        holder[0] = tdet.train_step(tbatch, holder[0])[0]
    summary['train'].update(device_profile(one_step, 'train step', '(nt)',
                                           card, 3))
    del tdet, holder, state
    torch.cuda.empty_cache()
    pdet = CenterPointDetector(pmodel, phead, device=CP_DEVICE, seed=0)
    _cuda.reset_launches()
    _, metrics = pdet.train_step(tbatch)
    torch.cuda.synchronize()
    row = {k: float(v) for k, v in metrics.items()}
    check(all(map(math.isfinite, row.values())) and len(row) == 14,
          f'plain CenterHead step: {row}')
    launches['train_plain'] = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    check(launches['train_plain'] == CP_PLAIN_STEP_LAUNCHES,
          f'plain CenterHead step launches {launches["train_plain"]}')
    print(f'(nt) one step of the plain CenterHead config '
          f'({CP_PLAIN_CONFIG}): {json.dumps(row)}; launches '
          f'{launches["train_plain"]} [{card}]')
    del pdet, batches, tbatch
    torch.cuda.empty_cache()

    cli_launches, summary['cli'] = cp_cli_phase(repo, card)
    launches.update({f'cli_{k}': v for k, v in cli_launches.items()})
    summary['phases_s'] = time.perf_counter() - t0
    print(f'(n)-(N) wall {summary["phases_s"]:.1f} s [{card}]')
    return results, launches, summary


# ------------------------------------------------- phases (m) to (M)
# MVF on KITTI: the two views' towers on the pillar trunk, at the KITTI
# configs' full width
MVF_CONFIG = ('configs/kitti/'
              'pillarmvf_pointpillars_secfpn_8x4_160e_kitti-3d-3class.py')
MVF_CP_CONFIG = ('configs/kitti/'
                 'pillarmvf_centerpoint_secfpn_8x4_160e_kitti-3d-3class.py')
# a predict: K1's max in each view's point net and the fused max on view
# 0's pillars (3 reduces), each view's cluster mean and covariance (4
# mapbacks), a splat onto each view's canvas and the trunk's (3 K2), NMS
MVF_PREDICT_LAUNCHES = {'segment_reduce': 3, 'segment_reduce_mapback': 4,
                        'bev_splat': 3, 'rotated_iou': 1, 'nms_sweep': 1}
# a step: the three maxes' winner forms, the four mapbacks, three splats,
# and K4 on SECOND's 16, the neck's 3 and the towers' 2 x 8 BatchNorms
MVF_STEP_LAUNCHES = {'bn_moments': 35, 'bn_grad_moments': 35,
                     'segment_max_winner': 3, 'segment_reduce_mapback': 4,
                     'bev_splat': 3}
MVF_DENSE_LAUNCHES = {**MVF_STEP_LAUNCHES, **DENSE_LAUNCHES}
# the center config's step: the shared conv's BatchNorm and 3 tasks x 6
# towers' (no velocity) more
MVF_CP_STEP_LAUNCHES = dict(MVF_STEP_LAUNCHES, bn_moments=54,
                            bn_grad_moments=54)
# the canvases K2 writes in a forward, in call order
MVF_CANVASES = ('cartesian view', 'cylindrical view', 'trunk')
# phase (M): a raw KITTI tree of train and val frames
MVF_TRAIN_FRAMES, MVF_VAL_FRAMES, MVF_CLI_STEPS = 16, 8, 3
MVF_BAND = dict(n_lo=2, n_hi=4, repeats=3)


def mvf_configs(repo):
    """{path: (model, head)} of the MVF configs."""
    from mmdet3d_gaussian_tpu_torch.utils.config import Config
    out = {}
    for path in (MVF_CONFIG, MVF_CP_CONFIG):
        cfg = Config.fromfile(os.path.join(repo, path)).to_dict()
        out[path] = (cfg['model'], cfg.get('head'))
    return out


def mvf_detector(model, head, **head_over):
    """The config's detector from a seed, its cls (anchor) or heatmap
    (center) biases zeroed so that NMS has candidates."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import (
        CenterPointDetector, PointPillarsDetector)
    from mmdet3d_gaussian_tpu_torch.models.dense_heads.centerpoint_head \
        import SeparateHead
    center = model.get('head_type') == 'center'
    cls = CenterPointDetector if center else PointPillarsDetector
    det = cls(model, dict(head or {}, **head_over), device='cuda', seed=0)
    with torch.no_grad():
        if not center:
            det.trunk.bbox_head.conv_cls.bias.zero_()
        for m in det.trunk.bbox_head.modules():
            if isinstance(m, SeparateHead):
                m.heatmap[-1].bias.zero_()
    return det


def mvf_counts(det, batch, tag):
    """Print the live points of each view, after the cross-view mask, and
    the live voxels of each view.  -> summary."""
    from mmdet3d_gaussian_tpu_torch.models.mvf_encoder import VIEW_TRANSFORMS
    from mmdet3d_gaussian_tpu_torch.ops.scatter import compute_voxel_coords
    enc = det.trunk.voxel_encoder
    pts, mask = batch['points'], batch['points_mask']
    n = int(mask.sum())
    flat = pts.reshape(-1, pts.shape[-1])
    in_view = {}
    with torch.inference_mode():
        for name, vs, pcr in zip(enc.view_names, enc.voxel_size,
                                 enc.point_cloud_range):
            c3, _ = compute_voxel_coords(VIEW_TRANSFORMS[name](flat)[:, :3],
                                         pcr, vs)
            in_view[name] = int(((c3 >= 0).all(-1) & mask.reshape(-1))
                                .sum())
        _, scatters, valid, _ = enc.scatters(
            pts, mask, det.trunk.max_voxels_per_sample * pts.shape[0])
    live = int(valid.sum())
    voxels = {name: (int(sc.num_voxels), int(sc.num_overflow))
              for name, sc in zip(enc.view_names, scatters)}
    grids = {name: (net.nx, net.ny) for name, net in enc.views.items()}
    print(f'{tag} {pts.shape[0]} x {pts.shape[1]} points: in each view '
          f'{in_view} of {n}; after the cross-view mask {live} '
          f'({live / n:.4f}); live voxels of each view (kept, truncated) '
          f'{voxels} of {scatters[0].max_voxels}; canvases (nx, ny) '
          f'{grids}')
    check(0 < live <= min(in_view.values()), 'cross-view mask')
    return dict(points_in_view=in_view, points_live=live,
                live_share=live / n, voxels=voxels)


def mvf_kernel_checks(calls, card):
    """Phase (m): K1 (each reduce and mapback call), K2 (each canvas), K5
    and K6 on one full-width MVF predict's inputs, each held to its plain
    version at phase (b)'s tolerance and timed beside its bound and its
    one-call yardstick (printed, not gated: the first times at these
    shapes).  -> {kernel: {call: numbers}}."""
    from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou, segment
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    out = {}

    def record(name, call, *args, **kw):
        results = {}
        report(results, name, card, *args, **kw)
        out.setdefault(name, {})[call] = results[name]

    for i, (data, starts, counts, op) in enumerate(calls['segment_reduce']):
        call = ('cartesian view max', 'cylindrical view max',
                'fused max on view 0')[i]
        got = segment.segment_reduce(data, starts, counts, op)
        err = float((got - segment.segment_reduce_plain(
            data, starts, counts, op)).abs().max())
        n_live = int(torch.count_nonzero(counts))
        rows, lengths = int(counts.sum()), counts[:n_live].long()
        check(bool((counts[n_live:] == 0).all()), 'live voxels not first')
        print(f'(m) segment_reduce {call}: {data.shape[0]} rows x '
              f'{data.shape[1]} into {n_live} live of {counts.shape[0]} '
              f'voxels ({rows} rows in them)')
        record('segment_reduce', call, err, '0', err == 0,
               lambda a=(data, starts, counts, op): segment.segment_reduce(
                   *a),
               lambda a=(data, starts, counts, op):
               segment.segment_reduce_plain(*a),
               lambda d=data[:rows], ln=lengths, o=op: torch.segment_reduce(
                   d, o, lengths=ln, unsafe=True), 100, 3,
               *k1_work('reduce', data, None, starts, counts),
               f' ({call}, mvf predict)')
    # f32 sums in another order: each held to phase (b)'s 1e-4, or to 1e-5
    # of its segment's sum of magnitudes where that is larger (the
    # cylindrical view's rho reaches 71 m)
    for i, args in enumerate(calls['segment_reduce_mapback']):
        call = (f'{MVF_CANVASES[i // 2].split()[0]} view '
                f'{("cluster mean", "covariance")[i % 2]}')
        data, ids, starts, counts, op = args
        got = segment.segment_reduce_mapback(*args)
        want = segment.segment_reduce_mapback_plain(*args)
        mags = segment.segment_reduce_mapback_plain(data.abs(), ids, starts,
                                                    counts, op)
        diff = (got - want).abs()
        ok = bool((diff <= torch.clamp(1e-5 * mags, min=1e-4)).all())
        print(f'(m) segment_reduce_mapback {call}: {data.shape[0]} rows x '
              f'{data.shape[1]}, max error {float(diff.max()):.3g}, largest '
              f'sum of magnitudes {float(mags.max()):.1f}')
        record('segment_reduce_mapback', call, float(diff.max()),
               'max(1e-4, 1e-5 of the sum of magnitudes)', ok,
               lambda a=args: segment.segment_reduce_mapback(*a),
               lambda a=args: segment.segment_reduce_mapback_plain(*a), None,
               100, 3, *k1_work('mapback', data, ids, starts, counts),
               f' ({call}, mvf predict)')
    for call, (feats, lin, ncell) in zip(MVF_CANVASES, calls['bev_splat']):
        got = voxelize.bev_splat(feats, lin, ncell)
        ref = voxelize.bev_splat_plain(feats, lin, ncell)
        live = lin < ncell
        canvas = torch.zeros_like(ref)
        ids_l, rows_l = lin[live].long(), feats[live]
        lib = lambda c=canvas, i=ids_l, r=rows_l: c.zero_().index_copy_(  # noqa: E731
            0, i, r)
        lib()
        check(torch.equal(canvas, ref), 'index_copy_ yardstick disagrees')
        print(f'(m) bev_splat {call}: {feats.shape[0]} rows x '
              f'{feats.shape[1]} ({int(live.sum())} live) onto {ncell} cells')
        record('bev_splat', call, float((got - ref).abs().max()), '0, equal',
               bool(torch.equal(got, ref)),
               lambda a=(feats, lin, ncell): voxelize.bev_splat(*a),
               lambda a=(feats, lin, ncell): voxelize.bev_splat_plain(*a),
               lib, 50, 3,
               # live rows read (the trash rows are not needed), every id
               # read, the canvas written
               int(live.sum()) * feats.shape[1] * 4 + lin.numel() * 4
               + ncell * feats.shape[1] * 4, 0, f' ({call}, mvf predict)')
    ((boxes,),) = calls['rotated_iou']
    got = rotated_iou.iou_bev_pairwise(boxes)
    ref = rotated_iou.iou_bev_pairwise_plain(boxes)
    n_near = k5_cull(boxes, got, ref, card, 'mvf predict inputs')
    err = float((got - ref).abs().max())
    record('rotated_iou', 'predict', err, '1e-5', err <= 1e-5,
           lambda: rotated_iou.iou_bev_pairwise(boxes),
           lambda: rotated_iou.iou_bev_pairwise_plain(boxes), None, 20, 2,
           *k5_work(boxes, n_near), ' (mvf predict)')
    ((iou, valid, thr),) = calls['nms_sweep']
    keep = nms.suppress_sweep(iou, valid, thr)
    ref = nms.suppress_sweep_plain(iou, valid, thr)
    record('nms_sweep', 'predict',
           float((keep.int() - ref.int()).abs().max()), '0, equal',
           bool(torch.equal(keep, ref)),
           lambda: nms.suppress_sweep(iou, valid, thr),
           lambda: nms.suppress_sweep_plain(iou, valid, thr), None, 50, 2,
           *k6_work(valid, ref), ' (mvf predict)')
    return out


def mvf_tower_share(det, batch, busy_ms, card):
    """Device ms of the encoder and of each view's tower in a predict
    (each run alone on the inputs it was handed), and their share of the
    predict's device-busy time."""
    enc = det.trunk.voxel_encoder
    seen, hooks = {}, []
    for name, net in enc.views.items():
        hooks.append(net.register_forward_pre_hook(
            lambda mod, args, name=name: seen.__setitem__(name, args)))
    det.predict(batch)
    for h in hooks:
        h.remove()
    cap = det.trunk.max_voxels_per_sample * batch['points'].shape[0]
    with torch.inference_mode():
        ms = {name: device_ms(lambda n=net, a=seen[name]: n(*a), 5)
              for name, net in enc.views.items()}
        ms['encoder'] = device_ms(lambda: enc(batch['points'],
                                              batch['points_mask'], cap), 5)
    towers = sum(v for k, v in ms.items() if k != 'encoder')
    share = towers / busy_ms if busy_ms else None
    print(f'(m) device ms of a predict\'s parts run alone: {ms}; the view '
          f'towers {towers:.3f} ms'
          + (f', {100 * share:.1f}% of the predict\'s device busy time'
             if share else '') + f' [{card}]')
    return dict(part_ms=ms, towers_ms=towers, towers_share=share)


def mvf_train_checks(det, batch, state, card):
    """(mt): K1's winner form (each of the three maxes), K4 on every
    BatchNorm (35 + 35) and K3 on one dense full-width step, held to their
    plain versions and timed.  -> (results, state)."""
    from mmdet3d_gaussian_tpu_torch.ops import gd_loss, segment
    capture = {k: v for k, v in MVF_DENSE_LAUNCHES.items()
               if k not in ('segment_reduce_mapback', 'bev_splat')}
    inputs, state = capture_train_inputs(det, batch, state, capture)
    out, note = {}, ' (mvf step)'
    with torch.no_grad():
        for call, args in zip(('cartesian view max', 'cylindrical view max',
                               'fused max on view 0'),
                              inputs['segment_max_winner']):
            got, mask = segment.segment_max_winner(*args)
            ref, ref_m = segment.segment_max_winner_plain(*args)
            exact = bool(torch.equal(got, ref) and torch.equal(mask, ref_m))
            results = {}
            report(results, 'segment_max_winner', card,
                   float((got - ref).abs().max()), '0, masks equal', exact,
                   lambda a=args: segment.segment_max_winner(*a),
                   lambda a=args: segment.segment_max_winner_plain(*a),
                   None, 100, 3, *k1_work('winner', *args),
                   f' exact_equal={exact} ({call}){note}')
            out.setdefault('segment_max_winner', {})[call] = \
                results['segment_max_winner']
        results = {}
        check_k4(results, inputs, card, note)
        ((pred2, tgt2, w_a, anc2, hw, cfg),) = inputs['gd_loss_fwd']
        ((gout, *_),) = inputs['gd_loss_bwd']
        work, (n_pos, _) = k3_work(pred2, w_a)
        check(n_pos > 0, 'no positive anchor in the dense MVF step')
        args = (tgt2, w_a, anc2, hw, cfg)
        got = gd_loss.gd_loss_fwd(pred2, *args)
        want = gd_loss.anchor_gd_loss_plain(pred2, *args)
        err = abs(float(got) - float(want))
        report(results, 'gd_loss_fwd', card, err, '1e-5 relative',
               err <= 1e-5 * abs(float(want)),
               lambda: gd_loss.gd_loss_fwd(pred2, *args),
               lambda: gd_loss.anchor_gd_loss_plain(pred2, *args), None, 50,
               3, *work['fwd'], note)
        dgot = gd_loss.gd_loss_bwd(gout, pred2, *args)
        dwant = gd_loss.gd_loss_bwd_plain(gout, pred2, *args)
        diff = (dgot - dwant).abs()
        report(results, 'gd_loss_bwd', card, float(diff.max()),
               '5e-6 + 1e-4 |plain|',
               bool((diff <= 5e-6 + 1e-4 * dwant.abs()).all()),
               lambda: gd_loss.gd_loss_bwd(gout, pred2, *args),
               lambda: gd_loss.gd_loss_bwd_plain(gout, pred2, *args), None,
               50, 3, *work['bwd'], note)
    for name, r in results.items():
        out[name] = {'step': r}
    return out, state


def mvf_step_band(det, batch, state, host_ms, card):
    """The step time through ``engine.timing.chain_time_state_band``
    (chains of dependent steps ending in a readback and a synchronize),
    printed beside the host-clock median ``host_ms``.  -> (band dict,
    state)."""
    from mmdet3d_gaussian_tpu_torch.engine.timing import chain_time_state_band
    med, lo, hi, state = chain_time_state_band(
        lambda s, b: det.train_step(b, s), state, batch, **MVF_BAND)
    print(f'(mt) step time by chain_time_state_band {MVF_BAND}: median '
          f'{med * 1e3:.3f} ms, band {lo * 1e3:.3f}-{hi * 1e3:.3f} ms; '
          f'host-clock median of the timed steps {host_ms:.3f} ms [{card}]')
    return dict(band_median_ms=med * 1e3, band_min_ms=lo * 1e3,
                band_max_ms=hi * 1e3), state


def mvf_center_phase(model, head, batches, card):
    """(mc): the MVF CenterPoint config at full width: 3 predicts and 3
    steps, every output finite, K5 and K6 on B x 3 problems.  -> (launches,
    summary)."""
    from mmdet3d_gaussian_tpu_torch.ops import _cuda, nms
    det = mvf_detector(model, head)
    n_tasks = len(det.head.tasks)
    seen = record_calls(lambda: det.predict(batches[0]),
                        [(nms, 'iou_bev_pairwise', 'rotated_iou')])
    p, k = seen['rotated_iou'][0][0].shape[:2]
    check(p == BATCH * n_tasks, f'K5 on {p} problems, want {BATCH} x '
          f'{n_tasks}')
    torch.cuda.synchronize()
    _cuda.reset_launches()
    times = []
    for batch in batches:
        t0 = time.perf_counter()
        boxes, scores, labels, valid = det.predict(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(boxes).all() and torch.isfinite(
            scores).all() and valid.any(1).all()),
            '(mc) non-finite boxes or a sample kept nothing')
    launches = {'predict': {k_: v for k_, v in _cuda.LAUNCHES.items() if v}}
    check_launches('(mc) predict', launches['predict'], MVF_PREDICT_LAUNCHES,
                   len(batches))
    print(f'(mc) {MVF_CP_CONFIG}: featmap {det.featmap_size}, K5 and K6 on '
          f'{p} problems (B x {n_tasks} tasks) of {k}; {len(batches)} '
          f'predicts, median {statistics.median(times) * 1e3:.3f} ms, '
          f'launches {launches["predict"]} [{card}]')
    state = det.init_train(LR, total_steps=100)
    rows, step_times = [], []
    for i in range(3):
        if i == 1:
            torch.cuda.synchronize()
            _cuda.reset_launches()
        t0 = time.perf_counter()
        state, metrics = det.train_step(batches[0], state)
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
        rows.append({k_: float(v) for k_, v in metrics.items()})
        check(all(map(math.isfinite, rows[-1].values())),
              f'(mc) non-finite loss {rows[-1]}')
    launches['train'] = {k_: v for k_, v in _cuda.LAUNCHES.items() if v}
    check_launches('(mc) train', launches['train'], MVF_CP_STEP_LAUNCHES, 2)
    print(f'(mc) 3 steps: {json.dumps(rows[-1])}; step times '
          f'{[round(t * 1e3, 3) for t in step_times]} ms; launches of the '
          f'last 2 {launches["train"]} [{card}]')
    return launches, dict(predict_ms=statistics.median(times) * 1e3,
                          step_ms=[t * 1e3 for t in step_times],
                          losses=rows[-1], nms_problems=p)


def write_raw_kitti(root, seed=0):
    """A raw KITTI tree under ``root`` as the KITTI download lays it out:
    ``training/velodyne/*.bin`` (phase (L)'s scenes), ``calib`` and
    ``label_2`` txts (camera-frame annotations through ``L_CALIB``), and
    ``ImageSets/{train,val}.txt``.  -> frames a split."""
    import numpy as np
    from mmdet3d_gaussian_tpu_torch.datasets.kitti import KittiDataset
    rng = np.random.RandomState(seed)
    calib = {k: np.asarray(v) for k, v in L_CALIB.items()}
    for sub in ('velodyne', 'calib', 'label_2'):
        os.makedirs(os.path.join(root, 'training', sub))
    os.makedirs(os.path.join(root, 'ImageSets'))

    def row(m, n):
        return ' '.join(f'{x:.12e}' for x in np.asarray(m)[:n].reshape(-1))
    calib_txt = ''.join(f'P{i}: {row(calib["P2"], 3)}\n' for i in range(4))
    calib_txt += (f'R0_rect: {row(calib["R0_rect"][:3, :3], 3)}\n'
                  f'Tr_velo_to_cam: {row(calib["Tr_velo_to_cam"], 3)}\n')
    ids = {'train': [], 'val': []}
    for i in range(MVF_TRAIN_FRAMES + MVF_VAL_FRAMES):
        idx = f'{i:06d}'
        ids['train' if i < MVF_TRAIN_FRAMES else 'val'].append(idx)
        pts, boxes, labels = kitti_scene(rng)
        pts.tofile(os.path.join(root, 'training', 'velodyne', f'{idx}.bin'))
        with open(os.path.join(root, 'training', 'calib', f'{idx}.txt'),
                  'w') as f:
            f.write(calib_txt)
        per_cls = [np.c_[boxes[labels == c], np.ones(((labels == c).sum(),
                                                      1))].astype(np.float32)
                   for c in range(3)]
        a = KittiDataset.lidar_det_to_kitti_anno(per_cls, calib, L_IMAGE,
                                                 L_CLASSES)
        check(len(a['name']) == len(boxes), 'a GT box left the image')
        lines = [f'{a["name"][j]} 0.00 0 {a["alpha"][j]:.6f} '
                 f'{" ".join(f"{v:.2f}" for v in a["bbox"][j])} '
                 f'{a["dimensions"][j][1]:.4f} {a["dimensions"][j][2]:.4f} '
                 f'{a["dimensions"][j][0]:.4f} '
                 f'{" ".join(f"{v:.4f}" for v in a["location"][j])} '
                 f'{a["rotation_y"][j]:.6f}\n' for j in range(len(a['name']))]
        with open(os.path.join(root, 'training', 'label_2', f'{idx}.txt'),
                  'w') as f:
            f.writelines(lines)
    for split, names in ids.items():
        with open(os.path.join(root, 'ImageSets', f'{split}.txt'), 'w') as f:
            f.write('\n'.join(names) + '\n')
    return {k: len(v) for k, v in ids.items()}


def run_module(module, args, cwd, root):
    """``python -m module args`` from ``cwd``; fails on a non-zero exit.
    -> (stdout, seconds)."""
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, '-m', module, *args], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    check(out.returncode == 0, f'{module} exited {out.returncode}: '
          f'{out.stderr[-3000:]}')
    return out.stdout, time.perf_counter() - t0


def mvf_cli_phase(repo, card):
    """(M): the MVF config through the port's converters and CLIs: a raw
    KITTI tree, ``kitti_converter`` and ``create_gt_database``, ``tools.
    train`` for MVF_CLI_STEPS steps at the config's batch, ``tools.test``
    under both KITTI metrics.  -> (launches per CLI run, summary)."""
    import pickle
    import tempfile
    t_phase = time.perf_counter()
    summary, launches = {}, {}
    conv = 'mmdet3d_gaussian_tpu_torch.tools.data_converter.'
    with tempfile.TemporaryDirectory(prefix='chip_smoke_mvf_') as tmp:
        root = os.path.join(tmp, 'kitti')
        frames = write_raw_kitti(root)
        _, secs_info = run_module(conv + 'kitti_converter', [root], tmp, repo)
        out, secs_db = run_module(conv + 'create_gt_database', [root], tmp,
                                  repo)
        with open(os.path.join(root, 'kitti_infos_train.pkl'), 'rb') as f:
            infos = pickle.load(f)
        with open(os.path.join(root, 'kitti_dbinfos_train.pkl'), 'rb') as f:
            db = {str(k): len(v) for k, v in pickle.load(f).items()}
        check(len(infos) == MVF_TRAIN_FRAMES and set(db) == set(L_CLASSES),
              f'converted {len(infos)} train frames, database {db}')
        reduced = len(os.listdir(os.path.join(root, 'training',
                                              'velodyne_reduced')))
        cfg_path, cfg = derived_config(tmp, root, repo, MVF_CONFIG)
        b = cfg.data['samples_per_gpu']
        print(f'(M) raw KITTI tree {frames} frames; the port\'s '
              f'kitti_converter {secs_info:.1f} s ({reduced} reduced clouds),'
              f' create_gt_database {secs_db:.1f} s (database {db}); config '
              f'{MVF_CONFIG} with its data paths moved (B {b}) '
              f'[{time.perf_counter() - t_phase:.1f} s]')
        work = os.path.join(tmp, 'work')
        _, runs, secs = run_cli('train', [
            cfg_path, '--work-dir', work, '--max-steps', str(MVF_CLI_STEPS),
            '--log-interval', '1'], tmp, repo)
        check_launches('(M) train CLI', runs, MVF_STEP_LAUNCHES,
                       MVF_CLI_STEPS)
        launches['train'] = runs
        log = read_log(work)
        check([r['step'] for r in log] == list(range(1, MVF_CLI_STEPS + 1))
              and all(math.isfinite(r[k]) for r in log for k in (
                  'loss', 'grad_norm', 'loss_cls', 'loss_bbox', 'loss_dir')),
              f'train log {log}')
        walls = [y['time'] - x['time'] for x, y in zip(log, log[1:])]
        waits = [r['data_time'] for r in log]
        summary.update(train_cli_s=secs, step_wall_ms=[w * 1e3 for w in walls],
                       data_wait_ms=[w * 1e3 for w in waits],
                       peak_mib=log[-1].get('memory', float('nan')),
                       loss=[r['loss'] for r in log])
        print(f'(M) train CLI: {MVF_CLI_STEPS} steps at B = {b} in '
              f'{secs:.1f} s; step wall (between log lines) '
              f'{[round(w * 1e3, 1) for w in walls]} ms; wait on the '
              f'prefetch queue {[round(w * 1e3, 1) for w in waits]} ms; loss '
              f'{[round(r["loss"], 4) for r in log]}; launches {runs} '
              f'[{card}]')
        ckpt = os.path.join(work, f'ckpt_{MVF_CLI_STEPS}.pt')
        n_batches = -(-MVF_VAL_FRAMES // b)
        jobs = {'kitti': ['--metric', 'kitti'], 'cowa': ['--metric', 'cowa']}
        with ThreadPoolExecutor(len(jobs)) as pool:
            futs = {k: pool.submit(run_cli, 'test', [cfg_path, ckpt] + a,
                                   tmp, repo) for k, a in jobs.items()}
            done = {k: f.result() for k, f in futs.items()}
        for k, (out, runs, secs) in done.items():
            check_launches(f'(M) test CLI {k}', runs, MVF_PREDICT_LAUNCHES,
                           n_batches)
            launches[f'test_{k}'] = runs
            check(f'frames {MVF_VAL_FRAMES},' in out,
                  f'{k}: not {MVF_VAL_FRAMES} frames')
            rep = report_json(out)
            check(len(rep) > 0 and all(map(math.isfinite, rep.values())),
                  f'{k}: a non-finite metric {rep}')
            summary[f'test_{k}_s'] = secs
            print(f'(M) test CLI --metric {k}: {out.splitlines()[0]}; '
                  f'{secs:.1f} s (two runs at once); {len(rep)} metrics, '
                  f'all finite; launches {runs}')
    wall = time.perf_counter() - t_phase
    summary['phase_s'] = wall
    print(f'(M) phase wall {wall:.1f} s [{card}]')
    return launches, summary


def mvf_phases(repo, card):
    """Phases (m), (mt), (mc) and (M).  -> (kernel numbers by call,
    launches by path, summaries)."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import synthetic_batch
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    cfgs = mvf_configs(repo)
    model, head = cfgs[MVF_CONFIG]
    batches = [synthetic_batch(BATCH, POINTS, 16, seed=s, device='cuda')
               for s in SEEDS]
    det = mvf_detector(model, head)
    summary, launches = {}, {}
    summary['counts'] = mvf_counts(det, batches[0], '(m)')
    with torch.inference_mode():
        calls = record_calls(lambda: det.predict(batches[0]),
                             predict_patches())
        got = {k: len(v) for k, v in calls.items()}
        check(got == {k: v for k, v in MVF_PREDICT_LAUNCHES.items()},
              f'(m) predict called {got}')
        results = mvf_kernel_checks(calls, card)
    del calls
    launches['predict'], summary['predict'] = main_path(
        det, batches, MVF_PREDICT_LAUNCHES, '(m)', card)
    summary['predict'].update(device_profile(
        lambda: det.predict(batches[0]), 'predict', '(m)', card, 5))
    summary['predict'].update(mvf_tower_share(
        det, batches[0], summary['predict'].get('device_busy_ms'), card))
    del det
    torch.cuda.empty_cache()

    # (mt): sparse-target steps, then dense (K3), a profile, the band
    tdet = mvf_detector(model, head)
    ddet = mvf_detector(model, head, pos_cap=0)
    tbatch = batches[0]
    dstate = ddet.init_train(LR, total_steps=100)
    dstate, _ = ddet.train_step(tbatch, dstate)        # warm-up
    step_k, dstate = mvf_train_checks(ddet, tbatch, dstate, card)
    for name, r in step_k.items():
        results.setdefault(name, {}).update(r)
    tstate = tdet.init_train(LR, total_steps=100)
    launches['train'], tstate, summary['train'] = timed_steps(
        tdet, tbatch, tstate, MVF_STEP_LAUNCHES, '(mt)', card)
    launches['train_dense'], dstate, summary['train']['dense_step_ms'] = \
        dense_steps(ddet, tbatch, dstate, MVF_DENSE_LAUNCHES, '(mt)', card)
    del ddet, dstate
    holder = [tstate]

    def one_step():
        holder[0] = tdet.train_step(tbatch, holder[0])[0]
    summary['train'].update(device_profile(one_step, 'train step', '(mt)',
                                           card, 3))
    band, holder[0] = mvf_step_band(tdet, tbatch, holder[0],
                                    summary['train']['step_ms'], card)
    summary['train'].update(band)
    del tdet, holder, tstate
    torch.cuda.empty_cache()

    cp_model, cp_head = cfgs[MVF_CP_CONFIG]
    cp_launches, summary['center'] = mvf_center_phase(cp_model, cp_head,
                                                      batches, card)
    launches.update({f'center_{k}': v for k, v in cp_launches.items()})
    del batches
    torch.cuda.empty_cache()
    _cuda.reset_launches()
    cli_launches, summary['cli'] = mvf_cli_phase(repo, card)
    launches.update({f'cli_{k}': v for k, v in cli_launches.items()})
    summary['phases_s'] = time.perf_counter() - t0
    print(f'(m)-(M) wall {summary["phases_s"]:.1f} s [{card}]')
    return results, launches, summary


PV_CONFIG = 'configs/kitti/hv_pvrcnn_secfpn_4x4_80e_kitti-3d-3class.py'
# the range PV-RCNN's synthetic batches cover (KITTI_PVRCNN's)
PV_PCR = (0., -40., -3., 70.4, 40., 1.)
# a predict: K1's voxel mean, K5 and K6 on the RPN's B x 512 class-agnostic
# candidates and on the B x 128 refined RoIs; no other kernel
PV_PREDICT_LAUNCHES = {name: 0 for name in KERNELS}
PV_PREDICT_LAUNCHES.update(segment_reduce=1, rotated_iou=2, nms_sweep=2)
# a step: K4 on SECOND's 12 and the neck's 2 BatchNorms (the sparse
# encoder's, the VSA's and the RoI stage's are masked BatchNorms, plain as
# in JAX), K1, and the proposals' K5 and K6
PV_STEP_LAUNCHES = {name: 0 for name in KERNELS}
PV_STEP_LAUNCHES.update(bn_moments=14, bn_grad_moments=14, segment_reduce=1,
                        rotated_iou=1, nms_sweep=1)
# (pt)'s loss terms whose targets stay put on a repeated batch: the RPN's
# (anchors against the boxes) and the semantic one (FPS keypoints in the
# boxes).  The RoI terms are over the samples of this step's proposals,
# which move with the weights: the box and corner terms are 0 on a step
# that samples no positive and spike on one that does, so the total
# rises from one step to another while these fall
PV_FIXED_TARGET_TERMS = ('rpn.loss_cls', 'rpn.loss_bbox', 'rpn.loss_dir',
                         'loss_semantic')
# phase (P): KITTI-format frames of the CLI run, and its train steps
PV_TRAIN_FRAMES, PV_VAL_FRAMES, PV_CLI_STEPS = 12, 8, 3
# (P)'s passes over the augmented train frames, a first step from the
# config's random init on each batch
PV_FIRST_EPOCHS = 2
# Card against CPU, the TINY PV-RCNN step's gradients, of each parameter's
# largest: the port's f32 gradient there is up to 8.7e-5 off a float64 run
# on the CPU (tests/test_torch_pvrcnn.py), so two f32 runs summing in other
# orders are held to 3e-4 of each other
PV_GRAD_TOL = 3e-4
# the TINY PV-RCNN of tests/test_pvrcnn.py (that file imports JAX)
TINY_PVRCNN = dict(
    voxel_size=(0.4, 0.4, 0.1667),
    point_cloud_range=(0., -6.4, -2., 12.8, 6.4, 2.),
    max_voxels=512, sparse_shape=(24, 32, 32), base_channels=8,
    encoder_channels=((8,), (16, 16), (16, 16), (16, 16)),
    encoder_out_channels=16,
    backbone=dict(in_channels=16, out_channels=(16, 32),
                  layer_nums=(1, 1), layer_strides=(1, 2)),
    neck=dict(in_channels=(16, 32), out_channels=(16, 16),
              upsample_strides=(1, 2)),
    num_keypoints=32, vsa_out_channels=32,
    voxel_sa_configs=[
        dict(scale_factor=1, in_channels=8, pool_radius=(0.8,),
             samples=(8,), mlps=((8, 8),)),
        dict(scale_factor=2, in_channels=16, pool_radius=(1.6,),
             samples=(8,), mlps=((8, 8),))],
    rawpoint_sa_config=dict(in_channels=1, pool_radius=(0.8,),
                            samples=(8,), mlps=((8, 8),)),
    bev_sa=True, num_proposals=16, grid_size=3, roi_pool_radius=(0.8,),
    roi_samples_per_radius=(8,), roi_mlps=((16, 16),))
TINY_PV_RPN = dict(
    anchor_generator=dict(ranges=[[0.2, -6.2, -1.0, 12.6, 6.2, -1.0]] * 3,
                          sizes=[[0.8, 0.6, 1.7], [1.8, 0.6, 1.7],
                                 [3.9, 1.6, 1.6]],
                          rotations=[0.0, 1.57]),
    test_cfg=dict(use_rotate_nms=True, nms_thr=0.8, score_thr=0.0,
                  nms_pre=64, max_num=16))


def pv_integers(det, batch):
    """Voxel coords, every level's sites and overflow, the FPS indices and
    the ball queries of the raw-point SA and of level 0's SA (every
    radius) of ``det`` on ``batch``.  -> {name: CPU tensor}."""
    from mmdet3d_gaussian_tpu_torch.ops import vsa
    out = {}
    b = batch['points'].shape[0]
    with torch.inference_mode():
        det.trunk.eval()
        feats, coords = det.voxelize(batch)
        out['voxel coords'] = coords
        levels = det.trunk.first.middle_encoder(feats, coords, b)[0]
        for i, lv in enumerate(levels):
            out[f'level {i} coords'] = lv.coords
            out[f'level {i} overflow'] = lv.overflow
        enc = det.trunk.second.keypoints_encoder
        idx, kp = enc.keypoints(batch['points'], batch['points_mask'])
        out['fps'] = idx
        raw = det.cfg['rawpoint_sa_config']
        for r, k in zip(raw['pool_radius'], raw['samples']):
            out[f'raw ball query r={r}'] = vsa.ball_query(
                r, k, batch['points'][..., :3], kp, batch['points_mask'])
        l0, cfg = levels[0], det.cfg['voxel_sa_configs'][0]
        mask = l0.valid[None] & (l0.coords[None, :, 0] == torch.arange(
            b, device=l0.coords.device)[:, None])
        centers = enc.voxel_centers(l0.coords[:, 1:4], cfg['scale_factor'])
        for r, k in zip(cfg['pool_radius'], cfg['samples']):
            out[f'level 0 ball query r={r}'] = enc.voxel_sa_0.group(
                r, k, centers, l0.feats, kp, mask)[1]
    return {k: v.cpu() for k, v in out.items()}, levels


def pv_card_vs_cpu_integers(got, want, tag):
    """Fail on any integer output of :func:`pv_integers` that differs,
    printing how many entries and the first places."""
    for name, w in want.items():
        g = got[name]
        same = g.shape == w.shape and torch.equal(g, w)
        if not same:
            bad = (g != w).nonzero() if g.shape == w.shape else None
            print(f'{tag} {name}: card and CPU differ at '
                  f'{None if bad is None else len(bad)} entries, first '
                  f'{None if bad is None else bad[:5].tolist()}')
        check(same, f'{tag} {name} differs between the card and the CPU')
    print(f'{tag} card vs CPU equal: {", ".join(want)}')


def tiny_pvrcnn_card_vs_cpu(card):
    """Phase (c), PV-RCNN: the TINY model (seed 2) on the card and on the
    CPU: the integer outputs equal, the predict's keep and labels equal,
    its boxes within 1e-4 of their scale and scores within 1e-5; then one
    train step on a batch with positives (made on the CPU): loss terms
    within 1e-4 relative, gradients within PV_GRAD_TOL of each
    parameter's largest, the running statistics within 1e-5."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import synthetic_batch
    from mmdet3d_gaussian_tpu_torch.engine.pvrcnn import (PVRCNNDetector,
                                                          positive_batch)
    batch = synthetic_batch(2, 1024, 4, seed=3,
                            pc_range=TINY_PVRCNN['point_cloud_range'],
                            device='cpu')
    ints, preds, steps = {}, {}, {}
    dets = {dev: PVRCNNDetector(TINY_PVRCNN, TINY_PV_RPN, device=dev, seed=2)
            for dev in ('cuda', 'cpu')}
    tbatch = positive_batch(dets['cpu'], batch)
    for dev, det in dets.items():
        b = {k: v.to(dev) for k, v in batch.items()}
        ints[dev] = pv_integers(det, b)[0]
        preds[dev] = [t.cpu() for t in det.predict(b)]
        b = {k: v.to(dev) for k, v in tbatch.items()}
        total, losses = det.loss(det.apply_train(b), b)
        params = dict(det.trunk.named_parameters())
        grads = torch.autograd.grad(total, list(params.values()))
        steps[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                      {k: g.cpu() for k, g in zip(params, grads)},
                      {k: v.cpu() for k, v in det.trunk.state_dict().items()
                       if 'running' in k})
    pv_card_vs_cpu_integers(ints['cuda'], ints['cpu'], '(c) TINY pvrcnn')
    (gb, gs, gl, gv), (cb, cs, cl, cv) = preds['cuda'], preds['cpu']
    box_err = float((gb - cb).abs().max())
    scale = max(float(cb.abs().max()), 1.0)
    score_err = float((gs - cs).abs().max())
    print(f'(c) TINY pvrcnn predict card vs CPU: valid_equal '
          f'{torch.equal(gv, cv)} labels_equal {torch.equal(gl, cl)} '
          f'({int(cv.sum())} kept); boxes max_abs_err {box_err:.3g} (tol '
          f'{1e-4 * scale:.3g}), scores {score_err:.3g} (tol 1e-5) [{card}]')
    check(torch.equal(gv, cv) and torch.equal(gl, cl) and bool(cv.any()),
          'TINY pvrcnn detections differ')
    check(box_err <= 1e-4 * scale and score_err <= 1e-5,
          'TINY pvrcnn boxes or scores differ')
    (lg, gg, sg), (lc, gc, sc) = steps['cuda'], steps['cpu']
    check(all(v > 0 for k, v in lc.items()), f'a TINY pvrcnn loss is 0: {lc}')
    loss_rel = max(abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc)
    grad_rel = max(float((gg[k] - gc[k]).abs().max() / gc[k].abs().max())
                   for k in gc)
    stat_err = max(float((sg[k] - sc[k]).abs().max()) for k in sc)
    print(f'(c) TINY pvrcnn train step card vs CPU: loss terms {lg} vs '
          f'{lc}, largest relative error {loss_rel:.3g} (tol 1e-4); '
          f'gradients max error / max |grad| per parameter {grad_rel:.3g} '
          f'(tol {PV_GRAD_TOL:g}); running statistics max_abs_err '
          f'{stat_err:.3g} (tol 1e-5) [{card}]')
    check(loss_rel <= 1e-4, 'TINY pvrcnn train losses differ')
    check(grad_rel <= PV_GRAD_TOL, 'TINY pvrcnn gradients differ')
    check(stat_err <= 1e-5, 'TINY pvrcnn running statistics differ')


def pv_level_counts(scatter, levels, b, tag):
    """Print the live voxels (kept, truncated) and each level's live sites
    per sample with the cumulative overflow.  -> summary."""
    per = []
    for lv in levels:
        ids = lv.coords[lv.valid, 0].long()
        per.append(torch.bincount(ids, minlength=b).tolist())
    over = [int(lv.overflow) for lv in levels]
    print(f'{tag} voxels {int(scatter.num_voxels)} kept of capacity '
          f'{scatter.max_voxels}, {int(scatter.num_overflow)} truncated; '
          f'live sites per sample by level {per}; cumulative sparse '
          f'overflow by level {over} (batch-major truncation: the last '
          f'samples lose their sites first)')
    return dict(voxels=int(scatter.num_voxels),
                voxels_truncated=int(scatter.num_overflow),
                sites_per_sample=per, overflow=over)


def pv_kernel_checks(calls, card, note):
    """K1, K5 and K6 on one PV-RCNN predict's or step's inputs (``calls``:
    the recorded arguments), each held to its plain version at phase (b)'s
    tolerance and timed beside its bound and yardstick.  -> {kernel: {call:
    numbers}}."""
    from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou, segment
    out = {}

    def record(name, call, *args, **kw):
        results = {}
        report(results, name, card, *args, **kw)
        out.setdefault(name, {})[call] = results[name]

    for data, starts, counts, op in calls['segment_reduce']:
        got = segment.segment_reduce(data, starts, counts, op)
        err = float((got - segment.segment_reduce_plain(
            data, starts, counts, op)).abs().max())
        n_live = int(torch.count_nonzero(counts))
        rows, lengths = int(counts.sum()), counts[:n_live].long()
        check(bool((counts[n_live:] == 0).all()), 'live voxels not first')
        print(f'(p) segment_reduce{note}: {data.shape[0]} rows x '
              f'{data.shape[1]} into {n_live} live of {counts.shape[0]} '
              f'voxels ({rows} rows in them)')
        record('segment_reduce', 'voxel mean', err, '1e-5', err <= 1e-5,
               lambda a=(data, starts, counts, op): segment.segment_reduce(
                   *a),
               lambda a=(data, starts, counts, op):
               segment.segment_reduce_plain(*a),
               lambda d=data[:rows], ln=lengths, o=op: torch.segment_reduce(
                   d, o, lengths=ln, unsafe=True), 100, 3,
               *k1_work('reduce', data, None, starts, counts),
               f' (pvrcnn{note}, HardSimpleVFE sums)')
    for (boxes,), (iou, valid, thr) in zip(calls['rotated_iou'],
                                          calls['nms_sweep']):
        p, k = boxes.shape[:2]
        call = f'{p}x{k}'
        got = rotated_iou.iou_bev_pairwise(boxes)
        ref = rotated_iou.iou_bev_pairwise_plain(boxes)
        n_near = k5_cull(boxes, got, ref, card, f'pvrcnn{note} {call}')
        err = float((got - ref).abs().max())
        record('rotated_iou', call, err, '1e-5', err <= 1e-5,
               lambda b=boxes: rotated_iou.iou_bev_pairwise(b),
               lambda b=boxes: rotated_iou.iou_bev_pairwise_plain(b), None,
               20, 2, *k5_work(boxes, n_near), f' (pvrcnn{note} {call})')
        keep = nms.suppress_sweep(iou, valid, thr)
        want = nms.suppress_sweep_plain(iou, valid, thr)
        print(f'(p) nms_sweep{note} {call}, thr {thr}: kept '
              f'{int(want.sum())} of {int(valid.sum())} valid')
        record('nms_sweep', call, float((keep.int() - want.int()).abs()
                                        .max()), '0, equal',
               bool(torch.equal(keep, want)),
               lambda a=(iou, valid, thr): nms.suppress_sweep(*a),
               lambda a=(iou, valid, thr): nms.suppress_sweep_plain(*a),
               None, 50, 2, *k6_work(valid, want),
               f' (pvrcnn{note} {call}, thr {thr})')
    return out


def pv_part_shares(det, batch, busy_ms, card):
    """Device ms of a predict's sparse encoder, FPS, set-abstraction ball
    queries (the raw points' and the levels') and RoI-grid pooling, each
    run alone on the inputs the predict handed it, and their shares of the
    predict's device-busy time."""
    from mmdet3d_gaussian_tpu_torch.ops import vsa
    seen, hooks = {}, []
    second = det.trunk.second
    for name, mod in (('encoder', det.trunk.first.middle_encoder),
                      ('roi grid pool', second.roi_extractor)):
        hooks.append(mod.register_forward_pre_hook(
            lambda m, args, name=name: seen.__setitem__(name, args)))
    queries = record_calls(lambda: det.predict(batch),
                           [(vsa, 'ball_query', 'ball_query')])['ball_query']
    for h in hooks:
        h.remove()
    roi_m = det.cfg['num_proposals'] * det.cfg['grid_size'] ** 3
    sa = [a for a in queries if a[3].shape[1] != roi_m]
    enc = second.keypoints_encoder
    with torch.inference_mode():
        ms = dict(
            encoder=device_ms(lambda: det.trunk.first.middle_encoder(
                *seen['encoder']), 3),
            fps=device_ms(lambda: enc.keypoints(batch['points'],
                                                batch['points_mask']), 1,
                          warmup=1),
            sa_ball_queries=device_ms(
                lambda: [vsa.ball_query(*a) for a in sa], 3),
            roi_grid_pool=device_ms(lambda: second.roi_extractor(
                *seen['roi grid pool']), 3))
    shares = {k: v / busy_ms for k, v in ms.items()} if busy_ms else {}
    print(f'(p) device ms of a predict\'s parts run alone: '
          f'{ {k: round(v, 3) for k, v in ms.items()} } ({len(sa)} SA ball '
          f'queries); shares of its device busy time '
          f'{ {k: round(v, 3) for k, v in shares.items()} } [{card}]')
    return dict(part_ms=ms, part_shares=shares)


def pv_capture_step(det, batch, state):
    """One train step recording the arguments of K4, K1, K5 and K6; each
    must be called as PV_STEP_LAUNCHES says.  -> (calls, state)."""
    from mmdet3d_gaussian_tpu_torch.ops import bn, nms, scatter
    patches = [(bn, 'moments', 'bn_moments'),
               (bn, 'grad_moments', 'bn_grad_moments'),
               (scatter, 'segment_reduce', 'segment_reduce'),
               (nms, 'iou_bev_pairwise', 'rotated_iou'),
               (nms, 'suppress_sweep', 'nms_sweep')]
    out = []
    seen = record_calls(lambda: out.append(det.train_step(batch, state)[0]),
                        patches)
    got = {k: len(v) for k, v in seen.items()}
    want = {k: n for k, n in PV_STEP_LAUNCHES.items() if n}
    check(got == want, f'(pt) train step called {got}, want {want}')
    return seen, out[0]


def pv_train_batch(det, seed=0):
    """(pt)'s repeated batch: ``synthetic_batch`` B x 16,384 over PV-RCNN's
    range with 4-8 GT boxes a sample of the 3 classes, the first two made
    positives by ``engine.pvrcnn.positive_batch``."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import synthetic_batch
    from mmdet3d_gaussian_tpu_torch.engine.pvrcnn import positive_batch
    batch = synthetic_batch(BATCH, POINTS, 8, seed=seed, pc_range=PV_PCR,
                            device=det.device)
    n_gt = torch.tensor([4, 6, 8, 5] * BATCH, device=det.device)[:BATCH]
    batch['gt_valid'] = (torch.arange(8, device=det.device)[None]
                         < n_gt[:, None])
    return positive_batch(det, batch)


def pv_first_steps(cfg, card, epochs=PV_FIRST_EPOCHS):
    """(P): a train step from the config's random init (seed 0, the CLI's)
    on every batch of ``epochs`` passes over its augmented train frames;
    every loss term, the gradient norm and every weight after it must be
    finite.  Prints the RPN's largest box delta, the longest proposal, and
    the batches with a sampled negative whose decode is not finite: there
    the JAX package's corner loss, every RoI's weighted by 0, is NaN
    (ROADMAP section 3).  -> summary."""
    from mmdet3d_gaussian_tpu_torch.engine.loop import (build_dataloader,
                                                         to_device)
    from mmdet3d_gaussian_tpu_torch.models.roi_heads import decode_roi_boxes
    from mmdet3d_gaussian_tpu_torch.tools.common import build_detector
    t0 = time.perf_counter()
    det = build_detector(cfg, 'cuda', seed=0)
    init = {k: v.clone() for k, v in det.trunk.state_dict().items()}
    _, make_iter = build_dataloader(cfg, 'train')
    n, overflowed, delta, longest = 0, 0, 0.0, 0.0
    for epoch in range(epochs):
        for host in make_iter(epoch):
            batch = to_device(host, det.device)
            det.trunk.load_state_dict(init)
            with torch.no_grad():
                rpn, out2, samples = det.apply_train(batch)
                dec = decode_roi_boxes(samples.rois, out2['roi_reg'],
                                       det.roi_coder)
            bad = ~torch.isfinite(dec).all(-1) & samples.valid
            overflowed += bool(bad.any())
            delta = max(delta, float(rpn[1].abs().max()))
            longest = max(longest, float(samples.rois[..., 3:6].max()))
            det.trunk.load_state_dict(init)
            state = det.init_train(cfg.optimizer['lr'], total_steps=100)
            _, metrics = det.train_step(batch, state)
            terms = {k: float(v) for k, v in metrics.items()}
            check(all(map(math.isfinite, terms.values()))
                  and all(bool(torch.isfinite(w).all())
                          for w in det.trunk.parameters()),
                  f'(P) a first step from the init is not finite: {terms}')
            n += 1
    del det, init
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f'(P) first steps from the config\'s init on {n} augmented '
          f'batches ({epochs} passes): every term and weight finite; RPN '
          f'box deltas up to {delta:.2f}, proposals up to {longest:.4g} m '
          f'long; {overflowed} of {n} batches sample a negative whose decode '
          f'is not finite (the JAX package\'s corner loss is NaN there); '
          f'{secs:.1f} s [{card}]')
    return dict(first_steps=n, first_steps_overflowed=overflowed,
                rpn_delta_max=delta, proposal_max_m=longest,
                first_steps_s=secs)


def pv_cli_phase(repo, card):
    """(P): the PV-RCNN config through the CLIs on a KITTI-format tree:
    ``tools.train`` PV_CLI_STEPS steps at the config's batch, ``tools.test
    --metric kitti`` on its checkpoint.  -> (launches per run, summary)."""
    import tempfile
    t_phase = time.perf_counter()
    summary, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_pvrcnn_') as tmp:
        root = os.path.join(tmp, 'kitti')
        frames, objects = write_kitti_tree(root, n_train=PV_TRAIN_FRAMES,
                                           n_val=PV_VAL_FRAMES)
        cfg_path, cfg = derived_config(tmp, root, repo, PV_CONFIG)
        b = cfg.data['samples_per_gpu']
        pad = cfg.data['train']['dataset']['pipeline'][-1]['num_points']
        print(f'(P) KITTI-format tree {frames} frames, GT database '
              f'{objects}; config {PV_CONFIG} with its data paths moved (B '
              f'{b}, Pad3D {pad}) [{time.perf_counter() - t_phase:.1f} s]')
        summary.update(pv_first_steps(cfg, card))
        work = os.path.join(tmp, 'work')
        _, runs, secs = run_cli('train', [
            cfg_path, '--work-dir', work, '--max-steps', str(PV_CLI_STEPS),
            '--log-interval', '1'], tmp, repo)
        check_launches('(P) train CLI', runs,
                       {k: v for k, v in PV_STEP_LAUNCHES.items() if v},
                       PV_CLI_STEPS)
        launches['train'] = runs
        log = read_log(work)
        terms = ('loss', 'grad_norm', 'rpn.loss_cls', 'rpn.loss_bbox',
                 'rpn.loss_dir', 'loss_semantic', 'loss_roi_cls',
                 'loss_roi_bbox', 'loss_corner', 'metric.sparse_overflow')
        check([r['step'] for r in log] == list(range(1, PV_CLI_STEPS + 1))
              and all(math.isfinite(r[k]) for r in log for k in terms),
              f'(P) train log {log}')
        walls = [y['time'] - x['time'] for x, y in zip(log, log[1:])]
        waits = [r['data_time'] for r in log]
        summary.update(train_cli_s=secs, step_wall_ms=[w * 1e3 for w in walls],
                       data_wait_ms=[w * 1e3 for w in waits],
                       peak_mib=log[-1].get('memory', float('nan')),
                       loss=[r['loss'] for r in log],
                       sparse_overflow=[r['metric.sparse_overflow']
                                        for r in log])
        print(f'(P) train CLI: {PV_CLI_STEPS} steps at B = {b}, lr '
              f'{cfg.optimizer["lr"]:g}, in {secs:.1f} s; step wall (between '
              f'log lines) '
              f'{[round(w * 1e3, 1) for w in walls]} ms; wait on the '
              f'prefetch queue {[round(w * 1e3, 1) for w in waits]} ms; loss '
              f'{[round(r["loss"], 4) for r in log]}; sparse overflow '
              f'{summary["sparse_overflow"]}; peak '
              f'{summary["peak_mib"]:.1f} MiB; launches {runs} [{card}]')
        ckpt = os.path.join(work, f'ckpt_{PV_CLI_STEPS}.pt')
        out, runs, secs = run_cli('test', [cfg_path, ckpt, '--metric',
                                           'kitti'], tmp, repo)
        n_batches = -(-PV_VAL_FRAMES // b)
        check_launches('(P) test CLI', runs,
                       {k: v for k, v in PV_PREDICT_LAUNCHES.items() if v},
                       n_batches)
        launches['test_kitti'] = runs
        check(f'frames {PV_VAL_FRAMES},' in out,
              f'(P) test: not {PV_VAL_FRAMES} frames')
        rep = report_json(out)
        check_aps(rep, '(P) test CLI --metric kitti')
        summary['test_kitti_s'] = secs
        print(f'(P) test CLI --metric kitti: {out.splitlines()[0]}; '
              f'{secs:.1f} s; {len(rep)} APs finite in [0, 100]; launches '
              f'{runs} [{card}]')
    summary['phase_s'] = time.perf_counter() - t_phase
    print(f'(P) phase wall {summary["phase_s"]:.1f} s [{card}]')
    return launches, summary


def pvrcnn_phases(repo, card):
    """Phases (p), (pt) and (P).  -> (kernel numbers by call, launches by
    path, summaries)."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import synthetic_batch
    from mmdet3d_gaussian_tpu_torch.engine.pvrcnn import PVRCNNDetector
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    summary, launches = {}, {}
    det = PVRCNNDetector(device='cuda', seed=0)
    batches = [synthetic_batch(BATCH, POINTS, 16, seed=s, pc_range=PV_PCR,
                               device='cuda') for s in SEEDS]
    b0 = batches[0]
    got, levels = pv_integers(det, b0)
    summary['counts'] = pv_level_counts(det.scatter(b0)[0], levels, BATCH,
                                        '(p)')
    del levels
    cpu = PVRCNNDetector(device='cpu', seed=0)
    t1 = time.perf_counter()
    want, _ = pv_integers(cpu, {k: v.cpu() for k, v in b0.items()})
    print(f'(p) the same integer outputs from the port on the CPU '
          f'[{time.perf_counter() - t1:.1f} s]')
    pv_card_vs_cpu_integers(got, want, '(p)')
    del cpu, got, want
    with torch.inference_mode():
        calls = record_calls(lambda: det.predict(b0), predict_patches())
        n_calls = {k: len(v) for k, v in calls.items()}
        check(n_calls == {k: v for k, v in PV_PREDICT_LAUNCHES.items() if v},
              f'(p) predict called {n_calls}')
        shapes = [tuple(a[0].shape) for a in calls['rotated_iou']]
        check(shapes == [(BATCH, 512, 5), (BATCH, 128, 5)],
              f'(p) K5 shapes {shapes}')
        results = pv_kernel_checks(calls, card, ' predict')
    del calls
    launches['predict'], summary['predict'] = main_path(
        det, batches, PV_PREDICT_LAUNCHES, '(p)', card, out_rows=64)
    summary['predict'].update(device_profile(
        lambda: det.predict(b0), 'predict', '(p)', card, 5))
    summary['predict'].update(pv_part_shares(
        det, b0, summary['predict'].get('device_busy_ms'), card))
    del batches
    torch.cuda.empty_cache()

    # (pt): the train step on one repeated batch with positives
    tbatch = pv_train_batch(det)
    print(f'(pt) GT boxes a sample {tbatch["gt_valid"].sum(1).tolist()}, '
          f'labels {tbatch["gt_labels"][:, :2].tolist()} first two')
    state = det.init_train(LR, total_steps=100)
    state, _ = det.train_step(tbatch, state)            # warm-up
    calls, state = pv_capture_step(det, tbatch, state)
    with torch.no_grad():
        k4 = {}
        check_k4(k4, calls, card, ' (pvrcnn step)')
        step_k = pv_kernel_checks(calls, card, ' step')
    del calls
    for name, r in step_k.items():
        for call, numbers in r.items():
            results.setdefault(name, {})[f'step {call}'] = numbers
    for name, r in k4.items():
        results.setdefault(name, {})['step'] = r
    launches['train'], state, summary['train'] = timed_steps(
        det, tbatch, state, PV_STEP_LAUNCHES, '(pt)', card,
        falling=PV_FIXED_TARGET_TERMS)
    holder = [state]

    def one_step():
        holder[0] = det.train_step(tbatch, holder[0])[0]
    summary['train'].update(device_profile(one_step, 'train step', '(pt)',
                                           card, 3))
    del det, holder, state, tbatch
    torch.cuda.empty_cache()
    _cuda.reset_launches()
    cli_launches, summary['cli'] = pv_cli_phase(repo, card)
    launches.update({f'cli_{k}': v for k, v in cli_launches.items()})
    summary['phases_s'] = time.perf_counter() - t0
    print(f'(p)-(P) wall {summary["phases_s"]:.1f} s [{card}]')
    return results, launches, summary


# ---------------------------------------------------------------------- MVX
# phases (c) mvx, (x), (x16), (xt): the image-fused pillar trunk
# (engine/mvx.py) at KITTI_MVX_MODEL's width with KITTI 3-class's head on
# images of mmdet3d's MVX KITTI test scale (1280 x 384)
MVX_IMG_HW = (384, 1280)
# the TINY MVX (tests/test_mvx_fusion.py's widths) on an odd 36 x 68 image,
# so that its FPN crops
TINY_MVX = dict(
    voxel_size=(0.4, 0.4, 4.0),
    point_cloud_range=(0., -6.4, -3., 12.8, 6.4, 1.),
    max_voxels_per_sample=512,
    img_backbone_cfg=dict(stage_channels=(8, 16), blocks_per_stage=1),
    img_neck_cfg=dict(out_channels=8),
    fusion_cfg=dict(out_channels=8, img_levels=(4, 8)),
    encoder_cfg=dict(in_channels=12, feat_channels=(16,)),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32),
                      layer_nums=(1, 1), layer_strides=(2, 2)),
    neck_cfg=dict(in_channels=(16, 32), out_channels=(16, 16),
                  upsample_strides=(1, 2)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=32),
)
TINY_MVX_HEAD = dict(
    anchor_generator=dict(
        ranges=[[0.2, -6.2, -1.0, 12.6, 6.2, -1.0]] * 3,
        sizes=[[0.8, 0.6, 1.7], [1.8, 0.6, 1.7], [3.9, 1.6, 1.6]],
        rotations=[0.0, 1.57]),
    test_cfg=dict(use_rotate_nms=True, nms_thr=0.5, score_thr=0.05,
                  nms_pre=64, max_num=16))
TINY_MVX_IMG_HW = (36, 68)
# a predict: the dynamic pillar pipeline on the plain canvas (K1 reduce and
# mapback, K2) and NMS; never K7
MVX_PREDICT_LAUNCHES = {'segment_reduce': 1, 'segment_reduce_mapback': 1,
                        'bev_splat': 1, 'bev_splat_pairs': 0,
                        'rotated_iou': 1, 'nms_sweep': 1}
# a step: K4 on SECOND's 16, the neck's 3 and the image branch's 20
# BatchNorms (the stem, 4 stages x 2 blocks x 2, bn_down in stages 1-3);
# K1's winner on the encoder's max, and the cluster mean's mapback forward
# and backward (the painted rows carry a gradient, their xyz too); K2 once
MVX_STEP_LAUNCHES = {'bn_moments': 39, 'bn_grad_moments': 39,
                     'segment_max_winner': 1, 'segment_reduce_mapback': 2,
                     'bev_splat': 1, 'bev_splat_pairs': 0}
MVX_DENSE_LAUNCHES = {**MVX_STEP_LAUNCHES, **DENSE_LAUNCHES}


def mvx_batch(seed, dev='cuda', hw=MVX_IMG_HW):
    from mmdet3d_gaussian_tpu_torch.engine.mvx import synthetic_mvx_batch
    return synthetic_mvx_batch(BATCH, POINTS, 16, img_hw=hw, seed=seed,
                               device=dev)


def tiny_mvx_batch(seed, dev):
    from mmdet3d_gaussian_tpu_torch.engine.mvx import synthetic_mvx_batch
    return synthetic_mvx_batch(2, 1024, 8, img_hw=TINY_MVX_IMG_HW, seed=seed,
                               pc_range=TINY_MVX['point_cloud_range'],
                               device=dev)


def tiny_mvx_card_vs_cpu(card):
    """Phase (c) for MVX: the TINY MVX predict and one dense train step on
    the card against the CPU (the rules of the other TINY models), and the
    image backbone's gradient on the card not zero."""
    from mmdet3d_gaussian_tpu_torch.engine.mvx import MVXDetector
    tiny_card_vs_cpu(card, TINY_MVX, tag='TINY mvx', detector=MVXDetector,
                     head=TINY_MVX_HEAD, batch_fn=tiny_mvx_batch)
    grads = tiny_train_card_vs_cpu(
        card, TINY_MVX, head=dict(TINY_MVX_HEAD, pos_cap=0),
        tag='TINY mvx dense', detector=MVXDetector, batch_fn=tiny_mvx_batch)
    img = {k: float(g.norm()) for k, g in grads.items()
           if k.startswith('img_backbone.')}
    norm = math.sqrt(sum(v * v for v in img.values()))
    print(f'(c) TINY mvx image backbone gradient on the card: norm '
          f'{norm:.4g} over {len(img)} parameters, '
          f'{sum(v > 0 for v in img.values())} of them not zero [{card}]')
    check(norm > 0 and all(v > 0 for v in img.values()),
          'the TINY MVX image backbone got no gradient on the card')


def mvx_detector(cfg=None, head=None):
    """The full-width MVX detector from seed 0, its cls bias zeroed so that
    NMS has candidates."""
    from mmdet3d_gaussian_tpu_torch.engine.mvx import MVXDetector
    det = MVXDetector(cfg, head, device='cuda', seed=0)
    with torch.no_grad():
        det.trunk.bbox_head.conv_cls.bias.zero_()
    return det


def mvx_on_image(batch, tag):
    """Print and return the share of the batch's points that project onto
    the image."""
    from mmdet3d_gaussian_tpu_torch.models.img_fusion import \
        project_points_to_img
    valid = project_points_to_img(batch['points'][..., :3],
                                  batch['lidar2img'],
                                  tuple(batch['img'].shape[1:3]))[1]
    share = float(valid.float().mean())
    print(f'{tag} points on the image: {int(valid.sum())} of '
          f'{valid.numel()} ({share:.4f}); image '
          f'{tuple(batch["img"].shape)}')
    return share


def mvx_part_shares(det, batch, busy_ms, tag, card):
    """Device ms of a predict's image branch (backbone and FPN) and fusion,
    each run alone on the predict's inputs, their shares of the predict's
    device busy time and the rest's; the image branch's heaviest kernels,
    FFT or Winograd tilings named."""
    trunk = det.trunk
    img, l2i = batch['img'], batch['lidar2img']
    xyz = batch['points'][..., :3]
    hw = tuple(img.shape[1:3])
    with torch.inference_mode():
        trunk.eval()
        feats = trunk.image_features(img)
        by_name = device_ms_by_name(lambda: trunk.image_features(img), 3)
        image_ms = sum(by_name.values())
        fusion_ms = device_ms(lambda: trunk.fusion(feats, xyz, l2i, hw), 5)
    tilings = {k: round(v, 4) for k, v in by_name.items()
               if 'fft' in k.lower() or 'winograd' in k.lower()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f'{tag} image branch alone: {image_ms:.3f} device ms '
          f'({len(by_name)} kernels by name; heaviest '
          f'{[(k[:60], round(v, 4)) for k, v in top]}); FFT / Winograd '
          f'kernels {tilings or "none"} [{card}]')
    rest = busy_ms - image_ms - fusion_ms if busy_ms else None
    shares = ({k: v / busy_ms for k, v in (
        ('image_branch', image_ms), ('fusion', fusion_ms), ('rest', rest))}
        if busy_ms else {})
    print(f'{tag} fusion alone: {fusion_ms:.3f} device ms; shares of the '
          f'predict\'s device busy time {busy_ms}: '
          f'{ {k: round(v, 4) for k, v in shares.items()} } [{card}]')
    return dict(image_branch_ms=image_ms, fusion_ms=fusion_ms,
                fft_winograd=tilings, shares=shares)


def mvx_kernel_checks(calls, card, call, note, tag='(x)'):
    """Those of K1 (reduce, mapback), K2, K5 and K6 that ``calls`` holds
    (one full-width MVX or Waymo predict's inputs), each held to its plain
    version at phase (b)'s tolerance and timed beside its bound and its
    one-call yardstick.  -> {kernel: {call: numbers}}."""
    from mmdet3d_gaussian_tpu_torch.ops import nms, rotated_iou, segment
    from mmdet3d_gaussian_tpu_torch.ops import voxelize
    out = {}

    def record(name, *args, **kw):
        results = {}
        report(results, name, card, *args, **kw)
        out.setdefault(name, {})[call] = results[name]

    if 'segment_reduce' in calls:
        ((data, starts, counts, op),) = calls['segment_reduce']
        got = segment.segment_reduce(data, starts, counts, op)
        err = float((got - segment.segment_reduce_plain(
            data, starts, counts, op)).abs().max())
        n_live = int(torch.count_nonzero(counts))
        rows, lengths = int(counts.sum()), counts[:n_live].long()
        print(f'{tag} segment_reduce{note}: {data.shape[0]} rows x '
              f'{data.shape[1]} into {n_live} live of {counts.shape[0]} '
              f'voxels')
        record('segment_reduce', err, '0', err == 0,
               lambda: segment.segment_reduce(data, starts, counts, op),
               lambda: segment.segment_reduce_plain(data, starts, counts,
                                                    op),
               lambda: torch.segment_reduce(data[:rows], op,
                                            lengths=lengths, unsafe=True),
               100, 3, *k1_work('reduce', data, None, starts, counts), note)
    if 'segment_reduce_mapback' in calls:
        ((data, ids, starts, counts, op),) = calls['segment_reduce_mapback']
        got = segment.segment_reduce_mapback(data, ids, starts, counts, op)
        err = float((got - segment.segment_reduce_mapback_plain(
            data, ids, starts, counts, op)).abs().max())
        record('segment_reduce_mapback', err, '1e-4', err <= 1e-4,
               lambda: segment.segment_reduce_mapback(data, ids, starts,
                                                      counts, op),
               lambda: segment.segment_reduce_mapback_plain(
                   data, ids, starts, counts, op), None, 100, 3,
               *k1_work('mapback', data, ids, starts, counts), note)
    if 'bev_splat' in calls:
        ((feats, lin, ncell),) = calls['bev_splat']
        got = voxelize.bev_splat(feats, lin, ncell)
        ref = voxelize.bev_splat_plain(feats, lin, ncell)
        live = lin < ncell
        canvas = torch.zeros_like(ref)
        ids_l, rows_l = lin[live].long(), feats[live]

        def lib():
            canvas.zero_().index_copy_(0, ids_l, rows_l)
        lib()
        check(torch.equal(canvas, ref), 'index_copy_ yardstick disagrees')
        esize = feats.element_size()
        print(f'{tag} bev_splat{note}: {feats.shape[0]} {feats.dtype} rows x '
              f'{feats.shape[1]} ({int(live.sum())} live) onto {ncell} '
              f'cells')
        record('bev_splat', float((got.float() - ref.float()).abs().max()),
               '0, equal', bool(torch.equal(got, ref)),
               lambda: voxelize.bev_splat(feats, lin, ncell),
               lambda: voxelize.bev_splat_plain(feats, lin, ncell), lib, 50,
               3,
               # live rows read, every id read, the canvas written
               int(live.sum()) * feats.shape[1] * esize + lin.numel() * 4
               + ncell * feats.shape[1] * esize, 0, note)
    if 'rotated_iou' in calls:
        ((boxes,),) = calls['rotated_iou']
        got = rotated_iou.iou_bev_pairwise(boxes)
        ref = rotated_iou.iou_bev_pairwise_plain(boxes)
        n_near = k5_cull(boxes, got, ref, card, f'predict inputs{note}')
        err = float((got - ref).abs().max())
        record('rotated_iou', err, '1e-5', err <= 1e-5,
               lambda: rotated_iou.iou_bev_pairwise(boxes),
               lambda: rotated_iou.iou_bev_pairwise_plain(boxes), None, 20,
               2, *k5_work(boxes, n_near), note)
    if 'nms_sweep' in calls:
        ((iou, valid, thr),) = calls['nms_sweep']
        keep = nms.suppress_sweep(iou, valid, thr)
        ref = nms.suppress_sweep_plain(iou, valid, thr)
        record('nms_sweep', float((keep.int() - ref.int()).abs().max()),
               '0, equal', bool(torch.equal(keep, ref)),
               lambda: nms.suppress_sweep(iou, valid, thr),
               lambda: nms.suppress_sweep_plain(iou, valid, thr), None, 50,
               2, *k6_work(valid, ref), note)
    return out


def mvx_predict_phase(det, batches, tag, card):
    """(x) or (x16): the kernels on one predict's inputs (in bf16 K2 on
    its bf16 rows), 6 requests with launch counts, a profile and the
    parts' shares.  -> (kernel numbers, launches, summary)."""
    b0 = batches[0]
    call = 'predict' if tag == '(x)' else 'bf16 predict'
    note = f' (mvx {call})'
    with torch.inference_mode():
        calls = record_calls(lambda: det.predict(b0), predict_patches())
        got = {k: len(v) for k, v in calls.items()}
        want = {k: v for k, v in MVX_PREDICT_LAUNCHES.items() if v}
        check(got == want, f'{tag} predict called {got}, want {want}')
        dt = det.trunk.compute_dtype or torch.float32
        rows_dt = calls['bev_splat'][0][0].dtype
        check(rows_dt == dt, f'{tag} K2 on {rows_dt} rows, want {dt}')
        if tag != '(x)':
            calls = {'bev_splat': calls['bev_splat']}
        results = mvx_kernel_checks(calls, card, call, note)
    del calls
    launches, summary = main_path(det, batches, MVX_PREDICT_LAUNCHES, tag,
                                  card)
    summary['on_image_share'] = mvx_on_image(b0, tag)
    summary.update(device_profile(lambda: det.predict(b0), 'predict', tag,
                                  card, 5))
    summary.update(mvx_part_shares(det, b0, summary.get('device_busy_ms'),
                                   tag, card))
    return results, launches, summary


def _fusion_indexing(fusion, feats, xyz, l2i, hw):
    """PointFusion's forward with the bilinear sample's gathers as plain
    indexing (autograd's own backward: ``index_put_`` with accumulate),
    the JAX package's form."""
    from mmdet3d_gaussian_tpu_torch.models.img_fusion import \
        project_points_to_img
    uv, valid = project_points_to_img(xyz, l2i, hw)
    acc = None
    for i, (f, stride) in enumerate(zip(feats, fusion.img_levels)):
        b, h, w, c = f.shape
        p = uv / stride
        x = p[..., 0].clamp(0, w - 1)
        y = p[..., 1].clamp(0, h - 1)
        x0 = torch.floor(x).long().clamp(0, w - 2)
        y0 = torch.floor(y).long().clamp(0, h - 2)
        dx, dy = (x - x0)[..., None], (y - y0)[..., None]
        bi = torch.arange(b, device=f.device)[:, None]
        s = ((1 - dy) * ((1 - dx) * f[bi, y0, x0] + dx * f[bi, y0, x0 + 1])
             + dy * ((1 - dx) * f[bi, y0 + 1, x0]
                     + dx * f[bi, y0 + 1, x0 + 1]))
        yl = getattr(fusion, f'lateral_{i}')(s)
        acc = yl if acc is None else acc + yl
    out = torch.relu(fusion.fuse(torch.relu(acc)))
    return out * valid[..., None].to(out.dtype)


def mvx_fusion_backward(det, batch, card):
    """The fusion's backward on a step's inputs, timed alone (device ms of
    ``autograd.grad`` into the FPN maps on a kept graph): the port's
    ``index_add_`` against plain indexing's backward (sorted
    ``index_put_`` with accumulate); the two gradients held to each
    other."""
    trunk = det.trunk
    seen = {}
    hook = trunk.fusion.register_forward_pre_hook(
        lambda mod, args: seen.__setitem__('args', args))
    with torch.no_grad():
        trunk.train()
        trunk.paint(batch['points'], batch['img'], batch['lidar2img'])
    hook.remove()
    feats, xyz, l2i, hw = seen['args']
    feats = [f.detach().requires_grad_(True) for f in feats]
    gen = torch.Generator(device='cuda').manual_seed(0)
    g = torch.randn(xyz.shape[:2] + (trunk.fusion.fuse.out_features,),
                    generator=gen, device='cuda')
    variants = {}
    for name in ('index_add_ (the path)', 'plain indexing'):
        out = (_fusion_indexing(trunk.fusion, feats, xyz, l2i, hw)
               if name == 'plain indexing'
               else trunk.fusion(feats, xyz, l2i, hw))

        def bwd(out=out):
            return torch.autograd.grad(out, feats, g, retain_graph=True)
        variants[name] = (device_ms(bwd, 5), bwd())
        del out
    ref = variants['index_add_ (the path)'][1]
    err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
              for a, b in zip(variants['plain indexing'][1], ref))
    ms = {name: t for name, (t, _) in variants.items()}
    print(f'(xt) fusion backward alone (device ms, into {len(feats)} FPN '
          f'maps from {xyz.shape[0]} x {xyz.shape[1]} points): '
          f'{ {k: round(v, 4) for k, v in ms.items()} }; gradients apart '
          f'by {err:.3g} of the largest (tol 1e-5) [{card}]')
    check(err <= 1e-5, 'the fusion backward variants disagree')
    return dict(fusion_backward_ms=ms)


def mvx_conv_algorithms(det, batch, card):
    """Device ms of the image branch's and of SECOND + SECONDFPN's forward
    and backward in training (a sum of their maps), with cuDNN's
    heuristics and with its benchmark mode (its algorithm search), and the
    FFT or Winograd kernels each runs."""
    trunk = det.trunk
    trunk.train()
    img = batch['img']
    gen = torch.Generator(device='cuda').manual_seed(0)
    canvas = torch.randn((img.shape[0], trunk.ny, trunk.nx,
                          trunk.backbone.blocks[0][0].in_channels),
                         generator=gen, device='cuda')
    parts = {
        'image branch': (lambda: trunk.image_features(img),
                         list(trunk.img_backbone.parameters())
                         + list(trunk.img_neck.parameters())),
        'SECOND + SECONDFPN': (lambda: trunk.neck(trunk.backbone(canvas)),
                               list(trunk.backbone.parameters())
                               + list(trunk.neck.parameters()))}
    cudnn = torch.backends.cudnn
    out = {}
    for part, (fwd, params) in parts.items():
        def step(fwd=fwd, params=params):
            maps = fwd()
            maps = maps if isinstance(maps, (list, tuple)) else [maps]
            torch.autograd.grad(sum(m.float().sum() for m in maps), params)
        for bench in (False, True):
            with cudnn.flags(enabled=cudnn.enabled, benchmark=bench,
                             deterministic=cudnn.deterministic,
                             allow_tf32=cudnn.allow_tf32):
                by_name = device_ms_by_name(step, 3)
            tilings = {k[:70]: round(v, 4) for k, v in by_name.items()
                       if 'fft' in k.lower() or 'winograd' in k.lower()
                       or 'cf32' in k.lower()}
            key = f'{part}, benchmark {"on" if bench else "off"}'
            out[key] = sum(by_name.values())
            print(f'(xt) {key}: forward + backward {out[key]:.3f} device ms; '
                  f'FFT / Winograd kernels {tilings or "none"} [{card}]')
    return dict(conv_ms=out)


def mvx_train_phase(batch, card):
    """(xt): K1's winner, K4 (39 + 39, each on its rows path) and K3 on a
    dense step's inputs held to their plain versions; the image
    backbone's gradient norm; the fusion's backward alone; 3 warm-up and
    10 sparse-target steps, 3 dense-target steps and a 3-step profile.
    -> (kernel numbers, launches, summary)."""
    tdet = mvx_detector()
    ddet = mvx_detector(head=dict(pos_cap=0))
    dstate = ddet.init_train(LR, total_steps=100)
    dstate, _ = ddet.train_step(batch, dstate)          # warm-up
    capture = {k: v for k, v in MVX_DENSE_LAUNCHES.items()
               if k in ('bn_moments', 'bn_grad_moments', 'segment_max_winner',
                        'gd_loss_fwd', 'gd_loss_bwd')}
    inputs, dstate = capture_train_inputs(ddet, batch, dstate, capture)
    with torch.no_grad():
        results = train_kernel_checks(inputs, card, ' (mvx step)')
    del inputs
    total, _ = tdet.loss(tdet.apply_train(batch), batch)
    img = [p for k, p in tdet.trunk.named_parameters()
           if k.startswith('img_backbone.')]
    grads = torch.autograd.grad(total, img)
    norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    n_zero = sum(int(float(g.abs().max()) == 0) for g in grads)
    print(f'(xt) image backbone gradient norm {norm:.6g} over {len(img)} '
          f'parameters ({n_zero} all zero) [{card}]')
    check(norm > 0 and n_zero == 0, 'the image backbone got no gradient')
    summary = dict(img_backbone_grad_norm=norm)
    summary.update(mvx_fusion_backward(tdet, batch, card))
    summary.update(mvx_conv_algorithms(tdet, batch, card))
    launches = {}
    tstate = tdet.init_train(LR, total_steps=100)
    launches['train'], tstate, train = timed_steps(
        tdet, batch, tstate, MVX_STEP_LAUNCHES, '(xt)', card)
    summary.update(train)
    launches['train_dense'], dstate, summary['dense_step_ms'] = dense_steps(
        ddet, batch, dstate, MVX_DENSE_LAUNCHES, '(xt)', card)
    del ddet, dstate
    holder = [tstate]

    def one_step():
        holder[0] = tdet.train_step(batch, holder[0])[0]
    summary.update(device_profile(one_step, 'train step', '(xt)', card, 3))
    return {k: {'step': v} for k, v in results.items()}, launches, summary


def mvx_phases(card):
    """Phases (c) mvx, (x), (x16) and (xt).  -> (kernel numbers by call,
    launches by path, summaries)."""
    t0 = time.perf_counter()
    tiny_mvx_card_vs_cpu(card)
    batches = [mvx_batch(s) for s in SEEDS]
    results, launches, summary = {}, {}, {}
    for tag, cfg in (('(x)', None), ('(x16)', dict(compute_dtype='bfloat16'))):
        det = mvx_detector(cfg)
        k, launches[f'predict{tag[2:-1]}'], summary[tag[1:-1]] = \
            mvx_predict_phase(det, batches, tag, card)
        for name, r in k.items():
            results.setdefault(name, {}).update(r)
        del det
        torch.cuda.empty_cache()
    k, step_launches, summary['xt'] = mvx_train_phase(batches[0], card)
    for name, r in k.items():
        results.setdefault(name, {}).update(r)
    launches.update(step_launches)
    del batches
    torch.cuda.empty_cache()
    summary['phases_s'] = time.perf_counter() - t0
    print(f'(c) mvx, (x), (x16), (xt) wall {summary["phases_s"]:.1f} s '
          f'[{card}]')
    return results, launches, summary


# ------------------------------------------------------- phases (w)-(wd)
# Waymo PointPillars (the gwd5 SyncBN 3-class config) at full width, and
# data-parallel training on the card.
WAYMO_CONFIG = ('configs/waymo/'
                'hv_pointpillars_secfpn_gwd5_sbn_8x4_2x_waymo-3d-3class.py')
WAYMO_POINTS = 180000
WAYMO_SEEDS = (10, 11, 12)
WAYMO_CLASSES = ('Car', 'Pedestrian', 'Cyclist')
# Waymo class sizes (dx, dy, dz), the config's anchor sizes
WAYMO_SIZES = ((4.73, 2.08, 1.77), (0.91, 0.84, 1.74), (1.81, 0.84, 1.77))
# the top LiDAR: 64 beams from +2.4 to -17.6 degrees at 2.2 m over the
# ground; the beams below the horizon sweep rings of the ground
WAYMO_BEAMS = np.radians(np.linspace(2.4, -17.6, 64))
WAYMO_SENSOR_Z = 2.2
WAYMO_PREDICT_LAUNCHES = {'bev_splat': 1, 'bev_splat_pairs': 0,
                          'rotated_iou': 1, 'nms_sweep': 1, **NO_K1}
WAYMO_STEP_LAUNCHES = {'bn_moments': 19, 'bn_grad_moments': 19,
                       'bev_splat': 1, 'bev_splat_pairs': 0, **NO_K1}
WAYMO_DENSE_LAUNCHES = {**WAYMO_STEP_LAUNCHES, **DENSE_LAUNCHES}
# (wd): two gloo ranks on the card against one rank on the 4 samples.
# Only the summation order differs (K4's chunks follow the row count, the
# gradients add up over two ranks), in f32 with TF32 off, through 19
# BatchNorms whose 1 / sigma scales a difference at each layer, and
# cuDNN's algorithms, which it picks by the batch (2 samples against 4):
# its f32 weight gradients of SECOND's 3 x 3 convs run through FFT tilings
# (`regular_fft_pad`, `vector_fft` and complex GEMMs in (wt)'s profile).
# The gradients' gap sits in conv weights (0.00348 and 0.00187 of a conv
# weight's largest at the two steps, where the loss terms agree to 3e-7,
# on an NVIDIA H100 80GB HBM3 at 700 W).  Each step from the same state:
# the loss terms within WD_LOSS_RTOL, every gradient leaf within
# WD_GRAD_TOL of its largest value, the running statistics within
# WD_STAT_TOL of their largest; K4's all-reduced sums within 1e-5 of the
# per-channel sum of magnitudes (phase (b)'s rule).  A rank that skipped
# the gradient all-reduce would be half the gradient off, local BatchNorm
# statistics or a local loss normalizer would move the loss terms by far
# more than WD_LOSS_RTOL.
WD_SEED = 10
WD_LOSS_RTOL = 1e-4
WD_GRAD_TOL = 1e-2
WD_STAT_TOL = 1e-4
WD_TIMEOUT_S = 300
WD_CLI_STEPS = 3
WD_TRAIN, WD_VAL = 8, 4
WAYMO_LIMIT_S = 150.0


def waymo_scene(rng, n=WAYMO_POINTS):
    """One Waymo-like frame from ``rng``: 20-40 boxes of the 3 classes at
    their sizes (centres log-uniform 4-60 m from the sensor), and ``n``
    points of (x, y, z, intensity, elongation): a tenth on the boxes, a
    fifth on walls (vertical segments 15-70 m out), the rest on the
    ground rings of the beams below the horizon, so the density falls
    with range as a spinning LiDAR's.  -> (points (n, 5) f32, boxes
    (G, 7) bottom-centred, labels (G,))."""
    g = rng.randint(20, 41)
    cls = rng.choice(3, g, p=(0.6, 0.3, 0.1))
    r = np.exp(rng.uniform(np.log(4.0), np.log(60.0), g))
    phi = rng.uniform(-np.pi, np.pi, g)
    dims = np.asarray(WAYMO_SIZES)[cls] * rng.uniform(0.9, 1.1, (g, 3))
    yaw = rng.uniform(-np.pi, np.pi, g)
    boxes = np.c_[r * np.cos(phi), r * np.sin(phi), np.zeros(g), dims,
                  yaw].astype(np.float32)
    n_obj, n_wall = n // 10, n // 5
    n_gnd = n - n_obj - n_wall
    owner = rng.randint(0, g, n_obj)
    local = rng.uniform(-0.5, 0.5, (n_obj, 3)) * boxes[owner, 3:6]
    c, s = np.cos(boxes[owner, 6]), np.sin(boxes[owner, 6])
    obj = np.c_[boxes[owner, 0] + c * local[:, 0] - s * local[:, 1],
                boxes[owner, 1] + s * local[:, 0] + c * local[:, 1],
                boxes[owner, 5] / 2 + local[:, 2]]
    n_walls = 24
    w_r = rng.uniform(15.0, 70.0, n_walls)
    w_phi = rng.uniform(-np.pi, np.pi, n_walls)
    w_len = rng.uniform(5.0, 25.0, n_walls)
    w_dir = w_phi + np.pi / 2 + rng.uniform(-0.5, 0.5, n_walls)
    which = rng.randint(0, n_walls, n_wall)
    t = rng.uniform(-0.5, 0.5, n_wall) * w_len[which]
    wall = np.c_[w_r[which] * np.cos(w_phi[which])
                 + t * np.cos(w_dir[which]),
                 w_r[which] * np.sin(w_phi[which])
                 + t * np.sin(w_dir[which]),
                 rng.uniform(0.0, 3.5, n_wall)]
    down = WAYMO_BEAMS[WAYMO_BEAMS < np.radians(-1.5)]
    rings = WAYMO_SENSOR_Z / np.tan(-down)
    ring = rings[rng.randint(0, len(rings), n_gnd)]
    rr = ring * (1 + rng.normal(0, 0.002, n_gnd))
    pp = rng.uniform(-np.pi, np.pi, n_gnd)
    gnd = np.c_[rr * np.cos(pp), rr * np.sin(pp),
                rng.normal(0.0, 0.03, n_gnd)]
    xyz = np.concatenate([obj, wall, gnd])
    pts = np.c_[xyz, rng.uniform(0, 1, n), rng.uniform(0, 0.3, n)]
    return pts.astype(np.float32), boxes, cls.astype(np.int32)


def waymo_batch(seed, b=BATCH, n=WAYMO_POINTS, num_gt=64, dev='cuda'):
    """A batch of ``b`` :func:`waymo_scene` frames from ``seed``."""
    rng = np.random.RandomState(seed)
    points = np.zeros((b, n, 5), np.float32)
    gt = np.zeros((b, num_gt, 7), np.float32)
    labels = np.zeros((b, num_gt), np.int32)
    valid = np.zeros((b, num_gt), bool)
    for i in range(b):
        pts, boxes, cls = waymo_scene(rng, n)
        points[i] = pts
        gt[i, :len(boxes)] = boxes
        labels[i, :len(boxes)] = cls
        valid[i, :len(boxes)] = True
    arrays = dict(points=points, points_mask=np.ones((b, n), bool),
                  gt_bboxes=gt, gt_labels=labels, gt_valid=valid)
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def waymo_config(repo):
    from mmdet3d_gaussian_tpu_torch.tools.common import load_config
    return load_config(os.path.join(repo, WAYMO_CONFIG))


def waymo_detector(cfg, head=None, group=None, seed=0):
    """The config's detector on the card from ``seed`` (through the CLIs'
    ``build_detector``), its cls bias zeroed so that NMS has candidates;
    ``head`` updates the config's head."""
    from mmdet3d_gaussian_tpu_torch.tools.common import build_detector
    cfg = dict(model=dict(cfg.get('model')),
               head=dict(cfg.get('head'), **(head or {})))
    det = build_detector(cfg, 'cuda', seed=seed, group=group)
    with torch.no_grad():
        det.trunk.bbox_head.conv_cls.bias.zero_()
    return det


def waymo_pillars(det, batch, tag):
    """Print the live pillars of each sample (the distinct canvas cells
    its points fall in) and how many hard voxelize drops at the batch's
    capacity; -> (live per sample, dropped)."""
    from mmdet3d_gaussian_tpu_torch.ops.scatter import compute_voxel_coords
    trunk = det.trunk
    per = []
    for pts in batch['points']:
        coords, _ = compute_voxel_coords(pts[:, :3], trunk.point_cloud_range,
                                         trunk.voxel_size)
        live = (coords >= 0).all(-1)
        cell = coords[live, 0].long() * trunk.ny + coords[live, 1].long()
        per.append(int(torch.unique(cell).numel()))
    with torch.inference_mode():
        _, _, sc = trunk.pillars(batch['points'], batch['points_mask'])
    dropped = int(sc.num_overflow)
    print(f'{tag} live pillars per sample {per}, capacity '
          f'{trunk.max_voxels_per_sample} a sample ({sc.max_voxels} the '
          f'batch): {int(sc.num_voxels)} kept, {dropped} dropped')
    return per, dropped


def waymo_predict_phase(det, batches, card):
    """(w): K2, K5, K6 on one predict's inputs held to their plain
    versions and timed; 6 requests with launch counts; a profile.  ->
    (kernel numbers, launches, summary)."""
    b0 = batches[0]
    with torch.inference_mode():
        calls = record_calls(lambda: det.predict(b0), predict_patches())
        got = {k: len(v) for k, v in calls.items()}
        want = {k: v for k, v in WAYMO_PREDICT_LAUNCHES.items() if v}
        check(got == want, f'(w) predict called {got}, want {want}')
        results = mvx_kernel_checks(calls, card, 'predict',
                                    ' (waymo predict)', tag='(w)')
    del calls
    per, dropped = waymo_pillars(det, b0, '(w)')
    launches, summary = main_path(det, batches, WAYMO_PREDICT_LAUNCHES,
                                  '(w)', card, out_rows=det.head.test_cfg[
                                      'max_num'], points=WAYMO_POINTS)
    summary.update(pillars_per_sample=per, pillars_dropped=dropped)
    summary.update(device_profile(lambda: det.predict(b0), 'predict', '(w)',
                                  card, 3))
    return results, launches, summary


def waymo_train_phase(cfg, batch, card):
    """(wt): K4 (19 + 19) and K3 (its gwd3d form) on a dense step's inputs
    held to their plain versions; 3 warm-up and 10 sparse-target steps,
    3 dense-target steps and a 3-step profile.  -> (kernel numbers,
    launches, summary)."""
    tdet = waymo_detector(cfg)
    ddet = waymo_detector(cfg, head=dict(pos_cap=0))
    dstate = ddet.init_train(LR, total_steps=100)
    dstate, _ = ddet.train_step(batch, dstate)          # warm-up
    capture = {k: WAYMO_DENSE_LAUNCHES[k] for k in (
        'bn_moments', 'bn_grad_moments', 'gd_loss_fwd', 'gd_loss_bwd')}
    inputs, dstate = capture_train_inputs(ddet, batch, dstate, capture)
    check(inputs['gd_loss_fwd'][0][5][0] == 'gwd3d',
          f'K3 ran {inputs["gd_loss_fwd"][0][5]}, want the gwd3d form')
    with torch.no_grad():
        results = train_kernel_checks(inputs, card, ' (waymo step)')
    del inputs
    launches, summary = {}, {}
    tstate = tdet.init_train(LR, total_steps=100)
    launches['train'], tstate, summary = timed_steps(
        tdet, batch, tstate, WAYMO_STEP_LAUNCHES, '(wt)', card,
        points=WAYMO_POINTS)
    launches['train_dense'], dstate, summary['dense_step_ms'] = dense_steps(
        ddet, batch, dstate, WAYMO_DENSE_LAUNCHES, '(wt)', card)
    del ddet, dstate
    holder = [tstate]

    def one_step():
        holder[0] = tdet.train_step(batch, holder[0])[0]
    summary.update(device_profile(one_step, 'train step', '(wt)', card, 3))
    return {k: {'step': v} for k, v in results.items()}, launches, summary


def wd_steps(det, batch, steps=2, group=None, start=None,
             keep_state=False):
    """``steps`` train steps of ``det`` on ``batch`` (from ``start``, a
    state this function kept, if given); -> each step's metrics, the
    gradients AdamW was given and the running statistics (on the host),
    the parameters after the last, with ``keep_state`` the state after
    the first step; under ``group`` also the first step's K4 sums after
    the all-reduce beside the plain moments (and sums of magnitudes) of
    this rank's rows, each step's forward BatchNorm sums after the
    all-reduce (``sums``, as :func:`wf_steps` records them for a replay),
    and the host time of the step's BatchNorm all-reduces in one more
    step."""
    from mmdet3d_gaussian_tpu_torch.models import voxel_encoders
    from mmdet3d_gaussian_tpu_torch.ops import bn
    from mmdet3d_gaussian_tpu_torch.parallel.train_state import (
        OptState, make_optimizer)
    opt = make_optimizer(LR, 100)
    grads = []
    update = opt.update

    def recording(g, *args, **kw):
        grads.append({k: v.detach().cpu().clone() for k, v in g.items()})
        return update(g, *args, **kw)
    opt.update = recording
    sums, forward = [], [False]
    apply_train = det.apply_train

    def apply(b):
        forward[0] = True
        sums.append(dict(bn=[], masked=[]))
        try:
            return apply_train(b)
        finally:
            forward[0] = False
    det.apply_train = apply
    state = det.init_train(optimizer=opt)
    if start is not None:
        det.trunk.load_state_dict(start['trunk'], strict=True)
        dev = det.device
        state = state._replace(step=start['step'], opt_state=OptState(
            start['count'], {k: v.to(dev) for k, v in start['mu'].items()},
            {k: v.to(dev) for k, v in start['nu'].items()}))
    k4 = dict(reduced=[], plain=[], mags=[])
    originals = (bn.moments, bn._group_sums)
    first = [group is not None]

    def moments(x):
        out = originals[0](x)
        if first[0]:
            rows = bn._channels_last_2d(x).float()
            k4['plain'].append(tuple(t.cpu() for t in
                                     bn.moments_plain(x)))
            k4['mags'].append((rows.abs().sum(0).cpu(),
                               (rows * rows).sum(0).cpu()))
        return out

    def group_sums(*args):
        out = originals[1](*args)
        if first[0] and len(k4['reduced']) < len(k4['plain']):
            k4['reduced'].append(tuple(t.cpu() for t in out[:2]))
        if forward[0]:
            sums[-1]['bn'].append(tuple(t.detach().cpu() for t in out))
        return out
    all_reduce = voxel_encoders.all_reduce_with_grad

    def masked_all_reduce(x, grp):
        out = all_reduce(x, grp)
        sums[-1]['masked'].append(out.detach().cpu())
        return out
    if group is not None:
        voxel_encoders.all_reduce_with_grad = masked_all_reduce
    bn.moments, bn._group_sums = moments, group_sums
    metrics, stats, kept = [], [], None
    try:
        for _ in range(steps):
            state, m = det.train_step(batch, state)
            first[0] = False
            metrics.append({k: float(v) for k, v in m.items()})
            stats.append({k: v.cpu().clone() for k, v in
                          det.trunk.named_buffers() if 'running_' in k})
            if keep_state and kept is None:
                opt_state = state.opt_state
                kept = dict(
                    trunk={k: v.cpu().clone()
                           for k, v in det.trunk.state_dict().items()},
                    step=state.step, count=opt_state.count,
                    mu={k: v.cpu().clone() for k, v in opt_state.mu.items()},
                    nu={k: v.cpu().clone() for k, v in opt_state.nu.items()})
    finally:
        bn.moments, bn._group_sums = originals
        voxel_encoders.all_reduce_with_grad = all_reduce
        forward[0] = False
    out = dict(metrics=metrics, grads=grads, stats=stats, k4=k4, state=kept,
               sums=sums,
               params={k: v.detach().cpu().clone()
                       for k, v in det.trunk.named_parameters()})
    if group is not None:
        spent = [0.0, 0]

        def timed(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = originals[1](*args)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return res
        bn._group_sums = timed
        try:
            det.train_step(batch, state)
        finally:
            bn._group_sums = originals[1]
        out['bn_all_reduce'] = dict(ms=spent[0] * 1e3, calls=spent[1])
    return out


def wd_rank(rank, world, store, repo, tmp):
    """One rank of (wd) 1: gloo on the card (``cuda:0``, as torchrun's
    ``LOCAL_RANK`` would say for one card), the config's detector from
    seed 0 under the group, this rank's rows of the global batch, 2
    checked steps and one timed one; saves :func:`wd_steps`' result."""
    import datetime
    import traceback
    out = os.path.join(tmp, f'rank{rank}.pt')
    try:
        sys.path.insert(0, repo)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import torch.distributed as dist
        from mmdet3d_gaussian_tpu_torch.parallel.mesh import (
            init_distributed, shard_batch)
        group = init_distributed(
            backend='gloo', init_method='file://' + store, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=WD_TIMEOUT_S))
        det = waymo_detector(waymo_config(repo), group=group)
        batch = shard_batch(waymo_batch(WD_SEED), group)
        torch.save(dict(wd_steps(det, batch, group=group,
                                 keep_state=rank == 0), rank=rank,
                        world=group.world,
                        device=str(next(det.trunk.parameters()).device)),
                   out)
        dist.destroy_process_group()
    except BaseException:
        with open(out + '.err', 'w') as f:
            f.write(traceback.format_exc())
        raise


def rel_max(a, b):
    """max |a - b| over the largest |b| (a leaf's difference relative to
    its largest value)."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def worst_of(got, want, rel):
    """(largest of ``rel(got[k], want[k])`` over the keys, its key)."""
    return max((rel(got[k], v), k) for k, v in want.items())


def wd_two_ranks(repo, cfg, card):
    """(wd) 1: the full-width Waymo step on two gloo ranks on the card
    against one rank on the 4 samples, each step from the same state: the
    first from the seed's weights, the second from rank 0's state after
    the first (a random init's first AdamW step moves every weight by
    about lr, so a sign flip of a gradient at its rounding carries into
    the next step at full size).  -> summary."""
    import tempfile
    det = waymo_detector(cfg)
    batch = waymo_batch(WD_SEED)
    # the capacity is the global batch's on two ranks as on one, so a
    # batch that drops pillars keeps the same ones ((wf) holds that)
    per, dropped = waymo_pillars(det, batch, '(wd)')
    t0 = time.perf_counter()
    one = [wd_steps(det, batch, steps=1)]
    one_s = time.perf_counter() - t0
    del det
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_wd_') as tmp:
        ranks = spawn_ranks(wd_rank, repo, tmp, 2, WD_TIMEOUT_S, '(wd)')
    spawn_s = time.perf_counter() - t0
    a, b = ranks
    det = waymo_detector(cfg)
    one.append(wd_steps(det, batch, steps=1, start=a['state']))
    del det
    torch.cuda.empty_cache()
    # the gradients against one rank that replays the ranks' forward
    # BatchNorm sums of the step: their other f32 order otherwise moves an
    # activation at a ReLU's kink to its other side (the one rank's
    # loss terms and statistics stay its own)
    replayed = []
    for s in range(2):
        det = waymo_detector(cfg)
        replayed.append(wf_steps(
            det, batch, 1, start=a['state'] if s else None,
            replay=_sums_to(a['sums'][s:s + 1], 'cuda')))
        del det
        torch.cuda.empty_cache()
    del batch
    check(a['world'] == b['world'] == 2 and a['device'].startswith('cuda'),
          f'(wd) ranks ran on {a["device"]}, world {a["world"]}')
    for k in a['params']:
        check(torch.equal(a['params'][k], b['params'][k]),
              f'(wd) rank parameters differ: {k}')
    for k in a['stats'][-1]:
        check(torch.equal(a['stats'][-1][k], b['stats'][-1][k]),
              f'(wd) rank running statistics differ: {k}')
    worst = {}
    for s in range(2):
        ref = one[s]
        worst[f'step{s + 1}'] = dict(
            loss=worst_of(a['metrics'][s], {k: v for k, v in
                                            ref['metrics'][0].items()
                                            if k != 'grad_norm'},
                          lambda g, w: abs(g - w) / max(abs(w), 1e-30)),
            grad=worst_of(a['grads'][s], replayed[s]['grads'][0], rel_max),
            stat=worst_of(a['stats'][s], ref['stats'][0], rel_max))
    params = worst_of(a['params'], one[1]['params'], rel_max)
    # K4: the all-reduced sums of each forward BatchNorm of step 1 against
    # the plain moments of both ranks' rows, over the sums of magnitudes
    k4_rel, n_calls = 0.0, len(a['k4']['reduced'])
    check(n_calls == 19 and len(b['k4']['reduced']) == 19,
          f'(wd) {n_calls} all-reduced K4 calls in step 1, want 19')
    for i in range(n_calls):
        for j in range(2):
            got = a['k4']['reduced'][i][j]
            check(torch.equal(got, b['k4']['reduced'][i][j]),
                  f'(wd) ranks hold other K4 sums at BatchNorm {i}')
            want = a['k4']['plain'][i][j] + b['k4']['plain'][i][j]
            mag = a['k4']['mags'][i][j] + b['k4']['mags'][i][j]
            k4_rel = max(k4_rel, float(((got - want).abs()
                                        / mag.clamp(min=1e-30)).max()))
    for step, w in worst.items():
        print(f'(wd) {step}, two gloo ranks on one card at global B = 4 '
              f'(2 + 2) against one rank on the 4 samples from the same '
              f'state: loss terms within {w["loss"][0]:.3g} ({w["loss"][1]};'
              f' tol {WD_LOSS_RTOL}), gradients (one rank replaying the '
              f'ranks\' forward BatchNorm sums) within {w["grad"][0]:.3g} '
              f'of the leaf\'s largest ({w["grad"][1]}; tol {WD_GRAD_TOL}), '
              f'running statistics {w["stat"][0]:.3g} ({w["stat"][1]}; tol '
              f'{WD_STAT_TOL}) [{card}]')
    print(f'(wd) parameters after step 2 within {params[0]:.3g} of the '
          f'leaf\'s largest ({params[1]}; AdamW moves each weight by about '
          f'lr whatever its gradient\'s size: not checked); the ranks\' '
          f'parameters and statistics bitwise equal; K4\'s all-reduced sums '
          f'against the plain moments of the 4 samples {k4_rel:.3g} of the '
          f'sums of magnitudes (tol 1e-5) [{card}]')
    agree = (all(w['loss'][0] <= WD_LOSS_RTOL and w['grad'][0] <= WD_GRAD_TOL
                 and w['stat'][0] <= WD_STAT_TOL for w in worst.values())
             and k4_rel <= 1e-5)
    ar = a['bn_all_reduce']
    print(f'(wd) the step\'s {ar["calls"]} BatchNorm all-reduces (gloo, two '
          f'ranks on one card; synchronized on each side, host clock): '
          f'{ar["ms"]:.3f} ms a step on rank 0, {b["bn_all_reduce"]["ms"]:.3f}'
          f' ms on rank 1; a one-rank step {one_s:.1f} s with its start, '
          f'the two-rank run {spawn_s:.1f} s wall [{card}]')
    check(ar['calls'] == 38, f'(wd) {ar["calls"]} all-reduces a step, '
          f'want 38')
    return dict({f'{step}_{k}': v[0] for step, w in worst.items()
                 for k, v in w.items()}, params_rel=params[0],
                k4_rel=k4_rel, all_reduce_ms=ar['ms'],
                all_reduce_calls=ar['calls'], pillars_per_sample=per,
                pillars_dropped=dropped,
                spawn_s=spawn_s, agree=agree)


def nccl_all_reduce_ms(card, iters=20):
    """Device ms of the 38 all-reduces of a Waymo step's BatchNorms
    (2C + 1 floats each) over an NCCL group of one rank on the card, CUDA
    events around ``iters`` steps' worth."""
    import datetime
    import tempfile
    import torch.distributed as dist
    widths = [64] * 4 + [128] * 6 + [256] * 6 + [128] * 3
    with tempfile.TemporaryDirectory(prefix='chip_smoke_nccl_') as tmp:
        dist.init_process_group(
            'nccl', init_method='file://' + os.path.join(tmp, 'store'),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            bufs = [torch.zeros(2 * c + 1, device='cuda')
                    for c in widths for _ in range(2)]

            def run():
                for t in bufs:
                    dist.all_reduce(t)
            ms = cuda_ms(run, iters)
        finally:
            dist.destroy_process_group()
    print(f'(wd) the 38 BatchNorm all-reduces of a step over NCCL, one '
          f'rank: {ms:.4f} ms a step (CUDA events over {iters} steps) '
          f'[{card}]')
    return ms


def write_waymo_tree(root, seed=0, n_train=WD_TRAIN, n_val=WD_VAL):
    """A Waymo-format (KITTI-layout) tree of :func:`waymo_scene` frames:
    6-column bins (x, y, z, intensity, elongation, timestamp) under
    ``training/velodyne_reduced``, identity calibrations, camera-frame
    boxes with their difficulty and point counts, and
    ``waymo_infos_{train,val}.pkl``.  -> frames written."""
    import pickle
    rng = np.random.RandomState(seed)
    vel = os.path.join(root, 'training', 'velodyne_reduced')
    os.makedirs(vel, exist_ok=True)
    calib = dict(R0_rect=np.eye(4), Tr_velo_to_cam=np.eye(4),
                 P2=np.eye(3, 4))
    infos = []
    for i in range(n_train + n_val):
        pts, boxes, cls = waymo_scene(rng)
        np.c_[pts, np.zeros(len(pts))].astype(np.float32).tofile(
            os.path.join(vel, f'{i:07d}.bin'))
        # points inside each box (its bottom-centred frame)
        d = pts[None, :, :3] - boxes[:, None, :3]
        c, s = np.cos(-boxes[:, 6:7]), np.sin(-boxes[:, 6:7])
        lx = c * d[..., 0] - s * d[..., 1]
        ly = s * d[..., 0] + c * d[..., 1]
        inside = ((np.abs(lx) <= boxes[:, 3:4] / 2)
                  & (np.abs(ly) <= boxes[:, 4:5] / 2)
                  & (d[..., 2] >= 0) & (d[..., 2] <= boxes[:, 5:6]))
        g = len(boxes)
        annos = dict(
            name=np.asarray([WAYMO_CLASSES[k] for k in cls]),
            location=boxes[:, :3].astype(np.float64),
            dimensions=boxes[:, [3, 5, 4]].astype(np.float64),
            rotation_y=(-boxes[:, 6] - np.pi / 2).astype(np.float64),
            bbox=np.tile([0., 0., 100., 100.], (g, 1)),
            occluded=np.zeros(g, np.int32), truncated=np.zeros(g),
            difficulty=np.where(rng.rand(g) < 0.2, 2, 1).astype(np.int32),
            num_points_in_gt=inside.sum(1).astype(np.int32))
        infos.append(dict(
            point_cloud=dict(velodyne_path=f'training/velodyne/{i:07d}.bin'),
            calib=calib, annos=annos))
    for name, part in (('train', infos[:n_train]), ('val', infos[n_train:])):
        with open(os.path.join(root, f'waymo_infos_{name}.pkl'), 'wb') as f:
            pickle.dump(part, f)
    return len(infos)


def waymo_derived_config(tmp, root, repo):
    """``tmp/waymo.py``: the Waymo config by absolute path with only its
    train and val data paths moved under ``root``; checked to load to that
    config with those paths changed and nothing else.  -> its path."""
    from mmdet3d_gaussian_tpu_torch.utils.config import Config
    base = os.path.join(repo, WAYMO_CONFIG)
    want = Config.fromfile(base).to_dict()
    for split in ('train', 'val'):
        want['data'][split]['data_root'] = root + '/'
        want['data'][split]['ann_file'] = os.path.join(
            root, f'waymo_infos_{split}.pkl')
    text = f'_base_ = [{base!r}]\ndata = dict(\n' + ''.join(
        f'    {split}=dict(data_root={want["data"][split]["data_root"]!r}, '
        f'ann_file={want["data"][split]["ann_file"]!r}),\n'
        for split in ('train', 'val')) + ')\n'
    path = os.path.join(tmp, 'waymo.py')
    with open(path, 'w') as f:
        f.write(text)
    check(Config.fromfile(path).to_dict() == want, 'the derived Waymo '
          'config differs from the config beyond its data paths')
    return path


def wd_cli(repo, card):
    """(wd) 2 and 3: ``torchrun --nproc_per_node 1`` of the train CLI with
    ``--distributed`` (NCCL, world 1) on a Waymo-format tree written here,
    WD_CLI_STEPS steps, then the test CLI with ``--metric waymo`` on its
    checkpoint.  -> (launches per run, summary)."""
    import tempfile
    summary, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_waymo_') as tmp:
        root = os.path.join(tmp, 'waymo')
        t0 = time.perf_counter()
        frames = write_waymo_tree(root)
        cfg_path = waymo_derived_config(tmp, root, repo)
        print(f'(wd) Waymo-format tree: {frames} frames ({WD_TRAIN} train, '
              f'{WD_VAL} val), config {WAYMO_CONFIG} with its data paths '
              f'moved [{time.perf_counter() - t0:.1f} s]')
        runner = os.path.join(tmp, 'runner.py')
        with open(runner, 'w') as f:
            f.write(CLI_RUNNER)
        counts = os.path.join(tmp, 'launches_train.json')
        work = os.path.join(tmp, 'work')
        env = dict(os.environ, PYTHONPATH=repo)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, '-m', 'torch.distributed.run', '--standalone',
             '--nproc_per_node', '1', runner, counts, 'train', cfg_path,
             '--distributed', '--work-dir', work, '--max-steps',
             str(WD_CLI_STEPS), '--log-interval', '1'],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        summary['train_s'] = time.perf_counter() - t0
        check(out.returncode == 0, f'(wd) torchrun train exited '
              f'{out.returncode}: {out.stderr[-3000:]}')
        with open(counts) as f:
            launches['train'] = {k: v for k, v in json.load(f).items() if v}
        log = read_log(work)
        check([r['step'] for r in log] == list(range(1, WD_CLI_STEPS + 1))
              and all(math.isfinite(r['loss']) for r in log),
              f'(wd) train log {log}')
        check_launches('(wd) torchrun train', launches['train'],
                       {k: v for k, v in WAYMO_STEP_LAUNCHES.items() if v},
                       WD_CLI_STEPS)
        print(f'(wd) torchrun --nproc_per_node 1 tools.train --distributed '
              f'(NCCL, world 1): {WD_CLI_STEPS} steps in '
              f'{summary["train_s"]:.1f} s, losses '
              f'{[round(r["loss"], 4) for r in log]}, launches '
              f'{launches["train"]} [{card}]')
        ckpt = os.path.join(work, f'ckpt_{WD_CLI_STEPS}.pt')
        stdout, launches['test'], summary['test_s'] = run_cli(
            'test', [cfg_path, ckpt, '--metric', 'waymo'], tmp, repo)
        report = report_json(stdout)
        bad = {k: v for k, v in report.items()
               if not (math.isfinite(v) and 0.0 <= v <= 1.0)}
        check(report and not bad, f'(wd) waymo report outside [0, 1]: '
              f'{bad or report}')
        check_launches('(wd) test', launches['test'],
                       {k: v for k, v in WAYMO_PREDICT_LAUNCHES.items()
                        if v}, 1)
        summary['report'] = report
        print(f'(wd) tools.test --metric waymo on ckpt_{WD_CLI_STEPS}.pt: '
              f'{len(report)} values in [0, 1] (mAP_L1 '
              f'{report.get("mAPH_L1", float("nan")):.4f} mAPH_L1, '
              f'{report["mAP_L2"]:.4f} mAP_L2) in {summary["test_s"]:.1f} s,'
              f' launches {launches["test"]} [{card}]')
    return launches, summary


# phase (wf): data parallel for CenterPoint, MVF, MVX and PV-RCNN.  One
# group of two gloo ranks on the card (NCCL refuses two ranks on one device)
# runs each family's TINY train step (tests/torch_dist_families.py's cases)
# at global B = 4 (2 + 2), 2 steps each, on batches whose voxels and sites
# overflow the global capacity unevenly over the ranks; one rank on the
# whole batch is the reference, step by step from the same state.
WF_TIMEOUT_S = 240
WF_LIMIT_S = 75.0
WF_B = 4
WF_GWD = dict(type='GDLoss', loss_type='gwd3d', fun='log1p', tau=1.0,
              loss_weight=5.0)
WF_CP_PCR = (-12.8, -12.8, -3.0, 12.8, 12.8, 1.0)
WF_MVF_PCR = (0., -9.6, -3., 25.6, 9.6, 1.)
WF_ANCHOR_TEST = dict(use_rotate_nms=True, nms_thr=0.01, score_thr=0.05,
                      nms_pre=128, max_num=32)
# family -> (detector, model, head, pile voxel size or None); capacities
# below the batches' live voxels (1,033 + 1,815 pillars against 2,400 for
# CenterPoint, both MVF views against their config's 1,100, 864 + 1,301
# against 1,800 for MVX; PV-RCNN's level 1 keeps no site of rank 1)
WF_CASES = {
    'centerpoint': ('CenterPointDetector', dict(
        voxel_size=(0.4, 0.4, 4.0), point_cloud_range=WF_CP_PCR,
        max_voxels_per_sample=600, voxelize_mode='dynamic',
        head_type='center',
        encoder_cfg=dict(in_channels=4, feat_channels=(16,)),
        backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                          layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
        neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                      upsample_strides=(0.5, 1, 2))),
        dict(tasks=[dict(num_classes=2), dict(num_classes=1)],
             out_size_factor=4, with_vel=False, code_weights=None,
             max_objs=16, yaw_mode=True, loss_gd=WF_GWD,
             test_cfg=dict(max_per_img=32, score_threshold=0.05,
                           nms_type='rotate', nms_thr=0.2,
                           post_max_size=16))),
    'mvf': ('PointPillarsDetector', dict(
        voxel_size=(0.4, 0.4, 4.0), point_cloud_range=WF_MVF_PCR,
        max_points_per_voxel=16, max_voxels_per_sample=1024,
        voxelize_mode='mvf',
        encoder_cfg=dict(in_channels=4, feat_channels=16,
                         views=('cartesian', 'cylindrical'),
                         voxel_size=((0.4, 0.4, 4.0), (0.04, 0.4, 40.0)),
                         point_cloud_range=(
                             WF_MVF_PCR, (-0.78, -3.0, 0.0, 0.78, 1.4,
                                          40.0)),
                         max_voxels=1100),
        backbone_cfg=dict(in_channels=16, out_channels=(16, 32, 64),
                          layer_nums=(1, 1, 1), layer_strides=(2, 2, 2)),
        neck_cfg=dict(in_channels=(16, 32, 64), out_channels=(16, 16, 16),
                      upsample_strides=(1, 2, 4)),
        head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=48)),
        dict(test_cfg=dict(WF_ANCHOR_TEST, nms_pre=128), pos_cap=0)),
    'mvx': ('MVXDetector', dict(TINY_MVX, max_voxels_per_sample=450),
            TINY_MVX_HEAD),
    'pvrcnn': ('PVRCNNDetector', TINY_PVRCNN, TINY_PV_RPN),
}
# the kernels each family's step must launch on both ranks (K3 in MVF's
# dense step, K5 and K6 in PV-RCNN's proposals)
WF_KERNELS = {
    'centerpoint': ('bn_moments', 'bn_grad_moments', 'segment_max_winner',
                    'segment_reduce_mapback', 'bev_splat_pairs'),
    'mvf': ('bn_moments', 'bn_grad_moments', 'segment_max_winner',
            'segment_reduce_mapback', 'bev_splat', 'gd_loss_fwd',
            'gd_loss_bwd'),
    'mvx': ('bn_moments', 'bn_grad_moments', 'segment_max_winner',
            'segment_reduce_mapback', 'bev_splat'),
    'pvrcnn': ('bn_moments', 'bn_grad_moments', 'segment_reduce',
               'rotated_iou', 'nms_sweep'),
}
# the modules that voxelize through build_scatter
WF_SCATTER_USERS = ('ops.voxelize', 'models.detectors.voxelnet',
                    'models.mvf_encoder', 'ops.sparse_conv', 'engine.pvrcnn')


def wf_detector(name, group=None):
    """The family's TINY detector on the card from seed 0."""
    from mmdet3d_gaussian_tpu_torch.engine import detector, mvx, pvrcnn
    cls_name, model, head = WF_CASES[name]
    cls = dict(CenterPointDetector=detector.CenterPointDetector,
               PointPillarsDetector=detector.PointPillarsDetector,
               MVXDetector=mvx.MVXDetector,
               PVRCNNDetector=pvrcnn.PVRCNNDetector)[cls_name]
    return cls(model, head, device='cuda', seed=0, group=group)


def wf_batch(name, det=None):
    """The family's global batch on the CPU: ``crowded_batch``'s piles on
    rank 0's samples (CenterPoint, MVF, MVX); for PV-RCNN
    ``synthetic_batch`` with RPN and RoI positives from ``det``."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import (crowded_batch,
                                                            synthetic_batch)
    from mmdet3d_gaussian_tpu_torch.engine.mvx import synthetic_mvx_batch
    from mmdet3d_gaussian_tpu_torch.engine.pvrcnn import positive_batch
    model = WF_CASES[name][1]
    pcr = model['point_cloud_range']
    if name == 'pvrcnn':
        return positive_batch(det, synthetic_batch(WF_B, 512, 4, pc_range=pcr,
                                                   device='cpu'))
    if name == 'mvx':
        batch = synthetic_mvx_batch(WF_B, 1024, 8, img_hw=TINY_MVX_IMG_HW,
                                    pc_range=pcr, device='cpu')
    else:
        batch = synthetic_batch(WF_B, 1024, 8, pc_range=pcr, device='cpu')
    piles = crowded_batch(WF_B, 1024, 8, pc_range=pcr,
                          voxel_size=(0.4, 0.4, 4.0), device='cpu')
    batch['points'][:WF_B // 2] = piles['points'][:WF_B // 2]
    return batch


def wf_steps(det, batch, steps, group=None, start=None, replay=None):
    """``steps`` train steps of ``det`` on ``batch`` (on the card), from
    ``start`` (a state this function kept) if given: each step's metrics,
    the summed gradients AdamW was given, the running statistics, the
    kept voxel and site coords of each voxelization and sparse level (the
    batch column made global) with their overflow, the launches of the
    steps, the state after each step (on the host), PV-RCNN's RoI samples
    of each step, and under a group each step's forward BatchNorm sums
    after the all-reduce (K4's and the masked ones).  ``replay``: such
    sums of as many steps (and PV-RCNN's samples, the ranks' concatenated
    on the batch axis), which then stand in for a one-rank run's own (the
    masked sums keep their gradient), so that an activation at a ReLU's
    kink, or a proposal at the top-k's edge, does not fall on its other
    side on one of the runs."""
    import importlib
    from mmdet3d_gaussian_tpu_torch.engine import pvrcnn
    from mmdet3d_gaussian_tpu_torch.models import voxel_encoders
    from mmdet3d_gaussian_tpu_torch.ops import _cuda, bn
    from mmdet3d_gaussian_tpu_torch.parallel.train_state import (
        OptState, make_optimizer)
    opt = make_optimizer(LR, 100)
    grads = []
    update = opt.update

    def recording(g, *args, **kw):
        grads.append({k: v.detach().cpu().clone() for k, v in g.items()})
        return update(g, *args, **kw)
    opt.update = recording
    batch = {k: v.to(det.device) for k, v in batch.items()}
    offset = 0 if group is None else group.rank * batch['points'].shape[0]
    forward, kept, sums = [False], [], []
    users = [importlib.import_module('mmdet3d_gaussian_tpu_torch.' + m)
             for m in WF_SCATTER_USERS]
    originals = dict(scatters=[u.build_scatter for u in users],
                     group_sums=bn._group_sums, batch_stats=bn.batch_stats,
                     all_reduce=voxel_encoders.all_reduce_with_grad,
                     masked_sums=voxel_encoders.masked_sums,
                     sample=pvrcnn.assign_and_sample)
    samples = []
    played_samples = None if replay is None else iter(
        [r['samples'] for r in replay if r.get('samples') is not None])

    def assign_and_sample(*args, **kw):
        out = originals['sample'](*args, **kw)
        if played_samples is not None:
            rec = next(played_samples)
            out = type(out)(*(t.to(out.rois.device) for t in rec))
        samples.append(tuple(t.detach().cpu() for t in out))
        return out

    def wrap(original):
        def build_scatter(coords, spatial_shape, max_voxels,
                          key_order=None, group=None):
            sc = original(coords, spatial_shape, max_voxels,
                          key_order=key_order, group=group)
            if forward[0]:
                rows = sc.voxel_coords[sc.voxel_counts > 0].cpu().clone()
                rows[:, 0] += offset
                c = coords.to(torch.int32)
                live = torch.unique(c[(c >= 0).all(-1)], dim=0).shape[0]
                kept[-1].append(dict(rows=rows, live=live,
                                     capacity=max_voxels,
                                     overflow=int(sc.num_overflow)))
            return sc
        return build_scatter

    def group_sums(*args):
        out = originals['group_sums'](*args)
        if forward[0]:
            sums[-1]['bn'].append(tuple(o.detach().clone() for o in out))
        return out

    def all_reduce(x, grp):
        out = originals['all_reduce'](x, grp)
        sums[-1]['masked'].append(out.detach().clone())
        return out
    played = None if replay is None else dict(
        bn=iter([x for r in replay for x in r['bn']]),
        masked=iter([x for r in replay for x in r['masked']]))

    def batch_stats(x):
        su, sq, cnt = next(played['bn'])
        return bn._stats(su, sq, cnt)

    def masked_sums(flat, mask=None):
        out = originals['masked_sums'](flat, mask)
        c = out[1].shape[0]
        rec = next(played['masked'])
        got = (rec[0], rec[1:1 + c], rec[1 + c:])
        return tuple(o + (r - o).detach() for o, r in zip(out, got))
    apply_train = det.apply_train

    def apply(b):
        forward[0] = True
        kept.append([])
        sums.append(dict(bn=[], masked=[]))
        try:
            return apply_train(b)
        finally:
            forward[0] = False
    det.apply_train = apply
    state = det.init_train(optimizer=opt)
    if start is not None:
        det.trunk.load_state_dict(start['trunk'], strict=True)
        dev = det.device
        state = state._replace(step=start['step'], opt_state=OptState(
            start['count'], {k: v.to(dev) for k, v in start['mu'].items()},
            {k: v.to(dev) for k, v in start['nu'].items()}))
    for u in users:
        u.build_scatter = wrap(u.build_scatter)
    if group is not None:
        bn._group_sums = group_sums
        voxel_encoders.all_reduce_with_grad = all_reduce
    if replay is not None:
        bn.batch_stats = batch_stats
        voxel_encoders.masked_sums = masked_sums
    pvrcnn.assign_and_sample = assign_and_sample
    metrics, stats, states = [], [], []
    try:
        torch.cuda.synchronize()
        _cuda.reset_launches()
        for _ in range(steps):
            state, m = det.train_step(batch, state)
            metrics.append({k: float(v) for k, v in m.items()})
            stats.append({k: v.cpu().clone() for k, v in
                          det.trunk.named_buffers() if 'running_' in k})
            opt_state = state.opt_state
            states.append(dict(
                trunk={k: v.cpu().clone()
                       for k, v in det.trunk.state_dict().items()},
                step=state.step, count=opt_state.count,
                mu={k: v.cpu().clone() for k, v in opt_state.mu.items()},
                nu={k: v.cpu().clone() for k, v in opt_state.nu.items()}))
        torch.cuda.synchronize()
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    finally:
        for u, f in zip(users, originals['scatters']):
            u.build_scatter = f
        bn._group_sums = originals['group_sums']
        bn.batch_stats = originals['batch_stats']
        voxel_encoders.all_reduce_with_grad = originals['all_reduce']
        voxel_encoders.masked_sums = originals['masked_sums']
        pvrcnn.assign_and_sample = originals['sample']
        del det.apply_train
    if replay is not None:
        check(next(played['bn'], None) is None
              and next(played['masked'], None) is None,
              '(wf) replayed BatchNorm sums left over')
    return dict(metrics=metrics, grads=grads, stats=stats, kept=kept,
                launches=launches, states=states,
                sums=[dict({k: [tuple(t.cpu() for t in x)
                                if isinstance(x, tuple) else x.cpu()
                                for x in v] for k, v in s.items()},
                           samples=samples[i] if i < len(samples) else None)
                      for i, s in enumerate(sums)])


def wf_joined_sums(a, b):
    """The ranks' recorded sums of each step (the same on both) with
    their PV-RCNN samples concatenated on the batch axis (rank order)."""
    out = []
    for sa, sb in zip(a['sums'], b['sums']):
        joined = dict(sa)
        if sa['samples'] is not None:
            joined['samples'] = tuple(torch.cat([x, y]) for x, y in
                                      zip(sa['samples'], sb['samples']))
        out.append(joined)
    return out


def _sums_to(sums, dev):
    return [dict({k: [tuple(t.to(dev) for t in x) if isinstance(x, tuple)
                      else x.to(dev) for x in s[k]]
                  for k in ('bn', 'masked')}, samples=s.get('samples'))
            for s in sums]


def wf_rank(rank, world, store, repo, tmp):
    """One rank of (wf): gloo on the card, each family's detector from
    seed 0 under the group, this rank's rows of its global batch, 2 steps;
    saves :func:`wf_steps`' results by family."""
    import datetime
    import traceback
    out = os.path.join(tmp, f'rank{rank}.pt')
    try:
        sys.path.insert(0, repo)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import torch.distributed as dist
        from mmdet3d_gaussian_tpu_torch.parallel.mesh import (
            init_distributed, shard_batch)
        group = init_distributed(
            backend='gloo', init_method='file://' + store, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=WF_TIMEOUT_S))
        res = {}
        for name in WF_CASES:
            det = wf_detector(name, group)
            batch = shard_batch(torch.load(os.path.join(
                tmp, f'{name}_batch.pt'), weights_only=True), group)
            res[name] = wf_steps(det, batch, 2, group=group)
            del det
        torch.save(dict(res, rank=rank, world=group.world), out)
        dist.destroy_process_group()
    except BaseException:
        with open(out + '.err', 'w') as f:
            f.write(traceback.format_exc())
        raise


def spawn_ranks(target, repo, tmp, world, timeout_s, tag, extra=()):
    """Start ``target(rank, world, store, repo, tmp, *extra)`` on ``world``
    spawned processes and join them within ``timeout_s`` (killed past
    it); fails the phase on a rank's error.  -> each rank's
    ``rank{r}.pt``."""
    import multiprocessing
    ctx = multiprocessing.get_context('spawn')
    store = os.path.join(tmp, 'store')
    procs = [ctx.Process(target=target,
                         args=(r, world, store, repo, tmp) + tuple(extra))
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + timeout_s
    try:
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [proc for proc in procs if proc.is_alive()]
        for proc in alive:
            proc.kill()
            proc.join(10)
    outs = [os.path.join(tmp, f'rank{r}.pt') for r in range(world)]
    errors = [open(o + '.err').read() for o in outs
              if os.path.exists(o + '.err')]
    check(not alive and not errors
          and all(proc.exitcode == 0 for proc in procs),
          f'{tag} ranks: {len(alive)} killed past {timeout_s} s, exit '
          f'codes {[proc.exitcode for proc in procs]}:\n'
          + '\n'.join(e[-3000:] for e in errors))
    return [torch.load(o, weights_only=False) for o in outs]


def wf_rows(t):
    """(n, 4) coords -> their set as sorted unique rows."""
    return np.unique(t.numpy(), axis=0).reshape(-1, t.shape[1])


def wf_trash_tables(card):
    """K1, K2 and K7 on tables whose live rows end early and on tables
    with no live row (every point in the trash), as a rank that keeps
    fewer voxels than the capacity, or none, hands them: each equal to
    its plain version."""
    from mmdet3d_gaussian_tpu_torch.ops import segment, voxelize
    from mmdet3d_gaussian_tpu_torch.ops.scatter import build_scatter
    gen = torch.Generator(device='cuda').manual_seed(0)
    n, c, cap = 4096, 16, 3000
    coords = torch.randint(0, 40, (n, 4), generator=gen, device='cuda',
                           dtype=torch.int32)
    coords[:, 0] = coords[:, 0] % 2
    coords[:, 3] = 0
    worst = 0.0
    for what, cc in (('live rows end early', coords),
                     ('no live row', torch.full_like(coords, -1))):
        sc = build_scatter(cc, (2, 40, 40, 1), cap,
                           key_order=voxelize.CANVAS_KEY_ORDER)
        rows = torch.randn((n, c), generator=gen, device='cuda')
        sv = rows[sc.sort_order].contiguous()
        ids, starts, counts = sc.sorted_ids, sc.sorted_starts, sc.voxel_counts
        # (kernel, plain, tolerance): the sums in another order, as (p)
        # holds the voxel mean and (b) the mapback; the max, the winner
        # and the splats exactly
        pairs = [
            (segment.segment_reduce(sv, starts, counts, 'sum'),
             segment.segment_reduce_plain(sv, starts, counts, 'sum'), 1e-5),
            (segment.segment_reduce(sv, starts, counts, 'max'),
             segment.segment_reduce_plain(sv, starts, counts, 'max'), 0.0),
            (segment.segment_reduce_mapback(sv, ids, starts, counts, 'sum'),
             segment.segment_reduce_mapback_plain(sv, ids, starts, counts,
                                                  'sum'), 1e-4),
        ]
        got_w = segment.segment_max_winner(sv, ids, starts, counts)
        want_w = segment.segment_max_winner_plain(sv, ids, starts, counts)
        pairs.append((got_w[0], want_w[0], 0.0))
        check(torch.equal(got_w[1], want_w[1]),
              f'(wf) K1 winner mask differs from plain ({what})')
        feats = torch.randn((cap, c), generator=gen, device='cuda')
        vc = sc.voxel_coords
        canvas = voxelize.bev_scatter(feats, vc, 2, 40, 40)
        b, ix, iy = vc[:, 0], vc[:, 1], vc[:, 2]
        lin = torch.where(b >= 0, (b * 40 + iy) * 40 + ix, 2 * 1600)
        pairs.append((canvas.reshape(-1, c),
                      voxelize.bev_splat_plain(feats, lin.to(torch.int32),
                                               2 * 1600), 0.0))
        par = torch.zeros_like(lin, dtype=torch.int32)
        lin2 = torch.where(b >= 0, lin, 2 * 1600).to(torch.int32)
        pairs.append((voxelize.bev_splat_pairs(feats, lin2, par, 2 * 1600),
                      voxelize.bev_splat_pairs_plain(feats, lin2, par,
                                                     2 * 1600), 0.0))
        errs = [float((g - w).abs().max()) if g.numel() else 0.0
                for g, w, _ in pairs]
        worst = max([worst] + errs)
        print(f'(wf) K1 (sum, max, mapback, winner), K2 and K7 on a table '
              f'of capacity {cap} with {int(sc.num_voxels)} live rows '
              f'({what}): differences from the plain versions '
              f'{[float(f"{e:.3g}") for e in errs]} (tolerances '
              f'{[t for _, _, t in pairs]}) [{card}]')
        check(all(e <= t for e, (_, _, t) in zip(errs, pairs)),
              f'(wf) a kernel differs from its plain version on a table '
              f'where {what}')
    return worst


def wf_families(repo, card):
    """Phase (wf): the four families' 2-rank steps against one rank.
    -> (summary, launches by family)."""
    import tempfile
    t0 = time.perf_counter()
    trash_err = wf_trash_tables(card)
    summary, launches, one = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix='chip_smoke_wf_') as tmp:
        for name in WF_CASES:
            det = wf_detector(name) if name == 'pvrcnn' else None
            torch.save(wf_batch(name, det), os.path.join(
                tmp, f'{name}_batch.pt'))
            del det
        t1 = time.perf_counter()
        ranks = spawn_ranks(wf_rank, repo, tmp, 2, WF_TIMEOUT_S, '(wf)')
        spawn_s = time.perf_counter() - t1
        for name in WF_CASES:
            batch = torch.load(os.path.join(tmp, f'{name}_batch.pt'),
                               weights_only=True)
            a, b = ranks[0][name], ranks[1][name]
            start = a['states'][0]
            plain = [wf_steps(wf_detector(name), batch, 1),
                     wf_steps(wf_detector(name), batch, 1, start=start)]
            joined = _sums_to(wf_joined_sums(a, b), 'cuda')
            replayed = [
                wf_steps(wf_detector(name), batch, 1, replay=joined[:1]),
                wf_steps(wf_detector(name), batch, 1, start=start,
                         replay=joined[1:2])]
            one[name] = dict(plain=plain, replayed=replayed)
            summary[name] = wf_compare(name, a, b, plain, replayed, card)
            launches[name] = dict(two_ranks=a['launches'],
                                  one_rank=plain[0]['launches'])
    summary['trash_tables_max_abs_err'] = trash_err
    summary['spawn_s'] = spawn_s
    summary['phase_s'] = time.perf_counter() - t0
    print(f'(wf) wall {summary["phase_s"]:.1f} s (the two-rank run '
          f'{spawn_s:.1f} s; limit {WF_LIMIT_S:.0f} s) [{card}]')
    check(all(s['agree'] for k, s in summary.items() if k in WF_CASES),
          '(wf) two ranks disagree with one rank beyond the tolerances')
    check(summary['phase_s'] <= WF_LIMIT_S,
          f'(wf) took {summary["phase_s"]:.1f} s')
    return summary, launches


def wf_compare(name, a, b, plain, replayed, card):
    """One family's checks of (wf); prints them.  -> summary."""
    for k in a['states'][-1]['trunk']:
        check(torch.equal(a['states'][-1]['trunk'][k],
                          b['states'][-1]['trunk'][k]),
              f'(wf) {name}: the ranks\' state differs after the steps: {k}')
    check(a['metrics'] == b['metrics'], f'(wf) {name}: rank metrics differ')
    differs = []
    for s in range(2):
        want = plain[s]['kept'][0]
        got = [a['kept'][s], b['kept'][s]]
        check(len(got[0]) == len(got[1]) == len(want),
              f'(wf) {name}: {len(want)} voxelizations on one rank, '
              f'{len(got[0])} and {len(got[1])} on two')
        for i, w in enumerate(want):
            union = wf_rows(torch.cat([g[i]['rows'] for g in got]))
            check(np.array_equal(union, wf_rows(w['rows'])),
                  f'(wf) {name} step {s + 1}: voxelization {i} keeps '
                  f'another set on two ranks than on one')
            check(all(g[i]['overflow'] == w['overflow'] for g in got),
                  f'(wf) {name}: the overflow of voxelization {i} is not '
                  f'the global one')
            per_rank = [min(g[i]['live'], w['capacity'] // 2) for g in got]
            if per_rank != [len(g[i]['rows']) for g in got]:
                differs.append(i)
    kept_counts = [[len(g['rows']) for g in a['kept'][0]],
                   [len(g['rows']) for g in b['kept'][0]]]
    check(bool(differs), f'(wf) {name}: the batch does not overflow its '
          f'capacity unevenly (a per-rank capacity keeps the same set)')
    worst = {}
    for s in range(2):
        w_metrics = {k: v for k, v in plain[s]['metrics'][0].items()
                     if k != 'grad_norm'}
        worst[f'step{s + 1}'] = dict(
            loss=worst_of(a['metrics'][s], w_metrics,
                          lambda g, w: abs(g - w) / max(abs(w), 1e-30)),
            grad=worst_of(a['grads'][s], replayed[s]['grads'][0], rel_max),
            stat=worst_of(a['stats'][s], plain[s]['stats'][0], rel_max))
    for step, w in worst.items():
        print(f'(wf) {name} {step}, two gloo ranks on one card at global B '
              f'= 4 (2 + 2) against one rank on the 4 samples from the same '
              f'state: loss terms within {w["loss"][0]:.3g} ({w["loss"][1]}; '
              f'tol {WD_LOSS_RTOL}), gradients (one rank replaying the '
              f'ranks\' forward BatchNorm sums) within {w["grad"][0]:.3g} of '
              f'the leaf\'s largest ({w["grad"][1]}; tol {WD_GRAD_TOL}), '
              f'running statistics {w["stat"][0]:.3g} ({w["stat"][1]}; tol '
              f'{WD_STAT_TOL}) [{card}]')
    if a['sums'][0]['samples'] is not None:
        joined = wf_joined_sums(a, b)
        same = [all(torch.equal(x, y) for x, y, f in zip(
            joined[s]['samples'], plain[s]['sums'][0]['samples'],
            range(6)) if f in (1, 4, 5)) for s in range(2)]
        print(f'(wf) {name}: the RoI samples (labels, positives, valid) of '
              f'one rank on its own equal the ranks\' in steps 1, 2: '
              f'{same}; the gradient runs replay the ranks\' [{card}]')
    got = a['launches']
    missing = [k for k in WF_KERNELS[name] if not got.get(k)]
    print(f'(wf) {name}: kept voxels and sites a rank per voxelization '
          f'{kept_counts[0]} and {kept_counts[1]}, the one-rank sets over '
          f'both ranks; launches of the 2 steps on rank 0 {got} (K4\'s '
          f'moments all-reduced), on one rank {plain[0]["launches"]} '
          f'(step 1) [{card}]')
    check(not missing, f'(wf) {name}: rank 0 launched no {missing}')
    agree = all(w['loss'][0] <= WD_LOSS_RTOL and w['grad'][0] <= WD_GRAD_TOL
                and w['stat'][0] <= WD_STAT_TOL for w in worst.values())
    return dict({f'{step}_{k}': v[0] for step, w in worst.items()
                 for k, v in w.items()}, kept=kept_counts,
                per_rank_capacity_keeps_another_set=sorted(set(differs)),
                launches=got, agree=agree)


# (ps): point-axis sharding (ShardedPointPillarsDetector, the JAX
# package's north-star scale axis).  The KITTI 3-class model at full
# width on the dense-canvas pillar encoder (no K1, K2 or K7: the canvas is
# the pillar table, a mean by index_add_), f32; the (data, points) grids
# split each sample's points over the ranks of a points group
PS_LIMIT_S = 90.0
PS_TIMEOUT_S = 240
PS_SEED = 0
# tests/test_sharded_model.py's TINY widths and head
TINY_SHARDED = dict(
    voxel_size=(0.4, 0.4, 4.0),
    point_cloud_range=(0., -12.8, -3., 25.6, 12.8, 1.),
    encoder_cfg=dict(feat_channels=(16,)),
    backbone_cfg=dict(in_channels=16, out_channels=(16, 32),
                      layer_nums=(1, 1), layer_strides=(2, 2)),
    neck_cfg=dict(in_channels=(16, 32), out_channels=(16, 16),
                  upsample_strides=(1, 2)),
    head_cfg=dict(num_classes=3, num_anchors=6, feat_channels=32))
TINY_SHARDED_HEAD = dict(
    anchor_generator=dict(
        ranges=[[0.2, -12.6, -1.0, 25.4, 12.6, -1.0]] * 3,
        sizes=[[0.8, 0.6, 1.7], [1.8, 0.6, 1.7], [3.9, 1.6, 1.6]],
        rotations=[0.0, 1.57]),
    test_cfg=dict(use_rotate_nms=True, nms_thr=0.5, score_thr=0.05,
                  nms_pre=64, max_num=16))
NO_SPLAT = {'bev_splat': 0, 'bev_splat_pairs': 0, **NO_K1}
PS_PREDICT_LAUNCHES = {'rotated_iou': 1, 'nms_sweep': 1, **NO_SPLAT}
PS_TRAIN_LAUNCHES = {'bn_moments': 19, 'bn_grad_moments': 19, **NO_SPLAT}
PS_DENSE_LAUNCHES = {**PS_TRAIN_LAUNCHES, **DENSE_LAUNCHES}
# the kernels of the grid's dense-target steps, on every rank
PS_GRID_KERNELS = ('bn_moments', 'bn_grad_moments', 'gd_loss_fwd',
                   'gd_loss_bwd')
PS_MERGES = ('dense', 'sparse')
PS_MERGE_ITERS = 5


def ps_detector(merge=None, mesh=None, head=None, tiny=False, dev='cuda',
                seed=PS_SEED):
    """The point-sharded detector from ``seed`` with a zero cls bias: full
    width (``tiny``: the TINY widths), one process (``merge`` None) or
    ``merge`` over ``mesh``; ``head`` overrides of the KITTI head."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import \
        ShardedPointPillarsDetector
    model = TINY_SHARDED if tiny else None
    head = dict(TINY_SHARDED_HEAD if tiny else {}, **(head or {}))
    if merge is None:
        det = ShardedPointPillarsDetector(model, head, point_axis=None,
                                          device=dev, seed=seed)
    else:
        det = ShardedPointPillarsDetector(model, head, merge=merge,
                                          mesh=mesh, device=dev, seed=seed)
    with torch.no_grad():
        det.trunk.bbox_head.conv_cls.bias.zero_()
    return det


def ps_geo():
    """The KITTI canvas of the point-sharded model: (range, pillar size,
    nx, ny)."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import KITTI_3CLASS_MODEL
    pcr, vs = (KITTI_3CLASS_MODEL[k] for k in ('point_cloud_range',
                                               'voxel_size'))
    return (pcr, vs, round((pcr[3] - pcr[0]) / vs[0]),
            round((pcr[4] - pcr[1]) / vs[1]))


def ps_batch(dev='cuda', seed=PS_SEED):
    from mmdet3d_gaussian_tpu_torch.engine.detector import synthetic_batch
    return synthetic_batch(BATCH, POINTS, 16, seed=seed, device=dev)


def ps_tiny(card):
    """(ps) TINY: the TINY sharded detector, ``point_axis=None``, card
    against CPU: one predict and one dense-target step."""
    def detector(cfg, head, device, seed):
        return ps_detector(head=head, tiny=True, dev=device, seed=seed)
    tiny_card_vs_cpu(card, cfg=None, tag='TINY sharded', detector=detector,
                     head=None)
    tiny_train_card_vs_cpu(card, cfg=None, head=dict(pos_cap=0),
                           tag='TINY sharded dense', detector=detector)


def ps_canvas_sums(det, batch):
    """The dense-canvas sums of ``batch`` (``canvas_sums`` on the
    encoder's point features, inference) and their bytes: -> (fn, bytes
    read and written)."""
    from mmdet3d_gaussian_tpu_torch.parallel.point_sharding import \
        canvas_sums
    enc, (nx, ny) = det.trunk.voxel_encoder, det.trunk.grid()
    with torch.inference_mode():
        x, lin, valid = enc.point_features(batch['points'],
                                           batch['points_mask'], nx, ny)
    b, n, c = x.shape
    nbytes = b * n * (c * 4 + 8 + 1) + b * ny * nx * (c + 1) * 4
    return (lambda: canvas_sums(x, lin, valid, nx, ny)), nbytes


def ps_one_card(card):
    """(ps) at full width, one process: 6 predicts, 10 warm sparse-target
    steps and 3 dense-target steps with launch counts, K3, K4, K5 and K6
    on this path's inputs against their plain versions, profiles, and the
    dense-canvas mean (``index_add_``) timed alone.  -> (kernel numbers,
    launches by path, summary)."""
    det = ps_detector()
    batches = [ps_batch(seed=s) for s in SEEDS]
    nx, ny = det.trunk.grid()
    print(f'(ps) ShardedPointPillarsDetector(): dense-canvas encoder on '
          f'{nx} x {ny} cells, SECOND (64, 128, 256) x (3, 5, 5), '
          f'SECONDFPN (128, 128, 128) concatenated, head 384 channels, '
          f'f32; B = {BATCH} x {POINTS} points, point_axis=None')
    with torch.inference_mode():
        inputs = capture_inputs(det, batches[0], PS_PREDICT_LAUNCHES)
        results = kernel_checks(inputs, card, ' (sharded predict)')
    del inputs
    launches, summary = {}, {}
    launches['predict'], summary['predict'] = main_path(
        det, batches, PS_PREDICT_LAUNCHES, '(ps)', card)
    summary['predict'].update(device_profile(
        lambda: det.predict(batches[0]), 'predict', '(ps)', card, 5))
    fn, nbytes = ps_canvas_sums(det, batches[0])
    mean_ms = device_ms(fn, 20)
    summary['canvas_mean'] = dict(ms=mean_ms, bytes=nbytes,
                                  bound_ms=bound(nbytes, 0)[0])
    print(f'(ps) the dense-canvas sums alone (index_add_ of {BATCH} x '
          f'{POINTS} rows of 65 lanes into {BATCH} x {ny * nx} cells, '
          f'zero fill included): {mean_ms:.4f} ms device, bound '
          f'{summary["canvas_mean"]["bound_ms"]:.4f} ms ({nbytes} bytes) '
          f'[{card}]')
    del det
    torch.cuda.empty_cache()

    tdet, ddet = ps_detector(), ps_detector(head=dict(pos_cap=0))
    batch = batches[0]
    tstate = tdet.init_train(LR, total_steps=100)
    dstate = ddet.init_train(LR, total_steps=100)
    dstate, _ = ddet.train_step(batch, dstate)          # warm-up
    train_inputs, dstate = capture_train_inputs(ddet, batch, dstate,
                                                PS_DENSE_LAUNCHES)
    with torch.no_grad():
        results.update(train_kernel_checks(train_inputs, card,
                                           ' (sharded dense step)'))
    del train_inputs
    launches['train'], tstate, summary['train'] = timed_steps(
        tdet, batch, tstate, PS_TRAIN_LAUNCHES, '(ps)', card)
    launches['train_dense'], dstate, summary['train']['dense_step_ms'] = \
        dense_steps(ddet, batch, dstate, PS_DENSE_LAUNCHES, '(ps)', card)
    holder = [tstate]

    def one_step():
        holder[0] = tdet.train_step(batch, holder[0])[0]
    summary['train'].update(device_profile(one_step, 'train step', '(ps)',
                                           card, 3))
    del tdet, ddet, holder, tstate, dstate, batches
    torch.cuda.empty_cache()
    return results, launches, summary


def ps_rank(rank, world, store, repo, tmp, backend, grids, timed=False):
    """One rank of the (ps) grid (gloo, two ranks on the card) or of
    ``--only dp4``'s (NCCL, one rank a card): on each (data, points) grid
    of ``grids`` and each merge, the full-width dense-target detector on
    its part of the global batch (``mesh.shard_points``): 2 steps
    (:func:`wf_steps`; each step's merged canvas kept by the first rank
    of each points group), then (``timed``) DP4_TIMED timed steps; the
    merge
    alone on the step's point features, timed; the pillar reduces of
    sample 0's raw points (sum with a count channel, max, mean) over its
    points group.  Saves the results by (grid, merge)."""
    import datetime
    import traceback
    out = os.path.join(tmp, f'rank{rank}.pt')
    try:
        if backend == 'nccl':
            os.environ['LOCAL_RANK'] = str(rank)
        sys.path.insert(0, repo)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import torch.distributed as dist
        from mmdet3d_gaussian_tpu_torch.parallel import mesh as tmesh
        from mmdet3d_gaussian_tpu_torch.parallel import point_sharding as ps
        world_group = tmesh.init_distributed(
            backend=backend, init_method='file://' + store, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PS_TIMEOUT_S))
        full = torch.load(os.path.join(tmp, 'batch.pt'), weights_only=True)
        res = dict(rank=rank, device=str(world_group.device))
        for grid in grids:
            mesh = tmesh.init_mesh(*grid, world_group)
            batch = {k: v.to(world_group.device) for k, v in
                     tmesh.shard_points(full, mesh).items()}
            for merge in PS_MERGES:
                det = ps_detector(merge, mesh, dict(pos_cap=0))
                canvases = []
                hook = det.trunk.voxel_encoder.register_forward_hook(
                    lambda m, i, o: canvases.append(o.detach().cpu()))
                r = wf_steps(det, batch, 2, group=mesh.data)
                hook.remove()
                # the merged canvas, the same on every rank of a points
                # group: kept by its first rank
                r['canvas'] = canvases if mesh.points.rank == 0 else None
                r['mesh'] = (mesh.data.rank, mesh.points.rank)
                if timed:
                    r['step_ms'] = dp4_timed(det, batch, det.init_train())[0]
                r['merge_ms'] = ps_merge_ms(det, batch, mesh)
                del det
                torch.cuda.empty_cache()
                res[grid, merge] = r
            pts = batch['points'][0]
            pts = torch.cat([pts, torch.ones_like(pts[:, :1])], -1)
            mask = batch['points_mask'][0]
            geo = ps_geo()
            res[grid, 'reduce'] = {
                (merge, op): fn(pts, mask, *geo, mesh.points, op).cpu()
                for merge, fn in (('dense', ps.sharded_pillar_reduce),
                                  ('sparse',
                                   ps.sharded_pillar_reduce_sparse))
                for op in ('sum', 'max', 'mean')}
        torch.save(res, out)
        dist.destroy_process_group()
    except BaseException:
        with open(out + '.err', 'w') as f:
            f.write(traceback.format_exc())
        raise


def ps_merge_ms(det, batch, mesh):
    """The encoder's merge alone on this rank's point features of
    ``batch``, PS_MERGE_ITERS times after a warm-up, every rank in step:
    -> (median ms, bytes this rank sends a merge).  Dense: the canvas sums
    (``index_add_``) and their all-reduce; sparse: the splat, compaction,
    ``all_to_all`` and gather.  CUDA events on the current stream around
    each merge (which waits for the collectives; gloo stages CUDA tensors
    through the host)."""
    from mmdet3d_gaussian_tpu_torch.parallel import mesh as tmesh
    from mmdet3d_gaussian_tpu_torch.parallel.point_sharding import (
        canvas_sums, default_capacity, sharded_feature_splat_sparse)
    enc, (nx, ny) = det.trunk.voxel_encoder, det.trunk.grid()
    with torch.inference_mode():
        x, lin, valid = enc.point_features(batch['points'],
                                           batch['points_mask'], nx, ny)
        b, _, c = x.shape
        p = mesh.points.world
        if enc.merge == 'dense':
            def run():
                return tmesh.all_reduce_replicated(
                    canvas_sums(x, lin, valid, nx, ny), mesh.points)
            nbytes = b * ny * nx * (c + 1) * 4
        else:
            def run():
                return sharded_feature_splat_sparse(x, lin, valid, nx, ny,
                                                    mesh.points)
            cap = default_capacity(ny // p * nx, None)
            nbytes = b * (p * cap * (c + 2) * 4 + ny * nx * (c + 1) * 4 // p)
        times = []
        for i in range(PS_MERGE_ITERS + 1):
            tmesh.barrier(mesh.world)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            if i:
                times.append(start.elapsed_time(end))
    return statistics.median(times), nbytes


def ps_reduce_checks(tag, rank_reduce, batch, card):
    """The ranks' pillar reduces of sample 0 (a count channel appended)
    against ``reference_pillar_reduce`` of all its points on the card:
    the count lane and the max exactly, the sums within 1e-6 of the
    cell's sum of magnitudes (``index_add_``'s atomics add in any order),
    the mean following.  -> the worst sum difference."""
    from mmdet3d_gaussian_tpu_torch.parallel.point_sharding import \
        reference_pillar_reduce
    pts = batch['points'][0].cuda()
    pts = torch.cat([pts, torch.ones_like(pts[:, :1])], -1)
    mask = batch['points_mask'][0].cuda()
    geo = ps_geo()
    want = {op: reference_pillar_reduce(pts, mask, *geo, op).cpu()
            for op in ('sum', 'max', 'mean')}
    c = pts.shape[1]      # the sums of magnitudes in the points' own cells
    mags = reference_pillar_reduce(torch.cat([pts, pts.abs()], -1), mask,
                                   *geo, 'sum')[..., c:].cpu()
    worst = 0.0
    for (merge, op), got in rank_reduce.items():
        w = want[op]
        if op == 'max':
            check(torch.equal(got, w), f'{tag} {merge} max merge differs')
            continue
        check(torch.equal(got[..., -1], w[..., -1]),
              f'{tag} {merge} {op}: the count lane differs')
        if op == 'sum':
            err = float(((got - w).abs() / mags.clamp(min=1e-30)).max())
            worst = max(worst, err)
            check(err <= 1e-6, f'{tag} {merge} sums differ ({err:.3g})')
        else:
            check(bool(torch.allclose(got, w, rtol=1e-6, atol=1e-6)),
                  f'{tag} {merge} means differ')
    print(f'{tag} the pillar reduces of sample 0 ({POINTS} points, a count '
          f'channel appended) merged over the points group, dense and '
          f'sparse, against one rank on all its points: max and count '
          f'equal, sums within {worst:.3g} of the cell\'s sum of magnitudes '
          f'(tol 1e-6), means within 1e-6 [{card}]')
    return worst


def ps_replayed_steps(batch, sums, canvases, start=None):
    """One one-rank dense-target step (:func:`wf_steps`) whose forward
    BatchNorm sums and merged canvas are the grid's (``canvases``: the
    step's canvas of each data rank, in order), each keeping the
    gradient of the one rank's own: ``own + (grid - own).detach()``."""
    det = ps_detector(head=dict(pos_cap=0))
    canvas = torch.cat(canvases).cuda()
    hook = det.trunk.voxel_encoder.register_forward_hook(
        lambda m, i, o: o + (canvas - o).detach())
    try:
        return wf_steps(det, batch, 1, start=start,
                        replay=_sums_to(sums, 'cuda'))
    finally:
        hook.remove()


def ps_grid_compare(tag, ranks, batch, grid, card, timed=False):
    """One grid's ranks against one rank on the whole batch, for each
    merge: loss terms, gradients (the one rank replaying the grid's
    forward BatchNorm sums and merged canvas: the canvas's other f32
    order, of ``index_add_``'s atomics, otherwise moves activations at a
    ReLU's kink to their other side), running statistics, every rank's
    parameters bitwise equal; the merges' bytes and times.
    -> summary."""
    a = ranks[0]
    check(all(r[grid, PS_MERGES[0]]['mesh'] == divmod(i, grid[1])
              for i, r in enumerate(ranks)),
          f'{tag} ranks are not d P + p on the {grid} grid')
    out = {}
    one = None
    for merge in PS_MERGES:
        ra = a[grid, merge]
        for r in ranks[1:]:
            rb = r[grid, merge]
            for k in ra['states'][-1]['trunk']:
                check(torch.equal(ra['states'][-1]['trunk'][k],
                                  rb['states'][-1]['trunk'][k]),
                      f'{tag} {grid} {merge}: rank {r["rank"]}\'s state '
                      f'differs from rank 0\'s: {k}')
            check(ra['metrics'] == rb['metrics'],
                  f'{tag} {grid} {merge}: rank metrics differ')
        start = ra['states'][0]
        if one is None:
            one = [wf_steps(ps_detector(head=dict(pos_cap=0)), batch, 1)]
        plain = [one[0], wf_steps(ps_detector(head=dict(pos_cap=0)), batch,
                                  1, start=start)]
        firsts = [r[grid, merge] for r in ranks[::grid[1]]]
        replayed = [ps_replayed_steps(batch, ra['sums'][s:s + 1],
                                      [f['canvas'][s] for f in firsts],
                                      start if s else None)
                    for s in range(2)]
        torch.cuda.empty_cache()
        worst = {}
        for s in range(2):
            w_metrics = {k: v for k, v in plain[s]['metrics'][0].items()
                         if k != 'grad_norm'}
            worst[f'step{s + 1}'] = dict(
                loss=worst_of(ra['metrics'][s], w_metrics,
                              lambda g, w: abs(g - w) / max(abs(w), 1e-30)),
                grad=worst_of(ra['grads'][s], replayed[s]['grads'][0],
                              rel_max),
                stat=worst_of(ra['stats'][s], plain[s]['stats'][0],
                              rel_max))
        for step, w in worst.items():
            print(f'{tag} {merge} merge, {grid[0]} x {grid[1]} grid '
                  f'({len(ranks)} ranks), {step}, dense targets, against '
                  f'one rank on the whole batch from the same state: loss '
                  f'terms within {w["loss"][0]:.3g} ({w["loss"][1]}; tol '
                  f'{WD_LOSS_RTOL}), gradients (one rank replaying the '
                  f'ranks\' forward BatchNorm sums and merged canvas) '
                  f'within {w["grad"][0]:.3g} of the leaf\'s largest '
                  f'({w["grad"][1]}; tol {WD_GRAD_TOL}), running statistics '
                  f'{w["stat"][0]:.3g} ({w["stat"][1]}; tol {WD_STAT_TOL}) '
                  f'[{card}]')
        merge_ms = [r[grid, merge]['merge_ms'][0] for r in ranks]
        nbytes = ra['merge_ms'][1]
        got = ra['launches']
        missing = [k for k in PS_GRID_KERNELS if not got.get(k)]
        extra = [k for k in ('segment_reduce', 'segment_reduce_mapback',
                             'segment_max_winner', 'bev_splat',
                             'bev_splat_pairs') if got.get(k)]
        print(f'{tag} {merge} merge on the {grid} grid: {nbytes} bytes a '
              f'rank sends a step\'s forward merge (dense: the all-reduced '
              f'(B, ny nx, C + 1) f32 sums; sparse: P x capacity x (C + 2) '
              f'x 4 of the all_to_all and the rank\'s stripe to the '
              f'gather), the merge alone {max(merge_ms):.3f} ms (slowest '
              f'rank, ranks {[round(x, 3) for x in merge_ms]}; medians of '
              f'{PS_MERGE_ITERS}, CUDA events); launches of 2 '
              f'steps on rank 0 {got} [{card}]')
        check(not missing and not extra,
              f'{tag} {merge}: rank 0 launched no {missing}, or {extra}')
        agree = all(w['loss'][0] <= WD_LOSS_RTOL
                    and w['grad'][0] <= WD_GRAD_TOL
                    and w['stat'][0] <= WD_STAT_TOL for w in worst.values())
        check(agree, f'{tag} {grid} {merge}: the grid disagrees with one '
              f'rank beyond the tolerances')
        out[merge] = dict({f'{step}_{k}': v[0] for step, w in worst.items()
                           for k, v in w.items()},
                          merge_bytes=nbytes, merge_ms=merge_ms,
                          launches=got)
        if timed:
            out[merge]['step_ms'] = [r[grid, merge]['step_ms']
                                     for r in ranks]
    out['reduce_sum_rel'] = ps_reduce_checks(tag, a[grid, 'reduce'], batch,
                                             card)
    for r in ranks:     # the same on every rank of a points group
        mate = ranks[r[grid, PS_MERGES[0]]['mesh'][0] * grid[1]]
        for key, t in r[grid, 'reduce'].items():
            check(torch.equal(t, mate[grid, 'reduce'][key]),
                  f'{tag} the ranks\' merged reduces differ: {key}')
    return out


def ps_two_ranks(repo, card):
    """(ps) on the card: two gloo ranks as a 1 x 2 points grid against one
    rank on the whole batch.  -> summary."""
    import tempfile
    batch = ps_batch('cpu')
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_ps_') as tmp:
        torch.save(batch, os.path.join(tmp, 'batch.pt'))
        ranks = spawn_ranks(ps_rank, repo, tmp, 2, PS_TIMEOUT_S, '(ps)',
                            extra=('gloo', ((1, 2),)))
    spawn_s = time.perf_counter() - t0
    check(all(r['device'].startswith('cuda') for r in ranks),
          f'(ps) ranks ran on {[r["device"] for r in ranks]}')
    out = ps_grid_compare('(ps)', ranks, batch, (1, 2), card)
    out['spawn_s'] = spawn_s
    return out


def ps_phase(repo, card):
    """Phase (ps): the TINY check, the full-width one-card path and the
    two-rank grid, within PS_LIMIT_S.  -> (kernel numbers, launches by
    path, summary)."""
    t0 = time.perf_counter()
    ps_tiny(card)
    results, launches, summary = ps_one_card(card)
    summary['grid_1x2'] = ps_two_ranks(repo, card)
    summary['phase_s'] = time.perf_counter() - t0
    print(f'(ps) wall {summary["phase_s"]:.1f} s (limit {PS_LIMIT_S:.0f} s) '
          f'[{card}]')
    check(summary['phase_s'] <= PS_LIMIT_S,
          f'(ps) took {summary["phase_s"]:.1f} s')
    return results, launches, summary


# --only dp4: the first NCCL job across cards.  One NCCL rank a card, the
# global batch split a sample a rank (4 cards); the Waymo PointPillars
# step (hard, 4 x 180,000 points) and the CenterPoint gwd5 step (dynamic,
# s2d canvas, 4 x 60,000 points) at full width against one rank on the
# whole batch, step by step from the same state; the step and its
# BatchNorm all-reduces timed beside one card's step
DP4_TIMEOUT_S = 600
DP4_TIMED = 3
DP4_LOSS_RTOL = 1e-5


def dp4_detector(which, repo, group=None):
    from mmdet3d_gaussian_tpu_torch.engine.detector import CenterPointDetector
    if which == 'waymo':
        return waymo_detector(waymo_config(repo), group=group)
    model, head = cp_configs(repo)[0]
    return CenterPointDetector(model, dict(head, code_weights=CP_CODE_WEIGHTS),
                               device='cuda', seed=0, group=group)


def dp4_batch(which):
    """The global batch on the CPU."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import synthetic_nus_batch
    if which == 'waymo':
        return waymo_batch(WD_SEED, dev='cpu')
    return synthetic_nus_batch(CP_BATCH, CP_POINTS, CP_GT, seed=0,
                               device='cpu')


def dp4_timed(det, batch, state, group=None):
    """DP4_TIMED more steps timed whole, then under a group DP4_TIMED more
    with each BatchNorm all-reduce synchronized and timed: -> (median ms
    of a step, median ms of its BatchNorm all-reduces and their count a
    step), synchronized host clock."""
    from mmdet3d_gaussian_tpu_torch.ops import bn
    batch = {k: v.to(det.device) for k, v in batch.items()}
    original = bn._group_sums
    spent = [0.0, 0]

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = original(*args)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return res
    steps, reduces, calls = [], [], 0
    for _ in range(DP4_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = det.train_step(batch, state)[0]
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    if group is None:
        return sorted(steps)[DP4_TIMED // 2], 0.0, 0
    bn._group_sums = timed
    try:
        for _ in range(DP4_TIMED):
            spent[:] = [0.0, 0]
            state = det.train_step(batch, state)[0]
            reduces.append(spent[0] * 1e3)
            calls = spent[1]
    finally:
        bn._group_sums = original
    return (sorted(steps)[DP4_TIMED // 2], sorted(reduces)[DP4_TIMED // 2],
            calls)


def dp4_rank(rank, world, store, repo, tmp, which):
    """One NCCL rank of --only dp4 on card ``rank``: 2 checked steps on
    its rows, then DP4_TIMED timed ones."""
    import datetime
    import traceback
    out = os.path.join(tmp, f'rank{rank}.pt')
    try:
        os.environ['LOCAL_RANK'] = str(rank)
        sys.path.insert(0, repo)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        import torch.distributed as dist
        from mmdet3d_gaussian_tpu_torch.parallel.mesh import (
            init_distributed, shard_batch)
        group = init_distributed(
            backend='nccl', init_method='file://' + store, rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=DP4_TIMEOUT_S))
        det = dp4_detector(which, repo, group)
        batch = shard_batch(torch.load(os.path.join(tmp, 'batch.pt'),
                                       weights_only=True), group)
        res = wf_steps(det, batch, 2, group=group)
        state = det.init_train()
        res['step_ms'], res['all_reduce_ms'], res['all_reduce_calls'] = \
            dp4_timed(det, batch, state, group)
        res.update(rank=rank, world=group.world,
                   device=str(next(det.trunk.parameters()).device))
        res['kept'] = None
        torch.save(res, out)
        dist.destroy_process_group()
    except BaseException:
        with open(out + '.err', 'w') as f:
            f.write(traceback.format_exc())
        raise


def dp4_phase(repo, card):
    """--only dp4: the Waymo and CenterPoint steps on one NCCL rank a card
    against one rank on the whole batch.  -> summary."""
    import tempfile
    world = torch.cuda.device_count()
    if world < 2:
        raise RuntimeError(f'--only dp4 needs at least 2 CUDA devices, '
                           f'{world} visible')
    summary = dict(cards=world)
    for which, calls in (('waymo', 38), ('centerpoint', 124)):
        t0 = time.perf_counter()
        batch = dp4_batch(which)
        check(batch['points'].shape[0] % world == 0,
              f'(dp4) a batch of {batch["points"].shape[0]} over {world} '
              f'cards')
        det = dp4_detector(which, repo)
        first = wf_steps(det, batch, 1)
        del det
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix='chip_smoke_dp4_') as tmp:
            torch.save(batch, os.path.join(tmp, 'batch.pt'))
            t1 = time.perf_counter()
            ranks = spawn_ranks(dp4_rank, repo, tmp, world, DP4_TIMEOUT_S,
                                '(dp4)', extra=(which,))
            spawn_s = time.perf_counter() - t1
        a = ranks[0]
        start = a['states'][0]
        det = dp4_detector(which, repo)
        second = wf_steps(det, batch, 1, start=start)
        replayed = [
            wf_steps(dp4_detector(which, repo), batch, 1,
                     replay=_sums_to(a['sums'][:1], 'cuda')),
            wf_steps(dp4_detector(which, repo), batch, 1, start=start,
                     replay=_sums_to(a['sums'][1:], 'cuda'))]
        one_ms, _, _ = dp4_timed(det, batch, det.init_train())
        del det
        torch.cuda.empty_cache()
        check(sorted(r['device'] for r in ranks)
              == [f'cuda:{r}' for r in range(world)],
              f'(dp4) ranks ran on {[r["device"] for r in ranks]}')
        for r in ranks[1:]:
            for k in a['states'][-1]['trunk']:
                check(torch.equal(a['states'][-1]['trunk'][k],
                                  r['states'][-1]['trunk'][k]),
                      f'(dp4) {which}: rank {r["rank"]}\'s state differs '
                      f'from rank 0\'s: {k}')
        plain = [first, second]
        worst = {}
        for s in range(2):
            w_metrics = {k: v for k, v in plain[s]['metrics'][0].items()
                         if k != 'grad_norm'}
            worst[f'step{s + 1}'] = dict(
                loss=worst_of(a['metrics'][s], w_metrics,
                              lambda g, w: abs(g - w) / max(abs(w), 1e-30)),
                grad=worst_of(a['grads'][s], replayed[s]['grads'][0],
                              rel_max),
                stat=worst_of(a['stats'][s], plain[s]['stats'][0], rel_max))
        for step, w in worst.items():
            print(f'(dp4) {which} {step}, {world} NCCL ranks (one a card, '
                  f'{batch["points"].shape[0] // world} sample a rank) '
                  f'against one rank on the whole batch from the same '
                  f'state: loss terms within {w["loss"][0]:.3g} '
                  f'({w["loss"][1]}; tol {DP4_LOSS_RTOL}), gradients (one '
                  f'rank replaying the ranks\' forward BatchNorm sums) '
                  f'within {w["grad"][0]:.3g} of the leaf\'s largest '
                  f'({w["grad"][1]}; tol {WD_GRAD_TOL}), running statistics '
                  f'{w["stat"][0]:.3g} ({w["stat"][1]}; tol {WD_STAT_TOL}) '
                  f'[{card}]')
        step_ms = [r['step_ms'] for r in ranks]
        ar_ms = [r['all_reduce_ms'] for r in ranks]
        print(f'(dp4) {which}: a step on {world} cards {max(step_ms):.3f} ms '
              f'(slowest rank; ranks {[round(x, 3) for x in step_ms]}), its '
              f'{a["all_reduce_calls"]} BatchNorm all-reduces over NCCL '
              f'{max(ar_ms):.3f} ms (ranks {[round(x, 3) for x in ar_ms]}; '
              f'synchronized host clock, medians of {DP4_TIMED}); one card '
              f'on the whole batch {one_ms:.3f} ms; launches of 2 steps on '
              f'rank 0 {a["launches"]}; the {world}-rank run {spawn_s:.1f} '
              f's wall, the phase {time.perf_counter() - t0:.1f} s [{card}]')
        check(a['all_reduce_calls'] == calls,
              f'(dp4) {which}: {a["all_reduce_calls"]} all-reduces a step, '
              f'want {calls}')
        check(all(w['loss'][0] <= DP4_LOSS_RTOL
                  and w['grad'][0] <= WD_GRAD_TOL
                  and w['stat'][0] <= WD_STAT_TOL for w in worst.values()),
              f'(dp4) {which}: {world} ranks disagree with one rank beyond '
              f'the tolerances')
        summary[which] = dict(
            {f'{step}_{k}': v[0] for step, w in worst.items()
             for k, v in w.items()}, step_ms=step_ms, all_reduce_ms=ar_ms,
            all_reduce_calls=a['all_reduce_calls'], one_card_step_ms=one_ms,
            launches=a['launches'], spawn_s=spawn_s)
    summary['sharded'] = ps_dp4(repo, card, world)
    return summary


def ps_dp4(repo, card, world):
    """--only dp4: the full-width KITTI point-sharded dense-target step on
    one NCCL rank a card, on a 2 x (world / 2) and a 1 x world grid, with
    the dense and the sparse merge, against one card on the whole batch
    (:func:`ps_grid_compare`); the step on the grid against one card's.
    -> summary."""
    import tempfile
    grids = [(1, world)] if world < 4 else [(2, world // 2), (1, world)]
    batch = ps_batch('cpu')
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_dp4_ps_') as tmp:
        torch.save(batch, os.path.join(tmp, 'batch.pt'))
        ranks = spawn_ranks(ps_rank, repo, tmp, world, DP4_TIMEOUT_S,
                            '(dp4)', extra=('nccl', tuple(grids), True))
    spawn_s = time.perf_counter() - t0
    check(sorted(r['device'] for r in ranks)
          == [f'cuda:{r}' for r in range(world)],
          f'(dp4) ranks ran on {[r["device"] for r in ranks]}')
    det = ps_detector(head=dict(pos_cap=0))
    one_ms = dp4_timed(det, batch, det.init_train())[0]
    del det
    torch.cuda.empty_cache()
    out = dict(one_card_step_ms=one_ms, spawn_s=spawn_s)
    for grid in grids:
        key = f'{grid[0]}x{grid[1]}'
        out[key] = ps_grid_compare('(dp4) sharded', ranks, batch, grid,
                                   card, timed=True)
        for merge in PS_MERGES:
            steps = out[key][merge]['step_ms']
            print(f'(dp4) sharded {key} {merge}: a dense-target step on '
                  f'{world} cards {max(steps):.3f} ms (slowest rank; ranks '
                  f'{[round(x, 3) for x in steps]}; medians of {DP4_TIMED},'
                  f' synchronized host clock) against one card on the '
                  f'whole batch {one_ms:.3f} ms [{card}]')
    return out


def waymo_phases(repo, card):
    """Phases (w), (wt) and (wd).  -> (kernel numbers by call, launches by
    path, summaries)."""
    t0 = time.perf_counter()
    cfg = waymo_config(repo)
    det = waymo_detector(cfg)
    check(det.trunk.voxelize_mode == 'hard' and not det.trunk.s2d
          and det.trunk.grid() == (468, 468)
          and det.featmap_size == (468, 468), '(w) the Waymo trunk')
    print(f'(w) {WAYMO_CONFIG}: hard voxelize on a 468 x 468 canvas, '
          f'first stage at stride 1, {det.anchors[..., 0].numel()} anchors '
          f'a sample; B = {BATCH} x {WAYMO_POINTS} points of 5 channels')
    batches = [waymo_batch(s) for s in WAYMO_SEEDS]
    results, launches, summary = {}, {}, {}
    k, launches['predict'], summary['w'] = waymo_predict_phase(det, batches,
                                                               card)
    for name, r in k.items():
        results.setdefault(name, {}).update(r)
    del det
    torch.cuda.empty_cache()
    k, step_launches, summary['wt'] = waymo_train_phase(cfg, batches[0],
                                                        card)
    for name, r in k.items():
        results.setdefault(name, {}).update(r)
    launches.update(step_launches)
    del batches
    torch.cuda.empty_cache()
    summary['w_wt_s'] = time.perf_counter() - t0
    dp, dp_launches = dp_phases(repo, card, cfg)
    summary['phases_s'] = time.perf_counter() - t0
    print(f'(w), (wt), (wd), (wf) wall {summary["phases_s"]:.1f} s (limit '
          f'{WAYMO_LIMIT_S + WF_LIMIT_S:.0f} s) [{card}]')
    check(summary['phases_s'] <= WAYMO_LIMIT_S + WF_LIMIT_S,
          f'(w)-(wf) took {summary["phases_s"]:.1f} s')
    return results, launches, summary, dp, dp_launches


def dp_phases(repo, card, cfg=None):
    """Phases (wd) and (wf).  -> (summary, launches by run)."""
    cfg = cfg or waymo_config(repo)
    dp = dict(two_ranks=wd_two_ranks(repo, cfg, card))
    torch.cuda.empty_cache()
    dp['nccl_all_reduce_ms'] = nccl_all_reduce_ms(card)
    dp_launches, dp['cli'] = wd_cli(repo, card)
    # (wd) 1's comparison fails the phase here, after the CLI runs
    check(dp['two_ranks']['agree'], '(wd) two ranks disagree with one rank '
          'beyond the tolerances')
    torch.cuda.empty_cache()
    dp['families'], wf_launches = wf_families(repo, card)
    dp_launches.update({f'wf {name}': runs['two_ranks']
                        for name, runs in wf_launches.items()})
    return dp, dp_launches


# ------------------------------------------------------------ phase (ex)
# Serving export (engine/export.py): three full-width predicts exported
# with torch.export, each program saved, loaded in a fresh python process,
# run on two batches (the example and another), held to the eager predict
# (integers equal, floats within EX_TOL; expected bitwise), with its
# launches per call equal to the eager predict's and its median time
# beside the eager one's; then one profiling.trace of a
# predict summarized by tools/misc/summarize_trace, and the host cost of
# dispatching each registered op (the op against its CUDA implementation
# called directly, in turns, on the predict's inputs).
EX_DEVICE = 'cuda'
EX_SEEDS = (0, 1)
EX_TOL = 1e-5
# timed calls of each predict, exported in the fresh process and eager
# here, after one warm call each
EX_ITERS = 10
# host calls of each op and of its CUDA implementation, in turns
EX_DISPATCH_CALLS, EX_DISPATCH_ROUNDS = 200, 5
# the serving process: for each job (bundle, inputs, outputs) load the
# bundle (the process imports torch and the loader only), run each batch
# once with the launch counts read around it, then time EX_ITERS calls on
# CUDA events
EX_SERVE = r'''
import json, statistics, sys, time
import torch
from mmdet3d_gaussian_tpu_torch.engine.export import load_exported
from mmdet3d_gaussian_tpu_torch.ops import _cuda
iters, reports = int(sys.argv[1]), []
for bundle, inputs, out in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    served = load_exported(bundle)
    load_s = time.perf_counter() - t0
    batches = torch.load(inputs, weights_only=True)
    outs, launches = [], []
    for b in batches:
        _cuda.reset_launches()
        o = served(b)
        torch.cuda.synchronize()
        launches.append({k: v for k, v in _cuda.LAUNCHES.items() if v})
        outs.append([t.cpu() for t in o])
    times = []
    for i in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        served(batches[i % len(batches)])
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    torch.save(outs, out)
    reports.append(dict(load_s=load_s, launches=launches,
                        median_ms=statistics.median(times)))
print(json.dumps(dict(reports=reports, modules=sorted(
    m for m in sys.modules if m.split('.')[0] in (
        'jax', 'jaxlib', 'mmdet3d_gaussian_tpu', 'mmdet3d_gaussian_tpu_torch')
    and not m.startswith('mmdet3d_gaussian_tpu_torch.ops')))))
'''
# what the serving process may import of the port besides its ops
EX_SERVE_MODULES = ['mmdet3d_gaussian_tpu_torch',
                    'mmdet3d_gaussian_tpu_torch.engine',
                    'mmdet3d_gaussian_tpu_torch.engine.export']


def ex_cases(repo):
    """(name, detector, two batches, launches per predict) of the three
    exported predicts: the KITTI flagship (hard, packed encoder, f32), KITTI
    dynamic bf16 on the s2d canvas, CenterPoint nuScenes (gwd5) f32; zero
    cls / heatmap biases so that NMS has work."""
    from mmdet3d_gaussian_tpu_torch.engine.detector import (
        PointPillarsDetector, synthetic_batch)
    kitti = [synthetic_batch(BATCH, POINTS, 16, seed=s, device=EX_DEVICE)
             for s in EX_SEEDS]
    hard = PointPillarsDetector(None, device=EX_DEVICE, seed=0)
    dyn16 = PointPillarsDetector(BF16_MODEL, device=EX_DEVICE, seed=0)
    check(hard.trunk.voxelize_mode == 'hard' and dyn16.trunk.s2d,
          '(ex) detectors')
    for det in (hard, dyn16):
        with torch.no_grad():
            det.trunk.bbox_head.conv_cls.bias.zero_()
    cp = cp_detector(*cp_configs(repo)[0])
    return [('kitti hard f32', hard, kitti, HARD_PREDICT_LAUNCHES),
            ('kitti dynamic bf16 s2d', dyn16, kitti, PREDICT_S2D_LAUNCHES),
            ('centerpoint f32', cp, cp_batches(EX_SEEDS),
             CP_PREDICT_LAUNCHES)]


def ex_launches(run):
    """Launches of one ``run()`` (the nonzero counts)."""
    from mmdet3d_gaussian_tpu_torch.ops import _cuda
    torch.cuda.synchronize()
    _cuda.reset_launches()
    out = run()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _cuda.LAUNCHES.items() if v}


def ex_event_ms(run):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def ex_compare(got, want, what):
    """Integers equal, floats within EX_TOL -> (max abs diff, bitwise)."""
    worst, bitwise = 0.0, True
    for a, b, name in zip(got, want, ('boxes', 'scores', 'labels', 'valid')):
        a, b = a.cpu(), b.cpu()
        check(a.shape == b.shape and a.dtype == b.dtype,
              f'{what} {name}: {a.dtype}{tuple(a.shape)} against '
              f'{b.dtype}{tuple(b.shape)}')
        bitwise &= torch.equal(a, b)
        if a.is_floating_point():
            err = float((a - b).abs().max()) if a.numel() else 0.0
            check(err <= EX_TOL, f'{what} {name} off by {err:.3g}')
            worst = max(worst, err)
        else:
            check(torch.equal(a, b), f'{what} {name} differ')
    return worst, bitwise


def ex_export(name, det, batches, per_request, tmp):
    """The eager predict's outputs and launches on ``batches``, then the
    export on the first -> dict of them, the bundle and its inputs."""
    from mmdet3d_gaussian_tpu_torch.engine.export import export_predict
    eager, eager_launches = [], []
    for b in batches:
        out, runs = ex_launches(lambda b=b: det.predict(b))
        eager.append(out)
        eager_launches.append(runs)
    want = {k: v for k, v in per_request.items() if v}
    check(all(r == want for r in eager_launches),
          f'(ex) {name}: eager launches {eager_launches}, want {want}')
    stem = os.path.join(tmp, name.replace(' ', '_'))
    t0 = time.perf_counter()
    export_predict(det, batches[0], stem)
    export_s = time.perf_counter() - t0
    with open(os.path.join(stem, 'meta.json')) as f:
        ops = json.load(f)['ops']
    check(sorted(op.split('::')[1] for op in ops) == sorted(want),
          f'(ex) {name}: the program calls {ops}, want the ops of {want}')
    torch.save(batches, stem + '_inputs.pt')
    return dict(name=name, det=det, batches=batches, eager=eager,
                eager_launches=eager_launches, export_s=export_s, ops=ops,
                job=[stem, stem + '_inputs.pt', stem + '_served.pt'])


def ex_serve(runs, repo):
    """Every bundle of ``runs`` served by one fresh python process ->
    its report for each."""
    r = subprocess.run([sys.executable, '-c', EX_SERVE, str(EX_ITERS),
                        json.dumps([run['job'] for run in runs])],
                       capture_output=True, text=True, cwd=repo,
                       timeout=900, env=dict(os.environ, PYTHONPATH=repo))
    check(r.returncode == 0, f'(ex) serving process failed:\n'
          f'{r.stderr[-3000:]}')
    served = json.loads(r.stdout.strip().splitlines()[-1])
    check(served['modules'] == EX_SERVE_MODULES,
          f'(ex) the serving process imported {served["modules"]}')
    return served['reports']


def ex_check(run, served, card):
    """One export's fresh-process report against the eager predict: the
    outputs and launches of both batches, and the eager median over the
    same calls as the fresh process timed."""
    name, det, batches = run['name'], run['det'], run['batches']
    eager, eager_launches = run['eager'], run['eager_launches']
    check(served['launches'] == eager_launches,
          f'(ex) {name}: exported launches {served["launches"]} per call, '
          f'eager {eager_launches}')
    fresh = torch.load(run['job'][2], weights_only=True)
    errs = [ex_compare(f, e, f'(ex) {name} fresh process batch {i}')
            for i, (f, e) in enumerate(zip(fresh, eager))]
    t_eager = [ex_event_ms(lambda: det.predict(batches[i % len(batches)]))
               for i in range(EX_ITERS)]
    worst = max(e for e, _ in errs)
    bitwise = all(bw for _, bw in errs)
    res = dict(export_s=run['export_s'], load_s=served['load_s'],
               exported_median_ms=served['median_ms'],
               eager_median_ms=statistics.median(t_eager),
               launches_per_call=eager_launches[0], max_abs_err=worst,
               bitwise=bitwise, ops=run['ops'])
    print(f'(ex) {name}: export {run["export_s"]:.2f} s, load in a fresh '
          f'process {served["load_s"]:.2f} s; 2 batches equal to the eager '
          f'predict (max abs err {worst:.3g}, bitwise {bitwise}); launches '
          f'per call {eager_launches[0]} exported = eager; median ms on '
          f'CUDA events over {EX_ITERS} calls: exported (fresh process) '
          f'{served["median_ms"]:.3f}, eager (here) '
          f'{res["eager_median_ms"]:.3f} [{card}]')
    return res


def ex_dispatch(det, batch, card):
    """Host us per call of each registered op against its CUDA
    implementation called directly (the same function, without the
    dispatcher), on the inputs a predict hands it, in turns; the host's
    enqueue time of ``EX_DISPATCH_CALLS`` back-to-back calls, the card's
    work left out."""
    from mmdet3d_gaussian_tpu_torch.ops import (library, nms, rotated_iou,
                                                segment, voxelize)
    direct = {'segment_reduce': segment._segment_reduce_cuda,
              'segment_reduce_mapback': segment._segment_mapback_cuda,
              'bev_splat': voxelize._bev_splat_cuda,
              'bev_splat_pairs': voxelize._bev_splat_pairs_cuda,
              'rotated_iou': rotated_iou._rotated_iou_cuda,
              'nms_sweep': nms._nms_sweep_cuda}
    with torch.inference_mode():
        calls = record_calls(lambda: det.predict(batch), predict_patches())
    out = {}
    for name, seen in calls.items():
        op = library.op(name)
        args = seen[0]
        if name == 'nms_sweep':
            args = (args[0], args[1], float(args[2]))
        fns = {'op': lambda: op(*args), 'direct': lambda: direct[name](*args)}
        us = {k: [] for k in fns}
        for _ in range(EX_DISPATCH_ROUNDS):
            for k, fn in fns.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(EX_DISPATCH_CALLS):
                    fn()
                # the host's time alone: the launches queue behind the
                # card without waiting for it
                us[k].append((time.perf_counter() - t0) * 1e6
                             / EX_DISPATCH_CALLS)
                torch.cuda.synchronize()
        med = {k: statistics.median(v) for k, v in us.items()}
        out[name] = dict(op_us=med['op'], direct_us=med['direct'],
                         dispatch_us=med['op'] - med['direct'])
        print(f'(ex) dispatch {name}: {med["op"]:.2f} us a call through the '
              f'op, {med["direct"]:.2f} us calling its CUDA implementation '
              f'directly: {med["op"] - med["direct"]:.2f} us of dispatch '
              f'(host clock, {EX_DISPATCH_CALLS} calls x '
              f'{EX_DISPATCH_ROUNDS} rounds in turns) [{card}]')
    return out


def ex_trace(det, batch, tmp, card, calls=3):
    """One profiling.trace of ``calls`` predicts, summarized."""
    from mmdet3d_gaussian_tpu_torch.engine import profiling
    from mmdet3d_gaussian_tpu_torch.tools.misc import summarize_trace
    log_dir = os.path.join(tmp, 'trace')
    with profiling.trace(log_dir):
        for _ in range(calls):
            det.predict(batch)
    summary = summarize_trace.summarize(
        os.path.join(log_dir, profiling.TRACE_FILE), steps=calls)
    print('(ex) profiling.trace of the flagship predict, summarized:\n'
          + summarize_trace.report(summary, top=12) + f'\n[{card}]')
    return dict(device=summary['device'], total_ms=summary['total_ms'],
                by_family=summary['by_family'])


def export_phase(repo, card):
    """Phase (ex) -> {case: numbers}."""
    import tempfile
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(repo, 'build')) as tmp:
        cases = ex_cases(repo)
        runs = [ex_export(name, det, batches, per, tmp)
                for name, det, batches, per in cases]
        for run, served in zip(runs, ex_serve(runs, repo)):
            out[run['name']] = ex_check(run, served, card)
        del runs
        hard, dyn16 = cases[0][1], cases[1][1]
        out['dispatch'] = ex_dispatch(dyn16, cases[1][2][0], card)
        out['dispatch'].update({k: v for k, v in ex_dispatch(
            hard, cases[0][2][0], card).items() if k == 'bev_splat'})
        out['trace'] = ex_trace(hard, cases[0][2][0], tmp, card)
        check(out['trace']['device'] or EX_DEVICE != 'cuda',
              '(ex) the trace holds no device event')
        del cases
    out['phase_s'] = time.perf_counter() - t0
    print(f'(ex) phase wall {out["phase_s"]:.1f} s [{card}]')
    return out


def union_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is not None and start <= cur_end:
            cur_end = max(cur_end, end)
            continue
        if cur_end is not None:
            total += cur_end - cur_start
        cur_start, cur_end = start, end
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def device_profile(run, what, tag, card, iters):
    """Where the device time of ``run()`` goes: ``torch.profiler`` over
    ``iters`` back-to-back calls (after the main path's counts were read).
    Prints the device-busy share of the wall time (the union of kernel
    intervals) and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    spans, per_kernel = cuda_spans(prof), {}
    for start, end, name in spans:
        ms, calls = per_kernel.get(name, (0.0, 0))
        per_kernel[name] = (ms + (end - start) / 1e3 / iters,
                            calls + 1 / iters)
    busy = union_us([(start, end) for start, end, _ in spans]) / 1e3 / iters
    if busy == 0:
        print(f'{tag} profile: no device time recorded; busy share not '
              f'measured')
        return {}
    print(f'{tag} profile of {iters} back-to-back {what}s (profiler on): '
          f'{wall:.3f} ms wall and {busy:.3f} ms device busy per {what}, '
          f'idle share {100 * (1 - busy / wall):.1f}% [{card}]')
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for name, (ms, calls) in top[:20]:
        print(f'{tag} profile: {ms:9.4f} ms {calls:6.1f} launches per '
              f'{what}  {name[:100]}')
    return dict(profiled_wall_ms=wall, device_busy_ms=busy,
                idle_share=1 - busy / wall)


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs on the card',
              file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from mmdet3d_gaussian_tpu_torch.engine.detector import (
        PointPillarsDetector, synthetic_batch)
    from mmdet3d_gaussian_tpu_torch.ops import _cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f'card: {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}; f32 with TF32 off (matmul '
          f'{torch.backends.cuda.matmul.allow_tf32}, cudnn '
          f'{torch.backends.cudnn.allow_tf32})')

    # (a) build
    _cuda.library()
    info = _cuda.BUILD_INFO
    print(f'(a) build: {"nvcc + link" if info["built"] else "cached"} '
          f'{info["seconds"]:.2f} s -> {os.path.relpath(info["path"], root)}')
    for kern, text in _cuda.ptxas_summary(info['ptxas']).items():
        print(f'(a) ptxas {kern}: {text}')
    if sys.argv[1:] == ['--only', 'mvx']:
        # the MVX phases alone (no result line): a quick run of that path
        _, mvx_launches, mvx_e2e = mvx_phases(card)
        print(f'(e) mvx launches {json.dumps(mvx_launches)} [{card}]')
        print(f'(e) mvx summary {json.dumps(mvx_e2e)} [{card}]')
        return 0
    if sys.argv[1:] == ['--only', 'dp']:
        # the data-parallel phases (wd) and (wf) alone (no result line)
        dp, dp_launches = dp_phases(root, card)
        print(f'(e) dp launches {json.dumps(dp_launches)} [{card}]')
        print(f'(e) dp summary {json.dumps(dp)} [{card}]')
        return 0
    if sys.argv[1:] == ['--only', 'dp4', 'sharded']:
        # dp4's point-sharded grids alone (no result line)
        print(f'(e) dp4 sharded summary '
              f'{json.dumps(ps_dp4(root, card, torch.cuda.device_count()))}'
              f' [{card}]')
        return 0
    if sys.argv[1:] == ['--only', 'dp4']:
        # one NCCL rank a card (needs 2 or more cards; no result line)
        print(f'(e) dp4 summary {json.dumps(dp4_phase(root, card))} '
              f'[{card}]')
        return 0
    if sys.argv[1:] == ['--only', 'ps']:
        # the point-sharding phase (ps) alone (no result line)
        _, ps_launches, ps_e2e = ps_phase(root, card)
        print(f'(e) sharded launches {json.dumps(ps_launches)} [{card}]')
        print(f'(e) sharded summary {json.dumps(ps_e2e)} [{card}]')
        return 0
    if sys.argv[1:] == ['--only', 'export']:
        # the serving export phase (ex) alone (no result line)
        print(f'(e) export summary {json.dumps(export_phase(root, card))} '
              f'[{card}]')
        return 0
    if sys.argv[1:] == ['--only', 'waymo']:
        # the Waymo and data-parallel phases alone (no result line)
        _, w_launches, w_e2e, dp, dp_launches = waymo_phases(root, card)
        print(f'(e) waymo launches {json.dumps(w_launches)} [{card}]')
        print(f'(e) waymo summary {json.dumps(w_e2e)} [{card}]')
        print(f'(e) dp launches {json.dumps(dp_launches)} [{card}]')
        print(f'(e) dp summary {json.dumps(dp)} [{card}]')
        return 0

    # full-width detectors and requests: f32 on the plain canvas (K2), bf16
    # on the s2d canvas (K7)
    det = PointPillarsDetector(F32_MODEL, device='cuda', seed=0)
    det16 = PointPillarsDetector(BF16_MODEL, device='cuda', seed=0)
    check(det16.trunk.s2d and not det.trunk.s2d, 'canvas choice')
    with torch.no_grad():
        det.trunk.bbox_head.conv_cls.bias.zero_()
        det16.trunk.bbox_head.conv_cls.bias.zero_()
    batches = [synthetic_batch(BATCH, POINTS, 16, seed=s, device='cuda')
               for s in SEEDS]
    with torch.inference_mode():
        _, _, scatter = det.trunk.pillars(batches[0]['points'],
                                          batches[0]['points_mask'])
        print(f'(d) voxels {int(scatter.num_voxels)} of capacity '
              f'{scatter.max_voxels}, overflow {int(scatter.num_overflow)}')
        inputs = capture_inputs(det, batches[0], PREDICT_LAUNCHES)
        results = kernel_checks(inputs, card)          # (b) predict
        results['rotated_iou']['cases'] = k5_cases(card)
        results['nms_sweep']['cases'] = k6_cases(card)
        splat_falloff(inputs['bev_splat'], det.trunk, card)
        inputs16 = capture_inputs(det16, batches[0], PREDICT_S2D_LAUNCHES)
    k2_inputs = inputs['bev_splat']
    del inputs

    # full-width trainers from one seed: sparse targets (the default) and
    # dense targets (pos_cap=0, the decoded-box loss through K3), in f32
    # and in bf16
    tdet = PointPillarsDetector(F32_MODEL, device='cuda', seed=0)
    ddet = PointPillarsDetector(F32_MODEL, dict(pos_cap=0), device='cuda',
                                seed=0)
    tdet16 = PointPillarsDetector(BF16_MODEL, device='cuda', seed=0)
    ddet16 = PointPillarsDetector(BF16_MODEL, dict(pos_cap=0),
                                  device='cuda', seed=0)
    tbatch = batches[0]
    tstate = tdet.init_train(LR, total_steps=100)
    dstate = ddet.init_train(LR, total_steps=100)
    tstate16 = tdet16.init_train(LR, total_steps=100)
    dstate16 = ddet16.init_train(LR, total_steps=100)
    dstate, _ = ddet.train_step(tbatch, dstate)        # warm-up
    train_inputs, dstate = capture_train_inputs(
        ddet, tbatch, dstate, {**TRAIN_LAUNCHES, **DENSE_LAUNCHES})
    with torch.no_grad():
        results.update(train_kernel_checks(train_inputs, card))  # (b) train
    del train_inputs
    dstate16, _ = ddet16.train_step(tbatch, dstate16)  # warm-up
    train_inputs16, dstate16 = capture_train_inputs(
        ddet16, tbatch, dstate16, DENSE_BF16_LAUNCHES)
    with torch.no_grad():                              # (b) bf16
        k7, bf16 = bf16_kernel_checks(inputs16, train_inputs16, k2_inputs,
                                      card)
    results.update(k7)
    del train_inputs16, inputs16, k2_inputs
    torch.cuda.empty_cache()
    tiny_card_vs_cpu(card)                             # (c)
    tiny_train_card_vs_cpu(card)
    tiny_bf16_card_vs_cpu(card)
    tiny_card_vs_cpu(card, TINY_HARD, hard=True)       # (c) hard
    tiny_train_card_vs_cpu(card, TINY_HARD, hard=True)
    tiny_bf16_card_vs_cpu(card, TINY_HARD16, TINY_HARD, hard=True)
    tiny_card_vs_cpu(card, TINY_MVF, tag='TINY mvf')   # (c) mvf
    tiny_train_card_vs_cpu(card, TINY_MVF, head=dict(TINY_HEAD, pos_cap=0),
                           tag='TINY mvf dense')
    tiny_pvrcnn_card_vs_cpu(card)                      # (c) pvrcnn
    launches, e2e = main_path(det, batches, PREDICT_LAUNCHES, '(d)',
                              card)                    # (d)
    nms_counts(det, batches[-1])
    e2e.update(device_profile(lambda: det.predict(batches[0]), 'predict',
                              '(d)', card, 5))
    launches16, e2e16 = main_path(det16, batches, PREDICT_S2D_LAUNCHES,
                                  '(d16)', card)       # (d16)
    e2e16.update(device_profile(lambda: det16.predict(batches[0]),
                                'predict', '(d16)', card, 5))
    # the f32 default canvas ('auto': s2d), K7 on f32 rows
    det_s2d = PointPillarsDetector(dict(F32_MODEL, s2d_canvas='auto'),
                                   device='cuda', seed=0)
    check(det_s2d.trunk.s2d, 'auto did not turn the s2d canvas on')
    with torch.no_grad():
        det_s2d.trunk.bbox_head.conv_cls.bias.zero_()
    k7_f32 = {}
    with torch.inference_mode():
        inputs_s2d = capture_inputs(det_s2d, batches[0],
                                    PREDICT_S2D_LAUNCHES)
        check(inputs_s2d['bev_splat_pairs'][0].dtype == torch.float32,
              'the f32 s2d predict splat non-f32 rows')
        splat_pairs_check(k7_f32, inputs_s2d['bev_splat_pairs'], card,
                          ' (f32 predict, s2d canvas)')
    del inputs_s2d
    on_off, launches_s2d = s2d_on_off(det_s2d, det, batches, card)
    e2e.update(on_off)
    del det_s2d
    launches_t, tstate, train = timed_steps(            # (t)
        tdet, tbatch, tstate, TRAIN_LAUNCHES, '(t)', card)
    launches_d, dstate, train['dense_step_ms'] = dense_steps(
        ddet, tbatch, dstate, {**TRAIN_LAUNCHES, **DENSE_LAUNCHES}, '(t)',
        card)
    holder = [tstate]

    def one_step():
        holder[0] = tdet.train_step(tbatch, holder[0])[0]
    train.update(device_profile(one_step, 'train step', '(t)', card, 3))
    del tdet, ddet, holder, tstate, dstate
    torch.cuda.empty_cache()
    launches_t16, tstate16, train16 = timed_steps(      # (t16)
        tdet16, tbatch, tstate16, TRAIN_BF16_LAUNCHES, '(t16)', card)
    launches_d16, dstate16, train16['dense_step_ms'] = dense_steps(
        ddet16, tbatch, dstate16, DENSE_BF16_LAUNCHES, '(t16)', card)
    holder16 = [tstate16]

    def one_step16():
        holder16[0] = tdet16.train_step(tbatch, holder16[0])[0]
    train16.update(device_profile(one_step16, 'train step', '(t16)', card,
                                  3))
    del tdet16, ddet16, holder16, tstate16, dstate16, det, det16
    torch.cuda.empty_cache()
    hard_k2, hard_k1, hard_launches, hard_e2e = hard_phases(batches, card)
    torch.cuda.empty_cache()
    cp_k, cp_launches, cp_e2e = centerpoint_phases(root, card)  # (n)-(N)
    torch.cuda.empty_cache()
    mvf_k, mvf_launches, mvf_e2e = mvf_phases(root, card)     # (m)-(M)
    torch.cuda.empty_cache()
    pv_k, pv_launches, pv_e2e = pvrcnn_phases(root, card)    # (p)-(P)
    torch.cuda.empty_cache()
    mvx_k, mvx_launches, mvx_e2e = mvx_phases(card)   # (c) mvx, (x)-(xt)
    torch.cuda.empty_cache()
    w_k, w_launches, w_e2e, dp, dp_launches = waymo_phases(  # (w)-(wd)
        root, card)
    torch.cuda.empty_cache()
    ps_k, ps_launches, ps_e2e = ps_phase(root, card)          # (ps)
    torch.cuda.empty_cache()
    loop_k, loop_launches, loop_e2e = loop_phase(root, card)   # (L)
    torch.cuda.empty_cache()
    ex_e2e = export_phase(root, card)                          # (ex)

    kernels = []                                       # (e)
    n_pred = len(SEEDS) * ROUNDS
    counts = {'predict': (launches, n_pred, 'predict'),
              'predict_bf16': (launches16, n_pred, 'bf16 predict'),
              'train': (launches_t, TIMED_STEPS, 'step'),
              'train_dense': (launches_d, DENSE_STEPS, 'dense step')}
    # the same kernels on the bf16 paths (K2 runs on none of them: bf16
    # takes the s2d canvas)
    counts16 = {'predict': counts['predict_bf16'],
                'train': (launches_t16, TIMED_STEPS, 'bf16 step'),
                'train_dense': (launches_d16, DENSE_STEPS,
                                'bf16 dense step')}

    def launch_keys(name, runs, n, unit):
        return dict(launches=runs[name],
                    launches_per=f'{runs[name] / n:g} per {unit}')
    for name, (source, replaces, path) in KERNELS.items():
        r = results[name]
        entry = dict(
            name=name, route='cuda', source=source, replaces=replaces,
            path=path, **launch_keys(name, *counts[path]),
            max_abs_err=r['max_abs_err'], ms=r['ms'], call_ms=r['call_ms'],
            plain_ms=r['plain_ms'],
            bound_ms=r['bound_ms'], bound_by=r['bound_by'],
            library_ms=r['library_ms'], bytes=r['bytes'],
            operations=r['operations'])
        entry.update({key: r[key] for key in (
            'cold_ms', 'floor_ms', 'library_cold_ms', 'zero_fill_ms')
            if key in r})
        if name == 'rotated_iou':
            entry.update({key: r[key] for key in (
                'near_share', 'bound_all_pairs_ms', 'zero_fill_ms', 'cases')})
        if name == 'nms_sweep':
            entry.update({key: r[key] for key in (
                'kept_share', 'split', 'cases')})
        if name == 'bev_splat_pairs':
            entry['launches_per_bf16_step'] = \
                launches_t16[name] / TIMED_STEPS
            entry['f32'] = dict(k7_f32[name], **launch_keys(
                name, launches_s2d, n_pred, 'f32 predict, s2d canvas'))
        if name in bf16:
            entry['bf16'] = bf16[name]
            if name != 'bev_splat':
                entry['bf16'].update(launch_keys(name, *counts16[path]))
        # the hard paths: launches per predict or step, and K2's and K1's
        # numbers on their inputs
        entry['hard'] = dict(launches_per={
            path: per[name] for path, per in hard_launches.items()
            if name in per})
        if name == 'bev_splat':
            entry['hard'].update(hard_k2)
        if name in ('segment_reduce', 'segment_max_winner'):
            entry['hard']['sorted'] = {
                what: r for what, r in hard_k1.items()
                if (name == 'segment_max_winner') == what.startswith(
                    'winner')}
        # phase (L): launches per CLI run, numbers on the loop's inputs
        entry['loop'] = dict(launches={
            run: counts[name] for run, counts in loop_launches.items()
            if name in counts})
        loop_key = {'bev_splat': 'loop train batch',
                    'nms_sweep': 'nms_normal_bev'}.get(name, name)
        if loop_key in loop_k:
            entry['loop'].update(loop_k[loop_key])
        if name == 'bev_splat':
            entry['loop']['bf16'] = loop_k['loop bf16 predict']
        # phases (n)-(N): launches per CenterPoint path, numbers on its
        # inputs
        entry['centerpoint'] = dict(cp_k.get(name, {}), launches={
            path: runs[name] for path, runs in cp_launches.items()
            if runs.get(name)})
        # phases (m)-(M): launches per MVF path, numbers on its inputs by
        # call (K2 by canvas, K1 by view)
        entry['mvf'] = dict(mvf_k.get(name, {}), launches={
            path: runs[name] for path, runs in mvf_launches.items()
            if runs.get(name)})
        # phases (p)-(P): launches per PV-RCNN path, numbers on its inputs
        # by call (K5 and K6 at B x 512 and B x 128, K4 over a step)
        entry['pvrcnn'] = dict(pv_k.get(name, {}), launches={
            path: runs[name] for path, runs in pv_launches.items()
            if runs.get(name)})
        # phases (x)-(xt): launches per MVX path, numbers on its inputs by
        # call (f32 and bf16 predict, the step)
        entry['mvx'] = dict(mvx_k.get(name, {}), launches={
            path: runs[name] for path, runs in mvx_launches.items()
            if runs.get(name)})
        # phases (w)-(wt): launches per Waymo path, numbers on its inputs
        entry['waymo'] = dict(w_k.get(name, {}), launches={
            path: runs[name] for path, runs in w_launches.items()
            if runs.get(name)})
        # phase (wd): launches per data-parallel CLI run; for K4 its
        # all-reduced sums against the plain moments of the whole batch
        # and the cost of the step's BatchNorm all-reduces
        entry['dp'] = dict(launches={
            run: counts[name] for run, counts in dp_launches.items()
            if counts.get(name)})
        if name == 'bn_moments':
            entry['dp'].update(
                all_reduced_vs_plain=dp['two_ranks']['k4_rel'],
                gloo_two_ranks_all_reduce_ms=dp['two_ranks'][
                    'all_reduce_ms'],
                nccl_one_rank_all_reduce_ms=dp['nccl_all_reduce_ms'])
        # phase (ps): launches per point-sharded path, numbers on its
        # inputs (K3, K4, K5, K6)
        entry['sharded'] = dict(ps_k.get(name, {}), launches={
            path: runs[name] for path, runs in ps_launches.items()
            if runs.get(name)})
        kernels.append(entry)
    print(f'(e) predict summary {json.dumps(e2e)} [{card}]')
    print(f'(e) bf16 predict summary {json.dumps(e2e16)} [{card}]')
    print(f'(e) train summary {json.dumps(train)} [{card}]')
    print(f'(e) bf16 train summary {json.dumps(train16)} [{card}]')
    for key, summary in hard_e2e.items():
        print(f'(e) hard {key} summary {json.dumps(summary)} [{card}]')
    print(f'(e) loop summary {json.dumps(loop_e2e)} [{card}]')
    print(f'(e) centerpoint summary {json.dumps(cp_e2e)} [{card}]')
    print(f'(e) mvf summary {json.dumps(mvf_e2e)} [{card}]')
    print(f'(e) pvrcnn summary {json.dumps(pv_e2e)} [{card}]')
    print(f'(e) mvx summary {json.dumps(mvx_e2e)} [{card}]')
    print(f'(e) waymo summary {json.dumps(w_e2e)} [{card}]')
    print(f'(e) dp summary {json.dumps(dp)} [{card}]')
    print(f'(e) sharded summary {json.dumps(ps_e2e)} [{card}]')
    print(f'(e) export summary {json.dumps(ex_e2e)} [{card}]')
    print(f'(e) profiler misses (timed on CUDA events instead): '
          f'{len(PROFILER_MISSES)}')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

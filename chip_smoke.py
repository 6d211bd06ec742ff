#!/usr/bin/env python3
"""Drive the PyTorch port of the tracker once on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:
  1. the card: name and power limit (nvidia-smi), torch, CUDA and nvcc;
  2. build the CUDA kernels from tinyslam_tpu_torch/csrc at first use;
  3. K1, the fused FAST kernel, one launch over the four pyramid levels of
     a rendered 640x480 frame and of a 752x480 one with real-camera
     photometrics (EuRoC's width: levels 376, 188 and 94 wide), bit-equal
     to its plain PyTorch version on every level, all five maps;
  4. K2, the streaming Hamming matcher on the int8 tensor cores, equal to
     its plain version at
     N=2048 features x M=8192 map points, guided (r=20, 8, the keyframes'
     32 and the relocalization's 64) and unguided (the global
     relocalization), and at the keyframes' and the two-view bootstrap's
     2048 x 2048; and with an explicit (N, M) pair mask (not on the main
     path): the r=20 gate written out as a mask (equal to the guided
     result too) at 2048 x 8192 and a random third of the pairs at 2048 x
     2048; then the keyframe triangulation's duplicate test and local
     depth band (``ops/dupband_cuda.py``) at 2048 x 8192 on phase 4's real
     features and seeded map, bit-equal to its plain version;
  5. the tracked-frame slice at full width with keyframes off
     (``slice_config()``): frame 0 seeds the map at its ray-cast 3D points,
     DeviceVO tracks frames 1-24 of the bench orbit on the card; every
     frame must track, camera centres must stay within 5 cm of ground
     truth, the first 8 frames must agree with the same slice run on the
     CPU with the plain versions, and both kernels' launch counters must
     show the main path went through them (K1 once a frame);
  6. the default ``SlamConfig()`` at full width, keyframes and windowed BA
     on: the same seed, DeviceVO (its captured graph, as on every phase's
     card run but 8's) tracks frames 1-188 of the orbit (the
     longest prefix the JAX reference tracks wholly: a keyframe comes about
     every 16 frames at this width, and the 11th, which rolls the 10-slot
     window and starts the culling, near frame 172); every frame must
     track, the window must roll, the map must gain landmarks, the
     camera-centre error must stay within 2 cm of the JAX reference's own
     on this sequence, frames 1-53 (three keyframes, the first BA) must
     agree with the CPU plain path, the launch counters must show K1 and K2
     on the path, and a frame of the plain ``track_step`` may synchronize
     with the host at most 3 times (4 on a keyframe);
  7. the kernels and their plain versions timed at the shapes of phases
     3, 4, 12 and 13 (device time from launches queued behind a sleep
     kernel between CUDA events, the profiler's kernel time beside it, wall
     time per call), K1 also one level a launch for the per-level split, one
     launch over phase 12's 8 frames and one over phase 13's 4 at four
     thresholds, K2 also over phase 13's 4 sequences, K2's library
     yardstick (torch._int_mm of the +-1 int8 unpacking, or a bf16 matmul,
     whichever is faster; a bf16 bmm for 4 sequences: the distance matrices
     alone, never called by the port), K2 with a pair mask (the mask's bytes
     in its bound), the order-fixed assembly kernel of the pose graph's
     normal equations at phases 9's and 14's first solve and at the first
     solve of tools/profile_pose_graph.py's 200-node chain (224 nodes x 7,
     256 edges padded; each shape's longest segment printed; its order in
     PyTorch as the plain version, one ``index_add_`` on the card as the
     library call), each kernel's bound from this run's shapes, and the
     device time (profiler) of one keyframe insertion, one relocalization
     frame and one graph solve; the duplicate-test kernel beside its plain
     version and its bound, its launches and the rows that took its
     overflow pass over the smoke;
  8. DeviceVO from frame 0 under the default ``SlamConfig()``, no state
     handed over, on the plain path (``graph=False``: (d) and (g) read its
     Python calls per attempt; phase 17 runs the same frames through the
     graph): (a) the host-phase two-view bootstrap must succeed within
     14 frames; (b) every later frame to 100 must track, the Sim(3)-aligned
     ATE over frames 14-100 within 2 cm of the JAX reference's own
     (``REF_BOOT_ATE``); (c) the same run on the CPU plain path with the same
     draws bootstraps on the same frame with the same landmarks, poses
     within 2e-3 over the next 16 frames; (d) a relocalization forced after
     a flush at frame 60 tracks, within 4 syncs (5 on a keyframe); (e) a
     kidnap (relocalization forced, then a frame 10 orbit steps ahead,
     beyond the guided radius) is re-acquired by the global fallback; (f)
     8 blank frames reboot the tracker, and the host phase bootstraps a
     second submap anchored at the last tracked pose; (g) K1 launches once
     a frame, host-phase frames included, and K2 at least once per
     bootstrap attempt and per relocalization attempt;
  9. Sim(3) loop closure, under the default ``SlamConfig()`` but for
     ``pose_graph.loop_min_gap`` 6 (``slam_config()``), on the out-and-back
     of the orbit (frames 0..100, then 99..0): (a) ``DeviceSlam`` from frame
     0 bootstraps within 14 frames, accepts at least the JAX reference's
     closures (``REF_SLAM_CLOSURES``), keeps its keyframe tables and edges
     consistent, and its corrected trajectory's Sim(3)-aligned ATE from the
     bootstrap frame stays within 2 cm of the reference's
     (``REF_SLAM_ATE``); K1 launches once a frame, K2 once per keyframe
     ingest and 1 + ``loop_candidates`` times per loop probe on top of the
     tracking path, the assembly kernel once a Gauss-Newton iteration of
     each graph solve (each stage one replay of its captured program,
     counted by wrapping the stage functions; the first solve's assembly
     inputs, from its eager run, bit-equal to ``index_add_`` on the
     CPU), and a tracked frame's ``process`` call synchronizes at most 3
     times (4 on a keyframe, one more after a lost frame; through the
     graph none, one where it dispatches a chunk); it prints the SLAM layer's
     syncs per chunk, its timings per stage and its tracked fps against
     ``DeviceVO`` on the same frames; (b) the first probe, the one that
     accepted the first closure, and the first graph solve replayed on the
     CPU plain path with the card's inputs and the same draws: the probe's
     counts equal (those read off the PnP pose but at a degenerate
     candidate: both reject it at the inlier gate, no hypothesis explains
     one chain match on either device, and the card's pose is finite or
     the NaN that ``_dlt_pose`` gives its first hypothesis) and, for the
     candidates at the inlier
     gate (at least one), poses within 2e-3 and RMSE and both scale
     estimates within 2e-3 relative; (c) the
     asynchronous back-end, with the frames fed at once and again at a
     camera's 30 a second, applies a closure, its watchdog restarts
     nothing, and its ATE stays within 2 cm of the reference's each time
     (fed at once, tracking outruns the solve and waits for it once it is
     16 frames old); (d) the host
     ``Slam`` on frames 0-40 bootstraps on ``DeviceVO``'s frame and tracks
     every later frame, K1 once a frame; (e) the command line (``python -m
     tinyslam_tpu_torch.run --dataset synthetic --frames 60``) exits 0 on
     the card;
 10. the datasets: (a) tools/eval_ate.py's fr1_desk-like sequence (640x480
     through the distorted fr1 camera, handheld motion, photometrics) and
     its mh01-like one (752x480, EuRoC's camera, MAV motion), rendered by
     ``tinyslam_tpu_torch.eval_ate`` (clean ray casts on spawned processes)
     and written in the TUM and EuRoC layouts under
     build/tinyslam_tpu_torch/seq/ (reused on a rerun); (b) the native
     loader alone: decode and undistort frames/s, the first frame equal to
     the rendered one once undistorted; (c) ``run.main(["--dataset", "tum",
     ...])`` in this process on the first ``N_TUM`` frames, (d) ``--dataset
     euroc`` on ``N_EUROC``: exit 0, the summary line, K1 once a frame and
     K2 on the path; then the same run under three more sets of RANSAC
     draws, and the medians of the four inside the JAX reference's envelope
     over four sets of its own (``REF_TUM_*``, ``REF_EUROC_*``): tracked
     frames at least its fewest less 2, keyframes and closures at least its
     fewest, the Sim(3)-aligned ATE at most its largest + 2 cm;
 11. recovery and instrumentation: (a) phase 8's ``DeviceVO`` after
     frame 40 saved (``utils/checkpoint.py``), restored into a fresh one on
     the card, both tracking frames 41-60 with 8d's relocalization forced
     at 60: equal flags, inliers and keyframes, centres within 1e-5 m, K1
     once a frame and K2 on the resumed path; (b) the same checkpoint on
     the CPU plain path, frames 41-48 within 2e-3 of the card; (c) phase
     9's ``DeviceSlam`` snapshotted every keyframe (``SnapshotPolicy``,
     keep 2), dropped after frame 69, the newest snapshot restored into a
     fresh one (tables and edges equal to the snapshot's), at most 3 of
     frames 70-99 lost; (d) ``Heartbeat(device="cuda")`` answers, a probe
     that sleeps reports dead within its 0.2 s; (e) continuous-angle BRIEF
     (nearest, then bilinear) on phase 3's frame equal to the CPU plain
     path's but for bits whose samples are within 1e-5 (counted), the
     front-end's ms a frame binned and continuous, ``DeviceVO`` under
     bilinear BRIEF on phase 5's 24 frames, ``dispatch_slope`` of one
     ``track_step`` beside phase 5's ms a frame, and a ``profiling.trace``
     of one chunk on the plain path naming ``orb_level0``-``3`` and both
     kernels; (f) the
     card/CPU differences that remain, pinned: in lockstep on identical
     frames and draws the front-end agrees bit for bit and the first
     quantity that differs is the one ROADMAP names (the two-view estimate
     at frame 3 of the 160x120 bootstrap under ``Sampler(4)`` and of the
     host ``Slam``; the pose refinement at frame 1 of phase 6);
 12. the distributed layer (``tinyslam_tpu_torch/parallel/``): (a)
     ``initialize_multihost`` with NCCL at world size 1 on a free local
     port, ``make_mesh()`` gives (1, 1) on the card; (b)
     ``extract_features_batch`` on 8 frames of the orbit at full width
     (``FrontendConfig()``: 4 levels x 512) through that mesh: one K1 launch
     for the batch, every frame bit-equal to ``extract_features`` on the card
     and to the CPU plain path, the wall time of a batch against 8 single
     frames, K1's batched launch against 8 single ones; (c)
     ``bundle_adjust_sharded`` at ``BAConfig()``'s size (K=10, L=2048, 6
     iterations) on a problem built as ``__graft_entry__.py`` builds its BA
     stage, bit-equal to ``bundle_adjust``, ms an LM iteration; (d) at
     ``PoseGraphConfig()``'s size (N=256, E=1024: an odometry chain, 512
     loop edges and invalid padding) ``optimize_pose_graph_sharded`` over 20
     iterations bit-equal to ``optimize_pose_graph`` and to a second run of
     it (the order-fixed assembly kernel adds the normal equations) and
     ``optimize_pose_graph_node_sharded`` (halo 8, 40 iterations) with
     centres within 0.05 m of it, ms each; (e) two processes on the one card
     over gloo with CUDA tensors (``chip_smoke.py --dist-rank``) running (c)
     and the edge-sharded (d) at world size 2: both ranks equal, within
     ``tests/test_torch_parallel.py``'s tolerances of world size 1;
 13. (run right after phase 17, before any profiler: a profiler session
     slows every later graph launch of the process) B camera streams as
     one batch (``track_chunk_batch``) under the default
     ``SlamConfig()``: (a) 4 sequences seeded at orbit frames 0, 40, 80 and
     120, 32 frames each, sequence 3 from a stale pose (it relocalizes in
     the batch), sequence 2's last 8 frames inactive, a step at a time
     through the captured ``BatchGraph`` in lockstep with the plain
     ``track_step_batch``: every state tensor, R, t and summary of every
     step bit-equal, the graph's branch runs (its tally, summed over rows)
     and K1 and K2 launches equal to the plain step's; every active frame
     tracks, and each sequence against its own ``track_chunk`` on the card
     has equal tracking and keyframe flags, inliers within 2%, centres
     within 2 mm and rotations within 1e-3 rad; (b) per plain step one K1
     launch, one K2 launch per guided pass plus the relocalization's and
     keyframes' own, at most one sync a condition (2B + 1, plus one a
     relocalization's fallback and one a keyframe's BA condition), and no
     sync in any of the graph's steps; (c) K1 at four thresholds over four
     frames bit-equal to its plain version, K2 at B=4 and B=1, guided and
     unguided, exact; (d) aggregate tracked frames/s at B = 1, 2, 4 and 8
     (orbit frames 0, 20, ..., 140, 24 frames each), three runs each of the
     batched graph, B serial ``ChunkGraph`` runs and the plain batched
     step, with each batched graph's capture and instantiation seconds and
     pool bytes; (e) ``entry()``'s step on the card: 256 landmarks, 0
     matches, features within 1% of the JAX step's 1543; (f)
     ``dryrun_multichip(1)`` on NCCL and ``dryrun_multichip(2)`` with two
     gloo ranks sharing the card, stage 4 through the captured graph; (g,
     run after phase 11 with 17f and 18c) one replay of the batched graph
     traced at B = 1 and 8, its kernel time by name and span.  Phase 7
     also times K1 and K2 at B=4;
 14. the accuracy eval: tools/eval_ate.py's fr1_loop-like sequence (a
     full-circuit handheld walk that returns to its start, 640x480 through
     the distorted fr1 camera) at ``N_LOOP`` frames, rendered by
     ``tinyslam_tpu_torch.eval_ate`` (the renderer phase 10 shares), through
     ``eval_ate.run_sequence`` (``DeviceSlam``, the loader's uint8 frames)
     under ``Sampler(0)``-``(3)``: every frame fed, finite ATE and RPE, K1
     once a frame, K2 once per keyframe ingest, 1 + ``loop_candidates``
     times per loop probe and at least once per tracked frame besides, the
     assembly kernel once an iteration of each closure's solve; the
     medians of the four inside the JAX reference's envelope over four key
     offsets (``REF_LOOP_*``, as phase 10's); the four samplers replay one
     chunk graph, one ingest and one probe program (no graph is keyed by a
     seed), printed with their pool bytes;
 15. the error budget: ``tinyslam_tpu_torch.error_budget.budget_for_sequence``
     on phase 14's fr1_loop-like frames under ``Sampler(0)`` (VO with and
     without BA, then SLAM): every stage with the JAX tool's keys and finite
     numbers, each loop candidate classified against the ground-truth
     revisits (tp + fp + fn + tn = candidates, the accepted ones = the
     closures), K1, K2 and the assembly kernel launched; the SLAM stage is
     phase 14's ``Sampler(0)`` run again and must equal it bit for bit: raw
     and corrected trajectories, closures, keyframes and edges (runs on the
     card are reproducible since the pose graph adds its normal equations
     in a fixed order);
 16. the bench (``tinyslam_tpu_torch.bench``, ``python -m
     tinyslam_tpu_torch.bench``'s path): ``bench_tracked`` on the first 110
     of phase 2's orbit frames (bootstrap, a warm-up chunk of 32, two timed
     chunks of 32, one round) and ``bench_frontend`` on four of them, each
     with its untimed instrumented rounds: the bootstrap within 14 frames,
     every timed frame tracked, K1 once a timed frame in both rows and K2 at
     least once a tracked frame; it prints frames/s, syncs and launches a
     frame and the card's busy share (not gates; the profiler of phase 11
     has already slowed this process's launches);
 17. (run right after phase 8, before any profiler) the captured graph,
     ``DeviceVO``'s path on the card, against the plain ``track_chunk`` on
     the card: (a) phase 6's frames 1-188 on the plain path, poses,
     summaries, the final state and map bit-equal to phase 6's graph run,
     launch counts equal, tracked frames/s both ways; (b) phase 8's script
     (bootstrap, the forced relocalization, the kidnap, the blank frames,
     the reboot and the second submap) through the graph, bit-equal to
     phase 8's plain run, launch counts (the graph's from its branch tally)
     equal, no sync in a tracked frame's ``process`` but the chunk's one
     readback where it dispatches; (c) phase 6's frames chunk by chunk
     through ``ChunkGraph.track_chunk``: no sync in any chunk, the results
     of phase 6; the branch bodies run, the capture and instantiation
     seconds, the graph's pool bytes and the launches a body makes; (e)
     the second pass's body's card time (replays of a graph of it), which
     a select over both sides would add to every frame that skips it; (f)
     (after phase 11, whose trace has already slowed later launches) one
     chunk of (c), the third keyframe's, replayed under the profiler: its
     K1 and K2 kernel events must equal the launches ``ChunkGraph`` works
     out for it from the graph and its branch tally;
 18. the SLAM layer's captured programs (``models/slam.py``: the ingest,
     the probe and the solve, each one replay of a ``Program`` and one
     readback): (a) right after phase 9, on every stage call of phase 9's
     counted run, the output equal bit for bit to the eager function's on
     the same inputs on the card (a probe that differs prints its first
     differing field and is held to phase 9b's check against the CPU
     instead), no sync in a load and replay and one in a stage call, each
     program's capture and instantiation seconds and pool bytes, wall ms
     a call against the eager function's and card ms a replay, and every
     allocation of a solve's capture (cuSOLVER's workspaces among them)
     in its graph's pool; (b) right after phase 14, the same on its
     ``Sampler(0)`` run's stage calls (no timing: phase 11's profiler has
     run by then); (c) after 17f, one replay of each program traced: its
     K1, K2 and assembly kernel events equal the launches it adds to the
     counters and the stage's own (K2 once an ingest, 1 + C times a
     probe; the assembly once a Gauss-Newton step of a solve, the steps
     one WHILE node, whose body the profiler reports once a replay: the
     turns are read from the loop's counter on the device).
The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

WIDTH, HEIGHT = 640, 480
N_FRAMES = 25          # frame 0 seeds the map, frames 1-24 are tracked
N_KF_FRAMES = 189      # phase 6: frames 1-188 are tracked with keyframes
CHUNK = 8
N_CPU_KF = 53          # phase 6 frames held against the CPU: 3 keyframes, 1 BA
# Max camera-centre error of the JAX reference (tinyslam_tpu, default
# SlamConfig, on the CPU) over phase 6's seeded frames 1-188:
# python tools/jax_reference_orbit.py --frames 189 (see PERF.md).
REF_MAX_ERR = 3.6051011085510254
N_BOOT_FRAMES = 101    # phase 8: DeviceVO from frame 0 to frame 100
BOOT_BUDGET = 14       # the bootstrap must succeed within this many frames
RELOC_FRAME = 60       # phase 8d: relocalization forced after a flush
KIDNAP_STEPS = 10      # phase 8e: the frame fed after frame 100
N_BLANK = 8            # phase 8f: blank frames, = reloc_max_frames
N_CPU_BOOT = 16        # phase 8c: frames after the bootstrap held against the CPU
# Sim(3)-aligned ATE of the JAX reference's DeviceVO from frame 0 over
# frames 14-100 of the orbit: python tools/jax_reference_orbit.py
# --bootstrap --frames 101 (see PERF.md).
REF_BOOT_ATE = 0.28026400986635236
N_SLAM = 101           # phase 9: orbit frames 0..100, then 99..0
# Phase 9's one change to SlamConfig(): the JAX package's own SLAM tests
# use 6 (tests/test_slam.py:29); the default 30 keyframes would take about
# 450 frames at a keyframe every 12-16.
SLAM_LOOP_MIN_GAP = 6
CAMERA_HZ = 30         # phase 9c: frames a second of a live camera (TUM's fr1)
N_SLAM_HOST = 41       # phase 9d: the host Slam on frames 0-40
N_CLI_FRAMES = 60      # phase 9e
# The JAX reference's DeviceSlam on phase 9's sequence: accepted closures
# and the Sim(3)-aligned ATE of the corrected trajectory from the
# bootstrap frame on: python tools/jax_reference_orbit.py --slam --frames
# 101 (see PERF.md).
REF_SLAM_CLOSURES = 1
REF_SLAM_ATE = 0.27765025824560974
REC_SAVE_FRAME = 41     # phase 11a: frames 0-40 tracked, then saved; 41-60 resumed
REC_CPU_FRAMES = 8      # phase 11b: frames 41-48 on the CPU from the card's checkpoint
CRASH_AT = 70           # phase 11c: the DeviceSlam dropped after frame 69 ...
CRASH_END = 100         # ... and frames 70-99 tracked after the restore
REC_DIR = Path(__file__).resolve().parent / "build" / "tinyslam_tpu_torch" / "phase11"
# Phase 10's sequences: tools/eval_ate.py's fr1_desk-like (:29-46) and
# mh01-like (:64-76) builders at these lengths (tinyslam_tpu_torch.eval_ate's
# fr1_desk_spec(150) and mh01_spec(60)), rendered by the port.
TUM_SEQ = dict(kind="tum", seed=101, frames=150, width=640, height=480,
               room=dict(tex_res=256, octaves=4, clutter=8))
EUROC_SEQ = dict(kind="euroc", seed=202, frames=60, width=752, height=480,
                 room=dict(half_size=(8.0, 5.0, 8.0), tex_res=256, octaves=4, clutter=16))
N_DP_FRAMES = 8        # phase 12b: frames of one batch through frontend_dp
N_PG_LOOPS = 512       # phase 12d: loop edges beside the 255 odometry ones
NODE_ITERS, NODE_HALO = 40, 8   # phase 12d: the node-sharded solver
DIST_DIR = Path(__file__).resolve().parent / "build" / "tinyslam_tpu_torch" / "phase12"
MS_STARTS = (0, 40, 80, 120)   # phase 13: the four sequences' seed frames
MS_FRAMES = 32                 # ... and their frames (s0 + 1 .. s0 + 32)
MS_STALE = 3                   # the sequence that starts from a stale pose,
MS_STALE_YAW = 0.02            # ... this many rad off, marked lost
MS_PADDED, MS_PAD = 2, 8       # the sequence whose last MS_PAD frames are inactive
MS8_STARTS, MS8_FRAMES = tuple(range(0, 160, 20)), 24    # phase 13d at B=8
MS_THRESHOLDS = (0.045, 0.06, 0.075, 0.09)               # phase 13c: K1's four thresholds
# The JAX package's entry() step, jitted on the CPU: num_features, matches,
# inliers, tracking, keyframe, landmarks, rmse, threshold.
REF_ENTRY_SUMMARY = (1543, 0, 0, 0, 0, 256, 0, 0.06)
# The prefixes phase 10 runs (the longest the JAX reference tracks without
# a reboot, at most 150 and 60 frames), and the envelope of the JAX
# reference's DeviceSlam there, as its command line runs it, over key
# offsets 0-3 (its RANSAC draws under four seeds; one run is one sample of
# a knife-edge bootstrap): the fewest tracked frames, keyframes and accepted
# closures, the largest Sim(3)-aligned ATE.  python
# tools/jax_reference_orbit.py --tum --frames N_TUM --key-offset S, and
# --euroc --frames N_EUROC (see PERF.md).
N_TUM = 150
N_EUROC = 60
REF_TUM_TRACKED, REF_TUM_KEYFRAMES, REF_TUM_CLOSURES = 142, 20, 0
REF_TUM_ATE = 0.6044219900662758
REF_EUROC_TRACKED, REF_EUROC_KEYFRAMES, REF_EUROC_CLOSURES = 55, 19, 0
REF_EUROC_ATE = 0.3265627921063381
# Phase 14: tools/eval_ate.py's fr1_loop-like sequence (:49-67) at that
# tool's default length, through tinyslam_tpu_torch.eval_ate.run_sequence
# (DeviceSlam, the loader's uint8 frames as the tool feeds them) under
# Sampler(0)-(3); the envelope of the JAX tool's own run_sequence there
# over key offsets 0-3: the fewest tracked frames, keyframes and accepted
# closures, the largest Sim(3)-aligned ATE of the corrected trajectory.
# python tools/jax_reference_orbit.py --eval fr1_loop --key-offset S (see
# PERF.md).
N_LOOP = 300
REF_LOOP_TRACKED, REF_LOOP_KEYFRAMES, REF_LOOP_CLOSURES = 267, 64, 1
REF_LOOP_ATE = 1.3399
# Phase 16: tinyslam_tpu_torch.bench's tracked row on phase 2's orbit frames
# (14 + BENCH_CHUNK * (BENCH_CHUNKS_TIMED + 1) = 110 of its 189) and its
# front-end row on BENCH_FE_FRAMES of them.
BENCH_CHUNK, BENCH_CHUNKS_TIMED, BENCH_FE_FRAMES = 32, 2, 4
# Phase 7's third assembly shape: a solve of tools/profile_pose_graph.py's
# chain of this many keyframes (padded to 224 nodes and 256 edges).
N_CHAIN = 200
# Published H100 SXM peaks (NVIDIA's data sheet, dense rates at 700 W): the
# bounds of phase 7.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12
# Float operations a pixel of K1 (csrc/fast.cu, as fast_maps counts them):
# the ring 16 x (1 sub, 2 compares, 2 subs, 2 max, 2 adds) + 1 max, box
# sums 2 x 14 adds, ramps 2 x (14 mul + 13 add), blur 2 x (7 mul + 6 add),
# NMS 8 compares.
K1_FLOPS_PER_PIXEL = 16 * 9 + 1 + 28 + 54 + 26 + 8


def out_and_back(n: int) -> list[int]:
    """Orbit indices of phase 9's sequence: frames 0..n-1, then n-2..0."""
    return list(range(n)) + list(range(n - 2, -1, -1))


def slam_config():
    """Phase 9's config: ``SlamConfig()`` with ``loop_min_gap`` 6."""
    from tinyslam_tpu_torch import SlamConfig

    cfg = SlamConfig()
    return cfg.replace(pose_graph=cfg.pose_graph.replace(loop_min_gap=SLAM_LOOP_MIN_GAP))


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn, reps: int = 100, warmup: int = 10) -> float:
    """Wall time of one call, from CUDA events around `reps` back-to-back
    calls: the rate at which the host can issue it, or the device can run
    it, whichever is slower."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int = 20) -> float | None:
    """Device time of one call: the summed duration of every kernel (and
    memset/copy) it runs, from the profiler's CUDA trace, over `reps` calls;
    None when three traces in a row record no device time (late in a long
    process the profiler now and then returns only empty traces)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages())
        if us > 0:
            return us / reps / 1e3
    return None


def _shown(ms: float | None, digits: int = 3) -> str:
    """A time from ``_device_ms`` as printed: ms, or why it is missing."""
    return "not measured (empty profiler traces)" if ms is None else f"{ms:.{digits}f} ms"


def _busy(device: float | None, wall: float) -> str:
    return "not measured" if device is None else f"{100 * device / wall:.1f}%"


def _queued_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` (which must not synchronize), from
    CUDA events around ``reps`` calls that the host queued while a sleep
    kernel held the stream: the events then time the device alone, with no
    gap for the host's launch overhead, and depend on no profiler."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Twice the time the host took to queue the calls, at up to 2 GHz.
    torch.cuda._sleep(int(2e9 * (2 * enqueue_s + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` (which must not synchronize) from
    CUDA events around replays of a CUDA graph of it: a function of
    hundreds of small launches fills the launch queue that ``_queued_ms``
    relies on, a replay queues one."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound_ms(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _library_ms(desc_a, desc_b, smi) -> float | None:
    """K2's yardstick: device time of one library product giving the
    (N, M) +-1 dot (hence the distances) of two descriptor sets,
    torch._int_mm on int8 or a bf16 matmul, whichever is faster; None if
    neither runs.  The unpacking is not timed; the port never calls these."""
    import torch

    from tinyslam_tpu_torch.types import descriptor_signs

    sa, sb = descriptor_signs(desc_a).to(torch.int8), descriptor_signs(desc_b).to(torch.int8)
    want = (sa.float() @ sb.float().transpose(-1, -2)).to(torch.int32)
    a16, b16 = sa.to(torch.bfloat16), sb.to(torch.bfloat16)
    calls = {"bf16 matmul": lambda: a16 @ b16.transpose(-1, -2)}
    if sa.dim() == 2:       # torch._int_mm takes no batch
        calls["int_mm"] = lambda: torch._int_mm(sa, sb.T)
    out = {}
    for name, fn in calls.items():
        try:
            if not torch.equal(fn().to(torch.int32), want):
                raise AssertionError("not the exact product")
            out[name] = _queued_ms(fn)
        except (RuntimeError, AssertionError) as exc:
            print(f"library yardstick {name}: not timed ({str(exc).splitlines()[0]})")
    print(f"library yardstick {tuple(sa.shape)} @ {tuple(sb.transpose(-1, -2).shape)}, "
          f"device ms: "
          f"{ {k: round(v, 5) for k, v in out.items()} }  [{smi}]")
    return min(out.values()) if out else None


def _centres(R, t) -> np.ndarray:
    return np.stack([-Ri.T @ ti for Ri, ti in zip(R, t)])


def _seeded(cfg, feats, room, cam, pose):
    """VOState whose map holds the valid features of one frame at their
    ray-cast ground-truth 3D points, at that frame's pose."""
    import torch

    from tinyslam_tpu_torch.models.vo_device import VOState

    xy = feats.xy[feats.valid].cpu().numpy().astype(np.float64)
    X = torch.from_numpy(room.raycast(cam, *pose, xy).astype(np.float32))
    R, t = (torch.from_numpy(np.asarray(a)) for a in pose)
    return VOState.seeded(cfg, feats, X, R, t)


def _same_bits(a, b) -> bool:
    """Two tensors of one shape and dtype equal bit for bit (NaN included)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return torch.equal(a, b)


def _named_leaves(tree, prefix: str = ""):
    """(dotted field name, tensor) of a dataclass of tensors, in
    ``tree_leaves`` order."""
    import dataclasses

    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _named_leaves(getattr(tree, f.name), prefix + f.name + ".")
    else:
        yield prefix[:-1], tree


def _with_sync_count(fn):
    """Run fn with PyTorch's sync debug mode on; returns (result, number of
    synchronizing CUDA calls it made), as the bench counts them."""
    from tinyslam_tpu_torch.bench import _with_sync_count as counted

    return counted(fn)


def _run_record(vo, launches, chunk_s=None, **extra) -> dict:
    """What a DeviceVO run leaves, for phase 17 to hold another run against
    bit for bit: poses, summaries, the final state (its map included) and
    the submaps, the launch counts and the chunks' seconds."""
    return {"R": np.stack([R for R, _ in vo.trajectory]),
            "t": np.stack([t for _, t in vo.trajectory]),
            "stats": [(s.num_features, s.num_matches, s.num_inliers, s.tracking,
                       s.is_keyframe, s.num_landmarks, s.rmse_px) for s in vo.stats],
            "state": vo.state.to_numpy() if vo.state is not None else None,
            "events": [(e["frame"], np.asarray(e["base"][0]).tobytes(),
                        np.asarray(e["base"][1]).tobytes()) for e in vo.submap_events],
            "launches": dict(launches), "chunk_s": chunk_s, **extra}


def _run_differences(a: dict, b: dict) -> list[str]:
    """The quantities in which two ``_run_record``s differ, each with the
    first frame (or state field) where it does."""
    out = []
    for key in ("R", "t"):
        if a[key].shape != b[key].shape:
            out.append(f"{key}: {a[key].shape} vs {b[key].shape} frames")
        elif not np.array_equal(a[key], b[key]):
            bad = np.flatnonzero((a[key] != b[key]).reshape(len(a[key]), -1).any(1))
            out.append(f"{key} from frame {int(bad[0])} ({len(bad)} frames)")
    if a["stats"] != b["stats"]:
        i = next((j for j, (x, y) in enumerate(zip(a["stats"], b["stats"])) if x != y),
                 min(len(a["stats"]), len(b["stats"])))
        out.append(f"summaries from frame {i}: "
                   f"{a['stats'][i] if i < len(a['stats']) else None} vs "
                   f"{b['stats'][i] if i < len(b['stats']) else None}")
    if (a["state"] is None) != (b["state"] is None):
        out.append("one run ends without a state")
    elif a["state"] is not None:
        out += [f"state {k}" for k in a["state"] if not np.array_equal(a["state"][k],
                                                                        b["state"][k])]
    if a["events"] != b["events"]:
        out.append("submap events")
    return out


def _graph_phase(cam, frames, dev, smi, kf_run, boot_run):
    """Phase 17: the captured graph (``DeviceVO``'s path on the card) against
    the plain ``track_chunk`` on the card, on phase 6's and phase 8's frames,
    bit for bit, with no sync in a chunk's replays and one readback a chunk.
    Returns the kernels' launch counts of its runs."""
    import torch

    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.models.vo_device import BRANCHES, DeviceVO, VOState
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda
    from tinyslam_tpu_torch.utils.draws import Sampler

    cfg = SlamConfig()
    failures = []
    total = {"fast_score_map_fused": 0, "match_reduce_streaming": 0, "dup_band": 0}

    def counted():
        out = {"fast_score_map_fused": fast_cuda.LAUNCHES,
               "match_reduce_streaming": match_cuda.LAUNCHES,
               "dup_band": dupband_cuda.LAUNCHES}
        for k, v in out.items():
            total[k] += v
        return out

    # a. Phase 6's seeded frames 1-188 on the plain path (phase 6 ran them
    # through the graph).
    torch.cuda.synchronize()
    fast_cuda.LAUNCHES = match_cuda.LAUNCHES = dupband_cuda.LAUNCHES = 0
    vo = DeviceVO(cfg, cam, chunk=CHUNK, device=dev, graph=False)
    vo.state = VOState.from_numpy(kf_run["seed"], dev)
    n = N_KF_FRAMES - 1
    chunk_s = []
    for c in range(n // CHUNK):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for im in frames[1 + c * CHUNK: 1 + (c + 1) * CHUNK]:
            vo.process(im)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t_start)
    for im in frames[1 + len(chunk_s) * CHUNK:]:
        vo.process(im)
    vo.flush()
    eager6 = _run_record(vo, counted(), chunk_s)
    diff6 = _run_differences(kf_run, eager6)
    fps = lambda cs: (len(cs) - 1) * CHUNK / sum(cs[1:])  # noqa: E731  (after the warm-up)
    kf6 = sum(s[4] for s in eager6["stats"])
    print(f"17a phase 6's frames 1-{n} ({kf6} keyframes), graph (phase 6) against the plain "
          f"path: {'bit-equal' if not diff6 else diff6}; launches graph "
          f"{kf_run['launches']}, plain {eager6['launches']}; tracked fps (frames "
          f"{CHUNK + 1}-{len(chunk_s) * CHUNK}) graph {fps(kf_run['chunk_s']):.2f}, plain "
          f"{fps(chunk_s):.2f}  [{smi}]")
    if diff6:
        failures.append(f"phase 6's frames: the graph and the plain path differ: {diff6}")
    if kf_run["launches"] != eager6["launches"]:
        failures.append(f"phase 6's launches: graph {kf_run['launches']}, plain "
                        f"{eager6['launches']}")

    # b. Phase 8's script (bootstrap, the forced relocalization at frame 60,
    # the kidnap, the blank frames and the reboot, the second submap)
    # through the graph; syncs counted per tracked frame fed.
    fast_cuda.LAUNCHES = match_cuda.LAUNCHES = dupband_cuda.LAUNCHES = 0
    vo = DeviceVO(cfg, cam, chunk=CHUNK, device=dev, sampler=Sampler(0))
    fed_syncs = []                # (dispatched a chunk, syncs) per tracked frame fed
    rebooted = []                 # syncs of the frames that rebooted the tracker
    t_start = time.perf_counter()
    for op in boot_run["script"]:
        if op[0] == "flush":
            vo.flush()
        elif op[0] == "force":
            vo.force_reloc = True
        else:
            image = frames[op[1]] if op[1] is not None else np.zeros_like(frames[0])
            if not vo.initialized:
                vo.process(image)
                continue
            pending, reboots = len(vo._pending), vo.num_reboots
            _, k = _with_sync_count(lambda: vo.process(image))
            if vo.num_reboots != reboots:
                rebooted.append(k)    # the reboot drains the pending chunks
            else:
                fed_syncs.append((len(vo._pending) != pending, k))
    torch.cuda.synchronize()
    seconds8 = time.perf_counter() - t_start
    graph8 = _run_record(vo, counted())
    diff8 = _run_differences(boot_run, graph8)
    dispatch = [k for d, k in fed_syncs if d]
    quiet = [k for d, k in fed_syncs if not d]
    print(f"17b phase 8's {len(boot_run['stats'])} frames (bootstrap, forced "
          f"relocalization, kidnap, reboot) through the graph against phase 8's plain "
          f"run: {'bit-equal' if not diff8 else diff8}; launches graph "
          f"{graph8['launches']}, plain {boot_run['launches']}; syncs per tracked frame "
          f"fed: {sorted(set(quiet))} where no chunk was dispatched, "
          f"{sorted(set(dispatch))} where one was ({len(dispatch)} chunks), {rebooted} "
          f"where one rebooted the tracker; {seconds8:.2f} s  [{smi}]")
    if diff8:
        failures.append(f"phase 8's frames: the graph and the plain path differ: {diff8}")
    if graph8["launches"] != boot_run["launches"]:
        failures.append(f"phase 8's launches: graph {graph8['launches']}, plain "
                        f"{boot_run['launches']}")
    if any(quiet) or any(k != 1 for k in dispatch) or not dispatch:
        failures.append(f"syncs per tracked frame {fed_syncs}: 0 expected, 1 (the "
                        f"chunk's readback) where a chunk is dispatched")

    # c. Phase 6's frames again, chunk by chunk through the captured graph:
    # no sync in any chunk's replays, and the results of phase 6's run.
    graph = vd.chunk_graph(cam, cfg, VOState.from_numpy(kf_run["seed"], dev),
                           torch.from_numpy(frames[1]).to(dev), Sampler(0))
    state = VOState.from_numpy(kf_run["seed"], dev)
    chunk_syncs, Rs, ts, sums = [], [], [], []
    images = torch.from_numpy(np.stack(frames[1:N_KF_FRAMES])).to(dev)
    # The chunk that phase 17f traces: the third keyframe's, with its BA.
    kf_chunk = [i for i, s in enumerate(kf_run["stats"]) if s[4]][2] // CHUNK * CHUNK
    before = graph.tally.tolist()
    fast_cuda.LAUNCHES = match_cuda.LAUNCHES = dupband_cuda.LAUNCHES = 0
    for c in range(0, n, CHUNK):
        part = images[c:c + CHUNK]
        if c == kf_chunk:
            replay = (graph, state, part)
        (state, ys), k = _with_sync_count(
            lambda part=part: graph.track_chunk(state, part, [True] * len(part)))
        chunk_syncs.append(k)
        Rs.append(ys["R"])
        ts.append(ys["t"])
        sums.append(ys["summary"])
    runs = dict(zip(BRANCHES, (a - b for a, b in zip(graph.tally.tolist(), before))))
    same = (np.array_equal(torch.cat(Rs).cpu().numpy(), kf_run["R"])
            and np.array_equal(torch.cat(ts).cpu().numpy(), kf_run["t"]))
    col = np.array([s[:7] for s in kf_run["stats"]], np.float32)
    same &= np.array_equal(torch.cat(sums)[:, :7].cpu().numpy(), col)
    accounted = graph.account(graph.tally.tolist())
    launched = counted()
    c = graph.captured
    print(f"17c phase 6's frames in {len(chunk_syncs)} chunks of {CHUNK} through "
          f"ChunkGraph.track_chunk: syncs per chunk {sorted(set(chunk_syncs))}, results "
          f"{'equal to' if same else 'DIFFERENT from'} phase 6's; branch bodies run "
          f"{runs}; the graph: capture {c.capture_s:.3f} s, instantiation "
          f"{c.instantiate_s:.3f} s, pool {c.pool_bytes} B, launches outside the "
          f"branches {c.base} (K1, K2, assembly, duplicate test) a replay, in each branch "
          f"{c.body_launches}  [{smi}]")
    # e. The second pass as a conditional node or as a select over both
    # sides: its body's card time on phase 6's first frame, and how often
    # the frames of (c) took it.
    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.models.vo import _match_to_map, _track_pnp

    st = VOState.from_numpy(kf_run["seed"], dev)
    feats = extract_features(images[0], st.threshold, cfg.frontend)

    def second_pass():
        idx, mv = _match_to_map(feats, st.map, cfg.matcher.max_distance, cfg.matcher.ratio,
                                cam=cam, R=st.R, t=st.t, radius_px=8.0)
        return _track_pnp(cam, feats, st.map, idx, mv, st.R, st.t, iters=cfg.vo.pnp_iters,
                          inlier_px=cfg.vo.pnp_inlier_px)

    sp_ms = _graph_ms(second_pass)
    print(f"17e the second pass's body (K2 at r=8, a PnP refine): {sp_ms:.4f} ms of card time "
          f"a frame; taken on {runs['second_pass']} of {n} frames in (c): a select over "
          f"both sides would add it to the other {n - runs['second_pass']}  [{smi}]")
    if any(chunk_syncs):
        failures.append(f"chunk replays synchronized: {chunk_syncs}")
    if not 0 < launched["dup_band"] == 2 * accounted["keyframe"]:
        failures.append(f"17c: the duplicate test launched {launched['dup_band']} times in "
                        f"{accounted['keyframe']} keyframe bodies (two a body expected)")
    if not same:
        failures.append("ChunkGraph.track_chunk differs from phase 6's DeviceVO run")
    for key, g in vd._GRAPHS.items():
        print(f"17d graph {key[2]} {key[3]}: capture {g.captured.capture_s:.3f} s, "
              f"instantiation {g.captured.instantiate_s:.3f} s, pool "
              f"{g.captured.pool_bytes} B, {g.replays} replays  [{smi}]")
    if failures:
        raise AssertionError("graph phase: " + "; ".join(failures))
    return total, replay


def _replay_trace(replay, dev, smi):
    """Phase 17f: the kernels that replays of the captured graph launch, as
    the profiler sees them.  One chunk of phase 17c's (its first with a
    keyframe, from the same state) is traced on the card alone, and its
    K1 and K2 kernel events are counted against the counts that
    ``ChunkGraph`` works out for the same chunk: the graph's launches
    outside the branches a replay, and each branch body's launches times
    the times the device tally says it ran; so are the keyframe body's
    duplicate-test kernels.  Run after phase 11 has traced:
    the profiler slows this process's later launches."""
    import json

    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda
    from tinyslam_tpu_torch.utils import profiling

    graph, state, part = replay
    kernels = ("fast_pyramid_kernel", "match_reduce_kernel", "dupband_kernel")
    for attempt in range(3):    # a trace now and then comes back empty
        graph.account(graph.tally.tolist())
        fast_cuda.LAUNCHES = match_cuda.LAUNCHES = dupband_cuda.LAUNCHES = 0
        with profiling.trace(REC_DIR / "replay_trace", device=dev, cpu=False) as log_dir:
            graph.track_chunk(state, part, [True] * len(part))
        runs = graph.account(graph.tally.tolist())
        worked = [fast_cuda.LAUNCHES, match_cuda.LAUNCHES, dupband_cuda.LAUNCHES]
        events = [e for e in json.loads((log_dir / "trace.json").read_text())["traceEvents"]
                  if e.get("cat") == "kernel"]
        seen = [sum(name in e.get("name", "") for e in events) for name in kernels]
        if events:
            break
    print(f"17f one chunk of {len(part)} replays traced (attempt {attempt + 1}): "
          f"{len(events)} kernel events; K1, K2, duplicate test in the trace {seen}, worked "
          f"out by ChunkGraph {worked}; branch bodies run {runs}  [{smi}]")
    if not events or seen != worked or not runs["keyframe"]:
        raise AssertionError(f"graph phase: the traced replays launched K1, K2, the "
                             f"duplicate test {seen} times, ChunkGraph counts {worked}, "
                             f"keyframe bodies {runs['keyframe']}")


def _slam_replay_trace(records, dev, smi):
    """Phase 18c: the kernels that one replay of each SLAM program
    launches, as the profiler sees them, on phase 9's first inputs of each
    stage: K1, K2 and the assembly kernel events held to the launches the
    program adds to the counters (its capture's ``base``) and to the
    stage's own counts (K2 once an ingest and 1 + C times a probe, the
    assembly once a Gauss-Newton step of a solve).  The profiler reports
    the kernels of a WHILE node's body once a replay however many turns
    it runs (587 kernel events for a solve's 20 steps), so a
    solve's trace shows the assembly once, and its turns are read from
    the loop's counter on the device (``Captured.turns``).  Run after
    phase 11 has traced, as 17f."""
    import json

    from tinyslam_tpu_torch.utils import profiling

    kernels = ("fast_pyramid_kernel", "match_reduce_kernel", "ordered_scatter_kernel")
    failures = []
    for name in ("kf_ingest", "loop_probe", "solve_graph"):
        args, _ = records[name][0]
        prog, inputs = _stage_program(name, args, dev)
        cfg = args[0] if name == "solve_graph" else args[1]
        pg = cfg.pose_graph
        want = {"kf_ingest": (0, 1, 0, 0),
                "loop_probe": (0, 1 + max(2, pg.loop_candidates), 0, 0),
                "solve_graph": (0, 0, pg.gn_iters, 0)}[name]
        want_turns = [pg.gn_iters] if name == "solve_graph" else []
        traced = (0, 0, 1) if name == "solve_graph" else want[:3]
        prog(inputs)
        # A trace now and then comes back empty, or without a WHILE body's
        # kernels (a solve's trace of 348 kernel events, not ~585, in one
        # of six runs): trace again, up to three times.
        for attempt in range(3):
            with profiling.trace(REC_DIR / f"slam_trace_{name}", device=dev,
                                 cpu=False) as log_dir:
                prog(inputs)
            events = [e for e in json.loads((log_dir / "trace.json").read_text())["traceEvents"]
                      if e.get("cat") == "kernel"]
            seen = tuple(sum(k in e.get("name", "") for e in events) for k in kernels)
            if events and seen == traced:
                break
        turns = [int(t) for t in prog.captured.turns]
        print(f"18c one {name} replay traced (attempt {attempt + 1}): {len(events)} kernel "
              f"events; K1, K2, assembly in the trace {seen} (a loop's body once), turns of "
              f"its loops {turns}; added to the counters a replay {prog.captured.base}, the "
              f"stage's own {want}  [{smi}]")
        if not (seen == traced and turns == want_turns and tuple(prog.captured.base) == want):
            failures.append(f"{name}: traced {seen}, turns {turns}, counted "
                            f"{prog.captured.base}, want {want}")
    if failures:
        raise AssertionError("SLAM replay trace: " + "; ".join(failures))


def _keyframe_phase(cam, room, poses, frames, dev, smi):
    """Phase 6: the default SlamConfig() (keyframe insertion, windowed BA,
    culling) at full width through DeviceVO on frames 1-188.  Returns the
    kernels' launch counts of the run and a callable that inserts one
    keyframe into the final state (timed in phase 7)."""
    import torch

    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.models.vo import _triangulate_and_insert, row
    from tinyslam_tpu_torch.models.vo_device import SUMMARY_FIELDS, DeviceVO, VOState
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda
    from tinyslam_tpu_torch.ops.hamming import match_descriptors
    from tinyslam_tpu_torch.utils.draws import Sampler

    cfg = SlamConfig()
    fe = cfg.frontend
    n = N_KF_FRAMES - 1
    col = {name: i for i, name in enumerate(SUMMARY_FIELDS)}
    thr = torch.tensor(fe.threshold, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    fast_cuda.LAUNCHES = 0
    match_cuda.LAUNCHES = 0
    dupband_cuda.LAUNCHES = 0
    feats0 = extract_features(torch.from_numpy(frames[0]).to(dev), thr, fe)
    seed = _seeded(cfg, feats0, room, cam, poses[0])
    n_seed = int(seed.map.valid.sum())
    vo = DeviceVO(cfg, cam, chunk=CHUNK, device=dev)
    vo.state = seed
    chunk_s = []    # the first chunk is the warm-up
    for c in range(n // CHUNK):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for im in frames[1 + c * CHUNK: 1 + (c + 1) * CHUNK]:
            vo.process(im)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t_start)
    for im in frames[1 + len(chunk_s) * CHUNK:]:      # the partial last chunk
        vo.process(im)
    vo.flush()
    launches = {"fast_score_map_fused": fast_cuda.LAUNCHES,
                "match_reduce_streaming": match_cuda.LAUNCHES,
                "dup_band": dupband_cuda.LAUNCHES}
    # The tracked frames' launches (less the seed frame's extraction).
    run = _run_record(vo, {**launches,
                           "fast_score_map_fused": launches["fast_score_map_fused"] - 1},
                      chunk_s, seed=seed.to_numpy())
    stats = vo.stats
    kf = np.array([s.is_keyframe for s in stats])
    n_kf = int(kf.sum())
    est = vo.positions
    gt = _centres([p[0] for p in poses[1:]], [p[1] for p in poses[1:]])
    err = np.linalg.norm(est - gt, axis=1) if est.shape == gt.shape else np.array([np.inf])
    made = int((vo.map.valid & (vo.map.anchor_kf >= 0)).sum())
    print("keyframes at frames", (np.flatnonzero(kf) + 1).tolist(),
          "landmarks per frame", [s.num_landmarks for s in stats])
    print(f"tracked {sum(s.tracking for s in stats)}/{n}, {n_kf} keyframes, "
          f"num_keyframes {vo.num_keyframes}, window ids {vo.state.win_kf_id.tolist()}; "
          f"map {int(vo.map.valid.sum())} landmarks ({n_seed} seeded, {made} triangulated "
          f"and alive); centre error vs ground truth max {err.max():.4f} m, mean "
          f"{err.mean():.4f} m (JAX reference max {REF_MAX_ERR} m)")
    print(f"keyframe path tracked fps (frames {CHUNK + 1}-{len(chunk_s) * CHUNK}, after "
          f"a warm-up chunk): {(len(chunk_s) - 1) * CHUNK / sum(chunk_s[1:]):.2f}; "
          f"ms/frame per chunk "
          f"{[round(t * 1e3 / CHUNK, 3) for t in chunk_s]}  [{smi}]")
    print("launches during the keyframe run:", launches)

    # Per frame: wall time and host syncs, tracked again from the seed.
    images = torch.from_numpy(np.stack(frames[1:])).to(dev)
    state = VOState.from_numpy(seed.to_numpy(), dev)
    frame_ms, syncs, is_kf = [], [], []
    for i in range(n):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        (state, ys), k = _with_sync_count(
            lambda: vd.track_step(cam, cfg, state, images[i], Sampler(0)))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t_start) * 1e3)
        syncs.append(k)
        is_kf.append(bool(ys["summary"][col["is_keyframe"]] > 0))
    frame_ms, syncs, is_kf = np.array(frame_ms), np.array(syncs), np.array(is_kf)
    late = np.arange(n) >= CHUNK                # after the warm-up frames
    print(f"ms per keyframe frame {frame_ms[late & is_kf].mean():.3f} "
          f"(n={int((late & is_kf).sum())}), per plain frame "
          f"{frame_ms[late & ~is_kf].mean():.3f} (n={int((late & ~is_kf).sum())}), "
          f"with a synchronize after each; syncs per plain frame "
          f"{sorted(set(syncs[late & ~is_kf].tolist()))}, per keyframe frame "
          f"{sorted(set(syncs[late & is_kf].tolist()))} (warm-up frames 1-{CHUNK}: "
          f"{syncs[~late].tolist()})  [{smi}]")

    # Where a keyframe's time goes, on the final state (window full).
    feats = extract_features(images[-1], state.threshold, cfg.frontend)
    ref = vd._best_baseline_slot(state)
    ref_feats = state.win_feats.map(lambda x: row(x, ref))
    none = torch.zeros_like(feats.valid)
    kf_insert = lambda: vd._insert_keyframe(cam, cfg, state, feats, none, none)
    match = lambda: match_descriptors(feats.desc, feats.valid, ref_feats.desc,
                                      ref_feats.valid)
    m = match()
    parts = {
        "K2 unguided match (x2)": match,
        "_triangulate_and_insert (x2)": lambda: _triangulate_and_insert(
            cam, state.map, state.num_keyframes, state.R, state.t, feats,
            row(state.win_R, ref), row(state.win_t, ref), ref_feats,
            m["idx_b"], m["valid"], none, max_new=fe.features_per_level,
            band_lo=cfg.vo.tri_band_lo, band_hi=cfg.vo.tri_band_hi,
            dup_radius_px=cfg.vo.dup_radius_px, local_band=cfg.vo.tri_local_band),
        "_record_kf_obs, K2 guided r=32 (x3)": lambda: vd._record_kf_obs(
            cam, cfg, state, ref, ref_feats),
        "_push_keyframe": lambda: vd._push_keyframe(state, state.R, state.t, feats,
                                                    state.num_keyframes),
        "_local_ba": lambda: vd._local_ba(cam, cfg, state),
        "_insert_keyframe (all, 1 sync)": kf_insert,
    }
    part_ms = {k: _time_ms(f, reps=5, warmup=1) for k, f in parts.items()}
    print("keyframe breakdown, wall ms per call: "
          + ", ".join(f"{k} {v:.3f}" for k, v in part_ms.items())
          + f"; BA per LM iteration {part_ms['_local_ba'] / cfg.ba.max_iters:.3f}"
          + f"  [{smi}]")

    # Reference on a small input: the same run on the CPU plain path.
    cpu_state = VOState.from_numpy(seed.to_numpy(), "cpu")
    _, ys = vd.track_chunk(cam, cfg, cpu_state,
                           torch.from_numpy(np.stack(frames[1:1 + N_CPU_KF])),
                           [True] * N_CPU_KF, Sampler(0))
    s_cpu = ys["summary"].numpy()
    cpu_c = _centres(ys["R"].numpy(), ys["t"].numpy())
    dc = float(np.abs(cpu_c - est[:N_CPU_KF]).max())
    lm_gpu = np.array([s.num_landmarks for s in stats[:N_CPU_KF]])
    dlm = float(np.max(np.abs(s_cpu[:, col["num_landmarks"]] - lm_gpu) / lm_gpu))
    kf_same = np.array_equal(s_cpu[:, col["is_keyframe"]] > 0, kf[:N_CPU_KF])
    print(f"card vs CPU plain path, frames 1-{N_CPU_KF} "
          f"({int(kf[:N_CPU_KF].sum())} keyframes): keyframes equal {kf_same}, max "
          f"centre diff {dc:.2e} m, max relative landmark diff {dlm:.4f}")

    failures = []
    if sum(s.tracking for s in stats) != n or len(stats) != n:
        failures.append(f"tracked {sum(s.tracking for s in stats)}/{n} frames")
    if n_kf < 10 or vo.num_keyframes <= cfg.ba.max_keyframes:
        failures.append(f"{n_kf} keyframes: the window did not roll")
    if made <= 0 or max(s.num_landmarks for s in stats) <= n_seed:
        failures.append("the map gained no landmarks")
    if not err.max() <= REF_MAX_ERR + 0.02:
        failures.append(f"centre error {err.max():.4f} m > reference "
                        f"{REF_MAX_ERR} m + 0.02 m")
    if not (kf_same and dc < 2e-3 and dlm <= 0.02):
        failures.append("card and CPU plain path disagree")
    if launches["fast_score_map_fused"] != N_KF_FRAMES:
        failures.append(f"K1 launched {launches['fast_score_map_fused']} times, "
                        f"expected {N_KF_FRAMES} (one a frame)")
    if launches["match_reduce_streaming"] < n + 5 * n_kf:
        failures.append(f"K2 launched {launches['match_reduce_streaming']} times, "
                        f"expected >= {n + 5 * n_kf}")
    if launches["dup_band"] != 2 * n_kf:
        failures.append(f"the duplicate test launched {launches['dup_band']} times, "
                        f"expected {2 * n_kf} (two a keyframe)")
    if syncs[late & ~is_kf].max() > 3 or syncs[late & is_kf].max() > 4:
        failures.append(f"syncs per frame {syncs.tolist()} exceed 3 (4 on a keyframe)")
    if failures:
        raise AssertionError("keyframe phase: " + "; ".join(failures))
    return launches, kf_insert, run


def _bootstrap_phase(cam, poses, frames, dev, smi, cfg=None):
    """Phase 8: DeviceVO from frame 0, no state handed over (the default
    SlamConfig() unless ``cfg``): bootstrap, tracking, the CPU comparison, a
    forced relocalization, a kidnap and a reboot.  Returns the kernels'
    launch counts of the run and a callable that tracks one relocalization
    frame (timed in phase 7)."""
    import torch

    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.geometry.pnp import pnp_ransac
    from tinyslam_tpu_torch.geometry.se3 import se3_compose
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.models.two_view import TwoViewEstimator
    from tinyslam_tpu_torch.models.vo import VisualOdometry, _match_to_map, _reloc_attempt
    from tinyslam_tpu_torch.models.vo_device import SUMMARY_FIELDS, DeviceVO, VOState
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda
    from tinyslam_tpu_torch.utils.draws import Sampler
    from tinyslam_tpu_torch.utils.evaluation import ate_rmse

    class LoggingSampler(Sampler):
        """Sampler(0) that records each draw's stream and K2's launch count
        when it was drawn."""

        def __init__(self):
            super().__init__(0)
            self.log = []             # (key, K2 launches so far)

        def uniform(self, shape, device, key=None):
            self.log.append((key, match_cuda.LAUNCHES))
            return super().uniform(shape, device, key)

    def clone_sampler(state):
        out = Sampler()
        out.generator.set_state(state)
        return out

    def sync_ms(fn):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t_start) * 1e3

    cfg = SlamConfig() if cfg is None else cfg
    col = {name: i for i, name in enumerate(SUMMARY_FIELDS)}
    gt = _centres([p[0] for p in poses], [p[1] for p in poses])
    blank = np.zeros_like(frames[0])
    failures = []

    # The plain track_chunk on the card: its draws and launch counters are
    # Python calls per attempt, which 8d and 8g read (a replay makes none);
    # phase 17 runs this same script through the captured graph.
    sampler = LoggingSampler()
    vo = DeviceVO(cfg, cam, chunk=CHUNK, device=dev, sampler=sampler, graph=False)
    script = []                   # ("feed", orbit index or None) / ("flush",) / ("force",)
    fed, host_ms = [], []         # orbit index of each frame fed (None: blank)
    calls = []                    # per process call: (K2 launches, log length) before it
    boot = []                     # global frames where a bootstrap succeeded
    boot_pair = None              # the first bootstrap's two views and draws

    def flush():
        script.append(("flush",))
        vo.flush()

    def force():
        script.append(("force",))
        vo.force_reloc = True

    def feed(i):
        nonlocal boot_pair
        script.append(("feed", i))
        fed.append(i)
        image = frames[i] if i is not None else blank
        calls.append((match_cuda.LAUNCHES, len(sampler.log)))
        if vo.initialized:
            vo.process(image)
            return
        draws = sampler.generator.get_state()
        _, ms = sync_ms(lambda: vo.process(image))
        host_ms.append((len(fed) - 1, ms))
        if vo.initialized:
            boot.append(len(fed) - 1)
            if boot_pair is None:
                boot_pair = (vo._host.kf0_feats, vo._host.kf_feats, draws)

    def per_attempt(kind):
        """(frame fed, key, K2 launches) for each attempt of ``kind``
        ("two_view" or "reloc"): the launches before its draw since the
        start of the process call (or flush) it fell in, or since the
        attempt before it there.  A two-view attempt draws E
        after its match, then H; a relocalization attempt matches, then
        draws.  Counted from the draws and the counters only."""
        out = []
        ends = [lo for _, lo in calls[1:]] + [len(sampler.log)]
        for c, ((k2_start, lo), hi) in enumerate(zip(calls, ends)):
            prev = k2_start
            for key, k2 in sampler.log[lo:hi]:
                if key[0] == "reloc" or key[-1] == "E":
                    if key[0] == kind:
                        out.append((c, key, k2 - prev))
                    prev = k2
        return out

    torch.cuda.synchronize()
    fast_cuda.LAUNCHES = 0
    match_cuda.LAUNCHES = 0
    dupband_cuda.LAUNCHES = 0
    # a, b, d: bootstrap, tracking to frame 100, a forced relocalization.
    for i in range(RELOC_FRAME):
        feed(i)
    flush()
    snap_reloc = VOState.from_numpy(vo.state.to_numpy(), dev) if vo.initialized else None
    gen_reloc = sampler.generator.get_state()
    force()
    n_calls = len(calls)
    for i in range(RELOC_FRAME, N_BOOT_FRAMES):
        feed(i)
    flush()
    reloc_keys = [k for k, _ in sampler.log[calls[n_calls][1]:]
                  if k[0] == "reloc" and int(k[1]) == RELOC_FRAME]
    main_stats, main_pos = list(vo.stats), vo.positions.copy()
    # e: the kidnap.
    kid = N_BOOT_FRAMES - 1 + KIDNAP_STEPS
    snap_kid = VOState.from_numpy(vo.state.to_numpy(), dev)
    gen_kid = sampler.generator.get_state()
    force()
    feed(kid)
    flush()
    kid_stat = vo.stats[-1]
    for i in range(kid + 1, kid + 11):
        feed(i)
    flush()
    # f: blank frames, the reboot, a second submap.
    last_tracked = max(j for j, st in enumerate(vo.stats) if st.tracking)
    for _ in range(N_BLANK):
        feed(None)
    reboot_at = len(fed) - 1
    for i in range(kid + 11, len(frames)):
        feed(i)
    flush()
    torch.cuda.synchronize()
    launches = {"fast_score_map_fused": fast_cuda.LAUNCHES,
                "match_reduce_streaming": match_cuda.LAUNCHES,
                "dup_band": dupband_cuda.LAUNCHES}
    run = _run_record(vo, launches, script=script)
    attempts = per_attempt("two_view")
    reloc_attempts = per_attempt("reloc")
    # The forced relocalizations (frames 60 and 101 of the first submap)
    # open their chunk, so their counts are theirs alone.
    forced = [n for c, key, n in reloc_attempts
              if c < reboot_at and int(key[1]) in (RELOC_FRAME, N_BOOT_FRAMES)]

    # a. The bootstrap.
    if not boot or boot[0] >= BOOT_BUDGET:
        raise AssertionError(f"phase 8: no bootstrap within {BOOT_BUDGET} frames "
                             f"(attempts at {[c for c, _, _ in attempts]})")
    b0 = boot[0]
    # The winning attempt again, from the same two views and the same draws.
    two_view = TwoViewEstimator(cam, cfg.matcher, cfg.ransac)
    won = two_view.estimate(boot_pair[0], boot_pair[1], clone_sampler(boot_pair[2]), b0)
    first = [c for c, _, _ in attempts if c <= b0]
    att_ms = [ms for f, ms in host_ms if 3 <= f <= b0]
    print(f"bootstrap at frame {b0}: model {won['model']}, "
          f"{int(won['num_inliers'])} inliers, {main_stats[b0].num_landmarks} landmarks; "
          f"attempts at frames {first}; host-phase ms per frame "
          f"{[round(ms, 1) for f, ms in host_ms if f <= b0]}, per attempt "
          f"{np.mean(att_ms):.1f}  [{smi}]")
    # b. Tracking from the bootstrap to frame 100.
    n_main = N_BOOT_FRAMES
    lost = [j for j in range(b0, n_main) if not main_stats[j].tracking]
    ate = ate_rmse(main_pos[BOOT_BUDGET:n_main], gt[BOOT_BUDGET:n_main])
    print(f"tracked {n_main - b0 - len(lost)}/{n_main - b0} frames after the bootstrap, "
          f"lost {lost}; {vo.num_keyframes if vo.num_reboots == 0 else '-'} keyframes; "
          f"Sim(3)-aligned ATE frames {BOOT_BUDGET}-{n_main - 1}: {ate:.4f} (JAX "
          f"reference {REF_BOOT_ATE}), from the bootstrap frame "
          f"{ate_rmse(main_pos[b0:n_main], gt[b0:n_main]):.4f}")
    if lost:
        failures.append(f"frames {lost} lost after the bootstrap")
    if REF_BOOT_ATE is None or not ate <= REF_BOOT_ATE + 0.02:
        failures.append(f"ATE {ate:.4f} > reference {REF_BOOT_ATE} + 0.02")
    # d. The forced relocalization at frame 60.
    if not reloc_keys or not main_stats[RELOC_FRAME].tracking:
        failures.append(f"frame {RELOC_FRAME}: no relocalization draw ({len(reloc_keys)}) "
                        f"or not tracked")
    print(f"forced relocalization at frame {RELOC_FRAME}: {len(reloc_keys)} attempt(s), "
          f"{main_stats[RELOC_FRAME].num_inliers} inliers, tracked "
          f"{main_stats[RELOC_FRAME].tracking}")
    # e. The kidnap.
    feats = extract_features(torch.from_numpy(frames[kid]).to(dev), snap_kid.threshold,
                             cfg.frontend)
    R_pred, t_pred = se3_compose(snap_kid.vel_R, snap_kid.vel_t, snap_kid.R, snap_kid.t)
    diag = clone_sampler(gen_kid)
    key = ("reloc", snap_kid.frame_idx)
    guided = _reloc_attempt(cam, cfg, snap_kid.map, feats, R_pred, t_pred, diag, key, True)
    globl = _reloc_attempt(cam, cfg, snap_kid.map, feats, R_pred, t_pred, diag, key, False)
    n_g, n_w = int(globl[2]["num_inliers"]), int(guided[2]["num_inliers"])
    print(f"kidnap: frame {kid} after frame {N_BOOT_FRAMES - 1} ({KIDNAP_STEPS} orbit "
          f"steps): guided attempt {n_w} inliers, global {n_g}; tracked "
          f"{kid_stat.tracking} with {kid_stat.num_inliers} inliers")
    if not (n_w < 20 and n_g >= 20 and kid_stat.tracking):
        failures.append("kidnap not re-acquired by the global fallback")
    # The same two attempts for other jumps, and the whole relocalization
    # frame from the same state, as tools/jax_reference_orbit.py --bootstrap
    # --kidnap runs the reference.
    sweep = {}
    lost_kid = snap_kid.replace(last_tracking=torch.zeros((), dtype=torch.bool, device=dev))
    for jump in range(2, 2 * KIDNAP_STEPS + 1, 2):
        img = torch.from_numpy(frames[N_BOOT_FRAMES - 1 + jump]).to(dev)
        fj = extract_features(img, snap_kid.threshold, cfg.frontend)
        diag = clone_sampler(gen_kid)
        sweep[jump] = tuple(int(_reloc_attempt(cam, cfg, snap_kid.map, fj, R_pred, t_pred,
                                                  diag, key, g)[2]["num_inliers"])
                            for g in (True, False))
        _, ys = vd.track_step(cam, cfg, lost_kid, img, clone_sampler(gen_kid))
        sweep[jump] += (bool(ys["summary"][col["tracking"]] > 0),)
    print(f"kidnap sweep, orbit steps -> (guided inliers, global inliers, tracked): {sweep}")
    # f. The reboot.
    ev = vo.submap_events
    second = [j for j in boot if j > reboot_at]
    print(f"reboot: {vo.num_reboots} reboot(s), events "
          f"{[(e['frame'], np.round(e['base'][1], 4).tolist()) for e in ev]}; second "
          f"bootstrap at frame {second[0] if second else None}")
    if not (vo.num_reboots == 1 and len(ev) == 1 and ev[0]["frame"] == reboot_at
            and np.allclose(ev[0]["base"][0], vo.trajectory[last_tracked][0])
            and np.allclose(ev[0]["base"][1], vo.trajectory[last_tracked][1]) and second):
        failures.append("the reboot or the second bootstrap failed")
    else:
        idx = np.arange(second[0], len(fed))
        orbit_idx = np.array([fed[j] for j in idx])
        tracked2 = [vo.stats[j].tracking for j in idx]
        print(f"second submap: {sum(tracked2)}/{len(idx)} frames tracked, Sim(3)-aligned "
              f"ATE {ate_rmse(vo.positions[idx], gt[orbit_idx]):.4f}")
    # g. Launch counters.
    print("launches during phase 8:", launches, f"for {len(fed)} frames "
          f"({vo.host_frames} on the host path); K2 per bootstrap attempt "
          f"{[n for _, _, n in attempts]}, per relocalization attempt "
          f"{[n for _, _, n in reloc_attempts]} (the forced ones {forced})")
    if launches["fast_score_map_fused"] != len(fed):
        failures.append(f"K1 launched {launches['fast_score_map_fused']} times, expected "
                        f"{len(fed)} (one a frame)")
    if (not attempts or min(n for _, _, n in attempts) < 1 or not reloc_attempts
            or min(n for _, _, n in reloc_attempts) < 1 or len(forced) < 2
            or min(forced) < 1):
        failures.append("a bootstrap or relocalization attempt launched no K2")

    # c. The same draws on the CPU plain path: bootstrap and 16 frames.
    cpu = DeviceVO(cfg, cam, chunk=CHUNK, device="cpu", sampler=Sampler(0))
    for i in range(b0 + N_CPU_BOOT + 1):
        cpu.process(frames[i])
    cpu.flush()
    span = slice(b0, b0 + N_CPU_BOOT + 1)
    dpos = float(np.abs(cpu.positions[span] - main_pos[span]).max())
    same = (cpu.host_frames == b0 + 1
            and cpu.stats[b0].num_landmarks == main_stats[b0].num_landmarks)
    print(f"card vs CPU plain path: bootstrap frame {cpu.host_frames - 1} vs {b0}, "
          f"landmarks {cpu.stats[b0].num_landmarks} vs {main_stats[b0].num_landmarks}; "
          f"max centre diff over frames {b0}-{b0 + N_CPU_BOOT}: {dpos:.2e}")
    if not (same and dpos < 2e-3):
        failures.append("card and CPU plain path disagree")

    # Costs, with a synchronize after each, from the snapshots.
    lost_state = lambda s: s.replace(last_tracking=torch.zeros(  # noqa: E731
        (), dtype=torch.bool, device=dev))
    img60 = torch.from_numpy(frames[RELOC_FRAME]).to(dev)
    img_kid = torch.from_numpy(frames[kid]).to(dev)
    reloc_frame = lambda: vd.track_step(cam, cfg, lost_state(snap_reloc), img60,  # noqa: E731
                                        clone_sampler(gen_reloc))
    kid_frame = lambda: vd.track_step(cam, cfg, lost_state(snap_kid), img_kid,  # noqa: E731
                                      clone_sampler(gen_kid))
    plain_frame = lambda: vd.track_step(cam, cfg, snap_reloc, img60,  # noqa: E731
                                        clone_sampler(gen_reloc))
    syncs = {}
    for name, fn in (("plain", plain_frame), ("reloc", reloc_frame), ("kidnap", kid_frame)):
        fn()                                                 # warm-up
        (_, ys), syncs[name] = _with_sync_count(fn)
        syncs[name] = (syncs[name], bool(ys["summary"][col["is_keyframe"]] > 0))
    ms = {name: np.mean([sync_ms(fn)[1] for _ in range(5)])
          for name, fn in (("plain", plain_frame), ("reloc", reloc_frame),
                           ("kidnap", kid_frame))}
    f60 = extract_features(img60, snap_reloc.threshold, cfg.frontend)
    R_pred, t_pred = se3_compose(snap_reloc.vel_R, snap_reloc.vel_t, snap_reloc.R,
                                 snap_reloc.t)
    idx, mvalid = _match_to_map(f60, snap_reloc.map, cfg.matcher.max_distance,
                                cfg.matcher.ratio, cam=cam, R=R_pred, t=t_pred,
                                radius_px=64.0)
    sample = Sampler(1).choice(mvalid, (cfg.vo.reloc_hypotheses, 6))
    X = snap_reloc.map.X[idx.long()]
    ransac_ms = np.mean([sync_ms(lambda: pnp_ransac(
        cam, X, f60.xy, mvalid, sample, inlier_px=cfg.vo.pnp_inlier_px,
        refine_iters=cfg.vo.pnp_iters, R_prior=R_pred, t_prior=t_pred))[1]
        for _ in range(5)])
    two_view_ms = np.mean([sync_ms(lambda: two_view.estimate(
        boot_pair[0], boot_pair[1], clone_sampler(boot_pair[2]), b0))[1] for _ in range(3)])
    host = VisualOdometry(cfg, cam, device=dev, sampler=Sampler(2))
    host.map, host.win_R, host.win_t = snap_kid.map, snap_kid.win_R, snap_kid.win_t
    host.win_obs, host.win_mask = snap_kid.win_obs, snap_kid.win_mask
    host.win_valid = snap_kid.win_valid.cpu().numpy()
    host._local_ba()
    ba_ms = np.mean([sync_ms(host._local_ba)[1] for _ in range(3)])
    print(f"wall ms, synchronize after each: two-view estimate {two_view_ms:.1f}, "
          f"bootstrap attempt {np.mean(att_ms):.1f}; host _local_ba (L="
          f"{cfg.vo.max_map_points}, not compacted, {int(host.win_valid.sum())} "
          f"keyframes) {ba_ms:.1f} (at the bootstrap it returns at once: 2 keyframes); "
          f"plain frame {ms['plain']:.2f}, relocalization frame (guided) "
          f"{ms['reloc']:.2f}, with the global fallback {ms['kidnap']:.2f}; pnp_ransac "
          f"{ransac_ms:.2f}; syncs (count, keyframe) {syncs}  [{smi}]")
    for name in ("reloc", "kidnap"):
        k, is_kf = syncs[name]
        if k > 4 + int(is_kf):
            failures.append(f"{name} frame: {k} syncs > {4 + int(is_kf)}")
    if failures:
        raise AssertionError("bootstrap phase: " + "; ".join(failures))
    return launches, reloc_frame, run


def _moved(a, device):
    """A tensor, or a dataclass of tensors (Features, MapState), on
    ``device``; anything else as it is."""
    import dataclasses

    import torch

    if isinstance(a, torch.Tensor):
        return a.to(device)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        return type(a)(**{f.name: _moved(getattr(a, f.name), device)
                          for f in dataclasses.fields(a)})
    return a


class _FirstAssembly:
    """While entered, keeps the inputs (plan, values) of the first
    order-fixed scatter the pose graph makes (its normal equations), for
    the kernel's checks and times at the main path's shape."""

    def __enter__(self):
        from tinyslam_tpu_torch.backend import pose_graph

        self.mod, self.real, self.first = pose_graph, pose_graph.ordered_scatter_add, None

        def first(plan, vals):
            if self.first is None:
                self.first = (plan, vals.clone())
            return self.real(plan, vals)

        pose_graph.ordered_scatter_add = first
        return self

    def __exit__(self, *exc):
        self.mod.ordered_scatter_add = self.real
        return False


def _assembly_check(label: str, first, smi) -> tuple:
    """The assembly kernel on the main path's inputs ``first`` (plan,
    values) against its plain version, ``index_add_`` on the CPU: bit-equal.
    Returns (label, kernel call, plain call, library call, bytes, terms,
    longest segment) for phase 7: the plain call is the kernel's order in
    PyTorch on the card (``ordered_scatter_segments``), the library call
    one ``index_add_`` on the card (atomics)."""
    import torch

    from tinyslam_tpu_torch.ops import scatter_cuda

    plan, vals = first
    got = scatter_cuda.ordered_scatter_add(plan, vals)
    want = scatter_cuda.ordered_scatter_add(
        scatter_cuda.scatter_plan(plan.at.cpu(), plan.size), vals.cpu())
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"assembly {label}: the kernel differs from index_add_ on the CPU "
                             f"by {float((got.cpu() - want).abs().max())}")
    plain = lambda: scatter_cuda.ordered_scatter_segments(plan.at, plan.size, vals)  # noqa: E731
    library = lambda: torch.zeros(plan.size, dtype=vals.dtype,  # noqa: E731
                                  device=vals.device).index_add_(0, plan.at, vals)
    if not torch.equal(plain(), got):
        raise AssertionError(f"assembly {label}: the kernel differs from its order in PyTorch")
    atomics = float((library().cpu() - want).abs().max())
    m = int(round((-1 + (1 + 4 * plan.size) ** 0.5) / 2))
    count = plan.ptr[1:] - plan.ptr[:-1]
    longest, hit = int(count.max()), int((count > 0).sum())
    # The terms and their sorted positions, the segment ends of the slots
    # that hold a term (and the first start), H and g: what this run needs.
    nbytes = (vals.numel() * (vals.element_size() + 4) + (hit + 1) * 4
              + plan.size * vals.element_size())
    print(f"assembly kernel {label}: {vals.numel()} terms into H ({m}x{m}) and g, {hit} slots "
          f"hit, longest segment {longest} terms; bit-equal to index_add_ on the CPU; "
          f"index_add_ on the card (atomics) differs by {atomics:.3g}  [{smi}]")
    return (f"assembly {label}", lambda: scatter_cuda.ordered_scatter_add(plan, vals), plain,
            library, nbytes, vals.numel(), longest)


def _eager_first_assembly(cfg, snap, dev):
    """The first assembly's inputs (plan, values) of the solve of ``snap``
    (padded as ``solve_graph`` pads it), from its eager run on ``dev``: a
    captured solve's replay makes no Python call to intercept, and runs the
    same kernels on the same inputs."""
    from tinyslam_tpu_torch.models import slam as sm

    with _FirstAssembly() as assembly:
        sm.solve_graph(cfg, snap, dev, eager=True)
    return assembly.first


def _chain_assembly(nodes: int, dev):
    """The first assembly's inputs (plan, values) of a solve of
    ``tools/profile_pose_graph.py``'s chain of ``nodes`` keyframes under
    ``SlamConfig()``, padded as ``solve_graph`` pads it."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import profile_pose_graph

    from tinyslam_tpu_torch import SlamConfig

    return _eager_first_assembly(SlamConfig(), profile_pose_graph.snapshot(nodes), dev)


def _kept(a):
    """A stage's argument as it was at the call: tensors, the features and
    the map cloned, arrays and lists copied (the caller goes on to change
    its own), anything else as it is."""
    import dataclasses

    import torch

    from tinyslam_tpu_torch.models.vo import MapState
    from tinyslam_tpu_torch.types import Features

    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, np.ndarray):
        return a.copy()
    if isinstance(a, (list, tuple)):
        return type(a)(_kept(x) for x in a)
    if isinstance(a, (Features, MapState)):
        return type(a)(**{f.name: getattr(a, f.name).clone() for f in dataclasses.fields(a)})
    return a


_PROBE_INTS = ("n_appear", "n_chain", "num_inliers", "n_scale_pairs", "n_scale_old",
               "n_scale_new")


_PNP_COUNTS = ("num_inliers", "n_scale_pairs", "n_scale_old")   # read off the PnP pose


def _ransac_start(args, c) -> dict:
    """Candidate ``c``'s RANSAC pool on the probe's device, rebuilt from
    the probe's inputs as ``models/slam.py:_loop_probe`` builds it (the
    chain, its keyed draws, ``pnp_ransac``'s DLT hypotheses and the
    odometry prior): the most chain matches one of them explains within
    the inlier threshold, which are finite, and whether the first in the
    vote's order is finite (where no refined pose gains an inlier, the
    refinement of that one wins)."""
    import torch

    from tinyslam_tpu_torch.geometry import pnp
    from tinyslam_tpu_torch.models import slam as sm
    from tinyslam_tpu_torch.ops.hamming import match_descriptors

    cam, cfg, cur, old, old_ids, old_X, old_ok, _, _, R_cur, t_cur, kf_id, sampler = args
    dev = cur.desc.device
    kw = sm._probe_params(cfg)
    T = lambda a, dtype=np.float32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype)).to(dev)
    o = old.map(lambda x: x[c])
    m = match_descriptors(cur.desc, cur.valid, o.desc, o.valid, max_distance=kw["max_distance"],
                          ratio=kw["ratio"], cross_check=True)
    ib = m["idx_b"].long()
    X = T(old_X[c])[ib]
    chain = m["valid"] & T(old_ok[c], np.bool_)[ib]
    sample = sampler.choice(chain, (kw["num_hypotheses"], 6),
                            key=("loop", int(kf_id) * 131 + int(old_ids[c])))
    Rs, ts = pnp._dlt_pose(cam, X[sample], cur.xy[sample],
                           torch.ones(sample.shape, device=dev))
    Rs, ts = torch.cat([Rs, T(R_cur)[None]]), torch.cat([ts, T(t_cur)[None]])
    err, z = pnp._project_err(cam, Rs, ts, X, cur.xy)
    votes = (chain & (z > 1e-4) & (err < kw["inlier_px"])).sum(-1)
    first = int(torch.sort(votes, descending=True, stable=True).indices[0])
    finite = torch.isfinite(Rs).all((-2, -1)) & torch.isfinite(ts).all(-1)
    return {"max_vote": int(votes.max()), "finite": finite.cpu().numpy(),
            "first_finite": bool(finite[first])}


def _probe_against_cpu(args, rows, cfg) -> tuple[bool, int, str]:
    """A probe's card rows against the CPU plain path on the same inputs
    with the same draws (phase 9b's check): every count equal, but for the
    counts read off the PnP pose (``_PNP_COUNTS``) at a degenerate
    candidate; over the candidates the inlier gate can pass, pose and the
    float fields within 2e-3.

    A candidate is degenerate where card and CPU both reject it at the
    inlier gate (the accept decision stays exact) and no DLT hypothesis
    nor the odometry prior explains a single chain match on either
    device (``_ransac_start``): the null vectors of such minimal samples
    are decided by rounding, and refining them may leave an inlier or
    none.  The card's pose there must be finite, or be the NaN that
    ``_dlt_pose`` gives a degenerate sample: no inlier, and the first
    hypothesis of the vote's order (whose refinement then wins) NaN.
    Phase 9's first probe: 78 chain matches, 0 inliers on the
    card and 1 on the CPU, the card's pose that NaN.  Returns (agrees,
    candidates at the gate, a line)."""
    from tinyslam_tpu_torch.models import slam as sm

    cpu_args = _moved_all(args, "cpu")
    got = sm.unpack_probe(sm.loop_probe(*cpu_args))
    card = sm.unpack_probe(rows)
    gate = cfg.pose_graph.loop_min_matches
    exact = all(np.array_equal(got[k], card[k]) for k in _PROBE_INTS)
    witnessed, notes = set(), []
    for c in range(len(card["num_inliers"])):
        if all(got[k][c] == card[k][c] for k in _PNP_COUNTS):
            continue
        rejected = max(card["num_inliers"][c], got["num_inliers"][c]) < gate
        on_card, on_cpu = _ransac_start(args, c), _ransac_start(cpu_args, c)
        degenerate = on_card["max_vote"] == 0 and on_cpu["max_vote"] == 0
        finite = bool(np.isfinite(card["R"][c]).all() and np.isfinite(card["t"][c]).all())
        by_design = (not finite and card["num_inliers"][c] == 0
                     and not on_card["first_finite"])
        if rejected and degenerate and (finite or by_design):
            witnessed.add(c)
        split = np.nonzero(on_card["finite"] != on_cpu["finite"])[0]
        notes.append(
            f"candidate {c}: num_inliers card {int(card['num_inliers'][c])}, CPU "
            f"{int(got['num_inliers'][c])}; both rejected at the gate {gate} {rejected}; most "
            f"chain matches a hypothesis or the prior explains, card {on_card['max_vote']}, CPU "
            f"{on_cpu['max_vote']}; finite hypotheses card {int(on_card['finite'].sum())}, CPU "
            f"{int(on_cpu['finite'].sum())} of {len(on_card['finite'])}, finite on one side "
            f"only {split.tolist()}; card pose "
            f"finite {finite}, else the NaN of its first hypothesis {by_design}; degenerate, "
            f"counts exempt {c in witnessed}")
    keep = np.array([c not in witnessed for c in range(len(card["num_inliers"]))])
    same = all(np.array_equal(got[k], card[k]) if k not in _PNP_COUNTS
               else np.array_equal(got[k][keep], card[k][keep]) for k in _PROBE_INTS)
    used = card["num_inliers"] >= gate
    pose = np.concatenate([card["R"].reshape(len(used), -1), card["t"]], 1)[used]
    pose_cpu = np.concatenate([got["R"].reshape(len(used), -1), got["t"]], 1)[used]
    dp = float(np.abs(pose - pose_cpu).max()) if used.any() else 0.0
    rel = {}
    for k in ("rmse", "s_e", "s_e_med"):
        a, b = card[k][used].astype(np.float64), got[k][used].astype(np.float64)
        both_nan = np.isnan(a) & np.isnan(b)
        r = np.abs(a - b) / np.maximum(np.abs(b), 1e-6)
        rel[k] = float(np.where(both_nan, 0.0, np.nan_to_num(r, nan=np.inf)).max(initial=0.0))
    cpu = "" if exact else f" (CPU { {k: got[k].astype(int).tolist() for k in _PROBE_INTS} })"
    said = (f"counts equal {exact}, equal but at degenerate candidates {same}: "
            f"{ {k: card[k].astype(int).tolist() for k in _PROBE_INTS} }{cpu}"
            f"{''.join('; ' + n for n in notes)}; over the {int(used.sum())} candidate(s) at the "
            f"inlier gate: max pose diff {dp:.2e}, max relative diff "
            f"{({k: f'{v:.2e}' for k, v in rel.items()})}")
    return same and dp < 2e-3 and max(rel.values()) < 2e-3, int(used.sum()), said


def _moved_all(args, device):
    return tuple(_moved(a, device) for a in args)


def _slam_phase(cam, poses, frames, dev, smi, cfg=None, n=N_SLAM):
    """Phase 9: Sim(3) loop closure (``slam_config()`` unless ``cfg``) on
    the out-and-back of the orbit's first ``n`` frames.  Returns the
    kernels' launch counts of the DeviceSlam run, a callable that runs
    the first graph solve again (timed in phase 7), or None, and the first
    assembly's inputs (plan, values)."""
    import re

    import torch

    from tinyslam_tpu_torch.models import slam as sm
    from tinyslam_tpu_torch.models.slam import DeviceSlam, Slam
    from tinyslam_tpu_torch.models.vo_device import DeviceVO
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda, scatter_cuda
    from tinyslam_tpu_torch.utils.draws import Sampler
    from tinyslam_tpu_torch.utils.evaluation import ate_rmse

    cfg = slam_config() if cfg is None else cfg
    dev = torch.device(dev)
    seq = out_and_back(n)
    images = [frames[i] for i in seq]
    gt = _centres([poses[i][0] for i in seq], [poses[i][1] for i in seq])
    C = max(2, cfg.pose_graph.loop_candidates)
    failures = []

    def run_timed(step, finish, ims):
        """Feed the frames; per-frame wall seconds on the host clock (the
        chunked trackers read back at chunk boundaries), the finish
        (flush or finalize) added to the last."""
        secs = []
        torch.cuda.synchronize()
        for im in ims:
            t_start = time.perf_counter()
            step(im)
            secs.append(time.perf_counter() - t_start)
        t_start = time.perf_counter()
        finish()
        torch.cuda.synchronize()
        secs[-1] += time.perf_counter() - t_start
        return np.array(secs)

    def fps(secs, start):
        return (len(secs) - start) / secs[start:].sum()

    # The tracker alone: its bootstrap frame and tracked fps.
    vo = DeviceVO(cfg, cam, chunk=CHUNK, device=dev, sampler=Sampler(0))
    vo_secs = run_timed(vo.process, vo.flush, images)
    b_vo = vo.host_frames - 1
    warm = b_vo + 1 + CHUNK         # after the bootstrap and a warm-up chunk

    # a. DeviceSlam, instrumented: K2 and wall ms per ingest, probe and
    # solve, syncs per tracked frame and per chunk sync; the first probe's
    # inputs and draws and the first solve's snapshot are kept for b.
    calls = {"kf_ingest": [], "loop_probe": [], "solve_graph": []}
    records = {k: [] for k in calls}        # (arguments, output) of every stage call
    frame_syncs, chunk_syncs = [], []
    real = {k: getattr(sm, k) for k in calls}

    def counted(name):
        def wrapper(*args):
            k2 = match_cuda.LAUNCHES
            t_start = time.perf_counter()
            out = real[name](*args)           # one replay and the readback
            calls[name].append((match_cuda.LAUNCHES - k2,
                                (time.perf_counter() - t_start) * 1e3))
            records[name].append((_kept(args), out))
            return out
        return wrapper

    slam = DeviceSlam(cfg, cam, chunk=CHUNK, device=dev, sampler=Sampler(0))
    real_sync = slam._sync_chunk
    real_process = slam.vo.process

    def process_counted(image):
        # A tracked frame's syncs: none while its chunk fills, the chunk's
        # one readback where it dispatches the chunk (the captured graph
        # tracks the chunk there); the SLAM layer's sync is counted apart.
        if not slam.vo.initialized:
            return real_process(image)
        out, k = _with_sync_count(lambda: real_process(image))
        frame_syncs.append(k)
        return out

    def sync_counted():
        slam.vo._dispatch()           # a partial chunk's frames count as frames
        chunk_syncs.append(_with_sync_count(real_sync)[1])

    slam._sync_chunk = sync_counted
    slam.vo.process = process_counted
    for k in real:
        setattr(sm, k, counted(k))
    try:
        torch.cuda.synchronize()
        fast_cuda.LAUNCHES = 0
        match_cuda.LAUNCHES = 0
        dupband_cuda.LAUNCHES = 0
        scatter_cuda.LAUNCHES = 0
        slam_secs = run_timed(slam.process_frame, slam.finalize, images)
        torch.cuda.synchronize()
        launches = {"fast_score_map_fused": fast_cuda.LAUNCHES,
                    "match_reduce_streaming": match_cuda.LAUNCHES,
                    "ordered_scatter_add": scatter_cuda.LAUNCHES,
                    "dup_band": dupband_cuda.LAUNCHES}
    finally:
        for k, f in real.items():
            setattr(sm, k, f)
    stats = slam.vo.stats
    b0 = slam.vo.host_frames - 1
    n_kf = len(slam.kf_R)
    ate = ate_rmse(slam.positions[b0:], gt[b0:])
    raw_ate = ate_rmse(slam.raw_positions[b0:], gt[b0:])
    lost = [j for j in range(b0, len(seq)) if not stats[j].tracking]
    print(f"phase 9: {len(seq)} frames (orbit 0..{n - 1}..0), bootstrap at frame {b0} "
          f"(DeviceVO alone {b_vo}); {n_kf} keyframes at frames "
          f"{sorted(slam.kf_frame_of.values())}; lost {lost}; "
          f"{len(calls['loop_probe'])} probes; candidates (kf, old, n_appear, n_chain, "
          f"inliers, rmse, s_e, pairs, s_e_med, accepted) "
          f"{[(r['kf'], r['old'], r['n_appear'], r['n_chain'], r['num_inliers'], round(r['rmse'], 3), round(r['s_e'], 4), r['n_scale_pairs'], round(r['s_e_med'], 4), r['accepted']) for r in slam.loop_log]}")
    print(f"phase 9: {slam.num_loop_closures} closures accepted; edges (i, j, s, w) "
          f"{[(i, j, round(s_, 4), w) for i, j, _, _, s_, w in slam.edges if j != i + 1]}; "
          f"Sim(3)-aligned ATE from the bootstrap frame: corrected {ate:.4f}, raw "
          f"{raw_ate:.4f} (JAX reference {REF_SLAM_ATE}, {REF_SLAM_CLOSURES} closures)")
    if not b0 < BOOT_BUDGET:
        failures.append(f"no bootstrap within {BOOT_BUDGET} frames ({b0})")
    if REF_SLAM_CLOSURES is None or slam.num_loop_closures < REF_SLAM_CLOSURES:
        failures.append(f"{slam.num_loop_closures} closures < reference {REF_SLAM_CLOSURES}")
    if not (n_kf == slam.vo.num_keyframes == len(slam.kf_store)) or not all(
            0 <= i < n_kf and 0 <= j < n_kf and s_ > 0 and w > 0
            for i, j, _, _, s_, w in slam.edges):
        failures.append("keyframe tables or edges inconsistent")
    if REF_SLAM_ATE is None or not ate <= REF_SLAM_ATE + 0.02:
        failures.append(f"ATE {ate:.4f} > reference {REF_SLAM_ATE} + 0.02")
    # K1 once a frame; K2 once an ingest, 1 + C times a probe (each a
    # replay of its captured program), the rest on the tracking path (at
    # least once a tracked frame).
    k2_ingest = [k for k, _ in calls["kf_ingest"]]
    k2_probe = [k for k, _ in calls["loop_probe"]]
    k2_track = launches["match_reduce_streaming"] - sum(k2_ingest) - sum(k2_probe)
    print(f"launches during phase 9a: {launches}; K2 = tracking {k2_track} + ingests "
          f"{k2_ingest} + probes {k2_probe} (1 + {C} each)")
    if launches["fast_score_map_fused"] != len(seq):
        failures.append(f"K1 launched {launches['fast_score_map_fused']} times, expected "
                        f"{len(seq)} (one a frame)")
    if (set(k2_ingest) != {1} or len(k2_ingest) != n_kf or set(k2_probe) != {1 + C}
            or k2_track < len(seq) - b0 - 1):
        failures.append("K2 launches do not add up")
    # The assembly kernel: one launch a Gauss-Newton iteration of a solve.
    n_solves = len(calls["solve_graph"])
    if not 0 < launches["ordered_scatter_add"] == n_solves * cfg.pose_graph.gn_iters:
        failures.append(f"the assembly kernel launched {launches['ordered_scatter_add']} "
                        f"times for {n_solves} solves of {cfg.pose_graph.gn_iters} iterations")
    # A tracked frame syncs at most 3 times, 4 on a keyframe, one more after
    # a lost frame.
    fs = np.array(frame_syncs)
    dev_stats = stats[b0 + 1:]
    if slam.vo.num_reboots or len(fs) != len(dev_stats):
        failures.append(f"{len(fs)} tracked steps for {len(dev_stats)} frames "
                        f"({slam.vo.num_reboots} reboots)")
    else:
        is_kf = np.array([s_.is_keyframe for s_ in dev_stats])
        after_lost = np.array([not stats[b0 + i].tracking for i in range(len(dev_stats))])
        late = np.arange(len(fs)) >= CHUNK          # after the warm-up chunk
        over = np.flatnonzero(late & (fs > 3 + is_kf + after_lost))
        if len(over):
            failures.append(f"frames {(b0 + 1 + over).tolist()} sync too often "
                            f"({fs[over].tolist()})")
        plain = late & ~is_kf & ~after_lost
        print(f"syncs per tracked frame: plain {sorted(set(fs[plain].tolist()))}, keyframe "
              f"{sorted(set(fs[late & is_kf].tolist()))} (warm-up frames {b0 + 1}-"
              f"{b0 + CHUNK}: {fs[~late].tolist()}); the SLAM layer's per chunk sync "
              f"{chunk_syncs}")
    # The same frames again without the counters, the solver warm: the
    # stage times and the tracked fps set against DeviceVO's.
    warm_slam = DeviceSlam(cfg, cam, chunk=CHUNK, device=dev, sampler=Sampler(0))
    ws_secs = run_timed(warm_slam.process_frame, warm_slam.finalize, images)
    n_probe, n_solve = len(calls["loop_probe"]), len(calls["solve_graph"])
    t = warm_slam.timings
    per = lambda k, m: 1e3 * t.get(k, 0.0) / m if m else float("nan")  # noqa: E731
    print(f"SLAM stages, the counted run: probe ms {[round(m, 1) for _, m in calls['loop_probe']]}"
          f" (a replay and its readback), graph solve ms "
          f"{[round(m, 1) for _, m in calls['solve_graph']]}; the warm run: wall s by stage "
          f"{({k: round(v, 3) for k, v in t.items()})}, ms per ingest "
          f"{per('kf_ingest', len(warm_slam.kf_R)):.2f} (n={len(warm_slam.kf_R)}), per probe "
          f"{per('loop_probe', n_probe):.2f} (n={n_probe}), per graph solve and its "
          f"application {per('graph_solve', n_solve):.2f} (n={n_solve})  [{smi}]")
    print(f"tracked fps from frame {warm} (after the bootstrap and a warm-up chunk): "
          f"DeviceSlam {fps(ws_secs, warm):.2f} (the counted run, first solve included: "
          f"{fps(slam_secs, warm):.2f}), DeviceVO {fps(vo_secs, warm):.2f}; host-clock s "
          f"{ws_secs[warm:].sum():.3f} vs {vo_secs[warm:].sum():.3f}  [{smi}]")

    # b. The first probe, and the one that accepted the first closure, and
    # the first solve again on the CPU plain path, from the card's inputs
    # with the same draws (keyed by the seed: the same on both devices).
    closing = [r["kf"] for r in slam.loop_log if r["accepted"]][:1]
    probes = records["loop_probe"]
    replay = [i for i, (a, _) in enumerate(probes) if i == 0 or a[11] in closing]
    n_gated = 0
    for i in replay:
        ok, n_used, said = _probe_against_cpu(*probes[i], cfg)
        n_gated += n_used
        print(f"probe {i} (keyframe {probes[i][0][11]}, candidates {list(probes[i][0][4])}), "
              f"card vs CPU: {said}")
        if not ok:
            failures.append(f"probe {i} disagrees with the CPU plain path")
    if replay and not n_gated:
        failures.append("no replayed probe has a candidate at the inlier gate")
    if records["solve_graph"]:
        (_, snap, _), card = records["solve_graph"][0]
        got = sm.solve_graph(cfg, snap, "cpu")
        d = [float(np.abs(g - c).max())
             for g, c in zip(sm.unpack_solve(got), sm.unpack_solve(card))]
        print(f"first graph solve ({len(snap[0])} nodes, {len(snap[2])} edges), card vs "
              f"CPU: max diff R {d[0]:.2e}, t {d[1]:.2e}, s {d[2]:.2e}")
        if max(d) >= 2e-3:
            failures.append("the first graph solve disagrees with the CPU plain path")
    if not replay or not records["solve_graph"]:
        failures.append("no probe or no graph solve to replay")

    # c. The asynchronous back-end on the same frames, fed at once and as a
    # camera delivers them (CAMERA_HZ), each held to the reference's ATE.
    # Fed at once, the captured graph tracks faster than the worker solves:
    # tracking waits for a solve 16 frames old (``solve_lag_frames``), and
    # the frames tracked meanwhile are rescaled when it lands
    # (``Slam._landed_late``).
    def async_run(hz):
        aslam = DeviceSlam(cfg, cam, chunk=CHUNK, async_backend=True, device=dev,
                           sampler=Sampler(0))
        applied = []
        real_apply = aslam._apply_graph_result

        def apply_counted(*a):
            applied.append(len(aslam.vo.stats) + len(aslam.vo._buf))
            return real_apply(*a)

        def fed(im):
            if hz:
                time.sleep(max(0.0, t_start + fed.n / hz - time.perf_counter()))
            fed.n += 1
            aslam.process_frame(im)

        fed.n = 0
        aslam._apply_graph_result = apply_counted
        try:
            t_start = time.perf_counter()
            secs = run_timed(fed, aslam.finalize, images)
            restarts = aslam._worker.restarts
        finally:
            aslam.close()
        b = aslam.vo.host_frames - 1
        return aslam, applied, restarts, ate_rmse(aslam.positions[b:], gt[b:]), secs

    for hz in (None, CAMERA_HZ):
        aslam, applied, restarts, a_ate, a_secs = async_run(hz)
        fed_as = f"at {hz} a second" if hz else "at once"
        print(f"async back-end, frames fed {fed_as}: {aslam.num_loop_closures} closures, "
              f"solves applied after frames {applied}, watchdog restarts {restarts}, ATE "
              f"{a_ate:.4f}, tracked fps {fps(a_secs, warm):.2f}  [{smi}]")
        if (not applied or restarts or REF_SLAM_ATE is None
                or not a_ate <= REF_SLAM_ATE + 0.02):
            failures.append(f"the asynchronous back-end, frames fed {fed_as}, applied no "
                            "closure, restarted, or missed the ATE")

    # d. The host-stepped Slam on frames 0-40.
    host = Slam(cfg, cam, device=dev, sampler=Sampler(0))
    torch.cuda.synchronize()
    fast_cuda.LAUNCHES = 0
    h_secs = run_timed(host.process_frame, host.finalize, frames[:N_SLAM_HOST])
    k1_host = fast_cuda.LAUNCHES
    hs = host.vo.stats
    h_b0 = host.vo.kf_frames_log[1] if host.vo.initialized else None
    print(f"host Slam on frames 0-{N_SLAM_HOST - 1}: bootstrap at frame {h_b0} (DeviceVO "
          f"{b_vo}), tracked {sum(s_.tracking for s_ in hs)}/{len(hs)}, "
          f"{host.vo.num_keyframes} keyframes, K1 {k1_host}, wall ms per frame after the "
          f"bootstrap {1e3 * h_secs[b_vo + 1:].mean():.1f}  [{smi}]")
    if not (h_b0 == b_vo and all(s_.tracking for s_ in hs[h_b0:])
            and k1_host == N_SLAM_HOST):
        failures.append("the host Slam did not bootstrap with DeviceVO, lost a frame, or "
                        "did not launch K1 once a frame")

    # e. The command line, in a process of its own.
    extra = [] if dev.type == "cuda" else ["--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m", "tinyslam_tpu_torch.run", "--dataset",
                           "synthetic", "--frames", str(N_CLI_FRAMES)] + extra,
                          capture_output=True, text=True, timeout=600)
    line = re.search(r"^frames=.*$", proc.stdout, re.M)
    ate_line = re.search(r"^ATE.*$", proc.stdout, re.M)
    print(f"command line: exit {proc.returncode}; {line.group(0) if line else '-'}; "
          f"{ate_line.group(0) if ate_line else '-'}  [{smi}]")
    if proc.returncode != 0 or not line:
        failures.append(f"the command line failed: {proc.stderr[-2000:]}")
    if failures:
        raise AssertionError("SLAM phase: " + "; ".join(failures))
    first = _eager_first_assembly(cfg, records["solve_graph"][0][0][1], dev)
    return launches, first, records


def _orbit():
    """(room, camera, poses) of the bench orbit at full width."""
    from tinyslam_tpu_torch.data.synthetic import TexturedRoom, orbit_trajectory
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera

    cam = PinholeCamera.create(fx=520.0, fy=520.0, cx=WIDTH / 2 - 0.5, cy=HEIGHT / 2 - 0.5)
    room = TexturedRoom(np.random.default_rng(3), tex_res=64, octaves=2)
    poses = orbit_trajectory(N_KF_FRAMES, radius=2.0, step=0.02, start=-0.35,
                             target=(0.0, 0.0, 2.0))
    return room, cam, poses


def _orbit_scene():
    """The orbit as ``eval_ate.render_clean`` renders it: (room, camera,
    poses, no distortion, width, height)."""
    room, cam, poses = _orbit()
    return room, cam, poses, None, WIDTH, HEIGHT


_SUMMARY = (r"^frames=(\d+) tracked=(\d+) keyframes=(\d+) landmarks=(\d+) "
            r"fps=([\d.]+) loop_closures=(\d+)$")


def _account_graphs() -> None:
    """Read back the tally of every captured tracker graph and add its
    bodies' launches to the kernels' counters now: replays that no
    ``DeviceVO`` accounts (phase 13d's timed runs, 13g's trace) would
    otherwise count in the next phase that accounts the same graph."""
    from tinyslam_tpu_torch.models import vo_device as vd

    for g in list(vd._GRAPHS.values()) + list(vd._BATCH_GRAPHS.values()):
        g.account(g.tally.tolist())


def _graph_replays() -> dict:
    """The replays of every captured graph of the process so far: the
    tracker's chunk graphs and batched graphs, the SLAM layer's programs."""
    from tinyslam_tpu_torch.models import slam as sm
    from tinyslam_tpu_torch.models import vo_device as vd

    out = {("chunk",) + k: g for k, g in vd._GRAPHS.items()}
    out.update({("batch",) + k: g for k, g in vd._BATCH_GRAPHS.items()})
    out.update({("program",) + k: p for k, p in sm._PROGRAMS.items()})
    return {k: (g, g.replays) for k, g in out.items()}


def _graphs_of_phase(label: str, before: dict, smi) -> None:
    """Print the graphs a phase replayed (kind, replays, pool bytes) and
    how many graphs the process holds; fail where a phase's samplers took
    more than one chunk graph, ingest or probe (no graph is keyed by a
    seed; a solve is one graph a padded shape)."""
    now = _graph_replays()
    used = {k: (g, n - before.get(k, (g, 0))[1]) for k, (g, n) in now.items()
            if n > before.get(k, (g, 0))[1]}
    kinds = {}
    for k, (g, n) in used.items():
        kind = k[0] if k[0] != "program" else k[1]
        kinds.setdefault(kind, []).append((n, g.captured.pool_bytes))
    held = sum(g.captured.pool_bytes for g, _ in now.values())
    print(f"{label}: graphs replayed (kind: [(replays, pool bytes)]) {kinds}; the process "
          f"holds {len(now)} captured graphs, pools {held} B at capture  [{smi}]")
    many = {kind: v for kind, v in kinds.items() if len(v) > 1 and kind != "solve"}
    if many:
        raise AssertionError(f"{label}: more than one graph of a kind: {many}")


def _stage_program(name, args, dev):
    """The captured program a stage's call replayed, and its inputs."""
    import torch

    from tinyslam_tpu_torch.models import slam as sm

    if name == "solve_graph":
        cfg, snap, _ = args
        pg = cfg.pose_graph
        tables, n = sm.padded_graph(pg, snap)
        return (sm.solve_program(pg, *sm.padded_shape(pg, n, len(snap[2])), dev),
                {k: torch.from_numpy(v) for k, v in tables.items()})
    spec = (sm._ingest_spec if name == "kf_ingest" else sm._probe_spec)(*args)
    return sm._program(*spec, args[2].desc.device), spec[3]


def _pool_allocations(cfg, snap, dev) -> str:
    """Capture the solve of ``snap`` once more, into a pool of its own,
    with the allocator's history on: every allocation made on the capture's
    stream (cuSOLVER's potrf and potrs workspaces among them) must lie in a
    segment of the graph's pool.  Returns a line, or raises."""
    import torch

    from tinyslam_tpu_torch.models import slam as sm
    from tinyslam_tpu_torch.utils.cuda_graph import capture, counters_kept, warm_checked

    pg = cfg.pose_graph
    tables, _ = sm.padded_graph(pg, snap)
    static = {k: torch.from_numpy(v).to(dev) for k, v in tables.items()}
    body = lambda: sm._solve_rows(pg.sim3, pg.gn_iters, static)  # noqa: E731
    pool = torch.cuda.graph_pool_handle()
    with counters_kept():
        warm_checked(body, dev)
        torch.cuda.memory._record_memory_history(enabled="all", context=None,
                                                 stacks="python", max_entries=1_000_000)
        try:
            capture(body, dev, (), pool=pool)
            mem = torch.cuda.memory._snapshot()
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
    default = torch.cuda.current_stream(dev).cuda_stream
    allocs = [e for e in mem["device_traces"][dev.index or 0]
              if e["action"] == "alloc" and e["stream"] != default]
    segs = [(g["address"], g["address"] + g["total_size"], tuple(g["segment_pool_id"]))
            for g in mem["segments"]]
    pools = [next((p for a, b, p in segs if a <= e["addr"] < b), None) for e in allocs]
    outside = [e["size"] for e, p in zip(allocs, pools) if p != tuple(pool)]
    line = (f"{len(allocs)} allocations on the capture's stream, {sum(e['size'] for e in allocs)}"
            f" B, {len(outside)} outside the graph's pool {tuple(pool)}")
    if not allocs or outside:
        raise AssertionError(f"the solve's capture: {line} (sizes {outside[:8]})")
    return line


def _slam_graph_phase(label, records, dev, smi, timing: bool):
    """Phase 18: the SLAM layer's captured programs (``models/slam.py``)
    against their eager runs on the card, on the inputs a run gave its
    stages (``records``: phase 9's, or phase 14's ``Sampler(0)``'s).  Every
    stage call's output (one replay and its readback) must equal the eager
    function's on the same inputs bit for bit; where a probe's do not, the
    first differing field is printed and the probe is held to phase 9b's
    check against the CPU instead.  A replay makes no sync and a stage call
    one (its readback).  With ``timing``: wall ms a call of each stage
    (host clock, synchronized) against the eager function's, the replay's
    card ms (CUDA events around replays), and the solve's capture held to
    its graph's pool.  Returns {stage: eager call} for phase 7's device
    times."""
    import torch

    from tinyslam_tpu_torch.models import slam as sm

    t_phase = time.perf_counter()
    failures = []
    for name in ("kf_ingest", "loop_probe", "solve_graph"):
        same, differ = 0, []
        for i, (args, got) in enumerate(records[name]):
            want = getattr(sm, name)(*args, eager=True)
            if np.array_equal(got, want, equal_nan=True):
                same += 1
                continue
            if name != "loop_probe":
                failures.append(f"{label} {name} {i}: the replay differs from the eager run by "
                                f"{float(np.nanmax(np.abs(got - want)))}")
                continue
            g, w = sm.unpack_probe(got), sm.unpack_probe(want)
            field = next(k for k in sm.PROBE_FIELDS
                         if not np.array_equal(g[k], w[k], equal_nan=True))
            ok, _, said = _probe_against_cpu(args, got, args[1])
            differ.append(i)
            print(f"{label} probe {i}: the replay differs from the eager run first at {field} "
                  f"({g[field].tolist()} against {w[field].tolist()}); card vs CPU: {said}")
            if not ok:
                failures.append(f"{label} probe {i}: neither bit-equal nor within phase 9b's "
                                "tolerances of the CPU")
        print(f"{label} {name}: {same} of {len(records[name])} calls bit-equal to the eager run "
              f"on the card{f', not {differ}' if differ else ''}  [{smi}]")
        if not records[name]:
            failures.append(f"{label}: no {name} call")
    # Syncs: none in a load and replay, one (the readback) in a stage call.
    for name in ("kf_ingest", "loop_probe", "solve_graph"):
        if not records[name]:
            continue
        args, _ = records[name][0]
        prog, inputs = _stage_program(name, args, dev)
        torch.cuda.synchronize()
        _, in_replay = _with_sync_count(lambda: prog(inputs))
        torch.cuda.synchronize()
        _, in_call = _with_sync_count(lambda: getattr(sm, name)(*args))
        c = prog.captured
        print(f"{label} {name} program: syncs in a load and replay {in_replay}, in a stage call "
              f"{in_call}; launches a replay (K1, K2, assembly, duplicate test) {c.base}; capture "
              f"{c.capture_s:.3f} s, instantiation {c.instantiate_s:.3f} s, pool bytes "
              f"{c.pool_bytes}; replays so far {prog.replays}  [{smi}]")
        if in_replay != 0 or in_call != 1:
            failures.append(f"{label} {name}: {in_replay} syncs in a replay, {in_call} in a call")
    pools = {}
    for key, prog in sm._PROGRAMS.items():
        pools.setdefault(key[0] == "solve", []).append(prog.captured.pool_bytes)
    print(f"{label}: {len(sm._PROGRAMS)} SLAM programs in this process; pool bytes at capture, "
          f"ingest and probe pool {pools.get(False)}, solve pool {pools.get(True)}  [{smi}]")
    eager_calls = {}
    if timing:
        for name in ("kf_ingest", "loop_probe", "solve_graph"):
            args, _ = records[name][0]
            prog, inputs = _stage_program(name, args, dev)
            stage = lambda name=name, args=args: getattr(sm, name)(*args)  # noqa: E731
            plain = lambda name=name, args=args: getattr(sm, name)(*args, eager=True)  # noqa: E731
            walls = {}
            for which, fn in (("graph", stage), ("eager", plain), ("graph", stage),
                              ("eager", plain)):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                walls.setdefault(which, []).append((time.perf_counter() - t0) / 5 * 1e3)
            prog(inputs)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(10):
                prog.captured.graph.replay()
            end.record()
            torch.cuda.synchronize()
            card = start.elapsed_time(end) / 10
            print(f"{label} {name}, wall ms a call: graph {[round(w, 3) for w in walls['graph']]}"
                  f", eager {[round(w, 3) for w in walls['eager']]}; card ms a replay {card:.3f}"
                  f"  [{smi}]")
            eager_calls[name] = (plain, min(walls["graph"]), min(walls["eager"]), card)
        (cfg, snap, _), _ = records["solve_graph"][0]
        print(f"{label} the solve's capture: {_pool_allocations(cfg, snap, dev)}")
    print(f"{label}: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    if failures:
        raise AssertionError("SLAM graph phase: " + "; ".join(failures))
    return eager_calls


def _dataset_phase(dev, smi):
    """Phase 10: the TUM and EuRoC sequences through the native loader and
    the command line, in this process.  Returns the kernels' launch counts
    of the two command-line runs."""
    import contextlib
    import io
    import re

    import torch

    from tinyslam_tpu_torch import SlamConfig, eval_ate, run
    from tinyslam_tpu_torch.data.euroc import EUROC_CAM0, EUROC_DIST, EurocSequence
    from tinyslam_tpu_torch.data.tum import FR1_DIST, FR1_INTRINSICS, TumSequence
    from tinyslam_tpu_torch.data.undistort import Undistorter
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models import DeviceSlam
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda
    from tinyslam_tpu_torch.utils.draws import Sampler
    from tinyslam_tpu_torch.utils.evaluation import ate_rmse

    def other_draws(seq, cam, n, seed):
        """The command line's run under Sampler(seed): (tracked, keyframes,
        closures, ATE)."""
        slam = DeviceSlam(SlamConfig(), cam, chunk=16, device=dev, sampler=Sampler(seed))
        for i, (_, img) in enumerate(seq.frames()):
            if i == n:
                break
            slam.process_frame(img.astype(np.float32) / 255.0)
        slam.finalize()
        vo = slam.vo
        first = next(i for i, st in enumerate(vo.stats) if st.tracking)
        gt = seq.gt_positions()
        ate = ate_rmse(vo.positions[first:len(gt)], gt[first:len(vo.positions)])
        return (sum(st.tracking for st in vo.stats), vo.num_keyframes,
                slam.num_loop_closures, round(float(ate), 4))

    failures = []
    launches = {"fast_score_map_fused": 0, "match_reduce_streaming": 0, "dup_band": 0}
    cases = (
        (TUM_SEQ, N_TUM, TumSequence, FR1_INTRINSICS, FR1_DIST,
         (REF_TUM_TRACKED, REF_TUM_KEYFRAMES, REF_TUM_CLOSURES, REF_TUM_ATE)),
        (EUROC_SEQ, N_EUROC, EurocSequence, EUROC_CAM0, EUROC_DIST,
         (REF_EUROC_TRACKED, REF_EUROC_KEYFRAMES, REF_EUROC_CLOSURES, REF_EUROC_ATE)))
    for spec, n, sequence, intrinsics, dist, ref in cases:
        kind, w, h = spec["kind"], spec["width"], spec["height"]
        # a. Render and write.
        root, secs = eval_ate.dataset_sequence(spec)
        print(f"phase 10 {kind}: {spec['frames']} frames {w}x{h} in {root.name} "
              f"({f'rendered and written in {secs:.1f} s' if secs else 'reused'})")
        # b. The loader alone: decode, then decode and undistort, after a
        # pass that brings the files into the page cache.
        seq = sequence.open(root)
        rates = {}
        for label, kw in (("warm", dict(undistort=False)), ("decode", dict(undistort=False)),
                          ("decode+undistort", {})):
            t_start = time.perf_counter()
            for i, (_, img) in enumerate(seq.frames(**kw)):
                if i == 0:
                    first = img
                if i + 1 == n:
                    break
            rates[label] = n / (time.perf_counter() - t_start)
        want = Undistorter(intrinsics, dist, h, w)(np.load(root / "frame0.npy"))
        same = first.shape == want.shape and np.array_equal(first, want)
        print(f"phase 10 {kind} loader, {n} frames: "
              + ", ".join(f"{k} {v:.1f} frames/s ({1e3 / v:.2f} ms a frame)"
                          for k, v in rates.items() if k != "warm")
              + f"; first frame equal to the rendered one undistorted: {same}  [{smi}]")
        if not same:
            failures.append(f"{kind}: the first decoded frame differs from the render")
        # c, d. The command line, in this process, on the card.
        out = eval_ate.SEQ_DIR / f"{root.name}_run"
        out.mkdir(exist_ok=True)
        argv = ["--dataset", kind, "--root", str(root), "--frames", str(n),
                "--output", str(out / "traj.txt"), "--metrics", str(out / "metrics.json")]
        if dev.type != "cuda":
            argv += ["--device", "cpu"]
        text = io.StringIO()
        torch.cuda.synchronize()
        fast_cuda.LAUNCHES = 0
        match_cuda.LAUNCHES = 0
        dupband_cuda.LAUNCHES = 0
        with contextlib.redirect_stdout(text):
            rc = run.main(argv)
        torch.cuda.synchronize()
        k1, k2 = fast_cuda.LAUNCHES, match_cuda.LAUNCHES
        launches["fast_score_map_fused"] += k1
        launches["match_reduce_streaming"] += k2
        launches["dup_band"] += dupband_cuda.LAUNCHES
        text = text.getvalue()
        m = re.search(_SUMMARY, text, re.M)
        a = re.search(r"^ATE RMSE \(Sim3\): ([\d.]+) m$", text, re.M)
        if rc != 0 or not m or not a:
            raise AssertionError(f"phase 10 {kind}: the command line exited {rc}:\n{text}")
        frames, tracked, kfs = (int(g) for g in m.groups()[:3])
        fps, closures, ate = float(m.group(5)), int(m.group(6)), float(a.group(1))
        r_tracked, r_kfs, r_closures, r_ate = ref
        lines = len((out / "traj.txt").read_text().splitlines())
        print(f"phase 10 {kind} command line: {m.group(0)}; ATE {ate} (JAX reference over "
              f"four key offsets: tracked >= {r_tracked}, keyframes >= {r_kfs}, closures >= "
              f"{r_closures}, ATE <= {r_ate}); "
              f"K1 {k1}, K2 {k2}; tracked fps {fps} against the loader's "
              f"{rates['decode+undistort']:.1f} frames/s  [{smi}]")
        # The same run under three other sets of RANSAC draws: a bootstrap
        # on these frames is a knife edge, so one run is one sample, and the
        # medians of four are held to the reference's envelope.
        cam = PinholeCamera.create(**intrinsics)
        runs = [(tracked, kfs, closures, ate)]
        runs += [other_draws(seq, cam, n, seed) for seed in (1, 2, 3)]
        med = [float(v) for v in np.median(np.array(runs, np.float64), axis=0)]
        print(f"phase 10 {kind}, (tracked, keyframes, closures, ATE) under Sampler(0) (the "
              f"command line), (1), (2), (3): {runs}; medians {med}  [{smi}]")
        if frames != n or lines != n:
            failures.append(f"{kind}: {frames} frames, {lines} trajectory lines, not {n}")
        if k1 != n:
            failures.append(f"{kind}: K1 launched {k1} times, expected {n} (one a frame)")
        if k2 < tracked:
            failures.append(f"{kind}: K2 launched {k2} times for {tracked} tracked frames")
        if not (med[0] >= r_tracked - 2 and med[1] >= r_kfs and med[2] >= r_closures
                  and med[3] <= r_ate + 0.02):
            failures.append(f"{kind}: medians (tracked, keyframes, closures, ATE) {med} "
                            f"outside the reference's envelope {ref}")
    if failures:
        raise AssertionError("dataset phase: " + "; ".join(failures))
    return launches


def _loop_phase(dev, smi):
    """Phase 14: the accuracy eval on the card, ``eval_ate.run_sequence`` on
    the fr1_loop-like sequence under four samplers.  Returns the kernels'
    launch counts of the four runs, the runs' reports (``Sampler(0)``'s
    with its ``DeviceSlam`` under "slam") and the first assembly's inputs
    of ``Sampler(0)``'s run (plan, values)."""
    import torch

    from tinyslam_tpu_torch import SlamConfig, eval_ate
    from tinyslam_tpu_torch.models import slam as sm
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda, scatter_cuda
    from tinyslam_tpu_torch.utils.draws import Sampler

    t_phase = time.perf_counter()
    spec = eval_ate.fr1_loop_spec(N_LOOP)
    root, secs = eval_ate.dataset_sequence(spec)
    print(f"phase 14: fr1_loop-like, {N_LOOP} frames {spec['width']}x{spec['height']} in "
          f"{root.name} "
          f"({f'rendered and written in {secs:.1f} s' if secs else 'reused'})  [{smi}]")
    C = max(2, SlamConfig().pose_graph.loop_candidates)
    iters = SlamConfig().pose_graph.gn_iters
    launches = {"fast_score_map_fused": 0, "match_reduce_streaming": 0, "ordered_scatter_add": 0,
                "dup_band": 0}
    real = {k: getattr(sm, k) for k in ("kf_ingest", "loop_probe", "solve_graph")}
    failures, runs, made, real_slam = [], [], [], eval_ate.DeviceSlam
    first = records = None

    def counted(name, calls, kept):
        def wrapper(*args):
            k2 = match_cuda.LAUNCHES
            out = real[name](*args)
            calls[name].append(match_cuda.LAUNCHES - k2)
            if kept is not None:
                kept[name].append((_kept(args), out))
            return out
        return wrapper

    for seed in range(4):
        calls = {k: [] for k in real}
        kept = {k: [] for k in real} if seed == 0 else None
        for k in real:
            setattr(sm, k, counted(k, calls, kept))
        eval_ate.DeviceSlam = lambda *a, **kw: made.append(real_slam(*a, **kw)) or made[-1]
        try:
            torch.cuda.synchronize()
            fast_cuda.LAUNCHES = 0
            match_cuda.LAUNCHES = 0
            dupband_cuda.LAUNCHES = 0
            scatter_cuda.LAUNCHES = 0
            t_run = time.perf_counter()
            out = eval_ate.run_sequence("fr1_loop_like", "tum", root, "slam", "device",
                                        device=dev, sampler=Sampler(seed))
            torch.cuda.synchronize()
            k1, k2, k3 = fast_cuda.LAUNCHES, match_cuda.LAUNCHES, scatter_cuda.LAUNCHES
            launches["dup_band"] += dupband_cuda.LAUNCHES
        finally:
            for k, f in real.items():
                setattr(sm, k, f)
            eval_ate.DeviceSlam = real_slam
        if seed == 0:
            out["slam"], records = made[-1], kept
            if kept["solve_graph"]:
                first = _eager_first_assembly(SlamConfig(), kept["solve_graph"][0][0][1], dev)
        made.clear()
        launches["fast_score_map_fused"] += k1
        launches["match_reduce_streaming"] += k2
        launches["ordered_scatter_add"] += k3
        ingests, probes = calls["kf_ingest"], calls["loop_probe"]
        k2_track = k2 - sum(ingests) - sum(probes)
        print(f"phase 14 Sampler({seed}), {time.perf_counter() - t_run:.1f} s: K1 {k1}, K2 "
              f"{k2} = tracking {k2_track} + {len(ingests)} ingests {sum(ingests)} + "
              f"{len(probes)} probes {sum(probes)} (1 + {C} each), assembly {k3} "
              f"({out['loop_closures']} solves of {iters} iterations)  [{smi}]")
        if out["frames"] != N_LOOP or not np.isfinite(
                [out[k] for k in ("ate_rmse_m", "ate_se3_m", "ate_raw_m", "rpe_trans_m",
                                  "rpe_rot_deg")]).all():
            failures.append(f"Sampler({seed}): {out['frames']} frames or a non-finite error")
        if k1 != N_LOOP:
            failures.append(f"Sampler({seed}): K1 launched {k1} times, expected {N_LOOP}")
        if (set(ingests) - {1} or set(probes) - {1 + C} or len(ingests) != out["keyframes"]
                or k2_track < out["tracked"]):
            failures.append(f"Sampler({seed}): K2 launches do not add up")
        if k3 != iters * out["loop_closures"]:
            failures.append(f"Sampler({seed}): the assembly kernel launched {k3} times for "
                            f"{out['loop_closures']} solves")
        runs.append(out)
    cols = ("tracked", "keyframes", "loop_closures", "ate_rmse_m")
    med = [float(v) for v in np.median([[r[k] for k in cols] for r in runs], axis=0)]
    ref = (REF_LOOP_TRACKED, REF_LOOP_KEYFRAMES, REF_LOOP_CLOSURES, REF_LOOP_ATE)
    print(f"phase 14, (tracked, keyframes, closures, ATE) under Sampler(0)-(3): "
          f"{[[r[k] for k in cols] for r in runs]}; medians {med}; the JAX reference over "
          f"four key offsets: tracked >= {ref[0]}, keyframes >= {ref[1]}, closures >= "
          f"{ref[2]}, ATE <= {ref[3]}  [{smi}]")
    if None in ref or not (med[0] >= ref[0] - 2 and med[1] >= ref[1] and med[2] >= ref[2]
                           and med[3] <= ref[3] + 0.02):
        failures.append(f"medians {med} outside the reference's envelope {ref}")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    if first is None:
        failures.append("Sampler(0)'s run solved no pose graph")
    if failures:
        raise AssertionError("loop eval phase: " + "; ".join(failures))
    return launches, runs, first, records


def _bench_phase(frames, smi):
    """Phase 16: ``tinyslam_tpu_torch.bench`` on the card, its tracked row
    on phase 2's orbit frames and its front-end row on four of them.
    Returns the kernels' launch counts of the phase."""
    import torch

    from tinyslam_tpu_torch import bench
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    fast_cuda.LAUNCHES = 0
    match_cuda.LAUNCHES = 0
    dupband_cuda.LAUNCHES = 0
    tr = bench.bench_tracked(chunk=BENCH_CHUNK, chunks_timed=BENCH_CHUNKS_TIMED, rounds=1,
                             frames=frames)
    fe = bench.bench_frontend(frames=frames[:BENCH_FE_FRAMES])
    torch.cuda.synchronize()
    launches = {"fast_score_map_fused": fast_cuda.LAUNCHES,
                "match_reduce_streaming": match_cuda.LAUNCHES,
                "dup_band": dupband_cuda.LAUNCHES}
    for row, res, fps in (("tracked", tr, tr["tracked_fps"]),
                          ("front-end", fe, fe["frontend_fps"])):
        pf = res["per_frame"]
        top = ", ".join(f"{op['name'][:48]} {op['ms']:.2f} ms x{op['calls']}"
                        for op in pf["top_device_ops"])
        busy = ("busy share not measured" if pf["busy_share"] is None
                else f"busy {100 * pf['busy_share']:.1f}% of a timed round")
        print(f"phase 16 {row}: {fps:.2f} frames/s; per frame {pf['syncs_per_frame']:.2f} "
              f"syncs, K1 {pf['k1_per_frame']:.2f}, K2 {pf['k2_per_frame']:.2f}, "
              f"{pf['device_ops_per_frame']:.0f} device operations, card busy "
              f"{pf['device_ms_per_frame']:.3f} ms profiled ({busy}); longest device "
              f"operations: {top}  [{smi}]")
    print(f"phase 16 tracked: bootstrap at frame {tr['boot_frame']}, tracked "
          f"{tr['tracked_frac']:.4f} of {tr['frames_timed']} timed frames; seconds "
          f"{ {k: round(v, 2) for k, v in tr['seconds'].items()} }; launches {launches}; "
          f"{time.perf_counter() - t_phase:.1f} s  [{smi}]")
    failures = []
    if not tr["boot_frame"] < BOOT_BUDGET:
        failures.append(f"bootstrap at frame {tr['boot_frame']}")
    if tr["tracked_frac"] != 1.0:
        failures.append(f"tracked {tr['tracked_frac']} of the timed frames, not all")
    if tr["frames_timed"] != BENCH_CHUNK * BENCH_CHUNKS_TIMED:
        failures.append(f"{tr['frames_timed']} frames timed")
    if tr["per_frame"]["k1_per_frame"] != 1.0 or fe["per_frame"]["k1_per_frame"] != 1.0:
        failures.append("K1 not launched once a timed frame")
    if not tr["per_frame"]["k2_per_frame"] >= 1.0:
        failures.append("K2 launched less than once a timed frame")
    if failures:
        raise AssertionError("bench phase: " + "; ".join(failures))
    return launches


# The keys of tools/error_budget.py's report, stage by stage.
BUDGET_KEYS = {
    "vo_ba_on": ("tracked", "frames", "reboots", "drift_segment", "ate_sim3_m", "ate_se3_m",
                 "dist_travelled_m", "scale_drift_logspread", "scale_drift_per_m",
                 "windowed_scale"),
    "bootstrap": ("first_tracked_frame", "window_scale_vs_run", "window_rmse_m"),
    "loop_gates": ("candidates", "tp", "fp", "fn", "tn", "precision", "recall",
                   "accepted_scales", "log"),
    "slam": ("loop_closures", "keyframes", "reboots", "ate_sim3_m", "ate_se3_m",
             "ate_raw_sim3_m"),
}
BUDGET_KEYS["vo_ba_off"] = BUDGET_KEYS["vo_ba_on"]


def _numbers(x):
    """Every number in a nest of dicts and lists."""
    if isinstance(x, dict):
        return [n for v in x.values() for n in _numbers(v)]
    if isinstance(x, (list, tuple)):
        return [n for v in x for n in _numbers(v)]
    return [x] if isinstance(x, (int, float)) and not isinstance(x, bool) else []


def _budget_phase(dev, smi, loop_run):
    """Phase 15: the error budget on the card, on phase 14's fr1_loop-like
    frames under ``Sampler(0)``; ``loop_run`` is phase 14's ``Sampler(0)``
    run, whose ``DeviceSlam`` the budget's SLAM stage must repeat bit for
    bit.  Returns the kernels' launch counts."""
    import torch

    from tinyslam_tpu_torch import SlamConfig, error_budget, eval_ate
    from tinyslam_tpu_torch.data.tum import TumSequence
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda, scatter_cuda
    from tinyslam_tpu_torch.utils.evaluation import ate_rmse

    root, _ = eval_ate.dataset_sequence(eval_ate.fr1_loop_spec(N_LOOP))
    made, real = [], error_budget.DeviceSlam
    error_budget.DeviceSlam = lambda *a, **kw: made.append(real(*a, **kw)) or made[-1]
    try:
        torch.cuda.synchronize()
        fast_cuda.LAUNCHES = 0
        match_cuda.LAUNCHES = 0
        dupband_cuda.LAUNCHES = 0
        scatter_cuda.LAUNCHES = 0
        t0 = time.perf_counter()
        rep = error_budget.budget_for_sequence("fr1_loop_like", "tum", root, device=dev, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"fast_score_map_fused": fast_cuda.LAUNCHES,
                    "match_reduce_streaming": match_cuda.LAUNCHES,
                    "ordered_scatter_add": scatter_cuda.LAUNCHES,
                    "dup_band": dupband_cuda.LAUNCHES}
    finally:
        error_budget.DeviceSlam = real
    slam = made[-1]
    for stage in ("vo_ba_on", "vo_ba_off", "bootstrap", "slam"):
        print(f"phase 15 {stage}: "
              f"{json.dumps({k: v for k, v in rep[stage].items() if k != 'windowed_scale'})}")
    gates = {k: v for k, v in rep["loop_gates"].items() if k != "log"}
    print(f"phase 15 loop_gates: {json.dumps(gates)}")
    gt = TumSequence.open(root).gt_positions()[:len(slam.vo.stats)]
    print("phase 15 loop candidates: kf old frames gt_dist_m n_appear inliers/chain rmse "
          "s_e s_e_med accepted revisit")
    for r in slam.loop_log:
        fi, fj = slam.kf_frame_of.get(r["kf"]), slam.kf_frame_of.get(r["old"])
        dist = (float(np.linalg.norm(gt[fi] - gt[fj]))
                if fi is not None and fj is not None and max(fi, fj) < len(gt) else None)
        truth = dist is not None and dist < error_budget.REVISIT_M
        print(f"  {r['kf']:3d} {r['old']:3d} {fi}-{fj} "
              f"{dist if dist is None else round(dist, 3)} {r['n_appear']} {r['num_inliers']}/{r['n_chain']} {r['rmse']:.3f} "
              f"{r['s_e']:.4f} {r['s_e_med']:.4f} {r['accepted']} {truth}")
    # The SLAM stage is phase 14's Sampler(0) run again: the same frames and
    # draws, so the same decisions and the same trajectories, bit for bit.
    first = loop_run["slam"]
    same = {
        "raw trajectory": np.array_equal(slam.raw_positions, first.raw_positions),
        "corrected trajectory": np.array_equal(slam.positions, first.positions),
        "closures": slam.num_loop_closures == first.num_loop_closures
        == rep["slam"]["loop_closures"] == loop_run["loop_closures"],
        "keyframes": len(slam.kf_store) == len(first.kf_store) == loop_run["keyframes"]
        and slam.kf_frame_of == first.kf_frame_of,
        "edges": len(slam.edges) == len(first.edges) and all(
            a[:2] == b[:2] and np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
            and a[4:] == b[4:] for a, b in zip(slam.edges, first.edges))}
    b0 = next((i for i, s_ in enumerate(slam.vo.stats) if s_.tracking), 0)
    m = min(len(slam.positions), len(gt))
    ates = [(ate_rmse(x.positions[b0:m], gt[b0:m]), ate_rmse(x.raw_positions[b0:m], gt[b0:m]))
            for x in (slam, first)]
    print(f"phase 15 slam against phase 14's Sampler(0) run: {same}; closures "
          f"{rep['slam']['loop_closures']} vs {loop_run['loop_closures']}, keyframes "
          f"{rep['slam']['keyframes']} vs {loop_run['keyframes']}, ATE Sim(3) {ates[0][0]!r} vs "
          f"{ates[1][0]!r}, raw {ates[0][1]!r} vs {ates[1][1]!r} m  [{smi}]")
    print(f"phase 15: 3 runs of {len(slam.vo.stats)} frames in {wall:.1f} s; K1 "
          f"{launches['fast_score_map_fused']}, K2 {launches['match_reduce_streaming']}, "
          f"assembly {launches['ordered_scatter_add']} launches  [{smi}]")
    failures = [f"the SLAM stage's {k} differs from phase 14's Sampler(0) run"
                for k, v in same.items() if not v]
    for stage, keys in BUDGET_KEYS.items():
        missing = set(keys) - set(rep.get(stage, {}))
        if missing:
            failures.append(f"{stage} lacks {sorted(missing)}")
    numbers = _numbers({k: v for k, v in rep.items() if k != "loop_gates"}
                       | {"loop_gates": gates})
    if not np.isfinite(np.asarray(numbers, np.float64)).all():
        failures.append("a number of the report is not finite")
    g = rep["loop_gates"]
    if g["candidates"] != g["tp"] + g["fp"] + g["fn"] + g["tn"]:
        failures.append(f"{g['candidates']} candidates != tp + fp + fn + tn")
    accepted = sum(r["accepted"] for r in slam.loop_log)
    if not accepted == g["tp"] + g["fp"] == rep["slam"]["loop_closures"]:
        failures.append(f"{accepted} accepted candidates, {rep['slam']['loop_closures']} "
                        f"closures")
    if 0 in (launches["fast_score_map_fused"], launches["match_reduce_streaming"]) or \
            launches["ordered_scatter_add"] != SlamConfig().pose_graph.gn_iters * accepted:
        failures.append(f"a kernel launched no time, or the assembly kernel not once an "
                        f"iteration of each solve: {launches}")
    if failures:
        raise AssertionError("error budget phase: " + "; ".join(failures))
    return launches


def _recovery_phase(cam, room, poses, frames, dev, smi, slice_cfg, slice_seed, slice_ms):
    """Phase 11: checkpoint and resume, crash recovery, the heartbeat,
    profiling and the continuous-angle BRIEF front-end.  ``slice_cfg``,
    ``slice_seed`` and ``slice_ms`` are phase 5's config, seeded state
    and ms a frame.  Returns the kernels' launch counts of the phase."""
    import dataclasses
    import shutil

    import torch

    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.models.slam import DeviceSlam
    from tinyslam_tpu_torch.models.vo_device import DeviceVO
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda
    from tinyslam_tpu_torch.ops.brief import brief_samples
    from tinyslam_tpu_torch.ops.compact import select_topk
    from tinyslam_tpu_torch.ops.fast_cuda import fast_pyramid_maps
    from tinyslam_tpu_torch.ops.image import build_pyramid
    from tinyslam_tpu_torch.types import unpack_descriptor_bits
    from tinyslam_tpu_torch.utils import checkpoint as ck
    from tinyslam_tpu_torch.utils import profiling
    from tinyslam_tpu_torch.utils.draws import Sampler
    from tinyslam_tpu_torch.utils.faults import Heartbeat, SnapshotPolicy

    failures = []
    launches = {"fast_score_map_fused": 0, "match_reduce_streaming": 0, "dup_band": 0}
    shutil.rmtree(REC_DIR, ignore_errors=True)

    def counted(fn):
        """fn() with both counters from 0; adds its launches to the
        phase's; returns (fn's result, K1 launches, K2 launches)."""
        torch.cuda.synchronize()
        fast_cuda.LAUNCHES = 0
        match_cuda.LAUNCHES = 0
        dupband_cuda.LAUNCHES = 0
        out = fn()
        torch.cuda.synchronize()
        k1, k2 = fast_cuda.LAUNCHES, match_cuda.LAUNCHES
        launches["fast_score_map_fused"] += k1
        launches["match_reduce_streaming"] += k2
        launches["dup_band"] += dupband_cuda.LAUNCHES
        return out, k1, k2

    def timed_ms(fn):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t_start) * 1e3

    def disk_bytes(path):
        return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())

    # a. Phase 8's DeviceVO to frame 40, saved, restored on the card; both
    # track frames 41-60, the relocalization of 8d forced at frame 60.
    cfg = SlamConfig()
    n0 = REC_SAVE_FRAME

    def to_save():
        v = DeviceVO(cfg, cam, chunk=CHUNK, device=dev, sampler=Sampler(0))
        for i in range(n0):
            v.process(frames[i])
        v.flush()
        return v

    vo, _, _ = counted(to_save)
    _, save_ms = timed_ms(lambda: ck.save_device_vo(vo, REC_DIR / "vo"))
    back = DeviceVO(cfg, cam, chunk=CHUNK, device=dev, sampler=Sampler(0))
    _, restore_ms = timed_ms(lambda: ck.restore_device_vo(back, REC_DIR / "vo"))
    vo_bytes = disk_bytes(REC_DIR / "vo")

    def resume(v):
        for i in range(n0, RELOC_FRAME):
            v.process(frames[i])
        v.flush()
        v.force_reloc = True
        v.process(frames[RELOC_FRAME])
        v.flush()

    counted(lambda: resume(vo))
    _, k1_r, k2_r = counted(lambda: resume(back))
    flags = lambda v: [(s_.tracking, s_.num_inliers, s_.is_keyframe)  # noqa: E731
                       for s_ in v.stats[n0:]]
    dc = float(np.abs(back.positions[n0:] - vo.positions[n0:]).max())
    n_res = RELOC_FRAME + 1 - n0
    print(f"phase 11a: DeviceVO saved after frame {n0 - 1} ({vo.num_keyframes} keyframes, "
          f"{vo_bytes} B on disk), save {save_ms:.1f} ms, restore {restore_ms:.1f} ms; "
          f"frames {n0}-{RELOC_FRAME} (relocalization forced at {RELOC_FRAME}) resumed "
          f"against uninterrupted: flags equal {flags(back) == flags(vo)}, max centre diff "
          f"{dc:.2e} m; resumed path K1 {k1_r}, K2 {k2_r}; frame {RELOC_FRAME} "
          f"{back.stats[RELOC_FRAME].num_inliers} inliers  [{smi}]")
    if not (flags(back) == flags(vo) and len(flags(vo)) == n_res and dc < 1e-5):
        failures.append("the resumed DeviceVO differs from the uninterrupted one")
    if not (k1_r == n_res and k2_r >= n_res and back.stats[RELOC_FRAME].tracking):
        failures.append(f"the resumed path launched K1 {k1_r} (expected {n_res}), K2 {k2_r}, "
                        f"or lost frame {RELOC_FRAME}")

    # b. The same checkpoint on the CPU plain path, 8 frames.
    cpu = DeviceVO(cfg, cam, chunk=CHUNK, device="cpu", sampler=Sampler(0))
    ck.restore_device_vo(cpu, REC_DIR / "vo")
    for i in range(n0, n0 + REC_CPU_FRAMES):
        cpu.process(frames[i])
    cpu.flush()
    span = slice(n0, n0 + REC_CPU_FRAMES)
    dcpu = float(np.abs(cpu.positions[span] - vo.positions[span]).max())
    same = [s_.tracking for s_ in cpu.stats[span]] == [s_.tracking for s_ in vo.stats[span]]
    print(f"phase 11b: the card's checkpoint restored on the CPU: frames {n0}-"
          f"{n0 + REC_CPU_FRAMES - 1} tracked {sum(s_.tracking for s_ in cpu.stats[span])}"
          f"/{REC_CPU_FRAMES}, max centre diff to the card {dcpu:.2e} m")
    if not (same and dcpu < 2e-3):
        failures.append("the checkpoint restored on the CPU does not track as the card")

    # c. Crash recovery: phase 9's DeviceSlam snapshotted every keyframe,
    # dropped at frame 70, restored into a fresh instance, frames 70-99.
    scfg = slam_config()
    images = [frames[i] for i in out_and_back(N_SLAM)]
    policy = SnapshotPolicy(REC_DIR / "snaps", every_keyframes=1, keep=2)
    slam = DeviceSlam(scfg, cam, chunk=CHUNK, device=dev, sampler=Sampler(0))
    snap_ms, tables = [], {}

    def crash_run():
        for i in range(CRASH_AT):
            slam.process_frame(images[i])
            path, ms = timed_ms(lambda: policy.maybe_snapshot(slam))
            if path is not None:
                snap_ms.append(ms)
                tables[path.name] = ([a.copy() for a in slam.kf_R],
                                     [a.copy() for a in slam.kf_t], list(slam.edges))

    counted(crash_run)
    del slam                                                  # the crash
    fresh = DeviceSlam(scfg, cam, chunk=CHUNK, device=dev, sampler=Sampler(0))
    restored, rest_ms = timed_ms(lambda: policy.restore_latest(fresh))
    if restored is None:
        raise AssertionError(f"phase 11c: no snapshot restored ({policy.skipped})")
    kf_R, kf_t, edges = tables[restored.name]
    same_tables = (len(fresh.kf_R) == len(kf_R) and len(fresh.edges) == len(edges)
                   and all(np.array_equal(a, b) for a, b in zip(fresh.kf_R, kf_R))
                   and all(np.array_equal(a, b) for a, b in zip(fresh.kf_t, kf_t))
                   and all(e[:2] == f[:2] and np.array_equal(e[2], f[2])
                           and np.array_equal(e[3], f[3]) and e[4:] == f[4:]
                           for e, f in zip(fresh.edges, edges)))
    n_before = len(fresh.vo.stats)

    def resume_slam():
        for i in range(CRASH_AT, CRASH_END):
            fresh.process_frame(images[i])
        fresh.finalize()

    _, k1_c, k2_c = counted(resume_slam)
    new = fresh.vo.stats[n_before:]
    lost = [CRASH_AT + j for j, s_ in enumerate(new) if not s_.tracking]
    print(f"phase 11c: {len(snap_ms)} snapshots to frame {CRASH_AT - 1}, ms per save "
          f"{np.mean(snap_ms):.1f} ({[round(m, 1) for m in snap_ms]}), {disk_bytes(restored)} "
          f"B on disk; restored {restored.name} ({len(kf_R)} keyframes, {len(edges)} edges) "
          f"in {rest_ms:.1f} ms, tables equal {same_tables}; frames {CRASH_AT}-"
          f"{CRASH_END - 1}: lost {lost}, K1 {k1_c}, K2 {k2_c}, {fresh.num_loop_closures} "
          f"closures  [{smi}]")
    if not (same_tables and len(new) == CRASH_END - CRASH_AT and len(lost) <= 3):
        failures.append("crash recovery: tables differ from the snapshot or more than 3 "
                        "frames lost")

    # d. The heartbeat.
    hb = Heartbeat(device="cuda", timeout_s=5.0)
    alive, hb_ms = timed_ms(hb.beat)
    hung = Heartbeat(probe_fn=lambda: time.sleep(2.0), timeout_s=0.2)
    t_start = time.perf_counter()
    dead = not hung.beat()
    dead_ms = (time.perf_counter() - t_start) * 1e3
    print(f"phase 11d: heartbeat on {hb.device}: alive {alive} in {hb_ms:.2f} ms; a probe "
          f"that sleeps: dead {dead} after {dead_ms:.1f} ms (timeout 200 ms)  [{smi}]")
    if not (alive and dead and dead_ms < 400):
        failures.append("the heartbeat did not answer, or did not report the hang in time")

    # e. Continuous BRIEF, card against the CPU plain path: nearest, then
    # bilinear, on phase 3's frame; a bit may differ only where its two
    # samples are within 1e-5.
    thr = torch.tensor(slice_cfg.frontend.threshold, dtype=torch.float32, device=dev)
    img = torch.from_numpy(frames[0]).to(dev)
    fe_ms = {"binned": _time_ms(lambda: extract_features(img, thr, slice_cfg.frontend),
                                reps=20, warmup=3)}
    for interp in (False, True):
        fcfg = dataclasses.replace(slice_cfg.frontend, brief_bins=0,
                                   interpolate_descriptors=interp)
        card_f = extract_features(img, thr, fcfg)
        cpu_f = extract_features(img.cpu(), thr.cpu(), fcfg)
        fe_ms["bilinear" if interp else "nearest"] = _time_ms(
            lambda fcfg=fcfg: extract_features(img, thr, fcfg), reps=20, warmup=3)
        others = all(torch.equal(getattr(card_f, k).cpu(), getattr(cpu_f, k))
                     for k in ("xy", "angle", "score", "valid", "level"))
        bits = unpack_descriptor_bits(card_f.desc.cpu()) != unpack_descriptor_bits(cpu_f.desc)
        near = torch.zeros_like(bits)
        if bits.any():
            # The samples of every bit, from the CPU plain path's levels.
            levels = build_pyramid(img.cpu(), fcfg.num_levels)
            maps = fast_pyramid_maps(levels, thr.cpu(), fcfg.border, fcfg.streak_length,
                                     fcfg.blur_sigma)
            gaps = []
            for sr, sn, m10, m01, blurred in maps:
                sel = select_topk(sn if fcfg.nms else sr, sr, m10, m01,
                                  fcfg.features_per_level)
                va, vb = brief_samples(blurred, sel["xy"], sel["angle"], interp)
                gaps.append((va - vb).abs())
            near = bits & (torch.cat(gaps) < 1e-5)
        n_bits, n_near = int(bits.sum()), int(near.sum())
        print(f"phase 11e: continuous BRIEF ({'bilinear' if interp else 'nearest'}), "
              f"{int(card_f.count)} features, card vs CPU: other fields equal {others}, "
              f"{n_bits} descriptor bits differ, {n_near} of them with samples within 1e-5")
        if not others or n_bits != n_near:
            failures.append(f"continuous BRIEF ({interp}) differs between the card and the CPU")
    print(f"phase 11e: front-end ms a frame on the card (640x480, 4 levels x 512): "
          f"{ {k: round(v, 3) for k, v in fe_ms.items()} }  [{smi}]")
    # DeviceVO under bilinear continuous BRIEF on phase 5's slice.
    icfg = dataclasses.replace(slice_cfg, frontend=dataclasses.replace(
        slice_cfg.frontend, interpolate_descriptors=True))

    def interp_run():
        f0 = extract_features(img, thr, icfg.frontend)
        v = DeviceVO(icfg, cam, chunk=CHUNK, device=dev)
        v.state = _seeded(icfg, f0, room, cam, poses[0])
        for im in frames[1:N_FRAMES]:
            v.process(im)
        v.flush()
        return v

    vi, k1_i, k2_i = counted(interp_run)
    gt = _centres([p[0] for p in poses[1:N_FRAMES]], [p[1] for p in poses[1:N_FRAMES]])
    err_i = float(np.linalg.norm(vi.positions - gt, axis=1).max())
    n_tr = sum(s_.tracking for s_ in vi.stats)
    print(f"phase 11e: DeviceVO with bilinear BRIEF on phase 5's slice: tracked {n_tr}/"
          f"{N_FRAMES - 1}, max centre error {err_i:.4f} m, K1 {k1_i}, K2 {k2_i}")
    if not (n_tr == N_FRAMES - 1 == len(vi.stats) and err_i < 0.05):
        failures.append("DeviceVO with bilinear BRIEF lost a frame or drifted")
    # dispatch_slope of one track_step, from phase 5's seeded state.
    sampler = Sampler(0)
    inputs = [torch.from_numpy(frames[i]).to(dev) for i in range(1, 1 + CHUNK)]
    slope = profiling.dispatch_slope(
        lambda im: vd.track_step(cam, slice_cfg, slice_seed, im, sampler), inputs,
        reps=9, attempts=3)
    print(f"phase 11e: dispatch_slope of one track_step (phase 5's slice): "
          f"{1e3 * slope:.2f} ms, beside phase 5's {slice_ms:.2f} ms a frame  [{smi}]")
    # A trace of one tracked chunk: the level scopes and both kernels.  The
    # plain path: a replay of the captured graph runs no Python, so no
    # scope is entered in it.
    def traced_chunk():
        back.graph = False
        try:
            with profiling.trace(REC_DIR / "trace", device=dev) as log_dir:
                for i in range(RELOC_FRAME + 1, RELOC_FRAME + 1 + CHUNK):
                    back.process(frames[i])
                back.flush()
        finally:
            back.graph = True
        return log_dir

    log_dir, _, _ = counted(traced_chunk)
    text = (log_dir / "trace.json").read_text()
    want = [f"orb_level{i}" for i in range(4)] + ["fast_pyramid_kernel", "match_reduce_kernel"]
    missing = [w for w in want if w not in text]
    print(f"phase 11e: trace of frames {RELOC_FRAME + 1}-{RELOC_FRAME + CHUNK} "
          f"({len(text)} B): names {[w for w in want if w in text]}, missing {missing}")
    if missing:
        failures.append(f"the trace does not name {missing}")
    print(f"launches during phase 11: {launches}")
    if failures:
        raise AssertionError("recovery phase: " + "; ".join(failures))
    return launches


def _difference_pins(dev, smi):
    """Phase 11f: the card/CPU differences that remain (ROADMAP queue 3),
    traced in lockstep by ``tools/trace_card_cpu.py`` on identical frames
    and draws: the front-end (pyramid, FAST maps, top-k, descriptors) must
    agree bit for bit, and the first quantity that differs must be the one
    ROADMAP names: the two-view estimate at the first bootstrap attempt
    (frame 3) of the 160x120 bootstrap under ``Sampler(4)`` and of the host
    ``Slam``, and the pose refinement at frame 1 of phase 6."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))
    import trace_card_cpu as tc

    t_start = time.perf_counter()
    with tc.Recorder() as rec:
        boot = tc.case_boot160(dev, rec, frames_n=6, seeds=[4])[0]
        host = tc.case_slamhost(dev, rec, n=6)[0]
        kf = tc.case_phase6(dev, rec, n=3)[0]
    failures = []
    for r, frame, kinds in ((boot, 3, ("two_view.",)), (host, 3, ("two_view.",)),
                            (kf, 1, ("rmse_px", "pose.", "summary"))):
        first = r["first_difference"]
        said = (f"at frame {first[0]}: {first[1]} (max |diff| {first[2]:.3g})" if first
                else "none")
        print(f"phase 11f: {r['case']}: first difference card vs CPU {said}; first "
              f"differing decision {r['first_decision']}; bootstrap frames (card, CPU) "
              f"{r.get('bootstrap_frame')}")
        if not (first and first[0] == frame and first[1].startswith(kinds)):
            failures.append(f"{r['case']}: expected the first difference at frame {frame} "
                            f"in {kinds}, got {first}")
    print(f"phase 11f: {time.perf_counter() - t_start:.1f} s  [{smi}]")
    if failures:
        raise AssertionError("difference pins: " + "; ".join(failures))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_problems(seed: int = 12) -> dict:
    """Phase 12's solver inputs (numpy, from a seed).  The BA window at
    ``BAConfig()``'s full size, built as ``__graft_entry__.py``'s
    ``dryrun_multichip`` builds its BA stage: K=10 orbit poses, L=2048
    random points seen at 0.3 px of noise, the first two poses gauge-fixed,
    the points moved by 2 cm.  The pose graph at ``PoseGraphConfig()``'s:
    N=256 poses on a circle of radius 5 m, the drifting odometry chain (255
    edges with 0.005 m and 0.01 rad of noise), 512 loop edges at their true
    relative transforms between nodes at least 10 apart, and the rest of
    the E=1024 slots invalid padding."""
    import torch

    from tinyslam_tpu_torch import BAConfig
    from tinyslam_tpu_torch.config import PoseGraphConfig
    from tinyslam_tpu_torch.data.synthetic import (default_camera, orbit_trajectory,
                                                   project_points, random_points)
    from tinyslam_tpu_torch.geometry.se3 import se3_compose, se3_exp, se3_inverse

    rng = np.random.default_rng(seed)
    ba, pg = BAConfig(), PoseGraphConfig()
    K, L = ba.max_keyframes, ba.max_landmarks
    cam = default_camera(WIDTH, HEIGHT)
    X = random_points(rng, L).astype(np.float32)
    poses = orbit_trajectory(K)
    z = np.zeros((L, K, 2), np.float32)
    mask = np.zeros((L, K), bool)
    for k, (R, t) in enumerate(poses):
        z[:, k], mask[:, k] = project_points(cam, R, t, X, width=WIDTH, height=HEIGHT,
                                             noise_px=0.3, rng=rng)
    out = {"ba_R": np.stack([p[0] for p in poses]), "ba_t": np.stack([p[1] for p in poses]),
           "ba_X": X + rng.normal(0, 0.02, X.shape).astype(np.float32), "ba_z": z,
           "ba_mask": mask, "ba_pose_free": np.r_[[False, False], np.ones(K - 2, bool)]}

    n, E = pg.max_nodes, pg.max_edges
    T = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    ang = 2 * np.pi * np.arange(n) / n
    xi = np.zeros((n, 6))
    xi[:, 4] = ang
    Rg, _ = se3_exp(T(xi))
    C = np.stack([5.0 * np.sin(ang), np.zeros(n), 5.0 * (1 - np.cos(ang))], -1)
    tg = -torch.einsum("nab,nb->na", Rg, T(C))

    def relative(a, b):
        return se3_compose(Rg[b], tg[b], *se3_inverse(Rg[a], tg[a]))

    i = np.arange(n - 1)
    noise = np.concatenate([rng.normal(0, 0.005, (n - 1, 3)), rng.normal(0, 0.01, (n - 1, 3))], 1)
    odo_R, odo_t = se3_compose(*se3_exp(T(noise)), *relative(i, i + 1))
    R_est, t_est = [Rg[0]], [tg[0]]
    for k in range(n - 1):
        Rn, tn = se3_compose(odo_R[k], odo_t[k], R_est[-1], t_est[-1])
        R_est.append(Rn)
        t_est.append(tn)
    a = rng.integers(0, n, 4 * N_PG_LOOPS)
    b = rng.integers(0, n, 4 * N_PG_LOOPS)
    keep = np.abs(a - b) >= 10
    a, b = a[keep][:N_PG_LOOPS], b[keep][:N_PG_LOOPS]
    loop_R, loop_t = relative(a, b)
    pad = E - (n - 1) - N_PG_LOOPS
    out.update(
        pg_R=torch.stack(R_est).numpy(), pg_t=torch.stack(t_est).numpy(),
        pg_ei=np.r_[i, a, np.zeros(pad)].astype(np.int32),
        pg_ej=np.r_[i + 1, b, np.ones(pad)].astype(np.int32),
        pg_eR=torch.cat([odo_R, loop_R, torch.eye(3).expand(pad, 3, 3)]).numpy(),
        pg_et=torch.cat([odo_t, loop_t, torch.zeros(pad, 3)]).numpy(),
        pg_ev=np.r_[np.ones(n - 1 + N_PG_LOOPS, bool), np.zeros(pad, bool)],
        pg_ew=np.r_[np.ones(n - 1 + N_PG_LOOPS), np.zeros(pad)].astype(np.float32))
    return out


def _ba_kwargs() -> dict:
    from tinyslam_tpu_torch import BAConfig

    ba = BAConfig()
    return dict(max_iters=ba.max_iters, huber=ba.huber_delta, lam0=ba.damping_init,
                lam_up=ba.damping_up, lam_down=ba.damping_down)


def _dist_args(prob: dict, dev):
    """(camera, BA arguments, pose-graph arguments) on ``dev``."""
    import torch

    from tinyslam_tpu_torch.data.synthetic import default_camera

    T = lambda k: torch.from_numpy(prob[k]).to(dev)  # noqa: E731
    return (default_camera(WIDTH, HEIGHT),
            [T(f"ba_{k}") for k in ("R", "t", "X", "z", "mask", "pose_free")],
            [T(f"pg_{k}") for k in ("R", "t", "ei", "ej", "eR", "et", "ev", "ew")])


def _dist_rank(rank: int, port: str, device: str) -> None:
    """Phase 12e, one of two ranks on the one card over gloo, CUDA tensors
    (``device`` "cuda"; "cpu" rehearses it): phase 12c's BA and 12d's
    edge-sharded pose graph on a (1, 2) mesh."""
    import torch
    import torch.distributed as dist

    from tinyslam_tpu_torch.config import PoseGraphConfig
    from tinyslam_tpu_torch.parallel import (bundle_adjust_sharded, initialize_multihost,
                                             make_mesh, optimize_pose_graph_sharded)

    initialize_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    mesh = make_mesh(device_type=device)
    if tuple(mesh.shape) != (1, 2):
        raise AssertionError(f"rank {rank}: mesh {tuple(mesh.shape)}, expected (1, 2)")
    cam, ba_args, pg_args = _dist_args(dict(np.load(DIST_DIR / "in.npz")), torch.device(device))
    ba = bundle_adjust_sharded(mesh, cam, *ba_args, **_ba_kwargs())
    pg = optimize_pose_graph_sharded(mesh, *pg_args, iters=PoseGraphConfig().gn_iters)
    if device == "cuda":
        torch.cuda.synchronize()
    np.savez(DIST_DIR / f"out{rank}.npz", **{f"ba_{k}": v.cpu().numpy() for k, v in ba.items()},
             **{f"pg_{k}": v.cpu().numpy() for k, v in pg.items()})
    dist.destroy_process_group()
    print(f"phase 12e rank {rank}: done on {device}")


def _dist_phase(frames, dev, smi, timed):
    """Phase 12: the distributed layer on the card.  Returns the kernels'
    launch counts of its main path, (b); appends the batched K1 launch to
    ``timed`` for phase 7."""
    import torch
    import torch.distributed as dist

    from tinyslam_tpu_torch import FrontendConfig
    from tinyslam_tpu_torch.backend.ba import bundle_adjust
    from tinyslam_tpu_torch.backend.pose_graph import optimize_pose_graph
    from tinyslam_tpu_torch.config import PoseGraphConfig
    from tinyslam_tpu_torch.frontend.orb import extract_batch, extract_features
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda
    from tinyslam_tpu_torch.ops.fast import fast_maps
    from tinyslam_tpu_torch.ops.image import build_pyramid
    from tinyslam_tpu_torch.parallel import (bundle_adjust_sharded, extract_features_batch,
                                             initialize_multihost, make_mesh,
                                             optimize_pose_graph_node_sharded,
                                             optimize_pose_graph_sharded)

    t_phase = time.perf_counter()
    # (a) NCCL at world size 1 and the default mesh.
    initialize_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                         backend="nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = make_mesh(device_type=dev.type)
        if tuple(mesh.shape) != (1, 1) or mesh.device_type != dev.type:
            raise AssertionError(f"mesh {tuple(mesh.shape)} on {mesh.device_type}")
        print(f"phase 12a: {dist.get_backend()} at world size {dist.get_world_size()}, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {mesh.device_type}")

        # (b) ORB over a batch of full-width frames, split on `frame`.
        fe = FrontendConfig()
        ims = torch.from_numpy(np.stack(frames[:N_DP_FRAMES])).to(dev)
        thr = torch.tensor(fe.threshold, dtype=torch.float32, device=dev)
        torch.cuda.synchronize()
        fast_cuda.LAUNCHES = 0
        match_cuda.LAUNCHES = 0
        dupband_cuda.LAUNCHES = 0
        batch = extract_features_batch(ims, thr, fe, mesh=mesh)
        torch.cuda.synchronize()
        launches = {"fast_score_map_fused": fast_cuda.LAUNCHES,
                    "match_reduce_streaming": match_cuda.LAUNCHES,
                    "dup_band": dupband_cuda.LAUNCHES}
        print("phase 12b launches:", launches)
        if launches["fast_score_map_fused"] != 1:
            raise AssertionError(f"K1 launched {launches['fast_score_map_fused']} times for "
                                 f"one batch of {N_DP_FRAMES} frames, expected 1")
        cpu = extract_batch(ims.cpu(), fe.threshold, fe)
        for i in range(N_DP_FRAMES):
            single = extract_features(ims[i], thr, fe)
            for name in ("xy", "level", "angle", "score", "desc", "valid"):
                got = getattr(batch, name)[i]
                for ref, where in ((getattr(single, name), "per-frame on the card"),
                                   (getattr(cpu, name)[i], "the CPU plain path")):
                    if not torch.equal(got.cpu(), ref.cpu()):
                        raise AssertionError(f"phase 12b frame {i} {name}: not equal to {where}")
        ms_batch = _time_ms(lambda: extract_features_batch(ims, thr, fe, mesh=mesh),
                            reps=10, warmup=2)
        ms_single = _time_ms(lambda: [extract_features(im, thr, fe) for im in ims],
                             reps=10, warmup=2)
        print(f"phase 12b: {N_DP_FRAMES} frames {tuple(ims.shape[1:])}, "
              f"{int(batch.valid.sum())} features, bit-equal per frame on the card and to the "
              f"CPU; wall a batch {ms_batch:.3f} ms, {N_DP_FRAMES} single frames "
              f"{ms_single:.3f} ms  [{smi}]")
        k1_args = (thr, fe.border, fe.streak_length, fe.blur_sigma)
        levels_b = build_pyramid(ims, fe.num_levels)
        levels_1 = [build_pyramid(im, fe.num_levels) for im in ims]
        k1_b = _time_ms(lambda: fast_cuda.fast_pyramid_maps(levels_b, *k1_args))
        k1_1 = _time_ms(lambda: [fast_cuda.fast_pyramid_maps(lv, *k1_args) for lv in levels_1])
        print(f"phase 12b K1 alone: one launch over {N_DP_FRAMES} frames {k1_b:.4f} ms, "
              f"{N_DP_FRAMES} launches of one frame {k1_1:.4f} ms (wall, CUDA events)  [{smi}]")
        timed.append((f"K1 batch {N_DP_FRAMES}x480x640",
                      lambda: fast_cuda.fast_pyramid_maps(levels_b, *k1_args),
                      lambda: [[fast_maps(lvl, *k1_args) for lvl in lv] for lv in levels_1]))

        # (c) landmark-sharded BA at BAConfig()'s full size.
        prob = _dist_problems()
        cam, ba_args, pg_args = _dist_args(prob, dev)
        kw = _ba_kwargs()
        ba_sh = bundle_adjust_sharded(mesh, cam, *ba_args, **kw)
        ba_1 = bundle_adjust(cam, *ba_args, **kw)
        for k in ("R", "t", "X", "cost", "initial_cost", "lam"):
            if not torch.equal(ba_sh[k], ba_1[k]):
                raise AssertionError(f"phase 12c: bundle_adjust_sharded {k} differs from "
                                     f"bundle_adjust by {float((ba_sh[k] - ba_1[k]).abs().max())}")
        if not float(ba_sh["cost"]) < 0.5 * float(ba_sh["initial_cost"]):
            raise AssertionError(f"phase 12c: cost {float(ba_sh['cost'])} from "
                                 f"{float(ba_sh['initial_cost'])}")
        ms_ba = _time_ms(lambda: bundle_adjust_sharded(mesh, cam, *ba_args, **kw), reps=5, warmup=1)
        ms_ba1 = _time_ms(lambda: bundle_adjust(cam, *ba_args, **kw), reps=5, warmup=1)
        print(f"phase 12c: bundle_adjust_sharded K={ba_args[0].shape[0]} L={ba_args[2].shape[0]}, "
              f"{kw['max_iters']} iterations, bit-equal to bundle_adjust; cost "
              f"{float(ba_sh['initial_cost']):.1f} -> {float(ba_sh['cost']):.1f}; wall an LM "
              f"iteration {ms_ba / kw['max_iters']:.3f} ms, unsharded "
              f"{ms_ba1 / kw['max_iters']:.3f} ms  [{smi}]")

        # (d) the pose graphs at PoseGraphConfig()'s sizes.
        iters = PoseGraphConfig().gn_iters
        pg_sh = optimize_pose_graph_sharded(mesh, *pg_args, iters=iters)
        pg_1 = optimize_pose_graph(*pg_args, iters=iters)
        for k in ("R", "t", "costs"):
            if not torch.equal(pg_sh[k], pg_1[k]):
                raise AssertionError(f"phase 12d: optimize_pose_graph_sharded {k} differs "
                                     f"from optimize_pose_graph")
        again = optimize_pose_graph(*pg_args, iters=iters)
        if not all(torch.equal(again[k], pg_1[k]) for k in ("R", "t", "costs")):
            raise AssertionError("phase 12d: two runs of optimize_pose_graph differ")
        node = optimize_pose_graph_node_sharded(mesh, *pg_args, iters=NODE_ITERS, halo=NODE_HALO)
        c_ref = _centres(pg_1["R"].cpu().numpy(), pg_1["t"].cpu().numpy())
        err = np.linalg.norm(_centres(node["R"].cpu().numpy(), node["t"].cpu().numpy())
                             - c_ref, axis=-1).max()
        drift = np.linalg.norm(_centres(prob["pg_R"], prob["pg_t"]) - c_ref, axis=-1).max()
        ms_pg = _time_ms(lambda: optimize_pose_graph_sharded(mesh, *pg_args, iters=iters),
                         reps=3, warmup=1)
        ms_pg1 = _time_ms(lambda: optimize_pose_graph(*pg_args, iters=iters), reps=3, warmup=1)
        ms_node = _time_ms(lambda: optimize_pose_graph_node_sharded(
            mesh, *pg_args, iters=NODE_ITERS, halo=NODE_HALO), reps=3, warmup=1)
        n, E = pg_args[0].shape[0], pg_args[2].shape[0]
        print(f"phase 12d: optimize_pose_graph_sharded N={n} E={E}, {iters} iterations, "
              f"bit-equal to optimize_pose_graph and a second run of it (the normal "
              f"equations added in a fixed order); cost {float(pg_1['costs'][0]):.4g} -> "
              f"{float(pg_1['costs'][-1]):.4g}; wall {ms_pg:.3f} ms, unsharded {ms_pg1:.3f} ms"
              f"  [{smi}]")
        print(f"phase 12d: optimize_pose_graph_node_sharded N={n}, halo {NODE_HALO}, "
              f"{NODE_ITERS} iterations: centres within {err:.4f} m of the replicated "
              f"optimum (the start is {drift:.3f} m off); wall {ms_node:.3f} ms  [{smi}]")
        if not (err < 0.05 and drift > 0.1):
            raise AssertionError(f"phase 12d: node-sharded centres {err} m from the optimum "
                                 f"(start {drift} m)")
    finally:
        dist.destroy_process_group()

    # (e) two ranks on the one card over gloo: (c) and the edge-sharded (d).
    DIST_DIR.mkdir(parents=True, exist_ok=True)
    np.savez(DIST_DIR / "in.npz", **prob)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dist-rank",
                               str(r), port, dev.type], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 12e rank {r} exited {p.returncode}:\n{log[-3000:]}")
    outs = [dict(np.load(DIST_DIR / f"out{r}.npz")) for r in range(2)]
    for k in outs[0]:
        if not np.array_equal(outs[0][k], outs[1][k]):
            raise AssertionError(f"phase 12e: the two ranks' {k} differ")
    world1 = {**{f"ba_{k}": v.cpu().numpy() for k, v in ba_1.items()},
              **{f"pg_{k}": v.cpu().numpy() for k, v in pg_1.items()}}
    # tests/test_torch_parallel.py's tolerances: R 5e-4, t and X 5e-3.
    worst = {}
    for k, tol in (("ba_R", 5e-4), ("ba_t", 5e-3), ("ba_X", 5e-3), ("pg_R", 5e-4),
                   ("pg_t", 5e-3)):
        worst[k] = float(np.abs(outs[0][k] - world1[k]).max())
        if not worst[k] <= tol:
            raise AssertionError(f"phase 12e: {k} at world size 2 is {worst[k]} from world "
                                 f"size 1 (> {tol})")
    print(f"phase 12e: 2 ranks over gloo on the card, both ranks equal; max |diff| to world "
          f"size 1 {worst}")
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    return launches


def _batch_replay_trace(cam, cases, dev, smi):
    """Phase 13g: one replay of the batched graph traced at B = 1 and 8
    (its first step of phase 13d's workload: the common path, keyframes
    where the policy asks): kernel time by name, which sets the pace of
    13d.  Run after phase 11 has traced, as 17f: the profiler slows this
    process's later graph launches (a B = 8 replay's enqueue from 4.7 to
    42 ms)."""
    import json

    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.models.vo_device import VOState
    from tinyslam_tpu_torch.utils import profiling
    from tinyslam_tpu_torch.utils.draws import Sampler

    cfg = SlamConfig()
    for nb in (1, 8):
        s_, im_, act_ = cases[nb]
        samp = [Sampler(b) for b in range(nb)]
        g = vd.batch_graph(cam, cfg, VOState.stack(s_), im_[:, 0], samp)
        st = VOState.stack(s_)
        g.track_chunk(st, im_[:, :1], act_[:, :1], samp)
        for attempt in range(3):        # a trace now and then comes back empty
            with profiling.trace(REC_DIR / f"batch_trace_{nb}", device=dev, cpu=False) as log_dir:
                g.track_chunk(st, im_[:, :1], act_[:, :1], samp)
            events = [e for e in json.loads((log_dir / "trace.json").read_text())["traceEvents"]
                      if e.get("cat") == "kernel"]
            if events:
                break
        by_name = {}
        for e in events:
            d, k = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (d + e["dur"], k + 1)
        total = sum(d for d, _ in by_name.values())
        span = (max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
                if events else 0.0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        print(f"phase 13g: one B={nb} replay traced (attempt {attempt + 1}): {len(events)} kernel "
              f"events, {total / 1e3:.3f} ms of kernel time in a span of {span / 1e3:.3f} ms; "
              f"longest by name: "
              + "; ".join(f"{n[:70]} {k}x {d / 1e3:.3f} ms" for n, (d, k) in top)
              + f"  [{smi}]")
        if not events:
            raise AssertionError(f"phase 13g: the B={nb} replay's trace holds no kernel")
    _account_graphs()


def _multiseq_phase(cam, room, poses, frames, dev, smi, timed):
    """Phase 13: B camera streams tracked as one batch
    (``track_chunk_batch``), the entry points and the dry run.  Returns the
    kernels' launch counts of its main path, (a), and appends the kernels'
    B=4 launches to ``timed`` for phase 7."""
    import torch

    from tinyslam_tpu_torch import SlamConfig
    from tinyslam_tpu_torch.entry import dryrun_multichip, entry
    from tinyslam_tpu_torch.frontend.orb import extract_batch, extract_features
    from tinyslam_tpu_torch.geometry.se3 import so3_exp
    from tinyslam_tpu_torch.models import vo_device as vd
    from tinyslam_tpu_torch.models.vo_device import (SUMMARY_FIELDS, VOState, track_chunk,
                                                     track_chunk_batch, track_step_batch)
    from tinyslam_tpu_torch.ops import dupband_cuda, fast_cuda, match_cuda
    from tinyslam_tpu_torch.ops.fast import fast_maps
    from tinyslam_tpu_torch.ops.hamming import match_reduce_plain
    from tinyslam_tpu_torch.ops.image import build_pyramid
    from tinyslam_tpu_torch.utils.draws import Sampler

    t_phase = time.perf_counter()
    cfg = SlamConfig()
    fe = cfg.frontend
    col = {name: i for i, name in enumerate(SUMMARY_FIELDS)}
    thr = torch.tensor(fe.threshold, dtype=torch.float32, device=dev)
    failures = []

    def seeded(s0: int, stale: bool) -> "VOState":
        state = _seeded(cfg, extract_features(torch.from_numpy(frames[s0]).to(dev), thr, fe),
                        room, cam, poses[s0])
        if not stale:
            return state
        dR = so3_exp(torch.tensor([0.0, MS_STALE_YAW, 0.0], device=dev))
        return state.replace(R=dR @ state.R, t=dR @ state.t,
                             last_tracking=torch.zeros((), dtype=torch.bool, device=dev))

    def workload(starts, n, stale=None, padded=None):
        seeds = [seeded(s0, b == stale) for b, s0 in enumerate(starts)]
        images = torch.from_numpy(np.stack([np.stack(frames[s0 + 1:s0 + 1 + n])
                                            for s0 in starts])).to(dev)
        active = np.ones((len(starts), n), bool)
        if padded is not None:
            active[padded, -MS_PAD:] = False
        return seeds, images, active

    # (a) The main path: 4 sequences a step at a time through the captured
    # BatchGraph (one replay a step), in lockstep with the plain batched
    # step, each step's state, poses and summaries held bit for bit;
    # launches and syncs counted per step on both.  Each guided pass of the
    # plain step is one call of _track_rows, which must launch K2 once, and
    # its decisions are counted by name as the graph's tally counts them.
    from tinyslam_tpu_torch.models import vo as vo_mod
    from tinyslam_tpu_torch.utils.cuda_graph import tree_leaves

    seeds, images, active = workload(MS_STARTS, MS_FRAMES, stale=MS_STALE, padded=MS_PADDED)
    B = len(seeds)
    real_rows, passes = vd._track_rows, []
    real_conds = (vd.device_cond, vo_mod.device_cond)
    taken = dict.fromkeys(vd.BATCH_BRANCHES, 0)

    def counted_rows(*a, **kw):
        k2 = match_cuda.LAUNCHES
        out = real_rows(*a, **kw)
        passes.append(match_cuda.LAUNCHES - k2)
        return out

    def counted_cond(pred, true_fn, false_fn, operands=(), names=(None, None)):
        # The plain device_cond (one read of the predicate), its branch counted.
        p = bool(pred)
        name = names[0] if p else names[1]
        if name is not None:
            taken[name] += 1
        return true_fn(*operands) if p else false_fn(*operands)

    samplers = [Sampler(b) for b in range(B)]
    graph = vd.batch_graph(cam, cfg, VOState.stack(seeds), images[:, 0], samplers)
    graph.account(graph.tally.tolist())
    states = g_states = VOState.stack(seeds)
    names = [n for n, _ in _named_leaves(states)]
    steps, outs, g_syncs, diffs = [], [], [], []
    e_k, g_k = [0, 0, 0], [0, 0, 0]

    def counts():
        return fast_cuda.LAUNCHES, match_cuda.LAUNCHES, dupband_cuda.LAUNCHES

    torch.cuda.synchronize()
    fast_cuda.LAUNCHES = 0
    match_cuda.LAUNCHES = 0
    dupband_cuda.LAUNCHES = 0
    for c in range(MS_FRAMES):
        k1, k2, n_pass = fast_cuda.LAUNCHES, match_cuda.LAUNCHES, len(passes)
        at = counts()

        def step(states=states, c=c):
            return track_step_batch(cam, cfg, states, images[:, c], active[:, c], samplers)

        vd._track_rows, vd.device_cond, vo_mod.device_cond = counted_rows, counted_cond, \
            counted_cond
        try:
            (states, ys), syncs = _with_sync_count(step)
        finally:
            vd._track_rows, (vd.device_cond, vo_mod.device_cond) = real_rows, real_conds
        outs.append(ys)
        steps.append((fast_cuda.LAUNCHES - k1, match_cuda.LAUNCHES - k2,
                      passes[n_pass:], syncs))
        e_k = [k + now - was for k, now, was in zip(e_k, counts(), at)]
        at = counts()
        (g_states, g_ys), k = _with_sync_count(
            lambda g_states=g_states, c=c: graph.track_chunk(
                g_states, images[:, c:c + 1], active[:, c:c + 1], samplers))
        g_syncs.append(k)
        g_k = [k + now - was for k, now, was in zip(g_k, counts(), at)]
        bad = [n for n, a, b in zip(names, tree_leaves(states), tree_leaves(g_states))
               if not _same_bits(a, b)]
        bad += [k for k in ("R", "t", "summary") if not _same_bits(ys[k], g_ys[k][:, 0])]
        if bad:
            diffs.append((c, bad))
    at = counts()
    runs = graph.account(graph.tally.tolist())
    g_k = [k + now - was for k, now, was in zip(g_k, counts(), at)]
    torch.cuda.synchronize()
    launches = {"fast_score_map_fused": fast_cuda.LAUNCHES,
                "match_reduce_streaming": match_cuda.LAUNCHES,
                "dup_band": dupband_cuda.LAUNCHES}
    summ = torch.stack([y["summary"] for y in outs], 1).cpu().numpy()     # (B, C, 8)
    R_b = torch.stack([y["R"] for y in outs], 1).cpu().numpy()
    t_b = torch.stack([y["t"] for y in outs], 1).cpu().numpy()
    tracking = summ[..., col["tracking"]] > 0
    is_kf = summ[..., col["is_keyframe"]] > 0
    was_lost = np.concatenate([[[not bool(s.last_tracking)] for s in seeds], ~tracking[:, :-1]],
                              1) & active
    print(f"phase 13a: {B} sequences from orbit frames {list(MS_STARTS)}, {MS_FRAMES} frames "
          f"each (sequence {MS_STALE} from a stale pose, sequence {MS_PADDED}'s last {MS_PAD} "
          f"inactive): tracked {int(tracking.sum())}/{int(active.sum())}, keyframes per "
          f"sequence {is_kf.sum(1).tolist()}, relocalizations at (sequence, frame) "
          f"{[tuple(int(i) for i in x) for x in np.argwhere(was_lost)]}; launches (plain step "
          f"and graph) {launches}")
    print(f"phase 13a: the captured BatchGraph against the plain step, {MS_FRAMES} steps in "
          f"lockstep: every state tensor ({len(names)}), R, t and summary "
          f"{'bit-equal at every step' if not diffs else f'DIFFERENT at {diffs[:3]}'}; branch "
          f"runs (summed over rows) graph {runs}, plain {taken}; K1, K2, duplicate test "
          f"launches graph {g_k}, plain {e_k}  [{smi}]")
    if diffs:
        failures.append(f"13a: the graph and the plain step differ at (step, fields) {diffs[:3]}")
    if runs != taken:
        failures.append(f"13a: branch runs graph {runs}, plain {taken}")
    if g_k != e_k:
        failures.append(f"13a: K1, K2, duplicate test launches graph {g_k}, plain {e_k}")
    if not 0 < g_k[2] == 2 * runs["keyframe"]:
        failures.append(f"13a: the duplicate test launched {g_k[2]} times in the graph's "
                        f"{runs['keyframe']} keyframe bodies (two a body expected)")
    if not tracking[active].all() or tracking[~active].any():
        failures.append(f"13a: tracked {tracking.tolist()} of active {active.tolist()}")
    if not was_lost[MS_STALE, 0]:
        failures.append("13a: the stale sequence did not relocalize at its first frame")
    # (b) per step of the plain version: K1 once, K2 once a guided pass plus
    # the rare branches' own launches (a relocalization 1-2, a keyframe 5),
    # syncs at most one a row's relocalization and keyframe condition, one
    # for the second pass, and one a relocalization's global fallback and a
    # keyframe's BA condition; the graph's replays none.
    worst = []
    for c, (k1, k2, pass_k2, syncs) in enumerate(steps):
        n_kf, n_rel = int(is_kf[:, c].sum()), int(was_lost[:, c].sum())
        rare = k2 - sum(pass_k2)
        if (k1 != 1 or not 1 <= len(pass_k2) <= 2 or any(p != 1 for p in pass_k2)
                or not n_rel + 5 * n_kf <= rare <= 2 * n_rel + 5 * n_kf
                or syncs > 2 * B + 1 + n_kf + n_rel):
            failures.append(f"13b: step {c}: K1 {k1}, K2 {k2} (guided passes {pass_k2}), "
                            f"{syncs} syncs, {n_kf} keyframes, {n_rel} relocalizations")
        worst.append(syncs - n_kf - n_rel)
    print(f"phase 13b: per step of the plain step K1 {sorted({s[0] for s in steps})}, guided "
          f"passes (K2 each) {sorted({len(s[2]) for s in steps})}, K2 {[s[1] for s in steps]}, "
          f"syncs {[s[3] for s in steps]} (at most {max(worst)} beyond keyframes and "
          f"relocalizations: one a condition); the graph's steps (one replay each): syncs "
          f"{g_syncs}  [{smi}]")
    if any(g_syncs):
        failures.append(f"13b: the graph's steps synchronized: {g_syncs}")

    # (a) each sequence against its own track_chunk on the card, and (d)
    # aggregate tracked frames/s at B = 1, 2, 4 and 8, three runs each:
    # the batched graph, B serial ChunkGraph runs (DeviceVO's path) and the
    # plain batched step.
    def clocked(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    def run_batched(seeds, images, active, graph):
        return clocked(lambda: track_chunk_batch(
            cam, cfg, VOState.stack(seeds), images, active,
            [Sampler(b) for b in range(len(seeds))], graph=graph)[1])

    def run_serial(seeds, images, active):
        def run():
            out = []
            for b, s in enumerate(seeds):
                g = vd.chunk_graph(cam, cfg, s, images[b, 0], Sampler(b))
                out.append(g.track_chunk(s, images[b], active[b].tolist())[1])
            return out
        return clocked(run)

    fps, cases = {}, {}
    modes = ("graph", "serial", "eager")
    for nb, starts, n in ((1, MS_STARTS[:1], MS_FRAMES), (2, MS_STARTS[:2], MS_FRAMES),
                          (4, MS_STARTS, MS_FRAMES), (8, MS8_STARTS, MS8_FRAMES)):
        if nb == 4:
            s_, im_, act_ = seeds, images, active
        else:
            s_, im_, act_ = workload(starts, n)
        cases[nb] = (s_, im_, act_)
        # Warm-up: the first call at a batch's shapes captures its graph and
        # pays for cuBLAS and allocator set-up.
        run_batched(s_, im_[:, :2], act_[:, :2], True)
        run_serial(s_, im_[:, :2], act_[:, :2])
        run_batched(s_, im_[:, :2], act_[:, :2], False)
        n_act = int(act_.sum())
        secs = {m: [] for m in modes}
        for _ in range(3):
            secs["graph"].append(run_batched(s_, im_, act_, True)[0])
            secs["serial"].append(run_serial(s_, im_, act_)[0])
            secs["eager"].append(run_batched(s_, im_, act_, False)[0])
        _account_graphs()
        fps[nb] = {m: sorted(n_act / x for x in v) for m, v in secs.items()}
        med = {m: v[1] for m, v in fps[nb].items()}
        g = vd._BATCH_GRAPHS[next(k for k in vd._BATCH_GRAPHS
                                  if k[2] == tuple(im_[:, 0].shape))].captured
        print(f"phase 13d: B={nb} ({n_act} tracked frames), frames/s of three runs: batched "
              f"graph {[round(x, 2) for x in fps[nb]['graph']]}, {nb} serial ChunkGraph "
              f"{[round(x, 2) for x in fps[nb]['serial']]}, batched plain step "
              f"{[round(x, 2) for x in fps[nb]['eager']]}; medians graph/serial "
              f"{med['graph'] / med['serial']:.3f}, graph/plain {med['graph'] / med['eager']:.3f}"
              f"; the graph: capture + instantiation {g.capture_s + g.instantiate_s:.3f} s, pool "
              f"{g.pool_bytes} B  [{smi}]")
    _, serial4 = clocked(lambda: [track_chunk(cam, cfg, s, images[b], active[b], Sampler(b))[1]
                                  for b, s in enumerate(seeds)])
    worst = {"centre_m": 0.0, "angle_rad": 0.0, "inliers_rel": 0.0}
    for b, ys in enumerate(serial4):
        s1 = ys["summary"].cpu().numpy()
        for name in ("tracking", "is_keyframe"):
            if not np.array_equal(s1[:, col[name]], summ[b, :, col[name]]):
                failures.append(f"13a: sequence {b} {name} {s1[:, col[name]].tolist()} alone, "
                                f"{summ[b, :, col[name]].tolist()} in the batch")
        n1, nb_ = s1[:, col["num_inliers"]], summ[b, :, col["num_inliers"]]
        rel = float(np.max(np.abs(n1 - nb_) / np.maximum(n1, 1)))
        R1, t1 = ys["R"].cpu().numpy(), ys["t"].cpu().numpy()
        dc = float(np.abs(_centres(R1, t1) - _centres(R_b[b], t_b[b])).max())
        # The angle between two rotations, ||R1 - R2||_F = 2 sqrt(2) sin(angle / 2),
        # in float64: arccos of the trace loses ~1e-3 rad to float32 near 0.
        fro = np.linalg.norm((R1.astype(np.float64) - R_b[b]).reshape(len(R1), -1), axis=1)
        ang = float((2 * np.arcsin(np.minimum(fro / np.sqrt(8.0), 1.0))).max())
        for k, v in (("centre_m", dc), ("angle_rad", ang), ("inliers_rel", rel)):
            worst[k] = max(worst[k], v)
    print(f"phase 13a: batch against each sequence's own track_chunk on the card: flags equal "
          f"where no failure is listed; worst {worst}")
    if not (worst["centre_m"] < 2e-3 and worst["angle_rad"] < 1e-3
            and worst["inliers_rel"] <= 0.02):
        failures.append(f"13a: batch against serial {worst}")

    # (c) the kernels against their plain versions at B=4: K1 with four
    # thresholds, K2 guided and unguided at B=1 and B=4.
    levels4 = build_pyramid(images[:, 0], fe.num_levels)
    thr4 = torch.tensor(MS_THRESHOLDS, dtype=torch.float32, device=dev)
    k1_args = (fe.border, fe.streak_length, fe.blur_sigma)
    got = fast_cuda.fast_pyramid_maps(levels4, thr4, *k1_args)
    k1_err = 0.0
    for lvl, maps in zip(levels4, got):
        for b in range(B):
            for g, w in zip(maps, fast_maps(lvl[b], thr4[b], *k1_args)):
                k1_err = max(k1_err, float((g[b] - w).abs().max()))
                if not torch.equal(g[b], w):
                    failures.append(f"13c: K1 frame {b} level {tuple(lvl.shape[1:])} differs")
    feats4 = extract_batch(images[:, 0], thr4, fe)
    st4 = VOState.stack(seeds)
    pc = st4.map.X @ st4.R.transpose(-1, -2) + st4.t[:, None]
    proj4 = torch.stack([cam.fx * pc[..., 0] / pc[..., 2] + cam.cx,
                         cam.fy * pc[..., 1] / pc[..., 2] + cam.cy], -1)
    case4 = dict(desc_a=feats4.desc, valid_a=feats4.valid, desc_b=st4.map.desc,
                 valid_b=st4.map.valid, xy_a=feats4.xy, proj_b=proj4)
    unguided = lambda c: {k: v for k, v in c.items() if k not in ("xy_a", "proj_b")}  # noqa: E731
    for name, case in (("B=4 guided r=20", case4), ("B=4 unguided", unguided(case4)),
                       ("B=1 guided r=20", {k: v[:1] for k, v in case4.items()}),
                       ("B=1 unguided", {k: v[:1] for k, v in unguided(case4).items()})):
        got = match_cuda.match_reduce(**case, radius_px=20.0)
        want = match_reduce_plain(**case, radius_px=20.0)
        same = all(torch.equal(g, w.to(g.dtype)) for g, w in zip(got, want))
        print(f"phase 13c: K2 {name} {tuple(case['desc_a'].shape)} x "
              f"{tuple(case['desc_b'].shape)}: {'exact' if same else 'DIFFERS'}")
        if not same:
            failures.append(f"13c: K2 {name} differs from its plain version")
    print(f"phase 13c: K1 one launch over 4 frames at thresholds {list(MS_THRESHOLDS)}: max "
          f"|diff| {k1_err}")
    timed.append(("K1 batch 4x480x640 thresholds a frame",
                  lambda: fast_cuda.fast_pyramid_maps(levels4, thr4, *k1_args),
                  lambda: [[fast_maps(lvl[b], thr4[b], *k1_args) for b in range(B)]
                           for lvl in levels4]))
    timed.append(("K2 batch 4x2048x8192 guided r=20",
                  lambda: match_cuda.match_reduce(**case4, radius_px=20.0),
                  lambda: match_reduce_plain(**case4, radius_px=20.0)))

    # (e) entry() on the card.
    fn, args = entry()
    _, ys = fn(*args)
    s = ys["summary"].cpu().numpy()
    print(f"phase 13e: entry() on the card: summary {s.tolist()} (the JAX step: "
          f"{REF_ENTRY_SUMMARY})")
    if not (s[col["num_landmarks"]] == 256 and s[col["num_matches"]] == 0
            and abs(s[col["num_features"]] - REF_ENTRY_SUMMARY[0]) <= 0.01 * REF_ENTRY_SUMMARY[0]):
        failures.append(f"13e: entry() summary {s.tolist()}")

    # (f) the dry run: NCCL at one rank, two gloo ranks sharing the card.
    for n, shape, backend in ((1, "(1, 2, 8)", "nccl"), (2, "(2, 2, 8)",
                                                        "gloo-cuda-2-ranks-on-1-card")):
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            line = dryrun_multichip(n)
        path = [x for x in printed.getvalue().splitlines() if x.startswith("track_chunk_dp:")]
        print(f"phase 13f: dryrun_multichip({n}) in {time.perf_counter() - t0:.1f} s: {line}; "
              f"{path}  [{smi}]")
        if f"tracked_summary_shape={shape} backend={backend} device=cuda" not in line:
            failures.append(f"13f: {line}")
        if not path or "the captured BatchGraph" not in path[0]:
            failures.append(f"13f: stage 4 did not run through the graph: {path}")
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s  [{smi}]")
    if failures:
        raise AssertionError("multi-sequence phase: " + "; ".join(failures))
    return launches, fps, case4, cases


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from tinyslam_tpu_torch import eval_ate, slice_config
    from tinyslam_tpu_torch.data.synthetic import apply_photometrics
    from tinyslam_tpu_torch.frontend.orb import extract_features
    from tinyslam_tpu_torch.geometry.camera import PinholeCamera
    from tinyslam_tpu_torch.models.vo_device import DeviceVO, VOState, track_chunk
    from tinyslam_tpu_torch.ops import cuda_build, dupband_cuda, fast_cuda, hamming, match_cuda
    from tinyslam_tpu_torch.ops.fast import fast_maps
    from tinyslam_tpu_torch.ops.hamming import match_reduce_plain
    from tinyslam_tpu_torch.ops.image import build_pyramid
    from tinyslam_tpu_torch.utils.draws import Sampler

    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    t_main = time.perf_counter()

    # ---- 1. the card ------------------------------------------------------
    smi = _smi()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"devices {torch.cuda.device_count()}")
    nvcc = subprocess.run([cuda_build._find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    print("nvcc:", nvcc.strip().splitlines()[-1])

    # ---- 2. build -----------------------------------------------------------
    path, log, secs = cuda_build.build()
    cuda_build.load_library()
    print(f"build: {secs:.1f} s -> {path.name}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print("  ptxas:", line.strip())

    cfg = slice_config()
    fe = cfg.frontend
    room, cam, poses = _orbit()
    t0 = time.perf_counter()
    frames = eval_ate.render_clean(_orbit_scene, (), len(poses))
    print(f"rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s")

    # ---- 3. K1 against plain ---------------------------------------------
    thr = torch.tensor(fe.threshold, dtype=torch.float32, device=dev)
    args = (thr, fe.border, fe.streak_length, fe.blur_sigma)
    timed = []      # (label, kernel call, plain call), timed in phase 7
    names = ("score_raw", "score_nms", "m10", "m01", "blurred")
    # EuRoC's width, with real-camera photometrics (noise, vignetting).
    cam_e = PinholeCamera.create(fx=458.654, fy=457.296, cx=375.5, cy=239.5)
    frame_e = apply_photometrics(room.render(cam_e, *poses[0], 752, 480),
                                 np.random.default_rng(9)).astype(np.float32) / 255.0
    k1_err = 0.0
    k1_levels = {}
    for label, image in (("", frames[0]), (" 752x480", frame_e)):
        levels = build_pyramid(torch.from_numpy(image).to(dev), fe.num_levels)
        run_k = lambda levels=levels: fast_cuda.fast_pyramid_maps(levels, *args)  # noqa: E731
        run_p = lambda levels=levels: [fast_maps(lvl, *args) for lvl in levels]  # noqa: E731
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        for lvl, g_maps, w_maps in zip(levels, got, want):
            for name, g, w in zip(names, g_maps, w_maps):
                err = float((g - w).abs().max())
                if not torch.equal(g, w):
                    raise AssertionError(f"K1 {name} at {tuple(lvl.shape)}: not "
                                         f"bit-equal (max |diff| {err})")
                k1_err = max(k1_err, err)
            print(f"K1 {tuple(lvl.shape)}: corners {int((g_maps[1] > 0).sum())}, "
                  f"bit-equal, max |diff| {k1_err}")
        timed.append((f"K1 pyramid{label}", run_k, run_p))
        k1_levels[label] = levels
    levels = k1_levels[""]
    for lvl in levels:      # one level a launch: the per-level split
        timed.append((f"K1 level {tuple(lvl.shape)}",
                      lambda lvl=lvl: fast_cuda.fast_score_map_fused(lvl, *args),
                      lambda lvl=lvl: fast_maps(lvl, *args)))
    k1_pixels = sum(lvl.numel() for lvl in levels)

    # ---- 4. K2 against plain ---------------------------------------------
    seed_feats = extract_features(torch.from_numpy(frames[0]).to(dev), thr, fe)
    feats1 = extract_features(torch.from_numpy(frames[1]).to(dev), thr, fe)
    m_state = _seeded(cfg, seed_feats, room, cam, poses[0]).map
    R0 = torch.from_numpy(poses[0][0]).to(dev)
    t0_ = torch.from_numpy(poses[0][1]).to(dev)
    pc = m_state.X @ R0.T + t0_
    proj = torch.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                        cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    rng = np.random.default_rng(5)
    n, m = fe.max_features, cfg.vo.max_map_points
    rdesc_b = rng.integers(0, 2**32 - 1, (m, 8), np.uint32)
    rdesc_b[rng.integers(0, m, m // 5)] = rdesc_b[rng.integers(0, m, m // 5)]
    rdesc_a = rdesc_b[rng.integers(0, m, n)].copy()
    rdesc_a[:, 0] ^= rng.integers(0, 2**8, n).astype(np.uint32)
    T = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    rand_case = dict(
        desc_a=T(rdesc_a.view(np.int32)), valid_a=T(rng.random(n) > 0.1),
        desc_b=T(rdesc_b.view(np.int32)), valid_b=T(rng.random(m) > 0.1),
        xy_a=T(rng.uniform(0, 640, (n, 2)).astype(np.float32)),
        proj_b=T(rng.uniform(0, 640, (m, 2)).astype(np.float32)))
    real = dict(desc_a=feats1.desc, valid_a=feats1.valid, desc_b=m_state.desc,
                valid_b=m_state.valid, xy_a=feats1.xy, proj_b=proj)
    unguided = lambda c: {k: v for k, v in c.items() if k not in ("xy_a", "proj_b")}
    # Keyframe insertion and the two-view bootstrap match a frame's features
    # to another frame's without a gate; a keyframe re-observes the map
    # guided at r=32, relocalization matches it guided at r=64, then
    # unguided.
    kf_pair = dict(desc_a=feats1.desc, valid_a=feats1.valid, desc_b=seed_feats.desc,
                   valid_b=seed_feats.valid)
    # An explicit (N, M) pair mask (not on the main path): the guided gate
    # at r=20 written out as a mask, and a random third of the keyframe pairs.
    du = real["xy_a"][:, None, 0] - real["proj_b"][None, :, 0]
    dv = real["xy_a"][:, None, 1] - real["proj_b"][None, :, 1]
    gate_mask = du * du + dv * dv < hamming.gate_radius2(20.0)
    kf_mask = T(np.random.default_rng(6).random((n, n)) < 0.35)
    cases = [("real guided r=20", real, 20.0), ("real guided r=8", real, 8.0),
             ("real unguided", unguided(real), 0.0),
             ("random guided r=20", rand_case, 20.0),
             ("random unguided", unguided(rand_case), 0.0),
             ("keyframe unguided", kf_pair, 0.0),
             ("keyframe guided r=32", real, 32.0),
             ("relocalization guided r=64", real, 64.0),
             ("masked real r=20 gate", unguided(real) | {"pair_mask": gate_mask}, 0.0),
             ("masked keyframe random", kf_pair | {"pair_mask": kf_mask}, 0.0)]
    for name, case, r in cases:
        got = match_cuda.match_reduce(**case, radius_px=r)
        want = match_reduce_plain(**case, radius_px=r)
        for label, g, w in zip(("best", "second", "idx_b", "col_idx"), got, want):
            if not torch.equal(g, w.to(g.dtype)):
                bad = int((g != w).sum())
                raise AssertionError(f"K2 {name}: {label} differs at {bad} slots")
        if name == "masked real r=20 gate":     # the mask of the gate = the gate
            guided = match_cuda.match_reduce(**real, radius_px=20.0)
            if not all(torch.equal(g, w) for g, w in zip(got, guided)):
                raise AssertionError("K2 masked by the r=20 gate differs from guided r=20")
        n_match = int(((got[0] <= cfg.matcher.max_distance)
                       & (got[0].float() <= cfg.matcher.ratio * got[1].float())).sum())
        print(f"K2 {name}: N={case['desc_a'].shape[0]} M={case['desc_b'].shape[0]} "
              f"exact; rows passing distance+ratio {n_match}")
    # The keyframe triangulation's duplicate test and local band: frame 1's
    # features against the seeded map seen from pose 0 (2048 x 8192).
    z_m = pc[:, 2].contiguous()
    in_view = (m_state.valid & (z_m > 0.02) & (proj[:, 0] > 0) & (proj[:, 0] < 2 * cam.cx + 1)
               & (proj[:, 1] > 0) & (proj[:, 1] < 2 * cam.cy + 1))
    db_args = (feats1.xy, feats1.desc, proj[:, 0].contiguous(), proj[:, 1].contiguous(), z_m,
               m_state.desc, m_state.valid, in_view, cfg.vo.dup_radius_px)
    for label, g, w in zip(("dup", "z_local", "n_neigh"), dupband_cuda.dup_band(*db_args),
                           dupband_cuda.dup_band_plain(*db_args)):
        if not torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                           w.view(torch.int32) if w.is_floating_point() else w):
            raise AssertionError(f"dup_band 2048x8192: {label} differs at "
                                 f"{int((g != w).sum())} rows")
        if label == "n_neigh":
            db_neigh = w
    print(f"dup_band N={n} M={m} r={cfg.vo.dup_radius_px}: bit-equal; map points in view "
          f"{int(in_view.sum())}, neighbours within 40 px a row: mean "
          f"{float(db_neigh.float().mean()):.1f}, max {int(db_neigh.max())}")
    timed.append(("dup_band 2048x8192", lambda: dupband_cuda.dup_band(*db_args),
                  lambda: dupband_cuda.dup_band_plain(*db_args)))
    k2_shapes = {}          # the main path's shapes, timed in phase 7
    for name, case, r in cases:
        if not name.startswith("random"):
            k2_shapes[f"K2 {name}"] = (case, r)
            timed.append((f"K2 {name}",
                          lambda case=case, r=r: match_cuda.match_reduce(**case, radius_px=r),
                          lambda case=case, r=r: match_reduce_plain(**case, radius_px=r)))

    # ---- 5. the slice on the card ----------------------------------------
    torch.cuda.synchronize()
    fast_cuda.LAUNCHES = 0
    match_cuda.LAUNCHES = 0
    dupband_cuda.LAUNCHES = 0
    feats0 = extract_features(torch.from_numpy(frames[0]).to(dev), thr, fe)
    seed = _seeded(cfg, feats0, room, cam, poses[0])
    print(f"seeded map: {int(seed.map.valid.sum())} landmarks of "
          f"{cfg.vo.max_map_points}")
    vo = DeviceVO(cfg, cam, chunk=CHUNK, device=dev)
    vo.state = seed
    chunk_s = []    # the first chunk is the warm-up
    for c in range((N_FRAMES - 1) // CHUNK):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        for im in frames[1 + c * CHUNK: 1 + (c + 1) * CHUNK]:
            vo.process(im)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t_start)
    vo.flush()
    launches = {"fast_score_map_fused": fast_cuda.LAUNCHES,
                "match_reduce_streaming": match_cuda.LAUNCHES,
                "dup_band": dupband_cuda.LAUNCHES}
    stats = vo.stats
    n_timed = N_FRAMES - 1 - CHUNK
    print("inliers per frame:", [s.num_inliers for s in stats], f" [{card}]")
    print(f"tracked fps (frames {CHUNK + 1}-{N_FRAMES - 1}, after a warm-up "
          f"chunk): {n_timed / sum(chunk_s[1:]):.2f}; ms/frame per chunk "
          f"{[round(t * 1e3 / CHUNK, 3) for t in chunk_s]}  [{smi}]")

    tracked = sum(s.tracking for s in stats)
    est = vo.positions
    gt = _centres([p[0] for p in poses[1:N_FRAMES]], [p[1] for p in poses[1:N_FRAMES]])
    if est.shape != (N_FRAMES - 1, 3) or not np.isfinite(est).all():
        raise AssertionError(f"trajectory shape {est.shape} or non-finite")
    err = np.linalg.norm(est - gt, axis=1)
    print(f"tracked {tracked}/{N_FRAMES - 1}; camera-centre error vs ground "
          f"truth: max {err.max():.4f} m, mean {err.mean():.4f} m")
    if tracked != N_FRAMES - 1:
        raise AssertionError(f"tracked only {tracked}/{N_FRAMES - 1} frames")
    if not err.max() < 0.05:
        raise AssertionError(f"camera-centre error {err.max():.4f} m >= 0.05 m")
    print("launches during the slice:", launches)
    if launches["fast_score_map_fused"] != N_FRAMES:
        raise AssertionError(f"K1 launched {launches['fast_score_map_fused']} "
                             f"times, expected {N_FRAMES} (one a frame)")
    if launches["match_reduce_streaming"] < N_FRAMES - 1:
        raise AssertionError(f"K2 launched {launches['match_reduce_streaming']} "
                             f"times, expected >= {N_FRAMES - 1}")

    # Reference on a small input: the same slice on the CPU (plain
    # versions, no kernels) over the first chunk must agree with the card.
    cpu_state = VOState.from_numpy(seed.to_numpy(), "cpu")
    _, ys = track_chunk(cam, cfg, cpu_state,
                        torch.from_numpy(np.stack(frames[1:1 + CHUNK])),
                        [True] * CHUNK, Sampler(0))
    cpu_c = _centres(ys["R"].numpy(), ys["t"].numpy())
    cpu_in = ys["summary"][:, 2].numpy()
    gpu_in = np.array([s.num_inliers for s in stats[:CHUNK]])
    dc = float(np.abs(cpu_c - est[:CHUNK]).max())
    din = float(np.max(np.abs(cpu_in - gpu_in) / np.maximum(cpu_in, 1)))
    print(f"card vs CPU plain path, frames 1-{CHUNK}: max centre diff {dc:.2e} m, "
          f"max relative inlier diff {din:.4f}")
    if not (dc < 2e-3 and din <= 0.02):
        raise AssertionError("card and CPU plain path disagree")

    # ---- 6. keyframes and windowed BA on the card -------------------------
    kf_launches, kf_insert, kf_run = _keyframe_phase(cam, room, poses, frames, dev, smi)

    # ---- 8. DeviceVO from frame 0: bootstrap, relocalization, reboot ------
    boot_launches, reloc_frame, boot_run = _bootstrap_phase(cam, poses, frames, dev, smi)

    # ---- 17. the captured graph against the plain path, phases 6 and 8 ---------
    # Here, before any profiler has slowed this process's launches: 17a
    # compares the two paths' frames/s.
    graph_launches, graph_replay = _graph_phase(cam, frames, dev, smi, kf_run, boot_run)

    # ---- 13. B sequences as one batch, entry() and the dry run ---------------
    # Here, before any profiler has slowed this process's graph launches:
    # 13d compares the batched graph's frames/s with serial graphs'.
    ms_launches, _, case4, ms_cases = _multiseq_phase(cam, room, poses, frames, dev, smi,
                                                      timed)

    # ---- 9. Sim(3) loop closure: DeviceSlam, the async back-end, Slam, CLI --
    slam_launches, pg_orbit, slam_records = _slam_phase(cam, poses, frames, dev, smi)
    assembly = [_assembly_check("phase 9 orbit", pg_orbit, smi)]

    # ---- 18a. the SLAM layer's captured programs against their eager runs ------
    slam_eager = _slam_graph_phase("phase 18a (phase 9's stages)", slam_records, dev, smi,
                                   timing=True)

    # ---- 10. the datasets: render, write, load, the command line ----------
    data_launches = _dataset_phase(dev, smi)

    # ---- 11. checkpoint and resume, crash recovery, heartbeat, profiling ---
    rec_launches = _recovery_phase(cam, room, poses, frames, dev, smi, cfg, seed,
                                   1e3 * sum(chunk_s[1:]) / n_timed)
    _difference_pins(dev, smi)
    _replay_trace(graph_replay, dev, smi)      # 17f
    del graph_replay
    _slam_replay_trace(slam_records, dev, smi)  # 18c
    _batch_replay_trace(cam, ms_cases, dev, smi)  # 13g
    del ms_cases

    # ---- 12. the distributed layer: mesh, frontend_dp, sharded BA and graphs --
    dist_launches = _dist_phase(frames, dev, smi, timed)

    # ---- 14. the accuracy eval: fr1_loop-like under four samplers --------------
    used = _graph_replays()
    loop_launches, loop_runs, pg_loop, loop_records = _loop_phase(dev, smi)
    _graphs_of_phase("phase 14 (Sampler(0)-(3))", used, smi)
    assembly.append(_assembly_check("phase 14 fr1_loop", pg_loop, smi))
    _slam_graph_phase("phase 18b (phase 14's Sampler(0) stages)", loop_records, dev, smi,
                      timing=False)

    # ---- 15. the error budget on fr1_loop-like under Sampler(0) ----------------
    budget_launches = _budget_phase(dev, smi, loop_runs[0])

    # ---- 16. the bench: its tracked row on the orbit, its front-end row --------
    bench_launches = _bench_phase(frames, smi)

    # ---- 7. kernel times -----------------------------------------------------
    # Last: once the profiler has run in a process, every later launch
    # costs more on the host, which would distort the tracked fps above.
    ins_wall = _time_ms(kf_insert, reps=5, warmup=1)
    ins_dev = _device_ms(kf_insert, reps=5)
    print(f"one keyframe insertion (window full, BA included): wall {ins_wall:.3f} ms, "
          f"device {_shown(ins_dev)}, card busy {_busy(ins_dev, ins_wall)}  [{smi}]")
    ms = {}
    for label, run_k, run_p in timed:
        # Device time from queued launches between CUDA events; the
        # profiler's sum beside it (its traces have shortened kernels: K2
        # over four sequences once read below its operations bound).
        ms[label] = (_queued_ms(run_k), _queued_ms(run_p, reps=3))
        print(f"{label}: device kernel {ms[label][0]:.4f} ms (profiler "
              f"{_shown(_device_ms(run_k), 4)}), plain {ms[label][1]:.4f} ms; wall per call "
              f"kernel {_time_ms(run_k):.4f} ms, plain {_time_ms(run_p, reps=5, warmup=1):.4f} ms  "
              f"[{smi}]")
    k1_ms, k1_plain_ms = ms["K1 pyramid"]
    # K1 bound: each level read once and five maps written, or its flops.
    k1_bytes = 4 * k1_pixels * 6 + 4
    k1_bound = _bound_ms(k1_bytes, K1_FLOPS_PER_PIXEL * k1_pixels, FP32_FLOPS_PER_S)
    print(f"K1 one frame ({len(levels)} levels, 1 launch), device: kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.4f} ms, one launch a level "
          f"{sum(v[0] for k, v in ms.items() if k.startswith('K1 level')):.4f} ms; bound "
          f"{k1_bound[0]:.5f} ms ({k1_bound[1]}, {k1_bytes} B), kernel at "
          f"{100 * k1_bound[0] / k1_ms:.1f}% of it  [{smi}]")
    e_pixels = sum(lvl.numel() for lvl in k1_levels[" 752x480"])
    e_bound = _bound_ms(4 * e_pixels * 6 + 4, K1_FLOPS_PER_PIXEL * e_pixels, FP32_FLOPS_PER_S)
    e_ms = ms["K1 pyramid 752x480"][0]
    print(f"K1 one 752x480 frame ({len(levels)} levels, 1 launch), device: kernel "
          f"{e_ms:.4f} ms, plain {ms['K1 pyramid 752x480'][1]:.4f} ms; bound "
          f"{e_bound[0]:.5f} ms ({e_bound[1]}), kernel at {100 * e_bound[0] / e_ms:.1f}% "
          f"of it  [{smi}]")
    b_label = f"K1 batch {N_DP_FRAMES}x480x640"
    b_bound = _bound_ms(N_DP_FRAMES * k1_bytes - 4 * (N_DP_FRAMES - 1),
                        N_DP_FRAMES * K1_FLOPS_PER_PIXEL * k1_pixels, FP32_FLOPS_PER_S)
    print(f"K1 one launch over {N_DP_FRAMES} frames of 640x480 (phase 12b), device: kernel "
          f"{ms[b_label][0]:.4f} ms ({1e3 * ms[b_label][0] / N_DP_FRAMES:.2f} us a frame), "
          f"plain {ms[b_label][1]:.4f} ms; bound {b_bound[0]:.5f} ms ({b_bound[1]}), kernel "
          f"at {100 * b_bound[0] / ms[b_label][0]:.1f}% of it; launches on phase 12's path "
          f"{dist_launches['fast_score_map_fused']}  [{smi}]")
    k2_bound = {}
    for label, (case, r) in k2_shapes.items():
        n_, m_ = case["desc_a"].shape[0], case["desc_b"].shape[0]
        used = case if r > 0 else {k: v for k, v in case.items() if k not in ("xy_a", "proj_b")}
        io = sum(v.numel() * v.element_size() for v in used.values()) + 4 * (3 * n_ + m_)
        k2_bound[label] = _bound_ms(io, 2 * n_ * m_ * 256, INT8_OPS_PER_S)
        print(f"{label}: bound {k2_bound[label][0]:.5f} ms ({k2_bound[label][1]}), kernel "
              f"{ms[label][0]:.4f} ms at {100 * k2_bound[label][0] / ms[label][0]:.1f}% "
              f"of it  [{smi}]")
    lib_ms = {name: _library_ms(case["desc_a"], case["desc_b"], smi)
              for name, case in (("2048x8192", real), ("2048x2048", kf_pair),
                                 ("4x2048x8192", case4))}
    # Phase 13's launches over four sequences: K1 at four thresholds, K2 at
    # four (features, map) pairs, each gated by its own projections.
    label = "K1 batch 4x480x640 thresholds a frame"
    k1_b4 = _bound_ms(4 * (k1_bytes - 4) + 16, 4 * K1_FLOPS_PER_PIXEL * k1_pixels,
                      FP32_FLOPS_PER_S)
    print(f"{label} (phase 13), device: kernel {ms[label][0]:.4f} ms "
          f"({1e3 * ms[label][0] / 4:.2f} us a frame), plain {ms[label][1]:.4f} ms; bound "
          f"{k1_b4[0]:.5f} ms ({k1_b4[1]}), kernel at {100 * k1_b4[0] / ms[label][0]:.1f}% of "
          f"it; launches on phase 13's path {ms_launches['fast_score_map_fused']}  [{smi}]")
    label = "K2 batch 4x2048x8192 guided r=20"
    b_, n_, m_ = case4["desc_b"].shape[0], case4["desc_a"].shape[1], case4["desc_b"].shape[1]
    io = sum(v.numel() * v.element_size() for v in case4.values()) + 4 * b_ * (3 * n_ + m_)
    k2_b4 = _bound_ms(io, b_ * 2 * n_ * m_ * 256, INT8_OPS_PER_S)
    print(f"{label} (phase 13), device: kernel {ms[label][0]:.4f} ms, plain "
          f"{ms[label][1]:.4f} ms; bound {k2_b4[0]:.5f} ms ({k2_b4[1]}), kernel at "
          f"{100 * k2_b4[0] / ms[label][0]:.1f}% of it; library (bf16 bmm of the four "
          f"distance matrices) {lib_ms['4x2048x8192']} ms; launches on phase 13's path "
          f"{ms_launches['match_reduce_streaming']}  [{smi}]")
    k2_ms, k2_plain_ms = ms["K2 real guided r=20"]
    # The duplicate test's bound: its inputs read once (the rows' pixels
    # and descriptors, the map's projections, depths, descriptors and two
    # masks) and its outputs written once, or the squared pixel distance of
    # every pair (2 subtractions, 2 products, 1 sum) at the float32 rate.
    db_bytes = sum(x.numel() * x.element_size() for x in db_args[:-1]) + n * (1 + 4 + 4)
    db_bound = _bound_ms(db_bytes, 5 * n * m, FP32_FLOPS_PER_S)
    db_ms, db_plain_ms = ms["dup_band 2048x8192"]
    db_launches = sum(x["dup_band"]
                      for x in (launches, kf_launches, boot_launches, slam_launches,
                                data_launches, rec_launches, dist_launches, ms_launches,
                                loop_launches, budget_launches, bench_launches,
                                graph_launches))
    torch.cuda.synchronize()
    db_overflow = int(dupband_cuda.overflow_rows(dev))
    print(f"dup_band 2048x8192 (keyframe triangulation), device: kernel {db_ms:.4f} ms, plain "
          f"{db_plain_ms:.4f} ms; bound {db_bound[0]:.5f} ms ({db_bound[1]}, {db_bytes} B), "
          f"kernel at {100 * db_bound[0] / db_ms:.1f}% of it; launches on the main path "
          f"{db_launches} (phase 13's {ms_launches['dup_band']}, phase 17's "
          f"{graph_launches['dup_band']}), rows through the overflow pass {db_overflow}  [{smi}]")
    # A relocalization frame's trace is the largest; it goes last.
    rel_wall = _time_ms(reloc_frame, reps=5, warmup=1)
    rel_dev = _device_ms(reloc_frame, reps=5)
    print(f"one relocalization frame (phase 8d, guided): wall {rel_wall:.3f} ms, device "
          f"{_shown(rel_dev)}, card busy {_busy(rel_dev, rel_wall)}  [{smi}]")
    # The SLAM layer's stages on phase 9's first inputs: the eager function
    # (the plain version) under the profiler beside phase 18a's captured
    # program (one replay; its card ms from CUDA events).
    for name, (plain, g_wall, e_wall, card_ms) in slam_eager.items():
        e_dev = _device_ms(plain, reps=2)
        print(f"one {name} (phase 9's first; upload and readback included), eager: wall "
              f"{e_wall:.3f} ms, device {_shown(e_dev)}, card busy {_busy(e_dev, e_wall)}; "
              f"captured (phase 18a): wall {g_wall:.3f} ms, card {card_ms:.3f} ms a replay  "
              f"[{smi}]")
    # The assembly kernel at the main path's shapes and at a large graph's:
    # one Gauss-Newton iteration's H and g; bound by the bytes of the terms,
    # the plan and H.
    assembly.append(_assembly_check(f"{N_CHAIN} nodes", _chain_assembly(N_CHAIN, dev), smi))
    pg_ms = {}
    for label, run_k, run_p, run_lib, nbytes, terms, longest in assembly:
        pg_ms[label] = (_queued_ms(run_k), _queued_ms(run_p, reps=3), _queued_ms(run_lib),
                        _bound_ms(nbytes, terms, FP32_FLOPS_PER_S))
        k_ms, p_ms, l_ms, (b_ms, b_by) = pg_ms[label]
        print(f"{label}: device kernel {k_ms:.4f} ms (profiler "
              f"{_shown(_device_ms(run_k), 4)}), plain (its order in PyTorch) {p_ms:.4f} ms, "
              f"library (index_add_, atomics) "
              f"{l_ms:.4f} ms, kernel / library {k_ms / l_ms:.2f}; bound {b_ms:.5f} ms "
              f"({b_by}, {nbytes} B), kernel at {100 * b_ms / k_ms:.1f}% of it; longest "
              f"segment {longest} terms  [{smi}]")
    pg_label = "assembly phase 14 fr1_loop"

    kernels = [
        {"name": "fast_score_map_fused", "route": "cuda",
         "source": "tinyslam_tpu_torch/csrc/fast.cu",
         "replaces": "tinyslam_tpu/ops/fast_pallas.py:258",
         "launches": sum(x["fast_score_map_fused"]
                         for x in (launches, kf_launches, boot_launches, slam_launches,
                                   data_launches, rec_launches, dist_launches, ms_launches,
                                   loop_launches, budget_launches, bench_launches,
                                   graph_launches)),
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None},
        {"name": "match_reduce_streaming", "route": "cuda",
         "source": "tinyslam_tpu_torch/csrc/match.cu",
         "replaces": "tinyslam_tpu/ops/match_pallas.py:140",
         "launches": sum(x["match_reduce_streaming"]
                         for x in (launches, kf_launches, boot_launches, slam_launches,
                                   data_launches, rec_launches, dist_launches, ms_launches,
                                   loop_launches, budget_launches, bench_launches,
                                   graph_launches)),
         "max_abs_err": 0.0, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound["K2 real guided r=20"][0],
         "bound_by": k2_bound["K2 real guided r=20"][1], "library_ms": lib_ms["2048x8192"]},
        {"name": "ordered_scatter_add", "route": "cuda",
         "source": "tinyslam_tpu_torch/csrc/scatter.cu",
         "replaces": "tinyslam_tpu/backend/pose_graph.py:116",
         "launches": sum(x.get("ordered_scatter_add", 0)
                         for x in (slam_launches, loop_launches, budget_launches)),
         "max_abs_err": 0.0, "ms": pg_ms[pg_label][0], "plain_ms": pg_ms[pg_label][1],
         "bound_ms": pg_ms[pg_label][3][0], "bound_by": pg_ms[pg_label][3][1],
         "library_ms": pg_ms[pg_label][2]},
        {"name": "dup_band", "route": "cuda",
         "source": "tinyslam_tpu_torch/csrc/dupband.cu",
         "replaces": "none (XLA: tinyslam_tpu/models/vo.py:204)",
         "launches": db_launches, "overflow_rows": db_overflow,
         "max_abs_err": 0.0, "ms": db_ms, "plain_ms": db_plain_ms,
         "bound_ms": db_bound[0], "bound_by": db_bound[1], "library_ms": None},
    ]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_main:.1f} s  [{smi}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        _dist_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
    sys.exit(0)

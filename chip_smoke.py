#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ofps_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device: requires CUDA, prints the ``nvidia-smi`` name and power limit;
2. build: compiles the hand kernels from ``ofps_torch/csrc`` with nvcc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes its paths give it: the 1080p serving step (B=4), the cv block
   matcher (B=1: flow mode at 1080x1920 and 270x480, the guarded 67x120
   s=6 level), the robust LK's guard (67x120, win 7), the warp at the five
   LK level shapes (B=1 and B=4), the 2-D sweep at the big-level shapes of
   ``FlowParams(axis_sep=False)`` and ``FlowParams(search=2)``.  The 3x3
   median has no launch of its own: it runs in the staging of the next
   level's refine (``median_in``), so its cases are the serving step's four
   median-taking refines, held against the plain median then the plain
   refine, and timed beside the same refines without it.  Almeida's
   RANSAC kernels at B=8 and B=32, multiview's at codec all4's shapes
   (B=8, masked and dense), the latter bit for bit, and homography's at
   the four cells' shapes (B=8 and B=32, dense and masked: the same winner
   and inlier count, each family and its |t| within 1e-6 rad on a rotating
   camera, within ``homography_tolerance`` on a translating plane, the pick
   the first minimum of the kernels' own norms);
4. slice: ``StreamPipeline`` (almeida + homography + block_motion, the
   serving configuration of ``bench.py``) at 1080p, B=4, 8 frames of a
   textured scene moving 3 px per frame with a patch moving 12 px per
   frame; checks that every kernel ran as often per step as the pyramid
   needs, the shift is recovered, both estimators' poses are finite, the
   detector reports the patch, and the plain path agrees (homography's
   rotation family by family: see ``homography_vs_plain``); almeida's and
   homography's kernels run once a replay of the consumers' graph (here,
   in all4 and in the codec phase);
   all4: ``bench.py``'s all-estimator configuration (almeida + homography
   + multiview + libmv + block_motion) at 1080p, B=8, 8 frames of the same
   scene; checks the flow kernels' launches per step, every pose finite on
   every frame, libmv's carried chain set (``has``) with a finite
   translation, one replay of the consumers' CUDA graph per step and no
   eager step, the graph against the same calls made eagerly over two
   consecutive steps (the carry passing through the graph), and multiview's
   and libmv's rotations from one step on each frame's kernel-path grid
   and plain-path grid with the same carry and draws (``EPI_STEP_DEG``,
   ``EPI_STEP_OFF``);
5. refine_2d: ``dense_flow`` at 1080p with ``axis_sep=False`` and with
   ``search=2``, whose big levels run the 2-D sweep; checks the launches
   and the plain path;
6. cv: the cv decoder's step (``CvFlowStep``, decoder defaults: 5 levels,
   150x84 grid, contrast mask) at 1080p on 8 frames of the scene with its
   left third at 2% contrast, for the block matcher and the robust LK (warp
   and guard kernels); checks the launches, that the mask drops some cells
   and keeps others, the 3 px pan in the valid cells and the plain path;
7. estimators: a synthetic camera rotation (0.3-0.6 deg per stream, 20% of
   the vectors corrupted) on the 84x150 serving lattice, B=4, built on the
   CPU (``rotation_grid``) so that the JAX package can run the same
   inputs, through the consumers' CUDA graph of all four estimators and
   eagerly with the same draws (equal within 1e-6), homography, multiview
   and libmv against almeida per stream (within 0.05 deg), and the masked
   path (a third of the points invalid, ``dense=False``), held the same;
8. codec: the codec-MV path (``run_batch`` over ``.mvec`` streams ->
   ``step_from_flow`` with masked RANSAC and the sparse detector in the
   consumers' graph) on a fixture built on the CPU (``codec_fixture``: 8
   streams x 24 frames of quarter-pel vectors on the 120 x 68 macroblock
   lattice of 1080p for a camera rotation, 12% intra blocks dropped, 8%
   outliers, the last stream ending after 16 frames), capacity 16,384, all
   four estimators + block_motion with ``drop_ended``: checks the steps,
   the vector counts, finite poses, the short stream's frozen pose, one
   graph replay per step, each estimator's error against the ground truth
   (``CODEC_GT_DEG``), the detector and almeida against the port on the
   CPU (same files, same uniforms), graph against eager over two steps
   with libmv's carry, and a ``LivePipeline.set_property`` that the next
   step sees with no new graph; times ``step_from_flow`` at B=1, 4, 8
   (almeida + homography) and B=8 (all four), the upload and the live
   step, with the consumers' kernels per replay;
9. apps: the command line (``ofps_torch.apps.cli.main``) and the
   single-stream apps on one ``codec_fixture`` stream (B=1, capacity
   16,384): ``run-config`` tracking with all four estimators (the stats
   and keyframe CSVs, each estimator's GT error within ``CODEC_GT_DEG``,
   finite poses, one graph capture and one replay per frame, a
   ``props_hook`` change that reaches its frame and no other, ms per
   frame); ``run-config`` detection on a stream whose block of vectors
   moves on some frames (its ranges equal to the port's on the CPU and to
   the fixture's); ``flow-extract`` at 150x84 (each ``.flo`` within
   ``FLO_TOL`` of the CPU's); ``watch`` for 8 frames on an ephemeral port
   (``/state.json`` over loopback, then the server shut down);
   ``bench-e2e`` over the fixture at 8 streams; and ``dense_flow_stream``
   at 1080p, B=4, 6 frames (its flow launches per step, bit-equal to the
   chained ``dense_flow_warm``, the 3 px pan, ms per frame);
10. parallel: the multi-device layer (``ofps_torch.parallel``) with the
   serving configuration at 1080p, B=8: a (stream, space) = (2, 2) mesh
   and a (2, 1) stream-only mesh, one card per position where the machine
   has four, else every position on cuda:0 (asked for explicitly and
   printed).  Checks the (2, 1) step against the unsharded one within
   1e-6 (homography family by family), the (2, 2) step's flow launches per
   band and step, its almeida deltas and grid against the unsharded
   step's, its full-resolution flow and warm carry against the same route
   on the plain versions of the kernels and against the unsharded flow
   (JAX's spatial gate, 16 px off every edge), the codec-MV step through
   ``run_batch`` on the (2, 1) mesh against the unsharded one; times the
   three steps (median of 3 captures x PAR_STEPS steps, with the host's
   enqueue time); a world-size-1 NCCL group, and with two or more cards two NCCL
   processes (one card each) and a launch and a graph replay on cuda:1;
11. matrix: the evaluation matrix (``ofps_torch.apps.evaluate_matrix``) on
   the JAX package's gate clips 0 and 5 (288x288, 10 frames) as B=2
   streams, its codec route fixed by MATRIX_CODEC and printed first: the
   four sources' fields (the cv step's flow launches per step at the
   clips' 4-level pyramid, MATRIX_LAUNCHES), the cv step's kernels against
   their plain versions at those shapes, each step from the same inputs
   (MISMATCH_PX, MAX_MISMATCH_SHARE), every source x configuration through
   one ``StreamPipeline`` per configuration, each cell that JAX's
   tests/test_evaluate_matrix.py gates under its ceiling (MATRIX_GATES),
   libmv 8-point's ATE and direction on translation path 0, and the card
   against the port on the CPU on scripts/check_backend_agreement.py's
   cells with the same draws (AGREE_DEG); prints its own seconds;
12. samples: BASELINE's sample configs (``ofps_torch.apps.samples
   --no-video`` into a temporary directory; no FFmpeg on the H100 host):
   ``run-config`` on ``synthetic_almeida_gt.json`` and
   ``synthetic_all_gt.json`` through ``cli.main`` on the card and with
   ``--device cpu`` (each estimator's mean rotation error under its bar,
   SAMPLES_ALMEIDA_DEG / SAMPLES_EST_DEG, the card within AGREE_DEG of the
   CPU, one graph capture and one replay per frame and no eager step on
   the card, the stages' ms per frame), and ``basic_detect``'s detector
   and settings on the committed ``detect.mvec`` (its ranges equal to
   SAMPLES_DETECT_RANGES, what the CPU finds); prints its own seconds;
13. bench: the port's benchmark (``python -m ofps_torch.apps.cli --device
   cuda bench`` at ``bench.py``'s defaults, its JSON record printed on a
   ``bench ...`` line): every frames/s finite and above 0 and every
   checksum finite; the flow kernels' launches per step of the bench's flow
   chain and of its serving step (BENCH_LAUNCHES); then the timing tools:
   ``bench_estimators`` (to a temporary table), ``profile_pipeline``
   (BENCH_PROFILE_STAGES), ``profile_libmv``, ``perf_lab`` (base, parts,
   ablate) and ``check_backend_agreement`` (exit 0: every cell within its
   0.01 deg/frame); the two profiles at BENCH_PROFILE_ITERS chained calls;
   prints its own seconds;
14. timing: ms/step of the serving step at B=1, 4, 8, of the all-estimator
   step at B=8 and of the cv step for both algorithms, kernel and plain
   paths; the consumers' graph at B=4 with almeida alone, homography alone
   and both, and at B=8 with multiview alone, libmv alone and all four,
   and its CUDA kernels per replay (``torch.profiler`` on the same calls
   made eagerly); each kernel
   against its plain version and, where one exists, one PyTorch library
   call (CUDA events around back-to-back calls, ``ms``), and each kernel
   and library call alone on the device (``device_ms``: a CUDA graph of N
   calls replayed, so the host's launch cost drops out).

Prints one JSON line of per-kernel results, the ``nvidia-smi`` line, then,
as the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
T_START = time.perf_counter()
H, W = 1080, 1920
SHIFT = 3.0
OBJ, OBJ_SHIFT = 400, 12
SEED = 0
# Kernel vs plain: share of outputs off by more than 1e-3 px must stay
# below 0.1% (an argmin flip on a float32 near-tie moves a pixel by up to
# one candidate step); grid sums within 1e-5 in normalized units; the warp
# within 1e-5 (same expression order, -fmad=false: expected bit-exact).
MISMATCH_PX = 1e-3
MAX_MISMATCH_SHARE = 1e-3
GRID_TOL = 1e-5
WARP_TOL = 1e-5
# The cv step's kernel and plain paths: LK flow within 1e-4 px (only the
# warp differs, and it is exact); the block matcher's grid as the slice's.
LK_PATH_TOL = 1e-4
CV_PAN_TOL = 0.25
# The cv phase dims the left third of its frames to this contrast, so the
# contrast mask drops cells (valid must be neither none nor all of them).
LOW_CONTRAST = 0.02
# Rotations: the kernel and plain paths within 1e-4 (quaternion
# components); graph and eager within 1e-6; homography, multiview and
# libmv against almeida on the synthetic rotation within 0.05 deg, dense
# and masked.
ROT_PATH_TOL = 1e-4
GRAPH_TOL = 1e-6
EST_AGREE_DEG = 0.05
ESTIMATORS = ("almeida", "homography")
# bench.py's all-estimator configuration, at B=8.
ALL4 = ("almeida", "homography", "multiview", "libmv")
ALL4_BATCH = 8
# Multiview's and libmv's delta rotations from one step on a frame's
# kernel grid and on its plain grid, with the same carry and draws: 7
# frames x 8 streams.  The grids differ in ~0.09% of the entries (argmin
# flips on float32 near-ties).  A stream-frame counts as apart when its two
# rotations differ by more than EPI_STEP_DEG, a twelfth of the 0.118 deg
# pan, and EPI_STEP_OFF bounds how many may be (readings on an H100 in
# PERF.md).  Multiview reads at most 0.002 deg apart: none may be.  This
# pan is a pure camera rotation, degenerate for the fundamental matrix, and
# libmv's 512 near-tied 7-point hypotheses flip their winner on those few
# entries: 26 of 56 read 0.010-0.096 deg apart, so its bound, 3/4 of them,
# only catches a path that moves libmv on nearly every frame; the grid
# share and multiview hold the flow kernels.
EPI_STEP_DEG = 0.01
EPI_STEP_OFF = {"multiview": 0, "libmv": 42}

# The "codec" phase: 8 .mvec streams of 24 frames at 1920x1080 through
# run_batch at the reference's capacity of 16,384 vectors; the camera is
# run_batch's default (16:9, the 1080p aspect, and a 90 deg fov_y).
CODEC_STREAMS, CODEC_FRAMES, CODEC_CAPACITY = 8, 24, 16384
CODEC_FOV_Y = 90.0
CODEC_INTRA, CODEC_OUTLIERS = 0.12, 0.08
# The last stream ends early: run_batch(drop_ended=True) feeds it empty
# flows from then on, and its poses must stay frozen.
CODEC_SHORT = 16
# Mean rotation error per frame against the ground truth, every estimator
# on every stream (0.0002-0.0042 deg on an H100: PERF.md).
CODEC_GT_DEG = 0.05
# The detector and almeida on the card against the port on the CPU, same
# files and uniforms, over the first CODEC_CPU_FRAMES frames: detections
# equal, island fields within 1e-6, almeida's delta rotation of every step
# within 1e-4 deg (the float32 floor of its 30-step refit on ~1,000
# points: 0-9.7e-5 deg on an H100, PERF.md; the integrated rotation sums
# them and is printed).
CODEC_CPU_FRAMES = 6
CODEC_FIELD_TOL = 1e-6
CODEC_ROT_DEG = 1e-4

# The "apps" phase: the command line and the single-stream apps on one
# codec_fixture stream (B=1, capacity 16,384, all four estimators).  A
# props_hook sets almeida's inlier angle to 0 before frame APPS_HOOK_FRAME:
# no point passes, so that frame's almeida delta is the identity, and the
# frames before it equal the run without the hook within GRAPH_TOL.  The
# detection stream: a block of DET_BLOCK of the lattice moves DET_SHIFT_PX
# on the frames of DET_MOVING (inclusive ranges), the rest of the lattice
# jitters by under a quarter pel.  flow-extract on the card against the
# port on the CPU within FLO_TOL px (scatter_add's atomics sum in any
# order).  dense_flow_stream at 1080p, B=4, over STREAM_FRAMES frames.
APPS_HOOK_FRAME = 12
DET_BLOCK = (0.3, 0.7)
DET_SHIFT_PX = 12.0
DET_MOVING = ((4, 9), (13, 20))
DET_SETTINGS = {"max_frame_gap": 2, "min_frames": 3}
FLO_TOL = 1e-5
WATCH_FRAMES = 8
# Timed calls: of a plain path (a step, a kernel's plain version,
# flow-extract's densify), and of each codec step's three repeats.
PLAIN_ITERS, CODEC_STEPS = 2, 5
STREAM_FRAMES = 6

# The "parallel" phase: bench.py's serving step (almeida + homography +
# block_motion) at 1080p, B=PAR_BATCH, on a (stream, space) = (2, 2) mesh
# and a (2, 1) stream-only mesh: one card per position where the machine
# has four, else every position on cuda:0.  PAR_FRAMES frames of the
# serving scene (the first primes the state).  The stream-only step equals
# the unsharded one within GRAPH_TOL (homography's rotation family by
# family: its pick between two families of equal |t| is decided by
# rounding, which differs between a B=4 and a B=8 graph; ROADMAP Queue 3,
# homography_vs_plain).  The (2, 2) route's full-resolution flow and warm
# carry agree with the same route on the plain versions of the kernels
# (MISMATCH_PX, MAX_MISMATCH_SHARE: the kernels at the bands' shapes), and
# its flow meets JAX's own gate for its spatial route against the
# unsharded flow (tests/test_spatial_shard.py: mean EPE < SPATIAL_MEAN_PX
# and 99th percentile < SPATIAL_P99_PX, seams included, SPATIAL_BORDER px
# off every edge; the whole frame is printed too).  The (2, 2) step's grid
# meets the same gate against the unsharded step's grid over every cell
# outside the consumers' border margin, and its almeida deltas are within
# SPATIAL_DEG of the unsharded step's.  The codec-MV step on the (2, 1)
# mesh equals the unsharded one over PAR_CODEC_FRAMES frames of
# codec_fixture.  Steps are timed as the median of 3 captures (the
# correctness run's and two new pipelines) x PAR_STEPS steps.
PAR_BATCH, PAR_FRAMES, PAR_STEPS, PAR_CODEC_FRAMES = 8, 3, 5, 6
SPATIAL_BORDER = 16
SPATIAL_MEAN_PX, SPATIAL_P99_PX = 0.05, 0.75
SPATIAL_DEG = 0.05
# Flow launches per band per step on the (2, 2) mesh: a 1080 x (960 + 128)
# band (no halo at the frame's edge) keeps the frame's six levels and its
# choice of refine per level (ofps_torch/parallel/spatial.py): 1080x1088,
# 540x544, 270x272 and 135x136 axis-separable (as 135x240 is in the
# frame), 67x68 the 2-D sweep with search 1, the 33x34 coarsest level two
# s=6 sweeps and the guard; the medians of levels 5..2 ride in the refines
# of levels 4..1.
BAND_LAUNCHES = {"flow_refine": 4, "flow_refine_small": 3, "guard_select": 1,
                 "median3x3_uv": 4}

# The "matrix" phase: the evaluation matrix (ofps_torch.apps.evaluate_matrix)
# on the JAX package's gate clips 0 and 5 as B=2 streams, all four sources
# and all eight configurations over its 10 frames.  MATRIX_CODEC is fixed
# by what the H100 host has: no FFmpeg (no libav* headers or libraries;
# PERF.md), so the "av" source reads the committed .mvec vectors and
# "block"/"rlof" run the cv step on the rendered frames.
MATRIX_CODEC = "mvec"
MATRIX_CLIPS = (0, 5)
# JAX's ceilings, mean deg/frame per (source, clip) and configuration: a
# copy of tests/test_evaluate_matrix.py:43-75 (GATES), which imports JAX.
MATRIX_GATES = {
    ("gt-mv", 0): {"almeida": 1e-3, "almeida-ransac": 1e-3, "homography-ransac": 0.02,
                   "multiview-lmeds": 0.06, "libmv-7pt": 0.02},
    ("block", 0): {"almeida": 0.12, "almeida-ransac": 0.021, "homography-ransac": 0.055,
                   "multiview-lmeds": 0.03},
    ("block", 5): {"almeida": 0.017, "almeida-ransac": 0.016, "homography-ransac": 0.03,
                   "multiview-lmeds": 0.028},
    ("av", 0): {"almeida": 0.012, "almeida-ransac": 0.018, "homography-ransac": 0.09,
                "multiview-ransac": 0.035, "libmv-7pt": 0.030},
    ("av", 5): {"almeida": 0.010, "almeida-ransac": 0.015, "homography-ransac": 0.09},
    ("rlof", 0): {"almeida": 0.025, "almeida-ransac": 0.021},
    ("rlof", 5): {"almeida": 0.008, "almeida-ransac": 0.013},
}
# test_translation_matrix_cell's bars: translation path 0 with libmv
# 8-point, ATE under 10% of the path, direction error under 11 deg.
MATRIX_ATE_PCT, MATRIX_DIR_DEG = 10.0, 11.0
# The card against the port on the CPU, same fields and draws (made on the
# CPU): scripts/check_backend_agreement.py's cells (gt-mv, clips 0 and 5)
# and its tolerance, in deg/frame.
AGREE_CONFIGS = ("almeida-ransac", "homography-ransac", "multiview-ransac", "libmv-7pt",
                 "libmv-8pt")
AGREE_DEG = 0.01
# Flow launches per cv step on a 288x288 clip with 4 levels.  Block
# matching: 36x36 (coarsest) two s=6 sweeps and the guard, 72x72 and
# 144x144 the 2-D sweep (under fuse_min_pixels), 288x288 the axis-separable
# refine; the medians of levels 3 and 2 ride in the refines of levels 2
# and 1.  Robust LK: 3 warps per level and init, the coarsest level twice
# (warm and zero) and the guard.
MATRIX_LAUNCHES = {
    "block": {"flow_refine": 1, "flow_refine_small": 4, "median3x3_uv": 2},
    "rlof": {"warp_bilinear": 15},
}

# The "samples" phase: BASELINE's sample configs, made by
# ``python -m ofps_torch.apps.samples --no-video`` (FFmpeg is absent on the
# H100 host), through the command line on the card and on the CPU.  Mean
# rotation error per estimator, deg/frame: almeida's float32 floor and
# every estimator's bar; the card against the port on the CPU within the
# matrix phase's agreement tolerance (AGREE_DEG).
SAMPLES_TRACKING = ("synthetic_almeida_gt.json", "synthetic_all_gt.json")
SAMPLES_ALMEIDA_DEG = 1e-4
SAMPLES_EST_DEG = 0.01
# basic_detect's detector and settings on the committed vectors of its
# clip (the port's motion-extract of detect.avi): the ranges that
# tests/test_torch_samples.py asserts the CPU finds from the clip and from
# these vectors.
SAMPLES_DETECT_MVEC = "ofps_torch/eval_data/detect.mvec"
SAMPLES_DETECT_RANGES = [(1, 29)]

# The "bench" phase: the port's benchmark at its defaults, then its timing
# tools.  Flow launches per step of the bench's flow chain and serving step
# (1080p, 6 levels: the slice's counts, one guard a step).  The profile
# scripts' chained calls per window are cut from their defaults (96 and
# 48): their estimator stages run eagerly, ~10^4 launches a call.
BENCH_LAUNCHES = {"flow_refine": 4, "flow_refine_small": 3, "median3x3_uv": 4}
BENCH_LAUNCH_STEPS = 3
BENCH_PROFILE_STAGES = "flow,densify,almeida,homography,detector,step"
BENCH_PROFILE_ITERS = {"profile_pipeline": 16, "profile_libmv": 8}

# Roofline of one H100 SXM (published, dense, at 700 W): HBM3 bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Float32 operations per pixel that the functions need (not what a kernel
# repeats): one bilinear sample (2 adds, 4 clamps, 2 floors, 2 subs, 2
# one-minus, 8 muls, 3 adds); one |diff| (sub, abs, bf16 round), taken once
# per pixel and candidate; a separable win x win box sum, 2 (win - 1) adds
# per pixel; one upsampled flow plane (6 muls, 3 adds, the 2x scale).
WARP_OPS = 23
DIFF_OPS = 3
UPSAMPLE_OPS = 10


def box_ops(win: int) -> int:
    return 2 * (win - 1)


# Float32 operations per pixel of a 3x3 median of both flow planes: 19
# exchanges (a min and a max) each.
MEDIAN_OPS = 2 * 19 * 2

REPLACES = {
    "flow_refine": ("csrc/flow_refine.cu", "ofps_tpu/pallas/flow_refine.py:60"),
    "flow_refine_2d": (
        "csrc/flow_refine_small.cu",
        "ofps_tpu/pallas/flow_refine.py:60 (2-D mode, :396-480)"),
    "flow_refine_small": (
        "csrc/flow_refine_small.cu", "ofps_tpu/pallas/flow_refine_small.py:39"),
    "guard_select": (
        "csrc/flow_refine_small.cu", "ofps_tpu/pallas/flow_refine_small.py:231"),
    "median3x3_uv": (
        "csrc/level_refine.cuh", "ofps_tpu/pallas/flow_refine_small.py:196"),
    "warp_bilinear": ("csrc/warp.cu", "ofps_tpu/pallas/warp.py:46"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name} {time.perf_counter() - T_START:.1f} s] {msg}", flush=True)


def textured(torch, batch: int, h: int, w: int, device, seed: int):
    """(batch, h, w) blurred-noise texture in [~-100, ~100] (sigma 2 px)."""
    g = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn((batch, 1, h + 16, w + 16), generator=g, device=device)
    x = torch.arange(-6, 7, dtype=torch.float32, device=device)
    k = torch.exp(-(x * x) / 8.0)
    k = k / k.sum()
    img = torch.nn.functional.conv2d(noise, k.view(1, 1, 1, -1))
    img = torch.nn.functional.conv2d(img, k.view(1, 1, -1, 1))
    return (img[:, 0, 2 : 2 + h, 2 : 2 + w] * 300.0).contiguous()


def moving_frames(torch, frames: int, batch: int, h: int, w: int, device):
    """(T, B, h, w): frame t shows the texture moved right by SHIFT*t px,
    so the background flow from each frame to the next is u = +SHIFT, and
    an OBJ x OBJ patch of another texture moving right by OBJ_SHIFT px per
    frame (7.7% of a 1080p frame: a motion island the detector reports)."""
    s = int(SHIFT)
    base = textured(torch, batch, h, w + s * frames, device, SEED)
    patch = textured(torch, batch, OBJ, OBJ, device, SEED + 7)
    x0 = s * frames
    out = torch.stack([base[:, :, x0 - s * t : x0 - s * t + w] for t in range(frames)])
    y, x = (h - OBJ) // 2, w // 4
    for t in range(frames):
        out[t, :, y : y + OBJ, x + OBJ_SHIFT * t : x + OBJ_SHIFT * t + OBJ] = patch
    return out.contiguous()


def with_low_contrast_band(frames):
    """``frames`` (..., H, W) with the left third dimmed to 2% contrast, so
    that the cv decoder's contrast mask drops the cells there."""
    out = frames.contiguous().clone()
    out[..., : frames.shape[-1] // 3] *= LOW_CONTRAST
    return out


def time_ms(torch, fn, iters: int):
    """(ms, host ms) per call of ``fn`` after one warm-up call: CUDA
    events, and the host's time to enqueue the same calls (its clock stops
    before the final synchronize), near the event time when the host sets
    the pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def device_ms(torch, fn, n: int = 20, reps: int = 5) -> float:
    """Device ms per call of ``fn``: N calls captured in one CUDA graph
    after a warm-up, the graph replayed ``reps`` times between two CUDA
    events.  The host's per-call cost (Python, ctypes, allocation) is not in
    it; inputs stay warm in L2 where they fit (50 MB)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(n):
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
    ms = start.elapsed_time(end) / (n * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def sweep_cost(batch, h, w, hc, wc, n_cand, win, out_bytes=None):
    """(bytes, ops) of one refine launch at a (h, w) level from a (hc, wc)
    flow: i1, i2, the two flow planes read once, the two outputs written
    once; per pixel the warp, for each of ``n_cand`` candidates the |diff|,
    its box sum, the divide and the prior, then the selection (a compare
    per candidate, two parabolas), the upsample and the final add."""
    px = batch * h * w
    nbytes = 4 * (2 * px + 2 * batch * hc * wc) + (8 * px if out_bytes is None else out_bytes)
    per_px = (WARP_OPS + n_cand * (DIFF_OPS + box_ops(win) + 2) + n_cand + 2 * 8 + 2
              + (2 * UPSAMPLE_OPS if (hc, wc) != (h, w) else 0))
    return nbytes, px * per_px


class Case:
    """One kernel launch at a path shape: the kernel call, its plain
    version, how to compare them, the least ms the H100 could take for its
    (bytes, ops) by each of the two limits, and, where one PyTorch call
    computes the same function, that call."""

    def __init__(self, kcall, pcall, kind, shape, cost, library=None):
        self.kcall, self.pcall, self.kind, self.shape = kcall, pcall, kind, shape
        self.bytes_ms = 1e3 * cost[0] / HBM_BYTES_PER_S
        self.ops_ms = 1e3 * cost[1] / FP32_OPS_PER_S
        self.bound = max(self.bytes_ms, self.ops_ms)
        self.bound_by = "bytes" if self.bytes_ms >= self.ops_ms else "operations"
        self.library = library
        self.note = ""


def kernel_cases(torch, device, batch: int):
    """Per kernel: list of :class:`Case` at the shapes of the 1080p serving
    step (B=batch), the LK warp (B=1 and B=batch) and the big levels'
    2-D mode (B=batch), on a 3 px-shifted textured scene."""
    import torch.nn.functional as F

    from ofps_torch.kernels import flow_refine as kfr
    from ofps_torch.kernels import flow_refine_small as kfs
    from ofps_torch.kernels import warp as kwarp
    from ofps_torch.ops.flow_pyramid import FlowParams, border_margin_px
    from ofps_torch.ops.image import build_pyramid
    from ofps_torch.core.motion import grid_size_for

    frames = moving_frames(torch, 2, batch, H, W, device)
    p1, p2 = build_pyramid(frames[0], 6), build_pyramid(frames[1], 6)
    g = torch.Generator(device=device).manual_seed(SEED + 1)

    def flow_at(lvl, b=batch):
        """A smooth flow near the true shift at pyramid level ``lvl``."""
        hh, ww = p1[lvl].shape[-2:]
        n = torch.randn((b, 2, hh // 8 + 2, ww // 8 + 2), generator=g, device=device)
        n = torch.nn.functional.interpolate(n, size=(hh, ww), mode="bilinear")
        u = SHIFT / 2**lvl + 0.4 * n[:, 0]
        return u.contiguous(), (0.4 * n[:, 1]).contiguous()

    def shape(lvl, b=batch):
        return (b,) + tuple(p1[lvl].shape[-2:])

    def frame_pair(lvl, b=batch):
        return p1[lvl][:b].contiguous(), p2[lvl][:b].contiguous()

    def sweep_cases(lvl, b, u0, v0, s):
        """The 2-D sweep at level ``lvl`` from (u0, v0): its Case and the
        plain result."""
        args = (*frame_pair(lvl, b), u0, v0, s, win, bf16)
        case = Case(
            lambda a=args: kfs.flow_refine_small(*a),
            lambda a=args: kfs.flow_refine_small_plain(*a), ("flow", None), shape(lvl, b),
            sweep_cost(*shape(lvl, b), *u0.shape[-2:], (2 * s + 1) ** 2, win))
        return case, kfs.flow_refine_small_plain(*args)

    def guard_case(lvl, b, warm, zero, gwin):
        args = (*frame_pair(lvl, b), *warm, *zero, gwin)
        px = math.prod(shape(lvl, b))
        return Case(
            lambda a=args: kfs.guard_select(*a),
            lambda a=args: kfs.guard_select_plain(*a), ("flow", None), shape(lvl, b),
            # 6 planes in, 2 out; per pixel and flow: warp, |diff|, box sum,
            # divide; then the compare and two selects.
            (4 * 8 * px, px * (2 * (WARP_OPS + 2 + box_ops(gwin) + 1) + 3)))

    # A tree whose refine wrappers lack ``median_in`` (the parent of the
    # fused median, run by scripts/kernel_ab.py) launches the standalone
    # median and then the refine: the same function at the same shape.
    fused = "median_in" in inspect.signature(kfr.flow_refine).parameters

    def median_consumer(lvl):
        """The serving step's refine of level ``lvl`` from level ``lvl +
        1``'s flow, with the 3x3 median of that flow (a Case for
        "median3x3_uv") and without it (a Case for "median_consumers")."""
        uc, vc = flow_at(lvl + 1)
        i1, i2 = frame_pair(lvl)
        if lvl == 4:  # 67x120: the 2-D sweep, s=1
            kernel, plain = kfs.flow_refine_small, kfs.flow_refine_small_plain
            tail, n_cand = (1, win, bf16), 9
        else:
            kernel, plain = kfr.flow_refine, kfr.flow_refine_plain
            tail, n_cand = (win, bf16), 5
        nbytes, ops = sweep_cost(*shape(lvl), *uc.shape[-2:], n_cand, win)
        if fused:
            def with_median():
                return kernel(i1, i2, uc, vc, *tail, median_in=True)
        else:
            def with_median():
                return kernel(i1, i2, *kfs.median3x3_uv(uc, vc), *tail)
        return (
            Case(with_median,
                 lambda: plain(i1, i2, *kfs.median3x3_uv_plain(uc, vc), *tail),
                 ("flow", None), shape(lvl),
                 (nbytes, ops + MEDIAN_OPS * batch * uc.shape[-2] * uc.shape[-1])),
            Case(lambda: kernel(i1, i2, uc, vc, *tail), lambda: plain(i1, i2, uc, vc, *tail),
                 ("flow", None), shape(lvl), (nbytes, ops)),
        )

    win, bf16 = 5, torch.bfloat16
    gh_gw = grid_size_for(W, H)[::-1]
    plan = kfr.build_grid_plan(
        H, W, *gh_gw, border_px=border_margin_px(FlowParams(), H, W), device=device,
    )
    cases = {k: [] for k in REPLACES}
    cases["median_consumers"] = []
    # The serving step's axis-separable levels (B=batch): 1080x1920 with
    # the grid, 540x960, 270x480 and 135x240; the cv block matcher's (B=1,
    # flow mode): 1080x1920 and 270x480.
    for lvl, b, grid in ((0, batch, plan), (1, batch, None), (2, batch, None),
                         (3, batch, None), (0, 1, None), (2, 1, None)):
        uc, vc = flow_at(lvl + 1, b)
        args = (*frame_pair(lvl, b), uc, vc, win, bf16, grid)
        out_bytes = None if grid is None else 8 * b * gh_gw[0] * gh_gw[1]
        cases["flow_refine"].append(Case(
            lambda a=args: kfr.flow_refine(*a),
            lambda a=args: kfr.flow_refine_plain(*a),
            ("grid", plan) if grid is not None else ("flow", None), shape(lvl, b),
            sweep_cost(*shape(lvl, b), *uc.shape[-2:], 5, win, out_bytes)))
    # The big levels' 2-D mode: 1080x1920 s=1 from 540x960 (axis_sep=False)
    # and 540x960 s=2 from 270x480 (search=2).
    for lvl, s in ((0, 1), (1, 2)):
        cases["flow_refine_2d"].append(sweep_cases(lvl, batch, *flow_at(lvl + 1), s)[0])
    # 67x120: s=1 from the upsampled 33x60 flow.
    cases["flow_refine_small"].append(sweep_cases(4, batch, *flow_at(5), 1)[0])
    # The guarded coarsest level: s=6 from the warm init and from zero,
    # then the guard; the serving step's at 33x60 (B=batch), the cv block
    # matcher's at 67x120 (B=1) and, on the same flows, the robust LK's
    # (67x120, B=1, its window of 7).
    for lvl, b, gwins in ((5, batch, (win,)), (4, 1, (win, 7))):
        uw, vw = flow_at(lvl, b)
        zero = torch.zeros_like(uw)
        warm_case, warm = sweep_cases(lvl, b, uw, vw, 6)
        zero_case, zeroed = sweep_cases(lvl, b, zero, zero, 6)
        cases["flow_refine_small"] += [warm_case, zero_case]
        for gwin in gwins:
            case = guard_case(lvl, b, warm, zeroed, gwin)
            # The pixels where the guard takes the zero-init side: a guard
            # that always kept the warm side disagrees with the plain
            # version there.
            picked = case.pcall()
            case.note = "win {}: zero side taken at {:.2e} of pixels".format(
                gwin,
                ((picked[0] == zeroed[0]) & (zeroed[0] != warm[0])).float().mean().item())
            cases["guard_select"].append(case)
    # The median after levels 5, 4, 3 and 2, in the refine of the next
    # finer level: 67x120 (s=1), 135x240, 270x480, 540x960.
    for lvl in (4, 3, 2, 1):
        with_median, without = median_consumer(lvl)
        cases["median3x3_uv"].append(with_median)
        cases["median_consumers"].append(without)
    # The LK warp at its five level shapes, B=1 and B=batch.  The library
    # yardstick is grid_sample (border padding, align_corners) on the same
    # sample coordinates, normalized outside the timed call.
    for b in (1, batch):
        for lvl in range(5):
            img = p2[lvl][:b].contiguous()
            u, v = (x[:b].contiguous() for x in flow_at(lvl))
            hh, ww = img.shape[-2:]
            ys = torch.arange(hh, dtype=torch.float32, device=device)[:, None]
            xs = torch.arange(ww, dtype=torch.float32, device=device)[None, :]
            grid = torch.stack(
                [(xs + u) * (2.0 / (ww - 1)) - 1.0, (ys + v) * (2.0 / (hh - 1)) - 1.0], dim=-1)

            def library(i=img[:, None], gr=grid):
                return F.grid_sample(i, gr, mode="bilinear", padding_mode="border",
                                     align_corners=True)[:, 0]

            px = b * hh * ww
            cases["warp_bilinear"].append(Case(
                lambda a=(img, u, v): kwarp.warp_bilinear(*a),
                lambda a=(img, u, v): kwarp.warp_bilinear_plain(*a), ("warp", None),
                (b, hh, ww), (4 * 4 * px, px * WARP_OPS), library))
    return cases


# Almeida's RANSAC has no TPU kernel (the JAX package leaves it to XLA);
# its three hand kernels stand in for the plain PyTorch RANSAC.  Against
# the plain version on the card: the same winner and count in every
# stream, the rotation within ALMEIDA_TOL rad (only the refit's sums take
# another order).
REPLACES["almeida_ransac"] = (
    "csrc/almeida_ransac.cu", "none: ofps_tpu/estimators/almeida.py:171 solve_ypr_ransac (XLA)")
ALMEIDA_TOL = 1e-6
ALMEIDA_LAUNCHES = 3  # a call: fit, score, refit
ALMEIDA_H, ALMEIDA_S = 200, 1000  # hypotheses, eval points (the defaults)


def almeida_cost(batch: int, h: int, s: int):
    """(bytes, ops) of one almeida_ransac call: per stream the hypotheses'
    3 points (an int64 index, pos, motion, mask: 28 bytes each) and the
    eval subset (index, weight, pos, motion: 28 bytes a point) read once,
    the rotation, winner and count written; float32 operations 12,183 a
    fit, 70 a hypothesis's test of a point and 2,226 a refit point (30
    iterations each), a transcendental counted as one."""
    return batch * (28 * 3 * h + 28 * s + 24), batch * (12183 * h + 70 * h * s + 2226 * s)


def almeida_cases(torch, device):
    """:class:`Case` s of ``kernels/almeida.ransac`` at the main path's
    shapes, B=8 and B=32: the frames cells' dense 84x150 grid and the
    codec cells' masked rows (CODEC_CAPACITY points: the lattice's with a
    third invalid, then invalid rows), on :func:`rotation_grid`'s fixture,
    with the bound a 0-d tensor as the consumers' graph takes it."""
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.core.motion import SparseFlow, field_to_sparse
    from ofps_torch.estimators import almeida as est
    from ofps_torch.kernels import almeida as kalm
    from ofps_torch.ops import robust

    cam = StandardCamera.create(W / H, 60.0)
    cases = []
    for b in (8, 32):
        rgrid, _, mask = rotation_grid(torch, b, SEED + 20 + b)
        lattice = field_to_sparse(rgrid)
        pad = CODEC_CAPACITY - mask.shape[-1]
        for masked in (False, True):
            flow = lattice if not masked else SparseFlow(*(
                torch.cat([x, x.new_zeros(x.shape[:1] + (pad,) + x.shape[2:])], dim=1)
                for x in (lattice.pos, lattice.motion, mask)))
            flow = SparseFlow(*(x.to(device) for x in flow))
            n = flow.mask.shape[-1]
            gen = torch.Generator(device=device).manual_seed(SEED + 30 + b)
            fit_idx = robust.as_indices(
                robust.draw(gen, (b,), n, ALMEIDA_H, 3, device, dense=not masked),
                flow.mask).to(torch.int64)
            if masked:
                eidx, w_e = robust.eval_subset(flow.mask, ALMEIDA_S)
            else:
                eidx, w_e = (x.expand((b,) + x.shape)
                             for x in robust.dense_eval_subset(n, ALMEIDA_S, str(device)))
            bound = est._inlier_bound(torch.tensor(0.05, device=device), flow.pos)
            args = (cam, flow, fit_idx, eidx, w_e, bound)
            case = Case(lambda a=args: kalm.ransac(*a), lambda a=args: kalm.ransac_plain(*a),
                        ("almeida", None), (b, n), almeida_cost(b, ALMEIDA_H, ALMEIDA_S))
            case.note = f"B={b} {'masked' if masked else 'dense'}"
            cases.append(case)
    return cases


# Multiview's RANSAC has no TPU kernel either (XLA); its hand kernels stand
# in for the plain robust_fit + five-point + eight-point refits.  At codec
# all4's shapes (B=8, 218 hypotheses) they are the plain version on the
# card bit for bit: the refit E, the LO model, the inliers, their count and
# the winner, in every stream.
REPLACES["multiview_ransac"] = (
    "csrc/multiview_ransac.cu",
    "none: ofps_tpu/estimators/multiview.py:116 robust_fit + five_point_essential (XLA)")


def multiview_launches():
    """Launches of one multiview estimate on the kernels: the normalized
    coordinates' one and those of ``kernels/multiview.ransac``."""
    from ofps_torch.kernels import multiview as kmv

    return 1 + kmv.LAUNCHES


def multiview_cost(batch: int, h: int, n: int, s: int, p: int, f: int):
    """(bytes, ops) of one multiview_ransac call: per stream the draws (5
    int64 indices and 5 points a hypothesis), the eval subset and all
    points read once, the winner's errors and inliers written; float32
    operations ~60,000 a five-point chart solve (two a hypothesis), 37 a
    Sampson test (prescore twice, finalists, the winner over all points) and
    ~60 a point of each of the three eight-point refits' PyTorch work, a
    transcendental counted as one."""
    nbytes = batch * (5 * 24 * h + 28 * s + 20 * n + 8 * n)
    ops = batch * (2 * 60000 * h + 37 * (2 * 28 * h * p + f * s + n) + 3 * 60 * n)
    return nbytes, ops


def multiview_cases(torch, device):
    """:class:`Case` s of ``kernels/multiview.ransac`` at codec all4's
    shapes, B=8 (the shapes whose card arithmetic the kernels copy): the
    masked codec rows (CODEC_CAPACITY points: the lattice's with a third
    invalid, then invalid rows) and the dense 84x150 lattice, on
    :func:`rotation_grid`'s fixture, the threshold a 0-d tensor as the
    consumers' graph takes it."""
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.core.motion import SparseFlow, field_to_sparse
    from ofps_torch.estimators import multiview as mv
    from ofps_torch.estimators.base import camera_intrinsics, create_estimator
    from ofps_torch.kernels import multiview as kmv

    cam = StandardCamera.create(W / H, 60.0)
    est = create_estimator("multiview")
    params, h = est.params, mv.hypothesis_count(est.params)
    k, kinv = camera_intrinsics(cam, str(device))
    thr = params.max_error / ((k[0, 0] + k[1, 1]) * 0.5)
    b = ALL4_BATCH
    rgrid, _, mask = rotation_grid(torch, b, SEED + 40)
    lattice = field_to_sparse(rgrid)
    pad = CODEC_CAPACITY - mask.shape[-1]
    cases = []
    for masked in (True, False):
        flow = lattice if not masked else SparseFlow(*(
            torch.cat([x, x.new_zeros(x.shape[:1] + (pad,) + x.shape[2:])], dim=1)
            for x in (lattice.pos, lattice.motion, mask)))
        flow = SparseFlow(*(x.to(device) for x in flow))
        n = flow.mask.shape[-1]
        x1 = mv.normalized_coords(kinv, flow.pos)
        x2 = mv.normalized_coords(kinv, flow.pos + flow.motion)
        gen = torch.Generator(device=device).manual_seed(SEED + 41)
        idx = est.draw(gen, (b,), n, device, dense=not masked)
        args = (x1, x2, flow.mask, thr, params, h, idx, not masked)
        s = min(params.eval_cap, n)
        case = Case(lambda a=args: kmv.ransac(*a), lambda a=args: kmv.ransac_plain(*a),
                    ("multiview", None), (b, n),
                    multiview_cost(b, h, n, s, params.prescore_cap, params.finalists))
        case.note = f"B={b} {'masked' if masked else 'dense'}"
        cases.append(case)
    return cases


# Homography's robust fit has no TPU kernel either (XLA); its three hand
# kernels stand in for the plain robust_fit + refit + polish + decomposition.
# Against the plain version on the card: the same winner and final inlier
# count in every stream; each family's rotation and translation norm
# within HOMOGRAPHY_TOL of the plain one's on a rotating camera (only the
# refit's sums take another order), within homography_tolerance on a
# translating plane; the rotation the first minimum of the kernels' own
# norms.
REPLACES["homography_ransac"] = (
    "csrc/homography_ransac.cu",
    "none: ofps_tpu/estimators/homography.py robust_fit + dlt/gn refit + decomposition (XLA)")
HOMOGRAPHY_TOL = 1e-6
HOMOGRAPHY_LAUNCHES = 3  # a call: fit, score, refit


def homography_cost(batch: int, h: int, n: int, s: int, p: int, f: int, passes: int = 13):
    """(bytes, ops) of one homography_ransac call: per stream the draws (4
    int64 indices and 4 points a hypothesis), the eval subset and all
    points read once (a stream's points fit in the shared memory of the
    refit's cluster), the final inliers written; float32 operations ~3,800
    a 4-point DLT, 14 a transfer test (prescore twice, finalists, each of
    the plain refit's ``passes`` over the points up to twice), ~60 more a
    point of a refit pass's sums, a square root or division counted as
    one."""
    nbytes = batch * (4 * 28 * h + 28 * s + 20 * n + 4 * n)
    ops = batch * (3800 * h + 14 * (2 * h * p + f * s) + passes * (2 * 14 + 60) * n)
    return nbytes, ops


def homography_tolerance(torch, h, camera):
    """Per stream of refined homographies ``h`` (B, 3, 3) the angle (rad)
    within which two float32 decompositions one rounding apart agree:
    HOMOGRAPHY_TOL on the pure-rotation branch (s1^2 - s3^2 < 1e-4), and
    there plus 2 float32 epsilons over min(s1^2 - 1, 1 - s3^2) elsewhere,
    the distance between the eigenvalues whose eigenvectors build the
    families (``tests/homography_checks.py``)."""
    k = camera.intrinsics().double()
    s = torch.linalg.svdvals(torch.linalg.inv(k) @ h.double().cpu() @ k)
    s1sq, s3sq = (s[:, 0] / s[:, 1]) ** 2, (s[:, 2] / s[:, 1]) ** 2
    apart = torch.minimum(s1sq - 1, 1 - s3sq).clamp(min=1e-30)
    eps = torch.finfo(torch.float32).eps
    return torch.where(s1sq - s3sq < 1e-4, HOMOGRAPHY_TOL, HOMOGRAPHY_TOL + 2 * eps / apart)


def plane_grid(torch, batch: int, seed: int):
    """:func:`rotation_grid`'s fixture with the camera also translating by
    0.03 over a plane (H = K (R + t n^T) K^-1 on the lattice, t mostly
    across the plane's normal n), far from the decomposition's
    pure-rotation branch: the grids (batch, 84, 150, 2), 20% of the vectors
    replaced by N(0, 0.01) noise, and the masked path's weights."""
    from ofps_torch.core import quat
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.core.motion import field_to_sparse, grid_size_for

    gw, gh = grid_size_for(W, H)
    k = StandardCamera.create(W / H, 60.0).intrinsics().double()
    g = torch.Generator().manual_seed(seed)
    pos = field_to_sparse(torch.zeros((gh, gw, 2))).pos.double()
    axis = torch.randn((batch, 3), generator=g)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = torch.deg2rad(0.3 + 0.3 * torch.rand((batch, 1), generator=g)) / 2
    r = quat.to_matrix3(torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)).double()
    n = torch.cat([0.3 * torch.randn((batch, 2), generator=g), torch.ones((batch, 1))], -1)
    n = (n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)).double()
    t = torch.randn((batch, 3), generator=g).double()
    t = t - 0.8 * (t * n).sum(-1, keepdim=True) * n
    t = 0.03 * t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    hs = k @ (r + t[:, :, None] * n[:, None, :]) @ torch.linalg.inv(k)
    x2 = torch.cat([pos, torch.ones_like(pos[:, :1])], -1) @ hs.transpose(-2, -1)
    motion = (x2[..., :2] / x2[..., 2:] - pos).float()
    bad = torch.rand(motion.shape[:-1], generator=g) < 0.2
    noise = 0.01 * torch.randn(motion.shape, generator=g)
    motion = torch.where(bad[..., None], noise, motion)
    mask = (torch.rand((batch, gh * gw), generator=g) >= 1 / 3).float()
    return motion.reshape(batch, gh, gw, 2).contiguous(), mask


def homography_cases(torch, device, plane: bool = False):
    """:class:`Case` s of ``kernels/homography.ransac`` against
    ``estimators/homography.ransac_plain`` at the four cells' shapes: the
    frames cells' dense 84x150 grid at B=8 and B=32 and the codec cells'
    masked rows (CODEC_CAPACITY points: the lattice's with a third invalid,
    then invalid rows) at B=32 and B=8, on :func:`rotation_grid`'s fixture
    (``plane``: :func:`plane_grid`'s), the threshold a 0-d tensor as the
    consumers' graph takes it."""
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.core.motion import SparseFlow, field_to_sparse
    from ofps_torch.estimators import homography as he
    from ofps_torch.kernels import homography as kh

    cam = StandardCamera.create(W / H, 60.0)
    est = he.make_homography()
    params, h = est.params, he.hypothesis_count(est.params)
    thr = torch.tensor(params.max_error, device=device)
    cases = []
    for b, masked in ((8, False), (32, False), (32, True), (8, True)):
        rgrid, mask = (plane_grid(torch, b, SEED + 60 + b) if plane else
                       rotation_grid(torch, b, SEED + 50 + b)[::2])
        lattice = field_to_sparse(rgrid)
        pad = CODEC_CAPACITY - mask.shape[-1]
        flow = lattice if not masked else SparseFlow(*(
            torch.cat([x, x.new_zeros(x.shape[:1] + (pad,) + x.shape[2:])], dim=1)
            for x in (lattice.pos, lattice.motion, mask)))
        flow = SparseFlow(*(x.to(device) for x in flow))
        n = flow.mask.shape[-1]
        gen = torch.Generator(device=device).manual_seed(SEED + 51 + b)
        idx = est.draw(gen, (b,), n, device, dense=not masked)
        args = (flow, cam, params, h, thr, not masked, idx)
        if not kh.on_kernels(params, flow.pos, h):
            fail(f"homography_cases: B={b} N={n} would not run on the kernels")
        case = Case(lambda a=args: kh.ransac(*a), lambda a=args: he.ransac_plain(*a),
                    ("homography", cam, plane), (b, n),
                    homography_cost(b, h, n, min(params.eval_cap, n), params.prescore_cap,
                                    params.finalists))
        case.note = f"B={b} {'masked' if masked else 'dense'}{' plane' if plane else ''}"
        cases.append(case)
    return cases


def family_gap(torch, got, ref):
    """Per stream the angle (rad) between ``got``'s two family rotations
    (B, 2, 4) and ``ref``'s, family by family: the larger of the two
    families' angles, in the pairing (as they stand or swapped) where it is
    smaller, since the two versions may order the families either way."""
    from ofps_torch.core import quat

    d = quat.angle_to(got[:, :, None, :].double(), ref[:, None, :, :].double())
    return torch.minimum(torch.maximum(d[:, 0, 0], d[:, 1, 1]),
                         torch.maximum(d[:, 0, 1], d[:, 1, 0]))


def replay_kernels(torch, pipe, state, field, draws, props=None, part="almeida_"):
    """The kernels whose names hold ``part`` in one replay of ``pipe``'s
    captured consumers' graph, from ``torch.profiler`` (CUPTI reports a
    graph's kernels, by their demangled names: ``(anonymous
    namespace)::almeida_fit_kernel(...)``); None where the profiler sees no
    CUDA events."""
    from torch.profiler import ProfilerActivity, profile

    graphs = len(pipe.graphs.calls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe._run_consumers(state, field, draws, props)
        torch.cuda.synchronize()
    if len(pipe.graphs.calls) != graphs:
        fail("replay_kernels: the call captured a new graph")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(part in e.name for e in kernels) if kernels else None


def rounded(xs, nd: int = 4):
    return [None if x is None else round(x, nd) for x in xs]


def time_cases(torch, items):
    """Per case: the kernel's and the library call's ms (CUDA events around
    back-to-back calls) and device ms (:func:`device_ms`)."""
    out = {"ms": [], "device_ms": [], "library_ms": [], "library_device_ms": []}
    for c in items:
        out["ms"].append(time_ms(torch, c.kcall, 20)[0])
        out["device_ms"].append(device_ms(torch, c.kcall))
        lib = c.library
        out["library_ms"].append(time_ms(torch, lib, 20)[0] if lib else None)
        out["library_device_ms"].append(device_ms(torch, lib) if lib else None)
    return out


def compare(torch, got, ref, kind):
    """(max_abs_err, mismatch_share, ok) of kernel output vs plain; for
    almeida (rotation gap in rad, share of streams with another winner or
    count, ok)."""
    if kind[0] == "multiview":
        (ge, gf), (re, rf) = got, ref
        pairs = [(ge, re), *zip(gf, rf, strict=True)]
        off = torch.zeros(ge.shape[0], dtype=torch.bool, device=ge.device)
        for g, r in pairs:
            same = (g == r) | (torch.isnan(g) & torch.isnan(r)) if g.is_floating_point() else g == r
            off |= ~same.reshape(ge.shape[0], -1).all(-1)
        gap = (ge - re).abs().max().item()
        return gap, off.float().mean().item(), not bool(off.any())
    if kind[0] == "homography":
        tol = homography_tolerance(torch, ref.h, kind[1]) if kind[2] else HOMOGRAPHY_TOL
        gap = family_gap(torch, got.quats, ref.quats).cpu()
        tgap = (got.tnorm.double().sqrt() - ref.tnorm.double().sqrt()).abs().amax(-1).cpu()
        first = torch.argmin(got.tnorm, dim=-1)
        picked = torch.equal(got.rot, got.quats[torch.arange(first.shape[0], device=first.device),
                                                first])
        off = ((got.fit.best != ref.fit.best) | (got.fit.score != ref.fit.score)).float()
        finite = bool(torch.isfinite(got.rot).all())
        held = bool((gap <= tol).all() and (tgap <= tol).all())
        return (gap.max().item(), off.mean().item(),
                not bool(off.any()) and held and picked and finite)
    if kind[0] == "almeida":
        from ofps_torch.core import quat

        gap = quat.angle_to(got[0].double(), ref[0].double()).max().item()
        off = ((got[1].long() != ref[1]) | (got[2].long() != ref[2])).float().mean().item()
        return gap, off, off == 0 and gap <= ALMEIDA_TOL and bool(torch.isfinite(got[0]).all())
    if kind[0] == "grid":
        plan = kind[1]
        errs = []
        for g, r, n in zip(got, ref, (W, H)):
            errs.append(((g - r).abs() / (plan.counts * n)).max().item())
        err = max(errs)
        return err, 0.0, err <= GRID_TOL and all(
            bool(torch.isfinite(g).all()) for g in got)
    if kind[0] == "warp":
        err = (got - ref).abs().max().item()
        return err, 0.0, err <= WARP_TOL and bool(torch.isfinite(got).all())
    d = torch.maximum((got[0] - ref[0]).abs(), (got[1] - ref[1]).abs())
    share = (d > MISMATCH_PX).float().mean().item()
    finite = bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    return d.max().item(), share, finite and share < MAX_MISMATCH_SHARE


def make_pipeline(device, plain: bool, estimators=ESTIMATORS, fov_y: float = 60.0,
                  shardings=None):
    """The serving configuration: ``estimators`` (bench.py's almeida +
    homography by default) + block_motion, serving mode, 1080p camera
    (the codec phase takes run_batch's fov_y, CODEC_FOV_Y), on ``device``
    or on the mesh of ``shardings``."""
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.detectors.base import create_detector
    from ofps_torch.estimators.base import create_estimator
    from ofps_torch.parallel.stream import StreamPipeline

    return StreamPipeline(
        StandardCamera.create(W / H, fov_y),
        [create_estimator(name) for name in estimators],
        create_detector("block_motion"),
        emit_dense_flow=False,
        device=device,
        plain=plain,
        shardings=shardings,
    )


def launch_counters(kfr, kfs, kwarp, kalm):
    """Per kernel: the (wrapper, attribute) launch counts that it sums.
    The 3x3 median is counted where a refine launch takes it; almeida's,
    multiview's and homography's kernels are launched from the host where a
    consumers' graph is captured (twice a capture: its warm-up and the captured call)
    or run eagerly, and replay inside the graph."""
    from ofps_torch.kernels import homography as kh
    from ofps_torch.kernels import multiview as kmv

    return {
        "flow_refine": [(kfr.flow_refine, "launches")],
        "flow_refine_2d": [(kfs.flow_refine_small, "launches")],
        "flow_refine_small": [(kfs.flow_refine_small, "launches")],
        "guard_select": [(kfs.guard_select, "launches")],
        "median3x3_uv": [(kfr.flow_refine, "median_in_launches"),
                         (kfs.flow_refine_small, "median_in_launches")],
        "warp_bilinear": [(kwarp.warp_bilinear, "launches")],
        "almeida_ransac": [(kalm.ransac, "launches")],
        "multiview_ransac": [(kmv.ransac, "launches")],
        "homography_ransac": [(kh.ransac, "launches")],
    }


def count_launches(torch, counters, fn):
    """Run ``fn`` with every launch count set to 0 just before it; returns
    (its result, {name: launches} read just after)."""
    for pairs in counters.values():
        for wrapper, attr in pairs:
            setattr(wrapper, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: sum(getattr(w, a) for w, a in pairs) for k, pairs in counters.items()}


def check_per_step(path, launches, per_step):
    """Fail unless each kernel ran ``per_step`` times per guarded coarsest
    level (one per step)."""
    steps = launches["guard_select"]
    want = {k: n * steps for k, n in per_step.items()}
    if steps <= 0 or any(launches[k] != n for k, n in want.items()):
        fail(f"{path}: launches {launches}, expected {want} over {steps} steps")


def run_cv(torch, device, frames, use_rlof: bool, plain: bool):
    """The cv step over ``frames`` (T, H, W) from a zero warm start, as the
    decoder runs it from its second frame on: [(flow, grid, valid)]."""
    from ofps_torch.decoders.cv import CvFlowStep

    step = CvFlowStep(H, W, use_rlof=use_rlof, device=device, plain=plain)
    prev = torch.zeros((H, W, 2), dtype=torch.float32, device=device)
    outs = []
    for t in range(1, frames.shape[0]):
        outs.append(step(frames[t - 1], frames[t], prev))
        prev = outs[-1][0]
    return outs


def frame_draws(torch, pipe, seed: int, frames: int, batch: int, n: int, device):
    """The draws ``step_from_frames`` takes, frame by frame, from a
    generator seeded with ``seed`` (estimator by estimator)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [tuple(e.draw(gen, (batch,), n, device) for e in pipe.estimators)
            for _ in range(frames)]


def homography_vs_plain(torch, pipe_p, outs, outs_p, draws):
    """Homography's delta rotations on the kernel path against the plain
    path's, frame by frame and stream by stream, with the same draws.

    The decomposition's two families have equal |t| in exact arithmetic,
    so outside the pure-rotation branch the estimator's pick between them
    is decided by rounding, and two paths whose grids differ in a few
    entries may pick different families.  So each kernel-path rotation is
    held against the nearer of the plain path's two family rotations
    (computed on the plain grid with the same draws).  Returns (max |diff|
    to the nearer family, the number of picks of the other family, the
    max |diff| between the two paths' picks)."""
    from ofps_torch.core.motion import field_to_sparse
    from ofps_torch.estimators import homography as he

    i = ESTIMATORS.index("homography")
    est = pipe_p.estimators[i]
    near_err, flips, picked_err = 0.0, 0, 0.0
    for o, p, d in zip(outs, outs_p, draws):
        fit = he.ransac_plain(field_to_sparse(p.grid), pipe_p.camera, est.params,
                              he.hypothesis_count(est.params), est.params.max_error, dense=True,
                              idx=d[i])
        quats, tnorm = fit.quats, fit.tnorm  # (B, 2, 4), (B, 2)
        near = (quats - o.delta_rot[i][:, None, :]).abs().amax(dim=-1).min(dim=-1)
        near_err = max(near_err, near.values.max().item())
        flips += int((near.indices != torch.argmin(tnorm, dim=-1)).sum().item())
        picked_err = max(picked_err, (o.delta_rot[i] - p.delta_rot[i]).abs().max().item())
    return near_err, flips, picked_err


def consumer_diff(torch, a, b) -> float:
    """Max |a - b| over the tensors of two ``_consume`` outputs: poses,
    deltas, carries and detection."""
    from ofps_torch.pipeline.graphs import leaves

    return max((x.float() - y.float()).abs().max().item() for x, y in zip(leaves(a), leaves(b)))


def run_all4(torch, device, counters):
    """The all-estimator configuration at 1080p, B=ALL4_BATCH, over 8
    frames: checks as the module docstring says; returns the flow kernels'
    launches."""
    from ofps_torch.core import quat

    batch = ALL4_BATCH
    frames = moving_frames(torch, 8, batch, H, W, device)
    pipe = make_pipeline(device, plain=False, estimators=ALL4)
    gen = torch.Generator(device=device).manual_seed(SEED)
    (state, outs), counts = count_launches(
        torch, counters, lambda: pipe.scan_frames(pipe.init_state(batch, H, W), frames, gen))
    launches = {k: counts[k] for k in ("flow_refine", "flow_refine_small", "guard_select",
                                       "median3x3_uv")}
    check_per_step("all4", launches, {"flow_refine": 4, "flow_refine_small": 3, "median3x3_uv": 4})
    # Multiview's kernels: launched from the host twice a capture, and all
    # of one call's in every replay of the consumers' graph.
    mv_host = counts["multiview_ransac"]
    if mv_host != 2 * multiview_launches() * len(pipe.graphs.calls):
        fail(f"all4: {mv_host} host launches of multiview's kernels for "
             f"{len(pipe.graphs.calls)} capture(s)")
    steps = frames.shape[0]
    finite = all(bool(torch.isfinite(x).all()) for o in outs
                 for x in (*o.rot, *o.pos, *o.delta_rot, *o.delta_tr))
    lm = ALL4.index("libmv")
    carry = state.est[lm]
    has_ok = bool((carry.has == 1).all()) and bool(torch.isfinite(outs[-1].delta_tr[lm]).all())
    deg = {name: [round(math.degrees(quat.angle(o.delta_rot[i][0]).item()), 4) for o in outs]
           for i, name in enumerate(ALL4)}
    phase("all4", f"1080p B={batch} {steps} frames ({'+'.join(ALL4)} + block_motion): "
          f"launches {launches}; consumers' graph replays {pipe.graph_replays} for {steps} "
          f"steps, eager runs {pipe.eager_runs}; poses finite on every frame={finite}; libmv "
          f"has={carry.has.tolist()} translation (stream 0, last frame) "
          f"{outs[-1].delta_tr[lm][0].tolist()}; delta angle per frame, stream 0, deg: {deg}")
    if pipe.graph_replays != steps or pipe.eager_runs != 0:
        fail("all4: the consumers did not replay as one CUDA graph per step")
    if not (finite and has_ok):
        fail("all4: a non-finite pose, or libmv's chain not set")
    # Graph against eager over two consecutive steps on the last grid, with
    # the same draws and carries: the carry passes through the graph.
    grid = outs[-1].grid
    n = grid.shape[1] * grid.shape[2]
    g_state = e_state = state
    g_err = 0.0
    for _ in range(2):
        draws = tuple(e.draw(gen, (batch,), n, device) for e in pipe.estimators)
        graphed = pipe._run_consumers(g_state, grid, draws, None)
        eager = pipe._consume(grid, e_state.rot, e_state.pos, draws, e_state.est)
        torch.cuda.synchronize()
        g_err = max(g_err, consumer_diff(torch, graphed, eager))
        g_state = g_state._replace(rot=graphed[0], pos=graphed[1], est=graphed[4])
        e_state = e_state._replace(rot=eager[0], pos=eager[1], est=eager[4])
    # The plain flow path on the same frames.
    pipe_p = make_pipeline(device, plain=True, estimators=ALL4)
    gen_p = torch.Generator(device=device).manual_seed(SEED)
    _, outs_p = pipe_p.scan_frames(pipe_p.init_state(batch, H, W), frames, gen_p)
    g_share = torch.stack([(o.grid - p.grid).abs() > 1e-5 for o, p in zip(outs, outs_p)]).float().mean().item()
    # Multiview's and libmv's rotations from one step on each frame's
    # kernel grid and plain grid, with the same carry and the same draws,
    # so that neither the chain nor fresh draws compound the grids' few
    # differing entries: the change that those entries alone make.
    step_deg = {name: [] for name in EPI_STEP_OFF}
    for o, p in zip(outs[1:], outs_p[1:]):
        draws = tuple(e.draw(gen, (batch,), n, device) for e in pipe.estimators)
        on_kernel = pipe._run_consumers(state, o.grid, draws, None)[2]
        on_plain = pipe._run_consumers(state, p.grid, draws, None)[2]
        for name in EPI_STEP_OFF:
            i = ALL4.index(name)
            step_deg[name] += [math.degrees(x) for x in
                               quat.angle_to(on_kernel[i], on_plain[i]).tolist()]
    off = {name: sum(d > EPI_STEP_DEG for d in v) for name, v in step_deg.items()}
    phase("all4", f"graph vs eager over two consecutive steps max |diff| {g_err:.3e}; kernel "
          f"vs plain path: grid entries off by >1e-5 {g_share:.2e}; one step on each "
          f"frame's two grids (same carry, same draws), delta rotation apart per stream "
          f"and frame, deg: { {k: [round(d, 5) for d in v] for k, v in step_deg.items()} }; "
          f"apart by more than {EPI_STEP_DEG} deg: {off} of {len(outs) - 1} x {batch} "
          f"(allowed {EPI_STEP_OFF})")
    if g_err > GRAPH_TOL:
        fail("all4: the consumers' graph and the eager calls disagree")
    mv_replay = replay_kernels(torch, pipe, g_state, grid, tuple(
        e.draw(gen, (batch,), n, device) for e in pipe.estimators), part="::mv_")
    phase("all4", f"multiview_ransac: {mv_host} host launches for {len(pipe.graphs.calls)} "
          f"capture(s); {mv_replay} multiview kernels in a replay (torch.profiler)")
    if mv_replay not in (None, multiview_launches()):
        fail("all4: multiview's kernels did not run once a replay, in the graph")
    launches["multiview_ransac"] = mv_replay if mv_replay is not None else mv_host
    hg_replay = replay_kernels(torch, pipe, g_state, grid, tuple(
        e.draw(gen, (batch,), n, device) for e in pipe.estimators), part="::hg_")
    if (counts["homography_ransac"] != 2 * HOMOGRAPHY_LAUNCHES * len(pipe.graphs.calls)
            or hg_replay not in (None, HOMOGRAPHY_LAUNCHES)):
        fail(f"all4: homography's kernels: {counts['homography_ransac']} host launches for "
             f"{len(pipe.graphs.calls)} capture(s), {hg_replay} in a replay")
    launches["homography_ransac"] = hg_replay if hg_replay is not None else HOMOGRAPHY_LAUNCHES
    if not (g_share <= 1e-2 and all(n <= EPI_STEP_OFF[k] for k, n in off.items())):
        fail("all4: kernel path and plain path disagree")
    return launches


def rotation_grid(torch, batch: int, seed: int):
    """The "estimators" phase's fixture, built on the CPU from a CPU
    generator so that the JAX package can run the same inputs
    (``tests/test_torch_multiview.py``): (batch, 84, 150, 2) serving-lattice
    grids of a camera rotation per stream (0.3-0.6 deg about a random axis,
    through the port's ``camera.delta``) with 20% of the vectors replaced by
    N(0, 0.01) noise, the rotations (batch, 4) and the masked path's weights
    (batch, 84 * 150): a third of the points invalid."""
    from ofps_torch.core import quat
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.core.motion import field_to_sparse, grid_size_for

    gw, gh = grid_size_for(W, H)
    cam = StandardCamera.create(W / H, 60.0)
    g = torch.Generator().manual_seed(seed)
    pos = field_to_sparse(torch.zeros((gh, gw, 2))).pos
    axis = torch.randn((batch, 3), generator=g)
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    half = torch.deg2rad(0.3 + 0.3 * torch.rand((batch, 1), generator=g)) / 2
    q = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    motion = torch.stack([cam.delta(pos, quat.to_matrix4(q[b])) for b in range(batch)])
    bad = torch.rand(motion.shape[:-1], generator=g) < 0.2
    noise = 0.01 * torch.randn(motion.shape, generator=g)
    motion = torch.where(bad[..., None], noise, motion)
    mask = (torch.rand((batch, gh * gw), generator=g) >= 1 / 3).float()
    return motion.reshape(batch, gh, gw, 2).contiguous(), q, mask


def run_estimators(torch, device, batch: int) -> None:
    """The "estimators" phase: :func:`rotation_grid`'s fixture moved to the
    card, through the consumers' CUDA graph of all four estimators and the
    same calls made eagerly (equal within GRAPH_TOL), each estimator
    against almeida per stream (within EST_AGREE_DEG), then the masked path
    (``dense=False``) eagerly, held the same way."""
    from ofps_torch.core import quat
    from ofps_torch.core.motion import SparseFlow, field_to_sparse

    pipe = make_pipeline(device, plain=False, estimators=ALL4)
    state = pipe.init_state(batch, H, W)
    rgrid, q_true, mask = (x.to(device) for x in rotation_grid(torch, batch, SEED + 3))
    n_grid = rgrid.shape[1] * rgrid.shape[2]
    gen_e = torch.Generator(device=device).manual_seed(SEED + 4)
    draws = tuple(e.draw(gen_e, (batch,), n_grid, device) for e in pipe.estimators)
    graphed = pipe._run_consumers(state, rgrid, draws, None)
    eager = pipe._consume(rgrid, state.rot, state.pos, draws, state.est)
    torch.cuda.synchronize()
    g_err = consumer_diff(torch, graphed, eager)
    truth = quat.conj(q_true)  # the estimators return the inverse rotation

    def degrees(a, b):
        return [round(math.degrees(x), 5) for x in quat.angle_to(a, b).tolist()]

    others = ALL4[1:]
    dense_deg = {name: degrees(graphed[2][0], graphed[2][ALL4.index(name)]) for name in others}
    err_deg = {name: degrees(graphed[2][i], truth) for i, name in enumerate(ALL4)}
    sparse = field_to_sparse(rgrid)
    masked = SparseFlow(sparse.pos, sparse.motion, mask)
    masked_rot = [e.estimate(st, masked, pipe.camera, gen_e, dense=False)[0]
                  for e, st in zip(pipe.estimators, state.est)]
    masked_deg = {name: degrees(masked_rot[0], masked_rot[ALL4.index(name)]) for name in others}
    finite = all(bool(torch.isfinite(r).all()) for r in (*graphed[2], *eager[2], *masked_rot))
    phase("estimators", f"synthetic rotation B={batch} on the {tuple(rgrid.shape[1:3])} "
          f"lattice ({[round(math.degrees(x), 4) for x in quat.angle(q_true).tolist()]} "
          f"deg, 20% corrupted): graph vs eager max |diff| {g_err:.3e} ({'+'.join(ALL4)} + "
          f"block_motion); against almeida per stream {dense_deg} deg; error vs the true "
          f"rotation {err_deg} deg; masked ({int(mask.sum().item())} of {batch * n_grid} "
          f"points valid, dense=False) against almeida {masked_deg} deg; finite={finite}")
    if not (g_err <= GRAPH_TOL and finite):
        fail("the consumers' graph and eager calls disagree, or a rotation is not finite")
    if not all(max(v) <= EST_AGREE_DEG for v in (*dense_deg.values(), *masked_deg.values())):
        fail("an estimator disagrees with almeida on the synthetic rotation")


def codec_fixture(torch, directory: Path, streams: int = CODEC_STREAMS,
                  frames: int = CODEC_FRAMES, seed: int = SEED + 11, lengths=None):
    """The "codec" phase's input, built on the CPU with the port's own
    camera and written with its ``.mvec`` writer and ``apps.gt``: per
    stream a ``.mvec`` file of ``frames`` frames (``lengths`` may shorten
    some) and a ground-truth CSV.  Frame 1 is empty (an I-frame); every
    later frame holds the vectors at the centres of the 16x16 macroblock
    lattice of 1920x1080 (120 x 68) for a camera rotation of 0.2-0.5 deg
    about an axis of the stream's own, quantized to quarter-pel, with
    CODEC_INTRA of the blocks dropped (intra blocks) and CODEC_OUTLIERS of
    the rest replaced by uniform +-16 px vectors.  Returns (mvec paths, GT
    paths, vectors per stream and frame (streams, frames))."""
    import numpy as np

    from ofps_torch.apps import gt as gtmod
    from ofps_torch.core import quat
    from ofps_torch.core.camera import StandardCamera
    from ofps_torch.decoders.mvec import write_mvec_frame

    cam = StandardCamera.create(W / H, CODEC_FOV_Y)
    rng = np.random.default_rng(seed)
    xs = (np.arange(W // 16) * 16 + 8) / W
    ys = (np.arange(-(-H // 16)) * 16 + 8) / H
    lattice = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.float32)
    pos_t = torch.from_numpy(lattice)
    scale = np.array([4.0 * W, 4.0 * H], np.float32)  # quarter-pel units
    mvecs, gts = [], []
    counts = np.zeros((streams, frames), np.int64)
    for s in range(streams):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        n_frames = frames if lengths is None else lengths[s]
        acc = quat.identity(torch.float64)
        rows = [gtmod.GroundTruthRow(frame=1, fov_x=CODEC_FOV_Y, fov_y=CODEC_FOV_Y,
                                     rot=acc.numpy(), pos=np.zeros(3))]
        mvecs.append(directory / f"s{s}.mvec")
        gts.append(directory / f"s{s}_gt.csv")
        with open(mvecs[-1], "wb") as f:
            write_mvec_frame(f, np.zeros((0, 2)), np.zeros((0, 2)))
            for t in range(1, n_frames):
                half = math.radians(rng.uniform(0.2, 0.5)) / 2
                q = torch.tensor([math.cos(half), *(math.sin(half) * axis)], dtype=torch.float64)
                # The estimators return the inverse of the rotation that
                # moves the points: the flow is made by q's inverse.
                rot = quat.to_matrix4(quat.conj(q).float())
                motion = cam.delta(pos_t, rot).numpy()
                bad = rng.random(len(lattice)) < CODEC_OUTLIERS
                motion[bad] = rng.uniform(-16.0, 16.0, (int(bad.sum()), 2)) / (W, H)
                motion = (np.round(motion * scale) / scale).astype(np.float32)
                keep = rng.random(len(lattice)) >= CODEC_INTRA
                write_mvec_frame(f, lattice[keep], motion[keep])
                counts[s, t] = int(keep.sum())
                acc = quat.mul(q, acc)
                rows.append(gtmod.GroundTruthRow(frame=t + 1, fov_x=CODEC_FOV_Y,
                                                 fov_y=CODEC_FOV_Y, rot=acc.numpy(),
                                                 pos=np.zeros(3)))
        gtmod.write_ground_truth(str(gts[-1]), rows)
    return [str(p) for p in mvecs], [str(p) for p in gts], counts


def run_codec(torch, device, counters, smi):
    """The "codec" phase: :func:`codec_fixture`'s streams through
    ``run_batch`` on the card (all four estimators + block_motion,
    ``drop_ended``, ground truth), the detector and almeida against the
    port on the CPU, the consumers' graph against eager over two steps
    with libmv's carry, a live property change without a new graph, and
    the step's timing.  Returns the timing as a dict."""
    import tempfile

    import numpy as np

    from ofps_torch.apps.batch import FlowUploader, run_batch
    from ofps_torch.core import quat
    from ofps_torch.core.motion import Densifier, flow_cell_index
    from ofps_torch.detectors.block_motion import block_dim
    from ofps_torch.decoders.mvec import MvecDecoder
    from ofps_torch.pipeline.graphs import leaves
    from ofps_torch.pipeline.runtime import LivePipeline

    b, cap = CODEC_STREAMS, CODEC_CAPACITY
    lengths = [CODEC_FRAMES] * (b - 1) + [CODEC_SHORT]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mvecs, gts, counts = codec_fixture(torch, Path(tmp), b, CODEC_FRAMES, lengths=lengths)
        build_s = time.perf_counter() - t0
        res, launches = count_launches(torch, counters, lambda: run_batch(
            mvecs, estimators=[{"name": n} for n in ALL4], ground_truths=gts,
            capacity=cap, drop_ended=True, fetch_lag=1, device=device))
        captures = sum(sp.name == "consumers.capture"
                       for spans in res.perf.spans.values() for sp in spans)
        gt_deg = {name: [round(math.degrees(res.gt_avg_err[(s, name)][0]), 5) for s in range(b)]
                  for name in ALL4}
        rots = np.stack([np.stack(h) for h in res.rot_hist])  # (E, T, B, 4)
        deltas = np.stack([np.stack(h) for h in res.delta_rot])
        finite = bool(np.isfinite(rots).all() and np.isfinite(deltas).all()
                      and all(np.isfinite(p).all() for p in res.poses_pos))
        frozen = bool((rots[:, CODEC_SHORT:, -1] == rots[:, CODEC_SHORT - 1:CODEC_SHORT, -1]).all()
                      and (deltas[:, CODEC_SHORT:, -1] == [1.0, 0.0, 0.0, 0.0]).all())
        counts_ok = bool((res.vectors == counts.T).all())
        phase("codec", f"fixture {b} .mvec streams x {lengths} frames, {int(counts.sum())} "
              f"vectors (mean {counts[:, 1:].mean():.1f} per frame), built in {build_s:.2f} s; "
              f"run_batch 1080p lattice B={b} capacity {cap} ({'+'.join(ALL4)} + "
              f"block_motion, drop_ended, fetch_lag 1): {res.frames} steps, graph replays "
              f"{res.graph_replays}, eager runs {res.eager_runs}, graph captures {captures}, "
              f"hand-kernel launches from the host {launches} (this path reaches no "
              f"pl.pallas_call); vectors per step as in the "
              f"files={counts_ok}; poses finite={finite}; the short stream frozen after its "
              f"end={frozen}; host split {json.dumps(res.perf.summary())}")
        phase("codec", f"mean rotation error per frame vs ground truth, deg, per stream: "
              f"{gt_deg} (gate {CODEC_GT_DEG})")
        if not (res.frames == CODEC_FRAMES and counts_ok and finite and frozen):
            fail("codec: wrong steps or vector counts, a non-finite pose, or a frozen stream moved")
        if res.graph_replays != res.frames or res.eager_runs != 0:
            fail("codec: the consumers did not replay as one CUDA graph per step")
        if captures < 1 or any(launches[k] != 2 * n * captures for k, n in (
                ("almeida_ransac", ALMEIDA_LAUNCHES), ("homography_ransac", HOMOGRAPHY_LAUNCHES))):
            fail("codec: almeida's or homography's kernels were launched outside the graphs' "
                 "captures")
        if max(max(v) for v in gt_deg.values()) > CODEC_GT_DEG:
            fail("codec: an estimator misses the ground truth")

        # The detector and almeida on the card against the port on the CPU:
        # the same files, the same uniforms (drawn on the CPU).
        pipe2 = make_pipeline(device, False, ESTIMATORS, CODEC_FOV_Y)
        pipe2_h = make_pipeline(torch.device("cpu"), False, ESTIMATORS, CODEC_FOV_Y)
        ups = FlowUploader(b, cap, device), FlowUploader(b, cap, "cpu")
        decs = [MvecDecoder(p) for p in mvecs]
        st, st_h = pipe2.init_state(b, 1, 1), pipe2_h.init_state(b, 1, 1)
        gen_h = torch.Generator().manual_seed(SEED + 12)
        flows, same_det, field_err, alm_int, dev_counts = [], True, 0.0, 0.0, True
        alm_delta = []
        for t in range(CODEC_CPU_FRAMES):
            frames = [d.process_frame() for d in decs]
            for u in ups:
                u.pack(frames)
            flow, flow_h = (u.upload() for u in ups)
            dev_counts &= bool((flow.count().cpu() == torch.from_numpy(counts[:, t]).float()).all())
            draws_h = tuple(e.draw(gen_h, (b,), cap, "cpu", dense=False)
                            for e in pipe2_h.estimators)
            st, out = pipe2.step_from_flow(st, flow, draws=tuple(x.to(device) for x in draws_h))
            st_h, out_h = pipe2_h.step_from_flow(st_h, flow_h, draws=draws_h)
            det, det_h = out.detection, out_h.detection
            same_det &= all(bool(torch.equal(x.cpu(), y)) for x, y in
                            ((det.detected, det_h.detected), (det.area, det_h.area),
                             (det.mask, det_h.mask)))
            field_err = max(field_err, (det.field.cpu() - det_h.field).abs().max().item())
            alm_delta.append([round(math.degrees(x), 7) for x in quat.angle_to(
                out.delta_rot[0].cpu(), out_h.delta_rot[0]).tolist()])
            alm_int = max(alm_int, math.degrees(quat.angle_to(out.rot[0].cpu(), out_h.rot[0])
                                                .max().item()))
            flows.append(flow)
        for d in decs:
            d.close()
    phase("codec", f"card vs the port on the CPU, {CODEC_CPU_FRAMES} steps, "
          f"{'+'.join(ESTIMATORS)} + block_motion, same files and uniforms: vector counts on "
          f"the device as in the files={dev_counts}; detections equal={same_det}, island field "
          f"max |diff| {field_err:.3e}; almeida delta rotations apart per step and stream, "
          f"deg: {alm_delta} (max {max(map(max, alm_delta)):.3e}, gate {CODEC_ROT_DEG}); "
          f"integrated rotation max {alm_int:.3e} deg apart")
    if not (dev_counts and same_det and field_err <= CODEC_FIELD_TOL
            and max(map(max, alm_delta)) <= CODEC_ROT_DEG):
        fail("codec: the card and the CPU disagree")

    # All four live: graph against eager over two steps (libmv's carry),
    # then a property change that the next step sees with no new graph.
    pipe4 = make_pipeline(device, False, ALL4, CODEC_FOV_Y)
    live = LivePipeline(pipe4, b, 1, 1, from_flow=True)
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    for flow in flows[1:3]:
        live.step(flow, gen)
    lm = ALL4.index("libmv")
    has = live.state.est[lm].has.tolist()
    g_state = e_state = live.state
    g_err = 0.0
    for flow in flows[3:5]:
        draws = tuple(e.draw(gen, (b,), cap, device, dense=False) for e in pipe4.estimators)
        graphed = pipe4._run_consumers(g_state, flow, draws, live.props)
        eager = pipe4._consume(flow, e_state.rot, e_state.pos, draws, e_state.est, live.props)
        torch.cuda.synchronize()
        g_err = max(g_err, max((x.float() - y.float()).abs().max().item()
                               for x, y in zip(leaves(graphed), leaves(eager))))
        g_state = g_state._replace(rot=graphed[0], pos=graphed[1], est=graphed[4])
        e_state = e_state._replace(rot=eager[0], pos=eager[1], est=eager[4])
    # Almeida's kernels in one replay of the live graph (props as device
    # scalars): ALMEIDA_LAUNCHES.
    launches["almeida_ransac"] = replay_kernels(torch, pipe4, g_state, flows[5], draws,
                                                live.props)
    launches["homography_ransac"] = replay_kernels(torch, pipe4, g_state, flows[5], draws,
                                                   live.props, part="::hg_")
    before = live.step(flows[5], gen)[1].detection.detected.tolist()
    graphs = len(pipe4.graphs.calls)
    applied = live.set_property("detector", "target_motion", 0.1)
    after = live.step(flows[5], gen)[1].detection.detected.tolist()
    live.set_property("detector", "target_motion", pipe4.detector.params.target_motion)
    phase("codec", f"live all four B={b}: libmv has={has}; graph vs eager over two steps "
          f"(carry through the graph) max |diff| {g_err:.3e}; target_motion 0.003 -> 0.1: "
          f"applied={applied}, detected {before} -> {after}, graphs {graphs} -> "
          f"{len(pipe4.graphs.calls)}, eager runs {pipe4.eager_runs}; almeida kernels in a "
          f"replay {launches['almeida_ransac']}, homography kernels "
          f"{launches['homography_ransac']} (torch.profiler)")
    if launches["almeida_ransac"] not in (None, ALMEIDA_LAUNCHES):
        fail("codec: almeida's kernels did not run once a replay")
    if launches["homography_ransac"] not in (None, HOMOGRAPHY_LAUNCHES):
        fail(f"codec: {launches['homography_ransac']} homography kernels in a replay")
    if g_err > GRAPH_TOL or min(has) < 1.0:
        fail("codec: the consumers' graph and eager calls disagree, or libmv's chain not set")
    if not (applied and any(before) and not any(after) and graphs == len(pipe4.graphs.calls) == 1
            and pipe4.eager_runs == 0):
        fail("codec: a live property change was not seen, or it captured a new graph")

    # Timing: ms per step_from_flow (CUDA events; the draws are part of
    # the step), the upload, and the consumers' kernels per replay.
    flow8 = flows[2]
    step_ms, kernels = {}, {}
    for names, bb in ((ESTIMATORS, 1), (ESTIMATORS, 4), (ESTIMATORS, 8), (ALL4, 8)):
        pipe = pipe2 if (names, bb) == (ESTIMATORS, b) else (
            pipe4 if names == ALL4 else make_pipeline(device, False, names, CODEC_FOV_Y))
        flow = type(flow8)(*(x[:bb] for x in flow8))
        state = pipe.init_state(bb, 1, 1)
        key = f"{'+'.join(names)}_B{bb}"
        reps = [time_ms(torch, lambda p=pipe, s=state, f=flow: p.step_from_flow(s, f, gen),
                        CODEC_STEPS)[0] for _ in range(3)]
        step_ms[key] = sorted(reps)[1]
        draws = tuple(e.draw(gen, (bb,), cap, device, dense=False) for e in pipe.estimators)
        n, kms = consumer_kernels(torch, pipe, state, flow, draws)
        kernels[key] = {"kernels": n, "kernel_ms": kms, "repeats_ms": reps}
        phase("timing", f"codec step_from_flow B={bb} capacity {cap}, {'+'.join(names)} + "
              f"block_motion: {step_ms[key]:.3f} ms/step, median of 3 x {CODEC_STEPS} steps "
              f"{[round(r, 3) for r in reps]} ({step_ms[key] / bb:.3f} ms/frame); "
              + (f"{n} CUDA kernels, {kms:.3f} ms of kernel time in the same consumers "
                 f"called eagerly (torch.profiler)" if n else "kernels not measured")
              + f" | {smi}")
    up = FlowUploader(b, cap, device)
    up.pack([None] * b)
    upload_ms = time_ms(torch, up.upload, 10)[0]
    live_ms = time_ms(torch, lambda: live.step(flow8, gen), 10)[0]
    # The sparse detector alone, and its deterministic one-hot accumulation
    # against scatter_add (atomics: the order of the adds varies), each on
    # the device alone (a CUDA graph of 20 calls).
    detect = pipe4.detector.detect
    dim = block_dim(pipe4.detector.params)
    dens = Densifier.zeros(dim, dim, (b,), device)
    idx = (lambda x, y: y * dim + x)(*flow_cell_index(flow8.pos, dim, dim))
    vals = torch.cat([flow8.mask[..., None], flow8.motion * flow8.mask[..., None]], dim=-1)
    det_ms = {
        "detect": device_ms(torch, lambda: detect(flow8)),
        "onehot_accumulate": device_ms(torch, lambda: dens.add_flow(flow8)),
        "scatter_add_accumulate": device_ms(torch, lambda: torch.zeros(
            (b, dim * dim, 3), device=device).scatter_add_(
                1, idx[..., None].expand(-1, -1, 3), vals)),
    }
    phase("timing", f"codec upload of one (B={b}, {cap}) step, {b * cap * 20 / 1e6:.2f} MB "
          f"pinned: {upload_ms:.3f} ms; LivePipeline step (props as device scalars), all "
          f"four B={b}: {live_ms:.3f} ms; block_motion sparse detect B={b}, device ms: "
          f"{ {k: round(v, 4) for k, v in det_ms.items()} }; run_batch host clock, median "
          f"ms per step: { {k: round(sorted(v)[len(v) // 2] * 1e3, 3) for k, v in res.perf.stages.items()} } "
          f"| {smi}")
    if not all(math.isfinite(v) for v in (*step_ms.values(), upload_ms, live_ms,
                                          *det_ms.values())):
        fail("codec: non-finite timing")
    return {"step_ms": step_ms, "consumer_kernels": kernels, "upload_ms": upload_ms,
            "live_step_ms": live_ms, "detector_device_ms": det_ms, "gt_deg": gt_deg,
            "host_split": res.perf.summary(), "launches": launches}


def detection_fixture(path: Path, frames: int = CODEC_FRAMES, seed: int = SEED + 21) -> None:
    """A ``.mvec`` stream on the 1080p macroblock lattice: frame 0 empty,
    then every block jittering by under a quarter pel, and the blocks of
    the DET_BLOCK square moving DET_SHIFT_PX right on the frames of
    DET_MOVING."""
    import numpy as np

    from ofps_torch.decoders.mvec import write_mvec_frame

    rng = np.random.default_rng(seed)
    xs = (np.arange(W // 16) * 16 + 8) / W
    ys = (np.arange(-(-H // 16)) * 16 + 8) / H
    lattice = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.float32)
    lo, hi = DET_BLOCK
    block = ((lattice >= lo) & (lattice <= hi)).all(-1)
    with open(path, "wb") as f:
        write_mvec_frame(f, np.zeros((0, 2)), np.zeros((0, 2)))
        for t in range(1, frames):
            motion = rng.uniform(-0.2, 0.2, lattice.shape) / (W, H)
            if any(a <= t <= b for a, b in DET_MOVING):
                motion[block, 0] += DET_SHIFT_PX / W
            write_mvec_frame(f, lattice, motion.astype(np.float32))


def run_apps(torch, device, counters, smi):
    """The "apps" phase: the command line (``ofps_torch.apps.cli.main``)
    and the single-stream apps on the card, at one 1080p codec stream's
    density, and ``dense_flow_stream`` at 1080p, B=4.  Returns its
    timings and the stream's kernel launches."""
    import contextlib
    import csv
    import io
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import numpy as np

    from ofps_torch.apps import cli
    from ofps_torch.apps import gt as gtmod
    from ofps_torch.apps.tracking import run_tracking
    from ofps_torch.apps.watch import run_watch
    from ofps_torch.decoders.flo import read_flo
    from ofps_torch.ops.flow_pyramid import (
        FlowParams, dense_flow_stream, dense_flow_warm, frame_cache)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (mvec,), (gt,), counts = codec_fixture(torch, tmp, streams=1, frames=CODEC_FRAMES)

        def write(name, obj):
            (tmp / name).write_text(json.dumps(obj))
            return str(tmp / name)

        def rows(name):
            return list(csv.reader(io.StringIO((tmp / name).read_text())))

        # run-config tracking, all four, through the command line.
        tracking = {
            "app": "tracking", "decoder": {"input": mvec}, "camera_aspect": W / H,
            "camera_fov_y": CODEC_FOV_Y, "estimators": [{"name": n} for n in ALL4],
            "ground_truth": gt,
            "output": {"stats_csv_prefix": str(tmp / "stats_"), "perf_csv": str(tmp / "perf.csv"),
                       "keyframes_prefix": str(tmp / "kf_")},
        }
        with contextlib.redirect_stdout(io.StringIO()) as said:
            rc = cli.main(["run-config", write("tracking.json", tracking)])
        lines = said.getvalue().strip().splitlines()
        stats = {n: rows(f"stats_{n}.csv") for n in ALL4}
        header = ["frame", "delta", "delta_r", "delta_p", "delta_y", "r", "p", "y", "error",
                  "error_r", "error_p", "error_y"]
        rows_ok = all(r[0] == header and len(r) == CODEC_FRAMES + 1 for r in stats.values())
        csv_finite = all(np.isfinite(np.float64([v for row in r[1:] for v in row])).all()
                         for r in stats.values())
        kf = rows("kf_almeida_keyframes.csv")
        perf = rows("perf.csv")
        est_ms = [float(row[perf[0].index("estimate")]) for row in perf[1:]]
        phase("apps", f"run-config tracking ({'+'.join(ALL4)}, B=1, capacity {CODEC_CAPACITY}, "
              f"1080p lattice, {CODEC_FRAMES} frames, {int(counts.sum())} vectors): rc {rc}; "
              f"printed {lines}; stats CSVs {'+'.join(ALL4)} header and {CODEC_FRAMES} rows="
              f"{rows_ok}, finite={csv_finite}; keyframes kept {len(kf) - 1}")
        if not (rc == 0 and rows_ok and csv_finite and 2 <= len(kf) <= 11
                and len(est_ms) == CODEC_FRAMES):
            fail("apps: run-config tracking failed or wrote wrong files")

        # The same stream through run_tracking: one capture, one replay per
        # frame, the GT error, and a props_hook change.
        def track(**kw):
            return run_tracking(mvec, tracking["estimators"], W / H, CODEC_FOV_Y, **kw)

        base = track()
        truth = gtmod.load_ground_truth(gt)
        gt_deg = {t.name: math.degrees(t.avg_err(truth)[0]) for t in base.tracks}
        finite = all(np.isfinite(x).all() for t in base.tracks
                     for x in (*t.poses_rot, *t.poses_pos, *t.transforms))
        ms = [1e3 * x for x in base.perf.stages["estimate"]]
        seen = []

        def hook(frame, props):
            seen.append(frame)
            if frame == APPS_HOOK_FRAME:
                props["estimators"][0]["inlier_angle_deg"].fill_(0.0)
            return props

        hooked = track(props_hook=hook)
        before = max(float(np.abs(a - b).max()) for t, u in zip(base.tracks, hooked.tracks)
                     for a, b in zip(t.transforms[:APPS_HOOK_FRAME], u.transforms[:APPS_HOOK_FRAME]))
        ident = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        at_hook = (np.array_equal(hooked.tracks[0].transforms[APPS_HOOK_FRAME], ident)
                   and not np.array_equal(base.tracks[0].transforms[APPS_HOOK_FRAME], ident))
        out["tracking"] = {
            "estimate_ms_per_frame": sorted(ms[1:])[len(ms[1:]) // 2],
            "estimate_ms_mean_after_capture": sum(ms[1:]) / len(ms[1:]),
            "first_frame_ms": ms[0], "cli_estimate_ms_median": sorted(est_ms)[len(est_ms) // 2],
            "cli_first_frame_ms": est_ms[0],
            "gt_deg": gt_deg}
        phase("apps", f"run_tracking on the same stream: graphs {base.graphs}, replays "
              f"{base.graph_replays}, eager runs {base.eager_runs}; mean GT error deg {gt_deg} (gate {CODEC_GT_DEG}); "
              f"poses finite={finite}; props_hook frames {seen[0]}..{seen[-1]}: inlier angle 0 "
              f"at frame {APPS_HOOK_FRAME} -> almeida identity there={at_hook}, frames before "
              f"it max |diff| {before:.3e}, graphs {hooked.graphs}, replays "
              f"{hooked.graph_replays}; \"estimate\" stage ms per frame: median "
              f"{out['tracking']['estimate_ms_per_frame']:.3f}, mean after the capture "
              f"{out['tracking']['estimate_ms_mean_after_capture']:.3f}, first frame (capture) "
              f"{ms[0]:.1f}; the CLI run's median {out['tracking']['cli_estimate_ms_median']:.3f}, "
              f"its first frame (the process's first capture) {est_ms[0]:.1f} | {smi}")
        if not (base.graphs == hooked.graphs == 1 and base.graph_replays == CODEC_FRAMES
                and hooked.graph_replays == CODEC_FRAMES and base.eager_runs == 0
                and hooked.eager_runs == 0):
            fail("apps: tracking did not run one capture and one replay per frame")
        if not (finite and max(gt_deg.values()) <= CODEC_GT_DEG):
            fail("apps: a tracking pose is not finite, or an estimator misses the ground truth")
        if not (seen == list(range(CODEC_FRAMES)) and at_hook and before <= GRAPH_TOL):
            fail("apps: the props_hook change did not reach its frame alone")

        # run-config detection: the card against the port on the CPU.
        det_mvec = tmp / "det.mvec"
        detection_fixture(det_mvec)
        ranges = {}
        for name, args in (("cuda", []), ("cpu", ["--device", "cpu"])):
            det = {"app": "detection", "decoder": {"input": str(det_mvec)},
                   "detector": {"name": "block_motion"}, "settings": DET_SETTINGS,
                   "output": {"ranges_csv": str(tmp / f"ranges_{name}.csv"),
                              "perf_csv": str(tmp / f"det_perf_{name}.csv")}}
            with contextlib.redirect_stdout(io.StringIO()) as said:
                rc = cli.main(args + ["run-config", write(f"det_{name}.json", det)])
            ranges[name] = ((tmp / f"ranges_{name}.csv").read_text(), rc,
                            said.getvalue().strip())
        perf = rows("det_perf_cuda.csv")
        det_ms = [float(row[perf[0].index("detect")]) for row in perf[1:]]
        want = "".join(f"{a},{b}\n" for a, b in DET_MOVING)
        out["detection"] = {"detect_ms_per_frame": sorted(det_ms[1:])[len(det_ms[1:]) // 2],
                            "detect_ms_mean": sum(det_ms) / len(det_ms)}
        phase("apps", f"run-config detection (block_motion, 1080p lattice, {len(det_ms)} "
              f"frames, a {DET_BLOCK} block moving {DET_SHIFT_PX} px on frames {DET_MOVING}): "
              f"card {ranges['cuda'][2]!r} rc {ranges['cuda'][1]}; ranges CSV equal to the "
              f"port on the CPU={ranges['cuda'][0] == ranges['cpu'][0]}; \"detect\" stage ms "
              f"per frame: median {out['detection']['detect_ms_per_frame']:.3f}, mean "
              f"{out['detection']['detect_ms_mean']:.3f} | {smi}")
        if not (ranges["cuda"][1] == ranges["cpu"][1] == 0
                and ranges["cuda"][0] == ranges["cpu"][0] == want):
            fail("apps: detection ranges differ from the CPU's or from the fixture's")

        # flow-extract at 150x84: the card against the port on the CPU.
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc_g = cli.main(["flow-extract", mvec, str(tmp / "flo_cuda")])
        wall_ms = (time.perf_counter() - t0) * 1e3 / CODEC_FRAMES
        with contextlib.redirect_stdout(io.StringIO()):
            rc_c = cli.main(["--device", "cpu", "flow-extract", mvec, str(tmp / "flo_cpu")])
        names = sorted(os.listdir(tmp / "flo_cuda"))
        flo_err = max(float(np.abs(read_flo(str(tmp / "flo_cuda" / n))
                                   - read_flo(str(tmp / "flo_cpu" / n))).max()) for n in names)
        last = read_flo(str(tmp / "flo_cuda" / names[-1]))
        from ofps_torch.decoders.mvec import MvecDecoder

        dec = MvecDecoder(mvec)
        dec.process_frame()
        f1 = dec.process_frame()
        dec.close()
        field_ms = time_ms(torch, lambda: cli.flow_field(f1.pos, f1.motion, 150, 84,
                                                         CODEC_CAPACITY, device), PLAIN_ITERS)[0]
        out["flow_extract"] = {"ms_per_frame_wall": wall_ms, "field_ms": field_ms,
                               "max_abs_err_px": flo_err}
        phase("apps", f"flow-extract 150x84 ({CODEC_FRAMES} frames): rc {rc_g}/{rc_c}, .flo "
              f"files {len(names)} of {sorted(os.listdir(tmp / 'flo_cpu')) == names and len(names)}"
              f" on the CPU; card vs CPU max |diff| {flo_err:.3e} px (gate {FLO_TOL}); field "
              f"finite={bool(np.isfinite(last).all())}; ms per frame: {wall_ms:.3f} wall (decode, "
              f"densify, hole fill, blur, fetch, write), densify+fill+blur alone {field_ms:.3f} "
              f"| {smi}")
        if not (rc_g == rc_c == 0 and len(names) == CODEC_FRAMES and flo_err <= FLO_TOL
                and sorted(os.listdir(tmp / "flo_cpu")) == names and np.isfinite(last).all()):
            fail("apps: flow-extract failed or disagrees with the CPU")

        # watch on an ephemeral port over loopback.
        box = []
        watch_cfg = dict(tracking, detector={"name": "block_motion"}, output={})
        th = threading.Thread(target=run_watch, daemon=True, kwargs=dict(
            config=watch_cfg, port=0, max_frames=WATCH_FRAMES, _server_box=box))
        with contextlib.redirect_stdout(io.StringIO()):
            th.start()
            t0 = time.perf_counter()
            while not box and time.perf_counter() - t0 < 60:
                time.sleep(0.05)
            snap = None
            if box:
                port = box[0].server_address[1]
                while time.perf_counter() - t0 < 120:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}/state.json",
                                                timeout=30) as r:
                        snap = json.loads(r.read())
                    if snap["done"]:
                        break
                    time.sleep(0.1)
                box[0].shutdown()
                box[0].server_close()
            th.join(timeout=60)
        refused = False
        if box:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}/state.json", timeout=5)
            except (urllib.error.URLError, ConnectionError):
                refused = True
        ests = (snap or {}).get("estimators", [])
        watch_ok = bool(snap and snap["done"] and snap["frame"] == WATCH_FRAMES - 1
                        and [e["name"] for e in ests] == list(ALL4)
                        and all(np.isfinite(e["euler_deg"]).all() for e in ests)
                        and snap["detected"] in (True, False))
        phase("apps", f"watch {WATCH_FRAMES} frames ({'+'.join(ALL4)} + block_motion) on port "
              f"{port if box else None}: /state.json frame {snap and snap['frame']}, estimators "
              f"{[e['name'] for e in ests]}, eulers {[e['euler_deg'] for e in ests]}, detected "
              f"{snap and snap['detected']}; server shut down={refused and not th.is_alive()}")
        if not (watch_ok and refused and not th.is_alive()):
            fail("apps: watch did not serve the frames or did not shut down")

        # bench-e2e over the fixture stream, 8 streams.
        with contextlib.redirect_stdout(io.StringIO()) as said:
            rc = cli.main(["bench-e2e", "--input", mvec, "--streams", str(CODEC_STREAMS),
                           "--width", str(W), "--height", str(H)])
        line = said.getvalue().strip().splitlines()[-1]
        rec = json.loads(line)
        out["bench_e2e"] = rec
        phase("apps", f"bench-e2e --input <fixture>.mvec --streams {CODEC_STREAMS} (almeida + "
              f"homography + block_motion, fetch lag 8): {line} | {smi}")
        if not (rc == 0 and rec["frames"] == CODEC_FRAMES and rec["streams"] == CODEC_STREAMS
                and rec["value"] > 0):
            fail("apps: bench-e2e failed or ran the wrong steps")

    # dense_flow_stream at 1080p, B=4: the carry against the chained form.
    batch = 4
    frames = moving_frames(torch, STREAM_FRAMES, batch, H, W, device)
    params = FlowParams()

    def stream():
        flows, carry = [], None
        for f in frames:
            flow, carry = dense_flow_stream(f, params, carry)
            flows.append(flow)
        return flows, carry

    (flows, carry), launches = count_launches(torch, counters, stream)
    launches = {k: launches[k] for k in ("flow_refine", "flow_refine_small", "guard_select",
                                         "median3x3_uv")}
    check_per_step("dense_flow_stream", launches, {
        "flow_refine": 4, "flow_refine_small": 3, "median3x3_uv": 4})
    same = True
    warm, cache = tuple(torch.zeros_like(x) for x in carry.warm), frame_cache(frames[0], params)
    for t in range(1, STREAM_FRAMES):
        (u, v), warm, cache = dense_flow_warm(frames[t - 1], frames[t], params, warm=warm,
                                              prev_cache=cache)
        same &= bool(torch.equal(u, flows[t][0]) and torch.equal(v, flows[t][1]))
    same &= all(bool(torch.equal(a, b)) for a, b in zip(warm, carry.warm))
    first_zero = not (flows[0][0].any() or flows[0][1].any())
    med = flows[-1][0][:, 64:-64, 64:-64].median().item()
    mid = (frames[1], dense_flow_stream(frames[0], params)[1])
    stream_ms = time_ms(torch, lambda: dense_flow_stream(mid[0], params, mid[1]), 10)[0]
    chain_ms = time_ms(torch, lambda: dense_flow_warm(
        frames[0], frames[1], params, warm=mid[1].warm, prev_cache=mid[1].cache), 10)[0]
    cold_ms = time_ms(torch, lambda: dense_flow_warm(
        frames[0], frames[1], params, warm=mid[1].warm), 10)[0]
    stream_dev = device_ms(torch, lambda: dense_flow_stream(mid[0], params, mid[1]))
    out["dense_flow_stream"] = {"ms_per_step": stream_ms, "ms_per_frame": stream_ms / batch,
                                "device_ms_per_step": stream_dev,
                                "chained_ms_per_step": chain_ms,
                                "chained_without_cache_ms_per_step": cold_ms,
                                "launches": launches}
    phase("apps", f"dense_flow_stream 1080p B={batch} {STREAM_FRAMES} frames: launches "
          f"{launches}; bit-equal to the chained dense_flow_warm={same}; first call zeros="
          f"{first_zero}; interior median u {med:.4f} px (expect {SHIFT}); {stream_ms:.3f} "
          f"ms/step ({stream_ms / batch:.3f} ms/frame; device alone, a CUDA graph of 20 steps, "
          f"{stream_dev:.3f} ms/step), chained dense_flow_warm with the cache "
          f"{chain_ms:.3f} ms/step, without it (the previous pyramid rebuilt) {cold_ms:.3f} "
          f"ms/step | {smi}")
    if not (same and first_zero and abs(med - SHIFT) <= 0.1 and math.isfinite(stream_dev)):
        fail("apps: dense_flow_stream differs from the chain, or the pan is not recovered")
    return out, launches


def parallel_meshes(torch):
    """The (2, 2) and (2, 1) meshes: one card per position where there
    are four, else every position on cuda:0, asked for explicitly."""
    from ofps_torch.parallel import make_stream_mesh

    if torch.cuda.device_count() >= 4:
        devices = [torch.device("cuda", i) for i in range(4)]
    else:
        devices = [torch.device("cuda", 0)] * 4
    return (make_stream_mesh(4, space=2, devices=devices),
            make_stream_mesh(2, space=1, devices=devices[:2]))


def sync_all(torch) -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def outputs_diff(torch, a, b) -> float:
    """Max |a - b| over two runs' outputs, step by step: grids, every
    translation, detections, and the poses of every estimator but
    homography, whose rotations :func:`homography_vs_plain` holds family
    by family (and whose positions integrate them)."""
    from ofps_torch.pipeline.graphs import leaves

    keep = [i for i, name in enumerate(ESTIMATORS) if name != "homography"]

    def held(o):
        return (o.grid, [o.rot[i] for i in keep], [o.pos[i] for i in keep],
                [o.delta_rot[i] for i in keep], o.delta_tr, o.detection)

    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(leaves([held(o) for o in a]), leaves([held(o) for o in b]))
               if x.numel())


def spatial_epe(torch, u, v, ru, rv, m: int):
    """(mean, 99th percentile) of the endpoint error ``m`` px off every
    edge."""
    h, w = u.shape[-2:]
    epe = torch.hypot(u - ru, v - rv)[:, m : h - m, m : w - m].flatten()
    k = max(1, math.ceil(0.99 * epe.numel()))
    return epe.mean().item(), torch.kthvalue(epe.cpu(), k).values.item()


def grid_epe(torch, got, ref, border_px: int):
    """(mean, 99th percentile) px endpoint error of two (..., gh, gw, 2)
    normalized grids over the cells wholly outside ``border_px`` of the
    frame's edges (the cells inside are copies of these)."""
    gh, gw = got.shape[-3:-1]
    ys = [r for r in range(gh) if r * H / gh >= border_px and (r + 1) * H / gh <= H - border_px]
    xs = [c for c in range(gw) if c * W / gw >= border_px and (c + 1) * W / gw <= W - border_px]
    d = (got - ref)[..., ys, :, :][..., xs, :]
    epe = torch.hypot(d[..., 0] * W, d[..., 1] * H).flatten()
    k = max(1, math.ceil(0.99 * epe.numel()))
    return epe.mean().item(), torch.kthvalue(epe.cpu(), k).values.item()


def decoded_flows(torch, mvecs, device):
    """The (B, capacity) SparseFlow of each step of ``run_batch`` over
    ``mvecs``, as its uploader makes them."""
    from ofps_torch.apps.batch import FlowUploader
    from ofps_torch.decoders.mvec import MvecDecoder

    decs = [MvecDecoder(p) for p in mvecs]
    up = FlowUploader(len(mvecs), CODEC_CAPACITY, device)
    flows = []
    try:
        while True:
            frames = [d.process_frame() for d in decs]
            if any(f is None for f in frames):
                return flows
            up.pack(frames)
            flows.append(up.upload())
    finally:
        for d in decs:
            d.close()


def codec_homography_err(torch, pipe, flows, seed: int, deltas):
    """Homography's delta rotations ``deltas`` (T, B, 4) of a codec run
    over ``flows`` whose generator was seeded with ``seed``, against the
    nearer of the two family rotations that the unsharded estimator gives
    on the same flows and draws (``homography_vs_plain``'s rule, masked).
    Returns (max |diff| to the nearer family, picks of the other one)."""
    from ofps_torch.estimators import homography as he

    i = ESTIMATORS.index("homography")
    est = pipe.estimators[i]
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    near_err, flips = 0.0, 0
    for flow, delta in zip(flows, deltas):
        b = flow.mask.shape[0]
        draws = [e.draw(gen, (b,), flow.capacity, pipe.device, dense=False)
                 for e in pipe.estimators]
        fit = he.ransac_plain(flow, pipe.camera, est.params, he.hypothesis_count(est.params),
                              est.params.max_error, idx=draws[i])
        quats, tnorm = fit.quats, fit.tnorm
        d = torch.from_numpy(delta).to(pipe.device)
        near = (quats - d[:, None, :]).abs().amax(dim=-1).min(dim=-1)
        near_err = max(near_err, near.values.max().item())
        flips += int((near.indices != torch.argmin(tnorm, dim=-1)).sum().item())
    return near_err, flips


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_distributed(torch, device):
    """``distributed.maybe_initialize`` over NCCL in this process (world
    size 1, one all_reduce); with two or more cards, two processes, one
    per card, agreeing on ``tests/test_torch_distributed.py``'s global
    reduction.  Returns the phase's notes."""
    from ofps_torch.parallel import distributed

    keys = ("OFPS_TORCH_COORDINATOR", "OFPS_TORCH_NUM_PROCESSES", "OFPS_TORCH_PROCESS_ID")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update(OFPS_TORCH_COORDINATOR=f"127.0.0.1:{free_port()}",
                      OFPS_TORCH_NUM_PROCESSES="1", OFPS_TORCH_PROCESS_ID="0")
    try:
        t0 = time.perf_counter()
        joined = distributed.maybe_initialize(timeout_s=60)
        backend = torch.distributed.get_backend()
        x = torch.arange(1.0, 5.0, device=device)
        same = bool(torch.equal(distributed.global_reduce(x, "sum"), x))
        init_s = time.perf_counter() - t0
    finally:
        distributed.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    notes = {"world1": {"joined": joined, "backend": backend, "all_reduce_equal": same,
                        "seconds": init_s}}
    phase("parallel", f"distributed world size 1: maybe_initialize={joined} backend "
          f"{backend}, all_reduce of a cuda:0 tensor equal={same}, {init_s:.2f} s, "
          f"process group destroyed")
    if not (joined and backend == "nccl" and same):
        fail("parallel: the world-size-1 NCCL group did not work")
    if torch.cuda.device_count() < 2:
        phase("parallel", "one card: the two-process NCCL check and the cuda:1 launch check "
              "need two cards and do not run here")
        return notes
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(HERE), CUDA_VISIBLE_DEVICES=str(rank),
                   OFPS_TORCH_COORDINATOR=f"127.0.0.1:{port}", OFPS_TORCH_NUM_PROCESSES="2",
                   OFPS_TORCH_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "tests" / "test_torch_distributed.py")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if outs is None:
        fail("parallel: a two-process worker timed out")
    ok = [p.returncode == 0 and "MULTIPROC_OK" in o for p, o in zip(procs, outs)]
    totals = {line.split("total=")[1] for o in outs for line in o.splitlines()
              if "MULTIPROC_OK" in line}
    notes["two_processes"] = {"ok": ok, "totals": sorted(totals)}
    phase("parallel", f"two processes, one card each (NCCL): ok={ok}, global sums {sorted(totals)}")
    if not (all(ok) and len(totals) == 1):
        fail("parallel: the two processes disagree:\n" + "\n".join(o[-2000:] for o in outs))
    notes["second_card"] = second_card(torch)
    return notes


def second_card(torch):
    """A kernel launch and a consumers' graph replay on cuda:1 while
    cuda:0 is current (the launches' device guard)."""
    from ofps_torch.kernels import flow_refine as kfr

    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    frames = moving_frames(torch, 2, 2, H, W, dev)
    u = torch.full((2, H // 2, W // 2), SHIFT / 2, device=dev)
    got = kfr.flow_refine(frames[0], frames[1], u, u, 5)
    ref = kfr.flow_refine_plain(frames[0], frames[1], u, u, 5)
    off = max(((a - b).abs() > MISMATCH_PX).float().mean().item() for a, b in zip(got, ref))
    pipe = make_pipeline(dev, False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    st, outs = pipe.scan_frames(pipe.init_state(2, H, W), frames, gen)
    torch.cuda.synchronize(dev)
    finite = all(bool(torch.isfinite(r).all()) for o in outs for r in o.rot)
    note = {"refine_mismatch_share": off, "graph_replays": pipe.graph_replays,
            "eager_runs": pipe.eager_runs, "device": str(outs[-1].grid.device)}
    phase("parallel", f"cuda:1 with cuda:0 current: flow_refine 1080p B=2 vs plain, pixels "
          f"off by >{MISMATCH_PX} px {off:.2e}; serving step x2: graph replays "
          f"{pipe.graph_replays}, eager {pipe.eager_runs}, outputs on {note['device']}, "
          f"poses finite={finite}")
    if not (off <= MAX_MISMATCH_SHARE and pipe.graph_replays == 2 and pipe.eager_runs == 0
            and finite and note["device"] == "cuda:1"):
        fail("parallel: a launch or a graph on cuda:1 went wrong")
    return note


def run_parallel(torch, device, counters, smi):
    """The "parallel" phase (constants PAR_* above): the meshes, the
    stream-only step against the unsharded one, the (2, 2) route's flow
    and poses against the unsharded step's, the codec-MV step on the
    (2, 1) mesh, the step times, and the distributed checks.  Returns
    (results, the flow launches of the (2, 2) run)."""
    import tempfile

    import numpy as np

    from ofps_torch.apps.batch import run_batch
    from ofps_torch.core import quat
    from ofps_torch.ops.flow_pyramid import border_margin_px, dense_flow_warm
    from ofps_torch.parallel import stream_sharding
    from ofps_torch.parallel.spatial import DEFAULT_HALO, dense_flow_warm_spatial

    t_phase = time.perf_counter()
    mesh22, mesh21 = parallel_meshes(torch)
    sh22, sh21 = stream_sharding(mesh22), stream_sharding(mesh21)
    n_cards = torch.cuda.device_count()
    layout = ("one card per position" if n_cards >= 4 else
              "every position on cuda:0, asked for explicitly (a degenerate mesh: the "
              "bands, halos, per-row graphs and kernels all run on the one card)")
    phase("parallel", f"{mesh22} and {mesh21}; {n_cards} card(s) visible; {layout} | {smi}")
    b = PAR_BATCH
    frames = moving_frames(torch, PAR_FRAMES, b, H, W, device)

    def run(pipe, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        out = pipe.scan_frames(pipe.init_state(b, H, W), frames, gen)
        sync_all(torch)
        return out

    # The stream-only mesh against the unsharded step: same draws.
    base = make_pipeline(device, False)
    base_state, ref = run(base, SEED + 31)
    p21 = make_pipeline(device, False, shardings=sh21)
    _, got21 = run(p21, SEED + 31)
    err21 = outputs_diff(torch, got21, ref)
    n_grid = ref[0].grid.shape[1] * ref[0].grid.shape[2]
    h_near, h_flips, h_picked = homography_vs_plain(
        torch, base, got21, ref, frame_draws(torch, base, SEED + 31, PAR_FRAMES, b, n_grid, device))
    phase("parallel", f"(2, 1) vs unsharded, 1080p B={b}, {PAR_FRAMES} steps: grids, "
          f"translations, detections and almeida's poses max |diff| {err21:.3e}; homography's "
          f"rotation to the unsharded step's nearer family {h_near:.3e} (tolerance "
          f"{GRAPH_TOL}), picks of the other family {h_flips} of {b * PAR_FRAMES} (max |diff| "
          f"of the picks {h_picked:.3e}); graph replays {p21.graph_replays} (two rows per "
          f"step), eager runs {p21.eager_runs}")
    if (max(err21, h_near) > GRAPH_TOL or p21.graph_replays != 2 * PAR_FRAMES
            or p21.eager_runs):
        fail("parallel: the stream-only step differs from the unsharded one")

    # The (2, 2) serving step: launches per band, poses and grid against
    # the unsharded step's.
    p22 = make_pipeline(device, False, shardings=sh22)
    (_, got22), counts = count_launches(torch, counters, lambda: run(p22, SEED + 31))
    launches = {k: counts[k] for k in BAND_LAUNCHES}
    per_band = {k: n / (PAR_FRAMES * 4) for k, n in launches.items()}
    finite = all(bool(torch.isfinite(x).all()) for o in got22
                 for x in (*o.rot, *o.pos, *o.delta_rot, *o.delta_tr))
    alm_deg = [max(math.degrees(d) for d in quat.angle_to(o.delta_rot[0], r.delta_rot[0]).tolist())
               for o, r in zip(got22, ref)]
    margin = border_margin_px(base.flow_params, H, W)
    grid_err = grid_epe(torch, torch.stack([o.grid for o in got22[1:]]),
                        torch.stack([r.grid for r in ref[1:]]), margin)
    phase("parallel", f"(2, 2) serving step 1080p B={b}, {PAR_FRAMES} steps, halo "
          f"{DEFAULT_HALO}: flow launches {launches}, per band per step {per_band} (expected "
          f"{BAND_LAUNCHES}); graph replays {p22.graph_replays}, eager runs {p22.eager_runs}; "
          f"poses finite={finite}; almeida delta rotation vs the unsharded step, max per "
          f"step over the streams, deg: {[round(d, 5) for d in alm_deg]} (gate {SPATIAL_DEG}); "
          f"grid vs the unsharded step's, the {PAR_FRAMES - 1} steps after the first, cells "
          f"outside the {margin} px border margin: (mean, p99) EPE px "
          f"({grid_err[0]:.5f}, {grid_err[1]:.5f}) (gates {SPATIAL_MEAN_PX}, {SPATIAL_P99_PX})")
    if per_band != {k: float(n) for k, n in BAND_LAUNCHES.items()}:
        fail(f"parallel: the (2, 2) bands launched {launches}")
    if not finite or max(alm_deg) > SPATIAL_DEG or p22.graph_replays != 2 * PAR_FRAMES:
        fail("parallel: the (2, 2) step's poses are off, or its consumers did not replay")
    if not (grid_err[0] < SPATIAL_MEAN_PX and grid_err[1] < SPATIAL_P99_PX):
        fail("parallel: the (2, 2) step's grid misses the spatial route's gate")

    # The (2, 2) route's full-resolution flow and warm carry, same frames
    # and state: cold (no warm start), then warm-started from the unsharded
    # step's carry after frame 1.  Against the same route on the plain
    # versions of the kernels, and against the unsharded flow.
    params = base.flow_params
    st = base.init_state(b, H, W)
    st, _ = base.step_from_frames(st, frames[0])
    st, _ = base.step_from_frames(st, frames[1])
    epes, vs_plain = {}, {}
    for start, (i1, i2, warm) in {"cold": (frames[0], frames[1], None),
                                  "warm": (frames[1], frames[2], st.warm_uv)}.items():
        (ru, rv), _, _ = dense_flow_warm(i1, i2, params, warm=warm)
        (u, v), carry = dense_flow_warm_spatial(i1, i2, params, warm, mesh22)
        (pu, pv), pcarry = dense_flow_warm_spatial(i1, i2, params, warm, mesh22, plain=True)
        for k, got, want in (("flow", (u, v), (pu, pv)), ("carry", carry, pcarry)):
            vs_plain[f"{start}_{k}"] = compare(torch, got, want, ("flow", None))
        epes[start] = spatial_epe(torch, u, v, ru, rv, SPATIAL_BORDER)
        epes[f"{start}_whole"] = spatial_epe(torch, u, v, ru, rv, 0)
        del pu, pv, pcarry
    phase("parallel", f"(2, 2) full-resolution flow and warm carry vs the same route on the "
          f"plain versions, 1080p B={b}, the whole band output: (max |diff| px, share off "
          f"by >{MISMATCH_PX} px) "
          f"{ {k: (float(f'{e:.3e}'), float(f'{sh:.2e}')) for k, (e, sh, _) in vs_plain.items()} } "
          f"(share gate {MAX_MISMATCH_SHARE})")
    if not all(ok for _, _, ok in vs_plain.values()):
        fail("parallel: the (2, 2) route's kernels disagree with their plain versions")
    phase("parallel", f"(2, 2) full-resolution flow vs unsharded, 1080p B={b}, "
          f"{SPATIAL_BORDER} px off every edge (and, not gated, the whole frame): (mean, p99) "
          f"EPE px { {k: (round(m, 5), round(p, 5)) for k, (m, p) in epes.items()} } (gates "
          f"{SPATIAL_MEAN_PX}, {SPATIAL_P99_PX})")
    if not all(m < SPATIAL_MEAN_PX and p < SPATIAL_P99_PX
               for k, (m, p) in epes.items() if k in ("cold", "warm")):
        fail("parallel: the (2, 2) flow misses the spatial route's gate")
    del base_state, ref, got21, got22, st

    # The codec-MV step on the (2, 1) mesh against the unsharded one,
    # through run_batch (each row packed and uploaded to its own device).
    with tempfile.TemporaryDirectory() as tmp:
        mvecs, gts, _ = codec_fixture(torch, Path(tmp), b, PAR_CODEC_FRAMES)
        kw = dict(estimators=[{"name": n} for n in ESTIMATORS], ground_truths=gts,
                  capacity=CODEC_CAPACITY, seed=SEED + 34, device=device)
        ref_c = run_batch(mvecs, **kw)
        got_c = run_batch(mvecs, shardings=sh21, **kw)
        flows = decoded_flows(torch, mvecs, device)
    alm = ESTIMATORS.index("almeida")
    codec_err = max(float(np.abs(np.stack(g[alm]) - np.stack(r[alm])).max())
                    for g, r in ((got_c.delta_rot, ref_c.delta_rot),
                                 (got_c.rot_hist, ref_c.rot_hist)))
    c_near, c_flips = codec_homography_err(
        torch, make_pipeline(device, False, ESTIMATORS, CODEC_FOV_Y), flows, SEED + 34,
        np.stack(got_c.delta_rot[ESTIMATORS.index("homography")]))
    same_det = bool((got_c.detections == ref_c.detections).all())
    same_vec = bool((got_c.vectors == ref_c.vectors).all())
    phase("parallel", f"codec-MV (2, 1) vs unsharded through run_batch, B={b}, "
          f"{PAR_CODEC_FRAMES} frames, capacity {CODEC_CAPACITY}, {'+'.join(ESTIMATORS)} + "
          f"block_motion: almeida's delta and integrated rotations max |diff| "
          f"{codec_err:.3e}; homography's delta rotation to the unsharded step's nearer "
          f"family {c_near:.3e} (tolerance {GRAPH_TOL}), picks of the other family {c_flips} "
          f"of {b * PAR_CODEC_FRAMES}; detections equal={same_det}, vectors equal={same_vec}; "
          f"graph replays {got_c.graph_replays} (unsharded {ref_c.graph_replays})")
    if not (max(codec_err, c_near) <= GRAPH_TOL and same_det and same_vec
            and got_c.frames == PAR_CODEC_FRAMES
            and got_c.graph_replays == 2 * PAR_CODEC_FRAMES):
        fail("parallel: the codec-MV step on the (2, 1) mesh differs from the unsharded one")

    # Step times: three captures each (the correctness run's pipeline, then
    # two new ones, their graphs captured on their first step), PAR_STEPS
    # steps per capture, CUDA events on cuda:0 (the outputs gather there,
    # so the end waits for every row).
    gen = torch.Generator(device=device).manual_seed(SEED + 33)
    step_ms = {}
    for name, sh, first in (("unsharded", None, base), ("(2,1)", sh21, p21),
                            ("(2,2)", sh22, p22)):
        reps, hosts = [], []
        for pipe in (first, None, None):
            pipe = pipe or make_pipeline(device, False, shardings=sh)
            st0, _ = pipe.step_from_frames(pipe.init_state(b, H, W), frames[0], gen)
            ms, host = time_ms(
                torch, lambda p=pipe, s=st0: p.step_from_frames(s, frames[1], gen), PAR_STEPS)
            reps.append(ms)
            hosts.append(host)
            del pipe, st0
        step_ms[name] = {"ms": sorted(reps)[1], "repeats_ms": reps, "host_enqueue_ms": hosts}
        phase("timing", f"sharded step {name} 1080p B={b} {'+'.join(ESTIMATORS)} + "
              f"block_motion: {sorted(reps)[1]:.3f} ms/step, median of 3 captures x "
              f"{PAR_STEPS} steps {[round(r, 3) for r in reps]} ({sorted(reps)[1] / b:.3f} "
              f"ms/frame); host enqueue ms/step {[round(h, 3) for h in hosts]} | {smi}")
    del base, p21, p22
    if not all(math.isfinite(v["ms"]) for v in step_ms.values()):
        fail("parallel: non-finite timing")
    torch.cuda.empty_cache()
    notes = run_distributed(torch, device)
    phase("parallel", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"meshes": [repr(mesh22), repr(mesh21)], "cards": n_cards, "step_ms": step_ms,
            "stream_only_max_diff": err21, "stream_only_homography": {
                "nearer_family_err": h_near, "other_family_picks": h_flips,
                "picks_max_diff": h_picked},
            "spatial_epe": epes, "spatial_vs_plain": {
                k: {"max_abs_err": e, "mismatch_share": sh} for k, (e, sh, _) in vs_plain.items()},
            "grid_epe": grid_err, "almeida_deg": alm_deg,
            "codec_max_diff": codec_err, "launches_per_band_step": per_band,
            "distributed": notes}, launches


def to_device(x, device):
    """A draw (a tensor, a tuple of them, or None) on ``device``."""
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    return None if x is None else x.to(device)


def cv_kernel_vs_plain(torch, device, frames, use_rlof: bool):
    """The cv step on a clip's frames (T+1, H, W) on the kernels and on
    their plain versions, each step from the same inputs (the plain step
    takes the kernel path's warm start): (share of flow pixels, share of
    grid entries off by more than MISMATCH_PX, max grid |diff| px, valid
    cells equal)."""
    from ofps_torch.apps import evaluate_matrix as em

    h, w = frames.shape[-2:]
    steps = [em.cv_step(h, w, use_rlof, device, plain) for plain in (False, True)]
    gray = torch.from_numpy(frames.astype("float32")).to(device)
    scale = torch.tensor([w, h], dtype=torch.float32, device=device)
    flow = torch.zeros((h, w, 2), dtype=torch.float32, device=device)
    f_off, g_off, n_f, n_g, g_max, same_valid = 0, 0, 0, 0, 0.0, True
    for t in range(1, gray.shape[0]):
        (fk, gk, vk), (fp, gp, vp) = (s(gray[t - 1], gray[t], flow) for s in steps)
        fd = (fk - fp).abs().max(dim=-1).values
        gd = ((gk - gp) * scale).abs()
        f_off += int((fd > MISMATCH_PX).sum().item())
        g_off += int((gd > MISMATCH_PX).sum().item())
        n_f, n_g = n_f + fd.numel(), n_g + gd.numel()
        g_max = max(g_max, gd.max().item())
        same_valid = same_valid and bool(torch.equal(vk, vp))
        flow = fk
    return f_off / n_f, g_off / n_g, g_max, same_valid


def run_matrix(torch, device, counters, smi):
    """The "matrix" phase (the module docstring says what it checks);
    returns (its results, {path: flow launches})."""
    from ofps_torch.apps import evaluate_matrix as em

    t_phase = time.perf_counter()
    clips, batch = list(MATRIX_CLIPS), len(MATRIX_CLIPS)
    phase("matrix", f"codec route {MATRIX_CODEC!r} (fixed: FFmpeg is absent on the H100 "
          f"host; av from the committed .mvec vectors, block and rlof on the rendered "
          f"frames) | clips {clips} as B={batch} streams, {em.H}x{em.W}, {em.T} frames, "
          f"grid {em.GRID}, cv levels {em.CV_LEVELS}")
    cam, schedules = em.camera(), em.make_schedules()
    per_clip, launches = {}, {}
    for source in em.SOURCES:
        def build(src=source):
            return [em.source_fields(src, ci, cam, schedules, device, MATRIX_CODEC)
                    for ci in clips]

        if source in MATRIX_LAUNCHES:
            per_clip[source], counts = count_launches(torch, counters, build)
            path = f"matrix_{source}"
            launches[path] = {k: counts[k] for k in (*MATRIX_LAUNCHES[source], "guard_select")}
            check_per_step(path, launches[path], MATRIX_LAUNCHES[source])
            if launches[path]["guard_select"] != em.T * batch:
                fail(f"{path}: {launches[path]['guard_select']} guarded steps, expected "
                     f"{em.T * batch}")
        else:
            per_clip[source] = build()
        sizes = [[0 if f is None else len(f[0]) for f in fl] for fl in per_clip[source]]
        phase("matrix", f"source {source}: vectors per frame {sizes}"
              + (f", flow launches {launches[f'matrix_{source}']} over {em.T * batch} cv "
                 f"steps" if source in MATRIX_LAUNCHES else ""))
        if min(min(x) for x in sizes) < em.MIN_VECTORS:
            fail(f"matrix: source {source} gave a frame with fewer than {em.MIN_VECTORS} "
                 "vectors")

    # The kernels at the clips' shapes against their plain versions,
    # before anything is timed.
    cv_check = {}
    for source in MATRIX_LAUNCHES:
        worst = [0.0, 0.0, 0.0]
        for ci in clips:
            f_share, g_share, g_max, same_valid = cv_kernel_vs_plain(
                torch, device, em.clip_frames(cam, schedules, ci), source == "rlof")
            worst = [max(a, b) for a, b in zip(worst, (f_share, g_share, g_max))]
            if not same_valid:
                fail(f"matrix: {source} clip {ci}: valid cells differ, kernel vs plain")
        cv_check[source] = dict(zip(("flow_share", "grid_share", "grid_max_px"), worst))
        phase("matrix", f"{source} kernel path vs plain path, every step from the same "
              f"inputs: flow pixels off by >{MISMATCH_PX} px {worst[0]:.2e}, grid entries "
              f"{worst[1]:.2e} (max {worst[2]:.3e} px), valid cells equal")
        if max(worst[:2]) >= MAX_MISMATCH_SHARE:
            fail(f"matrix: {source} kernels disagree with their plain versions at the "
                 "clips' shapes")

    # 1. every source x configuration, gated where JAX gates.
    fields = {s: em.stack_fields(per_clip[s], device) for s in em.SOURCES}
    results = em.run_matrix(clips, device, fields=fields,
                            log=lambda m: phase("matrix", m))
    over = [f"{src} clip{ci} {lab} {results[(src, ci, lab)][0]:.5f} > {ceil}"
            for (src, ci), gates in MATRIX_GATES.items() for lab, ceil in gates.items()
            if not results[(src, ci, lab)][0] <= ceil]
    n_gated = sum(len(g) for g in MATRIX_GATES.values())
    phase("matrix", f"{n_gated} gated cells against JAX's ceilings: "
          f"{'all under' if not over else over}")
    if over:
        fail(f"matrix: cells over JAX's ceilings: {over}")
    ate_pct, dir_deg, rot_deg = em.eval_translation_path(
        cam, em.translation_cloud(cam), *em.make_translation_paths()[0], 8, device)
    phase("matrix", f"translation path 0, libmv-8pt: ATE {ate_pct:.3f}% of the path "
          f"(< {MATRIX_ATE_PCT}), direction {dir_deg:.3f} deg (< {MATRIX_DIR_DEG}), "
          f"rotation {rot_deg:.5f} deg")
    if not (ate_pct < MATRIX_ATE_PCT and dir_deg < MATRIX_DIR_DEG):
        fail("matrix: translation path 0 over test_translation_matrix_cell's bars")

    # 2. the card against the port on the CPU: gt-mv, the same draws.
    cpu = torch.device("cpu")
    flows_cpu = em.stack_fields(per_clip["gt-mv"], cpu)
    n = flows_cpu.capacity
    truths = [em._truth_quats(schedules[ci]) for ci in clips]
    agree, t_cpu = {}, 0.0
    for label in AGREE_CONFIGS:
        pipe_c = em.make_pipeline(label, cam, cpu)
        est = pipe_c.estimators[0]
        gen = torch.Generator().manual_seed(em.SEED)
        draws = [(est.draw(gen, (batch,), n, cpu, dense=False),) for _ in range(em.T)]
        t0 = time.perf_counter()
        rots_c, _ = em.run_config(pipe_c, flows_cpu, draws=draws)
        t_cpu += time.perf_counter() - t0
        rots_g, _ = em.run_config(em.make_pipeline(label, cam, device), fields["gt-mv"],
                                  draws=[to_device(d, device) for d in draws])
        for ci, eg, ec in zip(clips, em.mean_errors_deg(rots_g, truths),
                              em.mean_errors_deg(rots_c, truths)):
            agree[f"{label}/clip{ci}"] = {"card": eg, "cpu": ec, "diff": abs(eg - ec)}
    worst = max(v["diff"] for v in agree.values())
    phase("matrix", f"card vs the port on the CPU (gt-mv, same draws; the CPU half "
          f"{t_cpu:.1f} s): " + ", ".join(
              f"{k} {v['card']:.5f}/{v['cpu']:.5f}" for k, v in agree.items())
          + f"; max |diff| {worst:.2e} deg/frame (tolerance {AGREE_DEG})")
    if worst > AGREE_DEG:
        fail("matrix: the card and the CPU disagree")
    seconds = time.perf_counter() - t_phase
    phase("matrix", f"phase seconds {seconds:.1f} | {smi}")
    return {
        "codec_route": MATRIX_CODEC, "clips": clips,
        "cells": {f"{src}/clip{ci}/{lab}": {"deg_per_frame": err, "ms_per_frame": ms}
                  for (src, ci, lab), (err, ms) in results.items()},
        "gated_cells": n_gated, "ate_path0_8pt": {"ate_pct": ate_pct, "dir_deg": dir_deg},
        "agreement": agree, "agreement_cpu_s": t_cpu, "cv_kernel_vs_plain": cv_check,
        "seconds": seconds,
    }, launches


def run_samples(torch, device, counters, smi):
    """The "samples" phase (the module docstring says what it checks);
    returns its results."""
    import contextlib
    import csv
    import io
    import re
    import tempfile

    from ofps_torch.apps import cli, samples

    t_phase = time.perf_counter()
    out = {}

    def run_config(path, args=()):
        """``cli.main`` on a config: (exit code, printed lines)."""
        with contextlib.redirect_stdout(io.StringIO()) as said:
            rc = cli.main([*args, "run-config", path])
        return rc, said.getvalue().strip().splitlines()

    def rows(path):
        with open(path, newline="") as f:
            return list(csv.reader(f))

    def stage_ms(path, stage):
        """(median after the first frame, first frame) ms of a stage."""
        r = rows(path)
        ms = [float(x[r[0].index(stage)]) for x in r[1:]]
        return sorted(ms[1:])[len(ms[1:]) // 2], ms[0]

    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = samples.main([tmp, "--no-video"])
        if rc != 0:
            fail("samples: the generator failed")
        frames = len(samples.DELTAS_DEG) + 1
        for name in SAMPLES_TRACKING:
            cfg = json.loads(Path(tmp, name).read_text())
            names = [e["name"] for e in cfg["estimators"]]
            res = {}
            for where, args in (("card", ("--device", str(device))), ("cpu", ("--device", "cpu"))):
                # The generated config with a per-frame times CSV added.
                perf_csv = str(Path(tmp, f"perf_{where}.csv"))
                run = dict(cfg, output=dict(cfg["output"], perf_csv=perf_csv))
                Path(tmp, f"run_{where}.json").write_text(json.dumps(run))
                (rc, lines), counts = count_launches(
                    torch, counters, lambda: run_config(str(Path(tmp, f"run_{where}.json")), args))
                stats = {n: rows(cfg["output"]["stats_csv_prefix"] + n + ".csv") for n in names}
                err = {}
                for n, r in stats.items():
                    col = r[0].index("error")
                    e = [float(x[col]) for x in r[1:] if x[col]]
                    err[n] = math.degrees(sum(e) / len(e)) if len(r) == frames + 1 else math.inf
                graphs = re.search(r"consumers: (\d+) CUDA graph\(s\), (\d+) replays, (\d+) eager",
                                   "\n".join(lines))
                res[where] = {
                    "rc": rc, "deg_per_frame": err,
                    "graphs": [int(g) for g in graphs.groups()] if graphs else None,
                    "estimate_ms": stage_ms(perf_csv, "estimate"),
                    "decode_ms": stage_ms(perf_csv, "decode"),
                    "flow_launches": sum(counts.values()),
                    "printed": [x.strip() for x in lines if "avg" in x],
                }
            card, cpu = res["card"], res["cpu"]
            diff = {n: abs(card["deg_per_frame"][n] - cpu["deg_per_frame"][n]) for n in names}
            out[name] = {**res, "diff_deg": diff}
            phase("samples", f"run-config {name} ({'+'.join(names)}, {frames} frames of "
                  f"the synthetic rotation, B=1): rc card {card['rc']} cpu {cpu['rc']}; mean "
                  f"rotation error deg/frame card/cpu "
                  + ", ".join(f"{n} {card['deg_per_frame'][n]:.6f}/{cpu['deg_per_frame'][n]:.6f}"
                              for n in names)
                  + f" (bars: almeida {SAMPLES_ALMEIDA_DEG}, each {SAMPLES_EST_DEG}, card vs "
                  f"cpu {AGREE_DEG}); consumers on the card (graphs, replays, eager) "
                  f"{card['graphs']}, flow kernel launches {card['flow_launches']} (.mvec "
                  f"input: none expected); stages ms/frame, median after the first frame "
                  f"(first frame): estimate card {card['estimate_ms'][0]:.3f} "
                  f"({card['estimate_ms'][1]:.1f}) cpu {cpu['estimate_ms'][0]:.3f} "
                  f"({cpu['estimate_ms'][1]:.1f}), decode card {card['decode_ms'][0]:.3f}; "
                  f"printed {card['printed']} | {smi}")
            if not (card["rc"] == cpu["rc"] == 0 and card["graphs"] == [1, frames, 0]):
                fail(f"samples: {name} failed, or did not run one graph replay per frame")
            for n in names:
                bar = SAMPLES_ALMEIDA_DEG if n == "almeida" else SAMPLES_EST_DEG
                if not (card["deg_per_frame"][n] < bar and cpu["deg_per_frame"][n] < bar
                        and diff[n] <= AGREE_DEG):
                    fail(f"samples: {name} {n} misses its bar or the CPU")

        # basic_detect's detector and settings on the committed vectors.
        det = samples.sample_configs(tmp)["basic_detect.json"]
        det["decoder"]["input"] = str(HERE / SAMPLES_DETECT_MVEC)
        det["output"] = {"ranges_csv": str(Path(tmp, "ranges.csv")),
                         "perf_csv": str(Path(tmp, "det_perf.csv"))}
        Path(tmp, "det.json").write_text(json.dumps(det))
        rc, lines = run_config(str(Path(tmp, "det.json")), ("--device", str(device)))
        ranges = [tuple(int(v) for v in r) for r in rows(det["output"]["ranges_csv"])]
        det_ms = stage_ms(det["output"]["perf_csv"], "detect")
        out["basic_detect"] = {"rc": rc, "ranges": ranges, "detect_ms": det_ms}
        phase("samples", f"basic_detect's block_motion {det['detector']['properties']} and "
              f"settings {det['settings']} on {SAMPLES_DETECT_MVEC}: rc {rc}, printed {lines}, "
              f"ranges {ranges} (want {SAMPLES_DETECT_RANGES}); detect ms/frame median after "
              f"the first frame {det_ms[0]:.3f} (first {det_ms[1]:.1f}) | {smi}")
        if not (rc == 0 and ranges == SAMPLES_DETECT_RANGES
                and lines == [f"processed 30 frames; motion ranges: {SAMPLES_DETECT_RANGES}"]):
            fail("samples: basic_detect's ranges differ from the CPU's")
    out["seconds"] = time.perf_counter() - t_phase
    phase("samples", f"phase seconds {out['seconds']:.1f} | {smi}")
    return out


def run_bench(torch, device, counters, smi):
    """The "bench" phase (the module docstring says what it checks);
    returns (its results, {path: flow launches})."""
    import contextlib
    import io
    import tempfile

    from ofps_torch.apps import (
        bench,
        bench_estimators,
        check_backend_agreement,
        cli,
        perf_lab,
        profile_libmv,
        profile_pipeline,
    )

    t_phase = time.perf_counter()
    dev = str(device)

    def num(x, nd: int) -> str:
        return "n/a" if x is None else f"{x:.{nd}f}"

    def tool(main, argv, tail: int = 1):
        """``main(argv)`` with its standard output captured: (exit code,
        the JSON object on its ``tail``-th line from the end)."""
        with contextlib.redirect_stdout(io.StringIO()) as said:
            rc = main(argv)
        return rc, json.loads(said.getvalue().strip().splitlines()[-tail])

    # 1. the benchmark through the command line, at bench.py's defaults.
    t0 = time.perf_counter()
    rc, rec = tool(cli.main, ["--device", dev, "bench"])
    bench_s = time.perf_counter() - t0
    print("bench " + json.dumps(rec), flush=True)
    d = rec["detail"]
    fps = [rec["value"], rec["vs_baseline"], rec["pipeline_all4_fps_per_chip"],
           *rec["pipeline_1080p_fps_per_chip"].values()]
    sums = [*d["flow"]["checksum"], *d["all4"]["checksum"],
            *(c for p in d["pipeline"].values() for c in p["checksum"])]
    phase("bench", f"cli bench rc {rc} in {bench_s:.1f} s: flow {rec['value']} frames/s "
          f"(median {d['flow']['fps_median']:.2f}; x{rec['vs_baseline']} the reference's "
          f"Farneback), serving step {rec['pipeline_1080p_fps_per_chip']} (median "
          f"{ {k: round(p['fps_median'], 2) for k, p in d['pipeline'].items()} }), all four "
          f"B=8 {rec['pipeline_all4_fps_per_chip']} (median {d['all4']['fps_median']:.2f}); "
          f"peak {d.get('max_memory_allocated_bytes', 0) / 2**30:.2f} GiB | {smi}")
    if rc != 0 or set(rec["pipeline_1080p_fps_per_chip"]) != {"b1", "b4", "b8"}:
        fail("bench: the benchmark failed or lacks bench.py's keys")
    if not all(math.isfinite(x) and x > 0 for x in fps) or not all(map(math.isfinite, sums)):
        fail(f"bench: a frames/s is not finite and positive, or a checksum not finite: {fps}")

    # 2. flow launches per step of the bench's flow chain and serving step.
    launches = {}
    i1, i2 = bench.make_inputs(1, H, W, device)
    run_flow = bench.build_runner(1, H, W, BENCH_LAUNCH_STEPS)
    run_step = bench.build_pipeline_runner(1, H, W, BENCH_LAUNCH_STEPS, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    for path, fn in (("bench_flow", lambda: run_flow(i1, i2).item()),
                     ("bench_step", lambda: run_step(i1, gen).item())):
        _, counts = count_launches(torch, counters, fn)
        launches[path] = {k: counts[k] for k in (*BENCH_LAUNCHES, "guard_select")}
        check_per_step(path, launches[path], BENCH_LAUNCHES)
        if launches[path]["guard_select"] != BENCH_LAUNCH_STEPS:
            fail(f"{path}: {launches[path]} over {BENCH_LAUNCH_STEPS} steps")
    phase("bench", f"flow launches over {BENCH_LAUNCH_STEPS} steps at 1080p B=1: {launches}")
    del run_flow, run_step, i1, i2
    torch.cuda.empty_cache()

    # 3. the timing tools; an exception or a disagreement fails the phase.
    out = {"bench": rec, "bench_s": bench_s}
    with tempfile.TemporaryDirectory() as tmp:
        rc, est = tool(bench_estimators.main, ["--device", dev, "--out", f"{tmp}/est.md"])
    out["estimators"] = {k: {"best": r["best"], "median": r["median"], "err_deg": r["err_deg"]}
                         for k, r in est["estimators"].items()}
    phase("bench", f"bench_estimators rc {rc}, ms/frame best (median) at B=1, 150x84: "
          + ", ".join(f"{k} {r['best']:.3f} ({r['median']:.3f})" for k, r in
                      out["estimators"].items()) + f" | {smi}")
    if rc != 0 or not all(r["err_deg"] < EST_AGREE_DEG for r in out["estimators"].values()):
        fail("bench: bench_estimators failed or an estimator missed the rotation")
    rc, prof = tool(profile_pipeline.main, [
        "--device", dev, "--stages", BENCH_PROFILE_STAGES,
        "--iters", str(BENCH_PROFILE_ITERS["profile_pipeline"])])
    out["profile_pipeline"] = {k: (prof[k], prof["device_us"][k])
                               for k in BENCH_PROFILE_STAGES.split(",")}
    phase("bench", f"profile_pipeline rc {rc}, us/step (device-only us) at 1080p B=1: "
          + ", ".join(f"{k} {v[0]:.1f} ({num(v[1], 1)})" for k, v in
                      out["profile_pipeline"].items()) + f" | {smi}")
    rc2, lib = tool(profile_libmv.main, [
        "--device", dev, "--iters", str(BENCH_PROFILE_ITERS["profile_libmv"])])
    out["profile_libmv"] = {k: (r["best"], r["device_ms"]) for k, r in lib["stages"].items()}
    phase("bench", f"profile_libmv rc {rc2}, ms/iter (device-only ms): "
          + ", ".join(f"{k} {v[0]:.3f} ({num(v[1], 3)})" for k, v in out["profile_libmv"].items())
          + f" | {smi}")
    rc3, lab = tool(perf_lab.main, ["base", "parts", "ablate", "--device", dev])
    out["perf_lab"] = {"base_ms": lab["base"]["best"],
                       "parts": {k: (r["best"], r["device_ms"]) for k, r in lab["parts"].items()},
                       "ablate_fps": {k: r["fps_best"] for k, r in lab["ablate"].items()},
                       "max_memory_allocated_bytes": lab.get("max_memory_allocated_bytes")}
    phase("bench", f"perf_lab rc {rc3}: base B={lab['batch']} {lab['base']['best']:.3f} ms/call; parts "
          + ", ".join(f"{k} {v[0]:.4f} ({num(v[1], 4)})" for k, v in
                      out["perf_lab"]["parts"].items())
          + "; ablate frames/s " + ", ".join(f"{k} {v:.1f}" for k, v in
                                             out["perf_lab"]["ablate_fps"].items())
          + f"; peak {lab.get('max_memory_allocated_bytes', 0) / 2**30:.2f} GiB | {smi}")
    rc4, agree = tool(check_backend_agreement.main, ["--device", dev], tail=2)
    cell, worst = max(((k, c["diff"]) for k, c in agree["cells"].items()), key=lambda x: x[1])
    out["agreement"] = {"rc": rc4, "max_diff_deg": worst, "worst_cell": cell,
                        "disagree": agree["disagree"]}
    phase("bench", f"check_backend_agreement rc {rc4}: max |card - cpu| {worst:.2e} deg/frame "
          f"({cell}: card {agree['cells'][cell]['device']:.5f}, cpu "
          f"{agree['cells'][cell]['cpu']:.5f}) over {len(agree['cells'])} cells, the same "
          f"fields and draws (tolerance {check_backend_agreement.TOL_DEG})")
    if rc != 0 or rc2 != 0 or rc3 != 0 or rc4 != 0:
        fail("bench: a timing tool failed, or the card and the CPU disagree")
    out["seconds"] = time.perf_counter() - t_phase
    phase("bench", f"phase seconds {out['seconds']:.1f} | {smi}")
    return out, launches


def consumer_kernels(torch, pipe, state, grid, draws):
    """CUDA kernels and their summed device ms in one eager ``_consume``
    (the calls its CUDA graph replays), from ``torch.profiler``; (None,
    None) where the profiler sees no CUDA events.  ``pipe`` has run its
    consumers before (their graph's capture warms them up)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe._consume(grid, state.rot, state.pos, draws, state.est)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, None
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def main() -> None:
    if not (HERE / "ofps_torch" / "csrc").is_dir():
        fail("the ofps_torch package is not beside chip_smoke.py")
    sys.path.insert(0, str(HERE))
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")

    # 2. build
    from ofps_torch.kernels import almeida as kalm
    from ofps_torch.kernels import build
    from ofps_torch.kernels import flow_refine as kfr
    from ofps_torch.kernels import flow_refine_small as kfs
    from ofps_torch.kernels import warp as kwarp

    t0 = time.perf_counter()
    build.library()
    phase("build", f"nvcc sm_90a build+load {time.perf_counter() - t0:.2f} s "
          f"({build.source_digest()})")
    counters = launch_counters(kfr, kfs, kwarp, kalm)
    # The median has no launch of its own any more: no wrapper or entry
    # point that a path could call for it.
    if hasattr(kfs, "median3x3_uv") or hasattr(build.library(), "ofps_median3x3"):
        fail("a standalone median launch exists")

    # 3. kernels vs plain
    batch = 4
    cases = kernel_cases(torch, device, batch)
    cases["almeida_ransac"] = almeida_cases(torch, device)
    cases["multiview_ransac"] = multiview_cases(torch, device)
    cases["homography_ransac"] = homography_cases(torch, device)
    results = {}
    for name, items in cases.items():
        worst, share, ok, errs = 0.0, 0.0, True, []
        for c in items:
            got, ref = c.kcall(), c.pcall()
            torch.cuda.synchronize()
            e, s, good = compare(torch, got, ref, c.kind)
            worst, share, ok = max(worst, e), max(share, s), ok and good
            errs.append(e)
        results[name] = {"max_abs_err": worst, "mismatch_share": share}
        notes = [c.note for c in items if c.note]
        phase("kernels", f"{name}: {len(items)} case(s) "
              f"{[c.shape for c in items]} max_abs_err={worst:.3e} "
              f"mismatch_share={share:.2e} {'ok' if ok else 'FAILED'}"
              + (f" ({'; '.join(notes)})" if notes else "")
              + (f" per case {[f'{e:.3e}' for e in errs]}" if len(items) > 1 else ""))
        if not ok:
            fail(f"{name} disagrees with its plain version")
    # Homography away from the pure-rotation branch: a translating plane,
    # whose two decomposition families differ.
    for c in homography_cases(torch, device, plane=True):
        got, ref = c.kcall(), c.pcall()
        torch.cuda.synchronize()
        e, s, good = compare(torch, got, ref, c.kind)
        phase("kernels", f"homography_ransac {c.note} {c.shape}: family gap {e:.3e} rad, "
              f"mismatch_share={s:.2e} {'ok' if good else 'FAILED'}")
        if not good:
            fail("homography_ransac disagrees with its plain version on a translating plane")
    for c in cases["warp_bilinear"]:
        phase("kernels", f"warp_bilinear {c.shape}: grid_sample (library) vs plain "
              f"max |diff| {(c.library() - c.pcall()).abs().max().item():.3e}")

    # 4. the slice
    frames = moving_frames(torch, 8, batch, H, W, device)
    pipe = make_pipeline(device, plain=False)
    state = pipe.init_state(batch, H, W)
    gen = torch.Generator(device=device).manual_seed(SEED)
    (state, outs), counts = count_launches(
        torch, counters, lambda: pipe.scan_frames(state, frames, gen))
    slice_kernels = ("flow_refine", "flow_refine_small", "guard_select", "median3x3_uv")
    launches = {k: counts[k] for k in slice_kernels}
    launches_by_path = {"serving_slice": launches}
    phase("slice", f"1080p B={batch} 8 frames: launches {launches} (median3x3_uv: "
          f"refine launches that took the fused median)")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path was never launched: {launches}")
    # Per step: 6 levels, four axis-separable, 67x120 s=1 and the two 33x60
    # s=6 sweeps, one guard; the medians of levels 5..2 in the refines of
    # levels 4..1.
    check_per_step("serving_slice", launches, {
        "flow_refine": 4, "flow_refine_small": 3, "median3x3_uv": 4})
    # Almeida's kernels: launched from the host twice a capture, and
    # ALMEIDA_LAUNCHES of them in every replay of the consumers' graph.
    last = outs[-1]
    n_last = last.grid.shape[1] * last.grid.shape[2]
    launches["almeida_ransac"] = replay_kernels(
        torch, pipe, state, last.grid, tuple(e.draw(gen, (batch,), n_last, device)
                                             for e in pipe.estimators))
    phase("slice", f"almeida_ransac: {counts['almeida_ransac']} host launches for "
          f"{len(pipe.graphs.calls)} capture(s) and {pipe.graph_replays} replays; "
          f"{launches['almeida_ransac']} almeida kernels in a replay (torch.profiler)")
    if (counts["almeida_ransac"] != 2 * ALMEIDA_LAUNCHES * len(pipe.graphs.calls)
            or pipe.graph_replays != frames.shape[0] + 1
            or launches["almeida_ransac"] not in (None, ALMEIDA_LAUNCHES)):
        fail("serving_slice: almeida's kernels did not run once a replay, in the graph")
    launches["homography_ransac"] = replay_kernels(
        torch, pipe, state, last.grid, tuple(e.draw(gen, (batch,), n_last, device)
                                             for e in pipe.estimators), part="::hg_")
    phase("slice", f"homography_ransac: {counts['homography_ransac']} host launches for "
          f"{len(pipe.graphs.calls)} capture(s); {launches['homography_ransac']} homography "
          f"kernels in a replay (torch.profiler)")
    if (counts["homography_ransac"] != 2 * HOMOGRAPHY_LAUNCHES * len(pipe.graphs.calls)
            or launches["homography_ransac"] not in (None, HOMOGRAPHY_LAUNCHES)):
        fail("serving_slice: homography's kernels did not run once a replay, in the graph")
    u_px = last.grid[:, 8:-8, 8:-8, 0] * W
    med = u_px.median().item()
    rot_ok = all(bool(torch.isfinite(r).all()) for o in outs for r in o.rot + o.delta_rot)
    det = last.detection
    det_ok = (
        bool(det.detected.all())
        and det.mask.shape == (batch, 14, 14) and det.area.shape == (batch,)
        and bool(((det.area >= 0) & (det.area <= 196)).all())
        and bool((det.mask.sum(dim=(-1, -2)).to(torch.int32) == det.area).all())
    )
    from ofps_torch.core import quat

    delta_deg = {
        name: [round(math.degrees(quat.angle(o.delta_rot[i][0]).item()), 4) for o in outs]
        for i, name in enumerate(ESTIMATORS)
    }
    phase("slice", f"grid {tuple(last.grid.shape)} interior median u*W="
          f"{med:.4f} px (expect {SHIFT}) rot finite (both estimators, every frame)="
          f"{rot_ok} rot[0]={[r[0].tolist() for r in last.rot]} detected="
          f"{det.detected.tolist()} area={det.area.tolist()} patch detected and "
          f"well-formed={det_ok}; delta angle per frame, stream 0, deg: {delta_deg}")
    if not abs(med - SHIFT) <= 0.1:
        fail(f"3 px shift not recovered: median {med}")
    if not (rot_ok and det_ok):
        fail("non-finite rotation, or the moving patch not detected")
    # The same frames and draws through the plain path.  The two differ
    # only where a float32 near-tie flips an argmin; through the warm
    # start such a flip can move a cell mean for a few frames, so the check
    # bounds the share of grid entries off by more than 1e-5 (normalized).
    pipe_p = make_pipeline(device, plain=True)
    gen_p = torch.Generator(device=device).manual_seed(SEED)
    _, outs_p = pipe_p.scan_frames(pipe_p.init_state(batch, H, W), frames, gen_p)
    diffs = torch.stack([(o.grid - p.grid).abs() for o, p in zip(outs, outs_p)])
    g_share = (diffs > 1e-5).float().mean().item()
    r_err = max((o.rot[0] - p.rot[0]).abs().max().item() for o, p in zip(outs, outs_p))
    n_grid = last.grid.shape[1] * last.grid.shape[2]
    h_near, h_flips, h_picked = homography_vs_plain(
        torch, pipe_p, outs, outs_p,
        frame_draws(torch, pipe_p, SEED, frames.shape[0], batch, n_grid, device))
    phase("slice", f"kernel path vs plain path over 8 frames: grid entries off "
          f"by >1e-5 {g_share:.2e} (max {diffs.max().item():.3e} normalized), "
          f"almeida rot max |diff| {r_err:.3e}; homography delta rot max |diff| to "
          f"the plain path's nearer family {h_near:.3e}, picks of the other family "
          f"{h_flips} of {batch * frames.shape[0]}, max |diff| of the picks {h_picked:.3e}")
    if not (g_share <= 1e-2 and r_err <= ROT_PATH_TOL and h_near <= ROT_PATH_TOL):
        fail("kernel path and plain path disagree")
    del pipe, pipe_p, state, outs, outs_p, diffs
    launches_by_path["all4"] = run_all4(torch, device, counters)
    torch.cuda.empty_cache()

    # 5. the big levels' 2-D mode through dense_flow (B=1, cold start).
    from ofps_torch.ops.flow_pyramid import (
        FlowParams, dense_flow, effective_levels, level_search, uses_axis_sep)

    f0, f1 = frames[0, :1].contiguous(), frames[1, :1].contiguous()
    big2d = 0
    for params in (FlowParams(axis_sep=False), FlowParams(search=2)):
        flow, counts = count_launches(
            torch, counters, lambda p=params: dense_flow(f0, f1, p))
        levels = effective_levels(params, H, W)
        sizes = [(H >> lvl, W >> lvl) for lvl in range(levels)]
        non_sep = [
            (lvl, hw) for lvl, hw in enumerate(sizes)
            if not uses_axis_sep(params, level_search(params, lvl, levels), *hw)
        ]
        big = [hw for _, hw in non_sep if hw[0] * hw[1] >= params.fuse_min_pixels]
        small = len(non_sep) - len(big)
        big_launches = counts["flow_refine_2d"] - small
        flow_p = dense_flow(f0, f1, params, plain=True)
        d = (flow - flow_p).abs().max(dim=-1).values
        share = (d > MISMATCH_PX).float().mean().item()
        med = flow[0, 64:-64, 64:-64, 0].median().item()
        phase("refine_2d", f"dense_flow 1080p B=1 axis_sep={params.axis_sep} "
              f"search={params.search}: 2-D sweep launches {counts['flow_refine_2d']} "
              f"({big_launches} at the big levels {big}), interior median u "
              f"{med:.4f} px, kernel vs plain pixels off by >1e-3 px {share:.2e}")
        if big_launches != len(big) or big_launches <= 0:
            fail(f"the big levels' 2-D mode did not run its kernel: {counts}")
        if not (abs(med - SHIFT) <= 0.1 and share <= 1e-2):
            fail("2-D mode: shift not recovered, or kernel and plain paths disagree")
        big2d += big_launches
    launches_by_path["refine_2d"] = {"flow_refine_2d": big2d}
    del flow, flow_p, d

    # 6. the cv decoder's step, both algorithms, B=1, 8 frames, with a
    # low-contrast band that the mask drops.
    cv_frames = with_low_contrast_band(frames[:, 0])
    cv_kernels = {
        "cv_sad": ("flow_refine", "flow_refine_small", "guard_select", "median3x3_uv"),
        "cv_rlof": ("warp_bilinear", "guard_select"),
    }
    for path, need in cv_kernels.items():
        use_rlof = path == "cv_rlof"
        outs, counts = count_launches(
            torch, counters, lambda r=use_rlof: run_cv(torch, device, cv_frames, r, False))
        launches_by_path[path] = {k: counts[k] for k in need}
        if not use_rlof:
            # 5 levels: four axis-separable, the two 67x120 s=6 sweeps, one
            # guard; the medians of levels 4..2 in the refines of 3..1.
            check_per_step(path, launches_by_path[path], {
                "flow_refine": 4, "flow_refine_small": 2, "median3x3_uv": 3})
        meds, n_valid = [], []
        for _, grid, valid in outs:
            meds.append(grid[..., 0][valid].median().item() * W)
            n_valid.append(int(valid.sum().item()))
        outs_p = run_cv(torch, device, cv_frames, use_rlof, True)
        same_valid = all(bool(torch.equal(o[2], p[2])) for o, p in zip(outs, outs_p))
        if use_rlof:
            err = max((o[0] - p[0]).abs().max().item() for o, p in zip(outs, outs_p))
            agree, detail = err <= LK_PATH_TOL, f"flow max |diff| {err:.3e} px"
        else:
            gd = torch.stack([(o[1] - p[1]).abs() for o, p in zip(outs, outs_p)])
            g_share = (gd > 1e-5).float().mean().item()
            agree = g_share <= 1e-2
            detail = (f"grid entries off by >1e-5 {g_share:.2e} (max "
                      f"{gd.max().item():.3e} normalized)")
        phase("cv", f"{path} 1080p 7 steps: launches {launches_by_path[path]}, "
              f"median u*W of the valid cells per step {[round(m, 4) for m in meds]} "
              f"(expect {SHIFT}), valid cells {n_valid} of "
              f"{outs[0][2].numel()}; kernel vs plain path: {detail}, "
              f"valid cells equal={same_valid}")
        if min(counts[k] for k in need) <= 0:
            fail(f"{path}: a kernel of the path was never launched: {counts}")
        if not all(0 < n < outs[0][2].numel() for n in n_valid):
            fail(f"{path}: the contrast mask kept none or all of the cells: {n_valid}")
        if not all(abs(m - SHIFT) <= CV_PAN_TOL for m in meds):
            fail(f"{path}: 3 px pan not recovered: {meds}")
        if not (agree and same_valid):
            fail(f"{path}: kernel path and plain path disagree")
        del outs, outs_p

    # 7. the estimators on a synthetic camera rotation (B=4, serving
    # lattice).
    run_estimators(torch, device, batch)

    # 8. the codec-MV path: .mvec streams through run_batch, B=8.
    codec = run_codec(torch, device, counters, smi)
    launches_by_path["codec"] = codec.pop("launches")
    torch.cuda.empty_cache()

    # 9. the command line and the single-stream apps, and dense_flow_stream.
    apps, launches_by_path["dense_flow_stream"] = run_apps(torch, device, counters, smi)
    torch.cuda.empty_cache()

    # 10. the multi-device layer: (2, 2) and (2, 1) meshes, distributed.
    parallel, launches_by_path["sharded"] = run_parallel(torch, device, counters, smi)
    torch.cuda.empty_cache()

    # 11. the evaluation matrix on clips 0 and 5, the card against the CPU.
    matrix, matrix_launches = run_matrix(torch, device, counters, smi)
    launches_by_path.update(matrix_launches)
    torch.cuda.empty_cache()

    # 12. BASELINE's sample configs through the command line.
    samples = run_samples(torch, device, counters, smi)
    torch.cuda.empty_cache()

    # 13. the port's benchmark and timing tools.
    bench, bench_launches = run_bench(torch, device, counters, smi)
    launches_by_path.update(bench_launches)
    torch.cuda.empty_cache()

    # 14. timing
    from ofps_torch.decoders.cv import CvFlowStep
    from ofps_torch.ops.flow_pyramid import dense_flow_warm

    step_ms = {}
    for plain in (False, True):
        for names, b in ((ESTIMATORS, 1), (ESTIMATORS, 4), (ESTIMATORS, 8), (ALL4, ALL4_BATCH)):
            pipe = make_pipeline(device, plain, names)
            fr = moving_frames(torch, 2, b, H, W, device)
            st = pipe.init_state(b, H, W)
            st, _ = pipe.step_from_frames(st, fr[0], gen)

            def step(st=st, pipe=pipe, f=fr[1]):
                return pipe.step_from_frames(st, f, gen)

            def flow(st=st, pipe=pipe, f=fr[1]):
                return dense_flow_warm(
                    st.prev_cache.pyr[0], f, pipe.flow_params, warm=st.warm_uv,
                    prev_cache=st.prev_cache, grid_plan=pipe._grid_plan(H, W),
                    plain=plain)

            _, out = step()
            n = out.grid.shape[1] * out.grid.shape[2]
            draws = tuple(e.draw(gen, (b,), n, device) for e in pipe.estimators)

            def consumers(st=st, pipe=pipe, grid=out.grid, d=draws):
                return pipe._run_consumers(st, grid, d, None)

            iters = PLAIN_ITERS if plain else 10
            ms = time_ms(torch, step, iters)[0]
            f_ms, c_ms = time_ms(torch, flow, iters)[0], time_ms(torch, consumers, iters)[0]
            config = "+".join(names)
            step_ms[("plain" if plain else "kernel", b, config)] = ms
            phase("timing", f"step {'plain ' if plain else 'kernel'} B={b} {config} "
                  f"{ms:.3f} ms/step ({ms / b:.3f} ms/frame): dense flow "
                  f"{f_ms:.3f} ms, estimator+detector {c_ms:.3f} ms | {smi}")
            del pipe, st, fr, out
    # The consumers' graph with each estimator alone and together, on the
    # serving step's grid of the 3 px scene, and its kernels per replay: at
    # B=4 the serving configuration's, at B=8 the all-estimator one's.
    consumers_ms, consumer_kernel_counts = {}, {}
    for b, sets in ((batch, (("almeida",), ("homography",), ESTIMATORS)),
                    (ALL4_BATCH, (("multiview",), ("libmv",), ALL4))):
        fr = moving_frames(torch, 2, b, H, W, device)
        grid_b = None
        for names in sets:
            pipe = make_pipeline(device, False, names)
            st = pipe.init_state(b, H, W)
            if grid_b is None:
                st1, _ = pipe.step_from_frames(st, fr[0], gen)
                grid_b = pipe.step_from_frames(st1, fr[1], gen)[1].grid
            d = tuple(e.draw(gen, (b,), n_grid, device) for e in pipe.estimators)
            key = f"{'+'.join(names)}_B{b}"
            consumers_ms[key] = time_ms(
                torch, lambda p=pipe, s=st, d=d, g=grid_b: p._run_consumers(s, g, d, None), 10)[0]
            kernels, kernel_ms = consumer_kernels(torch, pipe, st, grid_b, d)
            consumer_kernel_counts[key] = {"kernels": kernels, "kernel_ms": kernel_ms}
            phase("timing", f"consumers' graph B={b}, {'+'.join(names)} + block_motion: "
                  f"{consumers_ms[key]:.3f} ms per replay; "
                  + (f"{kernels} CUDA kernels, {kernel_ms:.3f} ms of kernel time in the same "
                     f"calls made eagerly (torch.profiler)" if kernels else
                     "kernels per replay not measured (the profiler saw no CUDA events)")
                  + f" | {smi}")
            del pipe, st
        del fr, grid_b
    cv_ms = {}
    prev_flow = torch.full((H, W, 2), SHIFT, dtype=torch.float32, device=device)
    for use_rlof in (False, True):
        for plain in (False, True):
            step = CvFlowStep(H, W, use_rlof=use_rlof, device=device, plain=plain)

            def cv_step(s=step):
                return s(cv_frames[0], cv_frames[1], prev_flow)

            iters = PLAIN_ITERS if plain else 10
            ms, host_ms = time_ms(torch, cv_step, iters)
            key = f"cv_{'rlof' if use_rlof else 'sad'}_{'plain' if plain else 'kernel'}"
            cv_ms[key] = ms
            phase("timing", f"{key} 1080p B=1 {ms:.3f} ms/step (host enqueue "
                  f"{host_ms:.3f} ms/step) | {smi}")
    timings = {}
    for name, items in cases.items():
        t = timings[name] = time_cases(torch, items)
        pms = [time_ms(torch, c.pcall, PLAIN_ITERS)[0] for c in items]
        bms = [c.bound for c in items]
        by = ("bytes" if sum(c.bytes_ms for c in items) >= sum(c.ops_ms for c in items)
              else "operations")
        lib = sum(t["library_ms"]) if items[0].library else None
        lib_dev = sum(t["library_device_ms"]) if items[0].library else None
        results[name].update(ms=sum(t["ms"]), device_ms=sum(t["device_ms"]),
                             plain_ms=sum(pms), bound_ms=sum(bms), bound_by=by,
                             library_ms=lib, library_device_ms=lib_dev,
                             cases=[list(c.shape) for c in items],
                             case_ms=t["ms"], case_device_ms=t["device_ms"])
        phase("timing", f"{name}: kernel {sum(t['ms']):.4f} ms (device "
              f"{sum(t['device_ms']):.4f} ms), plain {sum(pms):.4f} ms, "
              f"bound {sum(bms):.4f} ms ({by}), library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms (device {lib_dev:.4f} ms)'} "
              f"(sum over {len(items)} case(s); per case {[c.shape for c in items]}: "
              f"kernel {rounded(t['ms'])} device {rounded(t['device_ms'])} plain "
              f"{rounded(pms)} bound {rounded(bms)} {[c.bound_by for c in items]} "
              f"library {rounded(t['library_ms'])} device "
              f"{rounded(t['library_device_ms'])}) | {smi}")
    # The fused median's device time per serving step: the four refines
    # with it minus the same four without it.
    without = sum(timings["median_consumers"]["device_ms"])
    results["median3x3_uv"]["fused_device_ms"] = results["median3x3_uv"]["device_ms"] - without
    phase("timing", f"median3x3_uv fused into the next level's refine: "
          f"{results['median3x3_uv']['device_ms']:.4f} device ms for the four "
          f"refines with it, {without:.4f} without, "
          f"{results['median3x3_uv']['fused_device_ms']:.4f} ms per serving step "
          f"(B={batch}) | {smi}")
    warp = timings["warp_bilinear"]
    loses = [tuple(c.shape) for c, k, lib in zip(
        cases["warp_bilinear"], warp["device_ms"], warp["library_device_ms"]) if k > lib]
    phase("timing", f"warp_bilinear device time loses to grid_sample's at "
          f"{loses if loses else 'no shape'} | {smi}")

    if not all(math.isfinite(v) for v in [
            *step_ms.values(), *cv_ms.values(), *consumers_ms.values()]):
        fail("non-finite timing")
    main_path = {"flow_refine_2d": "refine_2d", "warp_bilinear": "cv_rlof",
                 "multiview_ransac": "all4"}
    print(json.dumps({"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": "ofps_torch/" + REPLACES[name][0],
            "replaces": REPLACES[name][1],
            "launches": launches_by_path[main_path.get(name, "serving_slice")][name],
            "launches_by_path": {
                p: c[name] for p, c in launches_by_path.items() if name in c},
            **{k: results[name][k] for k in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms", "cases", "case_ms",
                "case_device_ms")},
            **({"fused_device_ms": results[name]["fused_device_ms"]}
               if "fused_device_ms" in results[name] else {}),
        }
        for name in REPLACES
    ], "step_ms": {f"{p}_B{b}_{c}": v for (p, b, c), v in step_ms.items()},
        "step_config": "+block_motion, ".join(["+".join(ESTIMATORS), "+".join(ALL4)]) + "+block_motion",
        "consumers_ms": consumers_ms,
        "consumer_kernels": consumer_kernel_counts,
        "cv_step_ms": cv_ms, "codec": codec, "apps": apps, "parallel": parallel,
        "matrix": matrix, "samples": samples, "bench": bench, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Smoke run of the PyTorch/CUDA port (``d3d_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout::

    python3 chip_smoke.py

It needs CUDA, the checkout's ``d3d_tpu_torch`` package and ``nvcc``; it
imports no JAX and nothing of ``d3d_tpu``. In order, it

1. builds the CUDA kernels from ``d3d_tpu_torch/csrc`` into
   ``build/d3d_tpu_torch/`` (one ``nvcc`` per source, in parallel);
2. holds each kernel against its plain PyTorch version on the card:
   K1 (rotated IoU matrix) to atol 2e-5 from 100x100 to 2048x2048, +0.0
   wherever the plain version is 0, every entry written, its pairs that
   ran the IoU chain those the plain reject test keeps and its descriptors
   equal to torch's; K1's bit-row form (nms2d's) equal to its plain version
   and to K1's f32 form thresholded at n = 1 to 4096 and four thresholds,
   every word written (``check_k1_bits``); the scan K2/K3 at n = 1 to
   20 000 through the bool route and nms2d's (bit rows, scores, order),
   both of its kernels (``check_scans``); K4 (soft-NMS cascade, linear and
   gaussian, float32 and float64, n = 100 to 16 384, a dense cluster, a NaN
   score and +0/-0 scores, all four of its routes in each dtype: rows in
   shared memory, rows from L2, above 8192 boxes the scores in global
   memory, and above 32 768 boxes lanes of 64 or more boxes: 40 000 boxes
   in float32 and 32 769 in float64, few above the score threshold, and a
   dense 40 000-box case timed only) exactly; the
   voxelizers on points with NaNs equal to the CPU's
   (``check_nan_voxels``); K1's float32 matrix raising under autograd
   (``check_k1_grad_guard``); K5
   (sparse-conv gather-GEMM) at every layer shape of SECOND serving, in
   f32 and bf16, at the tolerances stated in ``check_k5``, bit-equal across
   two launches (the second into a NaN-filled buffer, so an unwritten row
   fails), K6 (its weight gradient) at every layer shape of SECOND
   training, f32 and bf16 features, bit-equal across two runs
   (``check_k6``), and K5 as the features' gradient of the submanifold
   layers (``check_k5_backward``), all through the maps' rule books; the
   same on seeded edge-case maps (``check_edge_maps``), on a KITTI-like
   seeded frame (``kitti_like_points``) and on maps of more offsets than a
   mask word holds (kernel_size 4, 5 and 7: 64, 125 and 343 offsets, at
   SECOND's first layer's 16 000 sites, ``wide_kernel_layers``); the rule
   books of every path's maps and of the sort's edge maps (one row to 3
   million rows, 16 maps a call, both of the build's routes) equal to the
   plain stable sort
   (``check_rulebooks``); the rule-book build and one
   stage's launches, forward and backward, run under
   ``torch.cuda.set_sync_debug_mode("error")`` (``check_sync_free``);
3. drives the port's paths with every launch count set to 0 just before
   and read just after: PointPillars serving (``make_pointpillars_detector``
   on the KITTI preset at full width, random seeded weights, 4 requests of
   different 120k-point frames), the north-star frame of ``bench.py``
   (``voxelize_mean_fm`` + ``nms2d`` of 512 boxes), ``nms2d`` of 2048
   boxes (K3), SECOND serving (``make_second_detector`` on
   ``presets.second_kitti`` at full width, 4 requests), ``soft_nms2d``
   of the north star's 512 boxes (K4), the public box and voxel API
   (``VoxelGenerator`` on OpenPCDet's KITTI voxel configuration, dense and
   sparse with every filter, on the bench and KITTI-like frames;
   ``box2d_iou``, four methods x precise, 512^2 and rbox 4096^2;
   ``box2d_nms``, hard/linear/gaussian x box/rbox x precise, n = 512 and
   4096, launches read per call, K4's float64 entry on both routes; crops
   and distances of 120k points x 40 boxes) and SECOND training
   (``make_train_step`` + ``make_optimizer`` on ``presets.second_kitti``
   at full width, batch 2, 5 steps in f32 with TF32 off and 5 in bf16,
   counts read per step: K5 13, K6 8) and ``kitti_eval`` (8 synthetic
   KITTI object frames written into ``build/`` and read back by the port's
   ``KittiObjectLoader``; SECOND, PointPillars and a stand-in detector
   (the labels jittered, duplicated, with noise boxes, through
   ``box2d_nms(iou_method="rbox", precise=False)``) into Target3DArrays;
   ``DetectionEvaluator`` at IoU 0.7 and 0.5 by ``calc_stats`` and
   ``device_calc_stats``, ``kitti_official_summary`` (bev and 3d) for SECOND
   and the stand-in, ``evaluate_waymo_detection`` on the stand-in with
   point counts from the clouds; then ``device_calc_stats`` over the KITTI
   val split's 3 769 seeded frames in chunks of 512) and
   ``pointpillars_train``
   (``examples/train_pointpillars.py`` at full width: the 8 KITTI-like
   frames through ``KittiObjectLoader``, ``build_gt_database``, then per
   frame ``sample_ground_truths``, ``perobject_augment`` (K1's f32 form),
   ``global_augment`` and ``pillarize``, ``batch_frames`` of 2 inside
   ``prefetch``; ``Trainer`` with a ``prepare_targets(dense=True)``
   prep_fn, 5 steps f32 (TF32 off) with ``ema_update``, a
   ``TrainCheckpointer`` in ``build/`` and an ``eval_fn``
   (``device_calc_stats`` on ``make_pointpillars_detector``: K1's bit
   form and the scan), then 5 steps bf16; the trained model's folded,
   int8 and flip-TTA detectors) and ``voxelnext_track``
   (``presets.voxelnext_nuscenes`` uncut on six seeded nuScenes-like
   keyframes of 10 sweeps, 5 columns: K5 and K6 checked at its widths,
   C = 5 padded; ``make_voxelnext_detector`` requests, one held to the
   CPU; ``make_tracking_step`` over the keyframes, detect and tracker
   timed apart; ``tracker_update`` on stand-in detections, card equal to
   CPU and trajectories matching ``CenterTracker``'s; 3 f32 + 3 bf16
   training steps; the sort join's maps equal to the canvas's and a
   request on a 90.5M-cell grid; SECOND's dense middle and SECOND on
   KITTI-like frames, each held to the CPU; a 5-column bf16 SECOND
   request) and ``nuscenes_track_eval`` (that scene written as raw nuScenes
   tables and blobs under ``build/``, converted by the port's converter,
   loaded by ``NuscenesLoader``, each keyframe accumulated by
   ``accumulate_sweeps`` and held to the direct cloud; VoxelNeXt (bf16)
   through ``make_tracking_step``, counts read per request; the tracks
   scored by ``TrackingEvaluator.calc_stats_sequence`` and the detections
   by ``evaluate_nuscenes_detection`` / ``evaluate_nuscenes_official``,
   each equal to the CPU's; stand-in tracks held to their stated floors;
   a seeded tracking set of nuScenes val's shape scored and timed, cut to
   its budget) and ``centerpoint_track`` (``presets.centerpoint_nuscenes_10sweep``
   uncut, bf16, on the same keyframes: one- and two-stage
   ``make_centerpoint_detector`` requests, counts read per request, card
   against CPU with TF32 off; the two-stage detector through
   ``make_tracking_step``, its slot tables equal to a CPU tracker's on
   the same detections; 3 f32 + 3 bf16 training steps and 3 of the refine
   stage (K1's f32 form on its targets, held to its plain version); two
   boxes in one centre cell assigned as on the CPU; PointPainting: a
   Seg2D segmenter on six 448 x 800 images, ``painting_rig`` of a
   nuScenes-like rig, ``paint_points_multi`` card vs CPU, the painted
   15-column sweep through SECOND in bf16 (K5 at C = 15, padded);
   ``aligned_scatter`` and ``nearest_neighbor`` at scale, card vs CPU) and
   ``mono3d_eval`` (``presets.mono3d_kitti`` uncut, bf16, on 384 x 1280
   stand-in images of the KITTI split's frames: ``make_mono3d_detector``
   into velo-frame Target3DArrays scored by ``DetectionEvaluator`` on the
   card and the CPU; the f32 heads card vs CPU; targets then decode of a
   perfect encoding; ``flip_camera_frame``'s mirrored targets; 5 + 5
   training steps and one step's gradients card vs CPU) and
   ``bevseg_kitti360`` (a KITTI-360 layout written with numpy: 4 scans of
   ~120 000 points, a 600 000-point static and a dynamic window; the
   ``KITTI360Loader``'s label transfer on the card, its first points
   re-derived on the CPU; ``presets.bevseg_semantickitti`` uncut, bf16,
   semantic and panoptic predictors scored by ``SegmentationEvaluator``
   and ``device_panoptic_stats``; the panoptic targets as perfect
   predictions; 5 + 5 panoptic training steps and one step's gradients
   card vs CPU; ``device_panoptic_stats`` over 1 024 frames); these two
   launch none of the kernels; ``sst_kitti`` (``presets.sst_kitti``
   uncut, seeded weights, heads calibrated: ``make_sst_detector`` on 4
   bench frames and 2 KITTI-like frames in f32 (TF32 off) and bf16, K1's
   bit form and the scan once a request; one request held to the CPU;
   steady request ms, busy share, the request's stages by events from
   forward hooks and each frame's share of empty window slots; 5 f32 + 5
   bf16 training steps, one step's gradients card vs CPU against a
   float64 step, ``remat_blocks`` equal to the plain step; 3 bf16 steps
   of ``sst_kitti(moe_experts=8)`` at the Switch bound, peak memory) and
   ``export`` (the SST (bf16) and PointPillars (``pointpillars_kitti``)
   detectors, Mono3D's two-input one and VoxelNeXt's through
   ``torch.export``, saved under ``build/export/`` and loaded: outputs
   bit-equal to the eager ``device_fn``, launches counted in the ops' CUDA
   implementations equal to the eager request's, both requests timed)
   and ``parallel`` (a world of one under NCCL through
   ``parallel.initialize`` with a FileStore under ``build/parallel/``:
   ``make_mesh``, ``make_global_mesh``, ``make_pp_mesh`` and an ep mesh
   on cuda; ``shard_inference`` of the PointPillars detector on 4 bench
   frames bit-equal to 4 eager requests; ``device_calc_stats(mesh=)``
   over 512 val-split frames and ``device_panoptic_stats(mesh=)`` on the
   KITTI-360 frames equal to ``mesh=None``; ``shard_train_step`` of
   SECOND, 3 f32 (TF32 off) and 3 bf16 steps equal to the plain steps;
   PointPillars bf16 with ``spatial_constrain``; ``pipeline_sst_trunk``
   on ``sst_kitti`` in f32 and bf16 against ``SST(stage="trunk")``;
   ``moe_mlp(mesh=)`` at ep = 1; the sharded step, the sharded request,
   one NCCL all_reduce of SECOND's gradient bytes and the evaluator with
   and without the mesh timed, the busy share of a sharded bf16 step;
   ``shard_train_step`` of CenterPoint, BEVSeg and VoxelNeXt, 3 f32 steps
   each against the plain steps, bit-equal where two plain runs are)
   and ``datasets`` (scenes written once under ``build/datasets/``: two
   KITTI tracking sequences of 40 frames of ~120 000 points, one zipped,
   through ``KittiTrackingLoader``, PointPillars (``pointpillars_kitti``,
   full width) and ``make_tracking_step``, the tracks dumped in the
   devkit's format and scored by ``TrackingEvaluator``; the ground truth
   through the device tracker (card equal to CPU), dumped and read back,
   MOTA 1; a SemanticKITTI sequence through ``KittiOdometryLoader`` into
   BEVSeg (``bevseg_semantickitti``), the labels as predictions mIoU 1; a
   Waymo segment through ``WaymoLoader`` into CenterPoint
   (``centerpoint_waymo`` on a 472 x 472 grid) and
   ``evaluate_waymo_detection``, the ground truth AP 1 in both levels,
   ``painting_rig`` against the loader's projection; a KITTI raw drive
   (its tracklets through ``DeviceCenterTracker``, MOTA 1) and a CADC
   drive through PointPillars; ``io.hdf5`` round trip; the native C++
   oracle against K1 and ``box2d_nms(precise=True)`` at 4096 boxes) and,
   after SECOND's training, ``examples`` (the seven
   ``examples/torch_*.py`` in this process at their originals' defaults,
   ``train_pointpillars`` at 10 steps then resumed from its checkpoint,
   each example's launches counted apart; the evaluator's counters, the
   trackers' metrics and the serving loop's first 3 live counts equal to
   the same runs on the CPU; the detector's export round trip) and
   ``dryrun`` (``d3d_tpu_torch.dryrun``: ``entry()``'s forward, then
   ``dryrun_multichip`` over every card under NCCL, its child ranks'
   launches summed; on one card a world of one, where the pp and ep
   branches do not run);
   each path must launch its kernels, and nms2d K1's bit form and the
   scan only (``check_nms_routes``);
4. checks the outputs: finite, of the expected shape, the keep masks equal
   to the plain scans on the kernels' own IoU matrices, the voxelizer
   equal to the port's CPU run, the box and voxel API's outputs equal to
   the same calls on the CPU (float64 IoU within 1e-12, float32 within
   K1's 2e-5, masks, indices and voxels exact), the loaded labels within
   1e-4 m and 1e-5 rad of the boxes they were written from, every
   evaluation equal to the same call with ``device="cpu"`` (counters
   exact, accuracies within 1e-5 relative; at the val split's scale the
   first 512 frames), the stand-in's AP(Car) above 0.85, both serving
   paths' outputs equal to a
   CPU run of the same weights at a stated tolerance (TF32 off), the
   training loss finite and falling, and one training step's gradients
   equal to the CPU's (plain versions) at a stated tolerance; for
   PointPillars training also: a second ``Trainer`` resumed from the step-3
   checkpoint equal to the straight run tensor for tensor, one step's
   gradients on the card and on the CPU within stated limits of a float64
   step (``pp_card_vs_cpu``), K1's f32 form at the augmentation's padded
   32x32 matrices held as ``check_k1`` holds it, the
   augmentation on near-touching boxes equal to the CPU's, bf16 within the
   stated bound of f32, the folded and int8 models within the JAX
   package's test bounds, the TTA keep mask equal to the plain scan's;
5. times the kernels, their plain versions, the rule-book builds and the
   paths with CUDA events (the kernels line's ``ms``), gives the sparse
   kernels' and rule books' own kernel time by CUPTI beside them
   (``cupti_ms``), and logs each sparse layer's share of
   multiply-adds on absent neighbours before the rule book (every row at
   every offset) and under it.

Any failed check raises, and the run exits nonzero. The second-to-last
line is ``{"kernels": [...]}``, the last ``{"ok": true, "device": ...}``.
"""

import contextlib
import dataclasses
import enum
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# the card's published rates (NVIDIA H100 SXM data sheet): HBM bytes/s,
# dense f32 operations/s outside the tensor cores, and the dense bf16
# tensor-core rate (the bound of K5's bf16 work)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# dense float64 outside the tensor cores (the same data sheet)
F64_OPS_PER_S = 34e12
BF16_TENSOR_OPS_PER_S = 989e12

# f32 operations per output pair of K1, counted from csrc/rbox_iou.cu (each
# add, sub, mul, div, sqrt, min, max, abs, compare and select counts 1):
#   16 edge crossings: 8 + 8 edge vectors, 12 + 12 squared lengths, and 32
#     per crossing (cross product 3, cutoff 6, select 1, offsets 2, t and u
#     5 each, 4 range compares, 2 x (mul, add, select))          552
#   8 corner tests: 16 quad edge vectors, 8 x 4 x (5 + compare),
#     16 selects, tolerance 3                                        227
#   centroid: 24 x (3 adds + 1 select) + max + 2 divisions           99
#   keys: 24 x (2 subs + 12 diamond angle + 1 select)                360
#   sort network: 132 x (compare, min, max, 4 selects)               924
#   collapse: 24 x (compare, 2 selects, 2 subs)                      120
#   shoelace 24 x 4, then 0.5x, max, union 2, max, division         102
K1_OPS_PER_PAIR = 2384

# f32 operations of K1's reject test per pair, counted from
# csrc/rbox_iou.cu `rejects`: gap 4 subs + 3 max, slack add + mul + sub,
# tolerance max + add + mul, 2 compares, min, mul, 2 x ceps, 3 ands
K1_REJECT_OPS_PER_PAIR = 21

# f32 operations of K4 per box and serial step, counted from
# csrc/soft_nms.cu (each compare, select, logic op and arithmetic op counts
# 1): availability 2, masked score 1, (max, min index) compare 3, overlap
# test and mask 3, linear decay 5 (max, log, mul, exp, sub), decayed score
# 2, dead test 2, suppressed or 1, frozen compare and or 2
K4_OPS_PER_BOX_STEP = 21

# the SECOND serving path's K5 launches in order (presets.second_kitti)
K5_LAYERS = ("subm0_0", "subm0_1", "down0", "subm1_0", "subm1_1", "down1",
             "subm2_0", "subm2_1")

# the CUDA kernels of K5 and K6, by the names CUPTI records
KERNEL_NAMES = {"subm_conv": ("subm_conv_kernel",),
                "subm_conv_dw": ("subm_conv_dw_partial",
                                 "subm_conv_dw_reduce")}

# soft-NMS cases on the north star's boxes: Bodla et al.'s linear decay
# s * (1 - iou) and gaussian decay with sigma 0.5
SOFT_NMS_CASES = (("linear", 1.0), ("gaussian", 0.5))
SOFT_NMS_ARGS = dict(iou_threshold=0.25, score_threshold=0.3)

ADVERSARIAL = np.array([
    [[1.0, 2.0, 3.0, 1.5, 0.3], [1.0, 2.0, 3.0, 1.5, 0.3]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 0.0, 2.0, 2.0, 0.0]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 2.0, 2.0, 2.0, 0.0]],
    [[0.0, 0.0, 4.0, 4.0, 0.2], [0.1, 0.1, 1.0, 1.0, 0.7]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [1.0, 0.5, 2.0, 2.0, 0.0]],
    [[0.0, 0.0, 3.0, 1.0, 0.0], [0.0, 0.0, 3.0, 1.0, np.pi / 2]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [0.0, 0.0, 2.0, 2.0, np.pi / 2]],
    [[0.0, 0.0, 1.0, 1.0, 0.0], [10.0, 10.0, 1.0, 1.0, 0.0]],
    [[0.0, 0.0, 2.0, 2.0, np.pi / 4], [0.5, 0.5, 2.0, 2.0, np.pi / 4]],
], np.float32)

GRID = (432, 496, 1)
BOUNDS = (0.0, 69.12, -39.68, 39.68, -3.0, 1.0)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.perf_counter()


def log(msg):
    """A line of the run's log, after the seconds since the script
    started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


# ---------------------------------------------------------------------------
# inputs: the bench.py recipe (KITTI-like frame, random rotated boxes)
# ---------------------------------------------------------------------------

def bench_points(rng, n=120_000):
    return np.stack([
        rng.random(n) * 69.12,
        rng.random(n) * 79.36 - 39.68,
        rng.random(n) * 4.0 - 3.0,
        rng.random(n),
    ], axis=1).astype(np.float32)


def bench_boxes(rng, n):
    boxes = np.stack([
        rng.random(n) * 60 + 4,
        rng.random(n) * 70 - 35,
        rng.random(n) * 3 + 1.5,
        rng.random(n) * 3 + 1.5,
        rng.random(n) * np.pi,
    ], axis=1).astype(np.float32)
    return boxes, rng.random(n).astype(np.float32)


def north_star_frame():
    """bench.py:71-89: seed 42, 120k points, then 512 boxes and scores."""
    rng = np.random.default_rng(42)
    pts = bench_points(rng)
    boxes, scores = bench_boxes(rng, 512)
    return pts, boxes, scores


def hit_box(d, t, centre, half, yaw):
    """The ray caster's box test: rays ``d`` (R, 3) from the sensor (the
    origin) against a box of half extents ``half`` at ``centre`` turned by
    ``yaw`` about z (slabs in the box's frame); a ray that enters it nearer
    than its current range ``t`` (R,) gets that range, in place."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    rot = np.array([[cy, sy, 0.0], [-sy, cy, 0.0], [0.0, 0.0, 1.0]])
    o = rot @ -centre                      # the sensor in box coords
    dl = d @ rot.T
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-half - o) / dl
        t2 = (half - o) / dl
    near = np.nanmax(np.minimum(t1, t2), axis=1)
    far = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (near <= far) & (near > 0) & (near < t)
    t[hit] = near[hit]


def kitti_like_points(seed, objects=16, az_step_deg=0.08,
                      with_boxes=False):
    """A seeded frame in the shape of a KITTI scan cropped to the camera's
    field of view: a 64-beam sensor 1.73 m above a ground plane
    (elevations -24.8 to +2 degrees, ``az_step_deg`` between azimuths over
    the camera's 90 degrees, as an HDL-64E at 10 Hz), each ray cast onto
    the ground, onto a street front each side (façades, and between them
    trees whose hits scatter up to 5 m deep) and onto ``objects`` car-sized
    boxes (about 3.9 x 1.6 x 1.56 m, any yaw) standing 5-60 m away; the
    nearest hit within 80 m is kept, with 2 cm of range noise and a random
    intensity, inside second_kitti's bounds. ~70k points; under
    second_kitti's 0.2 m voxels 8 000-13 000 voxels by seed (13 278 at
    seed 500, 11 648 at 501), below its 16 000 cap. With ``with_boxes``
    it returns (points, boxes): the cars as (objects, 7) [x, y, z, l, w, h,
    yaw] float64 rows in the sensor frame (yaw counter-clockwise from x),
    drawn with the same numbers as without."""
    rng = np.random.default_rng(seed)
    height = 1.73
    elev = np.deg2rad(np.linspace(-24.8, 2.0, 64))
    az = np.deg2rad(np.arange(-45.0, 45.0, az_step_deg))
    e, a = np.meshgrid(elev, az, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)],
                 -1).reshape(-1, 3)
    t = np.full(len(d), np.inf)
    down = d[:, 2] < 0
    t[down] = height / -d[down, 2]
    # a façade each side of the street, with gaps between buildings
    for side in (1.0, -1.0):
        off = side * rng.uniform(6.0, 10.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            tw = np.where(d[:, 1] * side > 0, off / d[:, 1], np.inf)
        hx, hz = d[:, 0] * tw, d[:, 2] * tw
        with np.errstate(invalid="ignore"):
            gaps = np.sin(hx * rng.uniform(0.2, 0.4)) > 0.6
        wall = (hx > 3.0) & (hz < 6.0 - height) & (tw < t)
        t[wall & gaps] = tw[wall & gaps]
        # between the buildings, trees: hits scattered up to 5 m deep
        tree = wall & ~gaps
        t[tree] = tw[tree] * (1.0 + rng.uniform(0.0, 5.0, tree.sum())
                              / np.abs(off))
    r = rng.uniform(5.0, 60.0, objects)
    ang = rng.uniform(-0.65, 0.65, objects)
    yaw = rng.uniform(-np.pi, np.pi, objects)
    half = np.stack([rng.uniform(3.6, 4.3, objects), rng.uniform(1.5, 1.8,
                     objects), rng.uniform(1.4, 1.7, objects)], -1) / 2
    for i in range(objects):
        centre = np.array([r[i] * np.cos(ang[i]), r[i] * np.sin(ang[i]),
                           -height + half[i, 2]])
        hit_box(d, t, centre, half[i], yaw[i])
    keep = t < 80.0
    pts = d[keep] * (t[keep] + rng.normal(0.0, 0.02, keep.sum()))[:, None]
    inside = ((pts[:, 0] >= 0) & (pts[:, 0] < 70.4) & (np.abs(pts[:, 1]) < 40)
              & (pts[:, 2] >= -3) & (pts[:, 2] < 1))
    pts = pts[inside]
    pts = np.concatenate([pts, rng.random((len(pts), 1))], 1).astype(
        np.float32)
    if not with_boxes:
        return pts
    centres = np.stack([r * np.cos(ang), r * np.sin(ang),
                        -height + half[:, 2]], -1)
    return pts, np.concatenate([centres, 2 * half, yaw[:, None]], 1)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_each(fn, reps, warmup=3):
    """Median device ms of ``fn``, each call between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_launches(fn, batch=50, batches=7):
    """Device ms per launch: CUDA events around ``batch`` back-to-back
    launches, median over ``batches``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def cupti_ms(fn, kernels=None, reps=10):
    """Device ms per call of ``fn`` spent in the kernels whose names hold
    one of ``kernels`` (default: every kernel), from torch.profiler's CUPTI
    trace: the kernels' own time, without the host's launch gaps that CUDA
    events around back-to-back launches include. None where the trace
    holds no device time. Reported beside the CUDA-event times (the
    kernels line's ``ms``), never in their place."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and (kernels is None or any(k in e.key for k in kernels)))
    return us / reps / 1e3 if us > 0 else None


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """(least ms on the card, what bounds it) for this many bytes moved
    once and operations at ``ops_per_s`` (default: f32 outside the tensor
    cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(n, m, chains):
    # boxes (5 f32 each) in, the (n, m) f32 matrix out; the reject test on
    # every pair and the IoU chain on the pairs this run's boxes needed it
    # for (the kernel's count, equal to the plain reject test's)
    return bound((n + m) * 5 * 4 + n * m * 4,
                 n * m * K1_REJECT_OPS_PER_PAIR + chains * K1_OPS_PER_PAIR)


def k1_bound_all_pairs(n, m):
    # the count of the all-pairs design: descriptors (10 f32 per box) in,
    # the matrix out, the chain on every pair
    return bound((n + m) * 10 * 4 + n * m * 4, n * m * K1_OPS_PER_PAIR)


def scan_bound(n):
    # nms2d's scan: the words of the bit rows it reads (each row from its
    # own word on), the sorted scores (f32) and the order (int64) in, the
    # (n,) bool mask out; an OR a word
    words = (n + 63) // 64
    upper = sum(words - i // 64 for i in range(n))
    return bound(upper * 8 + n * 13, upper)


def k1_bits_bound(n, chains):
    # nms2d's K1: boxes in, the (n, ceil(n / 64)) bit rows out; the reject
    # test on the pairs above the diagonal and the chain on those it keeps
    return bound(n * 5 * 4 + n * ((n + 63) // 64) * 8,
                 n * (n - 1) // 2 * K1_REJECT_OPS_PER_PAIR
                 + chains * K1_OPS_PER_PAIR)


def kernel_launches(fn):
    """(kernels, memory operations) one call of ``fn`` puts on the card,
    counted in torch.profiler's CUPTI trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    mem = sum(e.count for e in rows if e.key.startswith(("Memcpy", "Memset")))
    return sum(e.count for e in rows) - mem, mem


def k4_bound(n, steps, itemsize=4):
    # the steps this run's data takes (the kernel stops when no box is
    # left): each reads the pick's row of the IoU matrix (``itemsize``
    # bytes a value: 4 for float32, 8 for float64) and works on all n
    # boxes; (n,) scores and (n,) bool pre in, (n,) bool out
    return bound(steps * n * itemsize + n * (itemsize + 2),
                 steps * n * K4_OPS_PER_BOX_STEP,
                 F32_OPS_PER_S if itemsize == 4 else F64_OPS_PER_S)


def k5_work(feats, nbr, cout):
    """K5's (bytes, operations) on these inputs. Bytes: features, map,
    weights and valid read once, the output written once; operations: one
    multiply-add (2 operations) per channel pair of each neighbour that
    exists in this run's map."""
    n, c = feats.shape
    nq, k = nbr.shape
    size = feats.element_size()
    nbytes = (n * c + k * c * cout + nq * cout) * size + nq * k * 4 + nq
    return nbytes, 2 * int((nbr >= 0).sum()) * c * cout


def k5_rate(dtype):
    # f32 at the f32 rate, bf16 at the dense bf16 tensor-core rate
    return F32_OPS_PER_S if dtype == torch.float32 else BF16_TENSOR_OPS_PER_S


# ---------------------------------------------------------------------------
# the phases
# ---------------------------------------------------------------------------

def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def build_kernels():
    from d3d_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    log(f"build: {time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling")):
                log(f"  {name}: {line.strip()}")


def near_touching_boxes(rng, count=16):
    """Pairs (a[i], b[i]) that touch or nearly touch: a shared edge, a
    nearly parallel neighbour and a turned box corner on corner, moved by
    gaps of 0, +-1e-6 and +-1e-5 of the coordinates' scale; the K1 reject
    test must run the chain on all of them."""
    a, b = [], []
    for _ in range(count):
        x, y = rng.random() * 60 + 4, rng.random() * 70 - 35
        w, h = rng.random(2) * 3 + 1.5
        r = rng.random() * np.pi
        scale = abs(x) + abs(y) + w + h
        ux, uy = math.cos(r), math.sin(r)
        turn = rng.random() * np.pi
        for rel in (0.0, 1e-6, -1e-6, 1e-5, -1e-5):
            gap = rel * scale
            a += [(x, y, w, h, r)] * 3
            b.append((x + (w + gap) * ux, y + (w + gap) * uy, w, h, r))
            b.append((x - (0.85 * h + gap) * uy, y + (0.85 * h + gap) * ux,
                      w, h * 0.7, r + 1e-5))
            # corner 2 of a on corner 0 of b (turned), along a's diagonal
            px = x + ux * w / 2 - uy * h / 2
            py = y + uy * w / 2 + ux * h / 2
            c2, s2 = math.cos(r + turn), math.sin(r + turn)
            qx, qy = -c2 * w / 2 + s2 * h / 2, -s2 * w / 2 - c2 * h / 2
            d = math.hypot(px - x, py - y)
            b.append((px - qx + gap * (px - x) / d,
                      py - qy + gap * (py - y) / d, w, h, r + turn))
    return np.asarray(a, np.float32), np.asarray(b, np.float32)


def k1_case(name, ta, tb, diagonal=False, touching=False):
    """One case of ``check_k1`` on the card tensors ``ta`` (N, 5) and ``tb``
    (M, 5): K1 within 2e-5 of the plain version, exactly +0.0 wherever the
    plain version is 0, every entry written (into a NaN-filled buffer),
    the pairs that ran the chain those the plain reject test keeps; with
    ``diagonal`` the first 5 boxes' self-IoU 1 to 1e-4, with ``touching``
    every (i, i) pair through the chain. Returns (the max error, the share
    of pairs that ran the chain)."""
    from d3d_tpu_torch.ops import geometry_cuda, geometry_soa

    dev = ta.device
    got = geometry_cuda.rbox_iou_matrix(ta, tb)
    want = geometry_soa._rbox_iou_matrix_plain(ta, tb)
    chains = torch.zeros(1, dtype=torch.int32, device=dev)
    nan_out = torch.full_like(got, float("nan"))
    geometry_cuda._launch(ta, tb, chains=chains, out=nan_out)
    keep = ~geometry_cuda._reject_plain(ta, tb)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"K1 {name}: shape {got.shape}")
    check(bool(torch.isfinite(got).all()), f"K1 {name}: not finite")
    check(torch.equal(nan_out, got),
          f"K1 {name}: an entry left unwritten or not repeatable")
    err = float((got - want).abs().max())
    log(f"K1 {name}: max |kernel - plain| = {err:.3g} (atol 2e-5)")
    check(err <= 2e-5, f"K1 {name}: error {err} > 2e-5")
    zero = want == 0
    check(bool((got[zero] == 0).all())
          and not bool(torch.signbit(got[~keep]).any()),
          f"K1 {name}: not +0.0 where the plain version is 0")
    check(int(chains) == int(keep.sum()),
          f"K1 {name}: {int(chains)} pairs ran the chain, the plain "
          f"reject test keeps {int(keep.sum())}")
    if touching:
        check(bool(keep.diagonal().all()),
              f"K1 {name}: a touching pair was rejected")
    if diagonal:
        diag = torch.diagonal(got[:5, :5])
        check(bool(((diag - 1).abs() <= 1e-4).all()),
              f"K1 {name}: diagonal {diag.tolist()}")
    share = int(chains) / got.numel()
    log(f"K1 {name}: {int(chains)} of {got.numel()} pairs ran the chain "
        f"({100 * share:.2f}%), the rest +0.0 from the reject test")
    return err, share


def check_k1(dev):
    """K1 against the plain version on the card: within 2e-5, exactly +0.0
    wherever the plain version is 0, every entry written (into a NaN-filled
    buffer), the pairs that ran the chain those the plain reject test keeps,
    and the descriptors equal to torch's bit for bit. Returns the max error
    and each shape's share of pairs that ran the chain."""
    from d3d_tpu_torch.ops import geometry_cuda, geometry_soa

    rng = np.random.default_rng(0)
    _, boxes512, _ = north_star_frame()
    b37 = np.stack([rng.random(37) * 20, rng.random(37) * 20,
                    rng.random(37) * 6 + 1, rng.random(37) * 6 + 1,
                    rng.random(37) * 6 - 3], axis=1).astype(np.float32)
    b155 = np.concatenate([b37[:5], bench_boxes(rng, 150)[0]])
    boxes2048, _ = bench_boxes(np.random.default_rng(7), 2048)  # k3_path's
    near_a, near_b = near_touching_boxes(rng)
    cases = {"512x512": (boxes512, boxes512),
             "100x100": (boxes512[:100], boxes512[:100]),
             "37x155": (b37, b155),
             "adversarial": (ADVERSARIAL[:, 0], ADVERSARIAL[:, 1]),
             "2048x2048": (boxes2048, boxes2048),
             "near-touching": (near_a, near_b)}
    worst, shares = 0.0, {}
    for name, (a, b) in cases.items():
        err, shares[name] = k1_case(
            name, torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
            diagonal=name not in ("adversarial", "near-touching"),
            touching=name == "near-touching")
        worst = max(worst, err)
    for name in ("512x512", "2048x2048", "adversarial"):
        tb = torch.from_numpy(cases[name][0]).to(dev)
        mine = geometry_cuda._descriptors_cuda(tb)
        torch_desc = geometry_cuda.box_descriptors(tb)
        torch.cuda.synchronize()
        diff = int((mine != torch_desc).sum())
        log(f"K1 descriptors {name}: {diff} of {mine.numel()} values differ "
            f"from torch's (max |diff| "
            f"{float((mine - torch_desc).abs().max()):.3g})")
        check(diff == 0, f"K1 descriptors {name}: {diff} differ from torch's")
    return worst, shares


# the thresholds K1's bit rows are checked at: negative (a rejected pair's
# +0.0 sets its bit), 0, the paths' 0.25 and 1 (no IoU above it)
BIT_THRESHOLDS = (-0.1, 0.0, 0.25, 1.0)
BIT_SIZES = (1, 63, 64, 65, 100, 512, 2048, 4096)


def odd_boxes(rng, n):
    """bench.py-recipe boxes with, from 100 boxes on, a NaN centre, a NaN
    angle, and a zero-width and a zero-size box away from every other box
    (where a degenerate box overlaps another, its IoU is rounding noise)."""
    boxes, _ = bench_boxes(rng, n)
    if n >= 100:
        boxes[7, 0] = np.nan
        boxes[14, 4] = np.nan
        boxes[21, 2] = 0.0
        boxes[21, :2] = (-500.0, 900.0)
        boxes[28, 2:4] = 0.0
        boxes[28, :2] = (-900.0, 900.0)
    return boxes


def check_k1_bits(dev):
    """K1's bit-row form against its plain version (the plain IoU matrix
    thresholded, upper triangle, packed) and against K1's own f32 form
    thresholded, exactly, at ``BIT_SIZES`` x ``BIT_THRESHOLDS``, into
    buffers filled with ones (0xFF..., so an unwritten word shows), twice;
    the pairs that ran the chain those above the diagonal that the plain
    reject test keeps. Returns the mismatched words (0) and each size's
    share of upper pairs that ran the chain."""
    from d3d_tpu_torch.ops import geometry_cuda, geometry_soa, nms_cuda

    rng = np.random.default_rng(5)
    shares = {}
    for n in BIT_SIZES:
        b = torch.from_numpy(odd_boxes(rng, n)).to(dev)
        iou = geometry_soa._rbox_iou_matrix_plain(b, b)
        mine = geometry_cuda.rbox_iou_matrix(b, b)
        upper = torch.ones((n, n), dtype=torch.bool, device=dev).triu(1)
        keep = int((~geometry_cuda._reject_plain(b, b) & upper).sum())
        for thr in BIT_THRESHOLDS:
            want = nms_cuda.pack_rows(torch.triu(iou > thr, 1))
            own = nms_cuda.pack_rows(torch.triu(mine > thr, 1))
            chains = torch.zeros(1, dtype=torch.int32, device=dev)
            ones = torch.full_like(want, -1)
            geometry_cuda._bits_launch(b, thr, chains=chains, out=ones)
            again = geometry_cuda._bits_launch(b, thr)
            torch.cuda.synchronize()
            bad = int((ones != want).sum())
            check(bad == 0, f"K1 bits n={n} thr={thr}: {bad} of "
                            f"{want.numel()} words differ from the plain "
                            "version or were left unwritten")
            check(torch.equal(ones, own) and torch.equal(ones, again),
                  f"K1 bits n={n} thr={thr}: differ from K1's f32 form "
                  "thresholded or between launches")
            check(int(chains) == keep, f"K1 bits n={n} thr={thr}: "
                                       f"{int(chains)} pairs ran the chain, "
                                       f"the plain reject test keeps {keep}")
        shares[n] = keep / max(1, n * (n - 1) // 2)
        log(f"K1 bits n={n}: equal to the plain version and to K1's f32 "
            f"form at thresholds {BIT_THRESHOLDS}, every word written, "
            f"{keep} upper pairs ran the chain ({100 * shares[n]:.2f}%)")
    return 0.0, shares


def random_overlap(rng, n, dev):
    """A seeded (n, n) bool overlap (7% of pairs, symmetric) and a 10% pre
    mask on the card; above 4096 boxes drawn on the card itself."""
    if n > 4096:
        gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1e9)))
        ov = torch.rand((n, n), generator=gen, device=dev) < 0.07
        pre = torch.rand(n, generator=gen, device=dev) < 0.1
        return ov | ov.T, pre
    ov = rng.random((n, n)) < 0.07
    ov = ov | ov.T
    pre = rng.random(n) < 0.1
    return (torch.from_numpy(ov).to(dev), torch.from_numpy(pre).to(dev))


SCAN_SIZES = (1, 63, 64, 65, 100, 512, 1000, 1025, 2048, 4096, 20_000)


def check_scans(dev):
    """The scan (K2/K3) against the plain scan on the card at
    ``SCAN_SIZES``, exactly: the public bool route (pack, then scan) and
    nms2d's route (bit rows, the pre-suppression from the negated sorted
    scores with NaNs among them, the mask written through ``order``); both
    of the scan's routes (one warp up to 2048 boxes, one block above) must
    have run. Returns mismatch counts and the launches by route."""
    from d3d_tpu_torch.ops import nms_cuda

    rng = np.random.default_rng(1)
    routes0 = dict(nms_cuda._ROUTES)
    worst = {"nms_scan": 0, "nms_scan_blocked": 0}
    for n in SCAN_SIZES:
        scan = nms_cuda.nms_scan if n <= 1024 else nms_cuda.nms_scan_blocked
        ov, pre = random_overlap(rng, n, dev)
        got = scan(ov, pre)
        want = nms_cuda._nms_scan_plain(ov, pre)
        scores = torch.rand(n, device=dev)
        scores[::97] = float("nan")
        neg, order = torch.sort(-scores, stable=True)
        bits = nms_cuda.pack_rows(torch.triu(ov, 1))
        got_s = nms_cuda._nms_scan_sorted(bits, order, neg, 0.1)
        want_s = nms_cuda._nms_scan_sorted_plain(bits, order, neg, 0.1)
        torch.cuda.synchronize()
        bad = int((got != want).sum()) + int((got_s != want_s).sum())
        log(f"{scan.__name__} n={n}: {bad} of 2 x {n} differ from the "
            f"plain scan (bool route {int((~got).sum())} kept, nms2d's "
            f"route {int((~got_s).sum())} kept)")
        check(bad == 0, f"{scan.__name__} n={n}: {bad} mismatches")
        worst[scan.__name__] = max(worst[scan.__name__], bad)
    routes = {k: v - routes0[k] for k, v in nms_cuda._ROUTES.items()}
    log(f"NMS scan launches by route in the checks: {routes}")
    check(routes["warp"] > 0 and routes["block"] > 0,
          f"NMS scan: a route never ran: {routes}")
    return worst, routes


# two-point frames: one good point and one with a NaN x / xyz / intensity
NAN_POINTS = {"x": (np.nan, 1.5, 1.5, 0.0), "xyz": (np.nan,) * 3 + (0.0,),
              "intensity": (1.5, 1.5, 1.5, np.nan)}


def same_with_nan(a, b, atol=0.0):
    """NaN exactly where the other is NaN, the rest within ``atol``."""
    if a.shape != b.shape or not torch.equal(a.isnan(), b.isnan()):
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return a.numel() == 0 or float(
        (a.nan_to_num(0.0) - b.nan_to_num(0.0)).abs().max()) <= atol


def check_nan_voxels(dev):
    """Both voxelizers on the card against the port's CPU run on points
    with NaN coordinates: two-point frames (a NaN lands in cell 0
    of its axis, as XLA's convert puts it) and the north-star frame with
    100 NaN points; exactly equal, NaN where the CPU has NaN."""
    from d3d_tpu_torch.ops.voxel import (voxelize_dense_padded,
                                         voxelize_mean_fm)

    frames = {k: (np.array([(2.5, 2.5, 2.5, 1.0), v], np.float32),
                  (4, 4, 4), (0.0, 4.0, 0.0, 4.0, 0.0, 4.0), 4)
              for k, v in NAN_POINTS.items()}
    pts = north_star_frame()[0].copy()
    pts[:100:3, 0] = np.nan
    pts[1:100:3, :3] = np.nan
    pts[2:100:3, 3] = np.nan
    frames["north star + 100 NaN points"] = (pts, GRID, BOUNDS, 16000)
    # the means' last f32 operations may round apart on the two devices:
    # the north star's stated 8e-6 (``north_star``); the rest exact
    for name, (p, shape, bounds, cap) in frames.items():
        outs = []
        for d in (dev, torch.device("cpu")):
            tb = torch.tensor(bounds, dtype=torch.float32, device=d)
            fm = torch.from_numpy(np.ascontiguousarray(p.T)).to(d)
            outs.append((voxelize_mean_fm(fm, shape, tb, cap),
                         voxelize_dense_padded(torch.from_numpy(p).to(d),
                                               shape, tb, 4, cap, "mean",
                                               order_mode="sorted")))
        for i, what in enumerate(("voxelize_mean_fm",
                                  "voxelize_dense_padded")):
            card, cpu = outs[0][i], outs[1][i]
            for k in cpu:
                check(same_with_nan(card[k].cpu(), cpu[k],
                                    8e-6 if k == "aggregates" else 0.0),
                      f"NaN voxels {name} {what} {k}: card != CPU")
        log(f"NaN voxels {name}: card equal to CPU in both voxelizers "
            f"({int(outs[0][0].nvoxels)} voxels)")
    return 0.0


def check_k4(dev):
    """K4 against the plain cascade on the card, both methods, float32 and
    float64, on K1's IoU matrices of bench boxes (n = 100 to 8192, and
    10 000 and 16 384 above the shared-memory state's 8192; float64 takes
    the matrix cast) and of dense clusters with iou_threshold 0 (every pair
    overlaps, so every row's marks overflow its list; n = 512 and 2048,
    where the lists do not fit in shared memory), a NaN score and tied
    +0/-0 scores; masks must be equal, and all three of K4's routes (lists
    staged in shared memory, read from L2, and above 8192 boxes the scores
    in global memory) must have run in each dtype. Returns the mismatches,
    the launches by route, and the >8192 route's times at 16 384 boxes
    (linear, p = 1, float32 and float64: CUDA events, the plain cascade on
    the card, the bound of this run's steps)."""
    from d3d_tpu_torch.ops import geometry_cuda, nms_cuda
    from d3d_tpu_torch.ops.nms import _soft_nms_init

    rng = np.random.default_rng(3)
    routes0 = dict(nms_cuda._soft_launch.routes)
    cases = [(f"n={n}", *bench_boxes(rng, n), SOFT_NMS_ARGS["iou_threshold"])
             for n in (100, 512, 1000, 2048, 8192, 10000, 16384)]
    # above 8192 boxes the plain cascade takes seconds a call on the card:
    # each (size, dtype) once, both methods at 16 384 in float32
    f32, f64 = torch.float32, torch.float64
    only = {"n=10000": {(f32, "gaussian"), (f64, "linear")},
            "n=16384": {(f32, "linear"), (f32, "gaussian"), (f64, "linear")}}
    wide = {}
    # +0 and -0 scores tie: the lower index is picked first
    zeros, _ = bench_boxes(rng, 64)
    zeros[:, :2] = rng.random((64, 2)) * 6.0
    cases.append(("64 boxes with +0/-0 scores", zeros,
                  np.where(rng.random(64) < 0.5, 0.0, -0.0).astype(
                      np.float32), 0.1))
    # a NaN pick: 6 boxes 0.3 m apart, one NaN score (a NaN
    # available makes the pick n - 1, as in the Pallas kernel)
    cases.append(("6 boxes with a NaN score",
                  np.array([[0.3 * i, 0.0, 1.0, 1.0, 0.0] for i in range(6)],
                           np.float32),
                  np.array([0.5, np.nan, 0.9, 0.2, 0.8, 0.1], np.float32),
                  0.3))
    for n in (512, 2048):  # every row's marks overflow its list
        dense, dense_scores = bench_boxes(rng, n)
        dense[:, :2] = rng.random((len(dense), 2)) * 0.5 + 20.0
        cases.append((f"dense n={n}, iou_threshold 0", dense, dense_scores,
                      0.0))
    worst = 0
    for name, boxes, scores, iou_t in cases:
        tb = torch.from_numpy(boxes).to(dev)
        ts = torch.from_numpy(scores).to(dev)
        iou32 = geometry_cuda.rbox_iou_matrix(tb, tb)
        # the zeros case keeps its scores above the score threshold
        thr = -1.0 if name.startswith("64 boxes") else SOFT_NMS_ARGS[
            "score_threshold"]
        for dt in (torch.float32, torch.float64):
            iou = iou32.to(dt)
            pre, init = _soft_nms_init(ts.to(dt), thr)
            for method, param in SOFT_NMS_CASES:
                if name in only and (dt, method) not in only[name]:
                    continue
                args = (iou_t, thr, param, method)
                got = nms_cuda._soft_launch(iou, init, pre, *args)
                t0 = time.perf_counter()
                want = nms_cuda._soft_nms_scan_plain(iou, init, pre, *args)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                bad = int((got != want).sum())
                log(f"soft_nms_scan {method} {str(dt)[6:]} {name}: {bad} of "
                    f"{len(boxes)} differ from the plain cascade, "
                    f"{int(got.sum())} suppressed")
                check(bad == 0, f"soft_nms_scan {method} {dt} {name}: {bad} "
                                f"mismatches")
                worst = max(worst, bad)
                if name == "n=16384" and method == "linear":
                    wide[str(dt)[6:]] = k4_wide_times(
                        lambda: nms_cuda._soft_launch(iou, init, pre, *args),
                        plain_ms, len(boxes), got, iou.element_size())
    wide["above_32768"] = check_k4_wide(dev, rng)
    routes = {k: v - routes0[k]
              for k, v in nms_cuda._soft_launch.routes.items()}
    log(f"soft_nms_scan launches by route in the checks: {routes}")
    check(all(v > 0 for v in routes.values()),
          f"K4: a route never ran: {routes}")
    return worst, routes, wide


# K4 above 32 768 boxes (lanes of 64 boxes): float32 at 40 000 boxes (a
# 6.4 GB matrix), float64 at 32 769 (8.6 GB); few boxes start above the
# score threshold, so the cascade's steps stay few
K4_WIDE_CASES = ((40_000, torch.float32), (32_769, torch.float64))
K4_WIDE_LIVE = 400


def check_k4_wide(dev, rng):
    """K4's layout above 32 768 boxes against the plain cascade (which
    stops, as the kernel, when no box is left): per case of
    K4_WIDE_CASES the bench recipe's boxes with all but K4_WIDE_LIVE
    scores below the threshold, linear and gaussian, masks equal; then
    at 40 000 float32 boxes all above it (a step a box kept), timed only
    (the plain cascade takes ~10 s a call at 16 384 boxes). Each matrix
    is freed before the next. Returns the times: the sparse cases' and
    the dense one's (CUDA events, median of 3), the plain cascade's
    (host clock), the bounds of this run's steps."""
    from d3d_tpu_torch.ops import geometry_cuda, nms_cuda
    from d3d_tpu_torch.ops.nms import _soft_nms_init

    out = {}
    thr = SOFT_NMS_ARGS["score_threshold"]
    iou_t = SOFT_NMS_ARGS["iou_threshold"]
    for n, dt in K4_WIDE_CASES:
        boxes, scores = bench_boxes(rng, n)
        scores = np.where(np.arange(n) < K4_WIDE_LIVE, scores * 0.5 + 0.5,
                          scores * 0.25).astype(np.float32)
        scores = scores[rng.permutation(n)]
        tb = torch.from_numpy(boxes).to(dev)
        iou = geometry_cuda.rbox_iou_matrix(tb, tb)
        if dt == torch.float64:
            iou32, iou = iou, iou.to(dt)
            del iou32
        pre, init = _soft_nms_init(torch.from_numpy(scores).to(dev, dt), thr)
        for method, param in SOFT_NMS_CASES:
            args = (iou_t, thr, param, method)
            got = nms_cuda._soft_launch(iou, init, pre, *args)
            t0 = time.perf_counter()
            want = nms_cuda._soft_nms_scan_plain(iou, init, pre, *args)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            bad = int((got != want).sum())
            steps = n - int(got.sum())
            log(f"soft_nms_scan {method} {str(dt)[6:]} n={n} ({K4_WIDE_LIVE} "
                f"above the threshold, {nms_cuda._soft_boxes(n)} boxes a "
                f"lane): {bad} differ from the plain cascade, {steps} steps")
            check(bad == 0, f"soft_nms_scan {method} {dt} n={n}: {bad} "
                            "mismatches")
            check(0 < steps <= K4_WIDE_LIVE, f"K4 n={n}: {steps} steps")
            if method == "linear":
                b_ms, b_by = k4_bound(n, steps, iou.element_size())
                out[f"sparse_{n}_{str(dt)[6:]}"] = dict(
                    n=n, steps=steps, ms=time_each(
                        lambda: nms_cuda._soft_launch(iou, init, pre, *args),
                        reps=3, warmup=1),
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        if n == K4_WIDE_CASES[0][0]:
            # every box above the threshold: as many steps as boxes kept
            dense = (0.5 + 0.5 * rng.random(n)).astype(np.float32)
            pre, init = _soft_nms_init(torch.from_numpy(dense).to(dev), thr)
            args = (iou_t, thr, 1.0, "linear")
            got = nms_cuda._soft_launch(iou, init, pre, *args)
            steps = n - int(got.sum())
            b_ms, b_by = k4_bound(n, steps)
            ms = time_each(lambda: nms_cuda._soft_launch(iou, init, pre,
                                                         *args),
                           reps=3, warmup=0)
            out[f"dense_{n}_float32"] = dict(
                n=n, steps=steps, ms=ms, plain_ms=None, bound_ms=b_ms,
                bound_by=b_by)
            log(f"K4 n={n} float32, every score above the threshold: "
                f"{steps} steps, {ms:.2f} ms a launch (CUDA events, median "
                f"of 3; not compared: the plain cascade would take minutes),"
                f" bound {b_ms:.4f} ms ({b_by})")
        del iou, pre, init
        torch.cuda.empty_cache()
    for name, row in out.items():
        log(f"K4 {name}: {row['ms']:.3f} ms (CUDA events), plain "
            f"{row['plain_ms']} ms, bound {row['bound_ms']:.6f} ms")
    return out


def k4_wide_times(launch, plain_ms, n, suppressed, itemsize):
    """K4's route above 8192 boxes at ``n``: CUDA events a launch (median
    of 5), the plain cascade's one checked call (host clock around the
    call and a synchronize: it runs n steps of a dozen launches), and the
    bound of this run's steps (the boxes frozen: those not suppressed)."""
    steps = n - int(suppressed.sum())
    b_ms, b_by = k4_bound(n, steps, itemsize)
    row = dict(n=n, steps=steps, ms=time_each(launch, reps=5, warmup=1),
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    log(f"K4 n={n} ({itemsize * 8}-bit, scores in global memory, {steps} "
        f"steps): {row['ms']:.3f} ms a launch (CUDA events), plain "
        f"{row['plain_ms']:.1f} ms, bound {b_ms:.6f} ms ({b_by})")
    return row


# PointPillars' serving maps at full width, (C, W, H): the outputs of its
# three blocks' convolutions (3, 5 and 5 of them a frame) and of its three
# upsamplings, each a 128-channel slice of the heads' 384-channel input;
# and the pillar net's linear output, (pillars x points, channels) rows
EPILOGUE_MAPS = (((64, 432, 496), 3), ((128, 216, 248), 5),
                 ((256, 108, 124), 5))
EPILOGUE_UP = ((128, 432, 496), 3)
EPILOGUE_CAT = 384
EPILOGUE_ROWS = ((12000 * 32, 64), 1)


def check_epilogue(dev):
    """The BEV epilogue (``ops/epilogue.py`` ``bn_relu``: relu((x - mean) *
    mul + beta) a channel) against its plain version on the card,
    bit-equal: in place at the serving maps and the pillar net's rows,
    into each 128-channel slice of the heads' input (the rest of the
    buffer left as it was), a batch of 2 into a slice, bfloat16 and
    float64, planes, rows and slices that take no 16-byte vectors,
    NaN and infinities. Returns the kernels-line row: per serving map the
    CUDA-event ms over back-to-back launches, CUPTI's kernel ms, the bound
    (the map read and written once) and the plain version's ms, and their
    sums over a frame's 17 maps."""
    from d3d_tpu_torch.ops import epilogue as E

    gen = torch.Generator(device=dev).manual_seed(21)

    def stats(c, dtype):
        ct = torch.float64 if dtype == torch.float64 else torch.float32
        return (torch.randn(c, generator=gen, device=dev).to(ct),
                torch.rand(c, generator=gen, device=dev).to(ct) + 0.5,
                torch.randn(c, generator=gen, device=dev).to(ct))

    def case(shape, dtype=torch.float32, at=None, total=None, special=False):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        st = stats(shape[1], dtype)
        if special:
            x.view(-1)[:4] = torch.tensor(
                [float("nan"), float("inf"), -float("inf"), -0.0],
                dtype=dtype)
        want = torch.empty_like(x)
        E._bn_relu_plain(x, *st, want)
        if at is None:
            got = E.bn_relu(x.clone(), *st)
        else:
            buf = torch.full((shape[0], total) + tuple(shape[2:]),
                             float("nan"), dtype=dtype, device=dev)
            got = E.bn_relu(x, *st, out=buf[:, at:at + shape[1]])
            rest = torch.cat([buf[:, :at], buf[:, at + shape[1]:]], 1)
            check(bool(rest.isnan().all()), f"epilogue {shape} into "
                  f"[{at}, {at + shape[1]}) of {total}: wrote outside")
        torch.cuda.synchronize()
        check(same_with_nan(got, want), f"epilogue {shape} {dtype} (at "
              f"{at}): differs from its plain version")

    launches = E.bn_relu.launches
    for (c, w, h), _ in EPILOGUE_MAPS:
        case((1, c, w, h))
    (c, w, h), _ = EPILOGUE_UP
    for at in range(0, EPILOGUE_CAT, c):
        case((1, c, w, h), at=at, total=EPILOGUE_CAT)
    case((2, 128, 216, 248), at=128, total=EPILOGUE_CAT)
    case((1, 64, 432, 496), torch.bfloat16, special=True)
    case((1, 16, 40, 40), torch.float64, special=True)
    case((2, 3, 7, 5), special=True)                 # planes of 35
    case((1, 5, 8, 8), at=1, total=7)                # a slice off 16 bytes
    case(EPILOGUE_ROWS[0])
    case((1000, 64), torch.bfloat16, special=True)
    case((500, 16), torch.float64, special=True)
    case((1000, 10), special=True)                   # rows of 40 bytes
    checked = E.bn_relu.launches - launches
    check(checked == 15, f"epilogue checks launched {checked}, not 15")

    # timed cold: launches go round enough maps (the upsamplings' inputs
    # and buffers) to pass twice the 50 MB L2 between two visits
    maps, frame = [], dict(ms=0.0, cupti_ms=0.0, bound_ms=0.0, plain_ms=0.0)
    for shape, per_frame in EPILOGUE_MAPS + (EPILOGUE_UP, EPILOGUE_ROWS):
        shape = (1,) + shape if len(shape) == 3 else shape
        numel = math.prod(shape)
        up = shape[1:] == EPILOGUE_UP[0]
        c = shape[1]
        nbytes = numel * 4 * (1 + up * EPILOGUE_CAT // c)
        ring = [(torch.randn(shape, generator=gen, device=dev),
                 stats(c, torch.float32),
                 torch.empty((1, EPILOGUE_CAT) + shape[2:], device=dev)[
                     :, c:2 * c] if up else None)
                for _ in range(-(-100_000_000 // nbytes))]
        turn = iter(range(1 << 62))

        def run(plain=False):
            x, st, out = ring[next(turn) % len(ring)]
            if plain:
                E._bn_relu_plain(x, *st, x if out is None else out)
            else:
                E.bn_relu(x, *st, out=out)
        row = dict(shape=list(shape), per_frame=per_frame, ring=len(ring),
                   ms=time_launches(run),
                   cupti_ms=cupti_ms(run, kernels=["bn_relu"]),
                   bound_ms=bound(2 * numel * 4, 3 * numel)[0],
                   plain_ms=time_launches(lambda: run(plain=True)))
        del ring
        maps.append(row)
        for k in frame:
            frame[k] = (None if row[k] is None or frame[k] is None
                        else frame[k] + row[k] * per_frame)
    log("epilogue (bn_relu): " + "; ".join(
        f"{r['shape']}: {fmt_ms(r['ms'])} (CUPTI {fmt_ms(r['cupti_ms'])}, "
        f"bound {fmt_ms(r['bound_ms'])}, plain {fmt_ms(r['plain_ms'])})"
        for r in maps) + f"; a frame's 17 maps: {frame}")
    return dict(maps=maps, frame=frame, checks=checked)


def second_model(dev):
    """SECOND on presets.second_kitti at full width in f32, seeded random
    weights with calibrated heads, and 4 frames of bench.py's recipe."""
    from d3d_tpu_torch.models import SECOND, presets, second_voxelize

    cfg = presets.second_kitti(dtype="float32")
    frames = [bench_points(np.random.default_rng(200 + i)) for i in range(4)]
    model = SECOND(cfg, device=dev,
                   generator=torch.Generator().manual_seed(0))
    calibrate_heads(model, frames[0], dev, second_voxelize,
                    occupied_only=True)
    return model, frames


def second_layer_inputs(model, pts, dev):
    """Each K5 layer's inputs on one frame of the SECOND path, in path
    order: {layer: (features, nbr, valid, weight)}."""
    from d3d_tpu_torch.models import second_voxelize

    with torch.inference_mode():
        f, c, v = second_voxelize(torch.from_numpy(pts).to(dev), model.cfg)
    return stage_layer_inputs(model, f[None], c[None], v[None])


def stage_layer_inputs(model, feats, coords, valid, names=K5_LAYERS):
    """Each sparse layer's inputs when the (B, V, ...) batch runs through
    the stage loop as one joined site list, in path order: {layer:
    (features, nbr, valid, weight)}; the layers must be ``names``."""
    from d3d_tpu_torch.models import sparse_stage_loop

    seen = {}

    def recording(name, layer):
        def run(x, nbr, valid, train=False):
            seen[name] = (x, nbr, valid, layer.weight.detach())
            return layer(x, nbr, valid, train)
        return run

    with torch.inference_mode():
        sparse_stage_loop(model.cfg, {n: recording(n, l)
                                      for n, l in model.middle.items()},
                          feats, coords, valid)
    check(tuple(seen) == names, f"sparse layers {tuple(seen)}")
    return seen


# presets.second_kitti on a 120k-point uniform frame: the voxel cap (16000
# of ~117k occupied cells) and the first site cap (8000 of ~13.8k) bind; the
# last (4000) does not: ~3250 sites stay, the rest is padding.
# (Nq, N, C, Cout) of each layer of one frame
UNIFORM_SHAPES = {
    "subm0_0": (16000, 16000, 4, 16), "subm0_1": (16000, 16000, 16, 16),
    "down0": (8000, 16000, 16, 32), "subm1_0": (8000, 8000, 32, 32),
    "subm1_1": (8000, 8000, 32, 32), "down1": (4000, 8000, 32, 64),
    "subm2_0": (4000, 4000, 64, 64), "subm2_1": (4000, 4000, 64, 64)}


def absent_shares(rules, cout):
    """(present pairs, the share of K5's multiply-adds on absent neighbours
    before the rule book (every row at every offset), and under it (the
    tiles' union of offsets)) of one layer."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    nq, k = rules.shape
    present, scheduled = rules.k5_schedule(K.k5_tile_rows(cout))
    return present, 1 - present / (nq * k), 1 - present / max(scheduled, 1)


def k5_compare(name, x, rules, valid, w, dt):
    """One K5 check in ``dt``: two launches, the second into a NaN-filled
    buffer, bit-equal (so every row is written, and the same bits come
    twice), held to the plain version at 1e-5 of each output's sum of
    |terms| plus, in bf16, one bf16 ulp of the value. Returns the largest
    |kernel - plain|."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    xd, wd = x.to(dt), w.to(dt)
    got = K._launch(xd, rules, wd, valid)
    again = K._launch(xd, rules, wd, valid,
                      out=torch.full_like(got, float("nan")))
    want = K._subm_conv_plain(xd, rules.nbr, wd, valid)
    scale = K._subm_conv_plain(x.float().abs(), rules.nbr, w.float().abs(),
                               valid)
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == dt,
          f"K5 {name} {dt}: {got.shape} {got.dtype}")
    check(torch.equal(got, again),
          f"K5 {name} {dt}: two launches differ or a row was not written")
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"K5 {name} {dt}: not finite")
    err = (got - want).abs()
    tol = 1e-5 * scale
    if dt == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.abs()
    bad = int((err > tol).sum())
    check(bad == 0, f"K5 {name} {dt}: {bad} outputs out of tolerance, max "
                    f"error {float(err.max()) if err.numel() else 0.0}")
    return float(err.max()) if err.numel() else 0.0


def check_k5(layers, want_shapes=UNIFORM_SHAPES, label="uniform"):
    """K5 against its plain version on the card at every layer shape of the
    SECOND path, in f32 and bf16, through each map's rule book
    (``k5_compare``: tolerance stated there, bit-equal across launches,
    every row written). ``want_shapes``, where given, pins the shapes and
    which caps bind. Returns the largest |kernel - plain| per dtype and
    the layers' shapes and presence."""
    worst = {"float32": 0.0, "bfloat16": 0.0}
    shapes = {}
    for name, (x, rules, valid, w) in layers.items():
        shape = (rules.shape[0], x.shape[0], x.shape[1], w.shape[2])
        nvalid = int(valid.sum())
        if want_shapes is not None:
            binds = name not in ("down1", "subm2_0", "subm2_1")
            check(shape == want_shapes[name]
                  and (nvalid == shape[0] if binds
                       else 0 < nvalid < shape[0]),
                  f"K5 {name}: shape (Nq, N, C, Cout) {shape}, {nvalid} "
                  "valid")
        present, before, after = absent_shares(rules, w.shape[2])
        shapes[name] = dict(nq=shape[0], n=shape[1], c=shape[2],
                            cout=shape[3], valid=nvalid, present=present,
                            absent_share_before=before,
                            absent_share_after=after)
        errs = []
        for dt in (torch.float32, torch.bfloat16):
            errs.append(k5_compare(name, x, rules, valid, w, dt))
            key = str(dt).split(".")[1]
            worst[key] = max(worst[key], errs[-1])
        log(f"K5 {label} {name} (Nq {shape[0]} with {nvalid} valid, N "
            f"{shape[1]}, C {shape[2]}, Cout {shape[3]}, {present} of "
            f"{rules.nbr.numel()} neighbours present; multiply-adds on absent "
            f"neighbours {before:.1%} before the rule book, {after:.1%} "
            f"under it): max |kernel - plain| f32 {errs[0]:.3g}, bf16 "
            f"{errs[1]:.3g}; bit-equal across two launches")
    return worst, shapes


def wide_kernel_layers(model, pts, dev):
    """Maps of more offsets than a 32-bit mask holds, at a SECOND-sized
    layer: the submanifold maps of kernel_size 4 (64 offsets), 5 (125) and
    7 (343: K5's tile can no longer stage its neighbour rows in shared
    memory and reads them from L2) over the 16 000 sites of SECOND's first
    layer on a uniform frame, with seeded (N, 16) features and (K, 16, 16)
    weights, each through its rule book: {"k64" / "k125" / "k343":
    (features, rule book, valid, weights)}."""
    from d3d_tpu_torch.models import second_voxelize
    from d3d_tpu_torch.ops.sparse_conv import (build_neighbor_map,
                                               prepare_neighbor_map)

    _, coords, valid = second_voxelize(torch.from_numpy(pts).to(dev),
                                       model.cfg)
    gen = torch.Generator().manual_seed(125)
    out = {}
    for size in (4, 5, 7):
        nbr = build_neighbor_map(coords, valid, model.cfg.grid,
                                 kernel_size=size)
        k = nbr.shape[1]
        check(k == size ** 3, f"kernel_size {size}: {k} offsets")
        x = torch.randn((coords.shape[0], 16), generator=gen).to(dev)
        w = (torch.randn((k, 16, 16), generator=gen) / (k * 16) ** 0.5).to(
            dev)
        out[f"k{k}"] = (x, prepare_neighbor_map(nbr), valid, w)
    return out


def k6_work(feats, nbr, cout):
    """K6's (bytes, operations) on these inputs. Bytes: features, map and the
    f32 cotangent read once, the f32 (K, C, Cout) gradient written once;
    operations: one multiply-add (2 operations) per channel pair of each
    neighbour that exists in this run's map."""
    n, c = feats.shape
    nq, k = nbr.shape
    nbytes = (n * c * feats.element_size() + nq * k * 4 + nq * cout * 4
              + k * c * cout * 4)
    return nbytes, 2 * int((nbr >= 0).sum()) * c * cout


def train_cotangent(layers, seed):
    """A seeded f32 cotangent for each layer's output, masked by its valid
    sites as the backward masks it: {layer: (Nq, Cout)}."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, (_, nbr, valid, w) in layers.items():
        g = torch.randn((nbr.shape[0], w.shape[2]), generator=gen)
        out[name] = g.to(valid.device) * valid[:, None]
    return out


def k6_compare(name, x, rules, g, dt):
    """One K6 check with ``dt`` features: two launches bit-equal, held to
    the plain version at 1e-5 of each entry's sum of |terms| (the two sum
    over up to 32 000 rows in other orders). Returns the largest
    |kernel - plain|."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    xd = x.to(dt)
    got = K._dw_launch(xd, rules, g)
    again = K._dw_launch(xd, rules, g)
    want = K._subm_conv_dw_plain(xd, rules.nbr, g)
    scale = K._subm_conv_dw_plain(xd.float().abs(), rules.nbr, g.abs())
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == torch.float32,
          f"K6 {name} {dt}: {got.shape} {got.dtype}")
    check(torch.equal(got, again),
          f"K6 {name} {dt}: two runs on the same inputs differ")
    check(bool(torch.isfinite(got).all()), f"K6 {name} {dt}: not finite")
    err = (got - want).abs()
    bad = int((err > 1e-5 * scale).sum())
    check(bad == 0, f"K6 {name} {dt}: {bad} entries out of tolerance, max "
                    f"error {float(err.max())}")
    return float(err.max())


def check_k6(layers, label="uniform"):
    """K6 against its plain version on the card at every layer shape of the
    SECOND training path (two frames joined), with f32 and with bf16
    features and a seeded f32 cotangent, through each map's rule book
    (``k6_compare``: tolerance stated there, bit-equal across runs).
    Returns the largest |kernel - plain| per dtype and the shapes."""
    grads = train_cotangent(layers, 6)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    shapes = {}
    for name, (x, rules, valid, w) in layers.items():
        present = int((rules.nbr >= 0).sum())
        shapes[name] = dict(nq=rules.shape[0], n=x.shape[0], c=x.shape[1],
                            cout=w.shape[2], valid=int(valid.sum()),
                            present=present)
        errs = []
        for dt in (torch.float32, torch.bfloat16):
            errs.append(k6_compare(name, x, rules, grads[name], dt))
            key = str(dt).split(".")[1]
            worst[key] = max(worst[key], errs[-1])
        log(f"K6 {label} {name} (Nq {rules.shape[0]}, N {x.shape[0]}, C "
            f"{x.shape[1]}, Cout {w.shape[2]}, {present} of "
            f"{rules.nbr.numel()} neighbours present, all of them and no "
            f"other multiplied): max |kernel - plain| f32 {errs[0]:.3g}, "
            f"bf16 {errs[1]:.3g}; bit-equal across two runs")
    return worst, shapes


def k5_backward_inputs(layers):
    """The features'-gradient K5 launches of a train step: the submanifold
    layers after the first (whose input, the voxel means, needs no
    gradient), each with the seeded cotangent and the mirrored, transposed
    f32 weights: {layer: (cotangent, rule book, valid, weights)}."""
    grads = train_cotangent(layers, 5)
    return {name: (grads[name], rules, valid,
                   w.float().flip(0).transpose(1, 2).contiguous())
            for name, (_, rules, valid, w) in layers.items()
            if name.startswith("subm") and name != "subm0_0"}


def check_k5_backward(layers, label="uniform"):
    """K5 as the features' gradient of the five submanifold layers of the
    training path, through the maps' rule books: against the plain
    scatter-add (the transposed map, which needs no symmetry) at 1e-5 of
    each entry's sum of |terms|, bit-equal across two launches (the second
    into a NaN-filled buffer), and the adjoint identity <K5(x; W), g> =
    <x, K5^T(g)> to 1e-5 of the sum of |terms| (f32 rounding). Returns the
    largest |kernel - plain|."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    worst = 0.0
    for name, (g, rules, valid, wt) in k5_backward_inputs(layers).items():
        x, _, _, w = layers[name]
        w = w.float()
        got = K._launch(g, rules, wt, valid)
        again = K._launch(g, rules, wt, valid,
                          out=torch.full_like(got, float("nan")))
        want = K._scatter_dfeat(g, rules.nbr, w, x.shape[0])
        scale = K._scatter_dfeat(g.abs(), rules.nbr, w.abs(), x.shape[0])
        fwd = K._launch(x.float(), rules, w, valid)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"K5 backward {name}: two launches "
                                       "differ or a row was not written")
        err = (got - want).abs()
        bad = int((err > 1e-5 * scale).sum())
        check(bad == 0, f"K5 backward {name}: {bad} entries out of "
                        f"tolerance, max error {float(err.max())}")
        lhs = float((fwd.double() * g.double()).sum())
        rhs = float((x.double() * got.double()).sum())
        terms = float((fwd.double() * g.double()).abs().sum())
        check(abs(lhs - rhs) <= 1e-5 * terms,
              f"K5 backward {name}: <K5 x, g> {lhs} != <x, K5^T g> {rhs}")
        worst = max(worst, float(err.max()))
        log(f"K5 backward {label} {name} (N {x.shape[0]}, {w.shape[2]} -> "
            f"{w.shape[1]} channels): max |kernel - plain| "
            f"{float(err.max()):.3g}; bit-equal across two launches; "
            f"<K5 x, g> - <x, K5^T g> = {lhs - rhs:.3g} of {terms:.4g}")
    return worst


EDGE_CASES = ("all_absent", "all_present", "one_offset_empty",
              "invalid_rows", "ragged", "nq_lt_n")
# (C, Cout): SECOND's first layer, ragged widths that leave tile columns
# and staged channels empty, the widest stage, two column tiles
EDGE_WIDTHS = ((4, 16), (24, 40), (64, 64), (32, 96))


def edge_map(rng, kind, dev):
    """A seeded (nbr, valid, N) edge-case map on the card (30% of the
    neighbours present where the case does not say otherwise): every
    neighbour absent, every neighbour present, offset 5 absent everywhere,
    40% invalid rows that keep their neighbours, Nq = 1037 (no multiple of
    any tile), Nq = 1000 < N = 3000."""
    nq, n = {"nq_lt_n": (1000, 3000), "ragged": (1037, 1037)}.get(
        kind, (2048, 2048))
    nbr = rng.integers(0, n, (nq, 27)).astype(np.int32)
    present = rng.random((nq, 27)) < 0.3
    valid = np.ones(nq, bool)
    if kind == "all_absent":
        present[:] = False
    elif kind == "all_present":
        present[:] = True
    elif kind == "one_offset_empty":
        present[:, 5] = False
    elif kind == "invalid_rows":
        valid[rng.random(nq) < 0.4] = False
    nbr[~present] = -1
    return (torch.from_numpy(nbr).to(dev), torch.from_numpy(valid).to(dev),
            n)


def check_edge_maps(dev):
    """K5 (bit-equal across launches, the second into a NaN-filled buffer)
    and K6 against their plain versions, f32 and bf16, on the seeded edge
    maps at each of ``EDGE_WIDTHS``, each map through its rule book.
    Returns the largest |kernel - plain| of K5 and of K6."""
    from d3d_tpu_torch.ops.sparse_conv import prepare_neighbor_map

    rng = np.random.default_rng(11)
    worst = {"subm_conv": 0.0, "subm_conv_dw": 0.0}
    for kind in EDGE_CASES:
        nbr, valid, n = edge_map(rng, kind, dev)
        rules = prepare_neighbor_map(nbr)
        for c, cout in EDGE_WIDTHS:
            gen = torch.Generator().manual_seed(c * 1000 + cout)
            x = torch.randn((n, c), generator=gen).to(dev)
            w = (torch.randn((27, c, cout), generator=gen)
                 / (27 * c) ** 0.5).to(dev)
            g = torch.randn((nbr.shape[0], cout), generator=gen).to(dev)
            g = g * valid[:, None]
            name = f"edge {kind} {c}->{cout}"
            for dt in (torch.float32, torch.bfloat16):
                worst["subm_conv"] = max(worst["subm_conv"], k5_compare(
                    name, x, rules, valid, w, dt))
                worst["subm_conv_dw"] = max(worst["subm_conv_dw"],
                                            k6_compare(name, x, rules, g, dt))
        log(f"edge map {kind} (Nq {nbr.shape[0]}, N {n}, "
            f"{int((nbr >= 0).sum())} present, {int(valid.sum())} valid): "
            f"K5 and K6 within tolerance at (C, Cout) {EDGE_WIDTHS}, f32 "
            "and bf16; K5 bit-equal across launches, every row written")
    return worst


def sort_edge_maps(dev):
    """Seeded maps for the rule-book sort's edges, each set built in one
    call: one row, every mask equal, every mask distinct, a row count no
    multiple of the sort's chunk, SECOND's 32 000 joined rows, and 16 maps
    of sizes 0 to 9000 (every map count the call takes)."""
    rng = np.random.default_rng(13)

    def from_masks(masks):
        bits = (masks[:, None] >> np.arange(27)) & 1
        return torch.from_numpy(np.where(bits, 0, -1).astype(np.int32)).to(
            dev)

    sizes = [0, 1, 5, 2048, 2049, 4100, 700, 64, 3000, 1, 2, 9000, 33, 2047,
             100, 6000]
    return {
        "one row": [from_masks(rng.integers(0, 1 << 27, 1))],
        "every mask equal": [from_masks(np.full(3000, 0b1011011))],
        "every mask distinct": [from_masks(rng.choice(1 << 27, 5000,
                                                      replace=False))],
        "2049 rows": [from_masks(rng.integers(0, 1 << 6, 2049))],
        "32 000 rows": [from_masks(((rng.random((32000, 27)) < 0.3)
                                    << np.arange(27)).sum(1))],
        "16 maps": [from_masks(rng.integers(0, 1 << int(rng.integers(1, 28)),
                                            n)) for n in sizes],
        # more chunks than the card holds blocks at once: a launch a phase
        "3 000 000 rows": [from_masks(((rng.random((3_000_000, 27)) < 0.3)
                                       << np.arange(27)).sum(1))]}


def distinct_maps(layers):
    """(layer names, neighbour maps) of the distinct maps these layers use,
    in path order: the first layer on each map names it."""
    names, nbrs, seen = [], [], set()
    for name, (_, rules, _, _) in layers.items():
        if id(rules) not in seen:
            seen.add(id(rules))
            names.append(name)
            nbrs.append(rules.nbr)
    return names, nbrs


def check_rulebooks(map_sets):
    """The rule-book kernel against its plain version on the card, each
    set of maps in one call as the path builds them (``map_sets``:
    {label: [maps]}): masks and orders equal, bit for bit, over two
    launches. Returns the largest |kernel - plain| of either (0)."""
    from d3d_tpu_torch.ops import rulebook
    from d3d_tpu_torch.ops.rulebook import (_subm_conv_rulebook_plain,
                                            subm_conv_rulebook)

    routes0 = dict(rulebook._ROUTES)
    for label, nbrs in map_sets.items():
        got, again = subm_conv_rulebook(nbrs), subm_conv_rulebook(nbrs)
        want = _subm_conv_rulebook_plain(nbrs)
        torch.cuda.synchronize()
        for i, nbr in enumerate(nbrs):
            for part, what in ((0, "masks"), (1, "order")):
                check(torch.equal(got[part][i], want[part][i])
                      and torch.equal(got[part][i], again[part][i]),
                      f"rule-book kernel {label} map {i} (Nq "
                      f"{nbr.shape[0]}): {what} differ from the plain "
                      "version or between launches")
        log(f"rule-book kernels {label}: {len(nbrs)} maps in one call (Nq "
            f"{[n.shape[0] for n in nbrs]}), masks and orders equal to the "
            "plain version (torch ops, a stable sort a map), twice")
    routes = {k: v - routes0[k] for k, v in rulebook._ROUTES.items()}
    log(f"rule-book builds by route in the checks: {routes}")
    check(all(routes.values()), f"rule books: a route never ran: {routes}")
    return 0.0, routes


def stage_map_frames(rng, batch, rows, grid, box, fill=None):
    """(B, rows, 3) int32 coords and (B, rows) valid on the CPU: frame b
    has ``fill[b]`` (default ~80% of the rows less 10% a frame) valid
    sites at distinct cells of a box of ``box`` cells at the grid's origin
    or far corner, in random rows; the rest hold arbitrary coords."""
    coords = rng.integers(-4, max(grid) + 4, (batch, rows, 3)).astype(
        np.int32)
    valid = np.zeros((batch, rows), bool)
    box = tuple(min(b, g) for b, g in zip(box, grid))
    for b in range(batch):
        n = (fill[b] if fill is not None else
             min(int(np.prod(box)), rows * (8 - b) // 10))
        keys = rng.choice(int(np.prod(box)), n, replace=False)
        corner = [0 if (b + a) % 2 == 0 else g - x
                  for a, (g, x) in enumerate(zip(grid, box))]
        at = rng.choice(rows, n, replace=False)
        coords[b, at] = np.stack(np.unravel_index(keys, box), -1) + corner
        valid[b, at] = True
    return torch.from_numpy(coords), torch.from_numpy(valid)


def published_second():
    """The benchmark's SECOND at OpenPCDet's KITTI widths (its
    ``second_kitti_f32`` configuration): config and layout."""
    from d3d_tpu_torch.models import SECONDLayout, presets

    cfg = presets.second_kitti(
        dtype="float32", grid=(1408, 1600, 40), max_voxels=40000,
        stage_channels=(16, 32, 64, 64),
        stage_sites=(40000, 90000, 60000, 20000))
    return cfg, SECONDLayout(out_sites=12000)


def stage_maps_equal(label, cfg, layout, coords, valid, plain_on="cuda"):
    """M1's outputs against the plain version's (its torch ops on
    ``plain_on``) for one batch: maps and valid bit for bit, coords on
    valid rows. Returns the frames' valid sites after each strided
    layer."""
    from d3d_tpu_torch.models.second import _stage_plan
    from d3d_tpu_torch.ops import stage_maps as M

    grid, downs = _stage_plan(cfg, layout)
    plan = M._plan(valid.shape[1], grid, downs)
    got = torch.ops.d3d_tpu_torch.build_stage_maps(coords, valid, plan)
    stages, _ = M._build_stage_maps_plain(coords.to(plain_on),
                                          valid.to(plain_on), grid, downs)
    want = []
    for nbr, _, nbr_s, oc, ov in stages:
        want += [nbr] if nbr_s is None else [nbr, nbr_s, oc,
                                             ov.reshape(valid.shape[0], -1)]
    check(len(got) == len(want), f"stage maps {label}: {len(got)} outputs")
    sites = []
    for i in range(len(want)):
        g, w = got[i], want[i]
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"stage maps {label}: output {i} {tuple(g.shape)} {g.dtype}, "
              f"plain {tuple(w.shape)} {w.dtype}")
        g, w = g.to(plain_on), w.to(plain_on)
        if w.ndim == 3:  # a strided layer's coords: on its valid rows
            v = want[i + 1].to(plain_on)
            check(torch.equal(g[v], w[v].to(torch.int32)),
                  f"stage maps {label}: output coords {i} differ")
            sites.append(v.sum(dim=1).tolist())
        else:
            check(torch.equal(g, w), f"stage maps {label}: output {i} "
                  "differs from the plain version")
    return sites


def check_stage_maps(dev):
    """M1 (``csrc/stage_maps.cu``) against its plain version on the card:
    the benchmark cell's 16 seeded KITTI-like frames at the published
    extents (exact voxels, one frame a call and all 16 in one) and the edge
    cases (an empty frame, caps that bind, an empty output extent, the
    ``coords // 2`` rule on odd extents, VoxelNeXt, the 1504 x 1504 x 40
    Waymo-size extent, duplicate coords); then one frame's launches inside
    ``d3d.second.maps`` (maps and rule books) on M1 and on the plain
    route, and M1's time by CUDA events and CUPTI against the plain
    route's and its bound (coords read once, maps, coords and valid
    written once)."""
    from d3d_tpu_torch.models import SECONDLayout, presets, second_voxelize
    from d3d_tpu_torch.models.second import (_batch_stage_maps,
                                             _prepare_maps, _stage_plan)
    from d3d_tpu_torch.ops import stage_maps as M

    cfg, layout = published_second()
    frames = []
    for i in range(16):  # the serving cell's pool under seed 2147483801
        fs = int(np.random.SeedSequence([2147483801, 0, i]).generate_state(
            1, np.uint64)[0])
        pts = torch.from_numpy(kitti_like_points(fs)).to(dev)
        _, c, v = second_voxelize(pts, cfg, exact_mean=True)
        frames.append((c, v))
    sites = []
    for i, (c, v) in enumerate(frames):
        sites.append(stage_maps_equal(f"KITTI-like frame {i}", cfg, layout,
                                      c[None], v[None]))
    batch = (torch.stack([c for c, _ in frames]),
             torch.stack([v for _, v in frames]))
    stage_maps_equal("16 KITTI-like frames in one call", cfg, layout, *batch)
    voxels = [int(v.sum()) for _, v in frames]
    log(f"stage maps: M1 equal to the plain version on 16 KITTI-like "
        f"frames at the published extents ({min(voxels)}-{max(voxels)} "
        f"voxels; sites after each strided layer, frame 0: {sites[0]}), a "
        "frame a call and all 16 in one")

    rng = np.random.default_rng(29)
    small = presets.second_kitti(
        dtype="float32", grid=(24, 20, 40), max_voxels=400,
        stage_channels=(4, 8, 8, 8), stage_sites=(400, 900, 500, 300))
    small_layout = SECONDLayout(z_extent=41, out_sites=200)
    g0 = small_layout.grids(small)[0]
    tight = presets.second_kitti(
        dtype="float32", grid=(24, 20, 40), max_voxels=400,
        stage_channels=(4, 8, 8, 8), stage_sites=(400, 60, 30, 12))
    flat = presets.second_kitti(
        dtype="float32", grid=(16, 14, 8), max_voxels=300,
        stage_channels=(4, 8, 8, 8), stage_sites=(300, 600, 300, 200))
    flat_layout = SECONDLayout(z_extent=9, out_sites=100)
    odd = presets.second_kitti(grid=(21, 19, 9), max_voxels=300,
                               stage_sites=(300, 100, 40))
    vnx = presets.voxelnext_nuscenes(grid=(26, 22, 10), max_voxels=350,
                                     stage_sites=(350, 200, 120, 60))
    waymo = presets.voxelnext_nuscenes(
        bounds=(-75.2, 75.2, -75.2, 75.2, -2.0, 4.0), grid=(1504, 1504, 40),
        max_voxels=20000, stage_sites=(20000, 15000, 8000, 4000))
    dup = stage_map_frames(rng, 2, 350, vnx.grid, (14, 12, 10))
    for t in dup:
        t[:, 1::7] = t[:, ::7][:, :t[:, 1::7].shape[1]]
    edges = {
        "random": (small, small_layout,
                   stage_map_frames(rng, 3, 400, g0, (12, 12, 41))),
        "empty frame": (small, small_layout, stage_map_frames(
            rng, 2, 400, g0, (12, 12, 41), fill=(0, 300))),
        "caps bind": (tight, SECONDLayout(z_extent=41, out_sites=5),
                      stage_map_frames(rng, 2, 400, g0, (12, 12, 41))),
        "empty output extent": (flat, flat_layout, stage_map_frames(
            rng, 2, 300, flat_layout.grids(flat)[0], (10, 10, 9))),
        "coords // 2, odd extents": (odd, None, stage_map_frames(
            rng, 2, 300, odd.grid, (11, 11, 9))),
        "VoxelNeXt": (vnx, None, stage_map_frames(rng, 2, 350, vnx.grid,
                                                  (14, 12, 10))),
        "Waymo-size extent": (waymo, None, stage_map_frames(
            rng, 1, 20000, waymo.grid, (120, 120, 40))),
        "duplicates": (vnx, None, dup),
    }
    for label, (c_, lay, (co, va)) in edges.items():
        # duplicate rows: the canvas's scatter on the card keeps any one of
        # them, the CPU's the last, as M1 and the sort join do
        stage_maps_equal(label, c_, lay, co.to(dev), va.to(dev),
                         "cpu" if label == "duplicates" else dev.type)
    log(f"stage maps: M1 equal to the plain version on the edge cases "
        f"{list(edges)}")

    c, v = frames[0][0][None], frames[0][1][None]
    grid, downs = _stage_plan(cfg, layout)

    def plain():
        stages, final = M._build_stage_maps_plain(c, v, grid, downs)
        return _prepare_maps([(n, vv, ns, ov)
                              for n, vv, ns, _, ov in stages]), final

    calls = M.build_stage_maps.launches
    m1 = kernel_launches(lambda: _batch_stage_maps(cfg, c, v, layout))
    old = kernel_launches(plain)
    check(M.build_stage_maps.launches > calls, "M1 never ran")
    check(sum(m1) <= 40, f"a frame's maps took {m1} launches")
    plan = M._plan(v.shape[1], grid, downs)
    op = torch.ops.d3d_tpu_torch.build_stage_maps
    ms = time_each(lambda: op(c, v, plan), 20)
    cupti = cupti_ms(lambda: op(c, v, plan))
    plain_ms = time_each(lambda: M._build_stage_maps_plain(c, v, grid,
                                                           downs), 5)
    outs = op(c, v, plan)
    nbytes = c.numel() * 4 + v.numel() + sum(
        t.numel() * t.element_size() for t in outs)
    bound_ms, bound_by = bound(nbytes, 0)
    host = host_ms(lambda: _batch_stage_maps(cfg, c, v, layout))
    log(f"stage maps, one published frame ({int(v.sum())} voxels): "
        f"launches (kernels, memory operations) in d3d.second.maps "
        f"{m1} with M1, {old} on the plain route; M1 {ms:.3f} ms by CUDA "
        f"events, CUPTI {cupti}, bound {bound_ms:.4f} ms ({bound_by}, "
        f"{nbytes} bytes), plain route {plain_ms:.3f} ms; the host "
        f"{host:.3f} ms to issue the maps and rule books")
    return dict(frame_launches=list(m1), plain_frame_launches=list(old),
                ms=ms,
                cupti_ms=cupti, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, host_ms=host,
                shape=f"one published frame, {int(v.sum())} voxels")


def check_sync_free(dev, model, batch):
    """The rule books of the training batch's first stage (its submanifold
    and strided maps) are built, and that stage's three layers run forward
    and backward through K5 and K6, under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for
    the device raises."""
    from d3d_tpu_torch.models.second import _batch_stage_maps
    from d3d_tpu_torch.ops import sparse_conv_cuda as K
    from d3d_tpu_torch.ops.rulebook import subm_conv_rulebook
    from d3d_tpu_torch.ops.sparse_conv import (prepare_neighbor_maps,
                                               subm_conv_apply)

    maps, _ = _batch_stage_maps(model.cfg, batch["coords"], batch["valid"])
    raw, valid, raw_s, valid_s = maps[0]
    raw, raw_s = raw.nbr, raw_s.nbr
    x = batch["features"].reshape(-1, batch["features"].shape[-1])
    ws = {n: model.middle[n].weight.detach().clone().requires_grad_()
          for n in ("subm0_0", "subm0_1", "down0")}
    counts = (K.subm_conv.launches, K.subm_conv_dw.launches,
              subm_conv_rulebook.launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rules, rules_s = prepare_neighbor_maps([raw, raw_s])
        y = subm_conv_apply(x, rules, ws["subm0_0"], valid, symmetric=True)
        y = subm_conv_apply(torch.relu(y), rules, ws["subm0_1"], valid,
                            symmetric=True)
        y = subm_conv_apply(torch.relu(y), rules_s, ws["down0"], valid_s)
        y.sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launched = (K.subm_conv.launches - counts[0],
                K.subm_conv_dw.launches - counts[1],
                subm_conv_rulebook.launches - counts[2])
    check(launched == (4, 3, 1), f"sync-free stage: launches (K5, K6, rule "
                                 f"books) {launched}, want (4, 3, 1)")
    check(all(bool(torch.isfinite(w.grad).all()) for w in ws.values()),
          "sync-free stage: gradients not finite")
    log("sync debug mode 'error': the rule books of stage 0's two joined "
        "maps (one rule-book call) and its three layers forward and "
        "backward (4 K5, 3 K6 launches) ran without a host synchronisation")


def car_gt(dev, b, m=6):
    """``m`` car-like ground-truth boxes a frame across the field for ``b``
    frames (seeded; the last box of frame 0 padded): gt_boxes, gt_labels,
    gt_mask."""
    rng = np.random.default_rng(400)
    gt = np.stack([
        rng.uniform(2, 60, (b, m)), rng.uniform(-35, 35, (b, m)),
        np.full((b, m), -1.0), rng.uniform(3.5, 4.3, (b, m)),
        rng.uniform(1.5, 1.8, (b, m)), rng.uniform(1.4, 1.7, (b, m)),
        rng.uniform(-np.pi, np.pi, (b, m))], -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[0, -1] = False
    return dict(gt_boxes=torch.from_numpy(gt).to(dev),
                gt_labels=torch.zeros((b, m), dtype=torch.int32,
                                      device=dev),
                gt_mask=torch.from_numpy(mask).to(dev))


def train_batch(dev, cfg, frames):
    """Two frames of bench.py's recipe through second_voxelize, stacked, and
    six car-like ground-truth boxes a frame (``car_gt``): the training
    batch."""
    from d3d_tpu_torch.models import second_voxelize

    with torch.inference_mode():
        vox = [second_voxelize(torch.from_numpy(p).to(dev), cfg)
               for p in frames]
    batch = {k: torch.stack([v[i] for v in vox]).clone()
             for i, k in enumerate(("features", "coords", "valid"))}
    batch.update(car_gt(dev, len(frames)))
    return batch


TRAIN_STEPS = 5
RIOU_WEIGHT = 0.1  # as tests/test_second.py's training test


def train_model(cfg, state, dev):
    from d3d_tpu_torch.models import SECOND

    model = SECOND(cfg, device=dev)
    model.load_state_dict(state)
    return model


def second_training(dev, state, batch, dtype):
    """make_train_step on presets.second_kitti at full width (``dtype``
    compute) from the serving model's weights, make_optimizer over 5
    steps, 5 steps on one fixed batch of 2 frames. Every count is set to 0
    just before each step and read just after: each step must launch K5 13
    times (8 forward, 5 features' gradients), K6 8 times and K1 never. The
    loss must be finite every step and lower at step 5 than at step 1.
    Returns (the summed counts, stats)."""
    from d3d_tpu_torch.models import head_config, make_anchors, presets
    from d3d_tpu_torch.models.second import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    cfg = presets.second_kitti(dtype=dtype)
    model = train_model(cfg, state, dev)
    opt, lr = make_optimizer(model.parameters(), total_steps=TRAIN_STEPS)
    step = make_train_step(model, opt, cfg,
                           make_anchors(head_config(cfg), device=dev),
                           riou_weight=RIOU_WEIGHT)
    total = {}
    losses, step_ms, wall_ms = [], [], []
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        start.record()
        aux = step(batch)
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_counts()
        step_ms.append(start.elapsed_time(end))
        want = dict(rbox_iou_matrix=0, nms_scan=0, nms_scan_blocked=0,
                    soft_nms_scan=0, subm_conv=13, subm_conv_dw=8,
                    subm_conv_rulebook=1, build_stage_maps=1,
                    soft_nms_scan_f64=0)
        check(counts == want, f"SECOND training {dtype} step {i + 1}: "
                              f"launches {counts}, want {want}")
        check(not any(read_routes().values()),
              f"SECOND training {dtype} step {i + 1}: an NMS kernel ran: "
              f"{read_routes()}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        losses.append({k: float(v) for k, v in aux.items()})
        check(all(math.isfinite(v) for v in losses[-1].values()),
              f"SECOND training {dtype} step {i + 1}: loss {losses[-1]}")
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in model.parameters()),
          f"SECOND training {dtype}: a parameter without a finite gradient")
    totals = [l["total"] for l in losses]
    check(totals[-1] < totals[0],
          f"SECOND training {dtype}: loss did not fall: {totals}")
    steady = statistics.median(step_ms[1:])
    log(f"SECOND training {dtype}: losses "
        + ", ".join(f"{t:.4f}" for t in totals)
        + f"; step {step_ms[0]:.2f} ms first, {steady:.2f} ms median of "
        f"steps 2-{TRAIN_STEPS} (CUDA events; host wall clock "
        f"{statistics.median(wall_ms[1:]):.2f} ms); launches a step "
        f"K5 13, K6 8, rule books 1, K1 0; lr at the steps "
        + ", ".join(f"{lr(i):.3g}" for i in range(TRAIN_STEPS)))
    stages = train_stage_times(model, opt, batch, cfg)
    return total, dict(losses=totals, loss_terms=losses[-1],
                       step_ms=step_ms, steady_ms=steady,
                       wall_ms=wall_ms, stages_ms=stages)


def train_stage_times(model, opt, batch, cfg, reps=5):
    """The train step's body cut into its stages (target assignment,
    forward, loss, backward, optimizer), device ms between CUDA events,
    median of ``reps`` more steps on the same batch."""
    from d3d_tpu_torch.models import head_config, make_anchors
    from d3d_tpu_torch.models.pointpillars import (detection_loss,
                                                   prepare_targets)

    hcfg = head_config(cfg)
    anchors = make_anchors(hcfg, device=batch["features"].device)
    names = ("assign", "forward", "loss", "backward", "optimizer")
    times = {n: [] for n in names}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        with torch.no_grad():
            targets = prepare_targets(anchors, batch, cfg=hcfg)["targets"]
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        out = model(batch["features"], batch["coords"], batch["valid"],
                    train=True)
        ev[2].record()
        loss, _ = detection_loss(out, targets, hcfg, anchors, RIOU_WEIGHT)
        ev[3].record()
        loss.backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        ev[5].synchronize()
        for i, n in enumerate(names):
            times[n].append(ev[i].elapsed_time(ev[i + 1]))
    stages = {n: statistics.median(t) for n, t in times.items()}
    log(f"SECOND training {cfg.dtype} stages (median of {reps}): "
        + ", ".join(f"{n} {ms:.2f} ms" for n, ms in stages.items()))
    return stages


def train_card_vs_cpu(dev, state, batch):
    """One f32 train step (TF32 off) on the card (K5, K6) and on the CPU
    (their plain versions) from the same weights and batch, with the
    targets assigned once (so an IoU that rounds across a threshold on one
    side cannot change them): every gradient leaf within 1e-4 of the
    leaf's largest |g| (the two sum in other orders; stated), the loss to
    rtol 1e-5. Returns the worst leaf's error relative to its max."""
    from d3d_tpu_torch.models import head_config, make_anchors, presets
    from d3d_tpu_torch.models.pointpillars import prepare_targets
    from d3d_tpu_torch.models.second import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    cfg = presets.second_kitti(dtype="float32")
    hcfg = head_config(cfg)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    cpu_batch = prepare_targets(make_anchors(hcfg, device="cpu"), cpu_batch,
                                cfg=hcfg)
    dev_batch = dict(batch, targets={k: v.to(dev) for k, v in
                                     cpu_batch["targets"].items()})
    grads, losses = [], []
    t_cpu = 0.0
    for d, b in ((dev, dev_batch), ("cpu", cpu_batch)):
        model = train_model(cfg, state, d)
        opt, _ = make_optimizer(model.parameters(), TRAIN_STEPS)
        step = make_train_step(model, opt, cfg, make_anchors(hcfg, device=d),
                               riou_weight=RIOU_WEIGHT,
                               external_targets=True)
        t0 = time.perf_counter()
        aux = step(b)
        if d == "cpu":
            t_cpu = (time.perf_counter() - t0) * 1e3
        losses.append(float(aux["total"]))
        grads.append({n: p.grad.cpu() for n, p in model.named_parameters()})
    worst, worst_name = 0.0, ""
    for name, g in grads[0].items():
        c = grads[1][name]
        rel = float((g - c).abs().max() / c.abs().max())
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= 1e-4, f"SECOND training gradients card vs CPU: {worst} "
                         f"of the largest |g| at {worst_name}")
    check(abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]),
          f"SECOND training loss card vs CPU: {losses}")
    log(f"SECOND training card vs CPU (f32, TF32 off, one step): loss "
        f"{losses[0]:.6f} / {losses[1]:.6f}; worst gradient leaf "
        f"{worst_name} at {worst:.3g} of its largest |g| (stated 1e-4); the "
        f"CPU step {t_cpu:.0f} ms")
    return worst


def counters():
    from d3d_tpu_torch.ops import (geometry_cuda, nms_cuda, rulebook,
                                   sparse_conv_cuda, stage_maps)

    return (geometry_cuda.rbox_iou_matrix, nms_cuda.nms_scan,
            nms_cuda.nms_scan_blocked, nms_cuda.soft_nms_scan,
            sparse_conv_cuda.subm_conv, sparse_conv_cuda.subm_conv_dw,
            rulebook.subm_conv_rulebook, stage_maps.build_stage_maps)


def route_counters():
    from d3d_tpu_torch.ops import geometry_cuda, nms_cuda

    return {"k1_matrix": (geometry_cuda._FORMS, "matrix"),
            "k1_bits": (geometry_cuda._FORMS, "bits"),
            "pack": (nms_cuda._ROUTES, "pack"),
            "scan_warp": (nms_cuda._ROUTES, "warp"),
            "scan_block": (nms_cuda._ROUTES, "block")}


def reset_counts():
    from d3d_tpu_torch.ops import nms_cuda

    for fn in counters():
        fn.launches = 0
    nms_cuda.soft_nms_scan.launches_f64 = 0
    for table, key in route_counters().values():
        table[key] = 0
    for key in nms_cuda._soft_launch.routes:
        nms_cuda._soft_launch.routes[key] = 0


def read_counts():
    """Each wrapper's launches since ``reset_counts``; K4's float64 entry
    point as ``soft_nms_scan_f64``."""
    from d3d_tpu_torch.ops import nms_cuda

    counts = {fn.__name__: fn.launches for fn in counters()}
    counts["soft_nms_scan_f64"] = nms_cuda.soft_nms_scan.launches_f64
    return counts


def read_routes():
    """K1's launches by output form, the pack kernel's and the scan's by
    route, since ``reset_counts``."""
    return {name: table[key] for name, (table, key) in
            route_counters().items()}


def check_nms_routes(name, calls, scan="scan_warp", routes=None):
    """``calls`` nms2d calls ran K1's bit form and the scan (``scan``
    route) once each, and neither K1's f32 form nor the pack kernel:
    ``routes`` (this process's since ``reset_counts`` when None)."""
    routes = read_routes() if routes is None else routes
    want = dict(k1_matrix=0, k1_bits=calls, pack=0, scan_warp=0,
                scan_block=0)
    want[scan] = calls
    check(routes == want, f"{name}: kernel routes {routes}, want {want}: "
                          "nms2d runs K1's bit rows and the scan only")
    return routes


def nms_inputs(boxes, scores, iou_threshold):
    """What nms2d hands its scan: the score order, the overlap matrix in
    that order (from K1) and the pre-suppression mask (score threshold 0,
    rank 0 exempt)."""
    from d3d_tpu_torch.ops import geometry_cuda

    order = torch.sort(-scores, stable=True).indices
    b = boxes[order]
    overlap = geometry_cuda.rbox_iou_matrix(b, b) > iou_threshold
    pre = scores[order] <= 0.0
    pre[0] = False
    return order, overlap, pre


def plain_nms(boxes, scores, iou_threshold):
    """nms2d's suppressed mask, with the plain scan run on the kernel's own
    overlap matrix (so a disagreement can only come from the scan)."""
    from d3d_tpu_torch.ops import nms_cuda

    order, overlap, pre = nms_inputs(boxes, scores, iou_threshold)
    out = torch.zeros_like(pre)
    out[order] = nms_cuda._nms_scan_plain(overlap, pre)
    return out


def north_star(dev):
    """bench.py's frame through voxelize_mean_fm + nms2d."""
    from d3d_tpu_torch.ops.nms import nms2d
    from d3d_tpu_torch.ops.voxel import voxelize_mean_fm

    pts, boxes, scores = north_star_frame()
    pts_fm = torch.from_numpy(np.ascontiguousarray(pts.T)).to(dev)
    tb, ts = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    bounds = torch.tensor(BOUNDS, dtype=torch.float32, device=dev)

    def run():
        vox = voxelize_mean_fm(pts_fm, GRID, bounds, 16000)
        return vox, nms2d(tb, ts, iou_threshold=0.25)

    reset_counts()
    vox, sup = run()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"north star launches: {counts}")
    check(counts["rbox_iou_matrix"] == 1 and counts["nms_scan"] == 1,
          f"north star did not run K1 and K2 once each: {counts}")
    log(f"north star routes: {check_nms_routes('north star', 1)}")

    keep = ~sup
    check(torch.equal(sup, plain_nms(tb, ts, 0.25)),
          "north star keep mask differs from the plain scan")
    nv = int(vox.nvoxels)
    check(nv == 16000, f"north star: {nv} voxels, expected the cap 16000")
    check(bool(torch.isfinite(vox.aggregates).all()), "aggregates not finite")
    cpu = voxelize_mean_fm(torch.from_numpy(np.ascontiguousarray(pts.T)),
                           GRID, torch.tensor(BOUNDS), 16000)
    for k in ("coords", "voxel_npoints", "nvoxels"):
        check(torch.equal(vox[k].cpu(), cpu[k]), f"voxel {k}: card != CPU")
    agg_err = float((vox.aggregates.cpu() - cpu.aggregates).abs().max())
    check(agg_err <= 8e-6, f"voxel aggregates: card vs CPU {agg_err}")
    log(f"north star: {int(keep.sum())} of 512 boxes kept, {nv} voxels, "
        f"aggregates card vs CPU max diff {agg_err:.3g}")

    ms = time_each(run, reps=30, warmup=5)
    t0 = time.perf_counter()
    for _ in range(10):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 10 * 1e3
    log(f"north star: {ms:.4f} ms device (median of 30, CUDA events), "
        f"{wall:.4f} ms host wall clock per frame")
    return counts, dict(ms=ms, wall_ms=wall, kept=int(keep.sum()),
                        voxels=nv), (tb, ts)


def k3_path(dev):
    """nms2d of 2048 boxes, which goes through K3."""
    from d3d_tpu_torch.ops.nms import nms2d

    boxes, scores = bench_boxes(np.random.default_rng(7), 2048)
    tb, ts = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    reset_counts()
    sup = nms2d(tb, ts, iou_threshold=0.25)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"nms2d n=2048 launches: {counts}")
    check(counts["nms_scan_blocked"] == 1 and counts["rbox_iou_matrix"] == 1
          and counts["nms_scan"] == 0,
          f"nms2d n=2048 did not run K1 and K3 once each: {counts}")
    log(f"nms2d n=2048 routes: {check_nms_routes('nms2d n=2048', 1)}")
    check(torch.equal(sup, plain_nms(tb, ts, 0.25)),
          "nms2d n=2048 keep mask differs from the plain scan")
    log(f"nms2d n=2048: {int((~sup).sum())} kept")
    return counts, tb, ts


def forward(model, pts, dev, voxelize=None):
    """The network's raw outputs (cls, box, dir) on one frame; ``voxelize``
    is the model's front end (default: PointPillars' ``pillarize``)."""
    from d3d_tpu_torch.models import pillarize

    voxelize = voxelize or pillarize
    with torch.inference_mode():
        feats, coords, valid = voxelize(torch.from_numpy(pts).to(dev),
                                        model.cfg)
        return model(feats[None], coords[None], valid[None])


def calibrate_heads(model, pts, dev, voxelize=None, occupied_only=False,
                    box_bound=None):
    """Rescale the random heads so their outputs on one frame spread like a
    trained model's (class logits sd 2, box residuals sd 0.3, direction
    logits sd 1). Raw lidar coordinates through random weights give
    outputs far from that: saturated scores and boxes of e^20 m. With
    ``occupied_only`` the spread is taken over the anchors whose outputs
    are not exactly 0 (the biases are 0): SECOND's site caps leave most of
    its BEV map empty, and cells that no point reaches say nothing of the
    scale. With ``box_bound`` the box residuals are then scaled down, if
    need be, until none exceeds it on this frame: on frames whose every
    voxel reaches the BEV map (the dense middle, KITTI-like scans) the
    random model's tails reach 20 sd, boxes of e^7 times an anchor, where
    a trained model's residuals stay within a few units."""
    heads = (model.head_cls, model.head_box, model.head_dir)
    for head, out, sd in zip(heads, forward(model, pts, dev, voxelize),
                             (2.0, 0.3, 1.0)):
        spread = out[out != 0] if occupied_only else out
        scale = sd / float(spread.std())
        if box_bound is not None and head is model.head_box:
            scale = min(scale, box_bound / float(out.abs().max()))
        with torch.no_grad():
            head.weight.mul_(scale)


def decode_at(raw, anchors, idx):
    """detect's decode of the anchors ``idx`` from raw outputs: (boxes,
    scores), as models/inference.py does it."""
    from d3d_tpu_torch.models import decode_boxes

    cls, box, dirl = (o[0] for o in raw)
    boxes = decode_boxes(anchors[idx], box[idx])
    boxes[:, 6] += dirl[idx].argmax(dim=-1).to(boxes.dtype) * math.pi
    return boxes, torch.sigmoid(cls).max(dim=-1).values[idx]


def compare_with_cpu(name, model, cpu_model, frame, detect, anchors, dev,
                     voxelize=None):
    """The same frame through ``detect`` on the card (TF32 off) and through
    ``cpu_model`` (the card's weights) on the CPU. Returns (the card's
    request ms with TF32 off, the CPU network's ms)."""
    from d3d_tpu_torch.models.inference import _bev
    from d3d_tpu_torch.ops.nms import nms2d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    gpu = [t.cpu() for t in detect.device_fn(frame)]
    no_tf32_ms = (time.perf_counter() - t0) * 1e3
    raw_dev = forward(model, frame, dev, voxelize)
    raw_gpu = [o.cpu() for o in raw_dev]
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    raw_cpu = forward(cpu_model, frame, "cpu", voxelize)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    # f32 on both sides, summed in other orders by the card's kernels and
    # the CPU: stated 1e-4 of each output's largest magnitude
    raw_err = max(float((g - c).abs().max() / c.abs().max())
                  for g, c in zip(raw_gpu, raw_cpu))
    check(raw_err <= 1e-4, f"{name}: network outputs card vs CPU: {raw_err}")
    # detections at the card's top-k anchors, decoded from the CPU's
    # outputs (a near-tie may rank two anchors differently on the two
    # sides, so the ranking itself is not compared). Residuals differ by
    # <= 1e-4 x 1 (sd 0.3): positions move by that x the anchor diagonal
    # (4.2 m), sizes by that relative, the clipped arcsin yaw by up to 70x;
    # yaw is compared modulo pi (a near-tie of the direction logits flips
    # the heading). Stated: 2e-3 m / 2e-3 relative / 2e-2 rad.
    # detect's own decode of the card's raw outputs, on the card (the
    # CPU's sigmoid and exp may differ from the card's by an ulp): equal
    best = torch.sigmoid(raw_dev[0][0]).max(dim=-1).values
    idx = torch.sort(best, descending=True, stable=True).indices[:100]
    boxes_g, scores_g = (t.cpu() for t in decode_at(raw_dev, anchors, idx))
    idx, anchors_cpu = idx.cpu(), anchors.cpu()
    check(torch.equal(scores_g, gpu[1]) and
          float((boxes_g - gpu[0]).abs().max()) <= 1e-5,
          f"{name}: detect.device_fn disagrees with its own raw outputs: "
          f"scores {float((scores_g - gpu[1]).abs().max())}, boxes "
          f"{float((boxes_g - gpu[0]).abs().max())}")
    boxes_c, scores_c = decode_at(raw_cpu, anchors_cpu, idx)
    pos_err = float((boxes_c[:, :3] - gpu[0][:, :3]).abs().max())
    size_err = float(((boxes_c[:, 3:6] - gpu[0][:, 3:6])
                      / gpu[0][:, 3:6]).abs().max())
    dyaw = torch.remainder(boxes_c[:, 6] - gpu[0][:, 6] + math.pi / 2,
                           math.pi) - math.pi / 2
    yaw_err = float(dyaw.abs().max())
    score_err = float((scores_c - gpu[1]).abs().max())
    check(pos_err <= 2e-3 and size_err <= 2e-3 and yaw_err <= 2e-2
          and score_err <= 1e-4,
          f"{name}: boxes card vs CPU: position {pos_err}, size {size_err}, "
          f"yaw {yaw_err}, score {score_err}")
    # the keep mask: the card's NMS against the CPU's on the same boxes
    keep_cpu = ~nms2d(_bev(gpu[0]), gpu[1], iou_threshold=0.5)
    check(torch.equal(keep_cpu, gpu[3]), f"{name}: keep mask card vs CPU")
    log(f"{name} card vs CPU (TF32 off): outputs {raw_err:.3g} relative; "
        f"at the card's top-100: positions {pos_err:.3g} m, sizes "
        f"{size_err:.3g}, yaw {yaw_err:.3g} rad, scores {score_err:.3g}; "
        f"keep mask equal ({int(gpu[3].sum())} kept). f32 request with "
        f"TF32 off {no_tf32_ms:.2f} ms; the CPU network {cpu_ms:.0f} ms")
    return no_tf32_ms, cpu_ms


def car_classes():
    """The detectors' class list: the port's KITTI Car (detect tags its
    boxes with it)."""
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass

    return [KittiObjectClass.Car]


def check_detections(name, out, score_threshold=0.3, frame=None):
    """``detect``'s Target3DArray: its columns of the right shapes, finite,
    above the score threshold, tagged Car, in ``frame``. Returns its
    length."""
    k = len(out)
    c = out.columns()
    check(c["position"].shape == (k, 3) and c["dimension"].shape == (k, 3)
          and c["yaw"].shape == (k,) and c["label"].shape == (k,),
          f"{name}: column shapes")
    check(all(np.isfinite(c[key]).all() for key in
              ("position", "dimension", "yaw", "score")),
          f"{name}: non-finite output")
    check(bool((c["score"] >= score_threshold).all()),
          f"{name}: score threshold")
    check(all(o.tag_top.name == "Car" for o in out) and out.frame == frame,
          f"{name}: tags or frame")
    return k


def serving(dev):
    """make_pointpillars_detector on the KITTI preset at full width with
    seeded random weights: 4 requests, then the CPU comparison and the
    bf16 preset as pinned."""
    from d3d_tpu_torch.models import (PointPillars, make_anchors,
                                      make_pointpillars_detector, presets)
    from d3d_tpu_torch.ops.epilogue import bn_relu

    cfg = presets.pointpillars_kitti(dtype="float32")
    frames = [bench_points(np.random.default_rng(100 + i)) for i in range(4)]
    model = PointPillars(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    calibrate_heads(model, frames[0], dev)
    anchors = make_anchors(cfg, device=dev)
    detect = make_pointpillars_detector(model, None, cfg, anchors,
                                        car_classes(), device=dev)

    reset_counts()
    request_ms = []
    kept = []
    epilogue = bn_relu.launches
    for pts in frames:
        t0 = time.perf_counter()
        out = detect(pts)
        request_ms.append((time.perf_counter() - t0) * 1e3)
        kept.append(check_detections("detect", out))
    counts = read_counts()
    epilogue = bn_relu.launches - epilogue
    log(f"serving launches (4 requests): {counts}, epilogue {epilogue}; "
        f"detections kept per request: {kept}")
    # an epilogue for the pillar net, each convolution and each
    # upsampling, every request
    layers = 1 + sum(cfg.backbone_blocks) + len(cfg.backbone_blocks)
    check(epilogue == 4 * layers, f"serving ran the BEV epilogue {epilogue} "
          f"times, not {4 * layers}")
    check(counts["rbox_iou_matrix"] == 4 and counts["nms_scan"] == 4,
          f"serving did not run K1 and K2 once per request: {counts}")
    log(f"serving routes: {check_nms_routes('serving', 4)}")
    log("serving f32 (PyTorch defaults, TF32 convolutions allowed): "
        + ", ".join(f"{ms:.2f}" for ms in request_ms) + " ms per request")

    no_tf32_ms, cpu_ms = compare_with_cpu(
        "serving", model, PointPillars(cfg, device="cpu"), frames[0], detect,
        anchors, dev)
    cfg16 = presets.pointpillars_kitti()
    model16 = PointPillars(cfg16, device=dev)
    model16.load_state_dict(model.state_dict())
    detect16 = make_pointpillars_detector(
        model16, None, cfg16, make_anchors(cfg16, device=dev),
        car_classes(), device=dev)
    bf16_ms = []
    for pts in frames[:2]:
        t0 = time.perf_counter()
        out = detect16(pts)
        bf16_ms.append((time.perf_counter() - t0) * 1e3)
        check_detections("bf16 detect", out)
    log(f"serving bf16 preset as pinned: first request {bf16_ms[0]:.2f} ms, "
        f"second {bf16_ms[1]:.2f} ms")

    # steady-state request time, f32 (TF32 off) and bf16
    steady = {}
    for name, det in (("f32_no_tf32", detect), ("bf16", detect16)):
        times = []
        for i in range(10):
            t0 = time.perf_counter()
            det(frames[i % 4])
            times.append((time.perf_counter() - t0) * 1e3)
        steady[name] = statistics.median(times)
    log(f"serving steady state (median of 10 requests): "
        f"f32 TF32 off {steady['f32_no_tf32']:.2f} ms, "
        f"bf16 {steady['bf16']:.2f} ms")
    return counts, dict(request_ms=request_ms, no_tf32_ms=no_tf32_ms,
                        bf16_ms=bf16_ms, steady_ms=steady,
                        cpu_ms=cpu_ms, epilogue_launches=epilogue), detect


def second_serving(dev, model, frames):
    """make_second_detector on presets.second_kitti at full width: 4
    requests, the CPU comparison, then the f32 and the bf16 preset's
    first and steady request times."""
    from d3d_tpu_torch.models import (SECOND, head_config, make_anchors,
                                      make_second_detector, presets,
                                      second_voxelize)

    cfg = model.cfg
    anchors = make_anchors(head_config(cfg), device=dev)
    detect = make_second_detector(model, None, cfg, anchors, car_classes(),
                                  device=dev)
    reset_counts()
    request_ms, kept = [], []
    for pts in frames:
        t0 = time.perf_counter()
        out = detect(pts)
        request_ms.append((time.perf_counter() - t0) * 1e3)
        kept.append(check_detections("SECOND detect", out))
    counts = read_counts()
    log(f"SECOND serving launches (4 requests): {counts}; detections kept "
        f"per request: {kept}")
    want = dict(rbox_iou_matrix=4, nms_scan=4, nms_scan_blocked=0,
                soft_nms_scan=0, subm_conv=4 * len(K5_LAYERS),
                subm_conv_dw=0, subm_conv_rulebook=4, build_stage_maps=4,
                soft_nms_scan_f64=0)
    check(counts == want, f"SECOND serving: launches {counts}, want {want}: "
                          "8 of K5, 1 of M1, 1 of K1 and 1 of K2 per "
                          "request")
    log(f"SECOND serving routes: {check_nms_routes('SECOND serving', 4)}")
    log("SECOND serving f32: " + ", ".join(f"{ms:.2f}" for ms in request_ms)
        + " ms per request (the first one cold)")

    no_tf32_ms, cpu_ms = compare_with_cpu(
        "SECOND serving", model, SECOND(cfg, device="cpu"), frames[0],
        detect, anchors, dev, second_voxelize)

    cfg16 = presets.second_kitti()
    model16 = SECOND(cfg16, device=dev)
    model16.load_state_dict(model.state_dict())
    detect16 = make_second_detector(
        model16, None, cfg16, make_anchors(head_config(cfg16), device=dev),
        car_classes(), device=dev)
    t0 = time.perf_counter()
    out = detect16(frames[1])
    bf16_first = (time.perf_counter() - t0) * 1e3
    check_detections("SECOND bf16 detect", out)
    steady = {}
    for name, det in (("f32", detect), ("bf16", detect16)):
        times = []
        for i in range(10):
            t0 = time.perf_counter()
            det(frames[i % 4])
            times.append((time.perf_counter() - t0) * 1e3)
        steady[name] = statistics.median(times)
    log(f"SECOND serving: f32 first request {request_ms[0]:.2f} ms, steady "
        f"{steady['f32']:.2f} ms (median of 10, TF32 off); bf16 preset as "
        f"pinned: first request {bf16_first:.2f} ms, steady "
        f"{steady['bf16']:.2f} ms (median of 10)")
    return counts, dict(request_ms=request_ms, kept=kept,
                        no_tf32_ms=no_tf32_ms, cpu_ms=cpu_ms,
                        f32_first_ms=request_ms[0],
                        f32_steady_ms=steady["f32"],
                        bf16_first_ms=bf16_first,
                        bf16_steady_ms=steady["bf16"])


def soft_nms_path(dev):
    """soft_nms2d on the north star's 512 boxes, linear and gaussian: one
    K1 and one K4 launch per call, masks equal to the plain cascade on the
    kernel's own IoU matrix."""
    from d3d_tpu_torch.ops import geometry_cuda, nms_cuda
    from d3d_tpu_torch.ops.nms import _soft_nms_init, soft_nms2d

    _, boxes, scores = north_star_frame()
    tb, ts = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)

    def run(method, param):
        return soft_nms2d(tb, ts, supression_param=param,
                          supression_method=method, **SOFT_NMS_ARGS)

    reset_counts()
    sups = {m: run(m, p) for m, p in SOFT_NMS_CASES}
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"soft_nms2d launches (linear + gaussian): {counts}")
    check(counts == dict(rbox_iou_matrix=2, nms_scan=0, nms_scan_blocked=0,
                         soft_nms_scan=2, subm_conv=0, subm_conv_dw=0,
                         subm_conv_rulebook=0, build_stage_maps=0,
                         soft_nms_scan_f64=0),
          f"soft_nms2d did not run K1 and K4 once per call: {counts}")
    routes = read_routes()
    check(routes == dict(k1_matrix=2, k1_bits=0, pack=0, scan_warp=0,
                         scan_block=0),
          f"soft_nms2d: kernel routes {routes}: K1's f32 form twice only")
    iou = geometry_cuda.rbox_iou_matrix(tb, tb)
    thr = SOFT_NMS_ARGS["score_threshold"]
    pre, init = _soft_nms_init(ts, thr)
    stats = {}
    for method, param in SOFT_NMS_CASES:
        want = nms_cuda._soft_nms_scan_plain(
            iou, init, pre, SOFT_NMS_ARGS["iou_threshold"], thr, param,
            method)
        check(torch.equal(sups[method], want),
              f"soft_nms2d {method}: mask differs from the plain cascade")
        stats[method] = dict(
            suppressed=int(want.sum()),
            ms=time_each(lambda: run(method, param), reps=20))
        log(f"soft_nms2d {method} (p = {param}) on 512 boxes: "
            f"{stats[method]['suppressed']} suppressed, equal to the plain "
            f"cascade; {stats[method]['ms']:.4f} ms per call (device, "
            f"median of 20)")
    return counts, stats, (iou, init, pre)


# ---------------------------------------------------------------------------
# the public box and voxel API (ops/box.py, ops/voxel.py VoxelGenerator)
# ---------------------------------------------------------------------------

# OpenPCDet tools/cfgs/dataset_configs/kitti_dataset.yaml, the data
# processor of its SECOND and PV-RCNN KITTI models: POINT_CLOUD_RANGE
# [0, -40, -3, 70.4, 40, 1], VOXEL_SIZE [0.05, 0.05, 0.1] (a 1408 x 1600 x
# 40 grid, 90.1M cells), MAX_POINTS_PER_VOXEL 5, MAX_NUMBER_OF_VOXELS test
# 40000
KITTI_VOXELS = dict(bounds=(0.0, 70.4, -40.0, 40.0, -3.0, 1.0),
                    shape=(1408, 1600, 40), max_points=5, max_voxels=40000)
VOXEL_CASES = (
    ("dense mean", dict(dense=True, reduction="mean")),
    ("sparse trim/descending", dict(max_points_filter="trim",
                                    max_voxels_filter="descending")),
    ("sparse farthest_sampling", dict(max_points_filter="farthest_sampling",
                                      max_voxels_filter="trim")),
)
IOU_METHODS = ("box", "rbox", "grbox", "drbox")
NMS_CASES = (("hard", 0.0),) + SOFT_NMS_CASES
NMS_SIZES = (512, 4096)  # the north star's; OpenPCDet's NMS_PRE_MAXSIZE
NO_LAUNCHES = dict(rbox_iou_matrix=0, nms_scan=0, nms_scan_blocked=0,
                   soft_nms_scan=0, subm_conv=0, subm_conv_dw=0,
                   subm_conv_rulebook=0, build_stage_maps=0,
                   soft_nms_scan_f64=0)


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def voxel_generator_path(dev):
    """``VoxelGenerator`` on OpenPCDet's KITTI voxel configuration: dense
    with mean reduction, sparse with trim/descending and with
    farthest_sampling, on the bench frame (120k uniform points) and on the
    KITTI-like frame; every output array equal to the same call with
    ``device="cpu"`` (dense means within 8e-6, as ``check_nan_voxels``
    states); no hand kernel runs. Times: the whole call (host clock, numpy
    in and out, median of 5) and the padded cores on the card (CUDA
    events, median of 5)."""
    from d3d_tpu_torch.ops import voxel as V

    frames = {"bench 120k": bench_points(np.random.default_rng(42)),
              "KITTI-like": kitti_like_points(500)}
    size = torch.tensor([0.05, 0.05, 0.1], device=dev)
    bounds = torch.tensor(KITTI_VOXELS["bounds"], device=dev)
    stats = {}
    reset_counts()
    for fname, pts in frames.items():
        tp = torch.from_numpy(pts).to(dev)
        for cname, kw in VOXEL_CASES:
            gen = V.VoxelGenerator(device=dev, **KITTI_VOXELS, **kw)
            out = gen(pts)
            ref = V.VoxelGenerator(device="cpu", **KITTI_VOXELS, **kw)(pts)
            check(sorted(out) == sorted(ref), f"VoxelGenerator {cname}: "
                                              f"keys {sorted(out)}")
            for k in ref:
                a, b = torch.from_numpy(out[k]), torch.from_numpy(ref[k])
                check(a.dtype == b.dtype and same_with_nan(
                    a, b, 8e-6 if k == "aggregates" else 0.0),
                      f"VoxelGenerator {cname} {fname} {k}: card != CPU")
            nv = len(out.coords)
            check(0 < nv <= KITTI_VOXELS["max_voxels"]
                  and int(out.voxel_npoints.min()) > 0,
                  f"VoxelGenerator {cname} {fname}: {nv} voxels")
            if not kw.get("dense"):
                check(int(out.voxel_npoints.max()) <= 5
                      and len(out.points) == int(out.voxel_npoints.sum()),
                      f"VoxelGenerator {cname} {fname}: point counts")
            wall = []
            for _ in range(5):
                t0 = time.perf_counter()
                gen(pts)
                wall.append((time.perf_counter() - t0) * 1e3)
            if kw.get("dense"):
                core = dict(dense_core_ms=time_each(
                    lambda: V.voxelize_dense_padded(
                        tp, KITTI_VOXELS["shape"], bounds, 5, 40000,
                        "mean"), reps=5, warmup=1))
            else:
                sp = V.voxelize_sparse_padded(tp, size)
                vb = torch.from_numpy(gen._vbounds).to(dev)
                xyz = tp[:, :3] if "farthest" in cname else None
                core = dict(
                    sparse_core_ms=time_each(
                        lambda: V.voxelize_sparse_padded(tp, size), reps=5,
                        warmup=1),
                    filter_ms=time_each(lambda: V.voxelize_filter_padded(
                        sp.points_mapping, sp.coords, sp.voxel_npoints,
                        sp.nvoxels, vb, 0, 5, 40000, kw["max_points_filter"],
                        kw["max_voxels_filter"], True, points_xyz=xyz),
                        reps=5, warmup=1))
            stats[f"{fname}, {cname}"] = dict(
                points=len(pts), voxels=nv,
                kept_points=(int(out.voxel_npoints.sum()) if not
                             kw.get("dense") else None),
                call_ms=statistics.median(wall), **core)
            log(f"VoxelGenerator {cname} on {fname} ({len(pts)} points): "
                f"{nv} voxels, card equal to CPU; call "
                f"{statistics.median(wall):.2f} ms (host clock, numpy in "
                f"and out), cores on the card: "
                + ", ".join(f"{k} {v:.3f}" for k, v in core.items()))
    counts = read_counts()
    check(counts == NO_LAUNCHES,
          f"VoxelGenerator launched a hand kernel: {counts}")
    return counts, stats


def box_iou_path(dev):
    """``box2d_iou`` on 512 x 512 bench boxes, four methods x precise, numpy
    in and out: float64 (precise) within 1e-12 of the CPU's largest value,
    float32 within K1's 2e-5 (rbox is K1's matrix, one launch); then rbox
    float32 on 4096 x 4096 (K1) against the plain version on the card, and
    float64 beside it. Returns the counts, stats and the 4096 boxes."""
    from d3d_tpu_torch.ops import geometry_soa
    from d3d_tpu_torch.ops.box import box2d_iou

    rng = np.random.default_rng(71)
    b512 = bench_boxes(rng, 512)[0]
    b4096 = bench_boxes(rng, 4096)[0]
    stats = {}
    total = {}
    for method in IOU_METHODS:
        for precise in (True, False):
            b = b512.astype(np.float64) if precise else b512
            reset_counts()
            got = box2d_iou(b, b, method=method, precise=precise)
            counts = read_counts()
            want = box2d_iou(b, b, method=method, precise=precise,
                             device="cpu")
            k1 = int(method == "rbox" and not precise)
            check(counts == dict(NO_LAUNCHES, rbox_iou_matrix=k1),
                  f"box2d_iou {method} precise={precise}: launches "
                  f"{counts}")
            add_counts(total, counts)
            check(got.dtype == want.dtype == b.dtype
                  and got.shape == (512, 512)
                  and np.isfinite(got).all(), f"box2d_iou {method}: output")
            err = float(np.abs(got.astype(np.float64) - want).max())
            tol = (1e-12 * float(np.abs(want).max()) if precise else 2e-5)
            check(err <= tol, f"box2d_iou {method} precise={precise}: card "
                              f"vs CPU {err} > {tol}")
            tb = torch.from_numpy(b).to(dev)
            ms = time_each(lambda: box2d_iou(tb, tb, method=method,
                                             precise=precise), reps=5,
                           warmup=1)
            stats[f"{method}, precise={precise}"] = dict(err=err, ms=ms)
            log(f"box2d_iou {method} precise={precise} 512x512: card vs "
                f"CPU {err:.3g} (tolerance {tol:.3g}); {ms:.3f} ms on the "
                f"card (CUDA events, median of 5)")
    t4 = torch.from_numpy(b4096).to(dev)
    reset_counts()
    k1 = box2d_iou(t4, t4, method="rbox", precise=False)
    counts = read_counts()
    check(counts == dict(NO_LAUNCHES, rbox_iou_matrix=1),
          f"box2d_iou rbox 4096: launches {counts}")
    add_counts(total, counts)
    plain = geometry_soa._rbox_iou_matrix_plain(t4, t4)
    f64 = box2d_iou(t4.double(), t4.double(), method="rbox")
    err = float((k1 - plain).abs().max())
    err64 = float((k1.double() - f64).abs().max())
    check(err <= 2e-5 and err64 <= 2e-5,
          f"box2d_iou rbox 4096x4096: K1 vs plain {err}, vs float64 {err64}")
    ms = time_each(lambda: box2d_iou(t4, t4, method="rbox", precise=False),
                   reps=5, warmup=1)
    ms64 = time_each(lambda: box2d_iou(t4, t4, method="rbox"), reps=2,
                     warmup=1)
    stats["rbox 4096x4096"] = dict(err_vs_plain=err, err_vs_f64=err64,
                                   ms=ms, ms_precise=ms64)
    log(f"box2d_iou rbox 4096x4096: K1 vs the plain version on the card "
        f"{err:.3g}, vs precise {err64:.3g}; precise=False (K1) {ms:.3f} "
        f"ms, precise=True (the row-blocked float64 torch version) "
        f"{ms64:.1f} ms (CUDA events)")
    return total, stats


def clear_nms_boxes(rng, n, dev, thr, margin=1e-4):
    """``bench_boxes`` of n, each box of a pair whose float64 IoU (rotated
    or axis-aligned) lies within ``margin`` of ``thr`` drawn anew until
    none does: one rounding there could flip a keep bit between the card
    and the CPU (the ROADMAP's NMS trap)."""
    from d3d_tpu_torch.ops import geometry, geometry_soa

    boxes, scores = bench_boxes(rng, n)
    for _ in range(10):
        tb = torch.from_numpy(boxes).to(dev, torch.float64)
        near = torch.zeros((n, n), dtype=torch.bool, device=dev)
        for iou in (geometry_soa._rbox_iou_matrix_plain(tb, tb),
                    geometry.aabox_iou(tb[:, None], tb[None])):
            near |= (iou - thr).abs() < margin
        bad = torch.triu(near, 1).any(0).nonzero()[:, 0].cpu().numpy()
        if not len(bad):
            return boxes, scores
        boxes[bad] = bench_boxes(rng, len(bad))[0]
    raise SmokeFailure(f"no {n} boxes clear of IoU {thr} after 10 draws")


def cpu_nms_reference(boxes, scores, iou, sup, param):
    """box2d_nms's keep mask by the port's CPU pipeline, on ``iou``, the
    boxes' (N, N) IoU matrix in input order computed once on the CPU:
    hard, the plain scan on the rows in stable score order; soft, the
    plain cascade."""
    from d3d_tpu_torch.ops import nms_cuda
    from d3d_tpu_torch.ops.nms import _soft_nms_init

    args = SOFT_NMS_ARGS
    if sup == "hard":
        neg, order = torch.sort(-scores, stable=True)
        overlap = iou[order][:, order] > args["iou_threshold"]
        out = torch.empty(len(scores), dtype=torch.bool)
        out[order] = nms_cuda._nms_scan_plain(
            overlap, nms_cuda._pre_suppression(-neg,
                                               args["score_threshold"]))
        return ~out
    pre, init = _soft_nms_init(scores, args["score_threshold"])
    return ~nms_cuda._soft_nms_scan_plain(
        iou, init, pre, args["iou_threshold"], args["score_threshold"],
        param, sup)


def box_nms_path(dev):
    """``box2d_nms``, hard/linear/gaussian x box/rbox x precise, on n =
    512 and 4096 boxes clear of the IoU threshold, numpy in and out; keep
    masks equal to the CPU's: ``box2d_nms(..., device="cpu")``, and at
    4096 rotated boxes the same CPU pipeline on one CPU IoU matrix a dtype
    (``cpu_nms_reference``; the full calls would build six 4096^2 matrices
    on the host). Launches read per call: K1's bit rows + the scan for
    float32 rbox hard, the bool route (pack + scan, K2 at 512, K3 at 4096)
    for the other hard calls, K1's matrix + K4 for float32 rbox soft, K4
    (float32 or float64) for every soft call, and both of K4's float64
    routes. Returns the counts, stats and K4's inputs for the timings."""
    from d3d_tpu_torch.ops import geometry_soa, nms_cuda
    from d3d_tpu_torch.ops.box import box2d_nms
    from d3d_tpu_torch.ops.nms import _soft_nms_init

    rng = np.random.default_rng(72)
    thr = SOFT_NMS_ARGS["iou_threshold"]
    total, stats, k4_inputs = {}, {}, {}
    f64_routes = {"shared_f64": 0, "l2_f64": 0}
    for n in NMS_SIZES:
        boxes, scores = clear_nms_boxes(rng, n, dev, thr)
        tb, ts = (torch.from_numpy(a).to(dev) for a in (boxes, scores))
        cpu_iou = {}
        if n > 512:
            bc = torch.from_numpy(boxes)
            cpu_iou = {p: geometry_soa._rbox_iou_matrix_plain(
                bc.to(dt), bc.to(dt), pair_budget=1 << 18)
                for p, dt in ((True, torch.float64),
                              (False, torch.float32))}
        for iou_method in ("box", "rbox"):
            for sup, param in NMS_CASES:
                for precise in (True, False):
                    name = (f"n={n} {iou_method} {sup} "
                            f"{'float64' if precise else 'float32'}")
                    kw = dict(iou_method=iou_method, supression_method=sup,
                              supression_param=param, precise=precise,
                              **SOFT_NMS_ARGS)
                    reset_counts()
                    keep = box2d_nms(boxes, scores, **kw)
                    torch.cuda.synchronize()
                    counts, routes = read_counts(), read_routes()
                    for k in f64_routes:
                        f64_routes[k] += nms_cuda._soft_launch.routes[k]
                    add_counts(total, counts)
                    want = dict(NO_LAUNCHES)
                    f32_rbox = iou_method == "rbox" and not precise
                    if sup == "hard":
                        want["nms_scan" if n <= 1024
                             else "nms_scan_blocked"] = 1
                        want["rbox_iou_matrix"] = int(f32_rbox)
                        want_routes = dict(
                            k1_matrix=0, k1_bits=int(f32_rbox),
                            pack=int(not f32_rbox), scan_warp=0,
                            scan_block=0)
                        want_routes["scan_warp" if n <= 2048
                                    else "scan_block"] = 1
                    else:
                        want["soft_nms_scan_f64" if precise
                             else "soft_nms_scan"] = 1
                        want["rbox_iou_matrix"] = int(f32_rbox)
                        want_routes = dict(k1_matrix=int(f32_rbox),
                                           k1_bits=0, pack=0, scan_warp=0,
                                           scan_block=0)
                    check(counts == want and routes == want_routes,
                          f"box2d_nms {name}: launches {counts}, routes "
                          f"{routes}; want {want}, {want_routes}")
                    if iou_method == "rbox" and n > 512:
                        dt = torch.float64 if precise else torch.float32
                        ref = cpu_nms_reference(
                            torch.from_numpy(boxes), torch.from_numpy(
                                scores).to(dt), cpu_iou[precise], sup,
                            param).numpy()
                    else:
                        ref = box2d_nms(boxes, scores, device="cpu", **kw)
                    bad = int((keep != ref).sum())
                    check(keep.dtype == bool and keep.shape == (n,)
                          and bad == 0,
                          f"box2d_nms {name}: {bad} keep bits differ from "
                          "the CPU's")
                    ms = time_each(lambda: box2d_nms(tb, ts, **kw), reps=3,
                                   warmup=1)
                    stats[name] = dict(kept=int(keep.sum()), ms=ms)
                    log(f"box2d_nms {name}: {int(keep.sum())} of {n} kept, "
                        f"equal to the CPU's; launches "
                        f"{ {k: v for k, v in counts.items() if v} }; "
                        f"{ms:.3f} ms a call on the card (CUDA events, "
                        f"median of 3)")
        # K4's inputs as box2d_nms builds them for rotated soft-NMS, both
        # dtypes, for the kernels line
        for dt in (torch.float32, torch.float64):
            b = tb.to(dt)
            iou = geometry_soa.rbox_iou_matrix(b, b)
            pre, init = _soft_nms_init(ts.to(dt), SOFT_NMS_ARGS[
                "score_threshold"])
            k4_inputs[n, dt] = (iou, init, pre)
    log(f"box2d_nms: K4's float64 launches by route {f64_routes}")
    check(all(f64_routes.values()),
          f"box2d_nms: a float64 route of K4 never ran: {f64_routes}")
    return total, stats, k4_inputs


def crop_path(dev):
    """``box2dr_crop``, ``box3dp_crop``, ``box2dr_pdist`` and
    ``box3dr_pdist`` on the bench frame's 120k points and 40 bench boxes
    (3D: z centre -1, height 1.6 m), numpy in and out: index lists and masks
    equal to the CPU's, distances within 1e-4 m (float32 on both)."""
    from d3d_tpu_torch.ops import box as B

    pts = bench_points(np.random.default_rng(42))
    b2 = bench_boxes(np.random.default_rng(73), 40)[0]
    b3 = np.concatenate([b2[:, :2], np.full((40, 1), -1.0, np.float32),
                         b2[:, 2:4], np.full((40, 1), 1.6, np.float32),
                         b2[:, 4:5]], 1)
    calls = {
        "box2dr_crop": lambda **kw: B.box2dr_crop(pts[:, :2], b2, **kw),
        "box3dp_crop": lambda **kw: B.box3dp_crop(pts[:, :3], b3, **kw),
        "box2dr_pdist": lambda **kw: B.box2dr_pdist(pts[:, :2], b2, **kw),
        "box3dr_pdist": lambda **kw: B.box3dr_pdist(pts[:, :3], b3, **kw),
    }
    stats = {}
    reset_counts()
    for name, call in calls.items():
        got, want = call(), call(device="cpu")
        if name == "box2dr_crop":
            check(len(got) == 40 and all(np.array_equal(g, w)
                                         for g, w in zip(got, want)),
                  "box2dr_crop: card != CPU")
            val = sum(len(g) for g in got)
        elif name == "box3dp_crop":
            check(np.array_equal(got, want), "box3dp_crop: card != CPU")
            val = int(got.sum())
        else:
            val = float(np.abs(got - want).max())
            check(got.shape == (40, len(pts)) and val <= 1e-4,
                  f"{name}: card vs CPU {val}")
        wall = []
        for _ in range(5):
            t0 = time.perf_counter()
            call()
            wall.append((time.perf_counter() - t0) * 1e3)
        stats[name] = dict(value=val, call_ms=statistics.median(wall))
        log(f"{name} (120k points x 40 boxes): "
            + (f"{val} points inside, equal to the CPU's" if "crop" in name
               else f"card vs CPU {val:.3g} m")
            + f"; {statistics.median(wall):.2f} ms a call (host clock, "
              "numpy in and out, median of 5)")
    counts = read_counts()
    check(counts == NO_LAUNCHES, f"crops launched a hand kernel: {counts}")
    return counts, stats


def check_k1_grad_guard(dev):
    """K1's float32 matrix is forward-only: given boxes that require a
    gradient while grad mode is on, the wrapper and box2d_iou(precise=False)
    raise instead of returning a matrix with no gradient; precise=True
    differentiates (finite gradients) and runs no kernel."""
    from d3d_tpu_torch.ops import geometry_cuda
    from d3d_tpu_torch.ops.box import box2d_iou

    tb = torch.from_numpy(bench_boxes(np.random.default_rng(74),
                                      64)[0]).to(dev).requires_grad_()
    for name, call in (
            ("rbox_iou_matrix", lambda: geometry_cuda.rbox_iou_matrix(tb,
                                                                      tb)),
            ("box2d_iou precise=False",
             lambda: box2d_iou(tb, tb, method="rbox", precise=False))):
        try:
            call()
        except RuntimeError as e:
            check("forward-only" in str(e), f"K1 guard {name}: {e}")
        else:
            raise SmokeFailure(f"K1 guard: {name} under grad did not raise")
    reset_counts()
    box2d_iou(tb, tb.detach(), method="rbox").sum().backward()
    check(bool(torch.isfinite(tb.grad).all()) and read_counts() ==
          NO_LAUNCHES, "box2d_iou precise=True: no finite gradient")
    with torch.no_grad():
        check(geometry_cuda.rbox_iou_matrix(tb, tb).shape == (64, 64),
              "K1 under no_grad")
    log("K1 under grad: rbox_iou_matrix and box2d_iou(precise=False) raise; "
        "precise=True gives finite gradients")


# ---------------------------------------------------------------------------
# kitti_eval: KITTI frames in, Target3DArray out, both evaluators on the card
# ---------------------------------------------------------------------------

# tests/kitti_fixture.py's calibration (velodyne FLU -> camera RDF, R0_rect
# the identity), copied: this script imports nothing of the tests
KITTI_TR_VELO_TO_CAM = np.array([[0.0, -1.0, 0.0, 0.0],
                                 [0.0, 0.0, -1.0, -0.08],
                                 [1.0, 0.0, 0.0, -0.27]])
KITTI_P_BASE = np.array([[721.5, 0.0, 609.5, 0.0], [0.0, 721.5, 172.8, 0.0],
                         [0.0, 0.0, 1.0, 0.0]])
KITTI_FRAMES = 8
# the KITTI val split's frame count (the 3DOP split, OpenPCDet's
# kitti_infos_val), evaluated in chunks of 512 frames
KITTI_VAL_FRAMES = 3769
EVAL_CHUNK = 512
# KITTI's Car 3D IoU threshold, and the looser one of tests/test_end_to_end
EVAL_OVERLAPS = (0.7, 0.5)
EVAL_COUNTERS = ("ndt", "tp", "fp", "fn")
EVAL_ACCURACIES = ("acc_iou", "acc_dist", "acc_box", "acc_angular",
                   "acc_var")


def kitti_calib_text():
    rows = [("P%d" % i, KITTI_P_BASE + [[0, 0, 0, -40.0 * i], [0] * 4,
                                        [0] * 4]) for i in range(4)]
    rows += [("R0_rect", np.eye(3)), ("Tr_velo_to_cam", KITTI_TR_VELO_TO_CAM),
             ("Tr_imu_to_velo", np.hstack([np.eye(3), [[0.8], [-0.3],
                                                       [0.9]]]))]
    return "".join("%s: %s\n" % (k, " ".join("%.12e" % v for v in m.ravel()))
                   for k, m in rows)


def kitti_label_text(boxes):
    """KITTI label lines of sensor-frame cars (x, y, z, l, w, h, yaw): h w
    l, the bottom centre in the rectified camera frame and rotation_y =
    -yaw - pi/2, with 8 decimals; then one DontCare line."""
    rot, t = KITTI_TR_VELO_TO_CAM[:, :3], KITTI_TR_VELO_TO_CAM[:, 3]
    lines = []
    for x, y, z, ln, w, h, yaw in boxes:
        cx, cy, cz = rot @ [x, y, z] + t
        ry = math.remainder(-yaw - math.pi / 2, 2 * math.pi)
        lines.append("Car 0.00 0 0.00 100.00 100.00 200.00 200.00 "
                     + " ".join("%.8f" % v
                                for v in (h, w, ln, cx, cy + h / 2, cz, ry)))
    lines.append("DontCare -1 -1 -10 500.00 150.00 560.00 190.00 -1 -1 -1 "
                 "-1000 -1000 -1000 -10")
    return "\n".join(lines) + "\n"


def write_kitti_split(root):
    """A KITTI object training split of KITTI_FRAMES KITTI-like frames
    (``kitti_like_points``, seeds 600-607) under ``root``: calib, label_2
    (the frames' 16 cars and a DontCare) and velodyne; no images. Returns
    each frame's car boxes."""
    for sub in ("calib", "label_2", "velodyne"):
        (root / "training" / sub).mkdir(parents=True)
    boxes = []
    for i in range(KITTI_FRAMES):
        pts, cars = kitti_like_points(600 + i, with_boxes=True)
        name = "%06d" % i
        (root / "training" / "calib" / f"{name}.txt").write_text(
            kitti_calib_text())
        (root / "training" / "label_2" / f"{name}.txt").write_text(
            kitti_label_text(cars))
        pts.tofile(root / "training" / "velodyne" / f"{name}.bin")
        boxes.append(cars)
    return boxes


def load_kitti_split(root, boxes):
    """The split through the port's KittiObjectLoader: each frame's points
    and labels, the labels held to the boxes they were written from
    (1e-4 m, 1e-5 rad)."""
    from d3d_tpu_torch.dataset.kitti import KittiObjectLoader

    loader = KittiObjectLoader(root, trainval_split=1.0)
    check(len(loader) == KITTI_FRAMES, f"loader: {len(loader)} frames")
    frames, err = [], [0.0, 0.0, 0.0]
    for i, want in enumerate(boxes):
        gt = loader.annotation_3dobject(i)
        c = gt.columns()
        check(len(gt) == len(want) and gt.frame == "velo"
              and gt.dontcare.shape == (1, 4),
              f"frame {i}: {len(gt)} labels, {gt.dontcare.shape} DontCare")
        dyaw = np.remainder(c["yaw"] - want[:, 6] + math.pi, 2 * math.pi)
        for j, e in enumerate((np.abs(c["position"] - want[:, :3]).max(),
                               np.abs(c["dimension"] - want[:, 3:6]).max(),
                               np.abs(dyaw - math.pi).max())):
            err[j] = max(err[j], float(e))
        frames.append((loader.lidar_data(i), gt))
    check(err[0] <= 1e-4 and err[1] <= 1e-4 and err[2] <= 1e-5,
          f"labels against their boxes: position {err[0]} m, size {err[1]} "
          f"m, yaw {err[2]} rad")
    return frames, err


def stand_in_detections(rng, gt, dev, jitter=0.05, n_noise=6):
    """tests/test_end_to_end.py's stand-in detector: each GT jittered
    (score 0.7-0.95) and duplicated (0.3-0.5), plus low-scored noise cars,
    then box2d_nms(iou_method="rbox", precise=False) on ``dev``; its keep
    mask must equal the same call's on the CPU."""
    from d3d_tpu_torch.abstraction import Target3DArray
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass
    from d3d_tpu_torch.ops.box import box2d_nms

    c = gt.columns()
    n = len(gt)
    pos = c["position"] + rng.normal(0, jitter, (n, 3))
    dim = c["dimension"] * (1 + rng.normal(0, jitter / 2, (n, 3)))
    yaw = c["yaw"] + rng.normal(0, 0.02, n)
    dets = Target3DArray.from_columns(
        np.concatenate([pos, pos + rng.normal(0, jitter, (n, 3)),
                        rng.uniform([0, -20, -2], [50, 20, 0],
                                    (n_noise, 3))]),
        np.concatenate([dim, dim, np.tile([4.0, 1.8, 1.6], (n_noise, 1))]),
        yaws=np.concatenate([yaw, yaw, rng.uniform(-np.pi, np.pi,
                                                   n_noise)]),
        labels=np.full(2 * n + n_noise, KittiObjectClass.Car.value),
        scores=np.concatenate([rng.uniform(0.7, 0.95, n),
                               rng.uniform(0.3, 0.5, n),
                               rng.uniform(0.05, 0.2, n_noise)]),
        mapping=KittiObjectClass, frame="velo")
    rows = dets.to_numpy()
    bev = np.ascontiguousarray(rows[:, [2, 3, 5, 6, 8]])  # float32
    keep = [box2d_nms(bev, rows[:, 1], iou_method="rbox", iou_threshold=0.1,
                      precise=False, device=d) for d in (dev, "cpu")]
    check(np.array_equal(keep[0], keep[1]), "stand-in NMS: card vs CPU")
    check(keep[0].sum() < len(dets), "stand-in NMS removed nothing")
    return Target3DArray([d for d, k in zip(dets, keep[0]) if k],
                         frame="velo")


def same_stats(name, a, b, rtol=1e-5):
    """Two DetectionEvalStats count the same, and their accuracies agree
    to ``rtol`` relative (or are non-finite on both). Returns the largest
    relative difference of the accuracies."""
    worst = 0.0
    for k in a.ngt:
        check(a.ngt[k] == b.ngt[k], f"{name}: ngt {a.ngt[k]} vs {b.ngt[k]}")
        for fld in EVAL_COUNTERS:
            check(np.array_equal(getattr(a, fld)[k], getattr(b, fld)[k]),
                  f"{name}: {fld} differs")
        for fld in EVAL_ACCURACIES:
            x, y = getattr(a, fld)[k], getattr(b, fld)[k]
            fin = np.isfinite(x)
            check(np.array_equal(fin, np.isfinite(y))
                  and np.array_equal(np.isnan(x), np.isnan(y)),
                  f"{name}: {fld} finite entries differ")
            if fin.any():
                rel = np.abs(x[fin] - y[fin]) / np.maximum(np.abs(y[fin]),
                                                           1e-30)
                worst = max(worst, float(rel.max()))
    check(worst <= rtol, f"{name}: accuracies differ by {worst} relative")
    return worst


def merged_host_stats(ev, gts, dets):
    """calc_stats over the frames, merged; and the host ms of each call."""
    ev.reset()
    ms = []
    for gt, dt in zip(gts, dets):
        t0 = time.perf_counter()
        stats = ev.calc_stats(gt, dt)
        ms.append((time.perf_counter() - t0) * 1e3)
        ev.add_stats(stats)
    return ev.get_stats(), ms


def evaluate_on_card_and_cpu(name, gts, dets, dev):
    """DetectionEvaluator([Car], t) for t in EVAL_OVERLAPS, by calc_stats
    and by device_calc_stats, on the card and with device="cpu": every
    pair equal (counters exact, accuracies 1e-5 relative), host and device
    counters equal. Returns per threshold the AP(Car), the host ms per
    frame and the device call's ms."""
    from d3d_tpu_torch.benchmarks import DetectionEvaluator
    from d3d_tpu_torch.benchmarks_device import device_calc_stats
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass

    car = KittiObjectClass.Car
    out = {}
    for overlap in EVAL_OVERLAPS:
        evs = {"card": DetectionEvaluator([car], overlap, device=dev),
               "cpu": DetectionEvaluator([car], overlap, device="cpu")}
        host = {k: merged_host_stats(ev, gts, dets) for k, ev in evs.items()}
        device, device_ms = {}, {}
        for k, ev in evs.items():
            t0 = time.perf_counter()
            device[k] = device_calc_stats(ev, gts, dets)
            device_ms[k] = (time.perf_counter() - t0) * 1e3
        err = max(same_stats(f"{name} {overlap} calc_stats card vs CPU",
                             host["card"][0], host["cpu"][0]),
                  same_stats(f"{name} {overlap} device_calc_stats card vs "
                             "CPU", device["card"], device["cpu"]))
        for k in device["card"].ngt:
            for fld in EVAL_COUNTERS:
                check(np.array_equal(getattr(host["card"][0], fld)[k],
                                     getattr(device["card"], fld)[k]),
                      f"{name} {overlap}: host and device {fld} differ")
        ev = evs["card"]
        ev.reset()
        ev.add_stats(device["card"])
        out[overlap] = dict(
            ap=float(ev.ap()[car]), gt=int(device["card"].ngt[car.value]),
            tp_at_half=int(ev.tp(0.5)[car]), fp_at_half=int(ev.fp(0.5)[car]),
            calc_stats_ms_per_frame=statistics.median(host["card"][1]),
            cpu_calc_stats_ms_per_frame=statistics.median(host["cpu"][1]),
            device_calc_stats_ms=device_ms["card"],
            cpu_device_calc_stats_ms=device_ms["cpu"],
            max_rel_err_card_vs_cpu=err)
    return out


def kitti_official_card_vs_cpu(name, gts, dets, dev):
    """kitti_official_summary (Car, bev and 3d, every difficulty) on the
    card and with device="cpu": the same table, and every cell's counts
    at each recall threshold, thresholds and APs equal. Returns the card's
    AP_R40 and AP_R11 per metric and difficulty and the ms of each call."""
    from d3d_tpu_torch.benchmarks_kitti import kitti_official_summary
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass

    car = KittiObjectClass.Car
    res, ms = {}, {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        res[d] = kitti_official_summary(gts, dets, [car], metrics=("bev",
                                                                   "3d"),
                                        device=d)
        ms["card" if d == dev else "cpu"] = (time.perf_counter() - t0) * 1e3
    check(res[dev][0] == res["cpu"][0],
          f"{name} KITTI official table card vs CPU:\n{res[dev][0]}\n"
          f"{res['cpu'][0]}")
    out = {}
    for metric in ("bev", "3d"):
        for diff in range(3):
            a, b = res[dev][1][car][metric][diff], res["cpu"][1][car][
                metric][diff]
            for key in ("tp", "fp", "fn", "precision"):
                check(np.array_equal(a[key], b[key]),
                      f"{name} KITTI official {metric} {diff}: {key}")
            check(a["ap_r40"] == b["ap_r40"] and a["ap_r11"] == b["ap_r11"]
                  and list(a["thresholds"]) == list(b["thresholds"]),
                  f"{name} KITTI official {metric} {diff}: APs differ")
            out[f"{metric}_{diff}"] = dict(ap_r40=a["ap_r40"],
                                           ap_r11=a["ap_r11"])
    out["ms"] = ms
    log(f"kitti_eval {name}: KITTI official AP_R40 (Car, easy/mod/hard) "
        + "; ".join(f"{m} " + "/".join(f"{out[f'{m}_{d}']['ap_r40']:.4f}"
                                       for d in range(3))
                    for m in ("bev", "3d"))
        + f", card equal to CPU ({ms['card']:.0f} ms on the card, "
        f"{ms['cpu']:.0f} ms on the CPU)")
    return out


def waymo_card_vs_cpu(gts, dets, clouds, dev):
    """evaluate_waymo_detection of the stand-in (Car at 0.7, LEVEL_1/2 by
    range, the boxes' point counts from the clouds by crop_points on the
    evaluators' device) on the card and on the CPU: every stratum's
    counters equal. Returns the card's AP and APH per stratum."""
    from d3d_tpu_torch.benchmarks import DetectionEvaluator
    from d3d_tpu_torch.benchmarks_waymo import evaluate_waymo_detection
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass

    car = KittiObjectClass.Car
    res = {d: evaluate_waymo_detection(
        lambda: DetectionEvaluator([car], 0.7, device=d), gts, dets,
        clouds=clouds) for d in (dev, "cpu")}
    check(list(res[dev]) == list(res["cpu"]), "Waymo strata differ")
    out = {}
    for name, ev in res[dev].items():
        same_stats(f"Waymo {name} card vs CPU", ev.get_stats(),
                   res["cpu"][name].get_stats())
        check(ev.ap() == res["cpu"][name].ap(), f"Waymo {name}: AP differs")
        out[name] = dict(ap=float(ev.ap()[car]), aph=float(ev.aph()[car]))
    log("kitti_eval stand-in, Waymo protocol (point counts from the "
        "clouds): " + "; ".join(f"{n} AP {v['ap']:.4f} APH {v['aph']:.4f}"
                                for n, v in out.items())
        + "; card equal to CPU")
    return out


def kitti_eval(dev, second, pp_detect):
    """The kitti_eval path: a synthetic KITTI split written and loaded with
    the port's KittiObjectLoader, three detectors (SECOND and PointPillars
    at full width, seeded weights; the stand-in) returning Target3DArrays,
    and both evaluators on the card, each held to its CPU run. Every
    count is set to 0 before the path and read after: K1's bit form, the
    scan and K5 with its rule books must have launched."""
    import tempfile

    from d3d_tpu_torch.models import head_config, make_anchors
    from d3d_tpu_torch.models import make_second_detector

    second_detect = make_second_detector(
        second, None, second.cfg,
        make_anchors(head_config(second.cfg), device=dev), car_classes(),
        device=dev)
    rng = np.random.default_rng(800)
    stats = {}
    reset_counts()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        frames, label_err = load_kitti_split(root, write_kitti_split(root))
        stats["load_s"] = time.perf_counter() - t0
        gts = [gt for _, gt in frames]
        dets = {"second": [], "pointpillars": [], "stand_in": []}
        for pts, gt in frames:
            for name, det in (("second", second_detect),
                              ("pointpillars", pp_detect)):
                out = det(pts, frame="velo")
                check_detections(f"kitti_eval {name}", out, frame="velo")
                dets[name].append(out)
            dets["stand_in"].append(stand_in_detections(rng, gt, dev))
        counts = read_counts()
        for name, arrays in dets.items():
            stats[name] = evaluate_on_card_and_cpu(name, gts, arrays, dev)
        official = {name: kitti_official_card_vs_cpu(name, gts, dets[name],
                                                     dev)
                    for name in ("second", "stand_in")}
        waymo = waymo_card_vs_cpu(gts, dets["stand_in"],
                                  [pts for pts, _ in frames], dev)
    for overlap in EVAL_OVERLAPS:
        check(stats["stand_in"][overlap]["ap"] > 0.85,
              f"stand-in AP(Car) at {overlap}: "
              f"{stats['stand_in'][overlap]['ap']}")
    want = dict(rbox_iou_matrix=3 * KITTI_FRAMES, nms_scan=3 * KITTI_FRAMES,
                subm_conv=len(K5_LAYERS) * KITTI_FRAMES,
                subm_conv_rulebook=KITTI_FRAMES,
                build_stage_maps=KITTI_FRAMES)
    check(all(counts[k] == v for k, v in want.items()),
          f"kitti_eval launches {counts}, want {want}: K1's bit form and "
          "the scan per detector and frame, SECOND's K5 layers")
    routes = check_nms_routes("kitti_eval", 3 * KITTI_FRAMES)
    stats.update(label_err=dict(zip(("position_m", "size_m", "yaw_rad"),
                                    label_err)), launches=counts,
                 routes=routes, kitti_official=official,
                 waymo_stand_in=waymo)
    log(f"kitti_eval: {KITTI_FRAMES} frames loaded, labels within "
        f"{label_err} of their boxes; launches {counts}; "
        + "; ".join(f"{name} AP(Car) " + ", ".join(
            f"{o}: {v['ap']:.4f}" for o, v in stats[name].items())
            for name in dets))
    return counts, stats


def val_scale_frames(seed=7):
    """KITTI_VAL_FRAMES seeded frames at the KITTI val split's scale: 1-20
    GT cars a frame, 1-100 detections (the detectors' top_k; the first
    ones jittered GT, scored 0.4-1, the others 0-0.6), variances on half
    the detections."""
    from d3d_tpu_torch.abstraction import Target3DArray
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass

    car = KittiObjectClass.Car.value
    rng = np.random.default_rng(seed)
    lo, hi = [3.5, 1.5, 1.4], [4.5, 1.9, 1.7]
    gts, dts = [], []
    for _ in range(KITTI_VAL_FRAMES):
        ng, nd = int(rng.integers(1, 21)), int(rng.integers(1, 101))
        pos = rng.uniform([5, -30, -2], [65, 30, -1], (ng, 3))
        dim = rng.uniform(lo, hi, (ng, 3))
        yaw = rng.uniform(-np.pi, np.pi, ng)
        gts.append(Target3DArray.from_columns(
            pos, dim, yaws=yaw, labels=np.full(ng, car), scores=np.ones(ng),
            mapping=KittiObjectClass, frame="velo"))
        m = min(ng, nd)
        var = rng.random(nd) < 0.5
        eye = np.eye(3)[None]
        dts.append(Target3DArray.from_columns(
            np.concatenate([pos[:m] + rng.normal(0, 0.2, (m, 3)),
                            rng.uniform([0, -40, -3], [70, 40, 1],
                                        (nd - m, 3))]),
            np.concatenate([dim[:m] * rng.uniform(0.9, 1.1, (m, 3)),
                            rng.uniform(lo, hi, (nd - m, 3))]),
            yaws=np.concatenate([yaw[:m] + rng.normal(0, 0.05, m),
                                 rng.uniform(-np.pi, np.pi, nd - m)]),
            labels=np.full(nd, car),
            scores=np.concatenate([rng.uniform(0.4, 1.0, m),
                                   rng.uniform(0.0, 0.6, nd - m)]),
            position_vars=eye * rng.uniform(0.05, 0.5, (nd, 1, 1))
            * var[:, None, None],
            dimension_vars=eye * rng.uniform(0.05, 0.5, (nd, 1, 1))
            * var[:, None, None],
            orientation_vars=np.where(var, rng.uniform(0.05, 1.0, nd), 0.0),
            mapping=KittiObjectClass, frame="velo"))
    return gts, dts


def eval_at_scale(dev):
    """device_calc_stats over the KITTI val split's 3 769 frames (chunks of
    512): the call's host time, its packing by the host clock and
    eval_frames_device's chunks by CUDA events, the peak device memory,
    and one chunk split into its IoU tables, match loop and the rest, with
    its kernel time by CUPTI. The first 512 frames' stats must equal the
    CPU's (counters exact, accuracies 1e-5 relative)."""
    from d3d_tpu_torch import benchmarks_device as bd
    from d3d_tpu_torch.benchmarks import DetectionEvaluator
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass

    car = KittiObjectClass.Car
    t0 = time.perf_counter()
    gts, dts = val_scale_frames()
    make_s = time.perf_counter() - t0
    ev = DetectionEvaluator([car], EVAL_OVERLAPS[0], device=dev)
    chunk_ms, pack_ms = [], []
    plain_eval, plain_pack = bd.eval_frames_device, bd.pack_frames

    def timed_eval(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = plain_eval(*args, **kw)
        end.record()
        end.synchronize()
        chunk_ms.append(start.elapsed_time(end))
        return out

    def timed_pack(*args, **kw):
        t0 = time.perf_counter()
        out = plain_pack(*args, **kw)
        pack_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    bd.device_calc_stats(ev, gts[:EVAL_CHUNK], dts[:EVAL_CHUNK])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bd.eval_frames_device, bd.pack_frames = timed_eval, timed_pack
    try:
        t0 = time.perf_counter()
        full = bd.device_calc_stats(ev, gts, dts, chunk_frames=EVAL_CHUNK)
        call_s = time.perf_counter() - t0
    finally:
        bd.eval_frames_device, bd.pack_frames = plain_eval, plain_pack
    peak = torch.cuda.max_memory_allocated()
    check(sum(full.ngt.values()) == sum(len(g) for g in gts),
          "eval_at_scale: ngt is not the GT count")

    # one chunk's phases
    packed = bd.pack_frames(gts[:EVAL_CHUNK], dts[:EVAL_CHUNK], [car.value])
    md, strict = bd.max_dist_arrays(ev)
    thr = np.ascontiguousarray(ev._pr_thresholds, np.float32)
    steps = int((packed["dt_label"] >= 0).sum(-1).max())
    p = {k: torch.as_tensor(v, device=dev) for k, v in packed.items()}
    valid = p["gt_label"] >= 0
    md_t, strict_t = (torch.as_tensor(a, device=dev) for a in (md, strict))
    tables = bd._matching_tables(p["dt_box"], p["gt_box"], p["gt_label"],
                                 valid, md_t, strict_t)
    m_all = ((p["dt_label"] >= 0)[:, None, :]
             & (p["dt_score"][:, None, :]
                >= torch.as_tensor(thr, device=dev)[None, :, None]))
    phase_ms = dict(
        total=time_each(lambda: bd.eval_frames_device(
            packed, thr, md, strict, 1, device=dev), 3, warmup=1),
        iou_tables=time_each(lambda: bd._matching_tables(
            p["dt_box"], p["gt_box"], p["gt_label"], valid, md_t,
            strict_t), 3, warmup=1),
        match_loop=time_each(lambda: bd._greedy_match_masked(
            tables[1], tables[2], m_all, p["dt_label"], p["dt_score"],
            p["gt_label"], valid, steps), 3, warmup=1))
    phase_ms["rest"] = (phase_ms["total"] - phase_ms["iou_tables"]
                        - phase_ms["match_loop"])
    # the chunk's kernel time (CUPTI): the card's busy share of its events
    kernel_ms = cupti_ms(lambda: bd.eval_frames_device(
        packed, thr, md, strict, 1, device=dev), reps=3)
    # the first chunk, card vs CPU: last, as the CPU run's worker
    # threads keep cores busy for a while after it
    card = bd.device_calc_stats(ev, gts[:EVAL_CHUNK], dts[:EVAL_CHUNK])
    t0 = time.perf_counter()
    cpu = bd.device_calc_stats(
        DetectionEvaluator([car], EVAL_OVERLAPS[0], device="cpu"),
        gts[:EVAL_CHUNK], dts[:EVAL_CHUNK])
    cpu_s = time.perf_counter() - t0
    err = same_stats("val-scale first chunk card vs CPU", card, cpu)

    shape = dict(frames=EVAL_CHUNK, thresholds=len(thr),
                 dt_pad=packed["dt_label"].shape[1],
                 gt_pad=packed["gt_label"].shape[1], match_steps=steps)
    ev.reset()
    ev.add_stats(full)
    out = dict(frames=KITTI_VAL_FRAMES, chunk=EVAL_CHUNK,
               gt=sum(len(g) for g in gts), dt=sum(len(d) for d in dts),
               make_frames_s=make_s, call_s=call_s, chunk_ms=chunk_ms,
               peak_mib=peak / 2 ** 20, ap=float(ev.ap()[car]),
               cpu_frames_compared=EVAL_CHUNK, cpu_chunk_s=cpu_s,
               max_rel_err_card_vs_cpu=err, pack_ms=pack_ms,
               chunk_phase_ms=phase_ms, chunk_kernel_ms=kernel_ms,
               chunk_shape=shape)
    log(f"kitti_eval at the val split's scale: {KITTI_VAL_FRAMES} frames "
        f"({out['gt']} GT, {out['dt']} detections) in {call_s:.3f} s "
        f"(chunks {', '.join(f'{t:.1f}' for t in chunk_ms)} ms by events), "
        f"peak {out['peak_mib']:.0f} MiB; packing in the call "
        f"{sum(pack_ms):.0f} ms (host); one chunk: " + ", ".join(
            f"{k} {v:.2f} ms" for k, v in phase_ms.items())
        + f", kernels {kernel_ms} ms (CUPTI) {shape}; the first "
        f"{EVAL_CHUNK} frames equal the CPU's ({cpu_s:.1f} s there)")
    return out


# ---------------------------------------------------------------------------
# pointpillars_train: PointPillars training end to end on the card, and the
# serving tail of a trained model (folding, int8 weights, flip TTA)
# ---------------------------------------------------------------------------

PP_STEPS = 5
PP_BATCH = 2
PP_MAX_GT = 32      # examples/train_pointpillars.py's MAX_GT
PP_CKPT_STEP = 3
PP_MAX_PER_CLASS = 20
# tests/test_torch_pointpillars_train.py's bfloat16 bound at full width:
# 16 bfloat16 layers on the longest path, sums of up to 9 x 256 terms
PP_BF16_DEPTH, PP_BF16_WIDTH = 16, 9 * 256
PP_TTA_MODES = ("none", "flip_y")


def bf16_bound(depth, width):
    """The bfloat16 network's error relative to the largest float32 output
    (tests/test_torch_pointpillars_train.py): ``D (2^-8 + K 2^-24)``."""
    return depth * (2.0 ** -8 + width * 2.0 ** -24)


def pp_train_frames():
    """The 8 KITTI-like frames written as a KITTI object split
    (``write_kitti_split``) and read back by the port's KittiObjectLoader:
    (points (N, 4) f32, boxes (M, 7) f32, labels (M,)) a frame, and the
    frames' Target3DArrays."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        root = Path(tmp)
        loaded, _ = load_kitti_split(root, write_kitti_split(root))
    frames = []
    for pts, gt in loaded:
        c = gt.columns()
        boxes = np.concatenate([c["position"], c["dimension"],
                                c["yaw"][:, None]], 1).astype(np.float32)
        frames.append((np.asarray(pts, np.float32)[:, :4], boxes,
                       np.zeros(len(boxes), np.int64)))
    return frames, [gt for _, gt in loaded]


def pp_augmented(dev, cfg, frames, db, seed, count):
    """``count`` training frames, cycling over ``frames``: GT sampling
    (``sample_ground_truths``, numpy generator ``seed``), the boxes padded
    to PP_MAX_GT, then on the card ``perobject_augment`` (K1 twice) and
    ``global_augment`` (a CUDA generator ``seed``) and ``pillarize``."""
    from d3d_tpu_torch.augment import (global_augment, perobject_augment,
                                       sample_ground_truths)
    from d3d_tpu_torch.models import pillarize

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for i in range(count):
        pts, boxes, labels = sample_ground_truths(
            rng, db, *frames[i % len(frames)],
            max_per_class=PP_MAX_PER_CLASS, device=dev)
        m = min(len(boxes), PP_MAX_GT)
        gt = np.zeros((PP_MAX_GT, 7), np.float32)
        gt[:m] = boxes[:m]
        mask = torch.from_numpy(np.arange(PP_MAX_GT) < m).to(dev)
        p, g = perobject_augment(gen, torch.from_numpy(pts).to(dev),
                                 torch.from_numpy(gt).to(dev), mask)
        p, g = global_augment(gen, p, g)
        f, c, v = pillarize(p, cfg)
        yield dict(features=f, coords=c, valid=v, gt_boxes=g,
                   gt_labels=torch.zeros(PP_MAX_GT, dtype=torch.int32,
                                         device=dev), gt_mask=mask)


def pp_run(dev, cfg, state, frames, db, seed, ckpt=None, eval_fn=None,
           steps=PP_STEPS, profiled=False):
    """One Trainer run of ``steps`` steps of batch PP_BATCH from ``state``:
    make_optimizer over PP_STEPS, make_train_step(external_targets=True),
    ``batch_frames`` of ``pp_augmented`` inside ``prefetch``, a
    ``prepare_targets(dense=True)`` prep_fn, ``ema_update`` after each
    step, checkpoints every PP_CKPT_STEP steps into ``ckpt``, ``eval_fn``
    at the last step (``eval_fn(step, model, ema)``, with the EMA tree);
    ``profiled`` runs the Trainer under torch.profiler (CUDA activity) for
    the card's busy share. Returns (model, optimizer, record): per step
    the loss terms, CUDA events around the step and its host start time,
    the prepped batches, the run's wall clock and busy share."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from d3d_tpu_torch.models import (PointPillars, make_anchors,
                                      prepare_targets)
    from d3d_tpu_torch.models.pointpillars import make_train_step
    from d3d_tpu_torch.train import (Trainer, batch_frames, ema_init,
                                     ema_update, make_optimizer, prefetch)

    model = PointPillars(cfg, device=dev)
    model.load_state_dict(state)
    opt, _ = make_optimizer(model.parameters(), steps)
    anchors = make_anchors(cfg, device=dev)
    train_step = make_train_step(model, opt, cfg, anchors,
                                 external_targets=True)
    ema = ema_init(model)
    rec = dict(aux=[], events=[], host=[], batches=[])

    def step(batch):
        rec["host"].append(time.perf_counter())
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        aux = train_step(batch)
        ema_update(ema, model, step=len(rec["aux"]))
        ev[1].record()
        rec["aux"].append(aux)
        rec["events"].append(ev)
        rec["batches"].append(batch)
        return aux

    trainer = Trainer(
        step, prep_fn=lambda b: prepare_targets(anchors, b, cfg=cfg,
                                                dense=True),
        checkpointer=ckpt, log_every=steps, ckpt_every=PP_CKPT_STEP,
        log_fn=log, eval_every=steps if eval_fn else 0,
        eval_fn=eval_fn and (lambda step, m: eval_fn(step, m, ema)))
    batches = prefetch(batch_frames(
        pp_augmented(dev, cfg, frames, db, seed, PP_BATCH * steps),
        PP_BATCH), depth=2)
    with (profile(activities=[ProfilerActivity.CUDA]) if profiled
          else contextlib.nullcontext()) as prof:
        t0 = time.perf_counter()
        check(trainer.run(model, opt, batches) == steps,
              f"pointpillars_train {cfg.dtype}: the Trainer stopped early")
        torch.cuda.synchronize()
        rec["run_s"] = time.perf_counter() - t0
    rec["busy_share"] = busy_share(prof, rec["run_s"]) if profiled else None
    rec["losses"] = [{k: float(v) for k, v in a.items()} for a in rec["aux"]]
    rec["step_ms"] = [s.elapsed_time(e) for s, e in rec["events"]]
    return model, opt, rec


def pp_check_run(name, rec, counts, want):
    totals = [l["total"] for l in rec["losses"]]
    check(all(math.isfinite(v) for l in rec["losses"] for v in l.values()),
          f"{name}: a loss is not finite: {rec['losses']}")
    check(totals[-1] < totals[0], f"{name}: loss did not fall: {totals}")
    routes = read_routes()
    got = dict(k1_matrix=routes["k1_matrix"], k1_bits=routes["k1_bits"],
               nms_scan=counts["nms_scan"],
               rbox_iou_matrix=counts["rbox_iou_matrix"])
    check(got == want and counts["subm_conv"] == 0
          and counts["soft_nms_scan"] == 0,
          f"{name}: launches {got}, want {want}; all counts {counts}")
    steady = statistics.median(rec["step_ms"][1:])
    wall = statistics.median(np.diff(rec["host"]))
    log(f"{name}: losses " + ", ".join(f"{t:.4f}" for t in totals)
        + f"; step {rec['step_ms'][0]:.2f} ms first, {steady:.2f} ms median "
        f"of steps 2-{PP_STEPS} (CUDA events, with ema_update); Trainer "
        f"wall clock {wall * 1e3:.2f} ms a step (median of the host "
        f"intervals between step starts); run {rec['run_s']:.2f} s; "
        f"launches {got}")
    return dict(losses=totals, loss_terms=rec["losses"][-1],
                step_ms=rec["step_ms"], steady_ms=steady,
                trainer_wall_ms=wall * 1e3, run_s=rec["run_s"],
                launches=got)


def pp_stage_times(model, opt, batch, cfg, reps=4):
    """A train step cut into stages (prep: prepare_targets dense, forward,
    loss, backward, optimizer), device ms between CUDA events, median of
    ``reps`` steps on one batch."""
    from d3d_tpu_torch.models import make_anchors, prepare_targets
    from d3d_tpu_torch.models.pointpillars import detection_loss

    anchors = make_anchors(cfg, device=batch["features"].device)
    raw = {k: v for k, v in batch.items() if k != "targets"}
    names = ("prep", "forward", "loss", "backward", "optimizer")
    times = {n: [] for n in names}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        targets = prepare_targets(anchors, raw, cfg=cfg,
                                  dense=True)["targets"]
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        out = model(raw["features"], raw["coords"], raw["valid"], train=True)
        ev[2].record()
        loss, _ = detection_loss(out, targets, cfg, anchors)
        ev[3].record()
        loss.backward()
        ev[4].record()
        opt.step()
        ev[5].record()
        ev[5].synchronize()
        for i, n in enumerate(names):
            times[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(t) for n, t in times.items()}


def busy_share(prof, wall_s):
    """The card's busy share over a profiled stretch of ``wall_s`` seconds:
    the union of the trace's device activity intervals (kernels, copies
    and sets, on every stream; overlap counted once) over the wall clock.
    A ``record_function`` range (the port's ``d3d.*`` spans, the
    optimizer's step) is mirrored on the device's timeline over the
    kernels it encloses: it is no work of the card's, so a device event
    that is a user annotation, or shares its name with a host event, is
    left out. Reads the raw trace events: key_averages() would take tens
    of seconds over a Trainer run's ~10^5 events."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    host = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    spans = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.device_type() == DeviceType.CUDA
                   and not e.is_user_annotation() and e.name() not in host)
    busy_ns, end = 0, None
    for s0, s1 in spans:
        if end is None or s0 >= end:
            busy_ns, end = busy_ns + s1 - s0, s1
        elif s1 > end:
            busy_ns, end = busy_ns + s1 - end, s1
    return busy_ns / 1e9 / wall_s if busy_ns else None


def pp_input_times(dev, cfg, frames, db, count=4):
    """The input pipeline's time a frame, as ``pp_augmented`` makes one,
    on the main thread alone: GT sampling (host clock, its float64 IoUs
    on the card included) and the card's part (perobject_augment,
    global_augment, pillarize; host clock to a synchronise). Medians of
    ``count`` frames."""
    from d3d_tpu_torch.augment import (global_augment, perobject_augment,
                                       sample_ground_truths)
    from d3d_tpu_torch.models import pillarize

    rng = np.random.default_rng(970)
    gen = torch.Generator(device=dev).manual_seed(970)
    sample_ms, device_ms, gts = [], [], []
    for i in range(count):
        t0 = time.perf_counter()
        pts, boxes, _ = sample_ground_truths(
            rng, db, *frames[i % len(frames)],
            max_per_class=PP_MAX_PER_CLASS, device=dev)
        t1 = time.perf_counter()
        gt = np.zeros((PP_MAX_GT, 7), np.float32)
        gt[:min(len(boxes), PP_MAX_GT)] = boxes[:PP_MAX_GT]
        mask = torch.from_numpy(np.arange(PP_MAX_GT) < len(boxes)).to(dev)
        gts.append(torch.from_numpy(gt).to(dev))
        p, g = perobject_augment(gen, torch.from_numpy(pts).to(dev), gts[-1],
                                 mask)
        pillarize(global_augment(gen, p, g)[0], cfg)
        torch.cuda.synchronize()
        sample_ms.append((t1 - t0) * 1e3)
        device_ms.append((time.perf_counter() - t1) * 1e3)
    return dict(gt_sampling_ms=statistics.median(sample_ms),
                augment_pillarize_ms=statistics.median(device_ms)), gts


def pp_k1_augment(gts):
    """K1's f32 form at perobject_augment's shape, on the card: for each
    frame's GT boxes as the path pads them (``gts``: (PP_MAX_GT, 7), zero
    rows after the frame's boxes), proposals drawn as perobject_augment
    draws them (its defaults: yaw U(-0.3925, 0.3925), shift N(0, (1, 1,
    0.5))), and both of its matrices, proposals x proposals and proposals
    x originals, held to the plain version by ``k1_case`` (check_k1's
    limits). Times the last frame's proposals x proposals call. Returns
    its stats."""
    from d3d_tpu_torch.models.inference import _bev
    from d3d_tpu_torch.ops import geometry_cuda

    gen = torch.Generator(device=gts[0].device).manual_seed(980)
    worst = 0.0
    for i, g in enumerate(gts):
        m = g.shape[0]
        prop = g.clone()
        prop[:, 6] += torch.empty(m, device=g.device).uniform_(
            -0.3925, 0.3925, generator=gen)
        prop[:, :3] += torch.randn((m, 3), device=g.device, generator=gen) \
            * torch.tensor([1.0, 1.0, 0.5], device=g.device)
        a, b = _bev(prop), _bev(g)
        for name, other in (("proposals x proposals", a),
                            ("proposals x originals", b)):
            err, _ = k1_case(f"augment frame {i} {name} "
                             f"({int((g[:, 3] > 0).sum())} boxes of {m})",
                             a, other)
            worst = max(worst, err)
    return dict(
        ms=time_launches(lambda: geometry_cuda.rbox_iou_matrix(a, a)),
        cupti_ms=cupti_ms(lambda: geometry_cuda.rbox_iou_matrix(a, a)),
        max_abs_err=worst, frames=len(gts), shape=list(a.shape),
        launches_a_step=2 * PP_BATCH)


# one f32 step's gradients against the float64 step, each leaf's max
# error over its largest |g|, card and CPU alike. Readings of
# scripts/torch_pp_train_tolerances.py (NVIDIA H100 80GB HBM3, 700 W):
# over seeds 0-4 (this script's run is seed 0) the card 1.3e-3 to 1.04e-2,
# the CPU 2.7e-3 to 7.0e-3; the planted faults (BatchNorm statistics per
# frame, one transposed leaf) 0.105 or more. The limit is about 3 times
# the largest reading.
PP_GRAD_LIMIT = 3e-2


def pp_grad_runs(dev, cfg, state, batch, runs=("f64", "card", "cpu")):
    """One step from the weights ``state`` on the prepped ``batch``, as
    ``runs`` asks: "f64" the float64 step on the card (the network, its
    BatchNorm statistics, the heads, the loss and so the cotangent in
    float64), "card" the float32 step on the card (TF32 off), "cpu" the
    float32 step on the CPU. Returns ({run: (loss, {leaf: float64
    gradient on the CPU}, model)}, the CPU step's ms)."""
    from d3d_tpu_torch.models import PointPillars, make_anchors
    from d3d_tpu_torch.models.pointpillars import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    where = dict(f64=(dev, "float64"), card=(dev, "float32"),
                 cpu=(torch.device("cpu"), "float32"))
    out, cpu_ms = {}, 0.0
    for name in runs:
        d, dtype = where[name]
        c = dataclasses.replace(cfg, dtype=dtype)
        b = {k: ({t: u.to(d) for t, u in v.items()} if k == "targets"
                 else v.to(d)) for k, v in batch.items()}
        model = PointPillars(c, device=d)
        model.load_state_dict(state)
        opt, _ = make_optimizer(model.parameters(), PP_STEPS)
        step = make_train_step(model, opt, c, make_anchors(c, device=d),
                               external_targets=True)
        t0 = time.perf_counter()
        aux = step(b)
        if d.type == "cpu":
            cpu_ms = (time.perf_counter() - t0) * 1e3
        out[name] = (float(aux["total"]),
                     {n: p.grad.double().cpu()
                      for n, p in model.named_parameters()}, model)
    return out, cpu_ms


def grad_err(grads, ref):
    """The worst leaf's max |g - ref| over its largest |ref|: (error,
    leaf)."""
    worst, at = 0.0, ""
    for leaf, g in grads.items():
        rel = float((g - ref[leaf]).abs().max() / ref[leaf].abs().max())
        if rel > worst:
            worst, at = rel, leaf
    return worst, at


def pp_card_vs_cpu(dev, cfg, state, batch):
    """One f32 step (TF32 off) on the card and on the CPU against the
    float64 step on the card, from the same weights, batch and targets
    (``pp_grad_runs``). At full width card and CPU do not agree to
    SECOND's 1e-4 of each leaf's max: the loss pushes every anchor's
    logit the same way and BatchNorm's backward subtracts that common
    part from each layer's cotangent, which amplifies f32 rounding there
    (cuDNN's FFT convolutions are not ruled out; PERF.md, section 6).
    Held instead: every leaf of the card's step and of the CPU's within
    PP_GRAD_LIMIT of its largest |g| of the float64 step's (set between
    the seeds' readings and planted faults' errors), and the f32 losses
    to rtol 1e-5. Returns (the errors, the CPU step's ms)."""
    runs, cpu_ms = pp_grad_runs(dev, cfg, state, batch)
    ref = runs["f64"][1]
    err = {name: grad_err(runs[name][1], ref) for name in ("card", "cpu")}
    losses = (runs["card"][0], runs["cpu"][0])
    check(all(e <= PP_GRAD_LIMIT for e, _ in err.values()),
          f"PointPillars training gradients against float64: card {err['card']}"
          f", CPU {err['cpu']} of the largest |g|, limit {PP_GRAD_LIMIT}")
    check(abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]),
          f"PointPillars training loss card vs CPU: {losses}")
    log(f"pointpillars_train gradients against the float64 step (f32 TF32 "
        f"off, one step): card {err['card'][0]:.3g} (at {err['card'][1]}), "
        f"CPU {err['cpu'][0]:.3g} (at {err['cpu'][1]}) of each leaf's "
        f"largest |g| (limit {PP_GRAD_LIMIT}); loss {losses[0]:.6f} / "
        f"{losses[1]:.6f}, float64 {runs['f64'][0]:.6f}; the CPU step "
        f"{cpu_ms:.0f} ms")
    return dict(card_vs_f64=err["card"][0], cpu_vs_f64=err["cpu"][0]), cpu_ms


def pp_bf16_bound(dev, cfg32, state, batch):
    """bf16 against f32 (TF32 off) on one batch at full width, training
    forward from the same weights: the loss and each head output within
    ``bf16_bound(16, 2304)`` of the f32 one, relative to its largest
    magnitude. Returns the observed relative errors and the bound."""
    from d3d_tpu_torch.models import PointPillars, make_anchors
    from d3d_tpu_torch.models.pointpillars import detection_loss

    outs, losses = [], []
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(cfg32, dtype=dtype)
        model = PointPillars(cfg, device=dev)
        model.load_state_dict(state)
        with torch.no_grad():
            out = model(batch["features"], batch["coords"], batch["valid"],
                        train=True)
            loss, _ = detection_loss(out, batch["targets"], cfg,
                                     make_anchors(cfg, device=dev))
        outs.append(out)
        losses.append(float(loss))
    limit = bf16_bound(PP_BF16_DEPTH, PP_BF16_WIDTH)
    errs = [float((b - a).abs().max() / a.abs().max())
            for a, b in zip(*outs)]
    loss_err = abs(losses[1] - losses[0]) / abs(losses[0])
    check(max(errs) <= limit and loss_err <= limit,
          f"bf16 vs f32 at full width: heads {errs}, loss {loss_err}, "
          f"bound {limit}")
    log(f"pointpillars_train bf16 vs f32 (one batch, training forward): "
        f"heads {', '.join(f'{e:.3g}' for e in errs)}, loss {loss_err:.3g} "
        f"of the f32 magnitudes; bound D (2^-8 + K 2^-24) = {limit:.4f} "
        f"(D {PP_BF16_DEPTH}, K {PP_BF16_WIDTH})")
    return dict(head_rel_err=errs, loss_rel_err=loss_err, bound=limit)


def pp_resume(dev, cfg, state, ckpt_dir, straight, batches):
    """A second Trainer, given a checkpointer that holds the straight run's
    step-PP_CKPT_STEP checkpoint, restores it into a new model and
    optimizer and runs the straight run's last batches: parameters and
    BatchNorm buffers equal the straight run's, tensor for tensor (cuDNN
    deterministic in both)."""
    import shutil

    from d3d_tpu_torch.checkpoint import TrainCheckpointer
    from d3d_tpu_torch.models import PointPillars, make_anchors
    from d3d_tpu_torch.models.pointpillars import make_train_step
    from d3d_tpu_torch.train import Trainer, make_optimizer

    model = PointPillars(cfg, device=dev)
    model.load_state_dict(state)
    opt, _ = make_optimizer(model.parameters(), PP_STEPS)
    step = make_train_step(model, opt, cfg, make_anchors(cfg, device=dev),
                           external_targets=True)
    resume_dir = ckpt_dir.parent / "resume"
    resume_dir.mkdir()
    shutil.copy(ckpt_dir / f"step_{PP_CKPT_STEP}.pt", resume_dir)
    trainer = Trainer(step, checkpointer=TrainCheckpointer(resume_dir),
                      log_every=0, ckpt_every=0)
    start = trainer.restore_or(model, opt)
    check(start == PP_CKPT_STEP and opt.count == PP_CKPT_STEP,
          f"resume: start {start}, optimizer count {opt.count}")
    check(trainer.run(model, opt, iter(batches), start_step=start)
          == PP_STEPS, "resume: the Trainer stopped early")
    differ = [k for k, v in model.state_dict().items()
              if not torch.equal(v, straight[k])]
    check(not differ, f"resume: {len(differ)} tensors differ from the "
                      f"straight run, e.g. {differ[:3]}")
    log(f"pointpillars_train resume: restored step {start} (optimizer count "
        f"{PP_CKPT_STEP}), ran to {PP_STEPS}: all {len(straight)} tensors of "
        f"the state equal the straight run's")


def pp_augment_card_vs_cpu(dev):
    """perobject_augment's transform on near-touching boxes and
    global_augment's on a bench frame, on the card and the CPU from the
    same draws: the accepted boxes equal (the collision test is IoU > 0,
    so K1 must give +0.0 exactly where the plain version does), the points
    within 2e-5 (CUDA's and the CPU's sin/cos may differ by an ulp); a
    point inside two accepted boxes moves with the first. Returns the
    counts of accepted and rejected boxes and the largest point error."""
    from d3d_tpu_torch import augment

    rng = np.random.default_rng(960)
    a, b = near_touching_boxes(rng, count=16)
    pick = [i * 15 + (i % 5) * 3 + i % 3 for i in range(16)]
    bev = np.concatenate([a[pick], b[pick]])
    boxes = np.concatenate([bev[:, :2], np.full((32, 1), -1.0), bev[:, 2:4],
                            np.full((32, 1), 1.5), bev[:, 4:5]],
                           1).astype(np.float32)
    mask = np.ones(32, bool)
    mask[-2:] = False
    pts = [bench_points(rng, 4000)]
    for bx in boxes:
        c, s = math.cos(bx[6]), math.sin(bx[6])
        loc = rng.uniform(-0.45, 0.45, (40, 3)) * bx[3:6]
        pts.append(np.stack([c * loc[:, 0] - s * loc[:, 1] + bx[0],
                             s * loc[:, 0] + c * loc[:, 1] + bx[1],
                             loc[:, 2] + bx[2], rng.random(40)], 1))
    pts = np.concatenate(pts).astype(np.float32)
    # half the boxes stay put (their near-touching partners decide), half
    # move a little
    dtheta = (rng.uniform(-0.02, 0.02, 32) * (np.arange(32) % 2)).astype(
        np.float32)
    shift = (rng.normal(0, 0.05, (32, 3))
             * (np.arange(32) % 2)[:, None]).astype(np.float32)
    outs = []
    for d in (dev, "cpu"):
        t = [torch.from_numpy(x).to(d) for x in (pts, boxes, mask, dtheta,
                                                   shift)]
        outs.append([o.cpu() for o in augment._perobject_transform(*t)])
    check(torch.equal(outs[0][1], outs[1][1]),
          "perobject_augment card vs CPU: the accepted boxes differ")
    err = float((outs[0][0] - outs[1][0]).abs().max())
    moved = (outs[0][1] != torch.from_numpy(boxes)).any(dim=1)
    accepted, rejected = int(moved.sum()), int((~moved[:30]).sum())

    two = torch.tensor([[0.0, 0.0, -0.5, 4.0, 2.0, 1.6, 0.0],
                        [3.0, 0.0, -0.5, 4.0, 2.0, 1.6, 0.0]])
    inner = torch.from_numpy(np.concatenate([
        rng.uniform([1.1, -0.8, -1.0], [1.9, 0.8, 0.0], (20, 3)),
        rng.random((20, 1))], 1).astype(np.float32))
    draws = (torch.tensor([0.1, -0.2]),
             torch.tensor([[-10.0, 0, 0], [10.0, 0, 0]]))
    first = [augment._perobject_transform(
        inner.to(d), two.to(d), torch.ones(2, dtype=torch.bool, device=d),
        *(x.to(d) for x in draws))[0].cpu() for d in (dev, "cpu")]
    err = max(err, float((first[0] - first[1]).abs().max()))
    check(bool((first[0][:, 0] < -5).all()),
          "perobject_augment: a point in two boxes did not go with the first")

    frame = torch.from_numpy(bench_points(rng))
    gdraws = (torch.tensor(True), torch.tensor(0.3), torch.tensor(1.02),
              torch.tensor([0.1, -0.2, 0.05]))
    glob = [[o.cpu() for o in augment._global_transform(
        frame.to(d), torch.from_numpy(boxes).to(d),
        *(x.to(d) for x in gdraws))] for d in (dev, "cpu")]
    err = max(err, *(float((g - c).abs().max())
                     for g, c in zip(*glob)))
    check(err <= 2e-5, f"augmentation card vs CPU: points differ by {err}")
    log(f"pointpillars_train augmentation card vs CPU: near-touching boxes "
        f"{accepted} accepted, {rejected} rejected, equal; points within "
        f"{err:.3g}; the first owner wins on the card")
    return dict(accepted=accepted, rejected=rejected, max_abs_err=err)


def host_ms(fn, reps=5):
    """Median host ms of ``fn`` (numpy in and out, so each call ends on
    the host) after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# the folded model's raw outputs against the unfolded one's, max |f - b| /
# (1 + |b|), after five f32 steps. Readings of
# scripts/torch_pp_train_tolerances.py (NVIDIA H100 80GB HBM3, 700 W):
# seeds 0-4 1.8e-4 to 1.38e-3 (tests/test_model.py's 2e-4 holds the tiny
# model only), the planted fault (square convolutions scaled along their
# input axis) 5.05 or more. The limit is about 3 times the largest reading.
PP_FOLD_TOL = 4e-3


def fold_rel_err(folded, base):
    """The folded model's raw outputs against the unfolded one's: max |f -
    b| / (1 + |b|) over every output."""
    return max(float(((f - b).abs() / (1 + b.abs())).max())
               for f, b in zip(folded, base))


def pp_serving_tail(dev, cfg, model, frame):
    """The trained f32 model's serving tail (TF32 off): BatchNorm folded
    (raw outputs within PP_FOLD_TOL absolute + relative, detect's sorted
    scores within the sigmoid's slope, 1/4, of that at the largest class
    logit), int8 weights (raw outputs within 0.1 of their largest
    magnitude, tests/test_quantize.py:61), and the flip ensemble
    (``make_tta_detector``, modes none and flip_y: K1's bit form and the
    scan once for each mode and once for the merge, and its keep mask
    equal to the plain scan's on its boxes). Request latencies by the
    host clock. Returns (stats, counts of the TTA request)."""
    from d3d_tpu_torch.models import (PointPillars, make_anchors,
                                      make_pointpillars_detector,
                                      make_tta_detector)
    from d3d_tpu_torch.models.fold import fold_batchnorm
    from d3d_tpu_torch.models.inference import _bev
    from d3d_tpu_torch.ops.nms import nms2d
    from d3d_tpu_torch.quantize import (dequantize_params, quantize_params,
                                        quantized_bytes)

    anchors = make_anchors(cfg, device=dev)

    def detector(sd):
        m = PointPillars(cfg, device=dev)
        m.load_state_dict(sd)
        return m, make_pointpillars_detector(m, None, cfg, anchors,
                                             car_classes(), device=dev)

    base_model, base = detector(model.state_dict())
    t0 = time.perf_counter()
    folded_sd = fold_batchnorm(base_model)
    fold_s = time.perf_counter() - t0
    fold_model, fold = detector(folded_sd)
    t0 = time.perf_counter()
    q = quantize_params(base_model)
    quant_s = time.perf_counter() - t0
    q_model, qdet = detector(dequantize_params(q))
    raw = {name: [o.float() for o in forward(m, frame, dev)]
           for name, m in (("base", base_model), ("fold", fold_model),
                           ("int8", q_model))}
    fold_err = fold_rel_err(raw["fold"], raw["base"])
    check(fold_err <= PP_FOLD_TOL, f"folded outputs off by {fold_err} "
                                   f"(1 + |x|), limit {PP_FOLD_TOL}")
    s_base = torch.sort(base.device_fn(frame)[1], descending=True).values
    s_fold = torch.sort(fold.device_fn(frame)[1], descending=True).values
    score_err = float((s_base - s_fold).abs().max())
    score_tol = PP_FOLD_TOL * (1 + float(raw["base"][0].abs().max())) / 4
    check(score_err <= score_tol,
          f"folded detect's scores off by {score_err} (bound {score_tol})")
    q_err = max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-3))
                for a, b in zip(raw["int8"], raw["base"]))
    check(q_err < 0.1, f"int8 outputs off by {q_err} of their magnitude")
    check_detections("int8 detect", qdet(frame))
    ratio = quantized_bytes(q) / quantized_bytes(base_model.state_dict())

    tta = make_tta_detector(base, car_classes(), modes=PP_TTA_MODES)
    reset_counts()
    boxes, scores, labels, keep = tta.device_fn(frame)
    counts = read_counts()
    n = len(PP_TTA_MODES) + 1
    check(counts["rbox_iou_matrix"] == n and counts["nms_scan"] == n,
          f"TTA request launches {counts}, want K1 and the scan {n} times")
    routes = check_nms_routes("tta", n)
    plain = ~nms2d(_bev(boxes.cpu()), scores.cpu(), iou_threshold=0.5) \
        & (scores.cpu() > 0)
    check(torch.equal(plain, keep.cpu()),
          "TTA keep mask differs from the plain scan's")
    check_detections("tta detect", tta(frame))
    lat = {name: host_ms(lambda d=d: d(frame))
           for name, d in (("detect", base), ("folded", fold),
                           ("int8", qdet), ("tta", tta))}
    log(f"pointpillars_train serving tail: fold {fold_s * 1e3:.1f} ms "
        f"(outputs within {fold_err:.3g} (1 + |x|), limit {PP_FOLD_TOL:.2g}, "
        f"scores "
        f"{score_err:.3g}), int8 {quant_s * 1e3:.1f} ms (outputs "
        f"{q_err:.3g} of their magnitude, {ratio:.3f} of the bytes), TTA "
        f"{dict(counts=counts, routes=routes)}, kept {int(keep.sum())}; "
        "request ms " + ", ".join(f"{k} {v:.2f}" for k, v in lat.items()))
    return dict(fold_err=fold_err, fold_score_err=score_err,
                int8_rel_err=q_err, int8_bytes_ratio=ratio,
                fold_ms=fold_s * 1e3, quantize_ms=quant_s * 1e3,
                request_ms=lat, tta_routes=routes), counts


def pointpillars_train(dev):
    """The pointpillars_train path (examples/train_pointpillars.py at full
    width, presets.pointpillars_kitti): 8 KITTI-like frames through the
    port's KittiObjectLoader, build_gt_database; the Trainer runs 5 f32
    steps (TF32 off, cuDNN deterministic; a TrainCheckpointer in build/
    saves at step 3, an eval_fn at step 5 runs device_calc_stats on
    make_pointpillars_detector with the EMA weights over the 8 frames)
    and 5 bf16 steps, each over batch_frames of augmented frames inside
    prefetch. Every count is set to 0 just before each run and read just
    after: K1's f32 form twice a frame (perobject_augment), its bit form
    and the scan once a frame of the evaluation. Then the checks: losses
    finite and falling, the resume, the card's and the CPU's gradients
    against a float64 step, augmentation card vs CPU, K1's f32 form
    against its plain version at the augmentation's 32x32 shape, the bf16
    bound, and the serving tail. Returns (the summed counts of the two
    runs and the TTA request, stats)."""
    import tempfile

    from d3d_tpu_torch.augment import build_gt_database
    from d3d_tpu_torch.benchmarks import DetectionEvaluator
    from d3d_tpu_torch.benchmarks_device import device_calc_stats
    from d3d_tpu_torch.checkpoint import TrainCheckpointer
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass
    from d3d_tpu_torch.models import (PointPillars, make_anchors,
                                      make_pointpillars_detector, presets)
    from d3d_tpu_torch.train import train_state

    stats = {}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = presets.pointpillars_kitti(dtype="float32")
    t0 = time.perf_counter()
    frames, gts = pp_train_frames()
    db = build_gt_database(frames, device=dev)
    stats["data_s"] = time.perf_counter() - t0
    init = PointPillars(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    calibrate_heads(init, frames[0][0], dev)
    state = {k: v.clone() for k, v in init.state_dict().items()}
    anchors = make_anchors(cfg, device=dev)
    car = KittiObjectClass.Car
    evals = {}

    def eval_fn(step, model, ema):
        t_eval = time.perf_counter()
        ema_model = PointPillars(cfg, device=dev)
        ema_model.load_state_dict(dict(model.state_dict(), **ema))
        detect = make_pointpillars_detector(ema_model, None, cfg, anchors,
                                            [car], device=dev)
        dets = [detect(pts, frame="velo") for pts, _, _ in frames]
        ev = DetectionEvaluator([car], 0.7, device=dev)
        ev.add_stats(device_calc_stats(ev, gts, dets))
        evals.update(ap=float(ev.ap()[car]), detections=sum(map(len, dets)),
                     eval_s=time.perf_counter() - t_eval)
        return {"AP(Car)": evals["ap"]}

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            ckpt_dir = Path(tmp) / "pp"
            ckpt = TrainCheckpointer(ckpt_dir, keep=3)
            reset_counts()
            model, opt, rec = pp_run(dev, cfg, state, frames, db, 900, ckpt,
                                     eval_fn)
            counts32 = read_counts()
            stats["float32"] = pp_check_run(
                "pointpillars_train float32", rec, counts32,
                dict(k1_matrix=4 * PP_STEPS, k1_bits=KITTI_FRAMES,
                     nms_scan=KITTI_FRAMES,
                     rbox_iou_matrix=4 * PP_STEPS + KITTI_FRAMES))
            check(ckpt.all_steps() == [PP_CKPT_STEP, PP_STEPS],
                  f"checkpoints {ckpt.all_steps()}")
            check(evals.get("detections", 0) > 0,
                  f"eval_fn: no detections {evals}")
            t_save = time.perf_counter()
            ckpt.save(PP_STEPS + 1, *train_state(model, opt))
            save_call = time.perf_counter() - t_save
            ckpt.wait()
            stats["checkpoint_ms"] = dict(
                save_call=save_call * 1e3,
                save_and_write=(time.perf_counter() - t_save) * 1e3)
            straight = {k: v.clone() for k, v in model.state_dict().items()}
            pp_resume(dev, cfg, state, ckpt_dir, straight,
                      rec["batches"][PP_CKPT_STEP:])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    stats["eval"] = evals
    stats["stages_float32"] = pp_stage_times(model, opt, rec["batches"][0],
                                             cfg)
    first_batch = rec["batches"][0]
    stats["grad_err"], stats["cpu_step_ms"] = pp_card_vs_cpu(
        dev, cfg, state, first_batch)
    stats["bf16_bound"] = pp_bf16_bound(dev, cfg, state, first_batch)

    cfg16 = presets.pointpillars_kitti()
    reset_counts()
    model16, opt16, rec16 = pp_run(dev, cfg16, state, frames, db, 901,
                                   profiled=True)
    counts16 = read_counts()
    stats["busy_share"] = dict(
        share=rec16["busy_share"], run_s=rec16["run_s"],
        of="the bfloat16 Trainer run under torch.profiler (CUDA activity "
           "only): the union of device activity over its wall clock")
    stats["bfloat16"] = pp_check_run(
        "pointpillars_train bfloat16", rec16, counts16,
        dict(k1_matrix=4 * PP_STEPS, k1_bits=0, nms_scan=0,
             rbox_iou_matrix=4 * PP_STEPS))
    stats["stages_bfloat16"] = pp_stage_times(model16, opt16,
                                              rec16["batches"][0], cfg16)
    stats["input_a_frame"], padded = pp_input_times(dev, cfg, frames, db)
    stats["augment"] = pp_augment_card_vs_cpu(dev)
    stats["k1_f32_32x32"] = pp_k1_augment(padded)
    tail, tta_counts = pp_serving_tail(dev, cfg, model, frames[0][0])
    stats["serving_tail"] = tail
    log("pointpillars_train stages (median of 4, CUDA events): "
        + "; ".join(f"{dt}: " + ", ".join(
            f"{n} {ms:.2f}" for n, ms in stats[f'stages_{dt}'].items())
            + " ms" for dt in ("float32", "bfloat16"))
        + f"; busy {stats['busy_share']['share']}; input a frame "
        f"{stats['input_a_frame']}; checkpoint "
        f"{stats['checkpoint_ms']}; K1 f32 form at 32x32: "
        f"{stats['k1_f32_32x32']}; eval {evals}")
    counts = {}
    for c in (counts32, counts16, tta_counts):
        add_counts(counts, c)
    return counts, stats


# ---------------------------------------------------------------------------
# voxelnext_track: VoxelNeXt on nuScenes-like frames, the device tracker,
# VoxelNeXt training, the sort-join maps, SECOND's dense middle
# ---------------------------------------------------------------------------

class NuscClass(enum.Enum):
    """nuScenes' ten detection classes, in CenterPoint's head order."""

    car = 0
    truck = 1
    construction_vehicle = 2
    bus = 3
    trailer = 4
    barrier = 5
    motorcycle = 6
    bicycle = 7
    pedestrian = 8
    traffic_cone = 9


# CenterPoint's nuScenes tracking gates (m), in NuscClass order
NUSC_GATES = (4.0, 4.0, 1.0, 5.5, 3.0, 1.0, 13.0, 3.0, 1.0, 1.0)
# class: (l, w, h) in m
NUSC_SIZES = {NuscClass.car: (4.6, 1.95, 1.7), NuscClass.truck: (8.0, 2.5, 3.2),
              NuscClass.bus: (11.0, 2.9, 3.4),
              NuscClass.pedestrian: (0.75, 0.7, 1.75),
              NuscClass.bicycle: (1.8, 0.6, 1.3),
              NuscClass.traffic_cone: (0.4, 0.4, 0.9)}
KEYFRAMES = 6
KEY_DT = 0.5          # nuScenes keyframes: 2 Hz
SWEEPS = 10           # CenterPoint's 10-sweep input
SWEEP_DT = 0.05       # the lidar at 20 Hz
LIDAR_HEIGHT = 1.8
EGO_SPEED = 5.0       # m/s along x
TRACK_LOST_TIME = 1.0
TRACK_CAPACITY = 128
STAND_IN_ROWS = 128
VN_LAYERS = ("subm0_0", "subm0_1", "down0", "subm1_0", "subm1_1", "down1",
             "subm2_0", "subm2_1", "down2", "subm3_0", "subm3_1")
VN_TRAIN_STEPS = 3
VN_MAX_GT = 128


def nuscenes_scene(seed):
    """A seeded street scene in a world frame whose ground lies 1.8 m
    below the sensor: four lanes of cars (with a truck and a bus) along x
    at 3-12 m/s a lane, pedestrians on the sidewalks at 1-1.6 m/s, a
    bicycle, parked cars and traffic cones. Returns (classes, sizes (M, 3),
    centres at t = 0 (M, 3), yaws (M,), velocities (M, 3))."""
    rng = np.random.default_rng(seed)
    rows = []
    for lane, sign in ((-5.5, 1.0), (-2.0, 1.0), (2.0, -1.0), (5.5, -1.0)):
        speed = sign * rng.uniform(3.0, 12.0)
        x = -70.0 + rng.uniform(0.0, 8.0)
        while x < 90.0:
            cls = (NuscClass.car if rng.random() < 0.85 else
                   NuscClass.truck if rng.random() < 0.5 else NuscClass.bus)
            rows.append((cls, (x, lane), 0.0 if sign > 0 else np.pi,
                         (speed, 0.0)))
            x += NUSC_SIZES[cls][0] + rng.uniform(5.0, 14.0)
    for side in (-1.0, 1.0):
        for x in rng.uniform(-70.0, 90.0, 12):
            v = rng.choice([-1.0, 1.0]) * rng.uniform(1.0, 1.6)
            rows.append((NuscClass.pedestrian,
                         (x, side * rng.uniform(9.0, 10.5)),
                         0.0 if v > 0 else np.pi, (v, 0.0)))
        for x in np.arange(-60.0, 80.0, 17.0) + rng.uniform(0, 3):
            rows.append((NuscClass.car, (x, side * 8.0), 0.0, (0.0, 0.0)))
        for x in rng.uniform(-40.0, 60.0, 4):
            rows.append((NuscClass.traffic_cone, (x, side * 7.2), 0.0,
                         (0.0, 0.0)))
    rows.append((NuscClass.bicycle, (-30.0, -7.0), 0.0, (4.0, 0.0)))
    classes = [r[0] for r in rows]
    sizes = np.array([NUSC_SIZES[c] for c in classes])
    centres = np.array([[x, y, -LIDAR_HEIGHT + s[2] / 2]
                        for (_, (x, y), _, _), s in zip(rows, sizes)])
    yaws = np.array([r[2] for r in rows])
    vel = np.array([[vx, vy, 0.0] for *_, (vx, vy) in rows])
    return classes, sizes, centres, yaws, vel


def ego_x(t):
    return -20.0 + EGO_SPEED * t


def key_time(k):
    return (SWEEPS - 1) * SWEEP_DT + k * KEY_DT


def nuscenes_like_sweeps(scene, k, seed=0):
    """Keyframe ``k``'s cloud from :func:`nuscenes_sweep_parts`: every
    sweep's points moved into the keyframe's sensor frame and tagged with
    their age, as ``sweeps.accumulate_sweeps`` lays them out: (N, 5)
    float32 [x, y, z, intensity, dt]."""
    tk = key_time(k)
    out = []
    for ts, pts, inten in nuscenes_sweep_parts(scene, k, seed):
        pts = pts.copy()
        pts[:, 0] -= ego_x(tk)
        out.append(np.concatenate([pts, inten[:, None],
                                   np.full((len(pts), 1), tk - ts)], 1))
    return np.concatenate(out).astype(np.float32)


def nuscenes_sweep_parts(scene, k, seed=0):
    """Keyframe ``k`` of a nuScenes-like sequence: the keyframe sweep and
    the 9 before it (a 32-beam sensor, HDL-32E's elevations -30.67 to
    +10.67 degrees, 360 degrees at 0.3 degree steps, 20 Hz, 1.8 m above
    the ground), each ray cast onto the ground, a building front each side
    of the street (with gaps) and the scene's boxes where they stand at
    that sweep's time (``hit_box``, kitti_like_points' caster), the
    nearest hit within 70 m kept with 2 cm of range noise. The ego drives
    along x at 5 m/s. Returns per sweep, newest first, (time s, (n, 3)
    float64 points in the world frame, (n,) intensities)."""
    classes, sizes, centres, yaws, vel = scene
    rng = np.random.default_rng(1000 * seed + k)
    elev = np.deg2rad(np.linspace(-30.67, 10.67, 32))
    az = np.deg2rad(np.arange(0.0, 360.0, 0.3))
    e, a = np.meshgrid(elev, az, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)],
                 -1).reshape(-1, 3)
    ray_az = np.arctan2(d[:, 1], d[:, 0])
    tk = key_time(k)
    out = []
    for s in range(SWEEPS):
        ts = tk - s * SWEEP_DT
        origin = np.array([ego_x(ts), 0.0, 0.0])
        t = np.full(len(d), np.inf)
        down = d[:, 2] < 0
        t[down] = LIDAR_HEIGHT / -d[down, 2]
        for side, phase in ((1.0, 0.3), (-1.0, 1.9)):
            with np.errstate(divide="ignore", invalid="ignore"):
                tw = np.where(d[:, 1] * side > 0, 13.0 / np.abs(d[:, 1]),
                              np.inf)
                hx = origin[0] + d[:, 0] * tw
                wall = ((d[:, 2] * tw < 8.0 - LIDAR_HEIGHT) & (tw < t)
                        & (np.sin(hx * 0.25 + phase) > -0.4))
            t[wall] = tw[wall]
        rel = centres + ts * vel - origin
        dist = np.hypot(rel[:, 0], rel[:, 1])
        reach = np.hypot(sizes[:, 0], sizes[:, 1]) / 2 + 0.1
        for i in np.flatnonzero(dist < 75.0):
            # only the rays whose azimuth can reach the box
            span = np.arcsin(min(1.0, reach[i] / dist[i]))
            off = (ray_az - np.arctan2(rel[i, 1], rel[i, 0]) + np.pi) \
                % (2 * np.pi) - np.pi
            sel = np.flatnonzero(np.abs(off) <= span + 0.01)
            ts_sel = t[sel]
            hit_box(d[sel], ts_sel, rel[i], sizes[i] / 2, yaws[i])
            t[sel] = ts_sel
        keep = t < 70.0
        pts = origin + d[keep] * (t[keep] + rng.normal(0.0, 0.02,
                                                        keep.sum()))[:, None]
        out.append((ts, pts, rng.random(len(pts))))
    return out


def scene_boxes(scene, k, bounds):
    """The scene's objects at keyframe ``k`` inside ``bounds`` (x, y), in
    the keyframe's sensor frame and in the world frame: (labels (M,),
    boxes (M, 7), velocities (M, 3), world boxes (M, 7))."""
    classes, sizes, centres, yaws, vel = scene
    tk = key_time(k)
    world = centres + tk * vel
    local = world - [ego_x(tk), 0.0, 0.0]
    inside = ((local[:, 0] > bounds[0]) & (local[:, 0] < bounds[1])
              & (local[:, 1] > bounds[2]) & (local[:, 1] < bounds[3]))
    labels = np.array([c.value for c in classes])[inside]

    def boxes(c):
        return np.concatenate([c[inside], sizes[inside],
                               yaws[inside, None]], 1)
    return labels, boxes(local), vel[inside], boxes(world)


def voxelnext_frames(seed=700):
    """The scene and its keyframes' clouds."""
    t0 = time.perf_counter()
    scene = nuscenes_scene(seed)
    clouds = [nuscenes_like_sweeps(scene, k) for k in range(KEYFRAMES)]
    sizes = [len(c) for c in clouds]
    log(f"nuScenes-like frames: {KEYFRAMES} keyframes of {SWEEPS} sweeps, "
        f"{len(scene[0])} objects, {min(sizes)}-{max(sizes)} points a "
        f"keyframe, {time.perf_counter() - t0:.1f} s on the host")
    check(all(200_000 <= n <= 400_000 for n in sizes),
          f"nuScenes-like keyframes of {sizes} points")
    return scene, clouds


def calibrate_voxelnext(model, pts, dev):
    """Rescale VoxelNeXt's random heads so their outputs over the valid BEV
    sites spread like a trained model's (heatmap logits sd 2 about the
    -2.19 bias, regression sd 0.3): random weights on raw coordinates give
    saturated scores and boxes of e^20 m. Returns the valid sites' share
    of ``bev_sites`` and their x range (m)."""
    from d3d_tpu_torch.models import voxelnext_voxelize

    cfg = model.cfg
    with torch.inference_mode():
        f, c, v = voxelnext_voxelize(torch.from_numpy(pts).to(dev), cfg)
        out = model(f[None], c[None], v[None])
    valid = out["site_valid"][0]
    for head, key, sd in ((model.head_hm, "heatmap", 2.0),
                          (model.head_reg, "reg", 0.3)):
        spread = (out[key][0][valid] - head.bias.detach()).std()
        with torch.no_grad():
            head.weight.mul_(sd / float(spread))
    xs = out["site_xy"][0][valid][:, 0].float() * cfg.bev_voxel[0] \
        + cfg.bounds[0]
    return (float(valid.float().mean()), float(xs.min()), float(xs.max()),
            int(v.sum()))


def voxelnext_setup(dev):
    """VoxelNeXt on presets.voxelnext_nuscenes at full width, f32 and the
    bf16 preset on the same seeded weights (heads calibrated over the
    occupied sites of keyframe 0), the nuScenes-like frames, and each
    sparse layer's inputs for the kernel checks: serving (one keyframe)
    and training (keyframes 0 and 3 joined)."""
    from d3d_tpu_torch.models import VoxelNeXt, presets, voxelnext_voxelize

    cfg32 = presets.voxelnext_nuscenes(dtype="float32")
    scene, clouds = voxelnext_frames()
    model32 = VoxelNeXt(cfg32, point_features=5, device=dev,
                        generator=torch.Generator().manual_seed(0))
    share, x0, x1, nvox = calibrate_voxelnext(model32, clouds[0], dev)
    log(f"VoxelNeXt heads calibrated over the valid BEV sites of keyframe "
        f"0: {share:.1%} of the {cfg32.bev_sites} sites valid, x from "
        f"{x0:.1f} to {x1:.1f} m ({nvox} voxels: the sorted voxelizer keeps "
        "the lowest keys, so the sites sit on the scene's -x side)")
    model16 = VoxelNeXt(presets.voxelnext_nuscenes(), point_features=5,
                        device=dev)
    model16.load_state_dict(model32.state_dict())
    with torch.inference_mode():
        vox = [voxelnext_voxelize(torch.from_numpy(clouds[k]).to(dev),
                                  cfg32) for k in (0, 3)]
    layers = stage_layer_inputs(model32, *(v[None] for v in vox[0]),
                                names=VN_LAYERS)
    batch = voxelnext_batch(dev, cfg32, scene, vox, (0, 3))
    train_layers = stage_layer_inputs(model32, batch["features"],
                                      batch["coords"], batch["valid"],
                                      names=VN_LAYERS)
    return dict(scene=scene, clouds=clouds, model32=model32,
                model16=model16, layers=layers, train_layers=train_layers,
                batch=batch, occupied_share=share, occupied_x=(x0, x1))


def voxelnext_batch(dev, cfg, scene, vox, keys):
    """The training batch: two keyframes' voxels stacked, their objects as
    ground truth (boxes in the keyframe's sensor frame, labels, BEV
    velocities), padded to VN_MAX_GT rows a frame."""
    b = len(keys)
    gt = np.zeros((b, VN_MAX_GT, 7), np.float32)
    labels = np.zeros((b, VN_MAX_GT), np.int32)
    vel = np.zeros((b, VN_MAX_GT, 2), np.float32)
    mask = np.zeros((b, VN_MAX_GT), bool)
    for i, k in enumerate(keys):
        lab, boxes, v, _ = scene_boxes(scene, k, cfg.bounds)
        m = min(len(lab), VN_MAX_GT)
        gt[i, :m], labels[i, :m], vel[i, :m] = boxes[:m], lab[:m], v[:m, :2]
        mask[i, :m] = True
    batch = {key: torch.stack([v[j] for v in vox]).clone()
             for j, key in enumerate(("features", "coords", "valid"))}
    batch.update({k: torch.from_numpy(v).to(dev) for k, v in dict(
        gt_boxes=gt, gt_labels=labels, gt_velocity=vel,
        gt_mask=mask).items()})
    return batch


def timed(fn):
    """(result, device ms by CUDA events, host ms) of one call that ends
    in a synchronise."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - t0) * 1e3


def want_counts(**kw):
    want = dict(rbox_iou_matrix=0, nms_scan=0, nms_scan_blocked=0,
                soft_nms_scan=0, subm_conv=0, subm_conv_dw=0,
                subm_conv_rulebook=0, build_stage_maps=0, soft_nms_scan_f64=0)
    want.update(kw)
    return want


def nusc_classes():
    return list(NuscClass)


def voxelnext_serving(dev, vn):
    """make_voxelnext_detector on the bf16 preset: a request per keyframe
    (counts read over them: K5 11, one rule-book call, K1's bit rows and
    the scan once a request), the outputs TrackingTarget3Ds, then the
    steady request time and the card's busy share over 5 requests."""
    from torch.profiler import ProfilerActivity, profile

    from d3d_tpu_torch.models import make_voxelnext_detector, presets

    cfg = presets.voxelnext_nuscenes()
    detect = make_voxelnext_detector(vn["model16"], None, cfg,
                                     nusc_classes(), device=dev)
    reset_counts()
    ms, host, kept = [], [], []
    for k, pts in enumerate(vn["clouds"]):
        out, dev_ms, host_ms = timed(lambda: detect(pts, frame="velo",
                                                    timestamp=k))
        ms.append(dev_ms)
        host.append(host_ms)
        kept.append(len(out))
        check(all(type(o).__name__ == "TrackingTarget3D" for o in out)
              and all(np.isfinite(o.velocity).all()
                      and np.isfinite(o.position).all() for o in out),
              "VoxelNeXt detect: not finite TrackingTarget3Ds")
    n = len(vn["clouds"])
    counts = read_counts()
    want = want_counts(rbox_iou_matrix=n, nms_scan=n,
                       subm_conv=len(VN_LAYERS) * n, subm_conv_rulebook=n,
                       build_stage_maps=n)
    check(counts == want, f"VoxelNeXt serving: launches {counts}, want "
                          f"{want}: 11 of K5, 1 rule-book call, 1 K1 and "
                          "1 K2 a request")
    check_nms_routes("VoxelNeXt serving", n)
    steady = [timed(lambda: detect.device_fn(vn["clouds"][i % n]))
              for i in range(10)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5):
            detect.device_fn(vn["clouds"][i % n])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_share(prof, wall)
    stats = dict(request_ms=ms, request_host_ms=host, kept=kept,
                 steady_ms=statistics.median(s[1] for s in steady),
                 steady_host_ms=statistics.median(s[2] for s in steady),
                 busy_share=busy)
    log(f"VoxelNeXt serving (bf16 preset, 5-column clouds): requests "
        + ", ".join(f"{m:.2f}" for m in ms) + " ms by CUDA events (host "
        + ", ".join(f"{m:.2f}" for m in host) + " ms; the first cold), "
        f"steady {stats['steady_ms']:.2f} ms (host "
        f"{stats['steady_host_ms']:.2f} ms, median of 10); busy share "
        f"{busy if busy is None else round(busy, 3)}; kept {kept}; "
        f"launches over {n} requests {counts}")
    return counts, stats, detect


def voxelnext_card_vs_cpu(dev, vn):
    """One keyframe through the f32 detector on the card (TF32 off) and the
    same weights on the CPU: the active sites exact, heatmap and
    regression within 1e-4 of each output's largest magnitude, the card's
    top-k decoded from the CPU's outputs within 2e-3 m / 2e-3 relative /
    2e-2 rad / 1e-4 of score, and the CPU's NMS on the card's boxes equal
    to the card's keep mask. Returns (the card's f32 request ms, the CPU
    network's ms)."""
    from d3d_tpu_torch.models import (VoxelNeXt, make_voxelnext_detector,
                                      voxelnext_voxelize)
    from d3d_tpu_torch.models.inference import _bev
    from d3d_tpu_torch.models.voxelnext import decode_voxelnext
    from d3d_tpu_torch.ops.nms import nms2d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = vn["model32"]
    cfg = model.cfg
    pts = vn["clouds"][2]
    detect = make_voxelnext_detector(model, None, cfg, nusc_classes(),
                                     device=dev)
    gpu, f32_ms, _ = timed(lambda: [t.cpu() for t in detect.device_fn(pts)])
    cpu_model = VoxelNeXt(cfg, point_features=5, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    raw = []
    for m, d in ((model, dev), (cpu_model, "cpu")):
        t0 = time.perf_counter()
        with torch.inference_mode():
            f, c, v = voxelnext_voxelize(torch.from_numpy(pts).to(d), cfg)
            raw.append({k: t[0] for k, t in
                        m(f[None], c[None], v[None]).items()})
        cpu_ms = (time.perf_counter() - t0) * 1e3
    # the card's top-k as its decode ranks it (the same ops on the card)
    flat = torch.sigmoid(raw[0]["heatmap"]) * raw[0]["site_valid"][:, None]
    idx = torch.sort(flat.reshape(-1), descending=True,
                     stable=True).indices[:cfg.top_k].cpu()
    g, c = ({k: t.cpu() for k, t in r.items()} for r in raw)
    check(torch.equal(g["site_valid"], c["site_valid"])
          and torch.equal(g["site_xy"], c["site_xy"]),
          "VoxelNeXt card vs CPU: active BEV sites differ")
    raw_err = max(float((g[k] - c[k]).abs().max() / c[k].abs().max())
                  for k in ("heatmap", "reg"))
    check(raw_err <= 1e-4, f"VoxelNeXt card vs CPU: outputs {raw_err}")
    # the card's top-k decoded from either side's outputs at the card's
    # ranking (a near-tie may rank two sites apart on the two sides): a
    # heatmap that ranks exactly those (site, class) pairs, in that order
    def at(o):
        heat = torch.full((o["heatmap"].numel(),), -1e4)
        heat[idx] = 10.0 - 0.05 * torch.arange(len(idx), dtype=heat.dtype)
        sub = dict(o, heatmap=heat.reshape(o["heatmap"].shape),
                   site_valid=torch.ones_like(o["site_valid"]))
        return decode_voxelnext(cfg, sub)[0]
    boxes_g = at(g)
    check(float((boxes_g - gpu[0]).abs().max()) <= 1e-4,
          "VoxelNeXt detect.device_fn disagrees with its own raw outputs")
    boxes_c = at(c)
    pos_err = float((boxes_c[:, :3] - gpu[0][:, :3]).abs().max())
    size_err = float(((boxes_c[:, 3:6] - gpu[0][:, 3:6])
                      / gpu[0][:, 3:6]).abs().max())
    dyaw = torch.remainder(boxes_c[:, 6] - gpu[0][:, 6] + math.pi,
                           2 * math.pi) - math.pi
    yaw_err = float(dyaw.abs().max())
    scores_c = torch.sigmoid(c["heatmap"]).reshape(-1)[idx]
    score_err = float((scores_c - gpu[1]).abs().max())
    check(pos_err <= 2e-3 and size_err <= 2e-3 and yaw_err <= 2e-2
          and score_err <= 1e-4,
          f"VoxelNeXt card vs CPU: position {pos_err}, size {size_err}, "
          f"yaw {yaw_err}, score {score_err}")
    keep_cpu = ~nms2d(_bev(gpu[0]), gpu[1], iou_threshold=0.5)
    check(torch.equal(keep_cpu, gpu[3]), "VoxelNeXt keep mask card vs CPU")
    log(f"VoxelNeXt card vs CPU (f32, TF32 off): sites equal "
        f"({int(g['site_valid'].sum())} valid), outputs {raw_err:.3g} "
        f"relative; at the card's top-{cfg.top_k}: positions {pos_err:.3g} "
        f"m, sizes {size_err:.3g}, yaw {yaw_err:.3g} rad, scores "
        f"{score_err:.3g}; keep mask equal ({int(gpu[3].sum())} kept). f32 "
        f"request {f32_ms:.2f} ms; the CPU network {cpu_ms:.0f} ms")
    return f32_ms, cpu_ms


def voxelnext_tracking(dev, detect, clouds):
    """make_tracking_step(detect.device_fn, CenterPoint's nuScenes gates)
    over the keyframes at dt = 0.5 s, counts read over the run (K5 11,
    one rule-book call, K1's bit rows and the scan once a frame); then
    each frame again with detect and the tracker timed apart, the
    tracker's rows walked and its kernels counted by CUPTI."""
    from d3d_tpu_torch.tracking import make_tracking_step
    from d3d_tpu_torch.tracking.device_tracker import tracker_update

    step = make_tracking_step(detect.device_fn, NUSC_GATES,
                              lost_time=TRACK_LOST_TIME,
                              capacity=TRACK_CAPACITY, score_threshold=0.3)
    state = step.init()
    check(state["boxes"].device.type == "cuda", "tracker state off the card")
    reset_counts()
    frame_ms, frame_host, active = [], [], []
    for k, pts in enumerate(clouds):
        (state, out), ms, host = timed(
            lambda: step(state, pts, 0.0 if k == 0 else KEY_DT))
        frame_ms.append(ms)
        frame_host.append(host)
        active.append(int(state["active"].sum()))
        check(len(out) == 5 and all(bool(torch.isfinite(t.float()).all())
                                    for t in out),
              "tracking step: outputs not finite")
    n = len(clouds)
    counts = read_counts()
    want = want_counts(rbox_iou_matrix=n, nms_scan=n,
                       subm_conv=len(VN_LAYERS) * n, subm_conv_rulebook=n,
                       build_stage_maps=n)
    check(counts == want, f"tracking step: launches {counts}, want {want}")
    check_nms_routes("tracking step", n)
    check(int(state["next_tid"]) > 1 and active[-1] > 0,
          f"tracking step: no track ({active})")
    # detect and the tracker apart
    state = step.init()
    det_ms, trk_ms, trk_host, rows, kernels = [], [], [], [], []
    for k, pts in enumerate(clouds):
        out, ms, _ = timed(lambda: detect.device_fn(pts))
        det_ms.append(ms)
        boxes, scores, labels, keep, vel = out
        admit = keep & (scores.float() >= 0.3)
        args = (boxes, scores.float(), labels, vel, admit,
                0.0 if k == 0 else KEY_DT, step_thresholds(dev),
                TRACK_LOST_TIME)
        r0 = tracker_update.rows
        new, ms, host = timed(lambda: tracker_update(state, *args))
        rows.append(tracker_update.rows - r0)
        trk_ms.append(ms)
        trk_host.append(host)
        if k in (1, n - 1):
            kernels.append(kernel_launches(lambda: tracker_update(state,
                                                                  *args))[0])
        state = new
    stats = dict(frame_ms=frame_ms, frame_host_ms=frame_host,
                 active=active, detect_ms=det_ms, tracker_ms=trk_ms,
                 tracker_host_ms=trk_host, tracker_rows=rows,
                 tracker_kernels=kernels)
    log(f"VoxelNeXt tracking (fused step, bf16): frame "
        + ", ".join(f"{m:.2f}" for m in frame_ms) + " ms by CUDA events "
        f"(host " + ", ".join(f"{m:.2f}" for m in frame_host)
        + f" ms); active tracks {active}; apart: detect "
        + ", ".join(f"{m:.2f}" for m in det_ms) + " ms, tracker "
        + ", ".join(f"{m:.2f}" for m in trk_ms) + f" ms (host "
        + ", ".join(f"{m:.2f}" for m in trk_host) + f" ms) walking {rows} "
        f"admitted rows; the tracker's kernels (CUPTI) {kernels} a frame "
        f"(frames 2 and {n})")
    return counts, stats


def step_thresholds(dev):
    return torch.tensor(NUSC_GATES, dtype=torch.float32, device=dev)


def stand_in_tracks(rng, scene, k):
    """Stand-in detections of keyframe ``k`` in the world frame (the
    tracker's frame, as nuScenes tracking runs in global coordinates):
    each object within 50 m of the ego, jittered by 5 cm and 0.1 m/s,
    scored 0.5-0.95, plus 8 noise detections scored 0.3-0.5, padded to
    STAND_IN_ROWS rows: (boxes, scores, labels, vel, valid) numpy."""
    classes, sizes, centres, yaws, vel = scene
    tk = key_time(k)
    world = centres + tk * vel
    near = np.flatnonzero(np.abs(world[:, 0] - ego_x(tk)) < 50.0)
    n = len(near) + 8
    check(n <= STAND_IN_ROWS, f"stand-in frame of {n} detections")
    boxes = np.zeros((STAND_IN_ROWS, 7), np.float32)
    boxes[:, 3:6] = 1.0
    v = np.zeros((STAND_IN_ROWS, 3), np.float32)
    labels = np.zeros(STAND_IN_ROWS, np.int32)
    scores = np.zeros(STAND_IN_ROWS, np.float32)
    valid = np.zeros(STAND_IN_ROWS, bool)
    m = len(near)
    boxes[:m, :3] = world[near] + rng.normal(0, 0.05, (m, 3))
    boxes[:m, 3:6] = sizes[near]
    boxes[:m, 6] = yaws[near]
    v[:m] = vel[near] + rng.normal(0, 0.1, (m, 3)) * [1, 1, 0]
    labels[:m] = [classes[i].value for i in near]
    scores[:m] = rng.uniform(0.5, 0.95, m)
    boxes[m:n, :3] = np.c_[ego_x(tk) + rng.uniform(-45, 45, 8),
                           rng.uniform(-12, 12, 8), np.full(8, -1.0)]
    labels[m:n] = rng.integers(0, 10, 8)
    scores[m:n] = rng.uniform(0.3, 0.5, 8)
    valid[:n] = True
    return boxes, scores, labels, v, valid


def tracker_card_vs_cpu(dev, scene):
    """tracker_update on stand-in detections of every keyframe on the card
    and on the CPU: ids, labels, active masks and the next id exact, the
    slot boxes, velocities, scores and clocks within 1e-5 (f32); the
    card's reports' trajectories isomorphic with CenterTracker's on the
    same detections (positions within 1e-3 m)."""
    from d3d_tpu_torch.abstraction import (ObjectTag, Target3DArray,
                                           TrackingTarget3D)
    from d3d_tpu_torch.tracking import CenterTracker
    from d3d_tpu_torch.tracking.device_tracker import (tracker_init,
                                                       tracker_report,
                                                       tracker_update)
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(710)
    frames = [stand_in_tracks(rng, scene, k) for k in range(KEYFRAMES)]
    states = {d: tracker_init(TRACK_CAPACITY, d) for d in (dev, "cpu")}
    host = CenterTracker({c.value: g for c, g in zip(NuscClass, NUSC_GATES)},
                         lost_time=TRACK_LOST_TIME)
    worst = 0.0
    traj = ({}, {})
    for k, fr in enumerate(frames):
        dt = 0.0 if k == 0 else KEY_DT
        for d in states:
            states[d] = tracker_update(states[d], *fr, dt, NUSC_GATES,
                                       TRACK_LOST_TIME)
        a = {key: t.cpu() for key, t in states[dev].items()}
        b = states["cpu"]
        for key in ("tid", "label", "active", "next_tid"):
            check(torch.equal(a[key], b[key]),
                  f"tracker card vs CPU frame {k}: {key} differ")
        for key in ("boxes", "vel", "score", "lost", "history"):
            err = float((a[key] - b[key]).abs().max())
            worst = max(worst, err)
            check(err <= 1e-5, f"tracker card vs CPU frame {k}: {key} {err}")
        boxes, scores, labels, vel, valid = fr
        dets = Target3DArray([
            TrackingTarget3D(boxes[i, :3], Rotation.from_euler(
                "Z", boxes[i, 6]), boxes[i, 3:6], vel[i], [0, 0, 0],
                ObjectTag(NuscClass(int(labels[i])), NuscClass,
                          float(scores[i])))
            for i in np.flatnonzero(valid)], frame="world",
            timestamp=int(round(k * KEY_DT * 1e6)))
        host.update(dets)
        reps = (host.report(), tracker_report(states[dev], nusc_classes(),
                                              "world"))
        for rep, tr in zip(reps, traj):
            for o in rep:
                tr.setdefault(o.tid, []).append((k, np.asarray(
                    o.position[:2], np.float64)))
    sig = [sorted(((tuple(f for f, _ in v), np.stack([p for _, p in v]))
                   for v in tr.values()), key=lambda s: (s[0], *s[1][0]))
           for tr in traj]
    check(len(sig[0]) == len(sig[1]) and all(
        fa == fb and np.abs(pa - pb).max() <= 1e-3
        for (fa, pa), (fb, pb) in zip(*sig)),
        "tracker trajectories differ from CenterTracker's")
    log(f"tracker card vs CPU on stand-in detections: {KEYFRAMES} frames "
        f"of {[int(f[4].sum()) for f in frames]} detections, ids, labels "
        f"and masks equal, slot values within {worst:.3g}; "
        f"{len(sig[0])} trajectories isomorphic with CenterTracker's "
        f"(final next id {int(states['cpu']['next_tid'])})")
    return worst


def voxelnext_training(dev, vn, dtype):
    """make_train_step at full width, batch 2 (keyframes 0 and 3, their
    objects with velocities as ground truth), ``dtype`` compute from the
    f32 serving weights, VN_TRAIN_STEPS steps, counts read per step: K5
    18 (11 forward, 7 features' gradients), K6 11, one rule-book call, K1
    never. Losses finite. Returns (summed counts, stats)."""
    from d3d_tpu_torch.models import VoxelNeXt, presets
    from d3d_tpu_torch.models.voxelnext import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    cfg = presets.voxelnext_nuscenes(dtype=dtype)
    model = VoxelNeXt(cfg, point_features=5, device=dev)
    model.load_state_dict(vn["model32"].state_dict())
    opt, _ = make_optimizer(model.parameters(), total_steps=VN_TRAIN_STEPS)
    step = make_train_step(model, opt, cfg)
    total, losses, step_ms = {}, [], []
    want = want_counts(subm_conv=18, subm_conv_dw=11, subm_conv_rulebook=1,
                       build_stage_maps=1)
    for i in range(VN_TRAIN_STEPS):
        reset_counts()
        aux, ms, _ = timed(lambda: step(vn["batch"]))
        counts = read_counts()
        check(counts == want, f"VoxelNeXt training {dtype} step {i + 1}: "
                              f"launches {counts}, want {want}")
        for key, v in counts.items():
            total[key] = total.get(key, 0) + v
        step_ms.append(ms)
        losses.append({k: float(v) for k, v in aux.items()})
        check(all(math.isfinite(v) for v in losses[-1].values()),
              f"VoxelNeXt training {dtype}: loss {losses[-1]}")
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in model.parameters()),
          f"VoxelNeXt training {dtype}: a gradient not finite")
    log(f"VoxelNeXt training {dtype}: losses "
        + ", ".join(f"{l['total']:.4f}" for l in losses) + "; step "
        + ", ".join(f"{m:.2f}" for m in step_ms) + " ms (CUDA events); "
        "launches a step K5 18, K6 11 (subm0_0's C = 5 padded), rule "
        "books 1")
    return total, dict(losses=[l["total"] for l in losses], step_ms=step_ms)


def sort_join_path(dev, vn, detect):
    """The tagged sort join: on keyframe 0's voxels (nuScenes grid, under
    the canvas cap) the stage maps built by the canvas and by the sort
    join (forced by ``_DENSE_CANVAS_MAX_CELLS`` = 0) equal, each build
    timed; then one request on a 150.4 m extent at 0.1 m (1504 x 1504 x
    40, 90.5M cells, over the cap), whose stage loop builds its maps with
    M1 (on the card the stage loops take no canvas and no sort join), with
    its launches counted."""
    from d3d_tpu_torch.models import (VoxelNeXt, make_voxelnext_detector,
                                      presets, voxelnext_voxelize)
    from d3d_tpu_torch.models.second import _stage_plan
    from d3d_tpu_torch.ops import sparse_conv
    from d3d_tpu_torch.ops.stage_maps import frame_stage_maps

    cfg = presets.voxelnext_nuscenes()
    with torch.inference_mode():
        _, c, v = voxelnext_voxelize(
            torch.from_numpy(vn["clouds"][0]).to(dev), cfg)
    cap = sparse_conv._DENSE_CANVAS_MAX_CELLS
    built = {}
    try:
        for route, cells in (("canvas", cap), ("sort_join", 0)):
            sparse_conv._DENSE_CANVAS_MAX_CELLS = cells
            frame_stage_maps(c, v, *_stage_plan(cfg))
            built[route] = timed(
                lambda: frame_stage_maps(c, v, *_stage_plan(cfg)))
    finally:
        sparse_conv._DENSE_CANVAS_MAX_CELLS = cap
    (maps_a, _), ms_a, _ = built["canvas"]
    (maps_b, _), ms_b, _ = built["sort_join"]
    nmaps = 0
    for sa, sb in zip(maps_a, maps_b):
        for x, y in ((sa[0], sb[0]), (sa[2], sb[2])):
            if x is not None:
                nmaps += 1
                check(torch.equal(x, y), "sort join and canvas maps differ")
    wcfg = presets.voxelnext_nuscenes(
        bounds=(-75.2, 75.2, -75.2, 75.2, -2.0, 4.0), grid=(1504, 1504, 40))
    cells = int(np.prod(wcfg.grid))
    check(cells > cap, f"{cells} cells are not above the canvas's cap")
    model = VoxelNeXt(wcfg, point_features=5, device=dev)
    model.load_state_dict(vn["model16"].state_dict())
    wdet = make_voxelnext_detector(model, None, wcfg, nusc_classes(),
                                   device=dev)
    wdet.device_fn(vn["clouds"][1])
    reset_counts()
    out, ms, host = timed(lambda: wdet.device_fn(vn["clouds"][1]))
    counts = read_counts()
    want = want_counts(rbox_iou_matrix=1, nms_scan=1,
                       subm_conv=len(VN_LAYERS), subm_conv_rulebook=1,
                       build_stage_maps=1)
    check(counts == want, f"Waymo-size request: launches {counts}")
    check(all(bool(torch.isfinite(t.float()).all()) for t in out),
          "Waymo-size request: outputs not finite")
    log(f"sort join: keyframe 0's {nmaps} stage maps equal by both routes "
        f"(canvas {ms_a:.2f} ms, sort join {ms_b:.2f} ms a build of all "
        f"four stages, CUDA events); a request on the {wcfg.grid} grid "
        f"({cells} cells; its maps by M1) {ms:.2f} ms (host {host:.2f} ms), "
        f"launches {counts}")
    return counts, dict(maps=nmaps, canvas_build_ms=ms_a,
                        sort_join_build_ms=ms_b, request_ms=ms,
                        request_host_ms=host)


def second_more(dev, second):
    """SECOND's other routes: middle="dense" serving on
    presets.second_kitti (f32) with the sparse model's weights, held to
    the CPU (compare_with_cpu); SECOND serving on 4 KITTI-like frames,
    held to the CPU on one; and the bf16 preset on a 5-column cloud
    (K5's first layer at C = 5, padded). Launches read per route."""
    from d3d_tpu_torch.models import (SECOND, head_config, make_anchors,
                                      make_second_detector, presets,
                                      second_voxelize)

    stats, counts = {}, {}
    frames = [kitti_like_points(500 + i) for i in range(4)]
    # the dense middle
    cfg = presets.second_kitti(dtype="float32", middle="dense")
    model = SECOND(cfg, device=dev)
    model.load_state_dict(second.state_dict())
    # no site cap: data reaches every BEV cell, so the heads take their
    # spread from the dense outputs (the sparse model's would saturate
    # many scores at 1.0, whose ties rank by index)
    calibrate_heads(model, frames[0], dev, second_voxelize,
                    occupied_only=True, box_bound=2.0)
    anchors = make_anchors(head_config(cfg), device=dev)
    detect = make_second_detector(model, None, cfg, anchors, car_classes(),
                                  device=dev)
    reset_counts()
    ms = [timed(lambda: detect(p))[1] for p in frames[:3]]
    c = read_counts()
    check(c == want_counts(rbox_iou_matrix=3, nms_scan=3),
          f"SECOND dense: launches {c}: no K5, 1 K1 and 1 K2 a request")
    check_nms_routes("SECOND dense", 3)
    add_counts(counts, c)
    no_tf32, cpu_ms = compare_with_cpu(
        "SECOND dense middle", model, SECOND(cfg, device="cpu"), frames[0],
        detect, anchors, dev, second_voxelize)
    steady = [timed(lambda: detect(p))[1] for p in frames[1:4]]
    stats["dense"] = dict(request_ms=ms, no_tf32_ms=no_tf32,
                          no_tf32_steady_ms=steady, cpu_ms=cpu_ms)
    # the sparse model on KITTI-like frames, its heads calibrated there
    sparse = SECOND(second.cfg, device=dev)
    sparse.load_state_dict(second.state_dict())
    calibrate_heads(sparse, frames[0], dev, second_voxelize,
                    occupied_only=True, box_bound=2.0)
    detect = make_second_detector(sparse, None, sparse.cfg, anchors,
                                  car_classes(), device=dev)
    reset_counts()
    ms, kept = [], []
    for p in frames:
        out, m, _ = timed(lambda: detect(p))
        ms.append(m)
        kept.append(check_detections("SECOND KITTI-like", out))
    c = read_counts()
    check(c == want_counts(rbox_iou_matrix=4, nms_scan=4,
                           subm_conv=4 * len(K5_LAYERS),
                           subm_conv_rulebook=4, build_stage_maps=4),
          f"SECOND KITTI-like: launches {c}")
    add_counts(counts, c)
    no_tf32, cpu_ms = compare_with_cpu(
        "SECOND KITTI-like", sparse, SECOND(sparse.cfg, device="cpu"),
        frames[1], detect, anchors, dev, second_voxelize)
    stats["kitti_like"] = dict(request_ms=ms, kept=kept, no_tf32_ms=no_tf32,
                               cpu_ms=cpu_ms)
    # the bf16 preset on a 5-column cloud
    cfg16 = presets.second_kitti()
    model5 = SECOND(cfg16, point_features=5, device=dev,
                    generator=torch.Generator().manual_seed(5))
    pts5 = np.concatenate([frames[2], np.random.default_rng(5).uniform(
        0, 0.45, (len(frames[2]), 1)).astype(np.float32)], 1)
    calibrate_heads(model5, pts5, dev, second_voxelize, occupied_only=True)
    layers5 = second_layer_inputs(model5, pts5, dev)
    k5_err5, _ = check_k5({"subm0_0": layers5["subm0_0"]}, None,
                          "SECOND 5-column")
    det5 = make_second_detector(model5, None, cfg16,
                                make_anchors(head_config(cfg16), device=dev),
                                car_classes(), device=dev)
    reset_counts()
    out, m5, _ = timed(lambda: det5(pts5))
    c = read_counts()
    check(c == want_counts(rbox_iou_matrix=1, nms_scan=1,
                           subm_conv=len(K5_LAYERS), subm_conv_rulebook=1,
                           build_stage_maps=1),
          f"SECOND 5-column bf16: launches {c}")
    add_counts(counts, c)
    stats["five_column_bf16"] = dict(request_ms=m5,
                                     kept=check_detections("SECOND 5-column",
                                                           out),
                                     k5_err_c5=k5_err5)
    log(f"SECOND dense middle: requests "
        + ", ".join(f"{x:.2f}" for x in stats["dense"]["request_ms"])
        + " ms (cuDNN 3D convolutions, no K5; TF32 off: "
        + ", ".join(f"{x:.2f}" for x in steady) + " ms); KITTI-like requests "
        + ", ".join(f"{x:.2f}" for x in stats["kitti_like"]["request_ms"])
        + f" ms, kept {kept}; 5-column bf16 request {m5:.2f} ms")
    return counts, stats


def voxelnext_track(dev, vn, second):
    """The voxelnext_track path and SECOND's other routes. Returns
    ({path: counts}, stats)."""
    counts, stats = {}, {}
    c, stats["serving"], detect = voxelnext_serving(dev, vn)
    counts["voxelnext_serving"] = c
    stats["f32_no_tf32_ms"], stats["cpu_ms"] = voxelnext_card_vs_cpu(dev,
                                                                     vn)
    counts["voxelnext_track"], stats["tracking"] = voxelnext_tracking(
        dev, detect, vn["clouds"])
    stats["tracker_card_vs_cpu_err"] = tracker_card_vs_cpu(dev, vn["scene"])
    total = {}
    for dtype in ("float32", "bfloat16"):
        c, stats[f"train_{dtype}"] = voxelnext_training(dev, vn, dtype)
        add_counts(total, c)
    counts["voxelnext_train"] = total
    counts["sort_join"], stats["sort_join"] = sort_join_path(dev, vn,
                                                             detect)
    counts["second_more"], stats["second_more"] = second_more(dev, second)
    stats["occupied_share"] = vn["occupied_share"]
    stats["occupied_x_m"] = vn["occupied_x"]
    return counts, stats


# ---------------------------------------------------------------------------
# nuscenes_track_eval: raw nuScenes tables -> converter -> loader ->
# accumulate_sweeps -> VoxelNeXt -> device tracker -> TrackingEvaluator and
# the nuScenes protocol
# ---------------------------------------------------------------------------

# the scene's classes as nuScenes categories
NUSC_CATEGORY = {NuscClass.car: "vehicle.car",
                 NuscClass.truck: "vehicle.truck",
                 NuscClass.bus: "vehicle.bus.rigid",
                 NuscClass.pedestrian: "human.pedestrian.adult",
                 NuscClass.bicycle: "vehicle.bicycle",
                 NuscClass.traffic_cone: "movable_object.trafficcone"}
# the scene's t = 0 in microseconds (a date in nuScenes' range)
NUSC_EPOCH_US = 1_533_151_603_000_000
# objects annotated: within this many metres of the ego along x (the
# stand-ins' window)
NUSC_WINDOW_M = 50.0
# the nuScenes tracking challenge's seven classes
NUSC_TRACKING = ("bicycle", "bus", "car", "motorcycle", "pedestrian",
                 "trailer", "truck")
# the tracking evaluators of the phase: 3D IoU 0.5 for every class, 20
# score thresholds 0, 0.05, ..., 0.95 (0.5 exactly among them: the
# stand-ins' true detections score 0.5-0.95, their noise 0.3-0.5)
NUSC_TRACK_OVERLAP = 0.5
NUSC_TRACK_SAMPLES = 20
# nuScenes val's shape: 150 scenes of 40 keyframes
VAL_SCENES = 150
VAL_KEYFRAMES = 40
VAL_CHECKED_SCENES = 10
# the at-scale evaluation's budget on the card (the scenes are cut to fit,
# so that the phase stays near 40 s)
VAL_BUDGET_S = 15.0


def nusc_us(t):
    return NUSC_EPOCH_US + int(round(t * 1e6))


def head_classes():
    """The port's nuScenes detection classes in the head's order."""
    from d3d_tpu_torch.dataset.nuscenes import NuscenesDetectionClass

    return [NuscenesDetectionClass[c.name] for c in NuscClass]


def write_nuscenes_raw(root, scene, parts):
    """The scene as a raw nuScenes distribution (v1.0-trainval tables and
    samples/sweeps blobs) after tests/test_dataset.py's ``_raw``: one scene
    "scene-0001" of KEYFRAMES samples at 2 Hz, each with its keyframe sweep
    and the SWEEPS - 1 sweeps before it at 20 Hz, every sweep's points in
    its own sensor frame ((N, 5) float32 x, y, z, intensity, ring) with
    its own ego pose (the ego on the ground at (ego_x(t), 0), the lidar
    1.8 m above it, identity rotations); one annotation a keyframe for
    each object within NUSC_WINDOW_M of the ego along x (global centre,
    wlh size, wxyz rotation), linked prev/next through its instance, whose
    token's first 8 hex digits are the object's index + 1."""
    import json

    classes, sizes, centres, yaws, vel = scene
    v = root / "v1.0-trainval"
    for sub in (v, root / "samples/LIDAR_TOP", root / "sweeps/LIDAR_TOP"):
        sub.mkdir(parents=True)

    def wxyz(yaw):
        return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]

    samples, sdata, poses, anns = [], [], [], []
    last = {}
    for k in range(KEYFRAMES):
        tk = key_time(k)
        stok = f"sample{k:02d}"
        for s, (ts, pts, inten) in enumerate(parts[k]):
            tok = f"lidar{k:02d}_{s}"
            poses.append(dict(token=f"pose_{tok}", timestamp=nusc_us(ts),
                              rotation=[1.0, 0.0, 0.0, 0.0],
                              translation=[ego_x(ts), 0.0, -LIDAR_HEIGHT]))
            fname = (f"samples/LIDAR_TOP/{tok}.pcd.bin" if s == 0
                     else f"sweeps/LIDAR_TOP/{tok}.pcd.bin")
            cloud = np.zeros((len(pts), 5), np.float32)
            cloud[:, :3] = pts - [ego_x(ts), 0.0, 0.0]
            cloud[:, 3] = inten
            cloud.tofile(root / fname)
            sdata.append(dict(token=tok, sample_token=stok,
                              ego_pose_token=f"pose_{tok}",
                              calibrated_sensor_token="cs_lidar",
                              filename=fname, is_key_frame=s == 0,
                              timestamp=nusc_us(ts), fileformat="pcd",
                              prev="", next=""))
        world = centres + tk * vel
        ann_tokens = []
        for i in np.flatnonzero(np.abs(world[:, 0] - ego_x(tk))
                                < NUSC_WINDOW_M):
            atok = f"ann{k:02d}_{i:03d}"
            prev = last.get(i, (None, ""))
            prev = prev[1] if prev[0] == k - 1 else ""
            if prev:
                anns[[a["token"] for a in anns].index(prev)]["next"] = atok
            last[i] = (k, atok)
            anns.append(dict(
                token=atok, sample_token=stok,
                instance_token=f"{i + 1:08x}" + "0" * 24,
                attribute_tokens=[], translation=world[i].tolist(),
                size=[sizes[i, 1], sizes[i, 0], sizes[i, 2]],
                rotation=wxyz(yaws[i]), num_lidar_pts=1, num_radar_pts=0,
                prev=prev, next=""))
            ann_tokens.append(atok)
        samples.append(dict(token=stok, scene_token="scene_token",
                            timestamp=nusc_us(tk),
                            prev=f"sample{k - 1:02d}" if k else "",
                            next=f"sample{k + 1:02d}"
                            if k + 1 < KEYFRAMES else "",
                            anns=ann_tokens))
    cats = sorted(set(NUSC_CATEGORY.values()))
    tables = dict(
        log=[dict(token="log", logfile="synthetic", date_captured="2018-08-01",
                  vehicle="ego", location="street")],
        scene=[dict(token="scene_token", name="scene-0001", log_token="log",
                    nbr_samples=KEYFRAMES, description="nuScenes-like street",
                    first_sample_token="sample00",
                    last_sample_token=f"sample{KEYFRAMES - 1:02d}")],
        sample=samples,
        sensor=[dict(token="sensor_lidar", channel="LIDAR_TOP",
                     modality="lidar")],
        calibrated_sensor=[dict(token="cs_lidar", sensor_token="sensor_lidar",
                                rotation=[1.0, 0.0, 0.0, 0.0],
                                translation=[0.0, 0.0, LIDAR_HEIGHT],
                                camera_intrinsic=[])],
        ego_pose=poses, sample_data=sdata,
        category=[dict(token=f"cat{j}", name=c) for j, c in enumerate(cats)],
        attribute=[],
        instance=[dict(token=f"{i + 1:08x}" + "0" * 24,
                       category_token=f"cat{cats.index(NUSC_CATEGORY[c])}",
                       nbr_annotations=0)
                  for i, c in enumerate(classes)],
        sample_annotation=anns)
    for name, rows in tables.items():
        (v / f"{name}.json").write_text(json.dumps(rows))
    return len(anns)


def nuscenes_input(vn):
    """The scene written as raw tables under build/, converted with the
    port's converter (the intermediate sweeps kept), loaded with
    NuscenesLoader, each keyframe accumulated with accumulate_sweeps and
    held to the cloud the voxelnext_track phase built directly
    (nuscenes_like_sweeps): the same points within 1e-4 m and the same
    intensities and ages. Returns (loader, clouds, stats)."""
    import shutil

    from d3d_tpu_torch.dataset.nuscenes import NuscenesLoader
    from d3d_tpu_torch.dataset.nuscenes.converter import (
        convert_dataset_inpath)
    from d3d_tpu_torch.models.sweeps import accumulate_sweeps

    base = ROOT / "build" / "nuscenes_track_eval"
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    parts = [nuscenes_sweep_parts(vn["scene"], k) for k in range(KEYFRAMES)]
    nann = write_nuscenes_raw(base / "raw", vn["scene"], parts)
    t1 = time.perf_counter()
    convert_dataset_inpath(base / "raw", base / "converted",
                           store_inter=SWEEPS - 1)
    t2 = time.perf_counter()
    loader = NuscenesLoader(base / "converted", phase="training",
                            trainval_split="official")
    check(len(loader) == KEYFRAMES, f"loader: {len(loader)} frames")
    clouds = [accumulate_sweeps(loader, k, nsweeps=SWEEPS)
              for k in range(KEYFRAMES)]
    t3 = time.perf_counter()
    err = dt_err = 0.0
    for k, (got, want) in enumerate(zip(clouds, vn["clouds"])):
        check(got.shape == want.shape and got.dtype == np.float32,
              f"accumulated keyframe {k}: {got.shape} vs {want.shape}")
        err = max(err, float(np.abs(got[:, :3] - want[:, :3]).max()))
        dt_err = max(dt_err, float(np.abs(got[:, 4] - want[:, 4]).max()))
        check(np.array_equal(got[:, 3], want[:, 3]),
              f"accumulated keyframe {k}: intensities differ")
    check(err <= 1e-4 and dt_err == 0.0,
          f"accumulated clouds off the direct ones by {err} m, ages by "
          f"{dt_err} s")
    stats = dict(annotations=nann, write_s=t1 - t0, convert_s=t2 - t1,
                 load_accumulate_s=t3 - t2, max_point_err_m=err,
                 points=[len(c) for c in clouds])
    log(f"nuScenes input: {KEYFRAMES} keyframes x {SWEEPS} sweeps and "
        f"{nann} annotations written as raw tables ({stats['write_s']:.1f} "
        f"s), converted ({stats['convert_s']:.1f} s), loaded and "
        f"accumulated ({stats['load_accumulate_s']:.1f} s): "
        f"{stats['points']} points, within {err:.3g} m of the direct "
        "clouds, ages and intensities equal")
    return loader, clouds, stats


def tracking_evaluators(dev):
    """The phase's TrackingEvaluator on the card and with device="cpu"."""
    from d3d_tpu_torch.benchmarks import TrackingEvaluator
    from d3d_tpu_torch.dataset.nuscenes import NuscenesDetectionClass as N

    return {d: TrackingEvaluator([N[c] for c in NUSC_TRACKING],
                                 NUSC_TRACK_OVERLAP,
                                 pr_sample_count=NUSC_TRACK_SAMPLES,
                                 pr_sample_scale="lin", device=d)
            for d in (dev, "cpu")}


TRACK_FIELDS = ("id_switches", "fragments", "gt_frames", "gt_tracked",
                "dt_frames")


def same_tracking_stats(name, a, b):
    """same_stats plus the tracking counters and trajectory tables."""
    worst = same_stats(name, a, b)
    for k in a.ngt:
        for fld in TRACK_FIELDS:
            check(np.array_equal(getattr(a, fld)[k], getattr(b, fld)[k]),
                  f"{name}: {fld} differs")
        for tids in ("gt_tids", "dt_tids"):
            check(np.array_equal(getattr(a, tids)[k], getattr(b, tids)[k]),
                  f"{name}: {tids} differ")
    return worst


def score_tracks(name, gts, tracks, dev, calib=None):
    """calc_stats_sequence of the tracks on the card and on the CPU,
    equal. Returns the card's evaluator."""
    evs = tracking_evaluators(dev)
    for ev in evs.values():
        ev.calc_stats_sequence(gts, tracks, calib=calib)
    same_tracking_stats(f"{name} card vs CPU", evs[dev].get_stats(),
                        evs["cpu"].get_stats())
    return evs[dev]


def tracking_metrics(ev, score=None):
    car = [c for c in ev._classes if ev._class_type(c).name == "car"][0]
    c = ev._class_type(car)
    return dict(mota_car=ev.mota(score)[c], amota_car=ev.amota()[c],
                amotp_car=ev.amotp()[c], ids_car=ev.id_switches(score)[c],
                tp_car=ev.tp(score)[c], fp_car=ev.fp(score)[c],
                fn_car=ev.fn(score)[c], gt_car=int(ev.gt_count()[car]))


def nuscenes_protocols(name, gts, dets, classes, dev):
    """evaluate_nuscenes_detection and evaluate_nuscenes_official on the
    card and on the CPU: counters, APs, TP errors and NDS equal (the
    score-threshold evaluators' accuracies within 1e-5 relative). Returns
    the card's (mean AP, NDS) of each and their host ms."""
    from d3d_tpu_torch.benchmarks_nuscenes import (
        evaluate_nuscenes_detection, evaluate_nuscenes_official)

    out = {}
    res = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        res[d, "official"] = evaluate_nuscenes_official(gts, dets, classes,
                                                        device=d)
        t1 = time.perf_counter()
        res[d, "detection"] = evaluate_nuscenes_detection(gts, dets, classes,
                                                          device=d)
        out[f"{'card' if d == dev else 'cpu'}_ms"] = dict(
            official=(t1 - t0) * 1e3,
            detection=(time.perf_counter() - t1) * 1e3)
    a, b = res[dev, "official"], res["cpu", "official"]
    check(a["ap"] == b["ap"] and a["tp_errors"] == b["tp_errors"]
          and a["nds"] == b["nds"],
          f"{name}: the official nuScenes metrics differ card vs CPU")
    a, b = res[dev, "detection"], res["cpu", "detection"]
    for thr, ev in a["evaluators"].items():
        same_stats(f"{name} nuScenes detection {thr} m card vs CPU",
                   ev.get_stats(), b["evaluators"][thr].get_stats())
    check(a["ap"] == b["ap"], f"{name}: nuScenes detection APs differ")
    out.update(official_map=res[dev, "official"]["mean_ap"],
               official_nds=res[dev, "official"]["nds"],
               detection_map=a["mean_ap"], detection_nds=a["nds"])
    return out


def stand_in_floor(scene, ev, noise_cars):
    """The floors of the stand-ins' MOTA(car) at score 0.5 and AMOTA(car),
    from how they are made (``stand_in_tracks``): every object within
    NUSC_WINDOW_M of the ego is detected, jittered 5 cm (3D IoU with its
    box far above 0.5), scored 0.5-0.95, so at 0.5 every annotated car is
    tracked and keeps its track (FN = IDS = 0: a true detection is matched
    first, in score order, within CenterPoint's 4 m car gate of its own
    track's backcast position, 0.1 m off); the only false tracks are
    those coasting (up to TRACK_LOST_TIME, 2 keyframes) after their car
    leaves the window: FP <= 2 L, L the car exits between keyframes. So
    MOTA(car) >= 1 - 2 L / ngt. Above 0.5 a car is tracked in a frame iff
    its detection scores above the threshold (recall r); a present car
    untracked after a tracked frame counts at most one switch, so
    IDS <= FN = (1 - r) ngt, and MOTAR >= 1 - ((1 - r) ngt + FP) / (r
    ngt); below 0.5 the noise detections (8 a frame, scored 0.3-0.5, one
    in ten a car) add at most 3 each (detected, then coasting twice).
    AMOTA(car) >= the mean of those bounds, clipped to [0, 1], over the
    thresholds with r >= 0.1. Returns (MOTA floor, AMOTA floor, L)."""
    classes, sizes, centres, yaws, vel = scene
    inside = []
    for k in range(KEYFRAMES):
        x = centres[:, 0] + key_time(k) * vel[:, 0] - ego_x(key_time(k))
        inside.append(np.abs(x) < NUSC_WINDOW_M)
    car = np.array([c is NuscClass.car for c in classes])
    exits = int(sum((inside[k - 1] & ~inside[k] & car).sum()
                    for k in range(1, KEYFRAMES)))
    st = ev.get_stats()
    ck = [k for k in ev._classes if ev._class_type(k).name == "car"][0]
    ngt = st.ngt[ck]
    thr = ev.score_thresholds
    r = st.tp[ck] / ngt
    fp = 2 * exits + np.where(thr < 0.5, 3 * noise_cars, 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        motar = 1 - ((1 - r) * ngt + fp) / (r * ngt)
    valid = r >= 0.1
    amota = float(np.mean(np.clip(motar[valid], 0, 1))) if valid.any() \
        else 0.0
    return 1 - 2 * exits / ngt, amota, exits


def stand_in_scoring(dev, scene, gts):
    """The stand-ins (``stand_in_tracks``, world frame) through the device
    tracker, its reports moved into each keyframe's ego frame, scored on
    the card and on the CPU (equal), held to their floors."""
    from d3d_tpu_torch.tracking.device_tracker import (tracker_init,
                                                       tracker_report,
                                                       tracker_update)

    rng = np.random.default_rng(710)
    classes = head_classes()
    state = tracker_init(TRACK_CAPACITY, dev)
    tracks, noise_cars = [], 0
    for k in range(KEYFRAMES):
        boxes, scores, labels, vel, valid = stand_in_tracks(rng, scene, k)
        noise_cars += int(((labels == NuscClass.car.value) & valid
                           & (scores < 0.5)).sum())
        state = tracker_update(state, boxes, scores, labels, vel, valid,
                               0.0 if k == 0 else KEY_DT, NUSC_GATES,
                               TRACK_LOST_TIME)
        # the world-frame tracks in the keyframe's ego frame (the ego pose
        # is a translation)
        ego = dict(state)
        ego["boxes"] = state["boxes"] - torch.tensor(
            [ego_x(key_time(k)), 0.0, -LIDAR_HEIGHT, 0.0, 0.0, 0.0, 0.0],
            device=dev)
        tracks.append(tracker_report(ego, classes, "ego",
                                     nusc_us(key_time(k))))
    ev = score_tracks("stand-in tracks", gts, tracks, dev)
    mota_floor, amota_floor, exits = stand_in_floor(scene, ev, noise_cars)
    m = tracking_metrics(ev, 0.5)
    check(m["mota_car"] >= mota_floor and m["fn_car"] == 0
          and m["ids_car"] == 0,
          f"stand-in MOTA(car) {m['mota_car']} below its floor {mota_floor} "
          f"(FN {m['fn_car']}, IDS {m['ids_car']})")
    check(m["amota_car"] >= amota_floor,
          f"stand-in AMOTA(car) {m['amota_car']} below its floor "
          f"{amota_floor}")
    m.update(mota_floor=mota_floor, amota_floor=amota_floor,
             car_exits=exits, noise_cars=noise_cars)
    log(f"stand-in tracks: MOTA(car) at 0.5 {m['mota_car']:.4f} (floor "
        f"{mota_floor:.4f}: {exits} car exits), AMOTA(car) "
        f"{m['amota_car']:.4f} (floor {amota_floor:.4f}), AMOTP(car) "
        f"{m['amotp_car']:.4f} m; TP {m['tp_car']}, FP {m['fp_car']}, FN "
        f"{m['fn_car']}, IDS {m['ids_car']} of {m['gt_car']} cars; card "
        "equal to CPU")
    return m


def val_scale_scenes(first, last, seed=11):
    """Scenes ``first`` to ``last`` - 1 of a seeded tracking set of nuScenes
    val's shape (VAL_SCENES scenes of VAL_KEYFRAMES keyframes; each scene
    from its own seed, so a cut set is a prefix of the whole): 30 objects a
    scene of the 7 tracking classes moving at constant velocity within
    50 m; each keyframe's GT the objects present (8% drop out), its tracks
    85% of them jittered (the tid of the object's track) plus 5 false
    tracks with fresh tids. Ego frame, ObjectTarget3D rows with tids."""
    from d3d_tpu_torch.abstraction import Target3DArray
    from d3d_tpu_torch.dataset.nuscenes import NuscenesDetectionClass as N

    labels = np.array([N[c].value for c in NUSC_TRACKING])
    scenes = []
    for s in range(first, last):
        rng = np.random.default_rng((seed, s))
        n = 30
        pos = np.c_[rng.uniform(-45, 45, (n, 2)), rng.uniform(-1, 0, n)]
        vel = np.c_[rng.normal(0, 3, (n, 2)), np.zeros(n)]
        dim = rng.uniform(0.6, 5.0, (n, 3))
        yaw = rng.uniform(-np.pi, np.pi, n)
        lab = rng.choice(labels, n)
        noise = 1_000_000
        gts, dts = [], []
        for k in range(VAL_KEYFRAMES):
            p = pos + k * KEY_DT * vel
            g = rng.random(n) < 0.92
            d = rng.random(n) < 0.85
            nd = int(d.sum())
            ts = nusc_us(k * KEY_DT)
            gts.append(Target3DArray.from_columns(
                p[g], dim[g], yaws=yaw[g], labels=lab[g],
                scores=np.ones(int(g.sum())), mapping=N,
                tids=np.flatnonzero(g) + 1, frame="ego", timestamp=ts))
            dts.append(Target3DArray.from_columns(
                np.r_[p[d] + rng.normal(0, 0.15, (nd, 3)),
                      np.c_[rng.uniform(-45, 45, (5, 2)), np.zeros(5)]],
                np.r_[dim[d] * rng.uniform(0.95, 1.05, (nd, 3)),
                      rng.uniform(0.6, 5.0, (5, 3))],
                yaws=np.r_[yaw[d] + rng.normal(0, 0.05, nd),
                           rng.uniform(-np.pi, np.pi, 5)],
                labels=np.r_[lab[d], rng.choice(labels, 5)],
                scores=np.r_[rng.uniform(0.3, 1.0, nd),
                             rng.uniform(0.05, 0.6, 5)], mapping=N,
                tids=np.r_[np.flatnonzero(d) + 1001,
                           noise + 10 * k + np.arange(5)],
                frame="ego", timestamp=ts))
        scenes.append((gts, dts))
    return scenes


@contextlib.contextmanager
def timed_sequence_parts(dev, parts):
    """Adds the seconds of TrackingEvaluator's table chunks and of the
    sequence scan (each ending in a synchronise) into ``parts``."""
    from d3d_tpu_torch import benchmarks as BM
    from d3d_tpu_torch import benchmarks_device as BD

    real_scan, real_chunks = (BD.tracking_match_scan,
                              BM.TrackingEvaluator._table_chunks)

    def sync():
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()

    def scan(*a, **kw):
        t0 = time.perf_counter()
        out = real_scan(*a, **kw)
        sync()
        parts["scan"] += time.perf_counter() - t0
        return out

    def chunks(self, *a, **kw):
        it = real_chunks(self, *a, **kw)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            sync()
            parts["tables"] += time.perf_counter() - t0
            yield item

    BD.tracking_match_scan = scan
    BM.TrackingEvaluator._table_chunks = chunks
    try:
        yield parts
    finally:
        BD.tracking_match_scan = real_scan
        BM.TrackingEvaluator._table_chunks = real_chunks


def eval_scenes(ev, scenes, dev):
    """calc_stats_sequence over scenes, one sequence each; (seconds, the
    table chunks' and the scan's seconds)."""
    parts = dict(tables=0.0, scan=0.0)
    with timed_sequence_parts(dev, parts):
        t0 = time.perf_counter()
        for gts, dts in scenes:
            ev.calc_stats_sequence(gts, dts)
        total = time.perf_counter() - t0
    return total, parts


def tracking_at_scale(dev):
    """The tracking evaluator and the nuScenes protocol at nuScenes val's
    shape: the first VAL_CHECKED_SCENES scenes on the card and on the CPU
    (counters exact), then the rest on the card while the budget lasts
    (the scene count cut and printed where it does not), timed as ms a
    frame with the table chunks, the scan and the host bookkeeping apart;
    the official nuScenes protocol over the same frames, its first
    scenes' results equal to the CPU's."""
    from d3d_tpu_torch.benchmarks_nuscenes import evaluate_nuscenes_official
    from d3d_tpu_torch.dataset.nuscenes import NuscenesDetectionClass as N

    t0 = time.perf_counter()
    head = val_scale_scenes(0, VAL_CHECKED_SCENES)
    gen_s = time.perf_counter() - t0
    evs = tracking_evaluators(dev)
    cpu_s, _ = eval_scenes(evs["cpu"], head, "cpu")
    card_s, card_parts = eval_scenes(evs[dev], head, dev)
    same_tracking_stats(f"val scale, first {VAL_CHECKED_SCENES} scenes, "
                        "card vs CPU", evs[dev].get_stats(),
                        evs["cpu"].get_stats())
    per_scene = card_s / len(head)
    n = min(VAL_SCENES, VAL_CHECKED_SCENES
            + int(max(0.0, VAL_BUDGET_S - card_s) / per_scene))
    if n < VAL_SCENES:
        log(f"val-scale tracking: cut to {n} of {VAL_SCENES} scenes "
            f"({per_scene:.2f} s a scene on the card; budget "
            f"{VAL_BUDGET_S:.0f} s)")
    t0 = time.perf_counter()
    scenes = head + val_scale_scenes(VAL_CHECKED_SCENES, n)
    gen_s += time.perf_counter() - t0
    rest_s, rest_parts = eval_scenes(evs[dev], scenes[VAL_CHECKED_SCENES:],
                                     dev)
    frames = n * VAL_KEYFRAMES
    total_s = card_s + rest_s
    tables_s = card_parts["tables"] + rest_parts["tables"]
    scan_s = card_parts["scan"] + rest_parts["scan"]
    classes = [N[c] for c in NUSC_TRACKING]
    gts = [g for s in scenes for g in s[0]]
    dts = [d for s in scenes for d in s[1]]
    hg = [g for s in head for g in s[0]]
    hd = [d for s in head for d in s[1]]
    res = {d: evaluate_nuscenes_official(hg, hd, classes, device=d)
           for d in (dev, "cpu")}
    check(res[dev]["ap"] == res["cpu"]["ap"]
          and res[dev]["tp_errors"] == res["cpu"]["tp_errors"],
          "val scale: the official nuScenes metrics differ card vs CPU")
    t1 = time.perf_counter()
    official = evaluate_nuscenes_official(gts, dts, classes, device=dev)
    official_s = time.perf_counter() - t1
    m = tracking_metrics(evs[dev])
    stats = dict(
        scenes=n, frames=frames, generate_s=gen_s,
        ms_per_frame=total_s / frames * 1e3,
        tables_ms_per_frame=tables_s / frames * 1e3,
        scan_ms_per_frame=scan_s / frames * 1e3,
        host_ms_per_frame=(total_s - tables_s - scan_s) / frames * 1e3,
        cpu_ms_per_frame=cpu_s / (len(head) * VAL_KEYFRAMES) * 1e3,
        official_ms_per_frame=official_s / frames * 1e3,
        official_map=official["mean_ap"], official_nds=official["nds"],
        **m)
    log(f"val-scale tracking: {n} scenes x {VAL_KEYFRAMES} keyframes "
        f"({frames} frames, generated in {gen_s:.1f} s): "
        f"{stats['ms_per_frame']:.2f} ms a frame on the card (table chunks "
        f"{stats['tables_ms_per_frame']:.2f}, scan "
        f"{stats['scan_ms_per_frame']:.2f}, host bookkeeping "
        f"{stats['host_ms_per_frame']:.2f}; the CPU "
        f"{stats['cpu_ms_per_frame']:.2f} ms a frame on the first "
        f"{VAL_CHECKED_SCENES} scenes, equal); MOTA(car) "
        f"{m['mota_car']:.4f}, AMOTA(car) {m['amota_car']:.4f}; official "
        f"nuScenes protocol {stats['official_ms_per_frame']:.3f} ms a frame,"
        f" mAP {official['mean_ap']:.4f}, NDS {official['nds']:.4f}")
    return stats


def nuscenes_track_eval(dev, vn):
    """The nuscenes_track_eval path: raw nuScenes tables of the
    voxelnext_track scene -> the port's converter -> NuscenesLoader ->
    accumulate_sweeps -> presets.voxelnext_nuscenes uncut (bf16, the
    phase's seeded weights) through make_tracking_step, counts read per
    request (K5 11, one rule-book call, K1's bit form and the scan once)
    -> the tracks (the device tracker's reports, keyframe sensor frames)
    scored by TrackingEvaluator.calc_stats_sequence against the loader's
    annotations (ego frame, through the loader's calibration) and the
    detections by evaluate_nuscenes_detection and
    evaluate_nuscenes_official, each equal to the same call on the CPU;
    the stand-in tracks held to their floors; then the evaluators at
    nuScenes val's shape. Returns (counts, stats)."""
    from d3d_tpu_torch.models import make_voxelnext_detector, presets
    from d3d_tpu_torch.models.inference import _to_tracking_targets
    from d3d_tpu_torch.tracking import make_tracking_step
    from d3d_tpu_torch.tracking.device_tracker import tracker_report

    t_phase = time.perf_counter()
    reset_counts()
    loader, clouds, stats = nuscenes_input(vn)
    classes = head_classes()
    cfg = presets.voxelnext_nuscenes()
    detect = make_voxelnext_detector(vn["model16"], None, cfg, classes,
                                     device=dev)
    step = make_tracking_step(detect.device_fn, NUSC_GATES,
                              lost_time=TRACK_LOST_TIME,
                              capacity=TRACK_CAPACITY, score_threshold=0.3)
    state = step.init()
    calib = loader.calibration_data(0)
    total = {}
    per_request = []
    tracks, dets_ego, gts = [], [], []
    want = want_counts(rbox_iou_matrix=1, nms_scan=1,
                       subm_conv=len(VN_LAYERS), subm_conv_rulebook=1,
                       build_stage_maps=1)
    for k, pts in enumerate(clouds):
        before = read_counts()
        state, out = step(state, pts, 0.0 if k == 0 else KEY_DT)
        after = read_counts()
        c = {key: after[key] - before[key] for key in after}
        check(c == want, f"nuscenes_track_eval request {k}: launches {c}, "
                         f"want {want}")
        per_request.append(c)
        ts = loader.timestamp(k)
        tracks.append(tracker_report(state, classes, "lidar_top", ts))
        det = _to_tracking_targets(*(t.cpu().numpy() for t in out), classes,
                                   "lidar_top", ts, 0.3)
        dets_ego.append(calib.transform_objects(det, frame_to="ego"))
        gts.append(loader.annotation_3dobject(k))
    counts = read_counts()
    check_nms_routes("nuscenes_track_eval", KEYFRAMES)
    check(all(len(g) > 0 for g in gts) and sum(len(t) for t in tracks) > 0,
          "nuscenes_track_eval: no annotations or no tracks")
    t0 = time.perf_counter()
    ev = score_tracks("VoxelNeXt tracks", gts, tracks, dev, calib=calib)
    stats["track_eval_ms"] = (time.perf_counter() - t0) * 1e3
    stats["voxelnext_tracks"] = tracking_metrics(ev)
    det_classes = classes
    stats["voxelnext_protocols"] = nuscenes_protocols(
        "VoxelNeXt detections", gts, dets_ego, det_classes, dev)
    stats["stand_in"] = stand_in_scoring(dev, vn["scene"], gts)
    stats["val_scale"] = tracking_at_scale(dev)
    stats.update(launches=counts, launches_per_request=per_request[0],
                 phase_s=time.perf_counter() - t_phase)
    vt = stats["voxelnext_tracks"]
    log(f"nuscenes_track_eval: {KEYFRAMES} requests, launches {counts} "
        f"({per_request[0]} each); VoxelNeXt tracks (random weights) "
        f"MOTA(car) {vt['mota_car']:.4f}, AMOTA(car) {vt['amota_car']:.4f}"
        f", scored in {stats['track_eval_ms']:.1f} ms on the card, equal "
        f"to the CPU; detections: nuScenes mAP "
        f"{stats['voxelnext_protocols']['official_map']:.4f}, NDS "
        f"{stats['voxelnext_protocols']['official_nds']:.4f}; phase "
        f"{stats['phase_s']:.1f} s")
    return counts, stats


# ---------------------------------------------------------------------------
# centerpoint_track: CenterPoint (one- and two-stage) at the nuScenes
# 10-sweep preset's full width into the device tracker, its training and
# the refine stage's, PointPainting (Seg2D -> a camera rig -> SECOND), and
# aligned_scatter / nearest_neighbor at scale
# ---------------------------------------------------------------------------

CP_STEPS = 3          # training steps a dtype, and of the refine stage
CAMERAS = (("CAM_FRONT", 0.0), ("CAM_FRONT_RIGHT", -55.0),
           ("CAM_FRONT_LEFT", 55.0), ("CAM_BACK_RIGHT", -110.0),
           ("CAM_BACK_LEFT", 110.0), ("CAM_BACK", 180.0))
CAM_SIZE = (448, 800)   # nuScenes' 900 x 1600 halved, divisible by 8
SEG_CLASSES = 11        # nuScenes-lidarseg's 10 detection classes + other
NN_QUERIES, NN_REFS, NN_CPU_QUERIES = 100_000, 500_000, 2048
SCATTER_POINTS = 100_000
CP_HEAD_SD = dict(hm=2.0, reg=0.3, height=0.3, dim=0.3, rot=0.3, vel=0.3)


def cp_preset(**kw):
    """The phase's configuration: the nuScenes 10-sweep preset, uncut."""
    from d3d_tpu_torch.models import presets

    return presets.centerpoint_nuscenes_10sweep(**kw)


def calibrate_center_heads(model, pts, dev):
    """Rescale CenterPoint's random heads (a model built with
    ``return_feat=True``) so their outputs over the occupied BEV cells
    (those whose shared feature is not 0) spread like a trained model's:
    heatmap logits sd 2 about the -2.19 bias, regressions sd 0.3
    (CP_HEAD_SD). Returns (occupied share of the canvas, peaks above
    0.3)."""
    from d3d_tpu_torch.models import pillarize
    from d3d_tpu_torch.models.centerpoint import _heads, decode_centers

    cfg = model.cfg
    with torch.inference_mode():
        f, c, v = pillarize(torch.from_numpy(pts).to(dev), cfg)
        out = {k: t[0] for k, t in model(f[None], c[None], v[None]).items()}
    occupied = (out["feat"] != 0).any(dim=-1)
    for name, _ in _heads(cfg):
        last = model.heads[f"{name}_out"]
        o = out["heatmap" if name == "hm" else name][occupied] \
            - last.bias.detach()
        with torch.no_grad():
            last.weight.mul_(CP_HEAD_SD[name] / float(o.std()))
    with torch.inference_mode():
        out = {k: t[0] for k, t in model(f[None], c[None], v[None]).items()}
        scores = decode_centers(cfg, out)[1]
    return float(occupied.float().mean()), int((scores > 0.3).sum())


def calibrate_centerpoint(model, refine, pts, dev):
    """``calibrate_center_heads``, then the refine stage's output rescaled
    so its confidence logits spread with sd 1 and its residuals with sd
    0.05 on this frame's proposals. Returns (occupied share of the canvas,
    peaks above 0.3)."""
    from d3d_tpu_torch.models import pillarize, roi_grid_features
    from d3d_tpu_torch.models.centerpoint import decode_centers

    share, peaks = calibrate_center_heads(model, pts, dev)
    cfg = model.cfg
    with torch.inference_mode():
        f, c, v = pillarize(torch.from_numpy(pts).to(dev), cfg)
        out = {k: t[0] for k, t in model(f[None], c[None], v[None]).items()}
        boxes = decode_centers(cfg, out)[0]
        pooled = roi_grid_features(out["feat"], boxes, cfg.bounds, cfg.grid,
                                   refine.cfg.grid_points)
        r = refine(pooled, boxes)
    with torch.no_grad():
        refine.out.weight[0].mul_(1.0 / float(r["conf"].std()))
        refine.out.weight[1:].mul_(0.05 / float(r["deltas"].std()))
    return share, peaks


def centerpoint_setup(dev, vn):
    """CenterPoint on the 10-sweep preset at full width: f32 and the bf16
    preset on the same seeded weights (heads calibrated on keyframe 0),
    the refine stage (RefineConfig's defaults), on VoxelNeXt's
    nuScenes-like keyframes (5 columns)."""
    from d3d_tpu_torch.models import CenterPoint, CenterPointRefine
    from d3d_tpu_torch.models import RefineConfig

    cfg32 = cp_preset(dtype="float32")
    feat_c = cfg32.upsample_channels * len(cfg32.backbone_channels)
    model32 = CenterPoint(cfg32, return_feat=True, point_features=5,
                          device=dev,
                          generator=torch.Generator().manual_seed(12))
    refine = CenterPointRefine(RefineConfig(), feat_c, device=dev,
                               generator=torch.Generator().manual_seed(13))
    share, peaks = calibrate_centerpoint(model32, refine, vn["clouds"][0],
                                         dev)
    model16 = CenterPoint(cp_preset(), return_feat=True, point_features=5,
                          device=dev)
    model16.load_state_dict(model32.state_dict())
    log(f"CenterPoint ({cfg32.grid[0]} x {cfg32.grid[1]} canvas, "
        f"{cfg32.max_pillars} pillars x {cfg32.max_points_per_pillar} "
        f"points, {feat_c}-channel BEV map) heads calibrated over keyframe "
        f"0's occupied cells ({share:.1%} of the canvas; {peaks} peaks "
        "above 0.3)")
    return dict(cfg32=cfg32, model32=model32, model16=model16,
                refine=refine, feat_c=feat_c, occupied_share=share,
                peaks=peaks)


def cp_detectors(cp, dev, dtype="bfloat16"):
    """The one- and two-stage detectors of the ``dtype`` model."""
    from d3d_tpu_torch.models import make_centerpoint_detector

    model = cp["model16" if dtype == "bfloat16" else "model32"]
    rcfg = cp["refine"].cfg
    return {stages: make_centerpoint_detector(
        model, None, model.cfg, model.cfg, nusc_classes(), device=dev,
        refine=(cp["refine"], None, rcfg) if stages == "two" else None)
        for stages in ("one", "two")}


def centerpoint_serving(dev, cp, clouds):
    """One- and two-stage requests (bf16 preset) per keyframe, counts read
    per request (K1's bit rows and the scan once each, nms2d's route),
    the outputs TrackingTarget3Ds; then each route's steady request
    (host clock and CUDA events, median of 10 after a warm-up) and the
    card's busy share over 5 requests."""
    from torch.profiler import ProfilerActivity, profile

    dets = cp_detectors(cp, dev)
    counts, stats = {}, {}
    for stages, detect in dets.items():
        ms, kept = [], []
        for k, pts in enumerate(clouds):
            reset_counts()
            out, dev_ms, _ = timed(lambda: detect(pts, frame="velo",
                                                  timestamp=k))
            c = read_counts()
            check(c == want_counts(rbox_iou_matrix=1, nms_scan=1),
                  f"CenterPoint {stages}-stage request {k}: launches {c}")
            check_nms_routes(f"CenterPoint {stages}-stage request", 1)
            add_counts(counts, c)
            check(all(type(o).__name__ == "TrackingTarget3D" for o in out)
                  and all(np.isfinite(o.velocity).all()
                          and np.isfinite(o.position).all() for o in out),
                  f"CenterPoint {stages}-stage: not finite TrackingTarget3Ds")
            ms.append(dev_ms)
            kept.append(len(out))
        n = len(clouds)
        for i in range(3):
            detect.device_fn(clouds[i % n])
        steady = [timed(lambda: detect.device_fn(clouds[i % n]))
                  for i in range(10)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(5):
                detect.device_fn(clouds[i % n])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = busy_share(prof, wall)
        stats[stages] = dict(
            request_ms=ms, kept=kept,
            steady_ms=statistics.median(s[1] for s in steady),
            steady_host_ms=statistics.median(s[2] for s in steady),
            busy_share=busy)
        log(f"CenterPoint {stages}-stage serving (bf16 preset): requests "
            + ", ".join(f"{m:.2f}" for m in ms) + " ms by CUDA events (the "
            f"first cold), steady {stats[stages]['steady_ms']:.2f} ms (host "
            f"{stats[stages]['steady_host_ms']:.2f} ms, median of 10); busy "
            f"share {busy if busy is None else round(busy, 3)}; kept {kept}")
    return counts, stats, dets


def cp_top_indices(cfg, heads):
    """decode_centers' flat top-k indices over (W, H, C) (its first
    steps), to compare two sides' selections."""
    hm = torch.sigmoid(heads["heatmap"])
    pooled = torch.nn.functional.max_pool2d(hm.permute(2, 0, 1)[None], 3, 1,
                                            1)[0].permute(1, 2, 0)
    flat = torch.where(hm >= pooled, hm, 0.0).reshape(-1)
    return torch.sort(flat, descending=True, stable=True).indices[:cfg.top_k]


def centerpoint_card_vs_cpu(dev, cp, pts):
    """Keyframe ``pts`` through the f32 model on the card (TF32 off) and
    the same weights on the CPU: every head and the BEV map within 1e-4
    of its largest magnitude, the decode's top-k indices equal; the
    one- and two-stage detectors' boxes from the CPU's outputs at those
    indices within 2e-3 m / 2e-3 relative / 2e-2 rad, scores within
    1e-4; the CPU's NMS on the card's boxes equal to the card's keep
    masks. Returns the f32 request ms and the CPU network's ms."""
    from d3d_tpu_torch.models import (CenterPoint, CenterPointRefine,
                                      pillarize)
    from d3d_tpu_torch.models.inference import _bev
    from d3d_tpu_torch.ops.nms import nms2d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cp["cfg32"]
    cpu_model = CenterPoint(cfg, return_feat=True, point_features=5,
                            device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               cp["model32"].state_dict().items()})
    cpu_refine = CenterPointRefine(cp["refine"].cfg, cp["feat_c"],
                                   device="cpu")
    cpu_refine.load_state_dict({k: v.cpu() for k, v in
                                cp["refine"].state_dict().items()})
    raw, ms = [], []
    for m, d in ((cp["model32"], dev), (cpu_model, "cpu")):
        t0 = time.perf_counter()
        with torch.inference_mode():
            f, c, v = pillarize(torch.from_numpy(pts).to(d), cfg)
            raw.append({k: t[0] for k, t in
                        m(f[None], c[None], v[None]).items()})
        if d != "cpu":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    g, c = {k: t.cpu() for k, t in raw[0].items()}, raw[1]
    errs = {k: float((g[k] - c[k]).abs().max() / c[k].abs().max())
            for k in c}
    check(max(errs.values()) <= 1e-4, f"CenterPoint card vs CPU: {errs}")
    heads_g = {k: v for k, v in g.items() if k != "feat"}
    heads_c = {k: v for k, v in c.items() if k != "feat"}
    idx = cp_top_indices(cfg, heads_g)
    check(torch.equal(idx, cp_top_indices(cfg, heads_c)),
          "CenterPoint card vs CPU: the decode's top-k indices differ")
    dets = cp_detectors(cp, dev, "float32")
    stats = dict(head_err=errs, cpu_network_ms=ms[1], f32_network_ms=ms[0])
    for stages, detect in dets.items():
        out, f32_ms, _ = timed(lambda: [t.cpu() for t in
                                        detect.device_fn(pts)])
        stats[f"{stages}_stage_f32_request_ms"] = f32_ms
        boxes_c, scores_c = cpu_decode(cfg, heads_c, c["feat"], cpu_refine
                                       if stages == "two" else None)
        pos_err = float((boxes_c[:, :3] - out[0][:, :3]).abs().max())
        size_err = float(((boxes_c[:, 3:6] - out[0][:, 3:6])
                          / out[0][:, 3:6]).abs().max())
        dyaw = torch.remainder(boxes_c[:, 6] - out[0][:, 6] + math.pi,
                               2 * math.pi) - math.pi
        yaw_err = float(dyaw.abs().max())
        score_err = float((scores_c - out[1]).abs().max())
        check(pos_err <= 2e-3 and size_err <= 2e-3 and yaw_err <= 2e-2
              and score_err <= 1e-4,
              f"CenterPoint {stages}-stage card vs CPU: position {pos_err}, "
              f"size {size_err}, yaw {yaw_err}, score {score_err}")
        keep_cpu = ~nms2d(_bev(out[0]), out[1].float(), iou_threshold=0.5)
        check(torch.equal(keep_cpu, out[3]),
              f"CenterPoint {stages}-stage keep mask card vs CPU")
        stats[f"{stages}_stage_errors"] = dict(
            position_m=pos_err, size=size_err, yaw_rad=yaw_err,
            score=score_err, kept=int(out[3].sum()))
        log(f"CenterPoint {stages}-stage card vs CPU (f32, TF32 off): top-"
            f"{cfg.top_k} indices equal; positions {pos_err:.3g} m, sizes "
            f"{size_err:.3g}, yaw {yaw_err:.3g} rad, scores {score_err:.3g}; "
            f"keep mask equal ({int(out[3].sum())} kept); f32 request "
            f"{f32_ms:.2f} ms")
    log(f"CenterPoint card vs CPU: heads and BEV map within "
        f"{max(errs.values()):.3g} of their largest magnitudes; the f32 "
        f"network {ms[0]:.1f} ms on the card (first call), {ms[1]:.0f} ms "
        "on the CPU")
    return stats


def cpu_decode(cfg, heads, feat, refine=None):
    """The detector's boxes and scores from one side's raw outputs (the
    refine stage on that side when given)."""
    from d3d_tpu_torch.models import apply_refinements, roi_grid_features
    from d3d_tpu_torch.models.centerpoint import decode_centers

    with torch.inference_mode():
        boxes, scores = decode_centers(cfg, heads)[:2]
        if refine is not None:
            pooled = roi_grid_features(feat, boxes, cfg.bounds, cfg.grid,
                                       refine.cfg.grid_points)
            out = refine(pooled, boxes)
            boxes = apply_refinements(boxes, out["deltas"])
            a = refine.cfg.score_alpha
            scores = scores ** (1 - a) * torch.sigmoid(out["conf"]) ** a
    return boxes, scores


def centerpoint_tracking(dev, detect, clouds):
    """make_tracking_step over the two-stage detector (bf16) at dt = 0.5 s,
    counts read over the run (K1's bit rows and the scan once a frame);
    the same detections through tracker_update on the CPU, the slot
    tables equal frame by frame (ids, labels, masks, next id exact; the
    floats within 1e-5, as ``tracker_card_vs_cpu``); then detect and the
    tracker timed apart."""
    from d3d_tpu_torch.tracking import make_tracking_step
    from d3d_tpu_torch.tracking.device_tracker import (tracker_init,
                                                       tracker_update)

    step = make_tracking_step(detect.device_fn, NUSC_GATES,
                              lost_time=TRACK_LOST_TIME,
                              capacity=TRACK_CAPACITY, score_threshold=0.3)
    state, cpu_state = step.init(), tracker_init(TRACK_CAPACITY, "cpu")
    reset_counts()
    frame_ms, active, worst, exact = [], [], 0.0, True
    for k, pts in enumerate(clouds):
        dt = 0.0 if k == 0 else KEY_DT
        (state, out), ms, _ = timed(lambda: step(state, pts, dt))
        frame_ms.append(ms)
        active.append(int(state["active"].sum()))
        boxes, scores, labels, keep, vel = (t.cpu() for t in out)
        scores = scores.float()
        cpu_state = tracker_update(cpu_state, boxes, scores, labels, vel,
                                   keep & (scores >= 0.3), dt, NUSC_GATES,
                                   TRACK_LOST_TIME)
        a = {key: t.cpu() for key, t in state.items()}
        for key in ("tid", "label", "active", "next_tid"):
            check(torch.equal(a[key], cpu_state[key]),
                  f"CenterPoint tracking frame {k}: {key} card vs CPU")
        for key in ("boxes", "vel", "score", "lost", "history"):
            err = float((a[key] - cpu_state[key]).abs().max())
            exact = exact and err == 0.0
            worst = max(worst, err)
            check(err <= 1e-5, f"CenterPoint tracking frame {k}: {key} "
                               f"{err}")
    n = len(clouds)
    counts = read_counts()
    check(counts == want_counts(rbox_iou_matrix=n, nms_scan=n),
          f"CenterPoint tracking: launches {counts}")
    check_nms_routes("CenterPoint tracking", n)
    check(int(state["next_tid"]) > 1 and active[-1] > 0,
          f"CenterPoint tracking: no track ({active})")
    state = step.init()
    det_ms, trk_ms = [], []
    for k, pts in enumerate(clouds):
        out, ms, _ = timed(lambda: detect.device_fn(pts))
        det_ms.append(ms)
        boxes, scores, labels, keep, vel = out
        args = (boxes, scores.float(), labels, vel,
                keep & (scores.float() >= 0.3), 0.0 if k == 0 else KEY_DT,
                step_thresholds(dev), TRACK_LOST_TIME)
        state, ms, _ = timed(lambda: tracker_update(state, *args))
        trk_ms.append(ms)
    log(f"CenterPoint tracking (two-stage, bf16, fused step): frame "
        + ", ".join(f"{m:.2f}" for m in frame_ms) + " ms by CUDA events; "
        f"active tracks {active}; slot tables card vs CPU: ids and masks "
        f"equal, floats within {worst:.3g} (bit-equal: {exact}); apart: "
        "detect " + ", ".join(f"{m:.2f}" for m in det_ms) + " ms, tracker "
        + ", ".join(f"{m:.2f}" for m in trk_ms) + " ms")
    return counts, dict(frame_ms=frame_ms, active=active, detect_ms=det_ms,
                        tracker_ms=trk_ms, tables_max_err=worst,
                        tables_bit_equal=exact)


def cp_batch(dev, cfg, scene, clouds, keys=(0, 3)):
    """A training batch of two keyframes: their pillars stacked, their
    objects as ground truth with BEV velocities, padded to VN_MAX_GT. The
    10-sweep preset has one class (the JAX package's preset), so every
    object is labelled 0."""
    from d3d_tpu_torch.models import pillarize

    with torch.inference_mode():
        pil = [pillarize(torch.from_numpy(clouds[k]).to(dev), cfg)
               for k in keys]
    batch = voxelnext_batch(dev, cfg, scene, pil, keys)
    batch["gt_labels"] = torch.zeros_like(batch["gt_labels"])
    return batch


def check_collided_targets(dev, cfg, batch):
    """Two ground-truth boxes in one centre cell (keyframe 0's first box
    and a copy at its centre, the copy later and larger): assign_center_targets
    on the card equal to the CPU's (heatmap and vec within 1e-6, mask
    exact), the cell holding the later box's vector."""
    from d3d_tpu_torch.models import assign_center_targets

    gt = batch["gt_boxes"][0].clone()
    mask = batch["gt_mask"][0].clone()
    labels = batch["gt_labels"][0].clone()
    vel = batch["gt_velocity"][0].clone()
    j = min(int(mask.sum()), len(mask) - 1)
    gt[j] = gt[0] + torch.tensor([0, 0, 0, 0.5, 0.2, 0, 0.1], device=dev)
    mask[j], labels[j], vel[j] = True, labels[0], vel[0] + 1.0
    outs = [assign_center_targets(cfg, *(t.to(d) for t in (gt, labels, mask,
                                                           vel)))
            for d in (dev, "cpu")]
    a = {k: v.cpu() for k, v in outs[0].items()}
    b = outs[1]
    check(torch.equal(a["mask"], b["mask"]), "collided targets: mask")
    err = max(float((a[k] - b[k]).abs().max()) for k in ("heatmap", "vec"))
    check(err <= 1e-6, f"collided targets: card vs CPU {err}")
    vx, vy, _ = cfg.voxel_size
    ix = int((float(gt[0, 0]) - cfg.bounds[0]) / vx)
    iy = int((float(gt[0, 1]) - cfg.bounds[2]) / vy)
    check(ix == int((float(gt[j, 0]) - cfg.bounds[0]) / vx)
          and iy == int((float(gt[j, 1]) - cfg.bounds[2]) / vy),
          "collided targets: the boxes are not in one cell")
    cell = a["vec"][ix, iy]
    check(abs(math.exp(float(cell[3])) - float(gt[j, 3])) < 1e-4
          and abs(float(cell[8]) - float(vel[j, 0])) < 1e-6,
          "collided targets: the later box does not win its cell")
    log(f"collided targets: two boxes in cell ({ix}, {iy}), the later one's "
        f"vector kept; card equal to CPU within {err:.3g}")
    return err


def centerpoint_training(dev, cp, batch, dtype):
    """make_train_step at full width, batch 2 (keyframes 0 and 3), from
    the calibrated f32 weights in ``dtype`` (f32 with TF32 off), CP_STEPS
    steps, counts read per step (dense convolutions: no kernel of the
    port's). Losses finite. Returns (summed counts, stats)."""
    from d3d_tpu_torch.models import CenterPoint
    from d3d_tpu_torch.models.centerpoint import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    cfg = cp_preset(dtype=dtype)
    model = CenterPoint(cfg, point_features=5, device=dev)
    model.load_state_dict(cp["model32"].state_dict())
    opt, _ = make_optimizer(model.parameters(), total_steps=CP_STEPS)
    step = make_train_step(model, opt, cfg)
    total, losses, step_ms = {}, [], []
    for i in range(CP_STEPS):
        reset_counts()
        aux, ms, _ = timed(lambda: step(batch))
        c = read_counts()
        check(c == want_counts(), f"CenterPoint training {dtype} step "
                                  f"{i + 1}: launches {c}")
        add_counts(total, c)
        step_ms.append(ms)
        losses.append({k: float(v) for k, v in aux.items()})
        check(all(math.isfinite(v) for v in losses[-1].values()),
              f"CenterPoint training {dtype}: loss {losses[-1]}")
    check(all(p.grad is not None and bool(torch.isfinite(p.grad).all())
              for p in model.parameters()),
          f"CenterPoint training {dtype}: a gradient not finite")
    log(f"CenterPoint training {dtype} (batch 2): losses "
        + ", ".join(f"{l['total']:.4f}" for l in losses) + "; step "
        + ", ".join(f"{m:.2f}" for m in step_ms) + " ms (CUDA events)")
    del model, opt
    return total, dict(losses=[l["total"] for l in losses], step_ms=step_ms)


def refine_training(dev, cp, batch):
    """make_refine_train_step over the frozen f32 first stage (TF32 off),
    batch 2, CP_STEPS steps, counts read per step: K1's float32 form once
    a frame (the targets' IoU), nothing else; the first step's targets'
    K1 matrix held to its plain version as ``check_k1`` holds it."""
    from d3d_tpu_torch.models import CenterPointRefine
    from d3d_tpu_torch.models.centerpoint import decode_centers
    from d3d_tpu_torch.models.centerpoint2 import make_refine_train_step

    cfg = cp["cfg32"]
    refine = CenterPointRefine(cp["refine"].cfg, cp["feat_c"], device=dev)
    refine.load_state_dict(cp["refine"].state_dict())
    opt = torch.optim.AdamW(refine.parameters(), lr=1e-3)
    step = make_refine_train_step(cp["model32"], None, refine, cfg,
                                  refine.cfg, opt)
    with torch.inference_mode():
        out = {k: t[0] for k, t in cp["model32"](
            batch["features"][:1], batch["coords"][:1],
            batch["valid"][:1]).items()}
        rois = decode_centers(cfg, out)[0]
    bev = [torch.cat([b[:, 0:2], b[:, 3:5], b[:, 6:7]], -1).contiguous()
           for b in (rois, batch["gt_boxes"][0])]
    k1_err, _ = k1_case("refine targets (rois x gt)", *bev)
    losses, step_ms, total = [], [], {}
    for i in range(CP_STEPS):
        reset_counts()
        aux, ms, _ = timed(lambda: step(batch))
        c = read_counts()
        routes = read_routes()
        check(c == want_counts(rbox_iou_matrix=2) and routes["k1_matrix"]
              == 2 and routes["k1_bits"] == 0,
              f"refine training step {i + 1}: launches {c}, routes {routes}")
        add_counts(total, c)
        step_ms.append(ms)
        losses.append(float(aux["total"]))
        check(math.isfinite(losses[-1]), f"refine training: {losses[-1]}")
    log(f"refine training (frozen f32 first stage, batch 2): losses "
        + ", ".join(f"{l:.4f}" for l in losses) + "; step "
        + ", ".join(f"{m:.2f}" for m in step_ms) + " ms (CUDA events); K1's "
        "f32 form 2 a step")
    return total, dict(losses=losses, step_ms=step_ms, k1_err=k1_err)


def nuscenes_rig():
    """A seeded nuScenes-like camera rig in the port's TransformSet: six
    pinhole cameras (CAM_SIZE, f = 630 px, rotate=True: FLU -> RDF folded
    into the projection) at the nuScenes yaws, 1.5-1.8 m up around the
    roof, the lidar at the base frame."""
    from d3d_tpu_torch.abstraction import TransformSet

    rng = np.random.default_rng(31)
    ts = TransformSet("ego")
    ts.set_intrinsic_lidar("LIDAR_TOP")
    ts.set_extrinsic(np.eye(4), frame_to="LIDAR_TOP")
    h, w = CAM_SIZE
    for name, yaw in CAMERAS:
        ts.set_intrinsic_pinhole(name, (w, h), w / 2, h / 2, 630.0, 630.0)
        psi = np.deg2rad(yaw + rng.normal(0, 0.5))
        pos = np.array([1.0 * np.cos(psi), 0.6 * np.sin(psi),
                        rng.uniform(0.0, 0.3)])
        rot = np.array([[np.cos(psi), np.sin(psi), 0],
                        [-np.sin(psi), np.cos(psi), 0], [0, 0, 1]])
        t = np.eye(4)
        t[:3, :3] = rot
        t[:3, 3] = -rot @ pos
        ts.set_extrinsic(t, frame_to=name)
    return ts


def painting_path(dev, scene):
    """PointPainting on keyframe 0's own sweep (4 columns): six seeded
    camera images through a Seg2D segmenter (default channels,
    CAM_SIZE, SEG_CLASSES classes), ``painting_rig`` of the nuScenes-like
    rig, ``paint_points_multi`` on the card and on the CPU (within
    1e-5), then the painted cloud (15 columns) through SECOND in bf16 (K5
    at C = 15, padded; checked against its plain version at the first
    layer), counts read over the request. Returns (counts, stats)."""
    from d3d_tpu_torch.models import (SECOND, Seg2D, Seg2DConfig,
                                      head_config, make_anchors,
                                      make_second_detector, make_segmenter,
                                      presets, second_voxelize)
    from d3d_tpu_torch.ops.painting import paint_points_multi, painting_rig

    seg = make_segmenter(Seg2D(Seg2DConfig(image_size=CAM_SIZE,
                                           num_classes=SEG_CLASSES),
                               device=dev,
                               generator=torch.Generator().manual_seed(21)),
                         device=dev)
    rng = np.random.default_rng(22)
    images = torch.from_numpy(rng.random((len(CAMERAS),) + CAM_SIZE + (3,),
                                         dtype=np.float32)).to(dev)
    seg(images[0])
    scores, seg_ms, _ = timed(lambda: torch.stack([seg(im) for im in images]))
    ks, exts = painting_rig(nuscenes_rig(), [c for c, _ in CAMERAS],
                            frame_from="LIDAR_TOP")
    ts_, world, inten = nuscenes_sweep_parts(scene, 0)[0]
    sweep = np.concatenate([world - [ego_x(key_time(0)), 0.0, 0.0],
                            inten[:, None]], 1).astype(np.float32)
    args = [torch.from_numpy(a) for a in (sweep, ks, exts)]
    painted, paint_ms, _ = timed(lambda: paint_points_multi(
        args[0].to(dev), scores, args[1].to(dev), args[2].to(dev)))
    cpu = paint_points_multi(args[0], scores.cpu(), args[1], args[2])
    err = float((painted.cpu() - cpu).abs().max())
    check(painted.shape == (len(sweep), 4 + SEG_CLASSES) and err <= 1e-5,
          f"painting card vs CPU: {tuple(painted.shape)}, {err}")
    seen = float((painted[:, 4:].sum(-1) > 0).float().mean())
    cfg16 = presets.second_kitti()
    model = SECOND(cfg16, point_features=4 + SEG_CLASSES, device=dev,
                   generator=torch.Generator().manual_seed(23))
    pts = painted.cpu().numpy()
    calibrate_heads(model, pts, dev, second_voxelize, occupied_only=True)
    layers = second_layer_inputs(model, pts, dev)
    k5_err, _ = check_k5({"subm0_0": layers["subm0_0"]}, None,
                         "SECOND painted (C = 15)")
    det = make_second_detector(model, None, cfg16,
                               make_anchors(head_config(cfg16), device=dev),
                               car_classes(), device=dev)
    det(pts)
    reset_counts()
    out, req_ms, _ = timed(lambda: det(painted))
    counts = read_counts()
    check(counts == want_counts(rbox_iou_matrix=1, nms_scan=1,
                                subm_conv=len(K5_LAYERS),
                                subm_conv_rulebook=1, build_stage_maps=1),
          f"painted SECOND request: launches {counts}")
    check_nms_routes("painted SECOND request", 1)
    kept = check_detections("painted SECOND", out)
    log(f"PointPainting: Seg2D on {len(CAMERAS)} images {CAM_SIZE} "
        f"({seg_ms:.2f} ms, CUDA events), paint_points_multi on "
        f"{len(sweep)} points {paint_ms:.2f} ms ({seen:.1%} seen by a "
        f"camera), card vs CPU within {err:.3g}; SECOND bf16 on the "
        f"painted cloud (C = {4 + SEG_CLASSES}): {req_ms:.2f} ms, kept "
        f"{kept}, launches {counts}")
    return counts, dict(seg_ms=seg_ms, paint_ms=paint_ms, points=len(sweep),
                        seen_share=seen, card_vs_cpu_err=err,
                        second_request_ms=req_ms, k5_err_c15=k5_err,
                        kept=kept)


def point_ops_at_scale(dev, clouds):
    """aligned_scatter (linear, 2D) of SCATTER_POINTS points on a
    (1, 384, 512, 512) seeded map, forward and the map's gradient, card
    against CPU (within 1e-5 of the largest magnitude: the card's
    gradient adds by atomics); nearest_neighbor of NN_QUERIES queries
    (keyframe 0) in NN_REFS references (keyframes 1-2) on the card, its
    first NN_CPU_QUERIES against the CPU's (indices equal but at
    near-ties, distances within the expansion's rounding of float64).
    Returns stats."""
    from d3d_tpu_torch.ops.point import aligned_scatter, nearest_neighbor

    g = torch.Generator().manual_seed(41)
    fmap = torch.rand((1, 384, 512, 512), generator=g)
    coords = torch.cat([torch.zeros(SCATTER_POINTS, 1),
                        torch.rand((SCATTER_POINTS, 2), generator=g) * 530
                        - 9], 1)
    ct = torch.randn((SCATTER_POINTS, 384), generator=g)
    res = []
    for d in (dev, "cpu"):
        f = fmap.to(d).requires_grad_(True)
        out, ms, _ = timed(lambda: aligned_scatter(coords.to(d), f,
                                                   "linear"))
        (out * ct.to(d)).sum().backward()
        res.append((out.detach().cpu(), f.grad.cpu(), ms))
    fwd_err = float((res[0][0] - res[1][0]).abs().max()
                    / res[1][0].abs().max())
    grad_err = float((res[0][1] - res[1][1]).abs().max()
                     / res[1][1].abs().max())
    check(fwd_err <= 1e-5 and grad_err <= 1e-5,
          f"aligned_scatter card vs CPU: {fwd_err}, gradient {grad_err}")
    del fmap, res[:]
    q = clouds[0][:NN_QUERIES, :3]
    r = np.concatenate([clouds[1], clouds[2]])[:NN_REFS, :3]
    nearest_neighbor(q[:1024], r[:4096], device=dev)
    (d_card, i_card), nn_ms, _ = timed(lambda: nearest_neighbor(q, r,
                                                                device=dev))
    t0 = time.perf_counter()
    d_cpu, i_cpu = nearest_neighbor(q[:NN_CPU_QUERIES], r, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    # each side recentres on its own queries' mean, so each rounds its
    # expansion otherwise: a distance is held to the float64 one within
    # the expansion's rounding (8 float32 epsilons of |q|^2 + |r|^2, both
    # recentred), and the indices may differ only where the two picks lie
    # that close in float64
    qs, d2, bound = q[:NN_CPU_QUERIES].astype(np.float64), [], []
    for d, i, origin in ((d_card, i_card, q.mean(0)),
                         (d_cpu, i_cpu, qs.mean(0))):
        d, i = d[:NN_CPU_QUERIES], i[:NN_CPU_QUERIES]
        rr = r[i].astype(np.float64)
        b = 8 * 2.0 ** -24 * (((qs - origin) ** 2).sum(1)
                              + ((rr - origin) ** 2).sum(1))
        exact = ((qs - rr) ** 2).sum(1)
        check(bool((np.abs(d.astype(np.float64) ** 2 - exact) <= b).all()),
              "nearest_neighbor: a distance off its float64 value")
        d2.append(exact)
        bound.append(b)
    apart = i_card[:NN_CPU_QUERIES] != i_cpu
    check(bool((np.abs(d2[0] - d2[1]) <= bound[0] + bound[1])[apart].all())
          and len(d_card) == NN_QUERIES,
          f"nearest_neighbor card vs CPU: {int(apart.sum())} apart")
    d_err = float(np.abs(d_card[:NN_CPU_QUERIES] - d_cpu).max())
    log(f"aligned_scatter linear: {SCATTER_POINTS} points on a 384 x 512 x "
        f"512 map, card vs CPU within {fwd_err:.3g} (gradient "
        f"{grad_err:.3g}); nearest_neighbor {NN_QUERIES} x {NN_REFS}: "
        f"{nn_ms:.1f} ms on the card (CUDA events), its first "
        f"{NN_CPU_QUERIES} held to float64 with the CPU's ({int(apart.sum())}"
        f" near-ties apart, distances within {d_err:.3g} m of the CPU's; "
        f"the CPU {cpu_ms:.0f} ms)")
    return dict(scatter_fwd_err=fwd_err, scatter_grad_err=grad_err,
                nn_ms=nn_ms, nn_cpu_ms=cpu_ms, nn_ties_apart=int(apart.sum()))


def centerpoint_track(dev, vn):
    """The centerpoint_track path. Returns ({path: counts}, stats)."""
    t0 = time.perf_counter()
    cp = centerpoint_setup(dev, vn)
    counts, stats = {}, dict(occupied_share=cp["occupied_share"],
                             calibrated_peaks=cp["peaks"])
    counts["centerpoint_serving"], stats["serving"], dets = \
        centerpoint_serving(dev, cp, vn["clouds"])
    stats["card_vs_cpu"] = centerpoint_card_vs_cpu(dev, cp, vn["clouds"][2])
    counts["centerpoint_track"], stats["tracking"] = centerpoint_tracking(
        dev, dets["two"], vn["clouds"])
    batch = cp_batch(dev, cp["cfg32"], vn["scene"], vn["clouds"])
    stats["collided_targets_err"] = check_collided_targets(dev, cp["cfg32"],
                                                           batch)
    total = {}
    for dtype in ("float32", "bfloat16"):
        c, stats[f"train_{dtype}"] = centerpoint_training(dev, cp, batch,
                                                          dtype)
        add_counts(total, c)
    counts["centerpoint_train"] = total
    counts["refine_train"], stats["refine_train"] = refine_training(
        dev, cp, batch)
    counts["painting"], stats["painting"] = painting_path(dev, vn["scene"])
    stats["point_ops"] = point_ops_at_scale(dev, vn["clouds"])
    stats["phase_s"] = time.perf_counter() - t0
    log(f"centerpoint_track: {stats['phase_s']:.1f} s")
    del cp, dets, batch
    torch.cuda.empty_cache()
    return counts, stats


# ---------------------------------------------------------------------------
# mono3d_eval: KITTI frames in, scored camera detections out
# ---------------------------------------------------------------------------

MONO_STEPS = 5        # training steps a dtype
MONO_MAX_GT = 32      # padded ground truth a frame (the split has 16 cars)
# a trained SMOKE model's output spread over an image: heatmap logits sd 2
# about the -2.19 bias, sub-cell offsets sd 0.3, depth logits sd 0.5 about
# -3 (1 / sigmoid(-3) - 1 = 19 m), log-size residuals sd 0.1, (sin, cos)
# sd 1
MONO_HEAD_SD = dict(hm=2.0, offset=0.3, depth=0.5, dim=0.1, rot=1.0)
MONO_DEPTH_BIAS = -3.0
# KITTI's camera images (1242 x 375) are resized to the preset's 1280 x 384
KITTI_IMAGE = (375, 1242)


def kitti_classes():
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass

    return [KittiObjectClass.Car, KittiObjectClass.Pedestrian,
            KittiObjectClass.Cyclist]


def mono3d_frames(root, cfg):
    """The KITTI split of ``write_kitti_split`` read back through
    ``KittiObjectLoader``: per frame the velo-frame ground truth, its
    calibration trio (``calibration_data(idx, raw=True)``: no image
    opened), the camera matrix P2 scaled to the preset's image size, the
    cars as camera-frame boxes (``mono3d_gt_from_targets``) and a stand-in
    image as a numpy array: noise with every car ahead of the camera
    painted as a bright box where it projects."""
    from d3d_tpu_torch.dataset.kitti import KittiObjectLoader
    from d3d_tpu_torch.dataset.kitti.object import _cam_to_velo
    from d3d_tpu_torch.models import mono3d_gt_from_targets

    write_kitti_split(root)
    loader = KittiObjectLoader(root, trainval_split=1.0)
    h, w = cfg.image_size
    scale = np.array([[w / KITTI_IMAGE[1]], [h / KITTI_IMAGE[0]], [1.0]])
    lut = {c.value: i for i, c in enumerate(kitti_classes())}
    rng = np.random.default_rng(810)
    frames = []
    for i in range(KITTI_FRAMES):
        raw = loader.calibration_data(i, raw=True)
        k = (raw["P2"].reshape(3, 4)[:, :3] * scale).astype(np.float32)
        trio = _cam_to_velo(raw)
        gt = loader.annotation_3dobject(i)
        cam, labels = mono3d_gt_from_targets(gt, cam_to_velo=trio)
        image = rng.random((h, w, 3), dtype=np.float32) * 0.1
        for x, y, z, ln, _, ht, _ in cam:
            if z < 2:
                continue
            u = int(k[0, 0] * x / z + k[0, 2])
            v = int(k[1, 1] * (y - ht / 2) / z + k[1, 2])
            su = max(int(k[0, 0] * ln / z / 2), 2)
            sv = max(int(k[1, 1] * ht / z / 2), 2)
            image[max(v - sv, 0):max(v + sv, 0),
                  max(u - su, 0):max(u + su, 0)] = 1.0
        frames.append(dict(gt=gt, trio=trio, k=k, cam=cam, image=image,
                           labels=np.array([lut[int(l)] for l in labels],
                                           np.int32)))
    return frames


def calibrate_mono3d(model, image, dev):
    """Rescale the random heads to MONO_HEAD_SD over one image (the depth
    head's bias set to MONO_DEPTH_BIAS). Returns the peaks above 0.3 and
    the output map's size."""
    from d3d_tpu_torch.models.mono3d import _top_indices

    keys = dict(hm="heatmap")
    with torch.inference_mode():
        out = {k: t[0] for k, t in
               model(torch.from_numpy(image)[None].to(dev)).items()}
    for name, sd in MONO_HEAD_SD.items():
        last = model.heads[f"{name}_out"]
        o = out[keys.get(name, name)] - last.bias.detach()
        with torch.no_grad():
            last.weight.mul_(sd / float(o.std()))
            if name == "depth":
                last.bias.fill_(MONO_DEPTH_BIAS)
    with torch.inference_mode():
        out = {k: t[0] for k, t in
               model(torch.from_numpy(image)[None].to(dev)).items()}
        scores, _ = _top_indices(model.cfg, out)
    return int((scores > 0.3).sum()), tuple(out["heatmap"].shape[:2])


def mono3d_setup(dev, frames):
    """Mono3D on the KITTI preset uncut: f32 and the bf16 preset on the
    same seeded weights, heads calibrated on frame 0's image."""
    from d3d_tpu_torch.models import Mono3D

    cfg32 = mono_preset(dtype="float32")
    model32 = Mono3D(cfg32, device=dev,
                     generator=torch.Generator().manual_seed(51))
    peaks, out_size = calibrate_mono3d(model32, frames[0]["image"], dev)
    model16 = Mono3D(mono_preset(), device=dev)
    model16.load_state_dict(model32.state_dict())
    h, w = cfg32.out_size
    log(f"Mono3D ({cfg32.image_size[0]} x {cfg32.image_size[1]} images, "
        f"backbone {cfg32.backbone_channels}, {len(model32.blocks)} blocks "
        f"to a {h} x {w} map, {sum(p.numel() for p in model32.parameters())}"
        f" parameters) heads calibrated on frame 0 ({peaks} peaks above "
        "0.3)")
    check(out_size == (h, w), f"Mono3D output {out_size}, want {h} x {w}")
    return dict(cfg32=cfg32, model32=model32, model16=model16, peaks=peaks)


def mono_preset(**kw):
    """The phase's configuration: the KITTI Mono3D preset, uncut."""
    from d3d_tpu_torch.models import presets

    return presets.mono3d_kitti(**kw)


def mono3d_serving(dev, mono, frames):
    """make_mono3d_detector (bf16 preset, the split's calibration trio)
    on every frame, counts read over the requests (no kernel of the port's:
    the heatmap's max-pool is the NMS), Target3DArrays in the velo frame
    scored by DetectionEvaluator (calc_stats and device_calc_stats) on
    the card and with device="cpu", counters equal; then the steady
    request (median of 10 after a warm-up) and the card's busy share over
    5 requests."""
    from torch.profiler import ProfilerActivity, profile

    from d3d_tpu_torch.models import make_mono3d_detector

    cfg = mono["model16"].cfg
    trio = frames[0]["trio"]
    check(all(np.array_equal(f["trio"][2], trio[2]) for f in frames),
          "the split's frames do not share one calibration")
    detect = make_mono3d_detector(mono["model16"], None, cfg,
                                  kitti_classes(), cam_to_velo=trio,
                                  device=dev)
    dets, ms = [], []
    reset_counts()
    for f in frames:
        out, dev_ms, _ = timed(lambda: detect(f["image"], f["k"]))
        check(out.frame == "velo" and all(
            np.isfinite(o.position).all() for o in out),
              "Mono3D request: not finite velo-frame targets")
        dets.append(out)
        ms.append(dev_ms)
    counts = read_counts()
    check(counts == want_counts(), f"Mono3D requests: launches {counts}")
    evals = evaluate_on_card_and_cpu("mono3d", [f["gt"] for f in frames],
                                     dets, dev)
    n = len(frames)
    for i in range(3):
        detect(frames[i % n]["image"], frames[i % n]["k"])
    steady = [timed(lambda: detect(frames[i % n]["image"],
                                   frames[i % n]["k"])) for i in range(10)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5):
            detect(frames[i % n]["image"], frames[i % n]["k"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = busy_share(prof, wall)
    stats = dict(request_ms=ms, kept=[len(d) for d in dets],
                 steady_ms=statistics.median(s[1] for s in steady),
                 steady_host_ms=statistics.median(s[2] for s in steady),
                 busy_share=busy, eval=evals)
    log(f"Mono3D serving (bf16 preset): requests "
        + ", ".join(f"{m:.2f}" for m in ms) + " ms by CUDA events (the "
        f"first cold), steady {stats['steady_ms']:.2f} ms (host "
        f"{stats['steady_host_ms']:.2f} ms, median of 10); busy share "
        f"{busy if busy is None else round(busy, 3)}; kept {stats['kept']}; "
        "evaluator counters card = CPU, AP(Car) "
        + ", ".join(f"{o}: {v['ap']:.4f}" for o, v in evals.items()))
    return counts, stats


def mono3d_card_vs_cpu(dev, mono, frame):
    """Frame ``frame`` through the f32 model on the card (TF32 off) and
    the same weights on the CPU: every head within 1e-4 of its largest
    magnitude, the decode's top-k indices equal, the decoded boxes within
    2e-3 m / 2e-3 relative / 2e-2 rad and scores within 1e-4. Returns the
    errors and the CPU network's ms."""
    from d3d_tpu_torch.models import Mono3D, decode_mono3d
    from d3d_tpu_torch.models.mono3d import _top_indices

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mono["cfg32"]
    cpu_model = Mono3D(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               mono["model32"].state_dict().items()})
    raw, ms = [], []
    for m, d in ((mono["model32"], dev), (cpu_model, "cpu")):
        t0 = time.perf_counter()
        with torch.inference_mode():
            raw.append({k: t[0] for k, t in m(torch.from_numpy(
                frame["image"])[None].to(d)).items()})
        if d != "cpu":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    g, c = {k: t.cpu() for k, t in raw[0].items()}, raw[1]
    errs = {k: float((g[k] - c[k]).abs().max() / c[k].abs().max())
            for k in c}
    check(max(errs.values()) <= 1e-4, f"Mono3D card vs CPU: {errs}")
    check(torch.equal(_top_indices(cfg, g)[1], _top_indices(cfg, c)[1]),
          "Mono3D card vs CPU: the decode's top-k indices differ")
    k = torch.from_numpy(frame["k"])
    with torch.inference_mode():
        bg, sg, _ = (t.cpu() for t in decode_mono3d(
            cfg, raw[0], k.to(dev)))
        bc, sc, _ = decode_mono3d(cfg, c, k)
    pos_err = float((bg[:, :3] - bc[:, :3]).abs().max())
    size_err = float(((bg[:, 3:6] - bc[:, 3:6]) / bc[:, 3:6]).abs().max())
    dyaw = torch.remainder(bg[:, 6] - bc[:, 6] + math.pi,
                           2 * math.pi) - math.pi
    yaw_err = float(dyaw.abs().max())
    score_err = float((sg - sc).abs().max())
    check(pos_err <= 2e-3 and size_err <= 2e-3 and yaw_err <= 2e-2
          and score_err <= 1e-4,
          f"Mono3D decode card vs CPU: position {pos_err}, size "
          f"{size_err}, yaw {yaw_err}, score {score_err}")
    log(f"Mono3D card vs CPU (f32, TF32 off): heads within "
        f"{max(errs.values()):.3g} of their largest magnitudes, top-"
        f"{cfg.top_k} indices equal; boxes {pos_err:.3g} m, sizes "
        f"{size_err:.3g}, yaw {yaw_err:.3g} rad, scores {score_err:.3g}; "
        f"the network {ms[0]:.1f} ms on the card (first call), {ms[1]:.0f} "
        "ms on the CPU")
    return dict(head_err=errs, position_m=pos_err, size=size_err,
                yaw_rad=yaw_err, score=score_err, cpu_network_ms=ms[1])


def mono3d_perfect_decode(dev, cfg, frames):
    """assign_mono3d_targets then decode_mono3d of outputs built from the
    targets (heatmap logit 10 at each assigned cell, -12 elsewhere; the
    regression maps the targets' vectors) on the card, every frame: each
    assigned car alone in its cell decodes back to its box within 2e-3 m
    + 1e-4 relative and 1e-3 rad (tests/test_mono3d.py's roundtrip).
    Returns (boxes checked, largest errors)."""
    from d3d_tpu_torch.models import assign_mono3d_targets, decode_mono3d
    from d3d_tpu_torch.models.mono3d import _top_indices

    h, w = cfg.out_size
    nc = cfg.num_classes
    checked, err, yaw_err = 0, 0.0, 0.0
    for f in frames:
        boxes = torch.from_numpy(f["cam"]).to(dev)
        labels = torch.from_numpy(f["labels"]).to(dev)
        k = torch.from_numpy(f["k"]).to(dev)
        t = assign_mono3d_targets(cfg, k, boxes, labels,
                                  torch.ones(len(boxes), dtype=torch.bool,
                                             device=dev))
        cell = t["cell"].cpu().numpy()
        hm = torch.full((h * w, nc), -12.0, device=dev)
        reg = torch.zeros((h * w, 8), device=dev)
        for m in np.flatnonzero(cell >= 0):
            hm[cell[m], int(f["labels"][m])] = 10.0
            reg[cell[m]] = t["vec"][m]
        outputs = dict(heatmap=hm.reshape(h, w, nc),
                       offset=reg[:, 0:2].reshape(h, w, 2),
                       depth=reg[:, 2:3].reshape(h, w, 1),
                       dim=reg[:, 3:6].reshape(h, w, 3),
                       rot=reg[:, 6:8].reshape(h, w, 2))
        dec, scores, _ = decode_mono3d(cfg, outputs, k)
        dcell = (_top_indices(cfg, outputs)[1] // nc).cpu().numpy()
        dec = dec.cpu().numpy()
        alone = [m for m in np.flatnonzero(cell >= 0)
                 if (cell == cell[m]).sum() == 1]
        for m in alone:
            j = int(np.flatnonzero(dcell == cell[m])[0])
            want = f["cam"][m]
            e = np.abs(dec[j, :6] - want[:6]) / (2e-3 + 1e-4
                                                 * np.abs(want[:6]))
            err = max(err, float(e.max()))
            yaw_err = max(yaw_err, abs(math.remainder(
                float(dec[j, 6] - want[6]), 2 * math.pi)))
        checked += len(alone)
    check(checked > 0 and err <= 1.0 and yaw_err <= 1e-3,
          f"Mono3D perfect decode: {checked} boxes, error {err} of the "
          f"tolerance, yaw {yaw_err} rad")
    log(f"Mono3D targets -> decode on the card: {checked} labelled cars "
        f"recovered (largest error {err:.3g} of 2e-3 m + 1e-4 relative, "
        f"yaw {yaw_err:.3g} rad)")
    return dict(checked=checked, err_of_tolerance=err, yaw_rad=yaw_err)


def mono3d_flip_check(dev, cfg, frame):
    """flip_camera_frame on the card, then assign_mono3d_targets: every
    assigned car's centre mirrors (u' = W - 1 - u within 1e-3 px, same
    cell row), its heatmap peak of 1 sits at the mirrored cell, depth and
    size targets equal; flipping twice gives the image back."""
    from d3d_tpu_torch.augment import flip_camera_frame
    from d3d_tpu_torch.models import assign_mono3d_targets

    h, w = cfg.out_size
    image = torch.from_numpy(frame["image"]).to(dev)
    k = torch.from_numpy(frame["k"]).to(dev)
    boxes = torch.from_numpy(frame["cam"]).to(dev)
    labels = torch.from_numpy(frame["labels"]).to(dev)
    mask = torch.ones(len(boxes), dtype=torch.bool, device=dev)
    img2, k2, boxes2 = flip_camera_frame(image, k, boxes)
    t0 = assign_mono3d_targets(cfg, k, boxes, labels, mask)
    t1 = assign_mono3d_targets(cfg, k2, boxes2, labels, mask)
    both = (t0["mask"] & t1["mask"]).cpu().numpy()
    c0, c1 = t0["cell"].cpu().numpy(), t1["cell"].cpu().numpy()
    v0, v1 = t0["vec"].cpu().numpy(), t1["vec"].cpu().numpy()
    hm0, hm1 = t0["heatmap"].cpu().numpy(), t1["heatmap"].cpu().numpy()
    u_err = 0.0
    for m in np.flatnonzero(both):
        u0 = (c0[m] % w + v0[m, 0]) * cfg.stride
        u1 = (c1[m] % w + v1[m, 0]) * cfg.stride
        u_err = max(u_err, abs(u1 - (image.shape[1] - 1 - u0)))
        lab = int(frame["labels"][m])
        check(c0[m] // w == c1[m] // w
              and hm0.reshape(-1, cfg.num_classes)[c0[m], lab] == 1.0
              and hm1.reshape(-1, cfg.num_classes)[c1[m], lab] == 1.0,
              f"flip: car {m}'s peak is not mirrored")
    vec_err = float(np.abs(v1[both, 2:6] - v0[both, 2:6]).max())
    img3 = flip_camera_frame(img2, k2, boxes2)[0]
    check(int(both.sum()) > 0 and u_err <= 1e-3 and vec_err <= 1e-5
          and bool(torch.equal(img3, image))
          and bool(torch.equal(img2, image.flip(1))),
          f"flip: {int(both.sum())} cars, centres {u_err} px, depth/size "
          f"{vec_err}")
    log(f"flip_camera_frame on the card: {int(both.sum())} cars' centres "
        f"mirrored within {u_err:.3g} px, their peaks at the mirrored "
        f"cells, depth/size targets within {vec_err:.3g}")
    return dict(cars=int(both.sum()), u_err_px=u_err, vec_err=vec_err)


def mono3d_batch(dev, frames, keys=(0, 1)):
    """A training batch of two frames: images, camera matrices, the cars
    as camera-frame boxes padded to MONO_MAX_GT."""
    m = MONO_MAX_GT
    gt = np.zeros((len(keys), m, 7), np.float32)
    gt[..., 3:6] = 1.0
    labels = np.zeros((len(keys), m), np.int32)
    mask = np.zeros((len(keys), m), bool)
    for b, i in enumerate(keys):
        n = min(len(frames[i]["cam"]), m)
        gt[b, :n] = frames[i]["cam"][:n]
        labels[b, :n] = frames[i]["labels"][:n]
        mask[b, :n] = True
    batch = dict(images=np.stack([frames[i]["image"] for i in keys]),
                 intrinsics=np.stack([frames[i]["k"] for i in keys]),
                 gt_boxes=gt, gt_labels=labels, gt_mask=mask)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def mono3d_training(dev, mono, batch, dtype):
    """make_train_step + make_optimizer from the calibrated f32 weights in
    ``dtype`` (f32 with TF32 off), batch 2, MONO_STEPS steps, counts read
    per step (dense convolutions only): losses finite and the last below
    the first. Returns (summed counts, stats)."""
    from d3d_tpu_torch.models import Mono3D
    from d3d_tpu_torch.models.mono3d import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    model = Mono3D(mono_preset(dtype=dtype), device=dev)
    model.load_state_dict(mono["model32"].state_dict())
    opt, _ = make_optimizer(model.parameters(), total_steps=MONO_STEPS)
    step = make_train_step(model, opt, model.cfg)
    total, losses, step_ms = {}, [], []
    for i in range(MONO_STEPS):
        reset_counts()
        aux, ms, _ = timed(lambda: step(batch))
        c = read_counts()
        check(c == want_counts(), f"Mono3D training {dtype} step {i + 1}: "
                                  f"launches {c}")
        add_counts(total, c)
        step_ms.append(ms)
        losses.append(float(aux["total"]))
        check(math.isfinite(losses[-1]), f"Mono3D training {dtype}: "
                                         f"loss {losses[-1]}")
    check(losses[-1] < losses[0], f"Mono3D training {dtype}: losses "
                                  f"{losses} do not fall")
    log(f"Mono3D training {dtype} (batch 2): losses "
        + ", ".join(f"{l:.4f}" for l in losses) + "; step "
        + ", ".join(f"{m:.2f}" for m in step_ms) + " ms (CUDA events)")
    return total, dict(losses=losses, step_ms=step_ms)


def grads_card_vs_cpu(name, dev, make_model, state, batch, step_fn):
    """One step of the same weights and batch in f32 on the card and on
    the CPU (TF32 off) and in float64 on the card (the reference): every
    parameter's f32 gradient on either side within PP_GRAD_LIMIT of the
    float64 one's largest |g| (the limit of an f32 step at full width
    against float64, from PointPillars' readings: each side's f32
    rounds the BatchNorm backward's cancellations in its own summation
    order, and cuDNN's f32 algorithms are not the CPU's). Returns the
    largest relative distances card vs CPU, card vs float64 and CPU vs
    float64, and the CPU step's ms."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    grads, ms = {}, 0.0
    for side, d, dtype in (("card", dev, "float32"), ("cpu", "cpu", "float32"),
                           ("f64", dev, "float64")):
        model = make_model(d, dtype)
        model.load_state_dict({k: v.to(d) for k, v in state.items()})
        t0 = time.perf_counter()
        step_fn(model, torch.optim.SGD(model.parameters(), lr=0.0))(
            {k: v.to(d) for k, v in batch.items()})
        if side == "cpu":
            ms = (time.perf_counter() - t0) * 1e3
        grads[side] = {n: p.grad.cpu().double()
                       for n, p in model.named_parameters()}

    def rel(a, b):
        return {n: float((g - b[n]).abs().max()
                         / max(float(b[n].abs().max()), 1e-30))
                for n, g in a.items()}

    card, cpu = rel(grads["card"], grads["f64"]), rel(grads["cpu"],
                                                      grads["f64"])
    direct = rel(grads["card"], grads["cpu"])
    errs = dict(card_vs_cpu=max(direct.values()),
                card_vs_f64=max(card.values()), cpu_vs_f64=max(cpu.values()))
    check(errs["card_vs_f64"] <= PP_GRAD_LIMIT
          and errs["cpu_vs_f64"] <= PP_GRAD_LIMIT,
          f"{name} gradients against float64: card {errs['card_vs_f64']}, "
          f"CPU {errs['cpu_vs_f64']} > {PP_GRAD_LIMIT}")
    errs = dict(card_vs_cpu=max(direct.values()),
                card_vs_f64=max(card.values()), cpu_vs_f64=max(cpu.values()))
    log(f"{name} gradients (f32, TF32 off) against a float64 step on the "
        f"card: the card within {errs['card_vs_f64']:.3g} of each leaf's "
        f"largest |g|, the CPU {errs['cpu_vs_f64']:.3g} (worst "
        f"{max(card, key=card.get)} / {max(cpu, key=cpu.get)}); card vs CPU "
        f"{errs['card_vs_cpu']:.3g}; the CPU step {ms:.0f} ms")
    return errs, ms


def mono3d_eval(dev):
    """The mono3d_eval path. Returns ({path: counts}, stats)."""
    import tempfile

    from d3d_tpu_torch.models import Mono3D
    from d3d_tpu_torch.models.mono3d import make_train_step

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        frames = mono3d_frames(Path(tmp), mono_preset())
    mono = mono3d_setup(dev, frames)
    counts, stats = {}, dict(calibrated_peaks=mono["peaks"])
    counts["mono3d_serving"], stats["serving"] = mono3d_serving(dev, mono,
                                                                frames)
    stats["card_vs_cpu"] = mono3d_card_vs_cpu(dev, mono, frames[1])
    stats["perfect_decode"] = mono3d_perfect_decode(dev, mono["cfg32"],
                                                    frames)
    stats["flip"] = mono3d_flip_check(dev, mono["cfg32"], frames[0])
    batch = mono3d_batch(dev, frames)
    total = {}
    for dtype in ("float32", "bfloat16"):
        c, stats[f"train_{dtype}"] = mono3d_training(dev, mono, batch, dtype)
        add_counts(total, c)
    counts["mono3d_train"] = total
    cfg32 = mono["cfg32"]
    stats["grad_err"], stats["cpu_step_ms"] = grads_card_vs_cpu(
        "Mono3D", dev,
        lambda d, dt: Mono3D(mono_preset(dtype=dt), device=d),
        mono["model32"].state_dict(), batch,
        lambda m, opt: make_train_step(m, opt, m.cfg))
    stats["phase_s"] = time.perf_counter() - t0
    log(f"mono3d_eval: {stats['phase_s']:.1f} s")
    del mono, batch
    torch.cuda.empty_cache()
    return counts, stats


# ---------------------------------------------------------------------------
# bevseg_kitti360: KITTI-360 frames in, panoptic quality out
# ---------------------------------------------------------------------------

K360_SEQ = "2013_05_28_drive_0000_sync"
K360_FRAMES = 4
K360_SCAN_POINTS = 120_000     # an HDL-64E scan
K360_WINDOW_POINTS = 600_000   # the static window's aggregated points
K360_DYNAMIC_POINTS = 3_000    # the moving car's points a frame
K360_SICK_POINTS = 1_000
# KITTI-360 drives sit km from the world origin (the transfer recentres)
K360_ORIGIN = np.array([1200.0, 3400.0, 110.0])
K360_STEP = 1.0                # m a frame (36 km/h at 10 Hz)
K360_YAW_STEP = 0.02           # rad a frame
LIDAR_Z = 1.73
# camera (RDF) -> pose (FLU); the same matrix as camera -> velo makes the
# velodyne frame the pose frame
K360_CAM = np.array([[0.0, 0.0, 1.0, 0.8], [-1.0, 0.0, 0.0, 0.3],
                     [0.0, -1.0, 0.0, -0.1]])
K360_SICK = np.array([[1.0, 0.0, 0.0, 0.2], [0.0, 0.0, -1.0, 0.0],
                      [0.0, 1.0, 0.0, -0.4]])
# kitti360Scripts label ids of the scene's surfaces
K360_IDS = dict(road=7, sidewalk=8, building=11, pole=17, vegetation=21,
                terrain=22, person=24, car=26)
# parked cars (x, y) along both kerbs and pedestrians on the pavements, in
# the drive's own frame (world minus K360_ORIGIN)
K360_CARS = [(-40.0 + 8 * k, 4.5) for k in range(12)] \
    + [(-36.0 + 8 * k, -4.5) for k in range(11)]
K360_PERSONS = [(-42.0 + 9 * k, 7.2 * (-1) ** k) for k in range(11)]
K360_POLES = [(-45.0 + 15 * k, 7.8 * (-1) ** k) for k in range(7)]
K360_TREES = [(-45.0 + 6 * k, 15.0 * (-1) ** k) for k in range(17)]
# the moving car: on the road at y = -2, 3 m a frame
K360_MOVER = (5.0, -2.0, 3.0)
# the Kitti360Class names mapped onto bevseg_semantickitti's 20 classes
# (SemanticKITTI's learning map: 0 unlabeled, 1 car, 2 bicycle, 3
# motorcycle, 4 truck, 5 other-vehicle, 6 person, 7 bicyclist, 8
# motorcyclist, 9 road, 10 parking, 11 sidewalk, 12 other-ground, 13
# building, 14 fence, 15 vegetation, 16 trunk, 17 terrain, 18 pole, 19
# traffic-sign); every other class is 0
SEMKITTI_OF_K360 = dict(
    car=1, bicycle=2, motorcycle=3, truck=4, bus=5, train=5, caravan=5,
    trailer=5, person=6, rider=7, road=9, parking=10, sidewalk=11,
    ground=12, rail_track=12, building=13, garage=13, wall=13, bridge=13,
    tunnel=13, fence=14, guard_rail=14, gate=14, vegetation=15, terrain=17,
    pole=18, polegroup=18, smallpole=18, traffic_light=19, traffic_sign=19)
THING_CLASSES = (1, 2, 3, 4, 5, 6, 7, 8)
K360_CENTRES = 32              # the calibrated centre heatmap's peaks
SEG_SCALE_FRAMES = 1024        # a quarter of SemanticKITTI's sequence 08
SEG_SCALE_CHUNK = 128
SEG_SCALE_CHECKED = 64
BEV_STEPS = 5
NN_CHECKED = 2048              # scan points whose labels the CPU re-derives


def k360_lut():
    """Kitti360Class value -> bevseg_semantickitti class (uint8 LUT)."""
    from d3d_tpu_torch.dataset.kitti360 import Kitti360Class

    lut = np.zeros(256, np.uint8)
    for name, cls in SEMKITTI_OF_K360.items():
        lut[Kitti360Class[name].value] = cls
    return lut


def k360_surfaces(rng, n, x0, x1):
    """``n`` points of a street between x0 and x1 (the drive's frame):
    road, pavements, terrain, tree crowns, building walls, poles, the
    parked cars and the pedestrians, each class a fixed share. Returns
    (xyz float64, kitti360Scripts label id, instance id) with instances
    ``id * 1000 + k`` for the cars and pedestrians, 0 elsewhere."""
    shares = dict(road=0.30, sidewalk=0.10, terrain=0.12, vegetation=0.10,
                  building=0.23, pole=0.03, car=0.09, person=0.03)
    parts = []
    for name, share in shares.items():
        m = int(n * share)
        if name == "road":
            xyz = np.stack([rng.uniform(x0, x1, m), rng.uniform(-6, 6, m),
                            rng.normal(0, 0.02, m)], 1)
        elif name == "sidewalk":
            xyz = np.stack([rng.uniform(x0, x1, m),
                            rng.uniform(6, 9, m) * rng.choice([-1, 1], m),
                            0.15 + rng.normal(0, 0.02, m)], 1)
        elif name == "terrain":
            xyz = np.stack([rng.uniform(x0, x1, m),
                            rng.uniform(9, 19, m) * rng.choice([-1, 1], m),
                            rng.uniform(0, 0.2, m)], 1)
        elif name == "building":
            xyz = np.stack([rng.uniform(x0, x1, m),
                            (20 + rng.normal(0, 0.05, m))
                            * rng.choice([-1, 1], m), rng.uniform(0, 12, m)],
                           1)
        else:
            objs = dict(vegetation=K360_TREES, pole=K360_POLES,
                        car=K360_CARS, person=K360_PERSONS)[name]
            objs = [o for o in objs if x0 <= o[0] < x1]
            k = rng.integers(0, len(objs), m)
            c = np.asarray(objs)[k]
            if name == "vegetation":
                xyz = np.stack([c[:, 0], c[:, 1], np.full(m, 3.0)], 1) \
                    + rng.normal(0, [1.2, 1.2, 0.8], (m, 3))
            elif name == "car":
                xyz = np.stack([c[:, 0], c[:, 1], np.full(m, 0.75)], 1) \
                    + rng.uniform(-1, 1, (m, 3)) * [2.1, 0.9, 0.75]
            else:
                r = 0.15 if name == "pole" else 0.3
                a = rng.uniform(0, 2 * np.pi, m)
                xyz = np.stack([c[:, 0] + r * np.cos(a),
                                c[:, 1] + r * np.sin(a),
                                rng.uniform(0, 6 if name == "pole" else 1.8,
                                            m)], 1)
        label = K360_IDS[name]
        inst = (label * 1000 + 1
                + np.asarray([dict(car=K360_CARS, person=K360_PERSONS)[
                    name].index(tuple(o)) for o in objs])[k]
                if name in ("car", "person") else np.zeros(m, np.int64))
        parts.append((xyz, np.full(m, label), inst))
    return tuple(np.concatenate(p) for p in zip(*parts))


def k360_mover(rng, f, m):
    """The moving car's ``m`` points at frame ``f`` (its instance 26500)."""
    x0, y0, step = K360_MOVER
    xyz = np.array([x0 + step * f, y0, 0.75]) \
        + rng.uniform(-1, 1, (m, 3)) * [2.1, 0.9, 0.75]
    return xyz, np.full(m, K360_IDS["car"]), np.full(m, 26500)


def k360_pose(f):
    """(rotation, translation) of frame ``f``: the drive's frame moved to
    K360_ORIGIN, K360_STEP along x and K360_YAW_STEP of yaw a frame, the
    lidar LIDAR_Z above the road."""
    yaw = K360_YAW_STEP * f
    c, s = math.cos(yaw), math.sin(yaw)
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return rot, K360_ORIGIN + [K360_STEP * f, 0.0, LIDAR_Z]


def write_ply(path, xyz, semantic, instance, timestamp=None):
    """A binary little-endian PLY of the data_3d_semantics windows:
    x, y, z, red, green, blue, semantic, instance, visible[, timestamp]."""
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"),
              ("green", "u1"), ("blue", "u1"), ("semantic", "<i4"),
              ("instance", "<i4"), ("visible", "u1")]
    if timestamp is not None:
        fields.append(("timestamp", "<i4"))
    rec = np.zeros(len(xyz), np.dtype(fields))
    for i, axis in enumerate("xyz"):
        rec[axis] = xyz[:, i]
    rec["red"] = semantic * 7
    rec["semantic"], rec["instance"], rec["visible"] = semantic, instance, 1
    if timestamp is not None:
        rec["timestamp"] = timestamp
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex %d\n"
              % len(xyz) + "".join(
                  "property %s %s\n" % (dict(f4="float", u1="uchar",
                                             i4="int")[t[-2:]], name)
                  for name, t in fields) + "end_header\n")
    path.write_bytes(header.encode() + rec.tobytes())


def write_kitti360_scene(root):
    """A KITTI-360 layout under ``root`` written with numpy: calibration
    (cameras, velodyne, SICK, the fisheye YAMLs), poses, timestamps,
    K360_FRAMES velodyne scans of K360_SCAN_POINTS points and their SICK
    scans, one static window of K360_WINDOW_POINTS points and one dynamic
    window (the moving car), as PLY. Returns the windows' point counts."""
    rng = np.random.default_rng(900)
    cal = root / "calibration"
    cal.mkdir(parents=True)

    def row(m):
        return " ".join("%.12e" % v for v in np.ravel(m))

    (cal / "calib_cam_to_pose.txt").write_text("".join(
        f"image_{i:02d}: {row(K360_CAM)}\n" for i in range(4)))
    p = np.array([[552.55, 0.0, 682.05, 0.0], [0.0, 552.55, 238.77, 0.0],
                  [0.0, 0.0, 1.0, 0.0]])
    (cal / "perspective.txt").write_text("".join(
        f"P_rect_{i:02d}: {row(p)}\nS_rect_{i:02d}: 1408 376\n"
        f"R_rect_{i:02d}: {row(np.eye(3))}\n" for i in range(2)))
    (cal / "calib_cam_to_velo.txt").write_text(row(K360_CAM) + "\n")
    (cal / "calib_sick_to_velo.txt").write_text(row(K360_SICK) + "\n")
    mei = ("%YAML:1.0\n---\nmodel_type: MEI\ncamera_name: image_0{i}\n"
           "image_width: 1400\nimage_height: 1400\nmirror_parameters:\n"
           "   xi: 2.2134047507854890e+00\ndistortion_parameters:\n"
           "   k1: 1.6798235660113681e-02\n   k2: 1.6548773243373522e+00\n"
           "   p1: 4.2223943394772046e-04\n   p2: 4.2462134260997584e-04\n"
           "projection_parameters:\n   gamma1: 1.3363220825849971e+03\n"
           "   gamma2: 1.3357883350012958e+03\n"
           "   u0: 7.1694323510126321e+02\n   v0: 7.0576498308221585e+02\n")
    for i in (2, 3):
        (cal / f"image_0{i}.yaml").write_text(mei.format(i=i))
    stamps = "".join("2013-05-28 08:46:%02d.%09d\n" % (2 + f // 10,
                                                       f % 10 * 10 ** 8)
                     for f in range(K360_FRAMES))
    raw = root / "data_3d_raw" / K360_SEQ
    for sensor in ("velodyne_points", "sick_points"):
        (raw / sensor / "data").mkdir(parents=True)
        (raw / sensor / "timestamps.txt").write_text(stamps)
    poses = []
    for f in range(K360_FRAMES):
        rot, t = k360_pose(f)
        poses.append(f"{f} {row(np.hstack([rot, t[:, None]]))}")
        cx = K360_STEP * f
        xyz, _, _ = k360_surfaces(rng, K360_SCAN_POINTS
                                  - K360_DYNAMIC_POINTS // 2, cx - 45,
                                  cx + 45)
        xyz = np.concatenate([xyz, k360_mover(rng, f, K360_DYNAMIC_POINTS
                                              // 2)[0]])
        xyz += rng.normal(0, 0.02, xyz.shape)
        velo = (xyz + K360_ORIGIN - t) @ rot   # world -> velodyne (= pose)
        scan = np.concatenate([velo, rng.random((len(velo), 1))], 1)
        scan[rng.permutation(len(scan))].astype(np.float32).tofile(
            raw / "velodyne_points" / "data" / ("%010d.bin" % f))
        rng.uniform(-5, 5, (K360_SICK_POINTS, 2)).astype(np.float32).tofile(
            raw / "sick_points" / "data" / ("%010d.bin" % f))
    (root / "data_poses" / K360_SEQ).mkdir(parents=True)
    (root / "data_poses" / K360_SEQ / "poses.txt").write_text(
        "\n".join(poses) + "\n")
    sem = root / "data_3d_semantics" / K360_SEQ
    (sem / "static").mkdir(parents=True)
    (sem / "dynamic").mkdir(parents=True)
    xyz, label, inst = k360_surfaces(rng, K360_WINDOW_POINTS, -50, 55)
    write_ply(sem / "static" / ("%010d_%010d.ply" % (0, K360_FRAMES - 1)),
              xyz + K360_ORIGIN, label, inst)
    dyn = [k360_mover(rng, f, K360_DYNAMIC_POINTS)
           for f in range(K360_FRAMES)]
    write_ply(sem / "dynamic" / ("%010d_%010d.ply" % (0, K360_FRAMES - 1)),
              np.concatenate([d[0] for d in dyn]) + K360_ORIGIN,
              np.concatenate([d[1] for d in dyn]),
              np.concatenate([d[2] for d in dyn]),
              timestamp=np.repeat(np.arange(K360_FRAMES),
                                  K360_DYNAMIC_POINTS))
    return dict(static=len(xyz), dynamic=K360_DYNAMIC_POINTS * K360_FRAMES)


def k360_transfer(dev, root, windows):
    """KITTI360Loader on the scene, its label transfer
    (``_preload_3dsemantics`` through ``nearest_neighbor`` on the card)
    timed; every frame's labels read back. Then the first NN_CHECKED
    points of frame 0 re-derived on the CPU (the same windows, the same
    strict ``<`` merge): equal but at near-ties, where the card's label
    must be that of a window point whose float64 distance is within the
    two searches' rounding (8 float32 epsilons of |q - o|^2 + |r - o|^2
    for each side's recentring origin o) of the CPU pick's. Returns
    (loader, frames, stats)."""
    from d3d_tpu_torch.dataset.kitti360 import KITTI360Loader
    from d3d_tpu_torch.dataset.kitti360.utils import id2label, load_ply
    from d3d_tpu_torch.ops.point import nearest_neighbor

    loader = KITTI360Loader(root, trainval_split=1, device=dev)
    check(len(loader) == K360_FRAMES, f"KITTI-360: {len(loader)} frames")
    t0 = time.perf_counter()
    loader.annotation_3dpoints(0)
    transfer_s = time.perf_counter() - t0
    lut = k360_lut()
    frames = []
    for i in range(K360_FRAMES):
        pts = loader.lidar_data(i)
        seg = loader.annotation_3dpoints(i)
        check(len(seg.semantic) == len(pts) == len(seg.instance),
              f"KITTI-360 frame {i}: {len(pts)} points, "
              f"{len(seg.semantic)} labels")
        label = lut[seg.semantic]
        ids = np.where(np.isin(label, THING_CLASSES), seg.instance,
                       0).astype(np.uint16)
        frames.append(dict(points=pts, semantic=seg.semantic,
                           instance=seg.instance, labels=label, ids=ids))
    # the CPU's transfer of frame 0's first NN_CHECKED points
    idmap = np.zeros(max(id2label) + 1, np.uint8)
    for i, lab in id2label.items():
        if i >= 0:
            idmap[i] = lab.name.value
    world = loader._world_velo_cloud(K360_SEQ, 0)
    q = world[:NN_CHECKED]
    sem = root / "data_3d_semantics" / K360_SEQ
    static = load_ply(sem / "static", "%010d_%010d.ply"
                      % (0, K360_FRAMES - 1))
    dyn = load_ply(sem / "dynamic", "%010d_%010d.ply"
                   % (0, K360_FRAMES - 1))
    dyn = dyn[dyn["timestamp"] == 0]
    best_d = np.full(len(q), np.inf, np.float32)
    best = np.zeros((len(q), 2), np.int64)
    refs, fields = [], []
    for win in (static, dyn):
        xyz = np.stack([win["x"], win["y"], win["z"]], 1)
        d, nn = nearest_neighbor(q, xyz, device="cpu")
        sel = np.stack([idmap[win["semantic"][nn]], win["instance"][nn]], 1)
        upd = d < best_d
        best_d = np.where(upd, d, best_d)
        best = np.where(upd[:, None], sel, best)
        refs.append(xyz.astype(np.float64))
        fields.append(np.stack([idmap[win["semantic"]], win["instance"]], 1))
    refs, fields = np.concatenate(refs), np.concatenate(fields)
    card = np.stack([frames[0]["semantic"][:NN_CHECKED],
                     frames[0]["instance"][:NN_CHECKED]], 1).astype(np.int64)
    apart = np.flatnonzero((card != best).any(1))
    check(len(apart) <= NN_CHECKED // 100,
          f"label transfer: {len(apart)} of {NN_CHECKED} labels card vs CPU")
    origins = (world.mean(0), q.mean(0))
    eps8 = 8 * 2.0 ** -24
    for j in apart:
        d2 = ((refs - q[j]) ** 2).sum(1)
        bound = sum(eps8 * (((q[j] - o) ** 2).sum() + ((refs - o) ** 2).sum(1))
                    for o in origins)
        picks = []
        for want in (card[j], best[j]):
            cand = np.flatnonzero((fields == want).all(1))
            picks.append(cand[np.argmin(d2[cand])])
        gap = d2[picks[0]] - d2[picks[1]]
        check(abs(gap) <= bound[picks[0]] + bound[picks[1]],
              f"label transfer: point {j}'s card label {card[j]} is "
              f"{gap} m^2 off the CPU's {best[j]}")
    stats = dict(transfer_ms_per_frame=transfer_s * 1e3 / K360_FRAMES,
                 points=[len(f["points"]) for f in frames],
                 window_points=windows, cpu_checked=NN_CHECKED,
                 near_ties_apart=len(apart))
    log(f"KITTI-360 label transfer on the card: {K360_FRAMES} frames of "
        f"{stats['points']} points against {windows['static']} static and "
        f"{windows['dynamic']} dynamic window points, "
        f"{stats['transfer_ms_per_frame']:.1f} ms a frame (velodyne and "
        f"SICK scans, host included); the first {NN_CHECKED} points of "
        f"frame 0 equal to the CPU's but {len(apart)} near-ties")
    return loader, frames, stats


def bev_preset(**kw):
    """The phase's configuration: bevseg_semantickitti, uncut."""
    from d3d_tpu_torch.models import presets

    return presets.bevseg_semantickitti(**kw)


def pano_preset(**kw):
    return bev_preset(panoptic=True, thing_classes=THING_CLASSES, **kw)


def bev_inputs(points, cfg, dev):
    from d3d_tpu_torch.models import bevseg_pillarize, point_cell_coords

    pts = torch.from_numpy(points).to(dev)
    f, c, v = bevseg_pillarize(pts, cfg)
    return f[None], c[None], v[None], point_cell_coords(pts, cfg)[None]


def calibrate_bevseg(model, points, dev):
    """Rescale the random panoptic heads as a trained model's: centre
    logits sd 1.5 over the map, biased so that K360_CENTRES local maxima
    of the map pass the grouping's 0.1 (about the scene's instance
    count); offsets sd 0.5 m. Returns the centres above 0.1 after it."""
    from torch.nn.functional import max_pool2d

    with torch.inference_mode():
        out = model(*bev_inputs(points, model.cfg, dev))
    with torch.no_grad():
        hm = (out["heatmap"][0] - model.head_center.bias)
        scale = 1.5 / float(hm.std())
        hm = hm * scale
        maxima = hm[hm >= max_pool2d(hm[None, None], 3, 1, 1)[0, 0]]
        kth = torch.sort(maxima, descending=True).values[K360_CENTRES - 1]
        model.head_center.weight.mul_(scale)
        model.head_center.bias.fill_(math.log(0.1 / 0.9) + 1e-3
                                     - float(kth))
        model.head_offset.weight.mul_(0.5 / float(out["offset"].std()))
        out = model(*bev_inputs(points, model.cfg, dev))
        hm = torch.sigmoid(out["heatmap"][0])
        pooled = max_pool2d(hm[None, None], 3, 1, 1)[0, 0]
    return int(((hm >= pooled) & (hm > 0.1)).sum())


def bevseg_setup(dev, frames):
    """The semantic preset (bf16) and its panoptic variant (the thing
    classes 1-8), f32 copies of both, on seeded weights; the panoptic
    heads calibrated on frame 0."""
    from d3d_tpu_torch.models import BEVSeg

    out = {}
    for name, preset, seed in (("sem", bev_preset, 61),
                               ("pano", pano_preset, 62)):
        m32 = BEVSeg(preset(dtype="float32"), device=dev,
                     generator=torch.Generator().manual_seed(seed))
        if name == "pano":
            out["centres"] = calibrate_bevseg(m32, frames[0]["points"], dev)
        m16 = BEVSeg(preset(), device=dev)
        m16.load_state_dict(m32.state_dict())
        out[name] = dict(model32=m32, model16=m16)
    cfg = bev_preset()
    log(f"BEVSeg ({cfg.grid[0]} x {cfg.grid[1]} grid, {cfg.max_pillars} "
        f"pillars x {cfg.max_points_per_pillar} points, encoder "
        f"{cfg.enc_channels} x {cfg.enc_blocks}, decoder {cfg.dec_channels},"
        f" {cfg.num_classes} classes; "
        f"{sum(p.numel() for p in out['pano']['model32'].parameters())} "
        f"parameters with the panoptic heads): {out['centres']} centres "
        "above 0.1 on frame 0 after calibration")
    return out


def seg_stats_equal(name, a, b, classes):
    """Two SegmentationStats: integer counters equal, cumiou within 1e-12
    relative. Returns the largest relative cumiou difference."""
    worst = 0.0
    for f in ("tp", "fp", "fn", "itp", "ifp", "ifn"):
        check(getattr(a, f) == getattr(b, f), f"{name}: {f} differs")
    for k in classes:
        x, y = a.cumiou[k], b.cumiou[k]
        worst = max(worst, abs(x - y) / max(abs(y), 1e-300))
    check(worst <= 1e-12, f"{name}: cumiou differs by {worst} relative")
    return worst


def bevseg_serving(dev, bev, frames):
    """make_predictor (the semantic preset) and make_panoptic_predictor
    (top_k 64) on every frame, counts read over the requests (no kernel
    of the port's); the predictions scored by SegmentationEvaluator on
    the host (per frame, timed) and by device_panoptic_stats on the card,
    counters equal; then each predictor's steady request (median of 10
    after a warm-up) and the card's busy share over 5 requests."""
    from torch.profiler import ProfilerActivity, profile

    from d3d_tpu_torch.benchmarks import SegmentationEvaluator
    from d3d_tpu_torch.benchmarks_device import (device_panoptic_stats,
                                                 device_semantic_stats)
    from d3d_tpu_torch.models import make_panoptic_predictor, make_predictor

    classes = list(range(1, bev_preset().num_classes))
    preds = {"semantic": make_predictor(bev["sem"]["model16"], bev_preset(),
                                        device=dev),
             "panoptic": make_panoptic_predictor(
                 bev["pano"]["model16"], pano_preset(), top_k=64,
                 device=dev)}
    stats, out = {}, {}
    reset_counts()
    for name, predict in preds.items():
        res, ms = [], []
        for f in frames:
            r, dev_ms, _ = timed(lambda: predict(None, f["points"]))
            res.append(r)
            ms.append(dev_ms)
        n = len(frames)
        for i in range(3):
            predict(None, frames[i % n]["points"])
        steady = [timed(lambda: predict(None, frames[i % n]["points"]))
                  for i in range(10)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(5):
                predict(None, frames[i % n]["points"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stats[name] = dict(
            request_ms=ms, steady_ms=statistics.median(s[1] for s in steady),
            steady_host_ms=statistics.median(s[2] for s in steady),
            busy_share=busy_share(prof, wall))
        out[name] = res
    counts = read_counts()
    check(counts == want_counts(), f"BEVSeg requests: launches {counts}")
    sem = [r.cpu().numpy().astype(np.uint8) for r in out["semantic"]]
    pano_sem = [r[0].cpu().numpy().astype(np.uint8) for r in out["panoptic"]]
    pano_ids = [r[1].cpu().numpy() for r in out["panoptic"]]
    check(all(s.shape == f["labels"].shape for s, f in zip(sem, frames))
          and all(i.dtype == np.uint16 for i in pano_ids)
          and sum(int((i > 0).sum()) for i in pano_ids) > 0,
          "BEVSeg predictions: shapes, dtypes or no instance")
    gts = [f["labels"] for f in frames]
    gids = [f["ids"] for f in frames]
    host = SegmentationEvaluator(classes, background=0)
    host_ms = []
    for g, p, gi, pi in zip(gts, pano_sem, gids, pano_ids):
        t0 = time.perf_counter()
        host.add_stats(host.calc_stats(g, p, gi, pi))
        host_ms.append((time.perf_counter() - t0) * 1e3)
    ev = SegmentationEvaluator(classes, background=0)
    dev_stats, dev_ms, _ = timed(lambda: device_panoptic_stats(
        ev, gts, pano_sem, gids, pano_ids, device=dev))
    err = seg_stats_equal("BEVSeg panoptic scores host vs card",
                          dev_stats, host.get_stats(), classes)
    sem_host = SegmentationEvaluator(classes, background=0)
    for g, p in zip(gts, sem):
        sem_host.add_stats(sem_host.calc_stats(g, p))
    sem_dev = device_semantic_stats(ev, gts, sem, device=dev)
    for f in ("tp", "fp", "fn"):
        check(getattr(sem_dev, f) == getattr(sem_host.get_stats(), f),
              f"BEVSeg semantic scores host vs card: {f}")
    ev.add_stats(dev_stats)
    pq = [v for v in ev.pq().values() if not np.isnan(v)]
    stats.update(host_eval_ms_per_frame=statistics.median(host_ms),
                 device_eval_ms=dev_ms, cumiou_rel_err=err,
                 miou=float(np.nanmean(list(ev.iou().values()))),
                 mean_pq=float(np.mean(pq)) if pq else None)
    log("BEVSeg serving (bf16 presets): "
        + "; ".join(f"{k} requests " + ", ".join(
            f"{m:.2f}" for m in v["request_ms"]) + f" ms (CUDA events, the "
            f"first cold), steady {v['steady_ms']:.2f} ms (host "
            f"{v['steady_host_ms']:.2f} ms), busy share "
            f"{v['busy_share'] if v['busy_share'] is None else round(v['busy_share'], 3)}"
            for k, v in stats.items() if isinstance(v, dict))
        + f"; scored on the host {stats['host_eval_ms_per_frame']:.1f} ms a "
        f"frame, by device_panoptic_stats {dev_ms:.1f} ms for "
        f"{len(frames)} frames, counters equal, cumiou within {err:.3g}; "
        f"mIoU {stats['miou']:.4f}, mean PQ {stats['mean_pq']}")
    return counts, stats


def bevseg_card_vs_cpu(dev, bev, points):
    """Frame ``points`` through the f32 panoptic model on the card (TF32
    off) and the same weights on the CPU: per-point logits, the centre
    heatmap and the offsets within 1e-4 of each output's largest
    magnitude. Returns the errors and the CPU network's ms."""
    from d3d_tpu_torch.models import BEVSeg

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    m32 = bev["pano"]["model32"]
    cpu_model = BEVSeg(m32.cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               m32.state_dict().items()})
    raw, ms = [], []
    for m, d in ((m32, dev), (cpu_model, "cpu")):
        t0 = time.perf_counter()
        with torch.inference_mode():
            raw.append(m(*bev_inputs(points, m.cfg, d)))
        if d != "cpu":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    errs = {k: float((raw[0][k].cpu() - raw[1][k]).abs().max()
                     / raw[1][k].abs().max()) for k in raw[1]}
    check(max(errs.values()) <= 1e-4, f"BEVSeg card vs CPU: {errs}")
    log(f"BEVSeg card vs CPU (f32, TF32 off): logits, heatmap and offsets "
        f"within {max(errs.values()):.3g} of their largest magnitudes; the "
        f"network {ms[0]:.1f} ms on the card (first call), {ms[1]:.0f} ms "
        "on the CPU")
    return dict(errors=errs, cpu_network_ms=ms[1])


def bevseg_perfect_panoptic(dev, frames):
    """panoptic_targets of each frame's ground truth on the card, its
    heatmap as logits and its offsets as the predictions, grouped by
    group_instances (the gt labels as the semantic prediction):
    device_panoptic_stats gives PQ = 1 for every class with a thing."""
    from d3d_tpu_torch.benchmarks import SegmentationEvaluator
    from d3d_tpu_torch.benchmarks_device import device_panoptic_stats
    from d3d_tpu_torch.models import group_instances, panoptic_targets

    cfg = pano_preset()
    classes = list(range(1, cfg.num_classes))
    ids = []
    for f in frames:
        pts = torch.from_numpy(f["points"]).to(dev)
        labels = torch.from_numpy(f["labels"].astype(np.int32)).to(dev)
        t = panoptic_targets(cfg, pts, labels, torch.from_numpy(
            f["ids"].astype(np.int32)).to(dev))
        hm = torch.clamp(t["heatmap"], 1e-6, 1 - 1e-6)
        ids.append(group_instances(cfg, labels, pts, t["offset"],
                                   torch.log(hm) - torch.log1p(-hm),
                                   top_k=64).cpu().numpy())
    ev = SegmentationEvaluator(classes, background=0)
    gts = [f["labels"] for f in frames]
    ev.add_stats(device_panoptic_stats(ev, gts, gts, [f["ids"] for f in
                                                      frames], ids,
                                       device=dev))
    pq = {k: v for k, v in ev.pq().items() if not np.isnan(v)}
    check(pq and all(abs(v - 1.0) <= 1e-12 for v in pq.values()),
          f"perfect panoptic prediction: PQ {pq}")
    things = sum(len(np.unique(f["ids"][f["ids"] > 0])) for f in frames)
    log(f"panoptic_targets as predictions on the card: {things} thing "
        f"instances over {len(frames)} frames regrouped, PQ = 1 for classes "
        f"{sorted(pq)}")
    return dict(instances=things, classes=sorted(pq))


def bevseg_batch(dev, frames, keys=(0, 1)):
    """A panoptic training batch of two frames: pillars, cell coordinates,
    points, labels and instance ids, on the card."""
    cfg = pano_preset()
    parts = [bev_inputs(frames[i]["points"], cfg, dev) for i in keys]
    batch = {k: torch.cat([p[j] for p in parts]) for j, k in enumerate(
        ("features", "coords", "valid", "point_coords"))}
    batch.update(
        points=torch.stack([torch.from_numpy(frames[i]["points"])
                            for i in keys]).to(dev),
        labels=torch.stack([torch.from_numpy(frames[i]["labels"].astype(
            np.int32)) for i in keys]).to(dev),
        inst_ids=torch.stack([torch.from_numpy(frames[i]["ids"].astype(
            np.int32)) for i in keys]).to(dev))
    return batch


def bevseg_training(dev, bev, batch, dtype):
    """The panoptic make_train_step + make_optimizer from the calibrated
    f32 weights in ``dtype`` (f32 with TF32 off), batch 2, BEV_STEPS
    steps, counts read per step: losses finite, the last below the
    first. Returns (summed counts, stats)."""
    from d3d_tpu_torch.models import BEVSeg
    from d3d_tpu_torch.models.bevseg import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    model = BEVSeg(pano_preset(dtype=dtype), device=dev)
    model.load_state_dict(bev["pano"]["model32"].state_dict())
    opt, _ = make_optimizer(model.parameters(), total_steps=BEV_STEPS)
    step = make_train_step(model, opt, model.cfg)
    total, losses, step_ms = {}, [], []
    for i in range(BEV_STEPS):
        reset_counts()
        aux, ms, _ = timed(lambda: step(batch))
        c = read_counts()
        check(c == want_counts(), f"BEVSeg training {dtype} step {i + 1}: "
                                  f"launches {c}")
        add_counts(total, c)
        step_ms.append(ms)
        losses.append(float(aux["total"]))
        check(math.isfinite(losses[-1]), f"BEVSeg training {dtype}: loss "
                                         f"{losses[-1]}")
    check(losses[-1] < losses[0], f"BEVSeg training {dtype}: losses "
                                  f"{losses} do not fall")
    log(f"BEVSeg panoptic training {dtype} (batch 2): losses "
        + ", ".join(f"{l:.4f}" for l in losses) + "; step "
        + ", ".join(f"{m:.2f}" for m in step_ms) + " ms (CUDA events)")
    return total, dict(losses=losses, step_ms=step_ms)


def seg_scale_chunk(rng, frames, lo, hi):
    """Frames lo..hi of the evaluation set: frame j is KITTI-360 frame
    j % 4's ground truth, and its prediction that ground truth with 5% of
    the labels redrawn and 5% of the thing ids shifted by one (seeded): a
    good model's output, so most segments match."""
    n = len(frames[0]["labels"])
    idx = np.arange(lo, hi) % len(frames)
    gts = np.stack([frames[i]["labels"] for i in idx])
    gids = np.stack([frames[i]["ids"] for i in idx])
    flip = rng.random((hi - lo, n)) < 0.05
    sem = np.where(flip, rng.integers(0, 20, (hi - lo, n)), gts).astype(
        np.uint8)
    shift = rng.random((hi - lo, n)) < 0.05
    ids = np.where(shift & (gids > 0), gids + 1, gids).astype(np.uint16)
    return list(gts), list(sem), list(gids), list(ids)


def seg_eval_at_scale(dev, frames):
    """device_panoptic_stats over SEG_SCALE_FRAMES frames of the scan's
    size in chunks of SEG_SCALE_CHUNK (the host packing timed apart from
    the device counting and its copies), the first SEG_SCALE_CHECKED
    frames' counters held to the host evaluator's."""
    from d3d_tpu_torch import benchmarks_device as bd
    from d3d_tpu_torch.benchmarks import SegmentationEvaluator

    classes = list(range(1, bev_preset().num_classes))
    ev = SegmentationEvaluator(classes, background=0)
    rng = np.random.default_rng(950)
    pack_s = device_s = make_s = 0.0
    total = None
    for lo in range(0, SEG_SCALE_FRAMES, SEG_SCALE_CHUNK):
        t0 = time.perf_counter()
        gts, sem, gids, ids = seg_scale_chunk(rng, frames, lo,
                                              lo + SEG_SCALE_CHUNK)
        t1 = time.perf_counter()
        if lo == 0:
            host = SegmentationEvaluator(classes, background=0)
            h0 = time.perf_counter()
            for a in zip(gts[:SEG_SCALE_CHECKED], sem, gids, ids):
                host.add_stats(host.calc_stats(*a))
            host_ms = (time.perf_counter() - h0) * 1e3 / SEG_SCALE_CHECKED
            first = bd.device_panoptic_stats(
                ev, gts[:SEG_SCALE_CHECKED], sem[:SEG_SCALE_CHECKED],
                gids[:SEG_SCALE_CHECKED], ids[:SEG_SCALE_CHECKED],
                device=dev)
            seg_stats_equal(f"first {SEG_SCALE_CHECKED} frames host vs card",
                            first, host.get_stats(), classes)
        t2 = time.perf_counter()
        gt, pr = bd._pack_labels(ev, gts, sem)
        nmax = max(len(g) for g in gts)
        gk = bd._panoptic_keys(ev, gts, gids, nmax, 0)
        pk = bd._panoptic_keys(ev, sem, ids, nmax, 0)
        t3 = time.perf_counter()
        conf = bd._confusion_on(gt, pr, dev)
        pano = bd._panoptic_on(gk, pk, ev._min_points, 0, dev)
        t4 = time.perf_counter()
        part = [conf] + pano
        total = part if total is None else [a + b for a, b in
                                            zip(total, part)]
        make_s += t1 - t0
        pack_s += t3 - t2
        device_s += t4 - t3
    stats = dict(frames=SEG_SCALE_FRAMES, points=len(frames[0]["labels"]),
                 chunk=SEG_SCALE_CHUNK, host_pack_ms=pack_s * 1e3,
                 device_ms=device_s * 1e3,
                 device_ms_per_frame=device_s * 1e3 / SEG_SCALE_FRAMES,
                 host_eval_ms_per_frame=host_ms, data_s=make_s,
                 matched=int(total[1].sum()),
                 pq=float(total[4].sum() / max(total[1].sum() + 0.5 * (
                     total[2].sum() + total[3].sum()), 1)))
    log(f"segmentation evaluation at scale: {SEG_SCALE_FRAMES} frames x "
        f"{stats['points']} points in chunks of {SEG_SCALE_CHUNK}: device "
        f"counting {stats['device_ms']:.0f} ms ({stats['device_ms_per_frame']:.2f}"
        f" ms a frame, copies included), host packing "
        f"{stats['host_pack_ms']:.0f} ms; the host evaluator "
        f"{host_ms:.1f} ms a frame; the first {SEG_SCALE_CHECKED} frames' "
        f"counters equal to the host's; {stats['matched']} segments matched, "
        f"overall PQ {stats['pq']:.4f}")
    return stats


def bevseg_kitti360(dev):
    """The bevseg_kitti360 path. Returns ({path: counts}, stats, the
    KITTI-360 frames with their transferred labels)."""
    import shutil

    from d3d_tpu_torch.models import BEVSeg
    from d3d_tpu_torch.models.bevseg import make_train_step

    t0 = time.perf_counter()
    root = ROOT / "build" / "bevseg_kitti360"
    shutil.rmtree(root, ignore_errors=True)
    windows = write_kitti360_scene(root)
    stats = dict(write_s=time.perf_counter() - t0)
    reset_counts()
    loader, frames, stats["transfer"] = k360_transfer(dev, root, windows)
    counts = {"kitti360_transfer": read_counts()}
    check(counts["kitti360_transfer"] == want_counts(),
          f"label transfer: launches {counts['kitti360_transfer']}")
    bev = bevseg_setup(dev, frames)
    stats["calibrated_centres"] = bev["centres"]
    counts["bevseg_serving"], stats["serving"] = bevseg_serving(dev, bev,
                                                                frames)
    stats["card_vs_cpu"] = bevseg_card_vs_cpu(dev, bev, frames[0]["points"])
    stats["perfect_panoptic"] = bevseg_perfect_panoptic(dev, frames)
    batch = bevseg_batch(dev, frames)
    total = {}
    for dtype in ("float32", "bfloat16"):
        c, stats[f"train_{dtype}"] = bevseg_training(dev, bev, batch, dtype)
        add_counts(total, c)
    counts["bevseg_train"] = total
    stats["grad_err"], stats["cpu_step_ms"] = grads_card_vs_cpu(
        "BEVSeg panoptic", dev,
        lambda d, dt: BEVSeg(pano_preset(dtype=dt), device=d),
        bev["pano"]["model32"].state_dict(), batch,
        lambda m, opt: make_train_step(m, opt, m.cfg))
    stats["eval_at_scale"] = seg_eval_at_scale(dev, frames)
    stats["phase_s"] = time.perf_counter() - t0
    log(f"bevseg_kitti360: {stats['phase_s']:.1f} s")
    del bev, batch, loader
    torch.cuda.empty_cache()
    return counts, stats, frames


# ---------------------------------------------------------------------------
# sst_kitti: the transformer family served and trained at full width
# ---------------------------------------------------------------------------

SST_STEPS = 5          # training steps a dtype
SST_MOE_EXPERTS = 8    # scripts/aot_parallel_scale.py's value for sst_kitti
SST_MOE_STEPS = 3


def sst_preset(**kw):
    """The phase's configuration: the KITTI SST preset, uncut."""
    from d3d_tpu_torch.models import presets

    return presets.sst_kitti(**kw)


def sst_setup(dev):
    """SST on presets.sst_kitti uncut: f32 and the bf16 preset on the same
    seeded weights (heads calibrated on bench frame 0 as PointPillars'),
    4 of bench.py's 120k-point frames and 2 KITTI-like frames."""
    from d3d_tpu_torch.models import SST, make_anchors

    cfg32 = sst_preset(dtype="float32")
    frames = [bench_points(np.random.default_rng(100 + i)) for i in range(4)]
    frames += [kitti_like_points(600), kitti_like_points(601)]
    model32 = SST(cfg32, device=dev,
                  generator=torch.Generator().manual_seed(14))
    calibrate_heads(model32, frames[0], dev)
    model16 = SST(sst_preset(), device=dev)
    model16.load_state_dict(model32.state_dict())
    log(f"SST ({cfg32.grid[0]} x {cfg32.grid[1]} grid, {cfg32.depth} blocks "
        f"of {cfg32.num_heads} heads over {cfg32.window} x {cfg32.window}-"
        f"cell windows of {cfg32.capacity} slots, C = {cfg32.pfn_features}, "
        f"{sum(p.numel() for p in model32.parameters())} parameters) heads "
        "calibrated on bench frame 0")
    return dict(cfg32=cfg32, model32=model32, model16=model16, frames=frames,
                anchors=make_anchors(cfg32, device=dev))


def sst_flops(cfg, batch=1):
    """Multiply-adds x 2 of one SST forward at ``cfg``'s width, every
    window slot counted (empty ones too, as the design computes them):
    per block qkv, logits, attention x values, proj and the MLP on
    n_windows x capacity tokens, then the neck's two 3x3 convolutions and
    the heads on the full grid."""
    from d3d_tpu_torch.models.sst import _tiling

    c, w, h = cfg.pfn_features, cfg.grid[0], cfg.grid[1]
    total = 0
    for d in range(cfg.depth):
        _, nwx, nwy = _tiling(cfg.grid, cfg.window, bool(d % 2))
        t = nwx * nwy * cfg.capacity
        total += 2 * t * (3 * c * c + 2 * cfg.capacity * c + c * c
                          + 2 * cfg.mlp_ratio * c * c)
    n = cfg.neck_channels
    total += 2 * w * h * (9 * c * n + 9 * n * n
                          + n * cfg.num_anchors_per_cell * (
                              cfg.num_classes + 9))
    return batch * total


def hooked_stage_times(detect, model, pts, reps=5):
    """Device ms of a request's stages by CUDA events recorded from forward
    hooks (median of ``reps`` requests after one warm-up): pillarize (the
    request's start to the network's), the PFN and positional embedding,
    each block (with the routing before it), the neck and heads, then
    decode and NMS (the network's end to the request's)."""
    marks, hooks = [], []

    def mark(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        return hook

    hooks.append(model.register_forward_pre_hook(mark("network")))
    for i, blk in enumerate(model.blocks):
        hooks.append(blk.register_forward_pre_hook(mark(f"block{i}")))
    hooks.append(model.neck.register_forward_pre_hook(mark("neck")))
    hooks.append(model.register_forward_hook(mark("heads_end")))
    names = (["pillarize", "pfn_embed"]
             + [f"block{i}" for i in range(len(model.blocks))]
             + ["neck_heads", "decode_nms"])
    runs = []
    try:
        for r in range(reps + 1):
            marks.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            detect.device_fn(pts)
            end.record()
            end.synchronize()
            evs = [start] + [e for _, e in marks] + [end]
            if r:
                runs.append([a.elapsed_time(b)
                             for a, b in zip(evs[:-1], evs[1:])])
    finally:
        for h in hooks:
            h.remove()
    return {n: statistics.median(run[i] for run in runs)
            for i, n in enumerate(names)}


def sst_serving(dev, sst):
    """make_sst_detector on the 6 frames in f32 (TF32 off) and the bf16
    preset, counts read per request (K1's bit form and the scan once
    each, nothing else); one request held to the CPU; steady request ms by
    CUDA events (median of 10), the busy share over 5 requests, the
    request's stages and each frame's share of empty window slots."""
    from torch.profiler import ProfilerActivity, profile

    from d3d_tpu_torch.models import SST, make_sst_detector, pillarize
    from d3d_tpu_torch.models.sst import empty_slot_share

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames, anchors = sst["frames"], sst["anchors"]
    models = {"f32": sst["model32"], "bf16": sst["model16"]}
    detect = {dt: make_sst_detector(m, None, m.cfg, anchors, car_classes(),
                                    device=dev) for dt, m in models.items()}
    stats, total = {}, {}
    for dt, det in detect.items():
        ms, kept = [], []
        for i, pts in enumerate(frames):
            reset_counts()
            out, dev_ms, _ = timed(lambda: det(pts))
            c = read_counts()
            check(c == want_counts(rbox_iou_matrix=1, nms_scan=1),
                  f"SST request ({dt}, frame {i}): launches {c}")
            check_nms_routes(f"SST request ({dt}, frame {i})", 1)
            add_counts(total, c)
            kept.append(check_detections(f"SST {dt}", out))
            ms.append(dev_ms)
        steady = [timed(lambda: det(frames[i % 4])) for i in range(10)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(5):
                det(frames[i % 4])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stats[dt] = dict(
            request_ms=ms, kept=kept,
            steady_ms=statistics.median(s[1] for s in steady),
            steady_host_ms=statistics.median(s[2] for s in steady),
            busy_share=busy_share(prof, wall),
            stages_ms=hooked_stage_times(det, models[dt], frames[0]))
        s = stats[dt]
        log(f"SST serving {dt}{' (TF32 off)' if dt == 'f32' else ''}: "
            "requests " + ", ".join(f"{m:.2f}" for m in ms) + " ms (events,"
            f" the first cold), steady {s['steady_ms']:.2f} ms (host "
            f"{s['steady_host_ms']:.2f}; median of 10), busy share "
            f"{s['busy_share'] if s['busy_share'] is None else round(s['busy_share'], 3)}"
            f"; kept {kept}; stages " + ", ".join(
                f"{k} {v:.2f}" for k, v in s["stages_ms"].items()) + " ms")
    cfg = sst["cfg32"]
    shares = []
    with torch.inference_mode():
        for pts in frames:
            _, coords, valid = pillarize(torch.from_numpy(pts).to(dev), cfg)
            shares.append(empty_slot_share(cfg, coords[None], valid[None]))
    stats["empty_slot_share"] = shares
    stats["gflop"] = sst_flops(cfg) / 1e9
    log(f"SST empty window slots a request (bench frames, KITTI-like): "
        + ", ".join(f"{s:.1%}" for s in shares) + f" of the "
        f"{cfg.depth} blocks' slots; {stats['gflop']:.0f} GFLOP a request, "
        "every slot counted")
    stats["no_tf32_ms"], stats["cpu_ms"] = compare_with_cpu(
        "sst", sst["model32"], SST(cfg, device="cpu"), frames[0],
        detect["f32"], anchors, dev)
    return total, stats, detect["bf16"]


def sst_batch(dev, cfg, frames):
    """Two bench frames through pillarize, stacked, with ``car_gt``'s six
    boxes a frame."""
    from d3d_tpu_torch.models import pillarize

    with torch.inference_mode():
        pil = [pillarize(torch.from_numpy(p).to(dev), cfg) for p in frames]
    batch = {k: torch.stack([v[i] for v in pil]).clone()
             for i, k in enumerate(("features", "coords", "valid"))}
    return dict(batch, **car_gt(dev, len(frames)))


def sst_steps(dev, model, batch, steps, name, falling=True):
    """make_train_step + make_optimizer over ``steps`` steps, counts read
    per step (no kernel of the port's: targets by axis-aligned IoU), the
    loss finite and, with ``falling``, lower at the last step than at the
    first. Returns (counts, losses, step ms, moe_aux)."""
    from d3d_tpu_torch.models import make_anchors
    from d3d_tpu_torch.models.pointpillars import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    opt, _ = make_optimizer(model.parameters(), total_steps=steps)
    step = make_train_step(model, opt, model.cfg,
                           make_anchors(model.cfg, device=dev))
    total, losses, step_ms, moe = {}, [], [], []
    for i in range(steps):
        reset_counts()
        aux, ms, _ = timed(lambda: step(batch))
        c = read_counts()
        check(c == want_counts(), f"{name} step {i + 1}: launches {c}")
        add_counts(total, c)
        step_ms.append(ms)
        losses.append(float(aux["total"]))
        if "moe_aux" in aux:
            moe.append(float(aux["moe_aux"]))
        check(math.isfinite(losses[-1]), f"{name}: loss {losses[-1]}")
    check(not falling or losses[-1] < losses[0],
          f"{name}: losses {losses} do not fall")
    log(f"{name} (batch 2): losses " + ", ".join(f"{l:.4f}" for l in losses)
        + "; step " + ", ".join(f"{m:.2f}" for m in step_ms)
        + " ms (CUDA events)"
        + (f"; moe_aux " + ", ".join(f"{a:.4f}" for a in moe) if moe
           else ""))
    return total, losses, step_ms, moe


def sst_remat_check(dev, sst, batch):
    """remat_blocks=True: one f32 step (TF32 off, cuDNN deterministic)
    equal to the plain step from the same weights, loss and every
    gradient bit for bit."""
    from d3d_tpu_torch.models import SST, make_anchors
    from d3d_tpu_torch.models.pointpillars import make_train_step

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for remat in (False, True):
            model = SST(sst_preset(dtype="float32", remat_blocks=remat),
                        device=dev)
            model.load_state_dict(sst["model32"].state_dict())
            step = make_train_step(
                model, torch.optim.SGD(model.parameters(), lr=0.0),
                model.cfg, make_anchors(model.cfg, device=dev))
            torch.cuda.reset_peak_memory_stats(dev)
            aux = step(batch)
            runs.append((float(aux["total"]),
                         {n: p.grad.clone()
                          for n, p in model.named_parameters()},
                         torch.cuda.max_memory_allocated(dev) / 2 ** 30))
    finally:
        torch.backends.cudnn.deterministic = det
    check(runs[0][0] == runs[1][0]
          and all(torch.equal(g, runs[1][1][n])
                  for n, g in runs[0][1].items()),
          "SST remat_blocks step differs from the plain step")
    log(f"SST remat_blocks: one f32 step equal to the plain step bit for "
        f"bit; peak memory {runs[0][2]:.2f} GiB plain, {runs[1][2]:.2f} GiB "
        "with remat_blocks")
    return dict(peak_gib_plain=runs[0][2], peak_gib_remat=runs[1][2])


def sst_kitti(dev):
    """The sst_kitti path. Returns ({path: counts}, stats, the bf16
    detector and the frames)."""
    from d3d_tpu_torch.models import SST
    from d3d_tpu_torch.models import make_anchors
    from d3d_tpu_torch.models.pointpillars import make_train_step

    t0 = time.perf_counter()
    sst = sst_setup(dev)
    counts, stats = {}, {}
    counts["sst_serving"], stats["serving"], detect16 = sst_serving(dev, sst)
    batch = sst_batch(dev, sst["cfg32"], sst["frames"][:2])
    total = {}
    for dtype in ("float32", "bfloat16"):
        model = SST(sst_preset(dtype=dtype), device=dev)
        model.load_state_dict(sst["model32"].state_dict())
        c, losses, ms, _ = sst_steps(dev, model, batch, SST_STEPS,
                                     f"SST training {dtype}")
        stats[f"train_{dtype}"] = dict(losses=losses, step_ms=ms)
        add_counts(total, c)
        del model
    # one frame: the CPU's step at full width takes ~17 s a frame
    stats["grad_err"], stats["cpu_step_ms"] = grads_card_vs_cpu(
        "SST", dev, lambda d, dt: SST(sst_preset(dtype=dt), device=d),
        sst["model32"].state_dict(), {k: v[:1] for k, v in batch.items()},
        lambda m, opt: make_train_step(
            m, opt, m.cfg, make_anchors(m.cfg,
                                        device=next(m.parameters()).device)))
    stats["remat_blocks"] = sst_remat_check(dev, sst, batch)
    # the Switch-MoE variant: 8 experts, bf16
    moe = SST(sst_preset(moe_experts=SST_MOE_EXPERTS), device=dev,
              generator=torch.Generator().manual_seed(15))
    moe.load_state_dict(sst["model32"].state_dict(), strict=False)
    torch.cuda.reset_peak_memory_stats(dev)
    c, losses, ms, aux = sst_steps(dev, moe, batch, SST_MOE_STEPS,
                                   f"SST-MoE ({SST_MOE_EXPERTS} experts) "
                                   "training bfloat16", falling=False)
    add_counts(total, c)
    depth = moe.cfg.depth
    check(all(a >= depth * (1 - 1e-4) for a in aux),
          f"SST-MoE moe_aux {aux} below the Switch bound {depth}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    stats["moe"] = dict(losses=losses, step_ms=ms, moe_aux=aux,
                        peak_gib=peak)
    log(f"SST-MoE: moe_aux >= depth ({depth}) every step; peak memory "
        f"{peak:.2f} GiB (torch.cuda.max_memory_allocated, index dispatch)")
    counts["sst_train"] = total
    stats["phase_s"] = time.perf_counter() - t0
    log(f"sst_kitti: {stats['phase_s']:.1f} s")
    del moe, batch
    torch.cuda.empty_cache()
    return counts, stats, detect16, sst["frames"][:4]


# ---------------------------------------------------------------------------
# export: detectors through torch.export, saved, loaded and served
# ---------------------------------------------------------------------------

def export_roundtrip(name, device_fn, inputs, reps=10):
    """``device_fn`` exported (example ``inputs[0]``) and saved under
    build/export/ by ``save_detector``, then loaded; on every input of
    ``inputs`` two eager requests equal, the loaded artifact's outputs
    bit-equal to them and its kernel launches (counted in the ops' CUDA
    implementations) equal to an eager request's; then both requests'
    steady ms (CUDA events, median of ``reps``, in turns). Returns (the
    loaded artifact's counts, stats)."""
    from d3d_tpu_torch.export import load_detector, save_detector

    path = ROOT / "build" / "export" / f"{name}.zip"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    save_detector(device_fn, inputs[0], path, meta={"family": name})
    export_s = time.perf_counter() - t0
    loaded = load_detector(path)
    check(loaded.meta == {"family": name}
          and loaded.platforms == ("cuda",),
          f"export {name}: meta {loaded.meta}, platforms "
          f"{loaded.platforms}")
    ops = sorted({str(n.target) for n in loaded.program.graph.nodes
                  if str(n.target).startswith("d3d_tpu_torch")})
    total = {}
    for i, args in enumerate(inputs):
        reset_counts()
        want = device_fn(*args)
        torch.cuda.synchronize()
        eager = read_counts()
        check(all(torch.equal(a, b) for a, b in zip(want, device_fn(*args))),
              f"export {name} input {i}: two eager requests differ")
        reset_counts()
        got = loaded(*args)
        torch.cuda.synchronize()
        c = read_counts()
        check(c == eager, f"export {name} input {i}: the artifact launched "
                          f"{c}, the eager request {eager}")
        check(len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, want)),
              f"export {name} input {i}: outputs differ from the eager "
              "device_fn's: " + str([
                  float((a.double() - b.double()).abs().max())
                  for a, b in zip(got, want)]))
        add_counts(total, c)
    eager_ms, loaded_ms = [], []
    for r in range(reps):
        for fn, out in ((device_fn, eager_ms), (loaded, loaded_ms)):
            out.append(timed(lambda: fn(*inputs[r % len(inputs)]))[1])
    stats = dict(ops=ops, export_s=export_s,
                 artifact_mb=path.stat().st_size / 2 ** 20,
                 eager_ms=statistics.median(eager_ms),
                 loaded_ms=statistics.median(loaded_ms))
    log(f"export {name}: traced and saved in {export_s:.1f} s, "
        f"{stats['artifact_mb']:.1f} MB, ops {ops}; {len(inputs)} inputs "
        f"bit-equal to the eager "
        f"device_fn with equal launches ({c} the last); request "
        f"{stats['eager_ms']:.2f} ms eager, {stats['loaded_ms']:.2f} ms "
        "loaded (CUDA events, median of 10 in turns)")
    return total, stats


def op_dispatch_cost(dev):
    """The host cost of calling a kernel through its torch.library op
    rather than its launch function: K1's bit form on nms2d's 100 boxes,
    ms a call by CUDA events over back-to-back calls, both ways. The
    counts these calls add are set to 0 after."""
    from d3d_tpu_torch.ops import geometry_cuda

    boxes = torch.from_numpy(bench_boxes(np.random.default_rng(62),
                                         100)[0]).to(dev)
    direct = time_launches(lambda: geometry_cuda._bits_launch(boxes, 0.5))
    op = time_launches(
        lambda: torch.ops.d3d_tpu_torch.rbox_overlap_bits(boxes, 0.5))
    reset_counts()
    log(f"K1's bit form on 100 boxes: {direct:.4f} ms a launch called "
        f"directly, {op:.4f} ms through its torch.library op (events over "
        "back-to-back calls)")
    return dict(direct_ms=direct, op_ms=op)


def export_phase(dev, sst_detect, frames, vn):
    """The export path: the SST detector (bf16) and the PointPillars one
    at pointpillars_kitti (bf16, heads calibrated) on the 4 bench frames,
    Mono3D's two-input detector at mono3d_kitti and VoxelNeXt's at
    voxelnext_nuscenes (bf16; K5 and the rule books as ops)."""
    from d3d_tpu_torch.models import (Mono3D, PointPillars, make_anchors,
                                      make_mono3d_detector,
                                      make_pointpillars_detector,
                                      make_voxelnext_detector, presets)

    t0 = time.perf_counter()
    counts, stats = {}, {}
    args = [(f,) for f in frames]
    counts["export_sst"], stats["sst"] = export_roundtrip(
        "sst", sst_detect.device_fn, args)
    cfg = presets.pointpillars_kitti()
    pp = PointPillars(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    calibrate_heads(pp, frames[0], dev)
    pp_detect = make_pointpillars_detector(
        pp, None, cfg, make_anchors(cfg, device=dev), car_classes(),
        device=dev)
    counts["export_pointpillars"], stats["pointpillars"] = export_roundtrip(
        "pointpillars", pp_detect.device_fn, args)
    mcfg = mono_preset()
    rng = np.random.default_rng(61)
    images = [rng.random(mcfg.image_size + (3,)).astype(np.float32)
              for _ in range(2)]
    mono = Mono3D(mcfg, device=dev,
                  generator=torch.Generator().manual_seed(51))
    calibrate_mono3d(mono, images[0], dev)
    k = KITTI_P_BASE[:, :3] * np.array([[mcfg.image_size[1]
                                         / KITTI_IMAGE[1]],
                                        [mcfg.image_size[0]
                                         / KITTI_IMAGE[0]], [1.0]])
    mdet = make_mono3d_detector(mono, None, mcfg, kitti_classes(),
                                device=dev)
    counts["export_mono3d"], stats["mono3d"] = export_roundtrip(
        "mono3d", mdet.device_fn,
        [(im, k.astype(np.float32)) for im in images])
    vdet = make_voxelnext_detector(vn["model16"], None, vn["model16"].cfg,
                                   nusc_classes(), device=dev)
    n = min(len(c) for c in vn["clouds"][:2])
    counts["export_voxelnext"], stats["voxelnext"] = export_roundtrip(
        "voxelnext", vdet.device_fn,
        [(np.ascontiguousarray(c[:n]),) for c in vn["clouds"][:2]])
    stats["op_dispatch"] = op_dispatch_cost(dev)
    stats["phase_s"] = time.perf_counter() - t0
    log(f"export: {stats['phase_s']:.1f} s")
    return counts, stats


# ---------------------------------------------------------------------------
# parallel: the scale-out layer as a world of one under NCCL
# ---------------------------------------------------------------------------

PAR_STEPS = 3          # sharded and plain training steps a dtype
PAR_EVAL_FRAMES = 512  # the first val-split frames of kitti_eval's bank
PAR_SEG_FRAMES = 16


def median_ms(fn, reps=10, warmup=2):
    """The median of ``reps`` calls of ``fn`` by CUDA events, after
    ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        _, ms, _ = timed(fn)
        times.append(ms)
    return statistics.median(times)


def parallel_serving(dev, mesh, detect, frames):
    """shard_inference of the PointPillars detector (pointpillars_kitti,
    full width) over the mesh's dp axis on the 4 bench frames: every
    output bit-equal to 4 eager requests; K1's bit form and the scan 4
    times. Times one frame's share of the sharded call against one eager
    request."""
    from d3d_tpu_torch.parallel.mesh import shard_inference

    batched = shard_inference(detect.device_fn, mesh)
    pts = np.stack(frames)
    reset_counts()
    with torch.inference_mode():
        out = batched(pts)
    torch.cuda.synchronize()
    counts = read_counts()
    routes = check_nms_routes("parallel serving", 4)
    check(counts == want_counts(rbox_iou_matrix=4, nms_scan=4),
          f"parallel serving: launches {counts}")
    eager = [detect.device_fn(p) for p in frames]
    for i, e in enumerate(eager):
        for k, t in enumerate(e):
            check(torch.equal(out[k][i], t),
                  f"parallel serving: frame {i} output {k} differs from "
                  "the eager request")
    sharded_ms = median_ms(lambda: batched(pts)) / len(frames)
    eager_ms = median_ms(lambda: detect.device_fn(frames[0]))
    log(f"parallel serving: shard_inference of 4 frames bit-equal to 4 "
        f"eager requests; {sharded_ms:.3f} ms a frame against "
        f"{eager_ms:.3f} ms an eager request (CUDA events, median of 10); "
        f"routes {routes}")
    return counts, dict(sharded_ms_per_frame=sharded_ms,
                        eager_ms_per_request=eager_ms)


def parallel_eval(dev, mesh, bev_frames):
    """device_calc_stats(mesh=) over the first PAR_EVAL_FRAMES of
    kitti_eval's val-split bank and device_panoptic_stats(mesh=) on
    bevseg_kitti360's frames (seg_scale_chunk's predictions), each equal
    to mesh=None (counters exact, accuracies 1e-6, cumulative IoU
    1e-12); both timed with and without the mesh (host clock around the
    call: it packs on the host)."""
    from d3d_tpu_torch import benchmarks_device as bd
    from d3d_tpu_torch.benchmarks import (DetectionEvaluator,
                                          SegmentationEvaluator)
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass

    gts, dts = val_scale_frames()
    gts, dts = gts[:PAR_EVAL_FRAMES], dts[:PAR_EVAL_FRAMES]
    ev = DetectionEvaluator([KittiObjectClass.Car], EVAL_OVERLAPS[0],
                            device=dev)
    reset_counts()
    sharded = bd.device_calc_stats(ev, gts, dts, mesh=mesh)
    counts = read_counts()
    plain = bd.device_calc_stats(ev, gts, dts)
    same_stats("parallel device_calc_stats mesh vs none", sharded, plain,
               rtol=1e-6)
    car = KittiObjectClass.Car.value
    check(int(sharded.tp[car].sum()) > 0, "parallel eval: no true positive")
    times = {}
    for name, m in (("mesh", mesh), ("none", None)):
        times[name] = host_ms(
            lambda: bd.device_calc_stats(ev, gts, dts, mesh=m), reps=2)
    classes = list(range(1, bev_preset().num_classes))
    sev = SegmentationEvaluator(classes, background=0)
    seg = seg_scale_chunk(np.random.default_rng(951), bev_frames, 0,
                          PAR_SEG_FRAMES)
    reset_counts()
    pano = bd.device_panoptic_stats(sev, *seg, mesh=mesh, device=dev)
    add_counts(counts, read_counts())
    want = bd.device_panoptic_stats(sev, *seg, device=dev)
    seg_stats_equal("parallel device_panoptic_stats mesh vs none", pano,
                    want, classes)
    check(counts == want_counts(), f"parallel eval: launches {counts}")
    log(f"parallel eval: device_calc_stats over {len(gts)} frames equal "
        f"with and without the mesh, {times['mesh']:.1f} ms against "
        f"{times['none']:.1f} ms (host clock, median of 2); "
        f"device_panoptic_stats over {PAR_SEG_FRAMES} frames equal")
    return counts, dict(calc_stats_mesh_ms=times["mesh"],
                        calc_stats_ms=times["none"])


def max_param_diff(a, b, grads=None, names=None):
    """The largest difference between two models' state dicts (the entries
    ``names`` only, where given), over entries whose gradient (``grads``)
    is above 1e-4 of its leaf's largest: Adam's first step is about lr *
    sign(g), so a gradient at rounding level may flip its update."""
    worst = 0.0
    for k, w in b.items():
        if not w.dtype.is_floating_point or (names is not None
                                             and k not in names):
            continue
        d = (a[k].float() - w.float()).abs()
        if grads is not None and k in grads:
            g = grads[k].abs()
            d = torch.where(g > 1e-4 * g.max(), d, 0.0)
        worst = max(worst, float(d.max()))
    return worst


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN deterministic and ``torch.use_deterministic_algorithms``
    (warnings only) for the enclosed code, the previous settings restored
    after it."""
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1], warn_only=saved[2])


def parallel_training(dev, mesh, state, batch):
    """shard_train_step of SECOND (second_kitti, full width, batch 2) on
    the one-rank mesh against the plain step from the same weights:
    PAR_STEPS f32 steps (TF32 off) and PAR_STEPS bf16 steps through
    ``sharded_vs_plain`` under ``deterministic_algorithms`` (otherwise the
    backward's scatter-adds sum in no fixed order, and two plain runs
    differ by about 1.5e-6 of a loss term by step 3 (NVIDIA H100 80GB
    HBM3)). K5 13, K6 8 and one rule book a step, read per step. Times the
    steady step of both and the busy share of a sharded bf16 step."""
    from d3d_tpu_torch.models import head_config, make_anchors, presets
    from d3d_tpu_torch.models.second import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    total, stats, timing = {}, {}, {}
    with deterministic_algorithms():
        for dtype in ("float32", "bfloat16"):
            cfg = presets.second_kitti(dtype=dtype)

            def build(cfg=cfg):
                model = train_model(cfg, state, dev)
                opt, _ = make_optimizer(model.parameters(),
                                        total_steps=PAR_STEPS)
                return model, make_train_step(
                    model, opt, cfg, make_anchors(head_config(cfg),
                                                  device=dev),
                    riou_weight=RIOU_WEIGHT)
            counts, stats[dtype], timing[dtype] = sharded_vs_plain(
                f"SECOND {dtype}", dev, mesh, build, batch,
                want_counts(subm_conv=13, subm_conv_dw=8,
                            subm_conv_rulebook=1, build_stage_maps=1))
            add_counts(total, counts)
    # the steady steps as the paths run them (no deterministic mode), in
    # turns plain, sharded, sharded, plain
    for dtype, runs in timing.items():
        ms = {"plain": [], "sharded": []}
        for name in ("plain", "sharded", "sharded", "plain"):
            ms[name].append(median_ms(lambda: runs[name](batch), reps=5,
                                      warmup=1))
        stats[dtype].update(sharded_steady_ms=statistics.median(
            ms["sharded"]), plain_steady_ms=statistics.median(ms["plain"]),
            turns_ms=ms)
        log(f"parallel SECOND {dtype} steady step (median of 5 a turn, "
            f"turns P S S P): sharded {ms['sharded']} ms, plain "
            f"{ms['plain']} ms")
    run = timing["bfloat16"]["sharded"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats["busy_share_bf16"] = busy_share(prof, wall)
    log(f"parallel SECOND bf16 sharded step: busy share "
        f"{stats['busy_share_bf16']} over {wall * 1e3:.1f} ms "
        "(torch.profiler)")
    return total, stats


def sharded_vs_plain(name, dev, mesh, build, batch, want):
    """``build()`` -> (model, step) three times from the same weights: the
    plain step, the step through shard_train_step on the one-rank mesh
    and the plain step again, PAR_STEPS steps each with counts read per
    step (``want``). The sharded steps' losses and updated state equal
    the plain ones bit for bit where the two plain runs are bit-equal;
    otherwise within the SECOND check's limits (the larger of 1e-6 / 1e-5
    and twice the plain runs' gap). Returns (summed sharded counts,
    stats, {"plain": step, "sharded": step} for timing)."""
    from d3d_tpu_torch.parallel import shard_train_step

    runs, total = {}, {}
    for run_name in ("plain", "sharded", "plain_again"):
        model, step = build()
        run = (shard_train_step(step, mesh) if run_name == "sharded"
               else step)
        losses, ms, grads = [], [], None
        for i in range(PAR_STEPS):
            reset_counts()
            aux, t, _ = timed(lambda: run(batch))
            c = read_counts()
            check(c == want, f"parallel {name} {run_name} step {i + 1}: "
                             f"launches {c}, want {want}")
            if run_name == "sharded":
                add_counts(total, c)
            losses.append({k: float(v) for k, v in aux.items()})
            check(all(math.isfinite(v) for v in losses[-1].values()),
                  f"parallel {name} {run_name}: loss {losses[-1]}")
            ms.append(t)
            if i == 0:
                grads = {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}
        runs[run_name] = dict(losses=losses, ms=ms, grads=grads, run=run,
                              state={k: v.detach().clone() for k, v in
                                     model.state_dict().items()})
    plain, sharded, again = (runs[k] for k in ("plain", "sharded",
                                               "plain_again"))

    def same(a, b):
        return a["losses"] == b["losses"] and all(
            torch.equal(a["state"][k], b["state"][k]) for k in b["state"])
    plain_exact, exact = same(again, plain), same(sharded, plain)
    if plain_exact:
        check(exact, f"parallel {name}: the sharded steps are not bit-equal "
                     "to the plain ones, which two plain runs are")
    noise = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for a, b in zip(again["losses"], plain["losses"]) for k in b)
    for i, (a, b) in enumerate(zip(sharded["losses"], plain["losses"])):
        for k in b:
            check(abs(a[k] - b[k]) <= max(1e-6, 2 * noise) * abs(b[k])
                  + 1e-7, f"parallel {name} step {i + 1} {k}: {a[k]} vs "
                  f"the plain step's {b[k]} (two plain runs {noise:.3g} "
                  "apart)")
    param_noise = max_param_diff(again["state"], plain["state"],
                                 plain["grads"])
    diff = max_param_diff(sharded["state"], plain["state"], plain["grads"])
    check(diff <= max(1e-5, 2 * param_noise),
          f"parallel {name}: parameters {diff} from the plain step's (two "
          f"plain runs {param_noise:.3g} apart)")
    log(f"parallel {name}: {PAR_STEPS} sharded steps "
        + ("bit-equal to the plain ones" if exact else
           f"equal to the plain ones within {diff:.3g} (two plain runs "
           f"{noise:.3g} / {param_noise:.3g} apart)")
        + "; losses " + ", ".join(f"{l['total']:.4f}"
                                  for l in sharded["losses"])
        + "; step " + ", ".join(f"{m:.2f}" for m in sharded["ms"])
        + " ms sharded, " + ", ".join(f"{m:.2f}" for m in plain["ms"])
        + " ms plain (CUDA events, deterministic mode)")
    return total, dict(bit_equal=exact, plain_runs_bit_equal=plain_exact,
                       max_param_diff=diff, plain_runs_loss_gap=noise,
                       plain_runs_param_gap=param_noise,
                       losses=[l["total"] for l in sharded["losses"]],
                       sharded_ms=sharded["ms"], plain_ms=plain["ms"],
                       plain_again_ms=again["ms"]), dict(
        plain=plain["run"], sharded=sharded["run"])


def parallel_families(dev, mesh, vn, bev_frames):
    """shard_train_step of CenterPoint (the 10-sweep preset, one block a
    backbone stage, on VoxelNeXt's keyframes 0 and 3), BEVSeg (the
    panoptic semantickitti preset, one block an encoder stage, on the
    KITTI-360 frames) and VoxelNeXt (voxelnext_nuscenes at full width, its
    training batch) in f32 (TF32 off) on the one-rank mesh against each
    family's plain step from the same weights (``sharded_vs_plain``),
    under ``deterministic_algorithms``. CenterPoint and BEVSeg launch no
    kernel of the
    port's; VoxelNeXt K5 18, K6 11 and one rule book a step."""
    import dataclasses

    from d3d_tpu_torch.models import BEVSeg, CenterPoint, VoxelNeXt, presets
    from d3d_tpu_torch.models import bevseg, centerpoint, voxelnext
    from d3d_tpu_torch.train import make_optimizer

    cp_cfg = cp_preset(dtype="float32")
    cp_cfg = dataclasses.replace(
        cp_cfg, backbone_blocks=(1,) * len(cp_cfg.backbone_blocks))
    bev_cfg = pano_preset(dtype="float32")
    bev_cfg = dataclasses.replace(
        bev_cfg, enc_blocks=(1,) * len(bev_cfg.enc_blocks))
    vn_cfg = presets.voxelnext_nuscenes(dtype="float32")
    cp_state = CenterPoint(cp_cfg, point_features=5, device=dev,
                           generator=torch.Generator().manual_seed(21)
                           ).state_dict()
    bev_state = BEVSeg(bev_cfg, device=dev,
                       generator=torch.Generator().manual_seed(22)
                       ).state_dict()
    families = {
        "CenterPoint": (lambda: CenterPoint(cp_cfg, point_features=5,
                                            device=dev), cp_state,
                        centerpoint.make_train_step, cp_cfg,
                        cp_batch(dev, cp_cfg, vn["scene"], vn["clouds"]),
                        want_counts()),
        "BEVSeg": (lambda: BEVSeg(bev_cfg, device=dev), bev_state,
                   bevseg.make_train_step, bev_cfg,
                   bevseg_batch(dev, bev_frames), want_counts()),
        "VoxelNeXt": (lambda: VoxelNeXt(vn_cfg, point_features=5,
                                        device=dev),
                      vn["model32"].state_dict(), voxelnext.make_train_step,
                      vn_cfg, vn["batch"],
                      want_counts(subm_conv=18, subm_conv_dw=11,
                                  subm_conv_rulebook=1,
                                  build_stage_maps=1))}
    total, stats = {}, {}
    with deterministic_algorithms():
        for name, (make, state, make_step, cfg, batch, want) in \
                families.items():
            def build(make=make, state=state, make_step=make_step,
                      cfg=cfg):
                model = make()
                model.load_state_dict(state)
                opt, _ = make_optimizer(model.parameters(),
                                        total_steps=PAR_STEPS)
                return model, make_step(model, opt, cfg)
            counts, stats[name], _ = sharded_vs_plain(
                name, dev, mesh, build, batch, want)
            add_counts(total, counts)
    return total, stats


def parallel_spatial(dev, mesh):
    """PointPillars (pointpillars_kitti, bf16) with spatial_constrain on
    the one-rank mesh through shard_train_step against the plain step:
    PAR_STEPS steps from the same weights on 2 bench frames. The slab path
    (the halo convolution's explicit padding, the heads' gather) may pick
    other cuDNN algorithms than the plain path, so the losses are held to
    the bf16 bound of the network (bf16_bound(16, 9 x 256), relative) and
    the parameters to twice the sum of the Adam steps' largest update
    (lr * (1 - b1) / sqrt(1 - b2) each): the two runs agree at least as
    closely as two steps of rounding noise could make them. The
    BatchNorm running statistics' gap is reported, relative to each
    statistic's largest entry."""
    from d3d_tpu_torch.models import (PointPillars, make_anchors,
                                      pillarize, presets)
    from d3d_tpu_torch.models.pointpillars import make_train_step
    from d3d_tpu_torch.parallel import shard_train_step, spatial_constrain
    from d3d_tpu_torch.train import make_optimizer

    cfg = presets.pointpillars_kitti()
    frames = [bench_points(np.random.default_rng(100 + i)) for i in range(2)]
    with torch.inference_mode():
        pil = [pillarize(torch.from_numpy(p).to(dev), cfg) for p in frames]
    batch = {k: torch.stack([v[i] for v in pil]).clone()
             for i, k in enumerate(("features", "coords", "valid"))}
    batch.update(car_gt(dev, 2))
    ref = PointPillars(cfg, device=dev,
                       generator=torch.Generator().manual_seed(0))
    calibrate_heads(ref, frames[0], dev)
    runs, counts, total = {}, {}, {}
    for name in ("plain", "spatial"):
        hook = spatial_constrain(mesh) if name == "spatial" else None
        model = PointPillars(cfg, device=dev, constrain=hook)
        model.load_state_dict(ref.state_dict())
        opt, lr = make_optimizer(model.parameters(), total_steps=PAR_STEPS)
        step = make_train_step(model, opt, cfg, make_anchors(cfg,
                                                             device=dev))
        run = step if hook is None else shard_train_step(step, mesh)
        losses, ms = [], []
        for i in range(PAR_STEPS):
            reset_counts()
            aux, t, _ = timed(lambda: run(batch))
            c = read_counts()
            counts[name] = c if i == 0 else counts[name]
            check(c == counts[name], f"parallel spatial {name}: launches "
                                     f"{c} then {counts[name]}")
            if hook is not None:
                add_counts(total, c)
            losses.append(float(aux["total"]))
            ms.append(t)
        runs[name] = dict(losses=losses, ms=ms, state=model.state_dict(),
                          hook=hook)
    check(counts["spatial"] == counts["plain"],
          f"parallel spatial: launches {counts}")
    bound = bf16_bound(16, 9 * 256)
    for i, (a, b) in enumerate(zip(runs["spatial"]["losses"],
                                   runs["plain"]["losses"])):
        check(math.isfinite(a) and abs(a - b) <= bound * abs(b),
              f"parallel spatial step {i + 1}: loss {a} vs {b}")
    step_bound = 2 * sum(lr(i) for i in range(PAR_STEPS)) \
        * (1 - 0.9) / math.sqrt(1 - 0.999)
    names = {n for n, _ in model.named_parameters()}
    diff = max_param_diff(runs["spatial"]["state"], runs["plain"]["state"],
                          names=names)
    check(diff <= step_bound, f"parallel spatial: parameters {diff} apart, "
                              f"bound {step_bound}")
    stat_diff = max(
        float((runs["spatial"]["state"][k] - w).abs().max()
              / w.abs().max().clamp_min(1e-30))
        for k, w in runs["plain"]["state"].items()
        if k.endswith(("running_mean", "running_var")))
    hook = runs["spatial"]["hook"]
    check(hook.counts["gather"] == 3 * PAR_STEPS,
          f"parallel spatial: gathers {hook.counts}")
    log(f"parallel spatial: PointPillars bf16 on the one-rank sp hook, "
        f"losses {runs['spatial']['losses']} against "
        f"{runs['plain']['losses']}; parameters {diff:.3g} apart (bound "
        f"{step_bound:.3g}), running statistics {stat_diff:.3g} relative; "
        f"steps {runs['spatial']['ms']} ms against {runs['plain']['ms']} "
        "ms")
    return total, dict(
        losses=runs["spatial"]["losses"],
        plain_losses=runs["plain"]["losses"], max_param_diff=diff,
        running_stat_rel_diff=stat_diff,
        step_ms=runs["spatial"]["ms"], plain_step_ms=runs["plain"]["ms"],
        hook_counts=dict(hook.counts))


def parallel_pipeline(dev, pp_mesh, ep_mesh):
    """pipeline_sst_trunk on sst_kitti uncut, M = 2 microbatches of one
    bench frame each, against SST(stage="trunk") on the 2 frames: f32
    (TF32 off) within atol 2e-5, and bf16 on two seeds' weights, held to
    bf16_bound(5 depth, C mlp_ratio) of the trunk's largest output (the
    measured errors are returned); moe_mlp(mesh=) at ep = 1 equal to the
    dense call at sst_kitti(moe_experts=8)'s width (atol 1e-5, aux rtol
    1e-6)."""
    from d3d_tpu_torch.models import SST
    from d3d_tpu_torch.models.sst import pipeline_sst_trunk
    from d3d_tpu_torch.parallel import (init_moe_params, microbatch, moe_mlp,
                                        unmicrobatch)

    frames = [bench_points(np.random.default_rng(100 + i)) for i in range(2)]
    stats, counts = {}, {}
    reset_counts()
    for dtype, seeds in (("float32", (14,)), ("bfloat16", (14, 15))):
        cfg = sst_preset(dtype=dtype)
        batch = sst_batch(dev, cfg, frames)
        args = (batch["features"], batch["coords"], batch["valid"])
        errs = []
        for seed in seeds:
            gen = torch.Generator().manual_seed(seed)
            model = SST(cfg, device=dev, generator=gen)
            embed = SST(cfg, stage="embed", device=dev)
            trunk = SST(cfg, stage="trunk", device=dev)
            for m in (embed, trunk):
                m.load_state_dict(model.state_dict())
            with torch.inference_mode():
                pf0 = embed(*args)
                want = trunk(*args)
                got, ms, _ = timed(lambda: unmicrobatch(pipeline_sst_trunk(
                    model, cfg, pp_mesh, microbatch(pf0, 2),
                    microbatch(args[1], 2), microbatch(args[2], 2))))
                _, trunk_ms, _ = timed(lambda: trunk(*args))
            err = float((got.float() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            errs.append(dict(seed=seed, max_abs_err=err, scale=scale,
                             pipeline_ms=ms, trunk_ms=trunk_ms))
            if dtype == "float32":
                check(err <= 2e-5, f"pipelined SST trunk f32: {err}")
            else:
                bound = bf16_bound(cfg.depth * 5,
                                   cfg.pfn_features * cfg.mlp_ratio)
                check(err <= bound * scale,
                      f"pipelined SST trunk bf16 seed {seed}: {err}, "
                      f"bound {bound * scale}")
            del model, embed, trunk
        stats[f"trunk_{dtype}"] = errs
        log(f"parallel pipeline: SST trunk {dtype} pipelined (pp = 1, "
            f"M = 2) against stage='trunk': {errs}")
    cfg = sst_preset(moe_experts=SST_MOE_EXPERTS, dtype="float32")
    c = cfg.pfn_features
    params = init_moe_params(torch.Generator().manual_seed(16),
                             SST_MOE_EXPERTS, c, cfg.mlp_ratio * c,
                             device=dev)
    x = torch.randn((2, cfg.max_pillars, c),
                    generator=torch.Generator().manual_seed(17)).to(dev)
    with torch.inference_mode():
        y0, a0 = moe_mlp(params, x, cfg.moe_capacity,
                         group_size=cfg.moe_group)
        y1, a1 = moe_mlp(params, x, cfg.moe_capacity, mesh=ep_mesh,
                         group_size=cfg.moe_group)
    moe_err = float((y1 - y0).abs().max())
    check(moe_err <= 1e-5 and abs(float(a1) - float(a0))
          <= 1e-6 * abs(float(a0)),
          f"moe_mlp(mesh=) at ep = 1: {moe_err}, aux {float(a1)} vs "
          f"{float(a0)}")
    stats["moe_ep1_max_abs_err"] = moe_err
    add_counts(counts, read_counts())
    check(counts == want_counts(), f"parallel pipeline: launches {counts}")
    log(f"parallel pipeline: moe_mlp(mesh=) at ep = 1 within {moe_err:.3g} "
        f"of the dense call ({SST_MOE_EXPERTS} experts, C = {c})")
    return counts, stats


def nccl_all_reduce_ms(dev, numel):
    """One NCCL all_reduce of ``numel`` float32 (a SECOND step's gradient
    bytes) on the world's group: median of 10 by CUDA events."""
    import torch.distributed as dist

    buf = torch.ones(numel, device=dev)
    return median_ms(lambda: dist.all_reduce(buf))


def parallel_phase(dev, pp_detect, frames, state, batch, bev_frames,
                   vn):
    """The parallel path: a world of one under NCCL through the port's
    ``initialize`` (a FileStore under build/), the meshes of every axis
    on cuda, and the scale-out layer's serving, evaluation, training,
    pipeline and expert paths on it. Returns ({path: counts}, stats)."""
    import shutil

    import torch.distributed as dist

    from d3d_tpu_torch import parallel as par
    from d3d_tpu_torch.models import presets
    from d3d_tpu_torch.parallel.mesh import Mesh

    t0 = time.perf_counter()
    store = ROOT / "build" / "parallel"
    shutil.rmtree(store, ignore_errors=True)
    store.mkdir(parents=True)
    check(par.initialize("file://" + str(store / "store"), 1, 0),
          "parallel: initialize did not start the process group")
    try:
        check(dist.get_backend() is not None and par.process_count() == 1,
              "parallel: the world is not one rank")
        mesh = par.make_mesh(1)
        check(mesh.shape == {"dp": 1, "sp": 1, "tp": 1},
              f"parallel: make_mesh(1) {mesh.shape}")
        check(par.make_global_mesh().shape == {"dp": 1, "tp": 1},
              "parallel: make_global_mesh")
        pp_mesh = par.make_pp_mesh(1)
        ep_mesh = Mesh("cuda", torch.zeros((1, 1), dtype=torch.int64),
                       mesh_dim_names=("dp", "ep"))
        counts, stats = {}, {}
        counts["parallel_serving"], stats["serving"] = parallel_serving(
            dev, mesh, pp_detect, frames)
        counts["parallel_eval"], stats["eval"] = parallel_eval(
            dev, mesh, bev_frames)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        counts["parallel_train"], stats["train"] = parallel_training(
            dev, mesh, state, batch)
        counts["parallel_spatial"], stats["spatial"] = parallel_spatial(
            dev, mesh)
        counts["parallel_families"], stats["families"] = parallel_families(
            dev, mesh, vn, bev_frames)
        counts["parallel_pipeline"], stats["pipeline"] = parallel_pipeline(
            dev, pp_mesh, ep_mesh)
        numel = sum(p.numel() for p in train_model(
            presets.second_kitti(), state, dev).parameters())
        stats["nccl_all_reduce_ms"] = nccl_all_reduce_ms(dev, numel)
        stats["grad_bytes"] = 4 * numel
        log(f"parallel: NCCL all_reduce of SECOND's {4 * numel} gradient "
            f"bytes {stats['nccl_all_reduce_ms']:.4f} ms (world of one, "
            "CUDA events, median of 10)")
    finally:
        dist.destroy_process_group()
    stats["phase_s"] = time.perf_counter() - t0
    log(f"parallel: {stats['phase_s']:.1f} s")
    return counts, stats


# ---------------------------------------------------------------------------
# datasets: the sequence loaders, from files on disk to scores
# ---------------------------------------------------------------------------

DS_POINTS = 120_000           # a KITTI HDL-64E sweep
DS_TRACK_FRAMES = 40          # frames a KITTI tracking sequence
DS_SEQ_FRAMES = 20            # odometry, Waymo and raw frames
DS_CADC_FRAMES = 10
DS_CADC_POINTS = 60_000
DS_WAYMO_POINTS = 150_000     # Waymo's top lidar
DS_DT = 0.1                   # the lidars at 10 Hz
DS_KITTI_IMAGE = (1242, 375)
DS_LIDAR_Z = -1.73            # the KITTI ground below the velodyne
DS_CLASSES = ("Car", "Pedestrian", "Cyclist")
# the tracker's centre-distance gates (m), a few frames' motion of each
# class at 10 Hz and below the lanes' spacing
DS_GATES = (2.0, 0.5, 1.0)
DS_SIZES = {"Car": (3.9, 1.6, 1.56), "Pedestrian": (0.8, 0.6, 1.73),
            "Cyclist": (1.76, 0.6, 1.73)}
# the tracking scene: (class, lane y (m), x at frame 0 (m), speed along x
# (m/s)); lanes 1.5 m or more apart, every object ahead of the camera
# over the 4 s of a sequence; the second sequence mirrors y
DS_OBJECTS = (("Car", -6.0, 20.0, 6.0), ("Car", -3.0, 55.0, -6.0),
              ("Car", 0.0, 15.0, 6.0), ("Car", 0.0, 35.0, 6.0),
              ("Car", 3.0, 50.0, -6.0), ("Car", 6.0, 25.0, 6.0),
              ("Pedestrian", -9.0, 30.0, 1.2),
              ("Pedestrian", 9.0, 32.0, -1.2),
              ("Pedestrian", -10.5, 40.0, 1.0),
              ("Cyclist", -7.5, 45.0, -4.0), ("Cyclist", 7.5, 22.0, 4.0),
              ("Cyclist", 10.5, 38.0, 3.0))
DS_TRACK_ROWS = 32            # the ground truth's padded rows a frame
DS_EVAL_OVERLAP = 0.5
DS_NATIVE_BOXES = 4096
DS_NATIVE_THRESHOLD = 0.25
# the devkit's calibration of a tracking sequence (velo -> camera of the
# KITTI rig, rectification identity)
DS_TRACKING_CALIB = (
    "P0: 7.215e+02 0.0 6.095e+02 0.0 0.0 7.215e+02 1.728e+02 0.0 0.0 0.0 "
    "1.0 0.0\n"
    "P1: 7.215e+02 0.0 6.095e+02 -40.0 0.0 7.215e+02 1.728e+02 0.0 0.0 "
    "0.0 1.0 0.0\n"
    "P2: 7.215e+02 0.0 6.095e+02 -80.0 0.0 7.215e+02 1.728e+02 0.0 0.0 "
    "0.0 1.0 0.0\n"
    "P3: 7.215e+02 0.0 6.095e+02 -120.0 0.0 7.215e+02 1.728e+02 0.0 0.0 "
    "0.0 1.0 0.0\n"
    "R_rect: 1.0 0.0 0.0 0.0 1.0 0.0 0.0 0.0 1.0\n"
    "Tr_velo_cam: 0.0 -1.0 0.0 0.0 0.0 0.0 -1.0 -0.08 1.0 0.0 0.0 -0.27\n"
    "Tr_imu_velo: 1.0 0.0 0.0 0.8 0.0 1.0 0.0 -0.3 0.0 0.0 1.0 0.9\n")
DS_VELO_TO_CAM = np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, -0.08],
                           [1.0, 0.0, 0.0, -0.27]])
# an oxts packet: lat, lon, alt, roll, pitch, yaw, 19 rates and
# accuracies, then 5 integer status fields
DS_OXTS_TAIL = ("1.0 2.0 2.2 0.1 0.0 0.1 0.2 9.8 0.1 0.2 9.8 0.01 0.02 "
                "0.03 0.01 0.02 0.03 0.5 0.1 4 11 6 6 6")


def ds_png(size, value=90):
    """One stand-in camera image's PNG bytes (the loaders read its size)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", size, (value,) * 3).save(buf, format="PNG")
    return buf.getvalue()


class DsWriter:
    """Writes a dataset's files under ``root``, or into zip archives
    (``ZIP_STORED``) named by the first matching prefix of ``archives``
    (``{arcname prefix: zip path relative to root}``)."""

    def __init__(self, root, archives=None):
        import zipfile

        self.root = Path(root)
        self.archives = archives or {}
        self.zips = {}
        self._zipfile = zipfile

    def write(self, name, data):
        if isinstance(data, str):
            data = data.encode()
        for prefix, zname in self.archives.items():
            if name.startswith(prefix):
                if zname not in self.zips:
                    path = self.root / zname
                    path.parent.mkdir(parents=True, exist_ok=True)
                    self.zips[zname] = self._zipfile.ZipFile(
                        path, "w", self._zipfile.ZIP_STORED)
                self.zips[zname].writestr(name, data)
                return
        path = self.root / name
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(data)

    def close(self):
        for z in self.zips.values():
            z.close()


def ds_cloud(rng, n, boxes=(), per_box=200, half=(0.0, 70.0, -40.0, 40.0),
             z=(-2.0, 1.5), cols=4):
    """``n`` points spread over the field plus ``per_box`` inside each
    box (x, y, z, l, w, h, yaw), float32 with ``cols`` columns."""
    parts = [np.stack([rng.uniform(half[0], half[1], n),
                       rng.uniform(half[2], half[3], n),
                       rng.uniform(z[0], z[1], n)], axis=1)]
    for b in boxes:
        local = (rng.random((per_box, 3)) - 0.5) * b[3:6] * 0.9
        c, s = np.cos(b[6]), np.sin(b[6])
        parts.append(np.stack([b[0] + c * local[:, 0] - s * local[:, 1],
                               b[1] + s * local[:, 0] + c * local[:, 1],
                               b[2] + local[:, 2]], axis=1))
    xyz = np.concatenate(parts)
    extra = rng.random((len(xyz), cols - 3))
    return np.concatenate([xyz, extra], axis=1).astype(np.float32)


def ds_track_boxes(f, mirror=False):
    """The tracking scene's boxes at frame ``f`` (velo frame): (classes,
    tids, (M, 7) float64 x, y, z, l, w, h, yaw)."""
    rows = []
    for cls, y, x0, v in DS_OBJECTS:
        l, w, h = DS_SIZES[cls]
        rows.append((x0 + v * f * DS_DT, -y if mirror else y,
                     DS_LIDAR_Z + h / 2, l, w, h, 0.0 if v > 0 else np.pi))
    return ([c for c, *_ in DS_OBJECTS], list(range(1, len(rows) + 1)),
            np.asarray(rows))


def ds_label_line(f, tid, cls, box):
    """One KITTI tracking label row of a velo-frame box: the camera frame
    through the sequence's Tr_velo_cam (rectification identity), the
    bottom centre, rotation_y = -yaw - pi/2, the 2D box of the centre's
    projection, values printed %.2f as the devkit's files are."""
    x, y, z, l, w, h, yaw = box
    cam = DS_VELO_TO_CAM[:, :3] @ np.array([x, y, z]) + DS_VELO_TO_CAM[:, 3]
    ry = (-yaw - np.pi / 2 + np.pi) % (2 * np.pi) - np.pi
    u = 721.5 * cam[0] / cam[2] + 609.5 - 80.0 / cam[2]
    v = 721.5 * cam[1] / cam[2] + 172.8
    half = 721.5 * max(l, w) / cam[2] / 2
    return ("%d %d %s 0 0 0.00 %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f "
            "%.2f %.2f" % (f, tid, cls, u - half, v - half, u + half,
                           v + half, h, w, l, cam[0], cam[1] + h / 2,
                           cam[2], ry))


def write_tracking_sequence(root, seq, zipped, seed):
    """A KITTI tracking sequence of DS_TRACK_FRAMES frames: ~120 000
    velodyne points a frame (the field plus 200 in each object), 1242 x
    375 images, the objects of DS_OBJECTS (mirrored for odd sequences)
    and one or two DontCare regions a frame, one oxts packet a frame
    (the ego at 5 m/s north), the devkit's calibration; zipped into the
    data_tracking_*.zip archives or as files. Returns the written clouds
    and each frame's boxes."""
    rng = np.random.default_rng(seed)
    archives = ({f"training/{sub}/": f"data_tracking_{z}.zip" for sub, z in (
        ("calib", "calib"), ("label_02", "label_2"), ("oxts", "oxts"),
        ("velodyne", "velodyne"), ("image_02", "image_2"))}
        if zipped else {})
    out = DsWriter(root, archives)
    png = ds_png(DS_KITTI_IMAGE)
    clouds, boxes, labels, oxts = [], [], [], []
    for f in range(DS_TRACK_FRAMES):
        classes, tids, b = ds_track_boxes(f, mirror=seq % 2 == 1)
        cloud = ds_cloud(rng, DS_POINTS, b)
        clouds.append(cloud)
        boxes.append((classes, tids, b))
        out.write("training/velodyne/%04d/%06d.bin" % (seq, f),
                  cloud.tobytes())
        out.write("training/image_02/%04d/%06d.png" % (seq, f), png)
        labels += [ds_label_line(f, t, c, bx)
                   for c, t, bx in zip(classes, tids, b)]
        for _ in range(1 + f % 2):
            u, v = rng.uniform(100, 1100), rng.uniform(150, 300)
            labels.append("%d -1 DontCare -1 -1 -10.00 %.2f %.2f %.2f %.2f "
                          "-1.00 -1.00 -1.00 -1000.00 -1000.00 -1000.00 "
                          "-10.00" % (f, u, v, u + 40, v + 30))
        oxts.append("%.10f 8.4228601000 112.80 0.03 0.01 0.50 %s"
                    % (49.011212 + 5.0 * f * DS_DT / 111_319.0,
                       DS_OXTS_TAIL))
    out.write("training/label_02/%04d.txt" % seq, "\n".join(labels) + "\n")
    out.write("training/oxts/%04d.txt" % seq, "\n".join(oxts) + "\n")
    out.write("training/calib/%04d.txt" % seq, DS_TRACKING_CALIB)
    out.close()
    return clouds, boxes


def ds_loader_ms(loader, indices, fetch):
    """Host ms a frame of ``fetch(loader, idx)`` over ``indices`` (the
    files read from disk or zip, parsed)."""
    t0 = time.perf_counter()
    out = [fetch(loader, idx) for idx in indices]
    return out, (time.perf_counter() - t0) * 1e3 / len(indices)


def ds_same_boxes(name, arr, classes, b, pos_tol=0.006, dim_tol=0.006,
                  yaw_tol=0.006):
    """A loaded or dumped Target3DArray holds the boxes ``b`` of
    ``classes`` within the %.2f format (matched by position: each box's
    nearest); returns the largest position error."""
    check(len(arr) == len(b), f"{name}: {len(arr)} boxes, want {len(b)}")
    if not len(b):
        return 0.0
    c = arr.columns()
    worst = 0.0
    for cls, box in zip(classes, b):
        d = np.linalg.norm(c["position"] - box[:3], axis=1)
        i = int(np.argmin(d))
        dyaw = (c["yaw"][i] - box[6] + np.pi) % (2 * np.pi) - np.pi
        check(d[i] <= pos_tol * 2 and np.abs(c["dimension"][i] - box[3:6])
              .max() <= dim_tol and abs(dyaw) <= yaw_tol
              and arr[i].tag_top.name == cls,
              f"{name}: box {box} came back as {c['position'][i]}, "
              f"{c['dimension'][i]}, {c['yaw'][i]}, {arr[i].tag_top.name}")
        worst = max(worst, float(d[i]))
    return worst


def ds_parse_dump(path, raw_calib, frames):
    """A KITTI tracking dump read back through the loader's own
    ``parse_label``: {frame: Target3DArray}."""
    from d3d_tpu_torch.abstraction import Target3DArray
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass
    from d3d_tpu_torch.dataset.kitti.tracking import parse_label

    rows = {}
    for line in Path(path).read_text().splitlines():
        if line.strip():
            fields = line.split(" ")
            rows.setdefault(int(fields[0]), []).append(
                [int(fields[1]), KittiObjectClass[fields[2]]]
                + [float(v) for v in fields[3:]])
    return {f: (parse_label(rows[f], raw_calib) if f in rows
                else Target3DArray(frame="velo")) for f in range(frames)}


def ds_gt_rows(arr, classes):
    """A frame's ground truth as the device tracker's padded detections:
    boxes (x, y, z, l, w, h, yaw), scores 1, class indices, zero
    velocities, the valid mask (numpy)."""
    n = len(arr)
    check(n <= DS_TRACK_ROWS, f"{n} ground-truth boxes in a frame")
    boxes = np.zeros((DS_TRACK_ROWS, 7), np.float32)
    boxes[:, 3:6] = 1.0
    labels = np.zeros(DS_TRACK_ROWS, np.int32)
    valid = np.zeros(DS_TRACK_ROWS, bool)
    if n:
        c = arr.columns()
        boxes[:n, :3], boxes[:n, 3:6] = c["position"], c["dimension"]
        boxes[:n, 6] = c["yaw"]
        names = [c_.name for c_ in classes]
        labels[:n] = [names.index(o.tag_top.name) for o in arr]
        valid[:n] = True
    return (boxes, valid.astype(np.float32), labels,
            np.zeros((DS_TRACK_ROWS, 3), np.float32), valid)


def ds_gt_through_tracker(dev, loader, seq, gts, classes, path):
    """The ground truth of every frame fed as detections through the
    device tracker (``tracker_update``, DS_GATES) on the card and on the
    CPU (ids, labels, masks and the next id exact, slot values within
    1e-5), reported, dumped by ``dump_tracking_output`` and read back by
    ``parse_label``: the tracks' boxes within %.2f of the ground truth
    and the sequence's MOTA 1 with no identity switch. Returns (stats,
    the card's ms a frame of the tracker)."""
    from d3d_tpu_torch.tracking.device_tracker import (tracker_init,
                                                       tracker_report,
                                                       tracker_update)

    gates = torch.tensor(DS_GATES, dtype=torch.float32)
    states = {d: tracker_init(TRACK_CAPACITY, d) for d in (dev, "cpu")}
    tracks, worst, ms = {}, 0.0, []
    for f, gt in enumerate(gts):
        fr = ds_gt_rows(gt, classes)
        for d in states:
            call = (lambda d=d: tracker_update(
                states[d], *fr, 0.0 if f == 0 else DS_DT, gates.to(d),
                TRACK_LOST_TIME))
            if d == dev:
                states[d], t, _ = timed(call)
                ms.append(t)
            else:
                states[d] = call()
        a = {k: t.cpu() for k, t in states[dev].items()}
        b = states["cpu"]
        for k in ("tid", "label", "active", "next_tid"):
            check(torch.equal(a[k], b[k]),
                  f"tracking GT frame {f}: {k} card vs CPU")
        for k in ("boxes", "vel", "score", "lost", "history"):
            err = float((a[k] - b[k]).abs().max())
            worst = max(worst, err)
            check(err <= 1e-5, f"tracking GT frame {f}: {k} {err}")
        rep = tracker_report(states[dev], classes, "velo")
        tracks[f] = rep
    loader.dump_tracking_output(seq, tracks, path)
    back = ds_parse_dump(path, loader.calibration_data((seq, 0), raw=True),
                         len(gts))
    pos = max(ds_same_boxes(f"tracking GT dump frame {f}", back[f],
                            [o.tag_top.name for o in gt], np.stack(
                                [np.r_[o.position, o.dimension, o.yaw]
                                 for o in gt]), pos_tol=0.011)
              for f, gt in enumerate(gts))
    ev = ds_tracking_evaluator(dev)
    ev.calc_stats_sequence(gts, [back[f] for f in range(len(gts))])
    mota = {c.name: float(ev.mota(0.0)[c]) for c in classes}
    ids = {c.name: int(ev.id_switches(0.0)[c]) for c in classes}
    check(all(v == 1.0 for v in mota.values())
          and not any(ids.values()),
          f"tracking GT through the tracker: MOTA {mota}, switches {ids}")
    return dict(mota=mota, id_switches=ids, card_vs_cpu=worst,
                dump_pos_err=pos, tracks=int(states["cpu"]["next_tid"]) - 1
                ), statistics.median(ms)


def ds_tracking_evaluator(dev):
    from d3d_tpu_torch.benchmarks import TrackingEvaluator
    from d3d_tpu_torch.dataset.kitti import KittiObjectClass

    return TrackingEvaluator([KittiObjectClass[c] for c in DS_CLASSES],
                             DS_EVAL_OVERLAP, device=dev)


def ds_detector(dev, frame):
    """make_pointpillars_detector on presets.pointpillars_kitti at full
    width (f32), seeded weights, heads calibrated on ``frame``."""
    from d3d_tpu_torch.models import (PointPillars, make_anchors,
                                      make_pointpillars_detector, presets)

    cfg = presets.pointpillars_kitti(dtype="float32")
    model = PointPillars(cfg, device=dev,
                         generator=torch.Generator().manual_seed(16))
    calibrate_heads(model, frame, dev)
    anchors = make_anchors(cfg, device=dev)
    detect = make_pointpillars_detector(model, None, cfg, anchors,
                                        car_classes(), device=dev)
    return dict(cfg=cfg, model=model, anchors=anchors, detect=detect)


def kitti_tracking_path(dev, root):
    """Two KITTI tracking sequences (one zipped) through the port's
    KittiTrackingLoader, PointPillars at full width and the device
    tracker (make_tracking_step), reported, dumped in the devkit's format
    and scored by TrackingEvaluator against the loader's labels; the
    ground truth through the tracker scores MOTA 1; one request held to
    the CPU; the unzipped sequence through io.hdf5 and back where h5py is
    installed (``ds_hdf5_round_trip``). Returns (counts, stats, the
    detector)."""
    from d3d_tpu_torch.dataset.kitti import (KittiObjectClass,
                                             KittiTrackingLoader)
    from d3d_tpu_torch.models import PointPillars
    from d3d_tpu_torch.tracking import make_tracking_step
    from d3d_tpu_torch.tracking.device_tracker import tracker_report

    t0 = time.perf_counter()
    written, loaders = {}, {}
    for seq, zipped in ((0, False), (1, True)):
        path = root / ("tracking_zip" if zipped else "tracking_dir")
        written[seq] = write_tracking_sequence(path, seq, zipped, 160 + seq)
        loaders[seq] = KittiTrackingLoader(path, inzip=zipped,
                                           phase="training",
                                           trainval_split=1)
    stats = dict(write_s=time.perf_counter() - t0, loader_ms={})
    classes = [KittiObjectClass[c] for c in DS_CLASSES]
    gts = {}
    for seq, ld in loaders.items():
        check(ld.sequence_sizes == {seq: DS_TRACK_FRAMES},
              f"tracking loader sizes {ld.sequence_sizes}")
        frames, ms = ds_loader_ms(ld, [(seq, f) for f in range(
            DS_TRACK_FRAMES)], lambda l, i: (
                l.lidar_data(i), l.annotation_3dobject(i), l.pose(i),
                l.calibration_data(i), l.timestamp(i)))
        stats["loader_ms"]["zip" if seq else "dir"] = ms
        clouds, boxes = written[seq]
        for f, (pts, ann, pose, _, _) in enumerate(frames):
            check(pts.dtype == np.float32
                  and pts.tobytes() == clouds[f].tobytes(),
                  f"tracking seq {seq} frame {f}: points differ from the "
                  "written file")
            ds_same_boxes(f"tracking seq {seq} frame {f} labels", ann,
                          boxes[f][0], boxes[f][2])
            check(np.isfinite(pose.position).all(), "tracking pose")
        gts[seq] = [a for _, a, _, _, _ in frames]
    log(f"kitti_tracking: 2 sequences x {DS_TRACK_FRAMES} frames of "
        f"~{DS_POINTS} points written in {stats['write_s']:.1f} s; loader "
        f"{stats['loader_ms']['dir']:.2f} ms a frame unzipped, "
        f"{stats['loader_ms']['zip']:.2f} ms zipped (points, labels, pose, "
        "calibration); points bit-equal, labels within %.2f")

    pp = ds_detector(dev, written[0][0][0])
    step = make_tracking_step(pp["detect"].device_fn, [DS_GATES[0]],
                              lost_time=TRACK_LOST_TIME,
                              capacity=TRACK_CAPACITY, score_threshold=0.3)
    reset_counts()
    frame_ms, tracks, kept = [], {0: {}, 1: {}}, []
    for seq, ld in loaders.items():
        state = step.init()
        for f in range(DS_TRACK_FRAMES):
            pts = ld.lidar_data((seq, f))
            (state, out), ms, _ = timed(
                lambda: step(state, pts, 0.0 if f == 0 else DS_DT))
            frame_ms.append(ms)
            kept.append(int(out[3].sum()))
            tracks[seq][f] = tracker_report(state, car_classes(), "velo")
    n = 2 * DS_TRACK_FRAMES
    counts = read_counts()
    check(counts == want_counts(rbox_iou_matrix=n, nms_scan=n),
          f"kitti_tracking requests: launches {counts}")
    check_nms_routes("kitti_tracking", n)
    # the request and the tracker apart, on the unzipped sequence
    from d3d_tpu_torch.tracking.device_tracker import tracker_update

    state = step.init()
    gate = torch.tensor([DS_GATES[0]], dtype=torch.float32, device=dev)
    det_ms, trk_ms, rows = [], [], []
    for f in range(DS_TRACK_FRAMES):
        pts = loaders[0].lidar_data((0, f))
        out, ms, _ = timed(lambda: pp["detect"].device_fn(pts))
        det_ms.append(ms)
        boxes, scores, labels, keep = out[:4]
        scores = scores.float()
        args = (boxes, scores, labels, boxes.new_zeros((len(boxes), 3)),
                keep & (scores >= 0.3), 0.0 if f == 0 else DS_DT, gate,
                TRACK_LOST_TIME)
        r0 = tracker_update.rows
        state, ms, _ = timed(lambda: tracker_update(state, *args))
        trk_ms.append(ms)
        rows.append(tracker_update.rows - r0)
    ev_ms, scores = [], {}
    for seq, ld in loaders.items():
        path = root / f"tracking_{seq:04d}.txt"
        ld.dump_tracking_output(seq, tracks[seq], path)
        back = ds_parse_dump(path, ld.calibration_data((seq, 0), raw=True),
                             DS_TRACK_FRAMES)
        ev = ds_tracking_evaluator(dev)
        _, ms, host = timed(lambda: ev.calc_stats_sequence(
            gts[seq], [back[f] for f in range(DS_TRACK_FRAMES)]))
        ev_ms.append(host / DS_TRACK_FRAMES)
        car = KittiObjectClass.Car
        scores[seq] = dict(mota_car=float(ev.mota(0.3)[car]),
                           tp_car=int(ev.tp(0.3)[car]),
                           fp_car=int(ev.fp(0.3)[car]))
    gt_stats, tracker_ms = {}, []
    for seq, ld in loaders.items():
        gt_stats[seq], t = ds_gt_through_tracker(
            dev, ld, seq, gts[seq], classes, root / f"gt_{seq:04d}.txt")
        tracker_ms.append(t)
    reset_counts()
    compare_with_cpu("kitti_tracking", pp["model"],
                     PointPillars(pp["cfg"], device="cpu"),
                     written[0][0][0], pp["detect"], pp["anchors"], dev)
    add_counts(counts, read_counts())
    h5_s = ds_hdf5_round_trip(loaders[0], root / "tracking.h5",
                              written[0][0])
    stats.update(frame_ms=statistics.median(frame_ms), kept=kept,
                 request_ms=statistics.median(det_ms),
                 tracker_ms=statistics.median(trk_ms), tracker_rows=rows,
                 gt_tracker_ms=statistics.median(tracker_ms),
                 evaluator_ms=statistics.median(ev_ms), scores=scores,
                 gt_through_tracker=gt_stats, hdf5_s=h5_s)
    log(f"kitti_tracking: {n} frames (PointPillars f32 through "
        f"make_tracking_step) {stats['frame_ms']:.2f} ms a frame (CUDA "
        f"events, median), launches {counts}; apart, the request "
        f"{stats['request_ms']:.2f} ms and the tracker "
        f"{stats['tracker_ms']:.2f} ms a frame walking {rows} admitted "
        f"rows; the tracker on the 12 ground-truth rows "
        f"{stats['gt_tracker_ms']:.3f} ms a frame; TrackingEvaluator "
        f"{stats['evaluator_ms']:.2f} ms a frame (host clock); the random "
        f"detector's scores {scores}; ground truth through the tracker, "
        f"dumped and read back: {gt_stats}; io.hdf5 round trip: {h5_s}")
    return counts, stats, pp


def ds_hdf5_round_trip(loader, path, clouds):
    """``io.hdf5.dump_sequence_dataset`` of the loader's first sequence,
    read back equal to ``clouds``. Returns its seconds, or the reason it
    did not run: the module needs h5py, which a machine may lack (the
    H100 machine has none); tests/test_torch_io_vis.py holds it on the
    CPU then."""
    import importlib.util

    if importlib.util.find_spec("h5py") is None:
        log("io.hdf5 round trip not run: h5py is not installed here "
            "(tests/test_torch_io_vis.py holds io.hdf5 on the CPU)")
        return "not run: h5py is not installed"
    import h5py

    from d3d_tpu_torch.io.hdf5 import dump_sequence_dataset

    seq = loader.sequence_ids[0]
    t0 = time.perf_counter()
    dump_sequence_dataset(loader, path, sequences=[seq])
    seconds = time.perf_counter() - t0
    with h5py.File(path) as h5:
        for f, cloud in enumerate(clouds):
            check(np.array_equal(h5[f"dataset/{seq}/f{f}/velo"][()], cloud),
                  f"io.hdf5 frame {f} differs from the written points")
    return seconds


def write_odometry_sequence(root, frames, seed):
    """A SemanticKITTI sequence 00: ~120 000 points a frame in the
    classes road (raw 40), car (10, five instances), building (50) and
    vegetation (70), labels instance << 16 | class, 1226 x 370 images,
    the calibration, times and camera-frame poses (1 m a frame forward).
    Returns the clouds and raw labels."""
    rng = np.random.default_rng(seed)
    out = DsWriter(root)
    seq = Path("dataset", "sequences", "00")
    png = ds_png((1226, 370), 70)
    clouds, labels, poses = [], [], []
    for f in range(frames):
        n_road, n_car = DS_POINTS // 2, DS_POINTS // 10
        n_rest = DS_POINTS - n_road - n_car
        road = np.c_[rng.uniform(-45, 45, (n_road, 2)),
                     DS_LIDAR_Z + rng.normal(0, 0.02, n_road)]
        centres = rng.uniform(-30, 30, (5, 2))
        car = np.c_[np.repeat(centres, n_car // 5, axis=0)
                    + rng.uniform(-2, 2, (n_car, 2)),
                    rng.uniform(-1.7, -0.3, n_car)]
        rest = np.c_[rng.uniform(-45, 45, (n_rest, 2)),
                     rng.uniform(-1.5, 1.5, n_rest)]
        xyz = np.concatenate([road, car, rest])
        sem = np.concatenate([np.full(n_road, 40), np.full(n_car, 10),
                              np.where(rng.random(n_rest) < 0.5, 50, 70)])
        inst = np.concatenate([np.zeros(n_road), np.repeat(np.arange(
            1, 6), n_car // 5), np.zeros(n_rest)])
        cloud = np.c_[xyz, rng.random(len(xyz))].astype(np.float32)
        label = ((inst.astype(np.uint32) << np.uint32(16))
                 | sem.astype(np.uint32))
        clouds.append(cloud)
        labels.append(label)
        out.write(str(seq / "velodyne" / ("%06d.bin" % f)), cloud.tobytes())
        out.write(str(seq / "labels" / ("%06d.label" % f)),
                  label.astype("<u4").tobytes())
        out.write(str(seq / "image_2" / ("%06d.png" % f)), png)
        rt = np.hstack([np.eye(3), [[0.0], [0.0], [1.0 * f]]])
        poses.append(" ".join("%e" % v for v in rt.ravel()))
    calib = []
    for i in range(4):
        p = np.array([[718.86, 0.0, 607.19, -386.14 * (i % 2)],
                      [0.0, 718.86, 185.22, 0.0], [0.0, 0.0, 1.0, 0.0]])
        calib.append("P%d: " % i + " ".join("%.6e" % v for v in p.ravel()))
    calib.append("Tr: " + " ".join("%.6e" % v for v in
                                   DS_VELO_TO_CAM.ravel()))
    out.write(str(seq / "calib.txt"), "\n".join(calib) + "\n")
    out.write(str(seq / "times.txt"),
              "".join("%e\n" % (DS_DT * f) for f in range(frames)))
    out.write("dataset/poses/00.txt", "\n".join(poses) + "\n")
    out.close()
    return clouds, labels


def semantickitti_path(dev, root):
    """A SemanticKITTI sequence through KittiOdometryLoader (points
    bit-equal, the labels' raw ids and their learning map) into BEVSeg on
    presets.bevseg_semantickitti (uncut, bf16, seeded weights) and
    SegmentationEvaluator: the ground truth as predictions scores IoU 1
    exactly in every present class. Returns (counts, stats)."""
    from d3d_tpu_torch.benchmarks import SegmentationEvaluator
    from d3d_tpu_torch.dataset.kitti import KittiOdometryLoader
    from d3d_tpu_torch.models import BEVSeg, make_predictor

    t0 = time.perf_counter()
    clouds, raw = write_odometry_sequence(root / "odometry", DS_SEQ_FRAMES,
                                          170)
    write_s = time.perf_counter() - t0
    ld = KittiOdometryLoader(root / "odometry", inzip=False,
                             phase="training", trainval_split=1)
    check(ld.sequence_sizes == {0: DS_SEQ_FRAMES},
          f"odometry sizes {ld.sequence_sizes}")
    frames, loader_ms = ds_loader_ms(ld, range(DS_SEQ_FRAMES), lambda l, i: (
        l.lidar_data(i), l.annotation_3dpoints(i),
        l.annotation_3dpoints(i, convert_tag=False), l.pose(i)))
    learn = {40: 9, 10: 1, 50: 13, 70: 15}
    for f, (pts, seg, seg_raw, pose) in enumerate(frames):
        check(pts.tobytes() == clouds[f].tobytes(),
              f"odometry frame {f}: points differ from the written file")
        check(np.array_equal(seg_raw.semantic, raw[f] & 0xFFFF)
              and np.array_equal(seg.instance, raw[f] >> 16),
              f"odometry frame {f}: raw labels or instances differ")
        want = np.vectorize(learn.get)(raw[f] & 0xFFFF)
        check(np.array_equal(seg.semantic, want),
              f"odometry frame {f}: learning map")
        check(np.isfinite(pose.position).all(), f"odometry frame {f}: pose")
    cfg = bev_preset()
    model = BEVSeg(cfg, device=dev,
                   generator=torch.Generator().manual_seed(17))
    predict = make_predictor(model, cfg, device=dev)
    classes = list(range(1, cfg.num_classes))
    evs = {k: SegmentationEvaluator(classes, background=0)
           for k in ("gt", "model")}
    reset_counts()
    req_ms = []
    for pts, seg, _, _ in frames:
        pred, ms, _ = timed(lambda: predict(None, pts))
        req_ms.append(ms)
        pred = pred.cpu().numpy().astype(seg.semantic.dtype)
        check(pred.shape == seg.semantic.shape, "BEVSeg prediction shape")
        evs["model"].add_stats(evs["model"].calc_stats(seg.semantic, pred))
        evs["gt"].add_stats(evs["gt"].calc_stats(seg.semantic,
                                                 seg.semantic.copy()))
    counts = read_counts()
    check(counts == want_counts(), f"semantickitti: launches {counts}")
    ious = evs["gt"].iou()
    present = {k: v for k, v in ious.items() if not np.isnan(v)}
    check(len(present) == 4 and all(v == 1.0 for v in present.values()),
          f"semantickitti: ground truth as predictions, IoU {present}")
    model_iou = evs["model"].iou()
    stats = dict(write_s=write_s, loader_ms=loader_ms,
                 request_ms=statistics.median(req_ms),
                 gt_miou=float(np.mean(list(present.values()))),
                 model_miou=float(np.nanmean([model_iou[k] for k in
                                              present])))
    log(f"semantickitti: {DS_SEQ_FRAMES} frames of ~{DS_POINTS} points "
        f"(written in {write_s:.1f} s); KittiOdometryLoader "
        f"{loader_ms:.2f} ms a frame (points, both label forms, pose); "
        f"BEVSeg bf16 request {stats['request_ms']:.2f} ms (CUDA events, "
        f"median); ground truth as predictions mIoU "
        f"{stats['gt_miou']} over {len(present)} classes; the random "
        f"model's mIoU {stats['model_miou']:.4f}")
    return counts, stats


def ds_waymo_tid(i):
    import base64
    import struct

    return base64.urlsafe_b64encode(struct.pack("Q", 9100 + i)
                                    + b"seg0").decode()


def write_waymo_segment(root, frames, seed):
    """A converted Waymo segment (the converter's layout) of ``frames``
    frames: the top lidar at ~150 000 points (x, y, z, intensity,
    elongation) in its sensor frame, mounted at (1.43, 0, 2.18) in the
    vehicle frame; 24 objects (16 vehicles, 5 pedestrians, 3 cyclists)
    moving along x with 100 points in each; a 1920 x 1280 front camera
    (the loader's rotated FLU pinhole); poses 1 m a frame forward.
    Returns the vehicle-frame clouds and each frame's (labels, boxes)."""
    import json

    rng = np.random.default_rng(seed)
    seg = "9100000000_000_000_9100000000_000"
    out = DsWriter(root / "training" / seg)
    mount = np.array([1.43, 0.0, 2.18])
    lid = np.eye(4)
    lid[:3, 3] = mount
    cam = np.eye(4)
    cam[:3, 3] = [1.5, 0.0, 2.1]
    out.write("context/stats.json", json.dumps(dict(frame_count=frames,
                                                    context=seg)))
    out.write("context/calib_lidars.json",
              json.dumps({"top": dict(extrinsic=lid.ravel().tolist())}))
    out.write("context/calib_cams.json", json.dumps({"front": dict(
        intrinsic=[2055.5, 2055.5, 939.6, 641.0, 0.01, -0.005, 0.0002,
                   -0.0001, 0.0], extrinsic=cam.ravel().tolist(),
        width=1920, height=1280)}))
    kinds = [(1, (4.6, 2.0, 1.7), 8.0)] * 16 + [(2, (0.8, 0.8, 1.8),
                                                 1.2)] * 5 \
        + [(4, (1.8, 0.7, 1.7), 4.0)] * 3
    lanes = rng.permutation(np.arange(-36, 36, 3.0))[:len(kinds)]
    x0 = rng.uniform(-50, 30, len(kinds))
    jpg = None
    clouds, truth = [], []
    for f in range(frames):
        boxes = np.array([[x0[i] + v * f * DS_DT, lanes[i], 1.0 + s[2] / 2,
                           *s, 0.0] for i, (_, s, v) in enumerate(kinds)])
        cloud = ds_cloud(rng, DS_WAYMO_POINTS - 100 * len(kinds), boxes,
                         per_box=100, half=(-75.0, 75.0, -75.0, 75.0),
                         z=(0.0, 4.0), cols=5)
        clouds.append(cloud)
        sensor = cloud.copy()
        sensor[:, :3] -= mount.astype(np.float32)
        out.write("lidar_top/%04d.bin" % f, sensor.tobytes())
        if jpg is None:
            import io

            from PIL import Image

            buf = io.BytesIO()
            Image.new("RGB", (1920, 1280), (50,) * 3).save(buf, "JPEG")
            jpg = buf.getvalue()
        out.write("camera_front/%04d.jpg" % f, jpg)
        out.write("label_lidars/%04d.json" % f, json.dumps([dict(
            center=b[:3].tolist(), size=b[3:6].tolist(), heading=0.0,
            label=k, id=ds_waymo_tid(i), num_points=100)
            for i, ((k, _, _), b) in enumerate(zip(kinds, boxes))]))
        pose = np.eye(4)
        pose[0, 3] = 1.0 * f
        out.write("pose/%04d.bin" % f, pose.astype("<f8").tobytes())
        out.write("timestamp/%04d.txt" % f,
                  str(1_560_000_000_000_000 + 100_000 * f))
        truth.append(([k for k, _, _ in kinds], boxes))
    out.close()
    return clouds, truth


def waymo_preset(**kw):
    """presets.centerpoint_waymo on a 472 x 472 grid of its 0.32 m pillars
    (bounds +-75.52 m): the preset's 470 is not a multiple of the
    backbone's stride 8, so its three upsampled maps come out 470, 470
    and 472 wide and CenterPoint raises at the concatenation, in the JAX
    package as in the port (ROADMAP.md queue 3, F4)."""
    from d3d_tpu_torch.models import presets

    return presets.centerpoint_waymo(
        grid=(472, 472), bounds=(-75.52, 75.52, -75.52, 75.52, -2.0, 4.0),
        **kw)


def waymo_eval_path(dev, root):
    """A converted Waymo segment through WaymoLoader (the clouds in the
    vehicle frame within 1e-5 m of the written ones, the labels' ids
    decoded) into CenterPoint on presets.centerpoint_waymo (full width on
    ``waymo_preset``'s grid, bf16, seeded weights, heads calibrated; K1's
    bit rows and the scan
    once a request) and evaluate_waymo_detection with the boxes' point
    counts on the card (gt_num_points card equal to CPU): the ground
    truth as detections scores AP 1 in both levels; painting_rig on the
    loader's calibration pixel-matches project_points_to_camera. Returns
    (counts, stats)."""
    from d3d_tpu_torch.abstraction import ObjectTag, ObjectTarget3D
    from d3d_tpu_torch.abstraction import Target3DArray
    from d3d_tpu_torch.benchmarks import DetectionEvaluator
    from d3d_tpu_torch.benchmarks_waymo import (evaluate_waymo_detection,
                                                gt_num_points)
    from d3d_tpu_torch.dataset.waymo import WaymoLoader, WaymoObjectClass
    from d3d_tpu_torch.models import CenterPoint, make_centerpoint_detector
    from d3d_tpu_torch.ops.painting import _project, painting_rig

    t0 = time.perf_counter()
    clouds, truth = write_waymo_segment(root / "waymo", DS_SEQ_FRAMES, 180)
    write_s = time.perf_counter() - t0
    ld = WaymoLoader(root / "waymo", phase="training")
    check(len(ld) == DS_SEQ_FRAMES, f"Waymo loader of {len(ld)} frames")
    frames, loader_ms = ds_loader_ms(ld, range(DS_SEQ_FRAMES), lambda l, i: (
        l.lidar_data(i), l.annotation_3dobject(i), l.pose(i),
        l.timestamp(i)))
    for f, (pts, gt, _, _) in enumerate(frames):
        check(pts.shape == clouds[f].shape and float(np.abs(
            pts - clouds[f]).max()) <= 1e-5,
            f"Waymo frame {f}: points off the written ones")
        check([o.tid for o in gt] == [9100 + i for i in range(len(gt))],
              f"Waymo frame {f}: track ids not decoded")
        # the data model stores float32: 1e-5 m at 75 m
        ds_same_boxes(f"Waymo frame {f} labels", gt, [
            WaymoObjectClass(k).name for k in truth[f][0]], truth[f][1],
            pos_tol=1e-5, dim_tol=1e-5, yaw_tol=1e-6)
    classes = [WaymoObjectClass.Vehicle, WaymoObjectClass.Pedestrian,
               WaymoObjectClass.Cyclist]
    cfg32 = waymo_preset(dtype="float32")
    model32 = CenterPoint(cfg32, return_feat=True, point_features=5,
                          device=dev,
                          generator=torch.Generator().manual_seed(18))
    share, peaks = calibrate_center_heads(model32, frames[0][0], dev)
    model16 = CenterPoint(waymo_preset(), return_feat=True,
                          point_features=5, device=dev)
    model16.load_state_dict(model32.state_dict())
    detect = make_centerpoint_detector(model16, None, model16.cfg,
                                       model16.cfg, classes, device=dev)
    reset_counts()
    dets, req_ms = [], []
    for f, (pts, _, _, ts) in enumerate(frames):
        out, ms, _ = timed(lambda: detect(pts, frame="vehicle",
                                          timestamp=ts))
        dets.append(out)
        req_ms.append(ms)
    counts = read_counts()
    n = DS_SEQ_FRAMES
    check(counts == want_counts(rbox_iou_matrix=n, nms_scan=n),
          f"waymo_eval requests: launches {counts}")
    check_nms_routes("waymo_eval", n)
    gts = [gt for _, gt, _, _ in frames]
    pts_all = [p for p, _, _, _ in frames]
    for f in (0, n - 1):
        a = gt_num_points(gts[f], pts_all[f], device=dev)
        b = gt_num_points(gts[f], pts_all[f], device="cpu")
        check(np.array_equal(np.asarray(a), np.asarray(b))
              and (np.asarray(a) >= 100).all(),
              f"Waymo gt_num_points card {a} vs CPU {b}")
    # the ground truth as detections, scored apart (0.95 down to 0.5: the
    # PR curve's thresholds need scores that tell them apart)
    as_dets = [Target3DArray([ObjectTarget3D(
        o.position, o.orientation, o.dimension,
        ObjectTag(o.tag_top, WaymoObjectClass, float(sc)))
        for o, sc in zip(gt, np.linspace(0.95, 0.5, len(gt)))],
        frame=gt.frame, timestamp=gt.timestamp) for gt in gts]
    overlaps = [0.7, 0.5, 0.5]
    t0 = time.perf_counter()
    res = evaluate_waymo_detection(
        lambda: DetectionEvaluator(classes, overlaps, device=dev), gts,
        as_dets, clouds=pts_all)
    eval_s = time.perf_counter() - t0
    aps = {}
    for level in ("LEVEL_1", "LEVEL_2"):
        ap = res[level].ap()
        aps[level] = {c.name: float(ap[c]) for c in classes}
        check(all(v == 1.0 for v in aps[level].values()),
              f"Waymo ground truth as detections: {level} AP {aps[level]}")
    model_res = evaluate_waymo_detection(
        lambda: DetectionEvaluator(classes, overlaps, device=dev), gts,
        dets, clouds=pts_all)
    model_ap = {c.name: float(model_res["LEVEL_2"].ap()[c])
                for c in classes}
    # painting_rig on the loader's calibration against the projection
    calib = ld.calibration_data(0)
    cams = [c for c in ld.VALID_CAM_NAMES if c in calib.intrinsics]
    for cam in cams:
        calib.intrinsics_meta[cam].distort_coeffs = np.asarray([])
    ks, exts = painting_rig(calib, cams, frame_from="lidar_top")
    rng = np.random.default_rng(181)
    probe = np.stack([rng.uniform(5, 40, 256), rng.uniform(-8, 8, 256),
                      rng.uniform(-2, 1, 256)], axis=1)
    worst_px = 0.0
    for i, cam in enumerate(cams):
        uv, _, dmask = calib.project_points_to_camera(
            probe, frame_to=cam, frame_from="lidar_top",
            remove_outlier=False, return_dmask=True)
        u, v, ahead = _project(
            torch.from_numpy(probe.astype(np.float32)).to(dev),
            torch.from_numpy(ks[i]).to(dev),
            torch.from_numpy(exts[i]).to(dev))
        sel = np.zeros(len(probe), bool)
        sel[dmask] = True
        check(np.array_equal(ahead.cpu().numpy(), sel),
              f"painting_rig {cam}: points ahead differ")
        got = np.stack([u.cpu().numpy(), v.cpu().numpy()], axis=1)[sel]
        err = np.abs(got - uv[sel])
        check(bool((err <= 0.3 + 1e-4 * np.abs(uv[sel])).all()),
              f"painting_rig {cam}: {err.max()} px off")
        worst_px = max(worst_px, float(err.max()))
    stats = dict(write_s=write_s, loader_ms=loader_ms,
                 request_ms=statistics.median(req_ms),
                 occupied_share=share, peaks=peaks, gt_ap=aps,
                 model_ap_level2=model_ap, eval_s=eval_s,
                 painting_px=worst_px)
    log(f"waymo_eval: {n} frames of {len(clouds[0])} points (written in "
        f"{write_s:.1f} s); WaymoLoader {loader_ms:.2f} ms a frame; "
        f"CenterPoint (centerpoint_waymo, bf16; heads over {share:.1%} "
        f"occupied cells, {peaks} peaks) {stats['request_ms']:.2f} ms a "
        f"request (CUDA events, median), launches {counts}; ground truth "
        f"as detections AP {aps}; the random model's LEVEL_2 AP {model_ap}; "
        f"evaluate_waymo_detection {eval_s:.2f} s for the 20 frames "
        f"(host clock, 8 strata); painting_rig within {worst_px:.3g} px")
    return counts, stats


def write_raw_drive(root, frames, seed):
    """A KITTI raw synced drive 2011_09_26_drive_0001: ~120 000 points a
    frame, the tracklets of the tracking scene's objects, one oxts packet
    a frame, timestamps of every sensor, the date's three calibration
    files; images of cam2 only (the path reads none). Returns the clouds
    and each frame's (classes, boxes)."""
    rng = np.random.default_rng(seed)
    date, drive = "2011_09_26", "2011_09_26_drive_0001_sync"
    out = DsWriter(root)
    cam = ["calib_time: 09-Jan-2012 13:57:47"]
    for i in range(4):
        p = np.array([[721.5, 0.0, 609.5, -40.0 * i],
                      [0.0, 721.5, 172.8, 0.0], [0.0, 0.0, 1.0, 0.0]])
        cam += ["S_rect_%02d: 1242 375" % i,
                "R_rect_%02d: 1 0 0 0 1 0 0 0 1" % i,
                "P_rect_%02d: " % i + " ".join("%.6e" % v for v in p.ravel())]
    out.write(f"{date}/calib_cam_to_cam.txt", "\n".join(cam) + "\n")

    def rt(r, t):
        return ("R: " + " ".join("%.6e" % v for v in np.ravel(r))
                + "\nT: " + " ".join("%.6e" % v for v in t) + "\n")
    out.write(f"{date}/calib_imu_to_velo.txt", rt(np.eye(3),
                                                 [0.8, -0.3, 0.9]))
    out.write(f"{date}/calib_velo_to_cam.txt", rt(DS_VELO_TO_CAM[:, :3],
                                                 DS_VELO_TO_CAM[:, 3]))
    stamps = "".join("2011-09-26 13:02:%02d.%06d000\n"
                     % (25 + f // 10, 100000 * (f % 10))
                     for f in range(frames))
    base = f"{date}/{drive}"
    for folder in ("image_00", "image_01", "image_02", "image_03",
                   "velodyne_points", "oxts"):
        out.write(f"{base}/{folder}/timestamps.txt", stamps)
    png = ds_png(DS_KITTI_IMAGE)
    clouds, truth = [], []
    for f in range(frames):
        classes, _, b = ds_track_boxes(f)
        cloud = ds_cloud(rng, DS_POINTS, b)
        clouds.append(cloud)
        truth.append((classes, b))
        out.write(f"{base}/velodyne_points/data/%010d.bin" % f,
                  cloud.tobytes())
        out.write(f"{base}/image_02/data/%010d.png" % f, png)
        out.write(f"{base}/oxts/data/%010d.txt" % f, "%.10f 8.4228601000 "
                  "112.80 0.03 0.01 0.50 %s\n" % (
                      49.011212 + 5.0 * f * DS_DT / 111_319.0,
                      DS_OXTS_TAIL))
    items = []
    for k, (cls, _, _, _) in enumerate(DS_OBJECTS):
        l, w, h = DS_SIZES[cls]
        poses = "\n".join(
            "      <item><tx>%r</tx><ty>%r</ty><tz>%r</tz><rx>0</rx>"
            "<ry>0</ry><rz>%r</rz><state>1</state><occlusion>0</occlusion>"
            "<occlusion_kf>0</occlusion_kf><truncation>0</truncation>"
            "<amt_occlusion>0</amt_occlusion><amt_border_l>0</amt_border_l>"
            "</item>" % (float(truth[f][1][k, 0]), float(truth[f][1][k, 1]),
                         float(truth[f][1][k, 2] - h / 2),
                         float(truth[f][1][k, 6])) for f in range(frames))
        items.append(
            f"  <item>\n    <objectType>{cls}</objectType>\n"
            f"    <h>{h}</h><w>{w}</w><l>{l}</l>\n"
            f"    <first_frame>0</first_frame>\n    <poses>\n"
            f"      <count>{frames}</count>\n"
            f"      <item_version>2</item_version>\n{poses}\n    </poses>\n"
            "    <finished>1</finished>\n  </item>")
    out.write(f"{base}/tracklet_labels.xml",
              '<?xml version="1.0" encoding="UTF-8"?>\n'
              '<boost_serialization signature="serialization::archive" '
              'version="9">\n<tracklets class_id="0" tracking_level="0" '
              f'version="0">\n  <count>{len(items)}</count>\n'
              "  <item_version>1</item_version>\n" + "\n".join(items)
              + "\n</tracklets>\n</boost_serialization>\n")
    out.close()
    return clouds, truth


def write_cadc_drive(root, frames, seed):
    """A CADC labeled drive 2018_03_06/0001: ~60 000 points a frame
    around the car, 8 camera calibrations and the extrinsics YAML, one
    INSPVAX packet and timestamps a frame, two cuboids a frame (a moving
    car, a parked semi truck); images of camera 0 only. Returns the
    clouds."""
    import json

    import yaml

    rng = np.random.default_rng(seed)
    out = DsWriter(root)
    date, drive = "2018_03_06", "0001"
    cam_yaml = ("image_width: 1280\nimage_height: 1024\ncamera_name: F\n"
                "camera_matrix:\n  rows: 3\n  cols: 3\n  data: [653.0, 0.0, "
                "653.6, 0.0, 650.0, 508.4, 0.0, 0.0, 1.0]\ndistortion_model:"
                " plumb_bob\ndistortion_coefficients:\n  rows: 1\n  cols: 5\n"
                "  data: [-0.17, 0.08, 0.0002, -0.0005, 0.0]\n")

    def mat(t, about_z=0.0):
        c, s = np.cos(about_z), np.sin(about_z)
        m = np.eye(4)
        m[:2, :2] = [[c, -s], [s, c]]
        m[:3, 3] = t
        return m.tolist()
    ext = {"T_BASELINK_LIDAR": mat([0.0, 0.0, 1.6]),
           "T_00CAMERA_00IMU": mat([0.0, 0.1, 0.0]),
           "T_03CAMERA_03IMU": mat([0.0, -0.1, 0.0]),
           "T_LIDAR_GPSIMU": mat([-0.5, 0.0, -1.2])}
    for i in range(8):
        ext["T_LIDAR_CAM%02d" % i] = mat([0.1 * i, 0.0, -0.3],
                                         about_z=i * np.pi / 4)
        out.write(f"{date}/calib/%02d.yaml" % i, cam_yaml)
    out.write(f"{date}/calib/extrinsics.yaml", yaml.safe_dump(ext))
    stamps = "".join("2018-03-06T14:17:%02d.%06d\n" % (2 + f, 1000 * f)
                     for f in range(frames))
    base = f"{date}/{drive}/labeled"
    for i in range(8):
        out.write(f"{base}/image_%02d/timestamps.txt" % i, stamps)
    png = ds_png((1280, 1024), 200)
    clouds, anns = [], []
    for f in range(frames):
        cloud = ds_cloud(rng, DS_CADC_POINTS, half=(-40.0, 40.0, -40.0,
                                                    40.0), z=(-3.0, 2.0))
        clouds.append(cloud)
        out.write(f"{base}/lidar_points/data/%010d.bin" % f, cloud.tobytes())
        out.write(f"{base}/image_00/data/%010d.png" % f, png)
        out.write(f"{base}/novatel/data/%010d.txt" % f,
                  "%.8f -80.54 335.8 -36.5 0.01 0.01 0.02 0.5 -0.3 271.9 "
                  "0.02 0.02 0.08 3 56\n" % (43.47 + 1e-5 * f))
        anns.append(dict(cuboids=[
            dict(uuid="aaaabbbb-cccc-dddd-eeee-%012d" % f, label="Car",
                 yaw=0.2, position=dict(x=12.0 + f, y=3.0, z=0.8),
                 dimensions=dict(x=2.0, y=4.6, z=1.6),
                 attributes=dict(state="Moving")),
            dict(uuid="11112222-3333-4444-5555-%012d" % f, label="Truck",
                 yaw=-0.4, position=dict(x=-8.0, y=-6.0, z=1.0),
                 dimensions=dict(x=2.6, y=8.5, z=3.2),
                 attributes=dict(truck_type="Semi_Truck",
                                 state="Parked"))]))
    for folder in ("lidar_points", "novatel"):
        out.write(f"{base}/{folder}/timestamps.txt", stamps)
    out.write(f"{date}/{drive}/3d_ann.json", json.dumps(anns))
    out.close()
    return clouds


def raw_cadc_path(dev, root, pp):
    """A KITTI raw drive and a CADC drive through their loaders (points
    bit-equal) into one PointPillars request a frame; the raw drive's
    tracklets through DeviceCenterTracker and TrackingEvaluator (the
    ground truth tracked scores MOTA 1), as examples/kitti_raw_pipeline.py
    does on the host. Returns (counts, stats)."""
    from d3d_tpu_torch.dataset.cadc import CADCDLoader
    from d3d_tpu_torch.dataset.kitti import (KittiObjectClass,
                                             KittiRawLoader)
    from d3d_tpu_torch.tracking.device_tracker import DeviceCenterTracker

    t0 = time.perf_counter()
    raw_clouds, truth = write_raw_drive(root / "raw", DS_SEQ_FRAMES, 190)
    cadc_clouds = write_cadc_drive(root / "cadc", DS_CADC_FRAMES, 191)
    write_s = time.perf_counter() - t0
    raw = KittiRawLoader(root / "raw", inzip=False, phase="training",
                         trainval_split=1)
    cadc = CADCDLoader(root / "cadc", inzip=False, phase="training",
                       trainval_split=1)
    check(len(raw) == DS_SEQ_FRAMES and len(cadc) == DS_CADC_FRAMES,
          f"raw {len(raw)} / CADC {len(cadc)} frames")
    raw_frames, raw_ms = ds_loader_ms(raw, range(DS_SEQ_FRAMES), lambda l, i: (
        l.lidar_data(i), l.annotation_3dobject(i), l.pose(i),
        l.timestamp(i), l.calibration_data(i)))
    cadc_frames, cadc_ms = ds_loader_ms(
        cadc, range(DS_CADC_FRAMES), lambda l, i: (
            l.lidar_data(i), l.annotation_3dobject(i), l.pose(i),
            l.timestamp(i), l.calibration_data(i)))
    for f, (pts, gt, _, _, _) in enumerate(raw_frames):
        check(pts.tobytes() == raw_clouds[f].tobytes(),
              f"raw frame {f}: points differ from the written file")
        ds_same_boxes(f"raw frame {f} tracklets", gt, truth[f][0],
                      truth[f][1], pos_tol=1e-5, dim_tol=1e-5,
                      yaw_tol=1e-6)
    for f, (pts, gt, pose, _, _) in enumerate(cadc_frames):
        check(pts.tobytes() == cadc_clouds[f].tobytes(),
              f"CADC frame {f}: points differ from the written file")
        check(len(gt) == 2 and np.isfinite(pose.position).all(),
              f"CADC frame {f}: annotation or pose")
    classes = [KittiObjectClass[c] for c in DS_CLASSES]
    tracker = DeviceCenterTracker(
        classes, {c.value: g for c, g in zip(classes, DS_GATES)},
        lost_time=TRACK_LOST_TIME, capacity=TRACK_CAPACITY, device=dev)
    reset_counts()
    req_ms, kept = [], []
    for pts in [f[0] for f in raw_frames] + [f[0] for f in cadc_frames]:
        out, ms, _ = timed(lambda: pp["detect"](pts))
        req_ms.append(ms)
        kept.append(len(out))
    counts = read_counts()
    n = DS_SEQ_FRAMES + DS_CADC_FRAMES
    check(counts == want_counts(rbox_iou_matrix=n, nms_scan=n),
          f"raw_cadc requests: launches {counts}")
    check_nms_routes("raw_cadc", n)
    ev = ds_tracking_evaluator(dev)
    for _, gt, _, ts, _ in raw_frames:
        gt.timestamp = ts
        tracker.update(gt)
        ev.add_stats(ev.calc_stats(gt, tracker.report()))
    mota = {c.name: float(ev.mota(0.0)[c]) for c in classes}
    check(all(v == 1.0 for v in mota.values()),
          f"raw drive's tracklets tracked: MOTA {mota}")
    stats = dict(write_s=write_s, loader_ms=dict(raw=raw_ms, cadc=cadc_ms),
                 request_ms=statistics.median(req_ms), kept=kept, mota=mota)
    log(f"raw_cadc: a raw drive of {DS_SEQ_FRAMES} frames and a CADC drive "
        f"of {DS_CADC_FRAMES} frames of ~{DS_CADC_POINTS} points (written "
        f"in {write_s:.1f} s); KittiRawLoader {raw_ms:.2f} ms a frame, "
        f"CADCDLoader {cadc_ms:.2f} ms a frame; PointPillars requests "
        f"{stats['request_ms']:.2f} ms (CUDA events, median), launches "
        f"{counts}; the tracklets through DeviceCenterTracker: MOTA {mota}")
    return counts, stats


def native_oracle(dev):
    """The port's native host oracle (built with g++ into build/) against
    the card at DS_NATIVE_BOXES detector-like boxes: K1's float32 matrix
    off the oracle's float64 IoU by no more than its plain float32
    version is (computed on the card in blocks of 512 rows) plus K1's 2e-5
    from that version (the triangle inequality: float32 itself is up to
    ~2e-5 off float64 on thin overlaps); box2d_nms(precise=True)
    on the card (the float64 matrix, then the scan) keeping what the
    oracle's nms2d keeps, a differing box allowed only where a pair's
    float64 IoU lies within 4 ulp of the threshold. Returns (counts,
    stats)."""
    from d3d_tpu_torch import native
    from d3d_tpu_torch.ops import geometry_cuda
    from d3d_tpu_torch.ops.box import box2d_nms

    t0 = time.perf_counter()
    check(native.available(), f"native oracle did not build: "
                              f"{native._BUILD_ERROR!r}")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(195)
    boxes, scores = bench_boxes(rng, DS_NATIVE_BOXES)
    b64, s64 = boxes.astype(np.float64), scores.astype(np.float64)
    reset_counts()
    k1, k1_ms, _ = timed(lambda: geometry_cuda.rbox_iou_matrix(
        torch.from_numpy(boxes).to(dev), torch.from_numpy(boxes).to(dev)))
    t0 = time.perf_counter()
    ref = native.rbox_iou_matrix(b64, b64)
    iou_s = time.perf_counter() - t0
    from d3d_tpu_torch.ops import geometry_soa

    tb = torch.from_numpy(boxes).to(dev)
    plain = torch.cat([geometry_soa._rbox_iou_matrix_plain(tb[i:i + 512], tb)
                       for i in range(0, len(tb), 512)]).cpu().numpy()
    err = float(np.abs(k1.cpu().numpy() - ref).max())
    plain_err = float(np.abs(plain - ref).max())
    check(err <= plain_err + 2e-5,
          f"native oracle: K1 {err} from the float64 IoU, its plain "
          f"float32 version {plain_err}")
    keep, nms_ms, _ = timed(lambda: box2d_nms(
        b64, s64, iou_method="rbox", iou_threshold=DS_NATIVE_THRESHOLD,
        precise=True, device=dev))
    counts = read_counts()
    keep = np.asarray(keep.cpu() if torch.is_tensor(keep) else keep)
    t0 = time.perf_counter()
    want = native.nms2d(b64, s64, iou_method="rbox",
                        iou_threshold=DS_NATIVE_THRESHOLD)
    nms_s = time.perf_counter() - t0
    diff = np.flatnonzero(keep != want)
    near = np.abs(ref - DS_NATIVE_THRESHOLD) <= 4 * np.spacing(
        DS_NATIVE_THRESHOLD)
    np.fill_diagonal(near, False)
    check(len(diff) == 0 or bool(near.any()),
          f"native oracle: box2d_nms keeps {len(diff)} boxes otherwise, "
          "no pair within 4 ulp of the threshold")
    check(counts["rbox_iou_matrix"] == 1
          and counts["nms_scan"] + counts["nms_scan_blocked"] == 1,
          f"native oracle: launches {counts}")
    stats = dict(build_s=build_s, k1_err=err, plain_f32_err=plain_err,
                 k1_ms=k1_ms,
                 native_iou_s=iou_s, native_nms_s=nms_s,
                 card_nms_precise_ms=nms_ms, kept=int(want.sum()),
                 mask_diffs=len(diff), near_threshold_pairs=int(near.sum()))
    log(f"native_oracle: built in {build_s:.2f} s; {DS_NATIVE_BOXES} boxes: "
        f"K1 f32 {k1_ms:.3f} ms vs the oracle's float64 IoU {iou_s:.2f} s "
        f"(max error {err:.3g}, the plain float32 version's {plain_err:.3g}"
        "); box2d_nms(precise=True) on the card "
        f"{nms_ms:.2f} ms vs the oracle's nms2d {nms_s:.3f} s, keep masks "
        f"{'equal' if not len(diff) else f'{len(diff)} apart'} "
        f"({int(want.sum())} kept, {int(near.sum())} pairs within 4 ulp of "
        f"the threshold); launches {counts}")
    return counts, stats


def datasets_phase(dev):
    """The datasets path: each scene written once under build/datasets/,
    then kitti_tracking, semantickitti, waymo_eval, raw_cadc and
    native_oracle. Returns ({path: counts}, stats)."""
    import shutil

    t0 = time.perf_counter()
    root = ROOT / "build" / "datasets"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    counts, stats = {}, {}
    counts["kitti_tracking"], stats["kitti_tracking"], pp = \
        kitti_tracking_path(dev, root)
    counts["semantickitti"], stats["semantickitti"] = semantickitti_path(
        dev, root)
    counts["waymo_eval"], stats["waymo_eval"] = waymo_eval_path(dev, root)
    counts["raw_cadc"], stats["raw_cadc"] = raw_cadc_path(dev, root, pp)
    counts["native_oracle"], stats["native_oracle"] = native_oracle(dev)
    stats["phase_s"] = time.perf_counter() - t0
    log(f"datasets: {stats['phase_s']:.1f} s")
    return counts, stats


# ---------------------------------------------------------------------------
# examples and the dry run: the user-facing scripts and the repo's entry
# points, on the card
# ---------------------------------------------------------------------------

EX_PP_STEPS = 10      # train_pointpillars' --steps (its default is 50)
EX_PP_RESUME = 2      # steps of the run that resumes from its checkpoint
EX_SERVE_CPU = 3      # serve_tracking frames held to the CPU


def example_module(name):
    """``examples/<name>.py`` imported from the checkout."""
    import importlib

    path = str(ROOT / "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def run_example(name, fn):
    """(result, launch counts, wall s) of one example's run on the card,
    the counts set to 0 just before and read just after; logs both."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    log(f"examples: {name}: {wall:.2f} s, K1 {counts['rbox_iou_matrix']}, "
        f"K2 {counts['nms_scan']}")
    return out, counts, wall


def same_metrics(name, card, cpu, path=""):
    """Nested metrics card vs CPU: ints exact, floats within 1e-5 (f32
    IoU accumulations in another order); returns the largest float
    difference."""
    if isinstance(cpu, dict):
        check(card.keys() == cpu.keys(), f"{name}: keys {path}")
        return max([same_metrics(name, card[k], cpu[k], f"{path}/{k}")
                    for k in cpu] + [0.0])
    if isinstance(cpu, float) and isinstance(card, float):
        if math.isnan(cpu):
            check(math.isnan(card), f"{name}: {path} {card} vs nan")
            return 0.0
        err = abs(card - cpu)
        check(err <= 1e-5, f"{name}: {path} {card} vs {cpu}")
        return err
    check(card == cpu, f"{name}: {path} {card} vs {cpu}")
    return 0.0


def examples_evaluate(dev, stats, counts):
    demo = example_module("torch_evaluate_detections")
    ev, counts["evaluate_detections"], stats["evaluate_detections_s"] = \
        run_example("evaluate_detections", lambda: demo.run(128, dev))
    cpu = demo.run(128, "cpu")
    card, want = ev.metrics_dict(), cpu.metrics_dict()
    stats["evaluate_detections_max_err"] = same_metrics(
        "evaluate_detections", card, want)
    check(card["Car"]["tp"] > 0 and card["Pedestrian"]["tp"] > 0,
          "evaluate_detections: no true positive")
    stats["evaluate_detections_map"] = card["mAP"]


def examples_tracking(dev, stats, counts):
    demo = example_module("torch_track_sequence")
    got, counts["track_sequence"], stats["track_sequence_s"] = run_example(
        "track_sequence", lambda: demo.run(40, 6, dev))
    want = demo.run(40, 6, "cpu")
    for name in want:
        for k, v in want[name].items():
            same = got[name][k] == v or (
                isinstance(v, float) and math.isnan(v)
                and math.isnan(got[name][k]))
            check(same, f"track_sequence: {name} {k} card {got[name][k]} "
                  f"vs CPU {v}")
    stats["track_sequence"] = {name: {k: v for k, v in m.items()
                                      if k != "tids"}
                               for name, m in got.items()}


def examples_kitti_raw(dev, stats, counts, root):
    sys.path.insert(0, str(ROOT / "tests"))
    from dataset_fixtures import build_kitti_raw

    from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass

    demo = example_module("torch_kitti_raw_pipeline")
    build_kitti_raw(root / "kitti_raw", nframes=3)
    ev, counts["kitti_raw_pipeline"], stats["kitti_raw_pipeline_s"] = \
        run_example("kitti_raw_pipeline",
                    lambda: demo.run(root / "kitti_raw", device=dev))
    check(ev.mota()[KittiObjectClass.Car] == 1.0
          and not any(ev.id_switches().values()),
          "kitti_raw_pipeline: the ground truth tracked imperfectly")


def examples_viewer(dev, stats, counts, root):
    """The viewer's frame loop with a recording renderer (the card's
    machine has neither pcl nor matplotlib)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from dataset_fixtures import build_waymo

    demo = example_module("torch_dataset_viewer")
    build_waymo(root / "waymo", nframes=3)
    seen = []

    def render(cloud, lidar_frame, objs, calib):
        seen.append((len(cloud), len(objs), lidar_frame))

    _, counts["dataset_viewer"], stats["dataset_viewer_s"] = run_example(
        "dataset_viewer", lambda: demo.dataset_visualize_pcl(
            root / "waymo", "waymo", "1234567890_000_000_1234567890_000",
            device=dev, render=render, ask=lambda prompt: ""))
    check(len(seen) == 3 and all(n > 0 and m > 0 for n, m, _ in seen),
          f"dataset_viewer: frames {seen}")
    stats["dataset_viewer_frames"] = seen


def check_keep_masks(name, dets, iou_threshold=0.5):
    """Each frame's keep mask from the card (K1's bit rows and the scan)
    equal to the CPU's nms2d (the plain IoU and scan) on the card's own
    boxes and scores, so box rounding cannot explain a difference."""
    from d3d_tpu_torch.models.inference import _bev
    from d3d_tpu_torch.ops.nms import nms2d

    for t, (boxes, scores, keep) in enumerate(dets):
        want = ~nms2d(_bev(boxes), scores.float(),
                      iou_threshold=iou_threshold, iou_method="rbox")
        check(torch.equal(keep, want), f"{name} frame {t}: keep mask card "
              f"({int(keep.sum())} kept) vs CPU ({int(want.sum())} kept)")


def examples_serving(dev, stats, counts):
    """serve_tracking: 20 frames and the reloaded artifact's one step on
    the card; every frame's keep mask held to the CPU's NMS on the card's
    boxes (top-k 32), and the first frames' scores, kept scores and live
    tracks held to the same run on the CPU with the same weights."""
    demo = example_module("torch_serve_tracking")
    got, counts["serve_tracking"], stats["serve_tracking_s"] = run_example(
        "serve_tracking", lambda: demo.run(20, dev))
    check_nms_routes("serve_tracking", 21)
    check_keep_masks("serve_tracking", got["dets"])
    cpu = demo.run(EX_SERVE_CPU, "cpu")
    # f32 on both sides (TF32 off), summed in other orders: scores within
    # 1e-4, compare_with_cpu's bound. The k-th largest score moves no
    # more than the scores do, so the sorted top-k is compared whatever
    # order near-ties take; so are the kept scores, sorted
    score_err = 0.0
    for t in range(EX_SERVE_CPU):
        (_, sg, kg), (_, sc, kc) = got["dets"][t], cpu["dets"][t]
        top = float((sg.sort().values - sc.sort().values).abs().max())
        check(top <= 1e-4, f"serve_tracking frame {t}: top-k scores card "
              f"vs CPU {top}")
        check(int(kg.sum()) == int(kc.sum()), f"serve_tracking frame {t}: "
              f"kept card {int(kg.sum())} vs CPU {int(kc.sum())}")
        kept = float((sg[kg].sort().values - sc[kc].sort().values)
                     .abs().max()) if bool(kg.any()) else 0.0
        check(kept <= 1e-4, f"serve_tracking frame {t}: kept scores card "
              f"vs CPU {kept}")
        score_err = max(score_err, top, kept)
    card = got["live"][:EX_SERVE_CPU]
    if card != cpu["live"]:
        # an ulp between the card's and the CPU's f32 scores (the trap of
        # compare_with_cpu) may move a score across the admission gate;
        # only a score that close explains a different count
        near = min([float((s[k] - demo.SCORE_GATE).abs().min())
                    for run in (got, cpu)
                    for _, s, k in run["dets"][:EX_SERVE_CPU] if k.any()]
                   + [math.inf])
        check(near <= 1e-5, f"serve_tracking: live tracks card {card} vs "
              f"CPU {cpu['live']}, the nearest score {near} off the gate")
        log(f"examples: serve_tracking live tracks card {card} vs CPU "
            f"{cpu['live']}: a score {near:.2e} from the gate")
    check(got["export_bytes"] > 0 and got["export_live"] > 0,
          "serve_tracking: the export round trip")
    kept_n = [int(k.sum()) for _, _, k in got["dets"]]
    log(f"examples: serve_tracking keep masks of {len(kept_n)} frames equal "
        f"to the CPU's NMS on the card's boxes (kept {kept_n}); frames "
        f"0-{EX_SERVE_CPU - 1} scores card vs CPU within {score_err:.3g}")
    stats["serve_tracking"] = dict(
        live=got["live"], cpu_live=cpu["live"], kept=kept_n,
        score_err=score_err, steady_ms=statistics.median(got["ms"][2:]),
        first_ms=got["ms"][0], export_bytes=got["export_bytes"],
        export_live=got["export_live"])


def examples_mono3d(dev, stats, counts):
    demo = example_module("torch_train_mono3d")
    got, counts["train_mono3d"], stats["train_mono3d_s"] = run_example(
        "train_mono3d", lambda: demo.run(150, dev))
    losses = [s["total"] for s in got["losses"]]
    check(len(losses) == 150 and np.isfinite(losses).all()
          and np.isfinite(got["ap"]), "train_mono3d: non-finite")
    stats["train_mono3d"] = dict(first_loss=losses[0], last_loss=losses[-1],
                                 ap=got["ap"], depth_err=got["depth_err"])


def examples_pointpillars(dev, stats, counts, root):
    import shutil

    import torch.distributed as dist

    demo = example_module("torch_train_pointpillars")
    ckpt = root / "pp_ckpts"
    shutil.rmtree(ckpt, ignore_errors=True)
    check(not dist.is_initialized(), "train_pointpillars: a process group "
          "is left from an earlier phase")
    got, counts["train_pointpillars"], stats["train_pointpillars_s"] = \
        run_example("train_pointpillars", lambda: demo.run(
            steps=EX_PP_STEPS, ckpt_dir=str(ckpt), device=dev))
    resumed, c2, s2 = run_example("train_pointpillars (resumed)",
                                  lambda: demo.run(steps=EX_PP_RESUME,
                                                   ckpt_dir=str(ckpt),
                                                   device=dev))
    add_counts(counts["train_pointpillars"], c2)
    stats["train_pointpillars_s"] += s2
    check(len(got["losses"]) == EX_PP_STEPS
          and np.isfinite(got["losses"] + resumed["losses"]).all(),
          f"train_pointpillars: losses {got['losses']} {resumed['losses']}")
    check((resumed["start"], resumed["step"])
          == (EX_PP_STEPS, EX_PP_STEPS + EX_PP_RESUME),
          f"train_pointpillars: resumed {resumed['start']} -> "
          f"{resumed['step']}")
    check(not dist.is_initialized(),
          "train_pointpillars: its world of one was not ended")
    stats["train_pointpillars"] = dict(losses=got["losses"],
                                       resumed_losses=resumed["losses"])


def examples_phase(dev):
    """The seven ``examples/torch_*.py`` in this process on the card at
    their originals' defaults (train_pointpillars at ``--steps 10``), each
    example's launches counted apart and its wall time logged; the
    evaluator's counters, the trackers' metrics and the serving loop's
    first live tracks held to the same runs on the CPU. Returns (counts
    summed over the examples, stats)."""
    import shutil

    t0 = time.perf_counter()
    root = ROOT / "build" / "examples"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    counts, stats = {}, {}
    examples_evaluate(dev, stats, counts)
    examples_tracking(dev, stats, counts)
    examples_kitti_raw(dev, stats, counts, root)
    examples_viewer(dev, stats, counts, root)
    examples_serving(dev, stats, counts)
    examples_mono3d(dev, stats, counts)
    examples_pointpillars(dev, stats, counts, root)
    total = {}
    for c in counts.values():
        add_counts(total, c)
    stats["launches"] = counts
    stats["phase_s"] = time.perf_counter() - t0
    log(f"examples: {stats['phase_s']:.1f} s")
    return total, stats


def dryrun_phase(dev):
    """``d3d_tpu_torch.dryrun``: ``entry()``'s forward on the card, then
    ``dryrun_multichip`` over every card under NCCL (its ranks are child
    processes; their launches come back summed). Returns (counts, stats)."""
    from d3d_tpu_torch import dryrun

    t0 = time.perf_counter()
    reset_counts()
    fn, args = dryrun.entry(dev)
    out, ms, _ = timed(lambda: fn(*args))
    check([tuple(o.shape) for o in out]
          == [(1, 131072, 1), (1, 131072, 7), (1, 131072, 2)]
          and all(bool(torch.isfinite(o).all()) for o in out),
          f"dryrun: entry forward {[tuple(o.shape) for o in out]}")
    stats = dict(entry_first_ms=ms,
                 entry_ms=median_ms(lambda: fn(*args), reps=10))
    counts = read_counts()
    n = torch.cuda.device_count()
    t1 = time.perf_counter()
    res = dryrun.dryrun_multichip(n, device="cuda")
    stats["dryrun_s"] = time.perf_counter() - t1
    for k, v in res["launches"].items():
        counts[k] = counts.get(k, 0) + v
    check(np.isfinite(res["loss"]) and res["ap"] > 0.99,
          f"dryrun: loss {res['loss']}, ap {res['ap']}")
    # every rank serves its dp share (one frame): n nms2d calls, on K1's
    # bit rows and the scan; the gathered keep masks (top-k 16) held to
    # the CPU's NMS on the card's boxes
    check_nms_routes("dryrun shard_inference", n, routes=res["routes"])
    boxes, scores, keep = res["serve"]
    check_keep_masks("dryrun shard_inference", list(zip(boxes, scores, keep)))
    log(f"dryrun: shard_inference keep masks of {len(keep)} frame(s) equal "
        f"to the CPU's NMS on the card's boxes (kept "
        f"{[int(k.sum()) for k in keep]} of {keep.shape[1]})")
    if n % 4:
        check(res["pp_loss"] is None and res["ep_loss"] is None,
              "dryrun: pp/ep ran on a world that is not a multiple of 4")
        log(f"dryrun: a world of {n}: the pp and ep branches do not run "
            "(n % 4 != 0), as the JAX function skips them")
    stats.update({k: res[k] for k in ("mesh", "loss", "ap", "pp_loss",
                                      "ep_loss", "seconds")})
    stats["phase_s"] = time.perf_counter() - t0
    log(f"dryrun: entry forward {stats['entry_ms']:.3f} ms (median of 10), "
        f"dry run {stats['dryrun_s']:.1f} s on {n} rank(s), K1 "
        f"{counts['rbox_iou_matrix']}, K2 {counts['nms_scan']}; "
        f"{stats['phase_s']:.1f} s")
    return counts, stats


def add_cupti(a, b):
    """A sum of CUPTI times that is None where a term is."""
    return None if a is None or b is None else a + b


def fmt_ms(ms):
    return "no device time in the trace" if ms is None else f"{ms:.4f} ms"


def train_layers_k5_backward_times(train_layers):
    """K5 as the features' gradient: device ms of the five launches of one
    training step (two frames joined, f32), summed (CUDA events over
    back-to-back launches, and CUPTI's kernel time apart), with its plain
    version (the scatter-add) and the bound of the summed bytes and
    operations."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    tot = dict(ms=0.0, cupti_ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
    for name, (g, rules, valid, wt) in k5_backward_inputs(
            train_layers).items():
        w = train_layers[name][3].float()
        def run():
            K._launch(g, rules, wt, valid)
        ms = time_launches(run, batch=20)
        cupti = cupti_ms(run, KERNEL_NAMES["subm_conv"])
        plain = time_each(lambda: K._scatter_dfeat(g, rules.nbr, w,
                                                   g.shape[0]),
                          reps=5, warmup=1)
        nbytes, ops = k5_work(g, rules.nbr, wt.shape[2])
        for k, v in (("ms", ms), ("plain_ms", plain), ("nbytes", nbytes),
                     ("ops", ops)):
            tot[k] += v
        tot["cupti_ms"] = add_cupti(tot["cupti_ms"], cupti)
        log(f"subm_conv backward {name}: {ms:.4f} ms a launch (CUDA events "
            f"over back-to-back launches; kernel time by CUPTI "
            f"{fmt_ms(cupti)}), plain (scatter-add) {plain:.4f} ms")
    b_ms, b_by = bound(tot["nbytes"], tot["ops"])
    return dict(ms_backward_step=tot["ms"],
                cupti_ms_backward_step=tot["cupti_ms"],
                plain_ms_backward_step=tot["plain_ms"],
                bound_ms_backward_step=b_ms, bound_by_backward_step=b_by,
                backward_of="the 5 features'-gradient launches of one "
                            "training step (2 frames, f32)")


def layer_times(kernel, layers, label):
    """Per-launch device ms of K5 (``kernel`` "subm_conv") or K6
    ("subm_conv_dw", with the seeded cotangent) at each layer, f32 and bf16
    (features and, for K5, weights), through the maps' rule books: ``ms``
    by CUDA events over back-to-back launches, ``cupti_ms`` the kernels'
    own time by CUPTI (None where the trace has none); the plain version's
    ms (gather + torch.einsum on cuBLAS, which is also the library call);
    bounds per layer and of the summed bytes and operations (``k5_work`` /
    ``k6_work``). Returns {"per_layer": {layer: {dtype: ...}}, dtype: {ms,
    cupti_ms, plain_ms, bound_ms, bound_by}} with the sums over the
    layers."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    grads = train_cotangent(layers, 6)
    out = {"per_layer": {}}
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).split(".")[1]
        tot = dict(ms=0.0, cupti_ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
        for name, (x, rules, valid, w) in layers.items():
            xd, wd, g = x.to(dt), w.to(dt), grads[name]
            if kernel == "subm_conv":
                def run():
                    K._launch(xd, rules, wd, valid)

                def plain_run():
                    K._subm_conv_plain(xd, rules.nbr, wd, valid)
                nbytes, ops = k5_work(xd, rules.nbr, w.shape[2])
            else:
                def run():
                    K._dw_launch(xd, rules, g)

                def plain_run():
                    K._subm_conv_dw_plain(xd, rules.nbr, g)
                nbytes, ops = k6_work(xd, rules.nbr, w.shape[2])
            ms = time_launches(run, batch=20)
            cupti = cupti_ms(run, KERNEL_NAMES[kernel])
            plain = time_each(plain_run, reps=5, warmup=1)
            b_ms, b_by = bound(nbytes, ops, k5_rate(dt))
            out["per_layer"].setdefault(name, {})[key] = dict(
                ms=ms, cupti_ms=cupti, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by)
            for k, v in (("ms", ms), ("plain_ms", plain),
                         ("nbytes", nbytes), ("ops", ops)):
                tot[k] += v
            tot["cupti_ms"] = add_cupti(tot["cupti_ms"], cupti)
            log(f"{kernel} {label} {name} {key}: {ms:.4f} ms a launch "
                f"(CUDA events over back-to-back launches; kernel time by "
                f"CUPTI {fmt_ms(cupti)}), plain {plain:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by})")
        b_ms, b_by = bound(tot["nbytes"], tot["ops"], k5_rate(dt))
        out[key] = dict(ms=tot["ms"], cupti_ms=tot["cupti_ms"],
                        plain_ms=tot["plain_ms"], bound_ms=b_ms,
                        bound_by=b_by)
        log(f"{kernel} {label} {key}: {tot['ms']:.4f} ms for the "
            f"{len(layers)} layers (CUDA events; CUPTI "
            f"{fmt_ms(tot['cupti_ms'])}), plain {tot['plain_ms']:.3f} ms, "
            f"bound {b_ms:.5f} ms ({b_by})")
    return out


def rulebook_work(nbrs):
    """The rule-book build's (bytes, operations): each map read once, its
    masks (int32) and order (int64) written once; a compare, a shift and
    an or per (row, offset) entry (the sort's passes are not counted: the
    bytes bound it either way)."""
    entries = sum(n.numel() for n in nbrs)
    rows = sum(n.shape[0] for n in nbrs)
    return entries * 4 + rows * 12, 3 * entries


def rulebook_times(layers, label):
    """Device ms of building the rule books of the distinct maps these
    layers use, as the path builds them: K5's part of all of them together
    (masks and order, ``prepare_neighbor_maps``: one call of the
    rule-book kernels) and each map's K6 lists (``RuleBook.pairs``, built
    at the map's first K6 launch). ``ms`` is CUDA events over back-to-back
    builds (as the kernels' ``ms``), ``one_build_ms`` CUDA events around
    one build (median of 20), ``cupti_ms`` the kernels' own time by CUPTI;
    the plain version (torch ops, a stable sort a map) beside them."""
    from d3d_tpu_torch.ops.rulebook import (_subm_conv_rulebook_plain,
                                            prepare_neighbor_maps)

    names, nbrs = distinct_maps(layers)
    masks = _subm_conv_rulebook_plain(nbrs)[0]

    def build():
        prepare_neighbor_maps(nbrs)

    def plain():
        _subm_conv_rulebook_plain(nbrs)

    def library():  # the sort's part, one library call a map
        for m in masks:
            torch.sort(m, stable=True)
    b_ms, b_by = bound(*rulebook_work(nbrs))
    out = dict(ms=time_launches(build, batch=20),
               one_build_ms=time_each(build, reps=20),
               cupti_ms=cupti_ms(build),
               kernels_a_build=kernel_launches(build),
               plain_ms=time_each(plain, reps=20),
               plain_cupti_ms=cupti_ms(plain), bound_ms=b_ms, bound_by=b_by,
               library_cupti_ms=cupti_ms(library),
               library_events_ms=time_launches(library, batch=20),
               maps={n: nbr.shape[0] for n, nbr in zip(names, nbrs)},
               pairs_ms=0.0, pairs_cupti_ms=0.0, pairs_per_map={})
    log(f"rule books {label}, the {len(nbrs)} maps together (Nq "
        f"{list(out['maps'].values())}): {out['ms']:.4f} ms (CUDA events "
        f"over back-to-back builds; around one build "
        f"{out['one_build_ms']:.4f} ms; kernel time by CUPTI "
        f"{fmt_ms(out['cupti_ms'])}; (kernels, memory operations) a build "
        f"{out['kernels_a_build']}); plain version "
        f"{out['plain_ms']:.4f} "
        f"ms (CUPTI {fmt_ms(out['plain_cupti_ms'])}); torch.sort(masks, "
        f"stable=True) a map: CUPTI {fmt_ms(out['library_cupti_ms'])}, "
        f"events {out['library_events_ms']:.4f} ms; bound {b_ms:.5f} ms "
        f"({b_by})")
    for name, rb in zip(names, prepare_neighbor_maps(nbrs)):
        def pairs():
            rb._pairs = None
            rb.pairs()
        ms, cupti = time_each(pairs, reps=20), cupti_ms(pairs)
        out["pairs_per_map"][name] = dict(ms=ms, cupti_ms=cupti)
        out["pairs_ms"] += ms
        out["pairs_cupti_ms"] = add_cupti(out["pairs_cupti_ms"], cupti)
        log(f"K6's lists {label} {name}'s map (Nq {rb.shape[0]}): "
            f"{ms:.4f} ms (CUDA events around one build; CUPTI "
            f"{fmt_ms(cupti)})")
    return out


def nms_times(tb, ts, thr=0.25):
    """nms2d's parts on these boxes and scores: the scan as nms2d launches
    it (events over back-to-back launches, CUPTI), K1's bit form beside
    its f32 form (the boxes in score order), the whole nms2d call (events,
    CUPTI, its kernels and memory operations counted by the profiler) and
    its torch.sort(-scores, stable=True) by CUPTI."""
    from d3d_tpu_torch.ops import geometry_cuda, nms_cuda
    from d3d_tpu_torch.ops.nms import nms2d

    n = tb.shape[0]
    neg, order = torch.sort(-ts, stable=True)
    bo = tb[order].contiguous()
    chains = torch.zeros(1, dtype=torch.int32, device=tb.device)
    bits = geometry_cuda._bits_launch(bo, thr, chains=chains)
    out = torch.empty(n, dtype=torch.bool, device=tb.device)

    def scan():
        nms_cuda._scan_launch(bits, out, neg_scores=neg, order=order)

    def k1_bits():
        geometry_cuda._bits_launch(bo, thr)

    def k1_matrix():
        geometry_cuda._launch(bo, bo)

    def call():
        nms2d(tb, ts, iou_threshold=thr)

    kernels, mem = kernel_launches(call)
    row = dict(scan_ms=time_launches(scan),
               scan_cupti_ms=cupti_ms(scan, ("scan_",)),
               k1_bits_ms=time_launches(k1_bits),
               k1_bits_cupti_ms=cupti_ms(k1_bits, ("rbox_bits",)),
               k1_matrix_ms=time_launches(k1_matrix),
               k1_matrix_cupti_ms=cupti_ms(k1_matrix, ("rbox_iou",)),
               k1_bits_bound_ms=k1_bits_bound(n, int(chains))[0],
               nms2d_ms=time_launches(call), nms2d_cupti_ms=cupti_ms(call),
               nms2d_kernels=kernels, nms2d_memory_ops=mem,
               sort_cupti_ms=cupti_ms(
                   lambda: torch.sort(-ts, stable=True)))
    log(f"nms2d n={n}: scan {row['scan_ms']:.4f} ms (CUDA events; CUPTI "
        f"{fmt_ms(row['scan_cupti_ms'])}), K1 bits {row['k1_bits_ms']:.4f} "
        f"(CUPTI {fmt_ms(row['k1_bits_cupti_ms'])}) vs f32 matrix "
        f"{row['k1_matrix_ms']:.4f} (CUPTI {fmt_ms(row['k1_matrix_cupti_ms'])}"
        f"); the call {row['nms2d_ms']:.4f} ms (CUPTI "
        f"{fmt_ms(row['nms2d_cupti_ms'])}), {kernels} kernels and {mem} "
        f"memory operations; torch.sort(-scores) by CUPTI "
        f"{fmt_ms(row['sort_cupti_ms'])}")
    return row


def kernel_times(dev, ns_inputs, k3_inputs, soft_inputs, soft_stats,
                 k4_api_inputs, k5_layers, train_layers, kitti_layers,
                 kitti_train_layers):
    """Per-launch device ms of each kernel and its plain version at the
    paths' shapes, with the bounds."""
    from d3d_tpu_torch.ops import (geometry_cuda, geometry_soa, nms_cuda,
                                   sparse_conv_cuda)

    tb512, ts512 = ns_inputs
    tb2048, ts2048 = k3_inputs
    out = {}

    def k1(b, plain=True):
        """Events and CUPTI ms of one K1 launch on boxes x boxes, the plain
        version's ms, the pairs that ran the chain and both bounds."""
        n = b.shape[0]
        ms = time_launches(lambda: geometry_cuda._launch(b, b))
        row = dict(ms=ms, cupti_ms=cupti_ms(
            lambda: geometry_cuda._launch(b, b), ("rbox_iou",)))
        if plain:
            row["plain_ms"] = time_each(
                lambda: geometry_soa._rbox_iou_matrix_plain(b, b), reps=5,
                warmup=1)
        chains = int((~geometry_cuda._reject_plain(b, b)).sum())
        row["chain_share"] = chains / (n * n)
        row["bound_ms"], row["bound_by"] = k1_bound(n, n, chains)
        row["bound_ms_all_pairs"], _ = k1_bound_all_pairs(n, n)
        return row

    r512, r100 = k1(tb512), k1(tb512[:100])
    r2048 = k1(tb2048, plain=False)
    out["rbox_iou_matrix"] = dict(
        ms=r512["ms"], plain_ms=r512["plain_ms"], bound_ms=r512["bound_ms"],
        bound_by=r512["bound_by"],
        bound_ms_all_pairs=r512["bound_ms_all_pairs"],
        cupti_ms=r512["cupti_ms"], chain_share=r512["chain_share"],
        shape="512x512 (north star)",
        ms_100x100_serving=r100["ms"], cupti_ms_100x100=r100["cupti_ms"],
        plain_ms_100x100=r100["plain_ms"], bound_ms_100x100=r100["bound_ms"],
        bound_ms_all_pairs_100x100=r100["bound_ms_all_pairs"],
        chain_share_100x100=r100["chain_share"],
        ms_2048x2048=r2048["ms"], cupti_ms_2048x2048=r2048["cupti_ms"],
        bound_ms_2048x2048=r2048["bound_ms"],
        bound_ms_all_pairs_2048x2048=r2048["bound_ms_all_pairs"],
        chain_share_2048x2048=r2048["chain_share"])

    # the scan as nms2d runs it (K1's bit rows, the sorted scores, the
    # order) at the serving paths' 100 boxes, the north star's 512 and the
    # 2048 of the K3 path, with K1's two forms and the whole nms2d call
    scans = {"n100": nms_times(tb512[:100], ts512[:100]),
             "n512": nms_times(tb512, ts512), "n2048": nms_times(tb2048,
                                                                ts2048)}
    _, ov512, pre512 = nms_inputs(tb512, ts512, 0.25)
    _, ov2048, pre2048 = nms_inputs(tb2048, ts2048, 0.25)
    for name, key, n, ov, pre in (
            ("nms_scan", "n512", 512, ov512, pre512),
            ("nms_scan_blocked", "n2048", 2048, ov2048, pre2048)):
        row = scans[key]
        b_ms, b_by = scan_bound(n)
        out[name] = dict(
            ms=row["scan_ms"], cupti_ms=row["scan_cupti_ms"],
            plain_ms=time_each(lambda: nms_cuda._nms_scan_plain(ov, pre),
                               reps=5, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            library="none computes greedy NMS",
            shape=f"n={n} (nms2d's route: K1's bit rows, the sorted "
                  "scores, the order)",
            bool_route_ms=time_launches(lambda: nms_cuda._launch(ov, pre)),
            bool_route_cupti_ms=cupti_ms(lambda: nms_cuda._launch(ov, pre)))
    out["nms_scan"]["nms2d_by_size"] = scans
    out["nms_scan"]["ms_n100_serving"] = scans["n100"]["scan_ms"]
    out["nms_scan"]["cupti_ms_n100_serving"] = scans["n100"]["scan_cupti_ms"]
    out["rbox_iou_matrix"]["bits_form"] = {
        k: {f: v[f] for f in ("k1_bits_ms", "k1_bits_cupti_ms",
                              "k1_matrix_ms", "k1_matrix_cupti_ms",
                              "k1_bits_bound_ms")}
        for k, v in scans.items()}

    # K4 at n = 512, linear (the soft-NMS path's first call), gaussian
    # beside it; the cascade takes n minus the suppressed boxes' steps
    # (every step freezes one box)
    iou, init, pre = soft_inputs
    k4 = {}
    for method, param in SOFT_NMS_CASES:
        args = (SOFT_NMS_ARGS["iou_threshold"],
                SOFT_NMS_ARGS["score_threshold"], param, method)
        k4[method] = dict(
            ms=time_launches(lambda: nms_cuda._soft_launch(iou, init, pre,
                                                           *args)),
            cupti_ms=cupti_ms(lambda: nms_cuda._soft_launch(iou, init, pre,
                                                            *args),
                              ("soft_nms",)),
            plain_ms=time_each(lambda: nms_cuda._soft_nms_scan_plain(
                iou, init, pre, *args), reps=3, warmup=1),
            steps=512 - soft_stats[method]["suppressed"])
    lin, gau = k4["linear"], k4["gaussian"]
    b_ms, b_by = k4_bound(512, lin["steps"])
    out["soft_nms_scan"] = dict(
        ms=lin["ms"], plain_ms=lin["plain_ms"], bound_ms=b_ms, bound_by=b_by,
        cupti_ms=lin["cupti_ms"], steps=lin["steps"],
        shape="n=512 (soft_nms2d linear)", ms_gaussian=gau["ms"],
        cupti_ms_gaussian=gau["cupti_ms"], plain_ms_gaussian=gau["plain_ms"],
        steps_gaussian=gau["steps"],
        bound_ms_gaussian=k4_bound(512, gau["steps"])[0])
    out["soft_nms_scan_f64"] = k4_f64_times(k4_api_inputs)
    for row in out.values():
        row["ms_of"] = "one launch"

    # K5: every layer of one SECOND request, f32 (the path checked above)
    # and bf16 (the preset as pinned), and of one training step's forward;
    # a row sums the 8 layers, its bound is that of their summed bytes and
    # operations. The library route, index gather + torch.einsum (cuBLAS),
    # is timed as the plain version; nothing of the port calls it.
    serve = layer_times("subm_conv", k5_layers, "serving")
    train_fwd = layer_times("subm_conv", train_layers, "training forward")
    kitti = layer_times("subm_conv", kitti_layers, "KITTI-like serving")
    rb = rulebook_times(k5_layers, "serving")
    trb = rulebook_times(train_layers, "training")
    f32, bf16 = serve["float32"], serve["bfloat16"]
    out["subm_conv"] = dict(
        ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by=f32["bound_by"], library_ms=f32["plain_ms"],
        library="index gather + torch.einsum (cuBLAS): the plain version",
        shape="the 8 layers of one SECOND request, f32 (sum)",
        ms_of=f"one request ({len(K5_LAYERS)} launches; CUDA events over "
              "back-to-back launches)",
        cupti_ms=f32["cupti_ms"], cupti_of="the same launches' kernel time "
                                           "by CUPTI",
        ms_bf16=bf16["ms"], cupti_ms_bf16=bf16["cupti_ms"],
        plain_ms_bf16=bf16["plain_ms"],
        bound_ms_bf16=bf16["bound_ms"], bound_by_bf16=bf16["bound_by"],
        per_layer=serve["per_layer"],
        rulebook_ms=rb["ms"], rulebook_cupti_ms=rb["cupti_ms"],
        rulebook_of="the 5 maps of one request built together (masks + "
                    "order, one call; the subm_conv_rulebook row)",
        ms_with_rulebook=f32["ms"] + rb["ms"],
        ms_bf16_with_rulebook=bf16["ms"] + rb["ms"],
        cupti_ms_with_rulebook=add_cupti(f32["cupti_ms"], rb["cupti_ms"]),
        cupti_ms_bf16_with_rulebook=add_cupti(bf16["cupti_ms"],
                                              rb["cupti_ms"]),
        training_forward=dict(
            ms=train_fwd["float32"]["ms"],
            cupti_ms=train_fwd["float32"]["cupti_ms"],
            ms_bf16=train_fwd["bfloat16"]["ms"],
            cupti_ms_bf16=train_fwd["bfloat16"]["cupti_ms"],
            bound_ms=train_fwd["float32"]["bound_ms"],
            bound_ms_bf16=train_fwd["bfloat16"]["bound_ms"],
            plain_ms=train_fwd["float32"]["plain_ms"],
            rulebook_ms=trb["ms"], rulebook_cupti_ms=trb["cupti_ms"],
            rulebook_pairs_ms=trb["pairs_ms"],
            rulebook_pairs_cupti_ms=trb["pairs_cupti_ms"],
            rulebook_pairs_per_map=trb["pairs_per_map"],
            per_layer=train_fwd["per_layer"],
            of="the 8 forward launches of one training step (2 frames)"),
        kitti_like=dict(
            ms=kitti["float32"]["ms"], cupti_ms=kitti["float32"]["cupti_ms"],
            ms_bf16=kitti["bfloat16"]["ms"],
            cupti_ms_bf16=kitti["bfloat16"]["cupti_ms"],
            bound_ms=kitti["float32"]["bound_ms"],
            plain_ms=kitti["float32"]["plain_ms"],
            per_layer=kitti["per_layer"],
            of="the 8 layers of one request on the KITTI-like frame"))
    out["subm_conv"].update(train_layers_k5_backward_times(train_layers))
    dw = layer_times("subm_conv_dw", train_layers, "training")
    dw_kitti = layer_times("subm_conv_dw", kitti_train_layers,
                           "KITTI-like training")
    f32, bf16 = dw["float32"], dw["bfloat16"]
    out["subm_conv_dw"] = dict(
        ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by=f32["bound_by"], library_ms=f32["plain_ms"],
        library="index gather + torch.einsum (cuBLAS): the plain version",
        shape="the 8 layers of one SECOND training step, 2 frames, f32 "
              "(sum)",
        ms_of=f"one training step ({len(K5_LAYERS)} launches; CUDA events "
              "over back-to-back launches)",
        cupti_ms=f32["cupti_ms"], cupti_of="the same launches' kernel time "
                                           "by CUPTI",
        ms_bf16=bf16["ms"], cupti_ms_bf16=bf16["cupti_ms"],
        plain_ms_bf16=bf16["plain_ms"],
        bound_ms_bf16=bf16["bound_ms"], bound_by_bf16=bf16["bound_by"],
        per_layer=dw["per_layer"],
        rulebook_pairs_ms=trb["pairs_ms"],
        rulebook_pairs_cupti_ms=trb["pairs_cupti_ms"],
        rulebook_pairs_of="K6's lists of the 5 maps of one training step",
        kitti_like=dict(
            ms=dw_kitti["float32"]["ms"],
            cupti_ms=dw_kitti["float32"]["cupti_ms"],
            ms_bf16=dw_kitti["bfloat16"]["ms"],
            cupti_ms_bf16=dw_kitti["bfloat16"]["cupti_ms"],
            bound_ms=dw_kitti["float32"]["bound_ms"],
            plain_ms=dw_kitti["float32"]["plain_ms"],
            per_layer=dw_kitti["per_layer"],
            of="the 8 layers of one training step on 2 KITTI-like frames"))
    out["subm_conv_rulebook"] = dict(
        ms=rb["ms"], plain_ms=rb["plain_ms"], bound_ms=rb["bound_ms"],
        bound_by=rb["bound_by"], library_ms=rb["library_cupti_ms"],
        library="torch.sort(masks, stable=True), one call a map, summed, "
                "kernel time by CUPTI (the sort's part; the masks are "
                "extra)",
        library_events_ms=rb["library_events_ms"],
        shape=f"the 5 maps of one SECOND request (Nq "
              f"{list(rb['maps'].values())})",
        ms_of="one request's rule books, one call (CUDA events over "
              "back-to-back builds)",
        one_build_ms=rb["one_build_ms"], cupti_ms=rb["cupti_ms"],
        kernels_a_build=rb["kernels_a_build"],
        plain_cupti_ms=rb["plain_cupti_ms"],
        note="K5's rule-book build (csrc/subm_conv.cu rulebook_kernel, one "
             "cooperative launch a call at these sizes): "
             "part of K5's port; the Pallas kernel at sparse_conv_pallas.py"
             ":118 walks every offset and has no rule book",
        training=dict(ms=trb["ms"], one_build_ms=trb["one_build_ms"],
                      cupti_ms=trb["cupti_ms"],
                      kernels_a_build=trb["kernels_a_build"],
                      library_cupti_ms=trb["library_cupti_ms"],
                      plain_ms=trb["plain_ms"],
                      bound_ms=trb["bound_ms"],
                      of=f"the 5 joined maps of one training step (Nq "
                         f"{list(trb['maps'].values())})"))
    for name, row in out.items():
        log(f"{name}: {row['ms']:.4f} ms for {row['ms_of']} at "
            f"{row['shape']}, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.5f} ms "
            f"({row['bound_by']})")
    k5 = out["subm_conv"]
    log(f"subm_conv + the request's rule books, CUDA events: f32 "
        f"{k5['ms_with_rulebook']:.4f} ms, bf16 "
        f"{k5['ms_bf16_with_rulebook']:.4f} ms ({k5['rulebook_ms']:.4f} ms "
        f"of rule books for {k5['rulebook_of']}); kernel time by CUPTI: "
        f"f32 {fmt_ms(k5['cupti_ms_with_rulebook'])}, bf16 "
        f"{fmt_ms(k5['cupti_ms_bf16_with_rulebook'])}")
    return out


def k4_f64_times(k4_api_inputs):
    """K4's float64 entry point beside its float32 one on box2d_nms's
    rotated soft-NMS inputs (linear, p = 1) at n = 512 (float64 rows staged
    in shared memory) and 4096 (read from L2): CUDA events over
    back-to-back launches, CUPTI, the plain cascade on the card, and the
    bound of this run's steps with 8-byte values."""
    from d3d_tpu_torch.ops import nms_cuda

    args = (SOFT_NMS_ARGS["iou_threshold"], SOFT_NMS_ARGS["score_threshold"],
            1.0, "linear")
    rows = {}
    for n in NMS_SIZES:
        for dt in (torch.float32, torch.float64):
            iou, init, pre = k4_api_inputs[n, dt]

            def launch():
                return nms_cuda._soft_launch(iou, init, pre, *args)

            steps = n - int(launch().sum())
            b_ms, b_by = k4_bound(n, steps, iou.element_size())
            rows[n, dt] = dict(
                ms=time_launches(launch, batch=20, batches=5),
                cupti_ms=cupti_ms(launch, ("soft_nms",)),
                plain_ms=time_each(lambda: nms_cuda._soft_nms_scan_plain(
                    iou, init, pre, *args), reps=1, warmup=0),
                steps=steps, bound_ms=b_ms, bound_by=b_by)
            r = rows[n, dt]
            log(f"K4 {str(dt)[6:]} n={n} ({steps} steps): {r['ms']:.4f} ms "
                f"a launch (CUDA events; CUPTI {fmt_ms(r['cupti_ms'])}), "
                f"plain {r['plain_ms']:.1f} ms, bound {b_ms:.6f} ms "
                f"({b_by})")
    f64, f32 = torch.float64, torch.float32
    small, big = (rows[n, f64] for n in NMS_SIZES)
    return dict(
        ms=small["ms"], plain_ms=small["plain_ms"],
        bound_ms=small["bound_ms"], bound_by=small["bound_by"],
        cupti_ms=small["cupti_ms"], steps=small["steps"], library_ms=None,
        library="none computes soft-NMS",
        shape=f"n={NMS_SIZES[0]} float64 (box2d_nms rbox linear, "
              "precise=True; rows staged in shared memory)",
        ms_f32=rows[NMS_SIZES[0], f32]["ms"],
        cupti_ms_f32=rows[NMS_SIZES[0], f32]["cupti_ms"],
        ms_big=big["ms"], cupti_ms_big=big["cupti_ms"],
        plain_ms_big=big["plain_ms"], bound_ms_big=big["bound_ms"],
        steps_big=big["steps"], ms_f32_big=rows[NMS_SIZES[1], f32]["ms"],
        cupti_ms_f32_big=rows[NMS_SIZES[1], f32]["cupti_ms"],
        shape_big=f"n={NMS_SIZES[1]} float64 (rows read from L2)")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "d3d_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no d3d_tpu_torch package beside {__file__}; run "
              "it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    card = card_line()
    print(card, flush=True)

    build_kernels()
    k1_err, k1_shares = check_k1(dev)
    k1_bits_err, k1_bits_shares = check_k1_bits(dev)
    scan_err, scan_routes = check_scans(dev)
    k4_err, k4_routes, k4_wide = check_k4(dev)
    epilogue = check_epilogue(dev)
    check_nan_voxels(dev)
    second, second_frames = second_model(dev)
    k5_layers = second_layer_inputs(second, second_frames[0], dev)
    k5_err, k5_shapes = check_k5(k5_layers)
    state = {k: v.clone() for k, v in second.state_dict().items()}
    batch = train_batch(dev, second.cfg, [bench_points(
        np.random.default_rng(300 + i)) for i in range(2)])
    train_layers = stage_layer_inputs(second, batch["features"],
                                      batch["coords"], batch["valid"])
    k6_err, k6_shapes = check_k6(train_layers)
    wide_layers = wide_kernel_layers(second, second_frames[0], dev)
    wide_k5_err, wide_k5_shapes = check_k5(wide_layers, None, "K > 31")
    wide_k6_err, wide_k6_shapes = check_k6(wide_layers, "K > 31")
    k5_bwd_err = check_k5_backward(train_layers)
    edge_err = check_edge_maps(dev)
    check_sync_free(dev, second, batch)
    kitti_layers = second_layer_inputs(second, kitti_like_points(500), dev)
    kitti_k5_err, kitti_shapes = check_k5(kitti_layers, None, "KITTI-like")
    kitti_batch = train_batch(dev, second.cfg, [kitti_like_points(500),
                                                kitti_like_points(501)])
    kitti_train_layers = stage_layer_inputs(
        second, kitti_batch["features"], kitti_batch["coords"],
        kitti_batch["valid"])
    kitti_k6_err, kitti_k6_shapes = check_k6(kitti_train_layers, "KITTI-like")
    kitti_bwd_err = check_k5_backward(kitti_train_layers, "KITTI-like")
    vn = voxelnext_setup(dev)
    vn_k5_err, vn_shapes = check_k5(vn["layers"], None, "VoxelNeXt")
    vn_k6_err, vn_k6_shapes = check_k6(vn["train_layers"], "VoxelNeXt")
    vn_bwd_err = check_k5_backward(vn["train_layers"], "VoxelNeXt")
    edge_rng = np.random.default_rng(11)
    rb_err, rb_routes = check_rulebooks({
        "serving": distinct_maps(k5_layers)[1],
        "training": distinct_maps(train_layers)[1],
        "KITTI-like serving": distinct_maps(kitti_layers)[1],
        "KITTI-like training": distinct_maps(kitti_train_layers)[1],
        "VoxelNeXt serving": distinct_maps(vn["layers"])[1],
        "VoxelNeXt training": distinct_maps(vn["train_layers"])[1],
        "edge maps": [edge_map(edge_rng, kind, dev)[0]
                      for kind in EDGE_CASES],
        **{f"{name[1:]} offsets": [rules.nbr] for name, (_, rules, _, _)
           in wide_layers.items()},
        **sort_edge_maps(dev)})
    stage_maps = check_stage_maps(dev)

    serve_counts, serve, pp_detect = serving(dev)
    ns_counts, ns, ns_inputs = north_star(dev)
    k3_counts, tb2048, ts2048 = k3_path(dev)
    second_counts, second_stats = second_serving(dev, second, second_frames)
    soft_counts, soft_stats, soft_inputs = soft_nms_path(dev)
    check_k1_grad_guard(dev)
    vox_counts, vox_stats = voxel_generator_path(dev)
    iou_counts, iou_stats = box_iou_path(dev)
    nms_counts, nms_stats, k4_api_inputs = box_nms_path(dev)
    crop_counts, crop_stats = crop_path(dev)
    api_counts = {}
    for c in (vox_counts, iou_counts, nms_counts, crop_counts):
        add_counts(api_counts, c)
    kitti_counts, kitti_stats = kitti_eval(dev, second, pp_detect)
    kitti_stats["val_scale"] = eval_at_scale(dev)
    pp_counts, pp_stats = pointpillars_train(dev)
    vn_counts, vn_stats = voxelnext_track(dev, vn, second)
    nte_counts, nte_stats = nuscenes_track_eval(dev, vn)
    cp_counts, cp_stats = centerpoint_track(dev, vn)
    mono_counts, mono_stats = mono3d_eval(dev)
    bev_counts, bev_stats, bev_frames = bevseg_kitti360(dev)
    sst_counts, sst_stats, sst_detect, sst_frames = sst_kitti(dev)
    export_counts, export_stats = export_phase(dev, sst_detect, sst_frames,
                                               vn)
    par_counts, par_stats = parallel_phase(
        dev, pp_detect, [bench_points(np.random.default_rng(100 + i))
                         for i in range(4)], state, batch, bev_frames, vn)
    del bev_frames
    ds_counts, ds_stats = datasets_phase(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    train_counts, train_stats = {}, {}
    for dtype in ("float32", "bfloat16"):
        counts, train_stats[dtype] = second_training(dev, state, batch, dtype)
        for k, v in counts.items():
            train_counts[k] = train_counts.get(k, 0) + v
    train_stats["card_vs_cpu_grad_err"] = train_card_vs_cpu(dev, state,
                                                            batch)
    ex_counts, ex_stats = examples_phase(dev)
    dr_counts, dr_stats = dryrun_phase(dev)
    times = kernel_times(dev, ns_inputs, (tb2048, ts2048), soft_inputs,
                         soft_stats, k4_api_inputs, k5_layers, train_layers,
                         kitti_layers, kitti_train_layers)
    wide_times = {k: layer_times(k, wide_layers, "K > 31")["per_layer"]
                  for k in ("subm_conv", "subm_conv_dw")}

    by_path = {name: {"serving": serve_counts[name],
                      "north_star": ns_counts[name],
                      "nms2d_2048": k3_counts[name],
                      "second_serving": second_counts[name],
                      "soft_nms": soft_counts[name],
                      "second_training": train_counts[name],
                      "box_api": api_counts[name],
                      "kitti_eval": kitti_counts[name],
                      "pointpillars_train": pp_counts[name],
                      **{path: c[name] for path, c in vn_counts.items()},
                      "nuscenes_track_eval": nte_counts[name],
                      **{path: c[name] for path, c in cp_counts.items()},
                      "sst_kitti": sum(c[name] for c in sst_counts.values()),
                      "export": sum(c[name] for c in export_counts.values()),
                      "parallel": sum(c[name] for c in par_counts.values()),
                      **{path: c[name] for path, c in ds_counts.items()},
                      "examples": ex_counts[name],
                      "dryrun": dr_counts[name]}
               for name in serve_counts}
    meta = {
        "rbox_iou_matrix": ("cuda", "d3d_tpu_torch/csrc/rbox_iou.cu",
                            "d3d_tpu/ops/geometry_pallas.py:177", k1_err),
        "nms_scan": ("cuda", "d3d_tpu_torch/csrc/nms_scan.cu",
                     "d3d_tpu/ops/nms_pallas.py:67",
                     float(scan_err["nms_scan"])),
        "nms_scan_blocked": ("cuda", "d3d_tpu_torch/csrc/nms_scan.cu",
                             "d3d_tpu/ops/nms_pallas.py:137",
                             float(scan_err["nms_scan_blocked"])),
        "soft_nms_scan": ("cuda", "d3d_tpu_torch/csrc/soft_nms.cu",
                          "d3d_tpu/ops/nms_pallas.py:222", float(k4_err)),
        "soft_nms_scan_f64": ("cuda", "d3d_tpu_torch/csrc/soft_nms.cu",
                              "d3d_tpu/ops/nms_pallas.py:222",
                              float(k4_err)),
        "subm_conv": ("cuda", "d3d_tpu_torch/csrc/subm_conv.cu",
                      "d3d_tpu/ops/sparse_conv_pallas.py:118",
                      k5_err["float32"]),
        "subm_conv_dw": ("cuda", "d3d_tpu_torch/csrc/subm_conv_dw.cu",
                         "d3d_tpu/ops/sparse_conv_pallas.py:139",
                         k6_err["float32"]),
        "subm_conv_rulebook": ("cuda", "d3d_tpu_torch/csrc/subm_conv.cu",
                               "d3d_tpu/ops/sparse_conv_pallas.py:118",
                               rb_err),
    }
    kernels = []
    for name, (route, source, replaces, err) in meta.items():
        launches = sum(by_path[name].values())
        check(launches > 0, f"{name} was never launched on a path")
        row = times[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches, max_abs_err=err, ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row.get("library_ms"),
            shape=row["shape"], launches_by_path=by_path[name],
            **{k: v for k, v in row.items()
               if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "shape")}))
    kernels.append(dict(
        name="bn_relu", route="cuda",
        source="d3d_tpu_torch/csrc/bn_relu.cu", replaces=None,
        launches=serve["epilogue_launches"], max_abs_err=0.0,
        bound_by="bytes", launches_by_path={
            "serving": serve["epilogue_launches"]},
        launches_in_checks=epilogue["checks"], **epilogue["frame"],
        shape="a PointPillars frame's 17 maps", maps=epilogue["maps"]))
    launches = sum(by_path["build_stage_maps"].values())
    check(launches > 0, "build_stage_maps was never launched on a path")
    kernels.append(dict(
        name="build_stage_maps", route="cuda",
        source="d3d_tpu_torch/csrc/stage_maps.cu", replaces=None,
        launches=launches, max_abs_err=0.0,
        launches_by_path=by_path["build_stage_maps"], **stage_maps))
    rows = {row["name"]: row for row in kernels}
    rows["rbox_iou_matrix"]["chain_share_by_check"] = k1_shares
    rows["rbox_iou_matrix"].update(max_abs_err_bits=k1_bits_err,
                                   chain_share_bits_by_size=k1_bits_shares,
                                   augment_32x32=pp_stats["k1_f32_32x32"])
    for name in ("nms_scan", "nms_scan_blocked"):
        rows[name]["launches_by_route_in_checks"] = scan_routes
    rows["subm_conv_rulebook"]["builds_by_route_in_checks"] = rb_routes
    rows["soft_nms_scan"]["launches_by_route_in_checks"] = k4_routes
    rows["soft_nms_scan_f64"]["launches_by_route_in_checks"] = k4_routes
    rows["soft_nms_scan"]["global_state_16384"] = k4_wide["float32"]
    rows["soft_nms_scan_f64"]["global_state_16384"] = k4_wide["float64"]
    for name, row in k4_wide["above_32768"].items():
        rows["soft_nms_scan_f64" if name.endswith("float64")
             else "soft_nms_scan"][f"wide_lanes_{name}"] = row
    rows["subm_conv"].update(
        max_abs_err_bf16=k5_err["bfloat16"], layer_shapes=k5_shapes,
        max_abs_err_backward=k5_bwd_err,
        max_abs_err_edge_maps=edge_err["subm_conv"],
        max_abs_err_kitti_like=kitti_k5_err,
        max_abs_err_backward_kitti_like=kitti_bwd_err,
        layer_shapes_kitti_like=kitti_shapes,
        max_abs_err_voxelnext=vn_k5_err,
        max_abs_err_backward_voxelnext=vn_bwd_err,
        layer_shapes_voxelnext=vn_shapes, bit_equal_across_runs=True,
        max_abs_err_k_above_31=wide_k5_err,
        layer_shapes_k_above_31=wide_k5_shapes,
        times_k_above_31=wide_times["subm_conv"])
    rows["subm_conv_dw"].update(
        max_abs_err_k_above_31=wide_k6_err,
        layer_shapes_k_above_31=wide_k6_shapes,
        times_k_above_31=wide_times["subm_conv_dw"])
    rows["subm_conv_dw"].update(
        max_abs_err_bf16=k6_err["bfloat16"], layer_shapes=k6_shapes,
        max_abs_err_edge_maps=edge_err["subm_conv_dw"],
        max_abs_err_kitti_like=kitti_k6_err,
        layer_shapes_kitti_like=kitti_k6_shapes,
        max_abs_err_voxelnext=vn_k6_err, layer_shapes_voxelnext=vn_k6_shapes,
        bit_equal_across_runs=True)
    log(json.dumps({"paths": {"serving": serve, "north_star": ns,
                              "second_serving": second_stats,
                              "soft_nms": soft_stats,
                              "second_training": train_stats,
                              "box_api": {"VoxelGenerator": vox_stats,
                                          "box2d_iou": iou_stats,
                                          "box2d_nms": nms_stats,
                                          "crops": crop_stats},
                              "kitti_eval": kitti_stats,
                              "pointpillars_train": pp_stats,
                              "voxelnext_track": vn_stats,
                              "nuscenes_track_eval": nte_stats,
                              "centerpoint_track": cp_stats,
                              "mono3d_eval": dict(mono_stats,
                                                  launches=mono_counts),
                              "bevseg_kitti360": dict(bev_stats,
                                                      launches=bev_counts),
                              "sst_kitti": dict(sst_stats,
                                                launches=sst_counts),
                              "export": dict(export_stats,
                                             launches=export_counts),
                              "parallel": dict(par_stats,
                                               launches=par_counts),
                              "datasets": dict(ds_stats,
                                               launches=ds_counts),
                              "examples": ex_stats,
                              "dryrun": dict(dr_stats,
                                             launches=dr_counts)},
                    "card": card}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch/CUDA port (``d3d_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout::

    python3 chip_smoke.py

It needs CUDA, the checkout's ``d3d_tpu_torch`` package and ``nvcc``; it
imports no JAX and nothing of ``d3d_tpu``. In order, it

1. builds the CUDA kernels from ``d3d_tpu_torch/csrc`` into
   ``build/d3d_tpu_torch/`` (one ``nvcc`` per source, in parallel);
2. holds each kernel against its plain PyTorch version on the card:
   K1 (rotated IoU matrix) to atol 2e-5, K2/K3 (greedy NMS scan) and K4
   (soft-NMS cascade, linear and gaussian, n = 100 to 2048) exactly, K5
   (sparse-conv gather-GEMM) at every layer shape of SECOND serving, in
   f32 and bf16, at the tolerances stated in ``check_k5``;
3. drives the port's paths with every launch count set to 0 just before
   and read just after: PointPillars serving (``make_pointpillars_detector``
   on the KITTI preset at full width, random seeded weights, 4 requests of
   different 120k-point frames), the north-star frame of ``bench.py``
   (``voxelize_mean_fm`` + ``nms2d`` of 512 boxes), ``nms2d`` of 2048
   boxes (K3), SECOND serving (``make_second_detector`` on
   ``presets.second_kitti`` at full width, 4 requests) and ``soft_nms2d``
   of the north star's 512 boxes (K4); each path must launch its kernels;
4. checks the outputs: finite, of the expected shape, the keep masks equal
   to the plain scans on the kernels' own IoU matrices, the voxelizer
   equal to the port's CPU run, and both serving paths' outputs equal to a
   CPU run of the same weights at a stated tolerance (TF32 off);
5. times the kernels, their plain versions and the paths with CUDA events.

Any failed check raises, and the run exits nonzero. The second-to-last
line is ``{"kernels": [...]}``, the last ``{"ok": true, "device": ...}``.
"""

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

# f32 operations of K4 per box and serial step, counted from
# csrc/soft_nms.cu (each compare, select, logic op and arithmetic op counts
# 1): availability 2, masked score 1, (max, min index) compare 3, overlap
# test and mask 3, linear decay 5 (max, log, mul, exp, sub), decayed score
# 2, dead test 2, suppressed or 1, frozen compare and or 2
K4_OPS_PER_BOX_STEP = 21

# the SECOND serving path's K5 launches in order (presets.second_kitti)
K5_LAYERS = ("subm0_0", "subm0_1", "down0", "subm1_0", "subm1_1", "down1",
             "subm2_0", "subm2_1")

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


def log(msg):
    print(msg, flush=True)


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


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """(least ms on the card, what bounds it) for this many bytes moved
    once and operations at ``ops_per_s`` (default: f32 outside the tensor
    cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(n, m):
    # descriptors (10 f32 per box) in, the (n, m) f32 matrix out
    return bound((n + m) * 10 * 4 + n * m * 4, n * m * K1_OPS_PER_PAIR)


def scan_bound(n):
    # (n, n) bool overlap and (n,) pre in, (n,) bool out; one test per pair
    return bound(n * n + 2 * n, n * n)


def k4_bound(n, steps):
    # the steps this run's data takes (the kernel stops when no box is
    # left): each reads the pick's row of the f32 IoU matrix and works on
    # all n boxes; (n,) f32 scores and (n,) bool pre in, (n,) bool out
    return bound(steps * n * 4 + n * 6, steps * n * K4_OPS_PER_BOX_STEP)


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


def check_k1(dev):
    """K1 against the plain version on the card; returns the max error."""
    from d3d_tpu_torch.ops import geometry_cuda, geometry_soa

    rng = np.random.default_rng(0)
    _, boxes512, _ = north_star_frame()
    b37 = np.stack([rng.random(37) * 20, rng.random(37) * 20,
                    rng.random(37) * 6 + 1, rng.random(37) * 6 + 1,
                    rng.random(37) * 6 - 3], axis=1).astype(np.float32)
    b155 = np.concatenate([b37[:5], bench_boxes(rng, 150)[0]])
    cases = {"512x512": (boxes512, boxes512),
             "100x100": (boxes512[:100], boxes512[:100]),
             "37x155": (b37, b155),
             "adversarial": (ADVERSARIAL[:, 0], ADVERSARIAL[:, 1])}
    worst = 0.0
    for name, (a, b) in cases.items():
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        got = geometry_cuda.rbox_iou_matrix(ta, tb)
        want = geometry_soa._rbox_iou_matrix_plain(ta, tb)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"K1 {name}: shape {got.shape}")
        check(bool(torch.isfinite(got).all()), f"K1 {name}: not finite")
        err = float((got - want).abs().max())
        log(f"K1 {name}: max |kernel - plain| = {err:.3g} (atol 2e-5)")
        check(err <= 2e-5, f"K1 {name}: error {err} > 2e-5")
        if name != "adversarial":
            diag = torch.diagonal(got[:5, :5])
            check(bool(((diag - 1).abs() <= 1e-4).all()),
                  f"K1 {name}: diagonal {diag.tolist()}")
        worst = max(worst, err)
    return worst


def random_overlap(rng, n, dev):
    ov = rng.random((n, n)) < 0.07
    ov = ov | ov.T
    pre = rng.random(n) < 0.1
    return (torch.from_numpy(ov).to(dev), torch.from_numpy(pre).to(dev))


def check_scans(dev):
    """K2/K3 against the plain scan on the card; returns mismatch counts."""
    from d3d_tpu_torch.ops import nms_cuda

    rng = np.random.default_rng(1)
    worst = {"nms_scan": 0, "nms_scan_blocked": 0}
    for scan, sizes in ((nms_cuda.nms_scan, (100, 160, 512, 1000)),
                        (nms_cuda.nms_scan_blocked, (1025, 2048, 4096))):
        for n in sizes:
            ov, pre = random_overlap(rng, n, dev)
            got = scan(ov, pre)
            want = nms_cuda._nms_scan_plain(ov, pre)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            log(f"{scan.__name__} n={n}: {bad} of {n} differ from the plain "
                f"scan, {int((~got).sum())} kept")
            check(bad == 0, f"{scan.__name__} n={n}: {bad} mismatches")
            worst[scan.__name__] = max(worst[scan.__name__], bad)
    return worst


def check_k4(dev):
    """K4 against the plain cascade on the card, both methods, on K1's IoU
    matrices of bench boxes; masks must be equal. Returns the mismatches."""
    from d3d_tpu_torch.ops import geometry_cuda, nms_cuda
    from d3d_tpu_torch.ops.nms import _soft_nms_init

    rng = np.random.default_rng(3)
    worst = 0
    for n in (100, 512, 1000, 2048):
        boxes, scores = bench_boxes(rng, n)
        tb = torch.from_numpy(boxes).to(dev)
        ts = torch.from_numpy(scores).to(dev)
        iou = geometry_cuda.rbox_iou_matrix(tb, tb)
        thr = SOFT_NMS_ARGS["score_threshold"]
        pre, init = _soft_nms_init(ts, thr)
        for method, param in SOFT_NMS_CASES:
            args = (SOFT_NMS_ARGS["iou_threshold"], thr, param, method)
            got = nms_cuda._soft_launch(iou, init, pre, *args)
            want = nms_cuda._soft_nms_scan_plain(iou, init, pre, *args)
            torch.cuda.synchronize()
            bad = int((got != want).sum())
            log(f"soft_nms_scan {method} n={n}: {bad} of {n} differ from the "
                f"plain cascade, {int(got.sum())} suppressed")
            check(bad == 0, f"soft_nms_scan {method} n={n}: {bad} mismatches")
            worst = max(worst, bad)
    return worst


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
    from d3d_tpu_torch.models import second_voxelize, sparse_stage_loop

    seen = {}

    def recording(name, layer):
        def run(x, nbr, valid):
            seen[name] = (x, nbr, valid, layer.weight.detach())
            return layer(x, nbr, valid)
        return run

    with torch.inference_mode():
        f, c, v = second_voxelize(torch.from_numpy(pts).to(dev), model.cfg)
        sparse_stage_loop(model.cfg, {n: recording(n, l)
                                      for n, l in model.middle.items()},
                          f, c, v)
    check(tuple(seen) == K5_LAYERS, f"SECOND layers {tuple(seen)}")
    return seen


def check_k5(layers):
    """K5 against its plain version on the card at every layer shape of the
    SECOND path, in f32 and bf16. Stated tolerance, elementwise: 1e-5 of the
    output's sum of |terms| (the two sum in other orders), plus in bf16 one
    bf16 ulp of the value (2^-7 relative: the two f32 sums may round to
    neighbouring bf16 values). Returns the largest |kernel - plain| per
    dtype and the shapes."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    # presets.second_kitti on a 120k-point frame: the voxel cap (16000 of
    # ~117k occupied cells) and the first site cap (8000 of ~13.8k) bind;
    # the last (4000) does not: ~3250 sites stay, the rest is padding
    want_shapes = {
        "subm0_0": (16000, 16000, 4, 16), "subm0_1": (16000, 16000, 16, 16),
        "down0": (8000, 16000, 16, 32), "subm1_0": (8000, 8000, 32, 32),
        "subm1_1": (8000, 8000, 32, 32), "down1": (4000, 8000, 32, 64),
        "subm2_0": (4000, 4000, 64, 64), "subm2_1": (4000, 4000, 64, 64)}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    shapes = {}
    for name, (x, nbr, valid, w) in layers.items():
        shape = (nbr.shape[0], x.shape[0], x.shape[1], w.shape[2])
        nvalid = int(valid.sum())
        binds = name not in ("down1", "subm2_0", "subm2_1")
        check(shape == want_shapes[name]
              and (nvalid == shape[0] if binds else 0 < nvalid < shape[0]),
              f"K5 {name}: shape (Nq, N, C, Cout) {shape}, {nvalid} valid")
        present = int((nbr >= 0).sum())
        shapes[name] = dict(nq=shape[0], n=shape[1], c=shape[2],
                            cout=shape[3], valid=nvalid, present=present)
        scale = K._subm_conv_plain(x.float().abs(), nbr, w.float().abs(),
                                   valid)
        errs = []
        for dt in (torch.float32, torch.bfloat16):
            xd, wd = x.to(dt), w.to(dt)
            got = K._launch(xd, nbr, wd, valid)
            want = K._subm_conv_plain(xd, nbr, wd, valid)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dt,
                  f"K5 {name} {dt}: {got.shape} {got.dtype}")
            got, want = got.float(), want.float()
            check(bool(torch.isfinite(got).all()), f"K5 {name}: not finite")
            err = (got - want).abs()
            tol = 1e-5 * scale
            if dt == torch.bfloat16:
                tol = tol + 2.0 ** -7 * want.abs()
            bad = int((err > tol).sum())
            check(bad == 0, f"K5 {name} {dt}: {bad} outputs out of tolerance,"
                            f" max error {float(err.max())}")
            key = str(dt).split(".")[1]
            worst[key] = max(worst[key], float(err.max()))
            errs.append(float(err.max()))
        log(f"K5 {name} (Nq {shape[0]} with {nvalid} valid, N {shape[1]}, "
            f"C {shape[2]}, Cout {shape[3]}, {present} of {shape[0] * 27} "
            f"neighbours present): "
            f"max |kernel - plain| f32 {errs[0]:.3g}, bf16 {errs[1]:.3g}")
    return worst, shapes


def counters():
    from d3d_tpu_torch.ops import geometry_cuda, nms_cuda, sparse_conv_cuda

    return (geometry_cuda.rbox_iou_matrix, nms_cuda.nms_scan,
            nms_cuda.nms_scan_blocked, nms_cuda.soft_nms_scan,
            sparse_conv_cuda.subm_conv)


def reset_counts():
    for fn in counters():
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in counters()}


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
    _, overlap, pre = nms_inputs(tb, ts, 0.25)
    return counts, dict(ms=ms, wall_ms=wall, kept=int(keep.sum()),
                        voxels=nv), (tb, overlap, pre)


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


def calibrate_heads(model, pts, dev, voxelize=None, occupied_only=False):
    """Rescale the random heads so their outputs on one frame spread like a
    trained model's (class logits sd 2, box residuals sd 0.3, direction
    logits sd 1). Raw lidar coordinates through random weights give
    outputs far from that: saturated scores and boxes of e^20 m. With
    ``occupied_only`` the spread is taken over the anchors whose outputs
    are not exactly 0 (the biases are 0): SECOND's site caps leave most of
    its BEV map empty, and cells that no point reaches say nothing of the
    scale."""
    heads = (model.head_cls, model.head_box, model.head_dir)
    for head, out, sd in zip(heads, forward(model, pts, dev, voxelize),
                             (2.0, 0.3, 1.0)):
        spread = out[out != 0] if occupied_only else out
        with torch.no_grad():
            head.weight.mul_(sd / float(spread.std()))


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
    raw_gpu = [o.cpu() for o in forward(model, frame, dev, voxelize)]
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
    best = torch.sigmoid(raw_gpu[0][0]).max(dim=-1).values
    idx = torch.sort(best, descending=True, stable=True).indices[:100]
    anchors_cpu = anchors.cpu()
    boxes_g, scores_g = decode_at(raw_gpu, anchors_cpu, idx)
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


def serving(dev):
    """make_pointpillars_detector on the KITTI preset at full width with
    seeded random weights: 4 requests, then the CPU comparison and the
    bf16 preset as pinned."""
    from d3d_tpu_torch.models import (PointPillars, make_anchors,
                                      make_pointpillars_detector, presets)

    cfg = presets.pointpillars_kitti(dtype="float32")
    frames = [bench_points(np.random.default_rng(100 + i)) for i in range(4)]
    model = PointPillars(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0))
    calibrate_heads(model, frames[0], dev)
    anchors = make_anchors(cfg, device=dev)
    detect = make_pointpillars_detector(model, None, cfg, anchors, ["Car"],
                                        device=dev)

    reset_counts()
    request_ms = []
    kept = []
    for pts in frames:
        t0 = time.perf_counter()
        out = detect(pts)
        request_ms.append((time.perf_counter() - t0) * 1e3)
        k = len(out.scores)
        kept.append(k)
        check(out.positions.shape == (k, 3) and out.dimensions.shape == (k, 3)
              and out.yaws.shape == (k,) and out.labels.shape == (k,),
              "detect: column shapes")
        check(all(np.isfinite(out[c]).all() for c in
                  ("positions", "dimensions", "yaws", "scores")),
              "detect: non-finite output")
        check(bool((out.scores >= 0.3).all()), "detect: score threshold")
    counts = read_counts()
    log(f"serving launches (4 requests): {counts}; detections kept per "
        f"request: {kept}")
    check(counts["rbox_iou_matrix"] == 4 and counts["nms_scan"] == 4,
          f"serving did not run K1 and K2 once per request: {counts}")
    log("serving f32 (PyTorch defaults, TF32 convolutions allowed): "
        + ", ".join(f"{ms:.2f}" for ms in request_ms) + " ms per request")

    no_tf32_ms, cpu_ms = compare_with_cpu(
        "serving", model, PointPillars(cfg, device="cpu"), frames[0], detect,
        anchors, dev)
    cfg16 = presets.pointpillars_kitti()
    model16 = PointPillars(cfg16, device=dev)
    model16.load_state_dict(model.state_dict())
    detect16 = make_pointpillars_detector(
        model16, None, cfg16, make_anchors(cfg16, device=dev), ["Car"],
        device=dev)
    bf16_ms = []
    for pts in frames[:2]:
        t0 = time.perf_counter()
        out = detect16(pts)
        bf16_ms.append((time.perf_counter() - t0) * 1e3)
        check(np.isfinite(out.positions).all(), "bf16 detect: non-finite")
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
                        bf16_ms=bf16_ms, steady_ms=steady, cpu_ms=cpu_ms)


def second_serving(dev, model, frames):
    """make_second_detector on presets.second_kitti at full width: 4
    requests, the CPU comparison, then the f32 and the bf16 preset's
    first and steady request times."""
    from d3d_tpu_torch.models import (SECOND, head_config, make_anchors,
                                      make_second_detector, presets,
                                      second_voxelize)

    cfg = model.cfg
    anchors = make_anchors(head_config(cfg), device=dev)
    detect = make_second_detector(model, None, cfg, anchors, ["Car"],
                                  device=dev)
    reset_counts()
    request_ms, kept = [], []
    for pts in frames:
        t0 = time.perf_counter()
        out = detect(pts)
        request_ms.append((time.perf_counter() - t0) * 1e3)
        k = len(out.scores)
        kept.append(k)
        check(out.positions.shape == (k, 3) and out.dimensions.shape == (k, 3)
              and out.yaws.shape == (k,) and out.labels.shape == (k,),
              "SECOND detect: column shapes")
        check(all(np.isfinite(out[c]).all() for c in
                  ("positions", "dimensions", "yaws", "scores")),
              "SECOND detect: non-finite output")
        check(bool((out.scores >= 0.3).all()), "SECOND detect: threshold")
    counts = read_counts()
    log(f"SECOND serving launches (4 requests): {counts}; detections kept "
        f"per request: {kept}")
    want = dict(rbox_iou_matrix=4, nms_scan=4, nms_scan_blocked=0,
                soft_nms_scan=0, subm_conv=4 * len(K5_LAYERS))
    check(counts == want, f"SECOND serving: launches {counts}, want {want}: "
                          "8 of K5, 1 of K1 and 1 of K2 per request")
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
        ["Car"], device=dev)
    t0 = time.perf_counter()
    out = detect16(frames[1])
    bf16_first = (time.perf_counter() - t0) * 1e3
    check(np.isfinite(out.positions).all(), "SECOND bf16 detect: non-finite")
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
                         soft_nms_scan=2, subm_conv=0),
          f"soft_nms2d did not run K1 and K4 once per call: {counts}")
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


def kernel_times(dev, ns_inputs, k3_inputs, soft_inputs, soft_stats,
                 k5_layers):
    """Per-launch device ms of each kernel and its plain version at the
    paths' shapes, with the bounds."""
    from d3d_tpu_torch.ops import (geometry_cuda, geometry_soa, nms_cuda,
                                   sparse_conv_cuda)

    tb512, ov512, pre512 = ns_inputs
    tb2048, ts2048 = k3_inputs
    out = {}

    def k1(b):
        d = geometry_cuda.box_descriptors(b).contiguous()
        ms = time_launches(lambda: geometry_cuda._launch(d, d))
        plain = time_each(lambda: geometry_soa._rbox_iou_matrix_plain(b, b),
                          reps=5, warmup=1)
        return ms, plain

    k1_ms, k1_plain = k1(tb512)
    k1_serving_ms, _ = k1(tb512[:100])
    b_ms, b_by = k1_bound(512, 512)
    out["rbox_iou_matrix"] = dict(
        ms=k1_ms, plain_ms=k1_plain, bound_ms=b_ms, bound_by=b_by,
        shape="512x512 (north star)", ms_100x100_serving=k1_serving_ms)

    k2_ms = time_launches(lambda: nms_cuda._launch(ov512, pre512))
    ov100, pre100 = ov512[:100, :100].contiguous(), pre512[:100].contiguous()
    k2_serving_ms = time_launches(lambda: nms_cuda._launch(ov100, pre100))
    k2_plain = time_each(lambda: nms_cuda._nms_scan_plain(ov512, pre512),
                         reps=5, warmup=1)
    b_ms, b_by = scan_bound(512)
    out["nms_scan"] = dict(ms=k2_ms, plain_ms=k2_plain, bound_ms=b_ms,
                           bound_by=b_by, shape="n=512 (north star)",
                           ms_n100_serving=k2_serving_ms)

    _, ov2048, pre2048 = nms_inputs(tb2048, ts2048, 0.25)
    k3_ms = time_launches(lambda: nms_cuda._launch(ov2048, pre2048))
    k3_plain = time_each(lambda: nms_cuda._nms_scan_plain(ov2048, pre2048),
                         reps=5, warmup=1)
    b_ms, b_by = scan_bound(2048)
    out["nms_scan_blocked"] = dict(ms=k3_ms, plain_ms=k3_plain,
                                   bound_ms=b_ms, bound_by=b_by,
                                   shape="n=2048 (nms2d above 1024)")

    # K4 at n = 512, linear (the soft-NMS path's first call); the kernel
    # takes n minus the suppressed boxes' steps (every step freezes one box)
    iou, init, pre = soft_inputs
    method, param = SOFT_NMS_CASES[0]
    args = (SOFT_NMS_ARGS["iou_threshold"], SOFT_NMS_ARGS["score_threshold"],
            param, method)
    k4_ms = time_launches(lambda: nms_cuda._soft_launch(iou, init, pre,
                                                        *args))
    k4_plain = time_each(lambda: nms_cuda._soft_nms_scan_plain(
        iou, init, pre, *args), reps=3, warmup=1)
    steps = 512 - soft_stats[method]["suppressed"]
    b_ms, b_by = k4_bound(512, steps)
    out["soft_nms_scan"] = dict(ms=k4_ms, plain_ms=k4_plain, bound_ms=b_ms,
                                bound_by=b_by, steps=steps,
                                shape=f"n=512 (soft_nms2d {method})")
    for row in out.values():
        row["ms_of"] = "one launch"

    # K5: every layer of one SECOND request, f32 (the path checked above)
    # and bf16 (the preset as pinned); the row sums the 8 layers, its bound
    # is that of their summed bytes and operations
    per_layer = {}
    totals = {}
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).split(".")[1]
        tot = dict(ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
        for name, (x, nbr, valid, w) in k5_layers.items():
            xd, wd = x.to(dt), w.to(dt)
            ms = time_launches(lambda: sparse_conv_cuda._launch(xd, nbr, wd,
                                                                valid),
                               batch=20)
            plain = time_each(lambda: sparse_conv_cuda._subm_conv_plain(
                xd, nbr, wd, valid), reps=5, warmup=1)
            nbytes, ops = k5_work(xd, nbr, w.shape[2])
            b_ms, b_by = bound(nbytes, ops, k5_rate(dt))
            per_layer.setdefault(name, {})[key] = dict(
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
            for k, v in (("ms", ms), ("plain_ms", plain), ("nbytes", nbytes),
                         ("ops", ops)):
                tot[k] += v
            log(f"subm_conv {name} {key}: {ms:.4f} ms per launch, plain "
                f"{plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        tot["bound"] = bound(tot["nbytes"], tot["ops"], k5_rate(dt))
        totals[key] = tot
    f32, bf16 = totals["float32"], totals["bfloat16"]
    out["subm_conv"] = dict(
        ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound"][0],
        bound_by=f32["bound"][1],
        # the library route: index gather + torch.einsum (cuBLAS), timed
        # as the plain version; nothing of the port calls it
        library_ms=f32["plain_ms"],
        library="index gather + torch.einsum (cuBLAS): the plain version",
        shape="the 8 layers of one SECOND request, f32 (sum)",
        ms_of=f"one request ({len(K5_LAYERS)} launches)",
        ms_bf16=bf16["ms"], plain_ms_bf16=bf16["plain_ms"],
        bound_ms_bf16=bf16["bound"][0], bound_by_bf16=bf16["bound"][1],
        per_layer=per_layer)
    for name, row in out.items():
        log(f"{name}: {row['ms']:.4f} ms for {row['ms_of']} at "
            f"{row['shape']}, plain {row['plain_ms']:.3f} ms, bound "
            f"{row['bound_ms']:.5f} ms "
            f"({row['bound_by']})")
    return out


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
    k1_err = check_k1(dev)
    scan_err = check_scans(dev)
    k4_err = check_k4(dev)
    second, second_frames = second_model(dev)
    k5_layers = second_layer_inputs(second, second_frames[0], dev)
    k5_err, k5_shapes = check_k5(k5_layers)

    serve_counts, serve = serving(dev)
    ns_counts, ns, ns_inputs = north_star(dev)
    k3_counts, tb2048, ts2048 = k3_path(dev)
    second_counts, second_stats = second_serving(dev, second, second_frames)
    soft_counts, soft_stats, soft_inputs = soft_nms_path(dev)
    times = kernel_times(dev, ns_inputs, (tb2048, ts2048), soft_inputs,
                         soft_stats, k5_layers)

    by_path = {name: {"serving": serve_counts[name],
                      "north_star": ns_counts[name],
                      "nms2d_2048": k3_counts[name],
                      "second_serving": second_counts[name],
                      "soft_nms": soft_counts[name]}
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
        "subm_conv": ("cuda", "d3d_tpu_torch/csrc/subm_conv.cu",
                      "d3d_tpu/ops/sparse_conv_pallas.py:118",
                      k5_err["float32"]),
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
    kernels[-1]["max_abs_err_bf16"] = k5_err["bfloat16"]
    kernels[-1]["layer_shapes"] = k5_shapes
    log(json.dumps({"paths": {"serving": serve, "north_star": ns,
                              "second_serving": second_stats,
                              "soft_nms": soft_stats},
                    "card": card}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

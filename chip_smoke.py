"""Smoke run of the PyTorch/CUDA port (``d3d_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout::

    python3 chip_smoke.py

It needs CUDA, the checkout's ``d3d_tpu_torch`` package and ``nvcc``; it
imports no JAX and nothing of ``d3d_tpu``. In order, it

1. builds the CUDA kernels from ``d3d_tpu_torch/csrc`` into
   ``build/d3d_tpu_torch/`` (one ``nvcc`` per source, in parallel);
2. holds each kernel against its plain PyTorch version on the card:
   K1 (rotated IoU matrix) to atol 2e-5, K2/K3 (greedy NMS scan) exactly;
3. drives the port's paths with every launch count set to 0 just before
   and read just after: the serving path (``make_pointpillars_detector``
   on the KITTI preset at full width, random seeded weights, 4 requests of
   different 120k-point frames), the north-star frame of ``bench.py``
   (``voxelize_mean_fm`` + ``nms2d`` of 512 boxes) and ``nms2d`` of 2048
   boxes (K3); each path must launch its kernels;
4. checks the outputs: finite, of the expected shape, the keep masks equal
   to the plain scan on the kernel's own overlap matrix, the voxelizer
   equal to the port's CPU run, and the serving outputs equal to a CPU run
   of the same weights at a stated tolerance (TF32 off);
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

# the card's published rates (NVIDIA H100 SXM data sheet): HBM bytes/s and
# dense f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

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


def bound(nbytes, ops):
    """(least ms on the card, what bounds it) for this many bytes moved
    once and f32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(n, m):
    # descriptors (10 f32 per box) in, the (n, m) f32 matrix out
    return bound((n + m) * 10 * 4 + n * m * 4, n * m * K1_OPS_PER_PAIR)


def scan_bound(n):
    # (n, n) bool overlap and (n,) pre in, (n,) bool out; one test per pair
    return bound(n * n + 2 * n, n * n)


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


def counters():
    from d3d_tpu_torch.ops import geometry_cuda, nms_cuda

    return (geometry_cuda.rbox_iou_matrix, nms_cuda.nms_scan,
            nms_cuda.nms_scan_blocked)


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


def forward(model, pts, dev):
    """The network's raw outputs (cls, box, dir) on one frame."""
    from d3d_tpu_torch.models import pillarize

    with torch.inference_mode():
        feats, coords, valid = pillarize(torch.from_numpy(pts).to(dev),
                                         model.cfg)
        return model(feats[None], coords[None], valid[None])


def calibrate_heads(model, pts, dev):
    """Rescale the random heads so their outputs on one frame spread like a
    trained model's (class logits sd 2, box residuals sd 0.3, direction
    logits sd 1). Raw lidar coordinates through random weights give
    outputs ~10x that: saturated scores and boxes of e^20 m."""
    heads = (model.head_cls, model.head_box, model.head_dir)
    for head, out, sd in zip(heads, forward(model, pts, dev),
                             (2.0, 0.3, 1.0)):
        with torch.no_grad():
            head.weight.mul_(sd / float(out.std()))


def decode_at(raw, anchors, idx):
    """detect's decode of the anchors ``idx`` from raw outputs: (boxes,
    scores), as models/inference.py does it."""
    from d3d_tpu_torch.models import decode_boxes

    cls, box, dirl = (o[0] for o in raw)
    boxes = decode_boxes(anchors[idx], box[idx])
    boxes[:, 6] += dirl[idx].argmax(dim=-1).to(boxes.dtype) * math.pi
    return boxes, torch.sigmoid(cls).max(dim=-1).values[idx]


def serving(dev):
    """make_pointpillars_detector on the KITTI preset at full width with
    seeded random weights: 4 requests, then the CPU comparison and the
    bf16 preset as pinned."""
    from d3d_tpu_torch.models import (PointPillars, make_anchors,
                                      make_pointpillars_detector, presets)
    from d3d_tpu_torch.models.inference import _bev
    from d3d_tpu_torch.ops.nms import nms2d

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

    # the same frame on the card (TF32 off) and on the CPU, same weights
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    gpu = [t.cpu() for t in detect.device_fn(frames[0])]
    no_tf32_ms = (time.perf_counter() - t0) * 1e3
    raw_gpu = [o.cpu() for o in forward(model, frames[0], dev)]
    cpu_model = PointPillars(cfg, device="cpu")
    cpu_model.load_state_dict({k: v.cpu()
                               for k, v in model.state_dict().items()})
    t0 = time.perf_counter()
    raw_cpu = forward(cpu_model, frames[0], "cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    # f32 on both sides, summed in other orders by cuDNN and the CPU:
    # stated 1e-4 of each output's largest magnitude
    raw_err = max(float((g - c).abs().max() / c.abs().max())
                  for g, c in zip(raw_gpu, raw_cpu))
    check(raw_err <= 1e-4, f"network outputs card vs CPU: {raw_err}")
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
          "detect.device_fn disagrees with its own raw outputs")
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
          f"boxes card vs CPU: position {pos_err}, size {size_err}, yaw "
          f"{yaw_err}, score {score_err}")
    # the keep mask: the card's NMS against the CPU's on the same boxes
    keep_cpu = ~nms2d(_bev(gpu[0]), gpu[1], iou_threshold=0.5)
    check(torch.equal(keep_cpu, gpu[3]), "keep mask card vs CPU")
    log(f"serving card vs CPU (TF32 off): outputs {raw_err:.3g} relative; "
        f"at the card's top-100: positions {pos_err:.3g} m, sizes "
        f"{size_err:.3g}, yaw {yaw_err:.3g} rad, scores {score_err:.3g}; "
        f"keep mask equal ({int(gpu[3].sum())} kept). f32 request with "
        f"TF32 off {no_tf32_ms:.2f} ms; the CPU network {cpu_ms:.0f} ms")

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


def kernel_times(dev, ns_inputs, k3_inputs):
    """Per-launch device ms of each kernel and its plain version at the
    paths' shapes, with the bounds."""
    from d3d_tpu_torch.ops import geometry_cuda, geometry_soa, nms_cuda

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
    for name, row in out.items():
        log(f"{name}: {row['ms']:.4f} ms per launch at {row['shape']}, plain "
            f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.5f} ms "
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

    serve_counts, serve = serving(dev)
    ns_counts, ns, ns_inputs = north_star(dev)
    k3_counts, tb2048, ts2048 = k3_path(dev)
    times = kernel_times(dev, ns_inputs, (tb2048, ts2048))

    by_path = {name: {"serving": serve_counts[name],
                      "north_star": ns_counts[name],
                      "nms2d_2048": k3_counts[name]}
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
            bound_by=row["bound_by"], library_ms=None, shape=row["shape"],
            launches_by_path=by_path[name],
            **{k: v for k, v in row.items() if k.startswith("ms_")}))
    log(json.dumps({"paths": {"serving": serve, "north_star": ns},
                    "card": card}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

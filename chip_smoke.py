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
   f32 and bf16, at the tolerances stated in ``check_k5``, K6 (its weight
   gradient) at every layer shape of SECOND training, f32 and bf16
   features, bit-equal across two runs (``check_k6``), and K5 as the
   features' gradient of the submanifold layers (``check_k5_backward``);
3. drives the port's paths with every launch count set to 0 just before
   and read just after: PointPillars serving (``make_pointpillars_detector``
   on the KITTI preset at full width, random seeded weights, 4 requests of
   different 120k-point frames), the north-star frame of ``bench.py``
   (``voxelize_mean_fm`` + ``nms2d`` of 512 boxes), ``nms2d`` of 2048
   boxes (K3), SECOND serving (``make_second_detector`` on
   ``presets.second_kitti`` at full width, 4 requests), ``soft_nms2d``
   of the north star's 512 boxes (K4) and SECOND training
   (``make_train_step`` + ``make_optimizer`` on ``presets.second_kitti``
   at full width, batch 2, 5 steps in f32 with TF32 off and 5 in bf16,
   counts read per step: K5 13, K6 8); each path must launch its kernels;
4. checks the outputs: finite, of the expected shape, the keep masks equal
   to the plain scans on the kernels' own IoU matrices, the voxelizer
   equal to the port's CPU run, both serving paths' outputs equal to a
   CPU run of the same weights at a stated tolerance (TF32 off), the
   training loss finite and falling, and one training step's gradients
   equal to the CPU's (plain versions) at a stated tolerance;
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
    from d3d_tpu_torch.models import second_voxelize

    with torch.inference_mode():
        f, c, v = second_voxelize(torch.from_numpy(pts).to(dev), model.cfg)
    return stage_layer_inputs(model, f[None], c[None], v[None])


def stage_layer_inputs(model, feats, coords, valid):
    """Each sparse layer's inputs when the (B, V, ...) batch runs through
    the stage loop as one joined site list, in path order: {layer:
    (features, nbr, valid, weight)}."""
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


def check_k6(layers):
    """K6 against its plain version on the card at every layer shape of the
    SECOND training path (two frames joined), with f32 and with bf16
    features and a seeded f32 cotangent; two launches on the same inputs
    must give the same bits. Stated tolerance, elementwise: 1e-5 of the
    entry's sum of |terms| (the two sum over up to 32 000 rows in other
    orders). Returns the largest |kernel - plain| per dtype and the
    shapes."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    grads = train_cotangent(layers, 6)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    shapes = {}
    for name, (x, nbr, valid, w) in layers.items():
        g = grads[name]
        present = int((nbr >= 0).sum())
        shapes[name] = dict(nq=nbr.shape[0], n=x.shape[0], c=x.shape[1],
                            cout=w.shape[2], valid=int(valid.sum()),
                            present=present)
        errs = []
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = K._dw_launch(xd, nbr, g)
            again = K._dw_launch(xd, nbr, g)
            want = K._subm_conv_dw_plain(xd, nbr, g)
            scale = K._subm_conv_dw_plain(xd.float().abs(), nbr, g.abs())
            torch.cuda.synchronize()
            check(got.shape == want.shape == (27,) + tuple(w.shape[1:])
                  and got.dtype == torch.float32,
                  f"K6 {name} {dt}: {got.shape} {got.dtype}")
            check(torch.equal(got, again),
                  f"K6 {name} {dt}: two runs on the same inputs differ")
            check(bool(torch.isfinite(got).all()), f"K6 {name}: not finite")
            err = (got - want).abs()
            bad = int((err > 1e-5 * scale).sum())
            check(bad == 0, f"K6 {name} {dt}: {bad} entries out of "
                            f"tolerance, max error {float(err.max())}")
            key = str(dt).split(".")[1]
            worst[key] = max(worst[key], float(err.max()))
            errs.append(float(err.max()))
        log(f"K6 {name} (Nq {nbr.shape[0]}, N {x.shape[0]}, C {x.shape[1]}, "
            f"Cout {w.shape[2]}, {present} of {nbr.numel()} neighbours "
            f"present): max |kernel - plain| f32 {errs[0]:.3g}, bf16 "
            f"{errs[1]:.3g}; bit-equal across two runs")
    return worst, shapes


def k5_backward_inputs(layers):
    """The features'-gradient K5 launches of a train step: the submanifold
    layers after the first (whose input, the voxel means, needs no
    gradient), each with the seeded cotangent and the mirrored, transposed
    f32 weights: {layer: (cotangent, nbr, valid, weights)}."""
    grads = train_cotangent(layers, 5)
    return {name: (grads[name], nbr, valid,
                   w.float().flip(0).transpose(1, 2).contiguous())
            for name, (_, nbr, valid, w) in layers.items()
            if name.startswith("subm") and name != "subm0_0"}


def check_k5_backward(layers):
    """K5 as the features' gradient of the five submanifold layers of the
    training path: against the plain scatter-add (the transposed map, which
    needs no symmetry) at 1e-5 of each entry's sum of |terms|, and the
    adjoint identity <K5(x; W), g> = <x, K5^T(g)> to 1e-5 of the sum of
    |terms| (f32 rounding). Returns the largest |kernel - plain|."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    worst = 0.0
    for name, (g, nbr, valid, wt) in k5_backward_inputs(layers).items():
        x, _, _, w = layers[name]
        w = w.float()
        got = K._launch(g, nbr, wt, valid)
        want = K._scatter_dfeat(g, nbr, w, x.shape[0])
        scale = K._scatter_dfeat(g.abs(), nbr, w.abs(), x.shape[0])
        fwd = K._launch(x.float(), nbr, w, valid)
        torch.cuda.synchronize()
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
        log(f"K5 backward {name} (N {x.shape[0]}, {w.shape[2]} -> "
            f"{w.shape[1]} channels): max |kernel - plain| "
            f"{float(err.max()):.3g}; <K5 x, g> - <x, K5^T g> = "
            f"{lhs - rhs:.3g} of {terms:.4g}")
    return worst


def train_batch(dev, cfg, frames):
    """Two frames of bench.py's recipe through second_voxelize, stacked, and
    six car-like ground-truth boxes a frame across the field (seeded; the
    last box of frame 0 padded): the training batch."""
    from d3d_tpu_torch.models import second_voxelize

    with torch.inference_mode():
        vox = [second_voxelize(torch.from_numpy(p).to(dev), cfg)
               for p in frames]
    rng = np.random.default_rng(400)
    b, m = len(frames), 6
    gt = np.stack([
        rng.uniform(2, 60, (b, m)), rng.uniform(-35, 35, (b, m)),
        np.full((b, m), -1.0), rng.uniform(3.5, 4.3, (b, m)),
        rng.uniform(1.5, 1.8, (b, m)), rng.uniform(1.4, 1.7, (b, m)),
        rng.uniform(-np.pi, np.pi, (b, m))], -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[0, -1] = False
    batch = {k: torch.stack([v[i] for v in vox]).clone()
             for i, k in enumerate(("features", "coords", "valid"))}
    batch.update(gt_boxes=torch.from_numpy(gt).to(dev),
                 gt_labels=torch.zeros((b, m), dtype=torch.int32,
                                       device=dev),
                 gt_mask=torch.from_numpy(mask).to(dev))
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
    from d3d_tpu_torch.models import make_train_step
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
                    soft_nms_scan=0, subm_conv=13, subm_conv_dw=8)
        check(counts == want, f"SECOND training {dtype} step {i + 1}: "
                              f"launches {counts}, want {want}")
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
        f"K5 13, K6 8, K1 0; lr at the steps "
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
    from d3d_tpu_torch.models import (head_config, make_anchors,
                                      make_train_step, presets)
    from d3d_tpu_torch.models.pointpillars import prepare_targets
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
    from d3d_tpu_torch.ops import geometry_cuda, nms_cuda, sparse_conv_cuda

    return (geometry_cuda.rbox_iou_matrix, nms_cuda.nms_scan,
            nms_cuda.nms_scan_blocked, nms_cuda.soft_nms_scan,
            sparse_conv_cuda.subm_conv, sparse_conv_cuda.subm_conv_dw)


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
                soft_nms_scan=0, subm_conv=4 * len(K5_LAYERS),
                subm_conv_dw=0)
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
                         soft_nms_scan=2, subm_conv=0, subm_conv_dw=0),
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


def train_layers_k5_backward_times(train_layers):
    """K5 as the features' gradient: device ms of the five launches of one
    training step (two frames joined, f32), summed, with its plain version
    (the scatter-add) and the bound of the summed bytes and operations."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    tot = dict(ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
    for name, (g, nbr, valid, wt) in k5_backward_inputs(train_layers).items():
        w = train_layers[name][3].float()
        ms = time_launches(lambda: K._launch(g, nbr, wt, valid), batch=20)
        plain = time_each(lambda: K._scatter_dfeat(g, nbr, w, g.shape[0]),
                          reps=5, warmup=1)
        nbytes, ops = k5_work(g, nbr, wt.shape[2])
        for k, v in (("ms", ms), ("plain_ms", plain), ("nbytes", nbytes),
                     ("ops", ops)):
            tot[k] += v
        log(f"subm_conv backward {name}: {ms:.4f} ms per launch, plain "
            f"(scatter-add) {plain:.4f} ms")
    b_ms, b_by = bound(tot["nbytes"], tot["ops"])
    return dict(ms_backward_step=tot["ms"],
                plain_ms_backward_step=tot["plain_ms"],
                bound_ms_backward_step=b_ms, bound_by_backward_step=b_by,
                backward_of="the 5 features'-gradient launches of one "
                            "training step (2 frames, f32)")


def k6_times(train_layers):
    """K6 at the 8 layers of one SECOND training step (two frames joined),
    f32 (the path checked against the CPU) and with bf16 features (the
    preset as pinned): per-launch ms, the plain version (gather +
    torch.einsum, cuBLAS: also the library call), bounds per layer and of
    the summed bytes and operations."""
    from d3d_tpu_torch.ops import sparse_conv_cuda as K

    grads = train_cotangent(train_layers, 6)
    per_layer, totals = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt).split(".")[1]
        tot = dict(ms=0.0, plain_ms=0.0, nbytes=0, ops=0)
        for name, (x, nbr, valid, w) in train_layers.items():
            xd, g = x.to(dt), grads[name]
            ms = time_launches(lambda: K._dw_launch(xd, nbr, g), batch=20)
            plain = time_each(lambda: K._subm_conv_dw_plain(xd, nbr, g),
                              reps=5, warmup=1)
            nbytes, ops = k6_work(xd, nbr, w.shape[2])
            b_ms, b_by = bound(nbytes, ops, k5_rate(dt))
            per_layer.setdefault(name, {})[key] = dict(
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
            for k, v in (("ms", ms), ("plain_ms", plain), ("nbytes", nbytes),
                         ("ops", ops)):
                tot[k] += v
            log(f"subm_conv_dw {name} {key}: {ms:.4f} ms per launch, plain "
                f"{plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
        tot["bound"] = bound(tot["nbytes"], tot["ops"], k5_rate(dt))
        totals[key] = tot
    f32, bf16 = totals["float32"], totals["bfloat16"]
    return dict(
        ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound"][0],
        bound_by=f32["bound"][1], library_ms=f32["plain_ms"],
        library="index gather + torch.einsum (cuBLAS): the plain version",
        shape="the 8 layers of one SECOND training step, 2 frames, f32 "
              "(sum)",
        ms_of=f"one training step ({len(K5_LAYERS)} launches)",
        ms_bf16=bf16["ms"], plain_ms_bf16=bf16["plain_ms"],
        bound_ms_bf16=bf16["bound"][0], bound_by_bf16=bf16["bound"][1],
        per_layer=per_layer)


def kernel_times(dev, ns_inputs, k3_inputs, soft_inputs, soft_stats,
                 k5_layers, train_layers):
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
    out["subm_conv"].update(train_layers_k5_backward_times(train_layers))
    out["subm_conv_dw"] = k6_times(train_layers)
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
    state = {k: v.clone() for k, v in second.state_dict().items()}
    batch = train_batch(dev, second.cfg, [bench_points(
        np.random.default_rng(300 + i)) for i in range(2)])
    train_layers = stage_layer_inputs(second, batch["features"],
                                      batch["coords"], batch["valid"])
    k6_err, k6_shapes = check_k6(train_layers)
    k5_bwd_err = check_k5_backward(train_layers)

    serve_counts, serve = serving(dev)
    ns_counts, ns, ns_inputs = north_star(dev)
    k3_counts, tb2048, ts2048 = k3_path(dev)
    second_counts, second_stats = second_serving(dev, second, second_frames)
    soft_counts, soft_stats, soft_inputs = soft_nms_path(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    train_counts, train_stats = {}, {}
    for dtype in ("float32", "bfloat16"):
        counts, train_stats[dtype] = second_training(dev, state, batch, dtype)
        for k, v in counts.items():
            train_counts[k] = train_counts.get(k, 0) + v
    train_stats["card_vs_cpu_grad_err"] = train_card_vs_cpu(dev, state,
                                                            batch)
    times = kernel_times(dev, ns_inputs, (tb2048, ts2048), soft_inputs,
                         soft_stats, k5_layers, train_layers)

    by_path = {name: {"serving": serve_counts[name],
                      "north_star": ns_counts[name],
                      "nms2d_2048": k3_counts[name],
                      "second_serving": second_counts[name],
                      "soft_nms": soft_counts[name],
                      "second_training": train_counts[name]}
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
        "subm_conv_dw": ("cuda", "d3d_tpu_torch/csrc/subm_conv_dw.cu",
                         "d3d_tpu/ops/sparse_conv_pallas.py:139",
                         k6_err["float32"]),
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
    rows = {row["name"]: row for row in kernels}
    rows["subm_conv"].update(max_abs_err_bf16=k5_err["bfloat16"],
                             layer_shapes=k5_shapes,
                             max_abs_err_backward=k5_bwd_err)
    rows["subm_conv_dw"].update(max_abs_err_bf16=k6_err["bfloat16"],
                                layer_shapes=k6_shapes,
                                bit_equal_across_runs=True)
    log(json.dumps({"paths": {"serving": serve, "north_star": ns,
                              "second_serving": second_stats,
                              "soft_nms": soft_stats,
                              "second_training": train_stats},
                    "card": card}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

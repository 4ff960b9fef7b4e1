"""Where the time goes in the PyTorch/CUDA port's paths on one NVIDIA GPU.

Run from the root of a checkout, on a machine with CUDA and nvcc::

    python3 scripts/profile_port.py

For bench.py's north-star frame (``voxelize_mean_fm`` + ``nms2d`` of 512
boxes), for one serving request of PointPillars
(``make_pointpillars_detector`` on ``presets.pointpillars_kitti``) and of
SECOND (``make_second_detector`` on ``presets.second_kitti``), and for one
SECOND train step (``make_train_step`` on ``presets.second_kitti``, batch
2), at full width with seeded random weights as in chip_smoke.py, it
prints the device time of each serving stage (CUDA events, median of 20;
chip_smoke.py prints the train step's), the top kernels by device time
over 5 runs of each path (torch.profiler), and the share of those runs'
wall clock in which a kernel ran. Imports no JAX.
"""

import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from d3d_tpu_torch.dataset.kitti import KittiObjectClass  # noqa: E402
from d3d_tpu_torch.models import (SECOND, PointPillars,  # noqa: E402
                                  decode_boxes, head_config, make_anchors,
                                  make_pointpillars_detector,
                                  make_second_detector, pillarize, presets,
                                  second_voxelize)
from d3d_tpu_torch.models.inference import _bev  # noqa: E402
from d3d_tpu_torch.models.second import (_batch_stage_maps,  # noqa: E402
                                          _run_stages, make_train_step)
from d3d_tpu_torch.ops import geometry_cuda, nms_cuda  # noqa: E402
from d3d_tpu_torch.ops._build import build  # noqa: E402
from d3d_tpu_torch.ops.nms import nms2d  # noqa: E402
from d3d_tpu_torch.ops.sparse_conv import sparse_to_dense  # noqa: E402
from d3d_tpu_torch.ops.voxel import voxelize_mean_fm  # noqa: E402
from d3d_tpu_torch.train import make_optimizer  # noqa: E402


def stage_times(stages, reps=20):
    for name, fn in stages:
        print(f"  {name:<34} {smoke.time_each(fn, reps):9.4f} ms")


def profile_path(name, fn, runs=5):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    # kernel rows only: an aten op's row repeats its kernels' device time
    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    print(f"{name}: {runs} runs, wall {wall_us / runs / 1e3:.3f} ms per run, "
          f"kernels busy {busy_us / runs / 1e3:.3f} ms per run "
          f"({100 * busy_us / wall_us:.1f}% of the wall clock)")
    for e in averages:
        for k in ("rbox_iou_kernel", "rbox_bits_kernel",
                  "pack_overlap_kernel", "scan_warp_kernel",
                  "scan_block_kernel", "subm_conv_kernel",
                  "soft_nms_rows_kernel", "soft_nms_cascade_kernel",
                  "subm_conv_dw_partial", "subm_conv_dw_reduce",
                  "rulebook_kernel"):
            if e.device_type == DeviceType.CUDA and (k + "(" in e.key
                                                     or k + "<" in e.key):
                print(f"  port kernel {k}: "
                      f"{e.self_device_time_total / e.count:.2f} us per "
                      f"launch ({e.count} launches)")
    print(averages.table(sort_by="self_device_time_total", row_limit=15,
                         max_name_column_width=60))


def main():
    if not torch.cuda.is_available():
        print("profile_port: needs CUDA", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(smoke.card_line())
    build()

    # --- north star ---------------------------------------------------------
    pts, boxes, scores = smoke.north_star_frame()
    pts_fm = torch.from_numpy(np.ascontiguousarray(pts.T)).to(dev)
    tb, ts = torch.from_numpy(boxes).to(dev), torch.from_numpy(scores).to(dev)
    bounds = torch.tensor(smoke.BOUNDS, device=dev)
    order, ov, pre = smoke.nms_inputs(tb, ts, 0.25)
    bo = tb[order].contiguous()
    neg = torch.sort(-ts, stable=True).values
    bits = geometry_cuda._bits_launch(bo, 0.25)
    scanned = torch.empty(len(tb), dtype=torch.bool, device=dev)

    def north_star():
        voxelize_mean_fm(pts_fm, smoke.GRID, bounds, 16000)
        nms2d(tb, ts, iou_threshold=0.25)

    print("north star stages (device ms, CUDA events):")
    stage_times([
        ("frame: voxelize_mean_fm + nms2d", north_star),
        ("voxelize_mean_fm", lambda: voxelize_mean_fm(pts_fm, smoke.GRID,
                                                      bounds, 16000)),
        ("nms2d (512 boxes)", lambda: nms2d(tb, ts, iou_threshold=0.25)),
        ("  torch.sort(-scores)", lambda: torch.sort(-ts, stable=True)),
        ("  K1, bit rows (nms2d's form)",
         lambda: geometry_cuda._rbox_overlap_bits(bo, 0.25)),
        ("  K1, f32 matrix (public wrapper)",
         lambda: geometry_cuda.rbox_iou_matrix(bo, bo)),
        ("  K2 on the bit rows (nms2d's route)",
         lambda: nms_cuda._scan_launch(bits, scanned, neg_scores=neg,
                                       order=order)),
        ("  K2 public wrapper (pack + scan)",
         lambda: nms_cuda.nms_scan(ov, pre)),
    ])
    profile_path("north star", north_star)

    # --- serving ------------------------------------------------------------
    for dtype in ("float32", "bfloat16"):
        cfg = presets.pointpillars_kitti(dtype=dtype)
        frame = smoke.bench_points(np.random.default_rng(100))
        model = PointPillars(presets.pointpillars_kitti(dtype="float32"),
                             device=dev,
                             generator=torch.Generator().manual_seed(0))
        smoke.calibrate_heads(model, frame, dev)
        state = model.state_dict()
        model = PointPillars(cfg, device=dev)
        model.load_state_dict(state)
        anchors = make_anchors(cfg, device=dev)
        detect = make_pointpillars_detector(model, None, cfg, anchors,
                                            [KittiObjectClass.Car], device=dev)
        points = torch.from_numpy(frame).to(dev)
        feats, coords, valid = pillarize(points, cfg)
        with torch.inference_mode():
            raw = model(feats[None], coords[None], valid[None])
        best = torch.sigmoid(raw[0][0]).max(dim=-1).values
        idx = torch.sort(best, descending=True, stable=True).indices[:100]
        det_boxes = decode_boxes(anchors[idx], raw[1][0][idx])

        def network():
            with torch.inference_mode():
                model(feats[None], coords[None], valid[None])

        def topk_decode():
            b = torch.sigmoid(raw[0][0]).max(dim=-1).values
            i = torch.sort(b, descending=True, stable=True).indices[:100]
            decode_boxes(anchors[i], raw[1][0][i])

        print(f"serving stages, {dtype} (device ms, CUDA events; TF32 "
              f"{'allowed' if torch.backends.cudnn.allow_tf32 else 'off'} "
              f"for convolutions):")
        stage_times([
            ("request: device_fn (points on card)",
             lambda: detect.device_fn(points)),
            ("points to the card (1.9 MB)",
             lambda: torch.from_numpy(frame).to(dev)),
            ("pillarize", lambda: pillarize(points, cfg)),
            ("network", network),
            ("top-k + decode", topk_decode),
            ("nms2d (100 boxes)",
             lambda: nms2d(_bev(det_boxes), best[idx], iou_threshold=0.5)),
        ])
        walls = []
        for _ in range(20):
            t0 = time.perf_counter()
            detect(frame)
            walls.append((time.perf_counter() - t0) * 1e3)
        print(f"  request wall clock (numpy in and out): "
              f"{statistics.median(walls):.3f} ms median of 20")
        profile_path(f"serving {dtype}", lambda: detect.device_fn(points))

    # --- SECOND serving -----------------------------------------------------
    # TF32 off, as chip_smoke.py times SECOND (only the BEV block's
    # convolutions would take it)
    torch.backends.cudnn.allow_tf32 = False
    frame = smoke.bench_points(np.random.default_rng(200))
    points = torch.from_numpy(frame).to(dev)
    seeded, _ = smoke.second_model(dev)
    for dtype in ("float32", "bfloat16"):
        cfg = presets.second_kitti(dtype=dtype)
        model = SECOND(cfg, device=dev)
        model.load_state_dict(seeded.state_dict())
        anchors = make_anchors(head_config(cfg), device=dev)
        detect = make_second_detector(model, None, cfg, anchors,
                                      [KittiObjectClass.Car], device=dev)
        feats, coords, valid = second_voxelize(points, cfg)
        maps, (fc, fv, fg) = _batch_stage_maps(cfg, coords[None],
                                               valid[None])
        fc, fv = fc[0], fv[0]
        with torch.inference_mode():
            x = _run_stages(cfg, model.middle, feats, maps)
            raw = model.bev_head(sparse_to_dense(x, fc, fv, fg)[None])
        best = torch.sigmoid(raw[0][0]).max(dim=-1).values
        idx = torch.sort(best, descending=True, stable=True).indices[:100]
        det_boxes = decode_boxes(anchors[idx], raw[1][0][idx])

        def middle():
            with torch.inference_mode():
                _run_stages(cfg, model.middle, feats, maps)

        def head():
            with torch.inference_mode():
                model.bev_head(sparse_to_dense(x, fc, fv, fg)[None])

        def topk_decode():
            b = torch.sigmoid(raw[0][0]).max(dim=-1).values
            i = torch.sort(b, descending=True, stable=True).indices[:100]
            decode_boxes(anchors[i], raw[1][0][i])

        print(f"SECOND serving stages, {dtype} (device ms, CUDA events; "
              "TF32 off):")
        stage_times([
            ("request: device_fn (points on card)",
             lambda: detect.device_fn(points)),
            ("voxelize (second_voxelize)",
             lambda: second_voxelize(points, cfg)),
            ("neighbour maps + rule books + downsampling",
             lambda: _batch_stage_maps(cfg, coords[None], valid[None])),
            ("middle extractor (8 x K5 + BN)", middle),
            ("densify + BEV block + heads", head),
            ("top-k + decode", topk_decode),
            ("nms2d (100 boxes)",
             lambda: nms2d(_bev(det_boxes), best[idx], iou_threshold=0.5)),
        ])
        profile_path(f"SECOND serving {dtype}",
                     lambda: detect.device_fn(points))

    # --- SECOND training ----------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = smoke.train_batch(dev, seeded.cfg, [smoke.bench_points(
        np.random.default_rng(300 + i)) for i in range(2)])
    for dtype in ("float32", "bfloat16"):
        cfg = presets.second_kitti(dtype=dtype)
        model = smoke.train_model(cfg, seeded.state_dict(), dev)
        opt, _ = make_optimizer(model.parameters(), smoke.TRAIN_STEPS)
        step = make_train_step(model, opt, cfg,
                               make_anchors(head_config(cfg), device=dev),
                               riou_weight=smoke.RIOU_WEIGHT)
        profile_path(f"SECOND training {dtype} (TF32 off)",
                     lambda: step(batch))
    return 0


if __name__ == "__main__":
    sys.exit(main())

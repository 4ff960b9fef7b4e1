"""Serving loop on the port: detector + device tracker in one step.

Builds a velocity-head CenterPoint, fuses it with the device-resident
tracker (:func:`d3d_tpu_torch.tracking.make_tracking_step`) and drives a
synthetic 10 Hz stream through the step; the detections stay on the
device between the network and the association. Prints per-frame latency
and the live track table, then exports the detector through
``torch.export`` (:func:`d3d_tpu_torch.export.save_detector`), reloads
it, builds the tracking step on the loaded artifact and runs one frame.

The JAX counterpart (``serve_tracking.py``) exports the whole tracking
step; here the artifact is the detector alone, because the tracker walks
the admitted rows after one host read a frame, which ``torch.export``
does not trace.

Run: ``python examples/torch_serve_tracking.py [--frames 20] [--device cpu]``
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

FRAME_DT_S = 0.1
# untrained demo net: scores hover near the focal prior (~0.1), so the
# admission gate is lower than the serving default (0.3)
SCORE_GATE = 0.05


def make_cloud(rng):
    """``cloud(t)``: static clutter + one mover crossing at 5 m/s."""
    def cloud(t):
        n = 4096
        pts = np.stack([rng.random(n) * 32, rng.random(n) * 32 - 16,
                        rng.random(n) * 4 - 3, rng.random(n)],
                       axis=1).astype(np.float32)
        box = np.array([4.0 + 0.5 * t, -2.0, -1.0])
        car = box + rng.normal(0, 0.3, (256, 3)) * [1.5, 0.7, 0.5]
        pts[:256, :3] = car
        return pts
    return cloud


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(frames=20, device="cuda", weights=None):
    """Stream ``frames`` frames through the fused step on ``device``.

    :param weights: optional flax variables (numpy leaves) of the JAX
        example's CenterPoint, carried over by
        :func:`~d3d_tpu_torch.models.centerpoint_state_from_flax`; seeded
        weights without them
    :returns: ``{"live": [live tracks after each frame], "ms": [...],
        "dets": [each frame's detector (boxes, scores, keep) on the CPU],
        "report": [(tid, position, velocity, score)], "export_bytes",
        "export_live"}``
    """
    from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass
    from d3d_tpu_torch.export import load_detector, save_detector
    from d3d_tpu_torch.models import centerpoint_state_from_flax
    from d3d_tpu_torch.models.centerpoint import CenterPoint, CenterPointConfig
    from d3d_tpu_torch.models.inference import make_centerpoint_detector
    from d3d_tpu_torch.models.pointpillars import PointPillarsConfig
    from d3d_tpu_torch.tracking.device_tracker import (make_tracking_step,
                                                       tracker_report)
    from d3d_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    CAR = KittiObjectClass.Car
    cfg = CenterPointConfig(
        bounds=(0.0, 32.0, -16.0, 16.0, -3.0, 1.0), grid=(64, 64),
        max_pillars=2048, max_points_per_pillar=20, pfn_features=32,
        backbone_channels=(32, 64), backbone_blocks=(1, 1),
        upsample_channels=32, head_channels=32, window=9, top_k=32,
        predict_velocity=True)
    pcfg = PointPillarsConfig(
        bounds=cfg.bounds, grid=cfg.grid, max_pillars=cfg.max_pillars,
        max_points_per_pillar=cfg.max_points_per_pillar,
        pfn_features=cfg.pfn_features)

    cloud = make_cloud(np.random.default_rng(0))
    cloud(0)  # the JAX example's init frame: its draws come first
    model = CenterPoint(cfg, device=dev,
                        generator=torch.Generator().manual_seed(0))
    detect = make_centerpoint_detector(
        model, None if weights is None else
        centerpoint_state_from_flax(weights), cfg, pcfg, [CAR],
        score_threshold=0.0, device=dev)
    step = make_tracking_step(detect.device_fn, thresholds=[3.0],
                              capacity=64, score_threshold=SCORE_GATE)
    state = step.init()

    print(f"device={dev}; streaming {frames} frames at 10 Hz "
          "(one fused step a frame)")
    live, times, dets = [], [], []
    for t in range(frames):
        pts = torch.as_tensor(cloud(t), device=dev)
        dt = np.float32(0.0 if t == 0 else FRAME_DT_S)
        _sync(dev)
        t0 = time.perf_counter()
        state, (boxes, scores, _, keep, _) = step(state, pts, dt)
        n_live = int(state["active"].sum())  # the read waits for the card
        ms = (time.perf_counter() - t0) * 1e3
        dets.append(tuple(x.cpu() for x in (boxes, scores, keep)))
        live.append(n_live)
        times.append(ms)
        tag = " (first call)" if t == 0 else ""
        print(f"frame {t:3d}: {ms:8.2f} ms  live tracks: {n_live}{tag}")

    rep = tracker_report(state, [CAR], frame="velo",
                         timestamp=frames * 100_000)
    for o in rep[:5]:
        print(f"  tid={o.tid} pos=({o.position[0]:.1f}, "
              f"{o.position[1]:.1f}) v=({o.velocity[0]:.1f}, "
              f"{o.velocity[1]:.1f}) score={o.tag_top_score:.2f}")

    # the deployable artifact: export the detector, reload it, and run one
    # step of the tracker built on the loaded program
    example = cloud(0)  # the JAX example's shape frame: same draws
    with tempfile.TemporaryDirectory() as tmp:
        path = save_detector(detect.device_fn, example,
                             os.path.join(tmp, "centerpoint.pt2"))
        nbytes = os.path.getsize(path)
        loaded = load_detector(path)

    def reloaded_fn(points):
        return loaded(points)

    reloaded_fn.device = dev
    reloaded = make_tracking_step(reloaded_fn, thresholds=[3.0],
                                  capacity=64, score_threshold=SCORE_GATE)
    state2, _ = reloaded(state, torch.as_tensor(cloud(frames), device=dev),
                         np.float32(FRAME_DT_S))
    export_live = int(state2["active"].sum())
    print(f"export roundtrip: {nbytes} bytes; reloaded step ran, "
          f"{export_live} live tracks")
    return dict(live=live, ms=times, dets=dets,
                report=[(int(o.tid), np.asarray(o.position),
                         np.asarray(o.velocity), float(o.tag_top_score))
                        for o in rep],
                export_bytes=nbytes, export_live=export_live)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.frames, args.device)


if __name__ == "__main__":
    main()

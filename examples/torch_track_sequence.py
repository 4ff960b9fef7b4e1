"""Track a detection stream and score it with the tracking evaluator, on
the port (the PyTorch counterpart of ``track_sequence.py``).

Runs the three trackers over the same synthetic multi-object sequence:
``CenterTracker`` (velocity-backcast greedy association, consuming
detector-predicted velocities like the CenterPoint nuScenes pipeline),
``VanillaTracker`` (the reference-parity Kalman pipeline, which estimates
motion itself) and ``DeviceCenterTracker`` (CenterTracker's association on
the device), and prints CLEAR-MOT / AMOTA metrics for each.

Runs out of the box:
    python examples/torch_track_sequence.py --frames 40 --objects 6
    python examples/torch_track_sequence.py --device cpu
"""

import argparse
import os
import sys

import numpy as np
from scipy.spatial.transform import Rotation

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from d3d_tpu_torch.abstraction import (ObjectTag,  # noqa: E402
                                       Target3DArray, TrackingTarget3D)
from d3d_tpu_torch.benchmarks import TrackingEvaluator  # noqa: E402
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass  # noqa: E402
from d3d_tpu_torch.tracking import (CenterTracker,  # noqa: E402
                                    DeviceCenterTracker, VanillaTracker)
from d3d_tpu_torch.utils import resolve_device  # noqa: E402

CAR = KittiObjectClass.Car
DT_S = 0.1
# the detection-score floor: every reported track counts (the default
# operating point is the middle of the threshold grid, which would
# silently drop the lower-scored half)
SCORE_AT = 0.45


def synthetic_sequence(rng, n_frames, n_objects, drop_prob=0.1):
    """Constant-velocity objects with noisy detections; yields
    (gt_frame, det_frame) per time step."""
    pos = rng.uniform([-30, -30], [30, 30], (n_objects, 2))
    vel = rng.uniform(-8, 8, (n_objects, 2))
    for t in range(n_frames):
        ts = t * int(DT_S * 1e6)
        gt, det = Target3DArray(frame="velo", timestamp=ts), \
            Target3DArray(frame="velo", timestamp=ts)
        for i in range(n_objects):
            p = pos[i] + vel[i] * DT_S * t
            gt.append(TrackingTarget3D(
                [p[0], p[1], 0.0], Rotation.identity(), [4.0, 2.0, 1.6],
                [vel[i, 0], vel[i, 1], 0.0], [0, 0, 0],
                ObjectTag(CAR), tid=i + 1))
            if rng.random() > drop_prob:
                det.append(TrackingTarget3D(
                    [p[0] + rng.normal(0, 0.15),
                     p[1] + rng.normal(0, 0.15), 0.0],
                    Rotation.identity(), [4.0, 2.0, 1.6],
                    [vel[i, 0] + rng.normal(0, 0.3),
                     vel[i, 1] + rng.normal(0, 0.3), 0.0], [0, 0, 0],
                    ObjectTag(CAR, scores=float(rng.uniform(0.5, 1.0)))))
        yield gt, det


def score(name, gt_frames, trk_frames, device):
    """Print and return one tracker's CLEAR-MOT / AMOTA metrics."""
    ev = TrackingEvaluator([CAR], [0.5], device=device)
    for g, d in zip(gt_frames, trk_frames):
        ev.add_stats(ev.calc_stats(g, d))
    out = dict(mota=ev.mota(SCORE_AT)[CAR], amotp=ev.amotp()[CAR],
               switches=ev.id_switches(SCORE_AT)[CAR],
               fragments=ev.fragments(SCORE_AT)[CAR],
               amota=ev.amota()[CAR])
    print(f"{name:>14}: MOTA={out['mota']:.3f} "
          f"switches={out['switches']} fragments={out['fragments']} "
          f"AMOTA={out['amota']:.3f}")
    return out


def run(frames=40, objects=6, device="cuda"):
    """Track the sequence with each tracker on ``device``; returns
    ``{tracker: {metrics..., "tids": [the reported ids, frame by
    frame]}}``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    gts, dets = zip(*synthetic_sequence(rng, frames, objects))

    trackers = {
        "CenterTracker": CenterTracker(distance_threshold=1.5,
                                       lost_time=0.3),
        "VanillaTracker": VanillaTracker(matcher_distance_threshold=1.5,
                                         lost_time=0.3, device=dev),
        "DeviceTracker": DeviceCenterTracker([CAR], distance_threshold=1.5,
                                             lost_time=0.3, device=dev)}
    outs = {name: [] for name in trackers}
    for d in dets:
        for name, tracker in trackers.items():
            tracker.update(d)
            outs[name].append(tracker.report())

    return {name: dict(score(name, gts, outs[name], dev),
                       tids=[[int(o.tid) for o in f] for f in outs[name]])
            for name in trackers}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--objects", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.frames, args.objects, args.device)


if __name__ == "__main__":
    main()

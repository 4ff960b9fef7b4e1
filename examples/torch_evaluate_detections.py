"""Evaluate detections against ground truth with the batched device
evaluator on the port (the PyTorch counterpart of
``evaluate_detections.py``): the whole validation set in a handful of
device calls.

Runs out of the box on a synthetic stream:
    python examples/torch_evaluate_detections.py --frames 128
    python examples/torch_evaluate_detections.py --device cpu
"""

import argparse
import json
import os
import sys

import numpy as np
from scipy.spatial.transform import Rotation

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from d3d_tpu_torch.abstraction import (ObjectTag, ObjectTarget3D,  # noqa: E402
                                       Target3DArray)
from d3d_tpu_torch.benchmarks import DetectionEvaluator  # noqa: E402
from d3d_tpu_torch.benchmarks_device import device_calc_stats  # noqa: E402
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass  # noqa: E402
from d3d_tpu_torch.utils import resolve_device  # noqa: E402


def synthetic_pairs(rng, n):
    classes = [KittiObjectClass.Car, KittiObjectClass.Pedestrian]
    for _ in range(n):
        gt_boxes, dt_boxes = [], []
        for _ in range(int(rng.integers(5, 25))):
            pos = rng.uniform(-40, 40, 3)
            dim = rng.uniform(1, 4, 3)
            rot = Rotation.from_euler("Z", rng.uniform(-np.pi, np.pi))
            cls = classes[int(rng.integers(len(classes)))]
            gt_boxes.append(ObjectTarget3D(pos, rot, dim, ObjectTag(cls)))
            if rng.random() < 0.8:  # matched detection with jitter
                dt_boxes.append(ObjectTarget3D(
                    pos + rng.normal(0, 0.3, 3),
                    Rotation.from_euler("Z", rot.as_euler("zyx")[0]
                                        + rng.normal(0, 0.05)),
                    dim * rng.uniform(0.9, 1.1, 3),
                    ObjectTag(cls, scores=float(rng.uniform(0.3, 1)))))
        yield (Target3DArray(gt_boxes, frame="velo"),
               Target3DArray(dt_boxes, frame="velo"))


def run(frames=128, device="cuda"):
    """Evaluate ``frames`` synthetic frames on ``device`` and print the
    summary and the metrics; returns the evaluator."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    gts, dts = zip(*synthetic_pairs(rng, frames))

    ev = DetectionEvaluator(
        [KittiObjectClass.Car, KittiObjectClass.Pedestrian], [0.7, 0.5],
        device=dev)
    # one batched device call replaces the per-frame host loop
    ev.add_stats(device_calc_stats(ev, list(gts), list(dts)))
    print(ev.summary(verbose=True))
    print(json.dumps(ev.metrics_dict(), indent=2))  # structured export
    return ev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.frames, args.device)


if __name__ == "__main__":
    main()

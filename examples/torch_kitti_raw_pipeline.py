"""KITTI-raw ingestion walkthrough on the port (the PyTorch counterpart of
``kitti_raw_pipeline.py``): loader -> ego-motion-compensated multi-frame
clouds -> pillar tensors on the device -> tracking + evaluation.

1. ``KittiRawLoader`` reads the (zipped or extracted) raw drive;
2. consecutive clouds are re-expressed in the newest frame via the OXTS
   ego poses (``loader.pose`` + calibration extrinsics);
3. the accumulated cloud becomes static-shape pillar tensors on the
   device (``pillarize``), ready for a detector;
4. GT annotations drive a ``VanillaTracker`` and a ``TrackingEvaluator``
   to close the loop with metrics.

Usage:
    python examples/torch_kitti_raw_pipeline.py <dataset_root> [--scene S]
    python examples/torch_kitti_raw_pipeline.py --synthetic   # no dataset
    python examples/torch_kitti_raw_pipeline.py --synthetic --device cpu
"""

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def accumulate_frames(loader, scene, upto, nframes=3):
    """Ego-motion-compensate the ``nframes`` clouds ending at ``upto``
    into the newest frame's lidar coordinates, with an age channel."""
    calib = loader.calibration_data((scene, upto))
    lidar = loader.VALID_LIDAR_NAMES[0]
    t_el = calib.get_extrinsic(frame_from=lidar,
                               frame_to=loader.pose_name)  # lidar -> pose
    t_le = np.linalg.inv(t_el)
    key_pose_inv = np.linalg.inv(loader.pose((scene, upto)).homo())
    key_ts = loader.timestamp((scene, upto))

    merged = []
    for fi in range(max(0, upto - nframes + 1), upto + 1):
        cloud = np.asarray(loader.lidar_data((scene, fi)))[:, :4]
        m = t_le @ key_pose_inv @ loader.pose((scene, fi)).homo() @ t_el
        xyz = cloud[:, :3] @ m[:3, :3].T + m[:3, 3]
        dt = np.full((len(cloud), 1),
                     (key_ts - loader.timestamp((scene, fi))) / 1e6,
                     np.float32)
        merged.append(np.concatenate(
            [xyz.astype(np.float32), cloud[:, 3:4], dt], axis=1))
    return np.concatenate(merged, axis=0)


def run(root, scene=None, frames=None, inzip=False, device="cuda"):
    """Run the loop over a drive on ``device``; returns the evaluator."""
    from d3d_tpu_torch.benchmarks import TrackingEvaluator
    from d3d_tpu_torch.dataset.kitti import KittiRawLoader
    from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass
    from d3d_tpu_torch.models import PointPillarsConfig, pillarize
    from d3d_tpu_torch.tracking import VanillaTracker
    from d3d_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    loader = KittiRawLoader(root, inzip=inzip, phase="training",
                            trainval_split=1.0)
    scene = scene if scene is not None else loader.sequence_ids[0]
    nframes = frames or loader.sequence_sizes[scene]
    print(f"scene {scene}: {loader.sequence_sizes[scene]} frames, "
          f"using {nframes}")

    cfg = PointPillarsConfig(bounds=(0.0, 69.12, -39.68, 39.68, -3.0, 1.0),
                             grid=(432, 496), max_pillars=12000,
                             max_points_per_pillar=32)
    tracker = VanillaTracker(device=dev)
    evaluator = TrackingEvaluator([KittiObjectClass.Car,
                                   KittiObjectClass.Van], [0.5, 0.5],
                                  device=dev)

    for fi in range(nframes):
        cloud = accumulate_frames(loader, scene, fi)
        feats, coords, valid = pillarize(torch.as_tensor(cloud, device=dev),
                                         cfg)
        gt = loader.annotation_3dobject((scene, fi))
        gt.timestamp = loader.timestamp((scene, fi))
        # stand-in detector: the GT itself (swap in a trained model's
        # detect() here); the tracker smooths and assigns stable ids
        tracker.update(gt)
        tracked = tracker.report()
        evaluator.add_stats(evaluator.calc_stats(gt, tracked,
                                                 device_match=True))
        print(f"  frame {fi}: {len(cloud):7d} pts -> "
              f"{int(valid.sum()):5d} pillars, "
              f"{len(gt)} gt, {len(tracked)} tracks")

    print()
    print(evaluator.summary(score_thres=0.0))
    return evaluator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", help="KITTI raw dataset root")
    ap.add_argument("--scene", default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="run on a generated micro-drive (no dataset)")
    ap.add_argument("--inzip", action="store_true",
                    help="read the drive from the raw zip archives")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.synthetic:
        sys.path.insert(0, str(Path(__file__).parent.parent / "tests"))
        from dataset_fixtures import build_kitti_raw

        root = Path(tempfile.mkdtemp(prefix="kitti_raw_demo"))
        build_kitti_raw(root, nframes=3)
        return run(root, frames=args.frames, device=args.device)
    if args.root:
        return run(args.root, scene=args.scene, frames=args.frames,
                   inzip=args.inzip, device=args.device)
    ap.error("provide a dataset root or --synthetic")


if __name__ == "__main__":
    main()

"""Train the monocular camera 3D detector end to end on synthetic scenes,
on the port (the PyTorch counterpart of ``train_mono3d.py``).

The full camera pipeline: rendered scenes (bright boxes at projected
locations, with a brightness-ramp depth cue: a stand-in for a KITTI
image loader) -> flip augmentation -> Mono3D train step (AdamW one-cycle
via ``train.make_optimizer``) -> detection + center-distance AP with the
DetectionEvaluator (the nuScenes-style monocular metric). This is a
MECHANICS demo at smoke scale: a tiny net on rendered blobs learns coarse
depth in ~150 steps; real numbers need a real dataset (swap ``scene`` for
``loader.camera_data`` + ``mono3d_gt_from_targets``).

Run: ``python examples/torch_train_mono3d.py [--steps 150] [--device cpu]``
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(steps=150, device="cuda", weights=None):
    """Train ``steps`` steps on ``device`` and evaluate.

    :param weights: optional flax variables (numpy leaves) of the JAX
        example's Mono3D, carried over by
        :func:`~d3d_tpu_torch.models.mono3d_state_from_flax`; seeded
        weights without them
    :returns: ``{"losses": [each step's aux as floats], "ap", "depth_err"}``
    """
    from d3d_tpu_torch.augment import flip_camera_frame
    from d3d_tpu_torch.benchmarks import DetectionEvaluator
    from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass
    from d3d_tpu_torch.models import (Mono3D, Mono3DConfig,
                                      mono3d_state_from_flax)
    from d3d_tpu_torch.models.mono3d import (make_mono3d_detector,
                                             make_train_step,
                                             mono3d_to_targets)
    from d3d_tpu_torch.tracking.matcher import DistanceTypes
    from d3d_tpu_torch.train import make_optimizer
    from d3d_tpu_torch.utils import resolve_device

    dev = resolve_device(device)
    CAR = KittiObjectClass.Car
    cfg = Mono3DConfig(
        image_size=(96, 160), stride=4, backbone_channels=(8, 16, 32),
        head_channels=32, num_classes=1, top_k=8,
        dim_priors=((3.88, 1.63, 1.53),))
    K = np.array([[70.0, 0, 80.0], [0, 70.0, 48.0], [0, 0, 1.0]],
                 np.float32)
    rng = np.random.default_rng(0)

    def scene(m=2):
        # depth is cued by apparent size AND a brightness ramp: the
        # synthetic analogue of the appearance cues a real mono net uses
        z = rng.uniform(8, 16, m)
        gt = np.stack([
            rng.uniform(-0.4, 0.4, m) * z, rng.uniform(0.8, 1.4, m), z,
            rng.uniform(3.5, 4.3, m), rng.uniform(1.5, 1.8, m),
            rng.uniform(1.4, 1.7, m), rng.uniform(-1, 1, m)],
            axis=1).astype(np.float32)
        h, w = cfg.image_size
        img = rng.random((h, w, 3)).astype(np.float32) * 0.1
        for bx in gt:
            u = int(K[0, 0] * bx[0] / bx[2] + K[0, 2])
            v = int(K[1, 1] * (bx[1] - bx[5] / 2) / bx[2] + K[1, 2])
            su = max(int(K[0, 0] * bx[3] / bx[2] / 2), 2)
            sv = max(int(K[1, 1] * bx[5] / bx[2] / 2), 2)
            img[max(v - sv, 0):v + sv, max(u - su, 0):u + su] = \
                0.25 + (bx[2] - 8.0) / 8.0 * 0.6
        return img, gt

    def batch(b=4, augment=True):
        imgs, ks, gts = [], [], []
        for _ in range(b):
            img, gt = scene()
            k = K
            if augment and rng.random() < 0.5:
                img, k, gt = flip_camera_frame(img, K, gt)
            imgs.append(img)
            ks.append(k)
            gts.append(gt)
        m = gts[0].shape[0]
        return dict(images=torch.as_tensor(np.stack(imgs), device=dev),
                    intrinsics=torch.as_tensor(np.stack(ks), device=dev),
                    gt_boxes=torch.as_tensor(np.stack(gts), device=dev),
                    gt_labels=torch.zeros((b, m), dtype=torch.int32,
                                          device=dev),
                    gt_mask=torch.ones((b, m), dtype=torch.bool,
                                       device=dev))

    batch()  # the JAX example's init batch: its draws come first
    model = Mono3D(cfg, device=dev,
                   generator=torch.Generator().manual_seed(0))
    if weights is not None:
        model.load_state_dict(mono3d_state_from_flax(weights))
    opt, lr = make_optimizer(list(model.parameters()), steps, base_lr=5e-3)
    step = make_train_step(model, opt, cfg)
    losses = []
    for i in range(steps):
        aux = step(batch())
        if (i + 1) % 20 == 0 or i == 0:
            vals = {k: float(v) for k, v in aux.items()}
            print(f"step {i + 1:4d}: loss={vals['total']:.3f} "
                  f"hm={vals['hm']:.3f} reg={vals['reg']:.3f} "
                  f"lr={float(lr(i)):.2e}")
        losses.append(aux)
    losses = [{k: float(v) for k, v in aux.items()} for aux in losses]

    # evaluate on fresh scenes: detect -> camera-frame targets -> 3D mAP
    detect = make_mono3d_detector(model, None, cfg, [CAR],
                                  score_threshold=0.2, device=dev)
    # monocular metric convention: center-distance matching (nuScenes
    # protocol): 3D IoU punishes depth error too hard for mono models
    ev = DetectionEvaluator([CAR], [4.0],
                            distance_metric=DistanceTypes.Position,
                            device=dev)
    derr = []
    for _ in range(8):
        img, gt = scene()
        dt = detect(img, K, frame="cam")
        gt_arr = mono3d_to_targets(gt, np.ones(len(gt)),
                                   np.zeros(len(gt), np.int64), [CAR],
                                   frame="cam", score_threshold=0.0)
        ev.add_stats(ev.calc_stats(gt_arr, dt))
        for g in gt:
            if len(dt):
                derr.append(min(abs(float(o.position[2]) - g[2])
                                for o in dt))
    ap = float(ev.ap()[CAR])
    depth_err = float(np.median(derr)) if derr else float("nan")
    print(f"synthetic-val AP@4m center distance: {ap:.3f}; median |depth "
          f"err| {depth_err:.1f} m (smoke scale — see docstring)")
    return dict(losses=losses, ap=ap, depth_err=depth_err)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.steps, args.device)


if __name__ == "__main__":
    main()

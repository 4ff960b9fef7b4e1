"""Train a PointPillars detector end to end on the port (the PyTorch
counterpart of ``train_pointpillars.py``).

The full production pipeline: dataset (or synthetic) frames -> global
augmentation -> pillarization on the device -> device-side target
preparation -> mesh-sharded bf16 train step -> Trainer with background
checkpoints, resumed from the latest one when the directory has one.

The mesh spans the job's ranks: a ``torchrun`` job's (one card a rank,
``LOCAL_RANK``'s), or else a world of one that this script starts (and
ends) itself.

Runs out of the box on synthetic data:
    python examples/torch_train_pointpillars.py --steps 50 --batch 2
    python examples/torch_train_pointpillars.py --tiny --device cpu
With a real KITTI object dataset:
    python examples/torch_train_pointpillars.py --kitti /data/kitti --steps 2000
"""

import argparse
import contextlib
import os
import shutil
import sys
import tempfile
from dataclasses import replace

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from d3d_tpu_torch.augment import global_augment  # noqa: E402
from d3d_tpu_torch.checkpoint import TrainCheckpointer  # noqa: E402
from d3d_tpu_torch.models.pointpillars import (  # noqa: E402
    PointPillars, PointPillarsConfig, make_anchors, make_train_step,
    pillarize, prepare_targets)
from d3d_tpu_torch.parallel import (initialize, make_mesh,  # noqa: E402
                                    shard_train_step, spatial_constrain)
from d3d_tpu_torch.train import Trainer  # noqa: E402
from d3d_tpu_torch.utils import resolve_device  # noqa: E402

MAX_GT = 32
DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "pp_ckpts_torch")


def synthetic_frames(rng, cfg, n, npts=120_000):
    """Random clouds with a few car-sized boxes (stand-in for a loader)."""
    for _ in range(n):
        pts = np.stack([
            rng.uniform(cfg.bounds[0], cfg.bounds[1], npts),
            rng.uniform(cfg.bounds[2], cfg.bounds[3], npts),
            rng.uniform(cfg.bounds[4], cfg.bounds[5], npts),
            rng.uniform(0, 1, npts)], axis=1).astype(np.float32)
        m = int(rng.integers(3, 10))
        b = cfg.bounds  # sample INSIDE the scene so anchors go positive
        boxes = np.stack([
            rng.uniform(b[0] + 3, b[1] - 3, m),
            rng.uniform(b[2] + 2, b[3] - 2, m),
            np.full(m, -1.0), np.full(m, 3.9), np.full(m, 1.6),
            np.full(m, 1.56),
            rng.uniform(-np.pi / 2, np.pi / 2, m)], axis=1).astype(np.float32)
        yield pts, boxes, np.zeros(m, np.int64)


def kitti_frames(path, cfg, split="training"):
    from d3d_tpu_torch.dataset.kitti import KittiObjectLoader

    loader = KittiObjectLoader(path, inzip=False)
    for idx in range(len(loader)):
        cloud = np.asarray(loader.lidar_data(idx))[:, :4]
        objs = loader.annotation_3dobject(idx)
        boxes = objs.boxes7().astype(np.float32)
        labels = np.asarray([b.tag.labels[0] for b in objs])  # int values
        yield cloud.astype(np.float32), boxes, labels


def make_batches(frames, cfg, batch_size, generator, device):
    """Augment and pillarize frames on ``device`` into batches; the
    augmentation draws from ``generator`` (a ``torch.Generator``)."""
    buf = []
    for pts, boxes, labels in frames:
        m = min(len(boxes), MAX_GT)
        gt = np.zeros((MAX_GT, 7), np.float32)
        gt[:m] = boxes[:m]
        p2, b2 = global_augment(generator, torch.as_tensor(pts, device=device),
                                torch.as_tensor(gt, device=device))
        feats, coords, valid = pillarize(p2, cfg)
        lab = torch.zeros(MAX_GT, dtype=torch.int32, device=device)
        mask = torch.arange(MAX_GT, device=device) < m  # single class
        buf.append((feats, coords, valid, b2, lab, mask))
        if len(buf) == batch_size:
            f, c, v, g, l, mk = (torch.stack(x) for x in zip(*buf))
            yield dict(features=f, coords=c, valid=v, gt_boxes=g,
                       gt_labels=l, gt_mask=mk)
            buf = []


@contextlib.contextmanager
def process_group(device):
    """The job's process group: a ``torchrun`` job's or one that exists
    already, else a world of one (a FileStore in a temporary directory)
    started here and ended on exit. Yields this rank's device: in a
    ``torchrun`` job on CUDA, the card ``LOCAL_RANK`` names (NCCL takes
    one card a rank)."""
    if device.type == "cuda" and os.environ.get("LOCAL_RANK"):
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    store = tempfile.mkdtemp(prefix="pp_train_store")
    kw = {} if device.type == "cuda" else dict(backend="gloo")
    started = (initialize(**kw) or initialize(
        "file://" + os.path.join(store, "store"), 1, 0, **kw))
    try:
        yield device
    finally:
        if started:
            torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def run(kitti=None, steps=50, batch=2, ckpt_dir=DEFAULT_CKPT_DIR, lr=2e-4,
        tiny=False, device="cuda", weights=None):
    """Train ``steps`` steps on ``device``, resuming from ``ckpt_dir``.

    :param weights: optional flax variables (numpy leaves) of the JAX
        example's model, carried over by
        :func:`~d3d_tpu_torch.models.pointpillars_state_from_flax`; seeded
        weights without them
    :returns: ``{"start", "step", "losses": [each step's total loss]}``
    """
    from d3d_tpu_torch.models import pointpillars_state_from_flax

    dev = resolve_device(device)
    cfg = replace(PointPillarsConfig(), dtype="bfloat16")
    if tiny:
        cfg = replace(cfg, bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0),
                      grid=(32, 32), max_pillars=256,
                      max_points_per_pillar=16, pfn_features=32,
                      backbone_channels=(32, 64), backbone_blocks=(1, 1),
                      upsample_channels=32)
    with process_group(dev) as dev:
        anchors = make_anchors(cfg, device=dev)
        mesh = make_mesh(device_type=dev.type)
        dp = mesh.shape["dp"]
        if batch % dp:
            batch = ((batch + dp - 1) // dp) * dp
            print(f"batch rounded up to {batch} "
                  f"(must divide the {dp}-way dp axis)")
        rng = np.random.default_rng(0)
        frames = (kitti_frames(kitti, cfg) if kitti
                  else synthetic_frames(rng, cfg, steps * batch + 8,
                                        npts=2048 if tiny else 120_000))
        batches = make_batches(frames, cfg, batch,
                               torch.Generator(dev).manual_seed(0), dev)

        first = next(batches)
        # spatial_constrain runs whole canvases on the default sp=1 mesh;
        # pass sp= to make_mesh above to split the conv backbone's rows
        model = PointPillars(cfg, device=dev,
                             generator=torch.Generator().manual_seed(0),
                             constrain=spatial_constrain(mesh))
        if weights is not None:
            model.load_state_dict(pointpillars_state_from_flax(weights))
        opt = torch.optim.Adam(model.parameters(), lr=lr)
        sharded = shard_train_step(
            make_train_step(model, opt, cfg, anchors, external_targets=True,
                            remat=False), mesh)
        losses = []

        def step(b):
            aux = sharded(b)
            losses.append(aux["total"])  # read after the run: no sync here
            return aux

        step.train_state = sharded.train_state  # checkpoints save it whole

        def prep(b):
            return prepare_targets(anchors, b, cfg.pos_iou, cfg.neg_iou,
                                   num_classes=cfg.num_classes, dense=True)

        trainer = Trainer(step, prep_fn=prep,
                          checkpointer=TrainCheckpointer(ckpt_dir),
                          log_every=10, ckpt_every=500)
        start = trainer.restore_or(model, opt)

        def chain():
            yield first
            yield from batches

        step_n = trainer.run(model, opt, chain(), num_steps=steps,
                             start_step=start)
        print(f"trained to step {step_n}")
    return dict(start=start, step=step_n,
                losses=[float(x) for x in losses])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kitti", default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--tiny", action="store_true",
                    help="small grid + clouds for a fast smoke run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.kitti, args.steps, args.batch, args.ckpt_dir, args.lr,
               args.tiny, args.device)


if __name__ == "__main__":
    main()

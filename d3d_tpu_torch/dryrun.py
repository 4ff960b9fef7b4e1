"""The repo's two entry points on the port: a single-device forward
check and a multi-rank dry run of the scale-out layer (the counterpart
of the JAX package's ``__graft_entry__.py``).

* :func:`entry` returns the forward of the flagship ``PointPillars`` on
  a 256 x 256 grid of 8 000 pillars x 24 points, with example inputs on
  the device.
* :func:`dryrun_multichip` runs, on ``n`` ranks, one sharded training
  step over a ``('dp', 'sp', 'tp')`` mesh (BEV rows over ``sp`` once
  ``n`` allows all three axes), dp-sharded serving and evaluation, and
  when ``n % 4 == 0`` a GPipe gradient step through SST's trunk on four
  pipeline ranks and SST-MoE's training step with its experts over an
  ``ep`` axis.

The ranks are child processes of the caller (``python -m
d3d_tpu_torch.dryrun --rank ...``) joined by a ``FileStore`` in a
temporary directory: one card a rank under NCCL, or gloo ranks on the
CPU with ``device="cpu"``. Every draw comes from the JAX function's
``numpy`` generator in the same order, so weights carried over from its
flax init (``weights=``) give the same inputs, loss and scores.

Usage::

    python -m d3d_tpu_torch.dryrun                 # every card, NCCL
    python -m d3d_tpu_torch.dryrun --device cpu    # 8 gloo ranks
"""

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .utils import resolve_device

__all__ = ["entry", "dryrun_multichip"]

# __graft_entry__.py's configurations: entry()'s flagship forward, the
# dry run's PointPillars and its SST trunk
ENTRY_CONFIG = dict(bounds=(0.0, 51.2, -25.6, 25.6, -3.0, 1.0),
                    grid=(256, 256), max_pillars=8000,
                    max_points_per_pillar=24)
DRYRUN_CONFIG = dict(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32),
                     max_pillars=256, max_points_per_pillar=16,
                     pfn_features=64, backbone_channels=(64, 128),
                     backbone_blocks=(1, 1), upsample_channels=64)
SST_CONFIG = dict(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32),
                  max_pillars=256, max_points_per_pillar=16, pfn_features=32,
                  window=8, capacity=16, depth=4, num_heads=2,
                  neck_channels=32)


def _make_batch(rng, cfg, b, device):
    """``b`` copies of one seeded frame, pillarized, and four seeded car
    boxes: the JAX function's draws in its order."""
    from .models import pillarize

    n = 8192
    xmin, xmax, ymin, ymax, zmin, zmax = cfg.bounds
    pts = np.stack([
        rng.random(n) * (xmax - xmin) + xmin,
        rng.random(n) * (ymax - ymin) + ymin,
        rng.random(n) * (zmax - zmin) + zmin,
        rng.random(n),
    ], axis=1).astype(np.float32)
    # every row of the batch is the same cloud, so one pillarize serves
    one = pillarize(torch.as_tensor(pts, device=device), cfg)
    feats, coords, valid = (torch.stack([t] * b) for t in one)

    m = 4
    gt = np.stack([
        rng.random(m) * (xmax - xmin - 8) + xmin + 4,
        rng.random(m) * (ymax - ymin - 8) + ymin + 4,
        np.full(m, -1.0),
        np.full(m, 3.9), np.full(m, 1.6), np.full(m, 1.56),
        rng.random(m) * np.pi,
    ], axis=1).astype(np.float32)
    return dict(
        features=feats, coords=coords, valid=valid,
        gt_boxes=torch.as_tensor(np.broadcast_to(gt, (b, m, 7)).copy(),
                                 device=device),
        gt_labels=torch.zeros((b, m), dtype=torch.int32, device=device),
        gt_mask=torch.ones((b, m), dtype=torch.bool, device=device))


def _model(cls, cfg, weights, convert, seed, device, **kw):
    """``cls(cfg, **kw)`` on ``device`` with the flax ``weights`` converted
    by ``convert``, or seeded weights without them."""
    model = cls(cfg, device=device,
                generator=torch.Generator().manual_seed(seed), **kw)
    if weights is not None:
        model.load_state_dict(convert(weights))
    return model


def entry(device="cuda"):
    """The flagship forward and its example arguments: ``(forward,
    (features, coords, valid))`` where ``forward(features, coords, valid)``
    is ``PointPillars``' inference pass with seeded weights, on ``device``
    (default CUDA; raises without it)."""
    from .models import PointPillars, PointPillarsConfig

    dev = resolve_device(device)
    cfg = PointPillarsConfig(**ENTRY_CONFIG)
    batch = _make_batch(np.random.default_rng(0), cfg, 1, dev)
    model = PointPillars(cfg, device=dev,
                         generator=torch.Generator().manual_seed(0)).eval()

    @torch.inference_mode()
    def forward(features, coords, valid):
        return model(features, coords, valid, train=False)

    forward.model = model
    return forward, (batch["features"], batch["coords"], batch["valid"])


def _eval_frames(rng, n):
    """``n`` frames of three seeded cars each (the JAX function's
    evaluator input), scored and matched against themselves."""
    from scipy.spatial.transform import Rotation

    from .abstraction import ObjectTag, ObjectTarget3D, Target3DArray
    from .dataset.kitti.utils import KittiObjectClass

    frames = []
    for _ in range(n):
        arr = Target3DArray(frame="velo")
        for i in range(3):
            arr.append(ObjectTarget3D(
                rng.uniform(2, 14, 3) * [1, 1, 0] + [0, -7 + i * 5, -1],
                Rotation.from_euler("Z", rng.uniform(-3, 3)),
                [3.9, 1.6, 1.56],
                ObjectTag(KittiObjectClass.Car,
                          scores=float(rng.uniform(0.3, 1)))))
        frames.append(arr)
    return frames


def _launches():
    from .ops import geometry_cuda, nms_cuda, rulebook, sparse_conv_cuda

    fns = (geometry_cuda.rbox_iou_matrix, nms_cuda.nms_scan,
           nms_cuda.nms_scan_blocked, nms_cuda.soft_nms_scan,
           sparse_conv_cuda.subm_conv, sparse_conv_cuda.subm_conv_dw,
           rulebook.subm_conv_rulebook)
    return {fn.__name__: fn.launches for fn in fns}


def _routes():
    """K1's launches by output form and the NMS scan's by route."""
    from .ops import geometry_cuda, nms_cuda

    return {**{f"k1_{k}": v for k, v in geometry_cuda._FORMS.items()},
            **{("pack" if k == "pack" else f"scan_{k}"): v
               for k, v in nms_cuda._ROUTES.items()}}


def _pipeline_step(rng, n, dev, device_type, weights):
    """SST's trunk GPipe-pipelined over 4 pp ranks (x n/4 dp), one SGD
    step on the loss mean(out^2); returns the loss."""
    from .models import SST, SSTConfig, sst_state_from_flax
    from .models.sst import pipeline_sst_trunk
    from .parallel import make_pp_mesh, microbatch

    cfg = SSTConfig(**SST_CONFIG)
    batch = _make_batch(rng, cfg, 4, dev)
    args = (batch["features"], batch["coords"], batch["valid"])
    model = _model(SST, cfg, weights, sst_state_from_flax, 2, dev)
    embed = SST(cfg, stage="embed", device=dev).requires_grad_(False)
    embed.load_state_dict(model.state_dict())
    with torch.no_grad():
        pf0 = embed(*args, train=False)
    pp_dp = n // 4
    mesh = make_pp_mesh(4, dp=pp_dp, device_type=device_type)
    out = pipeline_sst_trunk(
        model, cfg, mesh, microbatch(pf0, 2), microbatch(batch["coords"], 2),
        microbatch(batch["valid"], 2),
        batch_axis="dp" if pp_dp > 1 else None)
    loss = torch.mean(out ** 2)
    loss.backward()
    torch.optim.SGD(model.parameters(), lr=1e-2).step()
    grads = [p.grad for p in model.blocks.parameters()]
    if not (torch.isfinite(loss) and all(
            g is not None and bool(torch.isfinite(g).all()) for g in grads)):
        raise AssertionError("pp grads non-finite")
    if max(float(g.abs().max()) for g in grads) <= 0:
        raise AssertionError("pipelined trunk produced zero grads")
    return float(loss)


def _expert_step(rng, n, dev, device_type, weights):
    """SST-MoE's training step on an (n/2, 2) dp x ep mesh, one expert an
    ep rank; returns the loss."""
    from .models import (SST, SSTConfig, make_anchors, sst_state_from_flax)
    from .models.pointpillars import make_train_step
    from .parallel import expert_constrain, shard_train_step, tp_param_report
    from .parallel.mesh import _mesh

    cfg = dataclasses.replace(SSTConfig(**SST_CONFIG), moe_experts=2,
                              moe_capacity=16)
    mesh = _mesh(device_type, list(range(n)), (n // 2, 2), ("dp", "ep"))
    model = _model(SST, cfg, weights, sst_state_from_flax, 3, dev,
                   moe_constrain=expert_constrain(mesh))
    batch = _make_batch(rng, cfg, n // 2, dev)
    sharded, _ = tp_param_report(model, mesh)
    if not any("moe_w1" in p for p in sharded):
        raise AssertionError("expert weights did not shard over the ep axis")
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = shard_train_step(
        make_train_step(model, opt, cfg, make_anchors(cfg, device=dev)),
        mesh, donate=False)
    loss = float(step(batch)["total"])
    if not np.isfinite(loss):
        raise AssertionError("ep train step non-finite")
    return loss


def _run_rank(n, dev, device_type, weights):
    """What every rank of :func:`dryrun_multichip` runs; returns its
    ``{mesh, loss, ap, pp_loss, ep_loss, seconds, serve}``."""
    from .benchmarks import DetectionEvaluator
    from .benchmarks_device import device_calc_stats
    from .dataset.kitti.utils import KittiObjectClass
    from .models import (PointPillars, PointPillarsConfig, make_anchors,
                         make_pointpillars_detector,
                         pointpillars_state_from_flax)
    from .models.pointpillars import make_train_step
    from .parallel import make_mesh, shard_train_step, spatial_constrain
    from .parallel.mesh import shard_inference

    weights = weights or {}
    seconds = {}
    t0 = time.perf_counter()
    cfg = PointPillarsConfig(**DRYRUN_CONFIG)
    # a spatial axis whenever the rank count allows all three axes
    sp = 2 if n % 8 == 0 else 1
    mesh = make_mesh(n, sp=sp, device_type=device_type)
    dp = mesh.shape["dp"]
    rng = np.random.default_rng(0)
    batch = _make_batch(rng, cfg, max(2 * dp, dp), dev)

    model = _model(PointPillars, cfg, weights.get("pointpillars"),
                   pointpillars_state_from_flax, 0, dev,
                   constrain=spatial_constrain(mesh))
    anchors = make_anchors(cfg, device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = shard_train_step(make_train_step(model, opt, cfg, anchors,
                                            riou_weight=0.1),
                            mesh, donate=False)
    total = float(step(batch)["total"])
    if not np.isfinite(total):
        raise AssertionError("training step produced non-finite loss")
    seconds["train"] = time.perf_counter() - t0

    # data-parallel serving over the same mesh, on an unconstrained model
    # with the trained weights (the spatial hook is a batched-path hook)
    t0 = time.perf_counter()
    detect = make_pointpillars_detector(
        PointPillars(cfg, device=dev), step.full_state_dict(), cfg, anchors,
        [KittiObjectClass.Car], top_k=16, device=dev)
    n_pts = 2048
    clouds = np.stack([
        np.stack([rng.random(n_pts) * 16, rng.random(n_pts) * 16 - 8,
                  rng.random(n_pts) * 4 - 3, rng.random(n_pts)], axis=1)
        for _ in range(dp)]).astype(np.float32)
    boxes, scores, labels, keep = shard_inference(detect.device_fn,
                                                  mesh)(clouds)
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError("sharded inference produced non-finite scores")
    seconds["serve"] = time.perf_counter() - t0

    # dp-sharded evaluation with mergeable stats
    t0 = time.perf_counter()
    frames = _eval_frames(rng, 2 * dp)
    ev = DetectionEvaluator([KittiObjectClass.Car], [0.5], device=dev)
    ev.add_stats(device_calc_stats(ev, frames, frames, mesh=mesh))
    ap = float(ev.ap()[KittiObjectClass.Car])
    if not ap > 0.99:
        raise AssertionError(f"self-match AP {ap} on the dp-sharded "
                             "evaluator")
    seconds["eval"] = time.perf_counter() - t0

    pp_loss = ep_loss = None
    if n % 4 == 0:
        t0 = time.perf_counter()
        pp_loss = _pipeline_step(rng, n, dev, device_type,
                                 weights.get("sst"))
        seconds["pp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ep_loss = _expert_step(rng, n, dev, device_type,
                               weights.get("sst_moe"))
        seconds["ep"] = time.perf_counter() - t0
    return dict(mesh=mesh.shape, loss=total, ap=ap, pp_loss=pp_loss,
                ep_loss=ep_loss, seconds=seconds,
                serve=[t.cpu() for t in (boxes, scores, keep)])


def _rank_main(rank, world, outdir, device):
    """One rank: join the group, run :func:`_run_rank`, save its result
    with the kernels' launches on this rank."""
    import torch.distributed as dist

    from .parallel import initialize

    outdir = Path(outdir)
    if device == "cuda":
        torch.cuda.set_device(rank)
        dev, kw = resolve_device(f"cuda:{rank}"), {}
    else:
        torch.set_num_threads(1)
        dev, kw = torch.device("cpu"), dict(backend="gloo")
    initialize("file://" + str(outdir / "store"), world, rank, **kw)
    inputs = outdir / "inputs.pt"
    weights = (torch.load(inputs, weights_only=False)
               if inputs.exists() else None)
    try:
        out = _run_rank(world, dev, dev.type, weights)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["launches"], out["routes"] = _launches(), _routes()
        torch.save(out, outdir / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"RANK {rank} OK", flush=True)


def _spawn(world, outdir, device):
    """Run the ``world`` ranks as one :class:`RankGroup` and return each
    rank's result."""
    from .parallel.launch import RankGroup

    root = str(Path(__file__).resolve().parents[1])
    env = dict(PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    RankGroup("dryrun_multichip", lambda r: [
        sys.executable, "-m", "d3d_tpu_torch.dryrun", "--rank", str(r),
        "--world", str(world), "--dir", str(outdir), "--device", device],
        world, outdir, env=env).wait()
    return [torch.load(outdir / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def dryrun_multichip(n_devices, device="cuda", weights=None):
    """Run the sharded training step, dp-sharded serving and evaluation,
    and with ``n_devices % 4 == 0`` the pipelined SST trunk and SST-MoE's
    expert-parallel step, on ``n_devices`` ranks (child processes).

    :param device: ``"cuda"`` (one card a rank, NCCL; raises when there
        are fewer cards than ranks: NCCL refuses two ranks on one card) or
        ``"cpu"`` (gloo ranks)
    :param weights: optional ``{"pointpillars", "sst", "sst_moe"}`` flax
        variables (numpy leaves), each converted by ``models/convert.py``;
        a missing one is seeded
    :returns: rank 0's ``{mesh, loss, ap, pp_loss, ep_loss, seconds}``
        and ``serve``, the dp-sharded detector's gathered ``(boxes,
        scores, keep)`` on the CPU; ``launches``, each kernel wrapper's
        launches, and ``routes``, K1's by output form and the NMS scan's
        by route, summed over the ranks
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs a card a rank; "
            f"{torch.cuda.device_count()} visible (NCCL refuses two ranks "
            "on one card)")
    outdir = Path(tempfile.mkdtemp(prefix="d3d_dryrun_"))
    try:
        if weights is not None:
            torch.save(weights, outdir / "inputs.pt")
        results = _spawn(n_devices, outdir, dev.type)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    out = dict(results[0])
    for key in ("launches", "routes"):
        out[key] = {k: sum(r[key][k] for r in results)
                    for k in results[0][key]}
    print(f"dryrun_multichip({n_devices}): mesh={out['mesh']} "
          f"loss={out['loss']:.4f} infer+eval OK (ap={out['ap']:.3f}) "
          f"pp[SST trunk grad]={out['pp_loss']} ep_loss={out['ep_loss']}",
          flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: a rank on every card; cpu: 8 gloo ranks")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dir", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank_main(args.rank, args.world, args.dir, args.device)
        return
    fn, inputs = entry(args.device)
    out = fn(*inputs)
    print("entry forward OK:", [tuple(o.shape) for o in out], flush=True)
    dryrun_multichip(torch.cuda.device_count() if args.device == "cuda"
                     else 8, device=args.device)


if __name__ == "__main__":
    main()

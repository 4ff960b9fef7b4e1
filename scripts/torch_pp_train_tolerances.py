"""The readings behind chip_smoke.py's PointPillars-training limits, on one
NVIDIA GPU.

Run from the root of a checkout, on a machine with CUDA and nvcc::

    python3 scripts/torch_pp_train_tolerances.py

For five seeds (the random weights and the augmented batch of 2 frames
both change with the seed; seed 0 is chip_smoke.py's), at full width (``presets.pointpillars_kitti``)
as chip_smoke.py's ``pointpillars_train`` path builds them, it prints:

* the gradients of one float32 step (TF32 off) on the card and on the CPU
  against the float64 step on the card (the network, BatchNorm, heads,
  loss and cotangent in float64): each run's worst leaf, max |g - g64|
  over the leaf's largest |g64| (``chip_smoke.grad_err``);
* the same error for two planted faults: the card's float32 step with
  BatchNorm's statistics taken per frame instead of over the batch (a
  wrong reduction axis), and the float64 gradient of one leaf with its two
  channel axes or its two kernel axes swapped (a transposed leaf; the
  smallest such error over the leaves where the swap keeps the shape and
  moves entries);
* the folded model's raw outputs against the unfolded one's, max |f - b| /
  (1 + |b|) (``chip_smoke.fold_rel_err``), after five float32 steps on
  the seed's batch (the float32 step above and four more, a new
  optimizer), and the same for a planted fault: the fold scaling the
  square convolutions along their input axis.

The last line is one JSON object with every reading and the limits
chip_smoke.py holds them to. Imports no JAX.
"""

import contextlib
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from d3d_tpu_torch.augment import build_gt_database  # noqa: E402
from d3d_tpu_torch.models import (PointPillars, make_anchors,  # noqa: E402
                                  prepare_targets, presets)
from d3d_tpu_torch.models import fold, pointpillars  # noqa: E402
from d3d_tpu_torch.models.pointpillars import make_train_step  # noqa: E402
from d3d_tpu_torch.train import batch_frames, make_optimizer  # noqa: E402

SEEDS = (0, 1, 2, 3, 4)


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def bn_per_frame(x, bn, real=pointpillars._bn_train):
    """The planted BatchNorm fault: the convolutions' statistics over each
    frame's own map, not over the batch (running statistics untouched)."""
    if x.ndim != 4:
        return real(x, bn)
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dim=(2, 3), keepdim=True)
                          - mean * mean, 0.0)
    y = ((xf - mean) * torch.rsqrt(var + bn.eps) * bn.weight.view(1, -1, 1, 1)
         + bn.bias.view(1, -1, 1, 1))
    return y.to(x.dtype)


def wrong_axes(model, real=fold.output_axes):
    """The planted fold fault: square convolutions scaled along axis 1."""
    axes = real(model)
    for name, p in model.named_parameters():
        if p.ndim == 4 and p.shape[0] == p.shape[1] and axes.get(name) == 0:
            axes[name] = 1
    return axes


def transposed_leaf(ref):
    """The smallest error one leaf of ``ref`` reads with its channel axes
    (0, 1) or kernel axes (2, 3) swapped, over the leaves where the swap
    keeps the shape and moves entries: (error, leaf, axes)."""
    worst = (float("inf"), "", None)
    for leaf, g in ref.items():
        for axes in ((0, 1), (2, 3)):
            if (g.ndim <= max(axes) or g.shape[axes[0]] != g.shape[axes[1]]
                    or g.shape[axes[0]] == 1):
                continue
            err = smoke.grad_err({leaf: g.transpose(*axes)}, {leaf: g})[0]
            worst = min(worst, (err, leaf, axes))
    return worst


def fold_errors(dev, cfg, model, frame):
    base = [o.float() for o in smoke.forward(model, frame, dev)]
    out = {}
    for name, axes in (("fold", fold.output_axes),
                       ("fold_fault_wrong_axis", wrong_axes)):
        with patched(fold, "output_axes", axes):
            sd = fold.fold_batchnorm(model)
        folded = PointPillars(cfg, device=dev)
        folded.load_state_dict(sd)
        out[name] = smoke.fold_rel_err(
            [o.float() for o in smoke.forward(folded, frame, dev)], base)
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_pp_train_tolerances: CUDA is not available",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = presets.pointpillars_kitti(dtype="float32")
    anchors = make_anchors(cfg, device=dev)
    frames, _ = smoke.pp_train_frames()
    db = build_gt_database(frames, device=dev)
    readings = []
    for seed in SEEDS:
        init = PointPillars(cfg, device=dev,
                            generator=torch.Generator().manual_seed(seed))
        smoke.calibrate_heads(init, frames[0][0], dev)
        state = {k: v.clone() for k, v in init.state_dict().items()}
        batch = next(batch_frames(smoke.pp_augmented(
            dev, cfg, frames, db, 900 + seed, smoke.PP_BATCH),
            smoke.PP_BATCH))
        batch = prepare_targets(anchors, batch, cfg=cfg, dense=True)
        runs, cpu_ms = smoke.pp_grad_runs(dev, cfg, state, batch)
        ref = runs["f64"][1]
        with patched(pointpillars, "_bn_train", bn_per_frame):
            fault = smoke.pp_grad_runs(dev, cfg, state, batch,
                                       runs=("card",))[0]["card"][1]
        model = runs["card"][2]
        opt, _ = make_optimizer(model.parameters(), smoke.PP_STEPS)
        step = make_train_step(model, opt, cfg, anchors,
                               external_targets=True)
        for _ in range(smoke.PP_STEPS - 1):
            step(batch)
        r = dict(seed=seed, loss_f64=runs["f64"][0],
                 loss_card=runs["card"][0], loss_cpu=runs["cpu"][0],
                 card=smoke.grad_err(runs["card"][1], ref),
                 cpu=smoke.grad_err(runs["cpu"][1], ref),
                 fault_bn_per_frame=smoke.grad_err(fault, ref),
                 fault_transposed_leaf=transposed_leaf(ref),
                 cpu_step_ms=cpu_ms,
                 **fold_errors(dev, cfg, model, frames[seed][0]))
        smoke.log(f"seed {seed}: {r}")
        readings.append(r)
    print(json.dumps(dict(card=card, readings=readings,
                          limits=dict(grad=smoke.PP_GRAD_LIMIT,
                                      fold=smoke.PP_FOLD_TOL))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

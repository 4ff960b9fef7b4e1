"""CenterPoint, the anchor-free BEV detector (port of
``d3d_tpu.models.centerpoint``).

The pillar encoder and BEV backbone are PointPillars' (``_PFN``,
``_ConvBlock``, ``_Upsample``, ``scatter_to_bev``); the head is a
per-class centre heatmap plus dense regression maps, trained with the
penalty-reduced focal loss and decoded with a 3x3 max-pool peak NMS and a
flat top-k. Every shape is fixed. The network runs NCHW with x along the
first spatial axis; its outputs are the JAX module's NHWC maps
``(B, W, H, C)`` in float32.

Reference: Yin et al., "Center-based 3D Object Detection and Tracking",
CVPR 2021 (arXiv:2006.11275); CornerNet gaussian targets (Law & Deng,
ECCV 2018).
"""

import contextlib
import math
import warnings
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.voxel import _to_int32
from ..parallel.comm import batch_sum
from ..utils import as_tensor, resolve_device
from .pointpillars import (_PFN, _ConvBlock, _Upsample, _bev_backbone,
                           _bev_hooks, _buffers_kept, _train_step,
                           scatter_to_bev)

__all__ = ["CenterPointConfig", "CenterPoint", "assign_center_targets",
           "center_loss", "decode_centers", "prepare_center_targets",
           "make_train_step"]

# the regression heads in the order of the targets' ``vec`` columns
_REG_HEADS = (("reg", 2), ("height", 1), ("dim", 3), ("rot", 2))


@dataclass(frozen=True)
class CenterPointConfig:
    """Static model configuration (the JAX module's fields and
    defaults)."""

    bounds: Tuple[float, ...] = (0.0, 69.12, -39.68, 39.68, -3.0, 1.0)
    grid: Tuple[int, int] = (432, 496)
    max_pillars: int = 12000
    max_points_per_pillar: int = 32
    pfn_features: int = 64
    backbone_channels: Tuple[int, ...] = (64, 128, 256)
    backbone_blocks: Tuple[int, ...] = (3, 5, 5)
    upsample_channels: int = 128
    num_classes: int = 1
    head_channels: int = 64
    window: int = 15          # gaussian splat window (odd)
    min_radius: int = 2
    gaussian_overlap: float = 0.1
    top_k: int = 100
    # BEV velocity head (the nuScenes configuration: multi-sweep input)
    predict_velocity: bool = False
    dtype: str = "float32"

    @property
    def voxel_size(self):
        b = np.asarray(self.bounds).reshape(3, 2)
        return (b[:, 1] - b[:, 0]) / np.array([*self.grid, 1])


def _heads(cfg):
    heads = (("hm", cfg.num_classes),) + _REG_HEADS
    return heads + (("vel", 2),) if cfg.predict_velocity else heads


class CenterPoint(nn.Module):
    """PFN -> BEV scatter -> backbone -> centre heads. Input is the batched
    output of :func:`~d3d_tpu_torch.models.pointpillars.pillarize` (a
    ``CenterPointConfig`` serves as its config).

    Each head is a 3x3 SAME convolution to ``head_channels``, a ReLU and a
    1x1 convolution, named as the flax module's (``heads.hm_conv``,
    ``heads.hm_out``, ...); the heatmap's output bias starts at -2.19
    (logit 0.1, the focal-loss start).

    :param constrain: optional activation hook ``(x, kind) -> x`` called
        on the BEV canvas (NCHW) with kind "bev";
        :func:`~d3d_tpu_torch.parallel.mesh.spatial_constrain`'s runs the
        backbone and heads on this rank's slab of rows and joins the head
        maps whole
    :param return_feat: also return the shared BEV map (key ``feat``) for
        the two-stage refinement (:mod:`.centerpoint2`)
    :param point_features: channels per input point (4: x, y, z,
        intensity; 5 with the sweep time); the PFN sees 5 more
    :param device: where the parameters live (default CUDA; raises when
        CUDA is missing and no device is given)
    :param generator: ``torch.Generator`` for the random initial weights
        (default: a generator seeded with 0)
    """

    def __init__(self, cfg: CenterPointConfig, constrain=None,
                 return_feat=False, point_features=4, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.constrain = constrain
        self.return_feat = return_feat
        self.pfn = _PFN(point_features + 5, cfg.pfn_features, cfg.dtype)
        blocks, ups = [], []
        ch_in = cfg.pfn_features
        for i, (ch, nb) in enumerate(zip(cfg.backbone_channels,
                                         cfg.backbone_blocks)):
            blocks.append(_ConvBlock(ch_in, ch, nb, 2 if i > 0 else 1,
                                     cfg.dtype))
            ups.append(_Upsample(ch, cfg.upsample_channels, 2 ** i,
                                 cfg.dtype))
            ch_in = ch
        self.blocks = nn.ModuleList(blocks)
        self.ups = nn.ModuleList(ups)
        feat = cfg.upsample_channels * len(blocks)
        layers = {}
        for name, n_out in _heads(cfg):
            layers[f"{name}_conv"] = nn.Conv2d(feat, cfg.head_channels, 3)
            layers[f"{name}_out"] = nn.Conv2d(cfg.head_channels, n_out, 1)
        self.heads = nn.ModuleDict(layers)
        self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Seeded random weights: He-normal kernels (LeCun-normal for the
        heads' outputs), zero biases but the heatmap's -2.19, identity
        BatchNorm statistics."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        outs = {self.heads[f"{n}_out"] for n, _ in _heads(self.cfg)}
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w[0].numel() if not isinstance(
                    mod, nn.ConvTranspose2d) else w.shape[0]
                gain = 1.0 if mod in outs else 2.0
                w.copy_(torch.randn(w.shape, generator=generator)
                        * math.sqrt(gain / fan_in))
                if mod.bias is not None:
                    mod.bias.fill_(-2.19 if mod is self.heads["hm_out"]
                                   else 0.0)
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()

    def forward(self, features, coords, valid, train=False):
        """Head maps ``heatmap`` (B, W, H, C), ``reg`` (.., 2), ``height``
        (.., 1), ``dim`` (.., 3), ``rot`` (.., 2)[, ``vel`` (.., 2)][,
        ``feat`` (.., 3 * upsample_channels)], float32 (float64 for a
        float64 model). ``train=True`` normalises by batch statistics and
        moves the running ones (the argument, not ``nn.Module.training``,
        selects it)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        out_dt = torch.promote_types(dt, torch.float32)
        pmask = (features != 0).any(dim=-1)
        pf = self.pfn(features, pmask, train)
        pf = pf * valid[..., None].to(pf.dtype)
        con, sp = _bev_hooks(self.constrain)
        x = con(scatter_to_bev(pf, coords, valid, cfg.grid).permute(
            0, 3, 1, 2), "bev")
        feat = _bev_backbone(self.blocks, self.ups, x, train, sp, dt)
        whole = (lambda t: t) if sp is None else sp.gather

        def head(name):
            conv, last = self.heads[f"{name}_conv"], self.heads[f"{name}_out"]
            w, bias = conv.weight.to(dt), conv.bias.to(dt)
            y = F.relu(F.conv2d(feat, w, bias, padding=1) if sp is None
                       else sp.conv2d(feat, w, 1, bias))
            y = F.conv2d(y, last.weight.to(dt), last.bias.to(dt))
            return whole(y).permute(0, 2, 3, 1).to(out_dt)

        keys = dict(hm="heatmap")
        out = {keys.get(name, name): head(name) for name, _ in _heads(cfg)}
        if self.return_feat:
            out["feat"] = whole(feat).permute(0, 2, 3, 1).to(out_dt)
        return out


def _gaussian_radius(l_cells, w_cells, min_overlap):
    """Radius such that any center within it keeps IoU >= min_overlap.

    The three CornerNet overlap cases with the quadratic roots
    ``(-b +- sqrt(b^2 - 4ac)) / (2a)``, in the JAX module's operation
    order (not the published code's divide-by-2 of every root)."""
    b1 = l_cells + w_cells
    c1 = l_cells * w_cells * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.clamp_min(b1 ** 2 - 4 * c1, 0.0))) / 2
    a2 = 4.0
    b2 = 2 * (l_cells + w_cells)
    c2 = (1 - min_overlap) * l_cells * w_cells
    r2 = (b2 - torch.sqrt(torch.clamp_min(b2 ** 2 - 4 * a2 * c2, 0.0))) \
        / (2 * a2)
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (l_cells + w_cells)
    c3 = (min_overlap - 1) * l_cells * w_cells
    r3 = (-b3 + torch.sqrt(torch.clamp_min(b3 ** 2 - 4 * a3 * c3, 0.0))) \
        / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def _cell_index(c, size):
    """floor(c) as int32 as XLA converts it (NaN -> 0, saturating), then
    clipped into [0, size - 1]."""
    return torch.clamp(_to_int32(torch.floor(torch.clamp(c, -2e9, 2e9))),
                       0, size - 1)


def assign_center_targets(cfg: CenterPointConfig, gt_boxes, gt_labels,
                          gt_mask, gt_velocity=None):
    """One frame of CenterPoint targets (no gradient; call under
    ``torch.no_grad()`` when the boxes carry one).

    :param gt_boxes: (M, 7) [x, y, z, l, w, h, yaw] padded ground truth
    :param gt_velocity: (M, 2) BEV velocities, read with
        ``cfg.predict_velocity`` (default zeros)
    :return: dict(heatmap (W, H, C), vec (W, H, 8 or 10), mask (W, H));
        ``vec`` is [dx, dy, z, log l, log w, log h, sin yaw, cos yaw]
        (+ [vx, vy] with the velocity head) at centres. Where two boxes
        share a centre cell the later one's vector wins (the JAX scatter's
        order), resolved per cell before any write.
    """
    w, h = cfg.grid
    m = gt_boxes.shape[0]
    dev = gt_boxes.device
    vx, vy, _ = [float(v) for v in cfg.voxel_size]
    win = cfg.window
    half = win // 2
    gt_boxes = gt_boxes.to(torch.float32)
    # 0-d divisors: torch on CUDA divides by a Python scalar as a multiply
    # by its reciprocal, an ulp off the CPU's (and XLA's) true division
    vx, vy = (torch.tensor(v, dtype=torch.float32, device=dev)
              for v in (vx, vy))

    cx = (gt_boxes[:, 0] - cfg.bounds[0]) / vx  # fractional cell coords
    cy = (gt_boxes[:, 1] - cfg.bounds[2]) / vy
    ix = _cell_index(cx, w)
    iy = _cell_index(cy, h)
    inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h) & gt_mask

    radius = torch.clamp_min(
        _gaussian_radius(gt_boxes[:, 3] / vx, gt_boxes[:, 4] / vy,
                         cfg.gaussian_overlap), cfg.min_radius)
    sigma2 = torch.clamp_min((2 * radius / 3.0) ** 2, 1e-6)

    # gaussian splat on a (win, win) window around each centre, scatter-max
    dxs = torch.arange(win, dtype=torch.int32, device=dev) - half
    gx = ix[:, None, None] + dxs[None, :, None]          # (M, win, 1)
    gy = iy[:, None, None] + dxs[None, None, :]          # (M, 1, win)
    d2 = ((gx - ix[:, None, None]) ** 2
          + (gy - iy[:, None, None]) ** 2).to(torch.float32)
    val = torch.exp(-d2 / (2 * sigma2[:, None, None]))
    cls = torch.clamp_min(gt_labels, 0).to(torch.int64)
    # a NaN value fails the > test, so the scatter-max below never sees NaN
    # (torch's amax would drop it where jnp.maximum keeps it); a label past
    # the classes is dropped, as JAX drops an out-of-bounds scatter update
    okw = ((inside & (cls < cfg.num_classes))[:, None, None]
           & (gx >= 0) & (gx < w) & (gy >= 0) & (gy < h) & (val > 1e-4))
    flat = torch.where(okw, gx * h + gy, w * h)           # trash cell
    idx = (flat.to(torch.int64) * cfg.num_classes
           + torch.where(okw, cls[:, None, None], 0))
    heat = torch.zeros((w * h + 1) * cfg.num_classes, dtype=torch.float32,
                       device=dev)
    heat = heat.scatter_reduce(0, idx.reshape(-1),
                               torch.where(okw, val, 0.0).reshape(-1),
                               "amax")
    heatmap = heat[:-cfg.num_classes].reshape(w, h, cfg.num_classes)

    cols = [
        cx - ix.to(torch.float32),
        cy - iy.to(torch.float32),
        gt_boxes[:, 2],
        torch.log(torch.clamp_min(gt_boxes[:, 3], 1e-3)),
        torch.log(torch.clamp_min(gt_boxes[:, 4], 1e-3)),
        torch.log(torch.clamp_min(gt_boxes[:, 5], 1e-3)),
        torch.sin(gt_boxes[:, 6]),
        torch.cos(gt_boxes[:, 6]),
    ]
    if cfg.predict_velocity:
        gv = (torch.zeros((m, 2), dtype=torch.float32, device=dev)
              if gt_velocity is None else gt_velocity.to(torch.float32))
        cols += [gv[:, 0], gv[:, 1]]
    vec = torch.stack(cols, dim=-1)                       # (M, 8 or 10)
    nv = vec.shape[-1]
    cflat = torch.where(inside, ix * h + iy, w * h).to(torch.int64)
    # each cell's last box (an amax of box indices), then one write per
    # cell: index_put_ with duplicate indices is undefined on CUDA
    order = torch.arange(m, device=dev)
    last = torch.full((w * h + 1,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, cflat, order, "amax")
    wins = inside & (last[cflat] == order)
    vbuf = torch.zeros((w * h + 1, nv), dtype=torch.float32, device=dev)
    vbuf[torch.where(wins, cflat, w * h)] = torch.where(wins[:, None], vec,
                                                        0.0)
    mbuf = torch.zeros(w * h + 1, dtype=torch.bool, device=dev)
    mbuf[cflat] = True
    return dict(heatmap=heatmap,
                vec=vbuf[:-1].reshape(w, h, nv),
                mask=mbuf[:-1].reshape(w, h))


def center_loss(outputs, targets, reg_weight=2.0):
    """Penalty-reduced focal (CornerNet, alpha=2 beta=4) + masked L1.
    Returns ``(total, dict(hm, reg, total))``. The positive count is the
    whole batch's in a sharded step (:func:`~.parallel.comm.batch_sum`)."""
    hm = torch.clamp(torch.sigmoid(outputs["heatmap"]), 1e-5, 1 - 1e-5)
    t = targets["heatmap"]
    pos = t >= 1.0 - 1e-6
    npos = torch.clamp_min(batch_sum(pos.sum()), 1).to(hm.dtype)
    pos_l = -((1 - hm) ** 2) * torch.log(hm) * pos
    neg_l = -((1 - t) ** 4) * (hm ** 2) * torch.log(1 - hm) * ~pos
    hm_loss = (pos_l.sum() + neg_l.sum()) / npos

    parts = [outputs[k] for k, _ in _REG_HEADS]
    if "vel" in outputs:
        parts.append(outputs["vel"])
    pred = torch.cat(parts, dim=-1)
    l1 = (pred - targets["vec"]).abs() * targets["mask"][..., None]
    reg_loss = l1.sum() / npos
    total = hm_loss + reg_weight * reg_loss
    return total, dict(hm=hm_loss, reg=reg_loss, total=total)


def decode_centers(cfg: CenterPointConfig, outputs):
    """Peak NMS (3x3 max-pool) + top-k of one frame's outputs (W, H, C)
    -> (K, 7) boxes, scores, labels (+ (K, 2) velocities when
    ``cfg.predict_velocity``). Fixed output shapes; callers mask on
    ``scores``. The top-k runs over the (W, H, C) layout and ranks equal
    scores lowest index first, as ``lax.top_k``; the pool pads with
    -inf, as ``reduce_window``."""
    w, h = cfg.grid
    vx, vy, _ = [float(v) for v in cfg.voxel_size]
    hm = torch.sigmoid(outputs["heatmap"])                 # (W, H, C)
    pooled = F.max_pool2d(hm.permute(2, 0, 1)[None], 3, 1, 1)[0]
    peaks = torch.where(hm >= pooled.permute(1, 2, 0), hm, 0.0)
    flat = peaks.reshape(-1)
    idx = torch.sort(flat, descending=True, stable=True).indices[:cfg.top_k]
    scores = flat[idx]
    cell = torch.div(idx, cfg.num_classes, rounding_mode="floor")
    labels = (idx % cfg.num_classes).to(torch.int32)
    ix = torch.div(cell, h, rounding_mode="floor")
    iy = cell % h

    vec = torch.cat([outputs[k] for k, _ in _REG_HEADS],
                    dim=-1).reshape(w * h, 8)[cell]
    boxes = torch.stack([
        (ix.to(vec.dtype) + vec[:, 0]) * vx + cfg.bounds[0],
        (iy.to(vec.dtype) + vec[:, 1]) * vy + cfg.bounds[2],
        vec[:, 2],
        torch.exp(vec[:, 3]),
        torch.exp(vec[:, 4]),
        torch.exp(vec[:, 5]),
        torch.atan2(vec[:, 6], vec[:, 7]),
    ], dim=-1)
    if cfg.predict_velocity:
        vel = outputs["vel"].reshape(w * h, 2)[cell]
        return boxes, scores, labels, vel
    return boxes, scores, labels


def _gt_velocity(cfg, batch):
    """(B, M, 2) gt velocities when the head is enabled (zeros, with a
    warning, if the batch lacks them), else None."""
    if not cfg.predict_velocity:
        return None
    gv = batch.get("gt_velocity")
    if gv is None:
        # training the velocity head toward silent zeros defeats its purpose
        warnings.warn(
            "predict_velocity=True but the batch has no 'gt_velocity' — "
            "velocity targets default to ZERO. Supply per-box (B, M, 2) "
            "BEV velocities (e.g. Target3DArray.columns()['velocity']"
            "[:, :2] from the nuScenes loader) to actually train the "
            "head.", stacklevel=3)
        gv = torch.zeros(tuple(batch["gt_boxes"].shape[:2]) + (2,),
                         device=batch["gt_boxes"].device)
    return gv


def prepare_center_targets(cfg: CenterPointConfig, batch):
    """Batched heatmap/regression target rendering apart from the train
    step (it needs no parameters): returns ``batch`` with a ``"targets"``
    entry for ``make_train_step(..., external_targets=True)``."""
    gv = _gt_velocity(cfg, batch)
    with torch.no_grad():
        frames = [assign_center_targets(
            cfg, b, l, m, None if gv is None else gv[i])
            for i, (b, l, m) in enumerate(zip(
                batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"]))]
    targets = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    return dict(batch, targets=targets)


def make_train_step(model, optimizer, cfg: CenterPointConfig, remat=False,
                    external_targets=False):
    """Build ``step(batch) -> aux``, one training step that updates
    ``model`` (parameters and BatchNorm running statistics) and
    ``optimizer`` (e.g. from :func:`d3d_tpu_torch.train.make_optimizer`)
    in place: forward with ``train=True``, :func:`center_loss`, backward,
    ``optimizer.step()``. After it each parameter's ``.grad`` holds this
    step's gradient (before clipping); ``aux`` holds the loss terms as
    detached 0-d tensors.

    ``batch``: features/coords/valid from ``pillarize`` (stacked) plus
    padded gt_boxes (B, M, 7), gt_labels (B, M), gt_mask (B, M) and, with
    the velocity head, gt_velocity (B, M, 2); tensors stay on their
    device, anything else goes to the model's.

    :param remat: recompute the forward in the backward
        (``torch.utils.checkpoint``, the JAX step's ``jax.checkpoint``),
        the BatchNorm buffers put back after the recompute
    :param external_targets: take ``batch["targets"]`` from
        :func:`prepare_center_targets` instead of rendering them in the
        step

    The step carries ``model``, ``optimizer``, ``backward`` (forward, loss
    and backward on a batch, returning ``aux``) and ``global_aux`` (none),
    which :func:`~d3d_tpu_torch.parallel.mesh.shard_train_step` runs over
    a mesh, as the PointPillars step does.
    """
    dev = next(model.parameters()).device

    def forward(features, coords, valid):
        return model(features, coords, valid, train=True)

    if remat:
        def run_forward(*inputs):
            return checkpoint(forward, *inputs, use_reentrant=False,
                              context_fn=lambda: (
                                  contextlib.nullcontext(),
                                  _buffers_kept(model)))
    else:
        run_forward = forward

    def backward(batch):
        batch = {k: (v if k == "targets" else as_tensor(v, device=dev))
                 for k, v in batch.items()}
        outputs = run_forward(batch["features"], batch["coords"],
                              batch["valid"])
        if external_targets:
            targets = {k: as_tensor(v, device=dev).detach()
                       for k, v in batch["targets"].items()}
        else:
            targets = prepare_center_targets(cfg, batch)["targets"]
        loss, aux = center_loss(outputs, targets)
        loss.backward()
        return {k: v.detach() for k, v in aux.items()}

    return _train_step(model, optimizer, backward)


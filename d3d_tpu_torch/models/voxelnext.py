"""VoxelNeXt, the fully sparse detector (port of
``d3d_tpu.models.voxelnext``).

Chen et al., "VoxelNeXt: Fully Sparse VoxelNet for 3D Object Detection and
Tracking", CVPR 2023: SECOND's sparse backbone (the port's
:func:`~d3d_tpu_torch.models.second.sparse_stage_loop`: K5 on CUDA, one
joined site list for the batch), then sparse height compression (the
features of the voxels of one BEV cell summed into one 2D site) and
CenterPoint-style heads on the active sites as per-site linear layers. No
dense BEV canvas is ever built.

Shapes are static: fixed-capacity site lists (``max_voxels`` ->
``stage_sites`` -> ``bev_sites``), masked instead of resized. Parameters
stay float32 and the compute runs in ``cfg.dtype``. Targets put each
ground-truth box on its NEAREST ACTIVE site (its own cell may be empty),
and decode is a flat top-k over (sites, classes).
"""

import contextlib
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..utils import as_tensor, resolve_device
from .centerpoint import _gaussian_radius
from ..parallel.comm import batch_sum
from .pointpillars import _buffers_kept, _train_step
from .second import _MaskedBN, _SpConv, second_voxelize, sparse_stage_loop

__all__ = ["VoxelNeXtConfig", "VoxelNeXt", "compress_height",
           "assign_voxelnext_targets", "voxelnext_loss",
           "decode_voxelnext", "voxelnext_voxelize", "make_train_step"]

_BIG_KEY = 2 ** 30 - 1


@dataclass(frozen=True)
class VoxelNeXtConfig:
    """Static configuration (the JAX module's fields and defaults)."""

    bounds: Tuple[float, ...] = (0.0, 70.4, -40.0, 40.0, -3.0, 1.0)
    grid: Tuple[int, int, int] = (352, 400, 20)
    max_voxels: int = 16000
    stage_channels: Tuple[int, ...] = (16, 32, 64)
    stage_sites: Tuple[int, ...] = (16000, 8000, 4000)
    subm_per_stage: int = 2
    bev_sites: int = 4000         # cap of the compressed 2D site set
    head_channels: int = 64
    num_classes: int = 1
    top_k: int = 100
    gaussian_overlap: float = 0.1
    min_radius: float = 2.0       # cells at the final stride
    predict_velocity: bool = False  # BEV velocity head (paper's tracking)
    dtype: str = "float32"

    @property
    def n_stages(self):
        return len(self.stage_channels)

    @property
    def final_grid(self):
        g = tuple(self.grid)
        for _ in range(self.n_stages - 1):
            g = tuple(-(-x // 2) for x in g)
        return g

    @property
    def bev_grid(self):
        g = self.final_grid
        return (g[0], g[1])

    @property
    def bev_voxel(self):
        """BEV cell edge lengths (m) at the final stride."""
        w, h = self.bev_grid
        return ((self.bounds[1] - self.bounds[0]) / w,
                (self.bounds[3] - self.bounds[2]) / h)


# voxelization is SECOND's (mean features per voxel, any point columns)
voxelnext_voxelize = second_voxelize


def compress_height(features, coords, valid, grid, max_out):
    """Sparse height compression of one frame: (N, C) 3D sites -> (M, C)
    unique-(x, y) BEV sites with the features SUMMED over z.

    One stable sort by the BEV key and a segment sum in the JAX module's
    order: an accumulating ``index_put`` (on CUDA a sort-based kernel that
    adds each cell's sites in row order; ``index_add``'s float atomics
    would add them in no fixed order, so two equal requests could differ
    in their last bits), every row outside a kept cell into a row of its
    own past ``max_out``; a cell's (x, y) is the segment max of its sites'
    cells. Cells past ``max_out`` are dropped (masked, not aliased).

    :returns: (bev_features (M, C), bev_xy (M, 2) int32, bev_valid (M,))
    """
    dev = features.device
    keys = torch.where(valid, coords[:, 0] * grid[1] + coords[:, 1],
                       _BIG_KEY).to(torch.int32)
    sk, order = torch.sort(keys, stable=True)
    sf = features[order]
    sxy = coords[order][:, :2].to(torch.int32)
    ok = sk < _BIG_KEY
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       sk[1:] != sk[:-1]]) & ok
    seg = torch.cumsum(first.to(torch.int32), 0) - 1
    inb = ok & (seg < max_out) & (seg >= 0)
    segc = seg.clamp(0, max_out - 1)
    n = sf.shape[0]
    rows = torch.where(inb, segc, max_out + torch.arange(n, device=dev))
    bev_f = sf.new_zeros((max_out + n, sf.shape[1])).index_put(
        (rows.to(torch.int64),), sf, accumulate=True)[:max_out]
    bev_xy = torch.full((max_out, 2), -1, dtype=torch.int32, device=dev)
    bev_xy = bev_xy.scatter_reduce(
        0, segc[:, None].expand(-1, 2),
        torch.where(inb[:, None], sxy, -1), "amax")
    nseg = torch.clamp_max(first.sum(), max_out)
    bev_valid = torch.arange(max_out, device=dev) < nseg
    return (bev_f * bev_valid[:, None].to(bev_f.dtype),
            bev_xy.clamp_min(0), bev_valid)


def _linear(x, layer, dt):
    """flax ``Dense(dtype=dt)``: input, kernel and bias in ``dt``, the bias
    added after the product."""
    return F.linear(x.to(dt), layer.weight.to(dt)) + layer.bias.to(dt)


class VoxelNeXt(nn.Module):
    """Sparse backbone -> height compression -> per-site center heads.

    Outputs (batched): ``heatmap`` (B, M, C) f32 logits, ``reg`` (B, M, 8
    or 10) f32 [dx, dy, z, log l, log w, log h, sin, cos(, vx, vy)],
    ``site_xy`` (B, M, 2) int32 BEV cells at the final stride,
    ``site_valid`` (B, M). The layers carry the flax tree's names:
    ``subm{s}_{i}`` / ``down{s}`` (in ``middle``), ``head1``, ``head_bn``,
    ``head_hm``, ``head_reg``.

    :param point_features: channels per voxel (4: mean x, y, z,
        intensity; 5 with nuScenes' sweep time)
    :param device: where the parameters live (default CUDA; raises when
        CUDA is missing and no device is given)
    :param generator: ``torch.Generator`` for the random initial weights
        (default: a generator seeded with 0)
    """

    def __init__(self, cfg: VoxelNeXtConfig, point_features=4, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        layers = {}
        c_in = point_features
        for s, ch in enumerate(cfg.stage_channels):
            for i in range(cfg.subm_per_stage):
                layers[f"subm{s}_{i}"] = _SpConv(c_in, ch, cfg.dtype,
                                                 symmetric=True)
                c_in = ch
            if s + 1 < cfg.n_stages:
                c_out = cfg.stage_channels[s + 1]
                layers[f"down{s}"] = _SpConv(c_in, c_out, cfg.dtype)
                c_in = c_out
        self.middle = nn.ModuleDict(layers)
        self.head1 = nn.Linear(c_in, cfg.head_channels)
        self.head_bn = _MaskedBN(cfg.head_channels)
        self.head_hm = nn.Linear(cfg.head_channels, cfg.num_classes)
        self.head_reg = nn.Linear(cfg.head_channels,
                                  10 if cfg.predict_velocity else 8)
        self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Seeded random weights: He-normal sparse kernels, LeCun-normal
        heads, zero biases but the heatmap's -2.19 (logit of 0.1, the
        focal-loss start), identity BatchNorm statistics."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, _SpConv)):
                w = mod.weight
                sparse = isinstance(mod, _SpConv)
                fan_in = w.shape[0] * w.shape[1] if sparse else w.shape[1]
                w.copy_(torch.randn(w.shape, generator=generator)
                        * ((2.0 if sparse else 1.0) / fan_in) ** 0.5)
                if not sparse:
                    mod.bias.fill_(-2.19 if mod is self.head_hm else 0.0)
            elif isinstance(mod, _MaskedBN):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)

    def forward(self, features, coords, valid, train=False):
        """:param features: (B, V, P) voxel means; ``coords`` (B, V, 3)
        int32; ``valid`` (B, V) bool
        :param train: BatchNorm with batch statistics, updating the running
            ones (the flag, not ``nn.Module.training``, as the JAX module's
            ``train`` argument)"""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        x, oc, ov, _ = sparse_stage_loop(cfg, self.middle, features, coords,
                                         valid, train)
        bev = [compress_height(f, c, v, cfg.bev_grid, cfg.bev_sites)
               for f, c, v in zip(x, oc, ov)]
        bev_f = torch.stack([b[0] for b in bev])
        bev_xy = torch.stack([b[1] for b in bev])
        bev_valid = torch.stack([b[2] for b in bev])
        b, m = bev_valid.shape
        y = _linear(bev_f, self.head1, dt).reshape(b * m, -1)
        y = F.relu(self.head_bn(y, bev_valid.reshape(-1), train))
        y = y.reshape(b, m, -1)
        return dict(heatmap=_linear(y, self.head_hm, dt).float(),
                    reg=_linear(y, self.head_reg, dt).float(),
                    site_xy=bev_xy, site_valid=bev_valid)


def _first_argmin(d2, dim):
    """The first index of the least value along ``dim`` (``jnp.argmin``),
    by an integer ``amin`` rather than ``torch.argmin``."""
    idx = torch.arange(d2.shape[dim], device=d2.device)
    idx = idx.view([-1 if d == dim else 1 for d in range(d2.ndim)])
    low = d2.amin(dim=dim, keepdim=True)
    return torch.where(d2 == low, idx, d2.shape[dim]).amin(dim=dim)


def assign_voxelnext_targets(cfg: VoxelNeXtConfig, site_xy, site_valid,
                             gt_boxes, gt_labels, gt_mask, gt_velocity=None):
    """Sparse CenterNet targets for ONE frame (no gradient).

    :param site_xy: (M2, 2) int32 active BEV cells; ``site_valid`` (M2,)
    :param gt_boxes: (M, 7) padded [x y z l w h yaw]
    :param gt_velocity: (M, 2) BEV velocities, read with
        ``cfg.predict_velocity`` (default zeros)
    :returns: dict(heat (M2, C) gaussian targets with 1.0 at positives,
        vec (M, 8 or 10) regression targets, pos_site (M,) int32 assigned
        site row (-1 when unassigned), pos_mask (M,))
    """
    w, h = cfg.bev_grid
    vx, vy = cfg.bev_voxel
    m2 = site_xy.shape[0]
    dev = gt_boxes.device
    gt_boxes = gt_boxes.to(torch.float32)

    cx = (gt_boxes[:, 0] - cfg.bounds[0]) / vx       # fractional cells
    cy = (gt_boxes[:, 1] - cfg.bounds[2]) / vy
    inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h) & gt_mask

    radius = torch.clamp_min(
        _gaussian_radius(gt_boxes[:, 3] / vx, gt_boxes[:, 4] / vy,
                         cfg.gaussian_overlap), cfg.min_radius)
    sigma2 = torch.clamp_min((2 * radius / 3.0) ** 2, 1e-6)

    ix, iy = torch.floor(cx), torch.floor(cy)
    sx = site_xy[:, 0].to(torch.float32)
    sy = site_xy[:, 1].to(torch.float32)
    d2 = ((sx[:, None] - ix[None, :]) ** 2
          + (sy[:, None] - iy[None, :]) ** 2)       # (M2, M) cell dist
    val = torch.exp(-d2 / (2 * sigma2[None, :]))
    val = torch.where(site_valid[:, None] & inside[None, :], val, 0.0)
    val = torch.where(val > 1e-4, val, 0.0)

    # nearest ACTIVE site per gt (the gt's own cell may hold no voxels)
    d2m = torch.where(site_valid[:, None], d2, torch.inf)
    pos = _first_argmin(d2m, 0).to(torch.int32)      # (M,)
    assignable = inside & site_valid.any()
    pos_site = torch.where(assignable, pos, -1)

    cls = gt_labels.clamp_min(0).long()
    clsoh = F.one_hot(cls, cfg.num_classes).to(torch.float32)
    heat = (val[:, :, None] * clsoh[None, :, :]).amax(dim=1)
    # positives pin to exactly 1.0
    flat = torch.where(assignable, pos.long() * cfg.num_classes + cls,
                       m2 * cfg.num_classes)
    heat = torch.cat([heat.reshape(-1), heat.new_zeros(1)])
    heat = heat.scatter_reduce(0, flat, assignable.to(torch.float32), "amax")
    heat = heat[:-1].reshape(m2, cfg.num_classes)

    # regression target per gt, offsets measured from the ASSIGNED site
    pl = pos.long()
    psx = torch.where(assignable, sx[pl], 0.0)
    psy = torch.where(assignable, sy[pl], 0.0)
    cols = [
        cx - psx, cy - psy, gt_boxes[:, 2],
        torch.log(torch.clamp_min(gt_boxes[:, 3], 1e-3)),
        torch.log(torch.clamp_min(gt_boxes[:, 4], 1e-3)),
        torch.log(torch.clamp_min(gt_boxes[:, 5], 1e-3)),
        torch.sin(gt_boxes[:, 6]), torch.cos(gt_boxes[:, 6]),
    ]
    if cfg.predict_velocity:
        gv = (torch.zeros((gt_boxes.shape[0], 2), device=dev)
              if gt_velocity is None else gt_velocity.to(torch.float32))
        cols += [gv[:, 0], gv[:, 1]]
    return dict(heat=heat, vec=torch.stack(cols, dim=-1), pos_site=pos_site,
                pos_mask=assignable)


def voxelnext_loss(outputs, targets):
    """Penalty-reduced focal loss over the active sites + L1 at the
    assigned sites (batched: every leaf has a leading batch axis).
    Returns ``(total, dict(hm, reg, total))``. The positive count is the
    whole batch's in a sharded step."""
    hm = torch.clamp(torch.sigmoid(outputs["heatmap"]), 1e-5, 1 - 1e-5)
    t = targets["heat"]
    valid = outputs["site_valid"][..., None]
    pos = (t >= 1.0 - 1e-6) & valid
    npos = torch.clamp_min(batch_sum(pos.sum()), 1).to(torch.float32)
    pos_l = -((1 - hm) ** 2) * torch.log(hm) * pos
    neg_l = -((1 - t) ** 4) * (hm ** 2) * torch.log(1 - hm) * (~pos & valid)
    hm_loss = (pos_l.sum() + neg_l.sum()) / npos

    ps = targets["pos_site"].clamp_min(0).long()
    reg = outputs["reg"]
    pred = reg.gather(1, ps[..., None].expand(-1, -1, reg.shape[-1]))
    l1 = (pred - targets["vec"]).abs() \
        * targets["pos_mask"][..., None].to(torch.float32)
    reg_loss = l1.sum() / npos
    total = hm_loss + 2.0 * reg_loss
    return total, dict(hm=hm_loss, reg=reg_loss, total=total)


def decode_voxelnext(cfg: VoxelNeXtConfig, outputs):
    """Flat top-k over (sites, classes) of one frame's outputs -> (K, 7)
    boxes, scores, labels (and (K, 2) velocities with
    ``cfg.predict_velocity``); callers mask on the scores. Equal scores
    rank lowest index first, as ``lax.top_k``."""
    vx, vy = cfg.bev_voxel
    scores_all = torch.sigmoid(outputs["heatmap"])
    scores_all = scores_all * outputs["site_valid"][:, None]
    flat = scores_all.reshape(-1)
    idx = torch.sort(flat, descending=True, stable=True).indices[:cfg.top_k]
    scores = flat[idx]
    site = torch.div(idx, cfg.num_classes, rounding_mode="floor")
    labels = (idx % cfg.num_classes).to(torch.int32)
    vec = outputs["reg"][site]
    sx = outputs["site_xy"][site, 0].to(torch.float32)
    sy = outputs["site_xy"][site, 1].to(torch.float32)
    boxes = torch.stack([
        (sx + vec[:, 0]) * vx + cfg.bounds[0],
        (sy + vec[:, 1]) * vy + cfg.bounds[2],
        vec[:, 2],
        torch.exp(vec[:, 3]), torch.exp(vec[:, 4]), torch.exp(vec[:, 5]),
        torch.atan2(vec[:, 6], vec[:, 7]),
    ], dim=-1)
    if cfg.predict_velocity:
        return boxes, scores, labels, vec[:, 8:10]
    return boxes, scores, labels


def make_train_step(model, optimizer, cfg: VoxelNeXtConfig, remat=False):
    """Build ``step(batch) -> aux``, one training step that updates
    ``model`` (parameters and BatchNorm running statistics) and
    ``optimizer`` in place: forward with ``train=True``, targets assigned
    from the forward's ACTUAL active sites without gradient (they depend
    on the voxelization, not on the parameters), :func:`voxelnext_loss`,
    backward, ``optimizer.step()``. After it each parameter's ``.grad``
    holds this step's gradient. ``aux`` holds the loss terms as detached
    0-d tensors.

    ``batch``: features/coords/valid from :func:`voxelnext_voxelize`
    (stacked) + padded gt_boxes (B, M, 7), gt_labels (B, M), gt_mask
    (B, M) and optionally gt_velocity (B, M, 2); tensors stay on their
    device, anything else goes to the model's.

    :param remat: recompute the forward in the backward
        (``torch.utils.checkpoint``, the JAX step's ``jax.checkpoint``),
        with the BatchNorm buffers put back after the recompute

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
        batch = {k: as_tensor(v, device=dev) for k, v in batch.items()}
        outputs = run_forward(batch["features"], batch["coords"],
                              batch["valid"])
        gv = batch.get("gt_velocity")
        if gv is None:
            gv = torch.zeros(batch["gt_boxes"].shape[:2] + (2,), device=dev)
        with torch.no_grad():
            per = [assign_voxelnext_targets(cfg, xy, sv, b, l, m, v)
                   for xy, sv, b, l, m, v in zip(
                       outputs["site_xy"], outputs["site_valid"],
                       batch["gt_boxes"], batch["gt_labels"],
                       batch["gt_mask"], gv)]
            targets = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        loss, aux = voxelnext_loss(outputs, targets)
        loss.backward()
        return {k: v.detach() for k, v in aux.items()}

    return _train_step(model, optimizer, backward)

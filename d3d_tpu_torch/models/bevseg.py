"""BEV point-cloud semantic and panoptic segmentation (port of
``d3d_tpu.models.bevseg``).

PolarNet-style pipeline (Zhang et al., CVPR 2020): pillarize (PointPillars'
``pillarize``) -> pillar PointNet -> BEV U-Net -> per-point logits by a
bilinear gather of the BEV map at each point's fractional cell coordinate
(:func:`d3d_tpu_torch.ops.point.aligned_scatter`, ``method="linear"``) ->
per-point cross-entropy. The panoptic extension (Panoptic-PolarNet, Zhou et
al., CVPR 2021) adds a centre heatmap and per-point offsets; instances group
by offset-shifted nearest-centre votes. Predictions feed
:class:`d3d_tpu_torch.benchmarks.SegmentationEvaluator` and
:func:`d3d_tpu_torch.benchmarks_device.device_panoptic_stats`.

The network runs NCHW with x along the first spatial axis (the JAX
module's NHWC canvas is (B, W, H, C)); every op is a dense torch op, so no
kernel of the port's runs on this path.
"""

import contextlib
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.point import aligned_scatter
from ..parallel.comm import batch_mean, batch_sum
from ..utils import as_tensor, resolve_device
from .pointpillars import (_BN_EPS, _PFN, _ConvBlock, _bev_hooks,
                           _buffers_kept, _norm, _train_step,
                           pillarize as _pp_pillarize, scatter_to_bev)

__all__ = ["BEVSegConfig", "BEVSeg", "bevseg_pillarize", "point_cell_coords",
           "segmentation_loss", "make_train_step", "make_predictor",
           "panoptic_targets", "panoptic_loss", "group_instances",
           "make_panoptic_predictor"]


@dataclass(frozen=True)
class BEVSegConfig:
    """Static configuration (the JAX module's fields and defaults)."""

    bounds: Tuple[float, ...] = (-48.0, 48.0, -48.0, 48.0, -3.0, 1.8)
    grid: Tuple[int, int] = (480, 480)
    max_pillars: int = 12000
    max_points_per_pillar: int = 32
    pfn_features: int = 64
    enc_channels: Tuple[int, ...] = (64, 128, 256)
    enc_blocks: Tuple[int, ...] = (2, 2, 2)
    dec_channels: int = 128
    num_classes: int = 20          # SemanticKITTI-style taxonomy size
    ignore_index: int = 0          # unlabeled
    # panoptic extension: centre heatmap + offset heads over the decoder
    panoptic: bool = False
    thing_classes: Tuple[int, ...] = ()   # instance-forming class values
    max_instances: int = 64               # per-frame target/centre cap
    center_sigma: float = 2.0             # gaussian splat sigma (cells)
    center_radius: float = 2.5            # grouping gate (metres)
    dtype: str = "float32"

    @property
    def voxel_size(self):
        b = np.asarray(self.bounds).reshape(3, 2)
        return (b[:, 1] - b[:, 0]) / np.array([*self.grid, 1])


def bevseg_pillarize(points, cfg: BEVSegConfig):
    """Pillar tensors for the segmentation grid (PointPillars'
    pillarization; the two configs share field names)."""
    return _pp_pillarize(points, cfg)


def point_cell_coords(points, cfg: BEVSegConfig):
    """Fractional BEV cell coordinates of each point, in the convention of
    :func:`~d3d_tpu_torch.ops.point.aligned_scatter` (cell centres at
    integers): ``(x - bound_lo) / voxel - 0.5``. Shape (..., N, 2)."""
    points = as_tensor(points)
    vsize = torch.tensor(cfg.voxel_size[:2], dtype=points.dtype,
                         device=points.device)
    bmin = torch.tensor([cfg.bounds[0], cfg.bounds[2]], dtype=points.dtype,
                        device=points.device)
    return (points[..., :2] - bmin) / vsize - 0.5


class _Up(nn.Module):
    """2x2 stride-2 ConvTranspose without bias, BatchNorm (momentum 0.99,
    eps 1e-3), ReLU, then the skip concatenated. flax's ConvTranspose
    (kernel = stride = 2, SAME) is torch's ``conv_transpose2d(stride=2)``
    on the spatially flipped kernel (the converter flips it)."""

    def __init__(self, in_channels, channels, dtype):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.conv = nn.ConvTranspose2d(in_channels, channels, 2, stride=2,
                                       bias=False)
        self.bn = nn.BatchNorm2d(channels, eps=_BN_EPS)

    def forward(self, x, skip, train, sp=None):
        dt = self.dtype
        x = F.conv_transpose2d(x.to(dt), self.conv.weight.to(dt), stride=2)
        x = F.relu(_norm(x, self.bn, train, sp))
        return torch.cat([x, skip.to(x.dtype)], dim=1)


class BEVSeg(nn.Module):
    """Pillar encoder -> BEV U-Net -> per-point class logits.

    Modules named after the flax ones: ``pfn`` (``_PFN_0``), ``blocks``
    (the encoder's ``_ConvBlock_{i}``), ``ups`` (``_Up_{j}``), ``dec``
    (the last ``_ConvBlock``), ``head_seg`` and, with ``cfg.panoptic``,
    ``head_center`` (bias -2.19) and ``head_offset``.

    :param constrain: optional activation hook ``(x, kind) -> x`` called
        on the BEV canvas (NCHW) with kind "bev";
        :func:`~d3d_tpu_torch.parallel.mesh.spatial_constrain`'s runs the
        U-Net and heads on this rank's slab of rows and joins the head
        maps whole before the per-point sampling
    :param point_features: channels per input point (4: x, y, z,
        intensity); the PFN sees 5 more
    :param device: where the parameters live (default CUDA; raises when
        CUDA is missing and no device is given)
    :param generator: ``torch.Generator`` for the random initial weights
        (default: a generator seeded with 0)
    """

    def __init__(self, cfg: BEVSegConfig, constrain=None, point_features=4,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.constrain = constrain
        self.pfn = _PFN(point_features + 5, cfg.pfn_features, cfg.dtype)
        blocks, ch_in = [], cfg.pfn_features
        for i, (ch, nb) in enumerate(zip(cfg.enc_channels, cfg.enc_blocks)):
            blocks.append(_ConvBlock(ch_in, ch, nb, 2 if i > 0 else 1,
                                     cfg.dtype))
            ch_in = ch
        self.blocks = nn.ModuleList(blocks)
        ups = []
        for skip in cfg.enc_channels[-2::-1]:
            ups.append(_Up(ch_in, cfg.dec_channels, cfg.dtype))
            ch_in = cfg.dec_channels + skip
        self.ups = nn.ModuleList(ups)
        self.dec = _ConvBlock(ch_in, cfg.dec_channels, 1, 1, cfg.dtype)
        self.head_seg = nn.Conv2d(cfg.dec_channels, cfg.num_classes, 1)
        if cfg.panoptic:
            self.head_center = nn.Conv2d(cfg.dec_channels, 1, 1)
            self.head_offset = nn.Conv2d(cfg.dec_channels, 2, 1)
        self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Seeded random weights: He-normal kernels (LeCun-normal for the
        heads), zero biases but the centre heatmap's -2.19, identity
        BatchNorm statistics."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        heads = {self.head_seg, getattr(self, "head_center", None),
                 getattr(self, "head_offset", None)}
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = (w.shape[0] * w.shape[2] * w.shape[3]
                          if isinstance(mod, nn.ConvTranspose2d)
                          else w[0].numel())
                gain = 1.0 if mod in heads else 2.0
                w.copy_(torch.randn(w.shape, generator=generator)
                        * math.sqrt(gain / fan_in))
                if mod.bias is not None:
                    mod.bias.fill_(-2.19 if mod is getattr(
                        self, "head_center", None) else 0.0)
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()

    def forward(self, features, coords, valid, point_coords, train=False):
        """:param features: (B, P, K, 9) pillar point decorations
        :param coords: (B, P, 2) int32 pillar cells
        :param valid: (B, P) pillar mask
        :param point_coords: (B, N, 2) fractional BEV coords of the raw
            points (from :func:`point_cell_coords`)
        :param train: batch statistics, moving the running ones (the
            argument, not ``nn.Module.training``)
        :return: (B, N, num_classes) float32 per-point logits; with
            ``cfg.panoptic`` a dict of those (``sem``), the centre
            ``heatmap`` (B, W, H) logits and per-point ``offset`` (B, N, 2)
        """
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        b = features.shape[0]
        pmask = (features != 0).any(dim=-1)
        pf = self.pfn(features, pmask, train)
        pf = pf * valid[..., None].to(pf.dtype)
        con, sp = _bev_hooks(self.constrain)
        x = con(scatter_to_bev(pf, coords, valid, cfg.grid).permute(
            0, 3, 1, 2), "bev")

        skips = []
        for block in self.blocks:
            x = block(x, train, sp)
            skips.append(x)
        for up, skip in zip(self.ups, skips[-2::-1]):
            x = up(x, skip, train, sp)
        x = self.dec(x, train, sp).to(dt)

        def conv(head):
            y = F.conv2d(x, head.weight.to(dt), head.bias.to(dt))
            return y if sp is None else sp.gather(y)

        # per-point bilinear gather off the (B, C, W, H) map, a leading
        # batch column on the coordinates
        n = point_coords.shape[1]
        bcol = torch.arange(b, dtype=point_coords.dtype,
                            device=point_coords.device).repeat_interleave(n)
        flatc = torch.cat([bcol[:, None], point_coords.reshape(b * n, 2)],
                          dim=1)

        def gather(m):
            g = aligned_scatter(flatc, m.to(torch.float32), method="linear")
            return g.reshape(b, n, m.shape[1])

        pt_logits = gather(conv(self.head_seg))
        if not cfg.panoptic:
            return pt_logits
        return dict(sem=pt_logits,
                    heatmap=conv(self.head_center)[:, 0].to(torch.float32),
                    offset=gather(conv(self.head_offset)))


def _one_hot(labels, c):
    """``jax.nn.one_hot``: rows of labels outside [0, c) are all zero."""
    return (labels[..., None] == torch.arange(c, device=labels.device)).to(
        torch.float32)


def segmentation_loss(logits, labels, cfg: BEVSegConfig, label_smooth=0.0):
    """Masked per-point cross-entropy; ``ignore_index`` points drop out.

    :param logits: (B, N, C) float32
    :param labels: (B, N) int
    :return: scalar loss, dict(seg, acc); the count of labelled points is
        the whole batch's in a sharded step
    """
    c = cfg.num_classes
    mask = (labels != cfg.ignore_index).to(torch.float32)
    onehot = _one_hot(labels, c)
    if label_smooth > 0:
        onehot = onehot * (1 - label_smooth) + label_smooth / c
    logp = F.log_softmax(logits, dim=-1)
    ce = -(onehot * logp).sum(dim=-1)
    denom = torch.clamp_min(batch_sum(mask.sum()), 1.0)
    loss = (ce * mask).sum() / denom
    acc = ((logits.argmax(dim=-1) == labels) * mask).sum() / denom
    return loss, {"seg": loss, "acc": acc}


def _segment_sum(values, seg, n):
    return torch.zeros(n, dtype=values.dtype,
                       device=values.device).index_add_(0, seg, values)


def panoptic_targets(cfg: BEVSegConfig, points, labels, inst_ids):
    """One frame of centre-heatmap + offset targets from instance labels
    (no gradient).

    Instance centres are the mean BEV position of each instance's points
    (segment sums over the points sorted by instance id); the first
    ``cfg.max_instances`` instances IN ASCENDING INSTANCE-ID ORDER get a
    target (the JAX function's code; its docstring's "first encounter" is
    not what it does). The heatmap is the max of a gaussian splat per
    centre; offsets point from each thing point to its centre. The JAX
    function's sort is not stable, so the sums' order within an instance,
    and a centre's last ulp, may differ from it.

    :param points: (N, >=2) frame points
    :param labels: (N,) int semantic labels
    :param inst_ids: (N,) int instance ids (0 = no instance)
    :returns: dict(heatmap (W, H), offset (N, 2) metres, offset_mask (N,))
    """
    w, h = cfg.grid
    dev = points.device
    n = points.shape[0]
    m = cfg.max_instances
    things = torch.tensor(cfg.thing_classes, dtype=torch.int64, device=dev)
    thing = torch.isin(labels.to(torch.int64), things) & (inst_ids > 0)
    key = torch.where(thing, inst_ids.to(torch.int32), 1 << 30)

    ks, idx = torch.sort(key, stable=True)
    xs = points[idx, 0].to(torch.float32)
    ys = points[idx, 1].to(torch.float32)
    firstk = torch.ones(n, dtype=torch.bool, device=dev)
    firstk[1:] = ks[1:] != ks[:-1]
    seg = torch.cumsum(firstk.to(torch.int64), 0) - 1
    cnt = _segment_sum(torch.ones(n, dtype=torch.int32, device=dev), seg, n)
    cnt = torch.clamp_min(cnt, 1).to(torch.float32)
    cx = _segment_sum(xs, seg, n) / cnt
    cy = _segment_sum(ys, seg, n) / cnt
    segval = ks != (1 << 30)
    seg_valid = _segment_sum(segval.to(torch.int32), seg, n) > 0
    inst_ok = seg_valid & (torch.arange(n, device=dev) < m)

    # per-point offset target (centre - point), back in input order
    off_s = torch.stack([cx[seg] - xs, cy[seg] - ys], dim=1)
    ok_s = inst_ok[seg] & segval
    offset = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    offset[idx] = off_s
    omask = torch.zeros(n, dtype=torch.bool, device=dev)
    omask[idx] = ok_s

    # gaussian heatmap at the (up to m) centres; 0-d divisors (a Python
    # scalar divides on CUDA as a multiply by its reciprocal)
    vx, vy, s2 = (torch.tensor(v, dtype=torch.float32, device=dev) for v in
                  ((cfg.bounds[1] - cfg.bounds[0]) / w,
                   (cfg.bounds[3] - cfg.bounds[2]) / h,
                   2 * cfg.center_sigma ** 2))
    ccx = (cx[:m] - cfg.bounds[0]) / vx - 0.5
    ccy = (cy[:m] - cfg.bounds[2]) / vy - 0.5
    gx = torch.arange(w, dtype=torch.float32, device=dev)
    gy = torch.arange(h, dtype=torch.float32, device=dev)
    d2 = ((gx[None, :, None] - ccx[:, None, None]) ** 2
          + (gy[None, None, :] - ccy[:, None, None]) ** 2)
    val = torch.where(inst_ok[:m, None, None], torch.exp(-d2 / s2), 0.0)
    heatmap = val.amax(dim=0)
    return dict(heatmap=heatmap, offset=offset, offset_mask=omask)


def panoptic_loss(outputs, targets, cfg: BEVSegConfig, labels,
                  label_smooth=0.0, center_weight=100.0, offset_weight=1.0):
    """Semantic CE + MSE heatmap + masked-L1 offsets (Panoptic-PolarNet's
    loss mix). Returns ``(total, dict(seg, acc, hm, offset, total))``. The
    heatmap's mean and the offset count are the whole batch's in a sharded
    step."""
    sem_loss, aux = segmentation_loss(outputs["sem"], labels, cfg,
                                      label_smooth)
    hm = torch.sigmoid(outputs["heatmap"])
    hm_loss = batch_mean((hm - targets["heatmap"]) ** 2)
    om = targets["offset_mask"][..., None].to(torch.float32)
    denom = torch.clamp_min(batch_sum(om.sum()), 1.0)
    off_loss = ((outputs["offset"] - targets["offset"]).abs() * om).sum() \
        / denom
    total = sem_loss + center_weight * hm_loss + offset_weight * off_loss
    return total, dict(aux, hm=hm_loss, offset=off_loss, total=total)


def group_instances(cfg: BEVSegConfig, sem_labels, points, offsets,
                    heatmap, top_k=64):
    """Fixed-shape instance grouping: 3x3 peak test (-inf padding) and the
    top-k centres off the heatmap, then every thing point votes with its
    offset-shifted position for the nearest centre within
    ``cfg.center_radius``.

    The top-k runs over the flat (W, H) heatmap, equal scores lowest index
    first, as ``lax.top_k`` (when fewer than ``top_k`` peaks exist the
    zeros fill it in index order); a centre's cell is (idx // H, idx % H).

    :param sem_labels: (N,) predicted semantic labels
    :param points: (N, >=2)
    :param offsets: (N, 2) predicted centre offsets (metres)
    :param heatmap: (W, H) centre logits
    :returns: (N,) uint16 instance ids (0 = stuff / unassigned)
    """
    w, h = cfg.grid
    dev = heatmap.device
    hm = torch.sigmoid(heatmap)
    pooled = F.max_pool2d(hm[None, None], 3, 1, 1)[0, 0]
    flat = torch.where(hm >= pooled, hm, 0.0).reshape(-1)
    idx = torch.sort(flat, descending=True, stable=True).indices[:top_k]
    scores = flat[idx]
    vx = (cfg.bounds[1] - cfg.bounds[0]) / w
    vy = (cfg.bounds[3] - cfg.bounds[2]) / h
    ccx = (torch.div(idx, h, rounding_mode="floor").to(torch.float32)
           + 0.5) * vx + cfg.bounds[0]
    ccy = ((idx % h).to(torch.float32) + 0.5) * vy + cfg.bounds[2]
    ok = scores > 0.1

    voted = points[:, :2].to(torch.float32) + offsets
    d2 = ((voted[:, 0:1] - ccx[None, :]) ** 2
          + (voted[:, 1:2] - ccy[None, :]) ** 2)
    d2 = torch.where(ok[None, :], d2, torch.inf)
    best = torch.argmin(d2, dim=1)
    bd = d2.gather(1, best[:, None])[:, 0]
    things = torch.tensor(cfg.thing_classes, dtype=torch.int64, device=dev)
    thing = torch.isin(sem_labels.to(torch.int64), things)
    gate = thing & (bd <= cfg.center_radius ** 2)
    return torch.where(gate, best + 1, 0).to(torch.uint16)


def _predict_outputs(model, cfg, variables, points, dev):
    if variables is not None:
        model.load_state_dict(variables)
    points = as_tensor(points, device=dev, dtype=torch.float32)
    feats, coords, valid = bevseg_pillarize(points, cfg)
    pc = point_cell_coords(points, cfg)
    return points, model(feats[None], coords[None], valid[None], pc[None])


def make_panoptic_predictor(model, cfg: BEVSegConfig, top_k=64,
                            device=None):
    """``predict(variables, points) -> (semantic labels (N,) int32,
    instance ids (N,) uint16)``; feed the pair straight into
    ``device_panoptic_stats`` / ``SegmentationEvaluator.calc_stats(...,
    gt_ids, pred_ids)``.

    :param variables: per call, a state_dict to load into ``model`` first,
        or None to keep its weights
    :param device: where the model and every call run (default CUDA;
        raises when CUDA is missing and no device is given)
    """
    assert cfg.panoptic, "build the model with BEVSegConfig(panoptic=True)"
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def predict(variables, points):
        points, out = _predict_outputs(model, cfg, variables, points, dev)
        sem = out["sem"][0].argmax(dim=-1).to(torch.int32)
        ids = group_instances(cfg, sem, points, out["offset"][0],
                              out["heatmap"][0], top_k=top_k)
        return sem, ids

    predict.device = dev
    return predict


def make_train_step(model, optimizer, cfg: BEVSegConfig, remat=False,
                    label_smooth=0.0):
    """Build ``step(batch) -> aux``, one training step that updates
    ``model`` (parameters and BatchNorm running statistics) and
    ``optimizer`` in place; after it each parameter's ``.grad`` holds this
    step's gradient and ``aux`` the loss terms as detached 0-d tensors.

    ``batch``: features/coords/valid from :func:`bevseg_pillarize`
    (stacked), point_coords (B, N, 2) from :func:`point_cell_coords`,
    labels (B, N). With ``cfg.panoptic`` the batch also carries the raw
    ``points`` (B, N, >=2) and ``inst_ids`` (B, N) for the centre/offset
    targets (:func:`panoptic_targets`, frame by frame). Tensors stay on
    their device, anything else goes to the model's.

    :param remat: recompute the forward in the backward
        (``torch.utils.checkpoint``), the BatchNorm buffers put back after
        the recompute

    The step carries ``model``, ``optimizer``, ``backward`` (forward, loss
    and backward on a batch, returning ``aux``) and ``global_aux`` (none),
    which :func:`~d3d_tpu_torch.parallel.mesh.shard_train_step` runs over
    a mesh, as the PointPillars step does.
    """
    dev = next(model.parameters()).device

    def forward(features, coords, valid, point_coords):
        return model(features, coords, valid, point_coords, train=True)

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
        out = run_forward(batch["features"], batch["coords"], batch["valid"],
                          batch["point_coords"])
        if cfg.panoptic:
            with torch.no_grad():
                frames = [panoptic_targets(cfg, p, l, i) for p, l, i in zip(
                    batch["points"], batch["labels"], batch["inst_ids"])]
            targets = {k: torch.stack([f[k] for f in frames])
                       for k in frames[0]}
            loss, aux = panoptic_loss(out, targets, cfg, batch["labels"],
                                      label_smooth)
        else:
            loss, aux = segmentation_loss(out, batch["labels"], cfg,
                                          label_smooth)
        loss.backward()
        return {k: v.detach() for k, v in dict(aux, total=loss).items()}

    return _train_step(model, optimizer, backward)


def make_predictor(model, cfg: BEVSegConfig, device=None):
    """``predict(variables, points) -> (N,) int32`` per-point labels for
    evaluation: feed the result straight into
    ``SegmentationEvaluator.calc_stats``. ``variables`` and ``device`` as
    :func:`make_panoptic_predictor`."""
    dev = resolve_device(device)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def predict(variables, points):
        _, logits = _predict_outputs(model, cfg, variables, points, dev)
        return logits[0].argmax(dim=-1).to(torch.int32)

    predict.device = dev
    return predict

"""PointPillars 3D detector (port of ``d3d_tpu.models.pointpillars``).

Pillarization reuses the sort-based voxelizer; the pillar feature net, BEV
backbone and SSD head are ``nn.Module`` s whose parameters stay float32 and
whose compute runs in ``cfg.dtype`` (each op casts its input and weight,
as the flax modules do). The network runs NCHW internally with x along the
first spatial axis; its public layout is the JAX module's: head outputs
``(B, W*H*A, C)`` in the same anchor order as :func:`make_anchors`.

The training half (target assignment, the losses, ``prepare_targets``,
``make_train_step``) is shared with SECOND. Training runs flax's
BatchNorm semantics in every layer (``_bn_train``), the PFN's masked max
routes its whole cotangent to the first maximal point, and the BEV
densification is a gather both ways (``scatter_to_bev``).

Reference: Lang et al., "PointPillars: Fast Encoders for Object Detection
from Point Clouds", CVPR 2019 (arXiv:1812.05784).
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

from ..ops.epilogue import bn_relu
from ..ops.geometry import aabox_iou
from ..ops.geometry_soa import rbox_iou
from ..ops.voxel import voxelize_dense_padded
from ..parallel.comm import (SpatialHook, all_reduce_sum, batch_groups,
                             batch_sum, live, loss_share)
from ..profiler import span
from ..utils import as_tensor, resolve_device

__all__ = ["PointPillarsConfig", "PointPillars", "pillarize", "scatter_to_bev",
           "make_anchors", "decode_boxes", "encode_boxes", "assign_targets",
           "detection_loss", "prepare_targets", "make_train_step"]

_BN_EPS = 1e-3  # the JAX package's BatchNorm epsilon, every layer


@dataclass(frozen=True)
class PointPillarsConfig:
    """Static model configuration."""

    bounds: Tuple[float, ...] = (0.0, 69.12, -39.68, 39.68, -3.0, 1.0)
    grid: Tuple[int, int] = (432, 496)        # (x cells, y cells)
    max_pillars: int = 12000
    max_points_per_pillar: int = 32
    pfn_features: int = 64
    backbone_channels: Tuple[int, ...] = (64, 128, 256)
    backbone_blocks: Tuple[int, ...] = (3, 5, 5)
    upsample_channels: int = 128
    num_classes: int = 1
    # per-class anchor sizes (l, w, h) and z center
    anchor_sizes: Tuple[Tuple[float, float, float], ...] = ((3.9, 1.6, 1.56),)
    anchor_z: float = -1.0
    anchor_rotations: Tuple[float, ...] = (0.0, 1.5707963)
    pos_iou: float = 0.6
    neg_iou: float = 0.45
    dtype: str = "float32"  # compute dtype for the network ("bfloat16")

    @property
    def voxel_size(self):
        b = np.asarray(self.bounds).reshape(3, 2)
        sizes = (b[:, 1] - b[:, 0]) / np.array([*self.grid, 1])
        return sizes

    @property
    def num_anchors_per_cell(self):
        return len(self.anchor_sizes) * len(self.anchor_rotations)


# ---------------------------------------------------------------------------
# pillarization (fixed-shape)
# ---------------------------------------------------------------------------

def pillarize(points, cfg: PointPillarsConfig):
    """Points (N, 4) -> pillar tensors with static shapes.

    :return: (features (P, K, 9), coords (P, 2) int32 [ix, iy], mask (P,))
        Features per point: x, y, z, intensity, offsets from the pillar
        centroid (3) and from the pillar center (2).
    """
    points = as_tensor(points)
    dt, dev = points.dtype, points.device
    bounds = torch.tensor(cfg.bounds, dtype=dt, device=dev)
    vox = voxelize_dense_padded(
        points, (cfg.grid[0], cfg.grid[1], 1), bounds,
        cfg.max_points_per_pillar, cfg.max_pillars, "none",
        order_mode="sorted")
    feats = vox.voxels              # (P, K, F)
    pmask = vox.voxel_pmask         # (P, K)
    coords = vox.coords[:, :2].to(torch.int32)  # (P, 2)
    npoints = torch.clamp(vox.voxel_npoints, min=1).to(dt)
    valid = (torch.arange(cfg.max_pillars, dtype=torch.int32, device=dev)
             < vox.nvoxels)

    # decorations
    xyz = feats[..., :3]
    centroid = (xyz * pmask[..., None]).sum(dim=1) / torch.clamp(
        npoints, max=cfg.max_points_per_pillar)[:, None]
    off_centroid = xyz - centroid[:, None, :]
    vsize = torch.tensor(cfg.voxel_size, dtype=dt, device=dev)
    bmin = torch.tensor([cfg.bounds[0], cfg.bounds[2]], dtype=dt, device=dev)
    cell_center = (coords.to(dt) + 0.5) * vsize[:2] + bmin
    off_center = xyz[..., :2] - cell_center[:, None, :]

    out = torch.cat([feats, off_centroid, off_center], dim=-1)
    out = out * pmask[..., None]
    return out, coords, valid


class _BevGather(torch.autograd.Function):
    """Gather-formulated BEV densification with a gather-only backward
    (the JAX module's ``_bev_gather``). Pillar cells are unique per frame,
    so the scatter is a permutation: one small int32 scatter builds the
    (W*H,) inverse index, the canvas is a row gather of the pillar
    features (cells without a pillar read an appended zero row), and the
    backward is the mirror gather ``d_pf[p] = d_canvas[flat[p]]`` (invalid
    pillars read the trash row: gradient 0). No F-wide scatter runs in
    either direction."""

    @staticmethod
    def forward(ctx, pf, flat, grid):
        b, p, nf = pf.shape
        w, h = grid
        dev = pf.device
        inv = torch.full((b, w * h + 1), p, dtype=torch.int32, device=dev)
        inv.scatter_(1, flat, torch.arange(p, dtype=torch.int32,
                                           device=dev).expand(b, p))
        rows = (inv[:, :w * h].to(torch.int64)
                + torch.arange(b, device=dev)[:, None] * (p + 1))
        pf_pad = torch.cat([pf, pf.new_zeros((b, 1, nf))], dim=1)
        canvas = pf_pad.reshape(b * (p + 1), nf)[rows.reshape(-1)]
        ctx.save_for_backward(flat)
        ctx.grid = grid
        return canvas.reshape(b, w, h, nf)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        w, h = ctx.grid
        b, p = flat.shape
        nf = g.shape[-1]
        g_pad = torch.cat([g.reshape(b, w * h, nf),
                           g.new_zeros((b, 1, nf))], dim=1)
        rows = (flat.to(torch.int64)
                + torch.arange(b, device=g.device)[:, None] * (w * h + 1))
        d_pf = g_pad.reshape(b * (w * h + 1), nf)[rows.reshape(-1)]
        return d_pf.reshape(b, p, nf), None, None


def scatter_to_bev(pf, coords, valid, grid):
    """Densify per-pillar features (B, P, F) onto the BEV canvas
    (B, W, H, F); invalid pillars land on a discarded trash row. Pillar
    coords must be unique per frame (voxelizer output — one pillar per
    cell). Differentiable through :class:`_BevGather`."""
    w, h = grid
    flat = coords[..., 0] * h + coords[..., 1]
    flat = torch.where(valid, flat, w * h).to(torch.int64)
    return _BevGather.apply(pf, flat, (w, h))


# ---------------------------------------------------------------------------
# network modules
# ---------------------------------------------------------------------------

def _bn(x, bn):
    """Inference BatchNorm over dim 1 from the running statistics (the
    flax modules at ``use_running_average=True``), output in x's dtype."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=bn.eps)


def _bn_train(x, bn, groups=None):
    """Training BatchNorm over dim 1 with flax ``nn.BatchNorm``'s semantics
    (momentum 0.99, ``use_fast_variance``): batch statistics over every
    other dim in float32 (float64 for a float64 ``x``, as flax promotes),
    ``var = max(E[x^2] - E[x]^2, 0)``, normalisation by that biased
    variance in that precision and output in x's dtype; the running
    statistics move ``0.99 * old + 0.01 * batch``, the variance biased.
    (``F.batch_norm(training=True)`` moves the running variance by 0.1 of
    the unbiased one.)

    :param groups: process groups whose ranks hold the rest of the batch
        (default: the sharded step's dp groups,
        :func:`~d3d_tpu_torch.parallel.comm.batch_groups`): the sums of x
        and x^2 and the count are summed over them, so the statistics are
        the whole batch's on every rank"""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = [d for d in range(x.ndim) if d != 1]
    groups = live(batch_groups() if groups is None else groups)
    if groups:
        c = x.shape[1]
        sums = all_reduce_sum(torch.cat([
            xf.sum(dim=dims), (xf * xf).sum(dim=dims),
            xf.new_full((1,), xf.numel() // c)]), groups)
        mean, ex2 = sums[:c] / sums[2 * c], sums[c:2 * c] / sums[2 * c]
    else:
        mean, ex2 = xf.mean(dim=dims), (xf * xf).mean(dim=dims)
    var = torch.clamp_min(ex2 - mean * mean, 0.0)
    with torch.no_grad():
        bn.running_mean.copy_(0.99 * bn.running_mean + 0.01 * mean)
        bn.running_var.copy_(0.99 * bn.running_var + 0.01 * var)
    shape = [1, -1] + [1] * (x.ndim - 2)
    mul = _bn_mul(var, bn)
    y = (xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return y.to(x.dtype)


def _same_padding(size, k, stride):
    """flax/XLA "SAME" padding of one spatial dim: (before, after). For an
    even input at stride 2 this is (0, 1) — asymmetric, unlike
    ``Conv2d(padding=1)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(x, weight, stride):
    (t, b), (l, r) = (_same_padding(x.shape[d], weight.shape[d], stride)
                      for d in (2, 3))
    if t == b and l == r:
        return F.conv2d(x, weight, stride=stride, padding=(t, l))
    return F.conv2d(F.pad(x, (l, r, t, b)), weight, stride=stride)


def _fused(train, sp=None):
    """Whether the BEV layers take their inference route: running
    statistics (``train`` False), the whole canvas (``sp`` None) and no
    gradients (``torch.inference_mode`` or ``no_grad``). There each layer
    is its linear part and one epilogue pass, BatchNorm and ReLU
    (``ops/epilogue.py`` ``bn_relu``, from :func:`_bn_stats`), on
    NCHW-contiguous maps. Any other forward takes the layers as they are
    written: linear part, BatchNorm, ReLU."""
    return not train and sp is None and not torch.is_grad_enabled()


def _bn_mul(var, bn):
    """flax's BatchNorm multiplier ``rsqrt(var + eps) * scale``."""
    return torch.rsqrt(var + bn.eps) * bn.weight


def _bn_stats(owner, slot, bn, dt):
    """``(mean, mul, beta)`` of the inference BatchNorm ``bn`` for the
    epilogue of a ``dt`` map, in float32 (float64 for a float64 map) as
    :func:`_bn_train` normalises, ``mul`` by :func:`_bn_mul`. Kept in
    ``owner._folds[slot]`` until a statistic changes: its storage or
    version (``load_state_dict``, an optimizer step, a training forward,
    ``.to()``; an update through ``.data`` counts no version and is not
    seen), the dtype or the device. A statistic that is an inference
    tensor counts no versions either: its fold is made on every call and
    not kept, as is one made while ``torch.export`` traces. Each fold
    runs in the span ``bev.fold``."""
    src = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    key = None if any(t.is_inference() for t in src) else (
        tuple((t.data_ptr(), t._version) for t in src), dt, src[0].device)
    hit = owner._folds.get(slot)
    if key is not None and hit is not None and hit[0] == key:
        return hit[1]
    ct = torch.promote_types(dt, torch.float32)
    with span("bev.fold"), torch.no_grad():
        stats = (bn.running_mean.to(ct), _bn_mul(bn.running_var.to(ct), bn),
                 bn.bias.to(ct))
    if key is not None and not torch.compiler.is_compiling():
        owner._folds[slot] = (key, stats)
    return stats


class _PFN(nn.Module):
    """Per-pillar PointNet: linear + BN + ReLU + masked max over points."""

    def __init__(self, in_features, features, dtype):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.dense = nn.Linear(in_features, features, bias=False)
        self.bn = nn.BatchNorm1d(features, eps=_BN_EPS)
        self._folds = {}

    def forward(self, x, pmask, train=False):
        """On the inference route (:func:`_fused`) BatchNorm and the ReLU
        are one epilogue pass over the linear layer's output."""
        dt = self.dtype
        x = F.linear(x.to(dt), self.dense.weight.to(dt))
        if _fused(train):
            bn_relu(x.view(-1, x.shape[-1]), *_bn_stats(self, 0, self.bn, dt))
        else:
            norm = _bn_train if train else _bn
            x = F.relu(norm(x.reshape(-1, x.shape[-1]),
                            self.bn).reshape(x.shape))
        # masked max over points: post-relu values are >= 0, so -1 is a
        # safe sentinel and empty pillars come out exactly 0 via the clamp.
        # The max is an integer argmax (the first maximal point) and a
        # gather, so a tie's whole cotangent goes to its first point, as
        # the JAX module's CPU route does (amax would split it evenly)
        x = torch.where(pmask[..., None], x, -1.0)
        idx = x.detach().argmax(dim=-2, keepdim=True)
        x = x.gather(-2, idx).squeeze(-2)
        return torch.where(x >= 0, x, 0.0)


class _ConvBlock(nn.Module):
    """``blocks`` 3x3 convolutions, each with BatchNorm and ReLU, the first
    at ``stride``. ``in_slices`` > 1: the input is that many equal slices
    stacked along the channels (SECOND's height fold), and the first
    convolution runs as one convolution a slice, summed: for 2 x 128
    channels at 176 x 200 in float32 cuDNN's heuristics pick an FFT engine
    for the whole (242 ms, 33 000 launches, 16 GB of workspace on an H100)
    and an implicit GEMM for a slice (0.36 ms)."""

    def __init__(self, in_channels, channels, blocks, stride, dtype,
                 in_slices=1):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.stride = stride
        self.in_slices = in_slices
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels if i == 0 else channels, channels, 3,
                      bias=False) for i in range(blocks))
        self.bns = nn.ModuleList(nn.BatchNorm2d(channels, eps=_BN_EPS)
                                 for _ in range(blocks))
        self._folds = {}

    def forward(self, x, train=False, sp=None):
        """``sp``: a :class:`~d3d_tpu_torch.parallel.comm.SpatialHook`
        when ``x`` is this rank's slab of the canvas (halo convolutions,
        statistics over the slabs). On the inference route
        (:func:`_fused`) the map is made NCHW-contiguous once, at the
        first layer, so that no convolution runs channels-last."""
        dt = self.dtype
        fused = _fused(train, sp)
        if fused:
            x = x.contiguous()
        conv_fn = sp.conv2d if sp is not None else _conv_same
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            stride = self.stride if i == 0 else 1
            x, w = x.to(dt), conv.weight.to(dt)
            if i == 0 and self.in_slices > 1:
                xs, ws = x.chunk(self.in_slices, 1), w.chunk(self.in_slices, 1)
                x = conv_fn(xs[0], ws[0], stride)
                for xi, wi in zip(xs[1:], ws[1:]):
                    x = x + conv_fn(xi, wi, stride)
            else:
                x = conv_fn(x, w, stride)
            x = (bn_relu(x, *_bn_stats(self, i, bn, dt)) if fused
                 else F.relu(_norm(x, bn, train, sp)))
        return x


def _norm(x, bn, train, sp=None):
    """BatchNorm of a BEV map: running statistics, or the batch's (over
    the slabs of ``sp`` too)."""
    if not train:
        return _bn(x, bn)
    return _bn_train(x, bn, None if sp is None else sp.stat_groups())


class _Upsample(nn.Module):
    def __init__(self, in_channels, channels, factor, dtype):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.factor = factor
        if factor > 1:
            # flax ConvTranspose(kernel = strides = factor, SAME): output
            # cell i*f + r takes input i through kernel tap f-1-r; the
            # converter flips the kernel so this is torch's r-th tap
            self.conv = nn.ConvTranspose2d(in_channels, channels, factor,
                                           stride=factor, bias=False)
        else:
            self.conv = nn.Conv2d(in_channels, channels, 1, bias=False)
        self.bn = nn.BatchNorm2d(channels, eps=_BN_EPS)
        self._folds = {}

    def forward(self, x, train=False, sp=None, out=None):
        """``out``: a map of the output's shape to write it into (a channel
        slice of the heads' input); the output is returned either way."""
        dt = self.dtype
        w = self.conv.weight.to(dt)
        if self.factor > 1:
            x = F.conv_transpose2d(x.to(dt), w, stride=self.factor)
        else:
            x = F.conv2d(x.to(dt), w)
        if _fused(train, sp):
            return bn_relu(x, *_bn_stats(self, 0, self.bn, dt), out=out)
        x = F.relu(_norm(x, self.bn, train, sp))
        return x if out is None else out.copy_(x)


def _bev_layers(in_channels, channels, convs, up_channels, dtype,
                in_slices=1):
    """The BEV blocks of ``convs[i]`` 3x3 convolutions of ``channels[i]``,
    the first block at stride 1 (its input ``in_slices`` slices, as
    :class:`_ConvBlock` takes them) and the rest at 2, and each block's
    upsampling by ``2**i`` to ``up_channels[i]``: two ``nn.ModuleList``."""
    blocks, ups = [], []
    for i, (ch, nb, up) in enumerate(zip(channels, convs, up_channels)):
        blocks.append(_ConvBlock(in_channels, ch, nb, 2 if i > 0 else 1,
                                 dtype, in_slices if i == 0 else 1))
        ups.append(_Upsample(ch, up, 2 ** i, dtype))
        in_channels = ch
    return nn.ModuleList(blocks), nn.ModuleList(ups)


def _bev_backbone(blocks, ups, x, train, sp, dt):
    """The BEV blocks, each followed by its upsampling: ``(B, sum of the
    upsamplings' channels, W, H)`` in ``dt``, the upsampled maps one after
    another along the channels. On the inference route (:func:`_fused`)
    each upsampling writes its slice of that map; otherwise they are
    concatenated."""
    if not _fused(train, sp):
        outs = []
        for block, up in zip(blocks, ups):
            x = block(x, train, sp)
            outs.append(up(x, train, sp))
        return torch.cat(outs, dim=1).to(dt)
    feat, at = None, 0
    for block, up in zip(blocks, ups):
        x = block(x, train, sp)
        if feat is None:
            b, _, w, h = x.shape
            feat = x.new_empty((b, sum(u.conv.out_channels for u in ups),
                                w * up.factor, h * up.factor), dtype=dt)
        width = up.conv.out_channels
        up(x, train, sp, out=feat[:, at:at + width])
        at += width
    return feat


class PointPillars(nn.Module):
    """Full network: PFN -> BEV scatter -> multi-scale 2D backbone -> SSD
    head. Input is the batched output of :func:`pillarize`.

    :param point_features: channels per input point (4: x, y, z,
        intensity); the PFN sees ``point_features + 5`` after decoration
    :param constrain: optional activation hook ``(x, kind) -> x``, called
        on the BEV canvas (NCHW) with kind "bev" (:func:`_bev_hooks`);
        :func:`~d3d_tpu_torch.parallel.mesh.spatial_constrain`'s runs the
        backbone and heads on this rank's slab of rows
    :param device: where the parameters live (default CUDA; raises when
        CUDA is missing and no device is given)
    :param generator: ``torch.Generator`` for the random initial weights
        (default: a generator seeded with 0)
    """

    def __init__(self, cfg: PointPillarsConfig, point_features=4,
                 device=None, generator=None, constrain=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.constrain = constrain
        self.pfn = _PFN(point_features + 5, cfg.pfn_features, cfg.dtype)
        self.blocks, self.ups = _bev_layers(
            cfg.pfn_features, cfg.backbone_channels, cfg.backbone_blocks,
            (cfg.upsample_channels,) * len(cfg.backbone_channels), cfg.dtype)
        feat = cfg.upsample_channels * len(self.blocks)
        a = cfg.num_anchors_per_cell
        self.head_cls = nn.Conv2d(feat, a * cfg.num_classes, 1)
        self.head_box = nn.Conv2d(feat, a * 7, 1)
        self.head_dir = nn.Conv2d(feat, a * 2, 1)
        self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Seeded random weights: He-normal kernels (LeCun-normal for the
        heads), zero biases, identity BatchNorm statistics."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        heads = (self.head_cls, self.head_box, self.head_dir)
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w[0].numel() if not isinstance(
                    mod, nn.ConvTranspose2d) else w.shape[0]
                gain = 1.0 if mod in heads else 2.0
                w.copy_(torch.randn(w.shape, generator=generator)
                        * math.sqrt(gain / fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()

    def forward(self, features, coords, valid, train=False):
        """Head outputs ``(cls (B, N, C), box (B, N, 7), dir (B, N, 2))``,
        float32 (float64 for a float64 model, :func:`_head`). ``train=True`` normalises by batch statistics and moves
        the BatchNorm running statistics (flax's ``train`` argument, not
        ``nn.Module.training``, selects it)."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)

        # pillar encoder
        with span("pointpillars.pfn"):
            pmask = (features != 0).any(dim=-1)  # (B, P, K)
            pf = self.pfn(features, pmask, train)
            pf = pf * valid[..., None].to(pf.dtype)  # (B, P, F)

        # BEV canvas, NCHW with x along the first spatial axis
        with span("pointpillars.scatter"):
            con, sp = _bev_hooks(self.constrain)
            x = con(scatter_to_bev(pf, coords, valid, cfg.grid).permute(
                0, 3, 1, 2), "bev")

        # backbone + FPN-style upsampling
        with span("pointpillars.backbone"):
            feat = _bev_backbone(self.blocks, self.ups, x, train, sp,
                                 dt)  # (B, 3*U, W, H)

        with span("pointpillars.head"):
            return (_head(feat, self.head_cls, cfg.num_classes, dt, sp),
                    _head(feat, self.head_box, 7, dt, sp),
                    _head(feat, self.head_dir, 2, dt, sp))


def _no_constrain(x, kind):
    return x


def _bev_hooks(constrain):
    """``(con, sp)``: the hook to call on the whole canvas (identity for
    None) and, for a :class:`~d3d_tpu_torch.parallel.comm.SpatialHook`,
    the hook again as the slab helper the BEV layers take (None
    otherwise). The spatial hook partitions the canvas once; the layers
    after it run on the slab, so the JAX module's later ``"bev"``
    constraints have no counterpart here."""
    con = constrain or _no_constrain
    return con, (con if isinstance(con, SpatialHook) else None)


def _head(feat, conv, c, dt, sp=None):
    """SSD head (per cell: A anchors): a 1x1 conv in ``dt`` on the NCHW
    map, back to the JAX module's NHWC order before the reshape so the
    outputs line up with :func:`make_anchors`; float32 out, float64 for a
    float64 model (the JAX module casts to float32 there too; the port
    keeps float64 so a float64 step is a float64 reference end to end:
    heads, loss and cotangent). On a slab (``sp``) the map is whole again
    (:meth:`~d3d_tpu_torch.parallel.comm.SpatialHook.gather`) before the
    reshape."""
    out = F.conv2d(feat, conv.weight.to(dt), conv.bias.to(dt))
    if sp is not None:
        out = sp.gather(out)
    return out.permute(0, 2, 3, 1).reshape(feat.shape[0], -1, c).to(
        torch.promote_types(dt, torch.float32))


# ---------------------------------------------------------------------------
# anchors and box decoding
# ---------------------------------------------------------------------------

def make_anchors(cfg: PointPillarsConfig, device=None):
    """Dense anchor grid (num_anchors, 7) [x, y, z, l, w, h, yaw] at the
    backbone output resolution (matching the head's spatial layout)."""
    w, h = cfg.grid
    vx, vy, _ = cfg.voxel_size
    xs = (np.arange(w) + 0.5) * vx + cfg.bounds[0]
    ys = (np.arange(h) + 0.5) * vy + cfg.bounds[2]
    gx, gy = np.meshgrid(xs, ys, indexing="ij")  # (w, h)
    cells = np.stack([gx, gy], axis=-1).reshape(-1, 2)

    anchors = []
    for size in cfg.anchor_sizes:
        for rot in cfg.anchor_rotations:
            a = np.zeros((cells.shape[0], 7), np.float32)
            a[:, 0:2] = cells
            a[:, 2] = cfg.anchor_z
            a[:, 3:6] = size
            a[:, 6] = rot
            anchors.append(a)
    # interleave anchors per cell: (wh, A, 7) -> (wh*A, 7)
    out = np.stack(anchors, axis=1).reshape(-1, 7)
    return torch.as_tensor(out, device=resolve_device(device))


def decode_boxes(anchors, deltas):
    """Inverse of the PointPillars residual encoding (yaw via asin of the
    residual)."""
    da = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
    return torch.stack([
        deltas[..., 0] * da + anchors[..., 0],
        deltas[..., 1] * da + anchors[..., 1],
        deltas[..., 2] * anchors[..., 5] + anchors[..., 2],
        torch.exp(deltas[..., 3]) * anchors[..., 3],
        torch.exp(deltas[..., 4]) * anchors[..., 4],
        torch.exp(deltas[..., 5]) * anchors[..., 5],
        # clip strictly inside (-1, 1): arcsin' is infinite at the endpoints
        torch.arcsin(torch.clamp(deltas[..., 6], -1 + 1e-4, 1 - 1e-4))
        + anchors[..., 6],
    ], dim=-1)


# ---------------------------------------------------------------------------
# target assignment, loss and the train step
# ---------------------------------------------------------------------------

def _bev_iou(anchors, gt):
    """BEV axis-aligned IoU between anchors (N, 7) and gt boxes (M, 7)."""
    a2 = torch.cat([anchors[:, 0:2], anchors[:, 3:5], anchors[:, 6:7]], dim=1)
    g2 = torch.cat([gt[:, 0:2], gt[:, 3:5], gt[:, 6:7]], dim=1)
    return aabox_iou(a2[:, None, :], g2[None, :, :])


def encode_boxes(anchors, gt):
    """The PointPillars residual encoding (sin of the yaw residual)."""
    da = torch.sqrt(anchors[..., 3] ** 2 + anchors[..., 4] ** 2)
    return torch.stack([
        (gt[..., 0] - anchors[..., 0]) / da,
        (gt[..., 1] - anchors[..., 1]) / da,
        (gt[..., 2] - anchors[..., 2]) / anchors[..., 5],
        torch.log(torch.clamp_min(gt[..., 3], 1e-3) / anchors[..., 3]),
        torch.log(torch.clamp_min(gt[..., 4], 1e-3) / anchors[..., 4]),
        torch.log(torch.clamp_min(gt[..., 5], 1e-3) / anchors[..., 5]),
        torch.sin(gt[..., 6] - anchors[..., 6]),
    ], dim=-1)


def assign_targets(anchors, gt_boxes, gt_labels, gt_mask, pos_iou=0.6,
                   neg_iou=0.45):
    """Anchor assignment for one frame.

    :param gt_boxes: (M, 7) padded ground truth
    :param gt_labels: (M,) int class ids (0-based)
    :param gt_mask: (M,) bool validity
    :return: dict(cls_target (N,), reg_target (N, 7), dir_target (N,) int32,
        pos (N,), neg (N,)); cls_target is -1 for ignored anchors. Ties take
        the lowest index, as ``jnp.argmax`` does; where two gts force-match
        the same anchor, the later gt wins.
    """
    n = anchors.shape[0]
    iou = torch.where(gt_mask[None, :], _bev_iou(anchors, gt_boxes), -1.0)
    best_gt = iou.argmax(dim=1)
    best_iou = iou.amax(dim=1)

    pos = best_iou >= pos_iou
    # force-match: every valid gt that overlaps something gets its best
    # anchor (a padded or non-overlapping gt would land on anchor 0)
    can_force = gt_mask & (iou.amax(dim=0) > 0)
    best_anchor = torch.where(can_force, iou.argmax(dim=0), n)
    force = torch.zeros(n + 1, dtype=torch.bool, device=anchors.device)
    force[best_anchor] = True
    gt_ids = torch.arange(gt_boxes.shape[0], device=anchors.device)
    forced_gt = torch.zeros(n + 1, dtype=torch.int64,
                            device=anchors.device).scatter_reduce(
                                0, best_anchor, gt_ids, "amax")
    force, forced_gt = force[:n], forced_gt[:n]
    best_gt = torch.where(force & ~pos, forced_gt, best_gt)
    pos = pos | force
    neg = (best_iou < neg_iou) & ~pos

    matched = gt_boxes[best_gt]
    dir_target = (torch.remainder(matched[..., 6] - anchors[..., 6],
                                  2 * math.pi) > math.pi).to(torch.int32)
    cls_target = torch.where(pos, gt_labels[best_gt], -1)
    return dict(cls_target=cls_target,
                reg_target=encode_boxes(anchors, matched),
                dir_target=dir_target, pos=pos, neg=neg)


def _focal_loss(logits, labels, pos, neg, num_classes, alpha=0.25,
                gamma=2.0):
    """Sigmoid focal loss over anchors; negatives train all classes to 0."""
    onehot = F.one_hot(labels.clamp_min(0).long(), num_classes).float()
    target = torch.where(pos[..., None], onehot, 0.0)
    weight = (pos | neg)[..., None].float()
    return _focal_terms(logits, target, weight, alpha, gamma)


def _focal_terms(logits, target, weight, alpha=0.25, gamma=2.0):
    p = torch.sigmoid(logits)
    ce = -(target * F.logsigmoid(logits)
           + (1 - target) * F.logsigmoid(-logits))
    pt = torch.where(target == 1, p, 1 - p)
    af = torch.where(target == 1, alpha, 1 - alpha)
    return torch.sum(af * (1 - pt) ** gamma * ce * weight)


def _smooth_l1(pred, target, beta=1.0 / 9):
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def detection_loss(outputs, targets, cfg: PointPillarsConfig, anchors=None,
                   riou_weight=0.0):
    """Total loss = focal cls + 2 x smooth-L1 box + 0.2 x direction CE
    (+ ``riou_weight`` x the rotated-IoU loss of the positive anchors, by
    autograd through :func:`d3d_tpu_torch.ops.geometry_soa.rbox_iou`).
    ``targets`` is either form :func:`prepare_targets` makes.

    :returns: (total, dict(cls, reg, dir[, riou], total))
    """
    cls_logits, box_preds, dir_logits = outputs
    dir_ce = -F.log_softmax(dir_logits, dim=-1)  # (B, N, 2)
    reg = _smooth_l1(box_preds, targets["reg_target"])
    if "cls_onehot" in targets:
        posf = targets["posf"]
        pos = posf > 0
        npos = torch.clamp_min(batch_sum(posf.sum()), 1.0)
        cls_loss = _focal_terms(cls_logits, targets["cls_onehot"],
                                targets["weight"][..., None]) / npos
        reg_loss = torch.sum(reg * posf[..., None]) / npos
        dir_loss = torch.sum((dir_ce * targets["dir_onehot"]).sum(-1)
                             * posf) / npos
    else:
        pos = targets["pos"]
        npos = torch.clamp_min(batch_sum(pos.sum()), 1).float()
        cls_loss = _focal_loss(cls_logits, targets["cls_target"], pos,
                               targets["neg"], cfg.num_classes) / npos
        reg_loss = torch.sum(reg * pos[..., None]) / npos
        dir_loss = torch.sum(
            torch.gather(dir_ce, -1,
                         targets["dir_target"].long()[..., None])[..., 0]
            * pos) / npos

    total = cls_loss + 2.0 * reg_loss + 0.2 * dir_loss
    aux = dict(cls=cls_loss, reg=reg_loss, dir=dir_loss)

    if riou_weight > 0.0 and anchors is not None:
        # non-positive anchors take their targets as predictions (zero loss,
        # zero gradient) before the geometry, and the size residuals are
        # clamped so exp() stays finite
        safe_tgt = torch.clamp(targets["reg_target"], -4.0, 4.0)
        safe_pred = torch.where(pos[..., None],
                                torch.clamp(box_preds, -4.0, 4.0), safe_tgt)
        dec = decode_boxes(anchors, safe_pred)
        gt_dec = decode_boxes(anchors, safe_tgt)
        bev_p = torch.cat([dec[..., 0:2], dec[..., 3:5], dec[..., 6:7]], -1)
        bev_g = torch.cat([gt_dec[..., 0:2], gt_dec[..., 3:5],
                           gt_dec[..., 6:7]], -1)
        riou = rbox_iou(bev_p, bev_g)
        riou_loss = torch.sum(torch.where(pos, 1.0 - riou, 0.0)) / npos
        total = total + riou_weight * riou_loss
        aux["riou"] = riou_loss
    aux["total"] = total
    return total, aux


def prepare_targets(anchors, batch, pos_iou=None, neg_iou=None,
                    num_classes=None, dense=False, cfg=None):
    """Batched anchor-target assignment, apart from the train step (it
    needs no parameters). Returns ``batch`` with a ``"targets"`` entry for
    ``make_train_step(..., external_targets=True)``.

    :param dense: the all-float32 form (cls_onehot / weight / posf /
        dir_onehot) instead of the int/bool one (needs ``num_classes``)
    :param cfg: PointPillarsConfig supplying pos_iou / neg_iou /
        num_classes where they are not given
    """
    if cfg is not None:
        pos_iou = cfg.pos_iou if pos_iou is None else pos_iou
        neg_iou = cfg.neg_iou if neg_iou is None else neg_iou
        num_classes = (cfg.num_classes if num_classes is None
                       else num_classes)
    if pos_iou is None or neg_iou is None:
        raise ValueError(
            "prepare_targets needs pos_iou/neg_iou: pass them or cfg=")
    frames = [assign_targets(anchors, b, l, m, pos_iou, neg_iou)
              for b, l, m in zip(batch["gt_boxes"], batch["gt_labels"],
                                 batch["gt_mask"])]
    targets = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    if dense:
        if num_classes is None:
            raise ValueError("dense targets need num_classes")
        pos = targets["pos"]
        onehot = F.one_hot(targets["cls_target"].clamp_min(0).long(),
                           num_classes).float()
        targets = dict(
            reg_target=targets["reg_target"],
            cls_onehot=torch.where(pos[..., None], onehot, 0.0),
            weight=(pos | targets["neg"]).float(),
            posf=pos.float(),
            dir_onehot=F.one_hot(targets["dir_target"].long(), 2).float())
    return dict(batch, targets=targets)


@contextlib.contextmanager
def _buffers_kept(model):
    """Put every buffer of ``model`` (the BatchNorm running statistics)
    back as it was on entry, also when the block exits early (a
    non-reentrant checkpoint stops its recompute once it has what the
    backward needs)."""
    saved = [b.clone() for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, s in zip(model.buffers(), saved):
                b.copy_(s)


def make_train_step(model, optimizer, cfg: PointPillarsConfig, anchors,
                    riou_weight=0.0, remat=False, external_targets=False):
    """Build ``step(batch) -> aux``, one training step that updates
    ``model`` (its parameters and BatchNorm running statistics) and
    ``optimizer`` (e.g. from :func:`d3d_tpu_torch.train.make_optimizer`) in
    place: forward with ``train=True``, :func:`detection_loss`, backward,
    ``optimizer.step()``. After it each parameter's ``.grad`` holds this
    step's gradient (before clipping). ``aux`` holds the loss terms as
    detached 0-d tensors.

    ``batch`` carries the model's stacked inputs (features/coords/valid)
    and padded gt_boxes (B, M, 7), gt_labels (B, M), gt_mask (B, M); tensors
    stay on their device, anything else goes to the model's.

    :param external_targets: take ``batch["targets"]`` from
        :func:`prepare_targets` instead of assigning anchors in the step
    :param remat: recompute the forward in the backward instead of keeping
        its activations (the JAX step's ``jax.checkpoint``), through
        ``torch.utils.checkpoint`` (non-reentrant). The recompute would
        move the BatchNorm running statistics a second time, so the
        model's buffers are put back as they were after it
        (:func:`_buffers_kept`): loss, gradients and statistics equal the
        step without ``remat``.

    A model that sows auxiliary losses (SST with ``moe_experts``: its
    ``sown_losses`` after the forward) adds ``cfg.moe_aux_weight`` times
    their sum to the loss and reports the sum as ``aux["moe_aux"]``
    (``aux["total"]`` stays the detection loss), as the JAX step does.

    The step carries ``model``, ``optimizer`` and ``backward`` (the step
    without ``zero_grad`` and ``optimizer.step()``: forward, loss and
    backward on a batch, returning ``aux``) as attributes, and
    ``global_aux``, the ``aux`` keys that are whole on every rank of a
    sharded step; :func:`~d3d_tpu_torch.parallel.mesh.shard_train_step`
    runs them over a mesh.
    """
    dev = next(model.parameters()).device
    anchors = as_tensor(anchors, device=dev, dtype=torch.float32)

    def forward(features, coords, valid):
        # the model's sown losses (SST's MoE load-balance terms) come out
        # beside the heads, so a checkpointed forward carries them too
        outputs = model(features, coords, valid, train=True)
        return outputs, tuple(getattr(model, "sown_losses", ()))

    if remat:
        def run_forward(*inputs):
            return checkpoint(forward, *inputs, use_reentrant=False,
                              context_fn=lambda: (
                                  contextlib.nullcontext(),
                                  _buffers_kept(model)))
    else:
        run_forward = forward

    def backward(batch):
        with span("train.forward"):
            batch = {k: (v if k == "targets" else as_tensor(v, device=dev))
                     for k, v in batch.items()}
            outputs, sown = run_forward(batch["features"], batch["coords"],
                                        batch["valid"])
        with span("train.loss"):
            if external_targets:
                targets = {k: as_tensor(v, device=dev).detach()
                           for k, v in batch["targets"].items()}
            else:
                with torch.no_grad():
                    targets = prepare_targets(anchors, batch,
                                              cfg=cfg)["targets"]
            loss, aux = detection_loss(outputs, targets, cfg, anchors,
                                       riou_weight)
            if sown:
                # a sharded step computes the load-balance loss whole on
                # every rank (global routing statistics): each adds its
                # share
                aux_total = sum(sown)
                loss = loss + (getattr(cfg, "moe_aux_weight", 0.0)
                               * loss_share()) * aux_total
                aux["moe_aux"] = aux_total
        with span("train.backward"):
            loss.backward()
        return {k: v.detach() for k, v in aux.items()}

    return _train_step(model, optimizer, backward, global_aux=("moe_aux",))


def _train_step(model, optimizer, backward, global_aux=()):
    """``step(batch) -> aux``: ``zero_grad``, ``backward(batch)`` (forward,
    loss and backward, returning ``aux``), ``optimizer.step()``. The step
    carries ``model``, ``optimizer``, ``backward`` and ``global_aux`` (the
    ``aux`` keys that are whole on every rank of a sharded step), which
    :func:`~d3d_tpu_torch.parallel.mesh.shard_train_step` reads; every
    family's ``make_train_step`` builds its step here."""
    def train_step(batch):
        optimizer.zero_grad(set_to_none=True)
        aux = backward(batch)
        optimizer.step()
        return aux

    train_step.model, train_step.optimizer = model, optimizer
    train_step.backward, train_step.global_aux = backward, tuple(global_aux)
    return train_step

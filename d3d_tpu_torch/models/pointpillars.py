"""PointPillars 3D detector, inference half (port of
``d3d_tpu.models.pointpillars``).

Pillarization reuses the sort-based voxelizer; the pillar feature net, BEV
backbone and SSD head are ``nn.Module`` s whose parameters stay float32 and
whose compute runs in ``cfg.dtype`` (each op casts its input and weight,
as the flax modules do). The network runs NCHW internally with x along the
first spatial axis; its public layout is the JAX module's: head outputs
``(B, W*H*A, C)`` in the same anchor order as :func:`make_anchors`.

Not ported yet: target assignment, the losses and the train step.

Reference: Lang et al., "PointPillars: Fast Encoders for Object Detection
from Point Clouds", CVPR 2019 (arXiv:1812.05784).
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.voxel import voxelize_dense_padded
from ..utils import as_tensor, resolve_device

__all__ = ["PointPillarsConfig", "PointPillars", "pillarize", "scatter_to_bev",
           "make_anchors", "decode_boxes"]

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


def scatter_to_bev(pf, coords, valid, grid):
    """Densify per-pillar features (B, P, F) onto the BEV canvas
    (B, W, H, F); invalid pillars land on a discarded trash row. Pillar
    coords must be unique per frame (voxelizer output — one pillar per
    cell). Forward only."""
    w, h = grid
    b, p, nf = pf.shape
    flat = coords[..., 0] * h + coords[..., 1]
    flat = torch.where(valid, flat, w * h).to(torch.int64)
    canvas = pf.new_zeros((b, w * h + 1, nf))
    canvas.scatter_(1, flat[..., None].expand(b, p, nf), pf)
    return canvas[:, :w * h].reshape(b, w, h, nf)


# ---------------------------------------------------------------------------
# network modules
# ---------------------------------------------------------------------------

def _bn(x, bn):
    """Inference BatchNorm over dim 1 from the running statistics (the
    flax modules at ``use_running_average=True``), output in x's dtype."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training=False, eps=bn.eps)


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


class _PFN(nn.Module):
    """Per-pillar PointNet: linear + BN + ReLU + masked max over points."""

    def __init__(self, in_features, features, dtype):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.dense = nn.Linear(in_features, features, bias=False)
        self.bn = nn.BatchNorm1d(features, eps=_BN_EPS)

    def forward(self, x, pmask):
        dt = self.dtype
        x = F.linear(x.to(dt), self.dense.weight.to(dt))
        x = F.relu(_bn(x.reshape(-1, x.shape[-1]), self.bn).reshape(x.shape))
        # masked max over points: post-relu values are >= 0, so -1 is a
        # safe sentinel and empty pillars come out exactly 0 via the clamp
        x = torch.where(pmask[..., None], x, -1.0).amax(dim=-2)
        return torch.where(x >= 0, x, 0.0)


class _ConvBlock(nn.Module):
    def __init__(self, in_channels, channels, blocks, stride, dtype):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.stride = stride
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels if i == 0 else channels, channels, 3,
                      bias=False) for i in range(blocks))
        self.bns = nn.ModuleList(nn.BatchNorm2d(channels, eps=_BN_EPS)
                                 for _ in range(blocks))

    def forward(self, x):
        dt = self.dtype
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            x = _conv_same(x.to(dt), conv.weight.to(dt),
                           self.stride if i == 0 else 1)
            x = F.relu(_bn(x, bn))
        return x


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

    def forward(self, x):
        dt = self.dtype
        w = self.conv.weight.to(dt)
        if self.factor > 1:
            x = F.conv_transpose2d(x.to(dt), w, stride=self.factor)
        else:
            x = F.conv2d(x.to(dt), w)
        return F.relu(_bn(x, self.bn))


class PointPillars(nn.Module):
    """Full network: PFN -> BEV scatter -> multi-scale 2D backbone -> SSD
    head. Input is the batched output of :func:`pillarize`.

    :param point_features: channels per input point (4: x, y, z,
        intensity); the PFN sees ``point_features + 5`` after decoration
    :param device: where the parameters live (default CUDA; raises when
        CUDA is missing and no device is given)
    :param generator: ``torch.Generator`` for the random initial weights
        (default: a generator seeded with 0)
    """

    def __init__(self, cfg: PointPillarsConfig, point_features=4,
                 device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
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

    def forward(self, features, coords, valid):
        cfg = self.cfg
        b = features.shape[0]
        dt = getattr(torch, cfg.dtype)

        # pillar encoder
        pmask = (features != 0).any(dim=-1)  # (B, P, K)
        pf = self.pfn(features, pmask)
        pf = pf * valid[..., None].to(pf.dtype)  # (B, P, F)

        # BEV canvas, NCHW with x along the first spatial axis
        x = scatter_to_bev(pf, coords, valid, cfg.grid).permute(0, 3, 1, 2)

        # backbone + FPN-style upsampling
        ups = []
        for block, up in zip(self.blocks, self.ups):
            x = block(x)
            ups.append(up(x))
        feat = torch.cat(ups, dim=1).to(dt)  # (B, 3*U, W, H)

        return (_head(feat, self.head_cls, cfg.num_classes, dt),
                _head(feat, self.head_box, 7, dt),
                _head(feat, self.head_dir, 2, dt))


def _head(feat, conv, c, dt):
    """SSD head (per cell: A anchors): a 1x1 conv in ``dt`` on the NCHW
    map, back to the JAX module's NHWC order before the reshape so the
    outputs line up with :func:`make_anchors`; float32 out."""
    out = F.conv2d(feat, conv.weight.to(dt), conv.bias.to(dt))
    return out.permute(0, 2, 3, 1).reshape(feat.shape[0], -1, c).to(
        torch.float32)


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

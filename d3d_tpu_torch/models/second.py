"""SECOND sparse voxel detector, inference half (port of
``d3d_tpu.models.second``).

Yan et al., "SECOND: Sparsely Embedded Convolutional Detection", Sensors
2018: voxelize -> sparse 3D middle extractor -> collapse z -> 2D RPN with
anchors. The middle extractor runs on the port's sparse-conv core
(:mod:`d3d_tpu_torch.ops.sparse_conv`: dense-canvas neighbour maps, the
gather-GEMM K5 on CUDA, sort-unique downsampling); the anchor head is
PointPillars', so anchors, decoding and the detector factory are shared.

Parameters stay float32 and the compute runs in ``cfg.dtype``. Shapes are
static: per-stage active-site caps, masked padding. The sparse stages run
one frame at a time (serving sends one); the BEV head runs batched.

Not ported yet: ``middle="dense"`` (``dense_stage_loop``) raises
``NotImplementedError``; target assignment, the losses, training-mode
BatchNorm statistics and the train step are absent.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse_conv import (build_neighbor_map, build_neighbor_map_strided,
                               downsample_coords, sparse_to_dense,
                               subm_conv_apply)
from ..ops.voxel import voxelize_dense_padded
from ..utils import as_tensor, resolve_device
from .pointpillars import PointPillarsConfig, _ConvBlock, _head

__all__ = ["SECONDConfig", "SECOND", "second_voxelize", "head_config",
           "sparse_stage_loop"]

_K = 27  # 3x3x3 kernel offsets


@dataclass(frozen=True)
class SECONDConfig:
    """Static configuration (the JAX module's fields and defaults)."""

    bounds: Tuple[float, ...] = (0.0, 70.4, -40.0, 40.0, -3.0, 1.0)
    grid: Tuple[int, int, int] = (352, 400, 20)   # (x, y, z) voxel cells
    max_voxels: int = 16000
    stage_channels: Tuple[int, ...] = (16, 32, 64)
    stage_sites: Tuple[int, ...] = (16000, 8000, 4000)  # caps after stride
    subm_per_stage: int = 2
    head_channels: int = 128
    num_classes: int = 1
    anchor_sizes: Tuple[Tuple[float, float, float], ...] = ((3.9, 1.6, 1.56),)
    anchor_z: float = -1.0
    anchor_rotations: Tuple[float, ...] = (0.0, 1.5707963)
    pos_iou: float = 0.6
    neg_iou: float = 0.45
    dtype: str = "float32"
    # "sparse" or "auto" (= sparse) run the active-site stage loop; the
    # JAX module's "dense" canvas strategy is not ported
    middle: str = "auto"
    dense_max_cells: int = 8_000_000

    @property
    def n_stages(self):
        return len(self.stage_channels)

    def middle_mode(self):
        mode = self.middle if self.middle != "auto" else "sparse"
        if mode == "dense":
            cells = int(np.prod(self.grid))
            if cells > self.dense_max_cells:
                raise ValueError(
                    f"middle='dense' over a {self.grid} grid materializes "
                    f"{cells} cells per layer, over the dense_max_cells "
                    f"budget ({self.dense_max_cells}); use middle='sparse' "
                    "or raise dense_max_cells explicitly")
        return mode

    def _downsampled_grid(self):
        """Ceil-divide per stage, exactly like the stage loop (a plain
        ``grid // 2**stages`` would alias odd dimensions)."""
        g = tuple(self.grid)
        for _ in range(self.n_stages - 1):
            g = tuple(-(-x // 2) for x in g)
        return g

    @property
    def bev_grid(self):
        g = self._downsampled_grid()
        return (g[0], g[1])

    @property
    def final_grid(self):
        return self._downsampled_grid()


def head_config(cfg: SECONDConfig) -> PointPillarsConfig:
    """A PointPillarsConfig describing the 2D head's anchor grid, so SECOND
    reuses :func:`make_anchors` and the detector factory unchanged."""
    return PointPillarsConfig(
        bounds=cfg.bounds, grid=cfg.bev_grid, num_classes=cfg.num_classes,
        anchor_sizes=cfg.anchor_sizes, anchor_z=cfg.anchor_z,
        anchor_rotations=cfg.anchor_rotations, pos_iou=cfg.pos_iou,
        neg_iou=cfg.neg_iou, dtype=cfg.dtype)


def second_voxelize(points, cfg: SECONDConfig):
    """Points (N, 4) -> (features (V, 4) per-voxel means, coords (V, 3)
    int32 [ix, iy, iz], valid (V,)) with static shapes, voxels in cell-key
    order. A tensor stays on its device, anything else goes to CUDA."""
    points = as_tensor(points)
    bounds = torch.tensor(cfg.bounds, dtype=points.dtype,
                          device=points.device)
    vox = voxelize_dense_padded(points, cfg.grid, bounds, 1, cfg.max_voxels,
                                "mean", order_mode="sorted")
    feats = vox.aggregates                        # (V, 4) means
    coords = vox.coords.to(torch.int32)           # (V, 3)
    valid = (torch.arange(cfg.max_voxels, dtype=torch.int32,
                          device=points.device) < vox.nvoxels)
    return feats * valid[:, None].to(feats.dtype), coords, valid


class _MaskedBN(nn.Module):
    """BatchNorm over active sites, inference mode: the running statistics
    (float32) normalise in the input dtype, in the JAX module's order of
    casts, and padded rows come out 0."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, valid):
        dt = x.dtype
        mul = (torch.rsqrt(self.running_var + 1e-3) * self.weight).to(dt)
        y = (x - self.running_mean.to(dt)) * mul + self.bias.to(dt)
        return y * valid[..., None].to(dt)


class _SpConv(nn.Module):
    """One sparse conv layer (submanifold or strided, as the neighbour map
    says) + masked BN + ReLU. ``weight`` is (K, C, Cout), the flax layout."""

    def __init__(self, in_channels, channels, dtype, symmetric=False):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.symmetric = symmetric
        self.weight = nn.Parameter(torch.empty(_K, in_channels, channels))
        self.bn = _MaskedBN(channels)

    def forward(self, x, nbr, valid):
        y = subm_conv_apply(x.to(self.dtype), nbr, self.weight, valid,
                            symmetric=self.symmetric)
        return F.relu(self.bn(y, valid))


def _stage_maps(cfg, coords, valid):
    """The neighbour maps of the sparse stages of one frame (they depend
    on the geometry only): per stage ``(nbr, valid, nbr_down, valid_down)``
    -- the submanifold map of the stage's sites, and the strided map to
    the next stage's sites with their mask (None after the last stage) --
    and the final sites' (coords, valid, grid)."""
    grid = tuple(cfg.grid)
    maps = []
    for s in range(cfg.n_stages):
        nbr = build_neighbor_map(coords, valid, grid)
        if s + 1 == cfg.n_stages:
            maps.append((nbr, valid, None, None))
            break
        oc, ov = downsample_coords(coords, valid, grid, 2,
                                   cfg.stage_sites[s + 1])
        nbr_s = build_neighbor_map_strided(oc, ov, coords, valid, grid, 2)
        maps.append((nbr, valid, nbr_s, ov))
        coords, valid = oc, ov
        grid = tuple(-(-g // 2) for g in grid)
    return maps, (coords, valid, grid)


def _run_stages(cfg, layers, x, maps):
    """The sparse layers on :func:`_stage_maps`' maps, taken from ``layers``
    by the JAX module's names ``subm{s}_{i}`` / ``down{s}``."""
    for s, (nbr, valid, nbr_s, valid_s) in enumerate(maps):
        for i in range(cfg.subm_per_stage):
            x = layers[f"subm{s}_{i}"](x, nbr, valid)
        if nbr_s is not None:
            x = layers[f"down{s}"](x, nbr_s, valid_s)
    return x


def sparse_stage_loop(cfg, layers, x, coords, valid):
    """The sparse-backbone stage loop of one frame (SECOND, later
    VoxelNeXt): submanifold convs on the active set, a strided downsample
    between stages.

    :param x: (V, C) site features; ``coords`` (V, 3) int32; ``valid`` (V,)
    :returns: (features, coords, valid, final_grid)
    """
    maps, final = _stage_maps(cfg, coords, valid)
    return (_run_stages(cfg, layers, x, maps),) + final


class SECOND(nn.Module):
    """Sparse middle extractor + BEV RPN head (PointPillars-compatible
    outputs: cls logits, box deltas, direction logits per anchor, in the
    JAX module's anchor order). Input is the batched output of
    :func:`second_voxelize`.

    :param point_features: channels per voxel (4: mean x, y, z, intensity)
    :param device: where the parameters live (default CUDA; raises when
        CUDA is missing and no device is given)
    :param generator: ``torch.Generator`` for the random initial weights
        (default: a generator seeded with 0)
    """

    def __init__(self, cfg: SECONDConfig, point_features=4, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        if cfg.middle_mode() == "dense":
            raise NotImplementedError(
                "middle='dense' (dense_stage_loop) is not ported yet")
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
        self.head_block = _ConvBlock(cfg.final_grid[2] * c_in,
                                     cfg.head_channels, 2, 1, cfg.dtype)
        a = len(cfg.anchor_sizes) * len(cfg.anchor_rotations)
        self.head_cls = nn.Conv2d(cfg.head_channels, a * cfg.num_classes, 1)
        self.head_box = nn.Conv2d(cfg.head_channels, a * 7, 1)
        self.head_dir = nn.Conv2d(cfg.head_channels, a * 2, 1)
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
            if isinstance(mod, (nn.Conv2d, _SpConv)):
                w = mod.weight
                fan_in = w[0].numel() if isinstance(mod, nn.Conv2d) \
                    else w.shape[0] * w.shape[1]
                gain = 1.0 if mod in heads else 2.0
                w.copy_(torch.randn(w.shape, generator=generator)
                        * (gain / fan_in) ** 0.5)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (_MaskedBN, nn.BatchNorm2d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)

    def forward(self, features, coords, valid):
        """:param features: (B, V, 4) voxel means
        :param coords: (B, V, 3) int32
        :param valid: (B, V) bool
        """
        dense = []
        for f, c, v in zip(features, coords, valid):
            x, oc, ov, fg = sparse_stage_loop(self.cfg, self.middle, f, c, v)
            dense.append(sparse_to_dense(x, oc, ov, fg))  # (X, Y, Z, C)
        return self.bev_head(torch.stack(dense))

    def bev_head(self, dense):
        """(B, X, Y, Z, C) final-stage canvas -> the three head outputs."""
        cfg = self.cfg
        b, nx, ny = dense.shape[:3]
        dt = getattr(torch, cfg.dtype)
        # fold z into channels z-major, as the JAX module's reshape does,
        # then NCHW with x along the first spatial axis
        bev = self.head_block(dense.reshape(b, nx, ny, -1).permute(0, 3, 1, 2))
        return (_head(bev, self.head_cls, cfg.num_classes, dt),
                _head(bev, self.head_box, 7, dt),
                _head(bev, self.head_dir, 2, dt))

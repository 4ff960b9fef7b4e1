"""SECOND sparse voxel detector (port of ``d3d_tpu.models.second``).

Yan et al., "SECOND: Sparsely Embedded Convolutional Detection", Sensors
2018: voxelize -> sparse 3D middle extractor -> collapse z -> 2D RPN with
anchors. The middle extractor runs on the port's sparse-conv core
(:mod:`d3d_tpu_torch.ops.sparse_conv`: the gather-GEMM K5 on CUDA with K6
and K5 in its backward; every stage's neighbour maps and downsampled sites
by :mod:`d3d_tpu_torch.ops.stage_maps`, the kernel chain M1 on CUDA); the
anchor head, target assignment, loss and train step are PointPillars', so
anchors, decoding and the detector factory are shared.

Parameters stay float32 and the compute runs in ``cfg.dtype``. Shapes are
static: per-stage active-site caps, masked padding. The sparse stages run
the frames of a batch as one joined site list; the BEV head runs batched.

``middle="dense"`` runs the same layers (the same parameters) on a dense
canvas instead (:func:`dense_stage_loop`): a masked 3D convolution a layer,
``F.conv3d``, as the JAX module's ``lax.conv_general_dilated``. It never
truncates, so it equals the sparse path wherever the site caps do not
bind.

``SECOND(cfg, layout=SECONDLayout())`` runs OpenPCDet's structure instead
(:class:`SECONDLayout`): strided layers by spconv's rule, a last strided
layer along z, and the two-block BEV network of PointPillars' layers.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse_conv import (conv_out_grid, prepare_neighbor_maps,
                               sparse_to_dense, subm_conv_apply)
from ..ops.stage_maps import Down, build_stage_maps
from ..ops.voxel import voxelize_dense_padded, voxelize_mean_fm_exact
from ..parallel.comm import all_reduce_sum, batch_groups, live
from ..profiler import span
from ..utils import as_tensor, resolve_device
from .pointpillars import (PointPillarsConfig, _bev_backbone, _bev_hooks,
                           _bev_layers, _ConvBlock, _head)
from .pointpillars import make_train_step as _pp_make_train_step

__all__ = ["SECONDConfig", "SECONDLayout", "SECOND", "second_voxelize",
           "head_config", "sparse_stage_loop", "dense_stage_loop",
           "make_train_step"]

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
    # "sparse" or "auto" (= sparse) run the active-site stage loop,
    # "dense" the dense-canvas one (dense_stage_loop)
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


@dataclass(frozen=True)
class SECONDLayout:
    """OpenPCDet's structure of SECOND (``VoxelBackBone8x`` and
    ``BaseBEVBackbone`` of ``tools/cfgs/kitti_models/second.yaml``; the
    defaults are its KITTI values), chosen by ``SECOND(cfg, layout=...)``.
    The stages' channels, submanifold layers and site caps stay ``cfg``'s.

    - ``z_extent``: the middle's sparse z extent (the voxel grid's + 1);
    - ``down_padding``: the padding (x, y, z) of the strided layer after
      each stage but the last; kernel 3, stride 2, outputs by spconv's
      rule (:func:`~d3d_tpu_torch.ops.sparse_conv.downsample_coords`);
    - ``out_*``: the strided layer after the last stage (``conv_out``),
      padding 0, and its site cap;
    - ``bev_*``: the BEV blocks, 3x3 convolutions, the first block at
      stride 1 and the rest at 2, each followed by its upsampling by
      ``2**i`` (PointPillars' ``_ConvBlock`` and ``_Upsample``); the heads
      read the upsampled maps one after another along the channels.
    """

    z_extent: int = 41
    down_padding: Tuple[Tuple[int, int, int], ...] = ((1, 1, 1), (1, 1, 1),
                                                      (1, 1, 0))
    out_channels: int = 128
    out_kernel: Tuple[int, int, int] = (1, 1, 3)
    out_stride: Tuple[int, int, int] = (1, 1, 2)
    out_sites: int = 16000
    bev_channels: Tuple[int, ...] = (128, 256)
    bev_convs: Tuple[int, ...] = (6, 6)
    bev_up_channels: Tuple[int, ...] = (256, 256)

    def down(self, cfg, s):
        """(kernel, stride, padding, site cap) of the strided layer after
        stage ``s``."""
        if s + 1 == cfg.n_stages:
            return self.out_kernel, self.out_stride, 0, self.out_sites
        return 3, 2, self.down_padding[s], cfg.stage_sites[s + 1]

    def grids(self, cfg):
        """The sparse extents (x, y, z): each stage's, then the last
        strided layer's output."""
        g = [(cfg.grid[0], cfg.grid[1], self.z_extent)]
        for s in range(cfg.n_stages):
            kernel, stride, pad, _ = self.down(cfg, s)
            g.append(conv_out_grid(g[-1], kernel, stride, pad))
        return g


def head_config(cfg: SECONDConfig, layout=None) -> PointPillarsConfig:
    """A PointPillarsConfig describing the 2D head's anchor grid, so SECOND
    reuses :func:`make_anchors` and the detector factory unchanged (with a
    :class:`SECONDLayout`, its BEV grid)."""
    grid = cfg.bev_grid if layout is None else layout.grids(cfg)[-1][:2]
    return PointPillarsConfig(
        bounds=cfg.bounds, grid=grid, num_classes=cfg.num_classes,
        anchor_sizes=cfg.anchor_sizes, anchor_z=cfg.anchor_z,
        anchor_rotations=cfg.anchor_rotations, pos_iou=cfg.pos_iou,
        neg_iou=cfg.neg_iou, dtype=cfg.dtype)


def second_voxelize(points, cfg: SECONDConfig, exact_mean=False):
    """Points (N, 4) -> (features (V, 4) per-voxel means, coords (V, 3)
    int32 [ix, iy, iz], valid (V,)) with static shapes, voxels in cell-key
    order. A tensor stays on its device, anything else goes to CUDA.

    The means are the JAX module's: differences of a float32 prefix sum
    over every point, off by centimetres where the sums reach ~10^6. With
    ``exact_mean`` each voxel's sums are exact integer sums of its points
    (:func:`~d3d_tpu_torch.ops.voxel.voxelize_mean_fm_exact`), and the
    means are right to float32 rounding."""
    points = as_tensor(points)
    bounds = torch.tensor(cfg.bounds, dtype=points.dtype,
                          device=points.device)
    if exact_mean:
        vox = voxelize_mean_fm_exact(points.T, cfg.grid, bounds,
                                     cfg.max_voxels)
        feats, coords = vox.aggregates.T, vox.coords.T.to(torch.int32)
    else:
        vox = voxelize_dense_padded(points, cfg.grid, bounds, 1,
                                    cfg.max_voxels, "mean",
                                    order_mode="sorted")
        feats = vox.aggregates                    # (V, 4) means
        coords = vox.coords.to(torch.int32)       # (V, 3)
    valid = (torch.arange(cfg.max_voxels, dtype=torch.int32,
                          device=points.device) < vox.nvoxels)
    return feats * valid[:, None].to(feats.dtype), coords, valid


class _MaskedBN(nn.Module):
    """BatchNorm over active sites (padded rows excluded from the
    statistics). The statistics are float32; they normalise in the input
    dtype, in the JAX module's order of casts, and padded rows come out 0.

    With ``train`` the statistics are the batch's: a masked two-pass mean
    and (biased) variance over every valid row, and the running statistics
    move ``0.99 * old + 0.01 * batch``; otherwise the running statistics.
    In a sharded step each pass's sums and the count are summed over the
    dp ranks (:func:`~d3d_tpu_torch.parallel.comm.batch_groups`), so the
    statistics are the whole batch's."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, valid, train=False):
        if train:
            xf = x.float()
            w = valid[:, None].to(torch.float32)
            groups = live(batch_groups())
            if groups:
                s = all_reduce_sum(torch.cat([(xf * w).sum(dim=0),
                                              w.sum().reshape(1)]), groups)
                n = torch.clamp_min(s[-1], 1.0)
                mean = s[:-1] / n
                var = all_reduce_sum((((xf - mean) ** 2) * w).sum(dim=0),
                                     groups) / n
            else:
                n = torch.clamp_min(w.sum(), 1.0)
                mean = (xf * w).sum(dim=0) / n
                var = (((xf - mean) ** 2) * w).sum(dim=0) / n
            with torch.no_grad():
                self.running_mean.copy_(0.99 * self.running_mean
                                        + 0.01 * mean)
                self.running_var.copy_(0.99 * self.running_var + 0.01 * var)
        else:
            mean, var = self.running_mean, self.running_var
        dt = x.dtype
        mul = (torch.rsqrt(var + 1e-3) * self.weight).to(dt)
        y = (x - mean.to(dt)) * mul + self.bias.to(dt)
        return y * valid[..., None].to(dt)


class _SpConv(nn.Module):
    """One sparse conv layer (submanifold or strided, as the neighbour map
    says) + masked BN + ReLU. ``weight`` is (K, C, Cout), the flax layout."""

    def __init__(self, in_channels, channels, dtype, symmetric=False, k=_K):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.symmetric = symmetric
        self.weight = nn.Parameter(torch.empty(k, in_channels, channels))
        self.bn = _MaskedBN(channels)

    def forward(self, x, nbr, valid, train=False):
        y = subm_conv_apply(x.to(self.dtype), nbr, self.weight, valid,
                            symmetric=self.symmetric)
        return F.relu(self.bn(y, valid, train))


def _pool_mask(mask, stride):
    """Active set of a strided conv's output on (B, X, Y, Z) masks: a cell
    is active iff its ``stride``-window holds an active input (the dense
    twin of :func:`downsample_coords`); odd dims are padded up so their
    last partial window counts (ceil-division)."""
    pad = []
    for d in reversed(mask.shape[1:]):
        pad += [0, (-d) % stride]
    m = F.pad(mask[:, None].to(torch.float32), pad)
    return F.max_pool3d(m, stride, stride)[:, 0] > 0


class _SpConvDense(_SpConv):
    """Dense-canvas twin of :class:`_SpConv` (the same parameters: the
    (K, C, Cout) kernel in ``kernel_offsets``' raster order is the
    (3, 3, 3, C, Cout) DHWIO kernel): one 3D convolution (padding 1,
    stride 1 or 2) on a (B, X, Y, Z, C) canvas, the masked BatchNorm over
    the active cells (the pooled mask after a strided layer), ReLU."""

    def __init__(self, in_channels, channels, dtype, stride=1):
        super().__init__(in_channels, channels, dtype)
        self.stride = stride

    def forward(self, x, mask, train=False):
        c_in, c_out = self.weight.shape[1:]
        kern = self.weight.reshape(3, 3, 3, c_in, c_out).permute(
            4, 3, 0, 1, 2).to(self.dtype)              # DHWIO -> OIDHW
        y = F.conv3d(x.to(self.dtype).permute(0, 4, 1, 2, 3), kern,
                     stride=self.stride, padding=1).permute(0, 2, 3, 4, 1)
        if self.stride > 1:
            mask = _pool_mask(mask, self.stride)
        shape = y.shape
        y = self.bn(y.reshape(-1, c_out), mask.reshape(-1), train)
        return F.relu(y).reshape(shape), mask


def dense_stage_loop(cfg, layers, x, coords, valid, train=False):
    """Dense-canvas execution of the middle extractor: scatter the voxel
    features once, then every submanifold layer as a masked convolution
    and every downsample as a strided one with the pooled mask. Layers
    and parameters are :func:`sparse_stage_loop`'s (``layers`` maps the
    names ``subm{s}_{i}`` / ``down{s}`` to :class:`_SpConvDense`).

    The sparse path's site caps (``cfg.stage_sites``) truncate; this one
    never does, so the two agree wherever the caps do not bind.

    :param x: (B, V, C) site features; ``coords`` (B, V, 3) int32;
        ``valid`` (B, V)
    :returns: (canvas (B, X', Y', Z', C'), mask (B, X', Y', Z'))
    """
    b = x.shape[0]
    canvas = torch.stack([sparse_to_dense(f, c, v, cfg.grid)
                          for f, c, v in zip(x, coords, valid)])
    mask = torch.zeros((b,) + tuple(cfg.grid), dtype=torch.bool,
                       device=x.device)
    frame = torch.arange(b, device=x.device)[:, None].expand_as(valid)
    c = coords.long()
    mask[frame[valid], c[..., 0][valid], c[..., 1][valid],
         c[..., 2][valid]] = True
    canvas = canvas * mask[..., None].to(canvas.dtype)
    for s in range(cfg.n_stages):
        for i in range(cfg.subm_per_stage):
            canvas, _ = layers[f"subm{s}_{i}"](canvas, mask, train)
        if s + 1 < cfg.n_stages:
            canvas, mask = layers[f"down{s}"](canvas, mask, train)
    return canvas, mask


def _stage_plan(cfg, layout=None):
    """(grid, downs) of the sparse stages
    (:func:`~d3d_tpu_torch.ops.stage_maps.build_stage_maps`): the JAX
    module's ``coords // 2`` after each stage but the last, capped by the
    next stage's sites; a :class:`SECONDLayout`'s strided layers by
    spconv's rule after every stage, the last its ``out_*`` layer."""
    if layout is None:
        return tuple(cfg.grid), [Down(2, cfg.stage_sites[s + 1])
                                 for s in range(cfg.n_stages - 1)] + [None]
    downs = []
    for s in range(cfg.n_stages):
        kernel, stride, pad, cap = layout.down(cfg, s)
        downs.append(Down(stride, cap, kernel, pad))
    return layout.grids(cfg)[0], downs


def _batch_stage_maps(cfg, coords, valid, layout=None):
    """The maps of every frame of (B, V, 3) coords and (B, V) valid,
    joined into the maps of ONE site list
    (:func:`~d3d_tpu_torch.ops.stage_maps.build_stage_maps`: M1 on CUDA,
    :func:`~d3d_tpu_torch.ops.stage_maps.frame_stage_maps` a frame on the
    CPU): frame b's rows of a stage with R rows a frame are rows
    ``b*R ... b*R + R - 1``. Every layer then
    runs once on the whole batch, and a masked BatchNorm reduces over the
    whole batch, as the JAX module's statistics over (B, V) do. On CUDA the
    joined maps come with their rule books (:func:`prepare_neighbor_maps`,
    all maps of the batch in one call a kernel size), built here once for
    every launch on them; the CPU's plain versions read the bare maps.
    Returns the joined maps and the final stage's (coords (B, R, 3), valid
    (B, R), grid)."""
    maps, final = build_stage_maps(coords, valid,
                                   *_stage_plan(cfg, layout))
    if coords.device.type == "cuda":
        maps = _prepare_maps(maps)
    return maps, final


def _prepare_maps(maps):
    """:func:`_batch_stage_maps`' maps with every neighbour map (each
    stage's submanifold map and strided map) replaced by its rule book,
    built together, one call of :func:`prepare_neighbor_maps` for the maps
    of each kernel size."""
    flat = [m for nbr, _, nbr_s, _ in maps for m in (nbr, nbr_s)
            if m is not None]
    books = [None] * len(flat)
    for k in sorted({m.shape[1] for m in flat}):
        rows = [i for i, m in enumerate(flat) if m.shape[1] == k]
        for i, book in zip(rows, prepare_neighbor_maps([flat[i]
                                                        for i in rows])):
            books[i] = book
    books = iter(books)
    return [(next(books), valid, None if nbr_s is None else next(books),
             valid_s) for _, valid, nbr_s, valid_s in maps]


def _run_stages(cfg, layers, x, maps, train=False):
    """The sparse layers on :func:`_batch_stage_maps`' maps, taken from
    ``layers`` by the JAX module's names ``subm{s}_{i}`` / ``down{s}``."""
    for s, (nbr, valid, nbr_s, valid_s) in enumerate(maps):
        for i in range(cfg.subm_per_stage):
            x = layers[f"subm{s}_{i}"](x, nbr, valid, train)
        if nbr_s is not None:
            x = layers[f"down{s}"](x, nbr_s, valid_s, train)
    return x


def sparse_stage_loop(cfg, layers, x, coords, valid, train=False,
                      layout=None):
    """The sparse-backbone stage loop (SECOND, later VoxelNeXt): submanifold
    convs on the active set, a strided downsample between stages. The B
    frames run as one joined site list (:func:`_batch_stage_maps`): one K5
    launch a layer for the batch. The maps run in the span
    ``second.maps``, the layers in ``second.middle``.

    :param x: (B, V, C) site features; ``coords`` (B, V, 3) int32;
        ``valid`` (B, V)
    :param train: BatchNorm with batch statistics (see :class:`_MaskedBN`)
    :param layout: a :class:`SECONDLayout`, whose last stage is followed
        by its ``out_*`` layer (``layers["down{n_stages - 1}"]``)
    :returns: (features (B, R, C'), coords (B, R, 3), valid (B, R),
        final_grid) of the final stage's R sites a frame
    """
    b, v = valid.shape
    with span("second.maps"):
        maps, (oc, ov, grid) = _batch_stage_maps(cfg, coords, valid, layout)
    with span("second.middle"):
        y = _run_stages(cfg, layers, x.reshape(b * v, -1), maps, train)
    return y.reshape(b, -1, y.shape[-1]), oc, ov, grid


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
    :param constrain: optional activation hook ``(x, kind) -> x`` called
        on the dense BEV map (NCHW) with kind "bev"; with
        :func:`~d3d_tpu_torch.parallel.mesh.spatial_constrain`'s only the
        BEV head runs on this rank's slab of rows, as in the JAX module
        (the sparse middle is site-parallel and stays whole)
    :param layout: a :class:`SECONDLayout` to run OpenPCDet's structure
        on the sparse middle (its last strided layer is
        ``middle.down{n_stages - 1}``, its BEV network ``blocks`` and
        ``ups``); None runs the JAX module's
    """

    def __init__(self, cfg: SECONDConfig, point_features=4, device=None,
                 generator=None, constrain=None, layout=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.constrain = constrain
        self.layout = layout
        dense = cfg.middle_mode() == "dense"
        if layout is not None and (
                dense or len(layout.down_padding) + 1 != cfg.n_stages):
            raise ValueError(
                "a SECONDLayout runs on the sparse middle, with a padding "
                f"for each of the {cfg.n_stages - 1} strided layers between "
                f"stages; got middle={cfg.middle!r} and "
                f"{len(layout.down_padding)} paddings")
        layers = {}
        c_in = point_features
        for s, ch in enumerate(cfg.stage_channels):
            for i in range(cfg.subm_per_stage):
                layers[f"subm{s}_{i}"] = (
                    _SpConvDense(c_in, ch, cfg.dtype) if dense
                    else _SpConv(c_in, ch, cfg.dtype, symmetric=True))
                c_in = ch
            if s + 1 < cfg.n_stages:
                c_out = cfg.stage_channels[s + 1]
                layers[f"down{s}"] = (
                    _SpConvDense(c_in, c_out, cfg.dtype, stride=2) if dense
                    else _SpConv(c_in, c_out, cfg.dtype))
                c_in = c_out
        if layout is not None:
            layers[f"down{cfg.n_stages - 1}"] = _SpConv(
                c_in, layout.out_channels, cfg.dtype,
                k=int(np.prod(layout.out_kernel)))
        self.middle = nn.ModuleDict(layers)
        if layout is None:
            self.head_block = _ConvBlock(cfg.final_grid[2] * c_in,
                                         cfg.head_channels, 2, 1, cfg.dtype)
            feat = cfg.head_channels
        else:
            nz = layout.grids(cfg)[-1][2]
            self.blocks, self.ups = _bev_layers(
                nz * layout.out_channels, layout.bev_channels,
                layout.bev_convs, layout.bev_up_channels, cfg.dtype,
                in_slices=nz)
            feat = sum(layout.bev_up_channels)
        a = len(cfg.anchor_sizes) * len(cfg.anchor_rotations)
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
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, _SpConv)):
                w = mod.weight
                fan_in = (w[0].numel() if isinstance(mod, nn.Conv2d) else
                          w.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                          else w.shape[0] * w.shape[1])
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

    def forward(self, features, coords, valid, train=False):
        """:param features: (B, V, 4) voxel means
        :param coords: (B, V, 3) int32
        :param valid: (B, V) bool
        :param train: BatchNorm with batch statistics, updating the running
            ones (the flag, not ``nn.Module.training``, selects this, as
            the JAX module's ``train`` argument does)
        """
        if self.cfg.middle_mode() == "dense":
            dense, _ = dense_stage_loop(self.cfg, self.middle, features,
                                        coords, valid, train)
            return self.bev_head(dense, train)
        x, oc, ov, fg = sparse_stage_loop(self.cfg, self.middle, features,
                                          coords, valid, train, self.layout)
        with span("second.bev"):
            dense = [sparse_to_dense(xi, ci, vi, fg)  # (X, Y, Z, C) a frame
                     for xi, ci, vi in zip(x, oc, ov)]
            return self.bev_head(torch.stack(dense), train)

    def bev_head(self, dense, train=False):
        """(B, X, Y, Z, C) final-stage canvas -> the three head outputs."""
        cfg = self.cfg
        b, nx, ny = dense.shape[:3]
        dt = getattr(torch, cfg.dtype)
        # fold z into channels z-major, as the JAX module's reshape does,
        # then NCHW with x along the first spatial axis
        con, sp = _bev_hooks(self.constrain)
        x = con(dense.reshape(b, nx, ny, -1).permute(0, 3, 1, 2), "bev")
        bev = (self.head_block(x, train, sp) if self.layout is None
               else _bev_backbone(self.blocks, self.ups, x, train, sp, dt))
        return (_head(bev, self.head_cls, cfg.num_classes, dt, sp),
                _head(bev, self.head_box, 7, dt, sp),
                _head(bev, self.head_dir, 2, dt, sp))


def make_train_step(model, optimizer, cfg: SECONDConfig, anchors,
                    riou_weight=0.0, remat=False, external_targets=False):
    """:func:`d3d_tpu_torch.models.pointpillars.make_train_step` with the
    head config (:func:`head_config`) carrying the anchor and loss
    settings; ``batch`` carries features/coords/valid from
    :func:`second_voxelize` (stacked) plus padded
    gt_boxes/gt_labels/gt_mask."""
    return _pp_make_train_step(model, optimizer, head_config(cfg), anchors,
                               riou_weight=riou_weight, remat=remat,
                               external_targets=external_targets)

"""SST, the single-stride sparse window transformer (port of
``d3d_tpu.models.sst``, the fifth model family).

Pillar tokens are grouped into BEV windows of ``window`` x ``window``
cells, each window holding ``capacity`` token slots, and run through
windowed multi-head attention; the tilings alternate by half a window
(Swin-style) from block to block. Detection stays at the full grid
resolution. The config extends :class:`PointPillarsConfig` and the module
keeps PointPillars' input and output contract, so ``make_train_step``,
``prepare_targets`` and the anchor detector factory serve it unchanged.

The routing is exact integer work: a stable sort by window id and
``cummax`` segment starts give each pillar its rank in its window
(:func:`window_slots`), an int32 scatter the inverse slot table, and
tokens and detokens are gathers, their backward gathers too
(:func:`route_tokens`, :func:`detok_tokens`). Every window has all its slots, real or empty, as
in the JAX design: at ``presets.sst_kitti`` about 94% of the attention
and MLP work is on empty slots (:func:`empty_slot_share` measures it).

Numerics follow the flax modules: LayerNorm with epsilon 1e-6 and flax's
fast variance in at least float32 (:func:`_layer_norm`); Dense layers add
their bias after the product in the compute dtype; the attention logits
are divided by ``np.sqrt(head_dim)``, a float64 NumPy scalar that the JAX
package (which turns on x64) promotes the logits to, so the port divides
in float64 too, by a 0-d tensor on the logits' device (a division by a
Python scalar on CUDA is a multiply by its reciprocal); masked keys take
-1e9 and the softmax runs in float32; gelu is the tanh form
(:func:`~d3d_tpu_torch.parallel.moe.gelu_tanh`). No
``scaled_dot_product_attention``: an empty window has every key masked,
which the -1e9 fill turns into uniform weights and a boolean mask into
NaN.

``moe_experts > 0`` swaps each block's dense MLP for a Switch-MoE
(:func:`~d3d_tpu_torch.parallel.moe.moe_mlp`) on the compact pillar rows
after detokenization; the blocks' load-balance losses are kept in
``SST.sown_losses`` after every forward, and ``make_train_step`` adds
them to the loss.

:func:`pipeline_sst_trunk` runs the trunk's blocks as GPipe stages over
a pipeline mesh axis (:func:`~d3d_tpu_torch.parallel.pipeline_apply`).

Reference: Fan et al., "Embracing Single Stride 3D Object Detector with
Sparse Transformer", CVPR 2022 (arXiv:2112.06375); window shifting from
Liu et al., Swin Transformer (ICCV 2021).
"""

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.gather import table_gather
from ..parallel.moe import gelu_tanh, moe_mlp
from ..utils import resolve_device
from .pointpillars import (PointPillarsConfig, _ConvBlock, _PFN, _bev_hooks,
                           _head, scatter_to_bev)

__all__ = ["SSTConfig", "SST", "window_slots", "route_tokens",
           "detok_tokens", "empty_slot_share", "pipeline_sst_trunk"]

_LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon


@dataclass(frozen=True)
class SSTConfig(PointPillarsConfig):
    """PointPillars-compatible static config + transformer knobs (the JAX
    module's fields and defaults). ``remat_blocks`` checkpoints each
    window block (``torch.utils.checkpoint``): the backward recomputes it."""

    window: int = 8           # window edge, in BEV cells
    capacity: int = 64        # token slots per window
    depth: int = 4            # transformer blocks (alternating shift)
    num_heads: int = 4
    mlp_ratio: int = 2
    neck_channels: int = 128  # post-transformer BEV conv neck
    moe_experts: int = 0      # >0: Switch-MoE MLP with this many experts
    moe_capacity: float = 1.25
    moe_group: int = 4096     # tokens per routing group
    moe_aux_weight: float = 0.01  # load-balance loss weight (train step)
    remat_blocks: bool = False


def _tiling(grid, window, shift):
    """(offset, windows along x, windows along y) of one tiling; the
    shifted one is laid over the grid padded by one window."""
    off = window // 2 if shift else 0
    return (off, (grid[0] + off + window - 1) // window,
            (grid[1] + off + window - 1) // window)


def window_slots(coords, valid, grid, window, capacity, shift=False):
    """Token-slot assignment of pillars to BEV windows.

    :param coords: (..., P, 2) integer pillar cells; ``valid`` (..., P)
    :param grid: (W, H); ``window`` the window edge in cells
    :param shift: offset the windows by window // 2 (Swin alternation)
    :returns: (slot (..., P) int32 in [0, n_windows * capacity), or the
        trash slot n_windows * capacity for an invalid or overflowing
        pillar; inv (..., n_windows * capacity) int32, the pillar row of
        each slot, P where empty). A window's pillars take its slots in
        row order."""
    p = coords.shape[-2]
    dev = coords.device
    off, nwx, nwy = _tiling(grid, window, shift)
    n_windows = nwx * nwy
    ix = coords[..., 0].to(torch.int64) + off
    iy = coords[..., 1].to(torch.int64) + off
    wid = torch.div(ix, window, rounding_mode="floor") * nwy \
        + torch.div(iy, window, rounding_mode="floor")
    wid_key = torch.where(valid, wid, n_windows)

    # stable sort by window id; in-window rank = index - segment start
    sw, order = torch.sort(wid_key, dim=-1, stable=True)
    ar = torch.arange(p, device=dev).expand_as(sw)
    first = torch.ones_like(sw, dtype=torch.bool)
    first[..., 1:] = sw[..., 1:] != sw[..., :-1]
    start = torch.cummax(torch.where(first, ar, 0), dim=-1).values
    rank = torch.empty_like(order).scatter_(-1, order, ar - start)

    keep = valid & (rank < capacity)
    trash = n_windows * capacity
    slot = torch.where(keep, wid * capacity + rank, trash)
    inv = torch.full(slot.shape[:-1] + (trash + 1,), p, dtype=torch.int64,
                     device=dev)
    inv.scatter_(-1, slot, ar)  # only the trash slot takes several rows
    return slot.to(torch.int32), inv[..., :-1].to(torch.int32)


def route_tokens(pf, inv, capacity):
    """Tokenize pillars into window slots: rows of ``pf`` (B, P, C) by the
    ``inv`` slot table (B, L), L a multiple of ``capacity`` (P = empty).
    Returns (tok (B, L / capacity, capacity, C), tmask). A gather both
    ways (:func:`~d3d_tpu_torch.ops.gather.table_gather`)."""
    b, p, c = pf.shape
    nw = inv.shape[1] // capacity
    tok = table_gather(pf, inv)
    return (tok.reshape(b, nw, capacity, c),
            (inv < p).reshape(b, nw, capacity))


def detok_tokens(pf, tok, slot, nwcap):
    """Window tokens back to pillar rows via the ``slot`` table; pillars
    with ``slot >= nwcap`` (overflow, trash) keep their residual ``pf``.
    A gather both ways (:func:`~d3d_tpu_torch.ops.gather.table_gather`)."""
    b, p, c = pf.shape
    upd = table_gather(tok.reshape(b, -1, c), slot)
    return torch.where((slot < nwcap)[..., None], upd, pf)


def empty_slot_share(cfg, coords, valid):
    """The share of window slots that hold no pillar, over the ``depth``
    blocks' tilings of a batch: the part of the attention and MLP work
    spent on empty slots."""
    slots = filled = 0
    for d in range(cfg.depth):
        _, inv = window_slots(coords, valid, cfg.grid, cfg.window,
                              cfg.capacity, bool(d % 2))
        slots += inv.numel()
        filled += int((inv < coords.shape[-2]).sum())
    return 1.0 - filled / slots


def _layer_norm(x, ln, dt):
    """flax ``nn.LayerNorm(dtype=dt)``: mean and fast variance
    (``E[x^2] - E[x]^2`` clamped at 0) of the last axis in at least
    float32, epsilon 1e-6, scale and bias in that precision, out in
    ``dt``."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp_min((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, 0.0)
    mul = torch.rsqrt(var + _LN_EPS) * ln.weight
    return ((xf - mu) * mul + ln.bias).to(dt)


def _dense(x, lin, dt):
    """flax ``nn.Dense(dtype=dt)``: the product in ``dt``, then the bias."""
    return F.linear(x.to(dt), lin.weight.to(dt)) + lin.bias.to(dt)


class _WindowBlock(nn.Module):
    """Pre-norm windowed MHSA + MLP on (B, Nw, K, C) token grids; with
    ``moe_experts`` the MLP is a Switch-MoE run on the pillar rows after
    detokenization (the caller passes the pillars and gets them back)."""

    def __init__(self, channels, num_heads, mlp_ratio, dtype, moe_experts=0,
                 moe_capacity=1.25, moe_group=4096, moe_constrain=None):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.num_heads = num_heads
        self.moe_experts = moe_experts
        self.moe_capacity = moe_capacity
        self.moe_group = moe_group
        self.moe_constrain = moe_constrain
        c, h = channels, mlp_ratio * channels
        self.norm1 = nn.LayerNorm(c)
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)
        self.norm2 = nn.LayerNorm(c)
        if moe_experts:
            e = moe_experts
            self.moe_router = nn.Parameter(torch.empty(c, e))
            self.moe_w1 = nn.Parameter(torch.empty(e, c, h))
            self.moe_b1 = nn.Parameter(torch.zeros(e, h))
            self.moe_w2 = nn.Parameter(torch.empty(e, h, c))
            self.moe_b2 = nn.Parameter(torch.zeros(e, c))
        else:
            self.mlp1 = nn.Linear(c, h)
            self.mlp2 = nn.Linear(h, c)

    def forward(self, tok, tmask, pf=None, valid=None, slot=None,
                nwcap=None):
        """Dense: the updated tokens. MoE (``pf``, ``valid``, ``slot``,
        ``nwcap`` given): (the updated pillar rows, the load-balance
        loss)."""
        dt = self.dtype
        b, nw, k, c = tok.shape
        heads, hd = self.num_heads, c // self.num_heads
        q, kk, v = (t.reshape(b, nw, k, heads, hd).transpose(2, 3)
                    for t in _dense(_layer_norm(tok, self.norm1, dt),
                                    self.qkv, dt).split(c, dim=-1))
        # (B, Nw, heads, K, K) window-local attention
        logits = torch.matmul(q, kk.transpose(-1, -2)).to(
            torch.promote_types(dt, torch.float64))
        logits = logits / torch.full((), math.sqrt(hd), dtype=logits.dtype,
                                     device=logits.device)
        logits = torch.where(tmask[:, :, None, None, :], logits, -1e9)
        attn = torch.softmax(
            logits.to(torch.promote_types(dt, torch.float32)), dim=-1)
        out = torch.matmul(attn.to(dt), v).transpose(2, 3).reshape(
            b, nw, k, c)
        tok = tok + _dense(out, self.proj, dt)

        if self.moe_experts:
            pf = detok_tokens(pf, tok, slot, nwcap)
            params = {"router": self.moe_router,
                      **{n: getattr(self, f"moe_{n}").to(dt)
                         for n in ("w1", "b1", "w2", "b2")}}
            y, aux = moe_mlp(params, _layer_norm(pf, self.norm2, dt),
                             self.moe_capacity, mask=valid,
                             constrain=self.moe_constrain,
                             group_size=self.moe_group)
            return pf + y, aux   # y is already zero on invalid rows
        y = _dense(_layer_norm(tok, self.norm2, dt), self.mlp1, dt)
        return tok + _dense(gelu_tanh(y), self.mlp2, dt)


class SST(nn.Module):
    """PFN -> windowed transformer (alternating shift) -> single-stride
    BEV neck -> SSD head. Input and output as
    :class:`~d3d_tpu_torch.models.pointpillars.PointPillars`.

    :param stage: "full"; "embed" returns the pillar features after the
        PFN and the positional embedding, "trunk" after the transformer
        blocks (before the validity mask)
    :param constrain: optional activation hook ``(x, kind) -> x`` called
        on the BEV canvas (NCHW) with kind "bev";
        :func:`~d3d_tpu_torch.parallel.mesh.spatial_constrain`'s runs the
        neck and heads on this rank's slab of rows
    :param moe_constrain: the MoE blocks' expert hook
        (:func:`~d3d_tpu_torch.parallel.mesh.expert_constrain`: the
        experts split over the mesh's ``ep`` axis)
    :param device: where the parameters live (default CUDA; raises when
        CUDA is missing and no device is given)
    :param generator: ``torch.Generator`` for the random initial weights
        (default: a generator seeded with 0)

    After each forward, ``sown_losses`` holds the MoE blocks' load-balance
    losses (empty without MoE), the JAX module's sown ``losses``.
    """

    def __init__(self, cfg: SSTConfig, constrain=None, moe_constrain=None,
                 stage="full", point_features=4, device=None, generator=None):
        super().__init__()
        if stage not in ("full", "embed", "trunk"):
            raise ValueError(f"unknown stage {stage!r}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.stage = stage
        self.constrain = constrain
        c = cfg.pfn_features
        self.pfn = _PFN(point_features + 5, c, cfg.dtype)
        self.pos_embed = nn.Linear(2, c)
        self.blocks = nn.ModuleList(
            _WindowBlock(c, cfg.num_heads, cfg.mlp_ratio, cfg.dtype,
                         cfg.moe_experts, cfg.moe_capacity, cfg.moe_group,
                         moe_constrain)
            for _ in range(cfg.depth))
        self.neck = _ConvBlock(c, cfg.neck_channels, 2, 1, cfg.dtype)
        a = cfg.num_anchors_per_cell
        self.head_cls = nn.Conv2d(cfg.neck_channels, a * cfg.num_classes, 1)
        self.head_box = nn.Conv2d(cfg.neck_channels, a * 7, 1)
        self.head_dir = nn.Conv2d(cfg.neck_channels, a * 2, 1)
        self.sown_losses = []
        self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Seeded random weights: LeCun-normal Dense and MoE kernels and
        heads, He-normal neck convolutions, zero biases, unit LayerNorm
        scales, identity BatchNorm statistics."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        heads = (self.head_cls, self.head_box, self.head_dir)

        def normal(t, fan_in, gain=1.0):
            t.copy_(torch.randn(t.shape, generator=generator)
                    * math.sqrt(gain / fan_in))

        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d)):
                conv = isinstance(mod, nn.Conv2d) and mod not in heads
                normal(mod.weight, mod.weight[0].numel(), 2.0 if conv
                       else 1.0)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm,
                                  nn.modules.batchnorm._BatchNorm)):
                mod.reset_parameters()
            elif isinstance(mod, _WindowBlock) and mod.moe_experts:
                normal(mod.moe_router, mod.moe_router.shape[0])
                normal(mod.moe_w1, mod.moe_w1.shape[1])
                normal(mod.moe_w2, mod.moe_w2.shape[1])
                mod.moe_b1.zero_()
                mod.moe_b2.zero_()

    def forward(self, features, coords, valid, train=False):
        """Head outputs ``(cls (B, N, C), box (B, N, 7), dir (B, N, 2))``,
        float32 (float64 for a float64 model), or the pillar features of
        ``stage``. ``train=True`` normalises by batch statistics and moves
        the BatchNorm running statistics."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        self.sown_losses = []

        pmask = (features != 0).any(dim=-1)
        pf = self.pfn(features, pmask, train)
        pf = pf * valid[..., None].to(pf.dtype)             # (B, P, C)

        # learned positional embedding of the in-window cell offset
        cell = torch.remainder(coords, cfg.window).to(dt) / torch.full(
            (), cfg.window, dtype=dt, device=coords.device)
        pf = pf + _dense(cell, self.pos_embed, dt)
        if self.stage == "embed":
            return pf

        tilings = {}  # two distinct tilings: one per shift parity
        for d, blk in enumerate(self.blocks):
            shift = bool(d % 2)
            if shift not in tilings:
                tilings[shift] = window_slots(coords, valid, cfg.grid,
                                              cfg.window, cfg.capacity,
                                              shift)
            slot, inv = tilings[shift]
            tok, tmask = route_tokens(pf, inv, cfg.capacity)
            args = (tok, tmask)
            if cfg.moe_experts:
                args += (pf, valid, slot, inv.shape[1])
            out = (checkpoint(blk, *args, use_reentrant=False)
                   if cfg.remat_blocks else blk(*args))
            if cfg.moe_experts:
                pf, aux = out
                self.sown_losses.append(aux)
            else:
                # overflow pillars keep their residual-path features
                pf = detok_tokens(pf, out, slot, inv.shape[1])
        if self.stage == "trunk":
            return pf
        pf = pf * valid[..., None].to(pf.dtype)

        # single-stride BEV neck + SSD head (full-resolution detection)
        con, sp = _bev_hooks(self.constrain)
        x = con(scatter_to_bev(pf, coords, valid, cfg.grid).permute(
            0, 3, 1, 2), "bev")
        x = self.neck(x, train, sp)
        return (_head(x, self.head_cls, cfg.num_classes, dt, sp),
                _head(x, self.head_box, 7, dt, sp),
                _head(x, self.head_dir, 2, dt, sp))


def pipeline_sst_trunk(model, cfg: SSTConfig, mesh, pf_mb, coords_mb,
                       valid_mb, batch_axis=None, axis="pp"):
    """Run ``model``'s windowed-transformer trunk pipelined over the mesh's
    pipeline axis: the ``cfg.depth`` blocks are GPipe stages, a contiguous
    run of them a rank (:func:`~d3d_tpu_torch.parallel.pipeline_apply`).

    A stage's state is its block's parameters and its routing tables for
    every microbatch: the ``slot`` and ``inv`` tables of its tiling (the
    two alternating tilings, the ``inv`` tables padded with empty slots to
    the larger one so every stage has one shape) and the ``nwcap`` that
    masks the padding in :func:`detok_tokens`; an MoE trunk carries the
    validity mask too.

    :param model: an :class:`SST` (its ``blocks`` give the weights)
    :param pf_mb: (M, mb, P, C) ``SST(cfg, stage="embed")`` outputs,
        microbatched (:func:`~d3d_tpu_torch.parallel.microbatch`)
    :param coords_mb: / ``valid_mb``: (M, mb, P, 2) / (M, mb, P)
    :param batch_axis: optional mesh axis splitting ``mb`` (dp x pp)
    :returns: (M, mb, P, C), ``SST(cfg, stage="trunk")``'s output on the
        same inputs, on every rank
    """
    from torch.func import functional_call

    from ..parallel.pipeline import pipeline_apply

    depth = cfg.depth
    par = []
    for shift in (False, True)[:min(depth, 2)]:
        sl, iv = window_slots(coords_mb, valid_mb, cfg.grid, cfg.window,
                              cfg.capacity, shift)
        par.append((sl, iv, iv.shape[-1]))
    length = max(p[2] for p in par)
    p = pf_mb.shape[-2]

    def pad(iv):
        return torch.cat([iv, iv.new_full(iv.shape[:-1] + (
            length - iv.shape[-1],), p)], dim=-1)

    names = [n for n, _ in model.blocks[0].named_parameters()]
    state = dict(
        params={n: torch.stack([dict(blk.named_parameters())[n]
                                for blk in model.blocks]) for n in names},
        slot=torch.stack([par[d % 2][0] for d in range(depth)]),
        inv=torch.stack([pad(par[d % 2][1]) for d in range(depth)]),
        nwcap=torch.tensor([par[d % 2][2] for d in range(depth)],
                           device=pf_mb.device))
    specs = dict(params={n: (axis,) for n in names},
                 slot=(axis, None, batch_axis), inv=(axis, None, batch_axis),
                 nwcap=(axis,))
    if cfg.moe_experts:
        state["valid"] = torch.stack([valid_mb] * depth)
        specs["valid"] = (axis, None, batch_axis)
    block = model.blocks[0]

    def stage(st, pf, mb):
        tok, tmask = route_tokens(pf, st["inv"][mb], cfg.capacity)
        if cfg.moe_experts:
            out, _ = functional_call(block, st["params"], (
                tok, tmask, pf, st["valid"][mb], st["slot"][mb],
                st["nwcap"]))
            return out
        tok = functional_call(block, st["params"], (tok, tmask))
        return detok_tokens(pf, tok, st["slot"][mb], st["nwcap"])

    return pipeline_apply(stage, state, pf_mb, mesh, axis=axis,
                          batch_axis=batch_axis, state_specs=specs)

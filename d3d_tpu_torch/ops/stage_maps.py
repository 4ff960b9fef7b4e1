"""Every neighbour map of a sparse middle's stages, for a batch of frames
at once: the kernel chain M1 (``csrc/stage_maps.cu``) on CUDA, today's
torch ops a frame (:mod:`d3d_tpu_torch.ops.sparse_conv`) as its plain
version on the CPU.

A middle is planned as stages (:func:`build_stage_maps`): each stage's
sites get the submanifold map of the centred 3x3x3 kernel, and a
:class:`Down` after a stage makes the next stage's sites (the first
``cap`` output cells in key order) and the strided map that reads them.
The frames' maps come joined into ONE site list: frame b's rows of a stage
with R rows a frame are rows ``b*R ... b*R + R - 1``, and its neighbour
indices move by ``b`` times the rows of the stage they point into (-1
stays).

On CUDA the build is the ``torch.library`` custom op
``d3d_tpu_torch::build_stage_maps`` (the CUDA kernel: M1, one call of its
C entry, counted in ``build_stage_maps.launches``; the CPU kernel: the
plain version; a fake implementation for tracing), so a traced CUDA
detector keeps it as a node. M1 looks stage 0's sites up in a hash table,
so it has no dense canvas and no sort join at any extent; a strided layer's
outputs are ranked in a bitmap instead of sorted. Nothing waits for the
device. The CPU's plain route runs outside the op, so the CPU stage loops
hold only torch's own ops. Maps, output coords and valid are the same bit
for bit on both routes (coords of padding rows are arbitrary).
"""

import ctypes
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ._build import load_library, stream_handle
from .sparse_conv import (_axes, build_neighbor_map,
                          build_neighbor_map_strided, conv_out_grid,
                          downsample_coords)

__all__ = ["Down", "build_stage_maps", "frame_stage_maps"]

# M1's plan: ints a stage (csrc/stage_maps.cu struct Stage), its scratch's
# bitmap words a block and least hash slots a frame
_PLAN_INTS = 18
_BLOCK_WORDS = 2048
_MIN_HASH_SLOTS = 1024
_SUBM_OFFSETS = 27

# builds by route (every call of build_stage_maps): M1, or the plain version
_ROUTES = {"kernel": 0, "plain": 0}


@dataclass(frozen=True)
class Down:
    """The strided layer after a stage, and its site cap.

    Without ``kernel`` the JAX module's rule: the outputs are the unique
    ``coords // stride`` on the ceil-divided extent, and each reads the
    centred 3x3x3 window at ``stride`` times its coords. With it spconv's
    (``kernel``, ``stride`` and ``padding`` each an int or one an axis;
    :func:`~d3d_tpu_torch.ops.sparse_conv.downsample_coords`). ``cap``:
    the output sites a frame, the first in key order (None or 0: as many as
    the stage's sites)."""

    stride: object = 2
    cap: int = None
    kernel: object = None
    padding: object = 0

    def out_grid(self, grid):
        if self.kernel is None:
            return tuple(-(-g // self.stride) for g in grid)
        return conv_out_grid(grid, self.kernel, self.stride, self.padding)


def _frame_stages(coords, valid, grid, downs):
    """:func:`frame_stage_maps` with each strided layer's output coords:
    per stage ``(nbr, valid, nbr_down, coords_down, valid_down)``."""
    stages = []
    for down in downs:
        nbr = build_neighbor_map(coords, valid, grid)
        if down is None:
            stages.append((nbr, valid, None, None, None))
            break
        oc, ov = downsample_coords(coords, valid, grid, down.stride,
                                   down.cap, kernel=down.kernel,
                                   padding=down.padding)
        if down.kernel is None:
            nbr_s = build_neighbor_map_strided(oc, ov, coords, valid, grid,
                                               down.stride)
        else:
            nbr_s = build_neighbor_map_strided(oc, ov, coords, valid, grid,
                                               down.stride, down.kernel,
                                               padding=down.padding)
        stages.append((nbr, valid, nbr_s, oc, ov))
        coords, valid, grid = oc, ov, down.out_grid(grid)
    return stages, (coords, valid, grid)


def frame_stage_maps(coords, valid, grid, downs):
    """The maps of one frame's stages (the plain version's torch ops): per
    stage ``(nbr, valid, nbr_down, valid_down)``, its submanifold map and,
    where ``downs`` has a :class:`Down` for it, the strided map to the next
    stage's sites with their mask (None where it has None, which ends the
    stages) -- and the final sites' (coords, valid, grid).

    :param coords: (R, 3) int sites on ``grid``; ``valid`` (R,) bool
    :param downs: one entry a stage, a :class:`Down` or None (last only)
    """
    stages, final = _frame_stages(coords, valid, grid, downs)
    return [(n, v, ns, ov) for n, v, ns, _, ov in stages], final


def _offset(nbr, base):
    """A frame's neighbour map moved to its rows in the batch's list."""
    return torch.where(nbr >= 0, nbr + base, nbr)


def _build_stage_maps_plain(coords, valid, grid, downs):
    """The plain version of :func:`build_stage_maps`: the torch ops of
    :func:`frame_stage_maps` a frame, each map moved to its frame's rows
    and the frames joined. Returns per stage ``(nbr, valid, nbr_down,
    coords_down (B, R', 3), valid_down)`` and the final sites."""
    frames = [_frame_stages(c, v, grid, downs)
              for c, v in zip(coords, valid)]
    stages = []
    for s in range(len(frames[0][0])):
        per = [f[0][s] for f in frames]
        rows = per[0][0].shape[0]
        nbr = torch.cat([_offset(p[0], b * rows) for b, p in enumerate(per)])
        valid_s = torch.cat([p[1] for p in per])
        if per[0][2] is None:
            stages.append((nbr, valid_s, None, None, None))
        else:
            stages.append((nbr, valid_s,
                           torch.cat([_offset(p[2], b * rows)
                                      for b, p in enumerate(per)]),
                           torch.stack([p[3] for p in per]),
                           torch.cat([p[4] for p in per])))
    final_coords = torch.stack([f[1][0] for f in frames])
    final_valid = torch.stack([f[1][1] for f in frames])
    return stages, (final_coords, final_valid, frames[0][1][2])


def _plan(rows, grid, downs):
    """M1's flat plan: ``_PLAN_INTS`` ints a stage (csrc/stage_maps.cu
    ``Stage``): its sites a frame and extent, the strided layer's rule
    (0: none, 1: ``coords // stride``, 2: spconv's window), the strided
    map's kernel, stride and padding, the output sites a frame (the cap,
    at most the candidates) and the output extent."""
    plan = []
    for down in downs:
        if down is None:
            plan += [rows, *grid] + [0] * (_PLAN_INTS - 4)
            break
        og = down.out_grid(grid)
        stride = _axes(down.stride)
        if down.kernel is None:
            kind, kernel, pad, taps = 1, (3, 3, 3), (1, 1, 1), 1
        else:
            kind, kernel, pad = 2, _axes(down.kernel), _axes(down.padding)
            taps = int(np.prod(kernel))
        out_rows = min(down.cap or rows, rows * taps)
        plan += [rows, *grid, kind, *kernel, *stride, *pad, out_rows, *og]
        rows, grid = out_rows, og
    return plan


def _stages(plan):
    return [plan[i:i + _PLAN_INTS] for i in range(0, len(plan), _PLAN_INTS)]


def _decode(plan):
    """(grid, downs) of a flat plan, for the plain version."""
    stages = _stages(plan)
    downs = []
    for st in stages:
        kind, kernel, stride, pad, out_rows = (st[4], tuple(st[5:8]),
                                               tuple(st[8:11]),
                                               tuple(st[11:14]), st[14])
        downs.append(None if kind == 0 else
                     Down(stride[0], out_rows) if kind == 1 else
                     Down(stride, out_rows, kernel, pad))
    return tuple(stages[0][1:4]), downs


def _outputs(like, batch, plan):
    """The op's outputs, empty: for each stage its submanifold map and,
    after a strided layer, its map, output coords and valid."""
    outs = []
    for st in _stages(plan):
        rows, kind, out_rows = st[0], st[4], st[14]
        outs.append(like.new_empty((batch * rows, _SUBM_OFFSETS),
                                   dtype=torch.int32))
        if kind:
            taps = int(np.prod(st[5:8]))
            outs += [like.new_empty((batch * out_rows, taps),
                                    dtype=torch.int32),
                     like.new_empty((batch, out_rows, 3), dtype=torch.int32),
                     like.new_empty((batch, out_rows), dtype=torch.bool)]
    return outs


def _scratch_ints(batch, plan):
    """M1's scratch in int32 words (csrc/stage_maps.cu ``scratch_ints``):
    a hash table a frame, then for each strided layer its bitmap and its
    words' ranks, a count a block and a frame."""
    stages = _stages(plan)
    slots = max(_MIN_HASH_SLOTS, 2 * stages[0][0])
    need = batch * 2 * (1 << (slots - 1).bit_length())
    round4 = lambda n: -(-n // 4) * 4  # noqa: E731
    for st in stages:
        if st[4]:
            words = -(-int(np.prod(st[15:18])) // 32)
            words = -(-words // _BLOCK_WORDS) * _BLOCK_WORDS
            need += (2 * batch * words + round4(batch * words // _BLOCK_WORDS)
                     + round4(batch))
    return need


def build_stage_maps(coords, valid, grid, downs):
    """The maps of every stage of a batch of frames, joined (see the module
    docstring): M1 on CUDA, the plain version on the CPU.

    :param coords: (B, R, 3) int sites on ``grid`` (padding rows
        arbitrary); ``valid`` (B, R) bool; valid coords inside ``grid``
        and unique (a duplicate keeps its last row)
    :param downs: one entry a stage: a :class:`Down`, or None for a last
        stage that no strided layer follows
    :returns: (maps, (coords (B, R', 3), valid (B, R'), grid) of the final
        sites): per stage ``(nbr (B*R, 27), valid (B*R,), nbr_down
        (B*R', T), valid_down (B*R',))``, the last two None where no
        strided layer follows
    """
    if coords.device.type != "cuda":
        _ROUTES["plain"] += 1
        stages, final = _build_stage_maps_plain(coords, valid, grid, downs)
        return [(n, v, ns, ov) for n, v, ns, _, ov in stages], final
    _ROUTES["kernel"] += 1
    plan = _plan(valid.shape[1], tuple(grid), downs)
    return _assemble(torch.ops.d3d_tpu_torch.build_stage_maps(
        coords, valid, plan), plan, coords, valid)


def _assemble(outs, plan, coords, valid):
    """:func:`build_stage_maps`' result from the op's outputs."""
    outs = iter(outs)
    maps, sites, grid = [], (coords, valid), tuple(_stages(plan)[0][1:4])
    for st in _stages(plan):
        nbr, stage_valid = next(outs), sites[1].reshape(-1)
        if not st[4]:
            maps.append((nbr, stage_valid, None, None))
            break
        nbr_s, oc, ov = next(outs), next(outs), next(outs)
        maps.append((nbr, stage_valid, nbr_s, ov.reshape(-1)))
        sites, grid = (oc, ov), tuple(st[15:18])
    return maps, (*sites, grid)


@torch.library.custom_op("d3d_tpu_torch::build_stage_maps",
                         mutates_args=(), device_types="cpu")
def _stage_maps_op(coords: torch.Tensor, valid: torch.Tensor,
                   plan: List[int]) -> List[torch.Tensor]:
    """The build as an op, its outputs in :func:`_outputs`' order: on the
    CPU the plain version, the same function that :func:`build_stage_maps`
    calls outside the op (so the op's CPU kernel serves ``opcheck`` and
    CPU calls of the op, and is no second route)."""
    stages, _ = _build_stage_maps_plain(coords, valid, *_decode(plan))
    outs = []
    for nbr, _, nbr_s, oc, ov in stages:
        outs.append(nbr)
        if nbr_s is not None:
            outs += [nbr_s, oc.to(torch.int32),
                     ov.reshape(valid.shape[0], -1)]
    return outs


@_stage_maps_op.register_fake
def _stage_maps_fake(coords, valid, plan):
    return _outputs(coords, valid.shape[0], plan)


@_stage_maps_op.register_kernel("cuda")
def _stage_maps_cuda(coords, valid, plan):
    # M1 reads (B, R, 3) int32 coords and (B, R) bool valid, row-major (the
    # voxelizer's coords are a transposed view: one copy)
    coords = coords.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    batch = valid.shape[0]
    outs = _outputs(coords, batch, plan)
    if batch and valid.shape[1]:
        ints = _scratch_ints(batch, plan)
        scratch = torch.empty(ints, dtype=torch.int32, device=coords.device)
        err = load_library("stage_maps").d3d_stage_maps(
            coords.data_ptr(), valid.data_ptr(), batch,
            (ctypes.c_int * len(plan))(*plan), len(plan) // _PLAN_INTS,
            (ctypes.c_void_p * len(outs))(*(t.data_ptr() for t in outs)),
            scratch.data_ptr(), ints, stream_handle(coords.device))
        if err:
            raise RuntimeError(f"stage-map kernel launch failed: CUDA error "
                               f"{err}")
        build_stage_maps.launches += 1
    return outs


build_stage_maps.launches = 0

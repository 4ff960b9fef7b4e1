"""Point-cloud voxelization as sort + segment bookkeeping (port of
``d3d_tpu.ops.voxel``).

Linearize each point's voxel coordinate into an int32 key, stable-sort the
points by key, detect segment boundaries, and read every per-voxel value at
the run boundaries. All outputs are fixed-shape tensors padded to the voxel
capacity, with the count as a 0-d tensor, so nothing waits for the device.

Ported so far: the cell-key ("sorted") voxel order of
:func:`voxelize_dense_padded` with reductions ``none`` and ``mean``, and
:func:`voxelize_mean_fm`. The reference's first-encounter order
(``order_mode="encounter"``), ``max``/``min``, ``voxelize_mean_fm_exact``,
the sparse and filter cores and ``VoxelGenerator`` raise
``NotImplementedError`` or are absent until they are ported.
"""

import math

import torch

from ..utils import EDict, as_tensor

__all__ = ["voxelize_dense_padded", "voxelize_mean_fm"]

_INT32_MAX = 2 ** 31 - 1


def _to_int32(x):
    """Float -> int32 as XLA's convert does it: NaN becomes 0 (a CUDA cast
    gives 0 too, torch on an x86 CPU INT_MIN). Callers clamp to int32's
    range first."""
    return torch.nan_to_num(x, nan=0.0, posinf=math.inf,
                            neginf=-math.inf).to(torch.int32)


def _sequential_cumsum(x, dim):
    """Inclusive prefix sum along ``dim``, added strictly left to right."""
    cols = [x.select(dim, 0)]
    for i in range(1, x.shape[dim]):
        cols.append(cols[-1] + x.select(dim, i))
    return torch.stack(cols, dim)


def _cumsum_f32(x):
    """Inclusive prefix sum along dim 0, added in the order XLA:CPU uses for
    ``jnp.cumsum``: sequential runs of 16 rows, whose run totals are
    prefix-summed the same way, recursively, and added back. Rounding then
    matches the JAX package's CPU path, and the port gives the same bits on
    the CPU and on the card (only elementwise f32 adds, no fused
    multiply-add). ``torch.cumsum`` rounds differently on each device."""
    n, run = x.shape[0], 16
    if n <= run:
        return _sequential_cumsum(x, 0)
    nb = -(-n // run)
    xp = torch.cat([x, x.new_zeros((nb * run - n,) + x.shape[1:])])
    local = _sequential_cumsum(xp.reshape((nb, run) + x.shape[1:]), 1)
    carry = _cumsum_f32(local[:, -1])
    excl = torch.cat([torch.zeros_like(carry[:1]), carry[:-1]])
    out = local + excl[:, None]
    return out.reshape((nb * run,) + x.shape[1:])[:n]


def _segment_structure(key, max_key=None, order_mode="encounter"):
    """Stable-sort points by voxel key and find the segments (cells).

    :param key: (N,) int cell key; invalid points carry ``max_key + 1``
    :param max_key: static upper bound on valid keys (< 2^31 - 2)
    :param order_mode: only "sorted" (voxel ids in cell-key order, so voxel
        v is segment v) is ported; "encounter" raises NotImplementedError
    :return: EDict with the sort ``order`` and ``valid_s`` in sorted order,
        and per-segment tensors of length N (segments beyond the voxel
        count are invalid). The JAX module also returns segment ids, slots
        and ranks for its other modes; eager PyTorch would compute them
        even where nothing reads them, so the port leaves them out until a
        mode needs them.
    """
    if order_mode != "sorted":
        raise NotImplementedError(
            f"order_mode={order_mode!r} is not ported yet (only 'sorted')")
    if max_key is None or max_key + 2 >= 1 << 31:
        raise NotImplementedError(
            "only the int32 dense key path (max_key < 2^31 - 2) is ported")
    n = key.shape[0]
    dev = key.device
    capped = torch.clamp(key, max=max_key + 1).to(torch.int32)
    k_s, order = torch.sort(capped, stable=True)
    valid_s = k_s <= max_key
    newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        k_s[1:] != k_s[:-1]])
    pos = torch.arange(n, dtype=torch.int32, device=dev)

    # per-segment start positions and keys by stream compaction: boundary
    # (key, position) pairs sort to the front in segment order. The JAX
    # module's two-key sort becomes one sort of an int64 composite key
    # (both parts are non-negative and below 2^31).
    composite = (torch.where(newseg, k_s, _INT32_MAX).to(torch.int64) << 32
                 | torch.where(newseg, pos, n).to(torch.int64))
    composite = torch.sort(composite).values
    seg_key_s = (composite >> 32).to(torch.int32)
    seg_start = (composite & 0xFFFFFFFF).to(torch.int32)
    # segments are contiguous in sorted order, so each count is the gap to
    # the next segment's start (empty segments carry start == n)
    next_start = torch.cat([seg_start[1:],
                            torch.full((1,), n, dtype=torch.int32,
                                       device=dev)])
    # invalid points carry the largest key, so they sort last: a segment is
    # valid iff it starts before the first invalid point
    seg_valid = (seg_start < n) & (seg_start < valid_s.sum())
    return EDict(
        order=order,
        valid_s=valid_s,
        npoints_seg=torch.where(seg_valid, next_start - seg_start, 0),
        seg_start=seg_start,
        seg_key_s=seg_key_s,
        seg_valid=seg_valid,
        nvoxels=seg_valid.sum().to(torch.int32),
    )


def voxelize_dense_padded(points, shape, bounds, max_points, max_voxels,
                          reduction, order_mode="encounter"):
    """Dense voxelization core (reference voxelize.cpp:46-199 semantics).

    :param points: (N, F) float tensor, xyz in the first 3 columns; a
        tensor stays on its device, anything else goes to CUDA
    :param shape: (3,) int grid shape
    :param bounds: (6,) [xmin,xmax,ymin,ymax,zmin,zmax]
    :param reduction: "none" or "mean" ("max"/"min" are not ported yet)
    :param order_mode: "sorted" = cell-key voxel order (the only one
        ported; the JAX default "encounter" raises NotImplementedError)
    :return: EDict of fixed-shape tensors padded to max_voxels + ``nvoxels``
    """
    shape = tuple(int(v) for v in shape)
    points = as_tensor(points)
    bounds = as_tensor(bounds, device=points.device)
    dev = points.device
    n, f = points.shape
    b = bounds.reshape(3, 2)
    sh = torch.tensor(shape, dtype=torch.int32, device=dev)
    vsize = (b[:, 1] - b[:, 0]) / sh
    scaled = (points[:, :3] - b[:, 0]) / vsize
    # C `int()` cast (trunc toward zero), voxelize.cpp:102; the clip only
    # guards the float->int conversion, clipped points fail the bounds check
    max_key = shape[0] * shape[1] * shape[2]
    if max_key + 2 >= 1 << 31:
        raise ValueError("voxel grid too large for int32 keys")
    idx = _to_int32(torch.trunc(torch.clamp(scaled, -2e9, 2e9)))
    inr = ((idx >= 0) & (idx < sh)).all(dim=1)
    key = (idx[:, 0] * shape[1] + idx[:, 1]) * shape[2] + idx[:, 2]
    key = torch.where(inr, key, max_key + 1)

    if reduction not in ("none", "mean", "max", "min"):
        raise ValueError("Unsupported reduction type in voxelization!")
    if reduction in ("max", "min"):
        raise NotImplementedError(
            f"reduction={reduction!r} is not ported yet")

    s = _segment_structure(key, max_key=max_key, order_mode=order_mode)
    feats_s = points[s.order]

    # voxel v is the contiguous run [seg_start[v], +npoints[v]) of feats_s
    sorted_fast = max_voxels < n
    if sorted_fast:
        keep_v = s.seg_valid[:max_voxels]
        start_v = torch.where(keep_v, s.seg_start[:max_voxels], n - 1)
        npoints = torch.where(keep_v, s.npoints_seg[:max_voxels], 0)
        seg_key = torch.where(keep_v, s.seg_key_s[:max_voxels], 0)
    else:
        vr = torch.arange(max_voxels, dtype=torch.int32, device=dev)
        sel = torch.clamp(vr, max=n - 1).long()
        keep_v = (vr < n) & s.seg_valid[sel]
        start_v = torch.where(keep_v, s.seg_start[sel], n - 1)
        npoints = torch.where(keep_v, s.npoints_seg[sel], 0)
        seg_key = torch.where(keep_v, s.seg_key_s[sel], 0)
    # npoints counts *all* points in the cell, even beyond max_points
    # (voxelize.cpp:128-135)

    # voxels tensor + pmask: only the first max_points slots are filled
    prange = torch.arange(max_points, dtype=torch.int32, device=dev)
    pmask = keep_v[:, None] & (prange[None, :]
                               < torch.clamp(npoints, max=max_points)[:, None])
    gidx = torch.clamp(start_v[:, None] + prange[None, :], max=n - 1)
    voxels = torch.where(
        pmask[..., None],
        feats_s[gidx.reshape(-1).long()].reshape(max_voxels, max_points, f),
        0)

    # decode the cell coordinate from the per-segment key
    c0 = seg_key // (shape[1] * shape[2])
    rem = seg_key % (shape[1] * shape[2])
    coords = torch.stack([c0, rem // shape[2], rem % shape[2]], dim=1)

    out = EDict(
        voxels=voxels,
        coords=coords,
        voxel_pmask=pmask,
        voxel_npoints=npoints,
        nvoxels=torch.clamp(s.nvoxels, max=max_voxels),
    )

    if reduction == "mean":
        # segment-sorted cumulative sum + one read at each run boundary
        fmask = s.valid_s[:, None]
        csum = _cumsum_f32(torch.where(fmask, feats_s, 0))
        if sorted_fast:
            # segment v's run ends where segment v+1's begins, so one read
            # of E[v] = csum just before run v covers both boundaries
            startp = s.seg_start[:max_voxels + 1]
            E = torch.where((startp > 0)[:, None],
                            csum[torch.clamp(startp - 1, min=0).long()], 0)
            total = E[1:] - E[:-1]
        else:
            lo = torch.where((start_v > 0)[:, None],
                             csum[torch.clamp(start_v - 1, min=0).long()], 0)
            end = torch.clamp(start_v + npoints - 1, max=n - 1).long()
            total = csum[end] - lo
        agg = total / torch.clamp(npoints, min=1)[:, None]
        out.aggregates = torch.where(keep_v[:, None], agg.to(points.dtype), 0)
    return out


def voxelize_mean_fm(points_fm, shape, bounds, max_voxels):
    """Feature-major mean voxelization (same cell semantics as
    :func:`voxelize_dense_padded` with ``reduction="mean",
    order_mode="sorted"``; reference voxelize.cpp:46-199).

    In-cell offsets (and extra columns over their range) are quantized to
    ``min(14, log2(2^31/N))`` fixed-point bits and summed exactly as
    integers, so means carry no cancellation error (max error range /
    2^(bits+1)). The JAX module sums in wrapping int32; the port sums in
    int64, whose boundary differences are the same integers with no
    overflow question. The per-voxel exclusive sums ride through the
    boundary-compaction sort, so no N-row gather of features remains.

    :param points_fm: (F, N) float32, xyz in the first THREE rows; a tensor
        stays on its device, anything else goes to CUDA
    :param shape: (3,) grid shape
    :param bounds: (6,) [xmin, xmax, ymin, ymax, zmin, zmax]
    :param max_voxels: voxel capacity V
    :return: EDict(aggregates (F, V), coords (3, V) int32, voxel_npoints
        (V,) int32, nvoxels) — voxels are in cell-key order
    """
    shape = tuple(int(v) for v in shape)
    points_fm = as_tensor(points_fm)
    bounds = as_tensor(bounds, device=points_fm.device)
    dev = points_fm.device
    f, n = points_fm.shape
    n_real = n  # before sentinel padding (stats must exclude the -1e30s)
    if n < max_voxels + 1:
        # pad with out-of-range sentinel points so the [:V+1] slices exist
        points_fm = torch.cat([points_fm, points_fm.new_full(
            (f, max_voxels + 1 - n), -1e30)], dim=1)
        n = max_voxels + 1
    b = bounds.reshape(3, 2)
    sh = torch.tensor(shape, dtype=torch.int32, device=dev)
    vsize = (b[:, 1] - b[:, 0]) / sh
    max_key = shape[0] * shape[1] * shape[2]
    if max_key + 2 >= 1 << 31:
        raise ValueError("voxel grid too large for int32 keys")
    qbits = min(14, int(math.log2((2 ** 31 - 1) / n)))
    qscale = float(1 << qbits)

    scaled = (points_fm[:3] - b[:, 0:1]) / vsize[:, None]
    idx = _to_int32(torch.trunc(torch.clamp(scaled, -2e9, 2e9)))
    inr = ((idx >= 0) & (idx < sh[:, None])).all(dim=0)
    key = (idx[0] * shape[1] + idx[1]) * shape[2] + idx[2]
    key = torch.where(inr, key, max_key + 1)

    # in-cell offsets (xyz) / range-normalized extras, as fixed point.
    # frac can be NEGATIVE: trunc-toward-zero puts scaled in (-1, 0) into
    # cell 0 with a negative offset — quantize signed, clamp the +1.0 edge.
    # Out-of-range values (the sentinels) only ever belong to invalid
    # points, whose columns are zeroed before the sums.
    frac = scaled - idx.to(scaled.dtype)
    qxyz = _to_int32(torch.round(frac * qscale))
    extra = points_fm[3:]
    # quantization stats over the REAL columns only
    cmin = extra[:, :n_real].amin(dim=1, keepdim=True)
    crange = torch.clamp_min(
        extra[:, :n_real].amax(dim=1, keepdim=True) - cmin, 1e-30)
    qextra = _to_int32(torch.round((extra - cmin) / crange * qscale))
    qmax = 1 << qbits
    qcols = torch.clamp(torch.cat([qxyz, qextra], dim=0), -qmax, qmax - 1)

    # the JAX module's unstable key sort carries packed column pairs; any
    # order within a cell gives the same sums, so a stable sort + gather
    k_s, order = torch.sort(key, stable=True)
    qcols_s = qcols[:, order]
    valid_s = k_s <= max_key

    newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        k_s[1:] != k_s[:-1]])
    pos = torch.arange(n, dtype=torch.int32, device=dev)

    # boundary-compaction sort: boundary rows carry (position, key,
    # exclusive sum per column); non-boundary rows carry (n, int32 max,
    # grand total) and sort last — slot v+1 then closes segment v
    colv = torch.where(valid_s[None, :], qcols_s, 0).to(torch.int64)
    csum = torch.cumsum(colv, dim=1)
    excl = torch.where(newseg[None, :], csum - colv, csum[:, -1:])
    seg_start, perm = torch.sort(torch.where(newseg, pos, n), stable=True)
    seg_key_s = torch.where(newseg, k_s, _INT32_MAX)[perm]
    e_cols = excl[:, perm]

    next_start = torch.cat([seg_start[1:],
                            torch.full((1,), n, dtype=torch.int32,
                                       device=dev)])
    nvalid = valid_s.sum()
    seg_valid = (seg_start < n) & (seg_start < nvalid)
    npoints_seg = torch.where(seg_valid, next_start - seg_start, 0)
    nvoxels = seg_valid.sum().to(torch.int32)

    keep_v = seg_valid[:max_voxels]
    npoints = torch.where(keep_v, npoints_seg[:max_voxels], 0)
    seg_key = torch.where(keep_v, seg_key_s[:max_voxels], 0)

    c0 = seg_key // (shape[1] * shape[2])
    rem = seg_key % (shape[1] * shape[2])
    coords = torch.stack([c0, rem // shape[2], rem % shape[2]], dim=0)

    inv_np = 1.0 / torch.clamp(npoints, min=1).to(torch.float32)
    totq = ((e_cols[:, 1:max_voxels + 1] - e_cols[:, :max_voxels])
            .to(torch.float32) / qscale)
    mean_frac = totq[:3] * inv_np[None, :]
    agg = (coords.to(torch.float32) + mean_frac) * vsize[:, None] + b[:, 0:1]
    if f > 3:
        agg_extra = totq[3:] * inv_np[None, :] * crange + cmin
        agg = torch.cat([agg, agg_extra], dim=0)
    agg = torch.where(keep_v[None, :], agg, 0)
    return EDict(aggregates=agg, coords=coords, voxel_npoints=npoints,
                 nvoxels=torch.clamp(nvoxels, max=max_voxels))

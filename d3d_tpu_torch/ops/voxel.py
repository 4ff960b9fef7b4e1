"""Point-cloud voxelization as sort + segment bookkeeping (port of
``d3d_tpu.ops.voxel``).

Linearize each point's voxel coordinate into an integer key, stable-sort
the points by key, detect segment boundaries, and read every per-voxel
value at the run boundaries. Voxel ids follow the reference's hash
insertion order (``order_mode="encounter"``: ranking segments by their
first point reproduces it, which the order-dependent TRIM filters need) or
cell-key order (``"sorted"``, the models' fast path). The padded cores
return fixed-shape tensors with the count as a 0-d tensor, so nothing waits
for the device; :class:`VoxelGenerator` slices them to the count and
returns numpy, as the reference does.
"""

import math

import numpy as np
import torch

from ..utils import EDict, as_tensor, resolve_device

__all__ = ["VoxelGenerator", "voxelize_dense_padded",
           "voxelize_sparse_padded", "voxelize_filter_padded",
           "voxelize_mean_fm", "voxelize_mean_fm_exact"]

_INT32_MAX = 2 ** 31 - 1
# the invalid key of the generic (int64) key path
_INT_SENTINEL = 2 ** 63 - 1


def _to_int32(x):
    """Float -> int32 as XLA's convert does it: NaN becomes 0 (a CUDA cast
    gives 0 too, torch on an x86 CPU INT_MIN). Callers clamp to int32's
    range first."""
    return torch.nan_to_num(x, nan=0.0, posinf=math.inf,
                            neginf=-math.inf).to(torch.int32)


def _to_int64(x):
    """Float -> int64 as XLA's convert does it: NaN becomes 0 and values
    past int64's range saturate at its ends."""
    x = torch.nan_to_num(x, nan=0.0, posinf=math.inf, neginf=-math.inf)
    big = 2.0 ** 63
    out = torch.where((x >= -big) & (x < big), x, 0.0).to(torch.int64)
    out = torch.where(x >= big, _INT_SENTINEL, out)
    return torch.where(x < -big, -_INT_SENTINEL - 1, out)


def _wrap_int32(x):
    """int64 -> int32 modulo 2^32, as XLA's int32 arithmetic wraps."""
    return (((x + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31).to(torch.int32)


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

    :param key: (N,) int cell key. With ``max_key`` (< 2^31 - 2, the dense
        grids) invalid points carry ``max_key + 1`` and the keys sort as
        int32; without it (the sparse path's data-dependent range) they
        sort as int64 and invalid points carry ``_INT_SENTINEL``
    :param order_mode: "encounter" ranks the segments by their first
        point (the reference's hash-insertion order); "sorted" keeps
        cell-key order, so voxel v is segment v
    :return: EDict with the sort ``order``, ``valid_s`` and ``newseg_s`` in
        sorted order and per-segment tensors of length N (segments beyond
        the voxel count are invalid). In encounter mode also each point's
        segment id and slot in its segment (sorted order), each segment's
        voxel rank (``rank_of_seg``, N for an invalid segment) and its
        inverse (``seg_of_rank``); sorted mode leaves them out, as nothing
        there reads them.
    """
    n = key.shape[0]
    dev = key.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    if max_key is not None and max_key + 2 < 1 << 31:
        capped = torch.clamp(key, max=max_key + 1).to(torch.int32)
        k_s, order = torch.sort(capped, stable=True)
        valid_s = k_s <= max_key
        newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            k_s[1:] != k_s[:-1]])
        # per-segment start positions and keys by stream compaction:
        # boundary (key, position) pairs sort to the front in segment
        # order. The JAX module's two-key sort becomes one sort of an int64
        # composite key (both parts are non-negative and below 2^31).
        composite = (torch.where(newseg, k_s, _INT32_MAX).to(torch.int64)
                     << 32 | torch.where(newseg, pos, n).to(torch.int64))
        composite = torch.sort(composite).values
        seg_key_s = (composite >> 32).to(torch.int32)
        seg_start = (composite & 0xFFFFFFFF).to(torch.int32)
    else:
        # the generic int64 key path: keys ascend with the position in
        # sorted order, so the boundaries' positions alone order them
        k_s, order = torch.sort(key.to(torch.int64), stable=True)
        valid_s = k_s != _INT_SENTINEL
        newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            k_s[1:] != k_s[:-1]])
        seg_start, perm = torch.sort(torch.where(newseg, pos, n),
                                     stable=True)
        seg_key_s = torch.where(newseg, k_s, _INT_SENTINEL)[perm]
    # segments are contiguous in sorted order, so each count is the gap to
    # the next segment's start (empty segments carry start == n)
    next_start = torch.cat([seg_start[1:],
                            torch.full((1,), n, dtype=torch.int32,
                                       device=dev)])
    # invalid points carry the largest key, so they sort last: a segment is
    # valid iff it starts before the first invalid point
    seg_valid = (seg_start < n) & (seg_start < valid_s.sum())
    out = EDict(
        order=order,
        valid_s=valid_s,
        newseg_s=newseg,
        npoints_seg=torch.where(seg_valid, next_start - seg_start, 0),
        seg_start=seg_start,
        seg_key_s=seg_key_s,
        seg_valid=seg_valid,
        nvoxels=seg_valid.sum().to(torch.int32),
    )
    if order_mode == "sorted":
        return out
    if order_mode != "encounter":
        raise ValueError(f"unknown order_mode {order_mode!r}")
    out.seg_id_s = (torch.cumsum(newseg, 0) - 1).to(torch.int32)
    # each point's slot in its segment: position - the segment's start
    start_s = torch.cummax(torch.where(newseg, pos, 0), 0).values
    out.slot_s = pos - start_s
    # first original point index of each segment (the stable sort puts it
    # at the segment start); invalid segments rank after every valid one,
    # ties by segment index as the JAX module's packed sort breaks them
    first_idx = torch.where(
        seg_valid, order[torch.clamp(seg_start, max=n - 1).long()], n)
    seg_of_rank = torch.sort(first_idx, stable=True).indices
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[seg_of_rank] = torch.arange(n, device=dev)
    out.seg_of_rank = seg_of_rank
    out.rank_of_seg = rank
    return out


def _scatter_rows(target_rows, idx, rows, mask):
    """Scatter ``rows`` into a (R + 1, ...) zero buffer at row ``idx``
    (masked rows go to the trash row R), returning the first R rows."""
    r = target_rows
    idx = torch.where(mask, idx, r).long()
    buf = rows.new_zeros((r + 1,) + rows.shape[1:])
    buf[idx] = rows
    return buf[:r]


def _segment_extreme(vals, seg_id, nseg, reduction):
    """Per-segment max or min of (N, F) ``vals`` over (N,) ``seg_id`` ->
    (nseg, F), NaN wherever a segment holds one (as ``jnp.maximum`` and
    ``jnp.minimum`` propagate it)."""
    fill = -math.inf if reduction == "max" else math.inf
    nan = torch.isnan(vals)
    idx = seg_id.long()[:, None].expand_as(vals)
    out = vals.new_full((nseg, vals.shape[1]), fill).scatter_reduce(
        0, idx, torch.where(nan, fill, vals),
        "amax" if reduction == "max" else "amin", include_self=True)
    has_nan = torch.zeros(out.shape, dtype=torch.uint8,
                          device=vals.device).scatter_reduce(
        0, idx, nan.to(torch.uint8), "amax", include_self=True)
    return torch.where(has_nan.bool(), math.nan, out)


def voxelize_dense_padded(points, shape, bounds, max_points, max_voxels,
                          reduction, order_mode="encounter"):
    """Dense voxelization core (reference voxelize.cpp:46-199 semantics).

    :param points: (N, F) float tensor, xyz in the first 3 columns; a
        tensor stays on its device, anything else goes to CUDA
    :param shape: (3,) int grid shape
    :param bounds: (6,) [xmin,xmax,ymin,ymax,zmin,zmax]
    :param reduction: one of "none", "mean", "max", "min"
    :param order_mode: "encounter" = reference hash-insertion voxel order;
        "sorted" = cell-key order (one sort fewer)
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

    s = _segment_structure(key, max_key=max_key, order_mode=order_mode)
    feats_s = points[s.order]

    # voxel v is the contiguous run [seg_start[sel_v], +npoints[sel_v]) of
    # feats_s, where sel_v is the segment ranked v (v itself when sorted)
    sorted_fast = order_mode == "sorted" and max_voxels < n
    if sorted_fast:
        keep_v = s.seg_valid[:max_voxels]
        start_v = torch.where(keep_v, s.seg_start[:max_voxels], n - 1)
        npoints = torch.where(keep_v, s.npoints_seg[:max_voxels], 0)
        seg_key = torch.where(keep_v, s.seg_key_s[:max_voxels], 0)
    else:
        vr = torch.arange(max_voxels, dtype=torch.int32, device=dev)
        sel = torch.clamp(vr, max=n - 1).long()
        if order_mode != "sorted":
            sel = s.seg_of_rank[sel]
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
    elif reduction in ("max", "min"):
        # the extreme over all points of each segment (invalid points form
        # their own trailing segment), read at the voxel's segment
        seg_id = torch.cumsum(s.newseg_s, 0) - 1
        per_seg = _segment_extreme(feats_s, seg_id, n, reduction)
        sel_v = (torch.arange(max_voxels, device=dev) if sorted_fast
                 else sel)
        out.aggregates = torch.where(keep_v[:, None],
                                     per_seg[sel_v].to(points.dtype), 0)
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


def voxelize_mean_fm_exact(points_fm, shape, bounds, max_voxels):
    """Feature-major mean voxelization at full f32 output precision (same
    contract as :func:`voxelize_mean_fm`).

    The columns are quantized to ~25 fixed-point bits and split into two
    int32 limbs, ``q = (q >> L) * 2^L + (q & (2^L - 1))``; each limb's
    per-voxel total is a difference of prefix sums. The JAX module sums in
    wrapping int32; the port sums in int64 and wraps the differences to
    int32 as XLA's arithmetic does. Each limb's true per-voxel total is
    below ``n * 2^max(L, qbits - L) <= 2^30`` (qbits adapts to n), so the
    wrapped differences are the exact totals either way.

    :param points_fm: (F, N) float32, xyz in the first three rows; a
        tensor stays on its device, anything else goes to CUDA
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
        points_fm = torch.cat([points_fm, points_fm.new_full(
            (f, max_voxels + 1 - n), -1e30)], dim=1)
        n = max_voxels + 1
    b = bounds.reshape(3, 2)
    sh = torch.tensor(shape, dtype=torch.int32, device=dev)
    vsize = (b[:, 1] - b[:, 0]) / sh
    max_key = shape[0] * shape[1] * shape[2]
    if max_key + 2 >= 1 << 31:
        raise ValueError("voxel grid too large for int32 keys")
    # both limbs must keep n * 2^limb_bits < 2^31 for exact differences
    limb = min(12, 30 - int(np.ceil(np.log2(n))))
    qbits = 2 * limb
    if qbits <= 0:
        raise ValueError("too many points for exact int32 limb accumulation")
    qscale = float(1 << qbits)
    qmax = 1 << qbits

    scaled = (points_fm[:3] - b[:, 0:1]) / vsize[:, None]
    idx = _to_int32(torch.trunc(torch.clamp(scaled, -2e9, 2e9)))
    inr = ((idx >= 0) & (idx < sh[:, None])).all(dim=0)
    key = (idx[0] * shape[1] + idx[1]) * shape[2] + idx[2]
    key = torch.where(inr, key, max_key + 1)

    # signed in-cell offsets, extras normalized over the REAL columns'
    # range, all at qbits fixed point
    frac = scaled - idx.to(scaled.dtype)
    qxyz = _to_int32(torch.round(frac * qscale))
    if f > 3:
        extra = points_fm[3:]
        cmin = extra[:, :n_real].amin(dim=1, keepdim=True)
        crange = torch.clamp_min(
            extra[:, :n_real].amax(dim=1, keepdim=True) - cmin, 1e-30)
        qextra = _to_int32(torch.round(
            torch.clamp((extra - cmin) / crange, -1.0, 2.0) * qscale))
        qcols = torch.clamp(torch.cat([qxyz, qextra], dim=0), -qmax, qmax)
    else:
        qcols = torch.clamp(qxyz, -qmax, qmax)

    # the JAX module's unstable key sort carries the columns; any order
    # within a cell gives the same integer sums, so a stable sort + gather
    k_s, order = torch.sort(key, stable=True)
    qcols_s = qcols[:, order]
    valid_s = k_s <= max_key
    newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        k_s[1:] != k_s[:-1]])
    pos = torch.arange(n, dtype=torch.int32, device=dev)

    # the two limbs and their prefix sums; boundary rows carry their
    # exclusive sums, the rest the grand total and sort last, so slot v + 1
    # closes segment v
    qv = torch.where(valid_s[None, :], qcols_s, 0)
    limbs = torch.cat([qv >> limb, qv & ((1 << limb) - 1)],
                      dim=0).to(torch.int64)
    csum = torch.cumsum(limbs, dim=1)
    excl = torch.where(newseg[None, :], csum - limbs, csum[:, -1:])
    seg_start, perm = torch.sort(torch.where(newseg, pos, n), stable=True)
    seg_key_s = torch.where(newseg, k_s, _INT32_MAX)[perm]
    e_limbs = excl[:, perm]

    next_start = torch.cat([seg_start[1:],
                            torch.full((1,), n, dtype=torch.int32,
                                       device=dev)])
    seg_valid = (seg_start < n) & (seg_start < valid_s.sum())
    npoints_seg = torch.where(seg_valid, next_start - seg_start, 0)
    nvoxels = seg_valid.sum().to(torch.int32)

    keep_v = seg_valid[:max_voxels]
    npoints = torch.where(keep_v, npoints_seg[:max_voxels], 0)
    seg_key = torch.where(keep_v, seg_key_s[:max_voxels], 0)

    c0 = seg_key // (shape[1] * shape[2])
    rem = seg_key % (shape[1] * shape[2])
    coords = torch.stack([c0, rem // shape[2], rem % shape[2]], dim=0)

    inv_np = 1.0 / torch.clamp(npoints, min=1).to(torch.float32)
    # limb totals (exact), recombined in f32 as separate per-limb means so
    # each term carries only its own ulp
    tot = _wrap_int32(e_limbs[:, 1:max_voxels + 1]
                      - e_limbs[:, :max_voxels]).to(torch.float32)
    mean_q = (tot[:f] * inv_np * float(1 << limb) / qscale
              + tot[f:] * inv_np / qscale)
    agg = (coords.to(torch.float32) + mean_q[:3]) * vsize[:, None] \
        + b[:, 0:1]
    if f > 3:
        agg = torch.cat([agg, mean_q[3:] * crange + cmin], dim=0)
    agg = torch.where(keep_v[None, :], agg, 0)
    return EDict(aggregates=agg, coords=coords, voxel_npoints=npoints,
                 nvoxels=torch.clamp(nvoxels, max=max_voxels))


def voxelize_sparse_padded(points, voxel_size):
    """Sparse (unbounded-grid) voxelization core: cells are
    ``floor(xyz / voxel_size)`` and every point is mapped; voxel ids in
    encounter order.

    :param points: (N, F) float tensor; a tensor stays on its device,
        anything else goes to CUDA
    :param voxel_size: (3,)
    :return: EDict(points_mapping (N,) int64, coords (N, 3) int64 padded,
        voxel_npoints (N,) int32 padded, nvoxels)
    """
    points = as_tensor(points)
    voxel_size = as_tensor(voxel_size, device=points.device)
    n = points.shape[0]
    idx = _to_int64(torch.floor(points[:, :3] / voxel_size))
    cmin = idx.amin(dim=0)
    rng = idx.amax(dim=0) - cmin + 1
    rel = idx - cmin
    key = (rel[:, 0] * rng[1] + rel[:, 1]) * rng[2] + rel[:, 2]
    # no sentinel: every point is valid
    key = torch.clamp(key, max=_INT_SENTINEL - 1)

    s = _segment_structure(key)
    pm = torch.empty(n, dtype=torch.int64, device=points.device)
    pm[s.order] = s.rank_of_seg[s.seg_id_s.long()]
    seg_keep = s.npoints_seg > 0
    npoints = _scatter_rows(n, s.rank_of_seg, s.npoints_seg[:, None],
                            seg_keep)[:, 0]
    # a segment's cell is that of any of its points (the JAX module's
    # segment minimum): take its first
    idx_s = idx[s.order]
    coords_seg = idx_s[torch.clamp(s.seg_start, max=n - 1).long()]
    coords = _scatter_rows(n, s.rank_of_seg, coords_seg, seg_keep)
    return EDict(points_mapping=pm, coords=coords, voxel_npoints=npoints,
                 nvoxels=s.nvoxels)


def voxelize_filter_padded(points_mapping, coords, voxel_npoints, nvoxels,
                           coords_bound, min_points, max_points, max_voxels,
                           max_points_filter, max_voxels_filter, use_bounds,
                           points_xyz=None, fps_pool=128):
    """Voxel and point filtering of the padded sparse output.

    Voxel filters: ``none`` (bounds and min_points only), ``trim`` (the
    first max_voxels passing voxels in insertion order), ``descending``
    (the max_voxels most populated, new ids in descending-npoints order).
    Point filters: ``trim`` drops the points past max_points of each kept
    voxel in point order; ``farthest_sampling`` keeps a farthest-point
    subset of each voxel's first ``fps_pool`` points instead (needs
    ``points_xyz``).

    :return: EDict(points_mapping (N,) with -1 for dropped, coords (V, 3)
        padded, voxel_npoints (V,), nvoxels)
    """
    dev = points_mapping.device
    n = points_mapping.shape[0]
    v = coords.shape[0]
    varange = torch.arange(v, device=dev)
    vvalid = varange < nvoxels

    passing = vvalid & (voxel_npoints >= min_points)
    if use_bounds:
        cb = coords_bound.to(coords.dtype)
        inb = ((coords >= cb[:, 0]) & (coords < cb[:, 1])).all(dim=1)
        passing = passing & inb

    if max_voxels_filter == "descending":
        sort_key = torch.where(vvalid, -voxel_npoints.to(torch.int64), 1)
        seq = torch.sort(sort_key, stable=True).indices
    else:
        seq = varange  # insertion order

    pass_seq = passing[seq]
    new_id_seq = torch.cumsum(pass_seq, 0) - 1
    keep_seq = pass_seq
    if max_voxels_filter in ("trim", "descending"):
        keep_seq = keep_seq & (new_id_seq < max_voxels)
    # back to the original voxel index space
    keep = torch.zeros(v, dtype=torch.bool, device=dev)
    keep[seq] = keep_seq
    new_id = torch.full((v,), -1, dtype=torch.int64, device=dev)
    new_id[seq] = torch.where(keep_seq, new_id_seq, -1)
    nkept = keep.sum().to(torch.int32)

    # remap points
    mapped = points_mapping >= 0
    pm_new = torch.where(mapped, new_id[torch.clamp_min(points_mapping, 0)],
                         -1)
    if max_points_filter in ("trim", "farthest_sampling"):
        # rank of each point within its (kept) voxel, in point order
        key = torch.where(pm_new >= 0, pm_new, v)
        k_s, order = torch.sort(key, stable=True)
        newseg = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                            k_s[1:] != k_s[:-1]])
        pos = torch.arange(n, device=dev)
        slot_s = pos - torch.cummax(torch.where(newseg, pos, 0), 0).values
        slot = torch.empty_like(slot_s)
        slot[order] = slot_s
    if max_points_filter == "trim":
        pm_new = torch.where(slot < max_points, pm_new, -1)
    elif max_points_filter == "farthest_sampling":
        from .point import farthest_point_sampling

        if points_xyz is None:
            raise ValueError("farthest_sampling needs the point coordinates")
        # the candidate pool never holds fewer points than trim would keep
        pool = max(int(fps_pool), int(max_points))
        inpool = (pm_new >= 0) & (slot < pool)
        rows = torch.where(inpool, pm_new, v)
        cols = torch.clamp(slot, max=pool - 1)
        table = torch.full((v + 1, pool), -1, dtype=torch.int64, device=dev)
        table[rows, cols] = torch.where(inpool, pos, -1)
        table = table[:v]
        cl_valid = table >= 0
        cl_xyz = torch.where(cl_valid[..., None],
                             points_xyz[torch.clamp_min(table, 0), :3], 0.0)
        sel = farthest_point_sampling(cl_xyz, max_points, cl_valid)
        keep_tab = torch.zeros((v, pool), dtype=torch.int32, device=dev)
        keep_tab.index_put_((varange[:, None], torch.clamp_min(sel, 0).long()),
                            (sel >= 0).to(torch.int32), accumulate=True)
        pt_keep = inpool & (keep_tab[torch.where(pm_new >= 0, pm_new, 0),
                                     cols] > 0)
        pm_new = torch.where(pt_keep, pm_new, -1)

    # new per-voxel point counts + coords in new id order
    counts = torch.zeros(v + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, torch.where(pm_new >= 0, pm_new, v),
                      (pm_new >= 0).to(torch.int32))
    coords_new = _scatter_rows(v, torch.where(keep, new_id, v), coords, keep)
    return EDict(points_mapping=pm_new, coords=coords_new,
                 voxel_npoints=counts[:v], nvoxels=nkept)


class VoxelGenerator:
    """Convert a point cloud to voxels; drop-in equivalent of the reference
    ``d3d.voxel.VoxelGenerator`` and of ``d3d_tpu.ops.voxel.VoxelGenerator``.

    :param bounds: grid boundary [xmin, xmax, ymin, ymax, zmin, zmax]
    :param shape: voxel grid shape (3,)
    :param min_points: minimum points per voxel (sparse only)
    :param max_points: maximum points kept per voxel
    :param max_voxels: maximum voxel count
    :param reduction: per-voxel feature reduction {none, mean, max, min}
        (dense only)
    :param dense: dense [max_voxels, max_points, F] output vs sparse mapping
    :param max_points_filter: {none, trim, farthest_sampling} (sparse)
    :param max_voxels_filter: {none, trim, descending} (sparse)
    :param device: where the voxelization runs: CUDA unless ``"cpu"`` (or
        another device) is given
    """

    def __init__(self, bounds, shape, min_points=0, max_points=30,
                 max_voxels=20000, max_points_filter=None,
                 max_voxels_filter=None, reduction=None, dense=False,
                 device=None):
        self._bounds = np.asarray(bounds, np.float32)
        self._shape = np.asarray(shape, np.int32)
        self._min_points = int(min_points)
        self._max_points = int(max_points)
        self._max_voxels = int(max_voxels)
        self._dense = bool(dense)
        self._device = resolve_device(device)

        barr = self._bounds.reshape(3, 2)
        self._size = (barr[:, 1] - barr[:, 0]) / self._shape
        dist = barr[:, 0] / self._size
        if np.any(np.abs(np.round(dist) - dist) > 1e-3):
            raise ValueError(
                "The voxelization grid is not aligned with the origin, "
                "which could lead to unexpected behavior!")
        self._offset = np.round(dist).astype(np.int64)
        self._vbounds = np.round(barr / self._size.reshape(3, 1)).astype(
            np.int64)

        self._reduction = (reduction or "none").lower()
        if self._reduction not in ("none", "mean", "max", "min"):
            raise ValueError("Unsupported reduction type in VoxelGenerator!")
        if self._reduction != "none" and not dense:
            raise ValueError("Reduction is only for dense voxelization!")

        self._max_points_filter = (max_points_filter or "none").lower()
        if self._max_points_filter not in ("none", "trim",
                                           "farthest_sampling"):
            raise ValueError(
                "Unsupported maximum points filter in VoxelGenerator!")
        self._max_voxels_filter = (max_voxels_filter or "none").lower()
        if self._max_voxels_filter not in ("none", "trim", "descending"):
            raise ValueError(
                "Unsupported maximum voxels filter in VoxelGenerator!")

        if dense:
            if min_points > 0:
                raise NotImplementedError(
                    "Minimum points filtering is not implemented for dense")
            if self._max_points_filter not in ("none", "trim"):
                raise NotImplementedError(
                    "Only trim is implemented for max points filtering")
            if self._max_voxels_filter not in ("none", "trim"):
                raise NotImplementedError(
                    "Only trim is implemented for max voxels filtering")

    def __call__(self, points):
        """Voxelize (N, F) points (numpy or a tensor); returns an EDict of
        numpy arrays sliced to the true voxel count."""
        if isinstance(points, torch.Tensor):
            points = points.detach().cpu().numpy()
        points = np.asarray(points, np.float32)
        dev = self._device
        tp = torch.from_numpy(points).to(dev)
        if self._dense:
            ret = voxelize_dense_padded(
                tp, tuple(self._shape.tolist()),
                torch.from_numpy(self._bounds).to(dev), self._max_points,
                self._max_voxels, self._reduction)
            nv = int(ret.nvoxels)
            out = EDict(
                voxels=ret.voxels[:nv].cpu().numpy(),
                coords=ret.coords[:nv].cpu().numpy().astype(np.int64),
                voxel_pmask=ret.voxel_pmask[:nv].cpu().numpy(),
                voxel_npoints=ret.voxel_npoints[:nv].cpu().numpy())
            if self._reduction != "none":
                out.aggregates = ret.aggregates[:nv].cpu().numpy()
            return out

        sparse = voxelize_sparse_padded(tp, torch.from_numpy(self._size).to(
            dev))
        filt = voxelize_filter_padded(
            sparse.points_mapping, sparse.coords, sparse.voxel_npoints,
            sparse.nvoxels, torch.from_numpy(self._vbounds).to(dev),
            self._min_points, self._max_points, self._max_voxels,
            self._max_points_filter, self._max_voxels_filter, True,
            points_xyz=(tp[:, :3]
                        if self._max_points_filter == "farthest_sampling"
                        else None))
        pm = filt.points_mapping.cpu().numpy()
        nv = int(filt.nvoxels)
        masked = np.where(pm >= 0)[0]
        return EDict(
            points=points[masked],
            points_mask=masked,
            points_mapping=pm[masked],
            voxel_npoints=filt.voxel_npoints[:nv].cpu().numpy(),
            coords=filt.coords[:nv].cpu().numpy() - self._offset)

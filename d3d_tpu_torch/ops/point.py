"""Point-set operations (port of ``d3d_tpu.ops.point``).

:func:`aligned_scatter` gathers per-point features from a dense feature
map at fractional coordinates (after the reference's
d3d/point/scatter.cpp: despite the name the forward is a gather; only the
backward scatters, which autograd derives from the gather). The whole
2^m neighbour lattice is one (N, 2^m) batched gather and a weighted
reduction.

Border semantics match scatter.cpp:34-77: out-of-range coordinates clamp
to the border cell and halve the interpolation weight per crossing, so a
fully clamped point still sums to exactly the border value. One reference
quirk is kept deliberately: at EXACTLY integral in-range coordinates
floor == ceil and both lattice neighbours get weight 1, so the "linear"
sum doubles per integral axis.

:func:`nearest_neighbor` is a chunked brute-force search whose recentring
runs in float64 on the host, and :func:`farthest_point_sampling` the
greedy downsampler that ``VoxelGenerator``'s ``farthest_sampling`` filter
runs. Indices follow the JAX module's gathers: a float index becomes an
integer as XLA converts it (NaN to 0, saturating), a negative one counts
from the end and the result is clamped into range.
"""

import numpy as np
import torch

from ..utils import as_tensor, resolve_device
from .voxel import _to_int32

__all__ = ["aligned_scatter", "nearest_neighbor", "farthest_point_sampling"]


def _index(x, size):
    """A float or integer index tensor as ``jnp`` indexing reads it: NaN
    -> 0 and saturating for floats, negative counting from the end, then
    clamped into [0, size - 1]; int64 for torch's indexing."""
    if x.is_floating_point():
        x = _to_int32(torch.clamp(x, -2e9, 2e9))
    x = x.to(torch.int64)
    return torch.clamp(torch.where(x < 0, x + size, x), 0, size - 1)


def _neighbor_lattice(coords, spatial_shape):
    """Neighbour cells and linear weights of fractional coords.

    :param coords: (N, m) fractional spatial coordinates
    :param spatial_shape: tuple of m ints (D1..Dm)
    :return: cells (N, 2^m, m) int64 (in range), weights (N, 2^m)
    """
    m = len(spatial_shape)
    nb = 1 << m
    dev = coords.device
    cells = []
    weights = torch.ones((coords.shape[0], nb), dtype=coords.dtype,
                         device=dev)
    for d in range(m):
        dmax = spatial_shape[d] - 1
        dc = coords[:, d]
        over, under = dc > dmax, dc < 0
        lo = torch.floor(dc)
        hi = torch.ceil(dc)
        # bit d of the neighbour index selects floor vs ceil
        bit = ((torch.arange(nb, device=dev) >> d) & 1)[None, :] == 1
        cell = torch.where(bit, hi[:, None], lo[:, None])
        cell = torch.where(over[:, None], float(dmax),
                           torch.where(under[:, None], 0.0, cell))
        w = torch.where(bit, 1 + dc[:, None] - hi[:, None],
                        1 - dc[:, None] + lo[:, None])
        w = torch.where((over | under)[:, None], 0.5, w)
        weights = weights * w
        cells.append(_index(cell, spatial_shape[d]))
    return torch.stack(cells, dim=-1), weights


def _aligned_gather(feature_map, coordinates, method):
    spatial = tuple(feature_map.shape[2:])
    b = _index(coordinates[:, 0], feature_map.shape[0])
    cells, weights = _neighbor_lattice(coordinates[:, 1:], spatial)
    # gather: (N, 2^m, C)
    vals = feature_map[(b[:, None], slice(None))
                       + tuple(cells[..., d] for d in range(len(spatial)))]
    if method == "mean":
        return vals.mean(dim=1)
    if method == "max":
        return vals.amax(dim=1)
    # the weights are functions of the coordinates, which take no gradient
    # (the reference's backward never produces one)
    return (vals * weights.detach()[..., None]).sum(dim=1)


def aligned_scatter(coordinates, feature_map, method="drop", device=None):
    """Gather per-point features from a dense feature map at fractional
    coordinates (API per reference d3d/point/__init__.py:41-67).
    Differentiable in ``feature_map`` (the gather's scatter-add; on CUDA
    by atomic adds, so not bit-reproducible).

    :param feature_map: (B, C, D1, ..., Dm)
    :param coordinates: (N, m+1); column 0 is the batch index
    :param method: drop | nearest | mean | linear | max
    :param device: where numpy inputs go (default: the feature map's
        device when it is a tensor, else CUDA)
    :return: (N, C) features; numpy when ``coordinates`` is numpy
    """
    convert = isinstance(coordinates, np.ndarray)
    if device is None and isinstance(feature_map, torch.Tensor):
        device = feature_map.device
    feature_map = as_tensor(feature_map, device=device)
    coordinates = as_tensor(coordinates, device=feature_map.device)
    ndim = coordinates.shape[1]
    if feature_map.ndim != ndim + 1:
        raise ValueError(
            "feature_map must have shape B x C x D1..Dm matching coordinates"
        )

    method = (method or "drop").lower()
    if method in ("drop", "nearest"):
        c = coordinates if method == "drop" else torch.round(coordinates)
        spatial = feature_map.shape[2:]
        idx = [_index(c[:, 0], feature_map.shape[0])]
        for d in range(len(spatial)):
            cd = c[:, d + 1]
            if method == "nearest":  # clamp like the interpolating paths
                cd = torch.clamp(cd, 0, spatial[d] - 1)
            idx.append(_index(cd, spatial[d]))
        out = feature_map[(idx[0], slice(None)) + tuple(idx[1:])]
    elif method in ("mean", "linear", "max"):
        out = _aligned_gather(feature_map, coordinates, method)
    else:
        raise ValueError("Unsupported align method!")
    return out.detach().cpu().numpy() if convert else out


def _nn_padded(query, ref, rvalid, q_chunk, r_chunk):
    """Chunked brute-force nearest neighbour: argmin_j |q_i - r_j|.

    |q-r|^2 = |q|^2 - 2 q.r + |r|^2, the cross term as three elementwise
    products in full float32 (the JAX module asks its matmul for
    ``Precision.HIGHEST``; a TF32 product would carry ~1e-3 relative
    error). Within a reference chunk the first least distance wins, across
    chunks only a strictly smaller one, as the JAX loop. Queries are
    independent, so they run ``q_chunk``-multiples at a time."""
    rn = torch.where(rvalid, (ref * ref).sum(dim=1), torch.inf)
    nq = query.shape[0]
    m = ref.shape[0]
    rows = q_chunk * max(1, 16384 // q_chunk)
    best_d = torch.empty(nq, dtype=query.dtype, device=query.device)
    best_i = torch.empty(nq, dtype=torch.int32, device=query.device)
    for q0 in range(0, nq, rows):
        qc = query[q0:q0 + rows]
        qn = (qc * qc).sum(dim=1)
        bd = torch.full((qc.shape[0],), torch.inf, dtype=query.dtype,
                        device=query.device)
        bi = torch.zeros(qc.shape[0], dtype=torch.int32, device=query.device)
        for j in range(m // r_chunk):
            rc = ref[j * r_chunk:(j + 1) * r_chunk]
            cross = (qc[:, 0:1] * rc[:, 0] + qc[:, 1:2] * rc[:, 1]
                     + qc[:, 2:3] * rc[:, 2])
            d = qn[:, None] - 2.0 * cross + rn[None, j * r_chunk:
                                               (j + 1) * r_chunk]
            i = torch.argmin(d, dim=1)
            dmin = d.gather(1, i[:, None])[:, 0]
            upd = dmin < bd
            bd = torch.where(upd, dmin, bd)
            bi = torch.where(upd, (i + j * r_chunk).to(torch.int32), bi)
        best_d[q0:q0 + rows] = bd
        best_i[q0:q0 + rows] = bi
    return torch.sqrt(torch.clamp_min(best_d, 0.0)), best_i


def nearest_neighbor(query, ref, q_chunk=1024, r_chunk=4096, center=True,
                     device=None):
    """Nearest reference point per query point (brute force on the device).

    :param query: (N, 3) float array
    :param ref: (M, 3) float array, M >= 1
    :param center: subtract the query centroid from both clouds (in
        float64, on the host) before the f32 distance expansion. At
        world-frame magnitudes (KITTI-360 drives sit km from the origin)
        |q|^2 ~ 1e7 and the f32 ulp of the expansion is ~1 m^2;
        distances and indices are translation-invariant, so this only
        removes the error.
    :param device: where the search runs (default CUDA; raises when CUDA
        is missing and no device is given)
    :return: (distance (N,), index (N,) int32) numpy arrays
    """
    dev = resolve_device(device)
    query = np.asarray(query, np.float64)
    ref = np.asarray(ref, np.float64)
    if center and len(query):
        origin = query.mean(axis=0)
        query = query - origin
        ref = ref - origin
    query = query.astype(np.float32)
    ref = ref.astype(np.float32)
    n, m = len(query), len(ref)
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    q_chunk = min(q_chunk, max(8, n))
    r_chunk = min(r_chunk, max(8, m))
    npad = -n % q_chunk
    mpad = -m % r_chunk
    qp = np.pad(query, ((0, npad), (0, 0)))
    rp = np.pad(ref, ((0, mpad), (0, 0)))
    rvalid = np.arange(len(rp)) < m
    d, i = _nn_padded(*(torch.from_numpy(a).to(dev) for a in (qp, rp, rvalid)),
                      q_chunk, r_chunk)
    return d.cpu().numpy()[:n], i.cpu().numpy()[:n]


def _sqdist(pts, q):
    """Squared distances (B, K) of (B, K, 3) points to (B, 3) points, the
    three squares added left to right as ``jnp.sum`` adds them."""
    d = pts - q[:, None, :]
    d = d * d
    return d[..., 0] + d[..., 1] + d[..., 2]


def farthest_point_sampling(xyz, k, valid=None):
    """Greedy farthest-point sampling over the last-but-one axis.

    Starts from the first valid point, then repeatedly picks the point
    farthest from the already selected set (the first such point on
    ties).

    :param xyz: (..., K, 3) coordinates (a tensor, on its device)
    :param k: number of samples
    :param valid: optional (..., K) bool mask; invalid slots are never
        picked
    :returns: (..., k) int32 indices into the K axis, -1 beyond the valid
        count
    """
    kk = xyz.shape[-2]
    batch = xyz.shape[:-2]
    dev = xyz.device
    if valid is None:
        valid = torch.ones(xyz.shape[:-1], dtype=torch.bool, device=dev)
    pts = xyz.to(torch.float32).reshape(-1, kk, 3)
    v = valid.reshape(-1, kk)
    nvalid = v.sum(dim=-1)
    rows = torch.arange(pts.shape[0], device=dev)
    # the first valid slot (0 where there is none), as jnp.argmax of a mask
    first = torch.argmax(v.to(torch.int8), dim=-1)
    # selected slots drop to -inf so exact duplicates are never picked twice
    mind = torch.where(v, _sqdist(pts, pts[rows, first]), -torch.inf)
    mind[rows, first] = -torch.inf
    out = torch.full((pts.shape[0], k), -1, dtype=torch.int32, device=dev)
    out[:, 0] = first.to(torch.int32)
    for i in range(1, k):
        nxt = torch.argmax(mind, dim=-1)
        d = _sqdist(pts, pts[rows, nxt])
        mind = torch.minimum(mind, torch.where(v, d, -torch.inf))
        mind[rows, nxt] = -torch.inf
        out[:, i] = nxt.to(torch.int32)
    out = torch.where(torch.arange(k, device=dev) < nvalid[:, None], out, -1)
    return out.reshape(batch + (k,))

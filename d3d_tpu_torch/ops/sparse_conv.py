"""Sparse 3D convolution on active-site lists (port of
``d3d_tpu.ops.sparse_conv``).

Active voxels are a fixed-capacity list of rows, padded with invalid rows.
For each kernel offset, the neighbour map holds the input row at the
query site plus that offset, or -1 where it is absent, out of bounds or
invalid. The map is built once per point cloud and stage and reused by
every layer of the stage. Building it scatters the active row ids onto a
dense int32 canvas of the grid and reads the whole (N, K) map back with
one gather.

The convolution itself, ``out[n] = valid[n] * sum_k W[k]^T feat[nbr[n, k]]``,
runs as the CUDA kernel K5 (:mod:`d3d_tpu_torch.ops.sparse_conv_cuda`) on
CUDA tensors, for submanifold and strided maps alike, and as its plain
version on CPU tensors; its weight gradient runs as K6, its features'
gradient as K5 again on submanifold maps. Both kernels walk the map's rule
book (:func:`prepare_neighbor_map`, :mod:`d3d_tpu_torch.ops.rulebook`):
built once per map on the device, it lets them skip the neighbours that
do not exist.

Grids up to ``_DENSE_CANVAS_MAX_CELLS`` (2^26 cells, a 268 MB int32
transient) build their maps on the canvas; larger ones (a 150 m Waymo
extent at 0.1 m is 90.5M cells) take the JAX module's tagged sort join
(:func:`match_sorted`), all kernel offsets in one batched stable sort.
Both routes give the same map. The stage loops of the models build their
maps through :mod:`d3d_tpu_torch.ops.stage_maps`: on CUDA by its kernel
chain M1, on the CPU by these functions, which are M1's plain version
(and, on the card, its reference).

Strided maps take a kernel, stride and padding per axis where asked
(``kernel``/``padding`` of :func:`downsample_coords` and
:func:`build_neighbor_map_strided`): output site ``o`` reads the inputs
``s*o - p + j`` for ``j`` in the kernel's raster, and it is active when
that window holds an active input, as spconv's ``SparseConv3d`` has it
(:func:`conv_out_grid` gives the output extent).
"""

import numpy as np
import torch

from ..profiler import span
from ..utils import as_tensor
from .rulebook import RuleBook, prepare_neighbor_map, prepare_neighbor_maps
from .sparse_conv_cuda import SubmConv

__all__ = ["kernel_offsets", "linearize", "match_sorted", "build_neighbor_map",
           "build_neighbor_map_strided", "conv_out_grid",
           "prepare_neighbor_map", "prepare_neighbor_maps", "RuleBook",
           "subm_conv_apply", "downsample_coords", "sparse_to_dense"]

_DENSE_CANVAS_MAX_CELLS = 1 << 26
_BIG_KEY = 2 ** 30 - 1


def _const(values, device):
    """``values`` (ints) as an int32 tensor on ``device``."""
    return torch.tensor(values, dtype=torch.int32, device=device)


def kernel_offsets(kernel_size=3, ndim=3):
    """All integer offsets of a cubic kernel in raster (ij) order,
    (K, ndim) int32 numpy, K = kernel_size**ndim. The list is
    centrosymmetric: ``offs[K-1-k] == -offs[k]``."""
    r = np.arange(kernel_size) - kernel_size // 2
    grids = np.meshgrid(*([r] * ndim), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)


def linearize(coords, grid):
    """Linear int32 keys of (..., 3) integer coords on ``grid``
    (D0, D1, D2); the grid volume must stay below 2**30."""
    d0, d1, d2 = grid
    if d0 * d1 * d2 >= 1 << 30:
        raise ValueError(f"sparse grid {grid} too large for int32 keys")
    coords = coords.to(torch.int32)
    return coords[..., 0] * (d1 * d2) + coords[..., 1] * d2 + coords[..., 2]


def match_sorted(ref_keys, ref_valid, query_keys, query_valid):
    """Exact-match join of two key lists: for each query, the matching ref
    ROW or -1, (M,) int32, as the JAX module's tagged sort gives it.

    ``2 * ref`` and ``2 * query + 1`` (invalid rows keyed ``2^30 - 1``)
    are sorted together, stably; a query matches iff its predecessor in
    that order is a ref of the same key: the last of equal refs in row
    order, and only the first of equal queries. Invalid queries give -1.
    Leading dimensions of the queries batch independent joins against the
    same refs (one sort along the last axis)."""
    n, m = ref_keys.shape[-1], query_keys.shape[-1]
    batch = query_keys.shape[:-1]
    rk = torch.where(ref_valid, ref_keys.to(torch.int32), _BIG_KEY) * 2
    qk = torch.where(query_valid, query_keys.to(torch.int32), _BIG_KEY) * 2 + 1
    keys = torch.cat([rk.expand(batch + (n,)), qk], dim=-1)
    sk, perm = torch.sort(keys, dim=-1, stable=True)
    is_query = perm >= n
    row = torch.where(is_query, perm - n, perm).to(torch.int32)
    half = torch.div(sk, 2, rounding_mode="floor")
    hit = torch.zeros_like(is_query)
    hit[..., 1:] = (is_query[..., 1:] & ~is_query[..., :-1]
                    & (half[..., 1:] == half[..., :-1]))
    prev = torch.cat([row[..., :1], row[..., :-1]], dim=-1)
    val = torch.where(hit, prev, -1)
    # back to query-row order: each query row sits once among the queries;
    # the refs all write a spare last column (no boolean index, which
    # would wait for the device)
    out = torch.empty(batch + (m + 1,), dtype=torch.int32, device=qk.device)
    out.scatter_(-1, torch.where(is_query, row, m).to(torch.int64), val)
    return torch.where(query_valid, out[..., :m], -1)


def _dense_row_canvas(keys, valid, volume):
    """(V + 1,) int32 canvas holding the active row index at each occupied
    cell (-1 empty). Invalid rows all write the overflow slot, which is
    then reset to -1: it answers every out-of-bounds or invalid query."""
    n = keys.shape[0]
    idx = torch.where(valid, keys, volume).to(torch.int64)
    canvas = torch.full((volume + 1,), -1, dtype=torch.int32,
                        device=keys.device)
    canvas[idx] = torch.arange(n, dtype=torch.int32, device=keys.device)
    canvas[volume] = -1
    return canvas


def _axes(v):
    """An int or a 3-sequence as a tuple of three ints."""
    return (int(v),) * 3 if np.ndim(v) == 0 else tuple(int(x) for x in v)


def _window_offsets(kernel, padding):
    """``j - padding`` for every kernel tap ``j`` in raster (ij) order,
    (K, 3) int32 numpy: the input offsets of an output site at stride
    times its coordinates."""
    kernel, padding = _axes(kernel), _axes(padding)
    grids = np.meshgrid(*(np.arange(k) - p for k, p in zip(kernel, padding)),
                        indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1).astype(np.int32)


def _offsets_on(kernel, padding, device):
    """:func:`_window_offsets` as an int32 tensor on ``device``."""
    return torch.as_tensor(_window_offsets(kernel, padding), device=device)


def conv_out_grid(grid, kernel, stride, padding):
    """The output extent of a strided sparse conv on ``grid``, per axis
    ``(n + 2p - k) // s + 1``."""
    return tuple((n + 2 * p - k) // s + 1 for n, k, s, p in
                 zip(grid, _axes(kernel), _axes(stride), _axes(padding)))


def _neighbor_map_impl(query_coords, query_valid, ref_keys, ref_valid, grid,
                       kernel, padding, stride=1):
    """Query site q looks up the input row at ``q * stride + off`` for
    every offset ``off`` of :func:`_window_offsets` (``kernel``,
    ``padding`` and ``stride`` each an int or one a axis): (Nq, K) int32,
    -1 where absent."""
    volume = int(np.prod(grid))
    dev = query_coords.device
    offs = _offsets_on(kernel, padding, dev)
    if np.ndim(stride):
        stride = _const(tuple(stride), dev)
    gmax = _const(tuple(grid), dev)
    qc = query_coords.to(torch.int32)[:, None, :] * stride + offs[None]
    inb = ((qc >= 0) & (qc < gmax)).all(dim=-1) & query_valid[:, None]
    d0, d1, d2 = grid
    qk = qc[..., 0] * (d1 * d2) + qc[..., 1] * d2 + qc[..., 2]
    if volume > _DENSE_CANVAS_MAX_CELLS:
        # one join per kernel offset, (K, Nq) -> (Nq, K)
        with span("sparse.sort_join"):
            return match_sorted(ref_keys, ref_valid, qk.T,
                                inb.T).T.contiguous()
    canvas = _dense_row_canvas(ref_keys, ref_valid, volume)
    return canvas[torch.where(inb, qk, volume).to(torch.int64)]


def build_neighbor_map(coords, valid, grid, kernel_size=3):
    """Neighbour map of a submanifold conv on active sites.

    :param coords: (N, 3) int active-voxel coords (padded rows arbitrary)
    :param valid: (N,) bool active mask
    :param grid: (D0, D1, D2) grid shape
    :returns: (N, K) int32 input row of each kernel-offset neighbour, -1
        where absent, out of bounds or invalid
    """
    keys = linearize(coords, grid)
    return _neighbor_map_impl(coords, valid, keys, valid, grid, kernel_size,
                              kernel_size // 2)


def build_neighbor_map_strided(out_coords, out_valid, in_coords, in_valid,
                               grid, stride=2, kernel_size=3, padding=None):
    """Neighbour map of a strided sparse conv: for each OUTPUT site, the
    input row at ``out * stride + off`` per kernel offset (``grid`` is the
    INPUT grid). Returns (M, K) int32, -1 where absent.

    Without ``padding`` the kernel is the cubic ``kernel_size`` centred on
    ``out * stride``. With it, ``kernel_size``, ``stride`` and ``padding``
    may each be an int or one a axis, and the offsets are ``j - padding``
    for the kernel's taps ``j`` in raster order: spconv's window."""
    in_keys = linearize(in_coords, grid)
    if padding is None:
        padding = kernel_size // 2
    return _neighbor_map_impl(out_coords, out_valid, in_keys, in_valid,
                              grid, kernel_size, padding, stride=stride)


def subm_conv_apply(features, nbr, weights, valid, symmetric=False):
    """Sparse conv on a neighbour map:
    ``out[n] = valid[n] * sum_k weights[k]^T features[nbr[n, k]]``.

    The weights are cast to the features' dtype, the sum accumulates in
    float32 and the output comes back in the features' dtype. A CUDA
    tensor launches K5 (submanifold and strided maps alike; Nq may differ
    from N); a CPU tensor runs K5's plain version. Gradients flow through
    :class:`~d3d_tpu_torch.ops.sparse_conv_cuda.SubmConv`, the JAX module's
    custom VJP: the weights' through K6, the features' through K5 again
    (``symmetric``) or a scatter-add.

    :param features: (N, C) active-site features (padded rows zero); a
        tensor stays on its device, anything else goes to CUDA, and the
        other operands follow it
    :param nbr: (Nq, K) int32 neighbour map, or its rule book from
        :func:`prepare_neighbor_map` (built once per map; a bare map gets
        its rule book built in the call)
    :param weights: (K, C, C') kernel
    :param valid: (Nq,) bool output-site mask
    :param symmetric: True when ``nbr`` is a submanifold map (Nq == N, the
        query sites are the input sites): the features' gradient then runs
        through K5 with mirrored offsets instead of a scatter-add
    :returns: (Nq, C') features
    """
    features = as_tensor(features)
    weights, valid = (as_tensor(t, device=features.device)
                      for t in (weights, valid))
    if not isinstance(nbr, RuleBook):
        nbr = as_tensor(nbr, device=features.device)
    return SubmConv.apply(features, nbr, weights, valid, symmetric)


def downsample_coords(coords, valid, grid, stride=2, max_out=None,
                      kernel=None, padding=0):
    """Active sites of a stride-``s`` sparse conv output: the unique
    ``coords // s`` in ascending key order, capped to the first ``max_out``
    (default N) keys.

    With ``kernel`` (and ``stride``, ``padding``: each an int or one a
    axis) the output rule is spconv's instead: a site ``o`` of the
    :func:`conv_out_grid` is active when its window ``[s*o - p, s*o - p +
    k - 1]`` holds an active input on every axis.

    :returns: (out_coords (M, 3) int32, out_valid (M,) bool). Rows past
        the last unique site are padding in no meaningful order.
    """
    n = coords.shape[0]
    m = max_out or n
    if kernel is None:
        og = tuple(-(-g // stride) for g in grid)
        down = torch.div(coords.to(torch.int32), stride,
                         rounding_mode="floor")
    else:
        # every (input, tap) pair names the output whose window puts the
        # input at that tap, where the stride divides it and it is inside
        og = conv_out_grid(grid, kernel, stride, padding)
        dev = coords.device
        st = _const(_axes(stride), dev)
        num = (coords.to(torch.int32)[:, None, :]
               - _offsets_on(kernel, padding, dev)[None])
        down = torch.div(num, st, rounding_mode="floor")
        hit = ((num - down * st == 0) & (down >= 0) & (down < _const(og, dev))
               ).all(dim=-1) & valid[:, None]
        down, valid = down.reshape(-1, 3), hit.reshape(-1)
    keys = torch.where(valid, linearize(down, og), _BIG_KEY)
    sk, perm = torch.sort(keys, stable=True)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=sk.device),
                       sk[1:] != sk[:-1]]) & (sk < _BIG_KEY)
    # compact the first row of each key to the front, keys ascending
    pos = torch.arange(keys.shape[0], dtype=torch.int32, device=sk.device)
    _, perm2 = torch.sort(torch.where(first, pos, _BIG_KEY), stable=True)
    rows = perm[perm2][:m]
    return down[rows], first[perm2][:m]


def sparse_to_dense(features, coords, valid, grid):
    """Densify (N, C) site features to (D0, D1, D2, C), invalid rows
    dropped. Valid coords must be unique."""
    d0, d1, d2 = grid
    volume = d0 * d1 * d2
    flat = torch.where(valid, linearize(coords, grid), volume)
    canvas = features.new_zeros((volume + 1, features.shape[1]))
    canvas.index_add_(0, flat.to(torch.int64),
                      features * valid[:, None].to(features.dtype))
    return canvas[:-1].reshape(d0, d1, d2, features.shape[1])

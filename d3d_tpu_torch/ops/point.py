"""Point-set operations (port of part of ``d3d_tpu.ops.point``).

Ported so far: :func:`farthest_point_sampling`, which
``VoxelGenerator``'s ``farthest_sampling`` filter runs. ``aligned_scatter``
and ``nearest_neighbor`` are not ported yet.
"""

import torch

__all__ = ["farthest_point_sampling"]


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

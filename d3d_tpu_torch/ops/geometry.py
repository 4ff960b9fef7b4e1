"""Array-of-structures box geometry (port of ``d3d_tpu.ops.geometry``).

Boxes are ``(..., 5)`` tensors ``[x, y, w, h, r]``; polygons are
``(..., K, 2)``. Every function broadcasts over the leading dimensions and
is differentiable by autograd: the intersection of two convex quads is
the (at most 8) valid vertices among 24 fixed candidates (16 edge
crossings, 8 contained corners), ordered by angle around their centroid
and summed by the shoelace formula; the order and the masks carry no
gradient, the gathered coordinates do (``detach`` stands for
``lax.stop_gradient``). The tolerances, the candidate order and the
stable sorts are the JAX module's, so the two agree to rounding.
Float64 corners take :func:`d3d_tpu_torch.ops.trig.sincos`.
"""

import torch

from . import trig

__all__ = [
    "box2poly",
    "poly_area",
    "quad_intersection",
    "intersect_area",
    "convex_hull_area",
    "aabox_iou",
    "rbox_iou",
    "rbox_giou",
    "rbox_diou",
    "poly_contains",
    "poly_signed_distance",
    "seg1d_intersection",
    "box3dr_iou_pair",
    "box3d_iou_pair",
]


def _max(x, c):
    """``jnp.maximum(x, c)`` for a constant ``c``: at a tie the gradient
    splits in half, as in JAX (``torch.clamp_min`` would pass all of it)."""
    return torch.maximum(x, x.new_full((), c))


def _min(x, c):
    return torch.minimum(x, x.new_full((), c))


def _cross2(a, b):
    """2D cross product z-component: a.x*b.y - a.y*b.x (last dim = 2)."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def box2poly(boxes):
    """``(..., 5)`` xywhr boxes -> ``(..., 4, 2)`` CCW corner polygons,
    starting at (-w/2, -h/2) in the box frame."""
    x, y, w, h, r = (boxes[..., i] for i in range(5))
    dx, dy = w * 0.5, h * 0.5
    lx = torch.stack([-dx, dx, dx, -dx], dim=-1)
    ly = torch.stack([-dy, -dy, dy, dy], dim=-1)
    s, c = trig.sincos(r)
    s, c = s[..., None], c[..., None]
    px = c * lx - s * ly + x[..., None]
    py = s * lx + c * ly + y[..., None]
    return torch.stack([px, py], dim=-1)


def poly_area(verts):
    """Shoelace area of CCW polygons ``(..., K, 2)`` (signed; CCW
    positive)."""
    nxt = torch.roll(verts, -1, dims=-2)
    return 0.5 * _cross2(verts, nxt).sum(dim=-1)


def _edge_pairs(poly):
    """(..., 4, 2) -> start (..., 4, 2), end (..., 4, 2) of each edge."""
    return poly, torch.roll(poly, -1, dims=-2)


def poly_contains(poly, points, eps=0.0):
    """Test points inside CCW convex polygons.

    :param poly: ``(..., K, 2)`` convex CCW polygons
    :param points: ``(..., 2)`` query points (broadcast against poly batch)
    :return: boolean ``(...)``
    """
    a, b = _edge_pairs(poly)
    # cross(edge, p - a) >= 0 for all edges
    side = _cross2(b - a, points[..., None, :] - a)
    return (side >= -eps).all(dim=-1)


def quad_intersection(poly1, poly2):
    """All candidate vertices of the intersection of two convex CCW quads.

    :param poly1: ``(..., 4, 2)``
    :param poly2: ``(..., 4, 2)``
    :return: ``(pts, mask)`` with ``pts (..., 24, 2)`` and ``mask
        (..., 24)``: the valid points are the vertices of the (convex)
        intersection polygon, possibly with duplicates where the quads
        touch.
    """
    batch = torch.broadcast_shapes(poly1.shape[:-2], poly2.shape[:-2])
    poly1 = poly1.expand(batch + poly1.shape[-2:])
    poly2 = poly2.expand(batch + poly2.shape[-2:])
    a, b = _edge_pairs(poly1)
    c, d = _edge_pairs(poly2)

    # 16 edge-edge crossings: edges of poly1 along -3, of poly2 along -2
    a_ = a[..., :, None, :]
    b_ = b[..., :, None, :]
    c_ = c[..., None, :, :]
    d_ = d[..., None, :, :]
    r = b_ - a_
    s = d_ - c_
    denom = _cross2(r, s)
    ac = c_ - a_
    # relative parallelism cutoff: |r x s| = |r||s| sin(angle)
    par_eps = 1e-12 if denom.dtype == torch.float64 else 1e-4
    rs_scale = torch.sqrt(_max((r * r).sum(dim=-1) * (s * s).sum(dim=-1),
                               1e-30))
    ok = denom.abs() > par_eps * rs_scale
    denom_safe = torch.where(ok, denom, 1.0)
    t = torch.where(ok, _cross2(ac, s) / denom_safe, -1.0)
    u = torch.where(ok, _cross2(ac, r) / denom_safe, -1.0)
    hit = ok & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    xpt = a_ + t[..., None] * r
    lead = xpt.shape[:-3]
    xpt = xpt.reshape(lead + (16, 2))
    hit = hit.reshape(lead + (16,))

    # corners of each quad inside the other, within a relative tolerance
    # (touching boxes put corners exactly on the other's boundary)
    scale = torch.cat([poly1, poly2], dim=-2).abs().amax(dim=(-1, -2))
    eps = 1e-9 if poly1.dtype == torch.float64 else 1e-5
    ceps = ((scale + 1.0) * eps)[..., None, None]
    in12 = poly_contains(poly2[..., None, :, :], poly1, ceps)
    in21 = poly_contains(poly1[..., None, :, :], poly2, ceps)

    pts = torch.cat([xpt, poly1, poly2], dim=-2)
    mask = torch.cat([hit, in12, in21], dim=-1)
    pts = torch.where(mask[..., None], pts, 0.0)
    return pts, mask


def _order_by_angle(pts, mask):
    """Sort masked points CCW by angle around their centroid (a stable
    sort, as ``jnp.argsort``: tied angles of duplicate points keep their
    candidate order). Valid points come first in boundary order; every
    invalid slot holds the first valid point."""
    n = torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1)
    center = (pts * mask[..., None]).sum(dim=-2, keepdim=True) / n[..., None]
    rel = (pts - center).detach()  # sort keys never need gradients
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    big = torch.finfo(ang.dtype).max
    key = torch.where(mask, ang, big)
    order = torch.sort(key, dim=-1, stable=True).indices
    pts_s = torch.take_along_dim(pts, order[..., None], dim=-2)
    mask_s = torch.take_along_dim(mask, order, dim=-1)
    first = pts_s[..., 0:1, :]
    pts_s = torch.where(mask_s[..., None], pts_s, first)
    return pts_s, mask_s


def intersect_area(poly1, poly2):
    """Intersection area of two convex CCW quads, batched.
    (..., 4, 2) x2 -> (...)."""
    pts, mask = quad_intersection(poly1, poly2)
    pts, mask = _order_by_angle(pts, mask)
    # recenter for numerical stability (area is translation invariant)
    n = torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1)
    c = (pts * mask[..., None]).sum(dim=-2, keepdim=True) / n[..., None]
    area = poly_area(pts - c.detach())
    return _max(area, 0.0)


def _half_hull(pts, batch, n):
    """One monotone chain (the lower hull of ``pts`` in sorted order):
    (sum of cross(v_i, v_i+1) over the chain, its first point, its last)."""
    stack = pts.new_zeros(batch + (n, 2))
    size = torch.zeros(batch, dtype=torch.int64, device=pts.device)
    slot = torch.arange(n, device=pts.device)
    for t in range(n):
        pt = pts[..., t, :]
        for _ in range(n):
            top = torch.take_along_dim(
                stack, torch.clamp_min(size - 1, 0)[..., None, None],
                dim=-2)[..., 0, :]
            sec = torch.take_along_dim(
                stack, torch.clamp_min(size - 2, 0)[..., None, None],
                dim=-2)[..., 0, :]
            bad = (size >= 2) & (_cross2(top - sec, pt - sec) <= 0)
            size = torch.where(bad, size - 1, size)
        onehot = (slot == size[..., None])[..., None]
        stack = torch.where(onehot, pt[..., None, :], stack)
        size = size + 1
    # invalid tail slots repeat the last point
    last = torch.take_along_dim(stack, (size - 1)[..., None, None], dim=-2)
    valid = slot < size[..., None]
    v = torch.where(valid[..., None], stack, last)
    nxt = torch.cat([v[..., 1:, :], last], dim=-2)
    return _cross2(v, nxt).sum(dim=-1), v[..., 0, :], last[..., 0, :]


def convex_hull_area(points):
    """Area of the convex hull of ``(..., N, 2)`` point sets (N small):
    batched Andrew monotone chain with a fixed-size stack, every push and
    pop a masked vector step."""
    n = points.shape[-2]
    batch = points.shape[:-2]
    # lexicographic order by (x, y) as two stable sorts; no gradient
    keys = points.detach()
    order_y = torch.sort(keys[..., 1], dim=-1, stable=True).indices
    x_by_y = torch.take_along_dim(keys[..., 0], order_y, dim=-1)
    order_x = torch.sort(x_by_y, dim=-1, stable=True).indices
    order = torch.take_along_dim(order_y, order_x, dim=-1)
    p = torch.take_along_dim(points, order[..., None], dim=-2)

    lo_sum, lo_first, lo_last = _half_hull(p, batch, n)
    hi_sum, hi_first, hi_last = _half_hull(torch.flip(p, dims=(-2,)), batch,
                                           n)
    # close the polygon: the lower chain runs leftmost -> rightmost, the
    # upper one back; the two joining edges
    join = _cross2(lo_last, hi_first) + _cross2(hi_last, lo_first)
    area = 0.5 * (lo_sum + hi_sum + join)
    return _max(area, 0.0)


def _union(area1, area2, inter, eps=1e-12):
    return _max(area1 + area2 - inter, eps)


def aabox_iou(boxes1, boxes2):
    """Axis-aligned IoU: each box is replaced by the axis-aligned bounding
    box of its rotated corners. Elementwise with broadcasting."""
    p1, p2 = box2poly(boxes1), box2poly(boxes2)
    lo1, hi1 = p1.amin(dim=-2), p1.amax(dim=-2)
    lo2, hi2 = p2.amin(dim=-2), p2.amax(dim=-2)
    iwh = _max(torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2), 0.0)
    inter = iwh[..., 0] * iwh[..., 1]
    a1 = (hi1 - lo1).prod(dim=-1)
    a2 = (hi2 - lo2).prod(dim=-1)
    return inter / _union(a1, a2, inter)


def rbox_iou(boxes1, boxes2):
    """Rotated-box IoU, elementwise with broadcasting."""
    inter = intersect_area(box2poly(boxes1), box2poly(boxes2))
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    return inter / _union(a1, a2, inter)


def _broadcast_polys(p1, p2):
    batch = torch.broadcast_shapes(p1.shape[:-2], p2.shape[:-2])
    return p1.expand(batch + p1.shape[-2:]), p2.expand(batch + p2.shape[-2:])


def rbox_giou(boxes1, boxes2):
    """Rotated-box GIoU: ``iou - (hull - union) / hull`` with the convex
    hull of both quads."""
    p1, p2 = _broadcast_polys(box2poly(boxes1), box2poly(boxes2))
    inter = intersect_area(p1, p2)
    a1 = boxes1[..., 2] * boxes1[..., 3]
    a2 = boxes2[..., 2] * boxes2[..., 3]
    union = _union(a1, a2, inter)
    hull = torch.maximum(convex_hull_area(torch.cat([p1, p2], dim=-2)),
                         union)
    return inter / union - (hull - union) / hull


def rbox_diou(boxes1, boxes2):
    """Rotated-box DIoU: ``iou - d^2/c^2`` with d the centre distance and c
    the diagonal of the axis-aligned box enclosing both quads."""
    iou = rbox_iou(boxes1, boxes2)
    d2 = ((boxes1[..., 0:2] - boxes2[..., 0:2]) ** 2).sum(dim=-1)
    p = torch.cat(_broadcast_polys(box2poly(boxes1), box2poly(boxes2)),
                  dim=-2)
    lo, hi = p.amin(dim=-2), p.amax(dim=-2)
    c2 = _max(((hi - lo) ** 2).sum(dim=-1), 1e-12)
    return iou - d2 / c2


def poly_signed_distance(poly, points):
    """Signed distance from points to the boundary of convex CCW polygons:
    positive inside, negative outside; the gradient flows through the
    nearest edge only.

    :param poly: ``(..., K, 2)``
    :param points: ``(..., 2)`` broadcastable
    """
    a, b = _edge_pairs(poly)
    p = points[..., None, :]
    ab = b - a
    ap = p - a
    len2 = _max((ab * ab).sum(dim=-1), 1e-30)
    t = _min(_max((ap * ab).sum(dim=-1) / len2, 0.0), 1.0)
    proj = a + t[..., None] * ab
    diff = p - proj
    # jnp.linalg.norm's formula, sqrt of the sum of squares
    d = torch.sqrt((diff * diff).sum(dim=-1))
    dmin = d.amin(dim=-1)
    inside = (_cross2(ab, ap) >= 0).all(dim=-1)
    return torch.where(inside, dmin, -dmin)


def seg1d_intersection(c1, w1, c2, w2, eps=1e-6):
    """1D segment intersection / union lengths for (center, width)
    segments: ``(i, u)`` with i clamped at 0 and u at ``eps``."""
    s1max, s1min = c1 + w1 * 0.5, c1 - w1 * 0.5
    s2max, s2min = c2 + w2 * 0.5, c2 - w2 * 0.5
    i = _max(torch.minimum(s1max, s2max) - torch.maximum(s1min, s2min), 0.0)
    u = _max(torch.maximum(s1max, s2max) - torch.minimum(s1min, s2min), eps)
    return i, u


def _bev(b):
    return torch.cat([b[..., 0:2], b[..., 3:5], b[..., 6:7]], dim=-1)


def box3dr_iou_pair(b1, b2):
    """Rotated 3D box IoU = BEV rotated IoU x z-interval IoU, for
    ``(..., 7)`` boxes ``[x, y, z, lx, ly, lz, rz]``."""
    from . import geometry_soa

    iou2d = geometry_soa.rbox_iou(_bev(b1), _bev(b2))
    zi, zu = seg1d_intersection(b1[..., 2], b1[..., 5], b2[..., 2],
                                b2[..., 5])
    return iou2d * (zi / zu)


def box3d_iou_pair(b1, b2):
    """Axis-aligned 3D box IoU (the axis-aligned box of the rotated BEV
    footprint x the z interval)."""
    iou2d = aabox_iou(_bev(b1), _bev(b2))
    zi, zu = seg1d_intersection(b1[..., 2], b1[..., 5], b2[..., 2],
                                b2[..., 5])
    return iou2d * (zi / zu)

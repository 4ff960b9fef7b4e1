"""Structure-of-arrays rotated-IoU math (port of ``d3d_tpu.ops.geometry_soa``).

Every candidate coordinate is its own tensor over the broadcast pair batch,
and the 24 intersection candidates are ordered around their centroid by a
fixed Batcher odd-even merge-sort network of elementwise compare-selects —
no gathers, no argsort. The same math, tolerances, diamond-angle keys and
sort network as the JAX module, so the two agree to rounding (f32) or to
1e-10 (f64); gradients flow through autograd exactly where they flow
through JAX's (``detach`` stands for ``lax.stop_gradient``).

This module is also the plain PyTorch version of the CUDA kernel K1
(:mod:`d3d_tpu_torch.ops.geometry_cuda`): ``_rbox_iou_matrix_plain`` is
what a CPU tensor gets and what ``chip_smoke.py`` holds the kernel to.
"""

import torch

__all__ = ["rbox_iou", "rbox_iou_matrix", "intersect_area"]

_NCAND = 24
_NSORT = 32  # power-of-two base size for the Batcher network


def _batcher_pairs(n):
    """Comparator index pairs of Batcher's odd-even mergesort (n = 2^k)."""
    pairs = []

    def merge(lo, hi, r):
        step = r * 2
        if step < hi - lo:
            merge(lo, hi, step)
            merge(lo + r, hi, step)
            for i in range(lo + r, hi - r, step):
                pairs.append((i, i + r))
        else:
            pairs.append((lo, lo + r))

    def sort(lo, hi):
        if hi - lo >= 2:
            mid = lo + (hi - lo) // 2
            sort(lo, mid)
            sort(mid, hi)
            merge(lo, hi, 1)

    sort(0, n)
    return pairs


# Prune the 32-wide network down to the 24 real slots: every comparator is
# ascending (min to the lower index), so +inf-keyed padding slots can never
# hand their key down and comparators touching an index >= 24 are no-ops
# (191 -> 132 comparators). The CUDA kernel K1 unrolls this same list from a
# header generated at build time (ops/_build.py).
_PAIRS24 = [(i, j) for (i, j) in _batcher_pairs(_NSORT) if j < _NCAND]

# invalid/padding sort key: the diamond angle below lies in (-2, 2]
_BIGKEY = 5.0
_KEYCUT = 4.0


def _diamond_angle(dx, dy):
    """Monotone surrogate of atan2(dy, dx) on (-pi, pi] -> (-2, 2]: the
    candidate ordering needs a consistent angular ORDER around the
    centroid, not the angle. dx = dy = 0 maps to 0 (degenerate
    single-vertex case, area is 0 regardless of order)."""
    s = dx.abs() + dy.abs()
    t = dy / torch.where(s > 0, s, 1.0)
    return torch.where(dx >= 0, t, torch.where(dy >= 0, 2.0 - t, -2.0 - t))


def _corners(x, y, w, h, r):
    """4 CCW corners as lists of coordinate tensors."""
    dx, dy = w * 0.5, h * 0.5
    c, s = torch.cos(r), torch.sin(r)
    lx = (-dx, dx, dx, -dx)
    ly = (-dy, -dy, dy, dy)
    cx = [c * a - s * b + x for a, b in zip(lx, ly)]
    cy = [s * a + c * b + y for a, b in zip(lx, ly)]
    return cx, cy


def _inside(qx, qy, px, py, eps):
    """Point (px, py) inside CCW quad (lists of 4 coord tensors)."""
    ok = None
    for i in range(4):
        j = (i + 1) % 4
        ex, ey = qx[j] - qx[i], qy[j] - qy[i]
        side = ex * (py - qy[i]) - ey * (px - qx[i])
        c = side >= -eps
        ok = c if ok is None else (ok & c)
    return ok


def intersect_area(b1, b2):
    """Intersection area of rotated boxes; ``b1``/``b2`` are ``(..., 5)``
    broadcastable xywhr tensors; returns ``(...)``."""
    x1, y1, w1, h1, r1 = (b1[..., i] for i in range(5))
    x2, y2, w2, h2, r2 = (b2[..., i] for i in range(5))
    shape = torch.broadcast_shapes(x1.shape, x2.shape)
    dt = torch.promote_types(b1.dtype, b2.dtype)
    f64 = dt == torch.float64

    ax, ay = _corners(x1, y1, w1, h1, r1)
    bx, by = _corners(x2, y2, w2, h2, r2)

    # relative containment tolerance
    scale = None
    for arr in ax + ay + bx + by:
        a = arr.abs()
        scale = a if scale is None else torch.maximum(scale, a)
    ceps = (scale + 1.0) * (1e-9 if f64 else 1e-5)

    px, py, valid = [], [], []

    # --- 16 edge-edge crossings -------------------------------------------
    par_eps = 1e-12 if f64 else 1e-4
    for i in range(4):
        i2 = (i + 1) % 4
        rx, ry = ax[i2] - ax[i], ay[i2] - ay[i]
        for j in range(4):
            j2 = (j + 1) % 4
            sx, sy = bx[j2] - bx[j], by[j2] - by[j]
            denom = rx * sy - ry * sx
            # relative parallelism cutoff (|r x s| = |r||s| sin angle)
            rs = torch.sqrt(torch.clamp_min(
                (rx * rx + ry * ry) * (sx * sx + sy * sy), 1e-30))
            ok = denom.abs() > par_eps * rs
            dsafe = torch.where(ok, denom, 1.0)
            acx, acy = bx[j] - ax[i], by[j] - ay[i]
            t = torch.where(ok, (acx * sy - acy * sx) / dsafe, -1.0)
            u = torch.where(ok, (acx * ry - acy * rx) / dsafe, -1.0)
            hit = ok & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
            px.append(torch.where(hit, ax[i] + t * rx, 0.0))
            py.append(torch.where(hit, ay[i] + t * ry, 0.0))
            valid.append(hit)

    # --- corners of each quad inside the other -----------------------------
    for i in range(4):
        ins = _inside(bx, by, ax[i], ay[i], ceps)
        px.append(torch.where(ins, ax[i], 0.0))
        py.append(torch.where(ins, ay[i], 0.0))
        valid.append(ins)
    for j in range(4):
        ins = _inside(ax, ay, bx[j], by[j], ceps)
        px.append(torch.where(ins, bx[j], 0.0))
        py.append(torch.where(ins, by[j], 0.0))
        valid.append(ins)

    # --- order by angle around the centroid via a sorting network ----------
    vf = [v.to(dt) for v in valid]
    cnt = sum(vf)
    cnt_safe = torch.clamp_min(cnt, 1.0)
    cx = sum(x * v for x, v in zip(px, vf)) / cnt_safe
    cy = sum(y * v for y, v in zip(py, vf)) / cnt_safe

    # validity rides in the key (invalid -> _BIGKEY, recovered after the
    # sort as key < _KEYCUT), so the network carries 3 values per slot
    keys, sx_, sy_ = [], [], []
    for k in range(_NCAND):
        ang = _diamond_angle((px[k] - cx).detach(), (py[k] - cy).detach())
        keys.append(torch.where(valid[k], ang, _BIGKEY))
        sx_.append(px[k])
        sy_.append(py[k])

    for i, j in _PAIRS24:
        swap = keys[i] > keys[j]
        keys[i], keys[j] = (torch.minimum(keys[i], keys[j]),
                            torch.maximum(keys[i], keys[j]))
        sx_[i], sx_[j] = (torch.where(swap, sx_[j], sx_[i]),
                          torch.where(swap, sx_[i], sx_[j]))
        sy_[i], sy_[j] = (torch.where(swap, sy_[j], sy_[i]),
                          torch.where(swap, sy_[i], sy_[j]))

    # invalid slots collapse onto the first (valid) vertex so the cyclic
    # shoelace is exact (zero-length edges)
    fx, fy = sx_[0], sy_[0]
    cxd, cyd = cx.detach(), cy.detach()
    for k in range(_NCAND):
        ok = keys[k] < _KEYCUT
        sx_[k] = torch.where(ok, sx_[k], fx) - cxd
        sy_[k] = torch.where(ok, sy_[k], fy) - cyd

    area = torch.zeros(shape, dtype=dt, device=b1.device)
    for k in range(_NCAND):
        k2 = (k + 1) % _NCAND
        area = area + (sx_[k] * sy_[k2] - sy_[k] * sx_[k2])
    return torch.clamp_min(0.5 * area, 0.0)


def rbox_iou(b1, b2):
    """Rotated-box IoU, elementwise over broadcast batch dims (the path
    used by NMS, matchers and the IoU losses)."""
    inter = intersect_area(b1, b2)
    a1 = b1[..., 2] * b1[..., 3]
    a2 = b2[..., 2] * b2[..., 3]
    union = torch.clamp_min(a1 + a2 - inter, 1e-12)
    return inter / union


def rbox_iou_matrix(b1, b2, pair_budget=1 << 22):
    """(N, M) rotated-IoU matrix; float32 CUDA tensors go to the CUDA
    kernel K1 (forward-only — NMS and matching never differentiate through
    the matrix), anything else (CPU, float64) to the row-blocked plain
    version."""
    if b1.is_cuda and torch.promote_types(b1.dtype, b2.dtype) == torch.float32:
        from . import geometry_cuda
        return geometry_cuda.rbox_iou_matrix(b1, b2)
    return _rbox_iou_matrix_plain(b1, b2, pair_budget=pair_budget)


def _rbox_iou_matrix_plain(b1, b2, pair_budget=1 << 22):
    """(N, 5) x (M, 5) -> (N, M) IoU matrix with bounded peak memory: the
    elementwise chain keeps ~128 live pair-shaped temporaries, so rows are
    processed in chunks of ``pair_budget / M`` pairs."""
    n, m = b1.shape[0], b2.shape[0]
    rows = max(1, pair_budget // max(m, 1))
    if n <= rows:
        return rbox_iou(b1[:, None, :], b2[None, :, :])
    return torch.cat([rbox_iou(b1[i:i + rows, None, :], b2[None, :, :])
                      for i in range(0, n, rows)])

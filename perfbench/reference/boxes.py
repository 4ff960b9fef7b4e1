"""Plain box arithmetic of the anchor detectors: the residual decoding,
the rotated bird's-eye IoU (polygon clipping in float64 numpy) and greedy
NMS. Written from the PointPillars paper (Lang et al., CVPR 2019, Sec.
3.3: SECOND's residuals, yaw by the sine of its residual and a direction
classifier) and the greedy NMS of SSD; nothing here imports the program.
"""

import math

import numpy as np
import torch

__all__ = ["anchors", "decode", "corners", "rotated_iou", "greedy_nms",
           "select"]


def anchors(model):
    """(W * H * A, 7) float32 anchors [x, y, z, l, w, h, yaw] at the
    centres of the ``model["grid"]`` cells, the anchors of one cell
    adjacent (sizes outer, rotations inner), cells x-major."""
    b = model["bounds"]
    w, h = model["grid"][0], model["grid"][1]
    vx, vy = (b[1] - b[0]) / w, (b[3] - b[2]) / h
    xs = (np.arange(w) + 0.5) * vx + b[0]
    ys = (np.arange(h) + 0.5) * vy + b[2]
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    cells = np.stack([gx, gy], -1).reshape(-1, 2)
    per = []
    for size in model["anchor_sizes"]:
        for rot in model["anchor_rotations"]:
            a = np.zeros((len(cells), 7), np.float32)
            a[:, 0:2] = cells
            a[:, 2] = model["anchor_z"]
            a[:, 3:6] = size
            a[:, 6] = rot
            per.append(a)
    return torch.from_numpy(np.stack(per, 1).reshape(-1, 7))


def decode(anc, deltas, dir_logits):
    """Boxes from residuals: centre offsets in units of the anchor's
    diagonal (z: its height), log size ratios, yaw = asin(residual)
    (clipped inside (-1, 1)) + anchor yaw + pi where the direction
    classifier says the heading points backwards."""
    diag = torch.sqrt(anc[:, 3] ** 2 + anc[:, 4] ** 2)
    yaw = torch.arcsin(torch.clamp(deltas[:, 6], -1 + 1e-4, 1 - 1e-4))
    yaw = yaw + anc[:, 6] + dir_logits.argmax(dim=-1).to(yaw.dtype) * math.pi
    return torch.stack([
        deltas[:, 0] * diag + anc[:, 0], deltas[:, 1] * diag + anc[:, 1],
        deltas[:, 2] * anc[:, 5] + anc[:, 2],
        torch.exp(deltas[:, 3]) * anc[:, 3],
        torch.exp(deltas[:, 4]) * anc[:, 4],
        torch.exp(deltas[:, 5]) * anc[:, 5], yaw], dim=-1)


def corners(bev):
    """(N, 4, 2) counter-clockwise corners of (N, 5) [x, y, l, w, yaw]
    float64 boxes (l along the heading)."""
    x, y, l, w, r = (bev[:, i] for i in range(5))
    c, s = np.cos(r), np.sin(r)
    dx = np.array([0.5, -0.5, -0.5, 0.5])
    dy = np.array([0.5, 0.5, -0.5, -0.5])
    px = x[:, None] + l[:, None] * dx * c[:, None] - w[:, None] * dy * s[:, None]
    py = y[:, None] + l[:, None] * dx * s[:, None] + w[:, None] * dy * c[:, None]
    return np.stack([px, py], -1)


def _clip(poly, n, a, b):
    """Sutherland-Hodgman: keep the part of each polygon (P, 8, 2) with
    ``n`` (P,) vertices left of the directed edge a -> b (P, 2 each)."""
    p = poly.shape[0]
    ex, ey = (b - a)[:, 0], (b - a)[:, 1]
    side = (ex[:, None] * (poly[..., 1] - a[:, None, 1])
            - ey[:, None] * (poly[..., 0] - a[:, None, 0]))   # >= 0 inside
    out = np.zeros_like(poly)
    cnt = np.zeros(p, np.int64)
    rows = np.arange(p)
    for i in range(poly.shape[1]):
        live = i < n
        j = np.where(i + 1 < n, i + 1, 0)
        cur, nxt = poly[rows, i], poly[rows, j]
        sc, sn = side[rows, i], side[rows, j]
        keep = live & (sc >= 0)
        out[rows[keep], cnt[keep]] = cur[keep]
        cnt = cnt + keep
        cross = live & ((sc >= 0) != (sn >= 0))
        with np.errstate(divide="ignore", invalid="ignore"):
            t = sc / (sc - sn)
            pt = cur + t[:, None] * (nxt - cur)
        out[rows[cross], cnt[cross]] = pt[cross]
        cnt = cnt + cross
    return out, cnt


def _area(poly, n):
    x, y = poly[..., 0], poly[..., 1]
    idx = np.arange(poly.shape[1])
    nxt = np.where(idx[None, :] + 1 < n[:, None], idx[None, :] + 1, 0)
    xn = np.take_along_axis(x, nxt, 1)
    yn = np.take_along_axis(y, nxt, 1)
    live = idx[None, :] < n[:, None]
    return 0.5 * np.abs(np.sum(np.where(live, x * yn - xn * y, 0.0), 1))


def rotated_iou(a, b):
    """(N, M) float64 IoU of rotated bird's-eye boxes (N, 5) and (M, 5)
    [x, y, l, w, yaw]; pairs whose circumscribed circles are apart are 0
    without clipping."""
    a = np.asarray(a, np.float64).reshape(-1, 5)
    b = np.asarray(b, np.float64).reshape(-1, 5)
    out = np.zeros((len(a), len(b)))
    if not len(a) or not len(b):
        return out
    ra = 0.5 * np.hypot(a[:, 2], a[:, 3])
    rb = 0.5 * np.hypot(b[:, 2], b[:, 3])
    dist = np.hypot(a[:, None, 0] - b[None, :, 0], a[:, None, 1] - b[None, :, 1])
    ii, jj = np.nonzero(dist < ra[:, None] + rb[None, :])
    if not len(ii):
        return out
    ca, cb = corners(a)[ii], corners(b)[jj]
    poly = np.zeros((len(ii), 8, 2))
    poly[:, :4] = ca
    n = np.full(len(ii), 4)
    for e in range(4):
        poly, n = _clip(poly, n, cb[:, e], cb[:, (e + 1) % 4])
    inter = np.where(n >= 3, _area(poly, n), 0.0)
    union = a[ii, 2] * a[ii, 3] + b[jj, 2] * b[jj, 3] - inter
    out[ii, jj] = inter / np.maximum(union, 1e-12)
    return out


def greedy_nms(bev, scores, iou_threshold):
    """Keep mask of greedy NMS: boxes in descending score order (stable),
    each kept box suppresses every later one with IoU above the
    threshold."""
    order = np.argsort(-np.asarray(scores), kind="stable")
    iou = rotated_iou(bev[order], bev[order])
    keep = np.zeros(len(order), bool)
    alive = np.ones(len(order), bool)
    for i in range(len(order)):
        if alive[i]:
            keep[order[i]] = True
            alive[i + 1:] &= iou[i, i + 1:] <= iou_threshold
    return keep


def bev(boxes):
    """[x, y, l, w, yaw] columns of (N, 7) boxes, float64 numpy."""
    b = np.asarray(boxes, np.float64)
    return b[:, [0, 1, 3, 4, 6]]


def select(scores, boxes, top_k, iou_threshold, score_threshold):
    """The detector's selection on one frame's decoded anchors (numpy
    float scores (N,), boxes (N, 7)): top-k by score (stable), greedy NMS,
    then the score threshold. Returns the rows [score, x, y, z, l, w, h,
    yaw] of the kept boxes."""
    idx = np.argsort(-scores, kind="stable")[:top_k]
    keep = greedy_nms(bev(boxes[idx]), scores[idx], iou_threshold)
    keep &= scores[idx] >= score_threshold
    return np.concatenate([scores[idx][keep, None],
                           boxes[idx][keep].astype(np.float64)], 1)

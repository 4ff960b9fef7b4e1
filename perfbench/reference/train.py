"""Plain training arithmetic of the anchor detectors in PyTorch: anchor
targets, the loss, and AdamW with global-norm clipping on a one-cycle
learning rate. Written from the PointPillars paper (Sec. 3.2: focal loss
with alpha 0.25 and gamma 2, smooth-L1 residuals, a softmax direction
loss, weights 1, 2 and 0.2, each over the number of positive anchors) and
the configuration's recipe (OpenPCDet's ``adam_onecycle``: one-cycle
cosine from peak/10 up to the peak at 40% and down to peak/1000, AdamW
with betas (0.9, 0.999), epsilon 1e-8 outside the square root, weight
decay 0.01 added to the update, gradients clipped to a global norm of
10); nothing here imports the program.

Anchors match ground truth by the IoU of the axis-aligned boxes that
bound their rotated bird's-eye footprints: positive at 0.6 or more,
negative below 0.45, and each box's best anchor positive whatever its
IoU (while it overlaps one at all: the lowest anchor index on a tie, the
later box where two boxes pick one anchor).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["assign", "loss", "onecycle", "AdamW", "running_change",
           "leaf_gaps"]


def _bounds(boxes):
    """(N, 2) lower and (N, 2) upper corners of the axis-aligned boxes
    that bound the rotated footprints of (N, 7) float32 boxes, from the
    footprints' corners ``R (+-l/2, +-w/2) + centre``."""
    x, y, l, w, r = (boxes[:, i] for i in (0, 1, 3, 4, 6))
    dx, dy = l * 0.5, w * 0.5
    lx = torch.stack([-dx, dx, dx, -dx], -1)
    ly = torch.stack([-dy, -dy, dy, dy], -1)
    s, c = torch.sin(r)[:, None], torch.cos(r)[:, None]
    px = c * lx - s * ly + x[:, None]
    py = s * lx + c * ly + y[:, None]
    pts = torch.stack([px, py], -1)
    return pts.amin(dim=1), pts.amax(dim=1)


def _iou(a, b):
    """(N, M) IoU of the bounding boxes of (N, 7) and (M, 7) boxes."""
    lo1, hi1 = (t[:, None] for t in _bounds(a))
    lo2, hi2 = (t[None] for t in _bounds(b))
    iwh = (torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2)).clamp_min(0)
    inter = iwh[..., 0] * iwh[..., 1]
    a1, a2 = (hi1 - lo1).prod(-1), (hi2 - lo2).prod(-1)
    return inter / torch.clamp_min(a1 + a2 - inter, 1e-12)


def assign(anchors, gt, pos_iou, neg_iou):
    """Targets of one frame's (N, 7) anchors against (M, 7) boxes: (pos
    (N,), neg (N,), residuals (N, 7), direction class (N,))."""
    n = anchors.shape[0]
    iou = _iou(anchors, gt)                                # (N, M)
    best = iou.max(dim=1)
    pos = best.values >= pos_iou
    which = best.indices.clone()
    col = iou.max(dim=0)
    forced = torch.zeros(n, dtype=torch.bool, device=anchors.device)
    for m in range(gt.shape[0]):
        if col.values[m] > 0:
            a = int(col.indices[m])
            forced[a] = True
            if not pos[a]:           # a thresholded positive keeps its box
                which[a] = m         # later boxes win
    pos = pos | forced
    neg = (best.values < neg_iou) & ~pos
    g = gt[which]
    diag = torch.sqrt(anchors[:, 3] ** 2 + anchors[:, 4] ** 2)
    reg = torch.stack([
        (g[:, 0] - anchors[:, 0]) / diag, (g[:, 1] - anchors[:, 1]) / diag,
        (g[:, 2] - anchors[:, 2]) / anchors[:, 5],
        torch.log(g[:, 3].clamp_min(1e-3) / anchors[:, 3]),
        torch.log(g[:, 4].clamp_min(1e-3) / anchors[:, 4]),
        torch.log(g[:, 5].clamp_min(1e-3) / anchors[:, 5]),
        torch.sin(g[:, 6] - anchors[:, 6])], -1)
    direction = (torch.remainder(g[:, 6] - anchors[:, 6], 2 * math.pi)
                 > math.pi).long()
    return pos, neg, reg, direction


def loss(outputs, targets):
    """The total loss of a batch: ``outputs`` (cls (B, N, C), box (B, N,
    7), dir (B, N, 2)), ``targets`` a list of :func:`assign` results, one
    per frame; the class of every box is 0."""
    cls, box, dirl = outputs
    pos = torch.stack([t[0] for t in targets])
    neg = torch.stack([t[1] for t in targets])
    reg = torch.stack([t[2] for t in targets])
    dirc = torch.stack([t[3] for t in targets])
    npos = pos.sum().clamp_min(1).float()
    target = F.one_hot(torch.zeros_like(dirc), cls.shape[-1]).float() * \
        pos[..., None]
    p = torch.sigmoid(cls)
    ce = -(target * F.logsigmoid(cls) + (1 - target) * F.logsigmoid(-cls))
    pt = torch.where(target == 1, p, 1 - p)
    alpha = torch.where(target == 1, 0.25, 0.75)
    focal = (alpha * (1 - pt) ** 2 * ce * (pos | neg)[..., None]).sum()
    d = (box - reg).abs()
    beta = 1.0 / 9
    sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    reg_loss = (sl1 * pos[..., None]).sum()
    dir_loss = (-F.log_softmax(dirl, -1).gather(-1, dirc[..., None])[..., 0]
                * pos).sum()
    return (focal + 2.0 * reg_loss + 0.2 * dir_loss) / npos


def onecycle(count, total, peak, pct=0.4, div=10.0, final_div=100.0):
    """The learning rate at update ``count`` (from 0) of ``total``: a
    cosine from peak/div up to peak over the first ``pct``, then a cosine
    down to peak/(div*final_div)."""
    up = int(pct * total)
    lo, hi, end = peak / div, peak, peak / (div * final_div)
    if count < up:
        return hi + (lo - hi) / 2 * (math.cos(math.pi * count / up) + 1)
    if count < total:
        t = (count - up) / (total - up)
        return end + (hi - end) / 2 * (math.cos(math.pi * t) + 1)
    return end


class AdamW:
    """AdamW over a dict of float32 tensors (updated in place), the
    gradients clipped together to ``clip`` by their global norm."""

    def __init__(self, params, total, peak, clip=10.0, decay=0.01,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params, self.total, self.peak = params, total, peak
        self.clip, self.decay, self.b1, self.b2, self.eps = (clip, decay,
                                                            b1, b2, eps)
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        """One update; returns the gradients as clipped."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = min(1.0, self.clip / float(norm)) if float(norm) > 0 else 1.0
        lr = onecycle(self.count, self.total, self.peak)
        self.count += 1
        bc1 = 1 - self.b1 ** self.count
        bc2 = 1 - self.b2 ** self.count
        clipped = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            clipped[k] = g
            self.m[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            u = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + self.eps)
            p.sub_(lr * (u + self.decay * p))
        return clipped


def running_change(buffers, stats, momentum):
    """The norm by leaf of the running statistics' change in one step:
    each BatchNorm's running mean and (biased) variance move to
    ``momentum * old + (1 - momentum) * batch``, from ``stats``, the
    batch statistics that the reference's forward recorded by layer."""
    out = {}
    for name, (mean, var) in stats.items():
        for key, batch in (("running_mean", mean), ("running_var", var)):
            old = buffers[f"{name}.{key}"].double()
            new = momentum * old + (1 - momentum) * batch.double()
            out[f"{name}.{key}"] = float((new - old).norm())
    return out


def leaf_gaps(prog, ref, exclude=()):
    """The worst leaf's gap between two dicts of per-leaf norms: |prog -
    ref| over the larger of the reference's norm of that leaf and of the
    median leaf's, the leaves ``exclude`` left out. Returns (gap, the
    leaf)."""
    med = float(np.median([v for k, v in ref.items() if k not in exclude]))
    worst, name = 0.0, None
    for k, r in ref.items():
        if k in exclude:
            continue
        g = abs(prog[k] - r) / max(r, med)
        if g > worst:
            worst, name = g, k
    return worst, name

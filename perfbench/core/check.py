"""The serving cells' comparison: how far a served frame's detections lie
from what the reference makes of the same frame.

The reference decodes every anchor (``scores`` (N,), ``boxes`` (N, 7),
``dir_margin`` (N,): the gap between its two direction logits). Each
served detection is matched to the reference's anchor that decodes
nearest to it, and the frame reads the largest of:

* the served values' distance from the reference's at that anchor: the
  score, the centre (m), the sizes (the log of their ratios: a random
  head's tails decode boxes of hundreds of metres, whose metres say
  nothing of rounding) and the yaw (rad; a yaw half a turn off reads the
  reference's direction margin, a tie it may have broken the other way);
* how far the served set breaks the selection by the reference's
  numbers: a served box below the score threshold or outside the top-k
  (by how much), two served boxes that overlap beyond the NMS threshold
  (by how much), and each box the reference would keep that was not
  served, by the least of its margins: above the threshold, above the
  top-k's cut, and short of being suppressed by a served box of a higher
  score;
* 1 for a served detection that matches no anchor, or two that match one.

A sound run reads rounding only: ties broken the other way read their
margins, which rounding makes small.
"""

import numpy as np

from ..reference.boxes import bev, rotated_iou

__all__ = ["frame_gap"]

_MATCH_POOL = 2000      # anchors of the reference's order searched
_MATCH_M = 1.0          # metres between a served box and its anchor


def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def frame_gap(served, scores, boxes, dir_margin, top_k, iou_threshold,
              score_threshold):
    """The gap of one frame: ``served`` (n, 9) rows [label, score, x, y,
    z, l, w, h, yaw]; the reference's arrays as above (numpy). Returns a
    float >= 0."""
    scores = np.asarray(scores, np.float64)
    boxes = np.asarray(boxes, np.float64)
    order = np.argsort(-scores, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order))
    pool = order[:_MATCH_POOL]
    cut = scores[order[top_k - 1]] if len(order) >= top_k else -np.inf
    below = scores[order[top_k]] if len(order) > top_k else -np.inf
    gap = 0.0
    served = np.asarray(served, np.float64).reshape(-1, 9)
    matched = []
    for row in served:
        s, b = row[1], row[2:9]
        pb = boxes[pool]
        dyaw = np.abs(_wrap(pb[:, 6] - b[6]))
        d = np.abs(pb[:, :6] - b[:6]).sum(1) + np.minimum(dyaw,
                                                          np.pi - dyaw)
        j = int(np.argmin(d))
        a = int(pool[j])
        if np.abs(pb[j, :3] - b[:3]).max() > _MATCH_M:
            return 1.0
        matched.append(a)
        with np.errstate(divide="ignore", invalid="ignore"):
            size = np.abs(np.log(b[3:6] / boxes[a, 3:6])).max()
        err = max(abs(s - scores[a]), np.abs(boxes[a, :3] - b[:3]).max(),
                  size if np.isfinite(size) else 1.0)
        dy = abs(_wrap(b[6] - boxes[a, 6]))
        if dy > np.pi / 2:
            dy = max(abs(dir_margin[a]), np.pi - dy)
        gap = max(gap, err, dy, score_threshold - scores[a],
                  (cut - scores[a]) if rank[a] >= top_k else 0.0)
    if len(set(matched)) < len(matched):
        return 1.0
    kept = np.array(matched, np.int64)
    if len(kept) > 1:
        iou = rotated_iou(bev(boxes[kept]), bev(boxes[kept]))
        np.fill_diagonal(iou, 0.0)
        gap = max(gap, float(iou.max()) - iou_threshold)
    cand = order[:top_k]
    cand = cand[scores[cand] >= score_threshold]
    missed = np.setdiff1d(cand, kept)
    if len(missed):
        sm = scores[missed]
        margin = np.minimum(sm - score_threshold, sm - below)
        if len(kept):
            iou = rotated_iou(bev(boxes[missed]), bev(boxes[kept]))
            sup = np.maximum(np.maximum(iou_threshold - iou,
                                        sm[:, None] - scores[kept][None, :]),
                             0.0).min(1)
            margin = np.minimum(margin, sup)
        gap = max(gap, float(margin.max()))
    return float(max(gap, 0.0))

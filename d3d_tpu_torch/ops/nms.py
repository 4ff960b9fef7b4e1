"""Rotated 2D NMS (port of ``d3d_tpu.ops.nms``).

The pairwise IoU matrix is built in score order (K1 on CUDA) and the greedy
scan runs as one kernel (K2 up to 1024 boxes, K3 above; the sequential
plain scan on the CPU). Semantics matched to the reference and to the JAX
module:

  * boxes with ``score <= score_threshold`` are pre-suppressed, except the
    top-scoring box is never pre-suppressed (an artifact of the reference's
    bottom-up pre-pass loop, nms.cpp:23-29 — kept for bit-exact parity);
  * hard NMS: scanning boxes in descending-score order (stable, so tied
    scores keep input order), an unsuppressed box suppresses every
    lower-ranked box with ``iou > iou_threshold``;
  * soft NMS (Bodla et al. 2017): iteratively pick the highest currently
    scored unfrozen/unsuppressed box, decay the scores of overlapping boxes
    (``linear``: ``s *= 1 - iou**p``; ``gaussian``: ``s *= exp(-iou^2/p)``),
    and suppress boxes whose decayed score falls below ``score_threshold``.
    The cascade runs as one kernel (K4 on CUDA, float32 only) or as its
    plain version on the CPU (float32 or float64).

``iou_method="box"`` is not ported yet.
"""

import torch

from ..utils import as_tensor
from . import geometry_soa as GS
from .nms_cuda import nms_scan, nms_scan_blocked, soft_nms_scan

__all__ = ["nms2d", "soft_nms2d"]


def nms2d(boxes, scores, iou_threshold=0.0, score_threshold=0.0,
          iou_method="rbox"):
    """Hard NMS. Returns the *suppressed* mask (callers invert, matching the
    reference's ``nms2d`` returning ``suppressed``).

    :param boxes: (N, 5) xywhr; a tensor stays on its device, anything
        else goes to CUDA
    :param scores: (N,)
    """
    if iou_method != "rbox":
        raise NotImplementedError(
            f"iou_method={iou_method!r} is not ported yet (only 'rbox')")
    boxes = as_tensor(boxes)
    scores = as_tensor(scores, device=boxes.device)
    n = boxes.shape[0]
    # stable descending order, as jnp.argsort(-scores, stable=True)
    order = torch.sort(-scores, stable=True).indices
    boxes_o = boxes[order]
    overlap = GS.rbox_iou_matrix(boxes_o, boxes_o) > iou_threshold

    # pre-suppression by score (in score order); rank 0 exempt
    pre = scores[order] <= score_threshold
    if n:
        pre[0] = False

    scan = nms_scan if n <= 1024 else nms_scan_blocked
    suppressed_o = scan(overlap, pre)
    # scatter back to original index order
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    out[order] = suppressed_o
    return out


def _soft_nms_init(scores, score_threshold):
    """Pre-suppression identical to hard NMS (the top-scoring box exempt)
    and the starting scores, pre-suppressed boxes at -inf."""
    pre = scores <= score_threshold
    if scores.shape[0]:
        pre[torch.argmax(scores)] = False  # the first maximum, as argsort
    return pre, torch.where(pre, -torch.inf, scores)


def soft_nms2d(boxes, scores, iou_threshold=0.0, score_threshold=0.0,
               supression_param=0.0, iou_method="rbox",
               supression_method="linear"):
    """Soft-NMS; returns the suppressed mask (scores are decayed internally
    only, like the reference, which discards its mutated score copy).

    :param boxes: (N, 5) xywhr; a tensor stays on its device, anything
        else goes to CUDA
    :param scores: (N,)
    :param supression_method: "linear" or "gaussian"
    """
    if iou_method != "rbox":
        raise NotImplementedError(
            f"iou_method={iou_method!r} is not ported yet (only 'rbox')")
    boxes = as_tensor(boxes)
    scores = as_tensor(scores, device=boxes.device)
    iou = GS.rbox_iou_matrix(boxes, boxes)
    pre, cur = _soft_nms_init(scores, score_threshold)
    dt = torch.promote_types(iou.dtype, cur.dtype)
    return soft_nms_scan(iou.to(dt), cur.to(dt), pre, iou_threshold,
                         score_threshold, supression_param,
                         supression_method)

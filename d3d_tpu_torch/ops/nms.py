"""Rotated 2D NMS (port of ``d3d_tpu.ops.nms``).

The overlaps are built in score order (K1 on CUDA, writing the scan's bit
rows directly for float32 rotated boxes; the axis-aligned IoU matrix of
``geometry.aabox_iou`` for ``iou_method="box"``, the float64 rotated one
of ``geometry_soa``, each thresholded into the scan's bool route) and the
greedy scan runs as one kernel (K2 up to 1024 boxes, K3 above; the
sequential plain scan on the CPU).
Semantics matched to the reference and to the JAX module:

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
    The cascade runs as one kernel (K4 on CUDA, float32 or float64) or as
    its plain version on the CPU.

The masks carry no gradient: the boxes are detached first.
"""

import torch

from ..utils import as_tensor
from . import geometry as G
from . import geometry_cuda as GC
from . import geometry_soa as GS
from .nms_cuda import (_K2_MAX_N, _nms_scan_sorted, _pre_suppression,
                       nms_scan, nms_scan_blocked, soft_nms_scan)

__all__ = ["nms2d", "soft_nms2d"]

_IOU_METHODS = ("box", "rbox")


def _iou_matrix(boxes, method):
    """(N, 5) boxes -> their (N, N) IoU matrix: axis-aligned ("box") or
    rotated ("rbox": K1 for float32 CUDA boxes)."""
    if method == "box":
        return G.aabox_iou(boxes[:, None, :], boxes[None, :, :])
    return GS.rbox_iou_matrix(boxes, boxes)


def _check_method(iou_method):
    if iou_method not in _IOU_METHODS:
        raise ValueError(f"unknown iou_method {iou_method!r}; expected one "
                         f"of {_IOU_METHODS}")


def nms2d(boxes, scores, iou_threshold=0.0, score_threshold=0.0,
          iou_method="rbox"):
    """Hard NMS. Returns the *suppressed* mask (callers invert, matching the
    reference's ``nms2d`` returning ``suppressed``).

    :param boxes: (N, 5) xywhr; a tensor stays on its device, anything
        else goes to CUDA
    :param scores: (N,)
    :param iou_method: "rbox" (rotated) or "box" (axis-aligned bounding
        boxes of the rotated corners)
    """
    _check_method(iou_method)
    boxes = as_tensor(boxes).detach()
    scores = as_tensor(scores, device=boxes.device).detach()
    n = boxes.shape[0]
    # stable descending order, as jnp.argsort(-scores, stable=True)
    neg, order = torch.sort(-scores, stable=True)
    boxes_o = boxes[order]
    if iou_method == "rbox" and boxes.dtype == torch.float32:
        # K1 writes the scan's bit rows (pairs above the diagonal only);
        # the scan takes the pre-suppression from the sorted scores and
        # writes the mask back in input order (plain versions on the CPU)
        bits = GC._rbox_overlap_bits(boxes_o, iou_threshold)
        pre = (None if scores.dtype == torch.float32
               else _pre_suppression(-neg, score_threshold))
        return _nms_scan_sorted(bits, order, neg, score_threshold, pre)
    # axis-aligned boxes, or other box dtypes: the IoU matrix in that
    # dtype, as the JAX module, thresholded into the bool route
    overlap = _iou_matrix(boxes_o, iou_method) > iou_threshold
    scan = nms_scan if n <= _K2_MAX_N else nms_scan_blocked
    # scatter back to original index order
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    out[order] = scan(overlap, _pre_suppression(-neg, score_threshold))
    return out


def _soft_nms_init(scores, score_threshold):
    """Pre-suppression identical to hard NMS (the top-ranked box exempt)
    and the starting scores, pre-suppressed boxes at -inf. The exempt box
    is rank 0 of the stable descending sort, as in the JAX module: the
    first largest score that is not NaN (NaN sorts last; ``argmax`` would
    return the NaN)."""
    pre = scores <= score_threshold
    if scores.shape[0]:
        pre[torch.sort(-scores, stable=True).indices[0]] = False
    return pre, torch.where(pre, -torch.inf, scores)


def soft_nms2d(boxes, scores, iou_threshold=0.0, score_threshold=0.0,
               supression_param=0.0, iou_method="rbox",
               supression_method="linear"):
    """Soft-NMS; returns the suppressed mask (scores are decayed internally
    only, like the reference, which discards its mutated score copy).

    :param boxes: (N, 5) xywhr; a tensor stays on its device, anything
        else goes to CUDA
    :param scores: (N,)
    :param iou_method: "rbox" (rotated) or "box" (axis-aligned)
    :param supression_method: "linear" or "gaussian"

    A NaN score: the JAX package's two routes disagree here. Its XLA loop
    picks with ``argmax``, which takes the NaN as the maximum; its Pallas
    kernel (``nms_pallas.soft_nms_scan``) matches no score against a NaN
    maximum and picks box n - 1. The port follows the Pallas kernel, in K4
    and in the plain cascade alike.
    """
    _check_method(iou_method)
    boxes = as_tensor(boxes).detach()
    scores = as_tensor(scores, device=boxes.device).detach()
    iou = _iou_matrix(boxes, iou_method)
    pre, cur = _soft_nms_init(scores, score_threshold)
    dt = torch.promote_types(iou.dtype, cur.dtype)
    return soft_nms_scan(iou.to(dt), cur.to(dt), pre, iou_threshold,
                         score_threshold, supression_param,
                         supression_method)

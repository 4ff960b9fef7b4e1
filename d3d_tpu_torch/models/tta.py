"""Test-time augmentation: flip-ensemble detection (port of
``d3d_tpu.models.tta``).

Run the detector on the original cloud and on mirrored copies, mirror the
boxes back, and merge all candidate sets with one final rotated NMS
(``nms2d``: K1's bit rows and the scan on the card). Shapes stay fixed
(passes x top_k candidates); only the final ``Target3DArray`` assembly
runs on the host.

It wraps the ``device_fn`` of a detector from
:mod:`d3d_tpu_torch.models.inference` (``points -> (boxes, scores,
labels, keep[, vel])``) and returns a ``detect`` with the same contract;
velocities are mirrored back with the boxes.
"""

import math

import torch

from ..ops.nms import nms2d
from ..utils import as_tensor

__all__ = ["make_tta_detector", "FLIP_MODES"]

FLIP_MODES = ("none", "flip_y", "flip_x", "flip_xy")


def _flip_points(points, mode):
    if mode == "none":
        return points
    sx = -1.0 if mode in ("flip_x", "flip_xy") else 1.0
    sy = -1.0 if mode in ("flip_y", "flip_xy") else 1.0
    scale = torch.tensor([sx, sy] + [1.0] * (points.shape[1] - 2),
                         dtype=points.dtype).to(points.device)
    return points * scale


def _unflip_boxes(boxes, vel, mode):
    """Mirror detector outputs back to the original frame. For a y-flip
    the yaw negates; for an x-flip it reflects to pi - yaw; a velocity's
    component along a flipped axis negates."""
    if mode == "none":
        return boxes, vel
    fx = mode in ("flip_x", "flip_xy")
    fy = mode in ("flip_y", "flip_xy")
    x = -boxes[:, 0] if fx else boxes[:, 0]
    y = -boxes[:, 1] if fy else boxes[:, 1]
    yaw = boxes[:, 6]
    if fy:
        yaw = -yaw
    if fx:
        yaw = math.pi - yaw
    out = torch.stack([x, y, boxes[:, 2], boxes[:, 3], boxes[:, 4],
                       boxes[:, 5], yaw], dim=-1)
    if vel is None:
        return out, None
    vx = -vel[:, 0] if fx else vel[:, 0]
    vy = -vel[:, 1] if fy else vel[:, 1]
    return out, torch.stack([vx, vy], dim=-1)


def make_tta_detector(detect, classes, modes=("none", "flip_y"),
                      score_threshold=0.3, iou_threshold=0.5):
    """Wrap a detector with a flip ensemble.

    :param detect: a ``detect`` closure from a ``make_*_detector`` factory
        (its ``.device_fn`` is wrapped and runs where it was built)
    :param classes: the class list the base detector was built with
    :param modes: a subset of :data:`FLIP_MODES`; "none" should normally
        be included
    :returns: ``tta(points, frame=None, timestamp=0) -> Target3DArray``
        with ``.device_fn``; a velocity-head base detector keeps its
        5-output contract and ``TrackingTarget3D`` elements
    """
    from .inference import _bev, _to_targets, _to_tracking_targets

    base = detect.device_fn
    for m in modes:
        if m not in FLIP_MODES:
            raise ValueError("unknown TTA mode %r" % (m,))

    @torch.inference_mode()
    def device(points):
        points = as_tensor(points, device=base.device, dtype=torch.float32)
        all_boxes, all_scores, all_labels, all_vel = [], [], [], []
        has_vel = False
        for mode in modes:
            out = base(_flip_points(points, mode))
            boxes, scores, labels, keep = out[:4]
            vel = out[4] if len(out) > 4 else None
            has_vel = has_vel or vel is not None
            boxes, vel = _unflip_boxes(boxes, vel, mode)
            # suppressed candidates drop out of the merge via score 0
            all_boxes.append(boxes)
            all_scores.append(torch.where(keep, scores, 0.0))
            all_labels.append(labels)
            all_vel.append(boxes.new_zeros((boxes.shape[0], 2))
                           if vel is None else vel)
        boxes = torch.cat(all_boxes)
        scores = torch.cat(all_scores).to(torch.float32)
        labels = torch.cat(all_labels)
        keep = ~nms2d(_bev(boxes), scores, iou_threshold=iou_threshold,
                      iou_method="rbox")
        keep = keep & (scores > 0)
        if has_vel:  # velocity-head detectors keep their 5-output contract
            return boxes, scores, labels, keep, torch.cat(all_vel)
        return boxes, scores, labels, keep

    def tta(points, frame=None, timestamp=0):
        out = [t.cpu().numpy() for t in device(points)]
        if len(out) > 4:
            return _to_tracking_targets(*out, classes, frame, timestamp,
                                        score_threshold)
        return _to_targets(*out, classes, frame, timestamp, score_threshold)

    device.device = base.device
    tta.device_fn = device
    return tta

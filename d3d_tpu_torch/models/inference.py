"""End-to-end inference: points in, :class:`Target3DArray` out (port of the
PointPillars, SST, CenterPoint, SECOND and VoxelNeXt part of
``d3d_tpu.models.inference``).

One request runs points -> voxelize -> network -> top-k decode -> rotated
NMS on one device with fixed shapes; only the final selection of kept rows
and the ``Target3DArray`` assembly run on the host.

Under a profiler every ``detect`` records its stages as
:func:`~d3d_tpu_torch.profiler.span` ranges (README lists the names).
"""

import math
from functools import partial

import numpy as np
import torch

from ..abstraction import ObjectTag, Target3DArray
from ..ops.nms import nms2d
from ..profiler import span
from ..utils import as_tensor, resolve_device
from .pointpillars import decode_boxes, pillarize
from .second import second_voxelize

__all__ = ["make_pointpillars_detector", "make_sst_detector",
           "make_centerpoint_detector", "make_second_detector",
           "make_voxelnext_detector"]


def _to_targets(boxes, scores, labels, keep, classes, frame, timestamp,
                score_threshold):
    """Host-side assembly of kept detections into a Target3DArray — one
    vectorized mask + ``Target3DArray.from_columns`` (the dense decode
    outputs become the array's struct-of-arrays backing directly)."""
    boxes, scores, labels, keep = (np.asarray(a) for a in
                                   (boxes, scores, labels, keep))
    sel = (keep & (scores >= score_threshold)
           & np.all(np.isfinite(boxes), axis=-1))
    boxes, scores, labels = boxes[sel], scores[sel], labels[sel]
    tags = [ObjectTag(cls := classes[int(l)], type(cls), float(s))
            for l, s in zip(labels, scores)]
    return Target3DArray.from_columns(
        positions=boxes[:, 0:3], dimensions=boxes[:, 3:6],
        yaws=boxes[:, 6], tags=tags, frame=frame, timestamp=timestamp)


def _bev(boxes):
    return torch.cat([boxes[:, 0:2], boxes[:, 3:5], boxes[:, 6:7]],
                     dim=-1).to(torch.float32)


def _readback(outputs):
    """A request's device outputs as host numpy arrays."""
    with span("detect.readback"):
        return [t.cpu().numpy() for t in outputs]


def _to_tracking_targets(boxes, scores, labels, keep, vel, classes, frame,
                         timestamp, score_threshold):
    """Like :func:`_to_targets`, but :class:`TrackingTarget3D` elements
    carrying the decoded BEV velocities (the input of
    :class:`~d3d_tpu_torch.tracking.CenterTracker` and the tracking
    evaluator), built column by column."""
    from ..abstraction import TrackingTarget3D

    boxes, scores, labels, keep, vel = (np.asarray(a) for a in
                                        (boxes, scores, labels, keep, vel))
    sel = (keep & (scores >= score_threshold)
           & np.all(np.isfinite(boxes), axis=-1))
    boxes, scores, labels, vel = boxes[sel], scores[sel], labels[sel], \
        vel[sel]
    n = len(boxes)
    y = boxes[:, 6].astype(np.float64)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 2] = np.sin(y / 2)
    quats[:, 3] = np.cos(y / 2)
    vel3 = np.zeros((n, 3), np.float32)
    vel3[:, :2] = vel
    cols = dict(
        position=np.ascontiguousarray(boxes[:, 0:3], np.float32),
        dimension=np.ascontiguousarray(boxes[:, 3:6], np.float32),
        quat=quats,
        position_var=np.zeros((n, 3, 3), np.float32),
        dimension_var=np.zeros((n, 3, 3), np.float32),
        velocity=vel3,
        angular_velocity=np.zeros((n, 3), np.float32),
        velocity_var=np.zeros((n, 3, 3), np.float32),
        angular_velocity_var=np.zeros((n, 3, 3), np.float32),
    )
    tags = [ObjectTag(cls := classes[int(l)], type(cls), float(s))
            for l, s in zip(labels, scores)]
    return Target3DArray._from_backed_columns(
        TrackingTarget3D, cols, tags, np.zeros(n, np.float32),
        frame=frame, timestamp=timestamp)


def _make_anchor_detector(model, variables, cfg, anchors, classes,
                          voxelize_fn, score_threshold, iou_threshold,
                          top_k, device):
    """Shared factory for the anchor-head families: voxelize -> heads ->
    top-k decode (incl. the direction classifier: arcsin only recovers yaw
    up to pi, the dir head supplies the flip) -> rotated NMS ->
    Target3DArray."""
    dev = resolve_device(device)
    if variables is not None:
        model.load_state_dict(variables)
    model = model.to(dev).eval()
    anchors = as_tensor(anchors, device=dev, dtype=torch.float32)

    @torch.inference_mode()
    def device_fn(points):
        with span("detect.upload"):
            points = as_tensor(points, device=dev, dtype=torch.float32)
        with span("detect.voxelize"):
            feats, coords, valid = voxelize_fn(points, cfg)
        with span("detect.network"):
            cls_logits, box_preds, dir_logits = model(
                feats[None], coords[None], valid[None])
        with span("detect.select"):
            scores_all = torch.sigmoid(cls_logits[0])        # (N, C)
            best = scores_all.max(dim=-1).values
            # lax.top_k order: descending, equal scores lowest index first
            idx = torch.sort(best, descending=True,
                             stable=True).indices[:top_k]
            top_scores = best[idx]
            boxes = decode_boxes(anchors[idx], box_preds[0][idx])
            # direction head disambiguates the arcsin yaw (residual mod 2pi
            # > pi -> class 1 -> add pi)
            flip = dir_logits[0][idx].argmax(dim=-1).to(boxes.dtype)
            boxes[:, 6] = boxes[:, 6] + flip * math.pi
            labels = scores_all.argmax(dim=-1)[idx]
            keep = ~nms2d(_bev(boxes), top_scores.to(torch.float32),
                          iou_threshold=iou_threshold, iou_method="rbox")
        return boxes, top_scores, labels, keep

    def detect(points, frame=None, timestamp=0):
        """The kept detections of one frame as a Target3DArray: a tag
        ``ObjectTag(classes[label], type(classes[label]), score)`` per box
        (``classes`` are Enum members), in ``frame`` at ``timestamp``."""
        with span("detect"):
            out = _readback(device_fn(points))
            with span("detect.assemble"):
                return _to_targets(*out, classes, frame, timestamp,
                                   score_threshold)

    device_fn.device = dev
    detect.device_fn = device_fn
    return detect


def make_pointpillars_detector(model, variables, cfg, anchors, classes,
                               score_threshold=0.3, iou_threshold=0.5,
                               top_k=100, device=None):
    """Build ``detect(points, frame=None, timestamp=0) -> Target3DArray``
    for a PointPillars model.

    :param variables: a state_dict to load into ``model`` (e.g. from
        :func:`d3d_tpu_torch.models.convert.pointpillars_state_from_flax`),
        or None to keep the model's own weights
    :param device: where the model and every request run (default CUDA;
        raises when CUDA is missing and no device is given)
    """
    return _make_anchor_detector(model, variables, cfg, anchors, classes,
                                 pillarize, score_threshold, iou_threshold,
                                 top_k, device)


def make_sst_detector(model, variables, cfg, anchors, classes,
                      score_threshold=0.3, iou_threshold=0.5, top_k=100,
                      device=None):
    """Build ``detect(points, frame=None, timestamp=0) -> Target3DArray``
    for an SST model (PointPillars' anchor head at the full single-stride
    grid): pillarize -> network -> top-k decode -> ``nms2d`` (K1's bit
    rows and the scan on the card). Arguments as
    :func:`make_pointpillars_detector` (``variables`` e.g. from
    :func:`d3d_tpu_torch.models.convert.sst_state_from_flax`)."""
    return _make_anchor_detector(model, variables, cfg, anchors, classes,
                                 pillarize, score_threshold, iou_threshold,
                                 top_k, device)


def make_centerpoint_detector(model, variables, cfg, pillar_cfg, classes,
                              score_threshold=0.3, iou_threshold=0.5,
                              refine=None, device=None):
    """Build ``detect(points, frame=None, timestamp=0)`` for a CenterPoint
    model: pillarize -> network -> peak decode (top-k ``cfg.top_k``)
    [-> second stage] -> rotated NMS (``nms2d``: K1's bit rows and the
    scan on the card). ``detect.device_fn`` gives the 5-output contract
    ``(boxes, scores, labels, keep, vel)`` (zero velocities without the
    velocity head), the input of
    :func:`~d3d_tpu_torch.tracking.make_tracking_step` and
    :func:`~d3d_tpu_torch.models.make_tta_detector`; ``detect`` returns
    ``TrackingTarget3D`` elements with ``cfg.predict_velocity``, plain
    ones otherwise.

    :param pillar_cfg: the config ``pillarize`` reads (a
        ``CenterPointConfig`` serves)
    :param refine: optional ``(refine_model, refine_variables,
        refine_cfg)`` second stage (:mod:`.centerpoint2`; variables a
        state_dict or None) — needs the first stage built with
        ``return_feat=True``; applies the box residuals and fuses the
        IoU-aware confidence into the score before NMS
    Other arguments as :func:`make_pointpillars_detector`.
    """
    if refine is not None and not getattr(model, "return_feat", False):
        raise ValueError(
            "the refine stage pools the shared BEV map: build the first "
            "stage with CenterPoint(cfg, return_feat=True)")
    from .centerpoint import decode_centers
    from .centerpoint2 import apply_refinements, roi_grid_features

    dev = resolve_device(device)
    if variables is not None:
        model.load_state_dict(variables)
    model = model.to(dev).eval()
    if refine is not None:
        rmodel, rvars, rcfg = refine
        if rvars is not None:
            rmodel.load_state_dict(rvars)
        rmodel = rmodel.to(dev).eval()

    @torch.inference_mode()
    def device_fn(points):
        with span("detect.upload"):
            points = as_tensor(points, device=dev, dtype=torch.float32)
        with span("detect.voxelize"):
            feats, coords, valid = pillarize(points, pillar_cfg)
        with span("detect.network"):
            outputs = model(feats[None], coords[None], valid[None])
        # the second stage, which refines decoded boxes, counts as select
        with span("detect.select"):
            outputs = {k: v[0] for k, v in outputs.items()}
            feat = outputs.pop("feat", None)
            dec = decode_centers(cfg, outputs)
            boxes, scores, labels = dec[:3]
            vel = dec[3] if cfg.predict_velocity else boxes.new_zeros(
                (boxes.shape[0], 2))
            if refine is not None:
                pooled = roi_grid_features(feat, boxes, cfg.bounds, cfg.grid,
                                           rcfg.grid_points)
                out = rmodel(pooled, boxes)
                boxes = apply_refinements(boxes, out["deltas"])
                a = rcfg.score_alpha
                scores = scores ** (1 - a) * torch.sigmoid(out["conf"]) ** a
            keep = ~nms2d(_bev(boxes), scores.to(torch.float32),
                          iou_threshold=iou_threshold, iou_method="rbox")
        return boxes, scores, labels, keep, vel

    def detect(points, frame=None, timestamp=0):
        """The kept detections of one frame as a Target3DArray (of
        ``TrackingTarget3D`` with the velocity head)."""
        with span("detect"):
            out = _readback(device_fn(points))
            with span("detect.assemble"):
                if not cfg.predict_velocity:
                    return _to_targets(*out[:4], classes, frame, timestamp,
                                       score_threshold)
                return _to_tracking_targets(*out, classes, frame, timestamp,
                                            score_threshold)

    device_fn.device = dev
    detect.device_fn = device_fn
    return detect


def make_second_detector(model, variables, cfg, anchors, classes,
                         score_threshold=0.3, iou_threshold=0.5, top_k=100,
                         device=None, exact_mean=False):
    """Build ``detect(points, frame=None, timestamp=0)`` for a SECOND model (head outputs are
    PointPillars-compatible; only the voxelization front end differs).
    Arguments as :func:`make_pointpillars_detector`; ``anchors`` come from
    ``make_anchors(head_config(cfg, model.layout))``; ``exact_mean`` is
    :func:`~d3d_tpu_torch.models.second.second_voxelize`'s."""
    return _make_anchor_detector(model, variables, cfg, anchors, classes,
                                 partial(second_voxelize,
                                         exact_mean=exact_mean),
                                 score_threshold, iou_threshold, top_k,
                                 device)


def make_voxelnext_detector(model, variables, cfg, classes,
                            score_threshold=0.3, iou_threshold=0.5,
                            device=None):
    """Build ``detect(points, frame=None, timestamp=0)`` for a VoxelNeXt
    model: voxelize -> network -> flat top-k decode over the active BEV
    sites (``cfg.top_k``) -> rotated NMS (``nms2d``: K1's bit rows and
    the scan on the card). With ``cfg.predict_velocity`` the detector
    returns ``TrackingTarget3D`` elements and its ``device_fn`` the
    5-output contract ``(boxes, scores, labels, keep, vel)``, the input of
    :func:`~d3d_tpu_torch.tracking.make_tracking_step`; otherwise a
    ``Target3DArray`` and 4 outputs. Arguments as
    :func:`make_pointpillars_detector`."""
    from .voxelnext import decode_voxelnext, voxelnext_voxelize

    dev = resolve_device(device)
    if variables is not None:
        model.load_state_dict(variables)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def device_fn(points):
        with span("detect.upload"):
            points = as_tensor(points, device=dev, dtype=torch.float32)
        with span("detect.voxelize"):
            feats, coords, valid = voxelnext_voxelize(points, cfg)
        with span("detect.network"):
            outputs = model(feats[None], coords[None], valid[None])
        with span("detect.select"):
            dec = decode_voxelnext(cfg, {k: v[0] for k, v in outputs.items()})
            boxes, scores, labels = dec[:3]
            keep = ~nms2d(_bev(boxes), scores.to(torch.float32),
                          iou_threshold=iou_threshold, iou_method="rbox")
        if cfg.predict_velocity:
            return boxes, scores, labels, keep, dec[3]
        return boxes, scores, labels, keep

    def detect(points, frame=None, timestamp=0):
        """The kept detections of one frame as a Target3DArray (of
        ``TrackingTarget3D`` with the velocity head)."""
        with span("detect"):
            out = _readback(device_fn(points))
            with span("detect.assemble"):
                if len(out) > 4:
                    return _to_tracking_targets(*out, classes, frame,
                                                timestamp, score_threshold)
                return _to_targets(*out, classes, frame, timestamp,
                                   score_threshold)

    device_fn.device = dev
    detect.device_fn = device_fn
    return detect

"""Public differentiable box-op API (port of ``d3d_tpu.ops.box``, itself
drop-in compatible with the reference's ``d3d.box``): ``box2d_iou``,
``box2d_nms``, ``box2dr_crop``, ``box3dp_crop``, ``seg1d_iou``,
``seg1d_pdist``, ``box2dr_pdist``, ``box3dr_pdist``.

Numpy in gives numpy out, computed on CUDA unless ``device="cpu"`` (or
another device) is given; tensors in give tensors out, on their own
device. ``precise=True`` computes in float64 and casts the result back to
the input dtype. A float32 rotated IoU matrix runs kernel K1 on CUDA
(forward-only, so it raises under autograd: ``precise=True`` is the
differentiable route), NMS runs K1's bit rows and K2/K3 or K4.
"""

import numpy as np
import torch

from ..utils import resolve_device
from . import geometry as G
from . import geometry_soa as GS
from . import nms as _nms

__all__ = [
    "box2d_iou",
    "box2d_nms",
    "box2dr_crop",
    "box3dp_crop",
    "seg1d_iou",
    "seg1d_pdist",
    "box2dr_pdist",
    "box3dr_pdist",
]

_IOU_FNS = {
    "box": G.aabox_iou,
    "rbox": GS.rbox_iou,  # structure-of-arrays: the same math and grads
    "grbox": G.rbox_giou,
    "drbox": G.rbox_diou,
}


def _maybe_numpy(*arrays):
    isnp = isinstance(arrays[0], np.ndarray)
    if isnp:
        assert all(isinstance(a, np.ndarray) for a in arrays), (
            "Inputs should be all numpy arrays or all torch tensors!")
    return isnp


def _tensors(arrays, device, dtype=None):
    """The inputs as tensors: numpy on :func:`resolve_device` ``(device)``,
    a tensor on its own device (or on ``device`` when given)."""
    dev = None
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            t = a if device is None else a.to(resolve_device(device))
        else:
            if dev is None:
                dev = resolve_device(device)
            t = torch.as_tensor(a, device=dev)
        out.append(t if dtype is None else t.to(dtype))
    return out


def _out(t, convert):
    return t.detach().cpu().numpy() if convert else t


def box2d_iou(boxes1, boxes2, method="box", precise=True, device=None):
    """Differentiable IoU matrix between two box sets.

    :param boxes1: (N, 5) boxes as [x, y, w, h, r]
    :param boxes2: (M, 5)
    :param method: 'box' (axis-aligned box of the rotated corners), 'rbox'
        (rotated IoU), 'grbox' (rotated GIoU), 'drbox' (rotated DIoU)
    :param precise: compute in float64
    :return: (N, M) IoU matrix in the input dtype
    """
    convert = _maybe_numpy(boxes1, boxes2)
    if boxes1.ndim != 2 or boxes2.ndim != 2:
        raise ValueError("Input boxes should be 2D (N, 5) arrays!")
    if boxes1.shape[1] != 5 or boxes2.shape[1] != 5:
        raise ValueError("Input boxes should have 5 fields: x, y, w, h, r")
    if method not in _IOU_FNS:
        raise ValueError("Unrecognized iou type!")

    b1, b2 = _tensors((boxes1, boxes2), device)
    otype = b1.dtype
    if precise:
        b1, b2 = b1.to(torch.float64), b2.to(torch.float64)
    if (method == "rbox"
            and torch.promote_types(b1.dtype, b2.dtype) == torch.float32):
        # the matrix entry point: K1 for float32 CUDA boxes
        out = GS.rbox_iou_matrix(b1, b2)
    else:
        out = _IOU_FNS[method](b1[:, None, :], b2[None, :, :])
    return _out(out.to(otype), convert)


def box2d_nms(boxes, scores, iou_method="box", supression_method="hard",
              iou_threshold=0.0, score_threshold=0.0, supression_param=0.0,
              precise=True, device=None):
    """NMS on (rotated) 2D boxes; returns the keep mask.

    :param boxes: (N, 5) boxes
    :param scores: (N,) scores, or (N, C), whose per-box maximum is taken
    :param iou_method: 'box' or 'rbox'
    :param supression_method: 'hard', 'linear' or 'gaussian' (soft-NMS)
    :param precise: compute in float64
    """
    convert = _maybe_numpy(boxes, scores)
    if len(boxes) != len(scores):
        raise ValueError("Numbers of boxes and scores are inconsistent!")
    if iou_method not in ("box", "rbox"):
        raise ValueError("Unrecognized iou type!")
    if supression_method not in ("hard", "linear", "gaussian"):
        raise ValueError("Unrecognized supression type!")

    dt = torch.float64 if precise else None
    b, s = _tensors((boxes, scores), device, dt)
    if s.ndim == 2:
        s = s.amax(dim=1)
    if b.numel() == 0:
        out = torch.zeros((0,), dtype=torch.bool, device=b.device)
    elif supression_method == "hard":
        out = ~_nms.nms2d(b, s, iou_threshold=iou_threshold,
                          score_threshold=score_threshold,
                          iou_method=iou_method)
    else:
        out = ~_nms.soft_nms2d(b, s, iou_threshold=iou_threshold,
                               score_threshold=score_threshold,
                               supression_param=supression_param,
                               iou_method=iou_method,
                               supression_method=supression_method)
    return _out(out, convert)


def crop_mask_2dr(points, boxes):
    """(M boxes, N points) boolean containment matrix for rotated 2D boxes
    (tensors on one device)."""
    poly = G.box2poly(boxes)
    return G.poly_contains(poly[:, None, :, :], points[None, :, :])


def box2dr_crop(points, boxes, device=None):
    """Indices of points inside each rotated box.

    :param points: (N, 2)
    :param boxes: (M, 5)
    :return: list of M index arrays (int64; numpy for numpy input, else
        tensors on the input's device)
    """
    convert = _maybe_numpy(points, boxes)
    p, b = _tensors((points, boxes), device)
    mask = crop_mask_2dr(p, b)
    if convert:
        return [np.where(m)[0] for m in mask.cpu().numpy()]
    return [torch.nonzero(m)[:, 0] for m in mask]


def _boxes_2d(boxes, ax2d):
    """(M, 7) [x, y, z, lx, ly, lz, r] -> (M, 5) footprints along the two
    axes ``ax2d``."""
    return torch.cat([boxes[:, ax2d], boxes[:, [3 + a for a in ax2d]],
                      boxes[:, 6:7]], dim=1)


def _project_axes(project_axis):
    ax2d = [a for a in range(3) if a != project_axis]
    if len(ax2d) != 2:
        raise ValueError("The projection axis can only be 0-x, 1-y and 2-z!")
    return ax2d


def box3dp_crop(points, boxes, project_axis=2, device=None):
    """Boolean (M, N) mask of 3D points inside rotated 3D boxes: the 2D
    footprint projected along ``project_axis`` and the interval along it.

    :param points: (N, 3)
    :param boxes: (M, 7) as [x, y, z, lx, ly, lz, r]
    """
    convert = _maybe_numpy(points, boxes)
    ax2d = _project_axes(project_axis)
    points, boxes = _tensors((points, boxes), device)
    mask_2d = crop_mask_2dr(points[:, ax2d], _boxes_2d(boxes, ax2d))

    pp = points[:, project_axis][None, :]
    bc = boxes[:, project_axis][:, None]
    bd = boxes[:, 3 + project_axis][:, None] / 2
    mask_p = (pp - bd < bc) & (bc < pp + bd)
    return _out(mask_2d & mask_p, convert)


def seg1d_iou(seg1, seg2, device=None):
    """IoU of 1D segments given as (center, width) rows, elementwise (the
    reference derives its second segment from the first, a fault the JAX
    package fixed; this is the fixed behaviour)."""
    convert = _maybe_numpy(seg1, seg2)
    s1, s2 = _tensors((seg1, seg2), device)
    i, u = G.seg1d_intersection(s1[:, 0], s1[:, 1], s2[:, 0], s2[:, 1])
    return _out(i / u, convert)


def seg1d_pdist(points, segs, device=None):
    """Signed distance from 1D points to (center, width) segments; positive
    inside."""
    convert = _maybe_numpy(points, segs)
    p, s = _tensors((points, segs), device)
    half = s[:, 1] / 2
    smax = s[:, 0] + half
    smin = s[:, 0] - half
    if p.ndim > 1:
        p = p[..., 0]
    out = torch.where(p > s[:, 0], smax - p, p - smin)
    return _out(out, convert)


def box2dr_pdist(points, boxes, method="rbox", device=None):
    """Signed distance from points to rotated 2D box boundaries, positive
    inside: an (M, N) matrix (boxes x points)."""
    if method != "rbox":
        raise ValueError("Only supported rotated boxes by now!")
    convert = _maybe_numpy(points, boxes)
    if boxes.ndim != 2 or boxes.shape[1] != 5:
        raise ValueError("Input boxes should have 5 fields: x, y, w, h, r")
    p, b = _tensors((points, boxes), device)
    poly = G.box2poly(b)
    out = G.poly_signed_distance(poly[:, None, :, :], p[None, :, :])
    return _out(out, convert)


def box3dr_pdist(points, boxes, project_axis=2, device=None):
    """Signed distance from 3D points to rotated 3D box surfaces: the
    projected 2D signed distance combined with the 1D interval distance
    along the projection axis. (M, N)."""
    convert = _maybe_numpy(points, boxes)
    ax2d = _project_axes(project_axis)
    points, boxes = _tensors((points, boxes), device)
    dist_2d = box2dr_pdist(points[:, ax2d], _boxes_2d(boxes, ax2d))

    segs = boxes[:, [project_axis, 3 + project_axis]]
    half = segs[:, 1:2] / 2
    smax = segs[:, 0:1] + half
    smin = segs[:, 0:1] - half
    pp = points[:, project_axis][None, :]
    dist_p = torch.where(pp > segs[:, 0:1], smax - pp, pp - smin)

    out = torch.where(
        dist_p > 0,
        torch.where(dist_2d > 0, torch.minimum(dist_p, dist_2d), dist_2d),
        torch.where(dist_2d > 0, dist_p,
                    -torch.sqrt(dist_2d ** 2 + dist_p ** 2)))
    return _out(out, convert)

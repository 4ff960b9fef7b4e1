"""Point-cloud training augmentation (port of ``d3d_tpu.augment``).

* :func:`global_augment`: the joint transform of a frame's points and GT
  boxes (random y-flip, rotation about z, uniform scale, translation
  noise), on the points' device.
* :func:`perobject_augment`: SECOND's per-object noise with a one-shot BEV
  collision test (K1, :func:`d3d_tpu_torch.ops.geometry_soa.rbox_iou_matrix`,
  on a float32 CUDA tensor).
* :func:`build_gt_database` / :func:`sample_ground_truths`: SECOND's
  GT sampling (host numpy; the crops and IoUs run on ``device``).
* :func:`class_balanced_frame_indices` (CBGS epoch resampling) and
  :func:`flip_camera_frame` (the mirror augmentation of camera frames).

Random draws take an explicit generator: a ``torch.Generator`` for the
device transforms (its device is where the values are drawn), a
``numpy.random.Generator`` for the host ones, as the JAX functions take a
``jax.random`` key or a numpy generator. Each device transform draws its
values, then calls a private transform that takes them as tensors.
"""

import math

import numpy as np
import torch

from .models.inference import _bev
from .ops.box import box2d_iou, box3dp_crop
from .ops.geometry_soa import rbox_iou_matrix

__all__ = ["global_augment", "perobject_augment", "build_gt_database",
           "flip_camera_frame", "sample_ground_truths",
           "class_balanced_frame_indices"]


def class_balanced_frame_indices(frame_classes, rng, samples_per_class=None,
                                 shuffle=True):
    """CBGS-style epoch resampling (Zhu et al., "Class-balanced Grouping
    and Sampling for Point Cloud 3D Object Detection", 2019): group the
    frames by the classes they contain and draw the epoch evenly from
    every class group (with replacement). Frames holding no listed class
    are left out.

    :param frame_classes: per-frame iterables of the class values present
    :param rng: ``np.random.Generator``
    :param samples_per_class: draws per class group (default: the size an
        even split of one epoch gives each group)
    :returns: int64 frame-index array, shuffled unless ``shuffle=False``
    """
    groups = {}
    for i, cs in enumerate(frame_classes):
        for c in set(cs):
            groups.setdefault(c, []).append(i)
    if not groups:
        return np.zeros(0, np.int64)
    spc = samples_per_class or int(np.ceil(len(frame_classes)
                                           / len(groups)))
    out = np.concatenate([
        rng.choice(np.asarray(idxs, np.int64), size=spc, replace=True)
        for _, idxs in sorted(groups.items())])
    if shuffle:
        rng.shuffle(out)
    return out


def global_augment(generator, points, gt_boxes, flip_prob=0.5,
                   rot_range=0.7854, scale_range=(0.95, 1.05),
                   translate_std=0.2):
    """Jointly transform a frame's points and GT boxes: a y-flip with
    probability ``flip_prob``, a rotation about z by U(-rot_range,
    rot_range), a scale by U(*scale_range) and a shift by N(0,
    translate_std) along each axis.

    :param generator: ``torch.Generator`` (the JAX function's key); the
        values are drawn on its device
    :param points: (N, F) tensor with xyz leading
    :param gt_boxes: (M, 7) tensor [x, y, z, l, w, h, yaw]
    :returns: (points', gt_boxes'), same shapes, dtypes and device
    """
    dt, g, d = points.dtype, generator, generator.device
    flip = torch.rand((), generator=g, device=d) < flip_prob
    theta = torch.empty((), dtype=dt, device=d).uniform_(
        -rot_range, rot_range, generator=g)
    scale = torch.empty((), dtype=dt, device=d).uniform_(
        scale_range[0], scale_range[1], generator=g)
    shift = torch.randn(3, dtype=dt, device=d, generator=g) * translate_std
    dev = points.device
    return _global_transform(points, gt_boxes, flip.to(dev), theta.to(dev),
                             scale.to(dev), shift.to(dev))


def _global_transform(points, gt_boxes, flip, theta, scale, shift):
    """:func:`global_augment` for given draws: ``flip`` a bool, ``theta``
    and ``scale`` scalars and ``shift`` (3,), 0-d/1-d tensors on the
    points' device. The rotation is written as elementwise products in
    float32 (the JAX function's ``xyz[:, :2] @ rot.T``: a TF32 matmul on
    the card would move points by ~1e-3 m)."""
    dt = points.dtype
    sign = torch.where(flip, -1.0, 1.0).to(dt)
    x, y, z = points[:, 0], points[:, 1] * sign, points[:, 2]
    bx = gt_boxes.clone()
    bx[:, 1] = bx[:, 1] * sign
    bx[:, 6] = bx[:, 6] * sign

    c, s = torch.cos(theta), torch.sin(theta)
    x, y = x * c - y * s, x * s + y * c
    bxx, bxy = bx[:, 0] * c - bx[:, 1] * s, bx[:, 0] * s + bx[:, 1] * c
    bx = torch.cat([bxx[:, None], bxy[:, None], bx[:, 2:6],
                    bx[:, 6:7] + theta], dim=1)

    xyz = torch.stack([x, y, z], dim=1) * scale + shift
    bx = torch.cat([bx[:, :6] * scale, bx[:, 6:7]], dim=1)
    bx = torch.cat([bx[:, :3] + shift, bx[:, 3:]], dim=1)
    return torch.cat([xyz, points[:, 3:]], dim=1), bx


def perobject_augment(generator, points, gt_boxes, gt_mask,
                      rot_range=0.3925, translate_std=(1.0, 1.0, 0.5)):
    """Perturb each GT box and its interior points on their own (SECOND
    Sec. 3.3 "noise per object"), with fixed shapes.

    Each box proposes a rotation about its centre by U(-rot_range,
    rot_range) and a shift by N(0, translate_std). A proposal is accepted
    only if its BEV footprint touches neither another box's proposal nor
    its original (one-shot, order-independent: rotated IoU > 0 in either
    (M, M) matrix, K1 on the card). Points inside an accepted box (by its
    original pose; a point inside several goes with the first) move
    rigidly with it.

    :param generator: ``torch.Generator`` (the JAX function's key)
    :param points: (N, F) tensor with xyz leading
    :param gt_boxes: (M, 7) [x, y, z, l, w, h, yaw] (padded rows allowed)
    :param gt_mask: (M,) bool valid-box mask
    :returns: (points', gt_boxes'), same shapes, dtypes and device
    """
    m, dt, g, d = gt_boxes.shape[0], gt_boxes.dtype, generator, \
        generator.device
    dtheta = torch.empty(m, dtype=dt, device=d).uniform_(
        -rot_range, rot_range, generator=g)
    shift = torch.randn((m, 3), dtype=dt, device=d, generator=g)
    dev = gt_boxes.device
    shift = shift.to(dev) * torch.tensor(translate_std, dtype=dt).to(dev)
    return _perobject_transform(points, gt_boxes, gt_mask, dtheta.to(dev),
                                shift)


def _perobject_transform(points, gt_boxes, gt_mask, dtheta, shift):
    """:func:`perobject_augment` for given draws ``dtheta`` (M,) and
    ``shift`` (M, 3) (already scaled by ``translate_std``)."""
    m = gt_boxes.shape[0]
    dev = gt_boxes.device
    prop = gt_boxes.clone()
    prop[:, 0:3] = prop[:, 0:3] + shift
    prop[:, 6] = prop[:, 6] + dtheta

    off_diag = ~torch.eye(m, dtype=torch.bool, device=dev)
    vv = gt_mask[:, None] & gt_mask[None, :] & off_diag
    with torch.no_grad():
        ipp = rbox_iou_matrix(_bev(prop), _bev(prop))
        ipo = rbox_iou_matrix(_bev(prop), _bev(gt_boxes))
    collide = (vv & ((ipp > 0) | (ipo > 0))).any(dim=1)
    accept = gt_mask & ~collide
    final = torch.where(accept[:, None], prop, gt_boxes)

    # membership against the original boxes, the first owner wins: the
    # lowest box index holding the point (no argmax over a bool mask,
    # whose tie order the card does not promise)
    inmask = box3dp_crop(points[:, :3], gt_boxes) & accept[:, None]
    owned = inmask.any(dim=0)
    ids = torch.arange(m, device=dev)[:, None]
    owner = torch.where(owned, torch.where(inmask, ids, m).amin(dim=0), 0)

    c = gt_boxes[owner, 0:3]
    th = dtheta[owner]
    cs, sn = torch.cos(th), torch.sin(th)
    rel = points[:, :3] - c
    rx = rel[:, 0] * cs - rel[:, 1] * sn
    ry = rel[:, 0] * sn + rel[:, 1] * cs
    moved = torch.stack([rx, ry, rel[:, 2]], dim=1) + c + shift[owner]
    xyz = torch.where(owned[:, None], moved.to(points.dtype), points[:, :3])
    return torch.cat([xyz, points[:, 3:]], dim=1), final


# ---------------------------------------------------------------------------
# GT sampling (host-side input pipeline)
# ---------------------------------------------------------------------------

def build_gt_database(frames, min_points=5, device=None):
    """Harvest a GT-sample database from ``(points, boxes7, labels)``
    frames (numpy).

    :param frames: iterable of tuples: points (N, F) float32, boxes (M, 7),
        labels (M,) int
    :param device: where the crops run (default CUDA)
    :returns: dict label -> list of (box7, interior points), the points in
        the box's frame (so pasting is a rotation and a translation)
    """
    db = {}
    for points, boxes, labels in frames:
        if len(boxes) == 0:
            continue
        crops = box3dp_crop(points[:, :3].astype(np.float32),
                            np.asarray(boxes, np.float32), device=device)
        for i, (box, lab) in enumerate(zip(boxes, labels)):
            mask = np.asarray(crops[i])
            if int(mask.sum()) < min_points:
                continue
            pts = np.array(points[mask], np.float32)
            c, s = np.cos(-box[6]), np.sin(-box[6])
            local = pts.copy()
            local[:, 0] = c * (pts[:, 0] - box[0]) - s * (pts[:, 1] - box[1])
            local[:, 1] = s * (pts[:, 0] - box[0]) + c * (pts[:, 1] - box[1])
            local[:, 2] = pts[:, 2] - box[2]
            db.setdefault(int(lab), []).append(
                (np.asarray(box, np.float32), local))
    return db


def sample_ground_truths(rng, db, points, gt_boxes, gt_labels,
                         max_per_class=10, iou_threshold=0.0, device=None):
    """Paste sampled GT objects into a frame (SECOND's sampling step).

    Candidates are drawn per class from ``db`` at their original pose and
    rejected if their BEV rotated IoU (float64, :func:`box2d_iou` on
    ``device``, default CUDA) with any box already there or accepted
    exceeds ``iou_threshold``.

    :param rng: ``np.random.Generator``
    :returns: (points', gt_boxes', gt_labels') numpy arrays
    """
    def bev(b):
        return np.concatenate([b[..., 0:2], b[..., 3:5], b[..., 6:7]],
                              axis=-1)

    cur_boxes = list(np.asarray(gt_boxes, np.float32))
    cur_labels = list(np.asarray(gt_labels))
    add_points = []
    for lab, samples in db.items():
        have = sum(1 for l in cur_labels if int(l) == int(lab))
        want = max_per_class - have
        if want <= 0 or not samples:
            continue
        order = rng.permutation(len(samples))
        for j in order[: 3 * want]:
            if want <= 0:
                break
            box, local = samples[j]
            if cur_boxes:
                ious = np.asarray(box2d_iou(
                    bev(box[None]), bev(np.stack(cur_boxes)),
                    method="rbox", device=device))[0]
                if ious.max() > iou_threshold:
                    continue
            c, s = np.cos(box[6]), np.sin(box[6])
            pts = local.copy()
            pts[:, 0] = c * local[:, 0] - s * local[:, 1] + box[0]
            pts[:, 1] = s * local[:, 0] + c * local[:, 1] + box[1]
            pts[:, 2] = local[:, 2] + box[2]
            add_points.append(pts)
            cur_boxes.append(box)
            cur_labels.append(lab)
            want -= 1

    if add_points:
        points = np.concatenate([np.asarray(points, np.float32)]
                                + add_points, axis=0)
    return (np.asarray(points, np.float32),
            np.stack(cur_boxes) if cur_boxes else np.zeros((0, 7), np.float32),
            np.asarray(cur_labels))


def flip_camera_frame(image, intrinsics, gt_boxes):
    """Horizontal mirror of a camera frame for monocular 3D detection:
    the image's columns reversed, the principal point reflected
    (``cx' = W - 1 - cx``), camera-frame x negated and the yaw reflected
    about the camera y axis (``ry' = pi - ry``, wrapped into (-pi, pi]).

    :param image: (H, W, C); ``intrinsics`` (3, 3); ``gt_boxes`` (M, 7)
        camera-frame [x, y, z, l, w, h, ry]; numpy arrays or tensors
    :returns: (image', intrinsics', gt_boxes'), numpy for numpy inputs,
        tensors on the inputs' device for tensors
    """
    w = image.shape[1]
    if isinstance(image, torch.Tensor):
        img = image.flip(1)
        k = torch.as_tensor(intrinsics).clone()
        b = torch.as_tensor(gt_boxes).clone()
        where = torch.where
    else:
        img = image[:, ::-1]
        k = np.array(intrinsics)
        b = np.array(gt_boxes)
        where = np.where
    k[0, 2] = w - 1.0 - k[0, 2]
    ry = math.pi - b[:, 6]
    ry = where(ry > math.pi, ry - 2 * math.pi, ry)
    b[:, 0] = -b[:, 0]
    b[:, 6] = ry
    return img, k, b

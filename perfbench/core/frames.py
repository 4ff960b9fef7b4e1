"""KITTI-like lidar frames from a seed, and the pools the cells draw on.

``hit_box`` and ``kitti_like_points`` are frozen copies of
``chip_smoke.py`` ``hit_box`` (l. 347) and ``kitti_like_points``
(l. 367), kept here so that the yardstick does not move when the
program's smoke script does. This module imports numpy only: the pool's
worker processes start from it.
"""

import multiprocessing
import os

import numpy as np

__all__ = ["hit_box", "kitti_like_points", "frame_seed", "make_pool",
           "augment"]


def hit_box(d, t, centre, half, yaw):
    """The ray caster's box test: rays ``d`` (R, 3) from the sensor (the
    origin) against a box of half extents ``half`` at ``centre`` turned by
    ``yaw`` about z (slabs in the box's frame); a ray that enters it nearer
    than its current range ``t`` (R,) gets that range, in place."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    rot = np.array([[cy, sy, 0.0], [-sy, cy, 0.0], [0.0, 0.0, 1.0]])
    o = rot @ -centre                      # the sensor in box coords
    dl = d @ rot.T
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-half - o) / dl
        t2 = (half - o) / dl
    near = np.nanmax(np.minimum(t1, t2), axis=1)
    far = np.nanmin(np.maximum(t1, t2), axis=1)
    hit = (near <= far) & (near > 0) & (near < t)
    t[hit] = near[hit]


def kitti_like_points(seed, objects=16, az_step_deg=0.08,
                      with_boxes=False):
    """A seeded frame in the shape of a KITTI scan cropped to the camera's
    field of view: a 64-beam sensor 1.73 m above a ground plane
    (elevations -24.8 to +2 degrees, ``az_step_deg`` between azimuths over
    the camera's 90 degrees, as an HDL-64E at 10 Hz), each ray cast onto
    the ground, onto a street front each side (facades, and between them
    trees whose hits scatter up to 5 m deep) and onto ``objects`` car-sized
    boxes (about 3.9 x 1.6 x 1.56 m, any yaw) standing 5-60 m away; the
    nearest hit within 80 m is kept, with 2 cm of range noise and a random
    intensity, inside second_kitti's bounds. ~70k points. With
    ``with_boxes`` it returns (points, boxes): the cars as (objects, 7)
    [x, y, z, l, w, h, yaw] float64 rows in the sensor frame."""
    rng = np.random.default_rng(seed)
    height = 1.73
    elev = np.deg2rad(np.linspace(-24.8, 2.0, 64))
    az = np.deg2rad(np.arange(-45.0, 45.0, az_step_deg))
    e, a = np.meshgrid(elev, az, indexing="ij")
    d = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)],
                 -1).reshape(-1, 3)
    t = np.full(len(d), np.inf)
    down = d[:, 2] < 0
    t[down] = height / -d[down, 2]
    # a facade each side of the street, with gaps between buildings
    for side in (1.0, -1.0):
        off = side * rng.uniform(6.0, 10.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            tw = np.where(d[:, 1] * side > 0, off / d[:, 1], np.inf)
        hx, hz = d[:, 0] * tw, d[:, 2] * tw
        with np.errstate(invalid="ignore"):
            gaps = np.sin(hx * rng.uniform(0.2, 0.4)) > 0.6
        wall = (hx > 3.0) & (hz < 6.0 - height) & (tw < t)
        t[wall & gaps] = tw[wall & gaps]
        # between the buildings, trees: hits scattered up to 5 m deep
        tree = wall & ~gaps
        t[tree] = tw[tree] * (1.0 + rng.uniform(0.0, 5.0, tree.sum())
                              / np.abs(off))
    r = rng.uniform(5.0, 60.0, objects)
    ang = rng.uniform(-0.65, 0.65, objects)
    yaw = rng.uniform(-np.pi, np.pi, objects)
    half = np.stack([rng.uniform(3.6, 4.3, objects), rng.uniform(1.5, 1.8,
                     objects), rng.uniform(1.4, 1.7, objects)], -1) / 2
    for i in range(objects):
        centre = np.array([r[i] * np.cos(ang[i]), r[i] * np.sin(ang[i]),
                           -height + half[i, 2]])
        hit_box(d, t, centre, half[i], yaw[i])
    keep = t < 80.0
    pts = d[keep] * (t[keep] + rng.normal(0.0, 0.02, keep.sum()))[:, None]
    inside = ((pts[:, 0] >= 0) & (pts[:, 0] < 70.4) & (np.abs(pts[:, 1]) < 40)
              & (pts[:, 2] >= -3) & (pts[:, 2] < 1))
    pts = pts[inside]
    pts = np.concatenate([pts, rng.random((len(pts), 1))], 1).astype(
        np.float32)
    if not with_boxes:
        return pts
    centres = np.stack([r * np.cos(ang), r * np.sin(ang),
                        -height + half[:, 2]], -1)
    return pts, np.concatenate([centres, 2 * half, yaw[:, None]], 1)


def frame_seed(seed, stream, index):
    """The generator seed of frame ``index`` of pool ``stream`` (a rank)
    under the run's ``seed``: any whole number goes in, 64 bits come out."""
    return int(np.random.SeedSequence([int(seed) % 2 ** 64, stream,
                                       index]).generate_state(
                                           1, np.uint64)[0])


def augment(points, boxes, seed, flip=True, rotation=np.pi / 4,
            scale=(0.95, 1.05)):
    """OpenPCDet's KITTI global augmentation without ground-truth
    sampling, in numpy from ``seed``: a flip along x (y -> -y, yaw ->
    -yaw) with probability 1/2, a rotation about z drawn from
    [-rotation, rotation], a scaling drawn from ``scale``. Points leaving
    the scene stay: the voxelizers drop what lies outside their bounds."""
    rng = np.random.default_rng(seed)
    pts = points.astype(np.float64)
    bx = boxes.astype(np.float64)
    if flip and rng.random() < 0.5:
        pts[:, 1] = -pts[:, 1]
        bx[:, 1] = -bx[:, 1]
        bx[:, 6] = -bx[:, 6]
    a = rng.uniform(-rotation, rotation)
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s], [s, c]])
    pts[:, :2] = pts[:, :2] @ rot.T
    bx[:, :2] = bx[:, :2] @ rot.T
    bx[:, 6] = bx[:, 6] + a
    k = rng.uniform(*scale)
    pts[:, :3] *= k
    bx[:, :6] *= k
    bx[:, 6] = np.arctan2(np.sin(bx[:, 6]), np.cos(bx[:, 6]))
    return pts.astype(np.float32), bx.astype(np.float32)


def _one(args):
    seed, stream, index, kw, aug = args
    fs = frame_seed(seed, stream, index)
    if aug is None:
        return kitti_like_points(fs, **kw)
    pts, boxes = kitti_like_points(fs, with_boxes=True, **kw)
    return augment(pts, boxes, fs + 1, **aug)


def make_pool(seed, count, stream=0, frame=None, augmentation=None,
              workers=None):
    """``count`` frames of stream ``stream`` under ``seed``, made in
    worker processes: points (N, 4) float32 each, or (points, boxes)
    pairs with ``augmentation`` (keyword arguments of :func:`augment`).
    ``frame`` holds keyword arguments of :func:`kitti_like_points`."""
    jobs = [(seed, stream, i, dict(frame or {}), augmentation)
            for i in range(count)]
    workers = max(1, min(workers or os.cpu_count() or 1, count))
    if workers == 1:
        return [_one(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    pool = ctx.Pool(workers)
    try:
        out = pool.map(_one, jobs)
    finally:
        pool.close()
        pool.join()
    return out

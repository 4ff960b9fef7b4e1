"""The port's native host oracle (``d3d_tpu_torch/native``: its own copy
of ``geometry.cpp`` and ``voxel.cpp``, built with g++ into
``build/d3d_tpu_torch/``) against the JAX package's library exactly, and
against the port's own box and voxel API as ``tests/test_native.py`` holds
the JAX package's: rotated and axis-aligned IoU within 1e-9 (adversarial
boxes 1e-7), NMS keep masks, containment, and the dense and sparse
voxelizers exactly (the dense mean's aggregates within its float32
cumsum's 2e-3)."""

from pathlib import Path

import numpy as np
import pytest
import torch

import _limits  # noqa: F401  (one torch thread a process)

from d3d_tpu import native as J

import d3d_tpu_torch.native as T
from d3d_tpu_torch.ops.box import box2d_iou, box2d_nms, crop_mask_2dr
from d3d_tpu_torch.ops.voxel import (voxelize_dense_padded,
                                     voxelize_sparse_padded)

ROOT = Path(__file__).resolve().parents[1]
BOUNDS = np.asarray([0.0, 8.0, -4.0, 4.0, -2.0, 2.0])
SHAPE = (16, 16, 4)


def _boxes(rng, n):
    return np.stack([rng.random(n) * 20, rng.random(n) * 20,
                     rng.random(n) * 6 + 1, rng.random(n) * 6 + 1,
                     rng.random(n) * 6 - 3], axis=1)


def _adversarial_boxes(rng, n):
    """Slivers, huge boxes, yaws at multiples of pi/2, near-identical
    pairs and edge-sharing squares (``tests/test_native.py``'s kinds)."""
    kinds = rng.integers(0, 6, n)
    b = _boxes(rng, n)
    b[:, 3] = np.where(kinds == 0, 1e-3, b[:, 3])
    b[:, 2] = np.where(kinds == 1, 500.0, b[:, 2])
    b[:, 4] = np.where(kinds == 2, rng.integers(-2, 3, n) * (np.pi / 2),
                       b[:, 4])
    dup = np.nonzero(kinds == 3)[0]
    dup = dup[dup > 0]
    b[dup] = b[dup - 1] + 1e-7
    edge = np.nonzero(kinds == 4)[0]
    b[edge, 2:4], b[edge, 4] = 2.0, 0.0
    edge2 = edge[edge > 0]
    b[edge2, 0] = b[edge2 - 1, 0] + b[edge2 - 1, 2] / 2 + 1.0
    return b


def _cloud(rng, n=4000):
    """20% of the points out of bounds, some at negative fractional
    cells."""
    return np.stack([rng.random(n) * 10 - 1, rng.random(n) * 10 - 5,
                     rng.random(n) * 5 - 2.5, rng.random(n)],
                    axis=1).astype(np.float32)


def _lattice_cloud(rng):
    """Points on cell boundaries, duplicates and far out-of-bounds ones."""
    vx = (BOUNDS[1] - BOUNDS[0]) / SHAPE[0]
    vy = (BOUNDS[3] - BOUNDS[2]) / SHAPE[1]
    xs = rng.choice(BOUNDS[0] + np.arange(SHAPE[0] + 1) * vx, 256)
    ys = rng.choice(BOUNDS[2] + np.arange(SHAPE[1] + 1) * vy, 256)
    zs = rng.choice([BOUNDS[4], 0.0, BOUNDS[5] - 1e-6, BOUNDS[5]], 256)
    pts = np.stack([xs, ys, zs, rng.random(256)], axis=1)
    return np.concatenate([pts, pts[:32], pts[:16] + [1e3, 0, 0, 0]]
                          ).astype(np.float32)


def test_available_and_built_outside_both_packages():
    assert T.available()
    lib = Path(T._LIB._name)
    assert lib.parent == ROOT / "build" / "d3d_tpu_torch"
    assert sorted(p.name for p in (ROOT / "d3d_tpu_torch" / "native")
                  .iterdir() if p.suffix != ".pyc" and p.is_file()) == \
        ["__init__.py", "geometry.cpp", "voxel.cpp"]
    assert T.__all__ == J.__all__


@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_geometry_equals_the_jax_library(kind):
    rng = np.random.default_rng(3)
    make = _boxes if kind == "random" else _adversarial_boxes
    b1, b2 = make(rng, 48), make(rng, 32)
    s = rng.random(48)
    p = rng.random((256, 2)) * 20
    for fn in ("rbox_iou_matrix", "aabox_iou_matrix"):
        np.testing.assert_array_equal(getattr(T, fn)(b1, b2),
                                      getattr(J, fn)(b1, b2))
    for method in ("rbox", "box"):
        for thr in (0.05, 0.3, 0.6):
            for st in (0.0, 0.5):
                np.testing.assert_array_equal(
                    T.nms2d(b1, s, iou_method=method, iou_threshold=thr,
                            score_threshold=st),
                    J.nms2d(b1, s, iou_method=method, iou_threshold=thr,
                            score_threshold=st))
    np.testing.assert_array_equal(T.box2dr_contains(b1, p),
                                  J.box2dr_contains(b1, p))


@pytest.mark.parametrize("case", ["mean", "max", "min", "lattice"])
def test_voxelizers_equal_the_jax_library(case):
    rng = np.random.default_rng(5)
    pts = _lattice_cloud(rng) if case == "lattice" else _cloud(rng)
    red = "mean" if case == "lattice" else case
    got = T.voxelize_dense(pts, SHAPE, BOUNDS, 8, 300, reduction=red)
    want = J.voxelize_dense(pts, SHAPE, BOUNDS, 8, 300, reduction=red)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, want = T.voxelize_sparse(pts, 0.37), J.voxelize_sparse(pts, 0.37)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["random", "adversarial"])
def test_oracle_holds_the_port_box_api(kind):
    """The port's float64 IoU (``precise=True``), NMS and containment on
    the CPU against the oracle."""
    rng = np.random.default_rng(7)
    make = _boxes if kind == "random" else _adversarial_boxes
    tol = 1e-9 if kind == "random" else 1e-7
    b1, b2 = make(rng, 40), make(rng, 24)
    for method, fn in (("rbox", T.rbox_iou_matrix),
                       ("box", T.aabox_iou_matrix)):
        got = box2d_iou(b1, b2, method=method, precise=True, device="cpu")
        np.testing.assert_allclose(np.asarray(got), fn(b1, b2), rtol=0,
                                   atol=tol, err_msg=method)
    b = make(rng, 64)
    s = rng.random(64)
    for thr in (0.05, 0.3, 0.6):
        keep = box2d_nms(b, s, iou_method="rbox", iou_threshold=thr,
                         device="cpu")
        np.testing.assert_array_equal(
            np.asarray(keep), T.nms2d(b, s, iou_method="rbox",
                                      iou_threshold=thr))
    p = rng.random((256, 2)) * 20
    mask = crop_mask_2dr(torch.as_tensor(p), torch.as_tensor(b[:16]))
    np.testing.assert_array_equal(mask.numpy(), T.box2dr_contains(b[:16], p))


@pytest.mark.parametrize("case", ["mean", "max", "min", "lattice"])
def test_oracle_holds_the_port_voxelizers(case):
    rng = np.random.default_rng(9)
    pts = _lattice_cloud(rng) if case == "lattice" else _cloud(rng)
    red = "mean" if case == "lattice" else case
    got = voxelize_dense_padded(torch.as_tensor(pts), SHAPE,
                                torch.as_tensor(BOUNDS, dtype=torch.float32),
                                8, 300, red)
    want = T.voxelize_dense(pts, SHAPE, BOUNDS, 8, 300, reduction=red)
    nv = want["nvoxels"]
    assert int(got.nvoxels) == nv and 0 < nv <= 300
    for k in ("coords", "voxel_npoints"):
        np.testing.assert_array_equal(getattr(got, k).numpy()[:nv],
                                      want[k][:nv], err_msg=k)
    np.testing.assert_array_equal(got.voxel_pmask.numpy(),
                                  want["voxel_pmask"])
    np.testing.assert_array_equal(got.voxels.numpy()[:nv],
                                  want["voxels"][:nv].astype(np.float32))
    tol = 2e-3 if red == "mean" else 0.0
    np.testing.assert_allclose(got.aggregates.numpy()[:nv],
                               want["aggregates"][:nv], rtol=tol, atol=tol)
    sparse = voxelize_sparse_padded(torch.as_tensor(pts),
                                    torch.tensor(0.37))
    want = T.voxelize_sparse(pts, 0.37)
    nv = want["nvoxels"]
    assert int(sparse.nvoxels) == nv
    np.testing.assert_array_equal(sparse.points_mapping.numpy(),
                                  want["points_mapping"])
    np.testing.assert_array_equal(sparse.coords.numpy()[:nv], want["coords"])
    np.testing.assert_array_equal(sparse.voxel_npoints.numpy()[:nv],
                                  want["voxel_npoints"])

"""Native host-side geometry library (port of ``d3d_tpu.native``): the C++
Sutherland-Hodgman oracle / CPU fallback and the hash-map voxelizers.

The port keeps its own copy of the sources (``geometry.cpp``,
``voxel.cpp``). They are compiled lazily with g++ on first use into
``build/d3d_tpu_torch/`` beside the package, as the CUDA kernels are
(:mod:`d3d_tpu_torch.ops._build`), under a name that hashes the sources and
flags, so a changed source never loads a stale build and nothing is written
into the package. Bound through ctypes (no pybind11; see geometry.cpp)."""

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "rbox_iou_matrix", "aabox_iou_matrix", "nms2d",
           "box2dr_contains", "voxelize_dense", "voxelize_sparse"]

_HERE = Path(__file__).parent
BUILD_DIR = _HERE.parents[1] / "build" / "d3d_tpu_torch"
_LIB = None
_BUILD_ERROR = None
_SOURCES = ("geometry.cpp", "voxel.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC"]


def _target():
    h = hashlib.sha256()
    for s in _SOURCES:
        h.update((_HERE / s).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libd3dhost-{h.hexdigest()[:16]}.so"


def _build():
    global _LIB, _BUILD_ERROR
    if _LIB is not None or _BUILD_ERROR is not None:
        return
    try:
        so = _target()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # a private name first: concurrent processes each build, and
            # the rename makes whichever finishes first the one loaded
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(
                ["g++", *_FLAGS, *(str(_HERE / s) for s in _SOURCES),
                 "-o", str(tmp)], check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        _bind(lib)
    except (OSError, subprocess.CalledProcessError, AttributeError) as e:
        # AttributeError: a library missing a symbol that _bind expects —
        # report unavailable rather than raising from available()
        _BUILD_ERROR = e
        return
    _LIB = lib


def _bind(lib):
    dp = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    bp = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lp = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.d3d_rbox_iou_matrix.argtypes = [dp, i64, dp, i64, dp]
    lib.d3d_aabox_iou_matrix.argtypes = [dp, i64, dp, i64, dp]
    lib.d3d_nms2d.argtypes = [dp, dp, i64, ctypes.c_int, ctypes.c_double,
                              ctypes.c_double, bp]
    lib.d3d_box2dr_contains.argtypes = [dp, i64, dp, i64, bp]
    lib.d3d_voxelize_dense.argtypes = [dp, i64, i64, dp, lp, i64, i64,
                                       ctypes.c_int, dp, lp, bp, lp, dp,
                                       lp]
    lib.d3d_voxelize_sparse.argtypes = [dp, i64, i64, dp, lp, lp, lp, lp]


def available():
    """True when the native library could be compiled and loaded."""
    _build()
    return _LIB is not None


def _lib():
    _build()
    if _LIB is None:
        raise RuntimeError(
            "native geometry library unavailable: %r" % (_BUILD_ERROR,))
    return _LIB


def rbox_iou_matrix(boxes1, boxes2):
    """(N, 5) x (M, 5) -> (N, M) rotated IoU (exact f64 polygon clipping)."""
    b1 = np.ascontiguousarray(boxes1, np.float64)
    b2 = np.ascontiguousarray(boxes2, np.float64)
    out = np.empty((len(b1), len(b2)), np.float64)
    _lib().d3d_rbox_iou_matrix(b1, len(b1), b2, len(b2), out)
    return out


def aabox_iou_matrix(boxes1, boxes2):
    """(N, 5) x (M, 5) -> (N, M) IoU of the corner AABBs."""
    b1 = np.ascontiguousarray(boxes1, np.float64)
    b2 = np.ascontiguousarray(boxes2, np.float64)
    out = np.empty((len(b1), len(b2)), np.float64)
    _lib().d3d_aabox_iou_matrix(b1, len(b1), b2, len(b2), out)
    return out


def nms2d(boxes, scores, iou_method="rbox", iou_threshold=0.0,
          score_threshold=0.0):
    """Greedy hard NMS; returns the keep mask (same semantics as
    d3d_tpu_torch.ops.nms)."""
    b = np.ascontiguousarray(boxes, np.float64)
    s = np.ascontiguousarray(scores, np.float64)
    sup = np.empty(len(b), np.uint8)
    _lib().d3d_nms2d(b, s, len(b), 1 if iou_method == "rbox" else 0,
                     iou_threshold, score_threshold, sup)
    return ~sup.astype(bool)


def box2dr_contains(boxes, points):
    """(M, 5) x (N, 2) -> (M, N) boolean containment matrix."""
    b = np.ascontiguousarray(boxes, np.float64)
    p = np.ascontiguousarray(points, np.float64)
    out = np.empty((len(b), len(p)), np.uint8)
    _lib().d3d_box2dr_contains(b, len(b), p, len(p), out)
    return out.astype(bool)


_REDUCTIONS = {"none": 0, "mean": 1, "max": 2, "min": 3}


def voxelize_dense(points, shape, bounds, max_points, max_voxels,
                   reduction="none"):
    """Reference-semantics hash-map dense voxelization (oracle for
    :func:`d3d_tpu_torch.ops.voxel.voxelize_dense_padded`, ``order_mode=
    "encounter"``). Cell assignment runs in f32 like the device path;
    aggregates accumulate in f64.

    :returns: dict(voxels (V,P,F), coords (V,3), voxel_pmask (V,P),
        voxel_npoints (V,), aggregates (V,F) or None, nvoxels int)
    """
    pts = np.ascontiguousarray(points, np.float64)
    n, f = pts.shape
    sh = np.ascontiguousarray(shape, np.int64)
    bnd = np.ascontiguousarray(bounds, np.float64)
    voxels = np.zeros((max_voxels, max_points, f), np.float64)
    coords = np.zeros((max_voxels, 3), np.int64)
    pmask = np.zeros((max_voxels, max_points), np.uint8)
    npoints = np.zeros(max_voxels, np.int64)
    agg = np.zeros((max_voxels, f), np.float64)
    nv = np.zeros(1, np.int64)
    _lib().d3d_voxelize_dense(pts, n, f, bnd, sh, max_points, max_voxels,
                              _REDUCTIONS[reduction], voxels, coords, pmask,
                              npoints, agg, nv)
    return dict(voxels=voxels, coords=coords, voxel_pmask=pmask.astype(bool),
                voxel_npoints=npoints,
                aggregates=None if reduction == "none" else agg,
                nvoxels=int(nv[0]))


def voxelize_sparse(points, voxel_size):
    """Reference-semantics sparse voxelization (oracle for
    :func:`d3d_tpu_torch.ops.voxel.voxelize_sparse_padded`): unbounded grid,
    every point mapped, voxel ids in first-encounter order.

    :returns: dict(points_mapping (N,), coords (V,3), voxel_npoints (V,),
        nvoxels int)
    """
    pts = np.ascontiguousarray(points, np.float64)
    n, f = pts.shape
    vs = np.ascontiguousarray(
        np.broadcast_to(np.asarray(voxel_size, np.float64), (3,)))
    pm = np.zeros(n, np.int64)
    coords = np.zeros((max(n, 1), 3), np.int64)
    npoints = np.zeros(max(n, 1), np.int64)
    nv = np.zeros(1, np.int64)
    _lib().d3d_voxelize_sparse(pts, n, f, vs, pm, coords, npoints, nv)
    v = int(nv[0])
    return dict(points_mapping=pm, coords=coords[:v],
                voxel_npoints=npoints[:v], nvoxels=v)

"""PointPainting: camera -> lidar feature fusion (port of
``d3d_tpu.ops.painting``).

Vora et al., "PointPainting: Sequential Fusion for 3D Object Detection"
(CVPR 2020, arXiv:1911.10150): project every lidar point into a camera
feature map (typically per-class semantic scores) and append the
bilinearly sampled features to the point's channels; the painted cloud
then feeds any lidar detector unchanged (the port's voxelizers carry any
number of point columns).

On the device: the rotation as elementwise products (no TF32 matmul), an
elementwise projection and four clamped gathers for the bilinear sample.
``painting_rig`` factors a dataset calibration on the host, once per
calibration, in numpy.
"""

import numpy as np
import torch

from ..utils import as_tensor
from .voxel import _to_int32

__all__ = ["paint_points", "paint_points_multi", "painting_rig",
           "bilinear_sample"]


def _project(xyz, intrinsics, extrinsic=None):
    """Pinhole projection shared by the single- and multi-camera
    painters: returns (u, v, ahead) with behind-lens rows guarded. The
    rotation is three products and two adds a row, in full float32."""
    if extrinsic is not None:
        r, t = extrinsic[:3, :3], extrinsic[:3, 3]
        xyz = torch.stack([xyz[:, 0] * r[i, 0] + xyz[:, 1] * r[i, 1]
                           + xyz[:, 2] * r[i, 2] + t[i] for i in range(3)],
                          dim=-1)
    z = xyz[:, 2]
    ahead = z > 1e-3
    zs = torch.where(ahead, z, 1.0)
    u = intrinsics[0, 0] * xyz[:, 0] / zs + intrinsics[0, 2]
    v = intrinsics[1, 1] * xyz[:, 1] / zs + intrinsics[1, 2]
    return u, v, ahead


def _floor_index(x):
    """floor(x) as an int64 index, NaN -> 0 as XLA's convert (x is
    already clipped into the image)."""
    return _to_int32(torch.floor(x)).to(torch.int64)


def bilinear_sample(image, u, v, valid=None, fill=0.0):
    """Bilinearly sample ``image`` (H, W, C) at pixel coordinates
    (u = column, v = row); out-of-bounds or ``~valid`` samples return
    ``fill``. Border-clamped gathers, mask applied after; a NaN coordinate
    is out of bounds (it gathers pixel 0, then takes ``fill``)."""
    h, w = image.shape[0], image.shape[1]
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    if valid is not None:
        inb = inb & valid
    u = torch.clamp(u, 0.0, w - 1.0)
    v = torch.clamp(v, 0.0, h - 1.0)
    u0 = _floor_index(u)
    v0 = _floor_index(v)
    u1 = torch.clamp_max(u0 + 1, w - 1)
    v1 = torch.clamp_max(v0 + 1, h - 1)
    fu = (u - u0.to(u.dtype))[:, None]
    fv = (v - v0.to(v.dtype))[:, None]
    s = (image[v0, u0] * (1 - fu) * (1 - fv)
         + image[v0, u1] * fu * (1 - fv)
         + image[v1, u0] * (1 - fu) * fv
         + image[v1, u1] * fu * fv)
    return torch.where(inb[:, None], s, s.new_tensor(fill))


def _inputs(points, *others):
    points = as_tensor(points)
    return (points,) + tuple(None if o is None else as_tensor(
        o, device=points.device) for o in others)


def paint_points(points, image_feats, intrinsics, extrinsic=None,
                 fill=0.0):
    """Append camera-plane features to every point (PointPainting).

    :param points: (N, F) cloud, xyz first (lidar frame, or already
        camera frame when ``extrinsic`` is None); a tensor stays on its
        device, anything else goes to CUDA, and the other arrays follow it
    :param image_feats: (H, W, C) feature map in the camera plane
        (semantic scores, heatmaps, learned features)
    :param intrinsics: (3, 3) camera matrix
    :param extrinsic: optional (4, 4) lidar->camera homogeneous
        transform
    :param fill: feature value for points behind the camera or
        projecting outside the image
    :returns: (N, F + C) painted cloud
    """
    points, image_feats, intrinsics, extrinsic = _inputs(
        points, image_feats, intrinsics, extrinsic)
    u, v, ahead = _project(points[:, :3], intrinsics, extrinsic)
    feats = bilinear_sample(image_feats, u, v, valid=ahead, fill=fill)
    return torch.cat([points, feats.to(points.dtype)], dim=-1)


def paint_points_multi(points, image_feats, intrinsics, extrinsics,
                       fill=0.0):
    """Paint from a CAMERA RIG (e.g. nuScenes' six cameras): each point
    takes its features from the first camera (in stacking order) that
    sees it in front of the lens and inside the image; points no camera
    sees get ``fill``.

    :param image_feats: (Ncam, H, W, C) per-camera feature maps
    :param intrinsics: (Ncam, 3, 3); ``extrinsics`` (Ncam, 4, 4)
        lidar->camera transforms (devices as :func:`paint_points`)
    :returns: (N, F + C) painted cloud
    """
    points, image_feats, intrinsics, extrinsics = _inputs(
        points, image_feats, intrinsics, extrinsics)
    xyz = points[:, :3]
    ncam = image_feats.shape[0]
    feats, seen = [], []
    for c in range(ncam):
        u, v, ahead = _project(xyz, intrinsics[c], extrinsics[c])
        h, w = image_feats.shape[1], image_feats.shape[2]
        seen.append(ahead & (u >= 0) & (u <= w - 1) & (v >= 0)
                    & (v <= h - 1))
        feats.append(bilinear_sample(image_feats[c], u, v, valid=ahead,
                                     fill=fill))
    feats, seen = torch.stack(feats), torch.stack(seen)
    # the first seeing camera: the least index among those that see it (an
    # integer amin, not an argmax of a bool)
    cams = torch.arange(ncam, device=points.device)[:, None]
    first = torch.where(seen, cams, ncam).amin(dim=0)
    any_seen = first < ncam
    chosen = feats.gather(0, torch.clamp_max(first, ncam - 1)[None, :, None]
                          .expand(1, -1, feats.shape[-1]))[0]
    chosen = torch.where(any_seen[:, None], chosen, chosen.new_tensor(fill))
    return torch.cat([points, chosen.to(points.dtype)], dim=-1)


def painting_rig(calib, cameras, frame_from=None):
    """Build :func:`paint_points_multi`'s ``(intrinsics, extrinsics)``
    stacks from a dataset calibration (the port's ``TransformSet``). The
    stored camera "intrinsic" is a PROJECTION matrix that may carry a
    folded axis conversion (``rotate=True`` FLU->RDF, e.g. Waymo/nuScenes)
    or a 3x4 fourth column (a stereo baseline, e.g. KITTI-360's
    ``P_rect_01``); both are factored OUT here (an RQ decomposition into
    the upper-triangular K, the rotation and the baseline moved into the
    returned extrinsic), so ``_project``'s plain pinhole sees exactly what
    ``project_points_to_camera`` computes. Host numpy, once per
    calibration. Lens distortion is ignored: painting samples a FEATURE
    map, for which the few-pixel distortion error is noise.

    :returns: (intrinsics (Ncam, 3, 3) f32, extrinsics (Ncam, 4, 4) f32)
        numpy arrays
    """
    import scipy.linalg

    ks, exts = [], []
    for cam in cameras:
        m = calib.intrinsics.get(cam)
        if m is None:
            m = getattr(calib.intrinsics_meta[cam], "intri_matrix", None)
        if m is None:
            raise ValueError(f"{cam!r} has no camera projection matrix")
        m = np.asarray(m, np.float64)
        rt = np.asarray(
            calib.get_extrinsic(frame_to=cam, frame_from=frame_from),
            np.float64)
        k3 = m[:, :3]
        # fourth column = K * extra translation (stereo baseline)
        off = (np.linalg.solve(k3, m[:, 3]) if m.shape[1] == 4
               else np.zeros(3))
        # k3 = K (upper triangular) @ C (folded axis-conversion rotation)
        kp, crot = scipy.linalg.rq(k3)
        sgn = np.sign(np.diag(kp))
        sgn[sgn == 0] = 1.0
        kp = kp * sgn[None, :]          # positive-diagonal K ...
        crot = crot * sgn[:, None]      # ... sign absorbed into C
        conv = np.eye(4)
        conv[:3, :3] = crot
        conv[:3, 3] = crot @ off
        ks.append((kp / kp[2, 2]).astype(np.float32))
        exts.append((conv @ rt).astype(np.float32))
    return np.stack(ks), np.stack(exts)

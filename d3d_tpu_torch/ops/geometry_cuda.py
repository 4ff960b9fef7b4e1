"""The rotated-box IoU matrix through the CUDA kernel K1 (``csrc/rbox_iou.cu``),
the port of ``d3d_tpu.ops.geometry_pallas``.

The wrapper computes the (K, 10) box descriptors with torch, so the kernel
shares the plain version's trigonometry, and launches one thread per output
pair. A CPU tensor goes to the plain version
(:func:`d3d_tpu_torch.ops.geometry_soa._rbox_iou_matrix_plain`); a CUDA
tensor goes to the kernel or the call raises.
"""

import torch

from ._build import load_library
from .geometry_soa import _rbox_iou_matrix_plain

__all__ = ["rbox_iou_matrix", "box_descriptors"]


def box_descriptors(boxes):
    """(K, 5) xywhr -> (K, 10) [x0..x3, y0..y3, area, |corner| scale]."""
    x, y, w, h, r = (boxes[..., i] for i in range(5))
    dx, dy = w * 0.5, h * 0.5
    c, s = torch.cos(r), torch.sin(r)
    lx = (-dx, dx, dx, -dx)
    ly = (-dy, -dy, dy, dy)
    cx = [c * a - s * b + x for a, b in zip(lx, ly)]
    cy = [s * a + c * b + y for a, b in zip(lx, ly)]
    scale = torch.zeros_like(x)
    for arr in cx + cy:
        scale = torch.maximum(scale, arr.abs())
    return torch.stack(cx + cy + [w * h, scale], dim=-1)


def rbox_iou_matrix(b1, b2):
    """(N, 5) x (M, 5) xywhr -> (N, M) float32 IoU (forward-only).

    Inputs are cast to float32 like the Pallas version's. CPU tensors take
    the plain version; CUDA tensors launch K1 (counted in
    ``rbox_iou_matrix.launches``)."""
    b1 = b1.to(torch.float32)
    b2 = b2.to(torch.float32)
    if b1.ndim != 2 or b2.ndim != 2 or b1.shape[1] != 5 or b2.shape[1] != 5:
        raise ValueError(f"expected (N, 5) and (M, 5) boxes, got "
                         f"{tuple(b1.shape)} and {tuple(b2.shape)}")
    if b1.device != b2.device:
        raise ValueError(f"boxes on {b1.device} and {b2.device}")
    if b1.device.type == "cpu":
        return _rbox_iou_matrix_plain(b1, b2)
    if b1.device.type != "cuda":
        raise ValueError(f"no K1 kernel for device {b1.device}")
    n, m = b1.shape[0], b2.shape[0]
    if n == 0 or m == 0:
        return torch.empty((n, m), dtype=torch.float32, device=b1.device)
    da = box_descriptors(b1).contiguous()
    # NMS asks for boxes x boxes: one set of descriptors (~25 launches)
    db = da if b2 is b1 else box_descriptors(b2).contiguous()
    out = _launch(da, db)
    rbox_iou_matrix.launches += 1
    return out


rbox_iou_matrix.launches = 0


def _launch(da, db):
    """K1 on (N, 10) and (M, 10) contiguous f32 CUDA descriptors -> (N, M)."""
    n, m = da.shape[0], db.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=da.device)
    err = load_library("rbox_iou").d3d_rbox_iou_matrix(
        da.data_ptr(), db.data_ptr(), out.data_ptr(), n, m,
        torch.cuda.current_stream(da.device).cuda_stream)
    if err:
        raise RuntimeError(f"rbox_iou kernel launch failed: CUDA error {err}")
    return out

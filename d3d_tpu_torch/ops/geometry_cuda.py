"""The rotated-box IoU matrix through the CUDA kernel K1 (``csrc/rbox_iou.cu``),
the port of ``d3d_tpu.ops.geometry_pallas``.

The wrapper hands K1 the (K, 5) boxes; each block computes its boxes'
descriptors as :func:`box_descriptors` does, rejects the pairs whose extents
are too far apart to overlap (:func:`_reject_plain` is that test in torch)
and runs the IoU chain on the rest. A CPU tensor goes to the plain version
(:func:`d3d_tpu_torch.ops.geometry_soa._rbox_iou_matrix_plain`); a CUDA
tensor goes to the kernel or the call raises. K1 has a second output form
for ``nms2d`` alone (:func:`_rbox_overlap_bits`): the NMS scan's bit rows,
thresholded in the kernel, for the pairs above the diagonal only.

Both forms are ``torch.library`` custom ops, ``d3d_tpu_torch::rbox_iou_matrix``
and ``d3d_tpu_torch::rbox_overlap_bits``, so that ``torch.export`` keeps
them as nodes of a traced detector: a CUDA implementation that launches
K1 and counts the launch, a CPU one that is the plain version and counts
none, and a fake one that gives the output's shape and dtype. The wrappers
check their inputs and call the ops.
"""

import torch

from ._build import load_library, stream_handle
from .geometry_soa import _rbox_iou_matrix_plain
from .nms_cuda import pack_rows

__all__ = ["rbox_iou_matrix", "box_descriptors"]

# K1's reject test (csrc/rbox_iou.cu kRejectRel, kRejectMaxScale)
_REJECT_REL = 0.02
_REJECT_MAX_SCALE = 1e9


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


def _reject_info(desc):
    """Per box of (K, 10) f32 descriptors, what K1's reject test reads:
    the extent (xlo, xhi, ylo, yhi), its width + height, the shortest edge
    and whether every corner is finite and below ``_REJECT_MAX_SCALE``."""
    cx, cy = desc[:, 0:4], desc[:, 4:8]
    xlo, xhi = cx[:, 0], cx[:, 0]
    ylo, yhi = cy[:, 0], cy[:, 0]
    for i in range(1, 4):
        xlo, xhi = torch.minimum(xlo, cx[:, i]), torch.maximum(xhi, cx[:, i])
        ylo, yhi = torch.minimum(ylo, cy[:, i]), torch.maximum(yhi, cy[:, i])
    emin = torch.full_like(xlo, torch.inf)
    for i in range(4):
        j = (i + 1) % 4
        ex, ey = cx[:, j] - cx[:, i], cy[:, j] - cy[:, i]
        emin = torch.minimum(emin, torch.sqrt(ex * ex + ey * ey))
    ok = (desc[:, 9] <= _REJECT_MAX_SCALE) & torch.isfinite(desc[:, 8])
    return xlo, xhi, ylo, yhi, (xhi - xlo) + (yhi - ylo), emin, ok


def _reject_plain(b1, b2):
    """(N, 5) x (M, 5) f32 boxes -> (N, M) bool: the pairs K1 writes +0.0
    for without running the IoU chain, by the kernel's comparisons in its
    order (see the note at the top of csrc/rbox_iou.cu)."""
    da, db = box_descriptors(b1), box_descriptors(b2)
    axlo, axhi, aylo, ayhi, aext, aemin, aok = (
        v[:, None] for v in _reject_info(da))
    bxlo, bxhi, bylo, byhi, bext, bemin, bok = (
        v[None, :] for v in _reject_info(db))
    gap = torch.maximum(torch.maximum(bxlo - axhi, axlo - bxhi),
                        torch.maximum(bylo - ayhi, aylo - byhi))
    slack = gap - _REJECT_REL * (aext + bext)
    ceps = (torch.maximum(da[:, 9, None], db[None, :, 9]) + 1.0) * 1e-5
    return (aok & bok & (slack > 0)
            & (slack * torch.minimum(aemin, bemin) > 2.0 * ceps))


def _forward_only(b1, b2):
    """K1 has no backward: raise rather than hand back a matrix that
    autograd would treat as a constant (a silent zero gradient)."""
    if torch.is_grad_enabled() and (b1.requires_grad or b2.requires_grad):
        raise RuntimeError(
            "rbox_iou_matrix (kernel K1) is forward-only and gives no "
            "gradient; for a differentiable IoU use box2d_iou(..., "
            "precise=True) or geometry_soa.rbox_iou elementwise, or call it "
            "under torch.no_grad() on detached boxes")


def rbox_iou_matrix(b1, b2):
    """(N, 5) x (M, 5) xywhr -> (N, M) float32 IoU (forward-only: boxes
    that require a gradient raise while grad mode is on).

    Inputs are cast to float32 like the Pallas version's. CPU tensors take
    the plain version; CUDA tensors launch K1 (counted in
    ``rbox_iou_matrix.launches``)."""
    _forward_only(b1, b2)
    b1 = b1.to(torch.float32)
    b2 = b2.to(torch.float32)
    if b1.ndim != 2 or b2.ndim != 2 or b1.shape[1] != 5 or b2.shape[1] != 5:
        raise ValueError(f"expected (N, 5) and (M, 5) boxes, got "
                         f"{tuple(b1.shape)} and {tuple(b2.shape)}")
    if b1.device != b2.device:
        raise ValueError(f"boxes on {b1.device} and {b2.device}")
    if b1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K1 kernel for device {b1.device}")
    return torch.ops.d3d_tpu_torch.rbox_iou_matrix(b1, b2)


rbox_iou_matrix.launches = 0


@torch.library.custom_op("d3d_tpu_torch::rbox_iou_matrix", mutates_args=(),
                         device_types="cpu")
def _k1_matrix_op(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """K1's f32 form as an op; its CPU implementation is the plain
    version."""
    return _rbox_iou_matrix_plain(b1, b2)


@_k1_matrix_op.register_kernel("cuda")
def _k1_matrix_cuda(b1, b2):
    n, m = b1.shape[0], b2.shape[0]
    if n == 0 or m == 0:  # nothing to launch
        return torch.empty((n, m), dtype=torch.float32, device=b1.device)
    out = _launch(b1.contiguous(), b2.contiguous())
    rbox_iou_matrix.launches += 1
    return out


@_k1_matrix_op.register_fake
def _k1_matrix_fake(b1, b2):
    return b1.new_empty((b1.shape[0], b2.shape[0]), dtype=torch.float32)


def _launch(b1, b2, chains=None, out=None):
    """K1 on (N, 5) and (M, 5) contiguous f32 CUDA boxes, N, M > 0 ->
    (N, M), into ``out`` if given. ``chains``, a one-element int32 CUDA
    tensor, gets the number of pairs that ran the IoU chain added to it."""
    n, m = b1.shape[0], b2.shape[0]
    if out is None:
        out = b1.new_empty((n, m))
    err = load_library("rbox_iou").d3d_rbox_iou_matrix(
        b1.data_ptr(), b2.data_ptr(), out.data_ptr(), n, m,
        None if chains is None else chains.data_ptr(),
        stream_handle(b1.device))
    if err:
        raise RuntimeError(f"rbox_iou kernel launch failed: CUDA error {err}")
    _FORMS["matrix"] += 1
    return out


# K1's launches by output form (every launch, checks included; the
# wrappers' ``rbox_iou_matrix.launches`` counts the paths' calls of both)
_FORMS = {"matrix": 0, "bits": 0}


def _rbox_overlap_bits_plain(boxes, iou_threshold):
    """The plain version of K1's bit-row form: (N, 5) boxes in score order
    -> (N, ceil(N / 64)) int64 rows, bit j % 64 of word j // 64 of row i
    set where j > i and ``iou(i, j) > iou_threshold`` (the IoU matrix in
    the boxes' dtype); every other bit 0."""
    iou = _rbox_iou_matrix_plain(boxes, boxes)
    return pack_rows(torch.triu(iou > iou_threshold, 1))


def _rbox_overlap_bits(boxes, iou_threshold):
    """nms2d's overlaps as the bit rows the NMS scan reads (see
    :func:`_rbox_overlap_bits_plain`), of (N, 5) boxes in score order, cast
    to float32: K1's bit-row form on CUDA (counted in
    ``rbox_iou_matrix.launches``), the plain version on the CPU. Not a
    public function: the JAX package has none."""
    boxes = boxes.to(torch.float32)
    if boxes.ndim != 2 or boxes.shape[1] != 5:
        raise ValueError(f"expected (N, 5) boxes, got {tuple(boxes.shape)}")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K1 kernel for device {boxes.device}")
    return torch.ops.d3d_tpu_torch.rbox_overlap_bits(boxes,
                                                     float(iou_threshold))


@torch.library.custom_op("d3d_tpu_torch::rbox_overlap_bits", mutates_args=(),
                         device_types="cpu")
def _k1_bits_op(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """K1's bit-row form as an op; its CPU implementation is the plain
    version."""
    return _rbox_overlap_bits_plain(boxes, iou_threshold)


@_k1_bits_op.register_kernel("cuda")
def _k1_bits_cuda(boxes, iou_threshold):
    n = boxes.shape[0]
    if n == 0:  # nothing to launch
        return torch.empty((0, 0), dtype=torch.int64, device=boxes.device)
    out = _bits_launch(boxes.contiguous(), iou_threshold)
    rbox_iou_matrix.launches += 1
    return out


@_k1_bits_op.register_fake
def _k1_bits_fake(boxes, iou_threshold):
    n = boxes.shape[0]
    return boxes.new_empty((n, (n + 63) // 64), dtype=torch.int64)


def _bits_launch(boxes, iou_threshold, chains=None, out=None):
    """K1's bit-row form on (N, 5) contiguous f32 CUDA boxes, N > 0 ->
    (N, ceil(N / 64)) int64, into ``out`` if given; ``chains`` as in
    :func:`_launch` (pairs j > i only)."""
    n = boxes.shape[0]
    if out is None:
        out = torch.empty((n, (n + 63) // 64), dtype=torch.int64,
                          device=boxes.device)
    err = load_library("rbox_iou").d3d_rbox_overlap_bits(
        boxes.data_ptr(), out.data_ptr(), n, float(iou_threshold),
        None if chains is None else chains.data_ptr(),
        stream_handle(boxes.device))
    if err:
        raise RuntimeError(f"rbox_iou bit-row launch failed: CUDA error "
                           f"{err}")
    _FORMS["bits"] += 1
    return out


def _descriptors_cuda(boxes):
    """The descriptors K1's blocks compute, for (K, 5) contiguous f32 CUDA
    boxes with K > 0 (held to :func:`box_descriptors` on the card)."""
    desc = torch.empty((boxes.shape[0], 10), dtype=torch.float32,
                       device=boxes.device)
    err = load_library("rbox_iou").d3d_rbox_descriptors(
        boxes.data_ptr(), desc.data_ptr(), boxes.shape[0],
        stream_handle(boxes.device))
    if err:
        raise RuntimeError(f"rbox_descriptors launch failed: CUDA error "
                           f"{err}")
    return desc

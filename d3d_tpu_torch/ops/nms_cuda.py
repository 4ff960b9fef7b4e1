"""The NMS scans through the CUDA kernels K2/K3 (``csrc/nms_scan.cu``) and
K4 (``csrc/soft_nms.cu``), the port of ``d3d_tpu.ops.nms_pallas``.

``nms_scan`` (K2, used by ``nms2d`` up to 1024 boxes) and
``nms_scan_blocked`` (K3, above) compute the same mask, so both launch the
same bitmask kernels; each keeps its own ``launches`` count.
``soft_nms_scan`` (K4) runs the soft-NMS pick/decay cascade. A CPU tensor
goes to the plain version (:func:`_nms_scan_plain`,
:func:`_soft_nms_scan_plain`); a CUDA tensor goes to the kernel or the call
raises.
"""

import torch

from ._build import load_library, stream_handle

__all__ = ["nms_scan", "nms_scan_blocked", "soft_nms_scan"]

# the scan keeps ceil(N / 64) suppression words in 48 KB of shared memory
_MAX_N = 48 * 1024 * 8
# K4's cascade: up to 8 warps, each lane owning up to 32 boxes
_SOFT_MAX_N = 8 * 32 * 32
_SOFT_METHODS = {"linear": 0, "gaussian": 1}
# up to this many boxes K4 stages its rows in shared memory (one warp);
# above it, it reads them from L2 (csrc/soft_nms.cu kStagedMaxN)
_SOFT_STAGED_MAX_N = 1024
# the decay factors K4 keeps a row (csrc/soft_nms.cu kListLen)
_SOFT_LIST_LEN = 8


def _soft_scratch_words(n):
    """K4's scratch in int32 words: per row, ``_SOFT_LIST_LEN`` decay
    factors (f32), ceil(n / 32) words of overlap marks and as many bytes of
    marks before each word."""
    marks = n * ((n + 31) // 32)
    return n * _SOFT_LIST_LEN + marks + (marks + 3) // 4


def _nms_scan_plain(overlap, pre):
    """The sequential greedy scan: for i ascending, an unsuppressed box i
    suppresses every later box j > i with ``overlap[i, j]``."""
    sup = pre.clone()
    for i in range(overlap.shape[0]):
        sup[i + 1:] |= overlap[i, i + 1:] & ~sup[i]
    return sup


def _check(overlap, pre):
    n = overlap.shape[0]
    if overlap.shape != (n, n) or pre.shape != (n,):
        raise ValueError(f"expected (N, N) overlap and (N,) pre, got "
                         f"{tuple(overlap.shape)} and {tuple(pre.shape)}")
    if overlap.dtype != torch.bool or pre.dtype != torch.bool:
        raise ValueError("overlap and pre must be bool tensors")
    if overlap.device != pre.device:
        raise ValueError(f"overlap on {overlap.device}, pre on {pre.device}")
    if overlap.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no NMS scan kernel for device {overlap.device}")


def _launch(overlap, pre):
    """K2/K3 on CUDA tensors with N > 0 -> (N,) bool suppressed."""
    n = overlap.shape[0]
    if n > _MAX_N:
        raise ValueError(f"NMS scan kernel takes at most {_MAX_N} boxes")
    overlap = overlap.contiguous()
    pre = pre.contiguous()
    out = torch.empty(n, dtype=torch.bool, device=overlap.device)
    mask = torch.empty((n, (n + 63) // 64), dtype=torch.int64,
                       device=overlap.device)
    lib = load_library("nms_scan")
    err = lib.d3d_nms_scan(
        overlap.data_ptr(), pre.data_ptr(), mask.data_ptr(), out.data_ptr(),
        n, stream_handle(overlap.device))
    if err:
        raise RuntimeError(f"nms_scan kernel launch failed: CUDA error {err}")
    return out


def nms_scan(overlap, pre):
    """(N, N) bool overlap in score order + (N,) bool pre-suppression ->
    (N,) bool suppressed, identical to the sequential greedy scan (K2)."""
    _check(overlap, pre)
    if overlap.device.type == "cpu":
        return _nms_scan_plain(overlap, pre)
    if overlap.shape[0] == 0:  # nothing to launch
        return pre.clone()
    out = _launch(overlap, pre)
    nms_scan.launches += 1
    return out


def nms_scan_blocked(overlap, pre):
    """Same contract and mask as :func:`nms_scan`, for N > 1024 (K3)."""
    _check(overlap, pre)
    if overlap.device.type == "cpu":
        return _nms_scan_plain(overlap, pre)
    if overlap.shape[0] == 0:  # nothing to launch
        return pre.clone()
    out = _launch(overlap, pre)
    nms_scan_blocked.launches += 1
    return out


nms_scan.launches = 0
nms_scan_blocked.launches = 0


def _soft_decay(row, p, tiny, method):
    """The soft-NMS decay factors of a row of IoU, ``p`` and ``tiny``
    (1e-38) 0-d tensors on its device."""
    if method == "linear":
        # x**p as exp(p log x), with power(0, 0) == 1
        pw = torch.where(p == 0, 1.0,
                         torch.exp(p * torch.log(torch.maximum(row, tiny))))
        return 1.0 - pw
    return torch.exp(-(row * row) / p)


def _soft_nms_scan_plain(iou, scores0, pre, iou_threshold, score_threshold,
                         param, method):
    """The soft-NMS cascade of ``nms_pallas.py`` ``_soft_nms_kernel``, one
    step per box, in its operation order and in the matrix's dtype. The
    parameters are tensors on the matrix's device (so a division by
    ``param`` is a true division there, as in the kernel)."""
    n = iou.shape[0]
    dev, dt = iou.device, iou.dtype
    iou_t, score_t, p = (torch.tensor(v, dtype=dt, device=dev)
                         for v in (iou_threshold, score_threshold, param))
    tiny = torch.tensor(1e-38, dtype=dt, device=dev)
    iota = torch.arange(n, device=dev)
    sc, su = scores0.clone(), pre.clone()
    fr = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(n):
        avail = ~fr & ~su
        any_avail = avail.any()
        masked = torch.where(avail, sc, -torch.inf)
        # first argmax
        pick = torch.where(masked == masked.max(), iota, n).min()
        pick = torch.clamp(pick, max=n - 1)
        row = iou[pick]
        mask_row = (row > iou_t) & ~fr & (iota != pick)
        decay = _soft_decay(row, p, tiny, method)
        nsc = torch.where(mask_row & any_avail, sc * decay, sc)
        dead = mask_row & (nsc < score_t)
        su = su | (any_avail & dead)
        fr = fr | ((iota == pick) & any_avail)
        sc = nsc
    return su


def soft_nms_scan(iou, scores0, pre, iou_threshold, score_threshold, param,
                  method):
    """Soft-NMS cascade (K4): (N, N) IoU in input order, (N,) starting
    scores (pre-suppressed boxes at -inf), (N,) bool pre-suppression ->
    (N,) bool suppressed. ``method`` is "linear" or "gaussian". IoU and
    scores share float32 (K4 on CUDA takes at most 8192 boxes), or float64
    on the CPU."""
    n = iou.shape[0]
    if iou.shape != (n, n) or scores0.shape != (n,) or pre.shape != (n,):
        raise ValueError(f"expected (N, N) iou, (N,) scores0 and (N,) pre, "
                         f"got {tuple(iou.shape)}, {tuple(scores0.shape)}, "
                         f"{tuple(pre.shape)}")
    dtypes = (torch.float32,) if iou.is_cuda else (torch.float32,
                                                   torch.float64)
    if (iou.dtype not in dtypes or scores0.dtype != iou.dtype
            or pre.dtype != torch.bool):
        raise ValueError(f"iou and scores0 must share one of {dtypes} on "
                         f"{iou.device.type}, pre bool; got {iou.dtype}, "
                         f"{scores0.dtype}, {pre.dtype}")
    if method not in _SOFT_METHODS:
        raise ValueError(f"unknown soft-NMS method {method!r}")
    if len({iou.device, scores0.device, pre.device}) != 1:
        raise ValueError("iou, scores0 and pre on different devices")
    if iou.device.type == "cpu":
        return _soft_nms_scan_plain(iou, scores0, pre, iou_threshold,
                                    score_threshold, param, method)
    if iou.device.type != "cuda":
        raise ValueError(f"no soft-NMS kernel for device {iou.device}")
    if n == 0:  # nothing to launch
        return pre.clone()
    out = _soft_launch(iou, scores0, pre, iou_threshold, score_threshold,
                       param, method)
    soft_nms_scan.launches += 1
    return out


def _soft_launch(iou, scores0, pre, iou_threshold, score_threshold, param,
                 method):
    """K4 on checked CUDA tensors with N > 0 -> (N,) bool suppressed."""
    n = iou.shape[0]
    if n > _SOFT_MAX_N:
        raise ValueError(f"soft-NMS kernel takes at most {_SOFT_MAX_N} boxes")
    out = torch.empty(n, dtype=torch.bool, device=iou.device)
    scratch = torch.empty(_soft_scratch_words(n), dtype=torch.int32,
                          device=iou.device)
    iou, scores0, pre = iou.contiguous(), scores0.contiguous(), pre.contiguous()
    err = load_library("soft_nms").d3d_soft_nms_scan(
        iou.data_ptr(), scores0.data_ptr(), pre.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), scratch.numel(), n, float(iou_threshold),
        float(score_threshold), float(param), _SOFT_METHODS[method],
        stream_handle(iou.device))
    if err:
        raise RuntimeError(f"soft_nms kernel launch failed: CUDA error {err}")
    _soft_launch.routes["shared" if n <= _SOFT_STAGED_MAX_N else "l2"] += 1
    return out


# K4's launches by where its cascade reads the marks (every launch, checks
# included; ``soft_nms_scan.launches`` counts the path's)
_soft_launch.routes = {"shared": 0, "l2": 0}


soft_nms_scan.launches = 0

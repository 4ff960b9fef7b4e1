"""The greedy NMS suppression scan through the CUDA kernels K2/K3
(``csrc/nms_scan.cu``), the port of ``d3d_tpu.ops.nms_pallas``.

``nms_scan`` (K2, used by ``nms2d`` up to 1024 boxes) and
``nms_scan_blocked`` (K3, above) compute the same mask, so both launch the
same bitmask kernels; each keeps its own ``launches`` count. A CPU tensor
goes to the plain version, the sequential greedy scan
(:func:`_nms_scan_plain`); a CUDA tensor goes to the kernel or the call
raises. ``soft_nms_scan`` (K4) is not ported yet.
"""

import torch

from ._build import load_library

__all__ = ["nms_scan", "nms_scan_blocked"]

# the scan keeps ceil(N / 64) suppression words in 48 KB of shared memory
_MAX_N = 48 * 1024 * 8


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
    n = overlap.shape[0]
    if n > _MAX_N:
        raise ValueError(f"NMS scan kernel takes at most {_MAX_N} boxes")
    overlap = overlap.contiguous()
    pre = pre.contiguous()
    out = torch.empty(n, dtype=torch.bool, device=overlap.device)
    if n == 0:
        return out
    mask = torch.empty((n, (n + 63) // 64), dtype=torch.int64,
                       device=overlap.device)
    lib = load_library("nms_scan")
    err = lib.d3d_nms_scan(
        overlap.data_ptr(), pre.data_ptr(), mask.data_ptr(), out.data_ptr(),
        n, torch.cuda.current_stream(overlap.device).cuda_stream)
    if err:
        raise RuntimeError(f"nms_scan kernel launch failed: CUDA error {err}")
    return out


def nms_scan(overlap, pre):
    """(N, N) bool overlap in score order + (N,) bool pre-suppression ->
    (N,) bool suppressed, identical to the sequential greedy scan (K2)."""
    _check(overlap, pre)
    if overlap.device.type == "cpu":
        return _nms_scan_plain(overlap, pre)
    out = _launch(overlap, pre)
    nms_scan.launches += 1
    return out


def nms_scan_blocked(overlap, pre):
    """Same contract and mask as :func:`nms_scan`, for N > 1024 (K3)."""
    _check(overlap, pre)
    if overlap.device.type == "cpu":
        return _nms_scan_plain(overlap, pre)
    out = _launch(overlap, pre)
    nms_scan_blocked.launches += 1
    return out


nms_scan.launches = 0
nms_scan_blocked.launches = 0

"""The NMS scans through the CUDA kernels K2/K3 (``csrc/nms_scan.cu``) and
K4 (``csrc/soft_nms.cu``), the port of ``d3d_tpu.ops.nms_pallas``.

``nms_scan`` (K2, up to 1024 boxes) and ``nms_scan_blocked`` (K3, above)
compute the same mask, so one scan kernel serves both; it reads the
overlaps as 64-bit rows (:func:`pack_rows`). The public functions take the
JAX package's bool (N, N) matrix and pack it on the card first; ``nms2d``
hands the scan the bit rows K1 writes (:func:`_nms_scan_sorted`), with the
pre-suppression computed in the kernel from the sorted scores and the mask
written back in input order. Each launch counts under K2 or K3 by N.
``soft_nms_scan`` (K4) runs the soft-NMS pick/decay cascade, in float32 or
float64 (one kernel source, a C entry point each). A CPU tensor
goes to the plain version (:func:`_nms_scan_plain`,
:func:`_nms_scan_sorted_plain`, :func:`_soft_nms_scan_plain`); a CUDA
tensor goes to the kernel or the call raises.

Each scan is a ``torch.library`` custom op in the ``d3d_tpu_torch``
namespace (``nms_scan``, ``nms_scan_blocked``, ``nms_scan_sorted``,
``soft_nms_scan``), so that ``torch.export`` keeps it as a node of a
traced detector: its CUDA implementation launches the kernel and counts
the launch, its CPU implementation is the plain version and counts none,
and a fake implementation gives the output's shape and dtype.
"""

from typing import Optional

import torch

from ._build import load_library, stream_handle

__all__ = ["nms_scan", "nms_scan_blocked", "soft_nms_scan"]

# the scan keeps ceil(N / 64) suppression words in 48 KB of shared memory
_MAX_N = 48 * 1024 * 8
# up to this many boxes one warp runs the scan, a lane a word
# (csrc/nms_scan.cu kWarpWords * 64); above, one block
_WARP_MAX_N = 2048
# nms2d's scan counts under K2 up to this many boxes, K3 above
_K2_MAX_N = 1024
# K4's cascade: up to 32 warps; a lane owns up to 32 boxes (one word of
# bits) up to this many boxes (csrc/soft_nms.cu kWordMaxN), and above it
# 64, 128 or 256 (2, 4 or 8 words)
_SOFT_WORD_MAX_N = 32 * 32 * 32
# the widest layout, 1024 lanes of 256 boxes (csrc/soft_nms.cu kMaxN): a
# float32 matrix of more boxes is 275 GB, so no card holds the input
_SOFT_MAX_N = 8 * _SOFT_WORD_MAX_N
# up to this many boxes (8 warps) the cascade keeps its scores and keys in
# shared memory; above it, 16 or 32 warps keep them in a slice of the
# scratch in global memory (csrc/soft_nms.cu kSharedStateMaxN)
_SOFT_SHARED_STATE_MAX_N = 8 * 32 * 32
_SOFT_METHODS = {"linear": 0, "gaussian": 1}
# up to this many boxes K4 stages its rows in shared memory (one warp);
# above it, it reads them from L2 (csrc/soft_nms.cu kStagedMaxN)
_SOFT_STAGED_MAX_N = 1024
# the same for float64, whose decay factors and scores take twice the bytes
# (csrc/soft_nms.cu kStagedMaxNF64)
_SOFT_STAGED_MAX_N_F64 = 512
# the decay factors K4 keeps a row (csrc/soft_nms.cu kListLen)
_SOFT_LIST_LEN = 8


def _soft_warps(n):
    """The warps of K4's cascade for ``n`` boxes (csrc/soft_nms.cu
    `launch`): one up to 1024 boxes, then a warp a 1024 boxes up to 8,
    then 16 up to 16 384 boxes and 32 above."""
    if n <= _SOFT_SHARED_STATE_MAX_N:
        return 1 << max(0, (-(-n // 1024) - 1).bit_length())
    return 16 if n <= 2 * _SOFT_SHARED_STATE_MAX_N else 32


def _soft_boxes(n):
    """The boxes a lane of K4's cascade owns above
    ``_SOFT_SHARED_STATE_MAX_N`` boxes (csrc/soft_nms.cu `wide_boxes`): 32
    up to ``_SOFT_WORD_MAX_N``, then the least of 64, 128 and 256 that
    covers ``n`` with 1024 lanes."""
    if n <= _SOFT_WORD_MAX_N:
        return 32
    return 64 if n <= 2 * _SOFT_WORD_MAX_N else (
        128 if n <= 4 * _SOFT_WORD_MAX_N else 256)


def _soft_scratch_words(n, itemsize=4):
    """K4's scratch in int32 words: per row, ``_SOFT_LIST_LEN`` decay
    factors (of ``itemsize`` bytes: 4 for float32, 8 for float64),
    ceil(n / 32) words of overlap marks and as many bytes of marks before
    each word; above ``_SOFT_SHARED_STATE_MAX_N`` boxes, from the next
    16-byte boundary, the cascade's scores and keys (:func:`_soft_boxes`
    a lane of its warps, ``itemsize`` bytes each)."""
    marks = n * ((n + 31) // 32)
    rows = n * _SOFT_LIST_LEN * (itemsize // 4) + marks + (marks + 3) // 4
    if n <= _SOFT_SHARED_STATE_MAX_N:
        return rows
    return -(-rows // 4) * 4 + (_soft_warps(n) * 32 * _soft_boxes(n) * 2
                                * (itemsize // 4))


def _nms_scan_plain(overlap, pre):
    """The sequential greedy scan: for i ascending, an unsuppressed box i
    suppresses every later box j > i with ``overlap[i, j]``."""
    sup = pre.clone()
    for i in range(overlap.shape[0]):
        sup[i + 1:] |= overlap[i, i + 1:] & ~sup[i]
    return sup


def pack_rows(overlap):
    """(N, N) bool -> the scan's (N, ceil(N / 64)) int64 bit rows: bit
    j % 64 of word j // 64 of row i is ``overlap[i, j]``."""
    n = overlap.shape[0]
    words = (n + 63) // 64
    padded = torch.nn.functional.pad(overlap, (0, 64 * words - n))
    bit = torch.arange(64, dtype=torch.int64, device=overlap.device)
    # distinct bits, so the sum is their OR (bit 63 wraps to the sign)
    return (padded.view(n, words, 64).to(torch.int64) << bit).sum(-1)


def _unpack_rows(bits, n):
    """The inverse of :func:`pack_rows`: (N, ceil(N / 64)) int64 -> (N, N)
    bool."""
    bit = torch.arange(64, dtype=torch.int64, device=bits.device)
    return ((bits[..., None] >> bit) & 1).bool().view(n, -1)[:, :n]


def _pre_suppression(scores_sorted, score_threshold):
    """nms2d's pre-suppression of the scores in score order: score <=
    score_threshold (a NaN never), rank 0 exempt."""
    pre = scores_sorted <= score_threshold
    if pre.shape[0]:
        pre[0] = False
    return pre


def _nms_scan_sorted_plain(bits, order, neg_scores, score_threshold,
                           pre=None):
    """The plain version of :func:`_nms_scan_sorted`: unpack the rows, the
    pre-suppression from the sorted scores unless ``pre`` is given, the
    sequential scan, the mask scattered back through ``order``."""
    n = bits.shape[0]
    if pre is None:
        pre = _pre_suppression(-neg_scores, score_threshold)
    sup = _nms_scan_plain(_unpack_rows(bits, n), pre)
    out = torch.empty_like(sup)
    out[order] = sup
    return out


def _nms_scan_sorted(bits, order, neg_scores, score_threshold, pre=None):
    """nms2d's scan: (N, ceil(N / 64)) int64 bit rows of the boxes in score
    order (from K1's bit-row form), ``order`` (N,) int64 and
    ``neg_scores`` (N,) float32, ``torch.sort(-scores, stable=True)``'s
    indices and values, -> (N,) bool suppressed in input order. The
    pre-suppression is nms2d's rule on the sorted scores, computed in the
    kernel, unless ``pre`` (bool, score order) is given, as for other score
    dtypes. On CUDA one launch of the scan kernel, counted under K2
    (``nms_scan``) up to 1024 boxes and K3 above; on the CPU the plain
    version."""
    return torch.ops.d3d_tpu_torch.nms_scan_sorted(
        bits, order, neg_scores, float(score_threshold), pre)


@torch.library.custom_op("d3d_tpu_torch::nms_scan_sorted", mutates_args=(),
                         device_types="cpu")
def _scan_sorted_op(bits: torch.Tensor, order: torch.Tensor,
                    neg_scores: torch.Tensor, score_threshold: float,
                    pre: Optional[torch.Tensor]) -> torch.Tensor:
    """nms2d's scan as an op (see :func:`_nms_scan_sorted`)."""
    return _nms_scan_sorted_plain(bits, order, neg_scores, score_threshold,
                                  pre)


@_scan_sorted_op.register_kernel("cuda")
def _scan_sorted_cuda(bits, order, neg_scores, score_threshold, pre):
    n = bits.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=bits.device)
    if n == 0:  # nothing to launch
        return out
    _scan_launch(bits, out, pre=pre,
                 neg_scores=neg_scores if pre is None else None,
                 score_threshold=score_threshold, order=order)
    (nms_scan if n <= _K2_MAX_N else nms_scan_blocked).launches += 1
    return out


@_scan_sorted_op.register_fake
def _scan_sorted_fake(bits, order, neg_scores, score_threshold, pre):
    return bits.new_empty(bits.shape[0], dtype=torch.bool)


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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _scan_launch(bits, out, pre=None, neg_scores=None, score_threshold=0.0,
                 order=None):
    """The scan kernel on N > 0 contiguous CUDA bit rows (see
    :func:`_nms_scan_sorted` for the arguments) into ``out`` (N,) bool."""
    n = bits.shape[0]
    if n > _MAX_N:
        raise ValueError(f"NMS scan kernel takes at most {_MAX_N} boxes")
    if neg_scores is not None and neg_scores.dtype != torch.float32:
        raise ValueError(f"the scan reads float32 scores, got "
                         f"{neg_scores.dtype}")
    pre, neg_scores, order = (None if t is None else t.contiguous()
                              for t in (pre, neg_scores, order))
    err = load_library("nms_scan").d3d_nms_scan(
        bits.data_ptr(), _ptr(pre), _ptr(neg_scores), float(score_threshold),
        _ptr(order), out.data_ptr(), n, stream_handle(bits.device))
    if err:
        raise RuntimeError(f"nms_scan kernel launch failed: CUDA error {err}")
    _ROUTES["warp" if n <= _WARP_MAX_N else "block"] += 1
    return out


def _launch(overlap, pre):
    """The public route on CUDA tensors with N > 0: pack the bool rows,
    then the scan -> (N,) bool suppressed."""
    n = overlap.shape[0]
    if n > _MAX_N:
        raise ValueError(f"NMS scan kernel takes at most {_MAX_N} boxes")
    overlap = overlap.contiguous()
    bits = torch.empty((n, (n + 63) // 64), dtype=torch.int64,
                       device=overlap.device)
    err = load_library("nms_scan").d3d_nms_pack(
        overlap.data_ptr(), bits.data_ptr(), n, stream_handle(overlap.device))
    if err:
        raise RuntimeError(f"nms_pack kernel launch failed: CUDA error {err}")
    _ROUTES["pack"] += 1
    out = torch.empty(n, dtype=torch.bool, device=overlap.device)
    return _scan_launch(bits, out, pre=pre)


# the scan's launches by route, and the pack kernel's (every launch, checks
# included; ``nms_scan.launches`` and ``nms_scan_blocked.launches`` count
# the paths' calls)
_ROUTES = {"pack": 0, "warp": 0, "block": 0}


def nms_scan(overlap, pre):
    """(N, N) bool overlap in score order + (N,) bool pre-suppression ->
    (N,) bool suppressed, identical to the sequential greedy scan (K2). On
    CUDA the rows are packed into bits, then scanned: two launches, one
    call counted."""
    _check(overlap, pre)
    return torch.ops.d3d_tpu_torch.nms_scan(overlap, pre)


def nms_scan_blocked(overlap, pre):
    """Same contract and mask as :func:`nms_scan`, for N > 1024 (K3)."""
    _check(overlap, pre)
    return torch.ops.d3d_tpu_torch.nms_scan_blocked(overlap, pre)


nms_scan.launches = 0
nms_scan_blocked.launches = 0


def _bool_scan_op(name, counted):
    """The bool route of K2 or K3 as the op ``d3d_tpu_torch::{name}``,
    counted in ``counted.launches``."""
    @torch.library.custom_op(f"d3d_tpu_torch::{name}", mutates_args=(),
                             device_types="cpu")
    def op(overlap: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
        return _nms_scan_plain(overlap, pre)

    @op.register_kernel("cuda")
    def _cuda(overlap, pre):
        if overlap.shape[0] == 0:  # nothing to launch
            return pre.clone()
        out = _launch(overlap, pre)
        counted.launches += 1
        return out

    @op.register_fake
    def _fake(overlap, pre):
        return torch.empty_like(pre)

    return op


_nms_scan_op = _bool_scan_op("nms_scan", nms_scan)
_nms_scan_blocked_op = _bool_scan_op("nms_scan_blocked", nms_scan_blocked)


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
    step per box, in its operation order and in the matrix's dtype, until
    no box is available (the later steps change nothing). The parameters
    are tensors on the matrix's device (so a division by ``param`` is a
    true division there, as in the kernel)."""
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
        if not bool(any_avail):  # no box left: nothing changes any more
            break
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
    scores share float32 or float64. K4 on CUDA takes any N whose matrix
    the card holds (its layouts reach 262 144 boxes, a 275 GB float32
    matrix; above 32 768 boxes its 1024 lanes own 64 to 256 boxes each);
    a matrix too large fails in the allocator, before this call. Its
    launches count in ``soft_nms_scan.launches`` and
    ``soft_nms_scan.launches_f64``."""
    n = iou.shape[0]
    if iou.shape != (n, n) or scores0.shape != (n,) or pre.shape != (n,):
        raise ValueError(f"expected (N, N) iou, (N,) scores0 and (N,) pre, "
                         f"got {tuple(iou.shape)}, {tuple(scores0.shape)}, "
                         f"{tuple(pre.shape)}")
    dtypes = (torch.float32, torch.float64)
    if (iou.dtype not in dtypes or scores0.dtype != iou.dtype
            or pre.dtype != torch.bool):
        raise ValueError(f"iou and scores0 must share one of {dtypes}, "
                         f"pre bool; got {iou.dtype}, {scores0.dtype}, "
                         f"{pre.dtype}")
    if method not in _SOFT_METHODS:
        raise ValueError(f"unknown soft-NMS method {method!r}")
    if len({iou.device, scores0.device, pre.device}) != 1:
        raise ValueError("iou, scores0 and pre on different devices")
    if iou.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no soft-NMS kernel for device {iou.device}")
    return torch.ops.d3d_tpu_torch.soft_nms_scan(
        iou, scores0, pre, float(iou_threshold), float(score_threshold),
        float(param), method)


@torch.library.custom_op("d3d_tpu_torch::soft_nms_scan", mutates_args=(),
                         device_types="cpu")
def _soft_op(iou: torch.Tensor, scores0: torch.Tensor, pre: torch.Tensor,
             iou_threshold: float, score_threshold: float, param: float,
             method: str) -> torch.Tensor:
    """K4 as an op (float32 or float64 by the matrix's dtype); its CPU
    implementation is the plain cascade."""
    return _soft_nms_scan_plain(iou, scores0, pre, iou_threshold,
                                score_threshold, param, method)


@_soft_op.register_kernel("cuda")
def _soft_cuda(iou, scores0, pre, iou_threshold, score_threshold, param,
               method):
    if iou.shape[0] == 0:  # nothing to launch
        return pre.clone()
    out = _soft_launch(iou, scores0, pre, iou_threshold, score_threshold,
                       param, method)
    if iou.dtype == torch.float64:
        soft_nms_scan.launches_f64 += 1
    else:
        soft_nms_scan.launches += 1
    return out


@_soft_op.register_fake
def _soft_fake(iou, scores0, pre, iou_threshold, score_threshold, param,
               method):
    return torch.empty_like(pre)


def _soft_launch(iou, scores0, pre, iou_threshold, score_threshold, param,
                 method):
    """K4 on checked CUDA tensors with N > 0 -> (N,) bool suppressed."""
    n = iou.shape[0]
    f64 = iou.dtype == torch.float64
    out = torch.empty(n, dtype=torch.bool, device=iou.device)
    scratch = torch.empty(_soft_scratch_words(n, iou.element_size()),
                          dtype=torch.int32, device=iou.device)
    iou, scores0, pre = iou.contiguous(), scores0.contiguous(), pre.contiguous()
    lib = load_library("soft_nms")
    err = (lib.d3d_soft_nms_scan_f64 if f64 else lib.d3d_soft_nms_scan)(
        iou.data_ptr(), scores0.data_ptr(), pre.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), scratch.numel(), n, float(iou_threshold),
        float(score_threshold), float(param), _SOFT_METHODS[method],
        stream_handle(iou.device))
    if err:
        raise RuntimeError(f"soft_nms kernel launch failed: CUDA error {err}")
    staged = n <= (_SOFT_STAGED_MAX_N_F64 if f64 else _SOFT_STAGED_MAX_N)
    route = ("shared" if staged else "l2" if n <= _SOFT_SHARED_STATE_MAX_N
             else "global" if n <= _SOFT_WORD_MAX_N else "wide") + (
                 "_f64" if f64 else "")
    _soft_launch.routes[route] += 1
    return out


# K4's launches by where its cascade reads the marks (shared memory, L2)
# and, above ``_SOFT_SHARED_STATE_MAX_N`` boxes, keeps its scores
# ("global": in the scratch, from L2; "wide": the same above
# ``_SOFT_WORD_MAX_N`` boxes, 64 to 256 boxes a lane), float32 and float64
# apart (every launch, checks included; ``soft_nms_scan.launches`` counts
# the path's)
_soft_launch.routes = {"shared": 0, "l2": 0, "global": 0, "wide": 0,
                       "shared_f64": 0, "l2_f64": 0, "global_f64": 0,
                       "wide_f64": 0}


# K4's launches on a path, float32 and float64 (its second C entry point)
soft_nms_scan.launches = 0
soft_nms_scan.launches_f64 = 0

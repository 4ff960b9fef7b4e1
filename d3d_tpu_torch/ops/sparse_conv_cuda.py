"""The sparse-conv gather-GEMM and its gradient through the CUDA kernels K5
(``csrc/subm_conv.cu``) and K6 (``csrc/subm_conv_dw.cu``), the port of
``d3d_tpu.ops.sparse_conv_pallas.subm_conv_fused`` and its custom VJP.

``subm_conv(features, nbr, weights, valid)`` (K5) computes
``out[n] = valid[n] * sum_k weights[k]^T features[nbr[n, k]]``, absent
(-1) neighbours contributing 0, accumulated in float32 and returned in the
features' dtype. Features and weights are float32 or bfloat16 (the same
dtype); the kernel converts bfloat16 to float32 in registers.

``subm_conv_dw(features, nbr, grad)`` (K6) computes the weight gradient
``dW[k] = sum_n features[nbr[n, k]] (x) grad[n]`` in float32 from float32 or
bfloat16 features and a float32 cotangent.

:class:`SubmConv` ties them together for autograd, as ``_fused_fwd`` /
``_fused_bwd`` do in the JAX module: the forward is K5, the weight gradient
K6, and the features' gradient K5 again with mirrored offsets on a
submanifold map, or a scatter-add on a strided one.

The map ``nbr`` is an (Nq, K) int32 tensor or its
:class:`~d3d_tpu_torch.ops.rulebook.RuleBook`: the kernels walk the rule
book to skip absent neighbours, and a bare tensor gets its rule book built
in the call. :class:`SubmConv` keeps one rule book for the forward and
both backward kernels.

A CPU tensor goes to the plain versions (:func:`_subm_conv_plain`,
:func:`_subm_conv_dw_plain`), which also take float64 so that
``torch.autograd.gradcheck`` can check the gradient; a CUDA tensor goes to
the kernels or the call raises.

K5's forward is the ``torch.library`` custom op ``d3d_tpu_torch::subm_conv``
(a CUDA implementation that launches K5 and counts the launch, the plain
version on the CPU, a fake one for tracing), so that ``torch.export``
keeps it as a node of a traced detector. K6 and :class:`SubmConv`'s
backward are training only and call their launches directly.
"""

from typing import Optional

import torch

from ._build import load_library, stream_handle
from .rulebook import RuleBook, prepare_neighbor_map

__all__ = ["subm_conv", "subm_conv_dw", "SubmConv", "k5_tile_rows",
           "pad_channels"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CPU_DTYPES = (torch.float32, torch.bfloat16, torch.float64)
# entries of one offset's list per K6 block: fixes how its sums are grouped,
# so a map always gives the same bits
_DW_SLAB = 512


def k5_tile_rows(cout):
    """Output rows of one K5 tile for ``cout`` output channels, as the
    kernel's library says (``csrc/subm_conv.cu``; built on first use)."""
    return load_library("subm_conv").d3d_subm_conv_tile_rows(cout)


def _nbr_tensor(nbr):
    return nbr.nbr if isinstance(nbr, RuleBook) else nbr


def _vec(t, row_elems, name):
    """The widest asynchronous copy (16, 8 or 4 bytes) that divides a row
    of ``t`` and its start address."""
    row = row_elems * t.element_size()
    for v in (16, 8, 4):
        if row % v == 0 and t.data_ptr() % v == 0:
            return v
    raise ValueError(f"{name}: rows of {row} bytes; the kernel copies rows "
                     "in units of 4, 8 or 16 bytes")


def pad_channels(features, weights=None):
    """Features whose rows are no whole number of the kernels' 4-byte copy
    unit (a 5-channel bf16 row is 10 bytes) widened with zero columns to
    the next 16 bytes, and the weights' input rows ``(K, C, Cout) -> (K,
    C', Cout)`` with zeros to match. A zero column adds exact zeros, so
    the padded sums equal the unpadded ones. Rows that already fit come
    back as they are. Returns ``(features, weights)``."""
    c = features.shape[1]
    size = features.element_size()
    if c * size % 4 == 0:
        return features, weights
    pad = -(-c * size // 16) * 16 // size - c
    features = torch.nn.functional.pad(features, (0, pad))
    if weights is not None:
        weights = torch.nn.functional.pad(weights, (0, 0, 0, pad))
    return features, weights


def _acc_dtype(*dtypes):
    """float32, or float64 where an operand is float64."""
    acc = torch.float32
    for dt in dtypes:
        acc = torch.promote_types(acc, dt)
    return acc


def _gather(features, nbr):
    """(Nq, K, C) rows ``features[nbr]``, absent rows 0."""
    gathered = features[nbr.clamp(min=0).long()]
    return torch.where((nbr >= 0)[..., None], gathered, 0)


def _subm_conv_plain(features, nbr, weights, valid):
    """Gather ``features[nbr.clamp(min=0)]``, zero the absent rows, one
    float32 einsum over (offset, channel), mask by ``valid``."""
    acc = _acc_dtype(features.dtype)
    out = torch.einsum("nkc,kcd->nd", _gather(features, nbr).to(acc),
                       weights.to(acc))
    return (out * valid[:, None]).to(features.dtype)


def _subm_conv_dw_plain(features, nbr, grad):
    """Gather, zero the absent rows, one float32 einsum over the query rows:
    (K, C, Cout)."""
    acc = _acc_dtype(features.dtype, grad.dtype)
    return torch.einsum("nkc,nd->kcd", _gather(features, nbr).to(acc),
                        grad.to(acc))


def _check_device(name, tensors, dtype):
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = tensors[0].device
    allowed = _CPU_DTYPES if dev.type == "cpu" else tuple(_DTYPES)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {name} kernel for device {dev}")
    if dtype not in allowed:
        raise ValueError(f"{name} on {dev.type} takes {allowed}, got {dtype}")


def _check(features, nbr, weights, valid):
    if features.ndim != 2 or nbr.ndim != 2 or weights.ndim != 3:
        raise ValueError(f"expected (N, C) features, (Nq, K) nbr and "
                         f"(K, C, Cout) weights, got {tuple(features.shape)}, "
                         f"{tuple(nbr.shape)}, {tuple(weights.shape)}")
    nq, k = nbr.shape
    if weights.shape[:2] != (k, features.shape[1]) or valid.shape != (nq,):
        raise ValueError(f"weights {tuple(weights.shape)} or valid "
                         f"{tuple(valid.shape)} do not match features "
                         f"{tuple(features.shape)} and nbr {tuple(nbr.shape)}")
    if weights.dtype != features.dtype:
        raise ValueError(f"features and weights must share a dtype, got "
                         f"{features.dtype} and {weights.dtype}")
    if nbr.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError("nbr must be int32 and valid bool")
    _check_device("K5", (features, nbr, weights, valid), features.dtype)


def _launch(features, rules, weights, valid, out=None):
    """K5 on CUDA tensors with N, C, Nq, Cout > 0 and a
    :class:`RuleBook` -> (Nq, Cout) in the features' dtype, written into
    ``out`` where given (every row is written). Features whose rows are
    no whole number of 4-byte copies run padded (:func:`pad_channels`)."""
    features, weights = pad_channels(features, weights)
    features = features.contiguous()
    weights = weights.contiguous()
    valid = valid.contiguous()
    n, c = features.shape
    nq, k = rules.shape
    cout = weights.shape[2]
    if out is None:
        out = torch.empty((nq, cout), dtype=features.dtype,
                          device=features.device)
    elif (out.shape != (nq, cout) or out.dtype != features.dtype
          or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({nq}, {cout}) "
                         f"{features.dtype} tensor")
    err = load_library("subm_conv").d3d_subm_conv(
        features.data_ptr(), rules.nbr.data_ptr(), rules.order.data_ptr(),
        weights.data_ptr(), valid.data_ptr(), out.data_ptr(), n, nq, k, c,
        cout, _DTYPES[features.dtype], _vec(features, c, "K5 features"),
        _vec(weights, cout, "K5 weights"),
        stream_handle(features.device))
    if err:
        raise RuntimeError(f"subm_conv kernel launch failed: CUDA error {err}")
    return out


def subm_conv(features, nbr, weights, valid):
    """(N, C) features, (Nq, K) int32 nbr or its :class:`RuleBook`, (K, C,
    Cout) weights of the same dtype, (Nq,) bool valid -> (Nq, Cout) in the
    features' dtype (K5; launches counted in ``subm_conv.launches``)."""
    _check(features, _nbr_tensor(nbr), weights, valid)
    if features.device.type == "cuda":
        nbr = prepare_neighbor_map(nbr)
    order = nbr.order if isinstance(nbr, RuleBook) else None
    return torch.ops.d3d_tpu_torch.subm_conv(features, _nbr_tensor(nbr),
                                             order, weights, valid)


subm_conv.launches = 0


@torch.library.custom_op("d3d_tpu_torch::subm_conv", mutates_args=(),
                         device_types="cpu")
def _k5_op(features: torch.Tensor, nbr: torch.Tensor,
           order: Optional[torch.Tensor], weights: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    """K5 as an op on a map and its rule book's ``order`` (the CPU's plain
    version reads the map alone)."""
    return _subm_conv_plain(features, nbr, weights, valid)


@_k5_op.register_kernel("cuda")
def _k5_cuda(features, nbr, order, weights, valid):
    (n, c), (nq, cout) = features.shape, (nbr.shape[0], weights.shape[2])
    if nq == 0 or cout == 0:  # nothing to launch
        return torch.empty((nq, cout), dtype=features.dtype,
                           device=features.device)
    if n == 0 or c == 0:  # every sum is empty
        return torch.zeros((nq, cout), dtype=features.dtype,
                           device=features.device)
    if order is None:
        raise ValueError("K5 on CUDA walks the map's rule book: pass its "
                         "order")
    out = _launch(features, RuleBook(nbr, (None, order)), weights, valid)
    subm_conv.launches += 1
    return out


@_k5_op.register_fake
def _k5_fake(features, nbr, order, weights, valid):
    return features.new_empty((nbr.shape[0], weights.shape[2]))


def _check_dw(features, nbr, grad):
    if features.ndim != 2 or nbr.ndim != 2 or grad.ndim != 2:
        raise ValueError(f"expected (N, C) features, (Nq, K) nbr and "
                         f"(Nq, Cout) grad, got {tuple(features.shape)}, "
                         f"{tuple(nbr.shape)}, {tuple(grad.shape)}")
    if grad.shape[0] != nbr.shape[0]:
        raise ValueError(f"grad {tuple(grad.shape)} does not match nbr "
                         f"{tuple(nbr.shape)}")
    if nbr.dtype != torch.int32:
        raise ValueError("nbr must be int32")
    _check_device("K6", (features, nbr, grad), features.dtype)
    if features.device.type == "cuda" and grad.dtype != torch.float32:
        raise ValueError(f"K6 takes a float32 cotangent, got {grad.dtype}")


def _dw_launch(features, rules, grad):
    """K6 on CUDA tensors with N, Nq > 0 and a :class:`RuleBook` -> (K, C,
    Cout) float32. Features whose rows are no whole number of 4-byte
    copies run padded (:func:`pad_channels`); the gradient of the padded
    rows is sliced off."""
    c_in = features.shape[1]
    features = pad_channels(features)[0].contiguous()
    grad = grad.contiguous()
    n, c = features.shape
    nq, k = rules.shape
    cout = grad.shape[1]
    out_rows, counts = rules.pairs()
    slabs = -(-nq // _DW_SLAB)
    part = torch.empty((k, slabs, c, cout), dtype=torch.float32,
                       device=features.device)
    out = torch.empty((k, c, cout), dtype=torch.float32,
                      device=features.device)
    err = load_library("subm_conv_dw").d3d_subm_conv_dw(
        features.data_ptr(), rules.nbr.data_ptr(), out_rows.data_ptr(),
        counts.data_ptr(), grad.data_ptr(), part.data_ptr(), out.data_ptr(),
        n, nq, k, c, cout, _DW_SLAB, _DTYPES[features.dtype],
        _vec(features, c, "K6 features"), _vec(grad, cout, "K6 cotangent"),
        stream_handle(features.device))
    if err:
        raise RuntimeError(f"subm_conv_dw kernel launch failed: CUDA error "
                           f"{err}")
    return out if c == c_in else out[:, :c_in].contiguous()


def subm_conv_dw(features, nbr, grad):
    """(N, C) features (float32 or bfloat16), (Nq, K) int32 nbr or its
    :class:`RuleBook`, (Nq, Cout) float32 cotangent (already masked by the
    output sites' validity) -> (K, C, Cout) float32 weight gradient (K6;
    launches counted in ``subm_conv_dw.launches``). Sums run in an order
    fixed by the map, so a repeated call gives the same bits."""
    _check_dw(features, _nbr_tensor(nbr), grad)
    if features.device.type == "cpu":
        return _subm_conv_dw_plain(features, _nbr_tensor(nbr), grad)
    k, c, cout = nbr.shape[1], features.shape[1], grad.shape[1]
    if min(nbr.shape[0], features.shape[0], k * c * cout) == 0:
        return torch.zeros((k, c, cout), dtype=torch.float32,
                           device=features.device)  # nothing to launch
    out = _dw_launch(features, prepare_neighbor_map(nbr), grad)
    subm_conv_dw.launches += 1
    return out


subm_conv_dw.launches = 0


def _scatter_dfeat(gm, nbr, weights, n):
    """d/dfeatures of a general (strided) map: every query row's
    ``weights[k] @ gm[row]`` added into input row ``nbr[row, k]``, as the JAX
    module's XLA scatter-add does (``index_add_``)."""
    c = weights.shape[1]
    contrib = torch.einsum("nd,kcd->nkc", gm, weights.to(gm.dtype))
    contrib = torch.where((nbr >= 0)[..., None], contrib, 0)
    rows = torch.where(nbr >= 0, nbr, n).long().reshape(-1)
    dfeat = gm.new_zeros((n + 1, c))
    dfeat.index_add_(0, rows, contrib.reshape(-1, c))
    return dfeat[:-1]


class SubmConv(torch.autograd.Function):
    """``subm_conv`` with the JAX module's custom VJP
    (``sparse_conv_pallas._fused_bwd``).

    ``apply(features, nbr, weights, valid, symmetric)``, ``nbr`` a map or
    its :class:`RuleBook` (built here for a bare map on CUDA, then kept for
    the backward, so every kernel of the layer walks one rule book): the
    weights (any
    float dtype, e.g. the float32 parameter) are cast to the features' dtype
    for the forward K5 launch. The backward upcasts the cotangent to float32
    (autograd hands a bfloat16 one to a bfloat16 forward) and masks it by
    ``valid``; the weight gradient is K6, returned in the weights' dtype; the
    features' gradient, skipped when the features need none, is K5 on the
    masked cotangent with the weights mirrored and transposed
    (``weights.flip(0).transpose(1, 2)`` in float32) where ``symmetric`` says
    the map is a submanifold one (the offsets are centrosymmetric, so
    ``nbr[i, k] == j`` iff ``nbr[j, K-1-k] == i``), and a scatter-add
    otherwise; it comes back in the features' dtype.
    """

    @staticmethod
    def forward(ctx, features, nbr, weights, valid, symmetric):
        if symmetric and nbr.shape[0] != features.shape[0]:
            raise ValueError(f"a symmetric (submanifold) map has a row per "
                             f"site: nbr {tuple(nbr.shape)}, features "
                             f"{tuple(features.shape)}")
        if features.device.type == "cuda":
            nbr = prepare_neighbor_map(nbr)
        ctx.save_for_backward(features, weights, valid)
        ctx.nbr = nbr
        ctx.symmetric = symmetric
        return subm_conv(features, nbr, weights.to(features.dtype), valid)

    @staticmethod
    def backward(ctx, grad):
        features, weights, valid = ctx.saved_tensors
        nbr = ctx.nbr
        acc = _acc_dtype(grad.dtype)
        gm = grad.to(acc) * valid[:, None]
        dw = dfeat = None
        if ctx.needs_input_grad[2]:
            dw = subm_conv_dw(features, nbr, gm).to(weights.dtype)
        if ctx.needs_input_grad[0]:
            w = weights.to(acc)
            if ctx.symmetric:
                dfeat = subm_conv(gm, nbr, w.flip(0).transpose(1, 2), valid)
            else:
                dfeat = _scatter_dfeat(gm, _nbr_tensor(nbr), w,
                                       features.shape[0])
            dfeat = dfeat.to(features.dtype)
        return dfeat, None, dw, None, None

"""The sparse-conv gather-GEMM through the CUDA kernel K5
(``csrc/subm_conv.cu``), the port of the forward of
``d3d_tpu.ops.sparse_conv_pallas.subm_conv_fused``.

``subm_conv(features, nbr, weights, valid)`` computes
``out[n] = valid[n] * sum_k weights[k]^T features[nbr[n, k]]``, absent
(-1) neighbours contributing 0, accumulated in float32 and returned in the
features' dtype. Features and weights are float32 or bfloat16 (the same
dtype); the kernel converts bfloat16 to float32 in registers. A CPU tensor
goes to the plain version (:func:`_subm_conv_plain`); a CUDA tensor goes to
the kernel or the call raises.
"""

import torch

from ._build import load_library

__all__ = ["subm_conv"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _subm_conv_plain(features, nbr, weights, valid):
    """Gather ``features[nbr.clamp(min=0)]``, zero the absent rows, one
    float32 einsum over (offset, channel), mask by ``valid``."""
    gathered = features[nbr.clamp(min=0).long()]              # (Nq, K, C)
    gathered = torch.where((nbr >= 0)[..., None], gathered, 0)
    out = torch.einsum("nkc,kcd->nd", gathered.float(), weights.float())
    return (out * valid[:, None]).to(features.dtype)


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
    if features.dtype not in _DTYPES or weights.dtype != features.dtype:
        raise ValueError(f"features and weights must share float32 or "
                         f"bfloat16, got {features.dtype} and {weights.dtype}")
    if nbr.dtype != torch.int32 or valid.dtype != torch.bool:
        raise ValueError("nbr must be int32 and valid bool")
    devs = {t.device for t in (features, nbr, weights, valid)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no K5 kernel for device {features.device}")


def _launch(features, nbr, weights, valid):
    """K5 on CUDA tensors with Nq, Cout > 0 -> (Nq, Cout) in the features'
    dtype."""
    features = features.contiguous()
    nbr = nbr.contiguous()
    weights = weights.contiguous()
    valid = valid.contiguous()
    n, c = features.shape
    nq, k = nbr.shape
    cout = weights.shape[2]
    out = torch.empty((nq, cout), dtype=features.dtype,
                      device=features.device)
    err = load_library("subm_conv").d3d_subm_conv(
        features.data_ptr(), nbr.data_ptr(), weights.data_ptr(),
        valid.data_ptr(), out.data_ptr(), n, nq, k, c, cout,
        _DTYPES[features.dtype],
        torch.cuda.current_stream(features.device).cuda_stream)
    if err:
        raise RuntimeError(f"subm_conv kernel launch failed: CUDA error {err}")
    return out


def subm_conv(features, nbr, weights, valid):
    """(N, C) features, (Nq, K) int32 nbr, (K, C, Cout) weights of the same
    dtype, (Nq,) bool valid -> (Nq, Cout) in the features' dtype (K5;
    launches counted in ``subm_conv.launches``)."""
    _check(features, nbr, weights, valid)
    if features.device.type == "cpu":
        return _subm_conv_plain(features, nbr, weights, valid)
    nq, cout = nbr.shape[0], weights.shape[2]
    if nq == 0 or cout == 0:  # nothing to launch
        return torch.empty((nq, cout), dtype=features.dtype,
                           device=features.device)
    out = _launch(features, nbr, weights, valid)
    subm_conv.launches += 1
    return out


subm_conv.launches = 0

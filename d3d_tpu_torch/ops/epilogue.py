"""The BEV layers' epilogue, inference BatchNorm and ReLU in one pass,
through the CUDA kernel of ``csrc/bn_relu.cu``.

On the inference route of ``models/pointpillars.py`` each layer's output
goes through this pass once: ``relu((x - mean) * mul + beta)`` along dim
1, flax's BatchNorm from the running statistics as the port's training
route writes it (``_bn_train``), in place or into a channel slice of a
larger map (the upsamplings' concatenated output). A CPU tensor goes to
the plain version (:func:`_bn_relu_plain`); a CUDA tensor goes to the
kernel or the call raises. The kernel replaces no TPU kernel (the JAX
package leaves the layer to XLA's fusion).

The two forms are ``torch.library`` custom ops, ``d3d_tpu_torch::bn_relu``
(in place, mutating ``x``) and ``d3d_tpu_torch::bn_relu_into`` (mutating
``out``), so that ``torch.export`` keeps them as nodes of a traced detector:
their CUDA implementation launches the kernel and counts the launch in
``bn_relu.launches``, their CPU implementation is the plain version and
counts none.
"""

import torch

from ._build import load_library, stream_handle

__all__ = ["bn_relu"]

_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
# the planes' grid: channels and batches (csrc/bn_relu.cu)
_MAX_GRID_YZ = 65535
# the rows kernel's block: a row's 16-byte vectors must fit in it
_THREADS = 256


def _bn_relu_plain(x, mean, mul, beta, out):
    """``out = relu((x - mean) * mul + beta)`` along dim 1, computed in the
    statistics' dtype and rounded once to ``out``'s; ``out`` may be
    ``x``."""
    shape = [1, -1] + [1] * (x.ndim - 2)
    y = ((x.to(mean.dtype) - mean.view(shape)) * mul.view(shape)
         + beta.view(shape))
    out.copy_(torch.relu_(y))


def bn_relu(x, mean, mul, beta, out=None):
    """``relu((x - mean[c]) * mul[c] + beta[c])`` along dim 1 of ``x``, a
    (B, C, H, W) map or (N, C) rows: inference BatchNorm with ``mul =
    rsqrt(var + eps) * scale``, then the ReLU. The statistics are (C,) in
    float32 (float64 for a float64 ``x``); each operation rounds in that
    dtype, the result once to ``x``'s. Written into ``out`` (``x``'s
    shape, dtype and device, e.g. a channel slice of a larger map) or, by
    default, into ``x`` itself; returns the tensor written. On CUDA the
    kernel takes float32, float64 and bfloat16; a map's H x W
    planes must be dense (any channel and batch strides), rows
    contiguous."""
    if x.ndim not in (2, 4) or any(t.shape != (x.shape[1],)
                                   for t in (mean, mul, beta)):
        raise ValueError(f"expected a (B, C, H, W) map or (N, C) rows and "
                         f"(C,) statistics, got {tuple(x.shape)} and "
                         f"{[tuple(t.shape) for t in (mean, mul, beta)]}")
    want = torch.promote_types(x.dtype, torch.float32)
    if any(t.dtype != want or t.device != x.device
           for t in (mean, mul, beta)):
        got = [(t.dtype, str(t.device)) for t in (mean, mul, beta)]
        raise ValueError(f"statistics must be {want} on {x.device}, got "
                         f"{got}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}, x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no epilogue kernel for device {x.device}")
    if out is None:
        torch.ops.d3d_tpu_torch.bn_relu(x, mean, mul, beta)
        return x
    torch.ops.d3d_tpu_torch.bn_relu_into(x, mean, mul, beta, out)
    return out


bn_relu.launches = 0


def _launch(x, mean, mul, beta, out):
    """The kernel on the CUDA tensor ``x`` into ``out`` (may be ``x``)."""
    if x.numel() == 0:
        return
    if x.dtype not in _DTYPES:
        raise ValueError(f"the epilogue kernel takes {list(_DTYPES)}, got "
                         f"{x.dtype}")
    per_vec = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, out))
    if x.ndim == 2:
        n, c = x.shape
        if not (x.is_contiguous() and out.is_contiguous()):
            raise ValueError("the epilogue kernel needs contiguous rows")
        rows, plane, strides = True, 1, (0, 0, 0, 0)
        vec = aligned and c % per_vec == 0 and c // per_vec <= _THREADS
        batch = n
    else:
        batch, c, h, w = x.shape
        if batch > _MAX_GRID_YZ or c > _MAX_GRID_YZ:
            raise ValueError(f"the epilogue kernel takes at most "
                             f"{_MAX_GRID_YZ} channels and batches, got {c} "
                             f"and {batch}")
        if not (x[0, 0].is_contiguous() and out[0, 0].is_contiguous()):
            raise ValueError(f"the epilogue kernel needs dense H x W planes, "
                             f"got strides {x.stride()} and {out.stride()}")
        rows, plane = False, h * w
        strides = (x.stride(0), x.stride(1), out.stride(0), out.stride(1))
        vec = aligned and all(s % per_vec == 0 for s in (plane, *strides))
    mean, mul, beta = (t.contiguous() for t in (mean, mul, beta))
    err = load_library("bn_relu").d3d_bn_relu(
        x.data_ptr(), out.data_ptr(), mean.data_ptr(), mul.data_ptr(),
        beta.data_ptr(), _DTYPES[x.dtype], int(rows), int(vec), batch, c,
        plane, *strides, stream_handle(x.device))
    if err:
        raise RuntimeError(f"bn_relu kernel launch failed: CUDA error {err}")
    bn_relu.launches += 1


@torch.library.custom_op("d3d_tpu_torch::bn_relu", mutates_args=("x",),
                         device_types="cpu")
def _inplace_op(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                beta: torch.Tensor) -> None:
    """The epilogue in place (see :func:`bn_relu`)."""
    _bn_relu_plain(x, mean, mul, beta, x)


@_inplace_op.register_kernel("cuda")
def _inplace_cuda(x, mean, mul, beta):
    _launch(x, mean, mul, beta, x)


@torch.library.custom_op("d3d_tpu_torch::bn_relu_into",
                         mutates_args=("out",), device_types="cpu")
def _into_op(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
             beta: torch.Tensor, out: torch.Tensor) -> None:
    """The epilogue into ``out`` (see :func:`bn_relu`)."""
    _bn_relu_plain(x, mean, mul, beta, out)


@_into_op.register_kernel("cuda")
def _into_cuda(x, mean, mul, beta, out):
    _launch(x, mean, mul, beta, out)

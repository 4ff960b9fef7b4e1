"""Weight-only int8 quantization for serving (port of
``d3d_tpu.quantize``).

Every weight that the JAX package quantizes (its ``kernel`` leaves: the
port's ``*.weight`` tensors of two or more dimensions) is stored as
per-output-channel symmetric int8 with a float32 scale vector, and
dequantized when the weights are loaded. Norm parameters, biases and
statistics stay in full precision.

The output-channel axis depends on the layout (the JAX package's flax
kernels keep it last): 0 for ``Linear`` and ``Conv2d``, 1 for
``ConvTranspose2d``, last for SECOND's (K, C, Cout) sparse kernels
(:func:`d3d_tpu_torch.models.fold.output_axes`), so the functions take the
model itself.

Usage::

    q = quantize_params(model)                   # int8 + scales
    model.load_state_dict(dequantize_params(q))  # apply-ready weights
"""

import torch

from .models.fold import output_axes

__all__ = ["quantize_params", "dequantize_params", "quantized_bytes"]

_QKEY = "_int8"
_SKEY = "_scale"
_AKEY = "_axis"


def quantize_params(model):
    """Per-output-channel symmetric int8 quantization of every weight with
    two or more dimensions: ``scale = max|w| / 127`` over the other axes
    (1 where the channel is all zero), ``q = clip(round(w / scale), -127,
    127)``, computed on the host in float32 as the JAX function does.

    :param model: the module whose ``state_dict`` is quantized; it gives
        each weight's output axis
    :returns: a dict where each such weight becomes ``{"_int8": int8,
        "_scale": (C_out,) float32, "_axis": int}`` on the weight's
        device; other entries pass through.
    """
    axes = output_axes(model)
    out = {}
    for name, w in model.state_dict().items():
        if name not in axes:
            out[name] = w
            continue
        axis = axes[name]
        wc = w.detach().to("cpu", torch.float32)
        dims = [d for d in range(wc.ndim) if d != axis]
        scale = wc.abs().amax(dim=dims) / 127.0
        scale = torch.where(scale > 0, scale, 1.0)
        shape = [1] * wc.ndim
        shape[axis] = -1
        q = torch.clamp(torch.round(wc / scale.view(shape)), -127, 127)
        out[name] = {_QKEY: q.to(torch.int8).to(w.device),
                     _SKEY: scale.to(w.device), _AKEY: axis}
    return out


def _is_qdict(x):
    return isinstance(x, dict) and _QKEY in x and _SKEY in x


def dequantize_params(qparams, dtype=torch.float32):
    """An apply-ready ``state_dict`` from :func:`quantize_params` output:
    ``q * scale`` in float32 along each weight's output axis, cast to
    ``dtype``."""
    out = {}
    for name, x in qparams.items():
        if _is_qdict(x):
            shape = [1] * x[_QKEY].ndim
            shape[x[_AKEY]] = -1
            x = (x[_QKEY].to(torch.float32)
                 * x[_SKEY].view(shape)).to(dtype)
        out[name] = x
    return out


def quantized_bytes(tree):
    """Total bytes of the tensors of a (possibly quantized) state_dict."""
    total = 0
    for x in tree.values():
        for t in (x.values() if isinstance(x, dict) else (x,)):
            if isinstance(t, torch.Tensor):
                total += t.numel() * t.element_size()
    return total

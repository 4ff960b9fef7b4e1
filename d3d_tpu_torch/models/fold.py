"""Inference-time BatchNorm folding (port of ``d3d_tpu.models.fold``).

At inference BatchNorm is a per-channel affine with frozen statistics; its
multiplicative part is absorbed into the preceding linear layer's weight
ahead of time. The module tree stays as it is: weights are rescaled along
their output-channel axis and each folded BatchNorm becomes a pure
per-channel add (weight 1, running mean = the negated residual, running
variance ``1 - eps``, bias 0), so the folded ``state_dict`` loads into the
same model and gives the same inference outputs with one multiply fewer a
channel.

Pairing follows the port's module structure: a BatchNorm ``X.bn`` folds
into ``X.dense`` or ``X.conv``, ``X.bns.j`` into ``X.convs.j``
(PointPillars' PFN, BEV blocks and upsampling; SECOND's BEV block). A
layer whose weight is the module's own parameter (SECOND's sparse layers
with their ``_MaskedBN``) has no such partner and is not folded, as the
JAX function folds none of them. The output-channel axis comes from the
module type (:func:`output_axes`): a ``state_dict`` alone cannot tell a
``Conv2d`` (O, I, kh, kw) from a ``ConvTranspose2d`` (I, O, kh, kw) whose
two channel counts are equal.
"""

import numpy as np
import torch
from torch import nn

__all__ = ["fold_batchnorm", "output_axes"]

_LINEAR = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)
_TRANSPOSED = (nn.ConvTranspose1d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def output_axes(model):
    """``{parameter name: output-channel axis}`` of every weight with two
    or more dimensions: 0 for ``Linear`` (out, in) and ``Conv*`` (O, I,
    ...), 1 for ``ConvTranspose*`` (I, O, ...), and the last axis for a
    module's own weight in the flax layout (SECOND's sparse (K, C, Cout)
    kernels)."""
    axes = {}
    for mname, mod in model.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            if pname != "weight" or p.ndim < 2:
                continue
            name = f"{mname}.{pname}" if mname else pname
            axes[name] = (0 if isinstance(mod, _LINEAR)
                          else 1 if isinstance(mod, _TRANSPOSED)
                          else p.ndim - 1)
    return axes


def _auto_pairs(model):
    mods = dict(model.named_modules())
    pairs = []
    for name, mod in mods.items():
        if not isinstance(mod, nn.modules.batchnorm._BatchNorm):
            continue
        scope, _, leaf = name.rpartition(".")
        if leaf.isdigit() and scope.endswith(".bns"):
            partners = [scope[:-len("bns")] + "convs." + leaf]
        else:
            partners = [f"{scope}.{p}" if scope else p
                        for p in ("dense", "conv")]
        lin = next((p for p in partners
                    if isinstance(mods.get(p), _LINEAR + _TRANSPOSED)), None)
        if lin is not None:
            pairs.append((lin, name))
    return pairs


def fold_batchnorm(model, eps=1e-3, pairs=None):
    """Return a new ``state_dict`` with the inference BatchNorm multiplies
    of ``model.state_dict()`` folded into the preceding weights.

    :param model: the module whose structure pairs the layers and gives
        each weight's output axis, and whose ``state_dict`` is folded (the
        JAX function reads all three from the flax variable tree)
    :param eps: the BatchNorm epsilon the model was built with; it must
        match (1e-3, every model of this package)
    :param pairs: optional explicit ``[(linear module name, BatchNorm
        module name)]`` instead of the structural pairing
    :returns: a new ``state_dict``; inference outputs equal the input's up
        to one float rounding
    """
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    axes = output_axes(model)
    for lin, bn in (_auto_pairs(model) if pairs is None else pairs):
        weight = sd[f"{lin}.weight"]
        axis = axes[f"{lin}.weight"]
        mean = sd[f"{bn}.running_mean"].cpu().numpy().astype(np.float64)
        var = sd[f"{bn}.running_var"].cpu().numpy().astype(np.float64)
        gamma = sd[f"{bn}.weight"].cpu().numpy().astype(np.float64)
        beta = sd[f"{bn}.bias"].cpu().numpy().astype(np.float64)
        if weight.shape[axis] != mean.shape[0]:
            raise ValueError(
                f"{lin}: out-features {weight.shape[axis]} != {bn} "
                f"channels {mean.shape[0]}")
        s = gamma / np.sqrt(var + eps)
        shape = [1] * weight.ndim
        shape[axis] = -1
        sd[f"{lin}.weight"] = weight * torch.as_tensor(
            s, dtype=weight.dtype).to(weight.device).view(shape)
        bias_key = f"{lin}.bias"
        if bias_key in sd and sd[bias_key] is not None:
            b = sd[bias_key]
            sd[bias_key] = torch.as_tensor(
                (b.cpu().numpy().astype(np.float64) - mean) * s + beta,
                dtype=b.dtype).to(b.device)
            resid = np.zeros_like(beta)
        else:
            resid = beta - mean * s
        stat = sd[f"{bn}.running_mean"]
        sd[f"{bn}.running_mean"] = torch.as_tensor(
            -resid, dtype=stat.dtype).to(stat.device)
        sd[f"{bn}.running_var"] = torch.full_like(
            sd[f"{bn}.running_var"], float(np.float32(1.0 - eps)))
        sd[f"{bn}.weight"] = torch.ones_like(sd[f"{bn}.weight"])
        sd[f"{bn}.bias"] = torch.zeros_like(sd[f"{bn}.bias"])
    return sd

"""Carry weights from the JAX package's flax PointPillars to the port.

The flax variables are a ``{"params", "batch_stats"}`` tree of nested dicts
of arrays (numpy, or anything ``np.asarray`` takes); nothing here imports
JAX. Layout changes: Dense kernels (in, out) transpose to Linear (out, in);
Conv kernels HWIO go to OIHW; the stride-f ConvTranspose kernel (kh, kw,
in, out) flips spatially and goes to (in, out, kh, kw), because flax's
``transpose_kernel=False`` with SAME padding feeds output cell ``i*f + r``
through tap ``f-1-r`` where torch uses tap ``r``.
"""

import numpy as np
import torch

__all__ = ["pointpillars_state_from_flax"]


def _oihw(kernel):
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def pointpillars_state_from_flax(variables):
    """flax PointPillars variables -> the port's ``state_dict``."""
    params = variables["params"]
    stats = variables["batch_stats"]
    sd = {}

    def bn(prefix, p, s):
        sd[prefix + ".weight"] = p["scale"]
        sd[prefix + ".bias"] = p["bias"]
        sd[prefix + ".running_mean"] = s["mean"]
        sd[prefix + ".running_var"] = s["var"]
        sd[prefix + ".num_batches_tracked"] = np.zeros((), np.int64)

    pfn = params["_PFN_0"]
    sd["pfn.dense.weight"] = np.asarray(pfn["Dense_0"]["kernel"]).T
    bn("pfn.bn", pfn["BatchNorm_0"], stats["_PFN_0"]["BatchNorm_0"])

    i = 0
    while f"_ConvBlock_{i}" in params:
        blk, st = params[f"_ConvBlock_{i}"], stats[f"_ConvBlock_{i}"]
        j = 0
        while f"Conv_{j}" in blk:
            sd[f"blocks.{i}.convs.{j}.weight"] = _oihw(blk[f"Conv_{j}"]["kernel"])
            bn(f"blocks.{i}.bns.{j}", blk[f"BatchNorm_{j}"],
               st[f"BatchNorm_{j}"])
            j += 1
        up, st = params[f"_Upsample_{i}"], stats[f"_Upsample_{i}"]
        if "ConvTranspose_0" in up:
            k = np.asarray(up["ConvTranspose_0"]["kernel"])
            sd[f"ups.{i}.conv.weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
        else:
            sd[f"ups.{i}.conv.weight"] = _oihw(up["Conv_0"]["kernel"])
        bn(f"ups.{i}.bn", up["BatchNorm_0"], st["BatchNorm_0"])
        i += 1

    for name in ("head_cls", "head_box", "head_dir"):
        sd[name + ".weight"] = _oihw(params[name]["kernel"])
        sd[name + ".bias"] = params[name]["bias"]
    return {k: torch.as_tensor(np.ascontiguousarray(v))
            for k, v in sd.items()}

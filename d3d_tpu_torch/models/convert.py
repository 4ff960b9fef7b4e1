"""Carry weights from the JAX package's flax PointPillars, CenterPoint (and
its refinement stage), SECOND, VoxelNeXt, Seg2D, Mono3D and BEVSeg to the
port.

The flax variables are a ``{"params", "batch_stats"}`` tree of nested dicts
of arrays (numpy, or anything ``np.asarray`` takes); nothing here imports
JAX. Layout changes: Dense kernels (in, out) transpose to Linear (out, in);
Conv kernels HWIO go to OIHW; the stride-f ConvTranspose kernel (kh, kw,
in, out) flips spatially and goes to (in, out, kh, kw), because flax's
``transpose_kernel=False`` with SAME padding feeds output cell ``i*f + r``
through tap ``f-1-r`` where torch uses tap ``r``; Seg2D's 4x4 stride-2
ConvTranspose (Mono3D's too) flips the same way (torch's ``padding=1``
then equals flax's SAME), and so does BEVSeg's 2x2 stride-2 one.
"""

import numpy as np
import torch

__all__ = ["pointpillars_state_from_flax", "pointpillars_params_from_flax",
           "centerpoint_state_from_flax", "centerpoint_params_from_flax",
           "centerpoint_refine_state_from_flax", "seg2d_state_from_flax",
           "seg2d_params_from_flax", "second_state_from_flax",
           "second_params_from_flax", "voxelnext_state_from_flax",
           "voxelnext_params_from_flax", "mono3d_state_from_flax",
           "mono3d_params_from_flax", "bevseg_state_from_flax",
           "bevseg_params_from_flax"]


def _oihw(kernel):
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def _bn(sd, prefix, p, s, tracked=True):
    """One flax BatchNorm's scale/bias and (where ``s`` is given)
    mean/var into ``sd``."""
    sd[prefix + ".weight"] = p["scale"]
    sd[prefix + ".bias"] = p["bias"]
    if s is None:
        return
    sd[prefix + ".running_mean"] = s["mean"]
    sd[prefix + ".running_var"] = s["var"]
    if tracked:  # torch's BatchNorm modules count batches
        sd[prefix + ".num_batches_tracked"] = np.zeros((), np.int64)


def _conv_block(sd, prefix, blk, st):
    """A flax ``_ConvBlock`` (Conv_j + BatchNorm_j) into ``sd``."""
    j = 0
    while f"Conv_{j}" in blk:
        sd[f"{prefix}.convs.{j}.weight"] = _oihw(blk[f"Conv_{j}"]["kernel"])
        _bn(sd, f"{prefix}.bns.{j}", blk[f"BatchNorm_{j}"],
            st and st[f"BatchNorm_{j}"])
        j += 1


def _heads(sd, params):
    for name in ("head_cls", "head_box", "head_dir"):
        sd[name + ".weight"] = _oihw(params[name]["kernel"])
        sd[name + ".bias"] = params[name]["bias"]


def _tensors(sd):
    return {k: torch.as_tensor(np.array(v)) for k, v in sd.items()}


def _flipped(kernel):
    """A flax ConvTranspose kernel (kh, kw, in, out) as torch's (in, out,
    kh, kw), flipped in both spatial axes."""
    return np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1)


def _pillar_backbone(sd, params, stats):
    """The PFN, BEV blocks and upsampling PointPillars and CenterPoint
    share, into ``sd``."""
    pfn = params["_PFN_0"]
    sd["pfn.dense.weight"] = np.asarray(pfn["Dense_0"]["kernel"]).T
    _bn(sd, "pfn.bn", pfn["BatchNorm_0"],
        stats and stats["_PFN_0"]["BatchNorm_0"])

    i = 0
    while f"_ConvBlock_{i}" in params:
        _conv_block(sd, f"blocks.{i}", params[f"_ConvBlock_{i}"],
                    stats and stats[f"_ConvBlock_{i}"])
        up = params[f"_Upsample_{i}"]
        if "ConvTranspose_0" in up:
            sd[f"ups.{i}.conv.weight"] = _flipped(
                up["ConvTranspose_0"]["kernel"])
        else:
            sd[f"ups.{i}.conv.weight"] = _oihw(up["Conv_0"]["kernel"])
        _bn(sd, f"ups.{i}.bn", up["BatchNorm_0"],
            stats and stats[f"_Upsample_{i}"]["BatchNorm_0"])
        i += 1


def _pointpillars(params, stats):
    """PointPillars' entries; without ``stats`` the parameters only."""
    sd = {}
    _pillar_backbone(sd, params, stats)
    _heads(sd, params)
    return _tensors(sd)


def pointpillars_state_from_flax(variables):
    """flax PointPillars variables -> the port's ``state_dict``."""
    return _pointpillars(variables["params"], variables["batch_stats"])


def pointpillars_params_from_flax(params):
    """A flax PointPillars ``params`` tree alone (the parameters, or
    anything of their structure, such as a gradient tree) -> ``{name:
    tensor}`` under the port's ``named_parameters()`` names, in its
    layouts (the gradient of a flipped or transposed kernel is the
    gradient flipped or transposed alike)."""
    return _pointpillars(params, None)


def _centerpoint(params, stats):
    """CenterPoint's entries: PointPillars' backbone, then each head's
    ``{name}_conv`` (3x3) and ``{name}_out`` (1x1) with their biases."""
    sd = {}
    _pillar_backbone(sd, params, stats)
    _conv_heads(sd, params, "heads.")
    return _tensors(sd)


def centerpoint_state_from_flax(variables):
    """flax CenterPoint variables -> the port's ``state_dict``."""
    return _centerpoint(variables["params"], variables["batch_stats"])


def centerpoint_params_from_flax(params):
    """A flax CenterPoint ``params`` tree alone (or a gradient tree of its
    structure) -> ``{name: tensor}`` under the port's
    ``named_parameters()`` names, in its layouts."""
    return _centerpoint(params, None)


def centerpoint_refine_state_from_flax(variables):
    """flax CenterPointRefine variables (``{"params": ...}``, or the
    params tree itself) -> the port's ``state_dict``: the Dense layers
    ``fc{i}`` and ``out``, kernels (in, out) transposed to (out, in)."""
    params = variables.get("params", variables)
    sd = {}
    i = 0
    while f"fc{i}" in params:
        sd[f"fcs.{i}.weight"] = np.asarray(params[f"fc{i}"]["kernel"]).T
        sd[f"fcs.{i}.bias"] = params[f"fc{i}"]["bias"]
        i += 1
    sd["out.weight"] = np.asarray(params["out"]["kernel"]).T
    sd["out.bias"] = params["out"]["bias"]
    return _tensors(sd)


def _blocks(sd, params, stats):
    """Seg2D's ``_Block_{i}`` (its Conv_0 or flipped ConvTranspose_0 and
    BatchNorm_0) into ``blocks.{i}``; Mono3D shares the block."""
    i = 0
    while f"_Block_{i}" in params:
        blk = params[f"_Block_{i}"]
        sd[f"blocks.{i}.conv.weight"] = (
            _flipped(blk["ConvTranspose_0"]["kernel"])
            if "ConvTranspose_0" in blk else _oihw(blk["Conv_0"]["kernel"]))
        _bn(sd, f"blocks.{i}.bn", blk["BatchNorm_0"],
            stats and stats[f"_Block_{i}"]["BatchNorm_0"])
        i += 1


def _conv_heads(sd, params, prefix=""):
    """Each flax Conv whose name ends in ``_conv``/``_out`` or starts with
    ``head_`` (kernel and bias) under the same name."""
    for name, p in params.items():
        if name.endswith(("_conv", "_out")) or name.startswith("head_"):
            sd[f"{prefix}{name}.weight"] = _oihw(p["kernel"])
            sd[f"{prefix}{name}.bias"] = p["bias"]


def _seg2d(params, stats):
    """Seg2D's entries: its blocks and the 1x1 head ``Conv_0``."""
    sd = {}
    _blocks(sd, params, stats)
    sd["head.weight"] = _oihw(params["Conv_0"]["kernel"])
    sd["head.bias"] = params["Conv_0"]["bias"]
    return _tensors(sd)


def seg2d_state_from_flax(variables):
    """flax Seg2D variables -> the port's ``state_dict``."""
    return _seg2d(variables["params"], variables["batch_stats"])


def seg2d_params_from_flax(params):
    """A flax Seg2D ``params`` tree alone (or a gradient tree of its
    structure) -> ``{name: tensor}`` under the port's
    ``named_parameters()`` names, in its layouts."""
    return _seg2d(params, None)


def _sparse_middle(sd, params, stats):
    """The sparse layers ``subm{s}_{i}`` / ``down{s}``: (K, C, Cout)
    kernels as they are, each layer's masked BatchNorm."""
    for name, p in params.items():
        if name.startswith(("subm", "down")):
            sd[f"middle.{name}.weight"] = p["kernel"]
            _bn(sd, f"middle.{name}.bn", p["_MaskedBN_0"],
                stats and stats[name]["_MaskedBN_0"], tracked=False)


def _second(params, stats):
    """SECOND's entries; without ``stats`` the parameters only."""
    sd = {}
    _sparse_middle(sd, params, stats)
    _conv_block(sd, "head_block", params["_ConvBlock_0"],
                stats and stats["_ConvBlock_0"])
    _heads(sd, params)
    return _tensors(sd)


def second_state_from_flax(variables):
    """flax SECOND variables -> the port's ``state_dict``. The sparse
    layers ``subm{s}_{i}`` / ``down{s}`` keep their (K, C, Cout) kernels
    as they are; the BEV block and the heads convert as PointPillars'."""
    return _second(variables["params"], variables["batch_stats"])


def second_params_from_flax(params):
    """A flax SECOND ``params`` tree alone (the parameters, or anything of
    their structure, such as a gradient tree) -> ``{name: tensor}`` under
    the port's ``named_parameters()`` names, in its layouts (the
    gradient of a transposed kernel is the transposed gradient)."""
    return _second(params, None)


def _voxelnext(params, stats):
    """VoxelNeXt's entries; without ``stats`` the parameters only."""
    sd = {}
    _sparse_middle(sd, params, stats)
    for name in ("head1", "head_hm", "head_reg"):
        sd[name + ".weight"] = np.asarray(params[name]["kernel"]).T
        sd[name + ".bias"] = params[name]["bias"]
    _bn(sd, "head_bn", params["head_bn"], stats and stats["head_bn"],
        tracked=False)
    return _tensors(sd)


def voxelnext_state_from_flax(variables):
    """flax VoxelNeXt variables -> the port's ``state_dict``: the sparse
    layers as SECOND's, the per-site Dense heads (in, out) transposed to
    ``Linear`` (out, in), ``head_bn`` a masked BatchNorm."""
    return _voxelnext(variables["params"], variables["batch_stats"])


def voxelnext_params_from_flax(params):
    """A flax VoxelNeXt ``params`` tree alone (or a gradient tree of its
    structure) -> ``{name: tensor}`` under the port's
    ``named_parameters()`` names, in its layouts."""
    return _voxelnext(params, None)


def _mono3d(params, stats):
    """Mono3D's entries: its blocks (Seg2D's) and each head's
    ``{name}_conv`` (3x3) and ``{name}_out`` (1x1) with their biases."""
    sd = {}
    _blocks(sd, params, stats)
    _conv_heads(sd, params, "heads.")
    return _tensors(sd)


def mono3d_state_from_flax(variables):
    """flax Mono3D variables -> the port's ``state_dict``."""
    return _mono3d(variables["params"], variables["batch_stats"])


def mono3d_params_from_flax(params):
    """A flax Mono3D ``params`` tree alone (or a gradient tree of its
    structure) -> ``{name: tensor}`` under the port's
    ``named_parameters()`` names, in its layouts."""
    return _mono3d(params, None)


def _bevseg(params, stats):
    """BEVSeg's entries: the PFN, the encoder's ``_ConvBlock_{i}`` (the
    last ``_ConvBlock`` is the decoder's ``dec``), the ``_Up_{j}``
    (flipped ConvTranspose_0, BatchNorm_0) and the 1x1 heads."""
    sd = {}
    pfn = params["_PFN_0"]
    sd["pfn.dense.weight"] = np.asarray(pfn["Dense_0"]["kernel"]).T
    _bn(sd, "pfn.bn", pfn["BatchNorm_0"],
        stats and stats["_PFN_0"]["BatchNorm_0"])
    nblocks = sum(1 for k in params if k.startswith("_ConvBlock_"))
    for i in range(nblocks):
        _conv_block(sd, "dec" if i == nblocks - 1 else f"blocks.{i}",
                    params[f"_ConvBlock_{i}"],
                    stats and stats[f"_ConvBlock_{i}"])
    j = 0
    while f"_Up_{j}" in params:
        up = params[f"_Up_{j}"]
        sd[f"ups.{j}.conv.weight"] = _flipped(up["ConvTranspose_0"]["kernel"])
        _bn(sd, f"ups.{j}.bn", up["BatchNorm_0"],
            stats and stats[f"_Up_{j}"]["BatchNorm_0"])
        j += 1
    _conv_heads(sd, params)
    return _tensors(sd)


def bevseg_state_from_flax(variables):
    """flax BEVSeg variables -> the port's ``state_dict``."""
    return _bevseg(variables["params"], variables["batch_stats"])


def bevseg_params_from_flax(params):
    """A flax BEVSeg ``params`` tree alone (or a gradient tree of its
    structure) -> ``{name: tensor}`` under the port's
    ``named_parameters()`` names, in its layouts."""
    return _bevseg(params, None)

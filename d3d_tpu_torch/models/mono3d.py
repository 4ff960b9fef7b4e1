"""Monocular camera 3D detection, the first camera family (port of
``d3d_tpu.models.mono3d``).

A CenterNet-style single-stage detector in the SMOKE recipe (Liu et al.,
CVPRW 2020, arXiv:2002.10111): a keypoint heatmap at the projected 3D
centre, per-keypoint depth / dimension-residual / observation-angle
regression and a closed-form back-projection through the camera
intrinsics. Everything is dense image-space convolutions and elementwise
decode; the 3x3 max-pool peak test in :func:`decode_mono3d` is the NMS, so
no kernel of the port's runs on this path.

Conventions: camera coordinates are the KITTI rectified-camera frame (x
right, y down, z forward); boxes are [x, y, z, l, w, h, ry] with ry the
rotation about the camera y axis and (x, y, z) the bottom centre (the
KITTI label convention). The observation angle ``alpha = ry - atan2(x,
z)`` is what the network regresses; decode restores ``ry``. The network
runs NCHW; its outputs are the JAX module's NHWC maps ``(B, H/4, W/4, C)``
in float32 whatever the compute dtype.
"""

import contextlib
import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.voxel import _to_int64
from ..utils import as_tensor, resolve_device
from .centerpoint import _gaussian_radius
from ..parallel.comm import batch_sum
from .pointpillars import _buffers_kept, _train_step
from .seg2d import _Block

__all__ = ["Mono3DConfig", "Mono3D", "assign_mono3d_targets",
           "mono3d_loss", "decode_mono3d", "make_train_step",
           "mono3d_to_targets", "make_mono3d_detector",
           "mono3d_gt_from_targets"]

# the heads in the order of the targets' ``vec`` columns
_HEADS = (("offset", 2), ("depth", 1), ("dim", 3), ("rot", 2))


@dataclass(frozen=True)
class Mono3DConfig:
    """Static configuration (the JAX module's fields and defaults)."""

    image_size: Tuple[int, int] = (384, 1280)   # (H, W), divisible by 16
    stride: int = 4                             # output stride
    backbone_channels: Tuple[int, ...] = (32, 64, 128)
    head_channels: int = 64
    num_classes: int = 3
    top_k: int = 50
    # per-class dimension priors (l, w, h): KITTI car/ped/cyclist means
    dim_priors: Tuple[Tuple[float, float, float], ...] = (
        (3.88, 1.63, 1.53), (0.84, 0.66, 1.76), (1.76, 0.60, 1.74))
    max_depth: float = 80.0
    gaussian_overlap: float = 0.7
    min_radius: float = 2.0
    window: int = 25              # gaussian splat window (cells)
    dtype: str = "float32"

    @property
    def out_size(self):
        return (self.image_size[0] // self.stride,
                self.image_size[1] // self.stride)


class Mono3D(nn.Module):
    """Strided conv backbone -> stride-``cfg.stride`` feature map -> SMOKE
    heads.

    ``blocks`` are the flax module's ``_Block_{i}`` in call order: a /2
    stem, one stride-2 block per backbone channel entry, then
    ``len(backbone_channels) + 1 - log2(stride)`` transposed blocks back up
    to the output stride (Seg2D's block). Each head is a 3x3 SAME
    convolution to ``head_channels``, a ReLU and a 1x1 convolution, named
    as the flax module's (``heads.hm_conv``, ``heads.hm_out``, ...); the
    heatmap's output bias starts at -2.19.

    :param device: where the parameters live (default CUDA; raises when
        CUDA is missing and no device is given)
    :param generator: ``torch.Generator`` for the random initial weights
        (default: a generator seeded with 0)
    """

    def __init__(self, cfg: Mono3DConfig, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        c_in = cfg.backbone_channels[0]
        blocks = [_Block(3, c_in, 2, cfg.dtype)]
        for ch in cfg.backbone_channels:
            blocks.append(_Block(c_in, ch, 2, cfg.dtype))
            c_in = ch
        ups = len(cfg.backbone_channels) + 1 - int(np.log2(cfg.stride))
        for _ in range(ups):
            blocks.append(_Block(c_in, cfg.head_channels, 2, cfg.dtype,
                                 transpose=True))
            c_in = cfg.head_channels
        self.blocks = nn.ModuleList(blocks)
        layers = {}
        for name, n_out in (("hm", cfg.num_classes),) + _HEADS:
            layers[f"{name}_conv"] = nn.Conv2d(c_in, cfg.head_channels, 3)
            layers[f"{name}_out"] = nn.Conv2d(cfg.head_channels, n_out, 1)
        self.heads = nn.ModuleDict(layers)
        self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Seeded random weights: He-normal kernels (LeCun-normal for the
        heads' outputs), zero biases but the heatmap's -2.19, identity
        BatchNorm statistics."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        outs = {self.heads[f"{n}_out"] for n in ("hm",) + tuple(
            h for h, _ in _HEADS)}
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = (w.shape[0] * w.shape[2] * w.shape[3]
                          if isinstance(mod, nn.ConvTranspose2d)
                          else w[0].numel())
                gain = 1.0 if mod in outs else 2.0
                w.copy_(torch.randn(w.shape, generator=generator)
                        * math.sqrt(gain / fan_in))
                if mod.bias is not None:
                    mod.bias.fill_(-2.19 if mod is self.heads["hm_out"]
                                   else 0.0)
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()

    def forward(self, images, train=False):
        """:param images: (B, H, W, 3) in [0, 1]
        :param train: batch statistics, moving the running ones (the
            argument, not ``nn.Module.training``)
        :return: dict of float32 NHWC maps ``heatmap`` (B, h, w, C)
            logits, ``offset`` (2), ``depth`` (1), ``dim`` (3) log-residuals
            from the class priors, ``rot`` (2) (sin, cos) of alpha
        """
        dt = getattr(torch, self.cfg.dtype)
        x = images.to(dt).permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x, train)

        def head(name):
            conv, last = self.heads[f"{name}_conv"], self.heads[f"{name}_out"]
            y = F.relu(F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt),
                                padding=1))
            y = F.conv2d(y, last.weight.to(dt), last.bias.to(dt))
            return y.permute(0, 2, 3, 1).to(torch.float32)

        out = dict(heatmap=head("hm"))
        out.update((name, head(name)) for name, _ in _HEADS)
        return out


def _depth_decode(d):
    """SMOKE's unbounded-positive depth transform."""
    return 1.0 / torch.sigmoid(d) - 1.0


def _depth_encode(z):
    # inverse of _depth_decode: logit(1 / (z + 1))
    p = 1.0 / (z + 1.0)
    return torch.log(p) - torch.log1p(-p)


def _floor_cells(c):
    """floor(c) as int32 as XLA converts it (NaN -> 0, saturating at
    int32's ends) and that integer back as float32, as the JAX function
    reads it (INT32_MAX rounds to 2^31)."""
    f = torch.floor(c)
    i = torch.clamp(_to_int64(f), -2 ** 31, 2 ** 31 - 1).to(torch.int32)
    return i, torch.where(torch.isnan(f), 0.0, torch.clamp(f, -2.0 ** 31,
                                                           2.0 ** 31))


def assign_mono3d_targets(cfg: Mono3DConfig, intrinsics, gt_boxes,
                          gt_labels, gt_mask):
    """One frame of SMOKE targets from camera-frame 3D ground truth (no
    gradient; call under ``torch.no_grad()`` when the boxes carry one).

    :param intrinsics: (3, 3) camera matrix for the (resized) image
    :param gt_boxes: (M, 7) [x, y, z, l, w, h, ry] camera-frame boxes
        (bottom-centre origin, KITTI label convention)
    :returns: dict(heatmap (h, w, C), vec (M, 8) regression targets
        [du, dv, depth_enc, log-dim residuals (3), sin a, cos a], cell (M,)
        int32 flat centre cell (-1 = unassigned), mask (M,)). A box is
        assigned only in front of the camera (0.5 < z < max_depth) with
        its projected centre in the output map; the others' rows carry
        whatever their projection gives (a box behind the camera projects
        through ``max(z, 1e-3)``, the cell index saturating as XLA's).
    """
    h, w = cfg.out_size
    dev = gt_boxes.device
    m = gt_boxes.shape[0]
    gt_boxes = gt_boxes.to(torch.float32)
    k = as_tensor(intrinsics, device=dev, dtype=torch.float32)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    s = torch.tensor(float(cfg.stride), dtype=torch.float32, device=dev)

    x3, y3, z3 = gt_boxes[:, 0], gt_boxes[:, 1], gt_boxes[:, 2]
    yc = y3 - gt_boxes[:, 5] / 2                 # geometric 3D centre
    zc = torch.clamp_min(z3, 1e-3)
    u = (fx * x3 / zc + cx) / s                  # projected centre, cells
    v = (fy * yc / zc + cy) / s
    iu, fu = _floor_cells(u)
    iv, fv = _floor_cells(v)
    inside = ((z3 > 0.5) & (z3 < cfg.max_depth) & gt_mask.to(torch.bool)
              & (u >= 0) & (u < w) & (v >= 0) & (v < h))

    # gaussian radius from the projected box extent (cells)
    wpix = fx * gt_boxes[:, 3] / zc / s
    hpix = fy * gt_boxes[:, 5] / zc / s
    radius = torch.clamp_min(
        _gaussian_radius(torch.clamp_min(wpix, 1.0),
                         torch.clamp_min(hpix, 1.0), cfg.gaussian_overlap),
        cfg.min_radius)
    sigma2 = torch.clamp_min((2 * radius / 3.0) ** 2, 1e-6)

    win = cfg.window
    half = win // 2
    dxs = torch.arange(win, dtype=torch.int32, device=dev) - half
    gu = iu[:, None, None] + dxs[None, :, None]
    gv = iv[:, None, None] + dxs[None, None, :]
    d2 = ((gu - iu[:, None, None]) ** 2
          + (gv - iv[:, None, None]) ** 2).to(torch.float32)
    val = torch.exp(-d2 / (2 * sigma2[:, None, None]))
    cls = torch.clamp_min(gt_labels, 0).to(torch.int64)
    # a NaN value fails the > test, so the scatter-max never sees NaN
    # (torch's amax drops it where jnp.maximum keeps it); a label past the
    # classes is dropped, as JAX drops an out-of-bounds scatter update
    okw = ((inside & (cls < cfg.num_classes))[:, None, None]
           & (gu >= 0) & (gu < w) & (gv >= 0) & (gv < h) & (val > 1e-4))
    flat = torch.where(okw, gv * w + gu, w * h)  # row-major (v, u)
    idx = (flat.to(torch.int64) * cfg.num_classes
           + torch.where(okw, cls[:, None, None], 0))
    heat = torch.zeros((w * h + 1) * cfg.num_classes, dtype=torch.float32,
                       device=dev)
    heat = heat.scatter_reduce(0, idx.reshape(-1),
                               torch.where(okw, val, 0.0).reshape(-1),
                               "amax")
    heatmap = heat[:-cfg.num_classes].reshape(h, w, cfg.num_classes)

    priors = torch.tensor(cfg.dim_priors, dtype=torch.float32, device=dev)[
        torch.clamp(cls, max=len(cfg.dim_priors) - 1)]
    alpha = gt_boxes[:, 6] - torch.atan2(x3, zc)
    vec = torch.stack([
        u - fu, v - fv,
        _depth_encode(zc),
        torch.log(torch.clamp_min(gt_boxes[:, 3], 1e-3) / priors[:, 0]),
        torch.log(torch.clamp_min(gt_boxes[:, 4], 1e-3) / priors[:, 1]),
        torch.log(torch.clamp_min(gt_boxes[:, 5], 1e-3) / priors[:, 2]),
        torch.sin(alpha), torch.cos(alpha),
    ], dim=-1)
    cell = torch.where(inside, iv * w + iu, -1)
    return dict(heatmap=heatmap, vec=vec.reshape(m, 8),
                cell=cell.to(torch.int32), mask=inside)


def mono3d_loss(outputs, targets):
    """Penalty-reduced focal + masked L1 at centre cells (batched).
    Returns ``(total, dict(hm, reg, total))``. The positive count is the
    whole batch's in a sharded step."""
    hm = torch.clamp(torch.sigmoid(outputs["heatmap"]), 1e-5, 1 - 1e-5)
    t = targets["heatmap"]
    pos = t >= 1.0 - 1e-6
    npos = torch.clamp_min(batch_sum(pos.sum()), 1).to(torch.float32)
    pos_l = -((1 - hm) ** 2) * torch.log(hm) * pos
    neg_l = -((1 - t) ** 4) * (hm ** 2) * torch.log(1 - hm) * ~pos
    hm_loss = (pos_l.sum() + neg_l.sum()) / npos

    b = outputs["heatmap"].shape[0]
    hw = t.shape[1] * t.shape[2]
    pred = torch.cat([outputs[k] for k, _ in _HEADS],
                     dim=-1).reshape(b, hw, 8)
    cell = torch.clamp_min(targets["cell"], 0).to(torch.int64)
    at = pred.gather(1, cell[..., None].expand(-1, -1, 8))
    l1 = (at - targets["vec"]).abs() \
        * targets["mask"][..., None].to(torch.float32)
    reg_loss = l1.sum() / npos
    total = hm_loss + reg_loss
    return total, dict(hm=hm_loss, reg=reg_loss, total=total)


def _top_indices(cfg, outputs):
    """The peak test (a 3x3 max-pool per class, -inf padding) and the flat
    top-k over the (h, w, C) layout, equal scores lowest index first, as
    ``lax.top_k``: (scores, indices)."""
    hm = torch.sigmoid(outputs["heatmap"])                 # (h, w, C)
    pooled = F.max_pool2d(hm.permute(2, 0, 1)[None], 3, 1, 1)[0]
    peaks = torch.where(hm >= pooled.permute(1, 2, 0), hm, 0.0)
    flat = peaks.reshape(-1)
    idx = torch.sort(flat, descending=True, stable=True).indices[:cfg.top_k]
    return flat[idx], idx


def decode_mono3d(cfg: Mono3DConfig, outputs, intrinsics):
    """Peak top-k + closed-form back-projection of one frame's outputs
    (h, w, C) -> (K, 7) camera-frame boxes, scores, labels. Fixed output
    shapes; callers mask on ``scores``."""
    h, w = cfg.out_size
    hm = outputs["heatmap"]
    dev = hm.device
    k = as_tensor(intrinsics, device=dev, dtype=torch.float32)
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    s = float(cfg.stride)

    scores, idx = _top_indices(cfg, outputs)
    cell = torch.div(idx, cfg.num_classes, rounding_mode="floor")
    labels = (idx % cfg.num_classes).to(torch.int32)
    iv = torch.div(cell, w, rounding_mode="floor")
    iu = cell % w

    vec = torch.cat([outputs[k] for k, _ in _HEADS],
                    dim=-1).reshape(h * w, 8)[cell]
    z = _depth_decode(vec[:, 2])
    u = (iu.to(torch.float32) + vec[:, 0]) * s
    v = (iv.to(torch.float32) + vec[:, 1]) * s
    x3 = (u - cx) * z / fx
    yc = (v - cy) * z / fy
    priors = torch.tensor(cfg.dim_priors, dtype=torch.float32,
                          device=dev)[labels.to(torch.int64)]
    dims = priors * torch.exp(vec[:, 3:6])
    y3 = yc + dims[:, 2] / 2                     # back to bottom centre
    alpha = torch.atan2(vec[:, 6], vec[:, 7])
    ry = alpha + torch.atan2(x3, torch.clamp_min(z, 1e-3))
    boxes = torch.stack([x3, y3, z, dims[:, 0], dims[:, 1], dims[:, 2], ry],
                        dim=-1)
    return boxes, scores, labels


def _frame_targets(cfg, batch):
    """The batch's targets, one frame at a time, stacked."""
    with torch.no_grad():
        frames = [assign_mono3d_targets(cfg, k, b, l, m) for k, b, l, m in
                  zip(batch["intrinsics"], batch["gt_boxes"],
                      batch["gt_labels"], batch["gt_mask"])]
    return {key: torch.stack([f[key] for f in frames]) for key in frames[0]}


def make_train_step(model, optimizer, cfg: Mono3DConfig, remat=False):
    """Build ``step(batch) -> aux``, one training step that updates
    ``model`` (parameters and BatchNorm running statistics) and
    ``optimizer`` in place: forward with ``train=True``, the targets of
    :func:`assign_mono3d_targets` frame by frame, :func:`mono3d_loss`,
    backward, ``optimizer.step()``. After it each parameter's ``.grad``
    holds this step's gradient; ``aux`` holds the loss terms as detached
    0-d tensors.

    ``batch``: images (B, H, W, 3), intrinsics (B, 3, 3), gt_boxes (B, M,
    7) camera frame, gt_labels (B, M), gt_mask (B, M); tensors stay on
    their device, anything else goes to the model's.

    :param remat: recompute the forward in the backward
        (``torch.utils.checkpoint``, the JAX step's ``jax.checkpoint``),
        the BatchNorm buffers put back after the recompute

    The step carries ``model``, ``optimizer``, ``backward`` (forward, loss
    and backward on a batch, returning ``aux``) and ``global_aux`` (none),
    which :func:`~d3d_tpu_torch.parallel.mesh.shard_train_step` runs over
    a mesh, as the PointPillars step does.
    """
    dev = next(model.parameters()).device

    def forward(images):
        return model(images, train=True)

    if remat:
        def run_forward(images):
            return checkpoint(forward, images, use_reentrant=False,
                              context_fn=lambda: (
                                  contextlib.nullcontext(),
                                  _buffers_kept(model)))
    else:
        run_forward = forward

    def backward(batch):
        batch = {k: as_tensor(v, device=dev) for k, v in batch.items()}
        outputs = run_forward(batch["images"])
        loss, aux = mono3d_loss(outputs, _frame_targets(cfg, batch))
        loss.backward()
        return {k: v.detach() for k, v in aux.items()}

    return _train_step(model, optimizer, backward)


def mono3d_to_targets(boxes, scores, labels, classes, cam_to_velo=None,
                      frame="cam", timestamp=0, score_threshold=0.3):
    """Decoded camera-frame boxes -> ``Target3DArray`` (host numpy and
    scipy, as the JAX function).

    Mirrors the KITTI label convention exactly as the object loader's
    ``parse_label`` does (``d3d_tpu_torch.dataset.kitti.object``):
    bottom centre -> geometric centre, camera (l, h, w) axes -> FLU via
    the ``R_x(pi/2)`` append, and, when ``cam_to_velo=(rrect, hr, ht)`` is
    given (``_cam_to_velo``), rectified camera -> velo for positions and
    orientations. Without it, targets stay in the camera frame with the
    same orientation convention.
    """
    from scipy.spatial.transform import Rotation

    from ..abstraction import ObjectTag, ObjectTarget3D, Target3DArray

    boxes, scores, labels = (
        a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
        else np.asarray(a) for a in (boxes, scores, labels))
    sel = (scores >= score_threshold) & np.isfinite(boxes).all(axis=-1)
    boxes, scores, labels = boxes[sel], scores[sel], labels[sel]
    out = Target3DArray(frame=frame, timestamp=timestamp)
    if not len(boxes):
        return out

    pos = boxes[:, :3].copy()
    pos[:, 1] -= boxes[:, 5] / 2          # bottom centre -> box centre
    base = Rotation.identity()
    if cam_to_velo is not None:
        rrect, hr, ht = cam_to_velo
        pos = pos @ rrect.inv().as_matrix().T
        pos = (pos - ht) @ hr.inv().as_matrix().T
        base = hr.inv() * rrect.inv()
    rot = base * Rotation.from_euler("y", boxes[:, 6:7]) \
        * Rotation.from_euler("x", np.pi / 2)
    if rot.single:  # scipy collapses a length-1 composition
        rot = Rotation.concatenate([rot])
    for i in range(len(boxes)):
        tag = ObjectTag(cls := classes[int(labels[i])], type(cls),
                        float(scores[i]))
        out.append(ObjectTarget3D(
            pos[i], rot[i],
            [boxes[i, 3], boxes[i, 4], boxes[i, 5]], tag))
    return out


def make_mono3d_detector(model, variables, cfg: Mono3DConfig, classes,
                         cam_to_velo=None, score_threshold=0.3,
                         device=None):
    """Build ``detect(image, intrinsics, frame=None, timestamp=0) ->
    Target3DArray`` for a Mono3D model. The peak max-pool in decode is
    the NMS (CenterNet-style: no box suppression pass).
    ``detect.device_fn(image, intrinsics) -> (boxes, scores, labels)``
    is the on-device part (network and decode).

    :param variables: a state_dict to load into ``model`` (e.g. from
        :func:`d3d_tpu_torch.models.convert.mono3d_state_from_flax`), or
        None to keep the model's own weights
    :param cam_to_velo: optional ``(rrect, hr, ht)`` rectified camera ->
        velo calib trio (``d3d_tpu_torch.dataset.kitti.object.
        _cam_to_velo``); targets come out in the velo frame when given,
        the camera frame otherwise
    :param device: where the model and every request run (default CUDA;
        raises when CUDA is missing and no device is given)
    """
    dev = resolve_device(device)
    if variables is not None:
        model.load_state_dict(variables)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def device_fn(image, intrinsics):
        image = as_tensor(image, device=dev, dtype=torch.float32)
        intrinsics = as_tensor(intrinsics, device=dev, dtype=torch.float32)
        outputs = {k: v[0] for k, v in model(image[None]).items()}
        return decode_mono3d(cfg, outputs, intrinsics)

    def detect(image, intrinsics, frame=None, timestamp=0):
        """The detections of one image above ``score_threshold`` as a
        Target3DArray (tags ``ObjectTag(classes[label], type(...),
        score)``)."""
        boxes, scores, labels = (t.cpu().numpy()
                                 for t in device_fn(image, intrinsics))
        return mono3d_to_targets(
            boxes, scores, labels, classes, cam_to_velo=cam_to_velo,
            frame=frame or ("velo" if cam_to_velo else "cam"),
            timestamp=timestamp, score_threshold=score_threshold)

    device_fn.device = dev
    detect.device_fn = device_fn
    return detect


def mono3d_gt_from_targets(targets, cam_to_velo=None):
    """Velo-frame ``Target3DArray`` ground truth -> (M, 7) camera-frame
    [x, y, z, l, w, h, ry] bottom-centre boxes + (M,) int labels: the
    training-data path from the dataset loaders (which emit velo-frame
    objects) into :func:`assign_mono3d_targets`. The exact inverse of
    :func:`mono3d_to_targets` (host numpy and scipy).

    :param cam_to_velo: ``(rrect, hr, ht)`` calib trio; None = targets
        already in the camera frame's convention
    """
    from scipy.spatial.transform import Rotation

    n = len(targets)
    boxes = np.zeros((n, 7), np.float32)
    labels = np.zeros(n, np.int64)
    if not n:
        return boxes, labels
    cols = targets.columns()
    pos = cols["position"].astype(np.float64)
    base = Rotation.identity()
    if cam_to_velo is not None:
        rrect, hr, ht = cam_to_velo
        pos = pos @ hr.as_matrix().T + ht
        pos = pos @ rrect.as_matrix().T
        base = hr.inv() * rrect.inv()
    rot = Rotation.from_quat(cols["quat"].astype(np.float64))
    # orientation = base * R_y(ry) * R_x(pi/2)  =>  recover ry
    ry_rot = base.inv() * rot * Rotation.from_euler("x", -np.pi / 2)
    ry = ry_rot.as_euler("yxz")[..., 0]
    dims = cols["dimension"]
    boxes[:, 0] = pos[:, 0]
    boxes[:, 1] = pos[:, 1] + dims[:, 2] / 2     # centre -> bottom
    boxes[:, 2] = pos[:, 2]
    boxes[:, 3:6] = dims
    boxes[:, 6] = ry
    labels[:] = cols["label"]
    return boxes, labels

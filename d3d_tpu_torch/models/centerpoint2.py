"""Two-stage CenterPoint: RoI-grid BEV pooling + IoU-aware refinement
(port of ``d3d_tpu.models.centerpoint2``).

The serving configuration of Yin et al.'s CVPR 2021 paper (the two-stage
variant): the first stage's top-k proposals pool features from the shared
BEV map on a rotated in-box grid (:func:`~d3d_tpu_torch.ops.point.aligned_scatter`'s
bilinear path), and a small MLP predicts an IoU-aware confidence, which
rectifies the heatmap score, and a box residual. Everything is
fixed-shape (K proposals a frame). The training targets' best-overlap
matching runs the rotated IoU matrix (K1's float32 form on the card), on
detached proposals.

Score fusion at inference: ``score = score_1st^(1-alpha) *
sigmoid(conf)^alpha``.
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.point import aligned_scatter
from ..utils import as_tensor, resolve_device
from .voxelnext import _linear

__all__ = ["RefineConfig", "CenterPointRefine", "roi_grid_features",
           "apply_refinements", "encode_refinement_targets", "refine_loss",
           "optax_sigmoid_bce", "make_refine_train_step"]


@dataclass(frozen=True)
class RefineConfig:
    """Static second-stage configuration."""

    grid_points: int = 6          # G: G x G rotated in-box sample grid
    hidden: Tuple[int, ...] = (128, 128)
    fg_iou: float = 0.55          # residual loss gate
    conf_lo: float = 0.25         # conf target ramp: 0 below, 1 above
    conf_hi: float = 0.75
    score_alpha: float = 0.5      # score fusion exponent
    dtype: str = "float32"


def roi_grid_features(feat, boxes, bounds, grid, n_grid):
    """Pool BEV features on a rotated G x G grid inside each box.

    :param feat: (W, H, C) BEV feature map of one frame
    :param boxes: (K, 7) [x, y, z, l, w, h, yaw]
    :param bounds: the model's (xmin, xmax, ymin, ymax, ...) bounds
    :param grid: (W, H) canvas shape
    :param n_grid: G
    :returns: (K, G*G*C) pooled features (bilinear, border-clamped)
    """
    w, h = grid
    vx = (bounds[1] - bounds[0]) / w
    vy = (bounds[3] - bounds[2]) / h
    k = boxes.shape[0]
    u = torch.as_tensor(np.linspace(-0.5, 0.5, n_grid).astype(np.float32),
                        device=boxes.device)
    gu, gv = torch.meshgrid(u, u, indexing="ij")          # (G, G) box frame
    lu = gu[None] * boxes[:, 3, None, None]               # (K, G, G) metres
    lv = gv[None] * boxes[:, 4, None, None]
    c = torch.cos(boxes[:, 6])[:, None, None]
    s = torch.sin(boxes[:, 6])[:, None, None]
    px = boxes[:, 0, None, None] + lu * c - lv * s
    py = boxes[:, 1, None, None] + lu * s + lv * c
    # cell-centre alignment: feature i sits at bmin + (i + 0.5) * v
    cx = (px - bounds[0]) / vx - 0.5
    cy = (py - bounds[2]) / vy - 0.5
    coords = torch.stack([torch.zeros_like(cx), cx, cy],
                         dim=-1).reshape(-1, 3)           # (K*G*G, 3)
    fmap = feat.permute(2, 0, 1)[None]                    # (1, C, W, H)
    g = aligned_scatter(coords, fmap, method="linear")    # (K*G*G, C)
    return g.reshape(k, n_grid * n_grid * feat.shape[-1])


class CenterPointRefine(nn.Module):
    """Refinement MLP over pooled RoI features + rotation-invariant box
    descriptors. Output per proposal: ``conf`` logit (IoU-aware) and a 7-d
    residual ``[dx, dy, dz, dlog l, dlog w, dlog h, dyaw]`` in box-frame
    units (see :func:`apply_refinements`). The layers are the flax
    module's ``fc{i}`` (``fcs.{i}``) and ``out``; each is flax ``Dense``
    (product and bias in ``cfg.dtype``, the bias added after).

    :param feat_channels: channels C of the BEV map the proposals pool
        (the input is G * G * C pooled features and 4 descriptors)
    :param device: where the parameters live (default CUDA; raises when
        CUDA is missing and no device is given)
    :param generator: ``torch.Generator`` for the random initial weights
    """

    def __init__(self, cfg: RefineConfig, feat_channels, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        fcs, c_in = [], cfg.grid_points ** 2 * feat_channels + 4
        for ch in cfg.hidden:
            fcs.append(nn.Linear(c_in, ch))
            c_in = ch
        self.fcs = nn.ModuleList(fcs)
        self.out = nn.Linear(c_in, 8)
        self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """LeCun-normal kernels (flax ``Dense``'s default), zero biases."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator)
                                 / math.sqrt(mod.weight.shape[1]))
                mod.bias.zero_()

    def forward(self, pooled, boxes, train=False):
        dt = getattr(torch, self.cfg.dtype)
        desc = torch.stack([
            torch.log(torch.clamp_min(boxes[..., 3], 1e-3)),
            torch.log(torch.clamp_min(boxes[..., 4], 1e-3)),
            torch.log(torch.clamp_min(boxes[..., 5], 1e-3)),
            boxes[..., 2],
        ], dim=-1)
        x = torch.cat([pooled, desc], dim=-1).to(dt)
        for fc in self.fcs:
            x = F.relu(_linear(x, fc, dt))
        out = _linear(x, self.out, dt).to(
            torch.promote_types(dt, torch.float32))
        return dict(conf=out[..., 0], deltas=out[..., 1:])


def apply_refinements(boxes, deltas):
    """Apply box-frame residuals: xy in box axes scaled by (l, w), z by h,
    dims multiplicatively, yaw additively."""
    l, w, h = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    yaw = boxes[:, 6]
    dx, dy = deltas[:, 0] * l, deltas[:, 1] * w
    cy_, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([
        boxes[:, 0] + dx * cy_ - dy * sy,
        boxes[:, 1] + dx * sy + dy * cy_,
        boxes[:, 2] + deltas[:, 2] * h,
        l * torch.exp(deltas[:, 3]),
        w * torch.exp(deltas[:, 4]),
        h * torch.exp(deltas[:, 5]),
        yaw + deltas[:, 6],
    ], dim=-1)


@torch.no_grad()
def encode_refinement_targets(cfg: RefineConfig, rois, gt_boxes, gt_mask):
    """Best-overlap targets for one frame's proposals (no gradient: the
    IoU is K1's float32 matrix on the card, which has no backward).

    :param rois: (K, 7) first-stage boxes (detached upstream)
    :param gt_boxes: (M, 7) padded ground truth, ``gt_mask`` (M,)
    :returns: dict(conf (K,) in [0, 1], deltas (K, 7) exact inverse of
        :func:`apply_refinements`, pos (K,) residual-loss gate)
    """
    from ..ops.geometry_soa import rbox_iou_matrix

    bev_r = torch.cat([rois[:, 0:2], rois[:, 3:5], rois[:, 6:7]], dim=-1)
    bev_g = torch.cat([gt_boxes[:, 0:2], gt_boxes[:, 3:5],
                       gt_boxes[:, 6:7]], dim=-1)
    iou = rbox_iou_matrix(bev_r.to(torch.float32), bev_g.to(torch.float32))
    iou = torch.where(gt_mask[None, :], iou, -1.0)
    best = torch.argmax(iou, dim=1)
    biou = iou.amax(dim=1)
    g = gt_boxes[best]

    yaw = rois[:, 6]
    cy_, sy = torch.cos(yaw), torch.sin(yaw)
    ex, ey = g[:, 0] - rois[:, 0], g[:, 1] - rois[:, 1]
    l = torch.clamp_min(rois[:, 3], 1e-3)
    w = torch.clamp_min(rois[:, 4], 1e-3)
    h = torch.clamp_min(rois[:, 5], 1e-3)
    dyaw = g[:, 6] - yaw
    dyaw = torch.atan2(torch.sin(dyaw), torch.cos(dyaw))  # wrap to (-pi, pi]
    deltas = torch.stack([
        (ex * cy_ + ey * sy) / l,
        (-ex * sy + ey * cy_) / w,
        (g[:, 2] - rois[:, 2]) / h,
        torch.log(torch.clamp_min(g[:, 3], 1e-3) / l),
        torch.log(torch.clamp_min(g[:, 4], 1e-3) / w),
        torch.log(torch.clamp_min(g[:, 5], 1e-3) / h),
        dyaw,
    ], dim=-1)
    conf = torch.clamp((biou - cfg.conf_lo) / (cfg.conf_hi - cfg.conf_lo),
                       0.0, 1.0)
    return dict(conf=conf, deltas=deltas, pos=biou >= cfg.fg_iou)


def optax_sigmoid_bce(logits, labels):
    """Numerically stable sigmoid BCE (max(x,0) - x*z + log1p(exp(-|x|)))."""
    return (torch.clamp_min(logits, 0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def refine_loss(out, targets):
    """BCE on the IoU-aware confidence + L1 residuals on positives.
    Returns ``(total, dict(conf, reg, total))``."""
    conf_l = optax_sigmoid_bce(out["conf"], targets["conf"]).mean()
    npos = torch.clamp_min(targets["pos"].sum(), 1).to(torch.float32)
    l1 = (out["deltas"] - targets["deltas"]).abs() \
        * targets["pos"][..., None]
    reg_l = l1.sum() / npos
    total = conf_l + reg_l
    return total, dict(conf=conf_l, reg=reg_l, total=total)


def make_refine_train_step(model_1st, variables_1st, refine_model, cfg_1st,
                           cfg: RefineConfig, optimizer):
    """Second-stage training over a FROZEN first stage.

    ``step(batch) -> aux`` updates ``refine_model``'s parameters through
    ``optimizer`` in place (after it each parameter's ``.grad`` holds the
    step's gradient); ``aux`` holds the loss terms as detached 0-d
    tensors. ``batch`` is the pillarized batch with padded gt
    (gt_boxes (B, M, 7), gt_mask (B, M)). The first stage (built with
    ``return_feat=True``; ``variables_1st`` a state_dict to load, or None
    to keep its weights) runs in eval mode without gradient; its top-k
    decode gives the proposals (the standard two-stage recipe: train the
    refinement on the detector's own proposal distribution).
    """
    from .centerpoint import decode_centers

    if variables_1st is not None:
        model_1st.load_state_dict(variables_1st)
    model_1st.eval()
    dev = next(refine_model.parameters()).device

    @torch.no_grad()
    def proposals(batch):
        outputs = model_1st(batch["features"], batch["coords"],
                            batch["valid"], train=False)
        feat = outputs.pop("feat")
        boxes = torch.stack([decode_centers(
            cfg_1st, {k: v[i] for k, v in outputs.items()})[0]
            for i in range(feat.shape[0])])
        return feat, boxes

    def step(batch):
        batch = {k: as_tensor(v, device=dev) for k, v in batch.items()}
        feat, boxes = proposals(batch)
        with torch.no_grad():
            pooled = torch.stack([
                roi_grid_features(f, b, cfg_1st.bounds, cfg_1st.grid,
                                  cfg.grid_points)
                for f, b in zip(feat, boxes)])
            per = [encode_refinement_targets(cfg, r, g, m) for r, g, m in
                   zip(boxes, batch["gt_boxes"], batch["gt_mask"])]
            targets = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        optimizer.zero_grad(set_to_none=True)
        out = refine_model(pooled, boxes, train=True)
        loss, aux = refine_loss(out, targets)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    return step

"""Array-of-structures box geometry (port of part of
``d3d_tpu.ops.geometry``).

Boxes are ``(..., 5)`` tensors ``[x, y, w, h, r]``; every function
broadcasts over the leading dimensions and is differentiable by autograd.

Ported so far: ``box2poly`` and ``aabox_iou``, the two that anchor
assignment uses, in float32 (``sin``/``cos`` are the native ones, as the JAX
module's ``trig.sincos`` uses for inputs that are not float64). The rest of
the module, and the float64 Cody-Waite ``sincos``, are not ported yet.
"""

import torch

__all__ = ["box2poly", "aabox_iou"]


def box2poly(boxes):
    """``(..., 5)`` xywhr boxes -> ``(..., 4, 2)`` CCW corner polygons,
    starting at (-w/2, -h/2) in the box frame."""
    x, y, w, h, r = (boxes[..., i] for i in range(5))
    dx, dy = w * 0.5, h * 0.5
    lx = torch.stack([-dx, dx, dx, -dx], dim=-1)
    ly = torch.stack([-dy, -dy, dy, dy], dim=-1)
    s, c = torch.sin(r)[..., None], torch.cos(r)[..., None]
    px = c * lx - s * ly + x[..., None]
    py = s * lx + c * ly + y[..., None]
    return torch.stack([px, py], dim=-1)


def aabox_iou(boxes1, boxes2):
    """Axis-aligned IoU: each box is replaced by the axis-aligned bounding
    box of its rotated corners. Elementwise with broadcasting."""
    p1, p2 = box2poly(boxes1), box2poly(boxes2)
    lo1, hi1 = p1.amin(dim=-2), p1.amax(dim=-2)
    lo2, hi2 = p2.amin(dim=-2), p2.amax(dim=-2)
    iwh = torch.clamp_min(torch.minimum(hi1, hi2) - torch.maximum(lo1, lo2),
                          0.0)
    inter = iwh[..., 0] * iwh[..., 1]
    a1 = (hi1 - lo1).prod(dim=-1)
    a2 = (hi2 - lo2).prod(dim=-1)
    return inter / torch.clamp_min(a1 + a2 - inter, 1e-12)

"""CenterPoint's heatmap radius (port of ``d3d_tpu.models.centerpoint``,
so far :func:`_gaussian_radius` only, which VoxelNeXt's targets use)."""

import torch

__all__ = []


def _gaussian_radius(l_cells, w_cells, min_overlap):
    """Radius such that any center within it keeps IoU >= min_overlap.

    The three CornerNet overlap cases with the quadratic roots
    ``(-b +- sqrt(b^2 - 4ac)) / (2a)``, in the JAX module's operation
    order (not the published code's divide-by-2 of every root)."""
    b1 = l_cells + w_cells
    c1 = l_cells * w_cells * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.clamp_min(b1 ** 2 - 4 * c1, 0.0))) / 2
    a2 = 4.0
    b2 = 2 * (l_cells + w_cells)
    c2 = (1 - min_overlap) * l_cells * w_cells
    r2 = (b2 - torch.sqrt(torch.clamp_min(b2 ** 2 - 4 * a2 * c2, 0.0))) \
        / (2 * a2)
    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (l_cells + w_cells)
    c3 = (min_overlap - 1) * l_cells * w_cells
    r3 = (-b3 + torch.sqrt(torch.clamp_min(b3 ** 2 - 4 * a3 * c3, 0.0))) \
        / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)

"""Special math (port of ``d3d_tpu.ops.special``): the exponentially
scaled Bessel functions ``i0e``/``i1e`` (``torch.special``, differentiable
by autograd) and the numpy helpers the evaluators use (``wmean``,
``diffnorm3``, ``quatdiff``).
"""

import numpy as np
import torch

from ..utils import resolve_device

__all__ = ["i0e", "i1e", "wmean", "diffnorm3", "quatdiff"]


def _bessel(fn, x, device):
    """``fn`` of a tensor on its device; numpy (or a scalar) goes to
    :func:`resolve_device` ``(device)`` and comes back as numpy."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    arr = np.asarray(x)
    if not np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float64)
    out = fn(torch.as_tensor(arr, device=resolve_device(device)))
    return out.cpu().numpy()


def i0e(x, device=None):
    """Exponentially scaled modified Bessel function of order 0."""
    return _bessel(torch.special.i0e, x, device)


def i1e(x, device=None):
    """Exponentially scaled modified Bessel function of order 1."""
    return _bessel(torch.special.i1e, x, device)


def wmean(mean1, w1, mean2, w2):
    """Weighted mean combine; zero-weight sides pass the other through (so a
    NaN placeholder with weight 0 does not poison the merge)."""
    if w1 == 0:
        return mean2
    if w2 == 0:
        return mean1
    return (mean1 * w1 + mean2 * w2) / (w1 + w2)


def diffnorm3(p1, p2):
    """Euclidean distance between 3-vectors."""
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    return np.linalg.norm(p1 - p2, axis=-1)


def quatdiff(q1, q2):
    """Relative rotation angle between two (x, y, z, w) quaternions in
    [0, pi]."""
    q1 = np.asarray(q1, dtype=np.float64)
    q2 = np.asarray(q2, dtype=np.float64)
    dot = np.clip(np.abs(np.sum(q1 * q2, axis=-1)), 0.0, 1.0)
    return 2.0 * np.arccos(dot)

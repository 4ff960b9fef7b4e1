"""Device selection shared by the port's entry points."""

import torch

__all__ = ["resolve_device", "as_tensor"]


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` when given, else CUDA.

    Raises when CUDA is asked for (explicitly or by default) and is not
    available: the port never moves to the CPU unless the caller says so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or CPU tensors) to "
            "run on the CPU")
    return dev


def as_tensor(x, device=None, dtype=None):
    """``x`` as a tensor. A tensor keeps its own device unless ``device`` is
    given; anything else is placed on :func:`resolve_device` ``(device)``."""
    if isinstance(x, torch.Tensor) and device is None:
        return x if dtype is None else x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))

"""d3d_tpu_torch — the PyTorch/CUDA port of :mod:`d3d_tpu` for NVIDIA Hopper.

The package mirrors ``d3d_tpu``'s module paths and public names
(``d3d_tpu_torch.ops.nms.nms2d`` is the counterpart of
``d3d_tpu.ops.nms.nms2d``). Plain tensor code is PyTorch; every Pallas
kernel of ``d3d_tpu`` on a ported path is a hand-written CUDA C++ kernel
under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use and bound
with ``ctypes`` (:mod:`d3d_tpu_torch.ops._build`).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"`` or
CPU tensors; without CUDA such a call raises instead of falling back.
This package imports neither JAX nor ``d3d_tpu``.
"""

from . import utils  # noqa: F401

__version__ = "0.1.0"

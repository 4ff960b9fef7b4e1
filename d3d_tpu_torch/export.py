"""Ahead-of-time detector export for serving (port of ``d3d_tpu.export``).

A detector's device function (points -> boxes, scores, labels, keep) is
traced by ``torch.export`` into one program with the model's weights baked
in as constants, saved as a zip (``torch.export.save``'s archive with the
caller's ``meta.json`` beside it) and loaded back into a callable that
needs no model code: :func:`load_detector` imports only the kernels' op
registrations (:mod:`d3d_tpu_torch.ops`). The hand kernels stay kernels in
the program: each is a ``torch.library`` custom op in the
``d3d_tpu_torch`` namespace (K1's two forms, the NMS scans, K4, K5 and the
rule-book build), whose CUDA implementation launches the kernel and counts
the launch, and whose CPU implementation is the plain version.

An artifact runs on the device type it was traced on (``platforms``):
``("cuda",)`` or ``("cpu",)``, with the example inputs' shapes and dtypes.
"""

import inspect
import json
from pathlib import Path

import numpy as np
import torch

from . import ops  # noqa: F401  (registers the kernels' ops)
from .utils import resolve_device

__all__ = ["export_detector", "load_detector", "save_detector",
           "ExportedDetector"]

_META_NAME = "meta.json"


class _Traced(torch.nn.Module):
    """The device function as the module ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(*inputs)


def export_detector(device_fn, example_points, platforms=None, meta=None):
    """Export a detector's device function.

    :param device_fn: the points -> (boxes, scores, labels, keep[, vel])
        device function (``detect.device_fn`` of the ``make_*_detector``
        factories: the weights it closes over are baked in); its
        ``torch.inference_mode`` decorator is unwrapped and the body traced
        without gradients
    :param example_points: example (N, F) input fixing the traced shape,
        or a TUPLE of example inputs for multi-input pipelines (Mono3D's
        ``(image, intrinsics)``); arrays go to ``device_fn.device``
    :param platforms: optional ``("cuda",)`` or ``("cpu",)``: the device
        type to trace on, which must be the function's own (the port does
        not lower for another device; asking for one raises)
    :param meta: optional JSON-serializable metadata stored alongside
    :returns: ExportedDetector
    """
    device = getattr(device_fn, "device", None)
    args = (tuple(example_points)
            if isinstance(example_points, (tuple, list))
            else (example_points,))
    if device is None:
        device = next((a.device for a in args
                       if isinstance(a, torch.Tensor)), None)
    device = resolve_device(device)
    if platforms is not None and tuple(platforms) != (device.type,):
        raise ValueError(f"the device function runs on {device.type}; the "
                         f"port exports for that device only, not "
                         f"{tuple(platforms)}")
    args = tuple(a if isinstance(a, torch.Tensor)
                 else torch.as_tensor(np.asarray(a), device=device)
                 for a in args)
    with torch.no_grad():
        program = torch.export.export(_Traced(inspect.unwrap(device_fn)),
                                      args, strict=False)
    return ExportedDetector(program, dict(meta or {}))


class ExportedDetector:
    """A traced (or loaded) detector program."""

    def __init__(self, program, meta):
        self._program = program
        self._module = program.module()
        self.meta = meta
        names = set(program.graph_signature.user_inputs)
        self._inputs = [node.meta["val"] for node in program.graph.nodes
                        if node.op == "placeholder" and node.name in names]

    @property
    def program(self):
        """The ``torch.export.ExportedProgram``."""
        return self._program

    @property
    def input_shape(self):
        """Shape of the FIRST input (the points or image tensor); see
        :attr:`input_shapes` for multi-input pipelines."""
        return self.input_shapes[0]

    @property
    def input_shapes(self):
        """Shapes of every input, in call order."""
        return tuple(tuple(v.shape) for v in self._inputs)

    @property
    def platforms(self):
        """The device type the program was traced on, as a 1-tuple."""
        return (self._inputs[0].device.type,)

    def __call__(self, *inputs):
        """Run the program; arrays go to its device. An input of another
        count, shape, dtype or device type raises ``ValueError``."""
        if len(inputs) != len(self._inputs):
            raise ValueError(f"the artifact takes {len(self._inputs)} "
                             f"inputs, got {len(inputs)}")
        device = resolve_device(self.platforms[0])
        args = []
        for i, (x, want) in enumerate(zip(inputs, self._inputs)):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
                np.asarray(x), device=device)
            if (tuple(t.shape) != tuple(want.shape) or t.dtype != want.dtype
                    or t.device.type != device.type):
                raise ValueError(
                    f"input {i}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                    f"the artifact was traced for {tuple(want.shape)} "
                    f"{want.dtype} on {device.type}")
            args.append(t)
        with torch.inference_mode():
            return self._module(*args)

    def save(self, path):
        """Write a self-contained artifact: ``torch.export.save``'s zip with
        ``meta.json`` beside the program."""
        with open(path, "wb") as f:  # a file object: any suffix
            torch.export.save(self._program, f,
                              extra_files={_META_NAME: json.dumps(self.meta)})
        return Path(path)


def save_detector(device_fn, example_points, path, platforms=None,
                  meta=None):
    """One-shot :func:`export_detector` + save."""
    return export_detector(device_fn, example_points, platforms=platforms,
                           meta=meta).save(path)


def load_detector(path):
    """Load an artifact saved by :meth:`ExportedDetector.save`; the
    returned object is callable on the traced device with no model
    code."""
    extra = {_META_NAME: ""}
    with open(path, "rb") as f:
        program = torch.export.load(f, extra_files=extra)
    return ExportedDetector(program, json.loads(extra[_META_NAME] or "{}"))

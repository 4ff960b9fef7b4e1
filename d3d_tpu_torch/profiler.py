"""Profiling utilities (port of ``d3d_tpu.profiler``; the reference d3d's
timer synchronises CUDA, as this one does for the tensors it is given).
:func:`tap_arrays` walks live torch tensors; :func:`trace` wraps
``torch.profiler`` and writes a Chrome trace; :func:`span` names a stage
of the port's hot path on the profiler's timeline."""

import gc
import logging
import os
import tempfile
import time
import weakref
from contextlib import contextmanager, nullcontext

import torch

_timers = {}
_logger = logging.getLogger("d3d_tpu_torch.profiler")

__all__ = ["tap_time", "tap_arrays", "trace", "span", "ArrayRef"]

_NO_SPAN = nullcontext()


def _sync(tree):
    """Wait for the devices of the CUDA tensors in a tree."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for x in tree:
            _sync(x)
    elif isinstance(tree, torch.Tensor) and tree.is_cuda:
        torch.cuda.synchronize(tree.device)


def tap_time(name, clear=True, report=True, sync=None):
    """Paired-call wall timer: the first call with a name starts the timer,
    the second stops it and returns the elapsed seconds.

    :param sync: optional tensor (or tree of them) whose devices are
        synchronised before the clock is read: pass a step's outputs to
        time the work on the card, not its enqueueing
    """
    if sync is not None:
        _sync(sync)
    if name not in _timers:
        _timers[name] = time.perf_counter()
        return 0
    elapsed = time.perf_counter() - _timers[name]
    if clear:
        del _timers[name]
    if report:
        _logger.debug("Elapsed time for %s: %.4f", name, elapsed)
    return elapsed


class ArrayRef:
    """Weak reference to a tensor with a printable summary. A tensor that
    cannot be weakly referenced is marked untracked rather than taken as
    released."""

    def __init__(self, array):
        try:
            self._ref = weakref.ref(array)
            self.trackable = True
        except TypeError:
            self._ref = lambda: None
            self.trackable = False
        self._id = id(array)
        self._summary = (f"<Tensor, dtype={array.dtype}, "
                         f"shape={list(array.shape)}, device={array.device}>")

    def __hash__(self):
        return self._id

    def __eq__(self, other):
        if isinstance(other, ArrayRef):
            return self._id == other._id
        return self._ref() is other

    def __str__(self):
        return self._summary

    def released(self):
        return self.trackable and self._ref() is None


_arrays = {}  # id -> ArrayRef


def tap_arrays(report=False):
    """Diff the live torch tensors since the last call (device-memory leak
    hunting, the reference's ``tap_tensors``). Returns (new tensors, ids of
    released ones)."""
    live = [obj for obj in gc.get_objects()
            if issubclass(type(obj), torch.Tensor) and id(obj) not in _arrays]
    dead = [key for key, ref in _arrays.items() if ref.released()]

    if report:
        _logger.debug("========== %d new tensors, %d released tensors "
                      "==========", len(live), len(dead))
    if len(live) > 50:
        _logger.debug("(Tensor list suppressed)")
        report = False
    for arr in live:
        ref = ArrayRef(arr)
        if report:
            _logger.debug("+%s", ref)
        _arrays[id(arr)] = ref
    for key in dead:
        if report:
            _logger.debug("-%s", _arrays[key])
        del _arrays[key]
    return live, dead


@contextmanager
def trace(log_dir=None):
    """Context manager around ``torch.profiler.profile`` (the CPU, and
    CUDA when it is available) that writes a Chrome/Perfetto trace,
    ``trace.json``, into ``log_dir`` (default: a new temporary directory).
    Yields ``log_dir``."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="d3d_tpu_torch_trace_")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name):
    """A ``torch.profiler.record_function`` range named ``"d3d." + name``
    while a profiler records, else one shared no-op context (the check
    costs a fraction of a microsecond, a range with no profiler many
    times that). The profiler that is running holds the ranges, on the
    clock of the device's events: :func:`trace`'s Chrome trace, or a
    caller's own ``torch.profiler.profile``. A range neither synchronises
    the device nor changes what runs."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function("d3d." + name)

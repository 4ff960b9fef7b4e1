"""Multi-process, multi-node scale-out (port of
``d3d_tpu.parallel.distributed``).

The JAX module wires ``jax.distributed`` and a hybrid mesh over TPU
slices; here the job is a ``torch.distributed`` process group, one rank
a GPU, launched by ``torchrun`` (or given its address, size and rank):

* :func:`initialize` starts the process group (NCCL for CUDA tensors,
  gloo for CPU ones);
* :func:`make_global_mesh` builds a ``('dp', 'tp')`` mesh over every rank,
  with each tp group inside one node (its ranks talk over NVLink) and only
  dp crossing nodes;
* :func:`all_hosts_stats` merges per-process evaluator stats (an
  all-gather of the dense stat arrays, then :func:`merge_stacked_stats`).

Without a process group every function degrades to its single-process
equivalent.
"""

import os

import numpy as np
import torch.distributed as dist

__all__ = ["initialize", "make_global_mesh", "all_hosts_stats",
           "merge_stacked_stats", "process_count", "process_index"]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               **kwargs):
    """Start the process group; returns True when this call started it.

    With no argument it joins only a ``torchrun`` job (``RANK``,
    ``WORLD_SIZE`` and ``MASTER_ADDR`` set, the counterpart of the JAX
    function's TPU worker variables) and otherwise returns False: one
    process needs no group. ``coordinator_address`` is ``"host:port"``
    (TCP) or an init-method URL such as ``"file:///path"``; with it,
    ``num_processes`` and ``process_id`` give the world size and this
    process's rank (a world of one too). Returns False when a group
    already exists. ``kwargs`` go to ``init_process_group`` (``backend``:
    default NCCL for CUDA tensors and gloo for CPU ones).
    """
    if dist.is_initialized():
        return False
    if coordinator_address is None:
        if num_processes == 1 or not all(os.environ.get(k)
                                         for k in _TORCHRUN_ENV):
            return False
        dist.init_process_group(init_method="env://", **kwargs)
        return True
    url = (coordinator_address if "://" in coordinator_address
           else "tcp://" + coordinator_address)
    dist.init_process_group(init_method=url, world_size=num_processes,
                            rank=process_id, **kwargs)
    return True


def process_count():
    """The world size (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(dp=None, tp=None, device_type="cuda"):
    """A ``('dp', 'tp')`` mesh over every rank of the job. tp defaults to
    2 when a node's rank count (``LOCAL_WORLD_SIZE``, which ``torchrun``
    sets; the world on one node) is even and > 1, else 1. Ranks are laid
    out node-major, so each tp group lies inside one node and only dp
    spans nodes; a tp that does not divide a node's ranks raises."""
    from .mesh import _mesh, _world

    n = _world()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if tp is None:
        tp = 2 if per_node % 2 == 0 and per_node > 1 else 1
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError("dp * tp must equal the global device count")
    if per_node % tp:
        raise ValueError("tp=%d does not divide a node's %d ranks (tp "
                         "cannot span nodes)" % (tp, per_node))
    return _mesh(device_type, list(range(n)), (dp, tp), ("dp", "tp"))


def all_hosts_stats(stats, classes, evaluator_cls=None):
    """Merge per-process DetectionEvalStats across every process of the
    job: the dense stat arrays are all-gathered and merged by
    :func:`merge_stacked_stats`, the same on every process, as if each had
    called ``add_stats`` with every other's partials. Single-process:
    an unchanged copy.

    :param classes: the evaluator's class-value list
    :param evaluator_cls: unused, for the JAX signature
    """
    from .mesh import arrays_to_stats, stats_to_arrays

    arrays = {k: v.numpy() for k, v in stats_to_arrays(stats,
                                                       classes).items()}
    if process_count() == 1:
        return arrays_to_stats(arrays, classes, stats_cls=type(stats))
    parts = [None] * process_count()
    dist.all_gather_object(parts, arrays)
    stacked = {k: np.stack([p[k] for p in parts]) for k in arrays}
    return arrays_to_stats(merge_stacked_stats(stacked), classes,
                           stats_cls=type(stats))


def merge_stacked_stats(gathered):
    """Reduce stacked per-process stat arrays (leading process axis): the
    numpy twin of :func:`~d3d_tpu_torch.parallel.reduce_stats_arrays`
    (counters summed, accuracies the tp-weighted mean, NaN where no
    process has a true positive); a change to one merge rule must be
    mirrored in the other."""
    tp = np.asarray(gathered["tp"])
    out = {}
    for f in ("ngt", "ndt", "tp", "fp", "fn"):
        out[f] = np.asarray(gathered[f]).sum(axis=0)
    tot = np.maximum(out["tp"], 1)
    for f in ("acc_iou", "acc_angular", "acc_dist", "acc_box", "acc_var"):
        weighted = np.where(tp > 0, np.asarray(gathered[f]) * tp, 0.0)
        out[f] = np.where(out["tp"] > 0, weighted.sum(axis=0) / tot, np.nan)
    return out

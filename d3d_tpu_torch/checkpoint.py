"""Training checkpoint and resume (port of ``d3d_tpu.checkpoint``).

The JAX module saves ``(params, batch_stats, opt_state)`` with orbax; here
the same three parts (``d3d_tpu_torch.train.train_state(model,
optimizer)``: parameters and buffers by name, the optimizer's
``state_dict()``) go to one ``torch.save`` file a step. A save copies the
tensors to the host, then a background thread writes them under a
temporary name and renames the file into place, so a crash never leaves a
partial checkpoint under a step's name. The newest ``keep`` checkpoints
are kept. In a process group the ranks share the directory, as orbax's
do: rank 0 writes, every rank saves and restores the same steps, and
:meth:`TrainCheckpointer.wait` (so also ``restore``) is a barrier.

Usage::

    ckpt = TrainCheckpointer("runs/run0", keep=3)
    for step in range(start, nsteps):
        aux = train_step(batch)
        ckpt.maybe_save(step, *train_state(model, opt), every=1000)
    state = ckpt.restore()          # None if there is no checkpoint yet
    state = ckpt.restore(like=train_state(model, opt))  # onto their devices
"""

import os
import re
import threading

import torch

from .train import _map_tensors

__all__ = ["TrainCheckpointer"]

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _to_host(tree):
    """A copy of a tree of dicts, lists and tuples with every tensor
    detached and copied to the CPU."""
    return _map_tensors(lambda t: t.detach().to("cpu", copy=True)
                        if isinstance(t, torch.Tensor) else t, tree)


def _like(tree, template):
    """``tree`` with each tensor moved to the device of the tensor at the
    same place in ``template``; tensors without one stay where they are."""
    if isinstance(tree, dict):
        t = template if isinstance(template, dict) else {}
        return {k: _like(v, t.get(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = (template if isinstance(template, (list, tuple))
             and len(template) == len(tree) else [None] * len(tree))
        return type(tree)(_like(v, w) for v, w in zip(tree, t))
    if isinstance(tree, torch.Tensor) and isinstance(template, torch.Tensor):
        return tree.to(template.device)
    return tree


class TrainCheckpointer:
    """Checkpoints of ``(params, batch_stats, opt_state)`` in a directory,
    one file a step, written in the background.

    :param directory: checkpoint root (created if missing)
    :param keep: number of most recent checkpoints kept
    """

    def __init__(self, directory, keep=3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep
        self._lock = threading.Lock()
        self._threads = []
        self._pending = set()
        self._recorded = set()  # steps rank 0 writes for this rank
        self._error = None

    def _path(self, step):
        return os.path.join(self._dir, f"step_{int(step)}.pt")

    def _saved_steps(self):
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self._dir))
                      if m)

    def all_steps(self):
        """The steps saved or being saved, in increasing order."""
        with self._lock:
            return sorted(set(self._saved_steps()) | self._pending
                          | self._recorded)

    # -- save ---------------------------------------------------------------
    def save(self, step, params, batch_stats, opt_state):
        """Copy the train state to the host and write it at ``step`` on a
        background thread. A step that already exists (saved or being
        saved) is left as it is and the call returns False."""
        from .parallel import process_index

        step = int(step)
        with self._lock:
            if (step in self._pending or step in self._recorded
                    or os.path.exists(self._path(step))):
                return False
            if process_index() != 0:
                self._recorded.add(step)
                return True
            self._pending.add(step)
        state = _to_host({"params": params, "batch_stats": batch_stats,
                          "opt_state": opt_state})
        thread = threading.Thread(target=self._write, args=(step, state))
        self._threads.append(thread)
        thread.start()
        return True

    def _write(self, step, state):
        path = self._path(step)
        tmp = path + ".tmp"
        try:
            torch.save(state, tmp)
            os.replace(tmp, path)
            with self._lock:
                self._pending.discard(step)
                for old in self._saved_steps()[:-self._keep]:
                    os.remove(self._path(old))
        except BaseException as e:  # raised again by wait()
            self._error = e
            with self._lock:
                self._pending.discard(step)

    def maybe_save(self, step, params, batch_stats, opt_state, every=1000):
        if every and step % every == 0:
            return self.save(step, params, batch_stats, opt_state)
        return False

    # -- restore ------------------------------------------------------------
    @property
    def latest_step(self):
        """The newest step saved or being saved, or None."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step=None, like=None):
        """Restore a train state (waits for pending saves first).

        :param step: checkpoint step (default: the latest)
        :param like: optional ``(params, batch_stats, opt_state)`` template:
            each restored tensor goes to the device of the template's
            tensor at the same place (an optimizer's state that the
            template does not have yet stays on the CPU, and
            ``Optimizer.load_state_dict`` moves it to its parameter's
            device); without it every tensor is on the CPU
        :returns: dict with params / batch_stats / opt_state, or None when
            the directory has no checkpoint
        """
        self.wait()
        step = step if step is not None else self.latest_step
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        if like is None:
            return state
        params, batch_stats, opt_state = like
        return _like(state, {"params": params, "batch_stats": batch_stats,
                             "opt_state": opt_state})

    def wait(self):
        """Block until the queued saves are written (in a process group,
        rank 0's: a barrier); raise the first error a writer met."""
        import torch.distributed as dist

        while self._threads:
            self._threads.pop(0).join()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self):
        self.wait()

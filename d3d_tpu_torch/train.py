"""Training orchestration (port of ``d3d_tpu.train``): the optimizer
recipe, EMA, batching, the prefetching input thread and the ``Trainer``
loop with checkpoints and evaluation.

The JAX module threads its state functionally (``(params, batch_stats,
opt_state)`` in and out of every step); here that state is a model and an
optimizer updated in place, so the signatures that carried it take
``(model, optimizer)`` instead, and a step is ``step(batch) -> metrics``
(:func:`d3d_tpu_torch.models.pointpillars.make_train_step`).
"""

import math
import queue
import threading
import time

import numpy as np
import torch

from .profiler import span

__all__ = ["Trainer", "prefetch", "batch_frames",
           "shard_frames_across_hosts", "ema_init", "ema_update",
           "make_optimizer", "ClippedAdamW", "init_variables",
           "repeat_batch_step", "train_state", "load_train_state"]

# optax.adamw's defaults, which the JAX package's recipe keeps
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _onecycle(transition_steps, peak_value, pct_start, div_factor=10.0,
              final_div_factor=100.0):
    """``optax.cosine_onecycle_schedule`` with the recipe's factors: a
    cosine ramp from ``peak_value / div_factor`` up to ``peak_value`` over
    the first ``pct_start`` of ``transition_steps``, then a cosine decay
    down to ``peak_value / (div_factor * final_div_factor)``. Evaluated in
    float64, with optax's own piecewise formula, so the float32 rate it
    gives equals optax's at every count."""
    if transition_steps <= 0:
        raise ValueError("onecycle schedule needs transition_steps > 0")
    bounds = np.array([0, int(pct_start * transition_steps),
                       int(transition_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])
    sizes = bounds[1:] - bounds[:-1]

    def schedule(count):
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (count - bounds[:-1]) / sizes
            start, end = values[:-1], values[1:]
            interp = end + (start - end) / 2.0 * (np.cos(np.pi * pct) + 1)
            inside = (bounds[:-1] <= count) & (count < bounds[1:])
            return float(inside.dot(interp)
                         + (bounds[-1] <= count) * values[-1])

    return schedule


def _cosine(init_value, decay_steps):
    """``optax.cosine_decay_schedule(init_value, decay_steps)`` (alpha 0,
    exponent 1)."""
    if decay_steps <= 0:
        raise ValueError("cosine schedule needs decay_steps > 0")

    def schedule(count):
        count = min(float(count), float(decay_steps))
        return init_value * (0.5 * (1 + math.cos(math.pi * count
                                                 / decay_steps)))

    return schedule


class ClippedAdamW(torch.optim.Optimizer):
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(lr,
    weight_decay=weight_decay))``, wrapped in ``optax.MultiSteps(...,
    every_k_schedule=accumulate)`` when ``accumulate > 1``, with optax's
    arithmetic in float32:

    - the gradients of all parameters are scaled by ``clip_norm / norm``
      (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``) unless their
      global norm is below ``clip_norm``;
    - Adam moments ``m = 0.1 g + 0.9 m``, ``v = 0.001 g^2 + 0.999 v``,
      bias-corrected by the update count t (from 1), update
      ``m_hat / (sqrt(v_hat) + 1e-8)``, plus ``weight_decay * p``, times
      ``-lr(t - 1)``: the schedule is read at the count before the update
      (count 0 for the first);
    - with ``accumulate = k`` the gradients of k steps are averaged
      (``acc += (g - acc) / (i + 1)``) and only every k-th step updates
      the parameters; the others leave them as they are.

    ``lr`` is a function of the update count. A parameter without a
    gradient counts as a zero gradient.
    """

    def __init__(self, params, lr, clip_norm=10.0, weight_decay=0.01,
                 accumulate=1):
        super().__init__(params, dict(clip_norm=clip_norm,
                                      weight_decay=weight_decay))
        self.lr = lr
        self.accumulate = max(int(accumulate), 1)
        self.count = 0      # applied updates
        self.mini_step = 0  # steps accumulated since the last update

    def state_dict(self):
        """``torch.optim.Optimizer.state_dict`` plus the update count (the
        schedule's position) and the accumulation phase, which live in
        attributes that the base class would drop: a resumed run goes on
        where it stopped, in the middle of an accumulation too."""
        sd = super().state_dict()
        sd["count"] = self.count
        sd["mini_step"] = self.mini_step
        return sd

    def load_state_dict(self, state_dict):
        sd = dict(state_dict)
        count, mini_step = int(sd.pop("count")), int(sd.pop("mini_step"))
        super().load_state_dict(sd)
        self.count, self.mini_step = count, mini_step

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self, sq_norm=None):
        """One update. ``sq_norm(params, grads)``, where given, returns the
        squared global norm of the (accumulated) gradients: a sharded step
        whose ranks hold parts of some leaves sums those parts' squares
        over their ranks (:func:`~d3d_tpu_torch.parallel.shard_train_step`);
        the default sums every gradient's squares here."""
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.accumulate > 1:
            for p, g in zip(params, grads):
                acc = self.state[p].setdefault("acc", torch.zeros_like(p))
                acc.add_((g - acc) / (self.mini_step + 1))
            if self.mini_step < self.accumulate - 1:
                self.mini_step += 1
                return None
            grads = [self.state[p]["acc"].clone() for p in params]
            for p in params:
                self.state[p]["acc"].zero_()
            self.mini_step = 0
        else:
            grads = [g.clone() for g in grads]

        group = self.param_groups[0]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads)
                          if sq_norm is None else sq_norm(params, grads))
        clip = ~(norm < group["clip_norm"])
        for g in grads:
            g.copy_(torch.where(clip, g / norm * group["clip_norm"], g))

        lr = np.float32(-self.lr(self.count))
        self.count += 1
        bc1 = float(np.float32(1 - _B1 ** self.count))
        bc2 = float(np.float32(1 - _B2 ** self.count))
        for p, g in zip(params, grads):
            st = self.state[p]
            m = st.setdefault("m", torch.zeros_like(p))
            v = st.setdefault("v", torch.zeros_like(p))
            m.copy_((1 - _B1) * g + _B1 * m)
            v.copy_((1 - _B2) * (g * g) + _B2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + _EPS)
            u = u + group["weight_decay"] * p
            p.add_(float(lr) * u)
        return None


def make_optimizer(params, total_steps, base_lr=1e-3, schedule="onecycle",
                   warmup_frac=0.4, clip_norm=10.0, weight_decay=0.01,
                   accumulate=1):
    """The JAX package's lidar-detection recipe: AdamW with a one-cycle
    learning rate and global-norm clipping, optionally accumulating
    ``accumulate`` steps per update, as :class:`ClippedAdamW` over
    ``params``.

    :param params: the parameters (``model.parameters()``); the one
        argument the JAX function does not have (optax binds them later)
    :param schedule: ``"onecycle"`` (cosine ramp to ``base_lr`` at
        ``warmup_frac`` of training, cosine decay after), ``"cosine"``
        (decay only) or ``"constant"``
    :param accumulate: steps per optimizer update; ``total_steps`` counts
        training steps, so the schedule runs over
        ``total_steps // accumulate`` updates
    :returns: ``(optimizer, lr_schedule)``; the schedule maps a training
        step to its learning rate
    """
    upd_steps = max(total_steps // max(accumulate, 1), 1)
    if schedule == "onecycle":
        lr = _onecycle(upd_steps, base_lr, warmup_frac)
    elif schedule == "cosine":
        lr = _cosine(base_lr, upd_steps)
    elif schedule == "constant":
        lr = (lambda count: base_lr)  # noqa: E731
    else:
        raise ValueError("unknown schedule %r" % (schedule,))
    opt = ClippedAdamW(params, lr, clip_norm=clip_norm,
                       weight_decay=weight_decay, accumulate=accumulate)
    if accumulate > 1:
        return opt, (lambda step: lr(step // accumulate))
    return opt, lr


def init_variables(model, device=None, generator=None):
    """Seeded initial weights drawn on the CPU, then moved to ``device``
    (the JAX function's ``model.init`` pinned to the host CPU): ``model``
    goes to the CPU, ``model.reset_parameters(generator)`` re-draws its
    weights there (the model's default seed without a generator), and the
    model moves to ``device`` (default CUDA). The same generator gives the
    same weights whatever the device. Returns the model."""
    from .utils import resolve_device

    dev = resolve_device(device)
    model.to("cpu").reset_parameters(generator)
    return model.to(dev)


def _named_params(params):
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def ema_init(params):
    """Start an exponential moving average of the parameters: a detached
    copy of each of them, ``{name: tensor}``. ``params`` is a module (its
    ``named_parameters()``; the BatchNorm running statistics are buffers
    and stay out, as the JAX function covers ``params`` only) or a
    ``{name: tensor}`` dict."""
    return {k: v.detach().clone() for k, v in _named_params(params).items()}


@torch.no_grad()
def ema_update(ema, params, decay=0.999, step=None):
    """One EMA step, in place on ``ema`` (which it returns): ``ema = d *
    ema + (1 - d) * params`` with the warm-up ``d = min(decay, (1 + step)
    / (10 + step))`` in float32; ``step=None`` is the plain fixed-decay
    update. No host synchronisation: ``d`` is made on the host from Python
    numbers."""
    s = np.float32(1e9 if step is None else step)
    d = np.minimum(np.float32(decay),
                   (np.float32(1.0) + s) / (np.float32(10.0) + s))
    d, one_minus = float(d), float(np.float32(1.0) - d)  # exact in f32
    for name, p in _named_params(params).items():
        e = ema[name]
        torch.add(e * d, p.detach() * one_minus, out=e)
    return ema


def _map_tensors(fn, tree):
    """``fn`` on every tensor or array of a tree of dicts, lists and
    tuples; anything else is kept."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    return tree


def repeat_batch_step(step, repeat, batch_argnum=0):
    """Wrap a train step so its batch is tiled ``repeat`` times along the
    leading axis of every tensor (and array) before the step sees it.

    The update is the same as the untiled batch's: the losses normalise by
    a count that tiling multiplies as much as their sums, and BatchNorm's
    batch statistics over a duplicated batch equal the originals; only the
    reduction order differs. One exception: the count is ``npos =
    max(sum(pos), 1)``, so a batch without a positive anchor keeps
    ``npos = 1`` when tiled while its sums grow ``repeat`` times, and the
    gradient is ``repeat`` times the untiled one. The JAX package uses this
    to move a small batch onto the TPU's 8-row tiles; it is kept for
    parity (it costs ``repeat`` times the activation memory).

    :param batch_argnum: position of the batch among ``step``'s arguments
        (0 for the port's ``step(batch)``; the JAX package's steps take it
        at 3)
    """
    if repeat == 1:
        return step

    def tiled(x):
        if x.ndim == 0:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x] * repeat, dim=0)
        return np.concatenate([x] * repeat, axis=0)

    def wrapped(*args):
        args = list(args)
        args[batch_argnum] = _map_tensors(tiled, args[batch_argnum])
        return step(*args)

    return wrapped


def prefetch(iterable, depth=2):
    """Run an iterator in a background thread with a bounded queue.

    Host work of the input pipeline (loading, augmentation, pillarization)
    overlaps the train steps this way. The worker stops when the consumer
    leaves (an early ``break`` does not leave it blocked on a full queue),
    and an exception raised in the worker is raised in the consumer.

    Items may hold CUDA tensors made by the worker. The worker issues its
    kernels on the stream that was current in the consumer when iteration
    began (the default stream unless the caller set another), so an item's
    kernels are queued before any kernel the consumer issues after taking
    it, and the allocator's reuse of its memory is ordered on that one
    stream: no event or host synchronisation is needed.
    """
    q = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    stream = torch.cuda.current_stream() if torch.cuda.is_available() \
        else None

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            with torch.cuda.stream(stream):
                for item in iterable:
                    if not put(("item", item)):
                        return
        except BaseException as e:  # raised again in the consumer
            put(("error", e))
            return
        put(("end", None))

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            kind, payload = q.get()
            if kind == "error":
                raise payload
            if kind == "end":
                return
            yield payload
    finally:
        stop.set()


def shard_frames_across_hosts(frames, index=None, count=None):
    """Strided split of a frame stream across processes: process ``index``
    yields items index, index + count, index + 2 count, ... Defaults come
    from the job (:func:`d3d_tpu_torch.parallel.process_index` /
    ``process_count``: the rank and world size once a process group is
    initialised, else the identity split, 0 of 1). Pair it with
    ``drop_last=True`` batching so every process steps the same number of
    times."""
    if index is None or count is None:
        from .parallel import process_count, process_index

        index = process_index() if index is None else index
        count = process_count() if count is None else count
    for i, frame in enumerate(frames):
        if i % count == index:
            yield frame


def _stack(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack([np.asarray(x) for x in leaves])


def _collate(frames, stack):
    first = frames[0]
    if isinstance(first, dict):
        return {k: _collate([f[k] for f in frames], stack) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_collate(list(xs), stack) for xs in zip(*frames))
    return stack(frames)


def batch_frames(frames, batch_size, collate=None, drop_last=True):
    """Group per-frame trees (dicts, lists, tuples) into stacked batches.

    :param collate: leaf-stacking function taking the list of a leaf's
        values (default: ``torch.stack`` for tensors, which keeps their
        device, ``np.stack`` for anything else)
    """
    stack = collate or _stack
    buf = []
    for frame in frames:
        buf.append(frame)
        if len(buf) == batch_size:
            yield _collate(buf, stack)
            buf = []
    if buf and not drop_last:
        yield _collate(buf, stack)


def train_state(model, optimizer):
    """``(params, batch_stats, opt_state)`` of a model and its optimizer:
    the parameters and the buffers (BatchNorm running statistics) by name,
    and the optimizer's ``state_dict()``; what
    :class:`d3d_tpu_torch.checkpoint.TrainCheckpointer` saves."""
    return (dict(model.named_parameters()), dict(model.named_buffers()),
            optimizer.state_dict())


def load_train_state(model, optimizer, state):
    """Load a restored ``{"params", "batch_stats", "opt_state"}`` into
    ``model`` and ``optimizer`` in place."""
    model.load_state_dict(dict(state["params"], **state["batch_stats"]))
    optimizer.load_state_dict(state["opt_state"])


class Trainer:
    """The generic training loop.

    :param step_fn: ``step(batch) -> metrics`` (e.g. from ``make_train_step``)
        updating its model and optimizer in place; ``metrics`` a dict of
        0-d tensors
    :param prep_fn: optional ``batch -> batch`` device-side prep
        (augmentation, ``prepare_targets``); the next batch's prep is
        dispatched before the current step runs
    :param checkpointer: optional
        :class:`d3d_tpu_torch.checkpoint.TrainCheckpointer`; a step
        that carries ``train_state()`` (``shard_train_step``'s) has its
        sharded leaves saved whole, and is restored by :meth:`restore_or`
        before its first call
    :param log_every: read and record the metrics every N steps (reading
        them waits for the card, so this sets the host's sync cadence; the
        steps between do not synchronise in the Trainer)
    :param ckpt_every: save every N steps (written by a background thread)
    :param eval_fn: optional ``(step, model) -> dict`` run every
        ``eval_every`` steps; results append to ``history`` under ``eval``
        and go through ``log_fn``
    """

    def __init__(self, step_fn, prep_fn=None, checkpointer=None,
                 log_every=50, ckpt_every=1000, log_fn=print,
                 eval_fn=None, eval_every=0):
        self.step_fn = step_fn
        self.prep_fn = prep_fn
        self.ckpt = checkpointer
        self.log_every = log_every
        self.ckpt_every = ckpt_every
        self.log_fn = log_fn
        self.eval_fn = eval_fn
        self.eval_every = eval_every
        self.history = []

    def restore_or(self, model, optimizer):
        """Resume from the latest checkpoint if one exists, loading it
        into ``model`` and ``optimizer`` in place (each tensor onto its
        template's device). Returns the step to start from (0 without a
        checkpoint)."""
        if self.ckpt is None:
            return 0
        state = self.ckpt.restore(like=train_state(model, optimizer))
        if state is None:
            return 0
        load_train_state(model, optimizer, state)
        return int(self.ckpt.latest_step)

    def run(self, model, optimizer, batches, num_steps=None, start_step=0):
        """Run the loop over ``batches`` (an iterator of batches), with
        ``step_fn`` updating ``model`` and ``optimizer``. Returns the step
        reached."""
        it = iter(batches)
        prep = self.prep_fn or (lambda b: b)
        step = start_step
        if num_steps is not None and num_steps <= 0:
            return step

        def next_batch():
            """The iterator's next batch, prepared (StopIteration at its
            end)."""
            with span("train.next"):
                b = next(it)
            with span("train.prep"):
                return prep(b)

        try:
            nxt = next_batch()
        except StopIteration:
            return step

        t0 = time.perf_counter()
        last_log_step = step
        while num_steps is None or step < start_step + num_steps:
            with span("train.step"):
                batch = nxt
                # the next batch's prep goes before the step; none past
                # the last step (a persistent iterator would lose a batch)
                last = (num_steps is not None
                        and step + 1 >= start_step + num_steps)
                if last:
                    nxt = None
                else:
                    try:
                        nxt = next_batch()
                    except StopIteration:
                        nxt = None
                metrics = self.step_fn(batch)
                step += 1

                if self.log_every and step % self.log_every == 0:
                    vals = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    rate = (step - last_log_step) / max(dt, 1e-9)
                    last_log_step = step
                    self.history.append(dict(step=step, **vals))
                    self.log_fn(f"step {step}: " + " ".join(
                        f"{k}={v:.4f}" for k, v in sorted(vals.items()))
                        + f" ({rate:.2f} steps/s)")
                if (self.eval_fn is not None and self.eval_every
                        and step % self.eval_every == 0):
                    result = self.eval_fn(step, model)
                    self.history.append(dict(step=step, eval=result))
                    self.log_fn(f"eval @ {step}: {result}")
                if (self.ckpt is not None and self.ckpt_every
                        and step % self.ckpt_every == 0):
                    self.ckpt.save(step, *self._state(model, optimizer))
            if nxt is None:
                break

        if self.ckpt is not None:
            if self.ckpt.latest_step != step:
                self.ckpt.save(step, *self._state(model, optimizer))
            self.ckpt.wait()
        return step

    def _state(self, model, optimizer):
        """What a checkpoint saves: the step's ``train_state()`` when it
        holds its state sharded (a ``shard_train_step``, whose gather is a
        collective every rank runs here), else ``train_state``."""
        whole = getattr(self.step_fn, "train_state", None)
        return whole() if whole is not None else train_state(model,
                                                             optimizer)

"""Training recipe (port of part of ``d3d_tpu.train``).

Ported so far: :func:`make_optimizer`, the JAX package's optax chain
``clip_by_global_norm`` -> ``adamw`` (optionally inside ``MultiSteps``) as a
``torch.optim.Optimizer`` with optax's arithmetic, and its learning-rate
schedules as plain functions of the update count. ``Trainer``,
``prefetch``, the EMA helpers and ``repeat_batch_step`` are not ported yet.
"""

import math

import numpy as np
import torch

__all__ = ["make_optimizer", "ClippedAdamW"]

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

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    @torch.no_grad()
    def step(self):
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
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
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

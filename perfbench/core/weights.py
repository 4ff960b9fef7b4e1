"""The benchmark's weights: made on the device from the seed in one call,
then the heads calibrated on the reference's forward of one frame."""

import math

import torch

__all__ = ["make_state", "calibrate"]


@torch.no_grad()
def make_state(template, fan_in, heads, seed, dev):
    """A state dict with ``template``'s keys and shapes: He-normal kernels
    (LeCun-normal for the ``heads``), drawn in one call from a generator
    on ``dev`` seeded with ``seed``; zero biases; BatchNorm at weight 1,
    bias 0 and running statistics (0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(int(seed) % 2 ** 63)
    kernels = [(k, v) for k, v in template.items()
               if v.is_floating_point() and v.ndim >= 2]
    total = sum(v.numel() for _, v in kernels)
    draw = torch.randn(total, generator=gen, device=dev)
    state, at = {}, 0
    for k, v in kernels:
        gain = 1.0 if k.split(".")[0] in heads else 2.0
        std = math.sqrt(gain / fan_in(k, tuple(v.shape)))
        state[k] = draw[at:at + v.numel()].reshape(v.shape) * std
        at += v.numel()
    for k, v in template.items():
        if k in state:
            continue
        if not v.is_floating_point():
            state[k] = v.to(dev).clone()
        elif k.endswith("running_var") or (k.endswith(".weight")
                                            and v.ndim == 1):
            state[k] = torch.ones(v.shape, device=dev)
        else:
            state[k] = torch.zeros(v.shape, device=dev)
    return state


@torch.no_grad()
def calibrate(state, outputs, heads, cls_sd, cls_prior, box_sd, dir_sd,
              box_bound):
    """Rescale the random heads in place so that their outputs on one
    frame (``outputs``: the reference's raw (cls, box, dir), biases 0)
    spread as a trained detector's do: class logits sd ``cls_sd`` about
    the focal-loss prior's bias ``-log((1 - p) / p)``, box residuals sd
    ``box_sd`` and none beyond ``box_bound``, direction logits sd
    ``dir_sd``."""
    for name, out, sd in zip(heads, outputs, (cls_sd, box_sd, dir_sd)):
        scale = sd / float(out.std())
        if name == heads[1]:
            scale = min(scale, box_bound / float(out.abs().max()))
        state[name + ".weight"].mul_(scale)
    state[heads[0] + ".bias"].fill_(-math.log((1 - cls_prior) / cls_prior))

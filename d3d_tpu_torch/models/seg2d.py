"""2D image semantic segmentation, the camera half of PointPainting (port
of ``d3d_tpu.models.seg2d``).

A compact UNet (encoder/decoder with skip connections, all dense convs)
producing per-pixel class scores. Its softmax output is what
:func:`d3d_tpu_torch.ops.painting.paint_points` consumes: camera
semantics -> painted cloud -> any lidar family. The network runs NCHW;
its public layout is the JAX module's NHWC ``(B, H, W, C)``.
"""

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils import as_tensor, resolve_device
from .pointpillars import _BN_EPS, _bn, _bn_train, _conv_same

__all__ = ["Seg2DConfig", "Seg2D", "make_seg2d_train_step",
           "make_segmenter"]


@dataclass(frozen=True)
class Seg2DConfig:
    """Static configuration (the JAX module's fields and defaults)."""

    image_size: Tuple[int, int] = (384, 1280)  # checked at forward
    channels: Tuple[int, ...] = (16, 32, 64)   # encoder stages (stride 2)
    num_classes: int = 4
    dtype: str = "float32"


class _Block(nn.Module):
    """Conv (3x3, SAME) or ConvTranspose (4x4, stride 2, SAME) without
    bias, BatchNorm (eps 1e-3), ReLU. flax's ConvTranspose pads the
    dilated input by (2, 2): torch's ``conv_transpose2d(stride=2,
    padding=1)`` with the kernel flipped in both spatial axes (the
    converter flips it)."""

    def __init__(self, in_features, features, stride, dtype,
                 transpose=False):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.stride = stride
        self.transpose = transpose
        if transpose:
            self.conv = nn.ConvTranspose2d(in_features, features, 4,
                                           stride=stride, padding=1,
                                           bias=False)
        else:
            self.conv = nn.Conv2d(in_features, features, 3, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=_BN_EPS)

    def forward(self, x, train):
        dt = self.dtype
        w = self.conv.weight.to(dt)
        if self.transpose:
            x = F.conv_transpose2d(x.to(dt), w, stride=self.stride,
                                   padding=1)
        else:
            x = _conv_same(x.to(dt), w, self.stride)
        return F.relu((_bn_train if train else _bn)(x, self.bn))


class Seg2D(nn.Module):
    """UNet: per-pixel class logits (B, H, W, num_classes), float32.

    The blocks in ``blocks`` are the flax module's ``_Block_{i}`` in call
    order (encoder, then per decoder level a transposed block and a
    block, then the last transposed block); ``head`` is its final 1x1
    ``Conv_0``.

    :param device: where the parameters live (default CUDA; raises when
        CUDA is missing and no device is given)
    :param generator: ``torch.Generator`` for the random initial weights
        (default: a generator seeded with 0)
    """

    def __init__(self, cfg: Seg2DConfig, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        blocks, c_in = [], 3
        for ch in cfg.channels:
            blocks.append(_Block(c_in, ch, 2, cfg.dtype))
            c_in = ch
        for ch in reversed(cfg.channels[:-1]):
            blocks.append(_Block(c_in, ch, 2, cfg.dtype, transpose=True))
            blocks.append(_Block(2 * ch, ch, 1, cfg.dtype))
            c_in = ch
        blocks.append(_Block(c_in, cfg.channels[0], 2, cfg.dtype,
                             transpose=True))
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Conv2d(cfg.channels[0], cfg.num_classes, 1)
        self.reset_parameters(generator)
        self.to(dev)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Seeded random weights: He-normal kernels, LeCun-normal head,
        zero bias, identity BatchNorm statistics."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = (w.shape[0] * w.shape[2] * w.shape[3]
                          if isinstance(mod, nn.ConvTranspose2d)
                          else w[0].numel())
                gain = 1.0 if mod is self.head else 2.0
                w.copy_(torch.randn(w.shape, generator=generator)
                        * math.sqrt(gain / fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()

    def forward(self, images, train=False):
        """:param images: (B, H, W, 3) at ``cfg.image_size``
        :param train: batch statistics, moving the running ones (the
            argument, not ``nn.Module.training``)"""
        cfg = self.cfg
        if tuple(images.shape[1:3]) != tuple(cfg.image_size):
            raise ValueError(
                "images %s != cfg.image_size %s"
                % (tuple(images.shape[1:3]), cfg.image_size))
        if any(v % (2 ** len(cfg.channels)) for v in cfg.image_size):
            raise ValueError("image_size must divide by 2^depth = %d"
                             % (2 ** len(cfg.channels)))
        dt = getattr(torch, cfg.dtype)
        x = images.to(dt).permute(0, 3, 1, 2)
        blocks = iter(self.blocks)
        skips = []
        for _ in cfg.channels:
            x = next(blocks)(x, train)
            skips.append(x)
        for skip in reversed(skips[:-1]):
            x = next(blocks)(x, train)
            x = next(blocks)(torch.cat([x, skip], dim=1), train)
        x = next(blocks)(x, train)
        logits = F.conv2d(x, self.head.weight.to(dt), self.head.bias.to(dt))
        return logits.permute(0, 2, 3, 1).to(
            torch.promote_types(dt, torch.float32))


def make_seg2d_train_step(model, optimizer, cfg: Seg2DConfig):
    """Build ``step(batch) -> aux``, one training step updating ``model``
    (parameters and BatchNorm running statistics) and ``optimizer`` in
    place. ``batch``: images (B, H, W, 3), labels (B, H, W) int with -1 =
    ignore. ``aux``: total (the mean cross-entropy over labelled pixels)
    and acc, detached 0-d tensors."""
    dev = next(model.parameters()).device

    def train_step(batch):
        images = as_tensor(batch["images"], device=dev)
        labels = as_tensor(batch["labels"], device=dev)
        optimizer.zero_grad(set_to_none=True)
        logits = model(images, train=True)
        valid = labels >= 0
        oh = F.one_hot(torch.clamp_min(labels, 0).long(),
                       cfg.num_classes).to(logits.dtype)
        ll = F.log_softmax(logits, dim=-1)
        ce = -(oh * ll).sum(dim=-1) * valid
        count = torch.clamp_min(valid.sum(), 1)
        loss = ce.sum() / count
        acc = ((logits.argmax(dim=-1) == labels) & valid).sum() / count
        loss.backward()
        optimizer.step()
        return dict(total=loss.detach(), acc=acc.detach())

    return train_step


def make_segmenter(model, variables=None, device=None):
    """``segment(image (H, W, 3)) -> (H, W, num_classes)`` softmax scores,
    the painting feature map.

    :param variables: a state_dict to load into ``model`` (e.g. from
        :func:`d3d_tpu_torch.models.convert.seg2d_state_from_flax`), or
        None to keep its weights
    :param device: where the model and every call run (default CUDA;
        raises when CUDA is missing and no device is given)
    """
    dev = resolve_device(device)
    if variables is not None:
        model.load_state_dict(variables)
    model = model.to(dev).eval()

    @torch.inference_mode()
    def segment(image):
        image = as_tensor(image, device=dev)
        return torch.softmax(model(image[None], train=False)[0], dim=-1)

    segment.device = dev
    return segment

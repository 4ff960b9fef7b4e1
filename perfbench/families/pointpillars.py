"""PointPillars configurations: the program's model and detector built
from a configuration file, and the benchmark's own view of the same
model (its reference forward, its weights' fan-in and its work)."""

import torch

from . import preset_config
from ..reference import pointpillars as ref

HEADS = ("head_cls", "head_box", "head_dir")


port_config = preset_config


def port_model(cfg, dev):
    from d3d_tpu_torch.models.pointpillars import PointPillars

    return PointPillars(cfg, device=dev)


def port_anchors(cfg, dev):
    from d3d_tpu_torch.models.pointpillars import make_anchors

    return make_anchors(cfg, device=dev)


def port_detector(model, cfg, anchors, classes, det, dev):
    from d3d_tpu_torch.models.inference import make_pointpillars_detector

    return make_pointpillars_detector(model, None, cfg, anchors, classes,
                                      device=dev, **det)


def port_voxelize(points, cfg):
    from d3d_tpu_torch.models.pointpillars import pillarize

    return pillarize(points, cfg)


def port_train_step(model, optimizer, cfg, anchors):
    from d3d_tpu_torch.models.pointpillars import make_train_step

    return make_train_step(model, optimizer, cfg, anchors,
                           external_targets=True)


def fan_in(name, shape):
    """The fan-in of a kernel: a transposed convolution's (in, out, f, f)
    weight feeds each output cell from one tap of ``in`` channels."""
    if name.startswith("ups.") and len(shape) == 4 and name != "ups.0.conv.weight":
        return shape[0]
    return int(torch.Size(shape[1:]).numel())


def ref_inputs(points, model):
    """One frame as the reference takes it."""
    return ref.pillarize(points, model)


def ref_forward(st, model, frames, cast=lambda t: t, stats=None):
    """Head outputs of a batch of :func:`ref_inputs` frames."""
    feats, coords, valid, mask = (torch.stack(t) for t in zip(*frames))
    return ref.forward(st, model, feats, coords, valid, mask, cast, stats)


def work(frame, model):
    """One frame's forward work: dense FLOPs (whole maps at the
    configuration's shapes)."""
    return dict(flops=ref.dense_flops(model))


def head_model(model):
    """The anchor grid's view of the configuration (the canvas)."""
    return model

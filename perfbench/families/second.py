"""SECOND configurations: the program's model and detector built from a
configuration file, and the benchmark's own view of the same model (its
reference forward, its weights' fan-in, its work, K5's bound and the
sparse path's spans).

The file's ``model`` holds the preset's sizes and, under ``layout``,
OpenPCDet's structure (``SECONDLayout``'s fields); ``exact_mean`` turns the
voxelizer's exact per-voxel mean on.
"""

from types import SimpleNamespace

import torch

from . import pointpillars as _pp
from . import preset_config
from ..core import spans, work as _work
from ..core.trace import union
from ..reference import second as ref

HEADS = _pp.HEADS
# the kernel K5 in a trace (``csrc/subm_conv.cu``)
K5_KERNEL = "subm_conv_kernel"
# the sparse path's spans
MAPS, MIDDLE = "d3d.second.maps", "d3d.second.middle"


def _tup(v):
    return tuple(_tup(x) for x in v) if isinstance(v, list) else v


def port_config(conf):
    """The port's (SECONDConfig, SECONDLayout, exact_mean) of a file."""
    from d3d_tpu_torch.models import SECONDLayout

    sizes = {k: v for k, v in conf["model"].items() if k != "layout"}
    return SimpleNamespace(
        cfg=preset_config(dict(conf, model=sizes)),
        layout=SECONDLayout(**{k: _tup(v) for k, v in
                               conf["model"]["layout"].items()}),
        exact_mean=conf["exact_mean"])


def port_model(port, dev):
    from d3d_tpu_torch.models import SECOND

    return SECOND(port.cfg, device=dev, layout=port.layout)


def port_anchors(port, dev):
    from d3d_tpu_torch.models import head_config, make_anchors

    return make_anchors(head_config(port.cfg, port.layout), device=dev)


def port_detector(model, port, anchors, classes, det, dev):
    from d3d_tpu_torch.models import make_second_detector

    return make_second_detector(model, None, port.cfg, anchors, classes,
                                device=dev, exact_mean=port.exact_mean,
                                **det)


def fan_in(name, shape):
    """A sparse kernel (K, C, Cout) feeds each output from K taps of C
    channels; the BEV network's and heads' as PointPillars'."""
    if len(shape) == 3:
        return shape[0] * shape[1]
    return _pp.fan_in(name, shape)


def ref_inputs(points, model):
    """One frame as the reference takes it: (features, coords)."""
    return ref.voxelize(points, model)


def ref_forward(st, model, frames, cast=lambda t: t, stats=None):
    """Head outputs of a batch of :func:`ref_inputs` frames."""
    outs = [ref.forward(st, model, f, c, cast) for f, c in frames]
    return tuple(torch.cat(o) for o in zip(*outs))


def work(frame, model):
    """One frame's forward work: FLOPs (the sparse layers' neighbour pairs,
    the BEV network and heads over their whole maps) and each sparse
    layer's sites and pairs (:func:`~perfbench.reference.second.sparse_work`)."""
    layers = ref.sparse_work(frame[1], model)
    sparse = sum(2 * lay["pairs"] * lay["cin"] * lay["cout"]
                 for lay in layers)
    return dict(flops=sparse + ref.dense_flops(model), layers=layers)


def head_model(model):
    """The anchor grid's view of the configuration: the folded map's x, y
    extents."""
    return dict(model, grid=list(ref.extents(model)[-1][:2]))


def k5_bound_s(ctx, frames):
    """K5's least time over the pool frames ``frames`` (indices): for each
    layer the larger of its bytes over the card's bandwidth and its
    neighbour pairs' FLOPs over the peak at the configuration's
    precision. Bytes: the active input rows, the weights, the output rows
    and their map rows (4 bytes a value)."""
    peaks, per_work = ctx["peaks"], _work.frame_work(ctx)
    total = 0.0
    for f in frames:
        for lay in per_work[f]["layers"]:
            k, cin, cout = lay["k"], lay["cin"], lay["cout"]
            nbytes = 4 * (lay["sites_in"] * cin + k * cin * cout
                          + lay["sites_out"] * (cout + k))
            flops = 2 * lay["pairs"] * cin * cout
            total += max(nbytes / peaks.HBM_BYTES_PER_S,
                         flops / _work.peak_ops(ctx))
    return total


def _in_spans(ctx, names):
    """(merged spans named ``names`` cut to the traced window, traced
    frames), or None without frames, device operations or such spans."""
    tr, frames = ctx["trace"], len(ctx.get("traced_frames", ()))
    win = spans.window(tr) if frames and tr.device else None
    if win is None:
        return None
    cut = [(max(s, win[0]), min(e, win[1])) for s, e in
           union((s, e) for n, s, e in tr.host if n in names)]
    cut = [(s, e) for s, e in cut if s < e]
    return (cut, frames) if cut else None


def span_launches(ctx, names):
    """Host calls that put work on the card started inside the spans
    ``names``, a traced frame; None where there are none of the spans."""
    got = _in_spans(ctx, names)
    if got is None:
        return None
    cut, frames = got
    starts = sorted(s for n, s, _ in ctx["trace"].host if spans.is_launch(n))
    count, i = 0, 0
    for s0, s1 in cut:
        while i < len(starts) and starts[i] < s0:
            i += 1
        while i < len(starts) and starts[i] <= s1:
            count += 1
            i += 1
    return count / frames


def span_idle_ms(ctx, names):
    """The card's idle milliseconds inside the spans ``names``, a traced
    frame; None where there are none of the spans."""
    got = _in_spans(ctx, names)
    if got is None:
        return None
    cut, frames = got
    inside = sum(e - s for s, e in cut)
    return (inside - spans.overlap_ns(ctx["trace"].busy, cut)) / 1e6 / frames

"""The port's profiler spans (``profiler.span``) on the CPU: a shared no-op
without a profiler, ``d3d.*`` ranges under one; a tiny PointPillars
``detect`` records its stages in order inside its root span and returns
the same detections with the profiler on and off; ``Trainer.run`` records
a span a step with the step's stages inside."""

import numpy as np
import pytest
import torch

import _limits  # noqa: F401  (one torch thread a process)

from d3d_tpu_torch import profiler
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass
from d3d_tpu_torch.models import (PointPillars, PointPillarsConfig,
                                  make_anchors, make_pointpillars_detector,
                                  pillarize, prepare_targets)
from d3d_tpu_torch.models.pointpillars import make_train_step
from d3d_tpu_torch.train import Trainer, batch_frames, make_optimizer

CFG = PointPillarsConfig(
    bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32), max_pillars=256,
    max_points_per_pillar=8, pfn_features=16, backbone_channels=(16, 32),
    backbone_blocks=(1, 1), upsample_channels=16)
STAGES = ["d3d.detect.upload", "d3d.detect.voxelize", "d3d.detect.network",
          "d3d.detect.select", "d3d.detect.readback", "d3d.detect.assemble"]
NETWORK = ["d3d.pointpillars.pfn", "d3d.pointpillars.scatter",
           "d3d.pointpillars.backbone", "d3d.pointpillars.head"]
TRAIN = ["d3d.train.next", "d3d.train.prep", "d3d.train.forward",
         "d3d.train.loss", "d3d.train.backward"]


def _points(rng, n=1024):
    return np.stack([rng.uniform(0, 16, n), rng.uniform(-8, 8, n),
                     rng.uniform(-3, 1, n), rng.random(n)],
                    1).astype(np.float32)


def _spans(prof):
    """The recorded ``d3d.*`` ranges as (name, start, end, thread), in
    order of start."""
    rows = [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith("d3d.")]
    return sorted(rows, key=lambda r: (r[1], -r[2]))


def _inside(rows, outer):
    _, s0, s1, th = outer
    return [r for r in rows if r is not outer and r[3] == th
            and s0 <= r[1] and r[2] <= s1]


def _in_order(rows):
    """Each range ends before the next starts."""
    return all(a[2] <= b[1] for a, b in zip(rows, rows[1:]))


def test_span_is_a_shared_noop_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiler.span("a") is profiler.span("b")
    with profiler.span("a"):
        pass
    with torch.profiler.profile() as prof:
        sp = profiler.span("a")
        assert isinstance(sp, torch.profiler.record_function)
        with sp:
            torch.ones(4).sum()
    assert [r[0] for r in _spans(prof)] == ["d3d.a"]


@pytest.fixture(scope="module")
def served():
    """(detections without a profiler, with one, the profile): two
    requests of a tiny PointPillars detector on the CPU."""
    model = PointPillars(CFG, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    detect = make_pointpillars_detector(
        model, None, CFG, make_anchors(CFG, device="cpu"),
        [KittiObjectClass.Car], score_threshold=0.0, top_k=16, device="cpu")
    frames = [_points(np.random.default_rng(s)) for s in (1, 2)]
    off = [detect(f) for f in frames]
    with torch.profiler.profile() as prof:
        on = [detect(f) for f in frames]
    return off, on, prof


def test_detect_records_its_stages_in_order(served):
    _, _, prof = served
    rows = _spans(prof)
    roots = [r for r in rows if r[0] == "d3d.detect"]
    assert len(roots) == 2
    for root in roots:
        inner = _inside(rows, root)
        stages = [r for r in inner if r[0] in STAGES]
        assert [r[0] for r in stages] == STAGES
        assert _in_order(stages)
        network = stages[STAGES.index("d3d.detect.network")]
        layers = [r for r in _inside(rows, network) if r[0] in NETWORK]
        assert [r[0] for r in layers] == NETWORK
        assert _in_order(layers)


def test_detect_is_equal_with_the_profiler_on_and_off(served):
    off, on, _ = served
    assert len(off) == 2 and sum(len(a) for a in off) > 0
    for a, b in zip(off, on):
        ca, cb = a.columns(), b.columns()
        assert ca.keys() == cb.keys()
        for key in ca:
            np.testing.assert_array_equal(ca[key], cb[key])


def test_trainer_records_each_step_and_its_stages():
    rng = np.random.default_rng(3)
    frames = []
    for _ in range(2):
        f, c, v = pillarize(torch.from_numpy(_points(rng)), CFG)
        gt = np.array([[6.0, 0.5, -1.0, 3.9, 1.6, 1.56, 0.3]], np.float32)
        frames.append(dict(features=f, coords=c, valid=v,
                           gt_boxes=torch.from_numpy(gt),
                           gt_labels=torch.zeros(1, dtype=torch.int32),
                           gt_mask=torch.ones(1, dtype=torch.bool)))
    model = PointPillars(CFG, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    opt, _ = make_optimizer(model.parameters(), 2)
    anchors = make_anchors(CFG, device="cpu")
    step = make_train_step(model, opt, CFG, anchors, external_targets=True)
    trainer = Trainer(step, log_every=0, prep_fn=lambda b: prepare_targets(
        anchors, b, cfg=CFG, dense=True))
    with torch.profiler.profile() as prof:
        assert trainer.run(model, opt, batch_frames(iter(frames), 1),
                           num_steps=2) == 2
    rows = _spans(prof)
    steps = [r for r in rows if r[0] == "d3d.train.step"]
    assert len(steps) == 2
    inner = [r[0] for s in steps for r in _inside(rows, s)]
    for name in TRAIN:
        assert name in inner
    for s in steps:
        stages = [r for r in _inside(rows, s) if r[0] in TRAIN[2:]]
        assert [r[0] for r in stages] == TRAIN[2:]
        assert _in_order(stages)

"""The port's segmentation evaluators against the JAX package's: the host
``SegmentationEvaluator`` (every counter and metric, ``metrics_dict`` and
``summary``; Enum and int classes, a negative background, ``min_points``)
and ``device_semantic_stats`` / ``device_panoptic_stats`` against both
hosts and the JAX device functions, on ``tests/test_segmentation_device.py``'s
random panoptic frames plus ragged, empty and single-point ones, the
perfect prediction, frames split over several device calls, and the
errors (ids not uint16, ``mesh=``).

Integer counters are held exactly; ``cumiou`` (float64 IoU sums, added in
another order) within 1e-12 relative; the metrics derived from them
within 1e-12."""

import enum

import numpy as np
import pytest
import torch

import _limits  # noqa: F401  (one torch thread a process)

from d3d_tpu.benchmarks import SegmentationEvaluator as JEvaluator
from d3d_tpu.benchmarks_device import (device_panoptic_stats,
                                       device_semantic_stats)

from d3d_tpu_torch import benchmarks_device as TD
from d3d_tpu_torch.benchmarks import SegmentationEvaluator

from tests.test_segmentation_device import CLASSES, _pano_frames

COUNTERS = ("tp", "fp", "fn", "itp", "ifp", "ifn")


class Cls(enum.Enum):
    """An Enum taxonomy over the test classes (both evaluators take it)."""

    road = 1
    car = 2
    person = 3
    pole = 7


def _same_stats(got, want, classes):
    for f in COUNTERS:
        for k in classes:
            assert getattr(got, f)[k] == getattr(want, f)[k], (f, k)
    for k in classes:
        assert got.cumiou[k] == pytest.approx(want.cumiou[k], rel=1e-12,
                                              abs=0.0), k


def _same_metrics(a, b):
    """Every metric of two evaluators equal (within 1e-12, NaN alike)."""
    for m in ("iou", "sq", "rq", "pq"):
        ha, hb = getattr(a, m)(), getattr(b, m)()
        assert [getattr(k, "name", k) for k in ha] == \
            [getattr(k, "name", k) for k in hb]
        for (ka, va), vb in zip(ha.items(), hb.values()):
            assert va == pytest.approx(vb, rel=1e-12, nan_ok=True), (m, ka)
    for inst in (False, True):
        for m in ("tp", "fp", "fn"):
            assert list(getattr(a, m)(instance=inst).values()) == \
                list(getattr(b, m)(instance=inst).values())
    _same_dicts(a.metrics_dict(), b.metrics_dict())
    assert a.summary() == b.summary()


def _same_dicts(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _same_dicts(a[k], b[k])
        elif a[k] is None or b[k] is None:
            assert a[k] is b[k], k
        else:
            assert a[k] == pytest.approx(b[k], rel=1e-12), k


def _frames(seed, background=0, nframes=5):
    """Random panoptic frames, then a ragged tail: an empty frame and a
    one-point frame."""
    gts, preds, gids, pids = _pano_frames(np.random.default_rng(seed),
                                          nframes, background)
    gts += [np.zeros(0, np.uint8), np.asarray([2], np.uint8)]
    preds += [np.zeros(0, np.uint8), np.asarray([2], np.uint8)]
    gids += [np.zeros(0, np.uint16), np.asarray([4], np.uint16)]
    pids += [np.zeros(0, np.uint16), np.asarray([9], np.uint16)]
    return gts, preds, gids, pids


@pytest.mark.parametrize("classes,background,min_points", [
    (CLASSES, 0, 0), (CLASSES, 0, 5), (list(Cls), 0, 0),
    (CLASSES, -1, 3)])
def test_host_evaluator_matches(classes, background, min_points):
    """Frame by frame, panoptic and semantic-only calls: every counter,
    metric, ``metrics_dict`` and ``summary`` equal the JAX package's."""
    frames = _frames(1, 255 if background == -1 else 0)
    evs = [cls(classes, background=background, min_points=min_points)
           for cls in (SegmentationEvaluator, JEvaluator)]
    for g, p, gi, pi in zip(*frames):
        for ev in evs:
            ev.add_stats(ev.calc_stats(g, p, gi, pi))
            ev.add_stats(ev.calc_stats(g, p))
    keys = [getattr(c, "value", c) for c in classes]
    _same_stats(evs[0].get_stats(), evs[1].get_stats(), keys)
    _same_metrics(*evs)
    assert evs[0].get_stats().itp[keys[0]] > 0
    evs[0].reset()
    assert evs[0].get_stats().tp[keys[0]] == 0


def test_host_evaluator_rejects_other_ids():
    gts, preds, gids, pids = _frames(2)
    ev = SegmentationEvaluator(CLASSES)
    with pytest.raises(ValueError, match="uint16"):
        ev.calc_stats(gts[0], preds[0], gids[0].astype(np.int32), pids[0])
    with pytest.raises(ValueError, match="Classes"):
        SegmentationEvaluator(["road"])


@pytest.mark.parametrize("min_points", [0, 5])
def test_device_stats_match(min_points):
    """device_semantic_stats and device_panoptic_stats of the port equal
    the host evaluators' sums and the JAX device functions' (ragged,
    empty and single-point frames included)."""
    frames = _frames(3)
    host = SegmentationEvaluator(CLASSES, min_points=min_points)
    for g, p, gi, pi in zip(*frames):
        host.add_stats(host.calc_stats(g, p, gi, pi))
    ev = SegmentationEvaluator(CLASSES, min_points=min_points)
    jev = JEvaluator(CLASSES, min_points=min_points)
    pano = TD.device_panoptic_stats(ev, *frames, device="cpu")
    _same_stats(pano, host.get_stats(), CLASSES)
    _same_stats(pano, device_panoptic_stats(jev, *frames), CLASSES)
    sem = TD.device_semantic_stats(ev, frames[0], frames[1], device="cpu")
    want = device_semantic_stats(jev, frames[0], frames[1])
    for f in ("tp", "fp", "fn"):
        assert getattr(sem, f) == getattr(want, f) == getattr(
            host.get_stats(), f)
    assert all(v == 0 for v in sem.itp.values())
    ev.add_stats(pano)
    _same_metrics(ev, host)


def test_device_stats_in_several_calls(monkeypatch):
    """Frames split over device calls (a chunk of 300 points: one frame a
    call) sum to the one-call result exactly."""
    frames = _frames(4)
    ev = SegmentationEvaluator(CLASSES, min_points=2)
    whole = TD.device_panoptic_stats(ev, *frames, device="cpu")
    monkeypatch.setattr(TD, "_SEG_CHUNK_POINTS", 300)
    assert len(TD._row_chunks(len(frames[0]),
                              max(map(len, frames[0])))) == len(frames[0])
    parts = TD.device_panoptic_stats(ev, *frames, device="cpu")
    for f in COUNTERS:
        assert getattr(parts, f) == getattr(whole, f), f
    _same_stats(parts, whole, CLASSES)


def test_device_perfect_prediction():
    """The ground truth as its own prediction: PQ = SQ = RQ = 1 wherever
    the class occurs as a thing, IoU 1, no false positive or negative."""
    gts, _, gids, _ = _frames(5)
    ev = SegmentationEvaluator(CLASSES)
    ev.add_stats(TD.device_panoptic_stats(ev, gts, gts, gids, gids,
                                          device="cpu"))
    pq = ev.pq()
    assert any(not np.isnan(v) for v in pq.values())
    for k, v in pq.items():
        assert np.isnan(v) or v == pytest.approx(1.0, abs=1e-12), k
    assert all(v == 0 for v in ev.fp(instance=True).values())
    assert all(v == 1.0 for v in ev.iou().values() if not np.isnan(v))


def test_device_errors():
    """Ids that are not uint16 raise ValueError, as in JAX; a device call
    without CUDA and without an explicit CPU raises (``mesh=`` runs on
    ranks: tests/test_torch_distributed.py)."""
    gts, preds, gids, pids = _frames(6)
    ev = SegmentationEvaluator(CLASSES)
    with pytest.raises(ValueError, match="uint16"):
        TD.device_panoptic_stats(ev, gts, preds, gids,
                                 [p.astype(np.int32) for p in pids],
                                 device="cpu")
    with pytest.raises(ValueError, match="lengths differ"):
        TD.device_semantic_stats(ev, gts, preds[::-1], device="cpu")
    for fn, args in ((TD.device_semantic_stats, (gts, preds)),
                     (TD.device_panoptic_stats, (gts, preds, gids, pids))):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(ev, *args)

"""The port's detection evaluators (``d3d_tpu_torch.benchmarks`` and
``.benchmarks_device``) and matchers against the JAX package's, on the CPU.

One module-scoped bank of seeded frames (random scenes with variances on
half the detections, score ties, class filtering with an unevaluated
class, ignored GT, empty frames, a detection with a singular covariance)
goes through four evaluators: the JAX package's host and device ones and
the port's. Counters must be equal as integers across all four;
accuracies within 1e-5 relative (``acc_var`` 1e-4) of the same side's JAX
counterpart, or non-finite on both; the derived metrics equal."""

import numpy as np
import pytest
import torch

import _limits  # noqa: F401  (one torch thread a process)

from d3d_tpu import benchmarks as JBM
from d3d_tpu import benchmarks_device as JBD
from d3d_tpu.dataset.kitti.utils import KittiObjectClass as JK
from d3d_tpu.tracking import matcher as JM

from d3d_tpu_torch import benchmarks as TBM
from d3d_tpu_torch import benchmarks_device as TBD
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TK
from d3d_tpu_torch.tracking import matcher as TM

from test_torch_abstraction import twin_arrays, twin_columns

COUNTERS = ("ndt", "tp", "fp", "fn")
ACCURACIES = ("acc_iou", "acc_dist", "acc_box", "acc_angular", "acc_var")
CLASSES = ("Car", "Van")  # Pedestrian (4) appears in the frames, unevaluated


def _quats(yaw):
    q = np.zeros((len(yaw), 4), np.float32)
    q[:, 2], q[:, 3] = np.sin(yaw / 2), np.cos(yaw / 2)
    return q


def _perturbed(rng, gt, keep=0.8, extra=3):
    """Detection columns: a jittered subset of ``gt``'s with variances,
    plus ``extra`` random boxes (variances on half)."""
    sel = rng.random(len(gt["position"])) <= keep
    n = int(sel.sum())
    yaw = 2 * np.arctan2(gt["quat"][sel, 2], gt["quat"][sel, 3])
    det = dict(
        position=gt["position"][sel] + rng.normal(0, 0.3, (n, 3)),
        dimension=gt["dimension"][sel] * rng.uniform(0.9, 1.1, (n, 3)),
        quat=_quats(yaw + rng.normal(0, 0.05, n)), label=gt["label"][sel],
        score=rng.uniform(0.2, 1.0, n),
        position_var=np.broadcast_to(np.eye(3) * 0.3, (n, 3, 3)),
        dimension_var=np.broadcast_to(np.eye(3) * 0.3, (n, 3, 3)),
        orientation_var=rng.uniform(0.05, 1.0, n))
    more = twin_columns(rng, extra, with_var=0.5)
    return {k: np.concatenate([det[k], more[k]]) for k in det}


def _row(position, yaw=0.0, dim=(2.0, 2.0, 2.0), label=1, score=1.0,
         var=None, ovar=0.0):
    z = np.zeros((3, 3)) if var is None else var
    return dict(position=np.array([position], float),
                dimension=np.array([dim], float),
                quat=_quats(np.array([yaw])), label=np.array([label]),
                score=np.array([score]), position_var=z[None],
                dimension_var=z[None], orientation_var=np.array([ovar]))


def _rows(*rows):
    return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}


def _empty():
    return {k: v[:0] for k, v in _row([0, 0, 0]).items()}


def _bank():
    """(gt columns, dt columns, gt_ignored or None) per frame."""
    frames = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        gt = twin_columns(rng, 12, labels=(1, 2, 4), scores=1.0)
        frames.append((gt, _perturbed(rng, gt), None))
    frames[0] = frames[0][:2] + (np.arange(12) % 5 == 0,)
    frames[2] = frames[2][:2] + (np.arange(12) == 3,)
    # all scores equal: the tie-break rules decide every assignment
    rng = np.random.default_rng(42)
    gt = _rows(*[_row([i * 1.5, 0, 0]) for i in range(6)])
    dt = _rows(*[_row([i * 1.5 + 0.3, 0.1, 0], score=0.7)
                 for i in rng.permutation(6)])
    frames.append((gt, dt, None))
    one = _rows(_row([0, 0, 0], score=0.9))
    frames += [(_empty(), _empty(), None), (one, _empty(), None),
               (_empty(), one, None)]
    # a Car matched by a detection without a variance (-inf) beside a Van
    # matched by one with a variance
    frames.append((_rows(_row([0, 0, 0]), _row([10, 0, 0], label=2)),
                   _rows(_row([0.1, 0, 0], score=0.9),
                         _row([10.1, 0, 0], label=2, score=0.9,
                              var=np.eye(3), ovar=0.5)), None))
    # an orientation variance with an all-zero (singular) covariance
    frames.append((_rows(_row([0, 0, 0]), _row([5, 0, 0])),
                   _rows(_row([0.1, 0, 0], score=0.9, ovar=0.5),
                         _row([5.1, 0, 0], score=0.8, var=np.eye(3) * 0.5,
                              ovar=0.2)), None))
    return frames


QUIRK_FRAME, SINGULAR_FRAME = 7, 8


def _evaluators(min_overlaps=(0.3, 0.5), **kw):
    return (JBM.DetectionEvaluator([JK[c] for c in CLASSES],
                                   list(min_overlaps), pr_sample_count=10,
                                   **kw),
            TBM.DetectionEvaluator([TK[c] for c in CLASSES],
                                   list(min_overlaps), pr_sample_count=10,
                                   device="cpu", **{
                                       k: TM.DistanceTypes(v.value)
                                       for k, v in kw.items()}))


def _evaluate(bank, jev, tev):
    gts, dts, ign = [], [], []
    for gt, dt, ignored in bank:
        gts.append(twin_arrays(gt, frame="t"))
        dts.append(twin_arrays(dt, frame="t"))
        ign.append(ignored)
    jg, tg = (list(x) for x in zip(*gts))
    jd, td = (list(x) for x in zip(*dts))
    return dict(
        jax_host=[jev.calc_stats(g, d, gt_ignored=m)
                  for g, d, m in zip(jg, jd, ign)],
        jax_device=JBD.device_calc_stats(jev, jg, jd, merge=False,
                                         gt_ignored=ign),
        port_host=[tev.calc_stats(g, d, gt_ignored=m)
                   for g, d, m in zip(tg, td, ign)],
        port_device=TBD.device_calc_stats(tev, tg, td, merge=False,
                                          gt_ignored=ign),
        arrays=(jg, jd, tg, td, ign))


@pytest.fixture(scope="module")
def bank():
    jev, tev = _evaluators()
    out = _evaluate(_bank(), jev, tev)
    out["evaluators"] = (jev, tev)
    return out


def _close(got, want, rtol, ctx):
    both_bad = ~np.isfinite(got) & ~np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), ctx)
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=0,
                               err_msg=ctx)
    assert (both_bad | ok).all(), ctx


def _assert_counters_equal(stats, ctx):
    """``stats`` (name -> DetectionEvalStats) all count the same."""
    ref_name, ref = next(iter(stats.items()))
    for name, s in stats.items():
        for k in (JK[c].value for c in CLASSES):
            assert s.ngt[k] == ref.ngt[k], (ctx, name, k)
            for fld in COUNTERS:
                np.testing.assert_array_equal(
                    getattr(s, fld)[k], getattr(ref, fld)[k],
                    f"{ctx}: {name} {fld} class {k} against {ref_name}")


@pytest.mark.parametrize("f", range(len(_bank())))
def test_counters_equal_across_the_four_evaluators(bank, f):
    _assert_counters_equal({name: bank[name][f] for name in
                            ("jax_host", "jax_device", "port_host",
                             "port_device")}, f"frame {f}")


@pytest.mark.parametrize("side", ["host", "device"])
def test_accuracies_match_the_same_side(bank, side):
    """Each of the port's evaluators against the JAX package's of the same
    kind: 1e-5 relative (acc_var 1e-4), or non-finite on both. The JAX
    device path's NaN acc_var where a class sums a -inf of another class
    or a singular covariance is pinned in the tests below instead."""
    for f, (want, got) in enumerate(zip(bank["jax_" + side],
                                        bank["port_" + side])):
        if side == "device" and f in (QUIRK_FRAME, SINGULAR_FRAME):
            continue
        for k in (JK[c].value for c in CLASSES):
            for fld in ACCURACIES:
                _close(getattr(got, fld)[k], getattr(want, fld)[k],
                       1e-4 if fld == "acc_var" else 1e-5,
                       f"{side} frame {f} {fld} class {k}")


def test_device_acc_var_stays_within_its_class(bank):
    """A matched Car detection without a variance makes the Car's acc_var
    -inf on every evaluator. The JAX device path multiplies that -inf by
    the Van's one-hot 0 and reports NaN for the Van; the port's device
    path sums each class over its own GT, as the host evaluators do."""
    car, van = JK.Car.value, JK.Van.value
    f = QUIRK_FRAME
    for name in ("jax_host", "jax_device", "port_host", "port_device"):
        assert np.isneginf(bank[name][f].acc_var[car][:3]).all(), name
    assert np.isnan(bank["jax_device"][f].acc_var[van]).all()
    host = bank["jax_host"][f].acc_var[van]
    assert np.isfinite(host[:3]).all()
    _close(bank["port_device"][f].acc_var[van], host, 1e-4, "van")
    _close(bank["port_host"][f].acc_var[van], host, 1e-4, "van host")


def test_singular_covariance_reads_as_no_estimate(bank):
    """A detection with an orientation variance but an all-zero covariance:
    the host evaluators give -inf (scipy's LinAlgError), the JAX device
    path NaN, the port's device path -inf (its LU factorisation reports the
    singular matrix). The counters do not depend on it (equal above)."""
    car = JK.Car.value
    f = SINGULAR_FRAME
    host = bank["jax_host"][f].acc_var[car]
    assert np.isneginf(host[:3]).all()
    assert np.isnan(bank["jax_device"][f].acc_var[car][:3]).all()
    np.testing.assert_array_equal(bank["port_device"][f].acc_var[car], host)
    np.testing.assert_array_equal(bank["port_host"][f].acc_var[car], host)
    for fld in ACCURACIES[:-1]:
        _close(getattr(bank["port_device"][f], fld)[car],
               getattr(bank["jax_device"][f], fld)[car], 1e-5, fld)


def _named(per_class):
    """A per-class dict with its keys (enum members of either package, or
    class values) as comparable names."""
    return [(getattr(k, "name", k), v) for k, v in per_class.items()]


def test_merged_and_chunked_match(bank):
    """merge=True and chunk_frames give the per-frame stats' merge; the
    derived metrics of the accumulated evaluators are equal."""
    jev, tev = bank["evaluators"]
    jg, jd, tg, td, ign = bank["arrays"]
    jev.reset()
    tev.reset()
    for s in bank["jax_host"]:
        jev.add_stats(s)
    merged = TBD.device_calc_stats(tev, tg, td, gt_ignored=ign)
    chunked = TBD.device_calc_stats(tev, tg, td, gt_ignored=ign,
                                    chunk_frames=4)
    _assert_counters_equal({"jax_host": jev.get_stats(),
                            "port_merged": merged, "port_chunked": chunked},
                           "merged")
    for k in (JK[c].value for c in CLASSES):
        for fld in ACCURACIES[:-1]:
            _close(getattr(chunked, fld)[k], getattr(merged, fld)[k], 1e-5,
                   f"chunked {fld}")
    tev.add_stats(merged)
    for name in ("ap", "precision", "recall", "fscore", "gt_count",
                 "dt_count", "tp", "fp", "fn"):
        want, got = getattr(jev, name)(), getattr(tev, name)()
        assert _named(got) == _named(want), name
    for name in ("precision", "recall", "fscore"):
        want = getattr(jev, name)(return_all=True)
        got = getattr(tev, name)(return_all=True)
        assert _named(got) == _named(want), name
    aph_want = jev.aph()
    for k, v in tev.aph().items():
        assert abs(v - aph_want[JK[k.name]]) <= 1e-4, k
    assert set(tev.metrics_dict()) == set(jev.metrics_dict())
    assert tev.summary(verbose=True).splitlines()[:3] == \
        jev.summary(verbose=True).splitlines()[:3]
    assert TBD.device_calc_stats(tev, [], []).ngt == {1: 0, 2: 0}


def test_position_metric_counts_match():
    """DistanceTypes.Position (the nuScenes protocol, thresholds in
    meters): the four evaluators count the same."""
    jev, tev = _evaluators((2.0, 1.0), distance_metric=JM.DistanceTypes
                           .Position)
    out = _evaluate(_bank()[:4], jev, tev)
    for f in range(4):
        _assert_counters_equal({name: out[name][f] for name in
                                ("jax_host", "jax_device", "port_host",
                                 "port_device")}, f"position frame {f}")


def _within_iou_ulps(got_dist, want_dist, ulps):
    """|got - want| of two 1 - IoU matrices within ``ulps`` f32 spacings
    of the IoU."""
    iou = (1 - want_dist).astype(np.float32)
    return bool((np.abs(got_dist - want_dist)
                 <= ulps * np.spacing(np.abs(iou))).all())


@pytest.mark.parametrize("matcher", ["ScoreMatcher", "NearestNeighborMatcher",
                                     "HungarianMatcher"])
def test_matchers_match(bank, matcher):
    """The distance cache (1 - IoU, float32) within 8 f32 ulps of the IoU
    of the JAX module's (XLA:CPU and torch round sin, cos and the areas
    differently: 5 ulps at most on this bank), and the same
    assignments."""
    jg, jd, tg, td, _ = bank["arrays"]
    thresholds = {JK.Car.value: 0.7, JK.Van.value: 0.5,
                  JK.Pedestrian.value: 0.9}
    for metric in ("RIoU", "IoU"):
        for f in range(len(jg)):
            jm, tm = getattr(JM, matcher)(), getattr(TM, matcher)()
            jm.prepare_boxes(jd[f], jg[f], JM.DistanceTypes[metric])
            tm.prepare_boxes(td[f], tg[f], TM.DistanceTypes[metric],
                             device="cpu")
            want, got = jm._distance_cache, tm._distance_cache
            assert got.dtype == np.float32 and got.shape == want.shape
            assert _within_iou_ulps(got, want, 8), (metric, f)
            jm.match(range(len(jd[f])), range(len(jg[f])), thresholds)
            tm.match(range(len(td[f])), range(len(tg[f])), thresholds)
            assert tm._src_assignment == jm._src_assignment, (metric, f)


def test_device_entry_points_need_cuda_or_an_explicit_cpu(bank):
    _, _, tg, td, ign = bank["arrays"]
    # merge=False ignores the mesh, as the JAX function does (the mesh
    # path runs on ranks: tests/test_torch_distributed.py)
    per_frame = TBD.device_calc_stats(bank["evaluators"][1], tg, td,
                                      merge=False, mesh=object(),
                                      gt_ignored=ign)
    for got, want in zip(per_frame, bank["port_device"]):
        for k in want.ngt:
            np.testing.assert_array_equal(got.tp[k], want.tp[k])
    if torch.cuda.is_available():
        pytest.skip("the rest checks the behaviour without CUDA")
    ev = TBM.DetectionEvaluator([TK.Car], 0.7)
    with pytest.raises(RuntimeError, match="CUDA"):
        ev.calc_stats(tg[0], td[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        TBD.device_calc_stats(ev, tg[:1], td[:1])
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.ScoreMatcher().prepare_boxes(td[0], tg[0], TM.DistanceTypes.RIoU)
    out = TBD.device_calc_stats(ev, tg[1:2], td[1:2], device="cpu")
    assert out.ngt[TK.Car.value] == bank["port_host"][1].ngt[TK.Car.value]


def test_matching_tables_and_subset_match():
    """The single-frame helpers (the tracking evaluator's) equal the JAX
    module's: distances within 8 ulps of the IoU, acceptance masks and
    ranks equal,
    the per-threshold matches equal."""
    rng = np.random.default_rng(3)
    gt = twin_columns(rng, 6, labels=(1, 2), scores=1.0)
    dt = _perturbed(rng, gt, extra=2)
    ja, ta = twin_arrays(gt, frame="t")
    jd, td = twin_arrays(dt, frame="t")
    classes = [1, 2]
    jp = JBD.pack_frames([ja], [jd], classes)
    tp = TBD.pack_frames([ta], [td], classes)
    for key in jp:
        np.testing.assert_array_equal(tp[key], jp[key], key)
    md = np.array([0.7, 0.5], np.float32)
    strict = np.array([True, False])
    masks = np.stack([tp["dt_label"][0] >= 0,
                      tp["dt_score"][0] >= 0.5])
    want = JBD.match_subsets_device(
        jp["dt_box"][0], jp["dt_label"][0], jp["dt_score"][0],
        jp["gt_box"][0], jp["gt_label"][0], masks, md, strict)
    got = TBD.match_subsets_device(
        tp["dt_box"][0], tp["dt_label"][0], tp["dt_score"][0],
        tp["gt_box"][0], tp["gt_label"][0], masks, md, strict, device="cpu")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert _within_iou_ulps(got[1].numpy(), np.asarray(want[1]), 8)
    jt = JBD.matching_tables_device(jp["dt_box"][0], jp["gt_box"][0],
                                    jp["gt_label"][0], md, strict)
    tt = TBD.matching_tables_device(tp["dt_box"][0], tp["gt_box"][0],
                                    tp["gt_label"][0], md, strict,
                                    device="cpu")
    for w, g in zip(jt[1:], tt[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

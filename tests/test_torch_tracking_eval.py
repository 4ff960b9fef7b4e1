"""The port's tracking evaluator (``d3d_tpu_torch.benchmarks.TrackingEvaluator``)
and its sequence scan (``benchmarks_device.tracking_match_scan``) against the
JAX package's, on the CPU.

The sequences are ``tests/tracking_sequence.py``'s, built by the JAX package
and converted object by object into the port's arrays from the same float32
columns (so every quaternion is bit-equal on both sides). Every integer
counter (TP/FP/FN, dt counts, id switches, fragments, the trajectory tables)
must be equal; the float metrics (MOTA, AMOTA, AMOTP, MT/ML ratios, AP and
the accuracy means) within 1e-12, except ``acc_iou``: the port computes the
rotated IoU with torch's float32 operations, which differ from XLA's by a few
ulps (up to 4.8e-7 on these sequences), so it is held within 1e-6, as the
JAX package's own device path is held to its host path. One module-scoped
bank holds every run; the JAX package runs once a case."""

import os

import numpy as np
import pytest
import torch

from _limits import time_limit

from tracking_sequence import evaluator_fingerprint, make_tracking_sequence

from d3d_tpu import benchmarks as JBM
from d3d_tpu import benchmarks_device as JBD

from d3d_tpu_torch import abstraction as TA
from d3d_tpu_torch import benchmarks as TBM
from d3d_tpu_torch import benchmarks_device as TBD
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TK
from d3d_tpu_torch.tracking import matcher as TM

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tracking_eval_oracle.npz")
# float metrics computed from the f32 IoU: a few ulps between torch and XLA
IOU_KEYS = ("acc_iou_",)


def port_array(arr):
    """A JAX-package Target3DArray as the port's, from its columns."""
    out = TA.Target3DArray(frame=arr.frame, timestamp=arr.timestamp)
    if len(arr) == 0:
        return out
    c = arr.columns()
    for i, o in enumerate(arr):
        tag = TA.ObjectTag(TK(int(o.tag.labels[0])), TK,
                           float(o.tag.scores[0]))
        out.append(TA.TrackingTarget3D(
            c["position"][i], c["quat"][i], c["dimension"][i],
            np.asarray(o.velocity), np.asarray(o.angular_velocity), tag,
            tid=o.tid))
    return out


def port_classes(classes):
    return [TK[c.name] for c in classes]


def assert_fingerprints(got, want, ctx):
    assert set(got) == set(want), ctx
    for key in sorted(want):
        g, w = np.asarray(got[key]), np.asarray(want[key])
        assert g.shape == w.shape, (ctx, key)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{ctx} {key}")
        else:
            atol = 1e-6 if key.startswith(IOU_KEYS) else 1e-12
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       equal_nan=True, err_msg=f"{ctx} {key}")


def _run_port(classes, thresholds, gts, dts, mode, chunk=32):
    ev = TBM.TrackingEvaluator(port_classes(classes), thresholds,
                               device="cpu")
    if mode in ("host", "device_match"):
        for g, d in zip(gts, dts):
            ev.add_stats(ev.calc_stats(g, d,
                                       device_match=mode == "device_match"))
    else:
        ev.calc_stats_sequence(gts, dts, chunk=chunk,
                               device_bookkeeping=mode == "sequence")
    return ev


MODES = ("host", "device_match", "sequence", "sequence_per_frame")


@pytest.fixture(scope="module")
def oracle_bank():
    """The port's evaluators on the frozen oracle's sequence (seed 7, 22
    frames with an empty-gt and an empty-dt frame), every route."""
    classes, gts, dts = make_tracking_sequence(seed=7, nframes=20)
    tg, td = [port_array(a) for a in gts], [port_array(a) for a in dts]
    return {mode: _run_port(classes, [0.7, 0.5, 0.5], tg, td, mode, chunk=5)
            for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_port_matches_the_frozen_oracle(oracle_bank, mode):
    """Host, device-match and both sequence routes (the scan with the
    device bookkeeping, and the per-frame device match) give the frozen
    oracle's counters exactly and its metrics within the stated limits."""
    want = dict(np.load(FIXTURE))
    assert_fingerprints(evaluator_fingerprint(oracle_bank[mode]), want, mode)


def _dup_tid_sequence():
    """Seed 51, 12 frames, a duplicated dt tid in frame 5 (chunk [4, 8)
    falls back to the per-frame path)."""
    classes, gts, dts = make_tracking_sequence(seed=51, nframes=12,
                                               with_empty_frames=False)
    dup = dts[5][0]
    dts[5].append(type(dup)(
        np.asarray(dup.position) + 0.1, dup.orientation,
        np.asarray(dup.dimension), dup.velocity, dup.angular_velocity,
        dup.tag, tid=dup.tid))
    return classes, gts, dts


def _calls(ev_cls, classes, seqs, bookkeeping, port):
    """Evaluate ``seqs`` (list of (gts, dts, kwargs)) on one evaluator."""
    cls = port_classes(classes) if port else classes
    kw = dict(device="cpu") if port else {}
    ev = ev_cls(cls, [0.5, 0.5, 0.5], **kw)
    for gts, dts, call_kw in seqs:
        ev.calc_stats_sequence(gts, dts, device_bookkeeping=bookkeeping,
                               **call_kw)
    return ev


CASES = ("multi_sequence", "duplicate_tid", "windowed", "calib")


def _case(name):
    """(classes, [(gts, dts, kwargs)]) of a case, JAX-package arrays."""
    if name == "multi_sequence":  # overlapping tid spaces, no id leak
        classes, g1, d1 = make_tracking_sequence(seed=21, nframes=6)
        _, g2, d2 = make_tracking_sequence(seed=22, nframes=6)
        return classes, [(g1, d1, {}), (g2, d2, {})]
    if name == "duplicate_tid":
        classes, gts, dts = _dup_tid_sequence()
        return classes, [(gts, dts, dict(chunk=4))]
    if name == "windowed":  # one sequence through two windows
        classes, gts, dts = make_tracking_sequence(seed=31, nframes=12)
        return classes, [(gts[:6], dts[:6], {}),
                         (gts[6:], dts[6:], dict(continue_sequence=True))]
    classes, gts, dts = make_tracking_sequence(seed=3, nframes=8)
    return classes, [(gts, dts, dict(calib="shifted", chunk=3))]


def _shifted_calib(mod):
    ts = mod.TransformSet("velo")
    ts.set_intrinsic_lidar("velo")
    ts.set_intrinsic_lidar("ego")
    t = np.eye(4)
    t[:3, 3] = [5.0, -2.0, 0.25]
    ts.set_extrinsic(t, frame_to="ego")
    return ts


@pytest.fixture(scope="module")
@time_limit(120)
def case_bank():
    """Each case through the JAX package's ``calc_stats_sequence`` (its
    scan; the JAX package's own tests hold its per-frame route equal to
    it) and the port's scan and per-frame routes, the dt frames of the
    calib case handed over in a shifted ego frame with its TransformSet.
    ``(case, bookkeeping)``: the JAX package's fingerprint and the port's
    evaluator; ``(case, "jax")``: the JAX package's evaluator."""
    from d3d_tpu import abstraction as JA

    out = {}
    for name in CASES:
        classes, seqs = _case(name)
        jseqs, tseqs = [], []
        for gts, dts, kw in seqs:
            tg = [port_array(a) for a in gts]
            td = [port_array(a) for a in dts]
            jkw, tkw = dict(kw), dict(kw)
            if kw.get("calib") == "shifted":
                jc, tc = _shifted_calib(JA), _shifted_calib(TA)
                dts = [jc.transform_objects(d, frame_to="ego") for d in dts]
                td = [tc.transform_objects(d, frame_to="ego") for d in td]
                jkw["calib"], tkw["calib"] = jc, tc
            jseqs.append((gts, dts, jkw))
            tseqs.append((tg, td, tkw))
        out[name, "jax"] = _calls(JBM.TrackingEvaluator, classes, jseqs,
                                  True, port=False)
        want = evaluator_fingerprint(out[name, "jax"])
        for bk in (True, False):
            out[name, bk] = (want, _calls(TBM.TrackingEvaluator, classes,
                                          tseqs, bk, port=True))
    return out


@pytest.mark.parametrize("bookkeeping", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_sequence_cases_match_jax(case_bank, case, bookkeeping):
    """Two sequences with overlapping tids back to back, a duplicate dt
    tid (its chunk takes the per-frame fallback, its neighbours the scan,
    the carry rebuilt across), one sequence in two windows, and dt frames
    in another frame with a calibration: the port's evaluator equals the
    JAX package's, with the device bookkeeping on and off."""
    want, ev = case_bank[case, bookkeeping]
    assert_fingerprints(evaluator_fingerprint(ev), want,
                        f"{case} bookkeeping={bookkeeping}")


def test_duplicate_tid_chunk_falls_back(monkeypatch):
    """The chunk holding a duplicated dt tid runs the per-frame path: the
    scan runs for the other two chunks only, and the result equals the
    all-per-frame run."""
    classes, gts, dts = _dup_tid_sequence()
    tg, td = [port_array(a) for a in gts], [port_array(a) for a in dts]
    calls = []
    real = TBD.tracking_match_scan
    monkeypatch.setattr(TBD, "tracking_match_scan",
                        lambda *a, **k: calls.append(a[0].shape[0])
                        or real(*a, **k))
    ev = _run_port(classes, [0.5, 0.5, 0.5], tg, td, "sequence", chunk=4)
    assert calls == [4, 4]
    ref = _run_port(classes, [0.5, 0.5, 0.5], tg, td, "host")
    assert_fingerprints(evaluator_fingerprint(ev),
                        evaluator_fingerprint(ref), "fallback")


def test_tracking_match_scan_matches_jax(monkeypatch):
    """The port's scan and the JAX package's ``lax.scan`` on the same
    chunks' tables, admissions, compact ids and carries (recorded from a
    port run of seed 41 in chunks of 4): new matches, preserved matches
    and the carry out are equal."""
    import jax.numpy as jnp

    classes, gts, dts = make_tracking_sequence(seed=41, nframes=10)
    tg, td = [port_array(a) for a in gts], [port_array(a) for a in dts]
    seen = []
    real = TBD.tracking_match_scan

    def record(*args, **kw):
        out = real(*args, **kw)
        seen.append(([np.asarray(a) if isinstance(a, np.ndarray)
                      else a.numpy() for a in args],
                     [o.numpy() for o in out]))
        return out

    monkeypatch.setattr(TBD, "tracking_match_scan", record)
    _run_port(classes, [0.5, 0.5, 0.5], tg, td, "sequence", chunk=4)
    assert len(seen) == 3
    live = 0
    for args, got in seen:
        want = JBD.tracking_match_scan(*(jnp.asarray(a) for a in args))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        live += int((got[2] >= 0).sum() + (got[3] >= 0).sum())
    assert live > 0


def test_scan_carry_is_the_host_state(oracle_bank):
    """The scan route's last-assignment matrices (the host state every
    route keeps) equal the per-frame route's after the whole sequence."""
    scan, per_frame = (oracle_bank[m] for m in ("sequence",
                                                "sequence_per_frame"))
    for attr in ("_last_gt_dt", "_last_dt_gt"):
        np.testing.assert_array_equal(getattr(scan, attr),
                                      getattr(per_frame, attr))
    assert scan._gtrack_rows == per_frame._gtrack_rows
    assert scan._dtrack_rows == per_frame._dtrack_rows


def _named(per_class):
    return sorted((getattr(k, "name", k), v) for k, v in per_class.items())


def test_metrics_and_summary_match_jax(case_bank):
    """metrics_dict (detection and CLEAR-MOT fields), summary text and the
    per-class metric calls of the port equal the JAX package's on the
    windowed case (floats of the IoU within 1e-6, others 1e-12)."""
    jev = case_bank["windowed", "jax"]
    tev = case_bank["windowed", True][1]
    jd, td = jev.metrics_dict(), tev.metrics_dict()
    assert set(jd) == set(td)
    for name, want in jd.items():
        got = td[name]
        if not isinstance(want, dict):
            assert got == pytest.approx(want, abs=1e-12), name
            continue
        for key, w in want.items():
            tol = 1e-6 if key == "acc_iou" else 1e-12
            if w is None:
                assert got[key] is None, (name, key)
            else:
                assert got[key] == pytest.approx(w, abs=tol), (name, key)
    assert tev.summary(verbose=True) == jev.summary(verbose=True)
    for fn in ("mota", "amota", "amotp", "id_switches", "fragments",
               "gt_traj_count"):
        assert _named(getattr(tev, fn)()) == _named(getattr(jev, fn)()), fn
    for score in (0.3, 0.9):
        assert (_named(tev.tracked_ratio(score))
                == _named(jev.tracked_ratio(score)))
        assert _named(tev.lost_ratio(score)) == _named(jev.lost_ratio(score))


def test_precompute_tables_and_new_sequence():
    """precompute_tables gives one (distance cache, context) a frame, the
    caches equal the host matcher's distances, and new_sequence clears the
    id state but keeps the stats."""
    classes, gts, dts = make_tracking_sequence(seed=7, nframes=4,
                                               with_empty_frames=False)
    tg, td = [port_array(a) for a in gts], [port_array(a) for a in dts]
    ev = TBM.TrackingEvaluator(port_classes(classes), [0.7, 0.5, 0.5],
                               device="cpu")
    tables = ev.precompute_tables(tg, td, chunk=3)
    assert len(tables) == 4
    for (cache, ctx), g, d in zip(tables, tg, td):
        sm = TM.ScoreMatcher()
        sm.prepare_boxes(d, g, TM.DistanceTypes.RIoU, device="cpu")
        np.testing.assert_array_equal(cache, sm._distance_cache)
        assert isinstance(ctx["dist_ok"], torch.Tensor)
    ev.add_stats(ev.calc_stats(tg[0], td[0], tables=tables[0]))
    ngt = dict(ev._stats.ngt)
    assert ev._last_gt_dt.shape[1] > 0
    ev.new_sequence()
    assert ev._last_gt_dt.shape[1] == 0 and ev._stats.ngt == ngt

"""The port's official protocols (``d3d_tpu_torch.benchmarks_kitti``,
``.benchmarks_nuscenes``, ``.benchmarks_waymo``) against the JAX package's,
on the CPU, over one module-scoped bank of seeded frames built object by
object on both sides from the same float32 columns.

- KITTI: ``evaluate_kitti_official`` and ``kitti_official_summary`` (2d,
  bev and 3d; AP_R11, AP_R40 and AOS; every difficulty; DontCare regions,
  the neighbouring class, too-small 2D boxes): the tp/fp/fn counts at every
  recall threshold and the thresholds themselves equal, the APs and AOS
  within 1e-12 (the overlaps are float64 on both sides and agree to about
  1e-12; no pair of the bank lies that close to 0.5 or 0.7, checked);
  ``evaluate_by_difficulty`` on both the batched and the per-frame route.
- nuScenes: ``evaluate_nuscenes_official`` (AP per class and distance, TP
  errors with velocities and attributes, NDS) within 1e-12, no detection
  within 1e-5 m of a distance threshold (checked), and
  ``evaluate_nuscenes_detection`` (counters equal, APs within 1e-12).
- Waymo: ``evaluate_waymo_detection`` (LEVEL_1/2, the three ranges; point
  counts from ``aux`` and from clouds through ``crop_points``): counters
  equal, AP within 1e-12.

Where the batched evaluator feeds a metric from its accuracy sums (APH,
the TP errors of the score-threshold approximation, its NDS), those sums
are float32 on both sides and torch's differ from XLA's in the last bits:
such metrics are held within 1e-6 on that route, 1e-12 on the host loop."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

from d3d_tpu import abstraction as JA
from d3d_tpu import benchmarks as JBM
from d3d_tpu import benchmarks_kitti as JKI
from d3d_tpu import benchmarks_nuscenes as JNU
from d3d_tpu import benchmarks_waymo as JWA
from d3d_tpu.dataset.kitti.utils import KittiObjectClass as JK
from d3d_tpu.dataset.nuscenes import NuscenesDetectionClass as JN

from d3d_tpu_torch import abstraction as TA
from d3d_tpu_torch import benchmarks as TBM
from d3d_tpu_torch import benchmarks_kitti as TKI
from d3d_tpu_torch import benchmarks_nuscenes as TNU
from d3d_tpu_torch import benchmarks_waymo as TWA
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TK
from d3d_tpu_torch.dataset.nuscenes import NuscenesDetectionClass as TN

KITTI_LABELS = (JK.Car.value, JK.Van.value, JK.Pedestrian.value,
                JK.Cyclist.value)
NUSC_LABELS = (JN.car.value, JN.pedestrian.value, JN.barrier.value,
               JN.traffic_cone.value, JN.truck.value)


def twins(cols, enums, frame="velo", aux=None, tracking=False,
          dontcare=None):
    """The same objects as a JAX-package array and a port array."""
    out = []
    for mod, enum in zip((JA, TA), enums):
        objs = []
        for i in range(len(cols["position"])):
            tag = mod.ObjectTag(enum(int(cols["label"][i])), enum,
                                float(cols["score"][i]))
            a = None if aux is None else dict(aux[i])
            if tracking:
                objs.append(mod.TrackingTarget3D(
                    cols["position"][i], cols["quat"][i],
                    cols["dimension"][i], cols["velocity"][i],
                    np.zeros(3), tag, tid=i + 1, aux=a))
            else:
                objs.append(mod.ObjectTarget3D(
                    cols["position"][i], cols["quat"][i],
                    cols["dimension"][i], tag, tid=i + 1, aux=a))
        arr = mod.Target3DArray(objs, frame=frame, timestamp=0)
        if dontcare is not None:
            arr.dontcare = np.array(dontcare, np.float64).reshape(-1, 4)
        out.append(arr)
    return out


def _quat(yaw):
    q = np.zeros((len(yaw), 4), np.float32)
    q[:, 2], q[:, 3] = np.sin(yaw / 2), np.cos(yaw / 2)
    return q


def _columns(rng, n, labels, spread, zero_score=False):
    yaw = rng.uniform(-np.pi, np.pi, n)
    return dict(position=np.stack([rng.uniform(-spread, spread, n),
                                   rng.uniform(-spread, spread, n),
                                   rng.uniform(-1, 1, n)], 1),
                dimension=rng.uniform(1.0, 4.5, (n, 3)), quat=_quat(yaw),
                yaw=yaw, label=rng.choice(labels, n),
                score=(np.ones(n) if zero_score
                       else rng.uniform(0.05, 1.0, n).astype(np.float32)),
                velocity=rng.normal(0, 2, (n, 3)))


def _detections(rng, gt, extra, labels, spread, jitter=0.25, nkeep=None):
    """A jittered subset of ``gt`` (``nkeep`` of them where given, so
    every frame has as many rows) plus ``extra`` random boxes."""
    keep = rng.random(len(gt["position"])) < 0.85
    if nkeep is not None:
        keep = np.isin(np.arange(len(keep)),
                       rng.choice(len(keep), nkeep, replace=False))
    n = int(keep.sum())
    yaw = gt["yaw"][keep] + rng.normal(0, 0.1, n)
    det = dict(position=gt["position"][keep] + rng.normal(0, jitter, (n, 3)),
               dimension=gt["dimension"][keep] * rng.uniform(0.9, 1.1,
                                                             (n, 3)),
               quat=_quat(yaw), yaw=yaw, label=gt["label"][keep],
               score=rng.uniform(0.2, 1.0, n).astype(np.float32),
               velocity=gt["velocity"][keep] + rng.normal(0, 0.3, (n, 3)))
    more = _columns(rng, extra, labels, spread)
    return {k: np.concatenate([det[k], more[k]]) for k in det}, keep


def _kitti_aux(rng, n, yaw):
    out = []
    for i in range(n):
        x1, y1 = rng.uniform(0, 1100), rng.uniform(0, 300)
        h = rng.uniform(15, 90)
        out.append(dict(bbox=np.array([x1, y1, x1 + h * 1.5, y1 + h]),
                        box_height=float(h), occluded=int(rng.integers(0, 4)),
                        truncated=float(rng.uniform(0, 0.6)),
                        alpha=float(yaw[i] + rng.normal(0, 0.1))))
    return out


@pytest.fixture(scope="module")
def kitti_bank():
    """8 KITTI-like frames: 12 GT objects of 4 classes (Van the Car's
    neighbour), 2D boxes, occlusion, truncation, alpha and two DontCare
    regions a frame; detections 10 of them jittered plus 5 noise boxes,
    their 2D boxes jittered too (some below 25 px). Every frame has the
    same shapes, so the JAX package compiles each overlap once."""
    rng = np.random.default_rng(1234)
    frames = []
    for _ in range(8):
        gt = _columns(rng, 12, KITTI_LABELS, 20.0, zero_score=True)
        gaux = _kitti_aux(rng, 12, gt["yaw"])
        dt, keep = _detections(rng, gt, 5, KITTI_LABELS, 20.0, nkeep=10)
        daux = [dict(a, bbox=a["bbox"] + rng.normal(0, 3, 4),
                     alpha=a["alpha"] + float(rng.normal(0, 0.05)))
                for a, k in zip(gaux, keep) if k]
        daux += _kitti_aux(rng, 5, dt["yaw"][-5:])
        dc = [[rng.uniform(0, 1100), rng.uniform(0, 300)] * 2
              for _ in range(2)]
        dc = [[a, b, a + 80, b + 60] for a, b, _, _ in dc]
        jg, tg = twins(gt, (JK, TK), aux=gaux, dontcare=dc)
        jd, td = twins(dt, (JK, TK), aux=daux)
        frames.append((jg, jd, tg, td))
    return [list(x) for x in zip(*frames)]


def _assert_official(got, want, ctx):
    for key in ("tp", "fp", "fn"):
        np.testing.assert_array_equal(got[key], want[key], f"{ctx} {key}")
    assert got["n_gt"] == want["n_gt"], ctx
    np.testing.assert_array_equal(np.asarray(got["thresholds"]),
                                  np.asarray(want["thresholds"]), ctx)
    for key in ("ap_r40", "ap_r11", "aos_r40", "aos_r11"):
        if key in want:
            assert abs(got[key] - want[key]) <= 1e-12, (ctx, key)
    for key in ("precision", "aos"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-12, err_msg=f"{ctx} {key}")


@pytest.mark.parametrize("metric", ["2d", "bev", "3d"])
def test_kitti_overlaps_match(kitti_bank, metric):
    """The overlap matrices (float64 on the port's CPU device) equal the
    JAX package's within 1e-12, and none lies within 1e-9 of 0.5 or 0.7,
    so no match can flip between the two."""
    jg, jd, tg, td = kitti_bank
    for a, b, c, d in zip(jg, jd, tg, td):
        want = JKI._overlap_matrix(b, a, metric)
        got = TKI._overlap_matrix(d, c, metric, device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        for t in (0.5, 0.7):
            assert not (np.abs(want - t) < 1e-9).any()


@pytest.mark.parametrize("metric", ["2d", "bev", "3d"])
@pytest.mark.parametrize("cls", ["Car", "Pedestrian"])
def test_kitti_official_matches_jax(kitti_bank, cls, metric):
    """Every difficulty of one class and metric (AOS with the 2d metric)."""
    jg, jd, tg, td = kitti_bank
    for difficulty in range(3):
        kw = dict(difficulty=difficulty, metric=metric,
                  min_overlap=0.7 if cls == "Car" else 0.5,
                  compute_aos=metric == "2d")
        want = JKI.evaluate_kitti_official(jg, jd, JK[cls], **kw)
        got = TKI.evaluate_kitti_official(tg, td, TK[cls], device="cpu",
                                          **kw)
        _assert_official(got, want, f"{cls} {metric} {difficulty}")
    assert want["n_gt"] > 0 and want["tp"].sum() > 0


def test_kitti_official_summary_matches_jax(kitti_bank):
    """The results table of three classes by 2d, bev and 3d with AOS: the
    same text, every cell's result equal."""
    jg, jd, tg, td = kitti_bank
    classes = ("Car", "Pedestrian", "Cyclist")
    jt, jr = JKI.kitti_official_summary(jg, jd, [JK[c] for c in classes],
                                        metrics=("2d", "bev", "3d"),
                                        compute_aos=True)
    tt, tr = TKI.kitti_official_summary(tg, td, [TK[c] for c in classes],
                                        metrics=("2d", "bev", "3d"),
                                        compute_aos=True, device="cpu")
    assert tt == jt
    for c in classes:
        for m in ("2d", "bev", "3d"):
            for d in range(3):
                _assert_official(tr[TK[c]][m][d], jr[JK[c]][m][d],
                                 f"{c} {m} {d}")


@pytest.mark.parametrize("device", [True, False])
def test_kitti_by_difficulty_matches_jax(kitti_bank, device):
    """The cumulative strata through the batched evaluator and through the
    per-frame host loop: counters equal, APs within 1e-12."""
    jg, jd, tg, td = kitti_bank
    want = JKI.evaluate_by_difficulty(
        lambda: JBM.DetectionEvaluator([JK.Car, JK.Pedestrian], [0.7, 0.5],
                                       pr_sample_count=20), jg, jd,
        device=device)
    got = TKI.evaluate_by_difficulty(
        lambda: TBM.DetectionEvaluator([TK.Car, TK.Pedestrian], [0.7, 0.5],
                                       pr_sample_count=20, device="cpu"),
        tg, td, device=device)
    _assert_evaluators(got, want, 1e-6 if device else 1e-12)


def _assert_evaluators(got, want, aph_tol=1e-12):
    """Counters equal, AP within 1e-12, APH within ``aph_tol``: on the
    batched route the heading term comes from float32 angle sums on both
    sides (torch's and XLA's differ in the last bits), on the host loop
    from float64 ones."""
    assert list(got) == list(want)
    for name in want:
        ws, gs = want[name].get_stats(), got[name].get_stats()
        for k in ws.ngt:
            assert gs.ngt[k] == ws.ngt[k], (name, k)
            for fld in ("ndt", "tp", "fp", "fn"):
                np.testing.assert_array_equal(getattr(gs, fld)[k],
                                              getattr(ws, fld)[k],
                                              f"{name} {fld} {k}")
        for fn, tol in (("ap", 1e-12), ("aph", aph_tol)):
            w = {c.name: v for c, v in getattr(want[name], fn)().items()}
            g = {c.name: v for c, v in getattr(got[name], fn)().items()}
            assert g.keys() == w.keys()
            for c in w:
                assert abs(g[c] - w[c]) <= tol or (
                    np.isnan(g[c]) and np.isnan(w[c])), (name, fn, c)


@pytest.fixture(scope="module")
def nusc_bank():
    """10 ego-frame nuScenes-like frames: 25 GT of 5 classes within 60 m
    (so the class ranges cut), velocities; detections a jittered subset
    plus 8 noise boxes."""
    rng = np.random.default_rng(99)
    frames = []
    for f in range(10):
        gt = _columns(rng, 25, NUSC_LABELS, 60.0, zero_score=True)
        dt, _ = _detections(rng, gt, 8, NUSC_LABELS, 60.0, jitter=0.8)
        jg, tg = twins(gt, (JN, TN), frame="ego", tracking=True)
        jd, td = twins(dt, (JN, TN), frame="ego", tracking=True)
        frames.append((jg, jd, tg, td))
    return [list(x) for x in zip(*frames)]


NUSC_CLASSES = ("car", "pedestrian", "barrier", "traffic_cone", "truck")


def _attr(v):
    return int(v) % 3


def test_nuscenes_distances_clear_the_thresholds(nusc_bank):
    """No same-class (detection, GT) BEV distance of the bank lies within
    1e-5 m of a matching threshold, so float32 rounding cannot flip a
    match between the two matchers."""
    jg, jd, _, _ = nusc_bank
    for g, d in zip(jg, jd):
        if not len(g) or not len(d):
            continue
        gc, dc = g.columns(), d.columns()
        dist = np.linalg.norm(dc["position"][:, None, :2]
                              - gc["position"][None, :, :2], axis=-1)
        same = dc["label"][:, None] == gc["label"][None, :]
        for t in JNU.NUSC_DIST_THRESHOLDS:
            assert not (same & (np.abs(dist - t) < 1e-5)).any()


@pytest.mark.parametrize("attr", [False, True])
def test_nuscenes_official_matches_jax(nusc_bank, attr):
    """AP per class and distance, the TP errors (velocity, and attribute
    where asked), their means and the NDS within 1e-12; the match itself
    equal."""
    jg, jd, tg, td = nusc_bank
    kw = dict(attr_of=_attr) if attr else {}
    want = JNU.evaluate_nuscenes_official(
        jg, jd, [JN[c] for c in NUSC_CLASSES], **kw)
    got = TNU.evaluate_nuscenes_official(
        tg, td, [TN[c] for c in NUSC_CLASSES], device="cpu", **kw)
    assert got["tp_metrics"] == want["tp_metrics"]
    assert ("attr_err" in got["tp_metrics"]) == attr
    assert "vel_err" in got["tp_metrics"]
    for c in NUSC_CLASSES:
        for t in JNU.NUSC_DIST_THRESHOLDS:
            assert got["ap"][TN[c]][t] == pytest.approx(
                want["ap"][JN[c]][t], abs=1e-12), (c, t)
        w, g = want["tp_errors"][JN[c]], got["tp_errors"][TN[c]]
        assert g.keys() == w.keys(), c
        for m in w:
            assert g[m] == pytest.approx(w[m], abs=1e-12), (c, m)
    for m in want["mean_tp_errors"]:
        assert got["mean_tp_errors"][m] == pytest.approx(
            want["mean_tp_errors"][m], abs=1e-12, nan_ok=True)
    assert got["mean_ap"] == pytest.approx(want["mean_ap"], abs=1e-12)
    assert got["nds"] == pytest.approx(want["nds"], abs=1e-12)
    assert 0.0 < got["mean_ap"] < 1.0


def test_nuscenes_match_frames_matches_jax(nusc_bank):
    """The matcher alone: the port's (T, F, D) matches equal the JAX
    package's on the packed bank, ties of equal distance included (two GT
    at the same center: the lower row wins on both sides)."""
    import jax.numpy as jnp
    import torch

    jg, jd, _, _ = nusc_bank
    idx = {JN[c].value: i for i, c in enumerate(NUSC_CLASSES)}
    dt = JNU._pack_nusc(jd, idx, 40)
    gt = JNU._pack_nusc(jg, idx, 30)
    gt["pos"][:, 25] = gt["pos"][:, 3]  # a twin of GT 3 in each frame
    gt["label"][:, 25] = gt["label"][:, 3]
    ths = np.asarray(JNU.NUSC_DIST_THRESHOLDS, np.float32)
    want = np.asarray(JNU._nusc_match_frames(
        jnp.asarray(dt["pos"][:, :, :2]), jnp.asarray(dt["score"]),
        jnp.asarray(dt["label"]), jnp.asarray(gt["pos"][:, :, :2]),
        jnp.asarray(gt["label"]), jnp.asarray(ths)))
    got = TNU._nusc_match_frames(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
            dt["pos"][:, :, :2], dt["score"], dt["label"],
            gt["pos"][:, :, :2], gt["label"], ths))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).sum() > 0 and not (got == 25).any()


@pytest.mark.parametrize("device", [True, False])
def test_nuscenes_detection_matches_jax(nusc_bank, device):
    """The score-threshold approximation on the batched evaluator (the
    port's on the CPU device) and on the per-frame host loop: counters
    equal, AP within 1e-12, TP errors and NDS within 1e-6 batched (float32
    sums) and 1e-12 on the host loop."""
    jg, jd, tg, td = nusc_bank
    want = JNU.evaluate_nuscenes_detection(
        jg, jd, [JN[c] for c in NUSC_CLASSES], pr_sample_count=20,
        device=device)
    got = TNU.evaluate_nuscenes_detection(
        tg, td, [TN[c] for c in NUSC_CLASSES], pr_sample_count=20,
        device="cpu" if device else False)
    _assert_evaluators({str(k): v for k, v in got["evaluators"].items()},
                       {str(k): v for k, v in want["evaluators"].items()},
                       1e-6 if device else 1e-12)
    # the TP errors are means of the accuracy sums: float32 on the batched
    # route (torch's and XLA's differ in the last bits), float64 on the host
    tol = 1e-6 if device else 1e-12
    for c in NUSC_CLASSES:
        for m, v in want["tp_errors"][JN[c]].items():
            assert got["tp_errors"][TN[c]][m] == pytest.approx(
                v, abs=tol, nan_ok=True), (c, m)
    assert got["nds"] == pytest.approx(want["nds"], abs=tol)
    assert got["mean_ap"] == pytest.approx(want["mean_ap"], abs=1e-12)


@pytest.fixture(scope="module")
def waymo_bank():
    """6 frames of 20 GT (Car/Pedestrian/Cyclist values) up to 70 m out,
    the first 3 with ``num_points``/``difficulty`` in aux, the last 3 with
    a cloud each (points inside some boxes, none in others) for
    ``crop_points`` to count."""
    rng = np.random.default_rng(5)
    labels = (JK.Car.value, JK.Pedestrian.value, JK.Cyclist.value)
    frames, clouds = [], []
    for f in range(6):
        gt = _columns(rng, 20, labels, 70.0, zero_score=True)
        dt, _ = _detections(rng, gt, 6, labels, 70.0)
        aux = None
        if f < 3:
            aux = [dict(num_points=int(rng.integers(0, 40)),
                        difficulty=int(rng.choice([0, 2])))
                   for _ in range(20)]
        else:
            pts = [gt["position"][i] + rng.uniform(-0.3, 0.3, (k, 3))
                   for i, k in enumerate(rng.integers(0, 12, 20))]
            clouds.append(np.concatenate(pts + [rng.uniform(
                -70, 70, (50, 3))]))
        jg, tg = twins(gt, (JK, TK), aux=aux)
        jd, td = twins(dt, (JK, TK))
        frames.append((jg, jd, tg, td))
    return [list(x) for x in zip(*frames)], clouds


def test_waymo_matches_jax(waymo_bank):
    """Every LEVEL and range stratum through the batched evaluators, the
    last frames' point counts from their clouds: counters equal, AP within
    1e-12 and APH within 1e-6 (float32 angle sums), the summary text the
    same."""
    (jg, jd, tg, td), clouds = waymo_bank
    jc = [None] * 3 + clouds
    classes = ("Car", "Pedestrian", "Cyclist")
    # the first frames carry aux counts: a cloud is read only without them
    want = JWA.evaluate_waymo_detection(
        lambda: JBM.DetectionEvaluator([JK[c] for c in classes], 0.5,
                                       pr_sample_count=20), jg, jd,
        clouds=jc)
    got = TWA.evaluate_waymo_detection(
        lambda: TBM.DetectionEvaluator([TK[c] for c in classes], 0.5,
                                       pr_sample_count=20, device="cpu"),
        tg, td, clouds=jc)
    assert len(got) == 8
    _assert_evaluators(got, want, 1e-6)
    assert TWA.waymo_summary(got) == JWA.waymo_summary(want)


def test_waymo_point_counts_match_jax(waymo_bank):
    """gt_num_points through the port's crop on the CPU equals the JAX
    package's, and some boxes hold no point (excluded), some at most 5
    (LEVEL_2)."""
    (jg, _, tg, _), clouds = waymo_bank
    counts = []
    for j, t, cloud in zip(jg[3:], tg[3:], clouds):
        want = JWA.gt_num_points(j, cloud)
        got = TWA.gt_num_points(t, cloud, device="cpu")
        np.testing.assert_array_equal(got, want)
        counts.append(got)
    counts = np.concatenate(counts)
    assert (counts == 0).any() and ((counts > 0) & (counts <= 5)).any()

"""The port's minimum end-to-end slice on the CPU, held to the JAX
package's (the counterpart of ``tests/test_end_to_end.py``): KITTI fixture
frames -> ``KittiObjectLoader`` -> ``VoxelGenerator`` -> a stand-in
detector (the GT jittered, duplicated, with noise boxes) -> rotated
``box2d_nms`` -> ``DetectionEvaluator``, host and device. The same seeded
detections go through the JAX package's loader, NMS and evaluator: the keep
masks and every counter are equal, and the AP bounds of
``tests/test_end_to_end.py`` hold. One request of a tiny PointPillars
``detect`` feeds the evaluators too."""

import numpy as np
import pytest
import torch

import _limits  # noqa: F401  (one torch thread a process)

import kitti_fixture as fx
from d3d_tpu.abstraction import Target3DArray as JArray
from d3d_tpu.benchmarks import DetectionEvaluator as JEvaluator
from d3d_tpu.dataset.kitti import KittiObjectClass as JK
from d3d_tpu.dataset.kitti import KittiObjectLoader as JLoader
from d3d_tpu.ops.box import box2d_nms as j_box2d_nms

from d3d_tpu_torch.abstraction import Target3DArray as TArray
from d3d_tpu_torch.benchmarks import DetectionEvaluator as TEvaluator
from d3d_tpu_torch.benchmarks_device import device_calc_stats
from d3d_tpu_torch.dataset.kitti import KittiObjectClass as TK
from d3d_tpu_torch.dataset.kitti import KittiObjectLoader as TLoader
from d3d_tpu_torch.models import (PointPillars, PointPillarsConfig,
                                  make_anchors, make_pointpillars_detector)
from d3d_tpu_torch.ops.box import box2d_nms
from d3d_tpu_torch.ops.voxel import VoxelGenerator

from test_torch_abstraction import twin_arrays

NFRAMES = 4
CLASSES = ("Car", "Pedestrian")
MIN_OVERLAPS = [0.5, 0.25]


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_port_e2e")
    fx.build_unzipped(root, nframes=NFRAMES)
    return (JLoader(root, phase="training", trainval_split=1.0),
            TLoader(root, phase="training", trainval_split=1.0))


def _stand_in(rng, gt, jitter=0.05, n_noise=6):
    """Detection columns from GT columns, as ``tests/test_end_to_end.py``'s
    fake detector: per GT a jittered box (score 0.7-0.95) and a duplicate
    that NMS must remove (0.3-0.5), then low-scored noise Cars."""
    rows = []
    for i in range(len(gt["position"])):
        pos = gt["position"][i] + rng.normal(0, jitter, 3)
        dim = gt["dimension"][i] * (1 + rng.normal(0, jitter / 2, 3))
        yaw = gt["yaw"][i] + rng.normal(0, 0.02)
        rows.append((pos, dim, yaw, gt["label"][i], rng.uniform(0.7, 0.95)))
        rows.append((pos + rng.normal(0, jitter, 3), dim, yaw,
                     gt["label"][i], rng.uniform(0.3, 0.5)))
    for _ in range(n_noise):
        rows.append((rng.uniform([0, -20, -2], [50, 20, 0]),
                     np.array([4.0, 1.8, 1.6]), rng.uniform(-np.pi, np.pi),
                     TK.Car.value, rng.uniform(0.05, 0.2)))
    pos, dim, yaw, label, score = (np.array(c) for c in zip(*rows))
    quat = np.zeros((len(rows), 4), np.float32)
    quat[:, 2], quat[:, 3] = np.sin(yaw / 2), np.cos(yaw / 2)
    n = len(rows)
    return dict(position=pos, dimension=dim, quat=quat, label=label,
                score=score, position_var=np.zeros((n, 3, 3)),
                dimension_var=np.zeros((n, 3, 3)),
                orientation_var=np.zeros(n))


def _counters(stats):
    return {k: (stats.ngt[k],) + tuple(tuple(getattr(stats, f)[k])
                                       for f in ("ndt", "tp", "fp", "fn"))
            for k in stats.ngt}


def _keep(dets, nms):
    arr = dets.to_numpy()
    bev = arr[:, [2, 3, 5, 6, 8]].astype(np.float64)  # x, y, l, w, yaw
    return np.asarray(nms(bev, arr[:, 1].astype(np.float64)))


def test_end_to_end_matches_the_jax_run(loaders):
    jl, tl = loaders
    rng = np.random.default_rng(20260816)
    gen = VoxelGenerator([0, 70.4, -40, 40, -3, 1], [176, 200, 4],
                         max_points=32, max_voxels=8000, reduction="mean",
                         dense=True, device="cpu")
    jev = JEvaluator([JK[c] for c in CLASSES], MIN_OVERLAPS)
    tev = TEvaluator([TK[c] for c in CLASSES], MIN_OVERLAPS, device="cpu")
    tev_dev = TEvaluator([TK[c] for c in CLASSES], MIN_OVERLAPS,
                         device="cpu")
    gts, kepts = [], []
    for i in range(NFRAMES):
        vox = gen(tl.lidar_data(i))
        assert len(vox.coords) > 0  # voxelization ran on the loaded frame

        jgt, tgt = jl.annotation_3dobject(i), tl.annotation_3dobject(i)
        cols = tgt.columns()
        np.testing.assert_array_equal(cols["position"],
                                      jgt.columns()["position"])
        jdet, tdet = twin_arrays(_stand_in(rng, cols), frame=tgt.frame)
        keep = _keep(tdet, lambda b, s: box2d_nms(
            b, s, iou_method="rbox", iou_threshold=0.1, device="cpu"))
        np.testing.assert_array_equal(keep, _keep(jdet, lambda b, s:
                                                  j_box2d_nms(
            b, s, iou_method="rbox", iou_threshold=0.1)))
        assert keep.sum() < len(tdet)  # NMS removed the duplicates
        jkept = JArray([d for d, k in zip(jdet, keep) if k], frame="velo")
        tkept = TArray([d for d, k in zip(tdet, keep) if k], frame="velo")
        jev.add_stats(jev.calc_stats(jgt, jkept))
        tev.add_stats(tev.calc_stats(tgt, tkept))
        gts.append(tgt)
        kepts.append(tkept)
    tev_dev.add_stats(device_calc_stats(tev_dev, gts, kepts))

    want = _counters(jev.get_stats())
    assert _counters(tev.get_stats()) == want
    assert _counters(tev_dev.get_stats()) == want
    for ev in (tev, tev_dev):
        ap = ev.ap()
        assert ap[TK.Car] > 0.85 and ap[TK.Pedestrian] > 0.85
        assert [v for v in ap.values()] == list(jev.ap().values())
    assert "mAP" in tev.summary(verbose=True)


def test_pointpillars_detect_feeds_the_evaluators(loaders):
    """One request of a tiny PointPillars detector (seeded random weights,
    CPU) on a loaded frame: its Target3DArray, evaluated against the
    frame's labels, counts the same on the port's host and device
    evaluators and on the JAX package's host evaluator."""
    jl, tl = loaders
    cfg = PointPillarsConfig(
        bounds=(0.0, 51.2, -25.6, 25.6, -3.0, 1.0), grid=(32, 32),
        max_pillars=256, max_points_per_pillar=8, pfn_features=16,
        backbone_channels=(16, 32), backbone_blocks=(1, 1),
        upsample_channels=16, dtype="float32")
    model = PointPillars(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    detect = make_pointpillars_detector(
        model, None, cfg, make_anchors(cfg, device="cpu"), [TK.Car],
        score_threshold=0.0, top_k=16, device="cpu")
    dets = detect(tl.lidar_data(1), frame="velo", timestamp=1)
    assert dets.frame == "velo" and 0 < len(dets) <= 16
    assert all(o.tag_top is TK.Car for o in dets)
    c = dets.columns()
    jdets = JArray.from_columns(c["position"], c["dimension"],
                                quats=c["quat"], labels=c["label"],
                                scores=c["score"], mapping=JK, frame="velo")
    # the labels, moved onto the first detections (random weights find
    # no car), so that the Car is found
    gt, jgt = tl.annotation_3dobject(1), jl.annotation_3dobject(1)
    for arr in (gt, jgt):
        for key in ("position", "dimension", "quat"):
            arr.columns()[key][:] = c[key][:len(arr)]
    jev = JEvaluator([JK.Car], 0.5)
    tev = TEvaluator([TK.Car], 0.5, device="cpu")
    want = _counters(jev.calc_stats(jgt, jdets))
    assert _counters(tev.calc_stats(gt, dets)) == want
    assert _counters(device_calc_stats(tev, [gt], [dets])) == want
    ngt, ndt, tp = want[TK.Car.value][:3]
    assert ngt == 1 and ndt[0] == len(dets) and tp[0] == 1

"""The port stands alone: it imports neither JAX nor the JAX package, runs
on the CPU only when asked, and its kernel wrappers take the plain version
for CPU tensors without counting a launch."""

import ast
import dataclasses
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

from _limits import run_python

import d3d_tpu_torch
from d3d_tpu_torch.models import SECOND, PointPillars, head_config, presets
from d3d_tpu_torch.models import (make_anchors, make_pointpillars_detector,
                                  make_second_detector)
from d3d_tpu_torch.ops import geometry_cuda, nms_cuda, sparse_conv_cuda
from d3d_tpu_torch.ops.nms import nms2d, soft_nms2d
from d3d_tpu_torch.ops.sparse_conv import subm_conv_apply
from d3d_tpu_torch.ops.voxel import voxelize_dense_padded, voxelize_mean_fm

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "d3d_tpu")


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        d3d_tpu_torch.__path__, "d3d_tpu_torch."))


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in ['d3d_tpu_torch'] + {_submodules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = run_python(code, ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix()
     for p in [*(ROOT / "d3d_tpu_torch").rglob("*.py"),
               *(ROOT / "examples").glob("torch_*.py")]]
    + ["chip_smoke.py", "tests/_torch_dist_worker.py"]))
def test_source_imports_no_jax(path):
    bad = [m for m in _imported_roots(ROOT / path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    cfg = presets.pointpillars_kitti(dtype="float32", grid=(8, 8),
                                     max_pillars=16)
    pts = np.zeros((10, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        PointPillars(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_anchors(cfg)
    model = PointPillars(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pointpillars_detector(model, None, cfg,
                                   make_anchors(cfg, device="cpu"), ["Car"])
    with pytest.raises(RuntimeError, match="CUDA"):
        nms2d(np.zeros((3, 5), np.float32), np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        voxelize_mean_fm(pts.T, (8, 8, 1), cfg.bounds, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        voxelize_dense_padded(pts, (8, 8, 1), cfg.bounds, 4, 4, "none",
                              order_mode="sorted")
    # asked for the CPU, the same entry points run there
    det = make_pointpillars_detector(model, None, cfg,
                                     make_anchors(cfg, device="cpu"),
                                     ["Car"], device="cpu")
    boxes, scores, labels, keep = det.device_fn(pts)
    assert boxes.device.type == "cpu"


def test_wrappers_on_cpu_tensors_take_the_plain_version():
    counts = (geometry_cuda.rbox_iou_matrix.launches,
              nms_cuda.nms_scan.launches, nms_cuda.nms_scan_blocked.launches)
    boxes = torch.tensor([[0.0, 0.0, 2.0, 2.0, 0.0],
                          [0.5, 0.0, 2.0, 2.0, 0.1],
                          [9.0, 9.0, 1.0, 1.0, 0.0]])
    iou = geometry_cuda.rbox_iou_matrix(boxes, boxes)
    assert iou.device.type == "cpu" and iou.shape == (3, 3)
    overlap = iou > 0.3
    pre = torch.zeros(3, dtype=torch.bool)
    for scan in (nms_cuda.nms_scan, nms_cuda.nms_scan_blocked):
        assert scan(overlap, pre).tolist() == [False, True, False]
    suppressed = nms2d(boxes, torch.tensor([0.9, 0.8, 0.7]),
                       iou_threshold=0.3)
    assert suppressed.tolist() == [False, True, False]
    assert (geometry_cuda.rbox_iou_matrix.launches,
            nms_cuda.nms_scan.launches,
            nms_cuda.nms_scan_blocked.launches) == counts


def _tiny_second():
    return presets.second_kitti(
        dtype="float32", bounds=(0.0, 6.4, -3.2, 3.2, -3.0, 1.0),
        grid=(16, 16, 8), max_voxels=64, stage_sites=(64, 32, 16),
        head_channels=8)


def test_second_entry_points_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    cfg = _tiny_second()
    pts = np.random.default_rng(0).uniform(-3, 3, (200, 4)).astype(
        np.float32) + np.array([3.2, 0, 1, 3], np.float32)
    feats = np.ones((4, 2), np.float32)
    nbr = np.full((4, 27), -1, np.int32)
    w = np.ones((27, 2, 3), np.float32)
    valid = np.ones(4, bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        SECOND(cfg)
    model = SECOND(cfg, device="cpu")
    anchors = make_anchors(head_config(cfg), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_second_detector(model, None, cfg, anchors, ["Car"])
    with pytest.raises(RuntimeError, match="CUDA"):
        soft_nms2d(np.zeros((3, 5), np.float32), np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        subm_conv_apply(feats, nbr, w, valid)
    # asked for the CPU, the same entry points run there
    det = make_second_detector(model, None, cfg, anchors, ["Car"],
                               device="cpu")
    boxes, scores, labels, keep = det.device_fn(pts)
    assert boxes.device.type == "cpu" and boxes.shape == (32, 7)
    out = subm_conv_apply(*(torch.from_numpy(a)
                            for a in (feats, nbr, w, valid)))
    assert out.device.type == "cpu" and out.shape == (4, 3)


def test_new_wrappers_on_cpu_tensors_take_the_plain_version():
    counts = (nms_cuda.soft_nms_scan.launches,
              sparse_conv_cuda.subm_conv.launches,
              geometry_cuda.rbox_iou_matrix.launches)
    iou = torch.tensor([[1.0, 0.6, 0.0], [0.6, 1.0, 0.1], [0.0, 0.1, 1.0]])
    scores = torch.tensor([0.9, 0.8, 0.7])
    pre = torch.zeros(3, dtype=torch.bool)
    for method, param in (("linear", 1.0), ("gaussian", 0.1)):
        sup = nms_cuda.soft_nms_scan(iou, scores, pre, 0.3, 0.5, param,
                                     method)
        assert sup.tolist() == [False, True, False]
    boxes = torch.tensor([[0.0, 0.0, 2.0, 2.0, 0.0],
                          [0.5, 0.0, 2.0, 2.0, 0.1],
                          [9.0, 9.0, 1.0, 1.0, 0.0]])
    assert soft_nms2d(boxes, scores, iou_threshold=0.3, score_threshold=0.5,
                      supression_param=1.0).tolist() == [False, True, False]
    feats = torch.arange(6.0).reshape(3, 2)
    nbr = torch.full((2, 27), -1, dtype=torch.int32)
    nbr[0, 13], nbr[1, 0] = 2, 1
    out = sparse_conv_cuda.subm_conv(feats, nbr, torch.ones(27, 2, 1),
                                     torch.tensor([True, False]))
    assert out.tolist() == [[9.0], [0.0]]
    assert (nms_cuda.soft_nms_scan.launches,
            sparse_conv_cuda.subm_conv.launches,
            geometry_cuda.rbox_iou_matrix.launches) == counts


def test_training_runs_on_the_cpu_only_when_asked():
    """The SECOND train step runs where its model lives: a model made
    without a device needs CUDA; one made with ``device="cpu"`` trains
    there on numpy batches (they follow the model), through the plain
    versions of K5 and K6, which count no launch."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    from d3d_tpu_torch.models import second_voxelize
    from d3d_tpu_torch.models.second import make_train_step
    from d3d_tpu_torch.train import make_optimizer

    cfg = _tiny_second()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_anchors(head_config(cfg))
    rng = np.random.default_rng(0)
    frames = [second_voxelize(torch.from_numpy(
        (rng.uniform(-3, 3, (300, 4)) + [3.2, 0, 1, 3]).astype(np.float32)),
        cfg) for _ in range(2)]
    batch = {k: torch.stack([f[i] for f in frames]).numpy()
             for i, k in enumerate(("features", "coords", "valid"))}
    batch.update(gt_boxes=np.array([[[3.0, 0.0, -1.0, 3.9, 1.6, 1.56, 0.3]]]
                                   * 2, np.float32),
                 gt_labels=np.zeros((2, 1), np.int32),
                 gt_mask=np.ones((2, 1), bool))
    model = SECOND(cfg, device="cpu")
    opt, _ = make_optimizer(model.parameters(), 3)
    step = make_train_step(model, opt, cfg,
                           make_anchors(head_config(cfg), device="cpu"))
    counts = (sparse_conv_cuda.subm_conv.launches,
              sparse_conv_cuda.subm_conv_dw.launches)
    aux = step(batch)
    assert np.isfinite(float(aux["total"]))
    assert all(p.grad is not None and p.grad.device.type == "cpu"
               for p in model.parameters())
    assert (sparse_conv_cuda.subm_conv.launches,
            sparse_conv_cuda.subm_conv_dw.launches) == counts


def test_training_tail_is_covered_and_needs_cuda_or_an_explicit_cpu():
    """The training pipeline's modules are among those the import checks
    walk, and their entry points that make tensors need CUDA unless given
    the CPU: ``init_variables``, the GT database's crops and the GT
    sampler's IoUs."""
    assert {"d3d_tpu_torch.augment", "d3d_tpu_torch.checkpoint",
            "d3d_tpu_torch.profiler", "d3d_tpu_torch.quantize",
            "d3d_tpu_torch.train", "d3d_tpu_torch.models.fold",
            "d3d_tpu_torch.models.tta"} <= set(_submodules())
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    from d3d_tpu_torch.augment import build_gt_database, sample_ground_truths
    from d3d_tpu_torch.train import init_variables

    cfg = presets.pointpillars_kitti(dtype="float32", grid=(8, 8),
                                     max_pillars=16)
    model = PointPillars(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_variables(model)
    assert init_variables(model, device="cpu") is model
    pts = np.zeros((10, 4), np.float32)
    box = np.array([[0, 0, 0, 4, 2, 2, 0]], np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_gt_database([(pts, box, np.array([0]))], min_points=1)
    db = build_gt_database([(pts, box, np.array([0]))], min_points=1,
                           device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        sample_ground_truths(np.random.default_rng(0), db, pts, box + 9,
                             np.array([0]))


def test_centerpoint_and_painting_entry_points_need_cuda_or_an_explicit_cpu():
    """CenterPoint (one- and two-stage), Seg2D, the painting ops,
    aligned_scatter and nearest_neighbor: without a device they need CUDA
    (numpy inputs go to CUDA); asked for the CPU, or given CPU tensors,
    they run there."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    from d3d_tpu_torch.models import (CenterPoint, CenterPointRefine,
                                      RefineConfig, Seg2D, Seg2DConfig,
                                      make_centerpoint_detector,
                                      make_segmenter)
    from d3d_tpu_torch.ops.painting import paint_points, paint_points_multi
    from d3d_tpu_torch.ops.point import aligned_scatter, nearest_neighbor

    cfg = presets.centerpoint_nuscenes(
        dtype="float32", bounds=(-3.2, 3.2, -3.2, 3.2, -3.0, 1.0),
        grid=(16, 16), max_pillars=32, max_points_per_pillar=4,
        pfn_features=8, backbone_channels=(8,), backbone_blocks=(1,),
        upsample_channels=8, head_channels=8, top_k=4)
    rcfg = RefineConfig(grid_points=2, hidden=(8,))
    scfg = Seg2DConfig(image_size=(16, 16), channels=(4, 8))
    pts = np.random.default_rng(0).uniform(-3, 3, (200, 4)).astype(
        np.float32)
    k, ext = np.eye(3, dtype=np.float32), np.eye(4, dtype=np.float32)
    for make in (lambda: CenterPoint(cfg), lambda: Seg2D(scfg),
                 lambda: CenterPointRefine(rcfg, 8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    model = CenterPoint(cfg, return_feat=True, device="cpu")
    refine = CenterPointRefine(rcfg, 8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_centerpoint_detector(model, None, cfg, cfg, ["Car"],
                                  refine=(refine, None, rcfg))
    with pytest.raises(RuntimeError, match="CUDA"):
        make_segmenter(Seg2D(scfg, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA"):
        paint_points(pts, np.zeros((4, 4, 2), np.float32), k, ext)
    with pytest.raises(RuntimeError, match="CUDA"):
        paint_points_multi(pts, np.zeros((1, 4, 4, 2), np.float32), k[None],
                           ext[None])
    with pytest.raises(RuntimeError, match="CUDA"):
        aligned_scatter(np.zeros((3, 3), np.float32),
                        np.zeros((1, 2, 4, 4), np.float32))
    with pytest.raises(RuntimeError, match="CUDA"):
        nearest_neighbor(pts[:, :3], pts[:8, :3])
    # asked for the CPU, or given CPU tensors, they run there
    det = make_centerpoint_detector(model, None, cfg, cfg, ["Car"],
                                    refine=(refine, None, rcfg),
                                    device="cpu")
    out = det.device_fn(pts)
    assert len(out) == 5 and out[0].device.type == "cpu"
    seg = make_segmenter(Seg2D(scfg, device="cpu"), device="cpu")
    assert seg(np.zeros((16, 16, 3), np.float32)).shape == (16, 16, 4)
    t = torch.from_numpy(pts)
    assert paint_points(t, torch.zeros((4, 4, 2)), torch.eye(3),
                        torch.eye(4)).shape == (200, 6)
    assert aligned_scatter(np.zeros((3, 3), np.float32),
                           torch.zeros((1, 2, 4, 4))).shape == (3, 2)
    assert nearest_neighbor(pts[:, :3], pts[:8, :3], device="cpu")[1].shape \
        == (200,)


def test_camera_and_segmentation_families_need_cuda_or_an_explicit_cpu():
    """Mono3D, BEVSeg, the segmentation evaluators' device functions and
    the KITTI-360 loader are among the modules the import checks walk;
    their entry points need CUDA unless given the CPU, and importing the
    loader imports neither ``sortedcontainers`` nor PyYAML nor PIL."""
    assert {"d3d_tpu_torch.models.mono3d", "d3d_tpu_torch.models.bevseg",
            "d3d_tpu_torch.dataset.kitti360",
            "d3d_tpu_torch.dataset.kitti360.loader",
            "d3d_tpu_torch.dataset.kitti360.utils"} <= set(_submodules())
    code = ("import sys\n"
            "import d3d_tpu_torch.dataset.kitti360\n"
            "bad = [m for m in ('sortedcontainers', 'yaml', 'PIL')\n"
            "       if m in sys.modules]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = run_python(code, ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    from d3d_tpu_torch.benchmarks import SegmentationEvaluator
    from d3d_tpu_torch.benchmarks_device import (device_panoptic_stats,
                                                 device_semantic_stats)
    from d3d_tpu_torch.models import (BEVSeg, Mono3D, make_mono3d_detector,
                                      make_panoptic_predictor,
                                      make_predictor)

    mcfg = presets.mono3d_kitti(dtype="float32", image_size=(32, 32),
                                backbone_channels=(4, 8), head_channels=4,
                                top_k=4)
    bcfg = presets.bevseg_semantickitti(
        dtype="float32", bounds=(0.0, 6.4, -3.2, 3.2, -3.0, 1.0),
        grid=(16, 16), max_pillars=32, max_points_per_pillar=4,
        pfn_features=4, enc_channels=(4, 8), enc_blocks=(1, 1),
        dec_channels=4, num_classes=3)
    for make in (lambda: Mono3D(mcfg), lambda: BEVSeg(bcfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    pcfg = dataclasses.replace(bcfg, panoptic=True, thing_classes=(1,))
    mono, seg = Mono3D(mcfg, device="cpu"), BEVSeg(bcfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mono3d_detector(mono, None, mcfg, ["Car"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_predictor(seg, bcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_panoptic_predictor(BEVSeg(pcfg, device="cpu"), pcfg)
    ev = SegmentationEvaluator([1, 2])
    labels = [np.array([1, 2], np.uint8)]
    ids = [np.zeros(2, np.uint16)]
    with pytest.raises(RuntimeError, match="CUDA"):
        device_semantic_stats(ev, labels, labels)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_panoptic_stats(ev, labels, labels, ids, ids)
    # asked for the CPU, they run there
    k = np.array([[20.0, 0, 16], [0, 20.0, 16], [0, 0, 1]], np.float32)
    boxes, scores, _ = make_mono3d_detector(
        mono, None, mcfg, ["Car"], device="cpu").device_fn(
            np.zeros((32, 32, 3), np.float32), k)
    assert boxes.device.type == "cpu" and boxes.shape == (4, 7)
    pts = np.random.default_rng(0).uniform(0, 3, (50, 4)).astype(np.float32)
    assert make_predictor(seg, bcfg, device="cpu")(None, pts).shape == (50,)
    assert device_semantic_stats(ev, labels, labels, device="cpu").tp[1] == 1


def test_rank_worker_loads_no_jax():
    """The multi-rank tests' worker entry imports only the port: every
    case function's imports, run in a fresh process."""
    code = (
        "import sys, inspect\n"
        "sys.path.insert(0, 'tests')\n"
        "import _torch_dist_worker as w\n"
        "import d3d_tpu_torch.parallel, d3d_tpu_torch.benchmarks_device\n"
        "import d3d_tpu_torch.models.sst\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad, sorted(w.CASES))\n"
        "sys.exit(1 if bad else 0)\n")
    res = run_python(code, ROOT)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_mesh_needs_cuda():
    """A mesh's ``device_type`` defaults to CUDA (NCCL) and raises without
    it; gloo meshes on the CPU are asked for with ``device_type="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    from d3d_tpu_torch.parallel.mesh import _mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        _mesh("cuda", [0], (1,), ("dp",))


def test_new_modules_read_nothing_of_the_jax_package(tmp_path):
    """The sequence loaders, ``io``, ``vis`` and ``native`` are among the
    modules the import checks walk, and in a fresh process that imports
    every module of the port, builds the native oracle from scratch and
    reads a KITTI tracking sequence, no file under ``d3d_tpu/`` is opened
    and no command names one (an audit hook sees every ``open`` and
    ``subprocess.Popen``)."""
    assert {"d3d_tpu_torch.dataset.kitti.tracking",
            "d3d_tpu_torch.dataset.kitti.raw",
            "d3d_tpu_torch.dataset.kitti.odometry",
            "d3d_tpu_torch.dataset.waymo.loader",
            "d3d_tpu_torch.dataset.cadc.loader", "d3d_tpu_torch.io.hdf5",
            "d3d_tpu_torch.io.ros", "d3d_tpu_torch.vis.pcl",
            "d3d_tpu_torch.native"} <= set(_submodules())
    code = (
        "import importlib, sys\n"
        f"ref = {str(ROOT / 'd3d_tpu')!r}\n"
        "seen = []\n"
        "def hook(event, args):\n"
        "    if event in ('open', 'subprocess.Popen'):\n"
        "        if ref + '/' in repr(args):\n"
        "            seen.append((event, repr(args)[:200]))\n"
        "sys.addaudithook(hook)\n"
        f"for m in ['d3d_tpu_torch'] + {_submodules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import d3d_tpu_torch.native as n\n"
        f"n.BUILD_DIR = __import__('pathlib').Path({str(tmp_path)!r})\n"
        "assert n.available(), n._BUILD_ERROR\n"
        "sys.path.insert(0, 'tests')\n"
        "import kitti_fixture as kfx\n"
        "from d3d_tpu_torch.dataset.kitti import KittiTrackingLoader\n"
        f"kfx.build_tracking({str(tmp_path / 'trk')!r}, seqs=(0,),"
        " frames_per_seq=2)\n"
        f"ld = KittiTrackingLoader({str(tmp_path / 'trk')!r},"
        " trainval_split=1)\n"
        "ld.lidar_data(0), ld.annotation_3dobject(1), ld.pose(1)\n"
        "print(seen)\n"
        "sys.exit(1 if seen else 0)\n")
    res = run_python(code, ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    assert list(tmp_path.glob("libd3dhost-*.so"))

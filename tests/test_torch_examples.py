"""The port's examples (``examples/torch_*.py``) against the JAX
package's originals (``examples/*.py``), one case each, on the CPU.

The originals run as shipped (their ``main`` or ``run``); what they do
not print exactly is read where it is made: their trackers' frames, their
models' flax init (``Module.init`` recorded; handed to the port through
``models/convert.py``), their first training step's loss and
``tracker_report``'s tracks. Each port example takes the same numpy
draws in the same order. Tolerances, case by case:

* evaluation counters exact, AP and the accuracy fields within 1e-6 (the
  f32 accumulation bound of ``tests/test_torch_benchmarks_official.py``);
* tracking metrics and track ids exact;
* accumulated clouds bit-equal; the viewer's clouds and drawing calls
  equal;
* ``serve_tracking``: live tracks exact, reported positions and
  velocities within 1e-5;
* ``train_mono3d``: step-1 loss within 1e-4 (relative); the AP line;
* ``train_pointpillars --tiny`` (bfloat16): step-1 loss within
  ``bf16_bound(5, 9 * 64)`` of ``tests/test_torch_pointpillars_train.py``
  (relative), the augmentation given the JAX example's draws; a second
  run resumes from the checkpoint directory.
"""

import builtins
import importlib
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from _limits import time_limit

import jax

import dataset_fixtures as dfx
from test_torch_io_vis import _Vis
from test_torch_pointpillars_train import bf16_bound

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


@pytest.fixture
def examples(monkeypatch):
    """``load(name)``: an example module by file name, imported fresh."""
    monkeypatch.syspath_prepend(str(EXAMPLES))

    def load(name):
        sys.modules.pop(name, None)
        return importlib.import_module(name)

    yield load


def _recorded_init(monkeypatch, cls):
    """Record the flax variables ``cls.init`` returns (numpy leaves)."""
    seen = []
    orig = cls.init

    def init(self, *args, **kw):
        out = orig(self, *args, **kw)
        seen.append(jax.tree.map(np.asarray, out))
        return out

    monkeypatch.setattr(cls, "init", init)
    return seen


def _same_json(got, want, path=""):
    """Nested metrics equal: ints and None exact, floats within 1e-6."""
    assert type(got) is type(want) or {type(got), type(want)} <= {int,
                                                                  float}, \
        path
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _same_json(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, float):
        assert abs(got - want) <= 1e-6, (path, got, want)
    else:
        assert got == want, path


def test_evaluate_detections(examples, monkeypatch, capsys):
    jax_demo = examples("evaluate_detections")
    monkeypatch.setattr(sys, "argv",
                        ["evaluate_detections.py", "--frames", "16"])
    jax_demo.main()
    out = capsys.readouterr().out
    want = json.loads(out[out.rindex("\n{\n") + 1:])
    ev = examples("torch_evaluate_detections").main(
        ["--frames", "16", "--device", "cpu"])
    got = ev.metrics_dict()
    _same_json(got, want)
    assert got["Car"]["gt"] > 0 and got["Pedestrian"]["tp"] > 0


def test_track_sequence(examples, monkeypatch):
    from d3d_tpu.benchmarks import TrackingEvaluator
    from d3d_tpu.dataset.kitti.utils import KittiObjectClass as JK

    jax_demo = examples("track_sequence")
    want = {}

    def score(name, gts, trks):
        ev = TrackingEvaluator([JK.Car], [0.5])
        for g, d in zip(gts, trks):
            ev.add_stats(ev.calc_stats(g, d))
        at = 0.45
        want[name] = dict(
            mota=ev.mota(at)[JK.Car], amotp=ev.amotp()[JK.Car],
            switches=ev.id_switches(at)[JK.Car],
            fragments=ev.fragments(at)[JK.Car], amota=ev.amota()[JK.Car],
            tids=[[int(o.tid) for o in f] for f in trks])

    monkeypatch.setattr(jax_demo, "score", score)
    monkeypatch.setattr(sys, "argv", ["track_sequence.py", "--frames", "10",
                                      "--objects", "4"])
    jax_demo.main()
    got = examples("torch_track_sequence").main(
        ["--frames", "10", "--objects", "4", "--device", "cpu"])
    assert set(got) == set(want) == {"CenterTracker", "VanillaTracker",
                                     "DeviceTracker"}
    for name in want:
        for k, v in want[name].items():
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(got[name][k]), (name, k)
            else:
                assert got[name][k] == v, (name, k)
        assert sum(map(len, got[name]["tids"])) > 0


def test_kitti_raw_pipeline(examples, tmp_path):
    """tests/test_examples.py's two cases on the port, and the accumulated
    clouds bit-equal to the original's."""
    from d3d_tpu.dataset.kitti import KittiRawLoader as JLoader
    from d3d_tpu_torch.dataset.kitti import KittiRawLoader as TLoader
    from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass

    jax_demo = examples("kitti_raw_pipeline")
    demo = examples("torch_kitti_raw_pipeline")
    dfx.build_kitti_raw(tmp_path, nframes=3)
    ev = demo.run(tmp_path, device="cpu")
    assert ev.mota()[KittiObjectClass.Car] == 1.0
    assert all(v == 0 for v in ev.id_switches().values())

    kw = dict(inzip=False, phase="training", trainval_split=1)
    jl, tl = JLoader(tmp_path, **kw), TLoader(tmp_path, **kw)
    scene = tl.sequence_ids[0]
    n = len(np.asarray(tl.lidar_data((scene, 0))))
    for upto in range(3):
        cloud = demo.accumulate_frames(tl, scene, upto, nframes=3)
        np.testing.assert_array_equal(
            cloud, jax_demo.accumulate_frames(jl, scene, upto, nframes=3))
    assert cloud.shape == (3 * n, 5)
    ages = np.unique(cloud[:, 4])
    assert len(ages) == 3 and ages.min() == 0.0


def _nuscenes_tree(root):
    """``tests/test_dataset.py``'s nuScenes tables with three sweeps a
    keyframe, converted by the JAX converter."""
    import test_dataset
    from d3d_tpu.dataset.nuscenes import converter
    from test_torch_dataset_nuscenes import SWEEPS, _add_sweeps

    raw = root / "raw"
    raw.mkdir()
    test_dataset.TestNuscenesConverter._raw(None, raw)
    _add_sweeps(raw, np.random.default_rng(3))
    converter.convert_dataset_inpath(raw, root / "tree",
                                     store_inter=SWEEPS)
    return root / "tree"


def _raw_zipped(root):
    """The KITTI raw fixture zipped into its documented archives (the
    viewer opens the loader with its default ``inzip=True``)."""
    from test_torch_dataset_loaders import _zip_raw

    seq = dfx.build_kitti_raw(root, nframes=3)
    _zip_raw(root, seq)
    return seq


@pytest.mark.parametrize("kind, inter", [("kitti-raw", 0), ("waymo", 0),
                                         ("nuscenes", 3)])
def test_dataset_viewer(examples, monkeypatch, tmp_path, kind, inter):
    """Under a recording pcl stand-in, every frame's cloud and drawing
    calls (the boxes) equal what the original hands its viewer."""
    if kind == "kitti-raw":
        root = tmp_path / "raw"
        scene = _raw_zipped(root)
    elif kind == "waymo":
        root = tmp_path / "waymo"
        dfx.build_waymo(root, nframes=3)
        scene = "1234567890_000_000_1234567890_000"
    else:
        root = _nuscenes_tree(tmp_path)
        scene = None

    def recorded(viewer, run):
        clouds, views = [], []
        pcl = types.ModuleType("pcl")

        def visualizer():
            views.append(_Vis())
            return views[-1]

        pcl.Visualizer = visualizer
        pcl.create_xyzi = lambda a: clouds.append(np.array(a)) or "cloud"
        monkeypatch.setitem(sys.modules, "pcl", pcl)
        run(viewer)
        return clouds, [v.calls for v in views]

    jax_demo = examples("dataset_viewer")
    demo = examples("torch_dataset_viewer")
    if scene is None:
        scene = demo.open_loader(root, kind).sequence_ids[0]
    monkeypatch.setattr(builtins, "input", lambda prompt: "")
    want = recorded(jax_demo, lambda m: m.dataset_visualize_pcl(
        root, kind, scene, inter))
    got = recorded(demo, lambda m: m.dataset_visualize_pcl(
        root, kind, scene, inter, device="cpu"))
    assert len(got[0]) == len(want[0]) >= 2
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    assert got[1] == want[1]
    kinds = [c[0] for calls in got[1] for c in calls]
    assert "addCube" in kinds and kinds.count("spin") == len(got[0])


def test_dataset_viewer_quits_and_needs_cuda(examples, tmp_path):
    demo = examples("torch_dataset_viewer")
    dfx.build_waymo(tmp_path, nframes=3)
    scene = "1234567890_000_000_1234567890_000"
    seen = []
    demo.dataset_visualize_pcl(
        tmp_path, "waymo", scene, device="cpu",
        render=lambda cloud, *rest: seen.append(len(cloud)),
        ask=lambda prompt: "q")
    assert len(seen) == 1 and seen[0] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            demo.dataset_visualize_pcl(tmp_path, "waymo", scene,
                                       render=None)


def test_serve_tracking(examples, monkeypatch, capsys):
    import d3d_tpu.tracking.device_tracker as JT
    from d3d_tpu.models.centerpoint import CenterPoint

    inits = _recorded_init(monkeypatch, CenterPoint)
    reports = []
    orig_report = JT.tracker_report

    def report(*args, **kw):
        reports.append(orig_report(*args, **kw))
        return reports[-1]

    monkeypatch.setattr(JT, "tracker_report", report)
    jax_demo = examples("serve_tracking")
    monkeypatch.setattr(sys, "argv", ["serve_tracking.py", "--frames", "3"])
    jax_demo.main()
    out = capsys.readouterr().out
    want_live = [int(line.split("live tracks:")[1].split()[0])
                 for line in out.splitlines() if line.startswith("frame ")]
    want_export = int(out.split("reloaded step ran, ")[1].split()[0])

    got = examples("torch_serve_tracking").run(3, device="cpu",
                                               weights=inits[0])
    assert got["live"] == want_live and len(want_live) == 3
    want = reports[0]
    assert [r[0] for r in got["report"]] == [int(o.tid) for o in want]
    for (_, pos, vel, score), o in zip(got["report"], want):
        np.testing.assert_allclose(pos, np.asarray(o.position), atol=1e-5)
        np.testing.assert_allclose(vel, np.asarray(o.velocity), atol=1e-5)
        np.testing.assert_allclose(score, o.tag_top_score, atol=1e-5)
    # the round trip ran: the artifact was written and the reloaded step
    # advanced the same state by one frame
    assert got["export_bytes"] > 0
    assert got["export_live"] == want_export


def test_train_mono3d(examples, monkeypatch, capsys):
    import d3d_tpu.models.mono3d as JM

    inits = _recorded_init(monkeypatch, JM.Mono3D)
    losses = []
    orig_step = JM.make_train_step

    def make_train_step(*args, **kw):
        inner = orig_step(*args, **kw)

        def step(*a):
            out = inner(*a)
            jax.debug.callback(lambda t: losses.append(float(t)),
                               out[3]["total"])
            return out
        return step

    monkeypatch.setattr(JM, "make_train_step", make_train_step)
    jax_demo = examples("train_mono3d")
    monkeypatch.setattr(sys, "argv", ["train_mono3d.py", "--steps", "3"])
    jax_demo.main()
    assert "AP@4m center distance" in capsys.readouterr().out

    got = examples("torch_train_mono3d").run(3, device="cpu",
                                             weights=inits[0])
    assert len(got["losses"]) == 3 and len(losses) == 3
    np.testing.assert_allclose(got["losses"][0]["total"], losses[0],
                               rtol=1e-4)
    assert "AP@4m center distance" in capsys.readouterr().out
    assert np.isfinite(got["ap"])


def _jax_draws(key):
    """The JAX ``global_augment``'s draws from ``key``: flip, theta,
    scale, shift (float32)."""
    kf, kr, ks, kt = jax.random.split(key, 4)
    dt = np.float32
    return (np.array(jax.random.bernoulli(kf, 0.5)),
            np.array(jax.random.uniform(kr, (), dt, -0.7854, 0.7854)),
            np.array(jax.random.uniform(ks, (), dt, 0.95, 1.05)),
            np.array(jax.random.normal(kt, (3,), dt) * 0.2))


@time_limit(120)
def test_train_pointpillars(examples, monkeypatch, tmp_path):
    import d3d_tpu.models.pointpillars as JPP
    from d3d_tpu_torch.augment import _global_transform

    inits = _recorded_init(monkeypatch, JPP.PointPillars)
    jax_demo = examples("train_pointpillars")
    want = []

    class Trainer(jax_demo.Trainer):
        def __init__(self, step_fn, **kw):
            def step(*args):
                out = step_fn(*args)
                want.append(float(out[3]["total"]))
                return out
            super().__init__(step, **kw)

    monkeypatch.setattr(jax_demo, "Trainer", Trainer)
    monkeypatch.setattr(sys, "argv", [
        "train_pointpillars.py", "--tiny", "--steps", "3",
        "--ckpt-dir", str(tmp_path / "jax")])
    jax_demo.main()
    assert len(want) == 3

    # the port's augmentation with the JAX example's draws: its key split
    # once a frame
    demo = examples("torch_train_pointpillars")
    key = [jax.random.PRNGKey(0)]

    def augment(generator, points, boxes):
        key[0], k = jax.random.split(key[0])
        return _global_transform(points, boxes, *(
            torch.as_tensor(d) for d in _jax_draws(k)))

    monkeypatch.setattr(demo, "global_augment", augment)
    # the JAX example rounds its batch of 2 up to its 4-way dp axis
    kw = dict(tiny=True, batch=4, ckpt_dir=str(tmp_path / "port"),
              device="cpu", weights=inits[0])
    got = demo.run(steps=3, **kw)
    assert (got["start"], got["step"], len(got["losses"])) == (0, 3, 3)
    bound = bf16_bound(5, 9 * 64)
    assert abs(got["losses"][0] - want[0]) <= bound * abs(want[0])
    assert np.isfinite(got["losses"]).all()
    assert not torch.distributed.is_initialized()

    resumed = demo.run(steps=2, **kw)
    assert (resumed["start"], resumed["step"]) == (3, 5)
    assert np.isfinite(resumed["losses"]).all()


@pytest.mark.parametrize("name, argv", [
    ("torch_evaluate_detections", ["--frames", "2"]),
    ("torch_track_sequence", ["--frames", "2"]),
    ("torch_serve_tracking", ["--frames", "1"]),
    ("torch_train_mono3d", ["--steps", "1"]),
    ("torch_train_pointpillars", ["--tiny", "--steps", "1"]),
])
def test_examples_need_cuda_or_an_explicit_cpu(examples, name, argv):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        examples(name).main(argv)

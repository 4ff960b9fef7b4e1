"""The port's KITTI object loader (``d3d_tpu_torch.dataset.kitti``) against
the JAX package's on the synthetic frames of ``tests/kitti_fixture.py``,
unzipped and zipped: the same frames, points, labels (velo-frame boxes
within 1e-12), raw and projective calibration, split and submission
text."""

import io

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import kitti_fixture as fx
from d3d_tpu.dataset import base as JB
from d3d_tpu.dataset.kitti import KittiObjectLoader as JLoader

from d3d_tpu_torch.dataset import base as TB
from d3d_tpu_torch.dataset.kitti import KittiObjectClass as TK
from d3d_tpu_torch.dataset.kitti import KittiObjectLoader as TLoader
from d3d_tpu_torch.dataset.kitti import object as tobject
from d3d_tpu_torch.dataset.zip import PatchedZipFile

NFRAMES = 4


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_port")
    zroot = tmp_path_factory.mktemp("kitti_port_zip")
    fx.build_zipped(root, zroot, nframes=NFRAMES)
    return root, zroot


@pytest.fixture(scope="module", params=["unzipped", "zipped"])
def loaders(request, roots):
    root, zroot = roots
    path, inzip = (root, False) if request.param == "unzipped" else (zroot,
                                                                     True)
    return (JLoader(path, inzip=inzip, trainval_split=1.0),
            TLoader(path, inzip=inzip, trainval_split=1.0))


def test_frames_and_points(loaders):
    jl, tl = loaders
    assert len(tl) == len(jl) == NFRAMES
    for i in range(NFRAMES):
        assert tl.identity(i) == jl.identity(i)
        np.testing.assert_array_equal(tl.lidar_data(i), jl.lidar_data(i))
        rec = tl.lidar_data(i, formatted=True)
        np.testing.assert_array_equal(rec.intensity, jl.lidar_data(i)[:, 3])


def test_labels_match(loaders):
    jl, tl = loaders
    for i in range(NFRAMES):
        want, got = jl.annotation_3dobject(i), tl.annotation_3dobject(i)
        assert got.frame == want.frame == "velo" and len(got) == len(want)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.position, w.position, rtol=0,
                                       atol=1e-12)
            np.testing.assert_allclose(g.dimension, w.dimension, rtol=0,
                                       atol=1e-12)
            assert abs(g.yaw - w.yaw) <= 1e-12
            assert g.tag_top.name == w.tag_top.name
            assert g.tag.scores == w.tag.scores and g.aux == w.aux
        np.testing.assert_array_equal(got.dontcare, want.dontcare)
        raw_w, raw_g = (ld.annotation_3dobject(i, raw=True)
                        for ld in (jl, tl))
        assert [[r[0].name] + r[1:] for r in raw_g] == \
            [[r[0].name] + r[1:] for r in raw_w]


def test_calibration_matches(loaders):
    jl, tl = loaders
    for i in range(NFRAMES):
        want, got = (ld.calibration_data(i, raw=True) for ld in (jl, tl))
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    want, got = jl.calibration_data(0), tl.calibration_data(0)
    assert got.frames == want.frames
    for frame in want.frames:
        np.testing.assert_array_equal(got.get_extrinsic(frame, "velo"),
                                      want.get_extrinsic(frame, "velo"))
        if want.intrinsics[frame] is not None:
            np.testing.assert_array_equal(got.intrinsics[frame],
                                          want.intrinsics[frame])


def test_detection_output_text_matches(loaders):
    """The submission text of each frame's labels, written back through the
    camera projection, equals the JAX loader's."""
    jl, tl = loaders
    for i in range(NFRAMES):
        texts = []
        for ld in (jl, tl):
            buf = io.BytesIO()
            ld.dump_detection_output(i, ld.annotation_3dobject(i), buf)
            texts.append(buf.getvalue())
        assert texts[1] == texts[0] and texts[1].count(b"\n") >= 1


@pytest.mark.parametrize("random", [False, 5, "r"])
def test_split_trainval_matches(random):
    for phase in ("training", "validation", "testing"):
        np.testing.assert_array_equal(
            TB.split_trainval(phase, 23, 0.7, random),
            JB.split_trainval(phase, 23, 0.7, random))
    np.testing.assert_array_equal(
        TB.split_trainval_seq("validation", {"a": 4, "b": 3, "c": 5}, 0.5,
                              random, by_seq=True),
        JB.split_trainval_seq("validation", {"a": 4, "b": 3, "c": 5}, 0.5,
                              random, by_seq=True))


def test_split_trainval_fresh_shuffle():
    """``trainval_random=True`` draws a fresh permutation on every call, on
    either side, so only its content is comparable: a permutation of the
    frames, cut where the JAX function cuts."""
    for phase in ("training", "validation", "testing"):
        got = TB.split_trainval(phase, 23, 0.7, True)
        want = JB.split_trainval(phase, 23, 0.7, True)
        assert len(got) == len(want) and len(set(got.tolist())) == len(got)
        assert set(got.tolist()) <= set(range(23))
    assert sorted(TB.split_trainval("testing", 23, 0.7, True).tolist()) == \
        list(range(23))


def test_zip_selective_parse(roots):
    _, zroot = roots
    name = "training/label_2/000002.txt"
    with PatchedZipFile(zroot / "data_object_label_2.zip",
                        to_extract=name) as zf:
        assert zf.namelist() == [name]
        assert zf.read(name).startswith(b"Car")


def test_parse_label_round_trip(roots, tmp_path):
    """A label parsed in velo coordinates and dumped as a Target3DArray
    loads back equal (the port's parse_detection_output path)."""
    root, _ = roots
    tl = TLoader(root, trainval_split=1.0)
    label = tobject.load_label(root, "training/label_2/000001.txt")
    objs = tobject.parse_label(label, tl.calibration_data(1, raw=True))
    objs.dump(tmp_path / "1.objs")
    back = type(objs).load(tmp_path / "1.objs")
    np.testing.assert_allclose(back.to_numpy(), objs.to_numpy(), atol=1e-6)
    assert [o.tag_top for o in back] == [TK.Car, TK.Pedestrian]


def test_base_helpers_match(loaders):
    """The frame-window and sensor fan-out decorators, the windowed frame
    map and the single-thread NumberPool behave as the JAX module's."""
    jl, tl = loaders
    np.testing.assert_array_equal(tl.lidar_data(0, "velo"),
                                  jl.lidar_data(0, names="velo"))
    assert TB.check_frames(None, ["a", "b"]) == JB.check_frames(None,
                                                                ["a", "b"])
    assert TB.check_frames("b", ["a", "b"]) == (True, ["b"])
    with pytest.raises(ValueError):
        TB.check_frames("c", ["a", "b"])
    counts = {"A": 3, "B": 10}
    for i in range(5):
        assert TB.locate_windowed_frame(i, counts, 5) == \
            JB.locate_windowed_frame(i, counts, 5)
    with pytest.raises(KeyError):
        TB.locate_windowed_frame(5, counts, 5)

    class Seq:
        nframes = 2

        def _locate_frame(self, idx):
            return "seq0", idx

        @TB.expand_idx
        def data(self, idx):
            return idx

    s = Seq()
    assert s.data(3) == [("seq0", 3), ("seq0", 4), ("seq0", 5)]
    assert s.data(3, bypass=True) == ("seq0", 3)
    assert TB.NumberPool(0).apply_async(lambda n, x: x * 2, (21,)) == 42

"""The port's KITTI-360 loader (``dataset/kitti360``) against the JAX
package's on ``tests/dataset_fixtures.build_kitti360``'s layout (one
static and one dynamic semantic window over four frames): sizes and
``_locate_frame`` for every index (several sequences, windowed and
shuffled splits: the port bisects where the JAX loader walks a
``SortedDict``), the lidar, sick and camera data, the calibration, the
boxes, the window points, the per-frame and intermediate semantic labels
after the transfer (run by the port's ``nearest_neighbor`` on the CPU),
the merge of overlapping windows and the cache guards
(tests/test_dataset_loaders.py's KITTI-360 checks).

The label transfer writes its cache under the dataset root, so each
package reads its own copy of the fixture. Arrays are held exactly;
poses and boxes within 1e-9 (both are float64 numpy and scipy)."""

import shutil

import numpy as np
import pytest

import dataset_fixtures as dfx
from d3d_tpu.dataset.kitti360 import KITTI360Loader as JLoader

from d3d_tpu_torch.dataset.kitti360 import Kitti360Class, KITTI360Loader
from d3d_tpu_torch.dataset.kitti360.utils import id2label

SEQ = dfx._K360_SEQ


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("k360")
    dfx.build_kitti360(base / "jax", nframes=4)
    shutil.copytree(base / "jax", base / "torch")
    return base / "jax", base / "torch"


@pytest.fixture(scope="module")
def pair(roots):
    return (JLoader(roots[0], trainval_split=1),
            KITTI360Loader(roots[1], trainval_split=1, device="cpu"))


def test_sizes_and_every_index(pair):
    j, t = pair
    assert len(t) == len(j) == 4
    assert t.sequence_ids == j.sequence_ids == [SEQ]
    assert t.sequence_sizes == j.sequence_sizes
    assert [t._locate_frame(i) for i in range(len(t))] == \
        [j._locate_frame(i) for i in range(len(j))]
    assert t.identity(2) == j.identity(2)


@pytest.mark.parametrize("nframes,random", [(0, False), (1, 3), (2, "r")])
def test_locate_frame_over_sequences(tmp_path, nframes, random):
    """Three sequences of 4, 1 and 3 velodyne frames: with windows of
    ``nframes`` (the one-frame sequence then holds none) and shuffled or
    reversed splits, ``_locate_frame`` of every index equals the JAX
    loader's, and one past the end raises KeyError as there."""
    dfx.build_kitti360(tmp_path, nframes=4)
    raw = tmp_path / "data_3d_raw"
    for name, count in (("2013_05_28_drive_0002_sync", 1),
                        ("2013_05_28_drive_0003_sync", 3)):
        data = raw / name / "velodyne_points" / "data"
        data.mkdir(parents=True)
        for f in range(count):
            shutil.copy(raw / SEQ / "velodyne_points" / "data"
                        / ("%010d.bin" % f), data)
    kw = dict(trainval_split=1, trainval_random=random, nframes=nframes)
    j, t = JLoader(tmp_path, **kw), KITTI360Loader(tmp_path, **kw)
    assert t.sequence_sizes == j.sequence_sizes and len(t) == len(j)
    assert [t._locate_frame(i) for i in range(len(t))] == \
        [j._locate_frame(i) for i in range(len(j))]
    t.frames = np.append(t.frames, sum(max(v - nframes, 0) for v in
                                       t.sequence_sizes.values()))
    with pytest.raises(KeyError):
        t._locate_frame(len(t) - 1)


def test_data_calib_and_poses(pair):
    """Lidar scans and sick items (index, timestamp, interpolated pose,
    data) equal; camera images of each kind; every calibration frame's
    extrinsic and intrinsic equal, the MEI mirror coefficient included;
    poses and timestamps equal."""
    j, t = pair
    for i in range(4):
        np.testing.assert_array_equal(t.lidar_data(i), j.lidar_data(i))
        ji = j.intermediate_data(i, names="sick", report_semantic=False)
        ti = t.intermediate_data(i, names="sick", report_semantic=False)
        assert [x.index for x in ti] == [x.index for x in ji]
        for a, b in zip(ti, ji):
            assert a.timestamp == b.timestamp
            np.testing.assert_array_equal(a.data, b.data)
            np.testing.assert_allclose(a.pose.position, b.pose.position,
                                       atol=1e-9)
        assert t.timestamp(i) == j.timestamp(i)
        np.testing.assert_allclose(t.pose(i).position, j.pose(i).position,
                                   atol=1e-9)
    assert t.camera_data(0, names="cam1").size == (1408, 376)
    assert t.camera_data(0, names="cam3").size == (1400, 1400)
    tc, jc = t.calibration_data(0), j.calibration_data(0)
    assert set(tc.frames) == set(jc.frames)
    for frame in ("cam1", "cam2", "cam3", "cam4", "sick"):
        np.testing.assert_allclose(
            tc.get_extrinsic(frame_from=frame, frame_to="velo"),
            jc.get_extrinsic(frame_from=frame, frame_to="velo"), atol=1e-12)
    for cam in ("cam1", "cam2", "cam3", "cam4"):
        np.testing.assert_array_equal(tc.intrinsics[cam], jc.intrinsics[cam])
        a, b = tc.intrinsics_meta[cam], jc.intrinsics_meta[cam]
        assert a.width == b.width and a.height == b.height
        np.testing.assert_array_equal(np.asarray(a.distort_coeffs),
                                      np.asarray(b.distort_coeffs))
        assert a.mirror_coeff == b.mirror_coeff or np.isnan(
            a.mirror_coeff) and np.isnan(b.mirror_coeff)
    assert tc.intrinsics_meta["cam3"].mirror_coeff == pytest.approx(2.21)


def test_boxes_and_window_points(pair):
    """annotation_3dobject of every frame (the dynamic pedestrian only at
    frame 1), raw and posed: positions, sizes, orientations, tags and
    track ids equal; the static and dynamic window points equal."""
    j, t = pair
    for i in range(4):
        a, b = t.annotation_3dobject(i), j.annotation_3dobject(i)
        assert len(a) == len(b) and a.frame == b.frame == "pose"
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.position, y.position, atol=1e-9)
            np.testing.assert_allclose(x.dimension, y.dimension, atol=1e-9)
            assert (x.orientation.inv() * y.orientation).magnitude() < 1e-9
            assert x.tag_top == Kitti360Class[y.tag_top.name]
            assert x.tid == y.tid
        assert len(t.annotation_3dobject(i, raw=True)) == len(b)
    assert len(t.annotation_3dobject(1)) == 2
    for dyn, frame in ((False, 0), (True, 1)):
        a = t.semantic_window_points(frame, dynamic=dyn)
        b = j.semantic_window_points(frame, dynamic=dyn)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_semantic_labels_after_transfer(pair):
    """annotation_3dpoints of every frame and the labelled intermediate
    sick scans equal the JAX loader's field by field (rgb, semantic,
    instance, visible), the classes car and road; the cache marker is
    written."""
    j, t = pair
    for i in range(4):
        a, b = t.annotation_3dpoints(i), j.annotation_3dpoints(i)
        for k in ("rgb", "semantic", "instance", "visible"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
        ai = t.intermediate_data(i, names="sick")
        bi = j.intermediate_data(i, names="sick")
        for x, y in zip(ai, bi):
            for k in ("semantic", "instance", "visible"):
                np.testing.assert_array_equal(x[k], y[k])
    assert set(np.unique(t.annotation_3dpoints(0).semantic)) <= {
        int(Kitti360Class.car), int(Kitti360Class.road)}
    assert (t.base_path / "data_3d_semantics" / SEQ
            / ".labels_complete").exists()


def test_nearest_across_windows(tmp_path):
    """Two overlapping static windows and the dynamic one: every frame's
    labels equal the JAX loader's on the same layout, and both the slab's
    building and the road occur (tests/test_dataset_loaders.py's merge
    check)."""
    rng = np.random.default_rng(3)
    slab = rng.uniform([0, -10, 0.9], [20, 10, 1.1], (400, 3))
    for name in ("jax", "torch"):
        dfx.build_kitti360(tmp_path / name, nframes=4)
        dfx._write_ply(tmp_path / name / "data_3d_semantics" / SEQ
                       / "static" / ("%010d_%010d.ply" % (1, 3)),
                       slab, np.full(400, 11), np.zeros(400, int),
                       np.full((400, 3), 7, np.uint8))
    j = JLoader(tmp_path / "jax", trainval_split=1)
    t = KITTI360Loader(tmp_path / "torch", trainval_split=1, device="cpu")
    for i in range(4):
        np.testing.assert_array_equal(t.annotation_3dpoints(i).semantic,
                                      j.annotation_3dpoints(i).semantic)
    seg = t.annotation_3dpoints(1).semantic
    assert (seg == int(Kitti360Class.building)).any()
    assert (seg == int(Kitti360Class.road)).any()
    assert id2label[11].name == Kitti360Class.building


def test_cache_guards(tmp_path):
    """ninter_frames=0 gives [] and a large one every scan; a transfer
    without windows raises FileNotFoundError and leaves no marker, and the
    windows put back build; a loader without a device needs CUDA for the
    transfer (not for anything else)."""
    import torch

    dfx.build_kitti360(tmp_path, nframes=4)
    loader = KITTI360Loader(tmp_path, trainval_split=1, device="cpu")
    assert loader.intermediate_data(0, names="sick", report_semantic=False,
                                    ninter_frames=0) == []
    assert len(loader.intermediate_data(0, names="sick",
                                        report_semantic=False,
                                        ninter_frames=999)) >= 1
    sem = tmp_path / "data_3d_semantics" / SEQ
    stash = tmp_path / "stash"
    stash.mkdir()
    for kind in ("static", "dynamic"):
        shutil.move(str(sem / kind), str(stash / kind))
    with pytest.raises(FileNotFoundError):
        loader.annotation_3dpoints(0)
    assert not (sem / ".labels_complete").exists()
    for kind in ("static", "dynamic"):
        shutil.move(str(stash / kind), str(sem / kind))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            KITTI360Loader(tmp_path, trainval_split=1).annotation_3dpoints(0)
    seg = loader.annotation_3dpoints(0)
    assert seg.semantic.shape == (len(loader.lidar_data(0)),)

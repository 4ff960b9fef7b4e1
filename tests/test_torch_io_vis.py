"""The port's ``io`` and ``vis`` packages against the JAX package's, each
driven by its own package's KITTI tracking loader over one fixture
sequence (``tests/kitti_fixture.build_tracking``): the HDF5 dumps equal
group by group and byte by byte in every dataset; the LMDB, ROS-bag and
XVIZ calls and ``vis/pcl``'s Visualizer calls equal under the same
recording stand-ins for ``lmdb``, the ROS stack, ``xviz_avs`` and ``pcl``
(none is installed; ``tests/test_optional_deps.py`` stubs them the same
way); the matplotlib artists of ``vis/image`` and ``vis/pcl``'s fallback
(line data, colours, widths, label texts and their positions) equal."""

import sys
import types

import matplotlib

matplotlib.use("Agg")

import h5py  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from scipy.spatial.transform import Rotation  # noqa: E402

import _limits  # noqa: E402,F401  (one torch thread a process)

import kitti_fixture as kfx  # noqa: E402
import d3d_tpu.abstraction as JA  # noqa: E402
import d3d_tpu.io.hdf5 as JH  # noqa: E402
import d3d_tpu.io.lmdb as JL  # noqa: E402
import d3d_tpu.io.ros as JR  # noqa: E402
import d3d_tpu.vis.image as JI  # noqa: E402
import d3d_tpu.vis.pcl as JP  # noqa: E402
import d3d_tpu.vis.xviz as JX  # noqa: E402
from d3d_tpu.dataset.kitti import KittiTrackingLoader as JLoader  # noqa

import d3d_tpu_torch.abstraction as TA  # noqa: E402
import d3d_tpu_torch.io.hdf5 as TH  # noqa: E402
import d3d_tpu_torch.io.lmdb as TL  # noqa: E402
import d3d_tpu_torch.io.ros as TR  # noqa: E402
import d3d_tpu_torch.vis.image as TI  # noqa: E402
import d3d_tpu_torch.vis.pcl as TP  # noqa: E402
import d3d_tpu_torch.vis.xviz as TX  # noqa: E402
from d3d_tpu_torch.dataset.kitti import (KittiObjectClass,  # noqa: E402
                                         KittiTrackingLoader as TLoader)

PKGS = {"jax": dict(A=JA, H=JH, L=JL, R=JR, I=JI, P=JP, X=JX),
        "torch": dict(A=TA, H=TH, L=TL, R=TR, I=TI, P=TP, X=TX)}


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_trk_io")
    kfx.build_tracking(root, seqs=(0,), frames_per_seq=3)
    kw = dict(phase="training", inzip=False, trainval_split=1)
    return {"jax": JLoader(root, **kw), "torch": TLoader(root, **kw)}


def _norm(v):
    """A comparable value: recorder objects by their attributes, arrays
    by dtype, shape and bytes, floats by repr."""
    if isinstance(v, _Auto):
        return {k: _norm(x) for k, x in sorted(v.__dict__.items())}
    if isinstance(v, np.ndarray):
        return (v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in sorted(v.items())}
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, np.integer):
        return int(v)
    return v


class _Auto:
    """Attribute sink: reading a missing attribute makes a child; every
    write is kept (a stand-in for ROS message types)."""

    def __init__(self, *args, **kw):
        self.__dict__.update(kw)
        if args:
            self.__dict__["args"] = args

    def __getattr__(self, name):
        child = _Auto()
        self.__dict__[name] = child
        return child


# ---------------------------------------------------------------------------
# io
# ---------------------------------------------------------------------------

def _h5(path):
    out = {}

    def visit(name, obj):
        out[name] = ((obj.dtype.str, obj.shape, obj[()].tobytes())
                     if isinstance(obj, h5py.Dataset) else "group")
    with h5py.File(path) as f:
        f.visititems(visit)
    return out


@pytest.mark.parametrize("fn", ["dump_dataset", "dump_sequence_dataset"])
def test_hdf5_dumps_are_equal(loaders, tmp_path, fn):
    got = {}
    for name, loader in loaders.items():
        getattr(PKGS[name]["H"], fn)(loader, tmp_path / f"{name}.h5")
        got[name] = _h5(tmp_path / f"{name}.h5")
    assert got["torch"] == got["jax"]
    assert sum(v != "group" for v in got["torch"].values()) == 3


def test_lmdb_dump_writes_what_the_jax_module_writes(loaders, monkeypatch,
                                                     tmp_path):
    for integrity in (False, True):
        calls = {}
        for name, loader in loaders.items():
            log = calls.setdefault(name, [])
            store = {}

            class _Txn:
                def __init__(self, write=False):
                    self.write = write

                def __enter__(self):
                    return self

                def __exit__(self, *a):
                    return False

                def put(self, key, value):
                    log.append(("put", key, value))
                    store[key] = value

                def get(self, key):
                    log.append(("get", key))
                    return store.get(key)

            class _Env:
                def begin(self, write=False):
                    log.append(("begin", write))
                    return _Txn(write)

                def close(self):
                    log.append(("close",))

            lmdb = types.ModuleType("lmdb")
            lmdb.open = lambda path, map_size: (
                log.append(("open", map_size)) or _Env())
            monkeypatch.setitem(sys.modules, "lmdb", lmdb)
            PKGS[name]["L"].dump_dataset(loader, tmp_path / name,
                                         frame_integrity=integrity)
        assert calls["torch"] == calls["jax"]
        assert sum(c[0] == "put" for c in calls["torch"]) == 3


def _ros_stubs(monkeypatch, records):
    class _Bag:
        size = 1

        def __init__(self, path, mode):
            self.mode = mode

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def write(self, topic, msg, t=None):
            records.append((topic, _norm(msg), _norm(t)))

    class _PointField(_Auto):
        FLOAT32, UINT32 = 7, 6

        def __init__(self, name, offset, dtype, count):
            super().__init__(name=name, offset=offset, dtype=dtype,
                             count=count)

    class _TFMessage(_Auto):
        def __init__(self):
            super().__init__(transforms=[])

    mods = {name: types.ModuleType(name) for name in (
        "rosbag", "rospy", "sensor_msgs", "sensor_msgs.point_cloud2",
        "sensor_msgs.msg", "geometry_msgs", "geometry_msgs.msg", "std_msgs",
        "std_msgs.msg", "tf2_msgs", "tf2_msgs.msg")}
    mods["rosbag"].Bag = _Bag
    mods["rospy"].Time = _Auto(from_sec=lambda s: ("time", s))
    mods["sensor_msgs.point_cloud2"].create_cloud = \
        lambda header, fields, arr: _Auto(header=header, fields=fields,
                                          cloud=np.asarray(arr))
    mods["sensor_msgs.msg"].PointField = _PointField
    mods["sensor_msgs.msg"].CameraInfo = _Auto
    mods["sensor_msgs.msg"].Image = _Auto
    mods["geometry_msgs.msg"].TransformStamped = _Auto
    mods["std_msgs.msg"].ByteMultiArray = _Auto
    mods["std_msgs.msg"].Header = _Auto
    mods["tf2_msgs.msg"].TFMessage = _TFMessage
    for parent, child in (("sensor_msgs", "point_cloud2"),
                          ("sensor_msgs", "msg"), ("geometry_msgs", "msg"),
                          ("std_msgs", "msg"), ("tf2_msgs", "msg")):
        setattr(mods[parent], child, mods[f"{parent}.{child}"])
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)


@pytest.mark.parametrize("odom", [None, "velo"])
def test_ros_bag_messages_are_equal(loaders, monkeypatch, tmp_path, odom):
    records = {}
    for name, loader in loaders.items():
        records[name] = []
        _ros_stubs(monkeypatch, records[name])
        calib = loader.calibration_data((0, 0))
        # the tracking calibration has no raw intrinsic matrix: graft one
        # onto cam2 so that the CameraInfo branch runs
        calib.intrinsics_meta["cam2"].intri_matrix = np.eye(3)
        monkeypatch.setattr(loader, "calibration_data",
                            lambda idx, _c=calib, **kw: _c)
        PKGS[name]["R"].dump_sequence_dataset(loader, tmp_path / "a.bag", 0,
                                              odom_frame=odom)
    assert records["torch"] == records["jax"]
    topics = [r[0] for r in records["torch"]]
    assert topics.count("/lidar/velo") == 3 and "/tf_static" in topics


def _xviz_stub(monkeypatch, calls):
    class _Chain:
        def __init__(self, tag):
            self.tag = tag

        def __getattr__(self, name):
            def record(*args, **kw):
                calls.append((self.tag, name, _norm(args), _norm(kw)))
                return self
            return record

    class _Meta(_Chain):
        def __init__(self):
            super().__init__("meta")

        def get_message(self):
            return {"streams": len(calls)}

    class _Builder(_Chain):
        def __init__(self, metadata=None):
            super().__init__("msg")
            calls.append(("msg", "init", _norm(metadata), {}))

        def get_message(self):
            return {"update": len(calls)}

    xviz = types.ModuleType("xviz_avs")
    builder = types.ModuleType("xviz_avs.builder")
    builder.XVIZMetadataBuilder, builder.XVIZBuilder = _Meta, _Builder
    xviz.builder = builder
    monkeypatch.setitem(sys.modules, "xviz_avs", xviz)
    monkeypatch.setitem(sys.modules, "xviz_avs.builder", builder)


def test_xviz_messages_are_equal(loaders, monkeypatch):
    calls = {}
    for name, loader in loaders.items():
        calls[name] = []
        _xviz_stub(monkeypatch, calls[name])
        conv = PKGS[name]["X"].TrackingDatasetConverter(
            loader, 0, camera_names=["cam2"])
        calls[name].append(("out", conv.get_metadata()))
        for f in range(3):
            calls[name].append(("out", conv.get_message(f)))
    assert calls["torch"] == calls["jax"]
    assert sum(c[1] == "polygon" for c in calls["torch"]) == 6


# ---------------------------------------------------------------------------
# vis
# ---------------------------------------------------------------------------

def _artists(ax):
    lines = [(np.asarray(ln.get_data_3d() if hasattr(ln, "get_data_3d")
                         else ln.get_xydata(), dtype=float).tolist(),
              str(ln.get_color()), ln.get_linewidth(), ln.get_linestyle())
             for ln in ax.lines]
    texts = [(t.get_text(), np.asarray(
        t.get_position_3d() if hasattr(t, "get_position_3d")
        else t.get_position(), dtype=float).tolist(), str(t.get_color()))
        for t in ax.texts]
    return lines, texts


def _scored(loader, frame):
    objs = loader.annotation_3dobject((0, frame))
    for i, o in enumerate(objs):
        o.tid = i + 1
        o.tag.scores = [0.75 - 0.1 * i]
    return objs


@pytest.mark.parametrize("kw", [{}, {"show_tid": True, "show_score": True}],
                         ids=["plain", "labels"])
def test_image_and_bev_artists_are_equal(loaders, kw):
    got = {}
    for name, loader in loaders.items():
        mod = PKGS[name]["I"]
        fig, (ax1, ax2) = plt.subplots(1, 2)
        objs, calib = _scored(loader, 1), loader.calibration_data((0, 1))
        mod.visualize_detections(ax1, "cam2", objs, calib, **kw)
        mod.visualize_detections_bev(ax2, "velo", objs, calib,
                                     **{k: v for k, v in kw.items()
                                        if k == "show_tid"})
        got[name] = (_artists(ax1), _artists(ax2))
        plt.close(fig)
    assert got["torch"] == got["jax"]
    assert len(got["torch"][0][0]) > 0 and len(got["torch"][1][0]) >= 8


def _scene(A):
    r = Rotation.from_euler("Z", 0.3)
    det = A.ObjectTarget3D([5, 0, 0], r, [4, 2, 1.6],
                           A.ObjectTag(KittiObjectClass.Car.name,
                                       _enum(A), scores=0.7),
                           position_var=np.eye(3) * 0.04)
    trk = A.TrackingTarget3D([10, 3, 0], r, [4, 2, 1.6], [2, 0, 0],
                             [0, 0, 0],
                             A.ObjectTag("Pedestrian", _enum(A),
                                         scores=0.9), tid=42)
    return A.Target3DArray([det, trk], frame="velo")


def _enum(A):
    if A is JA:
        from d3d_tpu.dataset.kitti.utils import KittiObjectClass as K
        return K
    return KittiObjectClass


class _Vis:
    """A recording stand-in for pcl.py's Visualizer."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def record(*args, **kw):
            self.calls.append((name, _norm([np.asarray(a) if isinstance(
                a, (list, tuple)) else a for a in args]), _norm(kw)))
        return record


@pytest.mark.parametrize("backend", ["pcl", "matplotlib"])
def test_pcl_scene_calls_are_equal(monkeypatch, backend):
    got = {}
    for name, mods in PKGS.items():
        if backend == "pcl":
            monkeypatch.setitem(sys.modules, "pcl", types.ModuleType("pcl"))
            vis = _Vis()
            mods["P"].visualize_detections(vis, "velo", _scene(mods["A"]),
                                           None, id_prefix="det",
                                           viewport=3, id_colored=True)
            got[name] = vis.calls
        else:
            fig = plt.figure()
            ax = fig.add_subplot(projection="3d")
            mods["P"].visualize_detections(ax, "velo", _scene(mods["A"]),
                                           None)
            got[name] = _artists(ax)
            plt.close(fig)
    assert got["torch"] == got["jax"]
    if backend == "pcl":
        kinds = [c[0] for c in got["torch"]]
        assert kinds.count("addCube") == 2 and kinds.count("addLine") == 5
    else:
        assert len(got["torch"][0]) == 2 * (12 + 2) + 1

"""The port's sequence loaders (``dataset/kitti/{tracking,raw,odometry}``,
``dataset/waymo``, ``dataset/cadc``) against the JAX package's, on the
repo's synthetic fixtures (``tests/kitti_fixture.build_tracking``,
``tests/dataset_fixtures.build_kitti_raw``, ``build_kitti_odometry``,
``build_waymo``, ``build_cadc``), each tree unzipped and zipped into the
layout its loader documents.

Every public method of every loader is called on every frame with each
option, on both packages' loaders over their own copy of the tree (the
Waymo loader writes ``metadata.msg`` beside its segments): points, images
and labels exactly, calibrations and poses within 1e-12, annotations as
serialized ``Target3DArray`` (tags, tids and every float), sizes,
identities and timestamps equal, the same exception where the JAX loader
raises one; the tracking and Waymo dumps byte-equal (Waymo's through a
recording stand-in for ``waymo_open_dataset``, as
``tests/test_optional_deps.py`` stubs it)."""

import enum
import inspect
import shutil
import sys
import types
import zipfile
from pathlib import Path

import numpy as np
import pytest
from PIL import Image
from scipy.spatial.transform import Rotation

import _limits  # noqa: F401  (one torch thread a process)

import dataset_fixtures as dfx
import kitti_fixture as kfx
from d3d_tpu.dataset import cadc as JCadc
from d3d_tpu.dataset import kitti as JKitti
from d3d_tpu.dataset import waymo as JWaymo

from d3d_tpu_torch.dataset import cadc as TCadc
from d3d_tpu_torch.dataset import kitti as TKitti
from d3d_tpu_torch.dataset import waymo as TWaymo

CALIB_TOL = 1e-12


# ---------------------------------------------------------------------------
# the trees, unzipped and zipped
# ---------------------------------------------------------------------------

def _zip(zpath, files, arc_base):
    zpath.parent.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(zpath, "w") as zf:
        for f in sorted(files):
            zf.write(f, f.relative_to(arc_base).as_posix())


def _tree_files(path):
    return [p for p in Path(path).rglob("*") if p.is_file()]


def _zip_tracking(root):
    train = root / "training"
    for sub, zname in (("calib", "calib"), ("label_02", "label_2"),
                       ("oxts", "oxts"), ("velodyne", "velodyne"),
                       ("image_02", "image_2"), ("image_03", "image_3")):
        _zip(root / ("data_tracking_%s.zip" % zname),
             _tree_files(train / sub), root)
    shutil.rmtree(train)


def _zip_raw(root, seq):
    date = seq[:10]
    _zip(root / f"{date}_calib.zip", (root / date).glob("calib_*.txt"),
         root)
    drive = root / date / seq
    xml = drive / "tracklet_labels.xml"
    _zip(root / (seq[:-len("sync")] + "tracklets.zip"), [xml], root)
    xml.unlink()
    _zip(root / f"{seq}.zip", _tree_files(drive), root)
    shutil.rmtree(root / date)


def _zip_odometry(root):
    seqs = root / "dataset" / "sequences"
    groups = {"calib": [], "color": [], "gray": [], "velodyne": [],
              "labels": [], "poses": _tree_files(root / "dataset" / "poses")}
    for f in _tree_files(seqs):
        folder = f.parent.name
        groups["calib" if f.suffix == ".txt" else
               "color" if folder in ("image_2", "image_3") else
               "gray" if folder in ("image_0", "image_1") else
               folder].append(f)
    for name, files in groups.items():
        if files:
            _zip(root / ("data_odometry_%s.zip" % name), files, root)
    shutil.rmtree(root / "dataset")


def _zip_cadc(root):
    for date in (p for p in root.iterdir() if p.is_dir()):
        _zip(date / "calib.zip", _tree_files(date / "calib"), date)
        shutil.rmtree(date / "calib")
        for drive in (p for p in date.iterdir() if p.is_dir()):
            _zip(drive / "labeled.zip", _tree_files(drive / "labeled"),
                 drive)
            shutil.rmtree(drive / "labeled")


def _build(name, root):
    kind, zipped = name.rsplit("_", 1)
    zipped = zipped == "zip"
    if kind == "tracking":
        kfx.build_tracking(root, seqs=(0, 1), frames_per_seq=3)
        if zipped:
            _zip_tracking(root)
    elif kind == "raw":
        seq = dfx.build_kitti_raw(root, nframes=3)
        if zipped:
            _zip_raw(root, seq)
    elif kind == "odometry":
        dfx.build_kitti_odometry(root, nframes=3, seq=0)
        if zipped:
            _zip_odometry(root)
    elif kind == "waymo":
        dfx.build_waymo(root, nframes=3, zipped=zipped)
    elif kind == "cadc":
        dfx.build_cadc(root, nframes=3)
        if zipped:
            _zip_cadc(root)
    return zipped


def _open(pkg, kind, root, zipped):
    kitti, waymo, cadc = pkg
    if kind == "tracking":
        return kitti.KittiTrackingLoader(root, inzip=zipped,
                                         phase="training", trainval_split=1)
    if kind == "raw":
        return kitti.KittiRawLoader(root, inzip=zipped, phase="training",
                                    trainval_split=1)
    if kind == "odometry":
        return kitti.KittiOdometryLoader(root, inzip=zipped,
                                         phase="training", trainval_split=1)
    if kind == "waymo":
        return waymo.WaymoLoader(root, phase="training", inzip=zipped)
    return cadc.CADCDLoader(root, inzip=zipped, phase="training",
                            trainval_split=1)


TREES = ["tracking_dir", "tracking_zip", "raw_dir", "raw_zip",
         "odometry_dir", "odometry_zip", "waymo_dir", "waymo_zip",
         "cadc_dir", "cadc_zip"]


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    """{tree: (JAX loader, port loader)}, each over its own copy."""
    base = tmp_path_factory.mktemp("seq_loaders")
    out = {}
    for name in TREES:
        zipped = _build(name, base / name / "jax")
        shutil.copytree(base / name / "jax", base / name / "torch")
        kind = name.rsplit("_", 1)[0]
        out[name] = (_open((JKitti, JWaymo, JCadc), kind,
                           base / name / "jax", zipped),
                     _open((TKitti, TWaymo, TCadc), kind,
                           base / name / "torch", zipped))
    return out


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

def _same(j, t, tol=0.0, where="out"):
    """Hold the port's value ``t`` to the JAX package's ``j``: arrays and
    images exactly (floats within ``tol``), objects of the data model by
    their fields, ``Target3DArray`` as serialized."""
    name = type(j).__name__
    assert type(t).__name__ == name, (where, name, type(t).__name__)
    if isinstance(j, np.ndarray):
        assert (t.dtype, t.shape) == (j.dtype, j.shape), where
        if tol and j.dtype.kind == "f":
            np.testing.assert_allclose(t, j, rtol=0, atol=tol, err_msg=where)
        else:
            np.testing.assert_array_equal(t, j, err_msg=where)
    elif isinstance(j, Image.Image):
        assert (t.mode, t.size) == (j.mode, j.size), where
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))
    elif name == "Target3DArray":
        assert t.frame == j.frame and len(t) == len(j), where
        _same(j.serialize(), t.serialize(), 0.0, where + ".serialize")
        for k, (a, b) in enumerate(zip(j, t)):
            _same(a.tag.mapping.__name__, b.tag.mapping.__name__)
            _same(a.tag.labels, b.tag.labels, 0.0, f"{where}[{k}].labels")
    elif isinstance(j, Rotation):
        _same(j.as_quat(), t.as_quat(), tol or CALIB_TOL, where)
    elif isinstance(j, enum.Enum):
        assert (t.name, t.value) == (j.name, j.value), where
    elif isinstance(j, dict):
        assert sorted(map(str, t)) == sorted(map(str, j)), where
        for k in j:
            _same(j[k], t[k], tol, f"{where}[{k!r}]")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), where
        for k, (a, b) in enumerate(zip(j, t)):
            _same(a, b, tol, f"{where}[{k}]")
    elif isinstance(j, float):
        assert abs(t - j) <= tol or (np.isnan(t) and np.isnan(j)), \
            (where, t, j)
    elif isinstance(j, (str, bytes, int, bool, np.generic)) or j is None:
        assert t == j, (where, t, j)
    else:
        _same(vars(j), vars(t), tol, where + ".__dict__")


def _call(loader, method, args, kw):
    try:
        return "ok", getattr(loader, method)(*args, **kw)
    except Exception as e:  # the port must raise what the JAX loader does
        return "raised", type(e).__name__


def _check(pair, method, args=(), kw=None, tol=0.0):
    j, t = pair
    jr, tr = (_call(x, method, args, kw or {}) for x in pair)
    assert tr[0] == jr[0], (method, args, kw, jr, tr)
    _same(jr[1], tr[1], tol, f"{method}{args}{kw or ''}")
    return jr


# every public method a loader has, with the options each one is called
# with on every frame; calibrations and poses within CALIB_TOL
_COMMON = {
    "camera_data": [{}, {"names": "ALL_CAMS"}],
    "lidar_data": [{}, {"formatted": True}],
    "calibration_data": [{}],
    "annotation_3dobject": [{}],
    "identity": [{}],
    "timestamp": [{}],
    "pose": [{}, {"raw": True}],
    "intermediate_data": [{}],
}
_EXTRA = {
    "tracking": {"calibration_data": [{}, {"raw": True}],
                 "annotation_3dobject": [{}, {"raw": True}],
                 "timestamp": [{}, {"names": "cam2"}]},
    "raw": {"calibration_data": [{}, {"raw": True}],
            "timestamp": [{}, {"names": "cam0"}, {"names": "cam2"}]},
    "odometry": {"calibration_data": [{}, {"raw": True}],
                 "annotation_3dpoints": [{}, {"convert_tag": False}],
                 "identity_in_raw": [{}],
                 "timestamp": [{}, {"names": "cam2"}]},
    "waymo": {"annotation_3dobject": [{}, {"raw": True}],
              "annotation_2dobject": [{}],
              "timestamp": [{}, {"names": "lidar_top"}]},
    "cadc": {"calibration_data": [{}, {"raw": True}],
             "timestamp": [{}, {"names": "camera_F"}]},
}
_NOT_PER_FRAME = {"dump_tracking_output", "dump_detection_output",
                  "return_path"}
_TOLERANT = {"calibration_data", "pose"}


def _methods(kind):
    return dict(_COMMON, **_EXTRA[kind])


@pytest.mark.parametrize("kind", ["tracking", "raw", "odometry", "waymo",
                                  "cadc"])
def test_every_public_method_is_held(kind):
    cls = {"tracking": TKitti.KittiTrackingLoader,
           "raw": TKitti.KittiRawLoader,
           "odometry": TKitti.KittiOdometryLoader,
           "waymo": TWaymo.WaymoLoader, "cadc": TCadc.CADCDLoader}[kind]
    public = {n for n, v in inspect.getmembers(cls)
              if not n.startswith("_") and inspect.isfunction(v)}
    assert public - _NOT_PER_FRAME == set(_methods(kind))


@pytest.mark.parametrize("tree", TREES)
def test_sizes_identities_and_properties(loaders, tree):
    j, t = loaders[tree]
    assert len(t) == len(j) > 0
    for prop in ("sequence_ids", "sequence_sizes", "pose_name",
                 "VALID_CAM_NAMES", "VALID_LIDAR_NAMES"):
        _same(getattr(j, prop), getattr(t, prop), 0.0, prop)
    if hasattr(j, "frames"):
        _same(np.asarray(j.frames), np.asarray(t.frames))
    assert [t._locate_frame(i) for i in range(len(t))] == \
        [j._locate_frame(i) for i in range(len(j))]


@pytest.mark.parametrize("tree", TREES)
def test_every_method_on_every_frame(loaders, tree):
    pair = loaders[tree]
    kind = tree.rsplit("_", 1)[0]
    raised = set()
    for method, options in sorted(_methods(kind).items()):
        tol = CALIB_TOL if method in _TOLERANT else 0.0
        for kw in options:
            if kw.get("names") == "ALL_CAMS":
                kw = {"names": list(pair[0].VALID_CAM_NAMES)}
            for i in range(len(pair[0])):
                if _check(pair, method, (i,), kw, tol)[0] == "raised":
                    raised.add(method)
    # the fixtures leave out only other cameras (CADC, Waymo) and the
    # odometry tree its objects; nothing else may fail in both
    assert raised <= {"camera_data", "annotation_3dobject"}, raised


def test_waymo_metadata_and_zip_reads_agree(loaders):
    for tree in ("waymo_dir", "waymo_zip"):
        j, t = loaders[tree]
        assert (t.base_path / "metadata.msg").read_bytes() == \
            (j.base_path / "metadata.msg").read_bytes()
    # the zipped and unzipped trees hold the same frames
    a, b = loaders["waymo_dir"][1], loaders["waymo_zip"][1]
    for i in range(len(a)):
        _same(a.lidar_data(i), b.lidar_data(i))
        _same(a.annotation_3dobject(i), b.annotation_3dobject(i))


@pytest.mark.parametrize("tree", ["tracking_dir", "tracking_zip"])
def test_tracking_dump_is_byte_equal_and_reads_back(loaders, tree,
                                                     tmp_path):
    """Each package dumps its own loader's labels (scored) in the KITTI
    tracking format; the files are equal byte for byte and parse back
    through ``parse_label`` to the labels within the ``%.2f`` format."""
    outs = []
    for loader in loaders[tree]:
        seq = loader.sequence_ids[0]
        tracks = {}
        for f in range(loader.sequence_sizes[seq]):
            arr = loader.annotation_3dobject((seq, f))
            for k, obj in enumerate(arr):
                obj.tag.scores = [0.5 + 0.1 * k]
            tracks[f] = arr
        path = tmp_path / ("%s.txt" % type(loader).__module__.split(".")[0])
        loader.dump_tracking_output(seq, tracks, path)
        outs.append((path.read_bytes(), loader, seq, tracks))
    (jb, _, _, _), (tb, t, seq, tracks) = outs
    assert tb == jb and tb
    from d3d_tpu_torch.dataset.kitti.tracking import parse_label

    rows = {}
    for line in tb.decode().splitlines():
        fields = line.split(" ")
        rows.setdefault(int(fields[0]), []).append(
            [int(fields[1]), TKitti.KittiObjectClass[fields[2]]]
            + [float(v) for v in fields[3:]])
    raw = t.calibration_data((seq, 0), raw=True)
    for f, arr in tracks.items():
        back = parse_label(rows[f], raw)
        assert [o.tid for o in back] == [o.tid for o in arr]
        for a, b in zip(arr, back):
            np.testing.assert_allclose(b.position, a.position, atol=0.011)
            np.testing.assert_allclose(b.dimension, a.dimension, atol=0.006)
            assert abs(b.yaw - a.yaw) < 0.006
            assert b.tag_top == a.tag_top


class _Rec:
    """Records every attribute written on it (a protobuf stand-in)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __getattr__(self, name):
        child = _Rec()
        self.__dict__[name] = child
        return child

    def CopyFrom(self, other):
        self.__dict__.update(other.__dict__)

    def state(self):
        return {k: (v.state() if isinstance(v, _Rec) else
                    [o.state() for o in v] if isinstance(v, list) else
                    repr(float(v)) if isinstance(v, (float, np.floating))
                    else repr(v))
                for k, v in sorted(self.__dict__.items())}


class _Objects(_Rec):
    def __init__(self):
        super().__init__(objects=[])

    def SerializeToString(self):
        return repr(self.state()).encode()


def test_waymo_detection_dump_is_byte_equal(loaders, monkeypatch, tmp_path):
    label_pb2 = types.ModuleType("waymo_open_dataset.label_pb2")
    label_pb2.Label = _Rec(TYPE_UNKNOWN=0, TYPE_VEHICLE=1, TYPE_PEDESTRIAN=2,
                           TYPE_SIGN=3, TYPE_CYCLIST=4, Box=_Rec)
    metrics_pb2 = types.ModuleType("waymo_open_dataset.protos.metrics_pb2")
    metrics_pb2.Objects, metrics_pb2.Object = _Objects, _Rec
    wod = types.ModuleType("waymo_open_dataset")
    protos = types.ModuleType("waymo_open_dataset.protos")
    wod.label_pb2, wod.protos, protos.metrics_pb2 = \
        label_pb2, protos, metrics_pb2
    for name, mod in (("waymo_open_dataset", wod),
                      ("waymo_open_dataset.label_pb2", label_pb2),
                      ("waymo_open_dataset.protos", protos),
                      ("waymo_open_dataset.protos.metrics_pb2",
                       metrics_pb2)):
        monkeypatch.setitem(sys.modules, name, mod)
    for tree in ("waymo_dir", "waymo_zip"):
        blobs = []
        for k, loader in enumerate(loaders[tree]):
            for i in range(len(loader)):
                dets = loader.annotation_3dobject(i)
                for n, d in enumerate(dets):
                    d.tag.scores = [0.9 - 0.1 * n]
                out = tmp_path / f"{tree}_{k}_{i}.bin"
                loader.dump_detection_output(i, dets, out)
                blobs.append(out.read_bytes())
        half = len(blobs) // 2
        assert blobs[half:] == blobs[:half]
        assert b"TYPE" not in blobs[0] and b"center_x" in blobs[0]

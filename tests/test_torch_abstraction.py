"""The port's data model (``d3d_tpu_torch.abstraction``) against the JAX
package's: the same seeded columns give the same columns, rows and boxes,
the same msgpack bytes (either side loads the other's dump), the same
TransformSet math, and the same crops, distances and IoUs through the
port's ops on the CPU. Also: the new modules import without the host-only
packages (msgpack, tqdm, PIL)."""

import io
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from _limits import run_python

from d3d_tpu import abstraction as JA
from d3d_tpu.dataset.kitti.utils import KittiObjectClass as JK

from d3d_tpu_torch import abstraction as TA
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TK

ROOT = Path(__file__).resolve().parents[1]

SIDES = ((JA, JK), (TA, TK))


def twin_columns(rng, n, labels=(1, 2, 4), scores=None, with_var=0.0,
                 spread=10.0, dims=(1.0, 4.0)):
    """Seeded columns for :func:`twin_arrays`: positions, f32 quaternions
    (yaw only), extents, labels, scores and, for a ``with_var`` share of
    the rows, positive definite covariances and an orientation variance."""
    yaw = rng.uniform(-np.pi, np.pi, n)
    quat = np.zeros((n, 4), np.float32)
    quat[:, 2], quat[:, 3] = np.sin(yaw / 2), np.cos(yaw / 2)
    cols = dict(
        position=rng.uniform(-spread, spread, (n, 3)),
        dimension=rng.uniform(*dims, (n, 3)), quat=quat,
        label=rng.choice(labels, n),
        score=(rng.choice([0.3, 0.5, 0.7, 0.7, 0.9], n) if scores is None
               else np.broadcast_to(scores, n)),
        position_var=np.zeros((n, 3, 3)), dimension_var=np.zeros((n, 3, 3)),
        orientation_var=np.zeros(n))
    for i in np.nonzero(rng.random(n) < with_var)[0]:
        a, b = rng.uniform(0.1, 0.5, (2, 3, 3))
        cols["position_var"][i] = a @ a.T + np.eye(3) * 0.2
        cols["dimension_var"][i] = b @ b.T + np.eye(3) * 0.2
        cols["orientation_var"][i] = rng.uniform(0.05, 1.0)
    return cols


def twin_arrays(cols, frame="velo", timestamp=0, tracking=None, tids=None,
                aux=None):
    """The same objects as a JAX-package array and a port array, built
    object by object through each side's constructors from the same
    values (so every f32 quaternion is bit-equal on both sides)."""
    out = []
    for mod, enum in SIDES:
        objs = []
        for i in range(len(cols["position"])):
            tag = mod.ObjectTag(enum(int(cols["label"][i])), enum,
                                float(cols["score"][i]))
            kw = dict(tid=0 if tids is None else tids[i],
                      position_var=cols["position_var"][i],
                      dimension_var=cols["dimension_var"][i],
                      orientation_var=float(cols["orientation_var"][i]),
                      aux=None if aux is None else aux[i])
            if tracking is None:
                objs.append(mod.ObjectTarget3D(
                    cols["position"][i], cols["quat"][i],
                    cols["dimension"][i], tag, **kw))
            else:
                objs.append(mod.TrackingTarget3D(
                    cols["position"][i], cols["quat"][i],
                    cols["dimension"][i], tracking["velocity"][i],
                    tracking["angular_velocity"][i], tag,
                    history=float(tracking["history"][i]), **kw))
        out.append(mod.Target3DArray(objs, frame=frame, timestamp=timestamp))
    return out


def _arrays(seed, tracking=False):
    rng = np.random.default_rng(seed)
    n = 12
    cols = twin_columns(rng, n, with_var=0.5)
    trk = None if not tracking else dict(
        velocity=rng.uniform(-5, 5, (n, 3)),
        angular_velocity=rng.uniform(-1, 1, (n, 3)),
        history=rng.uniform(0, 3, n))
    return twin_arrays(cols, frame="velo", timestamp=1.2345, tracking=trk,
                       tids=list(range(1, n + 1)),
                       aux=[{"k": i} if i % 3 == 0 else None
                            for i in range(n)])


def assert_same_columns(a, b):
    ca, cb = a.columns(), b.columns()
    assert sorted(ca) == sorted(cb)
    for key in ca:
        np.testing.assert_array_equal(cb[key], ca[key], err_msg=key)


@pytest.mark.parametrize("tracking", [False, True])
def test_columns_rows_and_boxes_match(tracking):
    ja, ta = _arrays(1, tracking)
    assert_same_columns(ja, ta)
    np.testing.assert_array_equal(ta.to_numpy(), ja.to_numpy())
    np.testing.assert_array_equal(ta.boxes7(), ja.boxes7())
    assert ta.to_numpy().dtype == np.float32
    assert ta.boxes7().dtype == np.float64


def test_from_columns_matches():
    rng = np.random.default_rng(2)
    cols = twin_columns(rng, 9)
    yaws = rng.uniform(-3, 3, 9)
    kw = dict(positions=cols["position"], dimensions=cols["dimension"],
              labels=cols["label"], scores=cols["score"], frame="velo",
              timestamp=7)
    for given in (dict(yaws=yaws), dict(quats=cols["quat"])):
        ja = JA.Target3DArray.from_columns(**kw, **given, mapping=JK)
        ta = TA.Target3DArray.from_columns(**kw, **given, mapping=TK)
        assert_same_columns(ja, ta)
        assert (ta.frame, ta.timestamp) == (ja.frame, ja.timestamp)
        assert [o.tag_top.name for o in ta] == [o.tag_top.name for o in ja]
    empty = TA.Target3DArray.from_columns(np.zeros((0, 3)), np.zeros((0, 3)),
                                          yaws=np.zeros(0), labels=[],
                                          mapping=TK)
    assert len(empty) == 0 and empty.to_numpy().shape == (0,)


@pytest.mark.parametrize("tracking", [False, True])
def test_dump_bytes_equal_and_load_across(tracking):
    ja, ta = _arrays(3, tracking)
    jb, tb = io.BytesIO(), io.BytesIO()
    ja.dump(jb)
    ta.dump(tb)
    assert tb.getvalue() == jb.getvalue()
    # each side loads the other's dump into the same columns
    from_jax = TA.Target3DArray.load(io.BytesIO(jb.getvalue()))
    from_port = JA.Target3DArray.load(io.BytesIO(tb.getvalue()))
    assert_same_columns(from_port, from_jax)
    assert type(from_jax[0]) is (TA.TrackingTarget3D if tracking
                                 else TA.ObjectTarget3D)
    assert from_jax[0].tag.mapping is TK
    assert [o.aux for o in from_jax] == [o.aux for o in from_port]
    assert (from_jax.frame, from_jax.timestamp) == (from_port.frame,
                                                    from_port.timestamp)


def test_empty_and_odd_tid_dumps_equal(tmp_path):
    for tid in (None, "strid0", -1):
        arrs = []
        for mod, enum in SIDES:
            objs = [] if tid is None else [mod.ObjectTarget3D(
                [1.0, 2, 3], np.array([0, 0, 0, 1], np.float32), [4, 2, 1.6],
                mod.ObjectTag(enum.Car, enum, 0.5), tid=tid)]
            arrs.append(mod.Target3DArray(objs, frame="f"))
        paths = [tmp_path / f"{side}.msg" for side in ("jax", "port")]
        for arr, path in zip(arrs, paths):
            arr.dump(path)
        assert paths[0].read_bytes() == paths[1].read_bytes()
        back = TA.Target3DArray.load(paths[0])
        assert len(back) == len(arrs[1]) and back.frame == "f"
        if tid is not None:
            assert back[0].tid == tid


def test_pickle_round_trip():
    for tracking in (False, True):
        _, ta = _arrays(4, tracking)
        copy = pickle.loads(pickle.dumps(ta))
        assert_same_columns(ta, copy)
        assert copy.frame == ta.frame and copy.timestamp == ta.timestamp


def _taxonomies():
    """(JAX enum, port enum, code) for every registered taxonomy."""
    from d3d_tpu.dataset.nuscenes import constants as JN
    from d3d_tpu.dataset.waymo.constants import WaymoObjectClass as JW

    from d3d_tpu_torch.dataset.nuscenes import constants as TN
    from d3d_tpu_torch.dataset.waymo.constants import WaymoObjectClass as TW
    return [(JK, TK, 1), (JW, TW, 2),
            (JN.NuscenesObjectClass, TN.NuscenesObjectClass, 3),
            (JN.NuscenesDetectionClass, TN.NuscenesDetectionClass, 4)]


@pytest.mark.parametrize("case", range(4), ids=["kitti", "waymo",
                                                "nuscenes",
                                                "nuscenes_detection"])
def test_every_taxonomy_serializes_with_its_code(case):
    """A tag of each built-in taxonomy carries the JAX package's code in
    ``serialize()``, dumps to the same msgpack bytes and keeps its
    ``mapping`` through a pickle round trip (a tag of a taxonomy left
    unregistered would come back with ``mapping=None``)."""
    jenum, tenum, code = _taxonomies()[case]
    member = list(tenum)[1]
    jtag = JA.ObjectTag(jenum[member.name], jenum, 0.5)
    ttag = TA.ObjectTag(member, tenum, 0.5)
    assert ttag.serialize()[0] == jtag.serialize()[0] == code
    assert ttag.serialize() == jtag.serialize()
    back = pickle.loads(pickle.dumps(ttag))
    assert back.mapping is tenum and back.labels == ttag.labels
    arrs = [mod.Target3DArray([mod.ObjectTarget3D(
        [1.0, 2, 3], np.array([0, 0, 0, 1], np.float32), [4, 2, 1.6], tag,
        tid=7)], frame="f") for mod, tag in ((JA, jtag), (TA, ttag))]
    bufs = [io.BytesIO(), io.BytesIO()]
    for arr, buf in zip(arrs, bufs):
        arr.dump(buf)
    assert bufs[1].getvalue() == bufs[0].getvalue()
    loaded = TA.Target3DArray.load(io.BytesIO(bufs[0].getvalue()))
    assert loaded[0].tag.mapping is tenum
    assert loaded[0].tag_top is member


def _transform_sets():
    out = []
    for mod, _ in SIDES:
        ts = mod.TransformSet("base")
        ts.set_intrinsic_lidar("velo")
        ts.set_intrinsic_camera(
            "cam", np.array([[721.5, 0.0, 609.5], [0, 721.5, 172.8],
                             [0, 0, 1]]), (1242, 375),
            distort_coeffs=(0.01, -0.02, 0.001, 0.002, 0.003),
            intri_matrix=np.array([[721.5, 0.0, 609.5], [0, 721.5, 172.8],
                                   [0, 0, 1]]))
        rt = np.eye(4)
        rt[:3, :3] = np.array([[0.0, -1, 0], [0, 0, -1], [1, 0, 0]]).T
        rt[:3, 3] = [0.3, -0.1, 0.2]
        ts.set_extrinsic(np.eye(4), frame_to="velo")
        ts.set_extrinsic(rt, frame_to="cam", frame_from="velo")
        out.append(ts)
    return out


def test_transform_set_matches():
    """Object and point transforms and the distorted camera projection,
    float64, within 1e-12 of the JAX module's."""
    jts, tts = _transform_sets()
    ja, ta = _arrays(5, tracking=True)
    jo = jts.transform_objects(ja, frame_to="cam")
    to = tts.transform_objects(ta, frame_to="cam")
    assert to.frame == "cam"
    for key, want in jo.columns().items():
        np.testing.assert_allclose(to.columns()[key], want, rtol=0,
                                   atol=1e-12, err_msg=key)
    rng = np.random.default_rng(6)
    pts = np.concatenate([rng.uniform([0, -20, -2], [60, 20, 2], (300, 3)),
                          rng.random((300, 1))], 1)
    np.testing.assert_allclose(tts.transform_points(pts, "cam", "velo"),
                               jts.transform_points(pts, "cam", "velo"),
                               rtol=0, atol=1e-12)
    for kw in (dict(), dict(remove_outlier=False, return_dmask=True)):
        want = jts.project_points_to_camera(pts, "cam", "velo", **kw)
        got = tts.project_points_to_camera(pts, "cam", "velo", **kw)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-12)
        for w, g in zip(want[1:], got[1:]):
            np.testing.assert_array_equal(g, w)
    buf = io.BytesIO()
    tts.dump(buf)
    buf.seek(0)
    assert TA.TransformSet.load(buf).frames == tts.frames


def test_filters_match():
    ja, ta = _arrays(7)
    for call in (lambda a: a.filter_tag("car"),
                 lambda a: a.filter_tag([a[0].tag_top]),
                 lambda a: a.filter_score(0.6),
                 lambda a: a.filter_position(x_min=-5, y_max=3),
                 lambda a: a.filter(lambda o: o.dimension[0] > 2)):
        np.testing.assert_array_equal(call(ta).to_numpy(),
                                      call(ja).to_numpy())
    ja.sort_by_score(reverse=True)
    ta.sort_by_score(reverse=True)
    np.testing.assert_array_equal(ta.to_numpy(), ja.to_numpy())


def test_geometry_on_the_cpu_matches():
    """crop_points masks exact, points_distance and box_iou within 1e-12
    (float64), paint_label exact, all with ``device="cpu"``."""
    rng = np.random.default_rng(8)
    cols = twin_columns(rng, 6, spread=4.0, dims=(2.0, 5.0))
    ja, ta = twin_arrays(cols)
    cloud = rng.uniform(-7, 7, (400, 3))
    np.testing.assert_array_equal(ta.crop_points(cloud, device="cpu"),
                                  ja.crop_points(cloud))
    sem = rng.choice([1, 2, 4], 400)
    np.testing.assert_array_equal(ta.paint_label(cloud, sem, device="cpu"),
                                  ja.paint_label(cloud, sem))
    for i in range(3):
        np.testing.assert_array_equal(ta[i].crop_points(cloud, device="cpu"),
                                      ja[i].crop_points(cloud))
        np.testing.assert_allclose(
            ta[i].points_distance(cloud, device="cpu"),
            ja[i].points_distance(cloud), rtol=0, atol=1e-12)
        for j in range(6):
            assert abs(ta[i].box_iou(ta[j], device="cpu")
                       - ja[i].box_iou(ja[j])) <= 1e-12
    assert ta[0].box_iou(ta[0], device="cpu") == pytest.approx(1.0, abs=1e-12)
    empty = TA.Target3DArray(frame="velo")
    assert empty.crop_points(cloud, device="cpu").shape == (0, 400)


def test_device_calls_need_cuda_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without CUDA")
    _, ta = _arrays(9)
    cloud = np.zeros((4, 3))
    for call in (lambda: ta.to_torch(), lambda: ta.crop_points(cloud),
                 lambda: TA.Target3DArray().crop_points(cloud),
                 lambda: ta.paint_label(cloud, np.zeros(4)),
                 lambda: ta[0].crop_points(cloud),
                 lambda: ta[0].points_distance(cloud),
                 lambda: ta[0].box_iou(ta[1])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    t = ta.to_torch(device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), ta.to_numpy())


def test_new_modules_import_without_host_only_packages():
    """The data model, the KITTI loader, the matcher and both evaluators
    import with msgpack, tqdm and PIL unavailable (the card's machine is
    not known to have them); only dump/load, progress bars and images
    need them."""
    code = (
        "import sys\n"
        "for m in ('msgpack', 'tqdm', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import d3d_tpu_torch.abstraction, d3d_tpu_torch.dataset.kitti\n"
        "import d3d_tpu_torch.tracking.matcher, d3d_tpu_torch.benchmarks\n"
        "import d3d_tpu_torch.benchmarks_device\n"
        "import d3d_tpu_torch.models.inference\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'd3d_tpu')]\n"
        "sys.exit(1 if bad else 0)\n")
    res = run_python(code, ROOT)
    assert res.returncode == 0, res.stdout + res.stderr

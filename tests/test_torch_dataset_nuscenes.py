"""The port's nuScenes input (``d3d_tpu_torch.dataset.nuscenes`` and
``d3d_tpu_torch.models.sweeps``) against the JAX package's, on the CPU.

The raw tables are the ones ``tests/test_dataset.py``'s
``TestNuscenesConverter._raw`` writes (two keyframes of a lidar and a
camera, one annotated car), once as they are and once with three lidar
sweeps a keyframe added (their own ego poses, in the sensor frame). Both
converters write their trees from them: the same files with the same bytes
(zipped: the same members). Both loaders read the JAX converter's tree: the
same accessors' values, equal exactly (both are host numpy on the same
files), and ``accumulate_sweeps`` the same cloud. The port's loader also
runs without ``msgpack`` (no metadata cache written)."""

import json
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from _limits import run_python

import test_dataset

from d3d_tpu.dataset.nuscenes import NuscenesLoader as JLoader
from d3d_tpu.dataset.nuscenes import converter as JConv
from d3d_tpu.models import sweeps as JSweeps

from d3d_tpu_torch.dataset.nuscenes import NuscenesLoader as TLoader
from d3d_tpu_torch.dataset.nuscenes import constants as TConst
from d3d_tpu_torch.dataset.nuscenes import converter as TConv
from d3d_tpu_torch.models import sweeps as TSweeps

ROOT = Path(__file__).resolve().parents[1]
SWEEPS = 3


def _add_sweeps(root, rng):
    """Three LIDAR_TOP sweeps before each keyframe of ``_raw``'s tables:
    non-key sample_data rows of the keyframe's sample, each with its own
    ego pose (the car moving and turning) and a seeded cloud."""
    v = root / "v1.0-trainval"
    (root / "sweeps/LIDAR_TOP").mkdir(parents=True)
    tables = {n: json.loads((v / f"{n}.json").read_text())
              for n in ("sample_data", "ego_pose")}
    for k, (sample, t_key) in enumerate((("s0", 1000000), ("s1", 1500000))):
        for j in range(SWEEPS):
            ts = t_key - 50000 * (SWEEPS - j)
            yaw = 0.05 * (k * SWEEPS + j)
            tok = f"sw{k}{j}"
            tables["ego_pose"].append(dict(
                token=f"p{tok}", timestamp=ts,
                rotation=[np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)],
                translation=[5.0 * k + 0.4 * j, 0.1 * j, 0.0]))
            fname = f"sweeps/LIDAR_TOP/{tok}.pcd.bin"
            rng.normal(0, 10, (40 + 8 * j, 5)).astype(np.float32).tofile(
                root / fname)
            tables["sample_data"].append(dict(
                token=tok, sample_token=sample, ego_pose_token=f"p{tok}",
                calibrated_sensor_token="cs_l", filename=fname,
                is_key_frame=False, timestamp=ts, fileformat="pcd", prev="",
                next=""))
    for name, rows in tables.items():
        (v / f"{name}.json").write_text(json.dumps(rows))


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _zip_members(root):
    out = {}
    for z in sorted(root.rglob("*.zip")):
        with zipfile.ZipFile(z) as zf:
            for name in sorted(zf.namelist()):
                out[f"{z.relative_to(root).as_posix()}:{name}"] = zf.read(
                    name)
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{case: (raw root, JAX tree, port tree)} for the plain tables and the
    tables with sweeps, each converted by both packages (sweeps kept)."""
    out = {}
    for case in ("raw", "sweeps"):
        base = tmp_path_factory.mktemp(case)
        raw = base / "raw"
        raw.mkdir()
        test_dataset.TestNuscenesConverter._raw(None, raw)
        if case == "sweeps":
            _add_sweeps(raw, np.random.default_rng(3))
        JConv.convert_dataset_inpath(raw, base / "jax", store_inter=SWEEPS)
        TConv.convert_dataset_inpath(raw, base / "port", store_inter=SWEEPS)
        out[case] = (raw, base / "jax", base / "port")
    return out


@pytest.mark.parametrize("case", ["raw", "sweeps"])
def test_converter_tree_matches_jax(trees, case):
    """File for file, byte for byte, the port's converted tree is the JAX
    package's (scene json, lidar and camera blobs, annotations with their
    finite-difference velocities, poses, timestamps, intermediate sweeps
    and their meta)."""
    _, jtree, ttree = trees[case]
    want, got = _files(jtree), _files(ttree)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    inter = [n for n in want if n.startswith("trainval/scene-0001/inter")]
    assert len(inter) == (2 + 2 * SWEEPS if case == "sweeps" else 2)


def test_zipped_converter_matches_jax(trees, tmp_path):
    """With ``zip_output`` each scene is one zip: the same members with the
    same bytes."""
    raw = trees["sweeps"][0]
    JConv.convert_dataset_inpath(raw, tmp_path / "jax", zip_output=True,
                                 store_inter=SWEEPS)
    TConv.convert_dataset_inpath(raw, tmp_path / "port", zip_output=True,
                                 store_inter=SWEEPS)
    want, got = _zip_members(tmp_path / "jax"), _zip_members(tmp_path / "port")
    assert got == want and len(want) > 10


def test_converter_console_script(trees, tmp_path, monkeypatch):
    """``d3d_tpu_torch_nuscenes_convert`` (the module's ``main``) writes
    the same tree as the function call."""
    raw, jtree, _ = trees["sweeps"]
    monkeypatch.setattr(sys, "argv", ["d3d_tpu_torch_nuscenes_convert",
                                      str(raw), str(tmp_path),
                                      "-i", str(SWEEPS)])
    TConv.main()
    assert _files(tmp_path) == _files(jtree)
    text = (ROOT / "pyproject.toml").read_text()
    assert ('d3d_tpu_torch_nuscenes_convert = '
            '"d3d_tpu_torch.dataset.nuscenes.converter:main"') in text


def _loaders(tree):
    return (JLoader(tree, phase="training", trainval_split="official"),
            TLoader(tree, phase="training", trainval_split="official"))


def _same_array(a, b):
    assert len(a) == len(b) and a.frame == b.frame
    if len(a):
        ca, cb = a.columns(), b.columns()
        for k in ("position", "dimension", "quat", "label", "score", "tid"):
            np.testing.assert_array_equal(ca[k], cb[k], k)
        for oa, ob in zip(a, b):
            assert type(oa).__name__ == type(ob).__name__
            if hasattr(ob, "velocity"):
                np.testing.assert_array_equal(oa.velocity, ob.velocity)
            assert oa.aux == ob.aux and oa.tag_top.name == ob.tag_top.name


@pytest.mark.parametrize("case", ["raw", "sweeps"])
def test_loader_accessors_match_jax(trees, case):
    """Every accessor of the port's loader on the converted tree equals the
    JAX package's: scenes and frames, lidar clouds, sweeps with their poses,
    annotations (ego frame, wlh to lwh, instance tids, velocities), poses,
    timestamps, metadata, tokens, calibrations, camera images."""
    jl, tl = _loaders(trees[case][1])
    assert len(tl) == len(jl) == 2
    assert tl.sequence_ids == list(jl.sequence_ids)
    assert tl.sequence_sizes == jl.sequence_sizes
    assert list(tl.frames) == list(jl.frames)
    for i in range(len(jl)):
        np.testing.assert_array_equal(tl.lidar_data(i), jl.lidar_data(i))
        _same_array(tl.annotation_3dobject(i), jl.annotation_3dobject(i))
        _same_array(tl.annotation_3dobject(i, with_velocity=False),
                    jl.annotation_3dobject(i, with_velocity=False))
        assert (tl.annotation_3dobject(i, raw=True)
                == jl.annotation_3dobject(i, raw=True))
        for a, b in ((tl.pose(i), jl.pose(i)),):
            np.testing.assert_array_equal(a.position, b.position)
            np.testing.assert_array_equal(a.homo(), b.homo())
        assert tl.timestamp(i) == jl.timestamp(i)
        assert tl.metadata(i) == jl.metadata(i)
        assert tl.token(i) == jl.token(i)
        assert tl.token(i, names="cam_front") == jl.token(i,
                                                          names="cam_front")
        tc, jc = tl.calibration_data(i), jl.calibration_data(i)
        for frame in ("lidar_top", "cam_front"):
            np.testing.assert_array_equal(
                tc.get_extrinsic(frame_from=frame),
                jc.get_extrinsic(frame_from=frame))
        ti, ji = tl.intermediate_data(i), jl.intermediate_data(i)
        assert len(ti) == len(ji) == (SWEEPS if case == "sweeps" else 0)
        for a, b in zip(ti, ji):
            np.testing.assert_array_equal(a.data, b.data)
            assert a.timestamp == b.timestamp
            np.testing.assert_array_equal(a.pose.homo(), b.pose.homo())
        assert (tl.camera_data(i, names="cam_front").size
                == jl.camera_data(i, names="cam_front").size)
    objs = tl.annotation_3dobject(0)
    assert objs[0].tid == int("ab12cd34", 16)
    assert objs[0].velocity[0] == pytest.approx(4.0, abs=1e-4)


def test_submission_entries_match_jax(trees):
    """dump_detection_output and dump_tracking_output give the same
    entries (global frame, wlh, wxyz, velocity, tracking fields)."""
    jl, tl = _loaders(trees["sweeps"][1])
    for i in range(len(jl)):
        ta, ja = tl.annotation_3dobject(i), jl.annotation_3dobject(i)
        assert tl.dump_detection_output(i, ta) == jl.dump_detection_output(
            i, ja)
        assert tl.dump_tracking_output(i, ta) == jl.dump_tracking_output(
            i, ja)


@pytest.mark.parametrize("nsweeps", [1, 2, 10])
def test_accumulate_sweeps_matches_jax(trees, nsweeps):
    """The keyframe cloud plus the newest ``nsweeps - 1`` sweeps, each
    motion-compensated into the keyframe sensor frame with the float64
    pose chain and tagged with its age: the same (N, 5) cloud as the JAX
    package's, bit for bit; ``max_points`` cuts the same rows."""
    jl, tl = _loaders(trees["sweeps"][1])
    for i in range(len(jl)):
        want = JSweeps.accumulate_sweeps(jl, i, nsweeps=nsweeps)
        got = TSweeps.accumulate_sweeps(tl, i, nsweeps=nsweeps)
        assert got.dtype == np.float32 and got.shape[1] == 5
        np.testing.assert_array_equal(got, want)
        ages = np.unique(got[:, 4])
        assert len(ages) == min(nsweeps, SWEEPS + 1)
    np.testing.assert_array_equal(
        TSweeps.accumulate_sweeps(tl, 1, max_points=70),
        JSweeps.accumulate_sweeps(jl, 1, max_points=70))


def test_loader_runs_without_msgpack(trees, tmp_path):
    """Without msgpack the port's loader reads the scenes' stats itself
    and writes no cache; with it, it writes ``metadata.msg`` as the JAX
    loader does. Neither imports sortedcontainers."""
    import shutil

    tree = tmp_path / "tree"
    shutil.copytree(trees["raw"][2], tree)
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['sortedcontainers'] = None\n"
        "from d3d_tpu_torch.dataset.nuscenes import NuscenesLoader\n"
        f"l = NuscenesLoader({str(tree)!r}, phase='training')\n"
        "print(len(l), l.metadata(1).sample_token)\n")
    res = run_python(code, ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["2", "s1"]
    assert not (tree / "trainval" / "metadata.msg").exists()
    TLoader(tree, phase="training")
    assert (tree / "trainval" / "metadata.msg").exists()


def test_taxonomy_matches_jax():
    """The class tables and the official splits are the JAX package's."""
    from d3d_tpu.dataset.nuscenes import constants as JConst

    for name in ("NuscenesObjectClass", "NuscenesDetectionClass",
                 "NuscenesSegmentationClass"):
        j, t = getattr(JConst, name), getattr(TConst, name)
        assert [(c.name, c.value) for c in t] == [(c.name, c.value)
                                                  for c in j]
    for split in ("train_detect", "train_track", "train_split", "val_split"):
        assert getattr(TConst, split) == getattr(JConst, split)
    c = TConst.NuscenesObjectClass.parse("vehicle.bus.rigid")
    assert c.to_detection() == TConst.NuscenesDetectionClass.bus
    assert (TConst.NuscenesObjectClass.from_nuscenes_id(17)
            == TConst.NuscenesObjectClass.vehicle_car)

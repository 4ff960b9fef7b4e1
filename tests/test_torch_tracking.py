"""The port's tracking package against the JAX package: the device
tracker's slot tables on seeded sequences (capacity saturation, class gates,
coast and prune), its report, the fused detect -> track step on a TINY
VoxelNeXt, and the host trackers (``CenterTracker``, ``VanillaTracker``)
and every filter on the same inputs.

The device sequences have one fixed shape, so the JAX scan compiles once.
Tolerances: ids, labels, active masks and the next id exact; slot boxes,
velocities, scores and clocks within 1e-5 (XLA:CPU fuses the backcast's and
the coast's multiply-add, torch does not); host numpy modules to 1e-9."""

import dataclasses

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu import abstraction as JA
from d3d_tpu import tracking as JT
from d3d_tpu.dataset.kitti.utils import KittiObjectClass as JClass
from d3d_tpu.models.inference import make_voxelnext_detector
from d3d_tpu.models.voxelnext import VoxelNeXt, voxelnext_voxelize
from d3d_tpu.tracking import device_tracker as JD
from d3d_tpu.tracking import filter as JF

from d3d_tpu_torch import abstraction as TA
from d3d_tpu_torch import tracking as TT
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TClass
from d3d_tpu_torch.models import VoxelNeXt as TVoxelNeXt
from d3d_tpu_torch.models import VoxelNeXtConfig as TConfig
from d3d_tpu_torch.models import make_voxelnext_detector as t_detector
from d3d_tpu_torch.models import voxelnext_state_from_flax
from d3d_tpu_torch.tracking import device_tracker as TD
from d3d_tpu_torch.tracking import filter as TF

from tests.test_torch_second import _randomize
from tests.test_voxelnext import TINY, _cloud

F, D, CAP = 10, 40, 24
THRESHOLDS = np.array([2.0, 0.8, 4.0], np.float32)
LOST = 0.25
SLOT_FLOAT = ("boxes", "vel", "score", "lost", "history")
SLOT_EXACT = ("label", "tid", "active", "next_tid")


def _sequence(seed):
    """(F, D) detections of objects moving at constant velocity, seen with
    jitter in most frames (some drop out for a few frames: coast, re-take
    or prune), three classes with their own gates, plus noise detections;
    more admitted rows than slots in the busy frames (saturation)."""
    rng = np.random.default_rng(seed)
    n_obj = 30
    pos = rng.uniform(-40, 40, (n_obj, 3)) * [1, 1, 0.05]
    vel = rng.normal(0, 3, (n_obj, 3)) * [1, 1, 0.1]
    cls = rng.integers(0, 3, n_obj)
    dts = np.full(F, 0.1, np.float32)
    dts[0] = 0.0
    t = np.cumsum(dts)
    boxes = np.zeros((F, D, 7), np.float32)
    boxes[..., 3:6] = [4.0, 1.8, 1.6]
    v = np.zeros((F, D, 3), np.float32)
    scores = rng.uniform(0.05, 1.0, (F, D)).astype(np.float32)
    labels = rng.integers(0, 3, (F, D)).astype(np.int32)
    valid = rng.random((F, D)) < 0.85
    for f in range(F):
        seen = rng.random(n_obj) < (0.5 if 3 <= f <= 5 else 0.95)
        for k, i in enumerate(np.flatnonzero(seen)[:D]):
            boxes[f, k, :3] = pos[i] + t[f] * vel[i] + rng.normal(0, 0.05, 3)
            boxes[f, k, 6] = 0.3 * i
            v[f, k] = vel[i] + rng.normal(0, 0.1, 3)
            labels[f, k] = cls[i]
        rest = slice(int(seen.sum()), D)
        boxes[f, rest, :3] = rng.uniform(-50, 50, (D - int(seen.sum()), 3))
    return boxes, scores, labels, v, valid, dts


def _slots_equal(got, want, where=""):
    for k in SLOT_EXACT:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f"{k} {where}")
    for k in SLOT_FLOAT:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{k} {where}")


@pytest.fixture(scope="module")
def scans():
    """seed -> (inputs, the JAX scan's per-frame slot tables)."""
    out = {}
    thr = jnp.asarray(THRESHOLDS)
    for seed in (1, 2, 3):
        seq = _sequence(seed)
        _, per = JD.tracker_scan_sequence(
            JD.tracker_init(CAP), *(jnp.asarray(a) for a in seq), thr,
            jnp.float32(LOST))
        out[seed] = seq, jax.tree.map(np.asarray, per)
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_scan_slot_tables_match(scans, seed):
    """Every frame's slot table equal to the JAX scan's; the sequence
    saturates the table, prunes coasting tracks, and a class's gate
    holds."""
    seq, want = scans[seed]
    _, got = TD.tracker_scan_sequence(TD.tracker_init(CAP, "cpu"), *seq,
                                      THRESHOLDS, LOST)
    for f in range(F):
        _slots_equal({k: v[f] for k, v in got.items()},
                     {k: v[f] for k, v in want.items()}, f"frame {f}")
    act = want["active"]
    assert act.all(axis=1).any(), "the table never saturated"
    assert (act[:-1] & ~act[1:]).any(), "no track was pruned"
    assert want["next_tid"][-1] > CAP


def test_update_matches_frame_by_frame(scans):
    """tracker_update one frame at a time, inputs on both sides as the
    callers hand them (two-column velocities, a Python dt), equal to the
    JAX function's tables."""
    (boxes, scores, labels, vel, valid, dts), _ = scans[1]
    st_j = JD.tracker_init(CAP)
    st_t = TD.tracker_init(CAP, "cpu")
    rows = TD.tracker_update.rows
    for f in range(4):
        st_j = JD.tracker_update(
            st_j, jnp.asarray(boxes[f]), jnp.asarray(scores[f]),
            jnp.asarray(labels[f]), jnp.asarray(vel[f, :, :2]),
            jnp.asarray(valid[f]), jnp.float32(dts[f]),
            jnp.asarray(THRESHOLDS), jnp.float32(LOST))
        before = {k: v.clone() for k, v in st_t.items()}
        new = TD.tracker_update(st_t, boxes[f], scores[f], labels[f],
                                vel[f, :, :2], valid[f], float(dts[f]),
                                THRESHOLDS, LOST)
        # the given state is left as it was
        assert all(torch.equal(before[k], st_t[k]) for k in before)
        st_t = new
        _slots_equal(st_t, jax.tree.map(np.asarray, st_j), f"frame {f}")
    assert TD.tracker_update.rows - rows == int(valid[:4].sum())


def test_report_matches(scans):
    """The final slot table reported as TrackingTarget3Ds: the same tids,
    tags, positions, velocities and histories, in slot order."""
    seq, want = scans[2]
    final, _ = TD.tracker_scan_sequence(TD.tracker_init(CAP, "cpu"), *seq,
                                        THRESHOLDS, LOST)
    jstate = {k: jnp.asarray(v[-1]) for k, v in want.items()}
    classes = [JClass.Car, JClass.Pedestrian, JClass.Cyclist]
    tclasses = [TClass.Car, TClass.Pedestrian, TClass.Cyclist]
    a = JD.tracker_report(jstate, classes, frame="velo", timestamp=9)
    b = TD.tracker_report(final, tclasses, frame="velo", timestamp=9)
    assert len(a) == len(b) > 0 and b.timestamp == 9
    for x, y in zip(a, b):
        assert type(y).__name__ == "TrackingTarget3D"
        assert (y.tid, y.tag.labels) == (x.tid, x.tag.labels)
        np.testing.assert_allclose(y.position, x.position, atol=1e-5)
        np.testing.assert_allclose(y.velocity, x.velocity, atol=1e-5)
        assert y.history == pytest.approx(x.history, abs=1e-5)


def test_tracking_step_on_a_tiny_voxelnext():
    """make_tracking_step on TINY VoxelNeXt with the velocity head (the
    same flax weights both sides) over three frames 0.5 s apart: the
    detector outputs as tests/test_torch_voxelnext.py holds them, the slot
    tables' ids, labels and masks exact, slot boxes within 1e-4 (the
    detections' own tolerance)."""
    cfg = dataclasses.replace(TINY, predict_velocity=True)
    rng = np.random.default_rng(11)
    clouds = [_cloud(rng) for _ in range(3)]
    model = VoxelNeXt(cfg)
    f, c, v = jax.jit(voxelnext_voxelize, static_argnums=1)(
        jnp.asarray(clouds[0]), cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), f[None],
                            c[None], v[None])
    variables = _randomize(shapes, np.random.default_rng(4))
    jdet = make_voxelnext_detector(model, variables, cfg,
                                   [JClass.Car, JClass.Pedestrian])
    tmodel = TVoxelNeXt(TConfig(**dataclasses.asdict(cfg)), device="cpu")
    tdet = t_detector(tmodel, voxelnext_state_from_flax(variables),
                      tmodel.cfg, [TClass.Car, TClass.Pedestrian],
                      device="cpu")
    jstep = JD.make_tracking_step(jdet.device_fn, [3.0, 1.0], capacity=16,
                                  score_threshold=0.0)
    tstep = TD.make_tracking_step(tdet.device_fn, [3.0, 1.0], capacity=16,
                                  score_threshold=0.0)
    sj, st = jstep.init(), tstep.init()
    assert st["boxes"].device.type == "cpu"
    for i, pts in enumerate(clouds):
        dt = 0.0 if i == 0 else 0.5
        sj, _ = jstep(sj, jnp.asarray(pts), jnp.float32(dt))
        st, out = tstep(st, pts, dt)
        assert len(out) == 5
        got, want = st, jax.tree.map(np.asarray, sj)
        for k in SLOT_EXACT:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        for k in SLOT_FLOAT:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    assert int(want["active"].sum()) > 0 and want["next_tid"] > 1


def _twins(det_rows, velocity=True):
    """The same detections as the JAX package's and the port's
    TrackingTarget3D (or ObjectTarget3D) arrays."""
    out = []
    for A, C in ((JA, JClass), (TA, TClass)):
        objs = []
        for r in det_rows:
            tag = A.ObjectTag(C(int(r["cls"])), C, scores=float(r["score"]))
            rot = Rotation.from_euler("Z", r["yaw"])
            if velocity:
                objs.append(A.TrackingTarget3D(
                    r["pos"], rot, r["dim"], r["vel"], [0, 0, 0], tag))
            else:
                objs.append(A.ObjectTarget3D(
                    r["pos"], rot, r["dim"], tag,
                    position_var=np.diag([0.2, 0.2, 0.1]),
                    dimension_var=np.eye(3) * 0.05,
                    orientation_var=0.01))
        out.append(objs)
    return out


def _host_sequence(seed, frames=6):
    """Per frame, detection rows of 5 objects on a 6 m lattice (no
    borderline distances), one missing for a frame, plus a newcomer."""
    rng = np.random.default_rng(seed)
    cell = rng.permutation(36)[:5]
    pos = np.stack([cell // 6, cell % 6], 1) * 6.0 - 15.0
    vel = rng.normal(0, 1.0, (5, 2)).round(1)
    cls = [JClass.Car.value, JClass.Car.value, JClass.Pedestrian.value,
           JClass.Car.value, JClass.Cyclist.value]
    seq = []
    for f in range(frames):
        rows = [dict(pos=[*(pos[i] + 0.1 * f * vel[i]), -1.0],
                     vel=[*vel[i], 0.0], dim=[4.0, 1.8, 1.6],
                     yaw=0.2 * i + 0.05 * f, score=0.5 + 0.08 * i,
                     cls=cls[i])
                for i in range(5) if not (f == 3 and i == seed % 5)]
        if f >= 4:
            rows.append(dict(pos=[30.0 + f, -30.0, -1.0], vel=[1, 0, 0],
                             dim=[4.0, 1.8, 1.6], yaw=0.0, score=0.95,
                             cls=JClass.Car.value))
        seq.append(rows)
    return seq


def _reports_equal(a, b, atol=1e-9):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (y.tid, y.tag.labels) == (x.tid, x.tag.labels)
        np.testing.assert_allclose(y.position, x.position, atol=atol)
        np.testing.assert_allclose(y.velocity, x.velocity, atol=atol)
        np.testing.assert_allclose(y.dimension, x.dimension, atol=atol)
        assert y.history == pytest.approx(x.history, abs=atol)


@pytest.mark.parametrize("seed", [1, 4])
def test_center_tracker_matches(seed):
    """CenterTracker (host numpy) on the same frames: every report equal
    (tids, tags, positions, velocities, histories) to 1e-9; and the
    device tracker's trajectories isomorphic to it, as
    tests/test_device_tracker.py holds the JAX pair."""
    gates = {JClass.Car.value: 2.0, JClass.Pedestrian.value: 1.0,
             JClass.Cyclist.value: 2.0}
    j = JT.CenterTracker(distance_threshold=gates, lost_time=0.25)
    t = TT.CenterTracker(distance_threshold=gates, lost_time=0.25)
    dev = TT.DeviceCenterTracker(
        [TClass.Car, TClass.Pedestrian, TClass.Cyclist], gates,
        lost_time=0.25, device="cpu")
    host_traj, dev_traj = {}, {}
    for f, rows in enumerate(_host_sequence(seed)):
        jd, td = _twins(rows)
        j.update(JA.Target3DArray(jd, frame="velo", timestamp=f * 100_000))
        fr = TA.Target3DArray(td, frame="velo", timestamp=f * 100_000)
        t.update(fr)
        dev.update(fr)
        _reports_equal(j.report(), t.report())
        for rep, traj in ((t.report(), host_traj), (dev.report(), dev_traj)):
            for o in rep:
                traj.setdefault(o.tid, []).append(
                    (f, tuple(np.round(np.asarray(o.position[:2]), 4))))
    assert sorted(map(tuple, host_traj.values())) == \
        sorted(map(tuple, dev_traj.values()))
    assert dev.tracked_ids and len(host_traj) >= 6


@pytest.mark.parametrize("pose", ["Pose_3DOF_UKF_CV", "Pose_3DOF_UKF_CTRV",
                                  "Pose_3DOF_UKF_CTRA"])
def test_vanilla_tracker_matches(pose):
    """VanillaTracker with each pose filter, the Hungarian matcher and the
    position gate: every report equal to the JAX package's to 1e-9."""
    kw = dict(matcher_distance_threshold=2.0, lost_time=0.25)
    j = JT.VanillaTracker(getattr(JF, pose), **kw)
    t = TT.VanillaTracker(getattr(TF, pose), **kw)
    for f, rows in enumerate(_host_sequence(7)):
        jd, td = _twins(rows, velocity=False)
        j.update(JA.Target3DArray(jd, frame="velo", timestamp=f * 100_000))
        t.update(TA.Target3DArray(td, frame="velo", timestamp=f * 100_000))
        _reports_equal(j.report(), t.report())
        assert t.match_count == j.match_count
    assert len(t.tracked_ids) >= 5


@pytest.mark.parametrize("name", ["Box_KF", "Pose_3DOF_UKF_CV",
                                  "Pose_3DOF_UKF_CTRV", "Pose_3DOF_UKF_CTRA",
                                  "Pose_IMM"])
def test_filters_match(name):
    """Each filter fed the same detections (predict, update), its state
    surface equal to the JAX package's to 1e-9 after every step."""
    rows = [r[1] for r in _host_sequence(3, frames=8)]
    jd, td = _twins(rows, velocity=False)
    jf, tf = getattr(JF, name)(jd[0]), getattr(TF, name)(td[0])
    props = (("dimension", "dimension_var") if name == "Box_KF" else
             ("position", "position_var", "velocity", "velocity_var",
              "angular_velocity", "orientation_var"))
    for a, b in zip(jd[1:], td[1:]):
        jf.predict(0.1)
        tf.predict(0.1)
        jf.update(a)
        tf.update(b)
        for p in props:
            np.testing.assert_allclose(np.asarray(getattr(tf, p)),
                                       np.asarray(getattr(jf, p)),
                                       rtol=1e-9, atol=1e-9, err_msg=p)
    if name == "Pose_IMM":
        np.testing.assert_allclose(tf.model_probabilities,
                                   jf.model_probabilities, atol=1e-12)


def test_motion_models_match():
    """The motion models and wrap_angle: equal on the same states."""
    rng = np.random.default_rng(5)
    for _ in range(20):
        s4, s5, s6 = (rng.normal(0, 2, n) for n in (4, 5, 6))
        dt = float(rng.uniform(0.05, 0.5))
        for fn, s in (("motion_CV", s4), ("motion_CTRV", s5),
                      ("motion_CTRA", s6)):
            np.testing.assert_allclose(getattr(TF, fn)(s, dt),
                                       getattr(JF, fn)(s, dt), atol=1e-12)
    th = rng.uniform(-10, 10, 50)
    np.testing.assert_array_equal(TF.wrap_angle(th), JF.wrap_angle(th))

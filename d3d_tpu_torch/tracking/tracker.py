"""Host-side multi-object Kalman tracking (the port's own copy of
``d3d_tpu.tracking.tracker``, host numpy).

API parity target: the public ``VanillaTracker`` contract of reference
d3d/tracking/tracker.py:8-204 (constructor kwargs, ``update``/``report``/
``tracked_ids``/``match_count``, microsecond timestamps, tids counted
from 1). The internals are this repo's own: one ``_Track`` record per
tracklet bundling its filters and age clocks, association factored into
``_associate``, and track snapshots built by the record itself. The
velocity trackers (:mod:`d3d_tpu_torch.tracking.device_tracker`,
:mod:`d3d_tpu_torch.tracking.center_tracker`) are the production path; this
class is the small-N host reference implementation.
"""

import itertools

import numpy as np

from ..abstraction import ObjectTarget3D, Target3DArray, TrackingTarget3D
from .filter import Box_KF, Pose_3DOF_UKF_CTRA
from .matcher import DistanceTypes, HungarianMatcher

__all__ = ["VanillaTracker"]

_GATE_KINDS = {
    "iou": DistanceTypes.IoU,
    "riou": DistanceTypes.RIoU,
    "position": DistanceTypes.Position,
}


class _Track:
    """One live tracklet: a pose filter and an extent/class filter plus the
    consecutive tracked/lost clocks that drive the pruning policy."""

    __slots__ = ("tid", "motion", "shape", "time_tracked", "time_lost")

    def __init__(self, tid, motion, shape):
        self.tid = tid
        self.motion = motion
        self.shape = shape
        self.time_tracked = 0.0
        self.time_lost = 0.0

    def advance(self, dt):
        self.motion.predict(dt)
        self.shape.predict(dt)

    def absorb(self, detection, dt):
        self.motion.update(detection)
        self.shape.update(detection)
        self.time_tracked += dt
        self.time_lost = 0.0

    def miss(self, dt):
        self.time_lost += dt
        self.time_tracked = 0.0

    def _estimate(self):
        return dict(
            position=self.motion.position,
            orientation=self.motion.orientation,
            dimension=self.shape.dimension,
            tag=self.shape.classification,
            tid=self.tid,
            # unfiltered covariance slots read as +inf; clamp for consumers
            # (matchers, serializers) that need finite numbers
            position_var=np.nan_to_num(self.motion.position_var, posinf=1e6),
            orientation_var=self.motion.orientation_var,
            dimension_var=self.shape.dimension_var,
        )

    def as_object(self):
        """Pose-only snapshot, used for association."""
        return ObjectTarget3D(**self._estimate())

    def as_tracked(self):
        """Full snapshot with motion state, used for reporting."""
        return TrackingTarget3D(
            velocity=self.motion.velocity,
            velocity_var=self.motion.velocity_var,
            angular_velocity=self.motion.angular_velocity,
            angular_velocity_var=self.motion.angular_velocity_var,
            history=self.time_tracked,
            **self._estimate(),
        )


class VanillaTracker:
    """Vanilla Kalman-filter tracker.

    :param pose_tracker_factory: builds a pose filter from an initial detection
    :param feature_tracker_factory: builds a property filter from a detection
    :param matcher_factory: builds the target matcher
    :param matcher_distance_type: "iou" | "riou" | "position" or DistanceTypes
    :param matcher_distance_threshold: scalar or per-class-value dict
    :param lost_time: seconds a target may stay unmatched before removal
    :param device: where the matcher computes IoU distances (the "iou" and
        "riou" gates; default CUDA); the "position" gate is host numpy
    """

    def __init__(self, pose_tracker_factory=Pose_3DOF_UKF_CTRA,
                 feature_tracker_factory=Box_KF,
                 matcher_factory=HungarianMatcher,
                 matcher_distance_type="position",
                 matcher_distance_threshold=1, lost_time=1,
                 default_position_var=np.eye(3),
                 default_dimension_var=np.eye(3),
                 default_orientation_var=1, device=None):
        self._tracks = {}
        self._tid_source = itertools.count(1)  # tid 0 means "no id"
        self._clock = None  # seconds; drives filter dt
        self._clock_raw = 0  # input unit (microseconds); echoed in outputs
        self._frame = None
        self._horizon = lost_time

        self._new_motion = pose_tracker_factory
        self._new_shape = feature_tracker_factory
        self._matcher = matcher_factory()
        if isinstance(matcher_distance_type, str):
            matcher_distance_type = _GATE_KINDS[matcher_distance_type.lower()]
        self._gate = matcher_distance_type
        self._gate_width = matcher_distance_threshold
        self._device = device
        self._spawn_vars = (default_position_var, default_dimension_var,
                            default_orientation_var)

    # -- track lifecycle ------------------------------------------------------
    def _spawn(self, detection):
        tid = next(self._tid_source)
        self._tracks[tid] = _Track(tid, self._new_motion(detection),
                                   self._new_shape(detection))

    def _backfill_vars(self, detection):
        """Detections arriving without covariances get the tracker's
        configured defaults before feeding any filter."""
        pos_var, dim_var, ori_var = self._spawn_vars
        if not np.any(detection.position_var):
            detection.position_var = pos_var
        if not np.any(detection.dimension_var):
            detection.dimension_var = dim_var
        if not np.any(detection.orientation_var):
            detection.orientation_var = ori_var

    def _associate(self, detections):
        """Match detections against predicted track states; returns
        {detection index: tid}."""
        order = list(self._tracks)
        predicted = Target3DArray(
            [self._tracks[tid].as_object() for tid in order],
            frame=detections.frame, timestamp=self._clock_raw)

        gates = self._gate_width
        if not isinstance(gates, dict):
            width = float(gates)
            gates = {obj.tag_top.value: width
                     for obj in itertools.chain(detections, predicted)}
        self._matcher.prepare_boxes(detections, predicted, self._gate,
                                    device=self._device)
        self._matcher.match(range(len(detections)), range(len(predicted)),
                            gates)
        pairing = {}
        for src in range(len(detections)):
            dst = self._matcher.query_src_match(src)
            if dst >= 0:
                pairing[src] = order[dst]
        return pairing

    # -- public surface -------------------------------------------------------
    @property
    def tracked_ids(self):
        return list(self._tracks)

    @property
    def match_count(self):
        return self._matcher.num_of_matches()

    def update(self, detections):
        """Feed a new frame of detections (timestamp in microseconds)."""
        now = detections.timestamp / 1e6
        if self._clock is None:
            for det in detections:
                self._backfill_vars(det)
                self._spawn(det)
        else:
            dt = now - self._clock
            for track in self._tracks.values():
                track.advance(dt)
            pairing = self._associate(detections)
            veterans = list(self._tracks.values())  # spawned tracks don't age
            hits = set()
            for src, det in enumerate(detections):
                self._backfill_vars(det)
                tid = pairing.get(src)
                if tid is None:
                    self._spawn(det)
                else:
                    self._tracks[tid].absorb(det, dt)
                    hits.add(tid)
            for track in veterans:
                if track.tid not in hits:
                    track.miss(dt)
            self._tracks = {tid: track for tid, track in self._tracks.items()
                            if track.time_lost <= self._horizon}

        self._clock = now
        self._clock_raw = detections.timestamp
        self._frame = detections.frame

    def report(self):
        """Current tracked targets as a TrackingTarget3D array."""
        return Target3DArray(
            [track.as_tracked() for track in self._tracks.values()],
            frame=self._frame, timestamp=self._clock_raw)

"""Velocity-backcast greedy tracker — the CenterPoint tracking recipe (the
port's own copy of ``d3d_tpu.tracking.center_tracker``, host numpy).

Yin et al. (CVPR 2021, §"Tracking") track WITHOUT a motion filter: the
detector's own predicted BEV velocity backcasts each detection to the
previous frame's time, and a confidence-ordered greedy closest-center
match (same class, distance-gated) carries the track id over; unmatched
tracks coast on their last velocity for a grace period. This complements
:class:`~d3d_tpu_torch.tracking.VanillaTracker` (the reference-parity Kalman
pipeline, d3d/tracking/tracker.py) as the natural consumer of a
velocity head (``VoxelNeXtConfig(predict_velocity=True)``).

Association is a single vectorized distance matrix per frame — no
per-pair Python math.
"""

import numpy as np

from ..abstraction import Target3DArray, TrackingTarget3D

__all__ = ["CenterTracker"]


class CenterTracker:
    """Greedy velocity-backcast tracker.

    :param distance_threshold: max center distance (m) for an association;
        scalar or ``{class_value: threshold}`` dict
    :param lost_time: seconds an unmatched track coasts before removal
    """

    def __init__(self, distance_threshold=1.0, lost_time=0.3):
        self._threshold = distance_threshold
        self._lost_time = lost_time
        self._tracks = {}          # tid -> dict(state)
        self._id_counter = 1
        self._last_ts = None       # seconds
        self._last_ts_us = 0
        self._last_frame = None

    @property
    def tracked_ids(self):
        return list(self._tracks)

    def reset(self):
        """Start a fresh sequence: drop all tracks and timestamps (tids
        keep counting up — uniqueness across sequences)."""
        self._tracks = {}
        self._last_ts = None
        self._last_ts_us = 0
        self._last_frame = None

    def _thr(self, label):
        if isinstance(self._threshold, dict):
            return float(self._threshold[label])
        return float(self._threshold)

    def _new_track(self, det, dt):
        self._tracks[self._id_counter] = dict(
            position=np.asarray(det.position, np.float64).copy(),
            velocity=np.asarray(getattr(det, "velocity", (0, 0, 0)),
                                np.float64).copy(),
            orientation=det.orientation,
            dimension=np.asarray(det.dimension, np.float64).copy(),
            tag=det.tag, lost=0.0, history=0.0)
        self._id_counter += 1

    def update(self, detections):
        """Feed a frame of detections (``Target3DArray``, timestamp in
        microseconds; elements with a ``velocity`` attribute use it for
        the backcast, others backcast by zero)."""
        ts = detections.timestamp / 1e6
        self._last_ts_us = detections.timestamp
        self._last_frame = detections.frame
        if self._last_ts is None:
            dt = 0.0
            for det in detections:
                self._new_track(det, dt)
            self._last_ts = ts
            return
        dt = ts - self._last_ts

        tids = list(self._tracks)
        tpos = np.array([self._tracks[t]["position"][:2] for t in tids],
                        np.float64).reshape(-1, 2)
        # ObjectTag.labels hold int values (the enum lives in .mapping)
        tlab = np.array([self._tracks[t]["tag"].labels[0] for t in tids])

        n = len(detections)
        if n:
            dpos = np.array([d.position[:2] for d in detections],
                            np.float64)
            dvel = np.array([
                np.asarray(getattr(d, "velocity", (0, 0, 0)))[:2]
                for d in detections], np.float64)
            dlab = np.array([d.tag.labels[0] for d in detections])
            dscore = np.array([d.tag_top_score for d in detections])
            # backcast detections to the previous frame time
            back = dpos - dt * dvel
            if len(tids):
                dist = np.linalg.norm(back[:, None, :] - tpos[None, :, :],
                                      axis=-1)
                dist = np.where(dlab[:, None] == tlab[None, :], dist,
                                np.inf)
            else:
                dist = np.zeros((n, 0))

        matched_tracks = set()
        order = np.argsort(-dscore, kind="stable") if n else []
        for i in order:
            det = detections[int(i)]
            j = -1
            if dist.shape[1]:
                cand = np.where(
                    [tids[c] in matched_tracks for c in
                     range(len(tids))], np.inf, dist[int(i)])
                j = int(np.argmin(cand))
                if not np.isfinite(cand[j]) \
                        or cand[j] > self._thr(dlab[int(i)]):
                    j = -1
            if j < 0:
                self._new_track(det, dt)
            else:
                tid = tids[j]
                matched_tracks.add(tid)
                tr = self._tracks[tid]
                tr["position"] = np.asarray(det.position,
                                            np.float64).copy()
                tr["velocity"] = np.asarray(
                    getattr(det, "velocity", (0, 0, 0)),
                    np.float64).copy()
                tr["orientation"] = det.orientation
                tr["dimension"] = np.asarray(det.dimension,
                                             np.float64).copy()
                tr["tag"] = det.tag
                tr["lost"] = 0.0
                tr["history"] += dt

        # unmatched tracks coast on their last velocity
        for tid in tids:
            if tid not in matched_tracks:
                tr = self._tracks[tid]
                tr["position"] = tr["position"] + dt * tr["velocity"]
                tr["lost"] += dt
                tr["history"] = 0.0
        for tid in [t for t, tr in self._tracks.items()
                    if tr["lost"] > self._lost_time]:
            del self._tracks[tid]

        self._last_ts = ts

    def report(self):
        """Current tracks as a ``TrackingTarget3D`` array (tids set)."""
        arr = Target3DArray(frame=self._last_frame,
                            timestamp=self._last_ts_us)
        for tid, tr in self._tracks.items():
            arr.append(TrackingTarget3D(
                tr["position"], tr["orientation"], tr["dimension"],
                tr["velocity"], [0.0, 0.0, 0.0], tr["tag"], tid=tid,
                history=tr["history"]))
        return arr

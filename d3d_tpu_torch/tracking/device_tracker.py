"""Device-resident velocity-backcast tracker (port of
``d3d_tpu.tracking.device_tracker``): the track state is a dict of
fixed-capacity slot tensors on the detector's device, so detect -> track
-> report needs no host copy of the track table.

Semantics mirror :class:`~d3d_tpu_torch.tracking.CenterTracker` (the
CenterPoint recipe): detections backcast by ``dt * velocity``, a
confidence-ordered greedy nearest-center match gated per class, matched
tracks adopt the detection's state, unmatched tracks coast on their last
velocity for ``lost_time`` seconds. The slot table is finite: when all
``capacity`` slots are live, the lowest-score leftover detections are
dropped (score order allocates high-confidence tracks first).

The association is sequential by nature (the JAX module's ``lax.scan``
over score-ordered detections). Here :func:`tracker_update` reads the
admitted rows' order to the host once a frame and walks only those rows,
each step a fixed sequence of tensor operations on the device with no
host read (a row the JAX scan does not admit writes nothing there, so
skipping it is exact). ``tracker_update.rows`` counts the rows walked.
"""

from functools import partial

import numpy as np
import torch

from ..utils import as_tensor, resolve_device

__all__ = ["tracker_init", "tracker_update", "tracker_report",
           "tracker_scan_sequence", "make_tracking_step",
           "DeviceCenterTracker"]


def tracker_init(capacity=128, device=None):
    """Empty slot-table state: a dict of tensors on ``device`` (default
    CUDA)."""
    dev = resolve_device(device)

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return dict(
        boxes=zeros((capacity, 7)), vel=zeros((capacity, 3)),
        label=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        score=zeros(capacity), tid=zeros(capacity, torch.int32),
        lost=zeros(capacity), history=zeros(capacity),
        active=zeros(capacity, torch.bool),
        next_tid=torch.ones((), dtype=torch.int32, device=dev))


def _first_min(x, idx):
    """The first index of the least value of a 1-D tensor
    (``jnp.argmin``), as an integer ``amin`` of the indices holding it."""
    return torch.where(x == x.amin(), idx, x.shape[0]).amin()


def tracker_update(state, boxes, scores, labels, vel, valid, dt,
                   thresholds, lost_time):
    """One frame: associate, adopt, coast, prune, on the state's device.

    :param boxes: (D, 7) [x y z l w h yaw] detections (padded rows ok)
    :param vel: (D, 3) velocities: xy drive the backcast, the full vector
        drives coasting (a (D, 2) input is zero-padded)
    :param valid: (D,) bool admission mask (score threshold, NMS keep)
    :param dt: seconds since the previous frame (0 on the first)
    :param thresholds: (L,) per-class-label association gates (m); labels
        clip into it, so a one-entry array serves every class
    :param lost_time: seconds before an unmatched track is pruned
    :returns: the new state (the given one is not modified)
    """
    dev = state["boxes"].device
    cap = state["boxes"].shape[0]
    boxes, scores, vel = (as_tensor(t, device=dev, dtype=torch.float32)
                          for t in (boxes, scores, vel))
    labels = as_tensor(labels, device=dev).to(torch.int32)
    valid = as_tensor(valid, device=dev, dtype=torch.bool)
    thresholds = as_tensor(thresholds, device=dev,
                           dtype=torch.float32).reshape(-1)
    dt = as_tensor(dt, device=dev, dtype=torch.float32)
    lost_time = as_tensor(lost_time, device=dev, dtype=torch.float32)
    if vel.shape[-1] == 2:
        vel = torch.cat([vel, vel.new_zeros((vel.shape[0], 1))], dim=-1)
    st = {k: v.clone() for k, v in state.items()}
    active0 = state["active"]

    # the admitted rows in score order (stable, invalid rows last): the
    # frame's one host read
    order = torch.sort(torch.where(valid, -scores, torch.inf),
                       stable=True).indices
    rows = order[valid[order]]
    n = int(rows.shape[0])
    tracker_update.rows += n

    consumed = torch.zeros(cap, dtype=torch.bool, device=dev)
    slots = torch.arange(cap, device=dev)
    if n:
        b, v, sc, lab = boxes[rows], vel[rows], scores[rows], labels[rows]
        back = b[:, :2] - dt * v[:, :2]
        thr = thresholds[lab.clamp(0, thresholds.shape[0] - 1).long()]
    for r in range(n):
        d = back[r] - st["boxes"][:, :2]
        dist = torch.sqrt((d * d).sum(dim=-1))
        cand = torch.where(st["active"] & ~consumed
                           & (st["label"] == lab[r]), dist, torch.inf)
        j = _first_min(cand, slots)
        best = cand.amin()
        is_match = torch.isfinite(best) & (best <= thr[r])
        # the first inactive slot (nothing is written when there is none)
        free = torch.where(st["active"], cap, slots).amin()
        free = free.clamp_max(cap - 1)
        is_new = ~is_match & ~st["active"].all()
        at = (slots == torch.where(is_match, j, free)) & (is_match | is_new)
        new_at = at & is_new
        st["boxes"] = torch.where(at[:, None], b[r], st["boxes"])
        st["vel"] = torch.where(at[:, None], v[r], st["vel"])
        st["label"] = torch.where(at, lab[r], st["label"])
        st["score"] = torch.where(at, sc[r], st["score"])
        st["tid"] = torch.where(new_at, st["next_tid"], st["tid"])
        st["lost"] = torch.where(at, 0.0, st["lost"])
        st["history"] = torch.where(
            at, torch.where(is_new, 0.0, st["history"] + dt), st["history"])
        st["active"] = st["active"] | at
        st["next_tid"] = st["next_tid"] + is_new.to(torch.int32)
        # a slot touched this frame (matched or freshly allocated) is not
        # associable again, exactly like the host tracker
        consumed = consumed | at

    # unmatched pre-existing tracks coast on their last (3D) velocity
    coast = active0 & ~consumed
    xyz = st["boxes"][:, :3] + dt * st["vel"]
    st["boxes"] = torch.where(
        coast[:, None], torch.cat([xyz, st["boxes"][:, 3:]], dim=-1),
        st["boxes"])
    st["lost"] = torch.where(coast, st["lost"] + dt, st["lost"])
    st["history"] = torch.where(coast, 0.0, st["history"])
    st["active"] = st["active"] & ~(st["lost"] > lost_time)
    return st


tracker_update.rows = 0


def tracker_report(state, classes, frame=None, timestamp=0):
    """Current tracks as a ``Target3DArray`` of ``TrackingTarget3D`` (one
    host copy of the slot table; columnar assembly)."""
    from ..abstraction import ObjectTag, Target3DArray, TrackingTarget3D

    st = {k: v.cpu().numpy() for k, v in state.items()}
    m = st["active"]
    boxes = st["boxes"][m]
    n = len(boxes)
    y = boxes[:, 6].astype(np.float64)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 2] = np.sin(y / 2)
    quats[:, 3] = np.cos(y / 2)
    cols = dict(
        position=np.ascontiguousarray(boxes[:, 0:3], np.float32),
        dimension=np.ascontiguousarray(boxes[:, 3:6], np.float32),
        quat=quats,
        position_var=np.zeros((n, 3, 3), np.float32),
        dimension_var=np.zeros((n, 3, 3), np.float32),
        velocity=np.ascontiguousarray(st["vel"][m], np.float32),
        angular_velocity=np.zeros((n, 3), np.float32),
        velocity_var=np.zeros((n, 3, 3), np.float32),
        angular_velocity_var=np.zeros((n, 3, 3), np.float32),
    )
    tags = [ObjectTag(cls := classes[int(l)], type(cls), float(s))
            for l, s in zip(st["label"][m], st["score"][m])]
    return Target3DArray._from_backed_columns(
        TrackingTarget3D, cols, tags, np.zeros(n, np.float32),
        tids=st["tid"][m].astype(np.uint64),
        histories=st["history"][m],
        frame=frame, timestamp=timestamp)


def tracker_scan_sequence(state, boxes, scores, labels, vel, valid, dts,
                          thresholds, lost_time):
    """Track a whole sequence: :func:`tracker_update` over the frame axis.

    :param boxes: (F, D, 7); ``scores``/``labels``/``valid`` (F, D);
        ``vel`` (F, D, 2 or 3); ``dts`` (F,) seconds since the previous
        frame (0 for the first)
    :returns: ``(final_state, per_frame_states)``: the per-frame states
        are the slot tables AFTER each frame, stacked on a leading axis
    """
    snaps = []
    for f in range(len(dts)):
        state = tracker_update(state, boxes[f], scores[f], labels[f],
                               vel[f], valid[f], dts[f], thresholds,
                               lost_time)
        snaps.append(state)
    return state, {k: torch.stack([s[k] for s in snaps]) for k in state}


def make_tracking_step(device_fn, thresholds, lost_time=0.3, capacity=128,
                       score_threshold=0.3):
    """Fuse a detector's ``device_fn`` with the tracker:
    ``step(state, points, dt) -> (state, (boxes, scores, labels, keep,
    vel))``, the serving loop body (the caller threads the state;
    ``step.init()`` makes an empty one on the detector's device). The
    detector should emit the 5-output velocity contract: a
    ``predict_velocity`` VoxelNeXt or CenterPoint (one- or two-stage,
    ``make_centerpoint_detector``), or a TTA wrap of one; without
    velocities the tracks backcast and coast by zero.

    :param score_threshold: admission gate on top of the detector's NMS
        ``keep``: the keep mask carries no score cut, and without one every
        low-score candidate would allocate a track and fill the table"""
    dev = getattr(device_fn, "device", None)
    thresholds = as_tensor(thresholds, device=dev,
                           dtype=torch.float32).reshape(-1)
    lost_time = float(lost_time)

    def step(state, points, dt):
        out = device_fn(points)
        boxes, scores, labels, keep = out[:4]
        vel = out[4] if len(out) > 4 else boxes.new_zeros(
            (boxes.shape[0], 3))
        scores = scores.to(torch.float32)
        admit = keep & (scores >= score_threshold)  # compared in float32
        state = tracker_update(state, boxes, scores, labels, vel, admit, dt,
                               thresholds, lost_time)
        return state, (boxes, scores, labels, keep, vel)

    step.init = partial(tracker_init, capacity, thresholds.device)
    return step


class DeviceCenterTracker:
    """The :class:`~d3d_tpu_torch.tracking.CenterTracker` API over the
    device state (same constructor contract; per-class dict thresholds are
    laid out over ``classes``).

    :param device: where the slot table lives (default CUDA)
    """

    def __init__(self, classes, distance_threshold=1.0, lost_time=0.3,
                 capacity=128, device=None):
        self._classes = list(classes)
        self._dev = resolve_device(device)
        # device labels index into classes -> index-aligned gate array
        self._thr = torch.tensor(
            [float(distance_threshold[int(getattr(c, "value", c))]
                   if isinstance(distance_threshold, dict)
                   else distance_threshold)
             for c in self._classes], dtype=torch.float32, device=self._dev)
        self._lost_time = float(lost_time)
        self._state = tracker_init(capacity, self._dev)
        self._last_ts = None
        self._last_ts_us = 0
        self._last_frame = None

    @property
    def tracked_ids(self):
        st = {k: v.cpu().numpy() for k, v in self._state.items()}
        return [int(t) for t in st["tid"][st["active"]]]

    def reset(self):
        """Start a fresh sequence: empty slot table, timestamps cleared
        (tids keep counting up, unique across sequences)."""
        nt = self._state["next_tid"]
        cap = self._state["boxes"].shape[0]
        self._state = dict(tracker_init(cap, self._dev), next_tid=nt)
        self._last_ts = None
        self._last_ts_us = 0
        self._last_frame = None

    def update(self, detections):
        """Feed a frame (``Target3DArray``, timestamp in microseconds;
        elements with a ``velocity`` attribute backcast by it). Detections
        whose class is not in ``classes`` are ignored."""
        ts = detections.timestamp / 1e6
        self._last_ts_us = detections.timestamp
        self._last_frame = detections.frame
        dt = 0.0 if self._last_ts is None else ts - self._last_ts
        self._last_ts = ts

        cols = detections.columns() if len(detections) else None
        lut = {int(getattr(c, "value", c)): i
               for i, c in enumerate(self._classes)}
        if cols is not None:
            known = np.asarray([int(l) in lut for l in cols["label"]], bool)
        n = int(known.sum()) if cols is not None else 0
        npad = int(np.ceil(max(n, 1) / 32) * 32)
        boxes = np.zeros((npad, 7), np.float32)
        vel = np.zeros((npad, 3), np.float32)
        labels = np.zeros(npad, np.int32)
        scores = np.zeros(npad, np.float32)
        valid = np.zeros(npad, bool)
        valid[:n] = True
        if n:
            boxes[:n, :3] = cols["position"][known]
            boxes[:n, 3:6] = cols["dimension"][known]
            boxes[:n, 6] = cols["yaw"][known]
            if "velocity" in cols:
                vel[:n] = cols["velocity"][known]
            labels[:n] = [lut[int(l)] for l in cols["label"][known]]
            scores[:n] = cols["score"][known]
        self._state = tracker_update(
            self._state, boxes, scores, labels, vel, valid,
            np.float32(dt), self._thr, self._lost_time)

    def report(self):
        return tracker_report(self._state, self._classes, self._last_frame,
                              self._last_ts_us)

"""Core data model (port of ``d3d_tpu.abstraction``): object tags, 3D
targets, target arrays, ego pose, sensor metadata and the calibration graph
(TransformSet).

The data model is host numpy, as in the JAX module, with the same names,
signatures, columnar backing and msgpack wire format (byte for byte: the
same field order, ``use_single_float=True``). Its batch geometry (crop,
point distance, 3D IoU) runs through :mod:`d3d_tpu_torch.ops` on
:func:`~d3d_tpu_torch.utils.resolve_device` ``(device)``: CUDA unless the
caller passes ``device="cpu"``. ``msgpack`` is imported only by
:meth:`Target3DArray.dump` and :meth:`Target3DArray.load`.

Reference bugs fixed here on purpose (SURVEY.md §7 item 5):
  * ``filter_position`` compared ``is not float('nan')`` (always true),
    tested x for y/z and never returned (abstraction.pyx:630-642);
  * ``sort_by_score`` ignored its ``reverse`` argument (:644-650).
"""

import base64
import enum
import pickle
from numbers import Integral
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

__all__ = [
    "ObjectTag",
    "ObjectTarget3D",
    "TrackingTarget3D",
    "Target3DArray",
    "EgoPose",
    "CameraMetadata",
    "LidarMetadata",
    "RadarMetadata",
    "PinMetadata",
    "TransformSet",
    "register_tag_enum",
]

# ---------------------------------------------------------------------------
# Tag enum registry (reference hardcodes KITTI=1, Waymo=2, Nuscenes=3,
# NuscenesDetection=4, abstraction.pyx:19-27; here it is an open registry,
# pre-populated lazily with the built-in dataset taxonomies: KITTI 1, Waymo
# 2, nuScenes 3 and nuScenes detection 4, as the JAX package registers them).
# ---------------------------------------------------------------------------
_TAG_ENUMS = {}
_BUILTINS_LOADED = False


def register_tag_enum(mapping, code):
    """Register an Enum type under a stable integer code for serialization."""
    _TAG_ENUMS[mapping] = int(code)


def _enum_mapping():
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        from .dataset.kitti.utils import KittiObjectClass
        from .dataset.nuscenes.constants import (NuscenesDetectionClass,
                                                 NuscenesObjectClass)
        from .dataset.waymo.constants import WaymoObjectClass

        _TAG_ENUMS.setdefault(KittiObjectClass, 1)
        _TAG_ENUMS.setdefault(WaymoObjectClass, 2)
        _TAG_ENUMS.setdefault(NuscenesObjectClass, 3)
        _TAG_ENUMS.setdefault(NuscenesDetectionClass, 4)
        _BUILTINS_LOADED = True
    return _TAG_ENUMS


def _enum_lookup():
    return {v: k for k, v in _enum_mapping().items()}


class ObjectTag:
    """Multi-class label + score container bound to a user Enum
    (reference abstraction.pyx:32-90).

    :param labels: a label or list of labels (enum member, name or value)
    :param mapping: the Enum type defining the classes
    :param scores: scores corresponding to the labels
    """

    def __init__(self, labels, mapping=None, scores=None):
        if mapping is not None and not issubclass(mapping, enum.Enum):
            raise ValueError("The object class mapping should be an Enum")
        self.mapping = mapping

        if scores is None:
            if isinstance(labels, (list, tuple)) and len(labels) != 1:
                raise ValueError("There cannot be multiple labels without scores")
            labels = labels if isinstance(labels, (list, tuple)) else [labels]
            labels = list(labels)
            scores = [1]
        else:
            labels = list(labels) if isinstance(labels, (list, tuple)) else [labels]
            scores = list(scores) if isinstance(scores, (list, tuple)) else [scores]

        for i, lab in enumerate(labels):
            if isinstance(lab, str):
                labels[i] = self.mapping[lab].value
            elif isinstance(lab, Integral):
                labels[i] = int(lab)
            else:
                if self.mapping is None:  # infer mapping from the member type
                    self.mapping = type(lab)
                labels[i] = lab.value

        if len(scores) == 1:  # fast path: nothing to sort (like the sort
            # below, a single score keeps only the first label)
            self.labels = labels[:1]
            self.scores = scores
        else:
            order = list(reversed(np.argsort(scores, kind="stable")))
            self.labels = [labels[i] for i in order]
            self.scores = [scores[i] for i in order]

    def __str__(self):
        return "<ObjectTag, top class: %s>" % self.mapping(self.labels[0]).name

    def serialize(self):
        return (_enum_mapping().get(self.mapping, 0), self.labels, self.scores)

    @classmethod
    def deserialize(cls, data):
        mapping = _enum_lookup().get(data[0])
        return cls(list(data[1]), mapping, list(data[2]))

    def __reduce__(self):
        return ObjectTag.deserialize, (self.serialize(),)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _vec3(values):
    arr = np.asarray(values, dtype=np.float32).reshape(-1)
    if arr.shape != (3,):
        raise ValueError("Incorrect vector length")
    return arr


def _mat33(values):
    if values is None:
        return np.zeros((3, 3), dtype=np.float32)
    return np.asarray(values, dtype=np.float32).reshape(3, 3)


def _parse_rotation(value):
    if isinstance(value, Rotation):
        return value.as_quat().astype(np.float32)
    if isinstance(value, np.ndarray) and value.ndim == 2:
        return Rotation.from_matrix(value[:3, :3]).as_quat().astype(np.float32)
    if len(value) == 4:
        return np.asarray(value, dtype=np.float32)
    raise ValueError("Unrecognized rotation format")


def _quat2yaw(q):
    """Yaw (z euler angle) of an (x, y, z, w) quaternion
    (reference abstraction.pyx:110-115)."""
    siny_cosp = 2 * (q[3] * q[2] + q[0] * q[1])
    cosy_cosp = 1 - 2 * (q[1] * q[1] + q[2] * q[2])
    return float(np.arctan2(siny_cosp, cosy_cosp))


def _quat2yaw_vec(q):
    """Vectorized :func:`_quat2yaw` over an (N, 4) f32 quaternion column —
    elementwise the same f32 IEEE operations, so bitwise identical to the
    scalar path."""
    siny_cosp = 2 * (q[:, 3] * q[:, 2] + q[:, 0] * q[:, 1])
    cosy_cosp = 1 - 2 * (q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2])
    return np.arctan2(siny_cosp, cosy_cosp)


def _pack_ull(value):
    out = []
    while value > 0:
        out.append(value % 256)
        value //= 256
    return bytes(out)


class ObjectTarget3D:
    """A 3D target in cartesian coordinates; body coordinate is FLU
    (front-left-up). Reference: abstraction.pyx:128-354.

    :param position: center (x, y, z)
    :param orientation: heading as scipy Rotation / quaternion / matrix
    :param dimension: extents (lx, ly, lz)
    :param tag: ObjectTag classification
    :param tid: tracking id (0 = unassigned)
    """

    def __init__(self, position, orientation, dimension, tag, tid=0,
                 position_var=None, orientation_var=None, dimension_var=None,
                 aux=None):
        assert isinstance(tag, ObjectTag), "Label should be of type ObjectTag"
        self._position = _vec3(position)
        self._dimension = _vec3(dimension)
        self._orientation = _parse_rotation(orientation)
        self.tag = tag
        self.tid = tid
        self.aux = aux
        self._position_var = _mat33(position_var)
        self._dimension_var = _mat33(dimension_var)
        self.orientation_var = 0 if orientation_var is None else orientation_var

    # setters write IN PLACE so that column-backed storage
    # (Target3DArray.columns) stays coherent: after an array builds its
    # struct-of-arrays cache, each object's vectors are row views into the
    # column arrays, and every public mutation lands in the columns too.
    position = property(
        lambda self: self._position,
        lambda self, v: self._position.__setitem__(..., _vec3(v)),
        doc="Position of the (center of) target",
    )
    dimension = property(
        lambda self: self._dimension,
        lambda self, v: self._dimension.__setitem__(..., _vec3(v)),
        doc="Dimension of the target",
    )
    position_var = property(
        lambda self: self._position_var,
        lambda self, v: self._position_var.__setitem__(..., _mat33(v)),
    )
    dimension_var = property(
        lambda self: self._dimension_var,
        lambda self, v: self._dimension_var.__setitem__(..., _mat33(v)),
    )

    @property
    def orientation(self):
        return Rotation(self._orientation)

    @orientation.setter
    def orientation(self, value):
        self._orientation[...] = _parse_rotation(value)

    @property
    def tag_top(self):
        return self.tag.mapping(self.tag.labels[0])

    @tag_top.setter
    def tag_top(self, value):
        if isinstance(value, Integral):
            self.tag.labels[0] = value
        elif isinstance(value, self.tag.mapping):
            self.tag.labels[0] = value.value
        else:
            raise ValueError("Invalid tag type!")

    @property
    def tag_top_score(self):
        return self.tag.scores[0]

    @tag_top_score.setter
    def tag_top_score(self, value):
        if len(self.tag.scores) == 1:
            self.tag.scores[0] = value
        else:
            raise NotImplementedError(
                "Cannot change score when multiple classes are present!"
            )

    @property
    def yaw(self):
        """Rotation angle around the z-axis (other axes ignored)."""
        return _quat2yaw(self._orientation)

    @property
    def corners(self):
        """8 x 3 corner coordinates of the bounding box."""
        offsets = [[-d / 2, d / 2] for d in self.dimension]
        offsets = np.array(np.meshgrid(*offsets)).T.reshape(-1, 3)
        offsets = offsets.dot(self.orientation.as_matrix().T)
        return self.position + offsets

    @property
    def tid64(self):
        """base64 representation of the tracking id."""
        return base64.b64encode(_pack_ull(self.tid)).rstrip(b"=").decode()

    def to_numpy(self, box_type="ground"):
        """9-float layout [label, score, x, y, z, lx, ly, lz, yaw] — the
        lingua franca consumed by matchers/evaluators
        (reference abstraction.pyx:256-273)."""
        return np.array(
            [float(self.tag.labels[0]), self.tag.scores[0],
             *self._position.tolist(), *self._dimension.tolist(), self.yaw],
            dtype=np.float32,
        )

    def serialize(self):
        return (
            self._position.tolist(),
            self._position_var.ravel().tolist(),
            self._dimension.tolist(),
            self._dimension_var.ravel().tolist(),
            self.orientation.as_quat().tolist(),
            self.orientation_var,
            self.tid,
            self.tag.serialize(),
            dict(self.aux) if self.aux else None,
        )

    @classmethod
    def deserialize(cls, data):
        pos, pos_var, dim, dim_var, ori, ori_var, tid, tag_data, aux = data
        return cls(pos, Rotation.from_quat(ori), dim,
                   ObjectTag.deserialize(tag_data), tid=tid, aux=aux,
                   position_var=pos_var, orientation_var=ori_var,
                   dimension_var=dim_var)

    def __reduce__(self):
        return ObjectTarget3D.deserialize, (self.serialize(),)

    def crop_points(self, cloud, device=None):
        """Boolean mask of cloud points inside this box (yaw-projected, like
        the reference's dgal box3dr_contains, abstraction.pyx:306-319),
        computed in float64 on ``device`` (default CUDA)."""
        from .ops.box import box3dp_crop

        box = np.concatenate([self.position, self.dimension, [self.yaw]])
        return np.asarray(box3dp_crop(
            np.asarray(cloud, np.float64)[:, :3], box[None].astype(np.float64),
            device=device))[0]

    def points_distance(self, cloud, device=None):
        """Signed distance of cloud points to the box surface (float64, on
        ``device``, default CUDA)."""
        from .ops.box import box3dr_pdist

        box = np.concatenate([self.position, self.dimension, [self.yaw]])
        return np.asarray(box3dr_pdist(
            np.asarray(cloud, np.float64)[:, :3], box[None].astype(np.float64),
            device=device))[0]

    def box_iou(self, other, device=None):
        """Rotated 3D IoU with another target (float64, on ``device``,
        default CUDA)."""
        import torch

        from .ops.geometry import box3dr_iou_pair
        from .utils import resolve_device

        dev = resolve_device(device)
        b1 = np.concatenate([self.position, self.dimension, [self.yaw]])
        b2 = np.concatenate([other.position, other.dimension, [other.yaw]])
        return float(box3dr_iou_pair(torch.as_tensor(b1, device=dev),
                                     torch.as_tensor(b2, device=dev)))


class TrackingTarget3D(ObjectTarget3D):
    """A tracked target: adds velocity / angular velocity (+vars) and the
    tracked duration ``history`` (reference abstraction.pyx:356-473)."""

    def __init__(self, position, orientation, dimension, velocity,
                 angular_velocity, tag, tid=0, position_var=None,
                 orientation_var=None, dimension_var=None, velocity_var=None,
                 angular_velocity_var=None, history=None, aux=None):
        super().__init__(position, orientation, dimension, tag, tid=tid,
                         position_var=position_var,
                         orientation_var=orientation_var,
                         dimension_var=dimension_var, aux=aux)
        self._velocity = _vec3(velocity)
        self._angular_velocity = _vec3(angular_velocity)
        self._velocity_var = _mat33(velocity_var)
        self._angular_velocity_var = _mat33(angular_velocity_var)
        self.history = float("nan") if history is None else history

    # in-place for column-backing, like the ObjectTarget3D setters
    velocity = property(
        lambda self: self._velocity,
        lambda self, v: self._velocity.__setitem__(..., _vec3(v)),
    )
    angular_velocity = property(
        lambda self: self._angular_velocity,
        lambda self, v: self._angular_velocity.__setitem__(..., _vec3(v)),
    )
    velocity_var = property(
        lambda self: self._velocity_var,
        lambda self, v: self._velocity_var.__setitem__(..., _mat33(v)),
    )
    angular_velocity_var = property(
        lambda self: self._angular_velocity_var,
        lambda self, v: self._angular_velocity_var.__setitem__(..., _mat33(v)),
    )

    def to_numpy(self, box_type="ground"):
        """12-float layout [label, score, x, y, z, lx, ly, lz, yaw, vx, vy,
        wz] (reference abstraction.pyx:456-470)."""
        return np.array(
            [float(self.tag.labels[0]), self.tag.scores[0],
             *self._position.tolist(), *self._dimension.tolist(), self.yaw,
             self._velocity[0], self._velocity[1], self._angular_velocity[2]],
            dtype=np.float32,
        )

    def serialize(self):
        return (
            self._position.tolist(),
            self._position_var.ravel().tolist(),
            self._dimension.tolist(),
            self._dimension_var.ravel().tolist(),
            self.orientation.as_quat().tolist(),
            self.orientation_var,
            self._velocity.tolist(),
            self._velocity_var.ravel().tolist(),
            self._angular_velocity.tolist(),
            self._angular_velocity_var.ravel().tolist(),
            self.tid,
            self.tag.serialize(),
            self.history,
            dict(self.aux) if self.aux else None,
        )

    @classmethod
    def deserialize(cls, data):
        (pos, pos_var, dim, dim_var, ori, ori_var, vel, vel_var, avel,
         avel_var, tid, tag_data, history, aux) = data
        return cls(pos, Rotation.from_quat(ori), dim, vel, avel,
                   ObjectTag.deserialize(tag_data), tid=tid,
                   position_var=pos_var, orientation_var=ori_var,
                   dimension_var=dim_var, velocity_var=vel_var,
                   angular_velocity_var=avel_var, history=history, aux=aux)

    def __reduce__(self):
        return TrackingTarget3D.deserialize, (self.serialize(),)


class Target3DArray(list):
    """Typed list of targets bound to a sensor frame + timestamp
    (reference abstraction.pyx:475-687).

    Columnar redesign: the list API is preserved, but the array keeps a
    cached struct-of-arrays backing (:meth:`columns`). After the first
    build, every element's vectors are row views into the column arrays,
    so ``to_numpy``/``boxes7``/evaluator packing are vectorized column
    reads instead of per-object Python loops (the reference's
    ``to_numpy`` walks objects one by one, abstraction.pyx:503-518).
    :meth:`from_columns` constructs an array straight from dense model
    outputs without ever parsing per object."""

    def __init__(self, iterable=(), frame=None, timestamp=0):
        super().__init__(iterable)
        self.frame = frame
        self.timestamp = timestamp
        self._ccache = None  # (row views, column dict) SoA backing
        if isinstance(iterable, Target3DArray) and not frame:
            self.frame = iterable.frame
            self.timestamp = iterable.timestamp

    # -- list mutations drop the column cache -------------------------------
    def _invalidate(self):
        self._ccache = None

    def append(self, *a):
        self._invalidate()
        return list.append(self, *a)

    def extend(self, *a):
        self._invalidate()
        return list.extend(self, *a)

    def insert(self, *a):
        self._invalidate()
        return list.insert(self, *a)

    def remove(self, *a):
        self._invalidate()
        return list.remove(self, *a)

    def pop(self, *a):
        self._invalidate()
        return list.pop(self, *a)

    def clear(self):
        self._invalidate()
        return list.clear(self)

    def sort(self, *a, **k):
        self._invalidate()
        return list.sort(self, *a, **k)

    def reverse(self):
        self._invalidate()
        return list.reverse(self)

    def __setitem__(self, *a):
        self._invalidate()
        return list.__setitem__(self, *a)

    def __delitem__(self, *a):
        self._invalidate()
        return list.__delitem__(self, *a)

    def __iadd__(self, other):
        self._invalidate()
        return list.__iadd__(self, other)

    def __imul__(self, other):
        self._invalidate()
        return list.__imul__(self, other)

    # -- struct-of-arrays backing -------------------------------------------
    def columns(self):
        """Struct-of-arrays layout of this array (SURVEY.md §7:
        "Target3DArray -> struct-of-arrays").

        Returns a dict of dense numpy arrays: ``position`` (N, 3) f32,
        ``dimension`` (N, 3) f32, ``quat`` (N, 4) f32 xyzw,
        ``position_var``/``dimension_var`` (N, 3, 3) f32, plus — for
        TrackingTarget3D elements — ``velocity``/``angular_velocity``
        (N, 3) and their (N, 3, 3) covariances; and freshly-extracted
        ``yaw`` (N,) f32, ``label`` (N,) i64, ``score`` (N,) f32,
        ``tid`` (N,) u64, ``orientation_var`` (N,) f32 (+ ``history``).

        The vector/matrix columns are cached AND share memory with the
        element objects (each object's vectors become row views into the
        columns), so in-place element mutation and the property setters
        write straight into the columns; scalar Python-level fields and
        the derived yaw are re-extracted per call — cheap comprehensions.

        .. warning:: building the cache REBINDS each element's internal
           arrays to column rows: an array reference obtained from a
           property BEFORE the first columnar access (``p = obj.position``)
           is orphaned by it — re-read the property after calls like
           ``to_numpy``/``boxes7`` instead of writing through stale
           references. Likewise, an object shared by two arrays is backed
           by whichever array built its columns most recently (the other
           array detects the broken sharing and rebuilds on next access).
        """
        n = len(self)
        tracking = n > 0 and isinstance(self[0], TrackingTarget3D)
        if n > 0 and any(type(o) is not type(self[0]) for o in self):
            raise ValueError(
                "Columnar access requires homogeneous element types "
                "(all ObjectTarget3D or all TrackingTarget3D)")
        cache = self._ccache
        if (cache is None or len(cache[0]) != n
                or any(o._position is not r for o, r in zip(self, cache[0]))):
            cols = {
                "position": np.empty((n, 3), np.float32),
                "dimension": np.empty((n, 3), np.float32),
                "quat": np.empty((n, 4), np.float32),
                "position_var": np.empty((n, 3, 3), np.float32),
                "dimension_var": np.empty((n, 3, 3), np.float32),
            }
            if tracking:
                cols["velocity"] = np.empty((n, 3), np.float32)
                cols["angular_velocity"] = np.empty((n, 3), np.float32)
                cols["velocity_var"] = np.empty((n, 3, 3), np.float32)
                cols["angular_velocity_var"] = np.empty((n, 3, 3), np.float32)
            attr_of = {"position": "_position", "dimension": "_dimension",
                       "quat": "_orientation", "position_var": "_position_var",
                       "dimension_var": "_dimension_var",
                       "velocity": "_velocity",
                       "angular_velocity": "_angular_velocity",
                       "velocity_var": "_velocity_var",
                       "angular_velocity_var": "_angular_velocity_var"}
            for key, col in cols.items():
                attr = attr_of[key]
                for i, o in enumerate(self):
                    col[i] = getattr(o, attr)
                    setattr(o, attr, col[i])  # share: object row = column row
            self._ccache = ([o._position for o in self], cols)

        out = dict(self._ccache[1])
        out["yaw"] = _quat2yaw_vec(out["quat"])
        out["label"] = np.fromiter(
            (int(o.tag.labels[0]) for o in self), np.int64, count=n)
        out["score"] = np.fromiter(
            (o.tag.scores[0] for o in self), np.float32, count=n)
        out["tid"] = np.fromiter((o.tid for o in self), np.uint64, count=n)
        out["orientation_var"] = np.fromiter(
            (o.orientation_var for o in self), np.float32, count=n)
        if tracking:
            out["history"] = np.fromiter(
                (o.history for o in self), np.float32, count=n)
        return out

    @classmethod
    def from_columns(cls, positions, dimensions, yaws=None, quats=None,
                     tags=None, labels=None, scores=None, mapping=None,
                     tids=None, position_vars=None, dimension_vars=None,
                     orientation_vars=None, frame=None, timestamp=0):
        """Build an array directly from dense columns (model decode / NMS
        outputs) without per-object parsing: the arrays become the SoA
        backing and the elements are lightweight row views.

        Provide orientation as either ``yaws`` (N,) or ``quats`` (N, 4)
        xyzw, and classification as either ``tags`` (list of ObjectTag) or
        ``labels`` (+ optional ``scores``) with a ``mapping`` enum."""
        pos = np.ascontiguousarray(positions, np.float32).reshape(-1, 3)
        n = len(pos)
        dim = np.ascontiguousarray(dimensions, np.float32).reshape(n, 3)
        if quats is None:
            y = np.asarray(yaws, np.float64).reshape(n)
            quats = np.zeros((n, 4), np.float32)
            quats[:, 2] = np.sin(y / 2)
            quats[:, 3] = np.cos(y / 2)
        else:
            quats = np.ascontiguousarray(quats, np.float32).reshape(n, 4)
        pv = (np.zeros((n, 3, 3), np.float32) if position_vars is None else
              np.ascontiguousarray(position_vars, np.float32).reshape(n, 3, 3))
        dv = (np.zeros((n, 3, 3), np.float32) if dimension_vars is None else
              np.ascontiguousarray(dimension_vars,
                                   np.float32).reshape(n, 3, 3))
        ov = (np.zeros(n, np.float32) if orientation_vars is None else
              np.asarray(orientation_vars, np.float32).reshape(n))
        if tags is None:
            if scores is None:
                tags = [ObjectTag(int(l), mapping) for l in labels]
            else:
                tags = [ObjectTag(int(l), mapping, float(s))
                        for l, s in zip(labels, scores)]

        cols = dict(position=pos, dimension=dim, quat=quats,
                    position_var=pv, dimension_var=dv)
        return cls._from_backed_columns(
            ObjectTarget3D, cols, tags, ov,
            tids=None if tids is None else np.asarray(tids),
            frame=frame, timestamp=timestamp)

    @classmethod
    def _from_backed_columns(cls, elem_cls, cols, tags, orientation_vars,
                             tids=None, auxs=None, histories=None,
                             frame=None, timestamp=0):
        """Internal: build an array whose elements are row views into the
        given (already f32, contiguous) column dict."""
        n = len(cols["position"])
        tracking = elem_cls is TrackingTarget3D
        arr = cls(frame=frame, timestamp=timestamp)
        for i in range(n):
            o = elem_cls.__new__(elem_cls)
            o._position = cols["position"][i]
            o._dimension = cols["dimension"][i]
            o._orientation = cols["quat"][i]
            o._position_var = cols["position_var"][i]
            o._dimension_var = cols["dimension_var"][i]
            o.orientation_var = float(orientation_vars[i])
            o.tag = tags[i]
            o.tid = int(tids[i]) if tids is not None else 0
            o.aux = auxs[i] if auxs is not None else None
            if tracking:
                o._velocity = cols["velocity"][i]
                o._angular_velocity = cols["angular_velocity"][i]
                o._velocity_var = cols["velocity_var"][i]
                o._angular_velocity_var = cols["angular_velocity_var"][i]
                o.history = (float(histories[i]) if histories is not None
                             else float("nan"))
            list.append(arr, o)
        arr._ccache = ([o._position for o in arr], cols)
        return arr

    def to_numpy(self, box_type="ground"):
        if len(self) == 0:
            return np.empty((0,), dtype=np.float32)
        c = self.columns()
        tracking = isinstance(self[0], TrackingTarget3D)
        out = np.empty((len(self), 12 if tracking else 9), np.float32)
        out[:, 0] = c["label"]
        out[:, 1] = c["score"]
        out[:, 2:5] = c["position"]
        out[:, 5:8] = c["dimension"]
        out[:, 8] = c["yaw"]
        if tracking:
            out[:, 9:11] = c["velocity"][:, 0:2]
            out[:, 11] = c["angular_velocity"][:, 2]
        return out

    def to_torch(self, box_type="ground", device=None):
        """The :meth:`to_numpy` rows as an (N, 9|12) float32 tensor on
        :func:`~d3d_tpu_torch.utils.resolve_device` ``(device)``: CUDA
        unless ``device`` is given (the reference's to_torch,
        abstraction.pyx:512-518). This takes the place of the JAX module's
        ``to_jax``; the JAX module's ``to_torch`` returns a CPU tensor."""
        import torch

        from .utils import resolve_device

        return torch.as_tensor(self.to_numpy(box_type),
                               device=resolve_device(device))

    def boxes7(self):
        """(N, 7) [x, y, z, lx, ly, lz, yaw] float64 array — the layout the
        geometry kernels consume."""
        if len(self) == 0:
            return np.empty((0, 7), dtype=np.float64)
        c = self.columns()
        out = np.empty((len(self), 7), dtype=np.float64)
        out[:, 0:3] = c["position"]
        out[:, 3:6] = c["dimension"]
        out[:, 6] = c["yaw"]
        return out

    def serialize(self):
        if len(self) > 0:
            if any(type(obj) is not type(self[0]) for obj in self):
                raise ValueError(
                    "All elements are required to be the same type "
                    "(ObjectTarget3D or TrackingTarget3D) before dumping!"
                )
            type_code = 2 if isinstance(self[0], TrackingTarget3D) else 1
        else:
            type_code = 0
        # columnar fast path for the exact library types (a user subclass
        # may override serialize — per-object path preserves that)
        if len(self) > 0 and type(self[0]) in (ObjectTarget3D,
                                               TrackingTarget3D):
            try:
                rows = self._serialize_rows(type_code)
            except (TypeError, ValueError, OverflowError):
                # e.g. non-integer or negative tids break the u64 tid
                # column build
                rows = [obj.serialize() for obj in self]
        else:
            rows = [obj.serialize() for obj in self]
        return (self.frame, self.timestamp, type_code, rows)

    def _serialize_rows(self, type_code):
        """Columnar serialization: identical rows to per-object
        ``ObjectTarget3D.serialize`` (the scipy quaternion normalization
        is the same f64 IEEE ops, vectorized) without constructing a
        ``Rotation`` per object — the replacement for the reference's
        Cython-speed dump (abstraction.pyx:552-580).

        .. note:: like ``to_numpy``/``boxes7``, this builds the
           :meth:`columns` cache, rebinding element arrays to column rows
           (see the warning there)."""
        c = self.columns()
        n = len(self)
        pos = c["position"].tolist()
        pvar = c["position_var"].reshape(n, 9).tolist()
        dim = c["dimension"].tolist()
        dvar = c["dimension_var"].reshape(n, 9).tolist()
        q = c["quat"].astype(np.float64)
        norm = np.sqrt(np.einsum("ij,ij->i", q, q))
        if not np.all(norm > 0):  # scipy raises here too — stay loud
            raise ValueError("Found zero norm quaternion in the array")
        q /= norm[:, None]
        quat = q.tolist()
        if type_code == 1:
            return [
                (pos[i], pvar[i], dim[i], dvar[i], quat[i],
                 obj.orientation_var, obj.tid, obj.tag.serialize(),
                 dict(obj.aux) if obj.aux else None)
                for i, obj in enumerate(self)]
        vel = c["velocity"].tolist()
        vvar = c["velocity_var"].reshape(n, 9).tolist()
        avel = c["angular_velocity"].tolist()
        avar = c["angular_velocity_var"].reshape(n, 9).tolist()
        return [
            (pos[i], pvar[i], dim[i], dvar[i], quat[i],
             obj.orientation_var, vel[i], vvar[i], avel[i], avar[i],
             obj.tid, obj.tag.serialize(), obj.history,
             dict(obj.aux) if obj.aux else None)
            for i, obj in enumerate(self)]

    @classmethod
    def deserialize(cls, data):
        rows = data[3]
        # bulk path: normalize all quaternions in one vectorized f64 pass
        # (the same IEEE ops Rotation.from_quat + as_quat run per object)
        # and hand the f32 result straight to the constructors
        quats = None
        if len(rows) > 0 and data[2] in (1, 2):
            q = np.asarray([r[4] for r in rows], np.float64)
            norm = np.sqrt(np.einsum("ij,ij->i", q, q))
            if not np.all(norm > 0):  # scipy raised here too — stay loud
                raise ValueError("Found zero norm quaternion in the data")
            q /= norm[:, None]
            quats = q.astype(np.float32)
        if data[2] == 1:
            objs = [
                ObjectTarget3D(
                    r[0], quats[i], r[2], ObjectTag.deserialize(r[7]),
                    tid=r[6], position_var=r[1], orientation_var=r[5],
                    dimension_var=r[3], aux=r[8])
                for i, r in enumerate(rows)]
        elif data[2] == 2:
            objs = [
                TrackingTarget3D(
                    r[0], quats[i], r[2], r[6], r[8],
                    ObjectTag.deserialize(r[11]), tid=r[10],
                    position_var=r[1], orientation_var=r[5],
                    dimension_var=r[3], velocity_var=r[7],
                    angular_velocity_var=r[9], history=r[12], aux=r[13])
                for i, r in enumerate(rows)]
        else:
            assert data[2] == 0 and len(rows) == 0
            objs = []
        return cls(objs, frame=data[0], timestamp=data[1])

    def dump(self, output):
        import msgpack

        data = msgpack.packb(self.serialize(), use_single_float=True)
        if isinstance(output, (str, Path)):
            Path(output).write_bytes(data)
        elif hasattr(output, "write"):
            output.write(data)
        else:
            raise ValueError("Invalid output object!")

    @classmethod
    def load(cls, file):
        import msgpack

        if isinstance(file, (str, Path)):
            return cls.deserialize(msgpack.unpackb(Path(file).read_bytes()))
        if hasattr(file, "read"):
            return cls.deserialize(msgpack.unpackb(file.read()))
        raise ValueError("Invalid input object!")

    def __repr__(self):
        return "<Target3DArray with %d objects @ %s>" % (len(self), self.frame)

    def __reduce__(self):
        return Target3DArray.deserialize, (self.serialize(),)

    def filter(self, predicate):
        return Target3DArray([b for b in self if predicate(b)],
                             self.frame, self.timestamp)

    def filter_tag(self, tags):
        """Keep only objects whose top tag name is in ``tags``."""
        if not tags:
            return self
        if not isinstance(tags, (list, tuple)):
            tags = [tags]
        tags = [t if isinstance(t, str) else t.name for t in tags]
        tags = [t.lower() for t in tags]
        return Target3DArray(
            [b for b in self if b.tag_top.name.lower() in tags],
            self.frame, self.timestamp,
        )

    def filter_score(self, score):
        return Target3DArray([b for b in self if b.tag_top_score >= score],
                             self.frame, self.timestamp)

    def filter_position(self, x_min=None, x_max=None, y_min=None, y_max=None,
                        z_min=None, z_max=None):
        """Filter objects by center position (fixed semantics; the reference
        version is broken, abstraction.pyx:630-642)."""
        lo = [x_min, y_min, z_min]
        hi = [x_max, y_max, z_max]

        def ok(box):
            p = box.position
            for d in range(3):
                if lo[d] is not None and p[d] < lo[d]:
                    return False
                if hi[d] is not None and p[d] >= hi[d]:
                    return False
            return True

        return Target3DArray([b for b in self if ok(b)],
                             self.frame, self.timestamp)

    def sort_by_score(self, reverse=False):
        """Sort in place ascending by score (descending with ``reverse``;
        honoring the flag the reference ignores, abstraction.pyx:644-650)."""
        self.sort(key=lambda b: b.tag_top_score, reverse=reverse)

    def crop_points(self, cloud, device=None):
        """(N_boxes, N_points) containment matrix, computed in one batched
        float64 call on ``device``, default CUDA (replaces the reference's
        scalar loop, abstraction.pyx:684-687)."""
        from .ops.box import box3dp_crop
        from .utils import resolve_device

        device = resolve_device(device)
        if len(self) == 0:
            return np.zeros((0, len(cloud)), dtype=bool)
        return np.asarray(box3dp_crop(
            np.asarray(cloud, np.float64)[:, :3], self.boxes7(),
            device=device))

    def paint_label(self, cloud, semantics, device=None):
        """Panoptic id painting: points whose semantic class matches a box's
        top label get id (box_index + 1); boxes are walked from the lowest
        score upward assuming descending score order so higher-scored boxes
        win (reference abstraction.pyx:663-682). The containment runs on
        ``device`` (default CUDA)."""
        mask = self.crop_points(cloud, device=device)
        semantics = np.asarray(semantics)
        idarr = np.zeros(len(cloud), dtype=np.uint16)
        for ib in range(len(self) - 1, -1, -1):
            target_cls = self[ib].tag.labels[0]
            sel = mask[ib] & (semantics == target_cls)
            idarr[sel] = ib + 1
        return idarr


class EgoPose:
    """Dynamic state of the ego vehicle in an earth-fixed coordinate
    (reference abstraction.pyx:689-732)."""

    def __init__(self, position, orientation, position_var=None,
                 orientation_var=None):
        assert len(position) == 3, "Invalid position shape"
        self.position = np.asarray(position, dtype=np.float32)
        self._orientation = _parse_rotation(orientation)
        self.position_var = (np.zeros((3, 3)) if position_var is None
                             else position_var)
        self.orientation_var = (np.zeros((3, 3)) if orientation_var is None
                                else orientation_var)

    @property
    def orientation(self):
        return Rotation(self._orientation)

    @orientation.setter
    def orientation(self, value):
        self._orientation = _parse_rotation(value)

    def homo(self):
        """4x4 homogeneous matrix of this pose."""
        arr = np.eye(4)
        arr[:3, :3] = self.orientation.as_matrix()
        arr[:3, 3] = self.position
        return arr

    def __repr__(self):
        return "<EgoPose %s>" % str(self)

    def __str__(self):
        rpy = tuple(self.orientation.as_euler("XYZ").tolist())
        return ("position: [x=%.2f, y=%.2f, z=%.2f], "
                "orientation: [r=%.2f, p=%.2f, y=%.2f]"
                % (tuple(self.position.tolist()) + rpy))


class CameraMetadata:
    """Camera intrinsic metadata (reference abstraction.pyx:734-749)."""

    def __init__(self, width, height, distort_coeffs, intri_matrix,
                 mirror_coeff):
        self.width = width
        self.height = height
        self.distort_coeffs = distort_coeffs
        self.intri_matrix = intri_matrix
        self.mirror_coeff = mirror_coeff


class LidarMetadata:
    pass


class RadarMetadata:
    pass


class PinMetadata:
    """A ground-fixed WGS-84 / UTM anchor (reference abstraction.pyx:765)."""

    def __init__(self, lon, lat):
        self.lon = lon
        self.lat = lat


class TransformSet:
    """Collection of intrinsic and extrinsic calibration parameters.

    All extrinsics are stored as base->frame 4x4 transforms; all frames use
    FLU coordinates including cameras (reference abstraction.pyx:777-1064).

    :param base_frame: name of the base frame
    """

    # FLU -> RDF (Right-Down-Front) axis rotation appended to camera
    # projections (reference abstraction.pyx:827-833)
    _FLU2RDF = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]])

    def __init__(self, base_frame):
        self.base_frame = base_frame
        self.intrinsics = {}
        self.intrinsics_meta = {}
        self.extrinsics = {}  # base -> frame 4x4

    # -- frame bookkeeping -------------------------------------------------
    def _is_base(self, frame):
        return frame is None or frame == self.base_frame

    def _is_same(self, f1, f2):
        return f1 == f2 or (self._is_base(f1) and self._is_base(f2))

    def _assert_exist(self, frame_id, extrinsic=False):
        if self._is_base(frame_id):
            return
        if frame_id not in self.intrinsics:
            raise ValueError(
                "Frame {0} not found in intrinsic parameters, please add "
                "intrinsics for {0} first!".format(frame_id))
        if extrinsic and frame_id not in self.extrinsics:
            raise ValueError(
                "Frame {0} not found in extrinsic parameters, please add "
                "extrinsic for {0} first!".format(frame_id))

    # -- intrinsics --------------------------------------------------------
    def set_intrinsic_general(self, frame_id, metadata=None):
        self.intrinsics[frame_id] = None
        self.intrinsics_meta[frame_id] = metadata

    def set_intrinsic_camera(self, frame_id, transform, size, rotate=True,
                             distort_coeffs=(), intri_matrix=None,
                             mirror_coeff=float("nan")):
        """Set camera intrinsics; with ``rotate`` the FLU->RDF rotation is
        appended so world points project through a standard pinhole."""
        width, height = size
        if rotate:
            transform = transform.dot(self._FLU2RDF)
        self.intrinsics[frame_id] = transform
        self.intrinsics_meta[frame_id] = CameraMetadata(
            width, height, np.asarray(distort_coeffs), intri_matrix,
            mirror_coeff)

    def set_intrinsic_lidar(self, frame_id):
        self.intrinsics[frame_id] = None
        self.intrinsics_meta[frame_id] = LidarMetadata()

    def set_intrinsic_radar(self, frame_id):
        self.intrinsics[frame_id] = None
        self.intrinsics_meta[frame_id] = RadarMetadata()

    def set_intrinsic_pinhole(self, frame_id, size, cx, cy, fx, fy, s=0,
                              distort_coeffs=()):
        P = np.array([[fx, s, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64)
        self.set_intrinsic_camera(frame_id, P, size, rotate=True,
                                  distort_coeffs=distort_coeffs,
                                  intri_matrix=P)

    def set_intrinsic_map_pin(self, frame_id, lon=float("nan"),
                              lat=float("nan")):
        self.intrinsics[frame_id] = None
        self.intrinsics_meta[frame_id] = PinMetadata(lon, lat)

    # -- extrinsics --------------------------------------------------------
    def set_extrinsic(self, transform, frame_to=None, frame_from=None):
        """Store the transform converting points from ``frame_from`` to
        ``frame_to`` (None = base frame); composes through the base frame
        like the reference (abstraction.pyx:865-904)."""
        transform = np.asarray(transform, dtype=np.float64)
        if self._is_same(frame_to, frame_from):
            if not np.allclose(transform, np.eye(transform.shape[0])):
                raise ValueError("Self-transform must be identity!")

        if transform.shape == (3, 4):
            transform = np.vstack([transform, [0, 0, 0, 1]])
        elif transform.shape != (4, 4):
            raise ValueError("Invalid matrix shape for extrinsics!")

        if self._is_base(frame_to):
            self._assert_exist(frame_from)
            self.extrinsics[frame_from] = np.linalg.inv(transform)
            return
        self._assert_exist(frame_to)

        if self._is_base(frame_from):
            self.extrinsics[frame_to] = transform
            return
        self._assert_exist(frame_from)

        have_from = frame_from in self.extrinsics
        have_to = frame_to in self.extrinsics
        if have_from and have_to:
            raise ValueError(
                "Frame %s and %s are both registered in extrinsic, please "
                "update one of them at one time" % (frame_from, frame_to))
        if have_from:
            self.extrinsics[frame_to] = transform.dot(self.extrinsics[frame_from])
        elif have_to:
            self.extrinsics[frame_from] = np.linalg.inv(transform).dot(
                self.extrinsics[frame_to])
        else:
            raise ValueError("All frames are not present in extrinsics! "
                             "Please add one of them first!")

    def get_extrinsic(self, frame_to=None, frame_from=None):
        """4x4 transform converting points from ``frame_from`` to
        ``frame_to`` (chains through the base frame)."""
        if self._is_same(frame_to, frame_from):
            return np.eye(4)
        if not self._is_base(frame_from):
            self._assert_exist(frame_from, extrinsic=True)
            if not self._is_base(frame_to):
                self._assert_exist(frame_to, extrinsic=True)
                return self.extrinsics[frame_to].dot(
                    np.linalg.inv(self.extrinsics[frame_from]))
            return np.linalg.inv(self.extrinsics[frame_from])
        if not self._is_base(frame_to):
            self._assert_exist(frame_to, extrinsic=True)
            return self.extrinsics[frame_to]
        return np.eye(4)

    @property
    def frames(self):
        return list(self.intrinsics.keys())

    def __repr__(self):
        return "<TransformSet with frames: *%s>" % ", ".join(
            [self.base_frame] + self.frames)

    # -- geometric operations ----------------------------------------------
    def transform_objects(self, objects, frame_to=None):
        """Re-express a Target3DArray in another frame (rotates positions,
        orientations and velocities; reference abstraction.pyx:936-969).

        Reference bug fixed: the reference copies angular velocity and all
        covariance matrices into the new frame UNROTATED; here the angular
        velocity rotates as a vector and every covariance transforms as
        R @ S @ R^T, so downstream filters consume frame-consistent
        dynamics."""
        if self._is_same(objects.frame, frame_to):
            return objects
        rt = self.get_extrinsic(frame_from=objects.frame, frame_to=frame_to)
        if len(objects) == 0:  # after get_extrinsic: frame typos still raise
            return Target3DArray(frame=frame_to,
                                 timestamp=objects.timestamp)
        r = Rotation.from_matrix(rt[:3, :3])
        rmat, t = r.as_matrix(), rt[:3, 3]

        # columnar transform: one batched pass over the SoA backing instead
        # of per-object scipy/numpy calls
        c = objects.columns()
        tracking = isinstance(objects[0], TrackingTarget3D)

        def rot_cov(s):  # R @ S @ R^T, batched over the leading axis
            return np.einsum("ij,njk,lk->nil", rmat, s,
                             rmat).astype(np.float32)

        f32 = np.float32
        cols = {
            "position": (c["position"] @ rmat.T + t).astype(f32),
            "dimension": c["dimension"].copy(),
            "quat": (r * Rotation.from_quat(c["quat"])).as_quat().astype(f32),
            "position_var": rot_cov(c["position_var"]),
            "dimension_var": c["dimension_var"].copy(),
        }
        if tracking:
            cols["velocity"] = (c["velocity"] @ rmat.T).astype(f32)
            cols["angular_velocity"] = (
                c["angular_velocity"] @ rmat.T).astype(f32)
            cols["velocity_var"] = rot_cov(c["velocity_var"])
            cols["angular_velocity_var"] = rot_cov(c["angular_velocity_var"])
        return Target3DArray._from_backed_columns(
            TrackingTarget3D if tracking else ObjectTarget3D, cols,
            tags=[o.tag for o in objects], orientation_vars=c["orientation_var"],
            tids=c["tid"], auxs=[o.aux for o in objects],
            histories=c.get("history"), frame=frame_to,
            timestamp=objects.timestamp)

    def transform_points(self, points, frame_to, frame_from=None):
        """Convert a point cloud between frames (extra feature columns pass
        through)."""
        rt = self.get_extrinsic(frame_to, frame_from)
        xyz = points[:, :3].dot(rt[:3, :3].T) + rt[:3, 3]
        return np.concatenate((xyz, points[:, 3:]), axis=1)

    def project_points_to_camera(self, points, frame_to, frame_from=None,
                                 remove_outlier=True, return_dmask=False):
        """Pinhole projection with radial/tangential distortion
        (k1, k2, p1, p2, k3) and in-image masking with 20px tolerance
        (reference abstraction.pyx:979-1035).

        :return: (uv, mask[, dmask]); the masks are index arrays
        """
        self._assert_exist(frame_from)
        self._assert_exist(frame_to)
        meta = self.intrinsics_meta[frame_to]
        rt = self.get_extrinsic(frame_to=frame_to, frame_from=frame_from)
        homo_xyz = np.insert(points[:, :3], 3, 1, axis=1)

        # a stored 3x4 projection (KITTI-360 P_rect_0x) consumes the full
        # homogeneous row — the reference slices to 3 unconditionally and
        # crashes on these cameras (abstraction.pyx:994, latent bug)
        proj = self.intrinsics[frame_to]
        txyz = rt.dot(homo_xyz.T)
        homo_uv = proj.dot(txyz if proj.shape[1] == 4 else txyz[:3])
        d = homo_uv[2, :]
        u, v = homo_uv[0, :] / d, homo_uv[1, :] / d

        dmask = d > 0
        mask = (0 < u) & (u < meta.width) & (0 < v) & (v < meta.height) & dmask

        distorts = np.asarray(
            meta.distort_coeffs if meta.distort_coeffs is not None else [])
        if distorts.size > 0:
            tolerance = 20
            mask = ((-tolerance < u) & (u < meta.width + tolerance)
                    & (-tolerance < v) & (v < meta.height + tolerance))

            im = meta.intri_matrix
            fx, fy, cx, cy = im[0, 0], im[1, 1], im[0, 2], im[1, 2]
            k1, k2, p1, p2, k3 = distorts
            u, v = (u - cx) / fx, (v - cy) / fy
            r2 = u * u + v * v
            auv, au, av = 2 * u * v, r2 + 2 * u * u, r2 + 2 * v * v
            cdist = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            ud = u * cdist + p1 * auv + p2 * au
            vd = v * cdist + p1 * av + p2 * auv
            u, v = ud * fx + cx, vd * fy + cy

            nmask = (0 < u) & (u < meta.width) & (0 < v) & (v < meta.height)
            mask = mask & nmask & dmask

        if remove_outlier:
            u, v = u[mask], v[mask]
        mask = np.where(mask)[0]
        dmask = np.where(dmask)[0]
        if return_dmask:
            return np.array([u, v]).T, mask, dmask
        return np.array([u, v]).T, mask

    # -- persistence ---------------------------------------------------------
    def dump(self, output):
        if isinstance(output, (str, Path)):
            with Path(output).open("wb") as fout:
                pickle.dump(self, fout)
        elif hasattr(output, "write"):
            pickle.dump(self, output)
        else:
            raise ValueError("Invalid output object!")

    @classmethod
    def load(cls, file):
        if isinstance(file, (str, Path)):
            with Path(file).open("rb") as fin:
                return pickle.load(fin)
        if hasattr(file, "read"):
            return pickle.load(file)
        raise ValueError("Invalid input object!")

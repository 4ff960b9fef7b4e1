"""KITTI shared utilities: class taxonomies, calibration / oxts / timestamp /
velodyne / image readers (port of ``d3d_tpu.dataset.kitti.utils``; ``PIL``
is imported only by :func:`load_image`).

All readers take ``(basepath, file)`` where ``basepath`` is either a
directory path or an open ZipFile (the in-zip access path), mirroring the
reference loader convention.
"""

import io
from collections import namedtuple
from datetime import datetime
from enum import Enum, auto
from pathlib import Path

import numpy as np

__all__ = [
    "KittiObjectClass",
    "SemanticKittiClass",
    "SemanticKittiLearningClass",
    "OxtData",
    "read_file",
    "load_image",
    "load_velo_scan",
    "load_calib_file",
    "load_timestamps",
    "load_oxt_file",
    "parse_pose_from_oxt",
    "load_tracklets",
]


class KittiObjectClass(Enum):
    """Object categories of the KITTI benchmarks (devkit label values)."""

    DontCare = 0
    Car = auto()
    Van = auto()
    Truck = auto()
    Pedestrian = auto()
    Person = auto()  # person sitting
    Person_sitting = Person
    Cyclist = auto()
    Tram = auto()
    Misc = auto()


class SemanticKittiLearningClass(Enum):
    """SemanticKITTI learning ids (official devkit learning map)."""

    unlabeled = 0
    car = 1
    bicycle = 2
    motorcycle = 3
    truck = 4
    other_vehicle = 5
    person = 6
    bicyclist = 7
    motorcyclist = 8
    road = 9
    parking = 10
    sidewalk = 11
    other_ground = 12
    building = 13
    fence = 14
    vegetation = 15
    trunk = 16
    terrain = 17
    pole = 18
    traffic_sign = 19
    moving_car = 20
    moving_bicyclist = 21
    moving_person = 22
    moving_motorcyclist = 23
    moving_other_vehicle = 24
    moving_truck = 25


class SemanticKittiClass(Enum):
    """SemanticKITTI raw label ids."""

    unlabeled = 0
    outlier = 1
    car = 10
    bicycle = 11
    bus = 13
    motorcycle = 15
    on_rails = 16
    truck = 18
    other_vehicle = 20
    person = 30
    bicyclist = 31
    motorcyclist = 32
    road = 40
    parking = 44
    sidewalk = 48
    other_ground = 49
    building = 50
    fence = 51
    other_structure = 52
    lane_marking = 60
    vegetation = 70
    trunk = 71
    terrain = 72
    pole = 80
    traffic_sign = 81
    other_object = 99
    moving_car = 252
    moving_bicyclist = 253
    moving_person = 254
    moving_motorcyclist = 255
    moving_on_rails = 256
    moving_bus = 257
    moving_truck = 258
    moving_other_vehicle = 259

    def to_learning_id(self, static_only=True):
        m = {
            0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5,
            30: 6, 31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13,
            51: 14, 52: 0, 60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19,
            99: 0,
            252: 1 if static_only else 20,
            253: 7 if static_only else 21,
            254: 6 if static_only else 22,
            255: 8 if static_only else 23,
            256: 5 if static_only else 24,
            257: 5 if static_only else 24,
            258: 4 if static_only else 25,
            259: 5 if static_only else 24,
        }
        return SemanticKittiLearningClass(m[self.value])


# KITTI raw oxts packet layout (raw-data devkit readme order)
OxtData = namedtuple("OxtData", [
    "lat", "lon", "alt", "roll", "pitch", "yaw",
    "vn", "ve", "vf", "vl", "vu",
    "ax", "ay", "az", "af", "al", "au",
    "wx", "wy", "wz", "wf", "wl", "wu",
    "pos_accuracy", "vel_accuracy",
    "navstat", "numsats", "posmode", "velmode", "orimode",
])


def read_file(basepath, file):
    """Read a member as bytes from a directory or an open ZipFile."""
    if isinstance(basepath, (str, Path)):
        return (Path(basepath) / file).read_bytes()
    return basepath.read(str(file))


def load_image(basepath, file, gray=False):
    """Load an image into a PIL Image (L if gray else RGB)."""
    from PIL import Image

    data = read_file(basepath, file)
    img = Image.open(io.BytesIO(data))
    return img.convert("L" if gray else "RGB")


def load_velo_scan(basepath, file, binary=True, formatted=False):
    """Parse a KITTI velodyne scan into an (N, 4) float32 array (or a record
    array with x/y/z/intensity fields if ``formatted``). ``binary=False``
    parses the ASCII .txt scans of the raw 'extract' distribution."""
    raw = read_file(basepath, file)
    if binary:
        scan = np.frombuffer(raw, dtype=np.float32).reshape(-1, 4).copy()
    else:
        scan = np.loadtxt(io.BytesIO(raw),
                          dtype=np.float32).reshape(-1, 4)
    if formatted:
        rec = np.rec.fromarrays(
            [scan[:, 0], scan[:, 1], scan[:, 2], scan[:, 3]],
            names=["x", "y", "z", "intensity"])
        return rec
    return scan


def load_calib_file(basepath, file):
    """Parse a KITTI calibration text blob into a dict of float arrays
    (non-numeric values like calib_time stay strings)."""
    out = {}
    for line in read_file(basepath, file).decode().splitlines():
        line = line.strip()
        if not line:
            continue
        key, _, value = line.partition(":")
        if not value:  # 'key value...' style (odometry calib)
            key, _, value = line.partition(" ")
        value = value.strip()
        try:
            out[key.strip()] = np.array([float(v) for v in value.split()])
        except ValueError:
            out[key.strip()] = value
    return out


def load_timestamps(basepath, file, formatted=False):
    """Parse a KITTI timestamps.txt into int64 microsecond epochs (UTC —
    naive .timestamp() would shift by the HOST timezone, so the same file
    parsed on different machines disagreed), or into datetime objects when
    ``formatted``."""
    from datetime import timezone

    out = []
    stamps = []
    for line in read_file(basepath, file).decode().splitlines():
        line = line.strip()
        if not line:
            continue
        # format: 2011-09-26 13:02:25.964389445 (ns precision -> trim to us)
        stamp = datetime.strptime(line[:26], "%Y-%m-%d %H:%M:%S.%f")
        stamps.append(stamp)
        out.append(int(stamp.replace(tzinfo=timezone.utc).timestamp() * 1e6))
    if formatted:
        return stamps
    return np.asarray(out, dtype=np.int64)


def load_oxt_file(basepath, file):
    """Parse a KITTI oxts packet file into a list of OxtData."""
    out = []
    for line in read_file(basepath, file).decode().splitlines():
        line = line.strip()
        if not line:
            continue
        values = [float(v) for v in line.split()]
        values[-5:] = [int(v) for v in values[-5:]]
        out.append(OxtData(*values))
    return out


_EARTH_RADIUS = 6378137.0


def parse_pose_from_oxt(oxt, scale=None, origin=None):
    """Convert an oxts packet to an EgoPose on a local Mercator plane (the
    KITTI raw devkit projection; the reference shells out to the `utm`
    package instead, kitti/utils.py:331-336 — not available here and the
    Mercator form is what the devkit itself uses).

    :param scale: mercator scale (cos of reference latitude); computed from
        this packet when None
    :param origin: (x, y, z) origin to subtract when given
    """
    from scipy.spatial.transform import Rotation

    from ...abstraction import EgoPose

    if scale is None:
        scale = np.cos(oxt.lat * np.pi / 180.0)
    tx = scale * oxt.lon * np.pi * _EARTH_RADIUS / 180.0
    ty = scale * _EARTH_RADIUS * np.log(np.tan((90.0 + oxt.lat) * np.pi / 360.0))
    pos = np.array([tx, ty, oxt.alt])
    if origin is not None:
        pos = pos - origin
    rot = Rotation.from_euler("xyz", [oxt.roll, oxt.pitch, oxt.yaw])
    return EgoPose(pos, rot, position_var=np.eye(3) * oxt.pos_accuracy)


def load_tracklets(basepath, file):
    """Parse a KITTI raw tracklet_labels.xml into a list of simple objects
    with ``objectType``, ``h/w/l`` and ``poses`` (tx/ty/tz/rx/ry/rz...)."""
    import xml.etree.ElementTree as ET

    class _Obj:
        pass

    root = ET.fromstring(read_file(basepath, file).decode())
    tracklets = []
    for item in next(iter(root)):
        if item.tag != "item":
            continue
        obj = _Obj()
        for prop in item:
            if prop.tag == "poses":
                poses = []
                for p in prop:
                    if p.tag != "item":
                        continue
                    pose = _Obj()
                    for f in p:
                        try:
                            setattr(pose, f.tag, float(f.text))
                        except (TypeError, ValueError):
                            setattr(pose, f.tag, f.text)
                    poses.append(pose)
                obj.poses = poses
            elif prop.tag == "objectType":
                obj.objectType = prop.text
            else:
                try:
                    setattr(obj, prop.tag, float(prop.text))
                except (TypeError, ValueError):
                    setattr(obj, prop.tag, prop.text)
        tracklets.append(obj)
    return tracklets

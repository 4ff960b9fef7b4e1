"""CADC (Canadian Adverse Driving Conditions) utilities: taxonomy, novatel
INSPVAX parsing, timestamps and 3D annotation parsing (port of
``d3d_tpu.dataset.cadc.utils``; reference d3d/dataset/cadc/utils.py)."""

from collections import namedtuple
from enum import IntFlag

import numpy as np
from scipy.spatial.transform import Rotation

from ...abstraction import EgoPose, ObjectTag, ObjectTarget3D, Target3DArray
from ..kitti.utils import load_image, load_velo_scan, read_file

__all__ = ["CADCObjectClass", "INSPVAX", "load_inspvax",
           "parse_pose_from_inspvax", "load_timestamps", "load_3d_ann",
           "load_image", "load_velo_scan"]

# novatel INSPVAX message fields
INSPVAX = namedtuple("INSPVAX", [
    "latitude", "longitude", "altitude", "undulation",
    "latitude_std", "longitude_std", "altitude_std",
    "roll", "pitch", "azimuth",
    "roll_std", "pitch_std", "azimuth_std",
    "ins_status", "position_type", "extended_status",
    "seconds_since_update",
    "north_velocity", "east_velocity", "up_velocity",
    "north_velocity_std", "east_velocity_std", "up_velocity_std",
])


class CADCObjectClass(IntFlag):
    """CADC categories; nibble 0 = label, nibble 1 = sub-type attribute,
    nibble 2 = motion state."""

    Unknown = 0
    Car = 0x0001

    Truck = 0x0002
    Snowplow_Truck = 0x0012
    Semi_Truck = 0x0022
    Construction_Truck = 0x0032
    Garbage_Truck = 0x0042
    Pickup_Truck = 0x0052
    Emergency_Truck = 0x0062

    Bus = 0x0003
    Coach_Bus = 0x0013
    Transit_Bus = 0x0023
    Standard_School_Bus = 0x0033
    Van_School_Bus = 0x0043

    Bicycle = 0x0004
    With_Rider = 0x0014
    Without_Rider = 0x0024

    Horse_and_Buggy = 0x0005
    Pedestrian = 0x0006
    Pedestrian_With_Object = 0x0007
    Animal = 0x0008
    Garbage_Containers_on_Wheels = 0x0009
    Traffic_Guidance_Objects = 0x0010

    # states
    Parked = 0x0100
    Stopped = 0x0200
    Moving = 0x0300


def load_inspvax(basepath, file, labeled=True):
    """Parse one novatel INSPVAX text record."""
    values = [float(v) for v in read_file(basepath, file).strip().split(b" ")]
    if labeled:
        values[13:14] = [int(v) for v in values[13:14]]
        values.extend([float("nan")] * 8)
    else:
        values[13:16] = [int(v) for v in values[13:16]]
    return INSPVAX(*values)


_EARTH_RADIUS = 6378137.0


def parse_pose_from_inspvax(data):
    """INSPVAX -> EgoPose on a local Mercator plane (the reference uses the
    `utm` package, unavailable here; see kitti.utils.parse_pose_from_oxt)."""
    scale = np.cos(data.latitude * np.pi / 180.0)
    x = scale * data.longitude * np.pi * _EARTH_RADIUS / 180.0
    y = scale * _EARTH_RADIUS * np.log(
        np.tan((90.0 + data.latitude) * np.pi / 360.0))
    t = [x, y, data.altitude + data.undulation]
    r = Rotation.from_euler("yxz", [data.roll, data.pitch, -data.azimuth],
                            degrees=True)
    return EgoPose(
        t, r,
        position_var=np.diag([data.latitude_std, data.longitude_std,
                              data.altitude_std]),
        orientation_var=np.diag([data.roll_std, data.pitch_std,
                                 data.azimuth_std]))


def load_timestamps(basepath, file):
    """CADC timestamps are local (UTC-4) datetime strings -> int64 us."""
    tz_offset = np.timedelta64(-4, "h")
    stamps = [np.datetime64(line.strip()) - tz_offset
              for line in read_file(basepath, file).decode().splitlines()
              if line.strip()]
    return np.asarray(stamps, dtype="datetime64[us]").astype(np.int64)


def load_3d_ann(ditem):
    """One frame of the 3d_ann.json cuboids -> Target3DArray (lidar frame).

    Note: the reference indexes ``attributes.bicycle_tye`` (a typo that
    always falls through, cadc/utils.py:134); fixed here to bicycle_type.
    """
    obj_arr = Target3DArray(frame="lidar")
    for box in ditem["cuboids"]:
        attr = box.get("attributes", {})
        if attr.get("truck_type"):
            label = CADCObjectClass[attr["truck_type"]]
        elif attr.get("bus_type"):
            label = CADCObjectClass[attr["bus_type"]]
        elif attr.get("bicycle_type"):
            label = CADCObjectClass[attr["bicycle_type"]]
        else:
            label = CADCObjectClass[box["label"].replace(" ", "_")]
        if attr.get("state"):
            label = label | CADCObjectClass[attr["state"]]

        pos = box["position"]
        dim = box["dimensions"]
        obj_arr.append(ObjectTarget3D(
            [pos["x"], pos["y"], pos["z"]],
            Rotation.from_euler("z", box["yaw"]),
            [dim["y"], dim["x"], dim["z"]],
            ObjectTag(label, CADCObjectClass),
            tid=int(box["uuid"].replace("-", ""), 16) % (1 << 63),
        ))
    return obj_arr

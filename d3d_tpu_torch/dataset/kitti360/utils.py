"""KITTI-360 utilities: Cityscapes-style taxonomy, label tables, sick-scan /
bbox-XML / PLY parsing (port of ``d3d_tpu.dataset.kitti360.utils``; reference
d3d/dataset/kitti360/utils.py; label table data follows the public
kitti360Scripts definitions). Host Python and numpy."""

import xml.etree.ElementTree as ET
from collections import namedtuple
from enum import IntFlag

import numpy as np

from ...utils import EDict
from ..kitti.utils import read_file

__all__ = ["Kitti360Class", "id2label", "kittiId2label", "load_sick_scan",
           "load_bboxes", "load_ply"]


class Kitti360Class(IntFlag):
    """Cityscapes-style categories of KITTI-360; nibble 0 = category group,
    nibble 1 = label within the group."""

    void = 0x00
    unlabeled = 0x10
    ego_vehicle = 0x20
    rectification_border = 0x30
    out_of_roi = 0x40
    static = 0x50
    dynamic = 0x60
    ground = 0x70
    unknown_construction = 0x80
    unknown_vehicle = 0x90
    unknown_object = 0xA0

    flat = 0x01
    road = 0x11
    sidewalk = 0x21
    parking = 0x31
    rail_track = 0x41

    construction = 0x02
    building = 0x12
    wall = 0x22
    fence = 0x32
    guard_rail = 0x42
    bridge = 0x52
    tunnel = 0x62
    garage = 0x72
    gate = 0x82
    stop = 0x92

    object_ = 0x03
    pole = 0x13
    polegroup = 0x23
    traffic_light = 0x33
    traffic_sign = 0x43
    smallpole = 0x53
    lamp = 0x63
    trash_bin = 0x73
    vending_machine = 0x83
    box = 0x93

    nature = 0x04
    vegetation = 0x14
    terrain = 0x24

    sky = 0x05

    human = 0x06
    person = 0x16
    rider = 0x26

    vehicle = 0x07
    car = 0x17
    truck = 0x27
    bus = 0x37
    caravan = 0x47
    trailer = 0x57
    train = 0x67
    motorcycle = 0x77
    bicycle = 0x87
    license_plate = 0x97


# Label metadata following kitti360Scripts helpers/labels.py. Note: the
# reference re-uses colliding flag values for garage/gate/stop/smallpole/
# lamp/trash_bin/vending_machine/box (kitti360/utils.py:44-57); here they
# get distinct codes.
_Label = namedtuple("_Label", ["name", "id", "kittiId", "trainId", "category",
                               "catId", "hasInstances", "ignoreInEval",
                               "color"])

K = Kitti360Class
_labels = [
    _Label(K.unlabeled, 0, -1, 255, "void", 0, False, True, (0, 0, 0)),
    _Label(K.ego_vehicle, 1, -1, 255, "void", 0, False, True, (0, 0, 0)),
    _Label(K.rectification_border, 2, -1, 255, "void", 0, False, True, (0, 0, 0)),
    _Label(K.out_of_roi, 3, -1, 255, "void", 0, False, True, (0, 0, 0)),
    _Label(K.static, 4, -1, 255, "void", 0, False, True, (0, 0, 0)),
    _Label(K.dynamic, 5, -1, 255, "void", 0, False, True, (111, 74, 0)),
    _Label(K.ground, 6, -1, 255, "void", 0, False, True, (81, 0, 81)),
    _Label(K.road, 7, 1, 0, "flat", 1, False, False, (128, 64, 128)),
    _Label(K.sidewalk, 8, 3, 1, "flat", 1, False, False, (244, 35, 232)),
    _Label(K.parking, 9, 2, 255, "flat", 1, False, True, (250, 170, 160)),
    _Label(K.rail_track, 10, 10, 255, "flat", 1, False, True, (230, 150, 140)),
    _Label(K.building, 11, 11, 2, "construction", 2, True, False, (70, 70, 70)),
    _Label(K.wall, 12, 7, 3, "construction", 2, False, False, (102, 102, 156)),
    _Label(K.fence, 13, 8, 4, "construction", 2, False, False, (190, 153, 153)),
    _Label(K.guard_rail, 14, 30, 255, "construction", 2, False, True, (180, 165, 180)),
    _Label(K.bridge, 15, 31, 255, "construction", 2, False, True, (150, 100, 100)),
    _Label(K.tunnel, 16, 32, 255, "construction", 2, False, True, (150, 120, 90)),
    _Label(K.pole, 17, 21, 5, "object", 3, True, False, (153, 153, 153)),
    _Label(K.polegroup, 18, -1, 255, "object", 3, False, True, (153, 153, 153)),
    _Label(K.traffic_light, 19, 23, 6, "object", 3, True, False, (250, 170, 30)),
    _Label(K.traffic_sign, 20, 24, 7, "object", 3, True, False, (220, 220, 0)),
    _Label(K.vegetation, 21, 5, 8, "nature", 4, False, False, (107, 142, 35)),
    _Label(K.terrain, 22, 4, 9, "nature", 4, False, False, (152, 251, 152)),
    _Label(K.sky, 23, 9, 10, "sky", 5, False, False, (70, 130, 180)),
    _Label(K.person, 24, 19, 11, "human", 6, True, False, (220, 20, 60)),
    _Label(K.rider, 25, 20, 12, "human", 6, True, False, (255, 0, 0)),
    _Label(K.car, 26, 13, 13, "vehicle", 7, True, False, (0, 0, 142)),
    _Label(K.truck, 27, 14, 14, "vehicle", 7, True, False, (0, 0, 70)),
    _Label(K.bus, 28, 34, 15, "vehicle", 7, True, False, (0, 60, 100)),
    _Label(K.caravan, 29, 16, 255, "vehicle", 7, True, True, (0, 0, 90)),
    _Label(K.trailer, 30, 15, 255, "vehicle", 7, True, True, (0, 0, 110)),
    _Label(K.train, 31, 33, 16, "vehicle", 7, True, False, (0, 80, 100)),
    _Label(K.motorcycle, 32, 17, 17, "vehicle", 7, True, False, (0, 0, 230)),
    _Label(K.bicycle, 33, 18, 18, "vehicle", 7, True, False, (119, 11, 32)),
    _Label(K.garage, 34, 12, 2, "construction", 2, True, False, (64, 128, 128)),
    _Label(K.gate, 35, 6, 4, "construction", 2, False, False, (190, 153, 153)),
    _Label(K.stop, 36, 29, 255, "construction", 2, True, True, (150, 120, 90)),
    _Label(K.smallpole, 37, 22, 5, "object", 3, True, False, (153, 153, 153)),
    _Label(K.lamp, 38, 25, 255, "object", 3, True, False, (0, 64, 64)),
    _Label(K.trash_bin, 39, 26, 255, "object", 3, True, False, (0, 128, 192)),
    _Label(K.vending_machine, 40, 27, 255, "object", 3, True, False, (128, 64, 0)),
    _Label(K.box, 41, 28, 255, "object", 3, True, False, (64, 64, 128)),
    _Label(K.unknown_construction, 42, 35, 255, "void", 0, False, True, (102, 0, 0)),
    _Label(K.unknown_vehicle, 43, 36, 255, "void", 0, False, True, (51, 0, 51)),
    _Label(K.unknown_object, 44, 37, 255, "void", 0, False, True, (32, 32, 32)),
    _Label(K.license_plate, -1, -1, -1, "vehicle", 7, False, True, (0, 0, 142)),
]
del K

kittiId2label = {label.kittiId: label for label in _labels}
id2label = {label.id: label for label in _labels}


def load_sick_scan(basepath, file):
    """SICK scans: (N, 2) float32 in the scan plane."""
    return np.frombuffer(read_file(basepath, file),
                         dtype=np.float32).reshape(-1, 2).copy()


def load_bboxes(basepath, file):
    """Parse a data_3d_bboxes XML into (objects, frame_ranges) where each
    frame range is (start, end, object_index) — dynamic objects are valid
    only at their timestamp, static objects over [start_frame, end_frame)."""
    root = ET.fromstring(read_file(basepath, file).decode())

    objects, ranges = [], []
    for child in root:
        if not child.tag.startswith("object"):
            continue
        obj = EDict()
        for prop in child:
            if prop.tag == "transform":
                obj.transform = np.fromstring(
                    prop.find("data").text, dtype=float, sep=" ").reshape(4, 4)
            elif prop.tag == "vertices":
                obj.vertices = np.fromstring(
                    prop.find("data").text, dtype=float, sep=" ").reshape(-1, 3)
            elif prop.tag == "faces":
                obj.faces = np.fromstring(
                    prop.find("data").text, dtype=int, sep=" ").reshape(-1, 3)
            elif prop.tag in ("label", "category"):
                obj[prop.tag] = prop.text
            else:
                obj[prop.tag] = int(prop.text)

        idx = len(objects)
        objects.append(obj)
        if obj.get("dynamic", 0):
            ranges.append((obj.timestamp, obj.timestamp + 1, idx))
        else:
            # end_frame is INCLUSIVE in KITTI-360 (kitti360Scripts tests
            # start <= f <= end); the reference feeds it into an
            # end-exclusive intervaltree Interval, dropping every static
            # object on its last valid frame — reference bug fixed
            ranges.append((obj.start_frame, obj.end_frame + 1, idx))
    return objects, ranges


def load_ply(basepath, file):
    """Minimal binary-little-endian PLY reader returning a structured array
    (covers the data_3d_semantics point clouds; no plyfile dependency)."""
    data = read_file(basepath, file)
    header_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:header_end].decode().splitlines()

    _types = {"float": "<f4", "float32": "<f4", "double": "<f8",
              "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4",
              "uint": "<u4", "uint32": "<u4", "short": "<i2",
              "ushort": "<u2"}
    count = 0
    fields = []
    in_vertex = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format" and parts[1] != "binary_little_endian":
            raise NotImplementedError("only binary_little_endian PLY supported")
        if parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            fields.append((parts[2], _types[parts[1]]))

    dtype = np.dtype(fields)
    return np.frombuffer(data, dtype=dtype, count=count,
                         offset=header_end).copy()

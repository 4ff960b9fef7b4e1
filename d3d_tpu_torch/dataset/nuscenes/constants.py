"""nuScenes taxonomy and official splits (port of
``d3d_tpu.dataset.nuscenes.constants``; reference
d3d/dataset/nuscenes/constants.py; taxonomy and split data follow the public
nuscenes-devkit definitions).

`NuscenesObjectClass` packs category levels and the attribute into a 16-bit
IntFlag: nibble 0 = level-0 category, nibble 1 = level-1, nibble 2 = level-2,
nibble 3 = attribute — so ``cls.category``/``cls.attribute`` are mask
operations and category|attribute compose into one value.
"""

from enum import Enum, IntFlag, auto

__all__ = [
    "NuscenesObjectClass", "NuscenesDetectionClass",
    "NuscenesSegmentationClass", "train_detect", "train_track",
    "train_split", "val_split",
]


def _expand(ranges):
    return ["scene-%04d" % n for lo, hi in ranges for n in range(lo, hi + 1)]


# official nuScenes trainval splits (scene numbers, run-length compressed)
train_detect = _expand([(1, 2), (41, 76), (161, 168), (170, 176), (190, 196), (199, 200), (202, 204), (206, 214), (254, 264), (283, 306), (315, 318), (321, 321), (323, 324), (347, 375), (382, 382), (420, 439), (457, 459), (461, 465), (467, 469), (471, 472), (474, 480), (566, 566), (568, 568), (570, 578), (580, 580), (582, 583), (665, 679), (681, 681), (683, 689), (739, 741), (744, 744), (746, 747), (749, 752), (757, 765), (767, 769), (868, 873), (875, 878), (880, 880), (882, 903), (945, 945), (947, 947), (949, 949), (952, 953), (955, 961), (975, 984), (988, 991), (1011, 1025), (1074, 1102), (1104, 1105)])
train_track = _expand([(4, 11), (19, 34), (120, 135), (138, 139), (149, 152), (154, 155), (157, 160), (177, 185), (187, 188), (218, 220), (222, 222), (224, 253), (328, 328), (376, 381), (383, 386), (388, 403), (405, 408), (410, 419), (440, 456), (499, 502), (504, 515), (517, 518), (525, 539), (541, 546), (584, 600), (639, 664), (695, 698), (700, 701), (703, 719), (726, 728), (730, 731), (733, 738), (786, 787), (789, 792), (803, 806), (808, 813), (815, 817), (819, 822), (847, 856), (858, 858), (860, 866), (992, 992), (994, 1010), (1044, 1058), (1106, 1110)])
val_split = _expand([(3, 3), (12, 18), (35, 36), (38, 39), (92, 110), (221, 221), (268, 278), (329, 332), (344, 346), (519, 524), (552, 565), (625, 627), (629, 630), (632, 638), (770, 771), (775, 775), (777, 778), (780, 784), (794, 800), (802, 802), (904, 917), (919, 931), (962, 963), (966, 969), (971, 972), (1059, 1073)])
train_split = sorted(set(train_detect + train_track))


class NuscenesDetectionClass(Enum):
    """The 10 detection-challenge classes (+ ignore)."""

    ignore = 0
    barrier = auto()
    bicycle = auto()
    bus = auto()
    car = auto()
    construction_vehicle = auto()
    motorcycle = auto()
    pedestrian = auto()
    traffic_cone = auto()
    trailer = auto()
    truck = auto()


class NuscenesSegmentationClass(Enum):
    """The 16 lidar-segmentation classes (+ ignore); one-to-one with the
    detection classes plus the flat/static categories."""

    ignore = 0
    barrier = auto()
    bicycle = auto()
    bus = auto()
    car = auto()
    construction_vehicle = auto()
    motorcycle = auto()
    pedestrian = auto()
    traffic_cone = auto()
    trailer = auto()
    truck = auto()
    driveable_surface = auto()
    other_flat = auto()
    sidewalk = auto()
    terrain = auto()
    manmade = auto()
    vegetation = auto()


class NuscenesObjectClass(IntFlag):
    """Categories + attributes of nuScenes annotations, nibble-packed (see
    module docstring)."""

    unknown = 0x0000
    noise = 0x0010

    # categories
    animal = 0x0001
    human = 0x0002
    human_pedestrian = 0x0012
    human_pedestrian_adult = 0x0112
    human_pedestrian_child = 0x0212
    human_pedestrian_construction_worker = 0x0312
    human_pedestrian_personal_mobility = 0x0412
    human_pedestrian_police_officer = 0x0512
    human_pedestrian_stroller = 0x0612
    human_pedestrian_wheelchair = 0x0712
    movable_object = 0x0003
    movable_object_barrier = 0x0013
    movable_object_debris = 0x0023
    movable_object_pushable_pullable = 0x0033
    movable_object_trafficcone = 0x0043
    vehicle_bicycle = 0x0004
    vehicle_bus = 0x0014
    vehicle_bus_bendy = 0x0114
    vehicle_bus_rigid = 0x0214
    vehicle_car = 0x0024
    vehicle_construction = 0x0034
    vehicle_emergency = 0x0044
    vehicle_emergency_ambulance = 0x0144
    vehicle_emergency_police = 0x0244
    vehicle_motorcycle = 0x0054
    vehicle_trailer = 0x0064
    vehicle_truck = 0x0074
    vehicle_ego = 0x0084
    static_object = 0x0005
    static_object_bicycle_rack = 0x0015
    flat = 0x0006
    flat_driveable_surface = 0x0016
    flat_sidewalk = 0x0026
    flat_terrain = 0x0036
    flat_other = 0x0046
    static = 0x0007
    static_manmade = 0x0017
    static_vegetation = 0x0027
    static_other = 0x0037

    # attributes
    vehicle_moving = 0x1000
    vehicle_stopped = 0x2000
    vehicle_parked = 0x3000
    cycle_with_rider = 0x4000
    cycle_without_rider = 0x5000
    pedestrian_sitting_lying_down = 0x6000
    pedestrian_standing = 0x7000
    pedestrian_moving = 0x8000

    @classmethod
    def parse(cls, string):
        """Parse a dotted nuScenes name (e.g. 'vehicle.bus.rigid')."""
        return cls[string.replace(".", "_")]

    # lidarseg category.json index order
    @classmethod
    def _id_table(cls):
        return [
            cls.noise, cls.animal, cls.human_pedestrian_adult,
            cls.human_pedestrian_child,
            cls.human_pedestrian_construction_worker,
            cls.human_pedestrian_personal_mobility,
            cls.human_pedestrian_police_officer, cls.human_pedestrian_stroller,
            cls.human_pedestrian_wheelchair, cls.movable_object_barrier,
            cls.movable_object_debris, cls.movable_object_pushable_pullable,
            cls.movable_object_trafficcone, cls.static_object_bicycle_rack,
            cls.vehicle_bicycle, cls.vehicle_bus_bendy, cls.vehicle_bus_rigid,
            cls.vehicle_car, cls.vehicle_construction,
            cls.vehicle_emergency_ambulance, cls.vehicle_emergency_police,
            cls.vehicle_motorcycle, cls.vehicle_trailer, cls.vehicle_truck,
            cls.flat_driveable_surface, cls.flat_other, cls.flat_sidewalk,
            cls.flat_terrain, cls.static_manmade, cls.static_other,
            cls.static_vegetation, cls.vehicle_ego,
        ]

    @classmethod
    def from_nuscenes_id(cls, nid):
        return cls._id_table()[nid]

    @property
    def category(self):
        return self & 0x0FFF

    @property
    def attribute(self):
        return self & 0xF000

    # canonical dotted names from the nuScenes category.json
    @classmethod
    def _dotted_names(cls):
        return {
            cls.noise: "noise", cls.animal: "animal", cls.human: "human",
            cls.human_pedestrian: "human.pedestrian",
            cls.human_pedestrian_adult: "human.pedestrian.adult",
            cls.human_pedestrian_child: "human.pedestrian.child",
            cls.human_pedestrian_construction_worker:
                "human.pedestrian.construction_worker",
            cls.human_pedestrian_personal_mobility:
                "human.pedestrian.personal_mobility",
            cls.human_pedestrian_police_officer:
                "human.pedestrian.police_officer",
            cls.human_pedestrian_stroller: "human.pedestrian.stroller",
            cls.human_pedestrian_wheelchair: "human.pedestrian.wheelchair",
            cls.movable_object: "movable_object",
            cls.movable_object_barrier: "movable_object.barrier",
            cls.movable_object_debris: "movable_object.debris",
            cls.movable_object_pushable_pullable:
                "movable_object.pushable_pullable",
            cls.movable_object_trafficcone: "movable_object.trafficcone",
            cls.vehicle_bicycle: "vehicle.bicycle",
            cls.vehicle_bus: "vehicle.bus",
            cls.vehicle_bus_bendy: "vehicle.bus.bendy",
            cls.vehicle_bus_rigid: "vehicle.bus.rigid",
            cls.vehicle_car: "vehicle.car",
            cls.vehicle_construction: "vehicle.construction",
            cls.vehicle_emergency: "vehicle.emergency",
            cls.vehicle_emergency_ambulance: "vehicle.emergency.ambulance",
            cls.vehicle_emergency_police: "vehicle.emergency.police",
            cls.vehicle_motorcycle: "vehicle.motorcycle",
            cls.vehicle_trailer: "vehicle.trailer",
            cls.vehicle_truck: "vehicle.truck",
            cls.vehicle_ego: "vehicle.ego",
            cls.static_object: "static_object",
            cls.static_object_bicycle_rack: "static_object.bicycle_rack",
            cls.flat: "flat",
            cls.flat_driveable_surface: "flat.driveable_surface",
            cls.flat_sidewalk: "flat.sidewalk",
            cls.flat_terrain: "flat.terrain",
            cls.flat_other: "flat.other",
            cls.static: "static",
            cls.static_manmade: "static.manmade",
            cls.static_vegetation: "static.vegetation",
            cls.static_other: "static.other",
        }

    @property
    def category_name(self):
        """Dotted category name as used in the nuScenes json files."""
        return self._dotted_names().get(self.category,
                                        self.category.name or "unknown")

    @property
    def attribute_name(self):
        name = self.attribute.name
        if name is None:
            return "unknown"
        first, _, rest = name.partition("_")
        return f"{first}.{rest}" if rest else first

    @property
    def pretty_name(self):
        return f"{self.category_name}[{self.attribute_name}]"

    @property
    def nuscenes_id(self):
        try:
            return self._id_table().index(self.category)
        except ValueError:
            return 0

    def to_detection(self):
        """Project onto the 10-class detection taxonomy (official mapping)."""
        c = NuscenesObjectClass
        d = NuscenesDetectionClass
        mapping = {
            c.movable_object_barrier: d.barrier,
            c.vehicle_bicycle: d.bicycle,
            c.vehicle_bus_bendy: d.bus,
            c.vehicle_bus_rigid: d.bus,
            c.vehicle_car: d.car,
            c.vehicle_construction: d.construction_vehicle,
            c.vehicle_motorcycle: d.motorcycle,
            c.human_pedestrian_adult: d.pedestrian,
            c.human_pedestrian_child: d.pedestrian,
            c.human_pedestrian_construction_worker: d.pedestrian,
            c.human_pedestrian_police_officer: d.pedestrian,
            c.movable_object_trafficcone: d.traffic_cone,
            c.vehicle_trailer: d.trailer,
            c.vehicle_truck: d.truck,
        }
        return mapping.get(self.category, d.ignore)

    def to_segmentation(self):
        """Project onto the 16-class lidarseg taxonomy (official mapping)."""
        c = NuscenesObjectClass
        s = NuscenesSegmentationClass
        mapping = {
            c.movable_object_barrier: s.barrier,
            c.vehicle_bicycle: s.bicycle,
            c.vehicle_bus_bendy: s.bus,
            c.vehicle_bus_rigid: s.bus,
            c.vehicle_car: s.car,
            c.vehicle_construction: s.construction_vehicle,
            c.vehicle_motorcycle: s.motorcycle,
            c.human_pedestrian_adult: s.pedestrian,
            c.human_pedestrian_child: s.pedestrian,
            c.human_pedestrian_construction_worker: s.pedestrian,
            c.human_pedestrian_police_officer: s.pedestrian,
            c.movable_object_trafficcone: s.traffic_cone,
            c.vehicle_trailer: s.trailer,
            c.vehicle_truck: s.truck,
            c.flat_driveable_surface: s.driveable_surface,
            c.flat_other: s.other_flat,
            c.flat_sidewalk: s.sidewalk,
            c.flat_terrain: s.terrain,
            c.static_manmade: s.manmade,
            c.static_vegetation: s.vegetation,
        }
        return mapping.get(self.category, s.ignore)

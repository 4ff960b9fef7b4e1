"""Waymo Open Dataset loader over the converted per-segment layout produced
by :mod:`d3d_tpu_torch.dataset.waymo.converter` (port of
``d3d_tpu.dataset.waymo.loader``; reference d3d/dataset/waymo/loader.py;
same converted-segment contract). Host Python and numpy.

Layout: ``<base>/{training,validation}/<segment>(.zip)/`` containing
``context/{stats,calib_cams,calib_lidars}.json``, per-frame
``<lidar>/NNNN.bin`` (x, y, z, intensity, elongation in sensor frame),
``<camera>/NNNN.jpg``, ``label_lidars/NNNN.json``, ``label_<camera>/NNNN.
json``, ``pose/NNNN.bin`` and ``timestamp/NNNN.txt``."""

import base64
import io
import json
import struct
from pathlib import Path

import msgpack
import numpy as np
from scipy.spatial.transform import Rotation
from sortedcontainers import SortedDict

from ...abstraction import (EgoPose, ObjectTag, ObjectTarget3D, Target3DArray,
                            TransformSet)
from ...utils import EDict
from ..base import TrackingDatasetBase, expand_idx, expand_idx_name
from ..zip import PatchedZipFile
from .constants import WaymoObjectClass

__all__ = ["WaymoLoader"]


class WaymoLoader(TrackingDatasetBase):
    """Loader for converted Waymo segments (run ``d3d_tpu_waymo_convert``
    over the tfrecords first). Waymo ships separate training/validation
    archives, so trainval_split is unused."""

    VALID_CAM_NAMES = ["camera_front", "camera_front_left",
                       "camera_front_right", "camera_side_left",
                       "camera_side_right"]
    VALID_LIDAR_NAMES = ["lidar_top", "lidar_front", "lidar_side_left",
                         "lidar_side_right", "lidar_rear"]
    VALID_OBJ_CLASSES = WaymoObjectClass

    def __init__(self, base_path, phase="training", inzip=False,
                 trainval_split=None, trainval_random=False, nframes=0):
        super().__init__(base_path, inzip=inzip, phase=phase, nframes=nframes)
        self.base_path = Path(base_path) / phase
        self._calib_cache = {}
        self._load_metadata()

    def _load_metadata(self):
        meta_path = self.base_path / "metadata.msg"
        if not meta_path.exists():
            metadata = {}
            if self.inzip:
                for ar in self.base_path.iterdir():
                    if ar.suffix != ".zip":
                        continue
                    with PatchedZipFile(ar,
                                        to_extract="context/stats.json") as z:
                        metadata[ar.stem] = json.loads(
                            z.read("context/stats.json"))
            else:
                for folder in self.base_path.iterdir():
                    if not folder.is_dir():
                        continue
                    metadata[folder.name] = json.loads(
                        (folder / "context/stats.json").read_text())
            assert metadata, "No converted Waymo segments found!"
            try:
                meta_path.write_bytes(msgpack.packb(metadata))
            except OSError:
                # read-only dataset mount: keep the in-memory metadata
                self._metadata = SortedDict(
                    (k, EDict(v)) for k, v in metadata.items())
                return
        self._metadata = SortedDict(
            (k, EDict(v)) for k, v in msgpack.unpackb(
                meta_path.read_bytes()).items())

    def __len__(self):
        return sum(max(v["frame_count"] - self.nframes, 0)
                   for v in self._metadata.values())

    @property
    def sequence_ids(self):
        return list(self._metadata.keys())

    @property
    def sequence_sizes(self):
        return {k: v["frame_count"] for k, v in self._metadata.items()}

    def _locate_frame(self, idx):
        from ..base import locate_windowed_frame
        counts = {k: v["frame_count"] for k, v in self._metadata.items()}
        return locate_windowed_frame(idx, counts, self.nframes)

    def _read(self, seq_id, fname):
        if self.inzip:
            with PatchedZipFile(self.base_path / (seq_id + ".zip"),
                                to_extract=fname) as ar:
                return ar.read(fname)
        return (self.base_path / seq_id / fname).read_bytes()

    def _read_json(self, seq_id, fname):
        return json.loads(self._read(seq_id, fname))

    # -- accessors ---------------------------------------------------------------
    @expand_idx_name(VALID_LIDAR_NAMES)
    def lidar_data(self, idx, names="lidar_top", formatted=False):
        seq_id, frame_idx = idx
        fname = "%s/%04d.bin" % (names, frame_idx)
        if self._return_file_path:
            return self.base_path / seq_id / fname
        cloud = np.frombuffer(self._read(seq_id, fname),
                              dtype="f4").reshape(-1, 5).copy()
        # clouds are stored in the sensor frame; report in the vehicle
        # frame. extrinsics[frame] holds vehicle->sensor (TransformSet
        # stores the inverse of set_extrinsic(frame_from=...)), so the
        # sensor->vehicle transform is get_extrinsic(frame_from=names) —
        # the raw matrix applied points in the WRONG direction (round-2
        # review finding: clouds came out mirrored through the mount).
        rt = self.calibration_data(idx).get_extrinsic(frame_from=names)
        cloud[:, :3] = cloud[:, :3].dot(rt[:3, :3].T) + rt[:3, 3]
        if not formatted:
            return cloud
        return np.rec.fromarrays(
            cloud.T, names=["x", "y", "z", "intensity", "elongation"])

    @expand_idx_name(VALID_CAM_NAMES)
    def camera_data(self, idx, names="camera_front"):
        from PIL import Image

        seq_id, frame_idx = idx
        fname = "%s/%04d.jpg" % (names, frame_idx)
        if self._return_file_path:
            return self.base_path / seq_id / fname
        return Image.open(io.BytesIO(self._read(seq_id, fname))).convert("RGB")

    @expand_idx_name(VALID_CAM_NAMES)
    def annotation_2dobject(self, idx, names="camera_front"):
        seq_id, frame_idx = idx
        fname = "label_%s/%04d.json" % (names, frame_idx)
        if self._return_file_path:
            return self.base_path / seq_id / fname
        return [EDict(v) for v in self._read_json(seq_id, fname)]

    @expand_idx
    def annotation_3dobject(self, idx, raw=False):
        seq_id, frame_idx = idx
        fname = "label_lidars/%04d.json" % frame_idx
        if self._return_file_path:
            return self.base_path / seq_id / fname
        labels = [EDict(v) for v in self._read_json(seq_id, fname)]
        if raw:
            return labels

        arr = Target3DArray(frame="vehicle")
        for label in labels:
            tid_bytes = base64.urlsafe_b64decode(label.id[:12])
            (tid,) = struct.unpack("Q", tid_bytes[:8])
            # num_points/difficulty are present in conversions made after
            # the benchmarks_waymo stratification landed; keep older zips
            # loadable (aux simply lacks the keys)
            aux = {k: label[k] for k in ("num_points", "difficulty")
                   if k in label}
            arr.append(ObjectTarget3D(
                label.center, Rotation.from_euler("z", label.heading),
                label.size, ObjectTag(label.label, WaymoObjectClass),
                tid=tid, aux=aux or None))
        return arr

    def calibration_data(self, idx):
        seq_id, _ = (self._locate_frame(idx)
                     if isinstance(idx, (int, np.integer)) else idx)
        assert not self._return_file_path, \
            "The calibration data is not in a single file!"
        if seq_id in self._calib_cache:  # JSON parse once per segment
            return self._calib_cache[seq_id]

        calib = TransformSet("vehicle")
        calib_cams = self._read_json(seq_id, "context/calib_cams.json")
        calib_lidars = self._read_json(seq_id, "context/calib_lidars.json")

        for frame, entry in calib_cams.items():
            frame = "camera_" + frame
            (fu, fv, cu, cv), distort = entry["intrinsic"][:4], entry["intrinsic"][4:]
            transform = np.array(entry["extrinsic"]).reshape(4, 4)
            calib.set_intrinsic_pinhole(frame, (entry["width"], entry["height"]),
                                        cu, cv, fu, fv,
                                        distort_coeffs=distort)
            calib.set_extrinsic(transform, frame_from=frame)
        for frame, entry in calib_lidars.items():
            frame = "lidar_" + frame
            calib.set_intrinsic_lidar(frame)
            calib.set_extrinsic(np.array(entry["extrinsic"]).reshape(4, 4),
                                frame_from=frame)
        self._calib_cache[seq_id] = calib
        return calib

    @expand_idx
    def identity(self, idx):
        return idx

    @expand_idx
    def timestamp(self, idx, names=None):
        seq_id, frame_idx = idx
        return int(self._read(seq_id, "timestamp/%04d.txt" % frame_idx))

    @expand_idx
    def pose(self, idx, raw=False):
        seq_id, frame_idx = idx
        rt = np.frombuffer(self._read(seq_id, "pose/%04d.bin" % frame_idx),
                           dtype="f8").reshape(4, 4)
        if raw:
            return rt
        return EgoPose(rt[:3, 3], rt[:3, :3])

    @property
    def pose_name(self):
        return "vehicle"

    @expand_idx
    def dump_detection_output(self, idx, detections, fout):
        """Serialize detections as a waymo_open_dataset metrics_pb2.Objects
        blob (requires the waymo_open_dataset package)."""
        try:
            from waymo_open_dataset import label_pb2
            from waymo_open_dataset.protos import metrics_pb2
        except ImportError:
            raise ImportError(
                "waymo_open_dataset is required to dump Waymo submissions; "
                "install it from github.com/waymo-research/waymo-open-dataset")

        label_map = {
            WaymoObjectClass.Unknown: label_pb2.Label.TYPE_UNKNOWN,
            WaymoObjectClass.Vehicle: label_pb2.Label.TYPE_VEHICLE,
            WaymoObjectClass.Pedestrian: label_pb2.Label.TYPE_PEDESTRIAN,
            WaymoObjectClass.Sign: label_pb2.Label.TYPE_SIGN,
            WaymoObjectClass.Cyclist: label_pb2.Label.TYPE_CYCLIST,
        }
        objects = metrics_pb2.Objects()
        for target in detections:
            obj = metrics_pb2.Object()
            box = label_pb2.Label.Box()
            box.center_x, box.center_y, box.center_z = target.position
            box.length, box.width, box.height = target.dimension
            box.heading = target.yaw
            obj.object.box.CopyFrom(box)
            obj.object.type = label_map[target.tag_top]
            obj.score = target.tag_top_score
            obj.context_name = idx[0]
            obj.frame_timestamp_micros = self.timestamp(idx, bypass=True)
            objects.objects.append(obj)
        data = objects.SerializeToString()
        if isinstance(fout, (str, Path)):
            Path(fout).write_bytes(data)
        else:
            fout.write(data)

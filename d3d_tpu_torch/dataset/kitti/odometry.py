"""KITTI odometry dataset loader with SemanticKITTI point-label support
(port of ``d3d_tpu.dataset.kitti.odometry``; reference
d3d/dataset/kitti/odometry.py). Host Python and numpy.

Layout (zipped: ``data_odometry_{calib,color,gray,velodyne,poses,labels}
.zip``; unzipped: ``<base>/dataset/{poses/XX.txt, sequences/XX/{image_*,
velodyne, labels, calib.txt, times.txt}}``). Sequences 00-10 are the
train/val pool, 11+ are testing."""

from collections import defaultdict
from pathlib import Path
from zipfile import ZipFile

import numpy as np

from ...abstraction import EgoPose, TransformSet
from ...utils import EDict
from ..base import (SegmentationDatasetMixin, TrackingDatasetBase,
                    expand_idx, expand_idx_name, split_trainval_seq)
from ..zip import PatchedZipFile
from . import utils
from .utils import SemanticKittiClass, SemanticKittiLearningClass

__all__ = ["KittiOdometryLoader"]


def _learning_map(static_only=True):
    return {c.value: c.to_learning_id(static_only).value
            for c in SemanticKittiClass}


class KittiOdometryLoader(TrackingDatasetBase, SegmentationDatasetMixin):
    """Loader for the KITTI odometry benchmark (+ SemanticKITTI labels);
    see module docstring for the layout."""

    VALID_CAM_NAMES = ["cam0", "cam1", "cam2", "cam3"]
    VALID_LIDAR_NAMES = ["velo"]
    VALID_PTS_CLASSES = SemanticKittiClass

    def __init__(self, base_path, inzip=True, phase="training",
                 trainval_split=0.8, trainval_random=False,
                 trainval_byseq=False, nframes=0):
        super().__init__(base_path, inzip=inzip, phase=phase, nframes=nframes,
                         trainval_split=trainval_split,
                         trainval_random=trainval_random,
                         trainval_byseq=trainval_byseq)

        frame_count = defaultdict(int)
        if self.inzip:
            for folder in ("gray", "color", "velodyne", "labels"):
                data_zip = self.base_path / ("data_odometry_%s.zip" % folder)
                if not data_zip.exists():
                    continue
                with ZipFile(data_zip) as data:
                    for name in data.namelist():
                        parts = Path(name).parts
                        if len(parts) < 5:
                            continue
                        seq = int(parts[2])
                        frame_count[seq] = max(frame_count[seq],
                                               int(Path(name).stem) + 1)
                break
        else:
            fpath = self.base_path / "dataset" / "sequences"
            if fpath.exists():
                for seq_path in sorted(fpath.iterdir()):
                    seq = int(seq_path.name)
                    for folder in ("image_2", "image_3", "velodyne"):
                        sub = seq_path / folder
                        if sub.exists():
                            frame_count[seq] = sum(1 for _ in sub.iterdir())
                            break

        if not frame_count:
            raise ValueError("Cannot parse dataset or empty dataset, please "
                             "check path, inzip option and file structure")

        if phase in ("training", "validation"):
            frame_count = {k: v for k, v in frame_count.items() if k <= 10}
        else:
            frame_count = {k: v for k, v in frame_count.items() if k >= 11}
        # imported here: importing the KITTI package does not need it
        from sortedcontainers import SortedDict

        self.frame_dict = SortedDict(frame_count)
        # split over window-reduced counts so len() matches the index domain
        # of _locate_frame (the reference leaves this as a TODO, base.py:71)
        reduced = SortedDict({k: max(v - self.nframes, 0)
                              for k, v in self.frame_dict.items()})
        self.frames = split_trainval_seq(phase, reduced, trainval_split,
                                         trainval_random, trainval_byseq)
        self._image_size_cache = {}
        self._pose_cache = {}
        self._calib_cache = {}
        self._timestamp_cache = {}

    def __len__(self):
        return len(self.frames)

    @property
    def sequence_ids(self):
        return list(self.frame_dict.keys())

    @property
    def sequence_sizes(self):
        return dict(self.frame_dict)

    def _locate_frame(self, idx):
        from ..base import locate_windowed_frame
        return locate_windowed_frame(self.frames[idx], self.frame_dict,
                                     self.nframes)

    @expand_idx
    def identity(self, idx):
        return idx

    @expand_idx
    def identity_in_raw(self, idx):
        """Identity of this frame in the KITTI raw dataset."""
        seq_map = {
            0: "2011_10_03_drive_0027", 1: "2011_10_03_drive_0042",
            2: "2011_10_03_drive_0034", 3: "2011_09_26_drive_0067",
            4: "2011_09_30_drive_0016", 5: "2011_09_30_drive_0018",
            6: "2011_09_30_drive_0020", 7: "2011_09_30_drive_0027",
            8: "2011_09_30_drive_0028", 9: "2011_09_30_drive_0033",
            10: "2011_09_30_drive_0034",
        }
        seq_id, frame_id = idx
        if seq_id not in seq_map:
            raise ValueError(
                "Sequence mapping is not available for testing data!")
        if seq_id == 8:
            frame_id += 1100
        return seq_map[seq_id] + "_sync", frame_id

    # -- calibration ---------------------------------------------------------
    def _preload_calib(self, seq_id):
        if seq_id in self._calib_cache:
            return
        fname = Path("dataset", "sequences", "%02d" % seq_id, "calib.txt")
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_odometry_calib.zip",
                                to_extract=fname) as src:
                self._calib_cache[seq_id] = utils.load_calib_file(src, fname)
        else:
            self._calib_cache[seq_id] = utils.load_calib_file(self.base_path,
                                                              fname)

    def calibration_data(self, idx, raw=False):
        assert not self._return_file_path, \
            "The calibration is not stored in single file!"
        seq_id, _ = (self._locate_frame(idx)
                     if isinstance(idx, (int, np.integer)) else idx)
        self._preload_calib(seq_id)
        filedata = self._calib_cache[seq_id]
        if raw:
            return filedata

        if seq_id not in self._image_size_cache:
            self.camera_data((seq_id, 0), bypass=True)
        image_size = self._image_size_cache[seq_id]

        data = TransformSet("velo")
        velo_to_cam = filedata["Tr"].reshape(3, 4)
        for i in range(4):
            p = filedata["P%d" % i].reshape(3, 4)
            projection = p[:, :3]
            offset = np.linalg.inv(projection).dot(p[:, 3])
            extri = np.vstack([velo_to_cam, [0, 0, 0, 1]])
            extri[:3, 3] += offset
            frame = "cam%d" % i
            data.set_intrinsic_camera(frame, projection, image_size,
                                      rotate=False)
            data.set_extrinsic(extri, frame_to=frame)
        return data

    # -- data ----------------------------------------------------------------
    @expand_idx_name(VALID_CAM_NAMES)
    def camera_data(self, idx, names="cam2"):
        seq_id, frame_idx = idx
        folder, zname, gray = {
            "cam0": ("image_0", "data_odometry_gray.zip", True),
            "cam1": ("image_1", "data_odometry_gray.zip", True),
            "cam2": ("image_2", "data_odometry_color.zip", False),
            "cam3": ("image_3", "data_odometry_color.zip", False),
        }[names]
        fname = Path("dataset", "sequences", "%02d" % seq_id, folder,
                     "%06d.png" % frame_idx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / zname,
                                to_extract=fname) as src:
                image = utils.load_image(src, fname, gray=gray)
        else:
            image = utils.load_image(self.base_path, fname, gray=gray)
        self._image_size_cache.setdefault(seq_id, image.size)
        return image

    @expand_idx_name(VALID_LIDAR_NAMES)
    def lidar_data(self, idx, names="velo", formatted=False):
        seq_id, frame_idx = idx
        fname = Path("dataset", "sequences", "%02d" % seq_id, "velodyne",
                     "%06d.bin" % frame_idx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_odometry_velodyne.zip",
                                to_extract=fname) as src:
                return utils.load_velo_scan(src, fname, formatted=formatted)
        return utils.load_velo_scan(self.base_path, fname, formatted=formatted)

    @expand_idx_name(VALID_LIDAR_NAMES)
    def annotation_3dpoints(self, idx, names="velo", convert_tag=True):
        """SemanticKITTI point labels: uint32 per point, semantics in the
        lower 16 bits and instance ids in the upper 16.

        :param convert_tag: True = static learning taxonomy; "dynamic" =
            learning taxonomy with moving classes; False = raw labels
        """
        seq_id, frame_idx = idx
        fname = Path("dataset", "sequences", "%02d" % seq_id, "labels",
                     "%06d.label" % frame_idx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_odometry_labels.zip",
                                to_extract=fname) as src:
                buffer = src.read(str(fname))
        else:
            buffer = (self.base_path / fname).read_bytes()
        label = np.frombuffer(buffer, dtype="u4")
        instance = label >> 16
        semantic = label & 0xFFFF

        if convert_tag is True or convert_tag == "dynamic":
            table = np.zeros(max(c.value for c in SemanticKittiClass) + 1,
                             dtype="u1")
            for ori, tgt in _learning_map(convert_tag is True).items():
                table[ori] = tgt
            return EDict(instance=instance, semantic=table[semantic],
                         moving=semantic > 100)
        return EDict(instance=instance, semantic=semantic)

    # -- pose / timestamps ----------------------------------------------------
    def _preload_poses(self, seq_id):
        if seq_id in self._pose_cache:
            return
        fname = Path("dataset", "poses", "%02d.txt" % seq_id)
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_odometry_poses.zip",
                                to_extract=fname) as src:
                text = src.read(str(fname)).decode().splitlines()
        else:
            text = (self.base_path / fname).read_text().splitlines()
        self._pose_cache[seq_id] = [
            np.array([float(v) for v in line.split()]).reshape(3, 4)
            for line in text if line.strip()]

    @expand_idx
    def pose(self, idx, raw=False):
        seq_id, frame_idx = idx
        self._preload_poses(seq_id)
        rt = self._pose_cache[seq_id][frame_idx]
        if raw:
            return rt
        return EgoPose(rt[:3, 3], rt[:3, :3])

    @property
    def pose_name(self):
        return "cam0"

    def _preload_timestamp(self, seq_id):
        if seq_id in self._timestamp_cache:
            return
        fname = Path("dataset", "sequences", "%02d" % seq_id, "times.txt")
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_odometry_calib.zip",
                                to_extract=fname) as src:
                text = src.read(str(fname)).decode().splitlines()
        else:
            text = (self.base_path / fname).read_text().splitlines()
        # odometry times.txt stores elapsed seconds
        self._timestamp_cache[seq_id] = np.array(
            [int(float(line) * 1e6) for line in text if line.strip()],
            dtype=np.int64)

    @expand_idx
    def timestamp(self, idx, names="velo"):
        seq_id, frame_idx = idx
        self._preload_timestamp(seq_id)
        return int(self._timestamp_cache[seq_id][frame_idx]) + 1

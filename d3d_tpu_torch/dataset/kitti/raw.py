"""KITTI raw (drive) dataset loader — synced drives with oxts poses and
tracklet annotations (port of ``d3d_tpu.dataset.kitti.raw``; reference
d3d/dataset/kitti/raw.py). Host Python and numpy.

Layout (zipped: ``<date>_calib.zip`` + ``<date>_drive_XXXX_sync.zip`` +
``<date>_drive_XXXX_tracklets.zip``; unzipped: ``<base>/<date>/{calib_*.txt,
<date>_drive_XXXX_sync/{image_0X, oxts, velodyne_points,
tracklet_labels.xml}}``)."""

from collections import defaultdict
from itertools import chain
from pathlib import Path
from zipfile import ZipFile

import numpy as np
from scipy.spatial.transform import Rotation

from ...abstraction import ObjectTag, ObjectTarget3D, Target3DArray, TransformSet
from ..base import TrackingDatasetBase, expand_idx, expand_idx_name, split_trainval_seq
from ..zip import PatchedZipFile
from . import utils
from .utils import KittiObjectClass

__all__ = ["KittiRawLoader"]

_DATES = ["2011_09_26", "2011_09_28", "2011_09_29", "2011_09_30",
          "2011_10_03"]


class KittiRawLoader(TrackingDatasetBase):
    """Loader for KITTI raw drives; see the module docstring for the layout.

    :param datatype: 'sync' (only synced drives are supported)
    """

    VALID_CAM_NAMES = ["cam0", "cam1", "cam2", "cam3"]
    VALID_LIDAR_NAMES = ["velo"]
    VALID_OBJ_CLASSES = KittiObjectClass
    _frame2folder = {
        "cam0": "image_00", "cam1": "image_01", "cam2": "image_02",
        "cam3": "image_03", "velo": "velodyne_points", "imu": "oxts",
    }

    def __init__(self, base_path, datatype="sync", inzip=True,
                 phase="training", trainval_split=1, trainval_random=False,
                 trainval_byseq=False, nframes=0):
        super().__init__(base_path, inzip=inzip, phase=phase, nframes=nframes,
                         trainval_split=trainval_split,
                         trainval_random=trainval_random,
                         trainval_byseq=trainval_byseq)
        if phase == "testing":
            raise ValueError("There's no testing split for raw data!")
        if datatype != "sync":
            raise NotImplementedError(
                "Currently only synced raw data are supported!")
        self.datatype = datatype

        frame_count = {}
        if self.inzip:
            globs = [self.base_path.glob(f"{date}_drive_*_{datatype}.zip")
                     for date in _DATES]
            for archive in chain(*globs):
                with ZipFile(archive) as data:
                    frame_count[archive.stem] = sum(
                        1 for n in data.namelist() if n.endswith(".bin"))
        else:
            for date in _DATES:
                if not (self.base_path / date).exists():
                    continue
                for drive in (self.base_path / date).iterdir():
                    if not drive.is_dir():
                        continue
                    frame_count[drive.name] = sum(
                        1 for _ in (drive / "velodyne_points" / "data").iterdir())

        if not frame_count:
            raise ValueError("Cannot parse dataset or empty dataset, please "
                             "check path, inzip option and file structure")
        # imported here: importing the KITTI package does not need it
        from sortedcontainers import SortedDict

        self.frame_dict = SortedDict(frame_count)
        # split over window-reduced counts so len() matches the index domain
        # of _locate_frame (the reference leaves this as a TODO, base.py:71)
        reduced = SortedDict({k: max(v - self.nframes, 0)
                              for k, v in self.frame_dict.items()})
        self.frames = split_trainval_seq(phase, reduced, trainval_split,
                                         trainval_random, trainval_byseq)
        self._calib_cache = {}
        self._timestamp_cache = {}
        self._tracklet_cache = {}

    def __len__(self):
        return len(self.frames)

    @property
    def sequence_ids(self):
        return list(self.frame_dict.keys())

    @property
    def sequence_sizes(self):
        return dict(self.frame_dict)

    @staticmethod
    def _get_date(seq_id):
        return seq_id[:10]

    def _locate_frame(self, idx):
        from ..base import locate_windowed_frame
        return locate_windowed_frame(self.frames[idx], self.frame_dict,
                                     self.nframes)

    @expand_idx
    def identity(self, idx):
        return idx

    # -- calibration ----------------------------------------------------------
    def _preload_calib(self, seq_id):
        date = self._get_date(seq_id)
        if date in self._calib_cache:
            return
        if self.inzip:
            with ZipFile(self.base_path / f"{date}_calib.zip") as src:
                self._calib_cache[date] = {
                    "cam_to_cam": utils.load_calib_file(
                        src, f"{date}/calib_cam_to_cam.txt"),
                    "imu_to_velo": utils.load_calib_file(
                        src, f"{date}/calib_imu_to_velo.txt"),
                    "velo_to_cam": utils.load_calib_file(
                        src, f"{date}/calib_velo_to_cam.txt"),
                }
        else:
            src = self.base_path / date
            self._calib_cache[date] = {
                "cam_to_cam": utils.load_calib_file(src, "calib_cam_to_cam.txt"),
                "imu_to_velo": utils.load_calib_file(src, "calib_imu_to_velo.txt"),
                "velo_to_cam": utils.load_calib_file(src, "calib_velo_to_cam.txt"),
            }

    def calibration_data(self, idx, raw=False):
        assert not self._return_file_path, \
            "The calibration is not stored in single file!"
        seq_id, _ = (self._locate_frame(idx)
                     if isinstance(idx, (int, np.integer)) else idx)
        self._preload_calib(seq_id)
        filedata = self._calib_cache[self._get_date(seq_id)]
        if raw:
            return filedata

        data = TransformSet("velo")
        velo_to_cam = np.empty((3, 4))
        velo_to_cam[:3, :3] = filedata["velo_to_cam"]["R"].reshape(3, 3)
        velo_to_cam[:3, 3] = filedata["velo_to_cam"]["T"]
        for i in range(4):
            size = filedata["cam_to_cam"]["S_rect_%02d" % i].tolist()
            rect = filedata["cam_to_cam"]["R_rect_%02d" % i].reshape(3, 3)
            p = filedata["cam_to_cam"]["P_rect_%02d" % i].reshape(3, 4)
            projection = p[:, :3].dot(rect)
            offset = np.linalg.inv(projection).dot(p[:, 3])
            extri = np.vstack([velo_to_cam, [0, 0, 0, 1]])
            extri[:3, 3] += offset
            frame = "cam%d" % i
            data.set_intrinsic_camera(frame, projection, size, rotate=False)
            data.set_extrinsic(extri, frame_to=frame)

        imu_to_velo = np.empty((3, 4))
        imu_to_velo[:3, :3] = filedata["imu_to_velo"]["R"].reshape(3, 3)
        imu_to_velo[:3, 3] = filedata["imu_to_velo"]["T"]
        data.set_intrinsic_general("imu")
        data.set_extrinsic(imu_to_velo, frame_from="imu")

        # vehicle bottom center and rear axle center anchors (devkit values)
        data.set_intrinsic_general("bottom_center")
        data.set_extrinsic(np.array([[1, 0, 0, -0.27], [0, 1, 0, 0],
                                     [0, 0, 1, 1.73], [0, 0, 0, 1.0]]),
                           frame_to="bottom_center")
        data.set_intrinsic_general("rear_center")
        data.set_extrinsic(np.array([[1, 0, 0, -0.805], [0, 1, 0, 0],
                                     [0, 0, 1, 0.30], [0, 0, 0, 1.0]]),
                           frame_from="bottom_center", frame_to="rear_center")
        return data

    # -- timestamps / poses ----------------------------------------------------
    def _preload_timestamp(self, seq_id):
        if seq_id in self._timestamp_cache:
            return
        date = self._get_date(seq_id)
        tsdict = {}
        for frame, folder in self._frame2folder.items():
            fname = Path(date, seq_id, folder, "timestamps.txt")
            if self.inzip:
                with PatchedZipFile(self.base_path / f"{seq_id}.zip",
                                    to_extract=fname) as src:
                    tsdict[frame] = utils.load_timestamps(src, fname)
            else:
                tsdict[frame] = utils.load_timestamps(self.base_path, fname)
        self._timestamp_cache[seq_id] = tsdict

    @expand_idx_name(VALID_CAM_NAMES + VALID_LIDAR_NAMES)
    def timestamp(self, idx, names="velo"):
        assert not self._return_file_path, \
            "The timestamp is not stored in single file!"
        seq_id, frame_idx = idx
        self._preload_timestamp(seq_id)
        return int(self._timestamp_cache[seq_id][names][frame_idx])

    @expand_idx
    def pose(self, idx, raw=False):
        seq_id, frame_idx = idx
        date = self._get_date(seq_id)
        fname = Path(date, seq_id, "oxts", "data", "%010d.txt" % frame_idx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / f"{seq_id}.zip",
                                to_extract=fname) as src:
                oxt = utils.load_oxt_file(src, fname)[0]
        else:
            oxt = utils.load_oxt_file(self.base_path, fname)[0]
        if raw:
            return oxt
        return utils.parse_pose_from_oxt(oxt)

    @property
    def pose_name(self):
        return "imu"

    # -- annotations -------------------------------------------------------------
    def _preload_tracklets(self, seq_id):
        if seq_id in self._tracklet_cache:
            return
        date = self._get_date(seq_id)
        fname = Path(date, seq_id, "tracklet_labels.xml")
        if self.inzip:
            zname = seq_id[:-len(self.datatype)] + "tracklets"
            with ZipFile(self.base_path / f"{zname}.zip") as src:
                tracklets = utils.load_tracklets(src, fname)
        else:
            tracklets = utils.load_tracklets(self.base_path, fname)

        objs = defaultdict(list)
        for tid, tr in enumerate(tracklets):
            dim = [tr.l, tr.w, tr.h]
            tag = ObjectTag(tr.objectType, KittiObjectClass)
            for pose_idx, pose in enumerate(tr.poses):
                pos = [pose.tx, pose.ty, pose.tz + dim[2] / 2]
                ori = Rotation.from_euler("ZYX", (pose.rz, pose.ry, pose.rx))
                objs[pose_idx + int(tr.first_frame)].append(
                    ObjectTarget3D(pos, ori, dim, tag, tid=tid))
        self._tracklet_cache[seq_id] = {
            k: Target3DArray(v, frame="velo") for k, v in objs.items()}

    @expand_idx
    def annotation_3dobject(self, idx):
        assert not self._return_file_path, \
            "The annotation is not stored in single file!"
        seq_id, frame_idx = idx
        self._preload_tracklets(seq_id)
        return self._tracklet_cache[seq_id].get(
            frame_idx, Target3DArray(frame="velo"))

    # -- sensor data -----------------------------------------------------------
    @expand_idx_name(VALID_CAM_NAMES)
    def camera_data(self, idx, names="cam2"):
        seq_id, frame_idx = idx
        date = self._get_date(seq_id)
        fname = Path(date, seq_id, self._frame2folder[names], "data",
                     "%010d.png" % frame_idx)
        if self._return_file_path:
            return self.base_path / fname
        gray = names in ("cam0", "cam1")
        if self.inzip:
            with PatchedZipFile(self.base_path / f"{seq_id}.zip",
                                to_extract=fname) as src:
                return utils.load_image(src, fname, gray=gray)
        return utils.load_image(self.base_path, fname, gray=gray)

    @expand_idx_name(VALID_LIDAR_NAMES)
    def lidar_data(self, idx, names="velo", formatted=False):
        seq_id, frame_idx = idx
        date = self._get_date(seq_id)
        fname = Path(date, seq_id, "velodyne_points", "data",
                     "%010d.bin" % frame_idx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / f"{seq_id}.zip",
                                to_extract=fname) as src:
                return utils.load_velo_scan(src, fname, formatted=formatted)
        return utils.load_velo_scan(self.base_path, fname, formatted=formatted)

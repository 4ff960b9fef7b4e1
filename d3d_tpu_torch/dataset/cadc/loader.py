"""CADC (Canadian Adverse Driving Conditions) dataset loader (port of
``d3d_tpu.dataset.cadc.loader``; reference d3d/dataset/cadc/loader.py).

Layout: ``<base>/<date>/{calib(.zip), <drive>/{labeled(.zip), raw(.zip),
3d_ann.json}}`` with KITTI-raw-style folders inside each drive."""

import json
from itertools import chain
from pathlib import Path
from zipfile import ZipFile

import numpy as np
import yaml
from sortedcontainers import SortedDict

from ...abstraction import TransformSet
from ..base import TrackingDatasetBase, expand_idx, expand_idx_name, split_trainval_seq
from ..zip import PatchedZipFile
from . import utils
from .utils import CADCObjectClass

__all__ = ["CADCDLoader"]

_DATES = ["2018_03_06", "2018_03_07", "2019_02_27"]


class CADCDLoader(TrackingDatasetBase):
    """Loader for the CADC dataset; see the module docstring for the layout.

    :param datatype: 'labeled' (only labeled drives are supported)
    """

    VALID_CAM_NAMES = ["camera_F", "camera_FR", "camera_RF", "camera_RB",
                       "camera_B", "camera_LB", "camera_LF", "camera_FL"]
    VALID_LIDAR_NAMES = ["lidar"]
    VALID_OBJ_CLASSES = CADCObjectClass
    _frame2folder = {
        "camera_F": "image_00", "camera_FR": "image_01",
        "camera_RF": "image_02", "camera_RB": "image_03",
        "camera_B": "image_04", "camera_LB": "image_05",
        "camera_LF": "image_06", "camera_FL": "image_07",
        "lidar": "lidar_points", "novatel": "novatel",
    }

    def __init__(self, base_path, datatype="labeled", inzip=True,
                 phase="training", trainval_split=1, trainval_random=False,
                 trainval_byseq=False, nframes=0):
        super().__init__(base_path, inzip=inzip, phase=phase, nframes=nframes,
                         trainval_split=trainval_split,
                         trainval_random=trainval_random,
                         trainval_byseq=trainval_byseq)
        if phase == "testing":
            raise ValueError("There's no testing split for CADC dataset!")
        if datatype != "labeled":
            raise NotImplementedError(
                "Currently only labeled data are supported!")
        self.datatype = datatype

        frame_count = {}
        if self.inzip:
            globs = [self.base_path.glob(f"{date}/00*/{datatype}.zip")
                     for date in _DATES]
            for archive in chain(*globs):
                with ZipFile(archive) as data:
                    seq = "-".join(archive.parent.parts[-2:])
                    frame_count[seq] = sum(
                        1 for n in data.namelist() if n.endswith(".bin"))
        else:
            for date in _DATES:
                if not (self.base_path / date).exists():
                    continue
                for drive in (self.base_path / date).iterdir():
                    if not drive.is_dir() or not drive.name.isdigit():
                        continue
                    seq = f"{date}-{drive.name}"
                    frame_count[seq] = sum(
                        1 for _ in (drive / datatype / "lidar_points"
                                    / "data").iterdir())

        if not frame_count:
            raise ValueError("Cannot parse dataset or empty dataset, please "
                             "check path, inzip option and file structure")
        self.frame_dict = SortedDict(frame_count)
        reduced = SortedDict({k: max(v - self.nframes, 0)
                              for k, v in self.frame_dict.items()})
        self.frames = split_trainval_seq(phase, reduced, trainval_split,
                                         trainval_random, trainval_byseq)
        self._calib_cache = {}
        self._timestamp_cache = {}
        self._3dann_cache = {}

    def __len__(self):
        return len(self.frames)

    @property
    def sequence_ids(self):
        return list(self.frame_dict.keys())

    @property
    def sequence_sizes(self):
        return dict(self.frame_dict)

    @staticmethod
    def _split_seqid(seq_id):
        return seq_id[:10], seq_id[11:]

    def _locate_frame(self, idx):
        from .. import base as _base
        return _base.locate_windowed_frame(self.frames[idx],
                                           self.frame_dict, self.nframes)

    @expand_idx
    def identity(self, idx):
        return idx

    # -- calibration -------------------------------------------------------------
    def _preload_calib(self, seq_id):
        date = self._split_seqid(seq_id)[0]
        if date in self._calib_cache:
            return

        calib = TransformSet("base_link")
        calib.set_intrinsic_lidar("lidar")
        calib.set_intrinsic_general("novatel")
        calib.set_intrinsic_general("xsens_30")
        calib.set_intrinsic_general("xsens_300")

        def add_cam(data, name):
            p = np.array(data["camera_matrix"]["data"]).reshape(3, 3)
            calib.set_intrinsic_camera(
                name, p,
                (data["image_width"], data["image_height"]),
                distort_coeffs=data["distortion_coefficients"]["data"],
                intri_matrix=p, rotate=False)

        def add_extrinsics(data):
            arr = {k: np.array(v) for k, v in data.items()}
            calib.set_extrinsic(arr["T_BASELINK_LIDAR"], "base_link", "lidar")
            for i in range(8):
                # stored matrices take camera coords to lidar coords
                calib.set_extrinsic(arr["T_LIDAR_CAM%02d" % i], "lidar",
                                    self.VALID_CAM_NAMES[i])
            calib.set_extrinsic(arr["T_00CAMERA_00IMU"], "camera_F",
                                "xsens_300")
            calib.set_extrinsic(arr["T_03CAMERA_03IMU"], "camera_RB",
                                "xsens_30")
            calib.set_extrinsic(arr["T_LIDAR_GPSIMU"], "lidar", "novatel")

        if self.inzip:
            with ZipFile(self.base_path / date / "calib.zip") as src:
                for i in range(8):
                    add_cam(yaml.safe_load(src.read("calib/%02d.yaml" % i)),
                            self.VALID_CAM_NAMES[i])
                add_extrinsics(yaml.safe_load(src.read("calib/extrinsics.yaml")))
        else:
            src = self.base_path / date / "calib"
            for i in range(8):
                add_cam(yaml.safe_load((src / ("%02d.yaml" % i)).read_text()),
                        self.VALID_CAM_NAMES[i])
            add_extrinsics(yaml.safe_load((src / "extrinsics.yaml").read_text()))
        self._calib_cache[date] = calib

    def calibration_data(self, idx, raw=False):
        assert not self._return_file_path, \
            "The calibration is not stored in single file!"
        seq_id, _ = (self._locate_frame(idx)
                     if isinstance(idx, (int, np.integer)) else idx)
        self._preload_calib(seq_id)
        return self._calib_cache[self._split_seqid(seq_id)[0]]

    # -- timestamps / poses --------------------------------------------------------
    def _preload_timestamp(self, seq_id):
        if seq_id in self._timestamp_cache:
            return
        date, drive = self._split_seqid(seq_id)
        drive_path = self.base_path / date / drive
        tsdict = {}
        for frame, folder in self._frame2folder.items():
            fname = Path(self.datatype, folder, "timestamps.txt")
            if self.inzip:
                with PatchedZipFile(drive_path / f"{self.datatype}.zip",
                                    to_extract=fname) as src:
                    tsdict[frame] = utils.load_timestamps(src, fname)
            else:
                tsdict[frame] = utils.load_timestamps(drive_path, fname)
        self._timestamp_cache[seq_id] = tsdict

    # reference bug fixed: it also advertises xsens_30/xsens_300 here but
    # never loads their folders, so those names always KeyError
    @expand_idx_name(VALID_CAM_NAMES + VALID_LIDAR_NAMES + ["novatel"])
    def timestamp(self, idx, names="lidar"):
        assert not self._return_file_path, \
            "The timestamp is not stored in single file!"
        seq_id, frame_idx = idx
        self._preload_timestamp(seq_id)
        return int(self._timestamp_cache[seq_id][names][frame_idx])

    @expand_idx
    def pose(self, idx, raw=False):
        seq_id, frame_idx = idx
        date, drive = self._split_seqid(seq_id)
        drive_path = self.base_path / date / drive
        fname = Path(self.datatype, "novatel", "data", "%010d.txt" % frame_idx)
        if self._return_file_path:
            return drive_path / fname
        if self.inzip:
            with PatchedZipFile(drive_path / f"{self.datatype}.zip",
                                to_extract=fname) as src:
                data = utils.load_inspvax(src, fname)
        else:
            data = utils.load_inspvax(drive_path, fname)
        if raw:
            return data
        return utils.parse_pose_from_inspvax(data)

    @property
    def pose_name(self):
        return "novatel"

    # -- annotations / data ----------------------------------------------------------
    def _preload_ann_3d(self, seq_id):
        if seq_id in self._3dann_cache:
            return
        date, drive = self._split_seqid(seq_id)
        self._3dann_cache[seq_id] = json.loads(
            (self.base_path / date / drive / "3d_ann.json").read_text())

    @expand_idx
    def annotation_3dobject(self, idx):
        assert not self._return_file_path, \
            "The annotation is not stored in single file!"
        seq_id, frame_idx = idx
        self._preload_ann_3d(seq_id)
        return utils.load_3d_ann(self._3dann_cache[seq_id][frame_idx])

    @expand_idx_name(VALID_CAM_NAMES)
    def camera_data(self, idx, names="camera_F"):
        seq_id, frame_idx = idx
        date, drive = self._split_seqid(seq_id)
        drive_path = self.base_path / date / drive
        fname = Path(self.datatype, self._frame2folder[names], "data",
                     "%010d.png" % frame_idx)
        if self._return_file_path:
            return drive_path / fname
        if self.inzip:
            with PatchedZipFile(drive_path / f"{self.datatype}.zip",
                                to_extract=fname) as src:
                return utils.load_image(src, fname)
        return utils.load_image(drive_path, fname)

    @expand_idx_name(VALID_LIDAR_NAMES)
    def lidar_data(self, idx, names="lidar", formatted=False):
        seq_id, frame_idx = idx
        date, drive = self._split_seqid(seq_id)
        drive_path = self.base_path / date / drive
        fname = Path(self.datatype, "lidar_points", "data",
                     "%010d.bin" % frame_idx)
        if self._return_file_path:
            return drive_path / fname
        if self.inzip:
            with PatchedZipFile(drive_path / f"{self.datatype}.zip",
                                to_extract=fname) as src:
                return utils.load_velo_scan(src, fname, formatted=formatted)
        return utils.load_velo_scan(drive_path, fname, formatted=formatted)

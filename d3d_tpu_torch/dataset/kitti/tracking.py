"""KITTI multi-object tracking dataset loader (port of
``d3d_tpu.dataset.kitti.tracking``; reference d3d/dataset/kitti/tracking.py).
Host Python and numpy: the arrays it returns go to the card through the
models' entry points.

Layout (zipped: ``data_tracking_{calib,image_2,image_3,label_2,velodyne,
oxts}.zip``; unzipped: ``<base>/{training,testing}/{calib,image_02,label_02,
oxts,velodyne}/<seq>``). ``DontCare`` objects are dropped."""

from collections import defaultdict
from pathlib import Path
from zipfile import ZipFile

import numpy as np
from scipy.spatial.transform import Rotation

from ...abstraction import ObjectTag, ObjectTarget3D, Target3DArray, TransformSet
from ..base import TrackingDatasetBase, expand_idx, expand_idx_name, split_trainval_seq
from ..zip import PatchedZipFile
from . import utils
from .utils import KittiObjectClass

__all__ = ["KittiTrackingLoader", "parse_label"]


def parse_label(label, raw_calib):
    """Tracking label rows -> Target3DArray in the velo frame; row layout is
    [track_id, class, truncated, occluded, alpha, bbox(4), hwl(3), xyz(3),
    ry(, score)] (the object-benchmark layout prefixed by the track id)."""
    from .object import _cam_to_velo

    rrect, hr, ht = _cam_to_velo(raw_calib, "Tr_velo_cam", "R_rect")
    objects = Target3DArray(frame="velo")

    for item in label:
        track_id = int(item[0])
        if item[1] == KittiObjectClass.DontCare:
            continue
        h, w, l = item[9:12]
        position = np.asarray(item[12:15], dtype=float)
        ry = item[15]
        position[1] -= h / 2

        position = rrect.inv().as_matrix().dot(position)
        position = hr.inv().as_matrix().dot(position - ht)
        orientation = hr.inv() * rrect.inv() * Rotation.from_euler("y", ry)
        orientation = orientation * Rotation.from_euler("x", np.pi / 2)

        score = item[16] if len(item) == 17 else None
        tag = ObjectTag(item[1], KittiObjectClass, scores=score)
        objects.append(ObjectTarget3D(position, orientation, [l, w, h], tag,
                                      tid=track_id))
    return objects


class KittiTrackingLoader(TrackingDatasetBase):
    """Loader for the KITTI multi-object tracking benchmark; see module
    docstring for the layout and
    :class:`d3d_tpu_torch.dataset.base.TrackingDatasetBase` for parameters."""

    VALID_CAM_NAMES = ["cam2", "cam3"]
    VALID_LIDAR_NAMES = ["velo"]
    VALID_OBJ_CLASSES = KittiObjectClass

    def __init__(self, base_path, inzip=False, phase="training",
                 trainval_split=0.8, trainval_random=False,
                 trainval_byseq=False, nframes=0):
        super().__init__(base_path, inzip=inzip, phase=phase, nframes=nframes,
                         trainval_split=trainval_split,
                         trainval_random=trainval_random,
                         trainval_byseq=trainval_byseq)
        self.phase_path = "training" if phase == "validation" else phase

        frame_count = defaultdict(int)
        if self.inzip:
            for folder in ("image_2", "image_3", "velodyne"):
                data_zip = self.base_path / ("data_tracking_%s.zip" % folder)
                if not data_zip.exists():
                    continue
                with ZipFile(data_zip) as data:
                    for name in data.namelist():
                        parts = Path(name).parts
                        if len(parts) != 4:
                            continue
                        ph, _, seq, frame = parts
                        if ph != self.phase_path:
                            continue
                        seq = int(seq)
                        frame_count[seq] = max(frame_count[seq],
                                               int(Path(frame).stem) + 1)
                break
        else:
            for folder in ("image_02", "image_03", "velodyne"):
                fpath = self.base_path / self.phase_path / folder
                if not fpath.exists():
                    continue
                for seq_path in fpath.iterdir():
                    frame_count[int(seq_path.name)] = sum(
                        1 for _ in seq_path.iterdir())
                break

        if not frame_count:
            raise ValueError("Cannot parse dataset, please check path, "
                             "inzip option and file structure")
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
        self._label_cache = {}
        self._calib_cache = {}
        self._pose_cache = {}

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

    # -- cached sequence-level parses ---------------------------------------
    def _preload_label(self, seq_id):
        if seq_id in self._label_cache:
            return
        fname = Path(self.phase_path, "label_02", "%04d.txt" % seq_id)
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_tracking_label_2.zip",
                                to_extract=fname) as src:
                text = src.read(str(fname)).decode().splitlines()
        else:
            text = (self.base_path / fname).read_text().splitlines()

        cache = defaultdict(list)
        for line in text:
            if not line.strip():
                continue
            frame_id, track_id, remain = line.split(" ", 2)
            fields = remain.split(" ")
            values = [KittiObjectClass[fields[0]]] + [float(v)
                                                      for v in fields[1:]]
            cache[int(frame_id)].append([int(track_id)] + values)
        self._label_cache[seq_id] = cache

    def _preload_calib(self, seq_id):
        if seq_id in self._calib_cache:
            return
        fname = Path(self.phase_path, "calib", "%04d.txt" % seq_id)
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_tracking_calib.zip",
                                to_extract=fname) as src:
                self._calib_cache[seq_id] = utils.load_calib_file(src, fname)
        else:
            self._calib_cache[seq_id] = utils.load_calib_file(self.base_path,
                                                              fname)

    def _preload_oxts(self, seq_id):
        if seq_id in self._pose_cache:
            return
        fname = Path(self.phase_path, "oxts", "%04d.txt" % seq_id)
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_tracking_oxts.zip",
                                to_extract=fname) as src:
                self._pose_cache[seq_id] = utils.load_oxt_file(src, fname)
        else:
            self._pose_cache[seq_id] = utils.load_oxt_file(self.base_path,
                                                           fname)

    # -- accessors -----------------------------------------------------------
    @expand_idx_name(VALID_CAM_NAMES)
    def camera_data(self, idx, names="cam2"):
        seq_id, frame_idx = idx
        folder, zname = {
            "cam2": ("image_02", "data_tracking_image_2.zip"),
            "cam3": ("image_03", "data_tracking_image_3.zip"),
        }[names]
        fname = Path(self.phase_path, folder, "%04d" % seq_id,
                     "%06d.png" % frame_idx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / zname,
                                to_extract=fname) as src:
                image = utils.load_image(src, fname)
        else:
            image = utils.load_image(self.base_path, fname)
        self._image_size_cache.setdefault(seq_id, image.size)
        return image

    @expand_idx_name(VALID_LIDAR_NAMES)
    def lidar_data(self, idx, names="velo", formatted=False):
        seq_id, frame_idx = idx
        if seq_id == 1 and frame_idx in range(177, 181):
            raise ValueError("There is missing data in KITTI tracking "
                             "dataset at seq 1, frame 177-180!")
        fname = Path(self.phase_path, "velodyne", "%04d" % seq_id,
                     "%06d.bin" % frame_idx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_tracking_velodyne.zip",
                                to_extract=fname) as src:
                return utils.load_velo_scan(src, fname, formatted=formatted)
        return utils.load_velo_scan(self.base_path, fname, formatted=formatted)

    def _load_calib(self, seq, raw=False):
        self._preload_calib(seq)
        filedata = self._calib_cache[seq]
        if raw:
            return filedata

        if seq not in self._image_size_cache:
            self.camera_data((seq, 0), bypass=True)
        image_size = self._image_size_cache[seq]

        data = TransformSet("velo")
        rect = filedata["R_rect"].reshape(3, 3)
        velo_to_cam = filedata["Tr_velo_cam"].reshape(3, 4)
        for i in range(4):
            p = filedata["P%d" % i].reshape(3, 4)
            projection = p[:, :3].dot(rect)
            offset = np.linalg.inv(projection).dot(p[:, 3])
            extri = np.vstack([velo_to_cam, [0, 0, 0, 1]])
            extri[:3, 3] += offset
            frame = "cam%d" % i
            data.set_intrinsic_camera(frame, projection, image_size,
                                      rotate=False)
            data.set_extrinsic(extri, frame_to=frame)
        data.set_intrinsic_general("imu")
        data.set_extrinsic(filedata["Tr_imu_velo"].reshape(3, 4),
                           frame_from="imu")
        return data

    def calibration_data(self, idx, raw=False):
        assert not self._return_file_path, \
            "The calibration is not stored in single file!"
        seq_id, _ = (self._locate_frame(idx)
                     if isinstance(idx, (int, np.integer)) else idx)
        return self._load_calib(seq_id, raw)

    @expand_idx
    def annotation_3dobject(self, idx, raw=False):
        assert self.phase_path != "testing", \
            "Testing dataset doesn't contain label data"
        seq_id, frame_idx = idx
        self._preload_label(seq_id)
        label = self._label_cache[seq_id][frame_idx]
        if raw:
            return label
        self._preload_calib(seq_id)
        return parse_label(label, self._calib_cache[seq_id])

    @expand_idx
    def identity(self, idx):
        return idx

    def dump_tracking_output(self, seq_id, tracks_by_frame, fout):
        """Write one sequence's tracks in the KITTI tracking submission
        text format (``frame tid type trunc occ alpha bbox x4 hwl
        location x3 rotation_y score`` per line, one file per sequence —
        the devkit's evaluate_tracking input). Boxes reproject through
        the same path as the object writer (:func:`format_kitti_box`).
        The reference has no tracking submission surface.

        :param tracks_by_frame: ``{frame_idx: Target3DArray}`` in the
            velo frame with tids set (e.g. tracker ``report()`` outputs)
        """
        from .object import _cam_to_velo, format_kitti_box

        calib = self._load_calib(seq_id)
        raw_calib = self._load_calib(seq_id, raw=True)
        # tracking calib key names differ from the object benchmark's
        rrect, hr, ht = _cam_to_velo(raw_calib, "Tr_velo_cam", "R_rect")

        lines = []
        fmt = "%d %d %s 0 0 0" + " %.2f" * 12
        for fi in sorted(tracks_by_frame):
            arr = tracks_by_frame[fi]
            assert arr.frame == "velo"
            for box in arr:
                values = format_kitti_box(box, calib, rrect, hr, ht)
                if values is None:
                    continue
                lines.append(fmt % (fi, int(box.tid), *values,
                                    box.tag_top_score))
        content = "\n".join(lines)
        if isinstance(fout, (str, Path)):
            Path(fout).write_text(content)
        else:
            fout.write(content.encode())

    @expand_idx
    def pose(self, idx, raw=False):
        seq_id, frame_idx = idx
        self._preload_oxts(seq_id)
        raw_pose = self._pose_cache[seq_id][frame_idx]
        if raw:
            return raw_pose
        return utils.parse_pose_from_oxt(raw_pose)

    @property
    def pose_name(self):
        return "imu"

    @expand_idx
    def timestamp(self, idx, names="velo"):
        # no real timestamps shipped: assume 10 Hz with a small lead-in
        _, frame_idx = idx
        return int(frame_idx * 1e5 + 1)

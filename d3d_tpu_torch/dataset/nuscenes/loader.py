"""nuScenes dataset loader over the converted per-scene layout produced by
:mod:`d3d_tpu_torch.dataset.nuscenes.converter` (port of
``d3d_tpu.dataset.nuscenes.loader``; reference d3d/dataset/nuscenes/loader.py;
same converted-scene contract). Host Python and numpy: the arrays it
returns go to the card through the models' entry points.

Layout: ``<base>/{trainval,test}/scene-XXXX(.zip)/`` containing
``scene/{stats,calib,tokens}.json``, per-frame ``lidar_top/NNN.pcd``,
``<cam>/NNN.jpg``, ``annotation/NNN.json``, ``pose/NNN.json``,
``timestamp/NNN.json``, ``lidar_top_seg/NNN.bin`` and
``intermediate/NNN/...`` sweeps.

The scene index is cached in ``metadata.msg`` when ``msgpack`` is
installed (imported where it is used); without it every scene's
``scene/stats.json`` is read each time a loader is made, and nothing is
cached. Scenes are kept sorted by name in a plain dict."""

import json
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation

from ...abstraction import (EgoPose, ObjectTag, ObjectTarget3D, Target3DArray,
                            TrackingTarget3D, TransformSet)
from ...utils import EDict
from ..base import TrackingDatasetBase, expand_idx, expand_idx_name, split_trainval_seq
from ..zip import PatchedZipFile
from .constants import (NuscenesDetectionClass, NuscenesObjectClass,
                        NuscenesSegmentationClass, train_split, val_split)

__all__ = ["NuscenesLoader", "create_submission",
           "execute_official_evaluator"]


class NuscenesLoader(TrackingDatasetBase):
    """Loader for converted nuScenes scenes (run
    ``d3d_tpu_torch_nuscenes_convert`` first); see
    :class:`d3d_tpu_torch.dataset.base.TrackingDatasetBase` for the
    constructor parameters. ``trainval_split="official"`` selects the
    official train/val scene splits."""

    VALID_CAM_NAMES = ["cam_front", "cam_front_left", "cam_front_right",
                       "cam_back", "cam_back_left", "cam_back_right"]
    VALID_LIDAR_NAMES = ["lidar_top"]
    VALID_OBJ_CLASSES = NuscenesDetectionClass
    VALID_PTS_CLASSES = NuscenesSegmentationClass

    def __init__(self, base_path, inzip=False, phase="training",
                 trainval_split="official", trainval_random=False,
                 trainval_byseq=False, nframes=0):
        super().__init__(base_path, inzip=inzip, phase=phase, nframes=nframes,
                         trainval_split=1.0, trainval_random=trainval_random,
                         trainval_byseq=trainval_byseq)
        self.base_path = Path(base_path) / (
            "trainval" if phase in ("training", "validation") else "test")

        self._metadata = None
        self._segmapping = None
        self._rawmapping = None
        self._load_metadata()

        if trainval_split == "official":
            if phase == "training":
                trainval_split, trainval_byseq = train_split, True
            elif phase == "validation":
                trainval_split, trainval_byseq = val_split, True
            else:
                trainval_split = 1
        if isinstance(trainval_split, list):
            trainval_split = [s for s in trainval_split
                              if s in self._metadata]

        counts = {k: v["nbr_samples"] - self.nframes
                  for k, v in self._metadata.items()}
        self.frames = split_trainval_seq(phase, counts, trainval_split,
                                         trainval_random, trainval_byseq)

    # -- metadata -------------------------------------------------------------
    def _load_metadata(self):
        meta_path = self.base_path / "metadata.msg"
        try:
            import msgpack
        except ImportError:  # no cache: read the scenes' stats every time
            msgpack = None
        if msgpack is not None and meta_path.exists():
            metadata = msgpack.unpackb(meta_path.read_bytes())
        else:
            metadata = {}
            if self.inzip:
                for ar in self.base_path.iterdir():
                    if ar.suffix != ".zip":
                        continue
                    with PatchedZipFile(ar, to_extract="scene/stats.json") as z:
                        metadata[ar.stem] = json.loads(z.read("scene/stats.json"))
            else:
                for folder in self.base_path.iterdir():
                    if not folder.is_dir() or folder.name == "maps":
                        continue
                    metadata[folder.name] = json.loads(
                        (folder / "scene/stats.json").read_text())
            assert metadata, ("The dataset folder contains no valid scene, "
                              "please check path or parameters!")
            if msgpack is not None:
                meta_path.write_bytes(msgpack.packb(metadata))
                metadata = msgpack.unpackb(meta_path.read_bytes())

        self._metadata = {k: EDict(v) for k, v in sorted(metadata.items())}

        # category id -> class/segmentation lookup tables
        table = NuscenesObjectClass._id_table()
        self._rawmapping = np.array([c.value for c in table], dtype="u4")
        self._segmapping = np.array(
            [c.to_segmentation().value for c in table], dtype="u1")

    def __len__(self):
        return len(self.frames)

    @property
    def sequence_ids(self):
        return list(self._metadata.keys())

    @property
    def sequence_sizes(self):
        return {k: v["nbr_samples"] for k, v in self._metadata.items()}

    def _locate_frame(self, idx):
        from ..base import locate_windowed_frame
        counts = {k: v["nbr_samples"] for k, v in self._metadata.items()}
        return locate_windowed_frame(self.frames[idx], counts, self.nframes)

    # -- raw file access -------------------------------------------------------
    def _read(self, seq_id, fname):
        if self.inzip:
            with PatchedZipFile(self.base_path / f"{seq_id}.zip",
                                to_extract=fname) as ar:
                return ar.read(fname)
        return (self.base_path / seq_id / fname).read_bytes()

    def _read_json(self, seq_id, fname):
        return json.loads(self._read(seq_id, fname))

    @staticmethod
    def _wxyz(quat):
        """nuScenes stores quaternions as (w, x, y, z)."""
        return Rotation.from_quat(list(quat[1:]) + [quat[0]])

    # -- accessors --------------------------------------------------------------
    @expand_idx_name(VALID_LIDAR_NAMES)
    def lidar_data(self, idx, names="lidar_top", formatted=False):
        seq_id, frame_idx = idx
        fname = "lidar_top/%03d.pcd" % frame_idx
        if self._return_file_path:
            return self.base_path / seq_id / fname
        scan = np.frombuffer(self._read(seq_id, fname),
                             dtype=np.float32).reshape(-1, 5).copy()
        if not formatted:
            return scan
        return np.rec.fromarrays(
            scan.T, names=["x", "y", "z", "intensity", "ring_index"])

    @expand_idx_name(VALID_CAM_NAMES)
    def camera_data(self, idx, names="cam_front"):
        import io

        from PIL import Image

        seq_id, frame_idx = idx
        fname = "%s/%03d.jpg" % (names, frame_idx)
        if self._return_file_path:
            return self.base_path / seq_id / fname
        return Image.open(io.BytesIO(self._read(seq_id, fname))).convert("RGB")

    @expand_idx_name(VALID_CAM_NAMES + VALID_LIDAR_NAMES)
    def intermediate_data(self, idx, names="lidar_top", ninter_frames=None,
                          formatted=False):
        """Unannotated sweeps between keyframes with their poses."""
        seq_id, frame_idx = idx
        meta = self._read_json(seq_id,
                               "intermediate/%03d/meta.json" % frame_idx)
        if not meta:
            return []
        items = [EDict(m) for m in meta[names]]
        if ninter_frames is not None:
            items = items[:ninter_frames]
        for item in items:
            rotation = item.pop("rotation")
            item.pose = EgoPose(item.pop("translation"), self._wxyz(rotation))
        if self._return_file_path:
            for item in items:
                item.file = (self.base_path / seq_id / "intermediate"
                             / ("%03d" % frame_idx) / item.file)
            return items
        for item in items:
            fname = "intermediate/%03d/%s" % (frame_idx, item.pop("file"))
            if names in self.VALID_CAM_NAMES:
                import io

                from PIL import Image

                item.data = Image.open(
                    io.BytesIO(self._read(seq_id, fname))).convert("RGB")
            else:
                item.data = np.frombuffer(self._read(seq_id, fname),
                                          dtype=np.float32).reshape(-1, 5).copy()
                if formatted:
                    item.data = np.rec.fromarrays(
                        item.data.T,
                        names=["x", "y", "z", "intensity", "ring_index"])
        return items

    @expand_idx
    def annotation_3dobject(self, idx, raw=False, convert_tag=True,
                            with_velocity=True):
        """Annotations re-expressed in the ego frame; tids are the first 8
        hex digits of the nuScenes instance token."""
        seq_id, frame_idx = idx
        fname = "annotation/%03d.json" % frame_idx
        if self._return_file_path:
            return self.base_path / seq_id / fname
        labels = [EDict(l) for l in self._read_json(seq_id, fname)]
        if raw:
            return labels

        ego_pose = self.pose(idx, bypass=True)
        ego_ri = ego_pose.orientation.inv()
        ego_rim = ego_ri.as_matrix()
        ego_t = ego_pose.position

        outputs = Target3DArray(frame="ego")
        for label in labels:
            tag = NuscenesObjectClass.parse(label.category)
            for attr in label.attribute:
                tag = tag | NuscenesObjectClass.parse(attr)
            if convert_tag:
                tag = ObjectTag(tag.to_detection(), NuscenesDetectionClass)
            else:
                tag = ObjectTag(tag, NuscenesObjectClass)
            aux = dict(num_lidar_pts=label["num_lidar_pts"],
                       num_radar_pts=label["num_radar_pts"])

            rel_r = ego_ri * self._wxyz(label.rotation)
            rel_t = ego_rim.dot(np.asarray(label.translation) - ego_t)
            size = [label.size[1], label.size[0], label.size[2]]  # wlh->lwh
            tid = int(label.instance[:8], 16)

            if with_velocity:
                v = ego_rim.dot(label.velocity)
                outputs.append(TrackingTarget3D(
                    rel_t, rel_r, size, v, label.angular_velocity, tag,
                    tid=tid, aux=aux))
            else:
                outputs.append(ObjectTarget3D(rel_t, rel_r, size, tag,
                                              tid=tid, aux=aux))
        return outputs

    @expand_idx_name(VALID_LIDAR_NAMES)
    def annotation_3dpoints(self, idx, names="lidar_top", parse_tag=True,
                            convert_tag=True):
        seq_id, frame_idx = idx
        fname = "lidar_top_seg/%03d.bin" % frame_idx
        if self._return_file_path:
            return EDict(semantic=self.base_path / seq_id / fname)
        label = np.frombuffer(self._read(seq_id, fname), dtype="u1")
        if parse_tag:
            table = self._segmapping if convert_tag else self._rawmapping
            return EDict(semantic=table[label])
        return EDict(semantic=label)

    @expand_idx
    def metadata(self, idx):
        seq_id, frame_idx = idx
        meta = self._metadata[seq_id]
        return EDict(
            scene_description=meta["description"],
            scene_token=meta["token"],
            sample_token=meta["sample_tokens"][frame_idx],
            logfile=meta["logfile"],
            date_captured=meta["date_captured"],
            vehicle=meta["vehicle"],
            location=meta["location"],
        )

    @expand_idx_name(VALID_CAM_NAMES + VALID_LIDAR_NAMES)
    def token(self, idx, names="lidar_top"):
        """Original nuScenes sample-data token of the given sensor frame."""
        seq_id, frame_idx = idx
        return self._read_json(seq_id, "scene/tokens.json")[names][frame_idx]

    @expand_idx
    def calibration_data(self, idx):
        seq_id, _ = idx
        calib_data = self._read_json(seq_id, "scene/calib.json")
        calib = TransformSet("ego")
        for frame, entry in calib_data.items():
            if frame.startswith("cam"):
                calib.set_intrinsic_camera(
                    frame, np.array(entry["camera_intrinsic"]), (1600, 900),
                    rotate=False)
            elif frame.startswith("lidar"):
                calib.set_intrinsic_lidar(frame)
            elif frame.startswith("radar"):
                calib.set_intrinsic_radar(frame)
            else:
                raise ValueError("Unrecognized frame name.")
            extri = np.eye(4)
            extri[:3, :3] = self._wxyz(entry["rotation"]).as_matrix()
            extri[:3, 3] = entry["translation"]
            calib.set_extrinsic(extri, frame_from=frame)
        return calib

    @expand_idx
    def identity(self, idx):
        return idx

    @expand_idx
    def timestamp(self, idx, names="lidar_top"):
        seq_id, frame_idx = idx
        ts = self._read_json(seq_id, "timestamp/%03d.json" % frame_idx)
        return ts.get(names, ts["lidar_top"])

    @expand_idx_name(VALID_LIDAR_NAMES + VALID_CAM_NAMES)
    def pose(self, idx, names="lidar_top", raw=False):
        """Ego-vehicle pose (names select the sensor timestamp variant)."""
        seq_id, frame_idx = idx
        data = self._read_json(seq_id, "pose/%03d.json" % frame_idx)[names]
        if raw:
            return data
        return EgoPose(np.asarray(data["translation"]),
                       self._wxyz(data["rotation"]))

    @property
    def pose_name(self):
        return "ego"

    @expand_idx
    def dump_detection_output(self, idx, detections, fout=None):
        """Convert an ego-frame detection array into nuScenes submission
        entries (global frame, wlh sizes, wxyz quaternions); returns the list
        and optionally writes JSON to ``fout``.

        .. warning:: with ``nframes > 0`` the @expand_idx window calls this
           once per window frame (reference behavior) — each call rewrites
           ``fout``, keeping only the last frame. Pass distinct paths or use
           ``bypass=True`` when dumping under a windowed loader."""
        seq_id, frame_idx = idx
        sample_token = self.metadata((seq_id, frame_idx),
                                     bypass=True).sample_token
        pose = self.pose((seq_id, frame_idx), bypass=True)

        results = []
        for box in detections:
            entry, name = self._submission_entry(box, pose, sample_token)
            entry.update(detection_name=name,
                         detection_score=float(box.tag_top_score),
                         attribute_name="")
            results.append(entry)
        if fout is not None:
            Path(fout).write_text(json.dumps({sample_token: results}))
        return results

    @staticmethod
    def _submission_entry(box, pose, sample_token):
        """Shared global-frame submission fields (detection AND tracking
        writers): translation, wlh size, wxyz rotation, BEV velocity —
        all plain Python floats (JSON-safe)."""
        rm, t = pose.orientation.as_matrix(), pose.position
        gt = rm.dot(box.position) + t
        q = (pose.orientation * box.orientation).as_quat()
        vel = rm.dot(np.asarray(getattr(box, "velocity", np.zeros(3)),
                                np.float64))
        name = (box.tag_top.name if box.tag.mapping
                is NuscenesDetectionClass
                else NuscenesObjectClass(
                    box.tag.labels[0]).to_detection().name)
        entry = dict(
            sample_token=sample_token,
            translation=[float(v) for v in gt],
            size=[float(box.dimension[1]), float(box.dimension[0]),
                  float(box.dimension[2])],
            rotation=[float(q[3]), float(q[0]), float(q[1]), float(q[2])],
            velocity=[float(vel[0]), float(vel[1])],
        )
        return entry, name

    # the 7 nuScenes tracking-challenge classes (a subset of the 10
    # detection classes; barrier/cone/construction_vehicle are untracked)
    TRACKING_NAMES = frozenset((
        "bicycle", "bus", "car", "motorcycle", "pedestrian", "trailer",
        "truck"))

    @expand_idx
    def dump_tracking_output(self, idx, tracks, fout=None):
        """Convert an ego-frame tracked array (``TrackingTarget3D`` with
        tids, e.g. :class:`d3d_tpu_torch.tracking.CenterTracker` reports) into
        nuScenes TRACKING-challenge submission entries: the detection
        fields plus ``tracking_id``/``tracking_name``/``tracking_score``;
        objects outside the 7 tracked classes are dropped (official
        protocol). No reference counterpart (its submission surface is
        detection-only, nuscenes/loader.py:447-541)."""
        seq_id, frame_idx = idx
        sample_token = self.metadata((seq_id, frame_idx),
                                     bypass=True).sample_token
        pose = self.pose((seq_id, frame_idx), bypass=True)

        results = []
        for box in tracks:
            entry, name = self._submission_entry(box, pose, sample_token)
            if name not in self.TRACKING_NAMES:
                continue
            entry.update(tracking_id=str(box.tid), tracking_name=name,
                         tracking_score=float(box.tag_top_score))
            results.append(entry)
        if fout is not None:
            Path(fout).write_text(json.dumps({sample_token: results}))
        return results


def create_submission(result_files, output_file, meta=None):
    """Merge per-frame dump_detection_output JSON files into one nuScenes
    submission json (reference nuscenes/loader.py:563-612)."""
    results = {}
    for f in result_files:
        results.update(json.loads(Path(f).read_text()))
    submission = dict(
        meta=meta or dict(use_camera=False, use_lidar=True, use_radar=False,
                          use_map=False, use_external=False),
        results=results,
    )
    out = Path(output_file)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(submission))
    return out


def execute_official_evaluator(nusc_path, submission_file, output_dir,
                               version="v1.0-trainval", eval_set="val"):
    """Run the official nuScenes detection evaluator (requires the
    nuscenes-devkit package)."""
    try:
        from nuscenes import NuScenes
        from nuscenes.eval.detection.config import config_factory
        from nuscenes.eval.detection.evaluate import DetectionEval
    except ImportError as e:
        raise ImportError("nuscenes-devkit is required for the official "
                          "evaluator") from e

    nusc = NuScenes(version=version, dataroot=str(nusc_path))
    cfg = config_factory("detection_cvpr_2019")
    ev = DetectionEval(nusc, config=cfg, result_path=str(submission_file),
                       eval_set=eval_set, output_dir=str(output_dir))
    return ev.main()

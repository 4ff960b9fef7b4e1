"""Convert a raw (extracted) nuScenes distribution into the per-scene layout
consumed by :class:`d3d_tpu_torch.dataset.nuscenes.NuscenesLoader` (port of
``d3d_tpu.dataset.nuscenes.converter``: host Python, the same output tree;
console script ``d3d_tpu_torch_nuscenes_convert``).

Input: the standard devkit layout — ``<input>/v1.0-{trainval,test,mini}/
*.json`` tables plus ``samples/`` and ``sweeps/`` blob folders (extract the
tarballs first; the reference converter streams the tarballs directly,
d3d/dataset/nuscenes/converter.py — the output contract is identical).

Output per scene (optionally zipped)::

    scene-XXXX/
        scene/{stats,calib,tokens}.json
        lidar_top/NNN.pcd            (x, y, z, intensity, ring float32)
        cam_*/NNN.jpg
        annotation/NNN.json
        pose/NNN.json                (per-sensor ego pose at sensor stamp)
        timestamp/NNN.json
        lidar_top_seg/NNN.bin        (when lidarseg is present)
        intermediate/NNN/meta.json (+ sweep files)
"""

import json
import shutil
import zipfile
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..base import NumberPool

__all__ = ["KeyFrameConverter", "convert_dataset_inpath", "main"]

_CHANNEL_MAP = {
    "LIDAR_TOP": "lidar_top",
    "CAM_FRONT": "cam_front",
    "CAM_FRONT_LEFT": "cam_front_left",
    "CAM_FRONT_RIGHT": "cam_front_right",
    "CAM_BACK": "cam_back",
    "CAM_BACK_LEFT": "cam_back_left",
    "CAM_BACK_RIGHT": "cam_back_right",
}


def _load_table(path, key="token"):
    data = json.loads(Path(path).read_text())
    return {item[key]: item for item in data}


class KeyFrameConverter:
    """Convert one nuScenes version split.

    :param input_path: extracted nuScenes root
    :param version: v1.0-trainval / v1.0-test / v1.0-mini
    :param zip_output: write per-scene zips instead of directories
    :param store_inter: number of intermediate sweeps to keep per keyframe
    """

    def __init__(self, input_path, output_path, version="v1.0-trainval",
                 zip_output=False, store_inter=0):
        self.input_path = Path(input_path)
        self.output_path = Path(output_path)
        self.version = version
        self.zip_output = zip_output
        self.store_inter = store_inter
        self._tables = {}

    def _table(self, name):
        if name not in self._tables:
            self._tables[name] = _load_table(
                self.input_path / self.version / f"{name}.json")
        return self._tables[name]

    # -- per-scene conversion ---------------------------------------------------
    def convert_scene(self, scene):
        sample_t = self._table("sample")
        sdata_t = self._table("sample_data")
        pose_t = self._table("ego_pose")
        calib_t = self._table("calibrated_sensor")
        sensor_t = self._table("sensor")
        ann_t = self._table("sample_annotation")
        inst_t = self._table("instance")
        cat_t = self._table("category")
        attr_t = self._table("attribute")
        log = self._table("log")[scene["log_token"]]

        out = self.output_path / scene["name"]
        for sub in ("scene", "annotation", "pose", "timestamp"):
            (out / sub).mkdir(parents=True, exist_ok=True)

        # order keyframe samples
        samples = []
        tok = scene["first_sample_token"]
        while tok:
            samples.append(sample_t[tok])
            tok = samples[-1]["next"]

        # group sample_data by sample and channel. The rows are pre-indexed
        # by sample token ONCE per converter (the old per-scene full-table
        # scan made conversion O(scenes x 2.4M rows) on trainval).
        if not hasattr(self, "_sdata_by_sample"):
            self._sdata_by_sample = defaultdict(list)
            for sd in sdata_t.values():
                self._sdata_by_sample[sd["sample_token"]].append(sd)
        by_sample = defaultdict(dict)
        sweeps = defaultdict(list)
        calib_per_channel = {}
        for sample in samples:
            for sd in self._sdata_by_sample.get(sample["token"], ()):
                channel = sensor_t[calib_t[sd["calibrated_sensor_token"]]
                                   ["sensor_token"]]["channel"]
                if channel not in _CHANNEL_MAP:
                    continue
                name = _CHANNEL_MAP[channel]
                calib_per_channel[name] = \
                    calib_t[sd["calibrated_sensor_token"]]
                if sd["is_key_frame"]:
                    by_sample[sd["sample_token"]][name] = sd
                else:
                    sweeps[(sd["sample_token"], name)].append(sd)

        # scene-level json
        tokens = {name: [] for name in _CHANNEL_MAP.values()}
        for fi, sample in enumerate(samples):
            frames = by_sample[sample["token"]]
            ts, poses = {}, {}
            for name, sd in frames.items():
                tokens[name].append(sd["token"])
                ts[name] = sd["timestamp"]
                pose = pose_t[sd["ego_pose_token"]]
                poses[name] = dict(rotation=pose["rotation"],
                                   translation=pose["translation"])
                self._dump_blob(sd, out, name, fi)
            (out / "timestamp" / ("%03d.json" % fi)).write_text(json.dumps(ts))
            (out / "pose" / ("%03d.json" % fi)).write_text(json.dumps(poses))

            # annotations with velocities estimated by finite differences
            anns = []
            for atok in sample["anns"]:
                ann = ann_t[atok]
                inst = inst_t[ann["instance_token"]]
                category = cat_t[inst["category_token"]]["name"]
                attributes = [attr_t[t]["name"]
                              for t in ann["attribute_tokens"]]
                anns.append(dict(
                    category=category, attribute=attributes,
                    translation=ann["translation"], size=ann["size"],
                    rotation=ann["rotation"],
                    velocity=self._velocity(ann, ann_t, sample_t),
                    angular_velocity=[0.0, 0.0, 0.0],
                    instance=ann["instance_token"],
                    num_lidar_pts=ann["num_lidar_pts"],
                    num_radar_pts=ann["num_radar_pts"]))
            (out / "annotation" / ("%03d.json" % fi)).write_text(
                json.dumps(anns))

            # intermediate sweeps
            inter_dir = out / "intermediate" / ("%03d" % fi)
            inter_dir.mkdir(parents=True, exist_ok=True)
            meta = {}
            for name in frames:
                items = []
                cands = sorted(sweeps.get((sample["token"], name), []),
                               key=lambda sd: sd["timestamp"])
                for sd in cands[:self.store_inter]:
                    pose = pose_t[sd["ego_pose_token"]]
                    fname = Path(sd["filename"]).name
                    src = self.input_path / sd["filename"]
                    if src.exists():
                        shutil.copy(src, inter_dir / fname)
                    items.append(dict(file=fname,
                                      timestamp=sd["timestamp"],
                                      rotation=pose["rotation"],
                                      translation=pose["translation"]))
                meta[name] = items
            (inter_dir / "meta.json").write_text(json.dumps(meta))

        # calibrations
        calib = {}
        for name, entry in calib_per_channel.items():
            item = dict(rotation=entry["rotation"],
                        translation=entry["translation"])
            if entry.get("camera_intrinsic"):
                item["camera_intrinsic"] = entry["camera_intrinsic"]
            calib[name] = item
        (out / "scene" / "calib.json").write_text(json.dumps(calib))
        (out / "scene" / "tokens.json").write_text(json.dumps(tokens))
        (out / "scene" / "stats.json").write_text(json.dumps(dict(
            nbr_samples=len(samples), token=scene["token"],
            description=scene["description"],
            sample_tokens=[s["token"] for s in samples],
            logfile=log["logfile"], date_captured=log["date_captured"],
            vehicle=log["vehicle"], location=log["location"])))

        if self.zip_output:
            zpath = self.output_path / (scene["name"] + ".zip")
            with zipfile.ZipFile(zpath, "w") as zf:
                for f in sorted(out.rglob("*")):
                    if f.is_file():
                        zf.write(f, f.relative_to(out))
            shutil.rmtree(out)

    def _velocity(self, ann, ann_t, sample_t):
        """Central/one-sided difference of the annotation translations."""
        prev_a = ann_t.get(ann["prev"]) if ann["prev"] else None
        next_a = ann_t.get(ann["next"]) if ann["next"] else None
        if prev_a is None and next_a is None:
            return [0.0, 0.0, 0.0]
        a0 = prev_a or ann
        a1 = next_a or ann
        t0 = sample_t[a0["sample_token"]]["timestamp"]
        t1 = sample_t[a1["sample_token"]]["timestamp"]
        if t1 == t0:
            return [0.0, 0.0, 0.0]
        d = (np.asarray(a1["translation"]) - np.asarray(a0["translation"]))
        return (d / ((t1 - t0) / 1e6)).tolist()

    def _dump_blob(self, sd, out, name, fi):
        src = self.input_path / sd["filename"]
        dst_dir = out / name
        dst_dir.mkdir(parents=True, exist_ok=True)
        if name == "lidar_top":
            dst = dst_dir / ("%03d.pcd" % fi)
            if src.exists():
                shutil.copy(src, dst)
            # lidarseg labels live in a parallel folder keyed by token
            seg = (self.input_path / "lidarseg" / self.version
                   / (sd["token"] + "_lidarseg.bin"))
            if seg.exists():
                seg_dir = out / "lidar_top_seg"
                seg_dir.mkdir(exist_ok=True)
                shutil.copy(seg, seg_dir / ("%03d.bin" % fi))
        else:
            dst = dst_dir / ("%03d.jpg" % fi)
            if src.exists():
                shutil.copy(src, dst)

    def convert(self, nworkers=0, scenes=None):
        scene_t = self._table("scene")
        todo = [s for s in scene_t.values()
                if scenes is None or s["name"] in scenes]
        self.output_path.mkdir(parents=True, exist_ok=True)
        pool = NumberPool(nworkers)
        for scene in todo:
            # module-level task: a lambda cannot pickle into worker
            # processes (every scene would fail silently in parallel mode)
            pool.apply_async(_convert_scene_task,
                             (self.input_path, self.output_path,
                              self.version, self.zip_output,
                              self.store_inter, scene["token"]))
            pool.wait_for_once()
        if nworkers:
            pool.close()
            pool.join()


def convert_dataset_inpath(input_path, output_path, version="v1.0-trainval",
                           zip_output=False, store_inter=0, nworkers=0,
                           scenes=None):
    """Convert the raw nuScenes tree at ``input_path``; trainval scenes go
    under ``<output>/trainval``, test under ``<output>/test``."""
    sub = "test" if "test" in version else "trainval"
    conv = KeyFrameConverter(input_path, Path(output_path) / sub,
                             version=version, zip_output=zip_output,
                             store_inter=store_inter)
    conv.convert(nworkers=nworkers, scenes=scenes)


def main():
    from argparse import ArgumentParser

    parser = ArgumentParser(
        description="Convert raw (extracted) nuScenes into the "
                    "d3d_tpu_torch per-scene layout.")
    parser.add_argument("input", type=str)
    parser.add_argument("output", type=str)
    parser.add_argument("-v", "--version", default="v1.0-trainval")
    parser.add_argument("-z", "--zip", action="store_true", dest="zip_output")
    parser.add_argument("-i", "--store-inter", type=int, default=0)
    parser.add_argument("-j", "--workers", type=int, default=0)
    args = parser.parse_args()
    convert_dataset_inpath(args.input, args.output, version=args.version,
                           zip_output=args.zip_output,
                           store_inter=args.store_inter,
                           nworkers=args.workers)


if __name__ == "__main__":
    main()


def _convert_scene_task(_ntqdm, input_path, output_path, version,
                        zip_output, store_inter, scene_token):
    """Picklable per-scene worker: rebuilds a converter in the worker
    process and converts one scene."""
    conv = KeyFrameConverter(input_path, output_path, version=version,
                             zip_output=zip_output, store_inter=store_inter)
    scene = conv._table("scene")[scene_token]
    conv.convert_scene(scene)

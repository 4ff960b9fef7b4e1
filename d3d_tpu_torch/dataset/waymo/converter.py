"""Convert Waymo Open Dataset tfrecords into the per-segment layout consumed
by :class:`d3d_tpu_torch.dataset.waymo.WaymoLoader` (port of
``d3d_tpu.dataset.waymo.converter``; reference
d3d/dataset/waymo/converter.py; same output contract).

Requires tensorflow + waymo_open_dataset (not shipped in this image; the
converter is import-gated). The point clouds keep the intensity and
elongation channels of the range images and are stored per lidar in the
SENSOR frame (the loader re-expresses them in the vehicle frame)."""

import json
import shutil
import zipfile
from pathlib import Path

import numpy as np

from ..base import NumberPool

__all__ = ["convert_segment", "convert_dataset_inpath", "main"]

_LIDAR_NAMES = {1: "top", 2: "front", 3: "side_left", 4: "side_right",
                5: "rear"}
_CAMERA_NAMES = {1: "front", 2: "front_left", 3: "front_right",
                 4: "side_left", 5: "side_right"}


def _require_waymo():
    try:
        import tensorflow  # noqa: F401
        from waymo_open_dataset import dataset_pb2  # noqa: F401
        from waymo_open_dataset.utils import (frame_utils,  # noqa: F401
                                              range_image_utils)
    except ImportError as e:
        raise ImportError(
            "tensorflow and waymo_open_dataset are required for the Waymo "
            "converter; install them from "
            "github.com/waymo-research/waymo-open-dataset") from e


def _extract_points(frame):
    """Range images -> per-lidar (N, 5) clouds with intensity/elongation
    (the stock frame_utils helper drops those channels)."""
    import tensorflow as tf
    from waymo_open_dataset.utils import frame_utils, range_image_utils, transform_utils

    (range_images, camera_projections, _,
     range_image_top_pose) = frame_utils.parse_range_image_and_camera_projection(frame)

    calibrations = sorted(frame.context.laser_calibrations,
                          key=lambda c: c.name)
    points = {}
    frame_pose = tf.convert_to_tensor(
        np.reshape(np.array(frame.pose.transform), [4, 4]))
    # top-lidar per-pixel pose
    ri_pose = tf.convert_to_tensor(
        np.reshape(np.array(range_image_top_pose.data),
                   range_image_top_pose.shape.dims))
    pose_rot = transform_utils.get_rotation_matrix(
        ri_pose[..., 0], ri_pose[..., 1], ri_pose[..., 2])
    pose_tensor = transform_utils.get_transform(pose_rot, ri_pose[..., 3:])

    for calib in calibrations:
        ri = range_images[calib.name][0]
        if len(calib.beam_inclinations) == 0:
            inclinations = range_image_utils.compute_inclination(
                tf.constant([calib.beam_inclination_min,
                             calib.beam_inclination_max]),
                height=ri.shape.dims[0])
        else:
            inclinations = tf.constant(calib.beam_inclinations)
        inclinations = tf.reverse(inclinations, axis=[-1])
        extrinsic = np.reshape(np.array(calib.extrinsic.transform), [4, 4])

        ri_tensor = tf.reshape(tf.convert_to_tensor(ri.data), ri.shape.dims)
        pixel_pose = frame_pose_local = None
        if calib.name == 1:  # TOP lidar supports per-pixel pose
            pixel_pose = tf.expand_dims(pose_tensor, axis=0)
            frame_pose_local = tf.expand_dims(frame_pose, axis=0)
        cart = range_image_utils.extract_point_cloud_from_range_image(
            tf.expand_dims(ri_tensor[..., 0], axis=0),
            tf.expand_dims(extrinsic, axis=0),
            tf.expand_dims(inclinations, axis=0),
            pixel_pose=pixel_pose, frame_pose=frame_pose_local)
        cart = tf.squeeze(cart, axis=0)
        mask = ri_tensor[..., 0] > 0
        xyz = tf.boolean_mask(cart, mask).numpy()
        intensity = tf.boolean_mask(ri_tensor[..., 1], mask).numpy()
        elongation = tf.boolean_mask(ri_tensor[..., 2], mask).numpy()

        # vehicle frame -> sensor frame for storage
        inv = np.linalg.inv(extrinsic)
        xyz = xyz.dot(inv[:3, :3].T) + inv[:3, 3]
        points[_LIDAR_NAMES[calib.name]] = np.concatenate(
            [xyz, intensity[:, None], elongation[:, None]],
            axis=1).astype(np.float32)
    return points


def convert_segment(ntqdm, tfrecord_path, output_path, zip_output=False,
                    delete_input=False):
    """Convert one tfrecord segment; resumable at file granularity."""
    _require_waymo()
    import tensorflow as tf
    from tqdm import tqdm
    from waymo_open_dataset import dataset_pb2

    tfrecord_path = Path(tfrecord_path)
    seq_name = tfrecord_path.stem.replace("segment-", "").replace(
        "_with_camera_labels", "")
    out = Path(output_path) / seq_name
    (out / "context").mkdir(parents=True, exist_ok=True)

    dataset = tf.data.TFRecordDataset(str(tfrecord_path), compression_type="")
    frame_count = 0
    calib_cams, calib_lidars = {}, {}

    for fi, data in enumerate(tqdm(dataset, position=ntqdm, leave=False,
                                   desc=seq_name[:24])):
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        frame_count += 1

        # calibrations (constant per segment)
        if not calib_cams:
            for c in frame.context.camera_calibrations:
                calib_cams[_CAMERA_NAMES[c.name]] = dict(
                    intrinsic=list(c.intrinsic),
                    extrinsic=list(c.extrinsic.transform),
                    width=c.width, height=c.height)
            for c in frame.context.laser_calibrations:
                calib_lidars[_LIDAR_NAMES[c.name]] = dict(
                    extrinsic=list(c.extrinsic.transform))

        # clouds
        for name, cloud in _extract_points(frame).items():
            d = out / ("lidar_" + name)
            d.mkdir(exist_ok=True)
            cloud.tofile(d / ("%04d.bin" % fi))

        # images + 2d labels
        for image in frame.images:
            name = _CAMERA_NAMES[image.name]
            d = out / ("camera_" + name)
            d.mkdir(exist_ok=True)
            (d / ("%04d.jpg" % fi)).write_bytes(image.image)
        for labels in frame.camera_labels:
            name = _CAMERA_NAMES[labels.name]
            d = out / ("label_camera_" + name)
            d.mkdir(exist_ok=True)
            items = [dict(center=[l.box.center_x, l.box.center_y],
                          size=[l.box.length, l.box.width],
                          label=l.type, id=l.id) for l in labels.labels]
            (d / ("%04d.json" % fi)).write_text(json.dumps(items))

        # 3d labels
        d = out / "label_lidars"
        d.mkdir(exist_ok=True)
        # num_points / difficulty feed the LEVEL_1/LEVEL_2 stratification
        # in d3d_tpu_torch.benchmarks_waymo (proto fields num_lidar_points_in_box
        # and detection_difficulty_level)
        items = [dict(center=[l.box.center_x, l.box.center_y, l.box.center_z],
                      size=[l.box.length, l.box.width, l.box.height],
                      heading=l.box.heading, label=l.type, id=l.id,
                      num_points=l.num_lidar_points_in_box,
                      difficulty=l.detection_difficulty_level)
                 for l in frame.laser_labels]
        (d / ("%04d.json" % fi)).write_text(json.dumps(items))

        # pose + timestamp
        d = out / "pose"
        d.mkdir(exist_ok=True)
        np.array(frame.pose.transform, dtype="f8").tofile(
            d / ("%04d.bin" % fi))
        d = out / "timestamp"
        d.mkdir(exist_ok=True)
        (d / ("%04d.txt" % fi)).write_text(str(frame.timestamp_micros))

    (out / "context" / "stats.json").write_text(json.dumps(dict(
        frame_count=frame_count, context=seq_name)))
    (out / "context" / "calib_cams.json").write_text(json.dumps(calib_cams))
    (out / "context" / "calib_lidars.json").write_text(
        json.dumps(calib_lidars))

    if zip_output:
        zpath = Path(output_path) / (seq_name + ".zip")
        with zipfile.ZipFile(zpath, "w") as zf:
            for f in sorted(out.rglob("*")):
                if f.is_file():
                    zf.write(f, f.relative_to(out))
        shutil.rmtree(out)
    if delete_input:
        tfrecord_path.unlink()
    return seq_name


def convert_dataset_inpath(input_path, output_path, nworkers=0,
                           zip_output=False, delete_input=False):
    """Convert all tfrecords under ``input_path`` (NumberPool fan-out)."""
    _require_waymo()
    records = sorted(Path(input_path).glob("*.tfrecord"))
    pool = NumberPool(nworkers)
    for rec in records:
        pool.apply_async(convert_segment,
                         (rec, output_path, zip_output, delete_input))
        pool.wait_for_once()
    if nworkers:
        pool.close()
        pool.join()


def main():
    from argparse import ArgumentParser

    parser = ArgumentParser(
        description="Convert Waymo tfrecords into the d3d_tpu_torch per-segment "
                    "layout.")
    parser.add_argument("input", type=str)
    parser.add_argument("output", type=str)
    parser.add_argument("-j", "--workers", type=int, default=0)
    parser.add_argument("-z", "--zip", action="store_true", dest="zip_output")
    parser.add_argument("-d", "--delete-input", action="store_true")
    args = parser.parse_args()
    convert_dataset_inpath(args.input, args.output, nworkers=args.workers,
                           zip_output=args.zip_output,
                           delete_input=args.delete_input)


if __name__ == "__main__":
    main()

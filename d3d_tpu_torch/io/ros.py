"""Dump sequence datasets into ROS bags (port of ``d3d_tpu.io.ros``;
reference d3d/io/ros.py:21-220).
Gated on the optional ROS python stack (rospy/rosbag/sensor_msgs).

Capability parity with the reference dump: static calibration TFs +
CameraInfo (intrinsics, distortion), per-frame lidar clouds, camera
images (mono8/rgb8 SensorImage, reference :126-148), msgpack-encoded
object annotations, per-point semantic annotations, and the per-frame
ego-pose TF chain relative to the first frame with an optional odom
anchor frame (reference :54, :73-99, :175-195)."""

import numpy as np

__all__ = ["dump_sequence_dataset"]


def _require_ros():
    try:
        import rosbag  # noqa: F401
        import rospy  # noqa: F401
        from sensor_msgs import point_cloud2  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "rospy/rosbag/sensor_msgs are required for ROS dumping; install "
            "a ROS python environment") from e


def dump_sequence_dataset(dataset, out_path, sequence, size_limit=None,
                          object_encoder="msgpack", odom_frame=None,
                          dump_images=True, dump_point_labels=True):
    """Write one sequence (calibration TFs, clouds, camera images, poses
    and msgpack-encoded object annotations) into a rosbag.

    :param object_encoder: 'msgpack' serializes Target3DArray dumps into
        std_msgs/ByteMultiArray messages
    :param odom_frame: optional sensor frame anchoring the odometry chain:
        a static ``odom -> odom_pose`` transform is emitted and per-frame
        poses hang off ``odom_pose`` (reference d3d/io/ros.py:92-109)
    :param dump_images: write per-frame camera images as SensorImage
    :param dump_point_labels: write per-point semantic annotations (when
        the dataset implements ``annotation_3dpoints``) as clouds with a
        trailing ``label`` field
    """
    _require_ros()
    import rosbag
    import rospy
    from geometry_msgs.msg import TransformStamped
    from sensor_msgs import point_cloud2
    from sensor_msgs.msg import CameraInfo, PointField
    from std_msgs.msg import ByteMultiArray, Header
    from tf2_msgs.msg import TFMessage

    try:
        from sensor_msgs.msg import Image as SensorImage
    except ImportError:
        SensorImage = None

    nframes = dataset.sequence_sizes[sequence]
    calib = dataset.calibration_data((sequence, 0), bypass=True)
    pose_name = getattr(dataset, "pose_name", None)

    def _fill_tf(msg, rt):
        q = _mat2quat(rt[:3, :3])
        msg.transform.translation.x, msg.transform.translation.y, \
            msg.transform.translation.z = rt[:3, 3]
        msg.transform.rotation.x, msg.transform.rotation.y, \
            msg.transform.rotation.z, msg.transform.rotation.w = q

    with rosbag.Bag(str(out_path), "w") as bag:
        # static calibration
        tfm = TFMessage()
        for frame in calib.frames:
            # TF child_frame_id semantics: the transform carries CHILD-frame
            # points into the parent, i.e. frame->base (frame_from), not
            # base->frame
            rt = calib.get_extrinsic(frame_from=frame)
            msg = TransformStamped()
            msg.header.frame_id = calib.base_frame
            msg.child_frame_id = frame
            _fill_tf(msg, rt)
            tfm.transforms.append(msg)

            meta = calib.intrinsics_meta.get(frame)
            if getattr(meta, "intri_matrix", None) is not None:
                info = CameraInfo()
                info.width, info.height = meta.width, meta.height
                info.distortion_model = "plumb_bob"
                info.K = list(np.asarray(meta.intri_matrix).ravel())
                if getattr(meta, "distort_coeffs", None) is not None:
                    info.D = list(np.asarray(meta.distort_coeffs).ravel())
                bag.write(f"/calib/{frame}", info)

        # odometry anchor: odom -> odom_pose static transform so external
        # tools can re-root the per-frame pose chain on a sensor frame
        if odom_frame is not None:
            if pose_name is None:
                raise ValueError(
                    "odom_frame requires a dataset with ego poses "
                    "(pose_name); this dataset exposes none")
            if odom_frame not in calib.frames \
                    and odom_frame != calib.base_frame:
                raise ValueError("Invalid odom frame name!")
            msg = TransformStamped()
            msg.header.frame_id = "odom"
            msg.child_frame_id = "odom_pose"
            msg_rt = calib.get_extrinsic(frame_to=odom_frame,
                                         frame_from=pose_name)
            _fill_tf(msg, msg_rt)
            tfm.transforms.append(msg)
        bag.write("/tf_static", tfm)

        pose0_inv = None
        cam_names = getattr(dataset, "VALID_CAM_NAMES", ()) \
            if dump_images and SensorImage is not None else ()

        for fi in range(nframes):
            ts = dataset.timestamp((sequence, fi), bypass=True)
            stamp = rospy.Time.from_sec(ts / 1e6)
            header = Header(stamp=stamp)

            # clouds
            for name in dataset.VALID_LIDAR_NAMES:
                cloud = dataset.lidar_data((sequence, fi), name, bypass=True)
                header.frame_id = name
                fields = [PointField(n, 4 * i, PointField.FLOAT32, 1)
                          for i, n in enumerate("xyzi"[:cloud.shape[1]])]
                msg = point_cloud2.create_cloud(header, fields,
                                                cloud[:, :len(fields)])
                bag.write(f"/lidar/{name}", msg, t=stamp)

                # per-point semantic labels -> cloud with a label field
                if dump_point_labels:
                    try:
                        labels = dataset.annotation_3dpoints(
                            (sequence, fi), name, bypass=True)
                    except (NotImplementedError, AttributeError, TypeError):
                        labels = None
                    if labels is not None:
                        lab = np.asarray(
                            labels["semantic"] if isinstance(labels, dict)
                            else labels, np.float32).reshape(-1, 1)
                        pts = np.hstack([np.asarray(cloud[:, :3], np.float32),
                                         lab])
                        lfields = fields[:3] + [
                            PointField("label", 12, PointField.FLOAT32, 1)]
                        msg = point_cloud2.create_cloud(header, lfields, pts)
                        bag.write(f"/annotation_3dpoints/{name}", msg,
                                  t=stamp)

            # camera images (reference d3d/io/ros.py:126-148)
            for name in cam_names:
                img = dataset.camera_data((sequence, fi), name, bypass=True)
                if img is None:
                    continue
                msg = SensorImage()
                msg.height, msg.width = img.height, img.width
                if img.mode in ("1", "L"):
                    img = img.convert("L")
                    msg.encoding = "mono8"
                    msg.step = img.width
                else:
                    img = img.convert("RGB")
                    msg.encoding = "rgb8"
                    msg.step = 3 * img.width
                msg.is_bigendian = False
                msg.data = np.asarray(img).tobytes()
                msg.header.stamp = stamp
                msg.header.frame_id = name
                bag.write(f"/camera/{name}", msg, t=stamp)

            # objects
            objs = dataset.annotation_3dobject((sequence, fi), bypass=True)
            arr = ByteMultiArray()
            import io as _io

            buf = _io.BytesIO()
            objs.dump(buf)
            # ROS1 byte[] is SIGNED int8: raw values > 127 crash genpy's
            # struct packing
            arr.data = [b - 256 if b > 127 else b for b in buf.getvalue()]
            bag.write("/objects", arr, t=stamp)

            # per-frame ego pose relative to the first frame
            # (reference d3d/io/ros.py:175-195)
            if pose_name is not None:
                try:
                    pose = dataset.pose((sequence, fi), bypass=True)
                except (NotImplementedError, AttributeError):
                    pose = None
                if pose is not None:
                    if pose0_inv is None:
                        pose0_inv = np.linalg.inv(pose.homo())
                    tfdiff = pose0_inv.dot(pose.homo())
                    ptfm = TFMessage()
                    msg = TransformStamped()
                    msg.header.stamp = stamp
                    msg.header.frame_id = ("odom_pose" if odom_frame
                                           else "odom")
                    msg.child_frame_id = pose_name
                    _fill_tf(msg, tfdiff)
                    ptfm.transforms.append(msg)
                    bag.write("/tf", ptfm, t=stamp)

            if size_limit and bag.size > size_limit:
                break


def _mat2quat(m):
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(m).as_quat()

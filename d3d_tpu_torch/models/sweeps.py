"""Multi-sweep lidar accumulation (nuScenes-style temporal input; port of
``d3d_tpu.models.sweeps``: host numpy, float64 transforms).

The standard nuScenes detector input concatenates the keyframe cloud with
the preceding unannotated sweeps, each motion-compensated into the
keyframe sensor frame and tagged with its age as an extra channel —
CenterPoint's "10-sweep" configuration. The reference devkit stores the
sweeps (d3d converted layout ``intermediate/NNN``) but ships no
accumulation op; this module provides it for the framework's model
families: the resulting (N, 5) ``[x, y, z, intensity, dt]`` cloud feeds
``pillarize``/``second_voxelize`` unchanged (feature columns beyond xyz
flow through voxelization and the PFN consumes whatever width arrives).
In the port the cloud feeds ``presets.voxelnext_nuscenes``'s 5-column
input.
"""

import numpy as np

__all__ = ["accumulate_sweeps"]


def accumulate_sweeps(loader, idx, nsweeps=10, sensor="lidar_top",
                      max_points=None):
    """Keyframe cloud + up to ``nsweeps - 1`` latest preceding sweeps,
    motion-compensated into the keyframe sensor frame.

    Chain per sweep point p (sensor frame at sweep time):
    ``p' = T_ego<-sensor^-1 @ T_key_pose^-1 @ T_sweep_pose @ T_ego<-sensor @ p``
    using the per-sweep ego poses the converter stored in
    ``intermediate/NNN/meta.json`` and the static sensor calibration.

    :param loader: a NuscenesLoader (or any loader exposing the same
        ``lidar_data`` / ``intermediate_data`` / ``calibration_data`` /
        ``pose`` / ``timestamp`` surface)
    :param idx: keyframe index
    :param max_points: optional cap; newest points win (keyframe first)
    :returns: (N, 5) float32 ``[x, y, z, intensity, dt_seconds]`` where
        dt is the keyframe-relative age (0 for keyframe points)
    """
    key_cloud = np.asarray(loader.lidar_data(idx, names=sensor))
    calib = loader.calibration_data(idx)
    t_es = calib.get_extrinsic(frame_from=sensor)  # sensor -> ego
    t_se = np.linalg.inv(t_es)
    key_pose_inv = np.linalg.inv(loader.pose(idx).homo())
    key_ts = loader.timestamp(idx)

    out = [np.concatenate(
        [key_cloud[:, :4].astype(np.float32),
         np.zeros((len(key_cloud), 1), np.float32)], axis=1)]

    items = list(loader.intermediate_data(idx, names=sensor)) \
        if nsweeps > 1 else []
    for item in items[-(nsweeps - 1):][::-1]:  # newest first
        pts = np.asarray(item.data)
        m = t_se @ key_pose_inv @ item.pose.homo() @ t_es
        xyz = pts[:, :3] @ m[:3, :3].T + m[:3, 3]
        inten = pts[:, 3:4] if pts.shape[1] > 3 \
            else np.zeros((len(pts), 1), pts.dtype)
        dt = np.full((len(pts), 1), (key_ts - item.timestamp) / 1e6,
                     np.float32)
        out.append(np.concatenate(
            [xyz.astype(np.float32), inten.astype(np.float32), dt], axis=1))

    cloud = np.concatenate(out, axis=0)
    if max_points is not None and len(cloud) > max_points:
        cloud = cloud[:max_points]
    return cloud

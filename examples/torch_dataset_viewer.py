"""Browse a tracking dataset frame by frame with the point-cloud viewer,
on the port's loaders (the PyTorch counterpart of ``dataset_viewer.py``:
the same loader surface; the pcl dependency is optional, with a
matplotlib fallback). Loading and drawing run on the host.

Usage:
    python examples/torch_dataset_viewer.py <dataset_path> kitti-raw <scene>
    python examples/torch_dataset_viewer.py <path> nuscenes <scene> --inter 3
"""

import argparse
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def open_loader(dataset_path, dataset_type):
    """The port's loader of ``dataset_type`` (kitti-raw, nuscenes or
    waymo) over ``dataset_path``, with its default layout."""
    dataset_type = dataset_type.lower()
    if dataset_type == "kitti-raw":
        from d3d_tpu_torch.dataset.kitti import KittiRawLoader
        return KittiRawLoader(dataset_path)
    if dataset_type == "nuscenes":
        from d3d_tpu_torch.dataset.nuscenes import NuscenesLoader
        return NuscenesLoader(dataset_path)
    if dataset_type == "waymo":
        from d3d_tpu_torch.dataset.waymo import WaymoLoader
        return WaymoLoader(dataset_path)
    raise ValueError("Unsupported dataset type!")


def scene_frames(loader, scene, ninter_frames=0):
    """Yield ``(idx, cloud (N, 4), objects, calib, lidar_frame)`` for each
    frame of ``scene``: the keyframe's lidar points with ``ninter_frames``
    intermediate sweeps moved into its frame by the ego poses."""
    lidar_frame = loader.VALID_LIDAR_NAMES[0]
    for idx in range(loader.sequence_sizes[scene]):
        sidx = (scene, idx)
        objs = loader.annotation_3dobject(sidx)
        calib = loader.calibration_data(sidx)
        cloud = np.asarray(loader.lidar_data(sidx))[:, :4]

        if ninter_frames:
            pose = loader.pose(sidx)
            inter = loader.intermediate_data(sidx, names=lidar_frame,
                                             ninter_frames=ninter_frames)
            for frame in inter:
                ego_rt = calib.get_extrinsic(frame_from=lidar_frame)
                rt = (np.linalg.inv(ego_rt) @ np.linalg.inv(pose.homo())
                      @ frame.pose.homo() @ ego_rt)
                xyz = frame.data[:, :3] @ rt[:3, :3].T + rt[:3, 3]
                cloud = np.vstack(
                    [cloud, np.hstack([xyz, frame.data[:, [3]]])])
        yield idx, cloud, objs, calib, lidar_frame


def show_frame(cloud, lidar_frame, objs, calib):
    """Draw one frame: the cloud and the boxes in pcl's Visualizer, or a
    matplotlib 3D axis without pcl; blocks until the window closes."""
    from d3d_tpu_torch.vis.pcl import visualize_detections

    try:
        import pcl
        vis = pcl.Visualizer()
        vis.addPointCloud(pcl.create_xyzi(cloud[:, :4]), field="intensity")
    except ImportError:  # matplotlib fallback
        import matplotlib.pyplot as plt
        fig = plt.figure()
        vis = fig.add_subplot(projection="3d")
        vis.scatter(cloud[::8, 0], cloud[::8, 1], cloud[::8, 2],
                    s=0.2, c=cloud[::8, 3])
    visualize_detections(vis, lidar_frame, objs, calib)
    try:
        vis.spin()  # pcl
    except AttributeError:
        import matplotlib.pyplot as plt
        plt.show()


def dataset_visualize_pcl(dataset_path, dataset_type, scene,
                          ninter_frames=0, device="cuda", render=show_frame,
                          ask=None):
    """Render each frame's accumulated lidar + GT boxes; enter advances,
    q quits.

    :param dataset_type: one of kitti-raw, nuscenes, waymo
    :param device: checked like every entry point's (CUDA unless
        ``"cpu"``); the viewer's own work runs on the host
    :param render: ``(cloud, lidar_frame, objects, calib)`` drawing one
        frame (default :func:`show_frame`)
    :param ask: the prompt between frames (default ``input``)
    """
    from d3d_tpu_torch.utils import resolve_device

    resolve_device(device)
    loader = open_loader(dataset_path, dataset_type)
    for idx, cloud, objs, calib, lidar_frame in scene_frames(
            loader, scene, ninter_frames):
        render(cloud, lidar_frame, objs, calib)
        key = (ask or input)(
            f"frame {idx} — enter to continue, q to quit: ")
        try:
            import matplotlib.pyplot as plt
            plt.close("all")  # the fallback leaks a figure per frame
        except ImportError:
            pass
        if key == "q":
            break


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path", type=Path)
    ap.add_argument("dataset", choices=["kitti-raw", "nuscenes", "waymo"])
    ap.add_argument("scene")
    ap.add_argument("--inter", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dataset_visualize_pcl(args.path, args.dataset, args.scene, args.inter,
                          device=args.device)


if __name__ == "__main__":
    main()

"""Camera / BEV visualization on matplotlib axes (port of
``d3d_tpu.vis.image``; reference
d3d/vis/image.py)."""

import numpy as np
from matplotlib import lines

from ..abstraction import TrackingTarget3D

__all__ = ["visualize_detections", "visualize_detections_bev"]

_BOX_PAIRS = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 4), (1, 5), (2, 6), (3, 7),
              (0, 2), (1, 3), (4, 6), (5, 7)]


def _label_text(target, with_tid, with_score):
    parts = []
    if with_tid and target.tid:
        parts.append("#%d" % target.tid if isinstance(target.tid, int)
                     else "#%s" % target.tid)
    if with_score and target.tag_top_score is not None:
        try:
            parts.append("%s %.2f" % (target.tag_top.name,
                                      target.tag_top_score))
        except Exception:
            pass
    return " ".join(parts)


def visualize_detections(ax, image_frame, targets, calib, box_color=(0, 1, 0),
                         thickness=2, tags=None, show_tid=False,
                         show_score=False):
    """Project 3D boxes (plus a heading whisker) into a camera image and draw
    the wireframes on a matplotlib axis. ``show_tid``/``show_score``
    annotate each box with its track id / class+score at the topmost
    visible corner."""
    for target in targets.filter_tag(tags):
        points = target.corners
        indicator = np.array([
            [0, 0, -target.dimension[2] / 2],
            [target.dimension[0] / 2, 0, -target.dimension[2] / 2],
        ]).dot(target.orientation.as_matrix().T)
        points = np.vstack([points, target.position + indicator])

        uv, mask, dmask = calib.project_points_to_camera(
            points, frame_to=image_frame, frame_from=targets.frame,
            remove_outlier=False, return_dmask=True)
        if len(mask) < 1:
            continue
        inlier = np.zeros(len(uv), bool)
        inlier[mask] = True
        ahead = np.zeros(len(uv), bool)
        ahead[dmask] = True

        for i, j in _BOX_PAIRS:
            if not (inlier[i] or inlier[j]):
                continue
            if not (ahead[i] and ahead[j]):
                continue
            ax.add_line(lines.Line2D((uv[i, 0], uv[j, 0]),
                                     (uv[i, 1], uv[j, 1]),
                                     c=box_color, lw=thickness))
        if ahead[-1] and ahead[-2]:
            ax.add_line(lines.Line2D((uv[-2, 0], uv[-1, 0]),
                                     (uv[-2, 1], uv[-1, 1]),
                                     c=box_color, lw=thickness))
        text = _label_text(target, show_tid, show_score)
        # anchor on corners that are in-image AND in front of the camera:
        # a behind-camera corner can project inside the bounds at a
        # mirrored position far from the drawn wireframe
        vis_mask = inlier[:8] & ahead[:8]
        if text and vis_mask.any():
            vis = uv[:8][vis_mask]
            anchor = vis[np.argmin(vis[:, 1])]
            ax.text(anchor[0], anchor[1] - 2, text, color=box_color,
                    fontsize=8)


def visualize_detections_bev(ax, visualizer_frame, targets, calib,
                             box_color=(0, 1, 0), thickness=2, tags=None,
                             show_tid=False, show_score=False):
    """Draw bird's-eye-view box footprints (and velocity vectors for tracked
    targets) on a matplotlib axis; ``show_tid``/``show_score`` annotate
    each footprint."""
    if targets.frame != visualizer_frame:
        targets = calib.transform_objects(targets, frame_to=visualizer_frame)

    for target in targets.filter_tag(tags):
        points = target.corners
        for i, j in [(0, 1), (2, 3), (0, 2), (1, 3)]:
            ax.add_line(lines.Line2D((points[i, 0], points[j, 0]),
                                     (points[i, 1], points[j, 1]),
                                     c=box_color, lw=thickness))
        if isinstance(target, TrackingTarget3D):
            start = target.position[:2]
            end = start + target.velocity[:2]
            ax.add_line(lines.Line2D((start[0], end[0]), (start[1], end[1]),
                                     c=box_color, lw=thickness))
        text = _label_text(target, show_tid, show_score)
        if text:
            ax.text(target.position[0], target.position[1], text,
                    color=box_color, fontsize=8)

"""3D point-cloud visualization (port of ``d3d_tpu.vis.pcl``).

The reference draws into an interactive ``pcl.py`` Visualizer window
(reference d3d/vis/pcl.py:18-113: oriented cubes, colormapped per-tid
colors, text tags with score/variance annotations, orientation arrows,
velocity lines). That package is optional and rarely available, so this
module renders the SAME scene content through two backends:

  * a ``pcl.py`` Visualizer when the package is installed (parity calls:
    addCube / addText3D / addLine / setShapeRenderingProperties), or
  * any matplotlib 3D axis — wireframe cubes, the same label text,
    orientation arrows and velocity lines — so the no-pcl path shows
    everything the reference's pcl window does.
"""

import numpy as np

__all__ = ["visualize_detections"]


def _tid_color(tid):
    """Deterministic RGB per tracking id (stable across processes:
    hash() is randomized for strings by PYTHONHASHSEED)."""
    import zlib

    rng = np.random.default_rng(zlib.crc32(str(tid).encode()))
    return tuple(rng.random(3) * 0.8 + 0.2)


def _resolve_color(color, tid):
    """Reference color semantics: an RGB(A) tuple is used as-is; a str
    names a matplotlib colormap applied to ``tid % 256``."""
    if isinstance(color, str):
        import matplotlib as mpl

        return mpl.colormaps[color](tid % 256)
    return color


def _label_text(target, i):
    """The reference's tag text (pcl.py:76-89): id + class, with score and
    position/dimension/orientation standard deviations when present."""
    if target.tid:
        disp = "%s: %s" % (target.tid64, target.tag_top.name)
    else:
        disp = "#%d: %s" % (i, target.tag_top.name)
    aux = []
    if target.tag_top_score < 1:
        aux.append("%.2f" % target.tag_top_score)
    pvar = np.power(max(np.linalg.det(target.position_var), 0), 1 / 6)
    if pvar > 0:
        aux.append("%.2f" % pvar)
    dvar = np.power(max(np.linalg.det(target.dimension_var), 0), 1 / 6)
    if dvar > 0:
        aux.append("%.2f" % dvar)
    if target.orientation_var > 0:
        aux.append("%.2f" % target.orientation_var)
    if aux:
        disp += " (" + ", ".join(aux) + ")"
    return disp


def _direction_lines(target):
    """The two bottom-face arrow lines pointing +x (pcl.py:92-99)."""
    lx, ly, lz = target.dimension
    dir_x, dir_y, dir_z = np.hsplit(target.orientation.as_matrix(), 3)
    off_x = dir_x.ravel() * lx / 2
    off_y = dir_y.ravel() * ly / 2
    off_z = dir_z.ravel() * lz / 2
    bottom = target.position - off_z
    return [(bottom - off_y - off_x, bottom + off_x),
            (bottom + off_y - off_x, bottom + off_x)]


_WIRE_PAIRS = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 4), (1, 5), (2, 6),
               (3, 7), (0, 2), (1, 3), (4, 6), (5, 7)]


def visualize_detections(visualizer, frame, targets, calib, text_scale=0.8,
                         box_color=(1, 1, 1), text_color=(1, 0.8, 1),
                         id_prefix="", tags=None, text_offset=None,
                         viewport=0, id_colored=False):
    """Draw detection/tracking boxes with labels into ``visualizer``.

    ``visualizer`` is either a ``pcl.py`` Visualizer (reference parity:
    d3d/vis/pcl.py:18) or a matplotlib 3D axis (the always-available
    fallback, same scene content).

    :param frame: the frame the visualizer's geometry lives in
    :param targets: Target3DArray; transformed to ``frame`` via ``calib``
        if needed
    :param text_scale: text size; <= 0 suppresses labels
    :param box_color: RGB(A) tuple, or a matplotlib colormap NAME applied
        to ``tid % 256`` (reference box_color colormap semantics)
    :param text_color: same semantics as ``box_color``
    :param id_prefix: actor-id prefix for repeated pcl calls
    :param text_offset: optional displacement of the label anchor
    :param viewport: pcl viewport (ignored by the mpl backend)
    :param id_colored: legacy flag — color boxes by a per-tid hash (kept
        for callers that predate the colormap semantics)
    """
    try:
        import pcl  # noqa: F401
        has_pcl = hasattr(visualizer, "addCube")
    except ImportError:
        has_pcl = False

    if id_prefix and not id_prefix.endswith("/"):
        id_prefix += "/"
    if targets.frame != frame:
        targets = calib.transform_objects(targets, frame_to=frame)

    for i, target in enumerate(targets.filter_tag(tags)):
        tid = target.tid or i
        color = _tid_color(target.tid) if id_colored and target.tid \
            else _resolve_color(box_color, tid)
        tcolor = _resolve_color(text_color, tid)
        if has_pcl:
            _draw_pcl(visualizer, target, i, color, tcolor, text_scale,
                      id_prefix, text_offset, viewport)
        else:
            _draw_mpl(visualizer, target, i, color, tcolor, text_scale,
                      text_offset)


def _draw_pcl(vis, target, i, color, tcolor, text_scale, id_prefix,
              text_offset, viewport):
    lx, ly, lz = target.dimension
    q = target.orientation.as_quat()
    cube_id = f"{id_prefix}target{i}"
    vis.addCube(list(target.position), [q[3], q[0], q[1], q[2]],
                lx, ly, lz, id=cube_id, viewport=viewport)
    alpha = color[3] if len(color) > 3 else 0.8
    vis.setShapeRenderingProperties("opacity", cube_id, alpha)
    vis.setShapeRenderingProperties("color", cube_id, tuple(color[:3]))

    if text_scale > 0:
        pos = np.array(target.position, float)
        pos[2] += lz / 2
        if text_offset is not None:
            pos = pos + text_offset
        vis.addText3D(_label_text(target, i), list(pos),
                      text_scale=text_scale, color=tuple(tcolor[:3]),
                      id=f"{cube_id}/tag", viewport=viewport)

    for k, (p0, p1) in enumerate(_direction_lines(target)):
        vis.addLine(p0, p1, id=f"{cube_id}/direction_{k + 1}",
                    viewport=viewport)
    vel = getattr(target, "velocity", None)
    if vel is not None:
        vis.addLine(target.position, target.position + vel,
                    color=(0.5, 0.5, 1), id=f"{cube_id}/velocity",
                    viewport=viewport)


def _draw_mpl(ax, target, i, color, tcolor, text_scale, text_offset):
    """Matplotlib twin of the pcl scene: wireframe cube + label +
    orientation arrow + velocity line."""
    corners = target.corners
    for a, b in _WIRE_PAIRS:
        ax.plot([corners[a, 0], corners[b, 0]],
                [corners[a, 1], corners[b, 1]],
                [corners[a, 2], corners[b, 2]], color=tuple(color[:3]))

    if text_scale > 0:
        pos = np.array(target.position, float)
        pos[2] += target.dimension[2] / 2
        if text_offset is not None:
            pos = pos + text_offset
        ax.text(pos[0], pos[1], pos[2], _label_text(target, i),
                color=tuple(tcolor[:3]), fontsize=10 * text_scale)

    for p0, p1 in _direction_lines(target):
        ax.plot([p0[0], p1[0]], [p0[1], p1[1]], [p0[2], p1[2]],
                color=tuple(color[:3]), linewidth=0.8)
    vel = getattr(target, "velocity", None)
    if vel is not None:
        p0, p1 = target.position, target.position + vel
        ax.plot([p0[0], p1[0]], [p0[1], p1[1]], [p0[2], p1[2]],
                color=(0.5, 0.5, 1))

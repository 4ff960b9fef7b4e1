"""KITTI 3D object detection dataset loader (port of
``d3d_tpu.dataset.kitti.object``; reference d3d/dataset/kitti/object.py).

Data layout (zipped: ``data_object_{calib,image_2,image_3,label_2,
velodyne}.zip``; unzipped: ``<base>/{training,testing}/{calib,image_2,
label_2,velodyne}``). Labels are given in the rectified camera frame and
converted to the velodyne frame here (the camera->velo math per the KITTI
devkit; reference object.py:43-73). ``DontCare`` boxes are dropped from
:meth:`annotation_3dobject`.

Labels and raw calibration (``calibration_data(raw=True)``) need no
``PIL``; the projective calibration (``calibration_data()``) opens the
camera image for its size, and so does :meth:`dump_detection_output`.
"""

import zipfile
from pathlib import Path
from zipfile import ZipFile

import numpy as np
from scipy.spatial.transform import Rotation

from ...abstraction import ObjectTag, ObjectTarget3D, Target3DArray, TransformSet
from ..base import DetectionDatasetBase, expand_name, split_trainval
from ..zip import PatchedZipFile
from . import utils
from .utils import KittiObjectClass

__all__ = ["KittiObjectLoader", "load_label", "parse_label",
           "create_submission", "execute_official_evaluator",
           "evaluate_detection_results"]
# (dump_detection_output is a KittiObjectLoader METHOD, not module-level)


def load_label(basepath, file):
    """Parse a KITTI object label / result text file into rows of
    [class, truncated, occluded, alpha, bbox(4), hwl(3), xyz(3), ry(, score)].
    """
    rows = []
    for line in utils.read_file(basepath, file).decode().splitlines():
        line = line.strip()
        if not line:
            continue
        fields = line.split()
        rows.append([KittiObjectClass[fields[0]]]
                    + [float(v) for v in fields[1:]])
    return rows


def _cam_to_velo(raw_calib, tr_key="Tr_velo_to_cam", rect_key="R0_rect"):
    """Rotations/translation taking rectified-camera coordinates to velo.
    The tracking benchmark stores the same matrices under different key
    names (``Tr_velo_cam``/``R_rect``) — pass them explicitly there."""
    tr = raw_calib[tr_key].reshape(3, 4)
    rrect = Rotation.from_matrix(raw_calib[rect_key].reshape(3, 3))
    return rrect, Rotation.from_matrix(tr[:, :3]), tr[:, 3]


def parse_label(label, raw_calib):
    """Convert parsed label rows to a Target3DArray in the velo frame.

    DontCare regions (2D-only label lines) are collected on the returned
    array as ``objects.dontcare`` — an (K, 4) float array of image-plane
    [x1, y1, x2, y2] boxes consumed by the official evaluation's
    false-positive suppression (plain attribute; not serialized by
    dump/load)."""
    rrect, hr, ht = _cam_to_velo(raw_calib)
    objects = Target3DArray(frame="velo")
    dontcare = []

    for item in label:
        if item[0] == KittiObjectClass.DontCare:
            dontcare.append([float(v) for v in item[4:8]])
            continue
        h, w, l = item[8:11]
        position = np.asarray(item[11:14], dtype=float)
        ry = item[14]
        position[1] -= h / 2  # bottom center -> box center (camera frame)

        position = rrect.inv().as_matrix().dot(position)
        position = hr.inv().as_matrix().dot(position - ht)
        orientation = hr.inv() * rrect.inv() * Rotation.from_euler("y", ry)
        # dimension order l,h,w (camera axes) -> l,w,h (FLU)
        orientation = orientation * Rotation.from_euler("x", np.pi / 2)

        score = item[15] if len(item) == 16 else None
        tag = ObjectTag(item[0], KittiObjectClass, scores=score)
        # keep the benchmark-relevant 2D fields (the reference discards
        # them): truncation, occlusion and 2D box height drive the
        # official easy/moderate/hard strata
        aux = dict(truncated=float(item[1]), occluded=int(item[2]),
                   alpha=float(item[3]),
                   box_height=float(item[7] - item[5]),
                   bbox=[float(v) for v in item[4:8]])
        objects.append(ObjectTarget3D(position, orientation, [l, w, h], tag,
                                      aux=aux))
    objects.dontcare = np.asarray(dontcare, dtype=float).reshape(-1, 4)
    return objects


class KittiObjectLoader(DetectionDatasetBase):
    """Loader for the KITTI 3D object detection benchmark; see the module
    docstring for the expected file layout and
    :class:`d3d_tpu_torch.dataset.base.DetectionDatasetBase` for the
    constructor parameters."""

    VALID_CAM_NAMES = ["cam2", "cam3"]
    VALID_LIDAR_NAMES = ["velo"]
    VALID_OBJ_CLASSES = KittiObjectClass

    def __init__(self, base_path, inzip=False, phase="training",
                 trainval_split=0.8, trainval_random=False):
        super().__init__(base_path, inzip=inzip, phase=phase,
                         trainval_split=trainval_split,
                         trainval_random=trainval_random)
        self.phase_path = "training" if phase == "validation" else phase

        total_count = None
        if self.inzip:
            for folder in ("image_2", "image_3", "velodyne", "label_2"):
                data_zip = self.base_path / ("data_object_%s.zip" % folder)
                if data_zip.exists():
                    with ZipFile(data_zip) as data:
                        total_count = sum(
                            1 for name in data.namelist()
                            if name.startswith(self.phase_path)
                            and not name.endswith("/"))
                    break
        else:
            for folder in ("image_2", "image_3", "velodyne", "label_2"):
                fpath = self.base_path / self.phase_path / folder
                if fpath.exists():
                    total_count = sum(1 for _ in fpath.iterdir())
                    break
        if not total_count:
            raise ValueError("Cannot parse dataset, please check path, "
                             "inzip option and file structure")

        self.frames = split_trainval(phase, total_count, trainval_split,
                                     trainval_random)
        self._image_size_cache = {}

    def __len__(self):
        return len(self.frames)

    def _parse_idx(self, idx):
        if isinstance(idx, (int, np.integer)):
            return self.frames[idx]
        (uidx,) = idx
        return uidx

    def identity(self, idx):
        return (self.frames[idx],)

    @expand_name(VALID_CAM_NAMES)
    def camera_data(self, idx, names="cam2"):
        folder = {"cam2": "image_2", "cam3": "image_3"}[names]
        uidx = self._parse_idx(idx)
        fname = Path(self.phase_path, folder, "%06d.png" % uidx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / ("data_object_%s.zip" % folder),
                                to_extract=fname) as src:
                image = utils.load_image(src, fname)
        else:
            image = utils.load_image(self.base_path, fname)
        self._image_size_cache.setdefault(uidx, image.size)
        return image

    @expand_name(VALID_LIDAR_NAMES)
    def lidar_data(self, idx, names="velo", formatted=False):
        uidx = self._parse_idx(idx)
        fname = Path(self.phase_path, "velodyne", "%06d.bin" % uidx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_object_velodyne.zip",
                                to_extract=fname) as src:
                return utils.load_velo_scan(src, fname, formatted=formatted)
        return utils.load_velo_scan(self.base_path, fname, formatted=formatted)

    def _load_calib(self, basepath, uidx, raw=False):
        fname = Path(self.phase_path, "calib", "%06d.txt" % uidx)
        filedata = utils.load_calib_file(basepath, fname)
        if raw:
            return filedata

        if uidx not in self._image_size_cache:
            self.camera_data((uidx,))  # fills the image size cache
        image_size = self._image_size_cache[uidx]

        # the projective P matrices operate on rectified camera coords; fold
        # the rectification into the projection and express the per-camera
        # baseline offset as an extrinsic translation (reference
        # object.py:225-245)
        data = TransformSet("velo")
        rect = filedata["R0_rect"].reshape(3, 3)
        velo_to_cam = filedata["Tr_velo_to_cam"].reshape(3, 4)
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
        data.set_extrinsic(filedata["Tr_imu_to_velo"].reshape(3, 4),
                           frame_from="imu")
        return data

    def calibration_data(self, idx, raw=False):
        uidx = self._parse_idx(idx)
        fname = Path(self.phase_path, "calib", "%06d.txt" % uidx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_object_calib.zip",
                                to_extract=fname) as src:
                return self._load_calib(src, uidx, raw)
        return self._load_calib(self.base_path, uidx, raw)

    def annotation_3dobject(self, idx, raw=False):
        assert self.phase_path != "testing", \
            "Testing dataset doesn't contain label data"
        uidx = self._parse_idx(idx)
        fname = Path(self.phase_path, "label_2", "%06d.txt" % uidx)
        if self._return_file_path:
            return self.base_path / fname
        if self.inzip:
            with PatchedZipFile(self.base_path / "data_object_label_2.zip",
                                to_extract=fname) as src:
                label = load_label(src, fname)
        else:
            label = load_label(self.base_path, fname)
        if raw:
            return label
        return parse_label(label, self.calibration_data((uidx,), raw=True))

    def dump_detection_output(self, idx, detections, fout):
        """Write detections in the KITTI submission text format, projecting
        boxes back to the rectified camera frame and clipping the 2D bbox to
        the image (reference object.py:293-357)."""
        uidx = self._parse_idx(idx)
        calib = self.calibration_data((uidx,))
        raw_calib = self.calibration_data((uidx,), raw=True)
        assert detections.frame == "velo"
        rrect, hr, ht = _cam_to_velo(raw_calib)

        lines = []
        fmt = "%s 0 0 0" + " %.2f" * 12
        for box in detections:
            values = format_kitti_box(box, calib, rrect, hr, ht)
            if values is None:
                continue
            lines.append(fmt % (*values, box.tag_top_score))

        content = "\n".join(lines)
        if isinstance(fout, (str, Path)):
            Path(fout).write_text(content)
        else:
            fout.write(content.encode())


def format_kitti_box(box, calib, rrect, hr, ht):
    """One velo-frame box -> the 11 shared KITTI label values
    ``(type, bbox x4, h, w, l, location x3, rotation_y)``: project the
    corners to cam2, clip the 2D bbox to the image, move the center to
    the rectified camera frame with the bottom-center convention. Used by
    both the object and the tracking submission writers. Returns None
    when no corner is visible."""
    meta = calib.intrinsics_meta["cam2"]
    width, height = meta.width, meta.height
    uv, mask, dmask = calib.project_points_to_camera(
        box.corners, frame_to="cam2", frame_from="velo",
        remove_outlier=False, return_dmask=True)
    if len(mask) < 1:
        return None
    inlier = np.zeros(len(uv), bool)
    inlier[mask] = True
    ahead = np.zeros(len(uv), bool)
    ahead[dmask] = True

    # clip box edges against the image border
    pairs = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 4), (1, 5), (2, 6),
             (3, 7), (0, 2), (1, 3), (4, 6), (5, 7)]
    pts = [uv[i] for i in mask]
    for i, j in pairs:
        if not ahead[i] or not ahead[j]:
            continue
        if inlier[i] and not inlier[j]:
            pts.append(_clip_to_image(uv[i], uv[j], width, height))
        elif inlier[j] and not inlier[i]:
            pts.append(_clip_to_image(uv[j], uv[i], width, height))
    pts = np.asarray(pts)
    umin, vmin = pts.min(axis=0)
    umax, vmax = pts.max(axis=0)

    l, w, h = box.dimension
    position = rrect.as_matrix().dot(hr.as_matrix().dot(box.position) + ht)
    position[1] += h / 2
    orientation = box.orientation * Rotation.from_euler("x", np.pi / 2)
    orientation = rrect * hr * orientation
    yaw = orientation.as_euler("YZX")[0]
    return (box.tag_top.name, umin, vmin, umax, vmax, h, w, l,
            *position.tolist(), yaw)


def _clip_to_image(p_in, p_out, width, height):
    """Intersection of segment (p_in inside -> p_out outside) with the image
    border, via parametric clipping against the four edges."""
    d = p_out - p_in
    tmin = 1.0
    for axis, bound in ((0, width), (1, height)):
        if d[axis] > 0:
            tmin = min(tmin, (bound - p_in[axis]) / d[axis])
        elif d[axis] < 0:
            tmin = min(tmin, (0 - p_in[axis]) / d[axis])
    p = p_in + np.clip(tmin, 0, 1) * d
    return np.clip(p, [0, 0], [width, height])


def execute_official_evaluator(exec_path, label_path, result_path,
                               output_path, model_name=None,
                               show_output=True):
    """Run the compiled KITTI devkit evaluator over dumped results
    (reference object.py:359-397)."""
    import shutil
    import subprocess
    import tempfile

    model_name = model_name or "noname"
    temp_path = Path(tempfile.mkdtemp())
    temp_label = temp_path / "data" / "object"
    temp_result = temp_path / "results" / model_name
    temp_label.mkdir(parents=True, exist_ok=True)
    temp_result.mkdir(parents=True, exist_ok=True)
    output_path = Path(output_path)
    output_path.mkdir(parents=True, exist_ok=True)
    try:
        (temp_label / "label_2").symlink_to(label_path,
                                            target_is_directory=True)
        (temp_result / "data").symlink_to(result_path,
                                          target_is_directory=True)
        proc = subprocess.Popen(
            [exec_path, model_name], cwd=temp_path,
            stdout=None if show_output else subprocess.PIPE)
        proc.wait()
        for entry in temp_result.iterdir():
            if entry.name != "data":
                shutil.move(str(entry), output_path)
    finally:
        shutil.rmtree(temp_path)


def create_submission(result_path, output_file):
    """Zip dumped detection outputs into a KITTI submission archive."""
    out = Path(output_file)
    if out.suffix != ".zip":
        out = out.parent / (out.name + ".zip")
    out.parent.mkdir(exist_ok=True, parents=True)
    with zipfile.ZipFile(out, "w", compression=zipfile.ZIP_DEFLATED) as ar:
        for file in Path(result_path).iterdir():
            ar.write(file, file.name)
    print("Submission file created at", out)


def parse_detection_output():
    """CLI: convert KITTI detection text outputs into dumped Target3DArray
    files (registered as a console script)."""
    from argparse import ArgumentParser

    from tqdm import tqdm

    parser = ArgumentParser(
        description="Convert detection output to dumped d3d object arrays.")
    parser.add_argument("input", type=str)
    parser.add_argument("-o", "--output", type=str)
    parser.add_argument("-d", "--dataset-path", type=str, dest="dspath")
    parser.add_argument("-p", "--phase", type=str, default="training",
                        choices=["training", "testing"])
    parser.add_argument("-z", "--inzip", action="store_true")
    args = parser.parse_args()

    loader = KittiObjectLoader(args.dspath, inzip=args.inzip,
                               phase=args.phase, trainval_split=1)
    input_path = Path(args.input)
    output_path = Path(args.output or args.input)
    output_path.mkdir(parents=True, exist_ok=True)
    files = list(input_path.iterdir())
    for txt in tqdm(files):
        boxes = load_label(input_path, txt.relative_to(input_path))
        calib = loader.calibration_data(int(txt.stem), raw=True)
        parse_label(boxes, calib).dump(
            output_path / txt.with_suffix(".objs").name)



def evaluate_detection_results():
    """CLI: exact official KITTI metrics for a directory of KITTI-format
    detection text files (``%06d.txt``, the submission layout) against a
    dataset split — the native replacement for shelling out to the
    compiled devkit binary (reference object.py:359-397); registered as
    the ``d3d_tpu_torch_kitti_eval`` console script. The overlap matrices
    run on ``--device`` (default CUDA)."""
    from argparse import ArgumentParser

    from tqdm import tqdm

    from ...benchmarks_kitti import kitti_official_summary

    parser = ArgumentParser(
        description="Official KITTI detection metrics, computed natively.")
    parser.add_argument("dataset", type=str, help="KITTI object root")
    parser.add_argument("results", type=str,
                        help="directory of %%06d.txt detection files")
    parser.add_argument("--classes", default="Car,Pedestrian,Cyclist")
    parser.add_argument("--metrics", default="bev,3d",
                        help="comma list from 2d,bev,3d")
    parser.add_argument("--aos", action="store_true")
    parser.add_argument("--inzip", action="store_true")
    parser.add_argument("--phase", default="training")
    parser.add_argument("--split", type=float, default=0.8,
                        help="trainval split passed to the loader; the "
                             "VALIDATION part is evaluated")
    parser.add_argument("--device", default=None,
                        help="where the overlaps are computed (default "
                             "cuda; cpu runs without a card)")
    args = parser.parse_args()

    loader = KittiObjectLoader(args.dataset, inzip=args.inzip,
                               phase="validation"
                               if args.phase == "training" else args.phase,
                               trainval_split=args.split)
    results = Path(args.results)
    gts, dts = [], []
    for i in tqdm(range(len(loader)), unit="frames"):
        uidx = loader._parse_idx(i)
        gts.append(loader.annotation_3dobject(i))
        raw_calib = loader.calibration_data(i, raw=True)
        fname = results / ("%06d.txt" % uidx)
        if fname.exists():
            dts.append(parse_label(load_label(results, fname.name),
                                   raw_calib))
        else:
            arr = Target3DArray(frame="velo")
            arr.dontcare = np.zeros((0, 4))
            dts.append(arr)

    classes = [KittiObjectClass[c] for c in args.classes.split(",")]
    text, _ = kitti_official_summary(
        gts, dts, classes, metrics=tuple(args.metrics.split(",")),
        compute_aos=args.aos, device=args.device)
    print(text)

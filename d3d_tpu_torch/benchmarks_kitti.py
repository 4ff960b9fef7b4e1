"""KITTI object-benchmark conveniences: official difficulty stratification
on top of the generic evaluators (port of ``d3d_tpu.benchmarks_kitti``).

The reference devkit ships the generic DetectionEvaluator and leaves the
KITTI protocol (easy/moderate/hard strata by 2D box height, occlusion and
truncation — cvlibs.net object benchmark rules) to downstream scripts;
this module closes that gap:

  * :func:`kitti_difficulty` — per-object difficulty per the official
    thresholds (0 easy / 1 moderate / 2 hard / -1 ignored);
  * :func:`evaluate_by_difficulty` — run a (device-batched) evaluation
    per stratum over a list of frames, where each stratum keeps the GT of
    easier-or-equal difficulty (official cumulative protocol) and returns
    one evaluator per stratum, ready for ``ap()`` / ``summary()``;
  * :func:`evaluate_kitti_official` / :func:`kitti_official_summary` — the
    devkit's exact AP_R11 / AP_R40 (and AOS) protocol. Its overlap
    matrices come from :mod:`d3d_tpu_torch.ops.geometry_soa` on ``device``
    (default CUDA; raises without it unless ``device="cpu"``), in float64;
    the matching is host numpy.
"""

import numpy as np

from .abstraction import Target3DArray

__all__ = ["kitti_difficulty", "evaluate_by_difficulty",
           "evaluate_kitti_official", "kitti_official_summary",
           "DIFFICULTY_NAMES"]

DIFFICULTY_NAMES = ("easy", "moderate", "hard")

# official thresholds: min 2D box height (px), max occlusion state,
# max truncation
_MIN_HEIGHT = (40.0, 25.0, 25.0)
_MAX_OCCLUSION = (0, 1, 2)
_MAX_TRUNCATION = (0.15, 0.30, 0.50)


def kitti_difficulty(box_height, occluded, truncated):
    """Official KITTI difficulty of one ground-truth object.

    :param box_height: 2D bounding-box height in pixels
    :param occluded: occlusion state 0..3
    :param truncated: truncation fraction 0..1
    :returns: 0 easy / 1 moderate / 2 hard, or -1 when the object fails
        even the hard criteria (ignored by the benchmark)
    """
    for level in range(3):
        if (box_height >= _MIN_HEIGHT[level]
                and occluded <= _MAX_OCCLUSION[level]
                and truncated <= _MAX_TRUNCATION[level]):
            return level
    return -1


def _gt_difficulties(gt_arrays, difficulty_fn):
    out = []
    for arr in gt_arrays:
        out.append(np.asarray([difficulty_fn(obj) for obj in arr],
                              dtype=np.int64))
    return out


def evaluate_by_difficulty(evaluator_factory, gt_arrays, dt_arrays,
                           difficulty_fn=None, device=True):
    """Evaluate per KITTI difficulty stratum.

    :param evaluator_factory: zero-arg callable returning a fresh
        DetectionEvaluator (one per stratum)
    :param gt_arrays: list of GT Target3DArray per frame
    :param dt_arrays: list of detection Target3DArray per frame
    :param difficulty_fn: ``obj -> difficulty``; defaults to reading
        ``obj.aux['difficulty']`` if present, else
        :func:`kitti_difficulty` over ``aux`` fields ``box_height`` /
        ``occluded`` / ``truncated`` (KITTI loaders populate aux from the
        label files)
    :param device: evaluate with the batched device evaluator (on the
        evaluator's own device)
    :returns: dict difficulty-name -> evaluator (stats accumulated).
        Stratum ``d`` counts every GT with difficulty in [0, d]
        (cumulative); harder and invalid (-1) GT are passed as IGNORE —
        they stay matchable so a detection on one counts neither TP nor
        FP. (For the full devkit protocol including DontCare 2D regions
        and neighboring-class absorption use
        :func:`evaluate_kitti_official` — the loader keeps the DontCare
        boxes on ``arr.dontcare``.)
    """
    if difficulty_fn is None:
        def difficulty_fn(obj):
            aux = obj.aux or {}
            if "difficulty" in aux:
                return int(aux["difficulty"])
            return kitti_difficulty(aux.get("box_height", np.inf),
                                    aux.get("occluded", 0),
                                    aux.get("truncated", 0.0))

    diffs = _gt_difficulties(gt_arrays, difficulty_fn)
    out = {}
    for level, name in enumerate(DIFFICULTY_NAMES):
        ev = evaluator_factory()
        ignored = [~((d >= 0) & (d <= level)) for d in diffs]
        if device:
            from .benchmarks_device import device_calc_stats

            ev.add_stats(device_calc_stats(ev, list(gt_arrays),
                                           list(dt_arrays),
                                           gt_ignored=ignored))
        else:
            for g, dt, ig in zip(gt_arrays, dt_arrays, ignored):
                ev.add_stats(ev.calc_stats(g, dt, gt_ignored=ig))
        out[name] = ev
    return out


# ---------------------------------------------------------------------------
# exact official KITTI protocol (devkit eval.cpp semantics, natively)
# ---------------------------------------------------------------------------

N_SAMPLE_PTS = 41
# neighboring classes absorbed as "similar" (devkit cleanData): detections
# on them are neither TP nor FP
NEIGHBOR_CLASSES = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}


def _clean_data(gt_arr, dt_arr, current_class, difficulty):
    """Devkit ``cleanData``: per-gt 0 (counted) / 1 (similar or too hard,
    absorbs silently) / -1 (other class, invisible); per-det 0 (evaluated)
    / 1 (2D box too small) / -1 (other class); counted-gt total."""
    cname = getattr(current_class, "name", str(current_class))
    neighbors = NEIGHBOR_CLASSES.get(cname, ())

    ignored_gt = []
    n_gt = 0
    for obj in gt_arr:
        aux = obj.aux or {}
        tname = getattr(obj.tag_top, "name", str(obj.tag.labels[0]))
        if tname == cname:
            valid_class = 1
        elif tname in neighbors:
            valid_class = 0
        else:
            valid_class = -1
        height = aux.get("box_height", np.inf)
        ignore = (aux.get("occluded", 0) > _MAX_OCCLUSION[difficulty]
                  or aux.get("truncated", 0.0) > _MAX_TRUNCATION[difficulty]
                  or height <= _MIN_HEIGHT[difficulty])
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            n_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)

    ignored_det = []
    for obj in dt_arr:
        aux = obj.aux or {}
        tname = getattr(obj.tag_top, "name", str(obj.tag.labels[0]))
        bbox = aux.get("bbox")
        height = (bbox[3] - bbox[1]) if bbox is not None \
            else aux.get("box_height", np.inf)
        if height < _MIN_HEIGHT[difficulty]:
            ignored_det.append(1)
        elif tname == cname:
            ignored_det.append(0)
        else:
            ignored_det.append(-1)
    return np.array(ignored_gt, int), np.array(ignored_det, int), n_gt


def _overlap_matrix(dt_arr, gt_arr, metric, device=None):
    """(D, G) overlap matrix on ``device`` (default CUDA), float64: TRUE
    VOLUME 3D rotated IoU (devkit ``d3DBoxOverlap``: inter_vol / (v1 + v2 -
    inter_vol) — NOT the framework's box3dr product of BEV and z IoUs,
    which understates overlap whenever both the footprint and the z
    interval partially overlap) or BEV rotated IoU (``groundBoxOverlap``),
    criterion = union. The 2d metric is host numpy."""
    from .ops.geometry_soa import intersect_area, rbox_iou
    from .utils import as_tensor

    if len(dt_arr) == 0 or len(gt_arr) == 0:
        return np.zeros((len(dt_arr), len(gt_arr)))
    if metric == "2d":
        # axis-aligned image-plane IoU over the aux 2D boxes (devkit
        # boxoverlap, criterion union); objects without a bbox overlap 0
        def boxes2d(arr):
            out = np.zeros((len(arr), 4))
            ok = np.zeros(len(arr), bool)
            for i, o in enumerate(arr):
                bb = (o.aux or {}).get("bbox")
                if bb is not None:
                    out[i] = bb
                    ok[i] = True
            return out, ok

        db, dok = boxes2d(dt_arr)
        gb, gok = boxes2d(gt_arr)
        x1 = np.maximum(db[:, None, 0], gb[None, :, 0])
        y1 = np.maximum(db[:, None, 1], gb[None, :, 1])
        x2 = np.minimum(db[:, None, 2], gb[None, :, 2])
        y2 = np.minimum(db[:, None, 3], gb[None, :, 3])
        inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
        da = (db[:, 2] - db[:, 0]) * (db[:, 3] - db[:, 1])
        ga = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1])
        union = da[:, None] + ga[None, :] - inter
        with np.errstate(invalid="ignore", divide="ignore"):
            iou = np.where(union > 0, inter / union, 0.0)
        return np.where(dok[:, None] & gok[None, :], iou, 0.0)

    d7 = dt_arr.boxes7()
    g7 = gt_arr.boxes7()
    bev = lambda b: as_tensor(  # noqa: E731
        np.concatenate([b[:, 0:2], b[:, 3:5], b[:, 6:7]], 1), device)
    if metric == "3d":
        b1 = bev(d7)[:, None, :]
        b2 = bev(g7)[None, :, :]
        inter_area = intersect_area(b1, b2).cpu().numpy()
        zlo = np.maximum(d7[:, None, 2] - d7[:, None, 5] / 2,
                         g7[None, :, 2] - g7[None, :, 5] / 2)
        zhi = np.minimum(d7[:, None, 2] + d7[:, None, 5] / 2,
                         g7[None, :, 2] + g7[None, :, 5] / 2)
        vi = inter_area * np.clip(zhi - zlo, 0, None)
        v1 = np.prod(d7[:, 3:6], axis=1)
        v2 = np.prod(g7[:, 3:6], axis=1)
        union = v1[:, None] + v2[None, :] - vi
        with np.errstate(invalid="ignore", divide="ignore"):
            m = np.where(union > 0, vi / union, 0.0)
    elif metric == "bev":
        m = rbox_iou(bev(d7)[:, None, :], bev(g7)[None, :, :]).cpu().numpy()
    else:
        raise ValueError("metric must be '2d', 'bev' or '3d'")
    return np.asarray(m)


def _dc_overlap(det_bbox, dc_box):
    """Devkit dontcare test: 2D intersection over DET area (criterion 0)."""
    if det_bbox is None:
        return 0.0
    x1 = max(det_bbox[0], dc_box[0])
    y1 = max(det_bbox[1], dc_box[1])
    x2 = min(det_bbox[2], dc_box[2])
    y2 = min(det_bbox[3], dc_box[3])
    w, h = x2 - x1, y2 - y1
    if w <= 0 or h <= 0:
        return 0.0
    area = (det_bbox[2] - det_bbox[0]) * (det_bbox[3] - det_bbox[1])
    return w * h / area if area > 0 else 0.0


_NO_DETECTION = -1e9


def _compute_statistics(overlap, scores, ignored_gt, ignored_det,
                        det_bboxes, dc_boxes, min_overlap, compute_fp,
                        thresh, gt_alphas=None, dt_alphas=None):
    """Devkit ``computeStatistics`` over a precomputed overlap matrix.

    :returns: (tp, fp, fn, tp_scores, similarity_sum) — similarity is the
        AOS numerator sum((1 + cos(alpha_gt - alpha_dt)) / 2) over TPs
        (NaN-free only when both alpha vectors are supplied)
    """
    nd = len(scores)
    assigned = np.zeros(nd, bool)
    ignored_threshold = np.zeros(nd, bool)
    if compute_fp:
        ignored_threshold = scores < thresh

    tp = fp = fn = 0
    similarity = 0.0
    tp_scores = []
    for i in range(len(ignored_gt)):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = _NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(nd):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            ov = overlap[j, i]
            if not compute_fp and ov > min_overlap \
                    and scores[j] > valid_detection:
                det_idx = j
                valid_detection = scores[j]
            elif compute_fp and ov > min_overlap \
                    and (ov > max_overlap or assigned_ignored_det) \
                    and ignored_det[j] == 0:
                max_overlap = ov
                det_idx = j
                valid_detection = 1.0
                assigned_ignored_det = False
            elif compute_fp and ov > min_overlap \
                    and valid_detection == _NO_DETECTION \
                    and ignored_det[j] == 1:
                det_idx = j
                valid_detection = 1.0
                assigned_ignored_det = True

        if valid_detection == _NO_DETECTION and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != _NO_DETECTION \
                and (ignored_gt[i] == 1 or ignored_det[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != _NO_DETECTION:
            tp += 1
            tp_scores.append(scores[det_idx])
            if gt_alphas is not None and dt_alphas is not None:
                delta = gt_alphas[i] - dt_alphas[det_idx]
                similarity += (1.0 + np.cos(delta)) / 2.0
            assigned[det_idx] = True

    if compute_fp:
        for j in range(nd):
            if not (assigned[j] or ignored_det[j] in (-1, 1)
                    or ignored_threshold[j]):
                fp += 1
        nstuff = 0
        for dc in dc_boxes:
            for j in range(nd):
                if assigned[j] or ignored_det[j] in (-1, 1) \
                        or ignored_threshold[j]:
                    continue
                if _dc_overlap(det_bboxes[j], dc) > min_overlap:
                    assigned[j] = True
                    nstuff += 1
        fp -= nstuff
    return tp, fp, fn, tp_scores, similarity


def _get_thresholds(tp_scores, n_gt):
    """Devkit ``getThresholds``: score thresholds at the 41 recall
    sample positions."""
    v = np.sort(np.asarray(tp_scores))[::-1]
    thresholds = []
    current_recall = 0.0
    for i in range(len(v)):
        l_recall = (i + 1) / n_gt
        r_recall = (i + 2) / n_gt if i < len(v) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) \
                and i < len(v) - 1:
            continue
        thresholds.append(v[i])
        current_recall += 1.0 / (N_SAMPLE_PTS - 1)
    return thresholds


def evaluate_kitti_official(gt_arrays, dt_arrays, current_class,
                            difficulty=1, metric="3d", min_overlap=0.7,
                            dontcare=None, compute_aos=False,
                            overlaps=None, device=None):
    """Exact official KITTI AP for one class and difficulty.

    Native reimplementation of the devkit ``eval.cpp`` pipeline the
    reference shells out to (reference object.py:359-397): cleanData
    class/difficulty gating with neighboring-class and too-hard gt
    absorbing detections silently, the two-phase greedy matching
    (max-score pass to collect TP scores, max-overlap pass per
    threshold), DontCare-region FP suppression on the image plane, the
    41-point recall-sampled precision curve with right-max
    monotonization, and both AP_R11 (legacy, every 4th point) and
    AP_R40 (mean of points 1..40).

    :param gt_arrays: per-frame GT Target3DArray (KITTI loader output:
        ``aux`` carries bbox/occluded/truncated, ``dontcare`` the 2D
        ignore regions)
    :param dt_arrays: per-frame detections; ``aux['bbox']`` (projected
        2D box) enables the det-height gate and DontCare suppression
    :param metric: "3d" (rotated 3D IoU), "bev", or "2d" (image-plane
        axis-aligned IoU over ``aux['bbox']`` — the official 2D benchmark)
    :param dontcare: optional per-frame (K, 4) arrays overriding
        ``gt_arr.dontcare``
    :param compute_aos: also compute average orientation similarity from
        ``aux['alpha']`` observation angles (officially paired with the
        2D metric); adds ``aos_r40`` / ``aos_r11`` / ``aos`` outputs
    :param overlaps: optional per-frame (D, G) overlap matrices — they
        depend only on the metric, so multi-class/difficulty sweeps
        (:func:`kitti_official_summary`) compute them once per metric
    :param device: where the overlap matrices are computed (default CUDA)
    :returns: dict(ap_r40, ap_r11, precision (41,), thresholds,
        n_gt, tp/fp/fn arrays per threshold[, aos fields])
    """
    frames = []
    total_tp_scores = []
    total_n_gt = 0
    for fi, (gt_arr, dt_arr) in enumerate(zip(gt_arrays, dt_arrays)):
        ig, idt, n_gt = _clean_data(gt_arr, dt_arr, current_class,
                                    difficulty)
        overlap = (overlaps[fi] if overlaps is not None
                   else _overlap_matrix(dt_arr, gt_arr, metric, device))
        scores = np.array([float(o.tag.scores[0]) for o in dt_arr])
        det_bboxes = [(o.aux or {}).get("bbox") for o in dt_arr]
        if dontcare is not None:
            dc = np.asarray(dontcare[fi]).reshape(-1, 4)
        else:
            dc = np.asarray(getattr(gt_arr, "dontcare",
                                    np.zeros((0, 4)))).reshape(-1, 4)
        galpha = dalpha = None
        if compute_aos:
            galpha = np.array([(o.aux or {}).get("alpha", 0.0)
                               for o in gt_arr])
            dalpha = np.array([(o.aux or {}).get("alpha", 0.0)
                               for o in dt_arr])
        frames.append((overlap, scores, ig, idt, det_bboxes, dc,
                       galpha, dalpha))
        total_n_gt += n_gt
        _, _, _, tps, _ = _compute_statistics(
            overlap, scores, ig, idt, det_bboxes, dc, min_overlap,
            compute_fp=False, thresh=0.0)
        total_tp_scores.extend(tps)

    precision = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    tps = np.zeros(N_SAMPLE_PTS, int)
    fps = np.zeros(N_SAMPLE_PTS, int)
    fns = np.zeros(N_SAMPLE_PTS, int)
    thresholds = _get_thresholds(total_tp_scores, total_n_gt) \
        if total_n_gt > 0 else []
    for ti, t in enumerate(thresholds):
        tp = fp = fn = 0
        sim = 0.0
        for overlap, scores, ig, idt, det_bboxes, dc, ga, da in frames:
            a, b, c, _, s_ = _compute_statistics(
                overlap, scores, ig, idt, det_bboxes, dc, min_overlap,
                compute_fp=True, thresh=t, gt_alphas=ga, dt_alphas=da)
            tp += a
            fp += b
            fn += c
            sim += s_
        tps[ti], fps[ti], fns[ti] = tp, fp, fn
        precision[ti] = tp / (tp + fp) if tp + fp > 0 else 0.0
        # devkit: AOS numerator over the same tp+fp denominator
        aos[ti] = sim / (tp + fp) if tp + fp > 0 else 0.0

    # right-max monotonization (devkit does this for the final curve)
    for i in range(N_SAMPLE_PTS):
        precision[i] = precision[i:].max()
        aos[i] = aos[i:].max()

    ap_r11 = float(np.mean(precision[0::4]))
    ap_r40 = float(np.mean(precision[1:]))
    out = dict(ap_r40=ap_r40, ap_r11=ap_r11, precision=precision,
               thresholds=thresholds, n_gt=total_n_gt,
               tp=tps, fp=fps, fn=fns)
    if compute_aos:
        out.update(aos=aos, aos_r40=float(np.mean(aos[1:])),
                   aos_r11=float(np.mean(aos[0::4])))
    return out


# per-class official minimum overlaps (devkit: cars 0.7, people/cyclists 0.5)
OFFICIAL_MIN_OVERLAP = {"Car": 0.7, "Van": 0.7, "Truck": 0.7}
_DEFAULT_MIN_OVERLAP = 0.5


def kitti_official_summary(gt_arrays, dt_arrays, classes,
                           metrics=("bev", "3d"), compute_aos=False,
                           min_overlaps=None, device=None):
    """The familiar official results table: AP_R40 per class x metric x
    difficulty (plus AOS when requested, paired with the 2d metric).

    :param classes: class enum members (e.g. ``[KittiObjectClass.Car]``)
    :param metrics: any of "2d", "bev", "3d"
    :param min_overlaps: optional {class-or-name: overlap} overriding the
        official 0.7 (cars) / 0.5 defaults
    :param device: where the overlap matrices are computed (default CUDA)
    :returns: (text, results) where results[cls][metric][difficulty] is
        the :func:`evaluate_kitti_official` dict
    """
    results = {}
    lines = []
    overlap_cache = {}
    gt_arrays = list(gt_arrays)
    dt_arrays = list(dt_arrays)
    for cls in classes:
        cname = getattr(cls, "name", str(cls))
        mo = _DEFAULT_MIN_OVERLAP
        mo = OFFICIAL_MIN_OVERLAP.get(cname, mo)
        if min_overlaps:
            mo = min_overlaps.get(cls, min_overlaps.get(cname, mo))
        results[cls] = {}
        for metric in metrics:
            # the overlap matrices depend only on the metric: compute once
            # and share across the class x difficulty sweep
            if metric not in overlap_cache:
                overlap_cache[metric] = [
                    _overlap_matrix(d, g, metric, device)
                    for d, g in zip(dt_arrays, gt_arrays)]
            ov = overlap_cache[metric]
            per_diff = {}
            for difficulty in range(3):
                per_diff[difficulty] = evaluate_kitti_official(
                    gt_arrays, dt_arrays, cls, difficulty=difficulty,
                    metric=metric, min_overlap=mo,
                    compute_aos=compute_aos and metric == "2d",
                    overlaps=ov)
            results[cls][metric] = per_diff
            aps = [per_diff[d]["ap_r40"] * 100 for d in range(3)]
            lines.append(
                f"{cname} {metric.upper():>3} AP_R40@{mo:.2f}: "
                f"{aps[0]:6.2f} {aps[1]:6.2f} {aps[2]:6.2f}")
            if compute_aos and metric == "2d":
                aoss = [per_diff[d]["aos_r40"] * 100 for d in range(3)]
                lines.append(
                    f"{cname}     AOS_R40@{mo:.2f}: "
                    f"{aoss[0]:6.2f} {aoss[1]:6.2f} {aoss[2]:6.2f}")
    header = "class metric           easy    mod   hard"
    return "\n".join([header] + lines), results

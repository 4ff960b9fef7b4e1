"""The detection and tracking evaluators (port of the detection and tracking
halves of ``d3d_tpu.benchmarks``; reference d3d/benchmarks.pyx).

The reference keeps per-class C++ hashmaps of per-threshold vectors and
fills the DT x GT rotated-IoU matrix with a scalar nogil loop; here every
per-(class, threshold) counter is a dense numpy vector (so merging partial
stats is pure `+`/weighted-mean) and the IoU matrix comes from one batched
call on the evaluator's ``device`` (``ScoreMatcher.prepare_boxes``: CUDA
unless the caller passes ``device="cpu"``). The greedy per-threshold
re-matching is tiny host bookkeeping over ids and stays in Python, exactly
reproducing the reference's assignment semantics.

The tracking evaluator (CLEAR-MOT / AMOTA) keeps the JAX module's host
bookkeeping in numpy; its ``device_match`` path and its sequence scan
(``calc_stats_sequence``) compute the matching tables and the greedy
matches with :mod:`d3d_tpu_torch.benchmarks_device` on the evaluator's
device, one fetch a chunk of frames. The segmentation evaluator
(semantic and panoptic) is host numpy, as the JAX module's; its batched
counterparts are :func:`~d3d_tpu_torch.benchmarks_device.device_semantic_stats`
and :func:`~d3d_tpu_torch.benchmarks_device.device_panoptic_stats`.
"""

from enum import Enum

import numpy as np
import scipy.stats as sps

from .abstraction import Target3DArray, TransformSet
from .ops.special import quatdiff
from .tracking.matcher import DistanceTypes, ScoreMatcher

__all__ = [
    "DetectionEvalStats",
    "DetectionEvaluator",
    "TrackingEvalStats",
    "TrackingEvaluator",
    "SegmentationStats",
    "SegmentationEvaluator",
]

# numpy 2 renamed trapz
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _calc_precision(tp, fp):
    return 1.0 if fp == 0 else tp / (tp + fp)


def _calc_recall(tp, fn):
    return 1.0 if fn == 0 else tp / (tp + fn)


def _calc_fscore(tp, fp, fn, b2):
    # empty class (tp = fp = fn = 0): precision = recall = 1 by the
    # conventions above, so the fscore is 1 as well (not 0/0)
    denom = (1 + b2) * tp + b2 * fn + fp
    return 1.0 if denom == 0 else (1 + b2) * tp / denom


class DetectionEvalStats:
    """Detection statistics of one evaluation step: per class value, dense
    per-threshold vectors (reference benchmarks.pyx:60-84)."""

    def __init__(self, classes=(), nsamples=0):
        self.ngt = {k: 0 for k in classes}
        self.ndt = {k: np.zeros(nsamples, int) for k in classes}
        self.tp = {k: np.zeros(nsamples, int) for k in classes}
        self.fp = {k: np.zeros(nsamples, int) for k in classes}
        self.fn = {k: np.zeros(nsamples, int) for k in classes}
        self.acc_iou = {k: np.full(nsamples, np.nan) for k in classes}
        self.acc_angular = {k: np.full(nsamples, np.nan) for k in classes}
        self.acc_dist = {k: np.full(nsamples, np.nan) for k in classes}
        self.acc_box = {k: np.full(nsamples, np.nan) for k in classes}
        self.acc_var = {k: np.full(nsamples, np.nan) for k in classes}

    def as_object(self):
        return dict(ngt=self.ngt, tp=self.tp, fp=self.fp, fn=self.fn,
                    ndt=self.ndt, acc_iou=self.acc_iou,
                    acc_angular=self.acc_angular, acc_dist=self.acc_dist,
                    acc_box=self.acc_box, acc_var=self.acc_var)


class DetectionEvaluator:
    """Object detection benchmark; association by descending score
    (reference benchmarks.pyx:87-446).

    :param classes: classes (Enum members) to consider
    :param min_overlaps: min rotated-3D-IoU per class (scalar or list)
    :param pr_sample_count: number of precision/recall sample thresholds
    :param min_score: minimum score threshold
    :param pr_sample_scale: "lin" or "logX" spacing of score thresholds
    :param device: where each frame's IoU matrix is computed (default
        CUDA; raises without it unless ``device="cpu"``)
    """

    def __init__(self, classes, min_overlaps, pr_sample_count=40,
                 min_score=0.0, pr_sample_scale="log10",
                 distance_metric=DistanceTypes.RIoU, device=None):
        if isinstance(classes, (list, tuple)):
            assert len(classes) > 0
            self._class_type = type(classes[0])
            self._classes = [c.value for c in classes]
        else:
            self._class_type = type(classes)
            self._classes = [classes.value]
        self._class_to_idx = {v: i for i, v in enumerate(self._classes)}
        self._distance_metric = distance_metric
        self._device = device
        # RIoU/IoU metrics: thresholds are MIN overlaps (distance = 1-IoU);
        # Position metric (the nuScenes protocol): thresholds are MAX
        # center distances in meters, used directly
        if distance_metric == DistanceTypes.Position:
            conv = lambda v: float(v)  # noqa: E731
        else:
            conv = lambda v: 1 - v  # noqa: E731
        if isinstance(min_overlaps, (list, tuple)):
            self._max_distance = {classes[i].value: conv(v)
                                  for i, v in enumerate(min_overlaps)}
        elif isinstance(min_overlaps, (int, float)):
            self._max_distance = {c: conv(min_overlaps)
                                  for c in self._classes}
        else:
            raise ValueError("min_overlaps should be a list or a single value")

        self._pr_nsamples = pr_sample_count
        self._min_score = min_score

        if pr_sample_scale == "lin":
            thresholds = np.linspace(min_score, 1, pr_sample_count,
                                     endpoint=False, dtype=np.float32)
        elif pr_sample_scale.startswith("log"):
            logstart, logend = 1, int(pr_sample_scale[3:] or "10")
            thresholds = np.geomspace(logstart, logend, pr_sample_count + 1,
                                      dtype=np.float32)
            thresholds = (thresholds - logstart) * (1 - min_score) / (logend - logstart)
            thresholds = (1 - thresholds)[:0:-1]
        else:
            raise ValueError("Unrecognized PR sample type")
        self._pr_thresholds = np.asarray(thresholds)

        self._stats = DetectionEvalStats(self._classes, self._pr_nsamples)

    def reset(self):
        self._stats = DetectionEvalStats(self._classes, self._pr_nsamples)

    # -- per-frame statistics -----------------------------------------------
    _ACC_NAMES = ("acc_iou", "acc_dist", "acc_box", "acc_angular", "acc_var")

    def _aggregate_stats(self, acc_vals, gt_tags=None, tag_ids=None):
        """Mean accuracy per (class, threshold) for every accuracy metric
        at once; ``acc_vals`` is an (S, G, 5) array with the
        :meth:`_accuracy_entries` columns (iou, dist, box, angular, var)
        and NaN marking absent (non-TP) entries. Classes come either from
        raw tag values (``gt_tags``) or pre-mapped class indices
        (``tag_ids``). Returns ``{metric_name: {class: (S,) means}}`` —
        one masked reduction per class instead of the reference's
        per-threshold dict scans (benchmarks.pyx:149-174)."""
        S = self._pr_nsamples
        out = {n: {k: np.full(S, np.nan) for k in self._classes}
               for n in self._ACC_NAMES}
        if acc_vals.shape[1]:
            # all 5 columns are set together; var may be -inf (propagates
            # through the sum exactly like the scalar accumulation did)
            valid = ~np.isnan(acc_vals[:, :, 0])
            vals = np.where(valid[:, :, None], acc_vals, 0.0)
            tags = tag_ids if tag_ids is not None else np.array(
                [self._class_to_idx.get(t, -1) for t in gt_tags])
            for ki, k in enumerate(self._classes):
                sel = tags == ki
                if not sel.any():
                    continue
                counts = valid[:, sel].sum(axis=1)
                sums = vals[:, sel, :].sum(axis=1)
                nz = counts > 0
                for vi, n in enumerate(self._ACC_NAMES):
                    out[n][k][nz] = sums[nz, vi] / counts[nz]
        return out

    def _accuracy_table(self, gt_boxes, dt_boxes, dj, g, ious):
        """(P, 5) accuracy entries for P matched (dt, gt) index pairs in
        one batch over the columnar storage: the norms and quaternion
        angles vectorize (same f32 row arithmetic as the object-wise
        :meth:`_accuracy_entries`); only pairs carrying an orientation
        variance fall back to the per-pair scipy logpdfs."""
        gc, dc = gt_boxes.columns(), dt_boxes.columns()
        dist = np.linalg.norm(gc["position"][g] - dc["position"][dj],
                              axis=-1).astype(np.float64)
        box = np.linalg.norm(gc["dimension"][g] - dc["dimension"][dj],
                             axis=-1).astype(np.float64)
        gq = gc["quat"][g].astype(np.float64)
        dq = dc["quat"][dj].astype(np.float64)
        gq /= np.linalg.norm(gq, axis=-1, keepdims=True)
        dq /= np.linalg.norm(dq, axis=-1, keepdims=True)
        ang = np.atleast_1d(quatdiff(gq, dq))
        var = np.full(len(dj), -np.inf)
        ovar = dc["orientation_var"][dj]
        for p in np.nonzero(ovar > 0)[0]:
            j, gi = dj[p], g[p]
            try:  # singular covariance -> "no uncertainty estimate" (-inf),
                v = sps.multivariate_normal.logpdf(
                    gc["position"][gi], dc["position"][j],
                    cov=dc["position_var"][j])
                v += sps.multivariate_normal.logpdf(
                    gc["dimension"][gi], dc["dimension"][j],
                    cov=dc["dimension_var"][j])
                var[p] = v + sps.vonmises.logpdf(ang[p], kappa=1 / ovar[p])
            except np.linalg.LinAlgError:
                pass  # var[p] stays -inf, matching _accuracy_entries
        return np.stack([np.asarray(ious, np.float64), dist, box,
                         ang / np.pi, var], axis=1)

    def _accuracy_entries(self, gt_box, dt_box, iou):
        dist = float(np.linalg.norm(gt_box.position - dt_box.position))
        box = float(np.linalg.norm(gt_box.dimension - dt_box.dimension))
        ang = quatdiff(gt_box.orientation.as_quat(), dt_box.orientation.as_quat())
        if dt_box.orientation_var > 0:
            # the reference guards only orientation_var and lets scipy
            # raise on a singular position/dimension covariance
            # (benchmarks.pyx:259-265); here a degenerate covariance reads
            # as "no uncertainty estimate" -> -inf, same as ovar == 0
            try:
                var = sps.multivariate_normal.logpdf(
                    gt_box.position, dt_box.position,
                    cov=dt_box.position_var)
                var += sps.multivariate_normal.logpdf(
                    gt_box.dimension, dt_box.dimension,
                    cov=dt_box.dimension_var)
                var += sps.vonmises.logpdf(
                    ang, kappa=1 / dt_box.orientation_var)
            except np.linalg.LinAlgError:
                var = -np.inf
        else:
            var = -np.inf
        return iou, dist, box, ang / np.pi, var

    def calc_stats(self, gt_boxes: Target3DArray, dt_boxes: Target3DArray,
                   calib: TransformSet = None, gt_ignored=None):
        """Evaluate one frame; returns a mergeable DetectionEvalStats.

        :param gt_ignored: optional boolean per-GT mask — ignored objects
            participate in matching (absorbing detections) but count
            neither TP nor FN, and a detection matched to one is NOT a
            false positive. This is the KITTI DontCare / harder-stratum
            IGNORE semantic.
        """
        if gt_boxes.frame != dt_boxes.frame:
            if calib is None:
                raise ValueError("Calibration is not provided when dt_boxes "
                                 "and gt_boxes are in different frames!")
            gt_boxes = calib.transform_objects(gt_boxes, frame_to=dt_boxes.frame)

        matcher = ScoreMatcher()
        matcher.prepare_boxes(dt_boxes, gt_boxes, self._distance_metric,
                              device=self._device)

        summary = DetectionEvalStats(self._classes, self._pr_nsamples)
        acc_vals = np.full((self._pr_nsamples, len(gt_boxes), 5), np.nan)

        if gt_ignored is None:
            gt_ignored = np.zeros(len(gt_boxes), bool)
        gt_ignored = np.asarray(gt_ignored, bool)

        gt_indices = []
        for gt_idx, gt_box in enumerate(gt_boxes):
            gt_tag = gt_box.tag.labels[0]
            if gt_tag not in self._stats.ngt:
                continue
            if not gt_ignored[gt_idx]:
                summary.ngt[gt_tag] += 1
            gt_indices.append(gt_idx)

        # f32 like the reference's C float score storage (and the device
        # evaluator's packed scores) so threshold ties agree everywhere
        scores = np.asarray([b.tag.scores[0] for b in dt_boxes], np.float32)
        tags = [b.tag.labels[0] for b in dt_boxes]

        # accuracy entries depend only on the (dt, gt) pair, not the
        # threshold: run the scipy logpdfs once per pair (the reference
        # recomputes per threshold — its own flagged bottleneck,
        # benchmarks.pyx:259 FIXME)
        acc_cache = {}

        def acc_of(dt_idx, gt_idx, gt_box, dt_box, iou):
            key = (dt_idx, gt_idx)
            if key not in acc_cache:
                acc_cache[key] = self._accuracy_entries(gt_box, dt_box, iou)
            return acc_cache[key]

        for si, thres in enumerate(self._pr_thresholds):
            dt_indices = []
            for dt_idx, dt_box in enumerate(dt_boxes):
                if tags[dt_idx] not in self._stats.ngt:
                    continue
                if scores[dt_idx] < thres:
                    continue
                summary.ndt[tags[dt_idx]][si] += 1
                dt_indices.append(dt_idx)

            matcher.clear_match()
            matcher.match(dt_indices, gt_indices, self._max_distance)

            for gt_idx in gt_indices:
                if gt_ignored[gt_idx]:
                    # ignored gt absorb their matched detection (it will
                    # not be FP) but contribute no TP/FN/accuracy
                    continue
                gt_box = gt_boxes[gt_idx]
                gt_tag = gt_box.tag.labels[0]
                dt_idx = matcher.query_dst_match(gt_idx)
                if dt_idx < 0:
                    summary.fn[gt_tag][si] += 1
                    continue
                summary.tp[gt_tag][si] += 1
                dt_box = dt_boxes[dt_idx]
                iou = 1 - matcher._distance_cache[dt_idx, gt_idx]
                acc_vals[si, gt_idx] = acc_of(dt_idx, gt_idx,
                                              gt_box, dt_box, iou)

            for dt_idx in dt_indices:
                if matcher.query_src_match(dt_idx) < 0:
                    summary.fp[tags[dt_idx]][si] += 1

        gt_tags = [b.tag.labels[0] for b in gt_boxes]
        for name, per_class in self._aggregate_stats(acc_vals,
                                                     gt_tags).items():
            setattr(summary, name, per_class)
        return summary

    def add_stats(self, stats):
        """Merge a partial stats object into the accumulated database
        (associative -> multiprocess/multi-host friendly)."""
        s = self._stats
        for k in self._classes:
            s.ngt[k] += stats.ngt[k]
            otp = s.tp[k].astype(float)
            ntp = stats.tp[k].astype(float)
            with np.errstate(invalid="ignore"):
                for field in ("acc_angular", "acc_box", "acc_iou",
                              "acc_dist", "acc_var"):
                    old = getattr(s, field)[k]
                    new = np.asarray(getattr(stats, field)[k])
                    # vectorized wmean: zero-weight sides pass through, so
                    # NaN placeholders never poison the merge
                    merged = (old * otp + new * ntp) / np.maximum(
                        otp + ntp, 1.0)
                    merged = np.where(otp == 0, new, merged)
                    old[:] = np.where(ntp == 0,
                                      np.where(otp == 0, new, old), merged)
            s.ndt[k] += stats.ndt[k]
            s.tp[k] += stats.tp[k]
            s.fp[k] += stats.fp[k]
            s.fn[k] += stats.fn[k]

    def get_stats(self):
        return self._stats

    # -- metric queries ------------------------------------------------------
    def _get_score_idx(self, score):
        if score is None or (isinstance(score, float) and np.isnan(score)):
            return self._pr_nsamples // 2
        # clamp: a score above the top threshold (e.g. 1.0 with the log10
        # grid topping out at ~0.993) would index past the stat vectors
        return min(int(np.searchsorted(self._pr_thresholds, score,
                                       side="left")),
                   self._pr_nsamples - 1)

    @property
    def score_thresholds(self):
        return np.asarray(self._pr_thresholds)

    def gt_count(self):
        return dict(self._stats.ngt)

    def dt_count(self, score=None):
        si = self._get_score_idx(score)
        return {self._class_type(k): int(v[si]) for k, v in self._stats.ndt.items()}

    def tp(self, score=None):
        si = self._get_score_idx(score)
        return {self._class_type(k): int(v[si]) for k, v in self._stats.tp.items()}

    def fp(self, score=None):
        si = self._get_score_idx(score)
        return {self._class_type(k): int(v[si]) for k, v in self._stats.fp.items()}

    def fn(self, score=None):
        si = self._get_score_idx(score)
        return {self._class_type(k): int(v[si]) for k, v in self._stats.fn.items()}

    def precision(self, score=None, return_all=False):
        if return_all:
            return {self._class_type(k): [
                _calc_precision(self._stats.tp[k][i], self._stats.fp[k][i])
                for i in range(self._pr_nsamples)] for k in self._classes}
        si = self._get_score_idx(score)
        return {self._class_type(k): _calc_precision(
            self._stats.tp[k][si], self._stats.fp[k][si]) for k in self._classes}

    def recall(self, score=None, return_all=False):
        if return_all:
            return {self._class_type(k): [
                _calc_recall(self._stats.tp[k][i], self._stats.fn[k][i])
                for i in range(self._pr_nsamples)] for k in self._classes}
        si = self._get_score_idx(score)
        return {self._class_type(k): _calc_recall(
            self._stats.tp[k][si], self._stats.fn[k][si]) for k in self._classes}

    def fscore(self, score=None, beta=1, return_all=False):
        b2 = beta * beta
        if return_all:
            return {self._class_type(k): [
                _calc_fscore(self._stats.tp[k][i], self._stats.fp[k][i],
                             self._stats.fn[k][i], b2)
                for i in range(self._pr_nsamples)] for k in self._classes}
        si = self._get_score_idx(score)
        return {self._class_type(k): _calc_fscore(
            self._stats.tp[k][si], self._stats.fp[k][si],
            self._stats.fn[k][si], b2) for k in self._classes}

    def ap(self):
        """(Mean) average precision: area under the PR curve."""
        p = self.precision(return_all=True)
        r = self.recall(return_all=True)
        return {k: -_trapezoid(p[k], r[k])
                for k in (self._class_type(c) for c in self._classes)}

    def aph(self):
        """Heading-weighted average precision — the Waymo Open Dataset
        companion metric to AP (Sun et al., "Scalability in Perception
        for Autonomous Driving: Waymo Open Dataset", CVPR 2020): every
        TP contributes ``1 - |dtheta| / pi`` instead of 1, where
        ``dtheta`` is the matched pair's wrapped rotation residual in
        ``[0, pi]`` (equal to the wrapped heading residual for upright
        BEV boxes). Both PR numerators take the weighted TP mass while
        the denominators keep raw counts, then the same PR-curve
        integration as :meth:`ap`.

        Computed exactly from the accumulated stats, no extra counters:
        ``acc_angular`` is the mean of ``|dtheta| / pi`` over TPs at each
        threshold (and its tp-weighted merge preserves sums), so the
        weighted mass is ``tp * (1 - acc_angular)``."""
        out = {}
        for k in self._classes:
            tp = np.asarray(self._stats.tp[k], float)
            fp = np.asarray(self._stats.fp[k], float)
            fn = np.asarray(self._stats.fn[k], float)
            ang = np.asarray(self._stats.acc_angular[k], float)
            h = np.where(tp > 0, tp * np.clip(1.0 - ang, 0.0, 1.0), 0.0)
            # same 0-denominator conventions as _calc_precision/_recall
            prec = np.where(fp == 0, np.where(tp > 0, h / np.maximum(tp, 1),
                                              1.0), h / np.maximum(tp + fp, 1))
            rec = np.where(fn == 0, np.where(tp > 0, h / np.maximum(tp, 1),
                                             1.0), h / np.maximum(tp + fn, 1))
            out[self._class_type(k)] = float(-_trapezoid(prec, rec))
        return out

    def acc_iou(self, score=None):
        si = self._get_score_idx(score)
        return {self._class_type(k): v[si] for k, v in self._stats.acc_iou.items()}

    def acc_box(self, score=None):
        si = self._get_score_idx(score)
        return {self._class_type(k): v[si] for k, v in self._stats.acc_box.items()}

    def acc_dist(self, score=None):
        si = self._get_score_idx(score)
        return {self._class_type(k): v[si] for k, v in self._stats.acc_dist.items()}

    def acc_angular(self, score=None):
        si = self._get_score_idx(score)
        return {self._class_type(k): v[si] for k, v in self._stats.acc_angular.items()}

    def metrics_dict(self, score=None):
        """Headline metrics as a plain JSON-serializable dict (per class:
        ap, precision, recall, fscore, counts, TP accuracies) — structured
        export for logging/metrics systems (the reference only prints
        human summaries)."""
        def _f(x):
            x = float(x)
            return x if np.isfinite(x) else None

        out = {}
        ap = self.ap()
        aph = self.aph()
        for k in self._classes:
            c = self._class_type(k)
            out[getattr(c, "name", str(c))] = dict(
                ap=_f(ap[c]),
                aph=_f(aph[c]),
                precision=_f(self.precision(score)[c]),
                recall=_f(self.recall(score)[c]),
                fscore=_f(self.fscore(score)[c]),
                gt=int(self.gt_count()[k]),
                tp=int(self.tp(score)[c]),
                fp=int(self.fp(score)[c]),
                fn=int(self.fn(score)[c]),
                acc_iou=_f(self.acc_iou(score)[c]),
                acc_dist=_f(self.acc_dist(score)[c]),
                acc_box=_f(self.acc_box(score)[c]),
                acc_angular=_f(self.acc_angular(score)[c]),
            )
        out["mAP"] = _f(np.mean([v for v in
                                 (d["ap"] for d in out.values()
                                  if isinstance(d, dict))
                                 if v is not None])) \
            if any(isinstance(d, dict) for d in out.values()) else None
        return out

    def summary(self, score_thres=0.8, verbose=False):
        """Human-readable report (format per reference benchmarks.pyx:410-446)."""
        si = self._get_score_idx(score_thres)
        lines = [""]
        precision, recall = self.precision(score_thres), self.recall(score_thres)
        fscore, ap = self.fscore(return_all=True), self.ap()

        lines.append("========== Benchmark Summary ==========")
        for k in self._classes:
            tk = self._class_type(k)
            if verbose:
                lines.append("Results for %s:" % tk.name)
                lines.append("\tTotal processed targets:\t%d gt boxes, %d dt boxes" % (
                    self._stats.ngt[k], max(self._stats.ndt[k])))
                lines.append("\tPrecision (score > %.2f):\t%.3f" % (score_thres, precision[tk]))
                lines.append("\tRecall (score > %.2f):\t\t%.3f" % (score_thres, recall[tk]))
                lines.append("\tMax F1:\t\t\t\t%.3f" % max(fscore[tk]))
                lines.append("\tAP:\t\t\t\t%.3f" % ap[tk])
                lines.append("")
                lines.append("\tMean IoU (score > %.2f):\t\t%.3f" % (score_thres, self._stats.acc_iou[k][si]))
                lines.append("\tMean angular error (score > %.2f):\t%.3f" % (score_thres, self._stats.acc_angular[k][si]))
                lines.append("\tMean distance (score > %.2f):\t\t%.3f" % (score_thres, self._stats.acc_dist[k][si]))
                lines.append("\tMean box error (score > %.2f):\t\t%.3f" % (score_thres, self._stats.acc_box[k][si]))
                if not np.isinf(self._stats.acc_var[k][si]):
                    lines.append("\tMean variance error (score > %.2f):\t%.3f" % (score_thres, self._stats.acc_var[k][si]))
            else:
                lines.append("\tResults for %s: AP=%.3f" % (tk.name, ap[tk]))
        lines.append("mAP: %.3f" % np.mean(list(ap.values())))
        lines.append("========== Summary End ==========")
        return "\n".join(lines)


class TrackingEvalStats(DetectionEvalStats):
    """Adds id-switch / fragment counts and per-trajectory frame counters
    (reference benchmarks.pyx:448-486).

    Trajectory counters are stored COLUMNAR: per class a (T,) trajectory-id
    vector plus dense count matrices — ``gt_frames`` (T,) frames a gt
    trajectory appears in, ``gt_tracked`` (S, T) frames it was tracked per
    threshold, ``dt_frames`` (S, T) frames a dt trajectory passed each
    threshold. The reference's dict-of-dict layout (benchmarks.pyx:468-476)
    is preserved as read-only views (:attr:`ngt_ids`, :attr:`ngt_tracked`,
    :attr:`ndt_ids`) so serialization stays wire-compatible, while merges
    and metric reductions run as vectorized array ops."""

    def __init__(self, classes=(), nsamples=0):
        super().__init__(classes, nsamples)
        self.nsamples = nsamples
        self.id_switches = {k: np.zeros(nsamples, int) for k in classes}
        self.fragments = {k: np.zeros(nsamples, int) for k in classes}
        self.gt_tids = {k: np.zeros(0, np.uint64) for k in classes}
        self.gt_frames = {k: np.zeros(0, np.int64) for k in classes}
        self.gt_tracked = {k: np.zeros((nsamples, 0), np.int64)
                           for k in classes}
        self.dt_tids = {k: np.zeros(0, np.uint64) for k in classes}
        self.dt_frames = {k: np.zeros((nsamples, 0), np.int64)
                          for k in classes}
        self._gt_rows = {k: {} for k in classes}
        self._dt_rows = {k: {} for k in classes}

    def _ensure_rows(self, side, k, tids):
        """Map trajectory ids to dense rows, growing the per-class table
        for ids seen for the first time; ``tids`` must be unique."""
        rows_map = self._gt_rows[k] if side == "gt" else self._dt_rows[k]
        out = np.empty(len(tids), np.intp)
        fresh = 0
        for i, t in enumerate(tids):
            t = int(t)
            r = rows_map.get(t)
            if r is None:
                r = len(rows_map)
                rows_map[t] = r
                fresh += 1
            out[i] = r
        if fresh:
            if side == "gt":
                self.gt_tids[k] = np.concatenate(
                    [self.gt_tids[k], np.zeros(fresh, np.uint64)])
                self.gt_frames[k] = np.concatenate(
                    [self.gt_frames[k], np.zeros(fresh, np.int64)])
                self.gt_tracked[k] = np.concatenate(
                    [self.gt_tracked[k],
                     np.zeros((self.nsamples, fresh), np.int64)], axis=1)
                tid_vec = self.gt_tids[k]
            else:
                self.dt_tids[k] = np.concatenate(
                    [self.dt_tids[k], np.zeros(fresh, np.uint64)])
                self.dt_frames[k] = np.concatenate(
                    [self.dt_frames[k],
                     np.zeros((self.nsamples, fresh), np.int64)], axis=1)
                tid_vec = self.dt_tids[k]
            tid_vec[out] = np.asarray(tids, np.uint64)
        return out

    # -- reference-layout views (wire format of benchmarks.pyx:468-476) ----
    @property
    def ngt_ids(self):
        return {k: dict(zip((int(t) for t in self.gt_tids[k]),
                            self.gt_frames[k].tolist()))
                for k in self.gt_tids}

    @property
    def ngt_tracked(self):
        out = {}
        for k, mat in self.gt_tracked.items():
            tids = self.gt_tids[k]
            out[k] = [{int(tids[j]): int(mat[si, j])
                       for j in np.nonzero(mat[si])[0]}
                      for si in range(self.nsamples)]
        return out

    @property
    def ndt_ids(self):
        out = {}
        for k, mat in self.dt_frames.items():
            tids = self.dt_tids[k]
            out[k] = [{int(tids[j]): int(mat[si, j])
                       for j in np.nonzero(mat[si])[0]}
                      for si in range(self.nsamples)]
        return out

    def as_object(self):
        d = super().as_object()
        d.update(id_switches=self.id_switches, fragments=self.fragments,
                 ngt_ids=self.ngt_ids, ngt_tracked=self.ngt_tracked,
                 ndt_ids=self.ndt_ids)
        return d


class TrackingEvaluator(DetectionEvaluator):
    """Object tracking benchmark with CLEAR-MOT metrics; keeps per-threshold
    frame-to-frame assignments to count id switches and fragments
    (reference benchmarks.pyx:488-889). ``device``: where the IoU
    matrices, the batched matches and the sequence scan run (default CUDA;
    raises without it unless ``device="cpu"``)."""

    def __init__(self, classes, min_overlaps, pr_sample_count=40,
                 min_score=0.0, pr_sample_scale="log10", device=None):
        super().__init__(classes, min_overlaps,
                         pr_sample_count=pr_sample_count, min_score=min_score,
                         pr_sample_scale=pr_sample_scale, device=device)
        self._clear_track_state()
        self._stats = TrackingEvalStats(self._classes, self._pr_nsamples)

    def _clear_track_state(self):
        """Cross-frame matching state, matrix-shaped: one global trajectory
        table per side (tid -> row, with the trajectory's class tag), and
        an (S, T) last-assignment matrix holding the counterpart's tid at
        the previous frame (0 = unassigned). Replaces the reference's
        per-threshold assignment dicts (benchmarks.pyx:500-520) so the
        per-frame id-switch / fragment bookkeeping is one boolean matrix
        expression instead of an S x T Python loop."""
        n = self._pr_nsamples
        self._gtrack_rows = {}
        self._gtrack_tags = []
        self._dtrack_rows = {}
        self._dtrack_tags = []
        self._last_gt_dt = np.zeros((n, 0), np.uint64)
        self._last_dt_gt = np.zeros((n, 0), np.uint64)
        # device sequence-scan state: compact trajectory ids (tid ->
        # dense int32, grows over the sequence)
        self._ctid_map = {}

    def _state_rows(self, side, tids, tags):
        """Rows in the cross-frame trajectory table for unique ``tids``,
        growing the table (and zero-padding the last-assignment matrix)
        for first-seen trajectories."""
        if side == "gt":
            rows_map, tag_list = self._gtrack_rows, self._gtrack_tags
        else:
            rows_map, tag_list = self._dtrack_rows, self._dtrack_tags
        out = np.empty(len(tids), np.intp)
        for i, t in enumerate(tids):
            t = int(t)
            r = rows_map.get(t)
            if r is None:
                r = len(rows_map)
                rows_map[t] = r
                tag_list.append(tags[i])
            out[i] = r
        grow = len(rows_map)
        if side == "gt":
            if self._last_gt_dt.shape[1] < grow:
                pad = grow - self._last_gt_dt.shape[1]
                self._last_gt_dt = np.concatenate(
                    [self._last_gt_dt,
                     np.zeros((self._pr_nsamples, pad), np.uint64)], axis=1)
        else:
            if self._last_dt_gt.shape[1] < grow:
                pad = grow - self._last_dt_gt.shape[1]
                self._last_dt_gt = np.concatenate(
                    [self._last_dt_gt,
                     np.zeros((self._pr_nsamples, pad), np.uint64)], axis=1)
        return out

    def reset(self):
        self._stats = TrackingEvalStats(self._classes, self._pr_nsamples)
        self._clear_track_state()

    def new_sequence(self):
        """Start a NEW sequence: clear the cross-frame id bookkeeping
        while KEEPING the accumulated stats. Without this, evaluating a
        second sequence on the same evaluator treats its first frame as
        continuing the previous sequence's tracks — with per-sequence
        tid spaces (KITTI tracking restarts ids at 0) that fabricates
        id switches at every boundary. (The reference sidesteps this by
        using one evaluator per multiprocessing worker and merging
        pickled stats; ``add_stats`` composition works here too.)

        .. note:: the per-TRAJECTORY tables behind ``tracked_ratio`` /
           ``lost_ratio`` (MT/ML) are keyed by raw tid — exactly like
           the reference's ``add_stats`` merge — so trajectories from
           different sequences that share a tid merge into one row.
           For correct MT/ML over multiple sequences give tids a
           globally unique space (offset per sequence); id switches,
           fragments, MOTA and AMOTA are unaffected either way."""
        self._clear_track_state()

    def _consts(self):
        """(max_dist, max_dist_strict) tensors on the evaluator's device,
        made once."""
        consts = getattr(self, "_device_consts", None)
        if consts is None:
            from .benchmarks_device import max_dist_arrays
            from .utils import as_tensor, resolve_device

            dev = resolve_device(self._device)
            consts = self._device_consts = tuple(
                as_tensor(a, dev) for a in max_dist_arrays(self))
        return consts

    def _device_tables(self, dt_boxes, gt_boxes, nd):
        """Pack both arrays and compute (dist, dist_ok, rank) in one device
        call. The returned context carries everything the later batched
        match needs; ``dist`` (cropped) doubles as the host distance cache
        — bit-identical to ScoreMatcher.prepare_boxes, so the rotated-IoU
        matrix is computed ONCE per frame."""
        from .benchmarks_device import _pack_one, matching_tables_device
        from .utils import as_tensor

        consts = self._consts()
        dev = consts[0].device
        ng = max(len(gt_boxes), 1)
        dt = _pack_one(dt_boxes, self._class_to_idx, nd, want_var=False)
        gt = _pack_one(gt_boxes, self._class_to_idx, ng, want_var=False)
        dist, dist_ok, rank = matching_tables_device(
            dt["boxes"], gt["boxes"], gt["labels"], consts[0], consts[1],
            device=dev)
        ctx = dict(dist_ok=dist_ok, rank=rank,
                   dt_label=as_tensor(dt["labels"], dev),
                   dt_score=as_tensor(dt["scores"], dev),
                   gt_label=as_tensor(gt["labels"], dev))
        dist_cache = dist.cpu().numpy()[:max(len(dt_boxes), 1),
                                        :len(gt_boxes) or 1]
        return dist_cache, ctx

    def _device_match_subsets(self, ctx, masks):
        """Batched per-threshold greedy match given precomputed tables;
        returns the (S, G) matched-dt-row array."""
        from .benchmarks_device import match_subsets_with_tables

        return match_subsets_with_tables(
            ctx["dist_ok"], ctx["rank"], ctx["dt_label"], ctx["dt_score"],
            ctx["gt_label"], masks,
            device=ctx["dist_ok"].device).cpu().numpy()

    def _table_chunks(self, gt_frames, dt_frames, chunk):
        """Pack and compute matching tables chunk by chunk: yields
        ``(nreal, stacked, per_frame)`` where ``stacked`` holds the
        chunk's device-stacked tables (F leading axis) plus the host
        distance copy and numpy score/label stacks, and ``per_frame`` is
        the list of ``(dist_cache, ctx)`` pairs ``calc_stats`` consumes
        (one fetch of the distances a chunk)."""
        from .benchmarks_device import (_bucket, _pack_one,
                                        batched_matching_tables)

        consts = self._consts()
        nd = _bucket(max((len(a) for a in dt_frames), default=1))
        # bucket the gt width too: a few padded shapes across sequences
        # (and an all-empty-gt sequence would produce zero-width arrays)
        ng = _bucket(max(max((len(a) for a in gt_frames), default=1), 1))

        empty = None
        for lo in range(0, len(gt_frames), chunk):
            gts = list(gt_frames[lo:lo + chunk])
            dts = list(dt_frames[lo:lo + chunk])
            nreal = len(gts)
            if nreal < chunk:
                # pad the tail chunk to the fixed shape
                if empty is None:
                    from .abstraction import Target3DArray as _T3A

                    empty = _T3A(frame=gts[0].frame if gts else None)
                gts += [empty] * (chunk - nreal)
                dts += [empty] * (chunk - nreal)
            dt = [_pack_one(a, self._class_to_idx, nd, want_var=False)
                  for a in dts]
            gt = [_pack_one(a, self._class_to_idx, ng, want_var=False)
                  for a in gts]
            nstack = lambda packs, k: np.stack([p[k] for p in packs])
            dist, dist_ok, rank = batched_matching_tables(
                nstack(dt, "boxes"), nstack(gt, "boxes"),
                nstack(gt, "labels"), consts[0], consts[1],
                device=consts[0].device)
            dist_h = dist.cpu().numpy()
            dtl_h, dsc_h = nstack(dt, "labels"), nstack(dt, "scores")
            gtl_h = nstack(gt, "labels")
            caches = [dist_h[i, :max(len(dts[i]), 1), :len(gts[i]) or 1]
                      for i in range(nreal)]
            stacked = dict(dist=dist, dist_ok=dist_ok, rank=rank,
                           dt_label_h=dtl_h, dt_score_h=dsc_h,
                           gt_label_h=gtl_h,
                           consts=consts, nd=nd, ng=ng)
            yield nreal, stacked, caches

    @staticmethod
    def _frame_ctx(stacked, i):
        """Per-frame match context from a chunk's stacked tables — built
        lazily: the scan path never needs it, and each device-array
        slice is a dispatch."""
        from .utils import as_tensor

        dev = stacked["dist_ok"].device
        return dict(dist_ok=stacked["dist_ok"][i], rank=stacked["rank"][i],
                    dt_label=as_tensor(stacked["dt_label_h"][i], dev),
                    dt_score=as_tensor(stacked["dt_score_h"][i], dev),
                    gt_label=as_tensor(stacked["gt_label_h"][i], dev))

    def precompute_tables(self, gt_frames, dt_frames, chunk=32):
        """Pack EVERY frame and compute all matching tables in a few
        chunked, batched device calls (the cross-frame id
        bookkeeping is sequential, but the per-frame distance/rank
        tables are not) — removes the per-frame packing+dispatch
        overhead from the ``device_match`` path.

        :returns: per-frame ``(dist_cache, ctx)`` pairs for
            ``calc_stats(..., device_match=True, tables=...)``
        """
        out = []
        for nreal, st, caches in self._table_chunks(gt_frames, dt_frames,
                                                    chunk):
            out.extend((caches[i], self._frame_ctx(st, i))
                       for i in range(nreal))
        return out

    def _ctid_columns(self, frames, n):
        """Map each frame's trajectory ids through the growing
        sequence-local compact-id table -> (F, n) int32, 0-padded."""
        m = self._ctid_map
        out = np.zeros((len(frames), n), np.int32)
        dup = False
        for i, arr in enumerate(frames):
            if len(arr) == 0:
                continue
            tids = arr.columns()["tid"]
            for j, t in enumerate(tids):
                t = int(t)
                r = m.get(t)
                if r is None:
                    r = m[t] = len(m) + 1
                out[i, j] = r
            if len(np.unique(tids)) != len(tids):
                dup = True
        return out, dup

    def _carry_from_host_state(self, nd):
        """Rebuild the device scan carry — (prev_ctid (nd,), prev_assign
        (S, nd)) compact-id arrays — from the host's ``_last_dt_gt``
        matrix, which pass 2 keeps correct regardless of which matching
        path processed the previous frame. Row k of the carry is an
        arbitrary slot for the k-th trajectory with a live assignment;
        the scan joins by compact id, not slot order."""
        S = self._pr_nsamples
        pc = np.zeros(nd, np.int32)
        pa = np.zeros((S, nd), np.int32)
        live = np.nonzero((self._last_dt_gt > 0).any(axis=0))[0]
        if len(live):
            m = self._ctid_map
            inv = {r: t for t, r in self._dtrack_rows.items()}
            for k, r in enumerate(live[:nd]):
                pc[k] = m.setdefault(int(inv[r]), len(m) + 1)
                codes = self._last_dt_gt[:, r]
                for s in np.nonzero(codes)[0]:
                    gt_tid = int(codes[s]) - 1
                    pa[s, k] = m.setdefault(gt_tid, len(m) + 1) + 1
        return pc, pa, len(live)

    def calc_stats_sequence(self, gt_frames, dt_frames, calib=None,
                            chunk=32, continue_sequence=False,
                            device_bookkeeping=True):
        """Evaluate a whole sequence with the device-match path and
        sequence-batched table precomputation, accumulating into this
        evaluator (frames stay ordered — the cross-frame id state
        requires it). Starts a fresh sequence (:meth:`new_sequence`) so
        back-to-back calls over different sequences do not leak id
        state across the boundary; pass ``continue_sequence=True`` when
        streaming ONE long sequence through windowed calls so id
        switches still count across the window boundary. Returns the
        evaluator's merged stats.

        With ``device_bookkeeping`` (the default) the sequential pass-1
        preservation + greedy matching chain ALSO runs on the device, a
        chunk at a time (:func:`~d3d_tpu_torch.benchmarks_device.
        tracking_match_scan`) — one fetch per chunk instead of a round trip
        per frame — and the host merely replays the counter
        bookkeeping from the fetched assignment matrices (bit-identical
        by construction; falls back to the per-frame path for frames
        with duplicate trajectory ids, where the host's dict semantics
        are not worth reproducing on device)."""
        # The tables are computed from the dt boxes AS MATCHED, so any
        # frame mismatch must be resolved BEFORE precomputation — a table
        # built on untransformed coordinates would silently mis-match.
        aligned = []
        for g, d in zip(gt_frames, dt_frames):
            if g.frame != d.frame:
                if calib is None:
                    raise ValueError(
                        "Calibration is not provided when dt_boxes and "
                        "gt_boxes are in different frames!")
                d = calib.transform_objects(d, frame_to=g.frame)
            aligned.append(d)
        # clear id state only AFTER validation: a raising call must not
        # destroy a mid-sequence evaluator's bookkeeping as a side effect
        if not continue_sequence:
            self.new_sequence()

        if not device_bookkeeping:
            tables = self.precompute_tables(gt_frames, aligned, chunk=chunk)
            for g, d, t in zip(gt_frames, aligned, tables):
                self.add_stats(self.calc_stats(g, d, device_match=True,
                                               tables=t))
            return self._stats

        from .benchmarks_device import tracking_match_scan

        thres_col = np.asarray(self._pr_thresholds)[:, None]
        pos = 0
        for nreal, st, caches in self._table_chunks(gt_frames, aligned,
                                                    chunk):
            F, nd = st["dt_label_h"].shape[0], st["nd"]
            gts = gt_frames[pos:pos + nreal]
            dts = aligned[pos:pos + nreal]
            pos += nreal
            # host-side score/tag admission with the exact f64-threshold
            # numpy semantics of calc_stats (padded rows: label -1)
            passing = (st["dt_label_h"][:, None, :] >= 0) \
                & ~(st["dt_score_h"][:, None, :] < thres_col[None])
            dt_ctid, dup_d = self._ctid_columns(dts, nd)
            gt_ctid, dup_g = self._ctid_columns(gts, st["ng"])
            if F > nreal:  # padded tail frames must not join/assign
                dt_ctid = np.concatenate(
                    [dt_ctid, np.zeros((F - nreal, nd), np.int32)])
                gt_ctid = np.concatenate(
                    [gt_ctid, np.zeros((F - nreal, st["ng"]), np.int32)])
                passing[nreal:] = False
            # the carry rebuilds from the host's _last_dt_gt each chunk:
            # pass 2 keeps that matrix correct on every path, so scan
            # chunks compose transparently with per-frame calls,
            # duplicate-tid fallbacks and re-bucketed windows
            pc, pa, nlive = self._carry_from_host_state(nd)
            if dup_d or dup_g or nlive > nd:
                # duplicate tids in a frame (host dict bookkeeping is
                # order-dependent there) or more live assignments than
                # carry slots: use the proven per-frame path for this chunk
                for i, (g, d) in enumerate(zip(gts, dts)):
                    self.add_stats(self.calc_stats(
                        g, d, device_match=True,
                        tables=(caches[i], self._frame_ctx(st, i))))
                continue
            _, _, new_match, cur_gt = tracking_match_scan(
                st["dist"], st["dist_ok"], st["rank"], st["dt_label_h"],
                st["dt_score_h"], st["gt_label_h"], passing, dt_ctid,
                gt_ctid, st["consts"][0], st["consts"][1], pc, pa,
                device=st["dist"].device)
            nm_h, cg_h = new_match.cpu().numpy(), cur_gt.cpu().numpy()
            for i, (g, d) in enumerate(zip(gts, dts)):
                inj = (nm_h[i], cg_h[i]) if len(g) and len(d) else None
                self.add_stats(self.calc_stats(
                    g, d, device_match=True, injected=inj,
                    tables=(caches[i], None) if inj is not None
                    else (caches[i], self._frame_ctx(st, i))))
        return self._stats

    def calc_stats(self, gt_boxes, dt_boxes, calib=None, device_match=False,
                   tables=None, injected=None):
        """Evaluate one frame.

        :param device_match: run all thresholds' greedy re-matching as one
            batched device call instead of the per-threshold host loop
            (bit-identical assignments; id bookkeeping stays on host).
        :param tables: optional precomputed ``(dist_cache, ctx)`` from
            :meth:`precompute_tables` (implies ``device_match``)
        :param injected: optional ``(new_match, cur_gt)`` (S, >=G) int
            matrices from :func:`~d3d_tpu_torch.benchmarks_device.
            tracking_match_scan` — pass 1 and the greedy match are then
            skipped and the counters replay from the given assignments
        """
        if gt_boxes.frame != dt_boxes.frame:
            if calib is None:
                raise ValueError("Calibration is not provided when dt_boxes "
                                 "and gt_boxes are in different frames!")
            dt_boxes = calib.transform_objects(dt_boxes, frame_to=gt_boxes.frame)

        use_device = ((device_match or tables is not None)
                      and len(dt_boxes) > 0 and len(gt_boxes) > 0)
        if use_device:
            if tables is not None:
                dist_cache, match_ctx = tables
            else:
                from .benchmarks_device import _bucket

                dist_cache, match_ctx = self._device_tables(
                    dt_boxes, gt_boxes, _bucket(len(dt_boxes)))
            if match_ctx is not None:  # None: injected assignments only
                nd = match_ctx["dt_label"].shape[0]
        else:
            matcher = ScoreMatcher()
            matcher.prepare_boxes(dt_boxes, gt_boxes, DistanceTypes.RIoU,
                                  device=self._device)
            dist_cache = matcher._distance_cache

        summary = TrackingEvalStats(self._classes, self._pr_nsamples)
        S = self._pr_nsamples
        G, D = len(gt_boxes), len(dt_boxes)
        acc_vals = np.full((S, G, 5), np.nan)

        # -- per-object columns via the struct-of-arrays backing ---------
        def _tag_ids(labels):
            """Map raw label values to class indices through one unique
            pass (the per-object ``_class_to_idx.get`` loop was a
            measurable fraction of the sequence-eval host time)."""
            uq, inv = np.unique(labels, return_inverse=True)
            lut = np.array([self._class_to_idx.get(int(u), -1) for u in uq],
                           np.intp)
            return lut[inv]

        if G:
            gc = gt_boxes.columns()
            gtag_id = _tag_ids(gc["label"])
            gtid_col = gc["tid"]
            gt_tids = gtid_col.tolist()
        else:
            gtag_id = np.zeros(0, np.intp)
            gtid_col = np.zeros(0, np.uint64)
            gt_tids = []
        gt_elig = gtag_id >= 0
        gt_indices = np.nonzero(gt_elig)[0]
        gt_tid_set = {gt_tids[g] for g in gt_indices}
        # Eligible classes only: a preserved assignment may only target a
        # gt the evaluator tracks (the reference resolved prev tids over
        # ALL gts, but a tid collision with an untracked-class gt would
        # crash its later switch accounting — excluded up front here).
        gt_tid_to_idx = {gt_tids[g]: g for g in gt_indices}

        if D:
            dc = dt_boxes.columns()
            dtag_id = _tag_ids(dc["label"])
            dtid_col = dc["tid"]
            dt_tids = dtid_col.tolist()
            scores32 = dc["score"]
        else:
            dtag_id = np.zeros(0, np.intp)
            dtid_col = np.zeros(0, np.uint64)
            dt_tids = []
            scores32 = np.zeros(0, np.float32)
        eligible = dtag_id >= 0
        # Score/tag admission of all (threshold, dt) pairs as one
        # vectorized comparison (same f32 semantics: the f32 score upcasts
        # to f64 against the f64 threshold, as np.float32(s) < thres did).
        thres_col = np.asarray(self._pr_thresholds)[:, None]
        passing = eligible[None, :] & ~(scores32[None, :] < thres_col)
        used = passing.any(axis=0)
        assert bool((dtid_col[used] > 0).all()), \
            "Tracking id should be greater than 0 for a valid object!"

        # -- per-class object / trajectory-frame counters ----------------
        for ci, k in zip(*np.unique(gtag_id[gt_indices],
                                    return_counts=True)):
            summary.ngt[self._classes[ci]] += int(k)
        for ci, k in enumerate(self._classes):
            cols = np.nonzero(gt_elig & (gtag_id == ci))[0]
            if len(cols):
                utids = list(dict.fromkeys(gt_tids[g] for g in cols))
                rows = summary._ensure_rows("gt", k, utids)
                summary.gt_frames[k][rows] += 1
            dsel = dtag_id == ci
            if dsel.any():
                summary.ndt[k][:] += passing[:, dsel].sum(axis=1)
                dcols = np.nonzero(dsel)[0]
                utids = list(dict.fromkeys(dt_tids[j] for j in dcols))
                pos = {t: i for i, t in enumerate(utids)}
                pres = np.zeros((S, len(utids)), np.int64)
                for j in dcols:
                    p = pos[dt_tids[j]]
                    pres[:, p] = np.maximum(pres[:, p], passing[:, j])
                rows = summary._ensure_rows("dt", k, utids)
                summary.dt_frames[k][:, rows] += pres

        if injected is not None:
            # assignments come from the device sequence scan: replay the
            # counters from (new_match, cur_gt); ``preserved`` is the
            # inverse image of cur_gt (each preserved dt holds exactly
            # one gt per threshold)
            new_match = injected[0][:, :G].astype(np.intp, copy=True)
            cur_gt = injected[1][:, :G].astype(np.intp, copy=True)
            preserved = np.zeros((S, D), bool)
            si_p, g_p = np.nonzero(cur_gt >= 0)
            preserved[si_p, cur_gt[si_p, g_p]] = True
            rematch = passing & ~preserved
        else:
            # -- pass 1: preserved assignments from the previous frame ---
            # prev gt (tid+1 code) per (threshold, dt); 0 = no assignment
            prev_code = np.zeros((S, D), np.uint64)
            if D and self._last_dt_gt.shape[1]:
                dt_srow = np.fromiter((self._dtrack_rows.get(int(t), -1)
                                       for t in dt_tids), np.intp, count=D)
                have = dt_srow >= 0
                if have.any():
                    prev_code[:, have] = self._last_dt_gt[:, dt_srow[have]]
            uniq, inv = np.unique(prev_code, return_inverse=True)
            lut = np.fromiter((gt_tid_to_idx.get(int(t) - 1, -1) if t else -1
                               for t in uniq), np.intp, count=len(uniq))
            prev_gt_idx = lut[inv].reshape(S, D)

            md_lut = np.array([self._max_distance[c]
                               for c in self._classes] + [-np.inf])
            maxd = md_lut[dtag_id] if D else np.zeros(0)
            preserved = np.zeros((S, D), bool)
            cand = passing & (prev_gt_idx >= 0)
            if cand.any():
                si_c, dj_c = np.nonzero(cand)
                gi_c = prev_gt_idx[si_c, dj_c]
                ok = ~(np.asarray(dist_cache)[dj_c, gi_c] > maxd[dj_c])
                preserved[si_c[ok], dj_c[ok]] = True
            rematch = passing & ~preserved
            cur_gt = np.full((S, G), -1, np.intp)  # preserved dt idx per gt
            si_p, dj_p = np.nonzero(preserved)
            cur_gt[si_p, prev_gt_idx[si_p, dj_p]] = dj_p

            # -- matching: one batched device call, or the host loop -----
            if use_device:
                masks = np.zeros((S, nd), bool)
                masks[:, :D] = rematch
                new_match = np.asarray(
                    self._device_match_subsets(match_ctx, masks))[:, :G]
                new_match = new_match.astype(np.intp, copy=True)
            else:
                new_match = np.full((S, G), -1, np.intp)
                gl = [int(g) for g in gt_indices]
                for si in range(S):
                    matcher.clear_match()
                    matcher.match(np.nonzero(rematch[si])[0].tolist(), gl,
                                  self._max_distance)
                    for gi, dj in matcher._dst_assignment.items():
                        new_match[si, gi] = dj
        if G and (~gt_elig).any():
            new_match[:, ~gt_elig] = -1

        # -- pass 2: counters from the (S, G) assignment matrix ----------
        fp_ks = np.zeros((len(self._classes), S), np.int64)
        over = (new_match >= 0) & (cur_gt >= 0)
        if over.any():
            # overwritten preserved match: counted FP under the NEW dt's
            # tag, matching the reference's bookkeeping
            si_o, g_o = np.nonzero(over)
            np.add.at(fp_ks, (dtag_id[new_match[si_o, g_o]], si_o), 1)
        final = np.where(new_match >= 0, new_match, cur_gt)
        tracked = final >= 0
        si_t, g_t = np.nonzero(tracked)
        dj_t = final[si_t, g_t]

        for ci, k in enumerate(self._classes):
            cols = np.nonzero(gt_elig & (gtag_id == ci))[0]
            if not len(cols):
                continue
            tpk = tracked[:, cols].sum(axis=1)
            summary.tp[k] += tpk
            summary.fn[k] += len(cols) - tpk
            utids = list(dict.fromkeys(gt_tids[g] for g in cols))
            pos = {t: i for i, t in enumerate(utids)}
            trkpres = np.zeros((S, len(utids)), np.int64)
            for g in cols:
                p = pos[gt_tids[g]]
                trkpres[:, p] = np.maximum(trkpres[:, p], tracked[:, g])
            rows = summary._ensure_rows("gt", k, utids)
            summary.gt_tracked[k][:, rows] += trkpres

        # accuracy entries once per unique (dt, gt) pair — the reference
        # re-ran its scipy logpdfs per threshold and flags that as its own
        # bottleneck (benchmarks.pyx:259 FIXME)
        if len(si_t):
            codes = dj_t.astype(np.int64) * max(G, 1) + g_t
            uniq_c, inv_c = np.unique(codes, return_inverse=True)
            dj_u, g_u = np.divmod(uniq_c, max(G, 1))
            table = self._accuracy_table(
                gt_boxes, dt_boxes, dj_u, g_u,
                1 - np.asarray(dist_cache)[dj_u, g_u])
            acc_vals[si_t, g_t] = table[inv_c]

        assigned_dt = np.zeros((S, D), bool)
        assigned_dt[si_t, dj_t] = True
        fp_un = rematch & ~assigned_dt
        if fp_un.any():
            si_u, dj_u = np.nonzero(fp_un)
            np.add.at(fp_ks, (dtag_id[dj_u], si_u), 1)
        for ci, k in enumerate(self._classes):
            summary.fp[k] += fp_ks[ci]

        # -- id switches / fragments as (S, T) matrix expressions --------
        # Grow the cross-frame tables for trajectories matched at any
        # threshold, then compare last frame's assignment matrix to this
        # frame's: switch = was assigned & (reassigned differently, or
        # unassigned while still present).
        m_g = np.nonzero(tracked.any(axis=0))[0]
        g_rows = self._state_rows("gt", [gt_tids[g] for g in m_g],
                                  [self._classes[gtag_id[g]] for g in m_g])
        Tg = self._last_gt_dt.shape[1]
        cur_gd = np.zeros((S, Tg), np.uint64)
        if len(m_g):
            row_of_g = np.full(G, -1, np.intp)
            row_of_g[m_g] = g_rows
            cur_gd[si_t, row_of_g[g_t]] = dtid_col[dj_t]
        last = self._last_gt_dt
        if Tg:
            present_g = np.zeros(Tg, bool)
            for t in gt_tid_set:
                r = self._gtrack_rows.get(int(t))
                if r is not None:
                    present_g[r] = True
            switch = (last > 0) & np.where(cur_gd > 0, cur_gd != last,
                                           present_g[None, :])
            if switch.any():
                tag_id_g = np.array([self._class_to_idx.get(t, -1)
                                     for t in self._gtrack_tags], np.intp)
                for ci, k in enumerate(self._classes):
                    cm = tag_id_g == ci
                    if cm.any():
                        summary.id_switches[k] += switch[:, cm].sum(axis=1)
        self._last_gt_dt = cur_gd

        m_d = np.nonzero(assigned_dt.any(axis=0))[0]
        d_rows = self._state_rows("dt", [dt_tids[j] for j in m_d],
                                  [self._classes[dtag_id[j]] for j in m_d])
        Td = self._last_dt_gt.shape[1]
        cur_dg = np.zeros((S, Td), np.uint64)
        if len(m_d):
            row_of_d = np.full(D, -1, np.intp)
            row_of_d[m_d] = d_rows
            cur_dg[si_t, row_of_d[dj_t]] = gtid_col[g_t] + np.uint64(1)
        last = self._last_dt_gt
        if Td:
            # dt presence is per-threshold: the tid must have passed at si
            present_d = np.zeros((S, Td), bool)
            for j in range(D):
                r = self._dtrack_rows.get(int(dt_tids[j]))
                if r is not None:
                    present_d[:, r] |= passing[:, j]
            frag = (last > 0) & np.where(cur_dg > 0, cur_dg != last,
                                         present_d)
            if frag.any():
                tag_id_d = np.array([self._class_to_idx.get(t, -1)
                                     for t in self._dtrack_tags], np.intp)
                for ci, k in enumerate(self._classes):
                    cm = tag_id_d == ci
                    if cm.any():
                        summary.fragments[k] += frag[:, cm].sum(axis=1)
        self._last_dt_gt = cur_dg

        for name, per_class in self._aggregate_stats(
                acc_vals, tag_ids=gtag_id).items():
            setattr(summary, name, per_class)
        return summary

    def add_stats(self, stats):
        super().add_stats(stats)
        s = self._stats
        for k in self._classes:
            s.id_switches[k] += stats.id_switches[k]
            s.fragments[k] += stats.fragments[k]
            if stats.gt_tids[k].size:
                rows = s._ensure_rows("gt", k, stats.gt_tids[k].tolist())
                s.gt_frames[k][rows] += stats.gt_frames[k]
                s.gt_tracked[k][:, rows] += stats.gt_tracked[k]
            if stats.dt_tids[k].size:
                rows = s._ensure_rows("dt", k, stats.dt_tids[k].tolist())
                s.dt_frames[k][:, rows] += stats.dt_frames[k]

    # -- tracking metrics ----------------------------------------------------
    def id_switches(self, score=None):
        si = self._get_score_idx(score)
        return {self._class_type(k): int(v[si])
                for k, v in self._stats.id_switches.items()}

    def fragments(self, score=None):
        si = self._get_score_idx(score)
        return {self._class_type(k): int(v[si])
                for k, v in self._stats.fragments.items()}

    def gt_traj_count(self):
        return {self._class_type(k): int(v.size)
                for k, v in self._stats.gt_tids.items()}

    def _calc_frame_ratio(self, score, thres, high_pass, return_all):
        st = self._stats

        def counts(k):
            """Per-threshold trajectory-ratio counts, vectorized over the
            columnar tables. Only trajectories tracked at least one frame
            enter the comparison (reference semantics: its per-threshold
            dict held tracked tids only, so never-tracked trajectories are
            not counted by the low-pass ML ratio either)."""
            nt = st.gt_frames[k]
            if not nt.size:
                return np.zeros(self._pr_nsamples)
            trk = st.gt_tracked[k]
            ratio = trk / np.maximum(nt[None, :], 1)
            cmp = (ratio > thres) if high_pass else (ratio < thres)
            return (cmp & (trk > 0)).sum(axis=1) / nt.size

        if return_all:
            return {self._class_type(k): counts(k).tolist()
                    for k in self._classes}
        si = self._get_score_idx(score)
        return {self._class_type(k): float(counts(k)[si])
                for k in self._classes}

    def tracked_ratio(self, score=None, frame_ratio_threshold=0.8,
                      return_all=False):
        """Mostly-tracked trajectory ratio (MT)."""
        return self._calc_frame_ratio(score, frame_ratio_threshold, True,
                                      return_all)

    def lost_ratio(self, score=None, frame_ratio_threshold=0.2,
                   return_all=False):
        """Mostly-lost trajectory ratio (ML)."""
        return self._calc_frame_ratio(score, frame_ratio_threshold, False,
                                      return_all)

    def mota(self, score=None):
        """CLEAR-MOT accuracy: 1 - (FP + FN + IDS) / ngt (nan when a
        class never appears in ground truth)."""
        si = self._get_score_idx(score)
        return {self._class_type(k): (1 - float(
            self._stats.fp[k][si] + self._stats.fn[k][si]
            + self._stats.id_switches[k][si]) / self._stats.ngt[k])
            if self._stats.ngt[k] else float("nan")
            for k in self._classes}

    def amota(self, min_recall=0.1):
        """Average MOTA over the evaluator's operating points — the
        AB3DMOT / nuScenes-style recall-averaged tracking accuracy.

        Per threshold with achieved recall r = TP/ngt, the
        recall-normalized MOTAR = max(0, 1 - (IDS + FP + FN -
        (1 - r) * ngt) / (r * ngt)) (Weng et al., AB3DMOT, IROS 2020;
        the formula the nuScenes tracking benchmark averages). Averaged
        over this evaluator's SCORE-threshold grid restricted to points
        with recall >= ``min_recall`` — faithful MOTAR averaging over our
        operating points, NOT a bit-exact devkit reimplementation (the
        devkit samples thresholds at fixed recall steps).
        """
        out = {}
        for k in self._classes:
            ngt = self._stats.ngt[k]
            if not ngt:
                out[self._class_type(k)] = float("nan")
                continue
            tp = np.asarray(self._stats.tp[k], float)
            fp = np.asarray(self._stats.fp[k], float)
            fn = np.asarray(self._stats.fn[k], float)
            ids = np.asarray(self._stats.id_switches[k], float)
            r = tp / ngt
            valid = r >= min_recall
            if not valid.any():
                out[self._class_type(k)] = 0.0
                continue
            with np.errstate(invalid="ignore", divide="ignore"):
                motar = 1.0 - (ids + fp + fn - (1.0 - r) * ngt) / (r * ngt)
            motar = np.clip(np.where(valid, motar, 0.0), 0.0, 1.0)
            out[self._class_type(k)] = float(np.mean(motar[valid]))
        return out

    def amotp(self, min_recall=0.1):
        """Average MOTP: mean TP center distance, averaged over the
        operating points with recall >= ``min_recall`` (companion of
        :meth:`amota`; lower is better)."""
        out = {}
        for k in self._classes:
            ngt = self._stats.ngt[k]
            if not ngt:
                out[self._class_type(k)] = float("nan")
                continue
            tp = np.asarray(self._stats.tp[k], float)
            dist = np.asarray(self._stats.acc_dist[k], float)
            valid = (tp / ngt >= min_recall) & np.isfinite(dist)
            out[self._class_type(k)] = (float(np.mean(dist[valid]))
                                        if valid.any() else float("nan"))
        return out

    def metrics_dict(self, score=None):
        """Detection export + CLEAR-MOT fields per class."""
        out = super().metrics_dict(score)

        def _f(x):
            x = float(x)
            return x if np.isfinite(x) else None

        mota = self.mota(score)
        ids = self.id_switches(score)
        frags = self.fragments(score)
        tracked = self.tracked_ratio(score)
        lost = self.lost_ratio(score)
        amota = self.amota()
        amotp = self.amotp()
        for k in self._classes:
            c = self._class_type(k)
            name = getattr(c, "name", str(c))
            if name in out and isinstance(out[name], dict):
                out[name].update(mota=_f(mota[c]), id_switches=int(ids[c]),
                                 fragments=int(frags[c]),
                                 tracked_ratio=_f(tracked[c]),
                                 lost_ratio=_f(lost[c]),
                                 amota=_f(amota[c]), amotp=_f(amotp[c]))
        return out

    def summary(self, score_thres=0.8, tracked_ratio_thres=0.8,
                lost_ratio_thres=0.2, note=None, verbose=False):
        si = self._get_score_idx(score_thres)
        lines = [""]
        precision, recall = self.precision(score_thres), self.recall(score_thres)
        fscore, ap = self.fscore(return_all=True), self.ap()
        mlt = self.tracked_ratio(score_thres, tracked_ratio_thres)
        mll = self.lost_ratio(score_thres, lost_ratio_thres)
        mota = self.mota(score_thres)

        header = ("========== Benchmark Summary (%s) ==========" % note
                  if note else "========== Benchmark Summary ==========")
        lines.append(header)
        for k in self._classes:
            tk = self._class_type(k)
            if verbose:
                lines.append("Results for %s:" % tk.name)
                lines.append("\tTotal processed targets:\t%d gt boxes, %d dt boxes" % (
                    self._stats.ngt[k], max(self._stats.ndt[k])))
                lines.append("\tTotal processed trajectories:\t%d gt tracklets, %d dt tracklets" % (
                    self.gt_traj_count()[tk],
                    int((self._stats.dt_frames[k] > 0).sum(axis=1).max())
                    if self._stats.dt_frames[k].size else 0))
                lines.append("\tPrecision (score > %.2f):\t%.3f" % (score_thres, precision[tk]))
                lines.append("\tRecall (score > %.2f):\t\t%.3f" % (score_thres, recall[tk]))
                lines.append("\tMax F1:\t\t\t\t%.3f" % max(fscore[tk]))
                lines.append("\tAP:\t\t\t\t%.3f" % ap[tk])
                lines.append("")
                lines.append("\tID switches (score > %.2f):\t\t\t%d" % (score_thres, self._stats.id_switches[k][si]))
                lines.append("\tFragments (score > %.2f):\t\t\t%d" % (score_thres, self._stats.fragments[k][si]))
                lines.append("\tMOTA (score > %.2f):\t\t\t\t%.2f" % (score_thres, mota[tk]))
                lines.append("\tMostly tracked (score > %.2f, ratio > %.2f):\t%.3f" % (
                    score_thres, tracked_ratio_thres, mlt[tk]))
                lines.append("\tMostly lost (score > %.2f, ratio < %.2f):\t%.3f" % (
                    score_thres, lost_ratio_thres, mll[tk]))
            else:
                lines.append("Results for %s: AP=%.3f, MOTA=%.3f" % (tk.name, ap[tk], mota[tk]))
        lines.append("mAP: %.3f" % np.mean(list(ap.values())))
        lines.append("========== Summary End ==========")
        return "\n".join(lines)


class SegmentationStats:
    """Semantic + panoptic segmentation counters
    (reference benchmarks.pyx:891-930)."""

    def __init__(self, classes=()):
        self.tp = {k: 0 for k in classes}
        self.fp = {k: 0 for k in classes}
        self.fn = {k: 0 for k in classes}
        self.itp = {k: 0 for k in classes}
        self.ifp = {k: 0 for k in classes}
        self.ifn = {k: 0 for k in classes}
        self.cumiou = {k: 0.0 for k in classes}

    def as_object(self):
        return dict(tp=self.tp, fp=self.fp, fn=self.fn, itp=self.itp,
                    ifp=self.ifp, ifn=self.ifn, cumiou=self.cumiou)


class SegmentationEvaluator:
    """Semantic / panoptic segmentation benchmark modeled after the
    cityscapesScripts panoptic evaluation (reference benchmarks.pyx:932-1213;
    the JAX module's host evaluator). Pointwise counting is
    vectorized with numpy instead of the reference's per-point nogil
    loops.

    :param classes: classes to consider (others count as background)
    :param background: the background class
    :param min_points: minimum segment size in the panoptic matching
    """

    def __init__(self, classes, background=0, min_points=0):
        if not isinstance(classes, (list, tuple)):
            classes = [classes]
        assert len(classes) > 0
        if isinstance(classes[0], Enum):
            self._class_type = type(classes[0])
            self._classes = [c.value for c in classes]
        elif isinstance(classes[0], (int, np.integer)):
            self._class_type = None
            self._classes = list(classes)
        else:
            raise ValueError("Classes should be int or Enum")

        if isinstance(background, Enum):
            background = background.value
        self._background = background if background >= 0 else 256 + background
        self._min_points = min_points
        self._stats = SegmentationStats(self._classes)
        if len(self._classes) > 255:
            raise ValueError("Only support up to 255 different categories!")

    def reset(self):
        self._stats = SegmentationStats(self._classes)

    def _collect_labels(self, stats, gt_labels, pred_labels):
        for k in self._classes:
            if k == self._background:
                continue
            gt_k = gt_labels == k
            stats.tp[k] += int(np.sum(gt_k & (pred_labels == k)))
            stats.fn[k] += int(np.sum(gt_k & (pred_labels != k)))
            stats.fp[k] += int(np.sum((pred_labels == k) & ~gt_k))

    def _collect_labels_pano(self, stats, gt_labels, pred_labels, gt_ids,
                             pred_ids):
        self._collect_labels(stats, gt_labels, pred_labels)

        bg_key = np.uint32(self._background) << np.uint32(16)
        in_cls_gt = np.isin(gt_labels, self._classes)
        in_cls_pred = np.isin(pred_labels, self._classes)
        gt_key = np.where(
            in_cls_gt,
            (gt_labels.astype(np.uint32) << np.uint32(16)) | gt_ids,
            bg_key)
        pred_key = np.where(
            in_cls_pred,
            (pred_labels.astype(np.uint32) << np.uint32(16)) | pred_ids,
            bg_key)

        # joint histogram of (gt segment, pred segment)
        pairs = (gt_key.astype(np.uint64) << np.uint64(32)) | pred_key
        upairs, pcounts = np.unique(pairs, return_counts=True)
        ugt = (upairs >> np.uint64(32)).astype(np.uint32)
        upred = (upairs & np.uint64(0xFFFFFFFF)).astype(np.uint32)

        gt_sizes = {}
        pred_sizes = {}
        for g, p, c in zip(ugt, upred, pcounts):
            gt_sizes[g] = gt_sizes.get(g, 0) + int(c)
            pred_sizes[p] = pred_sizes.get(p, 0) + int(c)

        bg_overlap = {int(p): int(c)
                      for g, p, c in zip(ugt, upred, pcounts) if g == bg_key}

        pred_matched = set()
        gt_matched = set()
        for g, p, c in zip(ugt, upred, pcounts):
            gt_label = int(g) >> 16
            pred_label = int(p) >> 16
            if gt_label == self._background or pred_label == self._background:
                continue
            if gt_label != pred_label:
                continue
            if gt_sizes[g] < self._min_points:
                continue
            total = gt_sizes[g] + pred_sizes[p] - int(c)
            # the reference subtracts the prediction's background overlap
            # only when it is absent (an apparent logic slip, benchmarks.pyx
            # :1056-1057); here the VOID overlap is subtracted when present,
            # matching the cityscapes panoptic protocol
            total -= bg_overlap.get(int(p), 0)
            iou = int(c) / total
            if iou > 0.5:
                stats.itp[gt_label] += 1
                stats.cumiou[gt_label] += iou
                gt_matched.add(g)
                pred_matched.add(p)

        for g, size in gt_sizes.items():
            gt_label = int(g) >> 16
            if gt_label == self._background:
                continue
            if size < self._min_points:
                continue
            if g not in gt_matched:
                stats.ifn[gt_label] += 1

        for p, size in pred_sizes.items():
            pred_label = int(p) >> 16
            if pred_label == self._background:
                continue
            if size < self._min_points:
                continue
            if p not in pred_matched:
                stats.ifp[pred_label] += 1

    def calc_stats(self, gt_labels, pred_labels, gt_ids=None, pred_ids=None):
        """Evaluate one frame of point/pixel labels (ids must be 0 for stuff
        classes)."""
        stats = SegmentationStats(self._classes)
        gt_labels = np.asarray(gt_labels, dtype=np.uint8)
        pred_labels = np.asarray(pred_labels, dtype=np.uint8)
        if gt_ids is None or pred_ids is None:
            self._collect_labels(stats, gt_labels, pred_labels)
        else:
            gt_ids = np.asarray(gt_ids)
            pred_ids = np.asarray(pred_ids)
            if gt_ids.dtype != np.uint16 or pred_ids.dtype != np.uint16:
                raise ValueError("Please convert ids to uint16!")
            self._collect_labels_pano(stats, gt_labels, pred_labels,
                                      gt_ids.astype(np.uint32),
                                      pred_ids.astype(np.uint32))
        return stats

    def add_stats(self, stats):
        for k in self._classes:
            self._stats.tp[k] += stats.tp[k]
            self._stats.fp[k] += stats.fp[k]
            self._stats.fn[k] += stats.fn[k]
            self._stats.itp[k] += stats.itp[k]
            self._stats.ifp[k] += stats.ifp[k]
            self._stats.ifn[k] += stats.ifn[k]
            self._stats.cumiou[k] += stats.cumiou[k]

    def get_stats(self):
        return self._stats

    def _typed(self, d):
        if self._class_type is None:
            return dict(d)
        return {self._class_type(k): v for k, v in d.items()}

    def tp(self, instance=False):
        return self._typed(self._stats.itp if instance else self._stats.tp)

    def fp(self, instance=False):
        return self._typed(self._stats.ifp if instance else self._stats.fp)

    def fn(self, instance=False):
        return self._typed(self._stats.ifn if instance else self._stats.fn)

    def iou(self, instance=False):
        result = {}
        for k in self._classes:
            if instance:
                iou = (self._stats.cumiou[k] / self._stats.itp[k]
                       if self._stats.itp[k] > 0 else np.nan)
            else:
                d = self._stats.tp[k] + self._stats.fp[k] + self._stats.fn[k]
                iou = self._stats.tp[k] / d if d > 0 else np.nan
            result[k if self._class_type is None else self._class_type(k)] = iou
        return result

    def sq(self):
        """Segmentation quality (panoptic)."""
        return self.iou(instance=True)

    def rq(self):
        """Recognition quality (panoptic)."""
        result = {}
        for k in self._classes:
            d = self._stats.itp[k] + 0.5 * self._stats.ifp[k] + 0.5 * self._stats.ifn[k]
            rq = self._stats.itp[k] / d if d > 0 else np.nan
            result[k if self._class_type is None else self._class_type(k)] = rq
        return result

    def pq(self):
        """Panoptic quality = SQ * RQ."""
        sq, rq = self.sq(), self.rq()
        return {k: sq[k] * rq[k] for k in sq}

    def metrics_dict(self):
        """Semantic + panoptic metrics as a JSON-serializable dict."""
        def _f(x):
            x = float(x)
            return x if np.isfinite(x) else None

        iou = self.iou()
        sq, rq, pq = self.sq(), self.rq(), self.pq()
        out = {}
        for k in self._classes:
            c = k if self._class_type is None else self._class_type(k)
            name = getattr(c, "name", str(c))
            out[name] = dict(iou=_f(iou[c]), sq=_f(sq[c]), rq=_f(rq[c]),
                             pq=_f(pq[c]),
                             tp=int(self._stats.tp[k]),
                             fp=int(self._stats.fp[k]),
                             fn=int(self._stats.fn[k]))
        vals = [v["iou"] for v in out.values() if v["iou"] is not None]
        out["mIoU"] = _f(np.mean(vals)) if vals else None
        return out

    def summary(self):
        def mean_wo_nan(values):
            valid = [v for v in values if not np.isnan(v)]
            return np.nan if not valid else sum(valid) / len(valid)

        lines = ["========== Benchmark Summary =========="]
        iou = self.iou()
        sq, rq, pq = self.sq(), self.rq(), self.pq()
        for k in self._classes:
            if k == self._background:
                continue
            tk = k if self._class_type is None else self._class_type(k)
            name = (str(k).rjust(4) if self._class_type is None
                    else tk.name.rjust(20))
            if np.isnan(pq[tk]):
                lines.append("%s: iou=%.3f" % (name, iou[tk]))
            else:
                lines.append("%s: iou=%.3f, sq=%.3f, rq=%.3f, pq=%.3f" % (
                    name, iou[tk], sq[tk], rq[tk], pq[tk]))
        lines.append("mean IoU: %.4f" % mean_wo_nan(iou.values()))
        if not np.isnan(mean_wo_nan(pq.values())):
            lines.append("mean SQ: %.4f" % mean_wo_nan(sq.values()))
            lines.append("mean RQ: %.4f" % mean_wo_nan(rq.values()))
            lines.append("mean PQ: %.4f" % mean_wo_nan(pq.values()))
        lines.append("========== Summary End ==========")
        return "\n".join(lines)

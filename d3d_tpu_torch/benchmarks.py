"""The detection evaluator (port of the detection half of
``d3d_tpu.benchmarks``; reference d3d/benchmarks.pyx).

The reference keeps per-class C++ hashmaps of per-threshold vectors and
fills the DT x GT rotated-IoU matrix with a scalar nogil loop; here every
per-(class, threshold) counter is a dense numpy vector (so merging partial
stats is pure `+`/weighted-mean) and the IoU matrix comes from one batched
call on the evaluator's ``device`` (``ScoreMatcher.prepare_boxes``: CUDA
unless the caller passes ``device="cpu"``). The greedy per-threshold
re-matching is tiny host bookkeeping over ids and stays in Python, exactly
reproducing the reference's assignment semantics. The tracking and
segmentation evaluators are not ported yet.
"""

import numpy as np
import scipy.stats as sps

from .abstraction import Target3DArray, TransformSet
from .ops.special import quatdiff
from .tracking.matcher import DistanceTypes, ScoreMatcher

__all__ = [
    "DetectionEvalStats",
    "DetectionEvaluator",
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

"""Detection <-> ground-truth matchers (port of
``d3d_tpu.tracking.matcher``; reference d3d/tracking/matcher.pyx).

The distance matrix is the only heavy part; the reference fills it with a
scalar nogil double loop over dgal 3D IoU (matcher.pyx:57-80), here it is
one broadcast float32 call of :mod:`d3d_tpu_torch.ops.geometry` on
``device`` (CUDA unless the caller passes ``device="cpu"``). The greedy /
Hungarian assignment logic is small host bookkeeping and stays in Python.
"""

from enum import IntEnum

import numpy as np
from scipy.optimize import linear_sum_assignment
from scipy.spatial.distance import cdist

from ..utils import resolve_device

__all__ = [
    "DistanceTypes",
    "BaseMatcher",
    "ScoreMatcher",
    "NearestNeighborMatcher",
    "HungarianMatcher",
]


class DistanceTypes(IntEnum):
    IoU = 1       # axis-aligned 3D box IoU
    RIoU = 2      # rotated 3D box IoU
    Position = 3  # euclidean center distance


def _iou_distance_matrix(src_arr, dst_arr, rotated, device):
    """1 - pairwise 3D IoU in float32, one broadcast call on ``device``
    (the JAX module pads the grid to multiples of 16 to share compiled
    programs; eager torch has nothing to share, and the pair function is
    elementwise, so the port takes the exact grid)."""
    import torch

    from ..ops.geometry import box3d_iou_pair, box3dr_iou_pair

    fn = box3dr_iou_pair if rotated else box3d_iou_pair
    b1 = torch.as_tensor(np.ascontiguousarray(src_arr[:, 2:9]), device=device)
    b2 = torch.as_tensor(np.ascontiguousarray(dst_arr[:, 2:9]), device=device)
    iou = fn(b1[:, None, :], b2[None, :, :])
    return (1.0 - iou).cpu().numpy().astype(np.float32)


class BaseMatcher:
    """Base matcher holding the distance cache and greedy assignment
    machinery (matcher.pyx:12-136)."""

    def __init__(self):
        self._src_boxes = None
        self._dst_boxes = None
        self._distance_cache = np.zeros((0, 0), np.float32)
        self._src_assignment = {}
        self._dst_assignment = {}

    def clear_match(self):
        self._src_assignment.clear()
        self._dst_assignment.clear()

    def prepare_boxes(self, src_boxes, dst_boxes, distance_metric,
                      device=None):
        """Compute the full src x dst distance matrix once.

        :param src_boxes: Target3DArray of boxes to match (e.g. detections)
        :param dst_boxes: fixed boxes (e.g. ground truth)
        :param distance_metric: a :class:`DistanceTypes`
        :param device: where the IoU metrics' matrix is computed (default
            CUDA; raises without it). The position metric is host numpy.
        """
        if distance_metric in (DistanceTypes.IoU, DistanceTypes.RIoU):
            device = resolve_device(device)
        self.clear_match()
        if src_boxes.frame != dst_boxes.frame:
            raise ValueError("Make sure the two object arrays are in the same frame!")
        self._src_boxes = src_boxes
        self._dst_boxes = dst_boxes

        ns, nd = len(src_boxes), len(dst_boxes)
        if ns == 0 or nd == 0:
            self._distance_cache = np.zeros((ns, nd), np.float32)
            return

        src_arr = src_boxes.to_numpy().astype(np.float32)
        dst_arr = dst_boxes.to_numpy().astype(np.float32)
        # guard against degenerate huge boxes (matcher.pyx:49-51)
        src_arr[:, 5:8] = np.clip(src_arr[:, 5:8], -1e3, 1e3)
        dst_arr[:, 5:8] = np.clip(dst_arr[:, 5:8], -1e3, 1e3)

        if distance_metric == DistanceTypes.IoU:
            self._distance_cache = _iou_distance_matrix(src_arr, dst_arr,
                                                        False, device)
        elif distance_metric == DistanceTypes.RIoU:
            self._distance_cache = _iou_distance_matrix(src_arr, dst_arr,
                                                        True, device)
        elif distance_metric == DistanceTypes.Position:
            self._distance_cache = cdist(
                src_arr[:, 2:5], dst_arr[:, 2:5], metric="euclidean"
            ).astype(np.float32)
        else:
            raise ValueError("Unknown distance metric!")

    def match(self, src_subset, dst_subset, distance_threshold):
        """:param distance_threshold: dict mapping class value -> max distance"""
        raise NotImplementedError("This is a virtual function!")

    def _match_by_order(self, src_order, dst_order, distance_threshold):
        """Greedy first-come assignment over (src, dst) candidate pairs,
        requiring equal top category and distance <= per-class threshold."""
        for src_idx, dst_idx in zip(src_order, dst_order):
            if src_idx in self._src_assignment:
                continue
            if dst_idx in self._dst_assignment:
                continue
            src_tag = self._src_boxes[src_idx].tag.labels[0]
            dst_tag = self._dst_boxes[dst_idx].tag.labels[0]
            if src_tag != dst_tag:
                continue
            if self._distance_cache[src_idx, dst_idx] <= distance_threshold.get(
                dst_tag, 0.0
            ):
                self._src_assignment[src_idx] = dst_idx
                self._dst_assignment[dst_idx] = src_idx

    def query_src_match(self, src_idx):
        return self._src_assignment.get(src_idx, -1)

    def query_dst_match(self, dst_idx):
        return self._dst_assignment.get(dst_idx, -1)

    def num_of_matches(self):
        assert len(self._src_assignment) == len(self._dst_assignment)
        return len(self._src_assignment)


class ScoreMatcher(BaseMatcher):
    """Match src boxes from highest score downward; for each src the dst
    candidates are tried closest-first (matcher.pyx:138-162)."""

    def match(self, src_subset, dst_subset, distance_threshold):
        src_subset = list(src_subset)
        dst_subset = list(dst_subset)
        if not src_subset or not dst_subset:
            return
        scores = np.asarray(
            [self._src_boxes[i].tag.scores[0] for i in src_subset],
            np.float32)  # C-float score semantics, matches the device path
        # stable sorts so tie order is deterministic (descending score, ties
        # by descending subset position; distance ties by ascending dst
        # position) — the device evaluator (benchmarks_device) replicates
        # exactly this tie rule for bit-identical assignments
        src_order = np.argsort(scores, kind="stable")[::-1]
        dsub = self._distance_cache[np.ix_(src_subset, dst_subset)]
        dst_order = np.argsort(dsub, axis=1, kind="stable")

        src_indices, dst_indices = [], []
        for i in range(len(src_subset)):
            for j in range(len(dst_subset)):
                src_indices.append(src_subset[src_order[i]])
                # NOTE: the reference indexes the distance-order row by the
                # loop position, not by src_order[i] (matcher.pyx:155-158);
                # replicated for bit-exact assignment parity
                dst_indices.append(dst_subset[dst_order[i, j]])
        self._match_by_order(src_indices, dst_indices, distance_threshold)


class NearestNeighborMatcher(BaseMatcher):
    """Globally greedy: all pairs sorted by ascending distance
    (matcher.pyx:164-186)."""

    def match(self, src_subset, dst_subset, distance_threshold):
        src_subset = list(src_subset)
        dst_subset = list(dst_subset)
        if not src_subset or not dst_subset:
            return
        dsub = self._distance_cache[np.ix_(src_subset, dst_subset)]
        order = np.argsort(dsub, axis=None)
        si, di = np.unravel_index(order, dsub.shape)
        self._match_by_order(
            [src_subset[i] for i in si],
            [dst_subset[j] for j in di],
            distance_threshold,
        )


class HungarianMatcher(BaseMatcher):
    """Per-class optimal assignment via scipy's Hungarian solver, then the
    per-class distance threshold (matcher.pyx:188-233)."""

    def match(self, src_subset, dst_subset, distance_threshold):
        src_classes, dst_classes = {}, {}
        for i in src_subset:
            src_classes.setdefault(self._src_boxes[i].tag.labels[0], []).append(i)
        for j in dst_subset:
            dst_classes.setdefault(self._dst_boxes[j].tag.labels[0], []).append(j)

        for clsid, src_list in src_classes.items():
            if clsid not in dst_classes:
                continue
            dst_list = dst_classes[clsid]
            dsub = self._distance_cache[np.ix_(src_list, dst_list)]
            rows, cols = linear_sum_assignment(dsub)
            for r, c in zip(rows, cols):
                si, dj = src_list[r], dst_list[c]
                if self._distance_cache[si, dj] <= distance_threshold.get(clsid, 0.0):
                    self._src_assignment[si] = dj
                    self._dst_assignment[dj] = si

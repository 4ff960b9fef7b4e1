"""Batched detection and tracking evaluation on one device (port of
``d3d_tpu.benchmarks_device``).

The reference evaluates detections with a compiled Cython loop over the 40
PR-sample thresholds, re-running a greedy score match per threshold per
frame (reference d3d/benchmarks.pyx:176-286). Here a batch of frames is
evaluated by torch ops on one device, with every frame and every threshold
at once:

  * the DT x GT rotated-IoU matrix of every frame comes from one broadcast
    call of :func:`d3d_tpu_torch.ops.geometry.box3dr_iou_pair`, the
    function :class:`~d3d_tpu_torch.tracking.matcher.ScoreMatcher` calls;
  * the thresholds are a leading S axis of a masked greedy match, a Python
    loop over the detections in descending-score order with (F, S, G)
    state, exactly the reference's assignment semantics, including its
    quirk of ranking GT candidates by the distance row of the
    *loop-position-th* subset element rather than the processed
    detection's own row (matcher.pyx:155-158, as ``ScoreMatcher.match``);
  * the per-pair accuracy values (center distance, box-dimension distance,
    quaternion angle, multivariate-normal + von-Mises log-likelihood) are
    dense (F, D, G) tensors computed once per batch.

The tracking evaluator's sequence scan (:func:`tracking_match_scan`) chains
the CLEAR-MOT matching of a chunk of frames on the same device: a Python
loop over the chunk's frames in place of ``lax.scan``, one fetch a chunk.

Semantic segmentation counts one ``bincount`` of ``gt * 256 + pred`` a
chunk of frames (:func:`device_semantic_stats`); panoptic matching sorts
every (frame, gt segment, pred segment) key of a chunk at once and reduces
its runs (:func:`device_panoptic_stats`), counters exact in int64 and the
IoU sums in float64, as the JAX module computes them with x64 on.

Packing stays host numpy. Counter outputs (ngt/ndt/tp/fp/fn) are
integer-exact against the host ``DetectionEvaluator.calc_stats``; accuracy
sums are float32 (the host accumulates in float64). Where the JAX module
differs: a matched detection without a variance (log-likelihood -inf)
poisons only its own class's ``acc_var`` (JAX's one-hot product makes the
other classes' sums NaN), and a detection whose covariance is exactly
singular reads as "no uncertainty estimate" (-inf, as on the host; JAX
gives NaN).
"""

import numpy as np
import torch

from .abstraction import Target3DArray
from .utils import as_tensor, resolve_device

__all__ = ["pack_frames", "eval_frames_device", "device_calc_stats",
           "match_subsets_device", "matching_tables_device",
           "batched_matching_tables", "match_subsets_with_tables",
           "max_dist_arrays", "tracking_match_scan",
           "device_semantic_stats", "device_panoptic_stats"]

_LOG_2PI = float(np.log(2.0 * np.pi))
_BIG_RANK = 2 ** 30
_ACC_FIELDS = ("acc_iou", "acc_angular", "acc_dist", "acc_box", "acc_var")


def max_dist_arrays(evaluator):
    """(max_dist f32 (C,), strict-tie bool (C,)) for an evaluator — the
    f32 threshold plus the flag marking thresholds whose f32 rounding went
    UP, where an exact f32 tie must be rejected to reproduce the host's
    f64 comparison."""
    md64 = np.array([evaluator._max_distance[c] for c in evaluator._classes],
                    np.float64)
    md = md64.astype(np.float32)
    return md, md.astype(np.float64) > md64


# ---------------------------------------------------------------------------
# host-side packing: Target3DArray pairs -> padded dense arrays
# ---------------------------------------------------------------------------

def _bucket(n, minimum=8):
    """Round up to a power of two (a few padded shapes across frames)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _pack_one(arr: Target3DArray, class_to_idx, n, want_var):
    """One Target3DArray -> fixed-size arrays. Padding rows are unit boxes
    far outside the scene (IoU exactly 0 with everything) with label -1.
    Extraction is columnar (``Target3DArray.columns()``): the column quats
    and the f32 box layout are the values ``to_numpy``/ScoreMatcher
    consume."""
    labels = np.full(n, -1, np.int32)
    scores = np.zeros(n, np.float32)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0:3] = 1e4
    boxes[:, 3:6] = 1.0
    quats = np.zeros((n, 4), np.float32)
    quats[:, 3] = 1.0
    if want_var:
        pos_var = np.zeros((n, 3, 3), np.float32)
        dim_var = np.zeros((n, 3, 3), np.float32)
        ori_var = np.zeros(n, np.float32)

    m = len(arr)
    if m > 0:
        c = arr.columns()
        boxes[:m, 0:3] = c["position"]
        boxes[:m, 3:6] = c["dimension"]
        boxes[:m, 6] = c["yaw"]
        scores[:m] = c["score"]
        uniq, inv = np.unique(c["label"], return_inverse=True)
        labels[:m] = np.array([class_to_idx.get(int(u), -1) for u in uniq],
                              np.int32)[inv]
        quats[:m] = c["quat"]
        if want_var:
            pos_var[:m] = c["position_var"]
            dim_var[:m] = c["dimension_var"]
            ori_var[:m] = c["orientation_var"]

    out = dict(labels=labels, scores=scores, boxes=boxes, quats=quats)
    if want_var:
        out.update(pos_var=pos_var, dim_var=dim_var, ori_var=ori_var)
    return out


def pack_frames(gt_arrays, dt_arrays, class_values, pad_dt=None, pad_gt=None,
                gt_ignored=None):
    """Pack lists of (gt, dt) Target3DArray pairs into stacked padded numpy
    arrays with a leading frame axis, ready for :func:`eval_frames_device`.

    :param class_values: ordered list of class *values* under evaluation
        (``DetectionEvaluator._classes``); labels outside it pack as -1 and
        are ignored, matching the host evaluator's tag filtering.
    :param gt_ignored: optional per-frame boolean masks (KITTI IGNORE
        semantics; see ``DetectionEvaluator.calc_stats``)
    """
    assert len(gt_arrays) == len(dt_arrays)
    class_to_idx = {v: i for i, v in enumerate(class_values)}
    nd = pad_dt or _bucket(max((len(a) for a in dt_arrays), default=1))
    ng = pad_gt or _bucket(max((len(a) for a in gt_arrays), default=1))

    dt = [_pack_one(a, class_to_idx, nd, want_var=True) for a in dt_arrays]
    gt = [_pack_one(a, class_to_idx, ng, want_var=False) for a in gt_arrays]
    stack = lambda packs, k: np.stack([p[k] for p in packs])  # noqa: E731
    return {
        "dt_label": stack(dt, "labels"), "dt_score": stack(dt, "scores"),
        "dt_box": stack(dt, "boxes"), "dt_quat": stack(dt, "quats"),
        "dt_pos_var": stack(dt, "pos_var"),
        "dt_dim_var": stack(dt, "dim_var"),
        "dt_ori_var": stack(dt, "ori_var"),
        "gt_label": stack(gt, "labels"), "gt_box": stack(gt, "boxes"),
        "gt_quat": stack(gt, "quats"),
        "gt_ignore": np.stack([
            np.pad(np.asarray(m, bool), (0, ng - len(m)))
            if gt_ignored is not None and m is not None
            else np.zeros(ng, bool)
            for m in (gt_ignored if gt_ignored is not None
                      else [None] * len(gt_arrays))]),
    }


# ---------------------------------------------------------------------------
# device math, batched over a leading frame axis F
# ---------------------------------------------------------------------------

def _mvn_logpdf(delta, cov):
    """Multivariate-normal log-density of the residuals ``delta`` (F, D, G,
    3) under each detection's ``cov`` (F, D, 3, 3), with ``ok`` (F, D)
    False where the LU factorisation found ``cov`` singular (the value
    there is not finite). One factorisation a detection serves its G
    right-hand sides; nothing syncs or raises on a singular batch
    element (``torch.linalg.solve`` would)."""
    lu, piv, info = torch.linalg.lu_factor_ex(cov)
    logdet = torch.linalg.slogdet(cov).logabsdet
    sol = torch.linalg.lu_solve(lu, piv, delta.transpose(-1, -2))
    maha = (delta.transpose(-1, -2) * sol).sum(-2)
    return -0.5 * (3.0 * _LOG_2PI + logdet[..., None] + maha), info == 0


def _vonmises_logpdf(x, kappa):
    """von-Mises log-density: kappa*cos(x) - log(2 pi I0(kappa)); log I0 via
    the exponentially-scaled function (log I0 = log i0e + kappa)."""
    return (kappa * torch.cos(x) - _LOG_2PI
            - (torch.log(torch.special.i0e(kappa)) + kappa))


def _matching_tables(dt_box, gt_box, gt_label, gt_valid, max_dist,
                     max_dist_strict, metric="riou"):
    """Distance matrix + acceptance mask + stable distance ranks, (F, D, G)
    each, the same computation as ScoreMatcher.prepare_boxes (the riou
    metric: 1 - rotated 3D IoU in f32 with the extents clipped to +-1e3;
    the position metric: euclidean center distance, the nuScenes
    matching protocol)."""
    from .ops.geometry import box3dr_iou_pair

    if metric == "position":
        delta = dt_box[:, :, None, 0:3] - gt_box[:, None, :, 0:3]
        dist = torch.sqrt((delta * delta).sum(-1)).to(torch.float32)
    else:
        b1 = torch.cat([dt_box[..., 0:3], dt_box[..., 3:6].clamp(-1e3, 1e3),
                        dt_box[..., 6:7]], -1)
        b2 = torch.cat([gt_box[..., 0:3], gt_box[..., 3:6].clamp(-1e3, 1e3),
                        gt_box[..., 6:7]], -1)
        iou = box3dr_iou_pair(b1[:, :, None, :], b2[:, None, :, :])
        dist = (1.0 - iou).to(torch.float32)

    safe_gtl = torch.where(gt_valid, gt_label, 0).long()
    md = max_dist[safe_gtl][:, None, :]
    le = dist <= md
    tie = (dist == md) & max_dist_strict[safe_gtl][:, None, :]
    dist_ok = le & ~tie

    rank_key = torch.where(gt_valid[:, None, :], dist, float("inf"))
    order_g = torch.sort(rank_key, dim=-1, stable=True).indices
    # the inverse permutation: each GT's position in its row's order
    rank = torch.empty_like(order_g, dtype=torch.int32).scatter_(
        -1, order_g, torch.arange(order_g.shape[-1], dtype=torch.int32,
                                  device=order_g.device).expand_as(order_g))
    return dist, dist_ok, rank


def _greedy_match_masked(dist_ok, rank, m, dt_label, dt_score, gt_label,
                         gt_valid, steps=None):
    """Greedy score match of the detection subsets ``m`` (F, S, D); returns
    the per-GT matched dt index (F, S, G), -1 unmatched. Exactly
    ScoreMatcher.match + _match_by_order: sources in descending score
    (ties: descending subset position), each trying GT candidates by
    ascending distance rank of the loop-position-th subset element (the
    reference quirk), first free compatible GT wins. ``steps`` bounds the
    loop where no subset holds more detections (default D)."""
    F, S, D = m.shape
    G = gt_label.shape[-1]
    dev = m.device
    fi = torch.arange(F, device=dev)[:, None, None]
    arange_d = torch.arange(D, device=dev, dtype=torch.int32)

    # subset position -> dt index (survivors in index order first)
    idx_by_pos = torch.sort(torch.where(m, arange_d, D), dim=-1,
                            stable=True).indices
    # processing order: survivors by (-score, -index), composed stable sorts
    rev = torch.arange(D - 1, -1, -1, device=dev)
    order = rev[torch.sort(-dt_score[:, rev], dim=-1, stable=True).indices]
    order = order[:, None, :].expand(F, S, D)
    dead = (~m.gather(-1, order)).to(torch.uint8)
    order = order.gather(-1, torch.sort(dead, dim=-1, stable=True).indices)
    live = arange_d < m.sum(-1, keepdim=True)                  # (F, S, D)

    # every step's candidate keys at once: (F, S, D, G)
    adm = (dist_ok[fi, order] & live[..., None] & gt_valid[:, None, None, :]
           & (gt_label[:, None, None, :]
              == dt_label[fi, order][..., None]))
    keys = torch.where(adm, rank[fi, idx_by_pos], _BIG_RANK)
    src_all = order.to(torch.int32)

    g_ids = torch.arange(G, device=dev)
    match = torch.full((F, S, G), -1, dtype=torch.int32, device=dev)
    for i in range(D if steps is None else min(steps, D)):
        key = torch.where(match < 0, keys[:, :, i], _BIG_RANK)
        g = key.argmin(-1, keepdim=True)
        hit = (g_ids == g) & (key.gather(-1, g) < _BIG_RANK)
        match = torch.where(hit, src_all[:, :, i, None], match)
    return match


def _to_device(packed, device):
    return {k: as_tensor(v, device) for k, v in packed.items()}


def matching_tables_device(dt_box, gt_box, gt_label, max_dist,
                           max_dist_strict, device=None):
    """Distance matrix + acceptance mask + ranks of one frame, (D, G) each
    (``dist`` is ScoreMatcher.prepare_boxes's distance cache). Tensors stay
    on their device; numpy goes to ``device`` (default CUDA)."""
    dist, dist_ok, rank = batched_matching_tables(
        *(as_tensor(x, device)[None] for x in (dt_box, gt_box, gt_label)),
        max_dist, max_dist_strict, device=device)
    return dist[0], dist_ok[0], rank[0]


def batched_matching_tables(dt_box, gt_box, gt_label, max_dist,
                            max_dist_strict, device=None):
    """:func:`matching_tables_device` over a leading frame axis."""
    dt_box, gt_box, gt_label = (as_tensor(x, device)
                                for x in (dt_box, gt_box, gt_label))
    dev = dt_box.device
    return _matching_tables(dt_box, gt_box, gt_label, gt_label >= 0,
                            as_tensor(max_dist, dev),
                            as_tensor(max_dist_strict, dev))


def match_subsets_with_tables(dist_ok, rank, dt_label, dt_score, gt_label,
                              subset_masks, device=None):
    """Greedy-match every per-threshold dt subset of one frame given the
    tables of :func:`matching_tables_device`.

    :param subset_masks: (S, D) bool — dt rows participating per threshold
    :returns: match (S, G) int32 dt row or -1
    """
    dist_ok, rank, dt_label, dt_score, gt_label, subset_masks = (
        as_tensor(x, device)[None] for x in
        (dist_ok, rank, dt_label, dt_score, gt_label, subset_masks))
    return _greedy_match_masked(dist_ok, rank, subset_masks, dt_label,
                                dt_score, gt_label, gt_label >= 0)[0]


def match_subsets_device(dt_box, dt_label, dt_score, gt_box, gt_label,
                         subset_masks, max_dist, max_dist_strict,
                         device=None):
    """One-call composition of the two phases above; returns (match,
    dist)."""
    dist, dist_ok, rank = matching_tables_device(
        dt_box, gt_box, gt_label, max_dist, max_dist_strict, device=device)
    match = match_subsets_with_tables(dist_ok, rank, dt_label, dt_score,
                                      gt_label, subset_masks, device=device)
    return match, dist


# ---------------------------------------------------------------------------
# tracking: whole-chunk CLEAR-MOT matching on the device
# ---------------------------------------------------------------------------

def _first_true(mask):
    """Index of the first True along the last axis (0 where none), as
    ``jnp.argmax`` of a bool row: an ``amin`` of the masked indices."""
    n = mask.shape[-1]
    idx = torch.arange(n, device=mask.device)
    return torch.where(mask, idx, n).amin(-1).clamp(max=n - 1)


def _tracking_scan_step(md, md_strict, carry, xs, steps=None):
    """One frame of the CLEAR-MOT matching chain (TrackingEvaluator
    pass 1 + greedy re-match, reference benchmarks.pyx:560-700): preserve
    last frame's assignments that still pass the dt-class distance cap,
    greedy-match the rest, and carry this frame's assignment forward.

    Carry is the previous frame's per-dt-slot state: the compact
    trajectory id per slot (``prev_ctid``, 0 = padding) and the assigned
    gt's compact-id code per (threshold, slot) (``prev_assign``, 0 =
    unassigned) — only the immediately-previous frame matters, exactly
    like the host's ``_last_dt_gt`` matrix which is rewritten per frame.
    ``steps`` bounds the greedy match (no subset holds more detections)."""
    prev_ctid, prev_assign = carry
    dist, dist_ok, rank, dtl, dts, gtl, passing, dct, gct = xs
    D, G = dtl.shape[0], gtl.shape[0]
    S = passing.shape[0]
    dev = dtl.device
    gt_valid = gtl >= 0
    d_idx = torch.arange(D, dtype=torch.int32, device=dev)
    g_idx = torch.arange(G, dtype=torch.int32, device=dev)

    # tid join: current dt slot -> same-trajectory slot of the prev frame
    eq = (dct[:, None] == prev_ctid[None, :]) & (dct > 0)[:, None]
    has_prev = eq.any(dim=1)
    prev_slot = _first_true(eq)
    code = torch.where(has_prev[None, :], prev_assign[:, prev_slot], 0)

    # prev gt code -> current-frame gt index (host dict semantics: the
    # LAST eligible gt with that trajectory id wins)
    eqg = (((code - 1)[:, :, None] == gct[None, None, :])
           & gt_valid[None, None, :] & (code > 0)[:, :, None])
    gi = torch.where(eqg, g_idx, -1).amax(-1)                   # (S, D)

    # preserved: still within the dt class's max distance (f32 cap with
    # the strict-tie rejection reproducing the host's f64 compare)
    safe_dtl = torch.where(dtl >= 0, dtl, 0).long()
    maxd = md[safe_dtl][None, :]
    strict = md_strict[safe_dtl][None, :]
    dval = dist[d_idx.long()[None, :], torch.where(gi >= 0, gi, 0).long()]
    ok = (dval <= maxd) & ~((dval == maxd) & strict)
    pres = passing & (gi >= 0) & ok

    # cur_gt (S, G): preserved dt per gt (largest dt index wins, matching
    # the host's write order)
    cur_gt = torch.full((S, G), -1, dtype=torch.int32, device=dev)
    cur_gt = cur_gt.scatter_reduce(
        1, torch.where(pres, gi, 0).long(),
        torch.where(pres, d_idx[None, :], -1), "amax")

    rematch = passing & ~pres
    new_match = _greedy_match_masked(
        dist_ok[None], rank[None], rematch[None], dtl[None], dts[None],
        gtl[None], gt_valid[None], steps)[0]                    # (S, G)

    # carry: this frame's final dt -> gt-code assignment per slot
    final = torch.where(new_match >= 0, new_match, cur_gt)
    best_g = torch.full((S, D), -1, dtype=torch.int32, device=dev)
    best_g = best_g.scatter_reduce(
        1, torch.where(final >= 0, final, 0).long(),
        torch.where(final >= 0, g_idx[None, :], -1), "amax")
    new_assign = torch.where(
        best_g >= 0, gct[torch.where(best_g >= 0, best_g, 0).long()] + 1, 0)
    return (dct, new_assign.to(torch.int32)), (new_match, cur_gt)


def tracking_match_scan(dist, dist_ok, rank, dt_label, dt_score, gt_label,
                        passing, dt_ctid, gt_ctid, max_dist, max_dist_strict,
                        prev_ctid, prev_assign, device=None):
    """Chain :func:`_tracking_scan_step` over a chunk of frames on one
    device (a Python loop over the frames, the JAX module's ``lax.scan``):
    the per-frame pass-1 + match round trips of
    ``TrackingEvaluator.calc_stats`` become one fetch a chunk. Tensors stay
    on their device; numpy goes to ``device`` (default CUDA).

    :param dist/dist_ok/rank: (F, D, G) stacked matching tables
    :param passing: (F, S, D) bool — host-computed score/tag admission
        (f64 threshold semantics preserved exactly)
    :param dt_ctid/gt_ctid: (F, D)/(F, G) int32 compact trajectory ids
        (host-assigned, 0 = padding; equality within a sequence is all
        the chain needs)
    :returns: (prev_ctid, prev_assign, new_match (F, S, G),
        cur_gt (F, S, G)) — the first two feed the next chunk's carry
    """
    dev = dist.device if isinstance(dist, torch.Tensor) \
        else resolve_device(device)
    # the greedy match of a frame takes at most its most passing detections
    steps = None
    if isinstance(passing, np.ndarray):
        steps = passing.sum(-1).max(-1, initial=0).tolist()
    (dist, dist_ok, rank, dt_label, dt_score, gt_label, passing, dt_ctid,
     gt_ctid, max_dist, max_dist_strict, prev_ctid, prev_assign) = (
        as_tensor(x, dev) for x in (
            dist, dist_ok, rank, dt_label, dt_score, gt_label, passing,
            dt_ctid, gt_ctid, max_dist, max_dist_strict, prev_ctid,
            prev_assign))
    carry = (prev_ctid.to(torch.int32), prev_assign.to(torch.int32))
    new_match, cur_gt = [], []
    for f in range(dist.shape[0]):
        carry, (nm, cg) = _tracking_scan_step(
            max_dist, max_dist_strict, carry,
            (dist[f], dist_ok[f], rank[f], dt_label[f], dt_score[f],
             gt_label[f], passing[f], dt_ctid[f], gt_ctid[f]),
            None if steps is None else steps[f])
        new_match.append(nm)
        cur_gt.append(cg)
    return carry[0], carry[1], torch.stack(new_match), torch.stack(cur_gt)


def eval_frames_device(packed, thresholds, max_dist, max_dist_strict,
                       nclasses, metric="riou", device=None):
    """Evaluate a batch of frames on one device.

    :param packed: dict from :func:`pack_frames` (leading frame axis F):
        numpy arrays go to ``device`` (default CUDA), tensors stay where
        they are
    :param thresholds: (S,) f32 PR-sample score thresholds
    :param max_dist: (C,) f32 per-class max distance (1 - min IoU overlap)
    :param max_dist_strict: (C,) bool — True where the f32 rounding of the
        f64 threshold rounded up, so an exact f32 tie must be rejected to
        match the host's f64 comparison
    :param nclasses: class count C
    :returns: dict of per-frame dense stats — ``ngt`` (F, C); ``ndt``,
        ``tp``, ``fp``, ``fn`` (F, C, S) i32; ``acc_{iou,angular,dist,box,
        var}`` (F, C, S) f32 sums over matched GT (divide by ``tp`` for the
        host evaluator's per-frame means).
    """
    steps = None
    if isinstance(packed["dt_label"], np.ndarray):
        # no subset holds more detections than the fullest frame
        steps = int((packed["dt_label"] >= 0).sum(-1).max(initial=0))
    p = _to_device(packed, device)
    dev = p["dt_label"].device
    thresholds = as_tensor(thresholds, dev, torch.float32)
    dtl, dts, dtb = p["dt_label"], p["dt_score"], p["dt_box"]
    gtl, gtb = p["gt_label"], p["gt_box"]
    F, D = dtl.shape
    G = gtl.shape[1]
    dv, gv = dtl >= 0, gtl >= 0
    # ignored gt stay matchable (absorbing detections from FP) but are
    # excluded from every counter and accuracy
    counted = gv & ~p["gt_ignore"]

    dist, dist_ok, rank = _matching_tables(
        dtb, gtb, gtl, gv, as_tensor(max_dist, dev),
        as_tensor(max_dist_strict, dev), metric)

    # (F, D, G) accuracy-value tensors
    d_pos = gtb[:, None, :, 0:3] - dtb[:, :, None, 0:3]
    v_dist = torch.sqrt((d_pos * d_pos).sum(-1))
    d_dim = gtb[:, None, :, 3:6] - dtb[:, :, None, 3:6]
    v_box = torch.sqrt((d_dim * d_dim).sum(-1))
    # the dot product as a chain of multiply-adds, as XLA:CPU fuses it
    # (bit-equal there): arccos near 1 turns an ulp of the dot into 1e-3 of
    # a small angle
    dq = p["dt_quat"][:, :, None, :].expand(F, D, G, 4)
    gq = p["gt_quat"][:, None, :, :].expand(F, D, G, 4)
    qdot = dq[..., 0] * gq[..., 0]
    for c in (1, 2, 3):
        qdot = torch.addcmul(qdot, dq[..., c], gq[..., c])
    v_ang = 2.0 * torch.arccos(qdot.abs().clamp(0, 1))
    ov = p["dt_ori_var"]
    lp_pos, ok_pos = _mvn_logpdf(d_pos, p["dt_pos_var"])
    lp_dim, ok_dim = _mvn_logpdf(d_dim, p["dt_dim_var"])
    kappa = 1.0 / torch.where(ov > 0, ov, 1.0)
    lp = lp_pos + lp_dim + _vonmises_logpdf(v_ang, kappa[:, :, None])
    has_var = (ov > 0) & ok_pos & ok_dim
    v_var = torch.where(has_var[:, :, None], lp, float("-inf"))

    # every threshold at once: a leading S axis of the masked greedy match
    m_all = dv[:, None, :] & (dts[:, None, :] >= thresholds[None, :, None])
    match_all = _greedy_match_masked(dist_ok, rank, m_all, dtl, dts, gtl,
                                     gv, steps)                 # (F, S, G)

    cls = torch.arange(nclasses, device=dev, dtype=dtl.dtype)
    oh_dt = dtl[:, None, :] == cls[None, :, None]               # (F, C, D)
    oh_gt = gtl[:, None, :] == cls[None, :, None]               # (F, C, G)

    matched = match_all >= 0
    safe = torch.where(matched, match_all, 0).long()
    dt_matched = torch.zeros((F, thresholds.shape[0], D), dtype=torch.int32,
                             device=dev).scatter_add_(
        -1, safe, matched.to(torch.int32)) > 0                  # (F, S, D)

    def count(onehot, mask):  # (F, C, N) x (F, S, N) -> (F, C, S) int32
        return (onehot[:, :, None, :] & mask[:, None, :, :]).sum(
            -1, dtype=torch.int32)

    ngt = (oh_gt & counted[:, None, :]).sum(-1, dtype=torch.int32)
    tp = count(oh_gt, matched & counted[:, None, :])
    out = dict(ngt=ngt, ndt=count(oh_dt, m_all), tp=tp,
               fp=count(oh_dt, m_all & ~dt_matched), fn=ngt[:, :, None] - tp)

    take = matched & counted[:, None, :]                        # (F, S, G)

    def acc(v):  # per-class sums of v over the matched, counted GT
        vals = torch.where(take, v.gather(1, safe), 0.0)
        return torch.where(oh_gt[:, :, None, :], vals[:, None, :, :],
                           0.0).sum(-1)

    out.update(acc_iou=acc(1.0 - dist), acc_dist=acc(v_dist),
               acc_box=acc(v_box), acc_angular=acc(v_ang / np.pi),
               acc_var=acc(v_var))
    return out


# ---------------------------------------------------------------------------
# DetectionEvaluator integration
# ---------------------------------------------------------------------------

def _merge_stats(evaluator, parts):
    """Combine mergeable partial DetectionEvalStats: counters sum,
    accuracies tp-weighted mean (NaN where no TPs) — the same semantics
    as the in-batch frame merge and evaluator.add_stats."""
    from .benchmarks import DetectionEvalStats

    classes = evaluator._classes
    s = DetectionEvalStats(classes, evaluator._pr_nsamples)
    for k in classes:
        s.ngt[k] = int(sum(p.ngt[k] for p in parts))
        for fld in ("ndt", "tp", "fp", "fn"):
            getattr(s, fld)[k][:] = np.sum(
                [getattr(p, fld)[k] for p in parts], axis=0)
        tp_tot = np.sum([p.tp[k] for p in parts], axis=0)
        with np.errstate(invalid="ignore"):
            for fld in _ACC_FIELDS:
                num = np.zeros_like(s.acc_iou[k])
                for p in parts:
                    v = getattr(p, fld)[k]
                    num += np.where(p.tp[k] > 0, v * p.tp[k], 0.0)
                getattr(s, fld)[k][:] = np.where(
                    tp_tot > 0, num / np.maximum(tp_tot, 1), np.nan)
    return s


def device_calc_stats(evaluator, gt_arrays, dt_arrays, calib=None,
                      merge=True, mesh=None, packed=None, gt_ignored=None,
                      chunk_frames=None, device=None):
    """Evaluate many frames with :func:`eval_frames_device` and return
    either one merged ``DetectionEvalStats`` (``merge=True``) or a list of
    per-frame stats identical to ``evaluator.calc_stats`` outputs.

    Drop-in replacement for the per-frame host loop::

        stats = device_calc_stats(evaluator, gt_list, dt_list)
        evaluator.add_stats(stats)

    :param mesh: not supported yet (the port has no ``parallel.mesh``);
        anything but None raises ``NotImplementedError``.
    :param packed: optional precomputed :func:`pack_frames` output for
        these (gt, dt) lists — packing is threshold-independent, so
        multi-threshold protocols pack once and evaluate many times.
    :param chunk_frames: optional chunk size bounding device memory on
        long streams (the batch holds F x S x D x G intermediates):
        chunks are evaluated in turn and their mergeable stats combined —
        identical results, bounded peak memory. Requires ``merge=True``.
    :param device: where the batch is evaluated; default the evaluator's
        ``device``, else CUDA (raises without it)
    """
    from .benchmarks import DetectionEvalStats
    from .tracking.matcher import DistanceTypes

    if mesh is not None:
        raise NotImplementedError(
            "device_calc_stats: mesh sharding is not ported yet "
            "(d3d_tpu_torch has no parallel.mesh); pass mesh=None")
    dev = resolve_device(device if device is not None
                         else getattr(evaluator, "_device", None))
    gt_arrays = list(gt_arrays)
    dt_arrays = list(dt_arrays)
    nframes = len(gt_arrays)
    if nframes == 0:
        return ([] if not merge
                else DetectionEvalStats(evaluator._classes,
                                        evaluator._pr_nsamples))
    if chunk_frames is not None and nframes > chunk_frames:
        if not merge:
            raise ValueError("chunk_frames requires merge=True")
        if packed is not None:
            raise ValueError("chunk_frames cannot reuse a prepacked batch")
        parts = []
        for lo in range(0, nframes, chunk_frames):
            hi = min(lo + chunk_frames, nframes)
            parts.append(device_calc_stats(
                evaluator, gt_arrays[lo:hi], dt_arrays[lo:hi], calib=calib,
                merge=True, gt_ignored=None if gt_ignored is None
                else list(gt_ignored)[lo:hi], device=dev))
        return _merge_stats(evaluator, parts)
    for i, (g, d) in enumerate(zip(gt_arrays, dt_arrays)):
        if g.frame != d.frame:
            if calib is None:
                raise ValueError("Calibration is not provided when dt_boxes "
                                 "and gt_boxes are in different frames!")
            gt_arrays[i] = calib.transform_objects(g, frame_to=d.frame)

    classes = evaluator._classes
    nsamples = evaluator._pr_nsamples
    if packed is None:
        packed = pack_frames(gt_arrays, dt_arrays, classes,
                             gt_ignored=gt_ignored)
    md, md_strict = max_dist_arrays(evaluator)
    metric = ("position" if getattr(evaluator, "_distance_metric", None)
              == DistanceTypes.Position else "riou")
    out = eval_frames_device(
        packed, np.ascontiguousarray(evaluator._pr_thresholds,
                                     np.float32), md,
        md_strict, nclasses=len(classes), metric=metric, device=dev)
    out = {k: v.cpu().numpy() for k, v in out.items()}

    def frame_stats(f):
        s = DetectionEvalStats(classes, nsamples)
        tp = out["tp"][f]
        for i, k in enumerate(classes):
            s.ngt[k] = int(out["ngt"][f, i])
            for fld in ("ndt", "tp", "fp", "fn"):
                getattr(s, fld)[k][:] = out[fld][f, i]
            with np.errstate(invalid="ignore"):
                for fld in _ACC_FIELDS:
                    getattr(s, fld)[k][:] = np.where(
                        tp[i] > 0, out[fld][f, i] / np.maximum(tp[i], 1),
                        np.nan)
        return s

    if not merge:
        return [frame_stats(f) for f in range(len(gt_arrays))]

    # merge across frames: counters sum, accuracies tp-weighted mean
    s = DetectionEvalStats(classes, nsamples)
    tp_tot = out["tp"].sum(0)  # (C, S)
    for i, k in enumerate(classes):
        s.ngt[k] = int(out["ngt"][:, i].sum())
        for fld in ("ndt", "tp", "fp", "fn"):
            getattr(s, fld)[k][:] = out[fld][:, i].sum(0)
        with np.errstate(invalid="ignore"):
            for fld in _ACC_FIELDS:
                getattr(s, fld)[k][:] = np.where(
                    tp_tot[i] > 0,
                    out[fld][:, i].sum(0) / np.maximum(tp_tot[i], 1), np.nan)
    return s


# ---------------------------------------------------------------------------
# semantic and panoptic segmentation
# ---------------------------------------------------------------------------

# points a device call counts at once (frames are chunked to stay below)
_SEG_CHUNK_POINTS = 1 << 25


def _row_chunks(rows, width):
    step = max(1, _SEG_CHUNK_POINTS // max(width, 1))
    return [(lo, min(lo + step, rows)) for lo in range(0, rows, step)]


def _seg_device(evaluator, device, mesh):
    if mesh is not None:
        raise NotImplementedError(
            "mesh sharding is not ported yet (d3d_tpu_torch has no "
            "parallel.mesh); pass mesh=None")
    return resolve_device(device if device is not None
                          else getattr(evaluator, "_device", None))


def _pack_labels(evaluator, gt_labels_list, pred_labels_list):
    """Host packing of the semantic path: (F, N) uint8 gt and pred label
    arrays, ragged frames padded with the background label (which counts
    nowhere)."""
    bg = evaluator._background
    frames = [(np.asarray(g, np.uint8), np.asarray(p, np.uint8))
              for g, p in zip(gt_labels_list, pred_labels_list)]
    nmax = max((len(g) for g, _ in frames), default=1)
    f = len(frames)
    gt = np.full((max(f, 1), nmax), bg, np.uint8)
    pr = np.full((max(f, 1), nmax), bg, np.uint8)
    for i, (g, p) in enumerate(frames):
        if len(g) != len(p):
            raise ValueError("gt/pred label lengths differ in frame %d" % i)
        gt[i, :len(g)] = g
        pr[i, :len(p)] = p
    return gt, pr


def _semantic_confusion(gt, pred):
    """(F, N) uint8 label tensors -> (256, 256) int64 confusion matrix
    (rows gt, columns pred): one ``bincount`` of ``gt * 256 + pred``.
    Exact at any count, where the JAX function's bf16 one-hot product
    with float32 accumulation is exact only below 2^24 points per frame
    and class pair."""
    key = gt.to(torch.int32) * 256 + pred.to(torch.int32)
    return torch.bincount(key.reshape(-1), minlength=256 * 256).reshape(
        256, 256)


def _confusion_on(gt, pr, dev):
    """The confusion matrix of packed (F, N) uint8 arrays on ``dev``, in
    chunks of frames, as numpy."""
    conf = torch.zeros((256, 256), dtype=torch.int64, device=dev)
    for lo, hi in _row_chunks(*gt.shape):
        conf += _semantic_confusion(torch.from_numpy(gt[lo:hi]).to(dev),
                                    torch.from_numpy(pr[lo:hi]).to(dev))
    return conf.cpu().numpy()


def device_semantic_stats(evaluator, gt_labels_list, pred_labels_list,
                          mesh=None, device=None):
    """Semantic confusion counting for many frames in one device pass.

    Computes the tp/fp/fn counters of
    :meth:`~d3d_tpu_torch.benchmarks.SegmentationEvaluator.calc_stats`
    (semantic part) summed over a batch of frames, integer-exactly, as
    ``bincount`` s of ``gt * 256 + pred`` (chunks of frames).

    :param evaluator: a ``SegmentationEvaluator`` (classes/background read)
    :param gt_labels_list: per-frame int label arrays (ragged allowed:
        frames pad with the background label, which counts nowhere)
    :param mesh: not supported yet (the port has no ``parallel.mesh``);
        anything but None raises ``NotImplementedError``
    :param device: where the counting runs (default CUDA; raises without
        it)
    :returns: a mergeable ``SegmentationStats`` (instance counters zero)
    """
    from .benchmarks import SegmentationStats

    dev = _seg_device(evaluator, device, mesh)
    gt, pr = _pack_labels(evaluator, gt_labels_list, pred_labels_list)
    conf = _confusion_on(gt, pr, dev)
    stats = SegmentationStats(evaluator._classes)
    for k in evaluator._classes:
        if k == evaluator._background:
            continue
        stats.tp[k] = int(conf[k, k])
        stats.fn[k] = int(conf[k, :].sum() - conf[k, k])
        stats.fp[k] = int(conf[:, k].sum() - conf[k, k])
    return stats


def _panoptic_keys(evaluator, labels, ids, nmax, bg):
    """Host packing: (label << 16 | id) int32 keys, out-of-class labels
    and padding routed to the background segment (the JAX function's
    packing; host counterpart: the ``np.where(in_cls, ...)`` key build in
    ``_collect_labels_pano``). Labels pass through ``np.uint8`` (-1 wraps
    to 255); ids must be uint16."""
    cls = np.asarray(evaluator._classes)
    f = len(labels)
    out = np.full((max(f, 1), nmax), np.int32(bg) << 16, np.int32)
    for i, (lab, sid) in enumerate(zip(labels, ids)):
        lab = np.asarray(lab, np.uint8)
        sid = np.asarray(sid)
        if sid.dtype != np.uint16:
            raise ValueError("Please convert ids to uint16!")
        key = np.where(np.isin(lab, cls),
                       (lab.astype(np.int32) << 16) | sid.astype(np.int32),
                       np.int32(bg) << 16)
        out[i, :len(key)] = key
    return out


def _panoptic_frames(gt_key, pred_key, min_points, bg_label):
    """(F, N) int32 segment keys on one device -> per-class (256,)
    counters itp, ifn, ifp (int64) and cumiou (float64) summed over the
    frames.

    One sort of every point's (frame, gt key, pred key) gives the joint
    pair histogram; its runs give the gt segments (sizes), a second
    ``unique`` the pred segments (sizes and VOID overlaps: the points of
    a pred segment whose gt label is the background). A pair matches when
    its labels agree and are not the background, its gt segment has
    ``min_points`` and its IoU ``c / (gt + pred - c - void)``, in float64,
    is strictly above 0.5; unmatched segments of ``min_points`` count as
    ifn / ifp. Host counterpart: ``SegmentationEvaluator.
    _collect_labels_pano``."""
    f, n = gt_key.shape
    dev = gt_key.device
    frame = torch.arange(f, dtype=torch.int64, device=dev)[:, None] << 48
    pk = pred_key.to(torch.int64)
    pairs, count = torch.unique(
        (frame | (gt_key.to(torch.int64) << 24) | pk).reshape(-1),
        return_counts=True)
    mask24 = (1 << 24) - 1
    gseg = pairs >> 24                                  # (frame, gt key)
    pseg = ((pairs >> 48) << 24) | (pairs & mask24)     # (frame, pred key)
    gl = (gseg >> 16) & 0xFF
    pl = (pairs >> 16) & 0xFF
    gu, ginv = torch.unique_consecutive(gseg, return_inverse=True)
    pu, pinv = torch.unique(pseg, return_inverse=True)

    def seg_sum(inv, nseg, values):
        return torch.zeros(nseg, dtype=torch.int64, device=dev).index_add_(
            0, inv, values)

    g_size = seg_sum(ginv, len(gu), count)
    p_size = seg_sum(pinv, len(pu), count)
    p_void = seg_sum(pinv, len(pu), count * (gl == bg_label))

    gsz = g_size[ginv]
    denom = gsz + p_size[pinv] - count - p_void[pinv]
    iou = torch.where(denom > 0, count.to(torch.float64)
                      / torch.clamp_min(denom, 1).to(torch.float64), 0.0)
    match = ((gl == pl) & (gl != bg_label) & (pl != bg_label)
             & (gsz >= min_points) & (iou > 0.5))
    itp = torch.bincount(gl[match], minlength=256)[:256]
    cumiou = torch.zeros(256, dtype=torch.float64, device=dev).index_add_(
        0, gl, torch.where(match, iou, 0.0))

    def unmatched(inv, nseg, labels, sizes):
        seg_label = torch.zeros(nseg, dtype=torch.int64,
                                device=dev).scatter_(0, inv, labels)
        matched = seg_sum(inv, nseg, match.to(torch.int64)) > 0
        cnt = (seg_label != bg_label) & (sizes >= min_points) & ~matched
        return torch.bincount(seg_label[cnt], minlength=256)[:256]

    ifn = unmatched(ginv, len(gu), gl, g_size)
    ifp = unmatched(pinv, len(pu), pl, p_size)
    return itp, ifn, ifp, cumiou


def _panoptic_on(gk, pk, min_points, bg, dev):
    """:func:`_panoptic_frames` over packed (F, N) key arrays in chunks of
    frames on ``dev``, summed, as numpy."""
    out = None
    for lo, hi in _row_chunks(*gk.shape):
        part = _panoptic_frames(torch.from_numpy(gk[lo:hi]).to(dev),
                                torch.from_numpy(pk[lo:hi]).to(dev),
                                min_points, bg)
        out = part if out is None else [a + b for a, b in zip(out, part)]
    return [t.cpu().numpy() for t in out]


def device_panoptic_stats(evaluator, gt_labels_list, pred_labels_list,
                          gt_ids_list, pred_ids_list, mesh=None,
                          device=None):
    """Full panoptic + semantic stats for many frames on one device.

    Equivalent to summing ``SegmentationEvaluator.calc_stats(gt, pred,
    gt_ids, pred_ids)`` over the frames: semantic tp/fp/fn from the
    confusion counts (:func:`device_semantic_stats`) and instance
    itp/ifn/ifp/cumiou from sorted-run reductions, integer counters
    exact and cumiou accumulated in float64 like the host (in another
    order: within 1e-12 relative).

    :param mesh: not supported yet; anything but None raises
        ``NotImplementedError``
    :param device: where the work runs (default CUDA; raises without it)
    :returns: a mergeable ``SegmentationStats``
    """
    dev = _seg_device(evaluator, device, mesh)
    stats = device_semantic_stats(evaluator, gt_labels_list,
                                  pred_labels_list, device=dev)
    bg = evaluator._background
    nmax = max((len(g) for g in gt_labels_list), default=1)
    gk = _panoptic_keys(evaluator, gt_labels_list, gt_ids_list, nmax, bg)
    pk = _panoptic_keys(evaluator, pred_labels_list, pred_ids_list, nmax, bg)
    itp, ifn, ifp, cumiou = _panoptic_on(gk, pk, evaluator._min_points, bg,
                                         dev)
    for k in evaluator._classes:
        if k == bg:
            continue
        stats.itp[k] = int(itp[k])
        stats.ifn[k] = int(ifn[k])
        stats.ifp[k] = int(ifp[k])
        stats.cumiou[k] = float(cumiou[k])
    return stats

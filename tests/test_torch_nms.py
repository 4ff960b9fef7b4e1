"""The port's NMS against the JAX package: the plain suppression scan (the
plain version of kernels K2/K3) against the Pallas kernels in interpret
mode, ``nms2d`` against ``d3d_tpu.ops.nms.nms2d``, and ``soft_nms2d`` and
the plain soft-NMS cascade (kernel K4's plain version) against
``d3d_tpu.ops.nms.soft_nms2d`` and ``soft_nms_scan(interpret=True)``, all
exact, with rotated and axis-aligned IoU."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax.numpy as jnp
import torch

from d3d_tpu.ops import geometry as G
from d3d_tpu.ops import geometry_soa as S
from d3d_tpu.ops import nms as N
from d3d_tpu.ops.nms_pallas import nms_scan, nms_scan_blocked, soft_nms_scan

from d3d_tpu_torch.ops import nms as TN
from d3d_tpu_torch.ops import nms_cuda as TK


def _overlap(rng, n):
    ov = rng.random((n, n)) < 0.07
    return ov | ov.T, rng.random(n) < 0.1


@pytest.mark.parametrize("n", [5, 128, 160, 200, 515, 1025])
def test_plain_scan_matches_pallas(rng, n):
    ov, pre = _overlap(rng, n)
    if n <= 1024:
        want = np.asarray(nms_scan(jnp.asarray(ov), jnp.asarray(pre),
                                   interpret=True))
    else:
        want = np.asarray(nms_scan_blocked(jnp.asarray(ov), jnp.asarray(pre),
                                           interpret=True))
    counts = TK.nms_scan.launches, TK.nms_scan_blocked.launches
    for scan in (TK.nms_scan, TK.nms_scan_blocked):
        got = scan(torch.from_numpy(ov), torch.from_numpy(pre)).numpy()
        np.testing.assert_array_equal(got, want)
    assert (TK.nms_scan.launches, TK.nms_scan_blocked.launches) == counts


def _boxes(rng, n, spread):
    return np.stack([rng.random(n) * spread, rng.random(n) * spread,
                     rng.random(n) * 3 + 1, rng.random(n) * 3 + 1,
                     rng.random(n) * np.pi], axis=1).astype(np.float32)


def _clear_of_threshold(boxes, thr, margin=1e-4):
    """Drop boxes until no pairwise IoU lies within ``margin`` of ``thr``,
    where one f32 rounding could flip a keep bit."""
    iou = np.asarray(S.rbox_iou(jnp.asarray(boxes, jnp.float64)[:, None],
                                jnp.asarray(boxes, jnp.float64)[None, :]))
    near = np.abs(iou - thr) < margin
    np.fill_diagonal(near, False)
    drop = np.unique(np.nonzero(np.triu(near))[1])
    return np.delete(boxes, drop, axis=0)


@pytest.mark.parametrize("n,thr,score_thr", [(80, 0.3, 0.0),
                                             (300, 0.1, 0.2),
                                             (1100, 0.25, 0.0)])
def test_nms2d_matches_jax(rng, n, thr, score_thr):
    boxes = _clear_of_threshold(_boxes(rng, n, np.sqrt(n) * 2.0), thr)
    scores = rng.random(len(boxes)).astype(np.float32)
    want = np.asarray(N.nms2d(jnp.asarray(boxes), jnp.asarray(scores),
                              iou_threshold=thr, score_threshold=score_thr))
    got = TN.nms2d(torch.from_numpy(boxes), torch.from_numpy(scores),
                   iou_threshold=thr, score_threshold=score_thr).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (~got).sum() < len(boxes)


def test_top_box_never_pre_suppressed(rng):
    # every score below the threshold: only rank 0 escapes pre-suppression
    boxes = _boxes(rng, 40, 12.0)
    scores = (rng.random(40) * 0.1).astype(np.float32)
    want = np.asarray(N.nms2d(jnp.asarray(boxes), jnp.asarray(scores),
                              iou_threshold=0.5, score_threshold=0.5))
    got = TN.nms2d(torch.from_numpy(boxes), torch.from_numpy(scores),
                   iou_threshold=0.5, score_threshold=0.5).numpy()
    np.testing.assert_array_equal(got, want)
    assert (~got).sum() == 1 and not got[np.argmax(scores)]


def test_tied_scores_keep_input_order(rng):
    # identical boxes with tied scores: the lowest index wins each tie
    base = _boxes(rng, 10, 30.0)
    boxes = np.repeat(base, 3, axis=0)
    scores = np.repeat(rng.random(10).astype(np.float32), 3)
    want = np.asarray(N.nms2d(jnp.asarray(boxes), jnp.asarray(scores),
                              iou_threshold=0.5))
    got = TN.nms2d(torch.from_numpy(boxes), torch.from_numpy(scores),
                   iou_threshold=0.5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.nonzero(~got)[0] % 3, 0)


def _clear_of_aabox_threshold(boxes, thr, margin=1e-4):
    """As :func:`_clear_of_threshold`, for the axis-aligned IoU."""
    b = jnp.asarray(boxes, jnp.float64)
    iou = np.asarray(G.aabox_iou(b[:, None], b[None]))
    near = np.abs(iou - thr) < margin
    np.fill_diagonal(near, False)
    return np.delete(boxes, np.unique(np.nonzero(np.triu(near))[1]), axis=0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_box_method_not_ported(rng, dtype):
    """``iou_method="box"`` is ported: the axis-aligned IoU matrix of the
    boxes in score order, thresholded into the bool route of the scan
    (K2 up to 1024 boxes, K3 above), equal to the JAX module's mask; an
    unknown method raises."""
    boxes = _clear_of_aabox_threshold(_boxes(rng, 200, 28.0), 0.3)
    scores = rng.random(len(boxes)).astype(np.float32)
    want = np.asarray(N.nms2d(jnp.asarray(boxes.astype(dtype)),
                              jnp.asarray(scores.astype(dtype)),
                              iou_threshold=0.3, iou_method="box"))
    got = TN.nms2d(torch.from_numpy(boxes.astype(dtype)),
                   torch.from_numpy(scores.astype(dtype)),
                   iou_threshold=0.3, iou_method="box").numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(boxes)
    with pytest.raises(ValueError, match="iou_method"):
        TN.nms2d(torch.zeros(2, 5), torch.zeros(2), iou_method="grbox")


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("method,param", [("linear", 0.5), ("linear", 0.0),
                                          ("gaussian", 0.4)])
def test_soft_nms_matches_jax(rng, method, param, tied):
    """f32: soft_nms2d against the JAX loop, and the plain cascade against
    the Pallas kernel on the same IoU matrix. p = 0 makes the linear decay
    1 - 1 = 0; tied scores must pick the lowest index first."""
    n = 64
    boxes = _boxes(rng, n, 14.0)
    scores = rng.random(n).astype(np.float32)
    if tied:
        scores = np.repeat(scores[:16], 4)
    kw = dict(iou_threshold=0.2, score_threshold=0.1,
              supression_param=param, supression_method=method)
    want = np.asarray(N.soft_nms2d(jnp.asarray(boxes), jnp.asarray(scores),
                                   **kw))
    got = TN.soft_nms2d(torch.from_numpy(boxes), torch.from_numpy(scores),
                        **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < n

    iou = np.array(N._iou_matrix(jnp.asarray(boxes), "rbox"), np.float32)
    pre = scores <= 0.1
    pre[np.argsort(-scores, kind="stable")[0]] = False
    init = np.where(pre, -np.inf, scores).astype(np.float32)
    args = (0.2, 0.1, param, method)
    pallas = np.asarray(soft_nms_scan(jnp.asarray(iou), jnp.asarray(init),
                                      jnp.asarray(pre), *args,
                                      interpret=True))
    launches = TK.soft_nms_scan.launches
    plain = TK.soft_nms_scan(torch.from_numpy(iou), torch.from_numpy(init),
                             torch.from_numpy(pre), *args).numpy()
    assert TK.soft_nms_scan.launches == launches
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, want)


@pytest.mark.parametrize("method,param", [("linear", 0.5), ("gaussian", 0.4)])
def test_soft_nms_float64_runs_the_loop(rng, method, param):
    """f64 input on the CPU runs the plain cascade in float64 against the
    JAX module's loop, and launches nothing."""
    boxes = _boxes(rng, 40, 12.0).astype(np.float64)
    scores = rng.random(40)
    kw = dict(iou_threshold=0.15, score_threshold=0.2,
              supression_param=param, supression_method=method)
    want = np.asarray(N.soft_nms2d(jnp.asarray(boxes), jnp.asarray(scores),
                                   **kw))
    launches = TK.soft_nms_scan.launches
    got = TN.soft_nms2d(torch.from_numpy(boxes), torch.from_numpy(scores),
                        **kw).numpy()
    assert TK.soft_nms_scan.launches == launches
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < 40


@pytest.mark.parametrize("iou_dtype,score_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float64)])
def test_soft_nms_scan_takes_one_float_dtype(iou_dtype, score_dtype):
    """The cascade takes float32 or float64 IoU and scores of the same
    dtype; anything else raises instead of running another loop."""
    iou = torch.eye(3, dtype=iou_dtype)
    scores = torch.tensor([0.9, 0.8, 0.7], dtype=score_dtype)
    with pytest.raises(ValueError, match="must share"):
        TK.soft_nms_scan(iou, scores, torch.zeros(3, dtype=torch.bool),
                         0.3, 0.5, 1.0, "linear")


def test_soft_nms_exempts_rank_zero_not_a_nan_score():
    """A NaN score: the exempt box is rank 0 of the stable descending
    sort (NaN sorts last), not ``argmax``, which returns the NaN."""
    boxes = np.array([[0.0, 0.0, 1.0, 1.0, 0.0], [5.0, 0.0, 1.0, 1.0, 0.0],
                      [10.0, 0.0, 1.0, 1.0, 0.0]], np.float32)
    scores = np.array([0.2, np.nan, 0.1], np.float32)
    kw = dict(iou_threshold=0.3, score_threshold=0.5)
    want = np.asarray(N.soft_nms2d(jnp.asarray(boxes), jnp.asarray(scores),
                                   **kw))
    got = TN.soft_nms2d(torch.from_numpy(boxes), torch.from_numpy(scores),
                        **kw).numpy()
    np.testing.assert_array_equal(want, [False, False, True])
    np.testing.assert_array_equal(got, want)


# a NaN pick: 6 boxes 0.3 m apart, a NaN score among them
NAN_PICK_BOXES = np.array([[0.3 * i, 0.0, 1.0, 1.0, 0.0] for i in range(6)],
                          np.float32)
NAN_PICK_SCORES = np.array([0.5, np.nan, 0.9, 0.2, 0.8, 0.1], np.float32)


def test_soft_nms_nan_pick_follows_the_pallas_kernel():
    """With a NaN score the JAX package's two routes disagree (its XLA
    loop's argmax picks the NaN, the Pallas kernel matches no entry against
    a NaN maximum and picks n - 1); the port follows the kernel, both in
    ``soft_nms2d`` and in the plain cascade."""
    kw = dict(iou_threshold=0.3, score_threshold=0.3, supression_param=0.0,
              supression_method="linear")
    got = TN.soft_nms2d(torch.from_numpy(NAN_PICK_BOXES),
                        torch.from_numpy(NAN_PICK_SCORES), **kw).numpy()
    iou = np.array(N._iou_matrix(jnp.asarray(NAN_PICK_BOXES), "rbox"),
                   np.float32)
    pre = NAN_PICK_SCORES <= 0.3
    pre[np.argsort(-NAN_PICK_SCORES, kind="stable")[0]] = False
    init = np.where(pre, -np.inf, NAN_PICK_SCORES).astype(np.float32)
    args = (0.3, 0.3, 0.0, "linear")
    pallas = np.asarray(soft_nms_scan(jnp.asarray(iou), jnp.asarray(init),
                                      jnp.asarray(pre), *args,
                                      interpret=True))
    plain = TK.soft_nms_scan(torch.from_numpy(iou), torch.from_numpy(init),
                             torch.from_numpy(pre), *args).numpy()
    np.testing.assert_array_equal(pallas, [False] * 3 + [True] * 3)
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_soft_nms_box_method_not_ported(rng, dtype):
    """``iou_method="box"`` is ported to soft-NMS too: the axis-aligned IoU
    matrix into the cascade (K4's plain version here), float32 and
    float64, equal to the JAX module's mask."""
    boxes = _clear_of_aabox_threshold(_boxes(rng, 64, 14.0), 0.2)
    scores = rng.random(len(boxes))
    kw = dict(iou_threshold=0.2, score_threshold=0.1, supression_param=0.5,
              supression_method="linear", iou_method="box")
    want = np.asarray(N.soft_nms2d(jnp.asarray(boxes.astype(dtype)),
                                   jnp.asarray(scores.astype(dtype)), **kw))
    got = TN.soft_nms2d(torch.from_numpy(boxes.astype(dtype)),
                        torch.from_numpy(scores.astype(dtype)),
                        **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(boxes)
    with pytest.raises(ValueError, match="iou_method"):
        TN.soft_nms2d(torch.zeros(2, 5), torch.zeros(2), iou_method="x")

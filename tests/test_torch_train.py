"""The port's training half against the JAX package on the same numpy-seeded
inputs: the axis-aligned anchor IoU, anchor assignment, the detection loss
and its gradient (both target forms, with and without the rotated-IoU
term), and the optimizer recipe (learning-rate schedules and updates)."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.models.pointpillars import (PointPillarsConfig, _bev_iou,
                                         assign_targets, detection_loss,
                                         make_anchors, prepare_targets)
from d3d_tpu.ops import geometry as G
from d3d_tpu.train import make_optimizer

from d3d_tpu_torch import train as TT
from d3d_tpu_torch.models import pointpillars as TP
from d3d_tpu_torch.ops import geometry as TG

CFG = dict(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(16, 16))
BAND = 1e-6  # IoUs this close to a threshold may round to either side


def _boxes(rng, n):
    return np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                     rng.uniform(0.5, 5, n), rng.uniform(0.5, 5, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


def _gt(rng, b=2, m=4):
    """(B, M, 7) car-like boxes inside CFG's bounds, labels and a mask with
    the last box of frame 0 padded."""
    boxes = np.stack([
        rng.uniform(2, 14, (b, m)), rng.uniform(-6, 6, (b, m)),
        np.full((b, m), -1.0), rng.uniform(3.0, 4.5, (b, m)),
        rng.uniform(1.4, 1.9, (b, m)), np.full((b, m), 1.56),
        rng.uniform(-np.pi, np.pi, (b, m))], -1).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[0, -1] = False
    return boxes, rng.integers(0, 2, (b, m)).astype(np.int32), mask


def test_aabox_iou_matches(rng):
    """f32: the two frameworks' sin/cos may differ by an ulp, which moves
    the corners by ~1e-7 relative: atol 2e-6 on IoUs in [0, 1]."""
    a, b = _boxes(rng, 300), _boxes(rng, 300)
    a[:5, 4] = [0.0, 1.5707963, -1.5707963, np.pi, 0.7853982]
    want = np.asarray(G.aabox_iou(jnp.asarray(a), jnp.asarray(b)))
    got = TG.aabox_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert (want > 0).sum() > 30
    np.testing.assert_allclose(
        TG.box2poly(torch.from_numpy(a)).numpy(),
        np.asarray(G.box2poly(jnp.asarray(a))), rtol=0, atol=2e-6)


def _anchors(cfg):
    return np.array(make_anchors(cfg))


def _threshold_band(iou, gt_mask, cfg):
    """Anchors whose best IoU (JAX's) lies within BAND of pos_iou or
    neg_iou."""
    best = np.where(gt_mask[None], iou, -1.0).max(1)
    return ((np.abs(best - cfg.pos_iou) < BAND)
            | (np.abs(best - cfg.neg_iou) < BAND))


@pytest.mark.parametrize("rotations", [(0.0, 1.5707963), (0.3,)])
def test_assign_targets_matches(rng, rotations):
    """Masks and integer targets exactly, outside the anchors whose IoU lies
    within 1e-6 of a threshold (counted: none or a handful); the box
    residuals to f32 rounding (atol 1e-5). The anchors at 1.5707963 go
    through cos(~pi/2)."""
    cfg = PointPillarsConfig(**CFG, anchor_rotations=rotations)
    anchors = _anchors(cfg)
    boxes, labels, mask = _gt(rng)
    ta = torch.from_numpy(anchors)
    banded = 0
    for f in range(boxes.shape[0]):
        jb, jl, jm = (jnp.asarray(x[f]) for x in (boxes, labels, mask))
        want = {k: np.asarray(v) for k, v in assign_targets(
            jnp.asarray(anchors), jb, jl, jm, cfg.pos_iou,
            cfg.neg_iou).items()}
        got = {k: v.numpy() for k, v in TP.assign_targets(
            ta, torch.from_numpy(boxes[f]), torch.from_numpy(labels[f]),
            torch.from_numpy(mask[f]), cfg.pos_iou, cfg.neg_iou).items()}
        iou = np.asarray(_bev_iou(jnp.asarray(anchors), jb))
        np.testing.assert_allclose(
            TP._bev_iou(ta, torch.from_numpy(boxes[f])).numpy(), iou,
            rtol=0, atol=2e-6)
        ok = ~_threshold_band(iou, mask[f], cfg)
        banded += int((~ok).sum())
        for k in ("pos", "neg", "cls_target"):
            np.testing.assert_array_equal(got[k][ok], want[k][ok], err_msg=k)
        pos = want["pos"] & ok
        assert pos.sum() >= mask[f].sum()  # force-match: one per valid gt
        np.testing.assert_array_equal(got["dir_target"][pos],
                                      want["dir_target"][pos])
        np.testing.assert_allclose(got["reg_target"][pos],
                                   want["reg_target"][pos], rtol=0,
                                   atol=1e-5)
    assert banded <= 4, banded


def _outputs(rng, b, n, c):
    return (rng.normal(0, 2, (b, n, c)).astype(np.float32),
            rng.normal(0, 0.3, (b, n, 7)).astype(np.float32),
            rng.normal(0, 1, (b, n, 2)).astype(np.float32))


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("riou_weight", [0.0, 0.1])
def test_detection_loss_and_grad_match(rng, dense, riou_weight):
    """The loss terms and the gradient w.r.t. the three head outputs, from
    the same targets (the JAX package's prepare_targets, int/bool or dense
    form; the port's prepare_targets equal to them). Sums in other orders
    and, for the rotated-IoU term, the JAX package's AoS clip on the CPU
    against the port's SoA one: rtol 1e-5 on the losses, atol 1e-5 of the
    largest gradient entry."""
    cfg = PointPillarsConfig(**CFG, num_classes=2)
    anchors = _anchors(cfg)
    boxes, labels, mask = _gt(rng)
    batch = dict(gt_boxes=jnp.asarray(boxes), gt_labels=jnp.asarray(labels),
                 gt_mask=jnp.asarray(mask))
    targets = prepare_targets(jnp.asarray(anchors), batch, cfg=cfg,
                              dense=dense)["targets"]
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    ttargets = TP.prepare_targets(torch.from_numpy(anchors), tbatch,
                                  cfg=cfg, dense=dense)["targets"]
    assert set(ttargets) == set(targets)
    for k, v in targets.items():
        np.testing.assert_allclose(ttargets[k].numpy().astype(np.float64),
                                   np.asarray(v).astype(np.float64),
                                   rtol=0, atol=1e-5, err_msg=k)
    outs = _outputs(rng, 2, anchors.shape[0], 2)

    def jloss(o):
        return detection_loss(o, targets, cfg, jnp.asarray(anchors),
                              riou_weight)

    (want, waux), wgrad = jax.value_and_grad(jloss, has_aux=True)(
        tuple(jnp.asarray(o) for o in outs))
    touts = [torch.from_numpy(o).requires_grad_() for o in outs]
    ttargets = {k: torch.from_numpy(np.array(v))
                for k, v in targets.items()}
    got, gaux = TP.detection_loss(touts, ttargets, cfg,
                                  torch.from_numpy(anchors), riou_weight)
    got.backward()
    assert set(gaux) == set(waux)
    for k in waux:
        np.testing.assert_allclose(float(gaux[k].detach()), float(waux[k]),
                                   rtol=1e-5, err_msg=k)
    for t, w in zip(touts, wgrad):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def _jax_lrs(total, schedule, accumulate):
    _, lr = make_optimizer(total, schedule=schedule, accumulate=accumulate)
    return np.array([float(lr(jnp.int32(s))) for s in range(total + 3)])


@pytest.mark.parametrize("schedule", ["onecycle", "cosine", "constant"])
@pytest.mark.parametrize("total,accumulate", [(10, 1), (37, 1), (12, 2)])
def test_schedule_matches_optax(schedule, total, accumulate):
    """The learning rate at every training step: float64 to 1e-12 (the two
    evaluate cos in other libraries), and the float32 rate the update uses
    equal."""
    want = _jax_lrs(total, schedule, accumulate)
    _, lr = TT.make_optimizer([torch.zeros(1)], total, schedule=schedule,
                              accumulate=accumulate)
    got = np.array([lr(s) for s in range(total + 3)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(got.astype(np.float32),
                                  want.astype(np.float32))


@pytest.mark.parametrize("schedule,accumulate", [
    ("onecycle", 1), ("cosine", 1), ("constant", 1), ("onecycle", 2)])
def test_updates_match_optax(rng, schedule, accumulate):
    """Four steps of make_optimizer's update against optax's chain on the
    same parameters and gradients; the second step's gradient is large
    enough to clip (global norm over 10), where optax divides by the norm
    with no epsilon. Parameters after each step: rtol 1e-6 (the global
    norm sums in another order)."""
    shapes = [(3, 4), (5,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 20 if i == 1 else 1, size=s).astype(np.float32)
              for s in shapes] for i in range(4)]
    tx, _ = make_optimizer(8, base_lr=1e-2, schedule=schedule,
                           accumulate=accumulate)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, _ = TT.make_optimizer(tp, 8, base_lr=1e-2, schedule=schedule,
                               accumulate=accumulate)
    for g in grads:
        u, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + x for p, x in zip(jp, u)]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        opt.step()
        for p, w in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-9)
    moved = [not np.array_equal(p.detach().numpy(), q)
             for p, q in zip(tp, params)]
    assert all(moved)

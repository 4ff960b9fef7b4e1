"""The port's augmentation against the JAX package's: each device
transform run with the JAX function's own draws (its key split as the JAX
function splits it) against the JAX function on the same key; the host
GT sampling and CBGS resampling exactly, from the same numpy generator;
the camera-frame flip exactly."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu import augment as J

from d3d_tpu_torch import augment as T
from d3d_tpu_torch.ops.box import box3dp_crop


def _scene(rng, n=500, m=4):
    """tests/test_augment.py's scene: m car-sized boxes, half the points
    inside them, an intensity column."""
    boxes = np.stack([
        rng.uniform(-20, 20, m), rng.uniform(-20, 20, m),
        rng.uniform(-1, 0, m), rng.uniform(3, 5, m),
        rng.uniform(1.5, 2, m), rng.uniform(1.4, 1.8, m),
        rng.uniform(-np.pi, np.pi, m)], axis=1).astype(np.float32)
    pts = [rng.uniform(-40, 40, (n // 2, 3)).astype(np.float32)]
    for b in boxes:
        c, s = np.cos(b[6]), np.sin(b[6])
        local = rng.uniform(-0.45, 0.45, (n // 2 // m, 3)).astype(
            np.float32) * b[3:6]
        world = local.copy()
        world[:, 0] = c * local[:, 0] - s * local[:, 1] + b[0]
        world[:, 1] = s * local[:, 0] + c * local[:, 1] + b[1]
        world[:, 2] = local[:, 2] + b[2]
        pts.append(world)
    pts = np.concatenate(pts)
    inten = rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)
    return np.concatenate([pts, inten], 1), boxes


def _jax_global_draws(key, flip_prob=0.5, rot_range=0.7854,
                      scale_range=(0.95, 1.05), translate_std=0.2):
    kf, kr, ks, kt = jax.random.split(key, 4)
    f32 = jnp.float32
    return (np.array(jax.random.bernoulli(kf, flip_prob)),
            np.array(jax.random.uniform(kr, (), f32, -rot_range, rot_range)),
            np.array(jax.random.uniform(ks, (), f32, *scale_range)),
            np.array(jax.random.normal(kt, (3,), f32) * translate_std))


def test_global_transform_matches():
    """Six keys (both flip outcomes among them): points and boxes within
    atol 2e-5 (coordinates up to ~47 m after the rotation and scale,
    where an f32 ulp is 3.8e-6: the JAX function rotates by a 2x2 matmul
    that XLA:CPU may fuse into multiply-adds, the port by elementwise
    products), the intensity column untouched."""
    flips = set()
    for seed in range(6):
        rng = np.random.default_rng(seed)
        pts, boxes = _scene(rng)
        key = jax.random.PRNGKey(seed)
        want = [np.asarray(a) for a in J.global_augment(
            key, jnp.asarray(pts), jnp.asarray(boxes))]
        draws = _jax_global_draws(key)
        flips.add(bool(draws[0]))
        got = T._global_transform(torch.from_numpy(pts),
                                  torch.from_numpy(boxes),
                                  *(torch.as_tensor(d) for d in draws))
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0,
                                   atol=2e-5)
        np.testing.assert_array_equal(got[0].numpy()[:, 3], pts[:, 3])
    assert flips == {False, True}


def test_global_augment_is_seeded_and_keeps_membership():
    """The generator decides the draws (equal seeds equal outputs, other
    seeds other ones), and points inside a box stay inside it (up to a
    few boundary points, as tests/test_augment.py allows)."""
    rng = np.random.default_rng(3)
    pts, boxes = _scene(rng)
    tp, tb = torch.from_numpy(pts), torch.from_numpy(boxes)
    a = T.global_augment(torch.Generator().manual_seed(7), tp, tb)
    b = T.global_augment(torch.Generator().manual_seed(7), tp, tb)
    c = T.global_augment(torch.Generator().manual_seed(8), tp, tb)
    assert torch.equal(a[0], b[0]) and not torch.allclose(a[0], c[0])
    before = box3dp_crop(tp[:, :3], tb)
    after = box3dp_crop(a[0][:, :3], a[1])
    for i in range(len(boxes)):
        assert int((before[i] ^ after[i]).sum()) <= max(
            2, int(before[i].sum()) // 20)


def _line_scene(rng, m=4, per=40, pad=2, spacing=15.0):
    """tests/test_augment.py's per-object scene: boxes on a line (closer
    together with a smaller ``spacing``), padded rows, points inside and
    background."""
    boxes = np.zeros((m + pad, 7), np.float32)
    for i in range(m):
        boxes[i] = [i * spacing - 20, (i % 2) * spacing / 3 - 5, -0.5,
                    4.0, 2.0, 1.6, rng.uniform(-np.pi, np.pi)]
    mask = np.zeros(m + pad, bool)
    mask[:m] = True
    pts = [rng.uniform(-60, 60, (200, 3)).astype(np.float32) + [0, 30, 0]]
    for b in boxes[:m]:
        c, s = np.cos(b[6]), np.sin(b[6])
        local = rng.uniform(-0.45, 0.45, (per, 3)).astype(np.float32) \
            * b[3:6]
        world = local.copy()
        world[:, 0] = c * local[:, 0] - s * local[:, 1] + b[0]
        world[:, 1] = s * local[:, 0] + c * local[:, 1] + b[1]
        world[:, 2] = local[:, 2] + b[2]
        pts.append(world)
    pts = np.concatenate(pts)
    feats = rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)
    return np.concatenate([pts, feats], axis=1), boxes, mask


def _jax_perobject_draws(key, m, rot_range=0.3925,
                         translate_std=(1.0, 1.0, 0.5)):
    kr, kt = jax.random.split(key)
    dtheta = jax.random.uniform(kr, (m,), jnp.float32, -rot_range,
                                rot_range)
    dt = jax.random.normal(kt, (m, 3), jnp.float32) * jnp.asarray(
        translate_std, jnp.float32)
    return np.asarray(dtheta), np.asarray(dt)


def _perobject_both(key, pts, boxes, mask, draws=None):
    want = [np.asarray(a) for a in J.perobject_augment(
        key, jnp.asarray(pts), jnp.asarray(boxes), jnp.asarray(mask))]
    dtheta, dt = draws if draws is not None else _jax_perobject_draws(
        key, len(boxes))
    got = T._perobject_transform(
        torch.from_numpy(pts), torch.from_numpy(boxes),
        torch.from_numpy(mask), torch.from_numpy(dtheta),
        torch.from_numpy(dt))
    return want, [g.numpy() for g in got]


@pytest.mark.parametrize("spacing", [15.0, 4.5])
def test_perobject_transform_matches(spacing):
    """Five keys on well-separated and on near-touching boxes (spacing
    4.5 m for 4 m cars: proposals collide and are rejected): the boxes
    (each accepted proposal or its original) equal, the points within
    atol 1e-5 (an f32 ulp is 3.8e-6 at 40 m; the rigid move is computed
    elementwise in both, XLA:CPU may fuse it into multiply-adds). Both
    outcomes of the collision test occur."""
    accepted = rejected = 0
    for seed in range(5):
        rng = np.random.default_rng(seed)
        pts, boxes, mask = _line_scene(rng, spacing=spacing)
        key = jax.random.PRNGKey(seed)
        want, got = _perobject_both(key, pts, boxes, mask)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0,
                                   atol=1e-5)
        moved = np.any(got[1] != boxes, axis=1)
        accepted += int(moved.sum())
        rejected += int((mask & ~moved).sum())
    assert accepted > 0 and (spacing > 10 or rejected > 0)


def test_perobject_point_in_two_boxes_goes_with_the_first():
    """Two overlapping original boxes whose proposals move far apart
    (both accepted): points in the overlap move with the lower-indexed
    box, the first maximum of the JAX function's ``argmax`` over the
    boolean (M, N) mask."""
    boxes = np.array([[0.0, 0.0, -0.5, 4.0, 2.0, 1.6, 0.0],
                      [3.0, 0.0, -0.5, 4.0, 2.0, 1.6, 0.0]], np.float32)
    mask = np.ones(2, bool)
    rng = np.random.default_rng(4)
    pts = np.concatenate([rng.uniform([1.1, -0.8, -1.0], [1.9, 0.8, 0.0],
                                      (20, 3)),
                          rng.uniform(0, 1, (20, 1))], 1).astype(np.float32)
    draws = (np.array([0.1, -0.2], np.float32),
             np.array([[-10.0, 0, 0], [10.0, 0, 0]], np.float32))
    got = [g.numpy() for g in T._perobject_transform(
        *(torch.from_numpy(a) for a in (pts, boxes, mask) + draws))]
    np.testing.assert_array_equal(got[1][:, 0], [-10.0, 13.0])  # accepted
    c, s = np.cos(0.1), np.sin(0.1)
    want = pts.copy()
    want[:, 0] = c * pts[:, 0] - s * pts[:, 1] - 10.0
    want[:, 1] = s * pts[:, 0] + c * pts[:, 1]
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-5)


def test_gt_database_and_sampling_exact():
    """``build_gt_database`` and ``sample_ground_truths`` (on the CPU)
    against the JAX package's from the same numpy generator: the same
    database (labels, boxes, local points) and the same pasted frame,
    exactly."""
    rng = np.random.default_rng(12)
    frames = []
    for _ in range(3):
        pts, boxes = _scene(rng, n=600, m=4)
        frames.append((pts, boxes, np.array([0, 0, 1, 1])))
    want_db = J.build_gt_database(frames, min_points=3)
    got_db = T.build_gt_database(frames, min_points=3, device="cpu")
    assert sorted(got_db) == sorted(want_db)
    for lab in want_db:
        assert len(got_db[lab]) == len(want_db[lab])
        for (gb, gl), (wb, wl) in zip(got_db[lab], want_db[lab]):
            np.testing.assert_array_equal(gb, wb)
            np.testing.assert_array_equal(gl, wl)
    tgt = rng.uniform(-40, 40, (200, 4)).astype(np.float32)
    for seed in range(2):
        args = (tgt, frames[0][1][:1], np.array([0]))
        want = J.sample_ground_truths(np.random.default_rng(seed), want_db,
                                      *args, max_per_class=3)
        got = T.sample_ground_truths(np.random.default_rng(seed), got_db,
                                     *args, max_per_class=3, device="cpu")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert len(got[1]) > 1


def test_class_balanced_frame_indices_exact():
    frame_classes = [[0], [0], [0, 1], [2], [], [0], [1, 1]]
    for kw in ({}, {"samples_per_class": 5}, {"shuffle": False}):
        want = J.class_balanced_frame_indices(
            frame_classes, np.random.default_rng(1), **kw)
        got = T.class_balanced_frame_indices(
            frame_classes, np.random.default_rng(1), **kw)
        np.testing.assert_array_equal(got, want)
    assert T.class_balanced_frame_indices([[]], np.random.default_rng(0)
                                          ).shape == (0,)


def test_flip_camera_frame_exact():
    """numpy and tensors, against the JAX function: the image, the
    intrinsics and the boxes equal (the yaw wraps into (-pi, pi])."""
    rng = np.random.default_rng(6)
    image = rng.random((4, 6, 3)).astype(np.float32)
    k = np.array([[700.0, 0, 300.5], [0, 700.0, 170.0], [0, 0, 1]],
                 np.float32)
    boxes = np.concatenate([rng.normal(size=(5, 6)),
                            [[-3.0], [-0.1], [0.0], [1.0], [3.1]]],
                           1).astype(np.float32)
    want = [np.asarray(a) for a in J.flip_camera_frame(image, k, boxes)]
    got = T.flip_camera_frame(image, k, boxes)
    got_t = T.flip_camera_frame(*(torch.from_numpy(a)
                                  for a in (image, k, boxes)))
    for g, t, w in zip(got, got_t, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(t.numpy(), w)

"""The port's rotated IoU (``d3d_tpu_torch.ops.geometry_soa``, the plain
version of kernel K1) against the JAX package: ``geometry_soa.rbox_iou``
and the Pallas tile kernel in interpret mode, on the same boxes; and the
port's array-of-structures geometry (``d3d_tpu_torch.ops.geometry``)
against ``d3d_tpu.ops.geometry``."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.ops import geometry_pallas as P
from d3d_tpu.ops import geometry_soa as S

from d3d_tpu_torch.ops import geometry_cuda as TC
from d3d_tpu_torch.ops import geometry_soa as TS


def _boxes(rng, n):
    return np.stack([
        rng.random(n) * 20,
        rng.random(n) * 20,
        rng.random(n) * 6 + 1,
        rng.random(n) * 6 + 1,
        rng.random(n) * 6 - 3,
    ], axis=1)


# (b1[i], b2[i]): identical, touching edge, touching corner, nested,
# edge-parallel overlap, 90-degree rotated, a square and itself turned 90
# degrees, disjoint, parallel at 45 degrees
_ADVERSARIAL = np.array([
    [[1.0, 2.0, 3.0, 1.5, 0.3], [1.0, 2.0, 3.0, 1.5, 0.3]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 0.0, 2.0, 2.0, 0.0]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [2.0, 2.0, 2.0, 2.0, 0.0]],
    [[0.0, 0.0, 4.0, 4.0, 0.2], [0.1, 0.1, 1.0, 1.0, 0.7]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [1.0, 0.5, 2.0, 2.0, 0.0]],
    [[0.0, 0.0, 3.0, 1.0, 0.0], [0.0, 0.0, 3.0, 1.0, np.pi / 2]],
    [[0.0, 0.0, 2.0, 2.0, 0.0], [0.0, 0.0, 2.0, 2.0, np.pi / 2]],
    [[0.0, 0.0, 1.0, 1.0, 0.0], [10.0, 10.0, 1.0, 1.0, 0.0]],
    [[0.0, 0.0, 2.0, 2.0, np.pi / 4], [0.5, 0.5, 2.0, 2.0, np.pi / 4]],
])


def test_sort_network_and_constants_match():
    assert TS._PAIRS24 == S._PAIRS24
    assert len(TS._PAIRS24) == 132
    assert (TS._BIGKEY, TS._KEYCUT) == (S._BIGKEY, S._KEYCUT)


def test_matrix_f32_matches_jax_and_pallas(rng):
    """Non-tile-aligned 37x155 with the first 5 boxes on both sides (the
    diagonal == 1 pairs), as tests/test_geometry_soa.py does for Pallas."""
    b1 = _boxes(rng, 37).astype(np.float32)
    b2 = np.concatenate([b1[:5], _boxes(rng, 150).astype(np.float32)])
    ref = np.asarray(S.rbox_iou(jnp.asarray(b1)[:, None],
                                jnp.asarray(b2)[None, :]))
    pallas = np.asarray(P.rbox_iou_matrix(jnp.asarray(b1), jnp.asarray(b2),
                                          interpret=True))
    launches = TC.rbox_iou_matrix.launches
    # the dispatcher (CPU -> plain) and the K1 wrapper given CPU tensors
    for got in (TS.rbox_iou_matrix(torch.from_numpy(b1),
                                   torch.from_numpy(b2)),
                TC.rbox_iou_matrix(torch.from_numpy(b1),
                                   torch.from_numpy(b2))):
        got = got.numpy()
        assert got.shape == (37, 155) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got, pallas, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got[:5, :5].diagonal(), 1.0, atol=1e-4)
    assert TC.rbox_iou_matrix.launches == launches


def test_adversarial_pairs_f32():
    b1 = _ADVERSARIAL[:, 0].astype(np.float32)
    b2 = _ADVERSARIAL[:, 1].astype(np.float32)
    ref = np.asarray(S.rbox_iou(jnp.asarray(b1)[:, None],
                                jnp.asarray(b2)[None, :]))
    pallas = np.asarray(P.rbox_iou_matrix(jnp.asarray(b1), jnp.asarray(b2),
                                          interpret=True))
    got = TS._rbox_iou_matrix_plain(torch.from_numpy(b1),
                                    torch.from_numpy(b2)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=2e-5)
    # closed forms on the diagonal: identical, touching (0), touching (0),
    # nested 1/16, offset 1x1.5 of 2x2 -> 1.5/6.5, cross 1/5, same square,
    # disjoint, 45-degree parallel offset
    diag = got.diagonal()
    np.testing.assert_allclose(diag[[0, 6]], 1.0, atol=1e-4)
    np.testing.assert_allclose(diag[[1, 2, 7]], 0.0, atol=1e-5)
    np.testing.assert_allclose(diag[3], 1 / 16, atol=1e-5)
    np.testing.assert_allclose(diag[4], 1.5 / 6.5, atol=1e-5)
    np.testing.assert_allclose(diag[5], 1 / 5, atol=1e-5)


def test_f64_matches_jax(rng):
    b1 = np.concatenate([_boxes(rng, 30), _ADVERSARIAL[:, 0]])
    b2 = np.concatenate([_boxes(rng, 20), _ADVERSARIAL[:, 1]])
    ref = np.asarray(S.rbox_iou(jnp.asarray(b1)[:, None],
                                jnp.asarray(b2)[None, :]))
    assert ref.dtype == np.float64
    got = TS.rbox_iou_matrix(torch.from_numpy(b1),
                             torch.from_numpy(b2)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


def test_row_blocking_is_invisible(rng):
    # a pair budget smaller than one row pass: several row chunks
    b1 = torch.from_numpy(_boxes(rng, 23))
    b2 = torch.from_numpy(_boxes(rng, 9))
    whole = TS._rbox_iou_matrix_plain(b1, b2)
    blocked = TS._rbox_iou_matrix_plain(b1, b2, pair_budget=40)
    assert torch.equal(whole, blocked)


@pytest.mark.parametrize("bad", [np.zeros((3, 4)), np.zeros((5,))])
def test_k1_wrapper_checks_shapes(bad):
    with pytest.raises(ValueError):
        TC.rbox_iou_matrix(torch.from_numpy(bad), torch.zeros(2, 5))


# ---------------------------------------------------------------------------
# the array-of-structures module (d3d_tpu_torch.ops.geometry) against
# d3d_tpu.ops.geometry: float64 to 1e-12 of the largest value, float32 to
# K1's 2e-5; every function, the stable angle sort and autograd
# ---------------------------------------------------------------------------

from d3d_tpu.ops import geometry as G  # noqa: E402

from d3d_tpu_torch.ops import geometry as TG  # noqa: E402

_PAIR_FNS = ("aabox_iou", "rbox_iou", "rbox_giou", "rbox_diou")


def _rel_err(got, want):
    scale = max(float(np.abs(want).max()), 1e-300)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


@pytest.fixture(scope="module")
def pair_boxes():
    rng = np.random.default_rng(7)
    b1 = np.concatenate([_boxes(rng, 24) * [0.4, 0.4, 1, 1, 1],
                         _ADVERSARIAL[:, 0]])
    b2 = np.concatenate([_boxes(rng, 20) * [0.4, 0.4, 1, 1, 1],
                         _ADVERSARIAL[:, 1]])
    return b1, b2


@pytest.fixture(scope="module")
def jax_pairs(pair_boxes):
    """The JAX functions on the (33, 1) x (1, 29) pair grid, once a module,
    in float64 and float32."""
    b1, b2 = pair_boxes
    out = {}
    for dt in (np.float64, np.float32):
        a, b = jnp.asarray(b1.astype(dt))[:, None], jnp.asarray(
            b2.astype(dt))[None]
        for name in _PAIR_FNS:
            out[name, dt] = np.asarray(getattr(G, name)(a, b))
    return out


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("name", _PAIR_FNS)
def test_pair_metrics_match_jax(pair_boxes, jax_pairs, name, dt):
    b1, b2 = pair_boxes
    got = getattr(TG, name)(torch.from_numpy(b1.astype(dt))[:, None],
                            torch.from_numpy(b2.astype(dt))[None]).numpy()
    want = jax_pairs[name, dt]
    assert got.dtype == want.dtype and got.shape == want.shape == (33, 29)
    if dt == np.float64:
        assert _rel_err(got, want) <= 1e-12
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
        # exactly +0.0 where JAX gives 0 (disjoint pairs)
        assert np.all(got[want == 0] == 0) and not np.signbit(
            got[want == 0]).any()


@pytest.mark.parametrize("name", _PAIR_FNS)
def test_pair_metric_gradients_match_jax(pair_boxes, name):
    """Autograd through the candidate masks, the stable angle sort and the
    hull's stack against jax.grad, float64, 1e-9 of each input's largest
    gradient, on the random pairs: the adversarial ones (identical and
    touching boxes) sit on kinks, where near-duplicate vertices whose
    angles differ by an ulp may order either way and give another
    subgradient."""
    b1, b2 = (b[:-len(_ADVERSARIAL)] for b in pair_boxes)
    fn = getattr(G, name)
    g1, g2 = jax.grad(lambda a, b: fn(a[:, None], b[None]).sum(),
                      argnums=(0, 1))(jnp.asarray(b1), jnp.asarray(b2))
    t1 = torch.from_numpy(b1).requires_grad_()
    t2 = torch.from_numpy(b2).requires_grad_()
    getattr(TG, name)(t1[:, None], t2[None]).sum().backward()
    for got, want in ((t1.grad, g1), (t2.grad, g2)):
        assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-9


def test_polygon_functions_match_jax(rng):
    """box2poly (float64 corners through trig.sincos), poly_area,
    poly_contains, poly_signed_distance, quad_intersection's candidates,
    intersect_area, convex_hull_area and seg1d_intersection, float64."""
    boxes = _boxes(rng, 12)
    pts = rng.random((40, 2)) * 20
    jp = G.box2poly(jnp.asarray(boxes))
    tp = TG.box2poly(torch.from_numpy(boxes))
    assert _rel_err(tp.numpy(), np.asarray(jp)) <= 1e-15
    assert _rel_err(TG.poly_area(tp).numpy(),
                    np.asarray(G.poly_area(jp))) <= 1e-12
    np.testing.assert_array_equal(
        TG.poly_contains(tp[:, None], torch.from_numpy(pts)[None]).numpy(),
        np.asarray(G.poly_contains(jp[:, None], jnp.asarray(pts)[None])))
    assert _rel_err(
        TG.poly_signed_distance(tp[:, None],
                                torch.from_numpy(pts)[None]).numpy(),
        np.asarray(G.poly_signed_distance(jp[:, None],
                                          jnp.asarray(pts)[None]))) <= 1e-12
    pj, mj = G.quad_intersection(jp[:, None], jp[None])
    pt, mt = TG.quad_intersection(tp[:, None], tp[None])
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert _rel_err(pt.numpy(), np.asarray(pj)) <= 1e-12
    assert _rel_err(TG.intersect_area(tp[:, None], tp[None]).numpy(),
                    np.asarray(G.intersect_area(jp[:, None], jp[None]))) \
        <= 1e-12
    hull_pts = rng.random((30, 8, 2)) * 5
    assert _rel_err(
        TG.convex_hull_area(torch.from_numpy(hull_pts)).numpy(),
        np.asarray(G.convex_hull_area(jnp.asarray(hull_pts)))) <= 1e-12
    seg = rng.random((4, 10))
    for got, want in zip(TG.seg1d_intersection(*torch.from_numpy(seg)),
                         G.seg1d_intersection(*jnp.asarray(seg))):
        assert _rel_err(got.numpy(), np.asarray(want)) <= 1e-15


def test_tied_angles_keep_candidate_order():
    """Identical boxes put every crossing on a corner: duplicate candidates
    with tied angles. The sort is stable, as jnp.argsort, so the ordered
    points and masks equal the JAX module's slot for slot."""
    box = np.array([[0.0, 0.0, 2.0, 2.0, 0.0], [1.0, 2.0, 3.0, 1.5, 0.3]])
    jp = G.box2poly(jnp.asarray(box))
    tp = TG.box2poly(torch.from_numpy(box))
    pj, mj = G._order_by_angle(*G.quad_intersection(jp, jp))
    pt, mt = TG._order_by_angle(*TG.quad_intersection(tp, tp))
    assert int(mt.sum()) > 8  # duplicates among the valid candidates
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert _rel_err(pt.numpy(), np.asarray(pj)) <= 1e-15


def test_3d_pair_ious_match_jax(rng):
    def boxes7(n):
        b = _boxes(rng, n)
        return np.concatenate([b[:, :2], rng.random((n, 1)), b[:, 2:4],
                               rng.random((n, 1)) + 1, b[:, 4:5]], 1)
    b1, b2 = boxes7(30), boxes7(30)
    b2[:10] = b1[:10] + rng.normal(0, 0.3, (10, 7))
    for name in ("box3dr_iou_pair", "box3d_iou_pair"):
        want = np.asarray(getattr(G, name)(jnp.asarray(b1), jnp.asarray(b2)))
        got = getattr(TG, name)(torch.from_numpy(b1),
                                torch.from_numpy(b2)).numpy()
        assert want[:10].min() > 0
        assert _rel_err(got, want) <= 1e-12

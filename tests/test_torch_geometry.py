"""The port's rotated IoU (``d3d_tpu_torch.ops.geometry_soa``, the plain
version of kernel K1) against the JAX package: ``geometry_soa.rbox_iou``
and the Pallas tile kernel in interpret mode, on the same boxes."""

import numpy as np
import pytest

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

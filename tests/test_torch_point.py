"""The port's ``aligned_scatter`` and ``nearest_neighbor`` against the JAX
package's on the same seeded inputs: every method on 1-, 2- and 3-D maps,
the integral-coordinate quirk, out-of-range clamps and wraps, NaN
coordinates, the feature map's gradient against ``jax.grad``; the nearest
neighbours against JAX and, km from the origin, against a float64 brute
force.

Tolerances: drop / nearest / max gather values, so they are exact; mean
and linear sum 2^m products in another order, within 4 float32 ulps of
the values' scale (1e-6 on maps of [0, 1)); gradients, sums of weights,
within 1e-6."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.ops.point import aligned_scatter, nearest_neighbor

from d3d_tpu_torch.ops import point as TP

METHODS = ("drop", "nearest", "mean", "linear", "max")


def _check_d2(d, query, ref, idx):
    """The f32 expansion |q|^2 - 2 q.r + |r|^2 of the recentred clouds
    rounds each term to within an ulp of its size: squared distances
    within 8 float32 epsilons of |q|^2 + |r|^2 of the float64 ones."""
    origin = query.mean(axis=0)
    q, r = query - origin, ref[idx] - origin
    bound = 8 * 2.0 ** -24 * ((q * q).sum(1) + (r * r).sum(1))
    err = np.abs(d.astype(np.float64) ** 2 - ((q - r) ** 2).sum(1))
    assert (err <= bound).all(), float((err / bound).max())
SPATIAL = {1: (7,), 2: (5, 6), 3: (3, 4, 5)}


def _coords(rng, spatial, b=2, n=40):
    """Fractional in-range points, integral points (the quirk), points
    past either border (clamped; -1.x drops to index -1, which wraps), one
    NaN in each column."""
    m = len(spatial)
    hi = np.array(spatial, np.float64) - 1
    frac = rng.random((n, m)) * hi
    integral = rng.integers(0, np.array(spatial), (6, m)).astype(np.float64)
    outside = np.where(rng.random((8, m)) < 0.5, -1.0 - rng.random((8, m)),
                       hi + 0.5 + rng.random((8, m)))
    pts = np.concatenate([frac, integral, outside])
    batch = rng.integers(0, b, (len(pts), 1)).astype(np.float64)
    coords = np.concatenate([batch, pts], 1)
    nan = np.full((m + 1, m + 1), 0.5)
    np.fill_diagonal(nan, np.nan)
    return np.concatenate([coords, nan]).astype(np.float32)


@pytest.fixture(scope="module")
def bank():
    """The JAX package's outputs and feature-map gradients, per (dims,
    method), computed once."""
    rng = np.random.default_rng(20261017)
    out = {}
    for m, spatial in SPATIAL.items():
        feat = rng.random((2, 3) + spatial).astype(np.float32)
        coords = _coords(rng, spatial)
        ct = rng.normal(size=(len(coords), 3)).astype(np.float32)
        for method in METHODS:
            want = np.asarray(aligned_scatter(jnp.asarray(coords),
                                              jnp.asarray(feat), method))
            grad = None
            if method in ("mean", "linear", "max"):
                grad = np.asarray(jax.grad(lambda f: jnp.sum(jnp.nan_to_num(
                    aligned_scatter(jnp.asarray(coords), f, method))
                    * ct))(jnp.asarray(feat)))
            out[m, method] = (feat, coords, ct, want, grad)
    return out


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("m", sorted(SPATIAL))
def test_aligned_scatter_matches(bank, m, method):
    """Values as the JAX package's (NaN where it gives NaN), numpy in ->
    numpy out; drop/nearest/max exact, mean/linear within 1e-6."""
    feat, coords, _, want, _ = bank[m, method]
    got = TP.aligned_scatter(coords, torch.from_numpy(feat), method)
    assert isinstance(got, np.ndarray) and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    tol = 0.0 if method in ("drop", "nearest", "max") else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, equal_nan=True)
    if method in ("drop", "nearest"):  # the NaN rows gather index 0
        assert np.isfinite(got).all()


@pytest.mark.parametrize("m", sorted(SPATIAL))
def test_integral_coordinates_double_the_linear_sum(bank, m):
    """At exactly integral in-range coordinates both lattice neighbours
    get weight 1: the linear sum is the cell's value times 2^m."""
    feat, coords, _, _, _ = bank[m, "linear"]
    pts = coords[40:46]
    got = TP.aligned_scatter(pts, torch.from_numpy(feat), "linear")
    ic = pts.astype(int)
    cell = np.stack([feat[(i[0], slice(None)) + tuple(i[1:])] for i in ic])
    np.testing.assert_allclose(got, cell * 2 ** m, rtol=1e-6)


def test_clamped_points_sum_to_the_border_value():
    """A point past every border: each axis' two neighbours clamp to the
    border cell at weight 0.5, so linear gives exactly the corner value."""
    feat = np.arange(2 * 1 * 3 * 4, dtype=np.float32).reshape(2, 1, 3, 4)
    pts = np.array([[1, -3.5, 9.25], [0, 7.0, -0.5]], np.float32)
    got = TP.aligned_scatter(pts, torch.from_numpy(feat), "linear")
    np.testing.assert_array_equal(got[:, 0], [feat[1, 0, 0, 3],
                                              feat[0, 0, 2, 0]])


@pytest.mark.parametrize("method", ("mean", "linear", "max"))
@pytest.mark.parametrize("m", sorted(SPATIAL))
def test_feature_map_gradient_matches(bank, m, method):
    """d(sum(out * ct))/d(feature_map) against jax.grad (the gather's
    scatter-add; the NaN rows' cotangent zeroed on both sides): within
    1e-6."""
    feat, coords, ct, _, want = bank[m, method]
    f = torch.from_numpy(feat).requires_grad_(True)
    out = TP.aligned_scatter(torch.from_numpy(coords), f, method)
    (torch.nan_to_num(out) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=0, atol=1e-6)


def test_aligned_scatter_rejects_bad_input():
    feat = torch.zeros((1, 2, 3, 3))
    with pytest.raises(ValueError, match="B x C"):
        TP.aligned_scatter(torch.zeros((4, 2)), feat)
    with pytest.raises(ValueError, match="Unsupported"):
        TP.aligned_scatter(torch.zeros((4, 3)), feat, "cubic")


def test_nearest_neighbor_matches_jax():
    """Against the JAX function on a seeded cloud with chunk sizes that do
    not divide it: indices equal, distances within the expansion's
    rounding of the float64 ones (``_check_d2``; XLA's dot rounds its
    cross term otherwise than the port's three products); at the
    integer grid's exact ties (equidistant in float64) each side's f32
    rounding of its cross term decides, so there both must pick one of
    the tied points. Empty and tiny queries."""
    rng = np.random.default_rng(5)
    ref = np.concatenate([rng.normal(0, 10, (3000, 3)),
                          rng.integers(-4, 4, (300, 3))])
    query = np.concatenate([rng.normal(0, 10, (700, 3)),
                            rng.integers(-4, 4, (60, 3)) + 0.5])
    for kw in (dict(), dict(q_chunk=96, r_chunk=500)):
        want = nearest_neighbor(query, ref, **kw)
        got = TP.nearest_neighbor(query, ref, device="cpu", **kw)
        apart = got[1] != want[1]
        d64 = [np.linalg.norm(query - ref[i], axis=1) for i in (got[1],
                                                                want[1])]
        np.testing.assert_array_equal(d64[0][apart], d64[1][apart])
        assert apart[:700].sum() == 0 and apart.sum() < 20
        _check_d2(got[0], query, ref, got[1])
        _check_d2(want[0], query, ref, want[1])
        assert got[1].dtype == np.int32 and got[0].dtype == np.float32
    d0, i0 = TP.nearest_neighbor(np.zeros((0, 3)), ref, device="cpu")
    assert d0.shape == i0.shape == (0,)
    d1, i1 = TP.nearest_neighbor(query[:7], ref[:3], device="cpu")
    np.testing.assert_array_equal(i1, nearest_neighbor(query[:7],
                                                       ref[:3])[1])


def test_nearest_neighbor_at_km_offsets_matches_float64():
    """World-frame coordinates km from the origin: the float64 recentring
    keeps every index equal to a float64 brute force; distances within
    the expansion's rounding (``_check_d2``)."""
    rng = np.random.default_rng(6)
    origin = np.array([3200.0, -4100.0, 110.0])
    ref = origin + rng.normal(0, 30, (5000, 3))
    query = origin + rng.normal(0, 30, (800, 3))
    d, i = TP.nearest_neighbor(query, ref, device="cpu")
    d2 = ((query[:, None, :] - ref[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(i, d2.argmin(1))
    _check_d2(d, query, ref, i)

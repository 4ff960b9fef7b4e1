"""The port's voxelizers against the JAX package on the same points:
``voxelize_dense_padded(order_mode="sorted")`` (reductions none and mean)
and ``voxelize_mean_fm``."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from d3d_tpu.ops import voxel as V

from d3d_tpu_torch.ops import voxel as TV

SHAPE = (16, 16, 2)
BOUNDS = np.array([0.0, 16.0, -8.0, 8.0, -3.0, 1.0], np.float32)


def _points(rng, n):
    """Points over the grid and half a cell beyond every face: some out of
    bounds, some with scaled coordinates in (-1, 0), which truncate into
    cell 0 with a negative offset."""
    return np.stack([rng.uniform(-0.5, 16.5, n), rng.uniform(-8.5, 8.5, n),
                     rng.uniform(-3.25, 1.25, n), rng.random(n)],
                    axis=1).astype(np.float32)


# 3000 points fill most of the 512 cells: max_voxels 200 keeps fewer voxels
# than there are occupied cells (the slice path), 5000 > N takes the gather
# path with empty trailing voxels
@pytest.mark.parametrize("max_voxels", [200, 5000])
@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_dense_padded_sorted_matches(rng, max_voxels, reduction):
    pts = _points(rng, 3000)
    want = V.voxelize_dense_padded(
        jnp.asarray(pts), SHAPE, jnp.asarray(BOUNDS), 8, max_voxels,
        reduction, order_mode="sorted")
    got = TV.voxelize_dense_padded(
        torch.from_numpy(pts), SHAPE, torch.from_numpy(BOUNDS), 8,
        max_voxels, reduction, order_mode="sorted")
    assert sorted(got) == sorted(want)
    for k in ("coords", "voxel_npoints", "nvoxels", "voxels", "voxel_pmask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    if reduction == "mean":
        # the f32 prefix sum is added in XLA:CPU's order, so the means agree
        # far inside the stated 1e-6 relative
        w = np.asarray(want.aggregates)
        np.testing.assert_allclose(got.aggregates.numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("n,max_voxels", [(3000, 300), (3000, 5000),
                                          (150, 400)])
def test_mean_fm_matches(rng, n, max_voxels):
    """More occupied cells than voxels, more voxels than cells, and fewer
    points than max_voxels + 1 (the sentinel-padding branch)."""
    pts_fm = np.ascontiguousarray(_points(rng, n).T)
    want = V.voxelize_mean_fm(jnp.asarray(pts_fm), SHAPE,
                              jnp.asarray(BOUNDS), max_voxels)
    got = TV.voxelize_mean_fm(torch.from_numpy(pts_fm), SHAPE,
                              torch.from_numpy(BOUNDS), max_voxels)
    for k in ("coords", "voxel_npoints", "nvoxels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the sums are integers; the last few f32 ops, (cell + offset) * size
    # + bound, round differently in XLA (fused multiply-add) by at most one
    # f32 ulp at the magnitude of that arithmetic: the bounds for xyz, the
    # [0, 1] range of the extra column
    agg = got.aggregates.numpy()
    w = np.asarray(want.aggregates)
    assert agg.shape == (4, max_voxels)
    scale = np.maximum(np.abs(w), np.array([[16.0], [8.0], [3.0], [1.0]]))
    assert np.all(np.abs(agg - w) <= np.spacing(scale.astype(np.float32)))


def test_prefix_sum_order(rng):
    x = torch.from_numpy(rng.random((1000, 3)).astype(np.float32) * 30)
    want = np.asarray(jnp.cumsum(jnp.asarray(x.numpy()), axis=0))
    np.testing.assert_array_equal(TV._cumsum_f32(x).numpy(), want)


def test_unported_modes_raise(rng):
    pts = torch.from_numpy(_points(rng, 50))
    bounds = torch.from_numpy(BOUNDS)
    with pytest.raises(NotImplementedError):
        TV.voxelize_dense_padded(pts, SHAPE, bounds, 4, 20, "none")
    with pytest.raises(NotImplementedError):
        TV.voxelize_dense_padded(pts, SHAPE, bounds, 4, 20, "max",
                                 order_mode="sorted")
    with pytest.raises(ValueError):
        TV.voxelize_dense_padded(pts, SHAPE, bounds, 4, 20, "median",
                                 order_mode="sorted")


# one good point and one with a NaN, on a 4^3 grid over
# [0, 4]^3. A float -> int32 cast of NaN gives 0 in XLA (and in CUDA's
# cvt.rzi), INT_MIN in torch on an x86 CPU: the port maps NaN to 0 first.
NAN_ROWS = {"x": [np.nan, 1.5, 1.5, 0.0], "xyz": [np.nan, np.nan, np.nan, 0.0],
            "intensity": [1.5, 1.5, 1.5, np.nan]}
NAN_SHAPE = (4, 4, 4)
NAN_BOUNDS = np.array([0.0, 4.0, 0.0, 4.0, 0.0, 4.0], np.float32)


@pytest.mark.parametrize("voxelizer", ["mean_fm", "dense_padded"])
@pytest.mark.parametrize("bad", sorted(NAN_ROWS))
def test_nan_point_lands_where_xla_puts_it(voxelizer, bad):
    pts = np.array([[2.5, 2.5, 2.5, 1.0], NAN_ROWS[bad]], np.float32)
    if voxelizer == "mean_fm":
        fm = np.ascontiguousarray(pts.T)
        want = V.voxelize_mean_fm(jnp.asarray(fm), NAN_SHAPE,
                                  jnp.asarray(NAN_BOUNDS), 4)
        got = TV.voxelize_mean_fm(torch.from_numpy(fm), NAN_SHAPE,
                                  torch.from_numpy(NAN_BOUNDS), 4)
        keys = ("coords", "voxel_npoints", "nvoxels", "aggregates")
    else:
        want = V.voxelize_dense_padded(
            jnp.asarray(pts), NAN_SHAPE, jnp.asarray(NAN_BOUNDS), 4, 4,
            "mean", order_mode="sorted")
        got = TV.voxelize_dense_padded(
            torch.from_numpy(pts), NAN_SHAPE, torch.from_numpy(NAN_BOUNDS),
            4, 4, "mean", order_mode="sorted")
        keys = ("coords", "voxel_npoints", "nvoxels", "voxels",
                "voxel_pmask", "aggregates")
    assert int(want["nvoxels"]) == int(got["nvoxels"]) == 2
    for k in keys:
        # NaN where the reference has NaN (the NaN point's own features),
        # the rest equal
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)

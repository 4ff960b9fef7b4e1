"""The port's voxelizers against the JAX package on the same points:
``voxelize_dense_padded`` (both order modes, every reduction),
``voxelize_mean_fm``, ``voxelize_mean_fm_exact``, the sparse and filter
cores, ``farthest_point_sampling`` and ``VoxelGenerator`` (dense and
sparse, every filter; also against the reference's spconv dump). Integer
outputs, voxel order, masks, max/min aggregates (NaN included), FPS
selections and kept points are exact; means as stated per test."""

from pathlib import Path

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

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
    """Every reduction and order mode of the JAX module is ported: what
    still raises is what raises there too, an unknown reduction, and a
    grid too large for int32 keys."""
    pts = torch.from_numpy(_points(rng, 50))
    bounds = torch.from_numpy(BOUNDS)
    for reduction in ("none", "max"):
        out = TV.voxelize_dense_padded(pts, SHAPE, bounds, 4, 20, reduction)
        assert out.coords.shape == (20, 3)
    with pytest.raises(ValueError):
        TV.voxelize_dense_padded(pts, SHAPE, bounds, 4, 20, "median",
                                 order_mode="sorted")
    with pytest.raises(ValueError):
        TV.voxelize_dense_padded(pts, (2048, 2048, 1024), bounds, 4, 20,
                                 "none")


# one good point and one with a NaN, on a 4^3 grid over
# [0, 4]^3. A float -> int32 cast of NaN gives 0 in XLA (and in CUDA's
# cvt.rzi), INT_MIN in torch on an x86 CPU: the port maps NaN to 0 first.
NAN_ROWS = {"x": [np.nan, 1.5, 1.5, 0.0], "xyz": [np.nan, np.nan, np.nan, 0.0],
            "intensity": [1.5, 1.5, 1.5, np.nan]}
NAN_SHAPE = (4, 4, 4)
NAN_BOUNDS = np.array([0.0, 4.0, 0.0, 4.0, 0.0, 4.0], np.float32)


@pytest.mark.parametrize("voxelizer", ["mean_fm", "dense_padded",
                                       "mean_fm_exact", "dense_encounter_max",
                                       "sparse"])
@pytest.mark.parametrize("bad", sorted(NAN_ROWS))
def test_nan_point_lands_where_xla_puts_it(voxelizer, bad):
    pts = np.array([[2.5, 2.5, 2.5, 1.0], NAN_ROWS[bad]], np.float32)
    fm = np.ascontiguousarray(pts.T)
    jb, tb = jnp.asarray(NAN_BOUNDS), torch.from_numpy(NAN_BOUNDS)
    if voxelizer in ("mean_fm", "mean_fm_exact"):
        want = getattr(V, "voxelize_" + voxelizer)(jnp.asarray(fm),
                                                   NAN_SHAPE, jb, 4)
        got = getattr(TV, "voxelize_" + voxelizer)(torch.from_numpy(fm),
                                                   NAN_SHAPE, tb, 4)
        keys = ("coords", "voxel_npoints", "nvoxels", "aggregates")
    elif voxelizer == "sparse":
        size = np.ones(3, np.float32)
        want = V.voxelize_sparse_padded(jnp.asarray(pts), jnp.asarray(size))
        got = TV.voxelize_sparse_padded(torch.from_numpy(pts),
                                        torch.from_numpy(size))
        keys = ("points_mapping", "coords", "voxel_npoints", "nvoxels")
    else:
        reduction, mode = (("mean", "sorted") if voxelizer == "dense_padded"
                           else ("max", "encounter"))
        want = V.voxelize_dense_padded(jnp.asarray(pts), NAN_SHAPE, jb, 4, 4,
                                       reduction, order_mode=mode)
        got = TV.voxelize_dense_padded(torch.from_numpy(pts), NAN_SHAPE, tb,
                                       4, 4, reduction, order_mode=mode)
        keys = ("coords", "voxel_npoints", "nvoxels", "voxels",
                "voxel_pmask", "aggregates")
    assert int(want["nvoxels"]) == int(got["nvoxels"]) == 2
    for k in keys:
        # NaN where the reference has NaN (the NaN point's own features),
        # the rest equal
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# encounter order, max/min, the exact limb mean, the sparse and filter
# cores, farthest-point sampling and VoxelGenerator
# ---------------------------------------------------------------------------

from d3d_tpu.ops import point as JP  # noqa: E402

from d3d_tpu_torch.ops import point as TP  # noqa: E402

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "voxel_data.npz"


@pytest.fixture(scope="module")
def nan_points():
    """3000 points over and around the grid, two of them with a NaN (an
    intensity, an x)."""
    pts = _points(np.random.default_rng(21), 3000)
    pts[5, 3] = np.nan
    pts[17, 0] = np.nan
    return pts


@pytest.mark.parametrize("max_voxels", [200, 5000])
@pytest.mark.parametrize("reduction", ["none", "mean", "max", "min"])
def test_dense_padded_encounter_matches(nan_points, max_voxels, reduction):
    """The JAX default order: voxel ids by first point. Everything exact;
    max/min bit-equal with the NaN propagated; means as the sorted test's
    (the prefix sum in XLA:CPU's order, 1e-6 relative)."""
    want = V.voxelize_dense_padded(
        jnp.asarray(nan_points), SHAPE, jnp.asarray(BOUNDS), 8, max_voxels,
        reduction)
    got = TV.voxelize_dense_padded(
        torch.from_numpy(nan_points), SHAPE, torch.from_numpy(BOUNDS), 8,
        max_voxels, reduction)
    assert sorted(got) == sorted(want)
    for k in ("coords", "voxel_npoints", "nvoxels", "voxels", "voxel_pmask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    if reduction == "mean":
        w = np.asarray(want.aggregates)
        np.testing.assert_allclose(got.aggregates.numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.nanmax(np.abs(w)))
    elif reduction != "none":
        w = np.asarray(want.aggregates)
        assert np.isnan(w).any()
        np.testing.assert_array_equal(got.aggregates.numpy(), w)


@pytest.mark.parametrize("reduction", ["max", "min"])
def test_dense_padded_sorted_extremes_match(nan_points, reduction):
    want = V.voxelize_dense_padded(
        jnp.asarray(nan_points), SHAPE, jnp.asarray(BOUNDS), 8, 200,
        reduction, order_mode="sorted")
    got = TV.voxelize_dense_padded(
        torch.from_numpy(nan_points), SHAPE, torch.from_numpy(BOUNDS), 8,
        200, reduction, order_mode="sorted")
    np.testing.assert_array_equal(got.aggregates.numpy(),
                                  np.asarray(want.aggregates))


def test_segment_structure_encounter_matches(rng):
    """The int32 dense-key path and the generic int64 path (invalid keys at
    the sentinel) give the JAX module's segment ids, slots, ranks and their
    inverse."""
    key = rng.integers(0, 40, 300)
    key[rng.random(300) < 0.1] = 41  # invalid: max_key + 1
    for max_key, k in ((40, key), (None, np.where(key == 41,
                                                  V._INT_SENTINEL, key))):
        want = V._segment_structure(jnp.asarray(k, jnp.int64), max_key)
        got = TV._segment_structure(torch.from_numpy(k), max_key)
        for name in ("order", "seg_id_s", "slot_s", "rank_of_seg",
                     "seg_of_rank", "npoints_seg", "seg_start", "seg_valid",
                     "nvoxels", "newseg_s", "valid_s"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(want[name]),
                                          err_msg=f"{name} {max_key}")


@pytest.mark.parametrize("n,max_voxels", [(3000, 300), (150, 400)])
def test_mean_fm_exact_matches(rng, n, max_voxels):
    """Integer outputs exact; the limbs' totals are exact integers, so the
    xyz means are bit-equal. The extra column's last step, mean * range +
    min, XLA:CPU fuses into one multiply-add: at most one f32 ulp there."""
    pts_fm = np.ascontiguousarray(_points(rng, n).T)
    want = V.voxelize_mean_fm_exact(jnp.asarray(pts_fm), SHAPE,
                                    jnp.asarray(BOUNDS), max_voxels)
    got = TV.voxelize_mean_fm_exact(torch.from_numpy(pts_fm), SHAPE,
                                    torch.from_numpy(BOUNDS), max_voxels)
    for k in ("coords", "voxel_npoints", "nvoxels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    agg, w = got.aggregates.numpy(), np.asarray(want.aggregates)
    assert agg.shape == (4, max_voxels)
    np.testing.assert_array_equal(agg[:3], w[:3])
    assert np.all(np.abs(agg[3] - w[3]) <= np.spacing(np.abs(w[3])))


def test_mean_fm_exact_wraps_int32_as_xla():
    big = torch.tensor([2 ** 31 - 1, 2 ** 31, -2 ** 31 - 1, 2 ** 33 + 5])
    assert TV._wrap_int32(big).tolist() == [2 ** 31 - 1, -2 ** 31,
                                            2 ** 31 - 1, 5]


@pytest.fixture(scope="module")
def sparse_cloud():
    rng = np.random.default_rng(22)
    pts = (rng.random((1500, 4)) * [1.2, 1.2, 1.2, 1.0] - [0.1, 0.1, 0.1,
                                                           0.0])
    pts[:300, :3] = rng.random((300, 3)) * 0.1  # one crowded corner
    return pts.astype(np.float32)


def test_sparse_padded_matches(sparse_cloud):
    size = np.full(3, 0.1, np.float32)
    want = V.voxelize_sparse_padded(jnp.asarray(sparse_cloud),
                                    jnp.asarray(size))
    got = TV.voxelize_sparse_padded(torch.from_numpy(sparse_cloud),
                                    torch.from_numpy(size))
    n = int(want.nvoxels)
    assert int(got.nvoxels) == n > 100
    for k in ("points_mapping", "coords", "voxel_npoints"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g[:n] if k != "points_mapping" else g,
                                      w[:n] if k != "points_mapping" else w,
                                      err_msg=k)


GEN_CASES = [
    dict(),
    dict(max_voxels=40, max_voxels_filter="trim"),
    dict(max_voxels=40, max_voxels_filter="descending"),
    dict(min_points=2, max_points=4, max_points_filter="trim"),
    dict(max_points=5, max_voxels=300, max_points_filter="farthest_sampling",
         max_voxels_filter="descending"),
    dict(dense=True, max_points=5, reduction="mean"),
    dict(dense=True, max_points=5, max_voxels=50, reduction="max"),
    dict(dense=True, max_points=3, max_voxels=60, reduction="min",
         max_voxels_filter="trim", max_points_filter="trim"),
]


@pytest.mark.parametrize("kw", GEN_CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()) or "default")
def test_voxel_generator_matches_jax(sparse_cloud, kw):
    """Sparse (every voxel and point filter) and dense (every reduction):
    the same keys, every array equal (means within 1e-6 relative)."""
    want = V.VoxelGenerator([0, 1, 0, 1, 0, 1], [10, 10, 10], **kw)(
        sparse_cloud)
    got = TV.VoxelGenerator([0, 1, 0, 1, 0, 1], [10, 10, 10], device="cpu",
                            **kw)(sparse_cloud)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if k == "aggregates" and kw.get("reduction") == "mean":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_voxel_generator_spconv_parity():
    """The reference's stored spconv VoxelGeneratorV2 dump."""
    data = np.load(FIXTURE)
    gen = TV.VoxelGenerator([0, 1, 0, 1, 0, 1], [10, 10, 10], max_points=5,
                            max_points_filter="trim", dense=True,
                            device="cpu")
    ret = gen(data["cloud"])
    np.testing.assert_allclose(ret.voxels, data["voxels"])
    np.testing.assert_array_equal(ret.coords, data["coords"])


def test_voxel_generator_validation_and_device():
    for kw in (dict(bounds=[0.05, 1, 0, 1, 0, 1]), dict(reduction="mean"),
               dict(reduction="median", dense=True),
               dict(max_points_filter="random"),
               dict(max_voxels_filter="random")):
        args = dict(bounds=[0, 1, 0, 1, 0, 1], device="cpu")
        args.update(kw)
        with pytest.raises(ValueError):
            TV.VoxelGenerator(shape=[10, 10, 10], **args)
    for kw in (dict(min_points=1), dict(max_points_filter="farthest_sampling"),
               dict(max_voxels_filter="descending")):
        with pytest.raises(NotImplementedError):
            TV.VoxelGenerator([0, 1, 0, 1, 0, 1], [10, 10, 10], dense=True,
                              device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TV.VoxelGenerator([0, 1, 0, 1, 0, 1], [10, 10, 10])


def test_farthest_point_sampling_matches_jax(rng):
    """Batched, with invalid slots, a batch with no valid slot, duplicate
    points and fewer valid points than k: the selections are equal."""
    xyz = rng.random((6, 40, 3)).astype(np.float32)
    xyz[1, 10:20] = xyz[1, 0]  # duplicates
    valid = rng.random((6, 40)) < 0.7
    valid[3] = False
    valid[4] = False
    valid[4, [5, 9, 30]] = True
    want = np.asarray(JP.farthest_point_sampling(jnp.asarray(xyz), 7,
                                                 jnp.asarray(valid)))
    got = TP.farthest_point_sampling(torch.from_numpy(xyz), 7,
                                     torch.from_numpy(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        TP.farthest_point_sampling(torch.from_numpy(xyz[0]), 5).numpy(),
        np.asarray(JP.farthest_point_sampling(jnp.asarray(xyz[0]), 5)))

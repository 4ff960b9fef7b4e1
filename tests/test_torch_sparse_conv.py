"""The port's sparse-conv core against the JAX package: neighbour maps,
``downsample_coords`` and ``sparse_to_dense`` exactly, and the plain
version of kernel K5 against the XLA ``subm_conv_apply`` and the Pallas
``subm_conv_fused`` (interpret mode) on the same numpy-seeded inputs."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from d3d_tpu.ops import sparse_conv as S
from d3d_tpu.ops.sparse_conv_pallas import subm_conv_fused

from d3d_tpu_torch.ops import sparse_conv as TS
from d3d_tpu_torch.ops import sparse_conv_cuda as TK

GRID = (8, 10, 6)


def _sites(rng, n_active, n_pad, grid=GRID):
    """n_active distinct cells of ``grid``, then padding rows with
    arbitrary (in-range) coords."""
    cells = np.stack(np.meshgrid(*[np.arange(g) for g in grid],
                                 indexing="ij"), -1).reshape(-1, 3)
    coords = np.full((n_pad, 3), 3, np.int32)
    coords[:n_active] = cells[rng.choice(len(cells), n_active,
                                         replace=False)]
    valid = np.arange(n_pad) < n_active
    return coords, valid


def _jt(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a)
                                              for a in arrays]


@pytest.mark.parametrize("ks", [3, 5])
def test_kernel_offsets_match(ks):
    np.testing.assert_array_equal(TS.kernel_offsets(ks),
                                  np.asarray(S.kernel_offsets(ks)))
    offs = TS.kernel_offsets(ks)
    np.testing.assert_array_equal(offs[::-1], -offs)  # centrosymmetric


def test_submanifold_map_matches(rng):
    coords, valid = _sites(rng, 200, 256)
    (jc, jv), (tc, tv) = _jt(coords, valid)
    want = np.asarray(S.build_neighbor_map(jc, jv, GRID))
    got = TS.build_neighbor_map(tc, tv, GRID)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[200:] == -1).all() and (want[:200, 13] == np.arange(200)).all()


def test_strided_map_matches(rng):
    coords, valid = _sites(rng, 150, 192)
    (jc, jv), (tc, tv) = _jt(coords, valid)
    joc, jov = S.downsample_coords(jc, jv, GRID, stride=2)
    # the same output sites on both sides, so the maps compare row by row
    oc, ov = np.array(joc), np.array(jov)
    want = np.asarray(S.build_neighbor_map_strided(joc, jov, jc, jv, GRID,
                                                   stride=2))
    got = TS.build_neighbor_map_strided(torch.from_numpy(oc),
                                        torch.from_numpy(ov), tc, tv, GRID,
                                        stride=2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_big_grid_map_matches_the_sort_join(rng):
    """A grid of 2^25 cells: the JAX package builds this map with its tagged
    sort join (its CPU canvas cap is 2^24), the port with its canvas."""
    grid = (512, 512, 128)
    coords = np.stack([rng.integers(0, 4, 300), rng.integers(0, 6, 300),
                       rng.integers(120, 128, 300)], 1).astype(np.int32)
    coords = np.unique(coords, axis=0)
    valid = np.ones(len(coords), bool)
    valid[-5:] = False
    (jc, jv), (tc, tv) = _jt(coords, valid)
    want = np.asarray(S.build_neighbor_map(jc, jv, grid))
    np.testing.assert_array_equal(
        TS.build_neighbor_map(tc, tv, grid).numpy(), want)


def test_grid_over_the_canvas_cap_is_not_ported():
    coords = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="sort-join"):
        TS.build_neighbor_map(coords, torch.ones(4, dtype=torch.bool),
                              (1024, 1024, 128))


@pytest.mark.parametrize("max_out", [None, 40, 10])
def test_downsample_coords_matches_on_valid_rows(rng, max_out):
    """Valid rows (unique keys, ascending) are equal; rows past them are
    padding in no fixed order (lax.sort is not stable). max_out 40 and 10
    bind: the first max_out keys are kept."""
    coords, valid = _sites(rng, 200, 256)
    (jc, jv), (tc, tv) = _jt(coords, valid)
    jo, jov = S.downsample_coords(jc, jv, GRID, stride=2, max_out=max_out)
    to, tov = TS.downsample_coords(tc, tv, GRID, stride=2, max_out=max_out)
    jov = np.asarray(jov)
    n_unique = len(np.unique(coords[valid] // 2, axis=0))
    assert n_unique == 59
    assert tov.shape == jov.shape == ((max_out or 256),)
    np.testing.assert_array_equal(tov.numpy(), jov)
    assert jov.sum() == min(n_unique, max_out or 256)
    np.testing.assert_array_equal(to.numpy()[jov], np.asarray(jo)[jov])


def test_sparse_to_dense_matches(rng):
    coords, valid = _sites(rng, 100, 128)
    feats = rng.normal(size=(128, 5)).astype(np.float32)
    (jc, jv, jf), (tc, tv, tf) = _jt(coords, valid, feats)
    want = np.asarray(S.sparse_to_dense(jf, jc, jv, GRID))
    got = TS.sparse_to_dense(tf, tc, tv, GRID).numpy()
    assert got.shape == GRID + (5,)
    np.testing.assert_array_equal(got, want)


def _conv_problem(rng, kind, c_in, c_out):
    """(features, nbr, weights, valid) numpy for a submanifold map, a
    strided map with as many output rows as input rows, or a strided map
    whose cap leaves fewer output rows (Nq < N)."""
    coords, valid = _sites(rng, 150, 192)
    feats = (rng.normal(size=(192, c_in)) * valid[:, None]).astype(np.float32)
    # LeCun-scaled weights, as a network holds them: outputs of order 1,
    # where f32 sums in another order differ by a few 1e-7
    w = (rng.normal(size=(27, c_in, c_out))
         / np.sqrt(27 * c_in)).astype(np.float32)
    jc, jv = jnp.asarray(coords), jnp.asarray(valid)
    if kind == "subm":
        return feats, np.array(S.build_neighbor_map(jc, jv, GRID)), w, valid
    max_out = 64 if kind == "strided_nq_lt_n" else None
    oc, ov = S.downsample_coords(jc, jv, GRID, stride=2, max_out=max_out)
    nbr = S.build_neighbor_map_strided(oc, ov, jc, jv, GRID, stride=2)
    return feats, np.array(nbr), w, np.array(ov)


@pytest.mark.parametrize("kind,c_in,c_out", [
    ("subm", 4, 16), ("subm", 16, 16), ("strided", 16, 32),
    ("strided_nq_lt_n", 32, 8)])
def test_conv_plain_matches_f32(rng, kind, c_in, c_out):
    """f32: the plain version against the XLA formulation and the Pallas
    kernel (K5's own semantics; Nq < N is padded to N for it, as the JAX
    module does on the TPU), rtol/atol 2e-6."""
    feats, nbr, w, valid = _conv_problem(rng, kind, c_in, c_out)
    nq = nbr.shape[0]
    want = np.asarray(S.subm_conv_apply(jnp.asarray(feats), jnp.asarray(nbr),
                                        jnp.asarray(w), jnp.asarray(valid)))
    pad = feats.shape[0] - nq
    fused = np.asarray(subm_conv_fused(
        jnp.asarray(feats),
        jnp.asarray(np.concatenate([nbr, np.full((pad, 27), -1, np.int32)])),
        jnp.asarray(w), jnp.asarray(np.concatenate([valid, np.zeros(pad,
                                                                     bool)])),
        False, True))[:nq]
    launches = TK.subm_conv.launches
    got = TS.subm_conv_apply(*(torch.from_numpy(a)
                               for a in (feats, nbr, w, valid)))
    assert TK.subm_conv.launches == launches
    assert got.shape == (nq, c_out) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), fused, rtol=2e-6, atol=2e-6)
    assert (got.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("kind,c_in,c_out", [("subm", 4, 16),
                                             ("strided_nq_lt_n", 32, 8)])
def test_conv_plain_matches_bf16(rng, kind, c_in, c_out):
    """bf16 features and weights (the weights cast to the features' dtype
    first), float32 accumulation, bf16 out. The two sides sum in other
    orders before the one rounding to bf16, so they may differ by one bf16
    ulp: stated bound 2^-7 of each value, plus 1e-3 of the largest one."""
    feats, nbr, w, valid = _conv_problem(rng, kind, c_in, c_out)
    f16 = jnp.asarray(feats, jnp.bfloat16)
    want = np.asarray(S.subm_conv_apply(f16, jnp.asarray(nbr), jnp.asarray(w),
                                        jnp.asarray(valid)).astype(
                                            jnp.float32))
    got = TS.subm_conv_apply(torch.from_numpy(feats).to(torch.bfloat16),
                             torch.from_numpy(nbr), torch.from_numpy(w),
                             torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                               atol=1e-3 * np.abs(want).max())

"""The port's sparse-conv core against the JAX package: neighbour maps,
``downsample_coords`` and ``sparse_to_dense`` exactly, and the plain
versions of kernels K5 and K6, forward and gradients, against the XLA
``subm_conv_apply`` and the Pallas ``subm_conv_fused`` (interpret mode) on
the same numpy-seeded inputs."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
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


def test_grid_over_the_canvas_cap_is_not_ported(rng):
    """A grid over the canvas cap (ported since) takes the sort join and
    gives the JAX package's map (its CPU route for this grid is its own
    sort join)."""
    grid = (1024, 1024, 128)
    coords = np.stack([rng.integers(0, 5, 200), rng.integers(1018, 1024, 200),
                       rng.integers(0, 6, 200)], 1).astype(np.int32)
    coords = np.unique(coords, axis=0)
    valid = np.ones(len(coords), bool)
    valid[::7] = False
    (jc, jv), (tc, tv) = _jt(coords, valid)
    want = np.asarray(S.build_neighbor_map(jc, jv, grid))
    got = TS.build_neighbor_map(tc, tv, grid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).sum() > len(coords)


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


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port_grads(feats, nbr, w, valid, cot, symmetric, dtype=torch.float32):
    """dfeat, dW of sum(subm_conv_apply(...) * cot) through the port's
    autograd (the plain versions on the CPU)."""
    tf, tn, tw, tv, tc = _t(feats, nbr, w, valid, cot)
    tf = tf.to(dtype).requires_grad_()
    tw.requires_grad_()
    out = TS.subm_conv_apply(tf, tn, tw, tv, symmetric=symmetric)
    assert out.grad_fn is not None and "SubmConv" in type(out.grad_fn).__name__
    (out.float() * tc).sum().backward()
    return tf.grad, tw.grad


@pytest.mark.parametrize("kind,c_in,c_out", [
    ("subm", 4, 16), ("subm", 16, 8), ("strided", 16, 32),
    ("strided_nq_lt_n", 32, 8)])
def test_conv_grads_match(rng, kind, c_in, c_out):
    """The port's gradients (K6's plain version for dW; K5's with mirrored
    weights for a submanifold map's dfeat, the scatter-add for a strided
    one) against jax.grad of the XLA subm_conv_apply and of the Pallas
    subm_conv_fused in interpret mode (its _dw_call and _fwd_call bodies;
    Nq < N padded to N for it, as the JAX module does). Sums in other
    orders: rtol/atol 1e-5, as tests/test_sparse_conv_pallas.py states."""
    feats, nbr, w, valid = _conv_problem(rng, kind, c_in, c_out)
    nq, n = nbr.shape[0], feats.shape[0]
    cot = rng.normal(size=(nq, c_out)).astype(np.float32)
    symmetric = kind == "subm"
    jn, jv, jc = jnp.asarray(nbr), jnp.asarray(valid), jnp.asarray(cot)
    want = jax.grad(lambda f, ww: jnp.sum(S.subm_conv_apply(
        f, jn, ww, jv) * jc), argnums=(0, 1))(jnp.asarray(feats),
                                              jnp.asarray(w))
    pad = n - nq
    nbr_full = jnp.asarray(np.concatenate([nbr, np.full((pad, 27), -1,
                                                         np.int32)]))
    valid_full = jnp.asarray(np.concatenate([valid, np.zeros(pad, bool)]))
    fused = jax.grad(lambda f, ww: jnp.sum(subm_conv_fused(
        f, nbr_full, ww, valid_full, symmetric, True)[:nq] * jc),
        argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    launches = (TK.subm_conv.launches, TK.subm_conv_dw.launches)
    got = _port_grads(feats, nbr, w, valid, cot, symmetric)
    assert (TK.subm_conv.launches, TK.subm_conv_dw.launches) == launches
    for g, wa, fu in zip(got, want, fused):
        np.testing.assert_allclose(g.numpy(), np.asarray(wa), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(fu), rtol=1e-5,
                                   atol=1e-5)
    assert (got[0].numpy()[~np.isin(np.arange(n), nbr)] == 0).all()


def test_dw_plain_matches_the_pallas_dw_call(rng):
    """K6's plain version against the Pallas kernel body of _dw_call run in
    the interpreter, on the same transposed operands: rtol/atol 1e-5."""
    from d3d_tpu.ops.sparse_conv_pallas import _dw_call

    feats, nbr, _, valid = _conv_problem(rng, "subm", 16, 8)
    g = (rng.normal(size=(nbr.shape[0], 8)) * valid[:, None]).astype(
        np.float32)
    want = np.asarray(_dw_call(jnp.asarray(feats.T), jnp.asarray(nbr.T),
                               jnp.asarray(g.T), True))
    got = TK.subm_conv_dw(*_t(feats, nbr, g))
    assert got.shape == (27, 16, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_conv_grads_bf16_features(rng):
    """bf16 features (the layer's compute dtype), f32 weights: autograd hands
    the backward a bf16 cotangent, which it upcasts, as _fused_bwd does;
    dW comes back f32 from the f32-converted features (rtol/atol 1e-5
    against the Pallas route in interpret mode), dfeat in bf16 (the two
    f32 sums may round to neighbouring bf16 values: one bf16 ulp, 2^-7
    relative, plus 1e-3 of the largest value)."""
    feats, nbr, w, valid = _conv_problem(rng, "subm", 8, 8)
    cot = rng.normal(size=(nbr.shape[0], 8)).astype(np.float32)
    fb = jnp.asarray(feats, jnp.bfloat16)
    jc = jnp.asarray(cot)
    want = jax.grad(lambda f, ww: jnp.sum(subm_conv_fused(
        f, jnp.asarray(nbr), ww, jnp.asarray(valid), True, True).astype(
            jnp.float32) * jc), argnums=(0, 1))(fb, jnp.asarray(w))
    dfeat, dw = _port_grads(feats, nbr, w, valid, cot, True, torch.bfloat16)
    assert dfeat.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(dw.numpy(), np.asarray(want[1]), rtol=1e-5,
                               atol=1e-5)
    wd = np.asarray(want[0].astype(jnp.float32))
    np.testing.assert_allclose(dfeat.float().numpy(), wd, rtol=2.0 ** -7,
                               atol=1e-3 * np.abs(wd).max())


@pytest.mark.parametrize("symmetric", [True, False])
def test_conv_gradcheck_f64(rng, symmetric):
    """torch.autograd.gradcheck of the port's gradient (the plain versions,
    which take float64 on the CPU) against finite differences."""
    coords, valid = _sites(rng, 20, 24)
    jc, jv = jnp.asarray(coords), jnp.asarray(valid)
    if symmetric:
        nbr, ov = np.array(S.build_neighbor_map(jc, jv, GRID)), valid
    else:
        oc, ov = S.downsample_coords(jc, jv, GRID, stride=2, max_out=16)
        nbr = np.array(S.build_neighbor_map_strided(oc, ov, jc, jv, GRID,
                                                    stride=2))
        ov = np.array(ov)
    feats = torch.from_numpy(rng.normal(size=(24, 3)) * valid[:, None])
    w = torch.from_numpy(rng.normal(size=(27, 3, 2)))
    tn, tv = _t(nbr, ov)
    assert torch.autograd.gradcheck(
        lambda f, ww: TS.subm_conv_apply(f, tn, ww, tv, symmetric=symmetric),
        (feats.requires_grad_(), w.requires_grad_()))


def test_symmetric_routes_dfeat(rng, monkeypatch):
    """``symmetric`` reaches the backward: a submanifold map's dfeat runs
    through K5 (``subm_conv`` on the cotangent with mirrored, transposed
    weights), a strided map's through the scatter-add; a map without a row
    per site cannot be symmetric."""
    calls = []
    real_conv, real_scatter = TK.subm_conv, TK._scatter_dfeat
    monkeypatch.setattr(TK, "subm_conv", lambda *a: calls.append(
        ("conv", a[2].shape)) or real_conv(*a))
    monkeypatch.setattr(TK, "_scatter_dfeat", lambda *a: calls.append(
        ("scatter",)) or real_scatter(*a))
    for kind, symmetric in (("subm", True), ("subm", False),
                            ("strided_nq_lt_n", False)):
        feats, nbr, w, valid = _conv_problem(rng, kind, 4, 6)
        calls.clear()
        _port_grads(feats, nbr, w, valid,
                    np.ones((nbr.shape[0], 6), np.float32), symmetric)
        want = [("conv", (27, 4, 6))] + (
            [("conv", (27, 6, 4))] if symmetric else [("scatter",)])
        assert calls == want, (kind, symmetric, calls)
    feats, nbr, w, valid = _conv_problem(rng, "strided_nq_lt_n", 4, 6)
    with pytest.raises(ValueError, match="symmetric"):
        TS.subm_conv_apply(*_t(feats, nbr, w, valid), symmetric=True)


def test_first_layer_takes_no_dfeat(rng, monkeypatch):
    """Features that need no gradient (SECOND's voxel means) get none: the
    backward runs K6 only, no K5 and no scatter."""
    calls = []
    monkeypatch.setattr(TK, "_scatter_dfeat", lambda *a: calls.append(1))
    feats, nbr, w, valid = _conv_problem(rng, "subm", 4, 6)
    tf, tn, tw, tv = _t(feats, nbr, w, valid)
    tw.requires_grad_()
    out = TS.subm_conv_apply(tf, tn, tw, tv, symmetric=True)
    monkeypatch.setattr(TK, "subm_conv", lambda *a: calls.append(2))
    out.sum().backward()
    assert calls == [] and tw.grad.shape == (27, 4, 6)


@pytest.mark.parametrize("case", ["repeats", "unique", "empty_refs"])
def test_match_sorted_matches(case):
    """The tagged sort join against the JAX package's, exactly: repeated
    refs give the last of them in row order, a repeated query only its
    first occurrence, invalid rows -1; a batch of query lists (one per
    kernel offset) gives each list's own join."""
    rng = np.random.default_rng(31)
    if case == "repeats":
        rk, qk = rng.integers(0, 30, 60), rng.integers(0, 30, (3, 50))
    elif case == "unique":
        rk, qk = rng.permutation(200)[:80], rng.permutation(200)[None, :90]
    else:
        rk, qk = np.arange(10), rng.integers(0, 10, (2, 20))
    rk, qk = rk.astype(np.int32), qk.astype(np.int32)
    rv = rng.random(rk.shape) < (0.0 if case == "empty_refs" else 0.8)
    qv = rng.random(qk.shape) < 0.8
    want = np.stack([np.asarray(S.match_sorted(*map(jnp.asarray,
                                                    (rk, rv, q, v))))
                     for q, v in zip(qk, qv)])
    got = TS.match_sorted(*map(torch.from_numpy, (rk, rv, qk, qv)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= 0).any() == (case != "empty_refs")


@pytest.mark.parametrize("strided", [False, True])
def test_sort_join_and_canvas_routes_agree(rng, monkeypatch, strided):
    """Both routes of the port's neighbour maps give the same map, and the
    JAX package's (as tests/test_sparse_conv.py::TestSortJoinFallback
    forces its routes with the cap)."""
    coords, valid = _sites(rng, 150, 192)
    (jc, jv), (tc, tv) = _jt(coords, valid)
    if strided:
        joc, jov = S.downsample_coords(jc, jv, GRID, stride=2)
        oc, ov = torch.from_numpy(np.array(joc)), torch.from_numpy(
            np.array(jov))
        want = np.asarray(S.build_neighbor_map_strided(joc, jov, jc, jv,
                                                       GRID, stride=2))

        def build():
            return TS.build_neighbor_map_strided(oc, ov, tc, tv, GRID, 2)
    else:
        want = np.asarray(S.build_neighbor_map(jc, jv, GRID))

        def build():
            return TS.build_neighbor_map(tc, tv, GRID)
    canvas = build()
    monkeypatch.setattr(TS, "_DENSE_CANVAS_MAX_CELLS", 0)
    sort_join = build()
    np.testing.assert_array_equal(canvas.numpy(), want)
    np.testing.assert_array_equal(sort_join.numpy(), want)
    assert sort_join.dtype == torch.int32 and sort_join.is_contiguous()


@pytest.mark.parametrize("c_in,c_out,dtype", [
    (5, 16, torch.bfloat16), (3, 7, torch.bfloat16), (5, 16, torch.float32),
    (6, 8, torch.bfloat16)])
def test_pad_channels_keeps_the_conv_and_its_gradients(rng, c_in, c_out,
                                                       dtype):
    """The K5/K6 wrappers pad feature rows that are no whole number of
    4-byte copies (a 5-column bf16 cloud: 10 bytes) with zero columns and
    the weights with zero input rows. The padded plain versions equal the
    unpadded ones exactly: the forward, K6's weight gradient sliced back
    to (K, C, Cout), and the features' and weights' gradients through
    autograd. Rows that already fit are left as they are."""
    feats, nbr, w, valid = _conv_problem(rng, "subm", c_in, c_out)
    tf, tn, tw, tv = _t(feats, nbr, w, valid)
    tf, tw = tf.to(dtype), tw.to(dtype)
    pf, pw = TK.pad_channels(tf, tw)
    if c_in * tf.element_size() % 4 == 0:
        assert pf is tf and pw is tw
    else:
        assert pf.shape[1] * pf.element_size() % 16 == 0
        assert pw.shape == (27, pf.shape[1], c_out)
        assert torch.equal(pf[:, :c_in], tf) and not pf[:, c_in:].any()
        assert torch.equal(pw[:, :c_in], tw) and not pw[:, c_in:].any()
    out = TK._subm_conv_plain(tf, tn, tw, tv)
    assert torch.equal(out, TK._subm_conv_plain(pf, tn, pw, tv))
    g = torch.from_numpy(rng.normal(size=(nbr.shape[0], c_out)).astype(
        np.float32)) * tv[:, None]
    assert torch.equal(TK._subm_conv_dw_plain(tf, tn, g),
                       TK._subm_conv_dw_plain(pf, tn, g)[:, :c_in])

    def grads(pad):
        f = tf.detach().clone().requires_grad_()
        ww = tw.detach().float().clone().requires_grad_()
        if pad:
            fp, wp = TK.pad_channels(f, ww)
            y = TS.subm_conv_apply(fp, tn, wp, tv, symmetric=True)
        else:
            y = TS.subm_conv_apply(f, tn, ww, tv, symmetric=True)
        (y.float() * g).sum().backward()
        return y.detach(), f.grad, ww.grad
    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)

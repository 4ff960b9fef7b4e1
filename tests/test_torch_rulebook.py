"""The rule book of the port's sparse-conv kernels (``ops/rulebook.py``)
against the JAX package's neighbour maps: every present (row, offset) pair
is scheduled exactly once; plain-torch emulations of K5's schedule (rows in
rule-book order, tiles that skip the offsets none of their rows has) and
of K6's (per-offset lists of present pairs, slabs summed in order) equal
the plain versions and the Pallas kernels in interpret mode; edge maps;
a prepared map gives what a bare one gives, forward and gradients; a numpy
emulation of the rule-book sort's passes (each chunk's stable ranks, its
look-back over the earlier chunks, the digit bases) equals a stable argsort;
and every C entry point's signature matches the argtypes ``ops/_build.py``
declares for it."""

import re

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax.numpy as jnp
import torch

from d3d_tpu.ops import sparse_conv as S
from d3d_tpu.ops.sparse_conv_pallas import _dw_call, subm_conv_fused

from d3d_tpu_torch.models import second as TSEC
from d3d_tpu_torch.models import presets
from d3d_tpu_torch.ops import _build
from d3d_tpu_torch.ops import sparse_conv as TS
from d3d_tpu_torch.ops import sparse_conv_cuda as TK
from d3d_tpu_torch.ops import stage_maps as TSM
from d3d_tpu_torch.ops import rulebook as RB
from d3d_tpu_torch.ops.rulebook import RuleBook, prepare_neighbor_map

GRID = (8, 10, 6)
K = 27


def _sites(rng, n_active, n_pad, grid=GRID):
    cells = np.stack(np.meshgrid(*[np.arange(g) for g in grid],
                                 indexing="ij"), -1).reshape(-1, 3)
    coords = np.full((n_pad, 3), 3, np.int32)
    coords[:n_active] = cells[rng.choice(len(cells), n_active,
                                         replace=False)]
    return coords, np.arange(n_pad) < n_active


def _jax_map(rng, kind):
    """(nbr, valid, N) from the JAX package's map builders: a submanifold
    map, a strided map capped below N (Nq < N), or two frames' submanifold
    maps joined as SECOND joins a batch (``_offset``)."""
    coords, valid = _sites(rng, 150, 192)
    jc, jv = jnp.asarray(coords), jnp.asarray(valid)
    if kind == "subm":
        return np.array(S.build_neighbor_map(jc, jv, GRID)), valid, 192
    if kind == "strided":
        oc, ov = S.downsample_coords(jc, jv, GRID, stride=2, max_out=64)
        nbr = S.build_neighbor_map_strided(oc, ov, jc, jv, GRID, stride=2)
        return np.array(nbr), np.array(ov), 192
    c2, v2 = _sites(rng, 120, 192)
    maps = [np.array(S.build_neighbor_map(jnp.asarray(c), jnp.asarray(v),
                                          GRID)) for c, v in
            ((coords, valid), (c2, v2))]
    joined = torch.cat([TSM._offset(torch.from_numpy(m), b * 192)
                        for b, m in enumerate(maps)])
    return joined.numpy(), np.concatenate([valid, v2]), 384


def _edge_map(rng, kind):
    """(nbr, valid, N) edge maps: every neighbour absent, every neighbour
    present, one offset absent everywhere, invalid rows that keep their
    neighbours, Nq not a multiple of any tile, Nq < N."""
    nq, n = {"nq_lt_n": (20, 50), "ragged": (37, 37)}.get(kind, (40, 40))
    nbr = rng.integers(0, n, (nq, K)).astype(np.int32)
    present = rng.random((nq, K)) < 0.3
    valid = np.ones(nq, bool)
    if kind == "all_absent":
        present[:] = False
    elif kind == "all_present":
        present[:] = True
    elif kind == "one_offset_empty":
        present[:, 5] = False
    elif kind == "invalid_rows":
        valid[rng.random(nq) < 0.4] = False
    nbr[~present] = -1
    return nbr, valid, n


MAPS = ["subm", "strided", "joined"]
EDGES = ["all_absent", "all_present", "one_offset_empty", "invalid_rows",
         "ragged", "nq_lt_n"]


def _problem(rng, kind, c_in=8, c_out=16):
    nbr, valid, n = (_jax_map if kind in MAPS else _edge_map)(rng, kind)
    feats = rng.normal(size=(n, c_in)).astype(np.float32)
    w = (rng.normal(size=(K, c_in, c_out)) / np.sqrt(K * c_in)).astype(
        np.float32)
    return feats, nbr, w, valid


def _k5_schedule(feats, rules, w, valid, tile_rows):
    """K5's schedule in plain torch: output rows in rule-book order, tiles
    of ``tile_rows`` rows, each tile adding its gathered rows times W[k] for
    the offsets (ascending) that some row of the tile has, absent rows
    zero; every row written once (the output starts as NaN). Returns the
    output and the (row, offset) pairs multiplied."""
    (nq, k_off), cout = rules.shape, w.shape[2]
    out = torch.full((nq, cout), float("nan"))
    order = rules.order.long()
    done = 0
    for t0 in range(0, nq, tile_rows):
        rows = order[t0:t0 + tile_rows]
        nb = rules.nbr[rows]
        acc = torch.zeros((len(rows), cout))
        for k in range(k_off):
            if not bool((nb[:, k] >= 0).any()):
                continue  # no row of the tile has offset k
            x = torch.where((nb[:, k] >= 0)[:, None],
                            feats[nb[:, k].clamp(min=0).long()], 0)
            acc += x @ w[k]
            done += len(rows)
        out[rows] = acc * valid[rows, None]
    return out, done


def _k6_schedule(feats, rules, g, slab):
    """K6's schedule in plain torch: per offset, its list of present pairs
    in slabs of ``slab`` entries, each slab's partial product summed in
    slab order. Returns dW and the pairs multiplied."""
    out_rows, counts = rules.pairs()
    dw = torch.zeros((K, feats.shape[1], g.shape[1]))
    done = 0
    for k in range(K):
        cnt = int(counts[k])
        for j0 in range(0, cnt, slab):
            rows = out_rows[k, j0:min(cnt, j0 + slab)].long()
            dw[k] += feats[rules.nbr[rows, k].long()].T @ g[rows]
            done += len(rows)
    return dw, done


@pytest.mark.parametrize("kind", MAPS + EDGES)
def test_every_present_pair_is_scheduled_once(rng, kind):
    """K5: the rule-book order is a permutation of the rows, so every
    present pair lies in exactly one tile, whose offsets include it; the
    masks are the presence bits. K6: the lists hold each present (query
    row, offset) exactly once, in ascending query row, and -1 past their
    counts."""
    _, nbr, _, _ = _problem(rng, kind)
    rules = prepare_neighbor_map(torch.from_numpy(nbr))
    nq = nbr.shape[0]
    assert rules.masks.dtype == torch.int32
    assert rules.order.dtype == torch.int64
    assert sorted(rules.order.tolist()) == list(range(nq))
    m = rules.masks[rules.order.long()].numpy()
    assert (np.diff(m) >= 0).all()                       # sorted by mask
    bits = (nbr >= 0).astype(np.int64) << np.arange(K)
    np.testing.assert_array_equal(rules.masks.numpy(), bits.sum(1))
    out_rows, counts = (t.numpy() for t in rules.pairs())
    assert out_rows.shape == (K, nq) and counts.dtype == np.int64
    got = set()
    for k in range(K):
        cnt = counts[k]
        assert cnt == (nbr[:, k] >= 0).sum()
        assert (np.diff(out_rows[k, :cnt]) > 0).all()
        assert (out_rows[k, cnt:] == -1).all()
        got |= {(r, k, nbr[r, k]) for r in out_rows[k, :cnt]}
    want = {(r, k, nbr[r, k]) for r, k in zip(*np.nonzero(nbr >= 0))}
    assert got == want and len(want) == counts.sum()
    assert rules.pairs()[0] is rules.pairs()[0]          # built once


@pytest.mark.parametrize("kind", MAPS + EDGES)
def test_k5_schedule_matches_the_plain_version(rng, kind):
    """The emulated K5 schedule at the kernel's own tile and at small tiles
    (so that the test maps span several) against ``_subm_conv_plain``:
    rtol/atol 2e-6 (f32 sums in another order); every row written; the
    multiplied pairs counted by ``RuleBook.k5_schedule``, never fewer than
    the present ones."""
    feats, nbr, w, valid = _problem(rng, kind)
    tf, tn, tw, tv = (torch.from_numpy(a) for a in (feats, nbr, w, valid))
    rules = prepare_neighbor_map(tn)
    want = TK._subm_conv_plain(tf, tn, tw, tv)
    # 128: the kernel's tile at Cout = 16 (2048 outputs, 16 columns)
    for tile in (4, 16, 128):
        got, done = _k5_schedule(tf, rules, tw, tv, tile)
        assert not bool(torch.isnan(got).any())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6,
                                   atol=2e-6)
        present, scheduled = rules.k5_schedule(tile)
        assert present == int((tn >= 0).sum()) and scheduled == done
        assert present <= scheduled <= nbr.shape[0] * K
    if kind == "all_absent":
        assert rules.k5_schedule(4)[1] == 0


@pytest.mark.parametrize("kind", MAPS)
def test_k5_schedule_matches_the_pallas_kernel(rng, kind):
    """Against ``subm_conv_fused`` in interpret mode (Nq < N padded to N for
    it, as the JAX module does on the TPU): rtol/atol 2e-6."""
    feats, nbr, w, valid = _problem(rng, kind)
    n, nq = feats.shape[0], nbr.shape[0]
    pad = n - nq
    fused = np.asarray(subm_conv_fused(
        jnp.asarray(feats),
        jnp.asarray(np.concatenate([nbr, np.full((pad, K), -1, np.int32)])),
        jnp.asarray(w),
        jnp.asarray(np.concatenate([valid, np.zeros(pad, bool)])),
        False, True))[:nq]
    rules = prepare_neighbor_map(torch.from_numpy(nbr))
    got, _ = _k5_schedule(torch.from_numpy(feats), rules, torch.from_numpy(w),
                          torch.from_numpy(valid), 16)
    np.testing.assert_allclose(got.numpy(), fused, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("kind", MAPS + EDGES)
def test_k6_schedule_matches_the_plain_version(rng, kind):
    """The emulated K6 schedule (slabs of 512 entries, as the kernel, and of
    7, so that lists span several) against ``_subm_conv_dw_plain``:
    rtol/atol 1e-5 (sums over up to 384 rows in another order); it
    multiplies exactly the present pairs."""
    feats, nbr, _, valid = _problem(rng, kind)
    g = (rng.normal(size=(nbr.shape[0], 16)) * valid[:, None]).astype(
        np.float32)
    tf, tn, tg = (torch.from_numpy(a) for a in (feats, nbr, g))
    rules = prepare_neighbor_map(tn)
    want = TK._subm_conv_dw_plain(tf, tn, tg)
    for slab in (7, TK._DW_SLAB):
        got, done = _k6_schedule(tf, rules, tg, slab)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert done == int((tn >= 0).sum())


@pytest.mark.parametrize("kind", MAPS)
def test_k6_schedule_matches_the_pallas_dw_call(rng, kind):
    """Against the Pallas ``_dw_call`` body in the interpreter, on the same
    transposed operands (Nq < N padded with absent rows): rtol/atol 1e-5."""
    feats, nbr, _, valid = _problem(rng, kind)
    n, nq = feats.shape[0], nbr.shape[0]
    g = (rng.normal(size=(nq, 16)) * valid[:, None]).astype(np.float32)
    pad = n - nq
    nbr_full = np.concatenate([nbr, np.full((pad, K), -1, np.int32)])
    g_full = np.concatenate([g, np.zeros((pad, 16), np.float32)])
    want = np.asarray(_dw_call(jnp.asarray(feats.T), jnp.asarray(nbr_full.T),
                               jnp.asarray(g_full.T), True))
    rules = prepare_neighbor_map(torch.from_numpy(nbr))
    got, _ = _k6_schedule(torch.from_numpy(feats), rules, torch.from_numpy(g),
                          64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_the_first_layer_tile_skips_absent_offsets(rng):
    """On a sparse map (a few neighbours a row) the sorted tiles multiply
    far fewer pairs than every row at every offset, and tiles of padding
    rows none."""
    coords, valid = _sites(rng, 60, 256)
    nbr = TS.build_neighbor_map(torch.from_numpy(coords),
                                torch.from_numpy(valid), GRID)
    rules = prepare_neighbor_map(nbr)
    present, scheduled = rules.k5_schedule(16)
    assert scheduled < 0.5 * 256 * K
    assert rules.masks[rules.order.long()][:196].eq(0).all()


@pytest.mark.parametrize("kind,symmetric", [("subm", True),
                                            ("strided", False),
                                            ("joined", True)])
def test_prepared_map_equals_a_bare_map(rng, kind, symmetric):
    """``subm_conv_apply`` with a rule book gives the bits a bare map gives,
    output and both gradients, and the backward sees the same rule book
    object the forward took."""
    feats, nbr, w, valid = _problem(rng, kind, 4, 8)
    cot = torch.from_numpy(rng.normal(size=(nbr.shape[0], 8)).astype(
        np.float32))
    results = []
    for prepared in (False, True):
        tf, tw = (torch.from_numpy(a).requires_grad_() for a in (feats, w))
        tn, tv = torch.from_numpy(nbr), torch.from_numpy(valid)
        m = prepare_neighbor_map(tn) if prepared else tn
        out = TS.subm_conv_apply(tf, m, tw, tv, symmetric=symmetric)
        (out * cot).sum().backward()
        results.append((out.detach(), tf.grad, tw.grad))
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_backward_reuses_the_forward_rule_book(rng, monkeypatch):
    """One rule book serves the forward K5, K6 and the mirrored K5."""
    seen = []
    real_conv, real_dw = TK.subm_conv, TK.subm_conv_dw
    monkeypatch.setattr(TK, "subm_conv", lambda *a: seen.append(a[1])
                        or real_conv(*a))
    monkeypatch.setattr(TK, "subm_conv_dw", lambda *a: seen.append(a[1])
                        or real_dw(*a))
    feats, nbr, w, valid = _problem(rng, "subm", 4, 8)
    tf, tw = (torch.from_numpy(a).requires_grad_() for a in (feats, w))
    rules = prepare_neighbor_map(torch.from_numpy(nbr))
    TS.subm_conv_apply(tf, rules, tw, torch.from_numpy(valid),
                       symmetric=True).sum().backward()
    assert len(seen) == 3 and all(s is rules for s in seen)


def test_kernel_wrappers_take_a_rule_book_on_the_cpu(rng):
    """The wrappers take a map or its rule book; on CPU tensors both run
    the plain versions and count no launch."""
    feats, nbr, w, valid = _problem(rng, "strided", 8, 4)
    tf, tn, tw, tv = (torch.from_numpy(a) for a in (feats, nbr, w, valid))
    rules = prepare_neighbor_map(tn)
    counts = (TK.subm_conv.launches, TK.subm_conv_dw.launches)
    assert torch.equal(TK.subm_conv(tf, rules, tw, tv),
                       TK.subm_conv(tf, tn, tw, tv))
    g = torch.ones((nbr.shape[0], 4))
    assert torch.equal(TK.subm_conv_dw(tf, rules, g),
                       TK.subm_conv_dw(tf, tn, g))
    assert (TK.subm_conv.launches, TK.subm_conv_dw.launches) == counts


def test_more_offsets_than_mask_bits_only_on_the_cpu(rng):
    """Maps of 4x4x4 (64) and 5x5x5 (125) offsets, more than a 31-bit mask
    holds, have a rule book like any other (the kernels take them on CUDA
    too): offset k folds onto mask bit k mod 31, the order is the stable
    sort of the folded masks, the emulated K5 schedule (tiles walking the
    offsets present in the map, in several mask words) equals the plain
    version at the kernel's tile and at small tiles, and K6's lists hold
    every present pair. The name is kept from when only the CPU took
    them."""
    for k, size in ((64, 4), (125, 5)):
        coords, valid = _sites(rng, 150, 192)
        nbr = TS.build_neighbor_map(torch.from_numpy(coords),
                                    torch.from_numpy(valid), GRID,
                                    kernel_size=size)
        assert nbr.shape == (192, k)
        rules = RuleBook(nbr)
        present = (nbr >= 0).numpy()
        fold = np.zeros((192, 31), bool)
        for j in range(k):
            fold[:, j % 31] |= present[:, j]
        np.testing.assert_array_equal(rules.masks.numpy(),
                                      (fold << np.arange(31)).sum(1))
        np.testing.assert_array_equal(
            rules.order.numpy(), np.argsort(rules.masks.numpy(),
                                            kind="stable"))
        _, counts = rules.pairs()
        assert counts.tolist() == present.sum(0).tolist()
        feats = torch.from_numpy(rng.normal(size=(192, 8)).astype(
            np.float32))
        w = torch.from_numpy((rng.normal(size=(k, 8, 16)) / np.sqrt(
            k * 8)).astype(np.float32))
        tv = torch.from_numpy(valid)
        want = TK._subm_conv_plain(feats, nbr, w, tv)
        assert torch.equal(TK.subm_conv(feats, rules, w, tv), want)
        for tile in (4, 16, 128):
            got, done = _k5_schedule(feats, rules, w, tv, tile)
            assert not bool(torch.isnan(got).any())
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6,
                                       atol=2e-6)
            assert rules.k5_schedule(tile) == (int(present.sum()), done)


def test_rule_book_rejects_what_is_not_a_map():
    with pytest.raises(ValueError, match="int32"):
        RuleBook(torch.zeros((3, 27), dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        RuleBook(torch.zeros(27, dtype=torch.int32))


def test_batch_stage_maps_prepare_each_joined_map_once(monkeypatch):
    """SECOND prepares each joined map of a batch once, all in one call: a
    submanifold and a strided map for each stage but the last, which has
    only the former (``_prepare_maps``, which ``_batch_stage_maps`` runs on
    CUDA). On the CPU the plain versions read bare maps: no rule book."""
    calls = []
    real = TSEC.prepare_neighbor_maps
    monkeypatch.setattr(TSEC, "prepare_neighbor_maps", lambda nbrs: calls.append(
        [tuple(n.shape) for n in nbrs]) or real(nbrs))
    cfg = presets.second_kitti(
        dtype="float32", bounds=(0.0, 6.4, -3.2, 3.2, -3.0, 1.0),
        grid=(16, 16, 8), max_voxels=64, stage_sites=(64, 32, 16),
        head_channels=8)
    rng = np.random.default_rng(3)
    coords = torch.from_numpy(rng.integers(0, 8, (2, 64, 3)).astype(np.int32))
    valid = torch.ones((2, 64), dtype=torch.bool)
    maps, _ = TSEC._batch_stage_maps(cfg, coords, valid)
    assert calls == []
    for nbr, _, nbr_s, _ in maps:
        assert not isinstance(nbr, RuleBook)
        assert not isinstance(nbr_s, RuleBook)
    prepared = TSEC._prepare_maps(maps)
    assert calls == [[(128, 27), (64, 27), (64, 27), (32, 27), (32, 27)]]
    for (nbr, v, nbr_s, v_s), (rb, pv, rb_s, pv_s) in zip(maps, prepared):
        assert v is pv and v_s is pv_s
        for bare, book in ((nbr, rb), (nbr_s, rb_s)):
            if bare is None:
                assert book is None
                continue
            assert isinstance(book, RuleBook) and torch.equal(book.nbr, bare)
            assert torch.equal(book.order, RuleBook(bare).order)


@pytest.mark.parametrize("kinds", [MAPS, EDGES, ["subm"], MAPS + EDGES])
def test_maps_prepared_together_equal_each_alone(rng, kinds):
    """``prepare_neighbor_maps`` (all maps in one call) gives each map the
    masks, order and K6 lists its own ``prepare_neighbor_map`` gives."""
    nbrs = [torch.from_numpy(_problem(rng, kind)[1]) for kind in kinds]
    for nbr, book in zip(nbrs, TS.prepare_neighbor_maps(nbrs)):
        alone = prepare_neighbor_map(nbr)
        assert torch.equal(book.nbr, nbr)
        assert torch.equal(book.masks, alone.masks)
        assert torch.equal(book.order, alone.order)
        for a, b in zip(book.pairs(), alone.pairs()):
            assert torch.equal(a, b)


def test_rule_book_wrapper_runs_its_plain_version_on_the_cpu(rng):
    """``subm_conv_rulebook`` on CPU maps is its plain version and counts
    no launch: each map's masks are its presence bits and its order the
    stable sort of its own masks."""
    from d3d_tpu_torch.ops import rulebook as RB

    nbrs = [torch.from_numpy(_problem(rng, kind)[1]) for kind in MAPS]
    launches = RB.subm_conv_rulebook.launches
    masks, orders = RB.subm_conv_rulebook(nbrs)
    assert RB.subm_conv_rulebook.launches == launches
    for nbr, m, o in zip(nbrs, masks, orders):
        bits = ((nbr >= 0).long() << torch.arange(K)).sum(1)
        assert torch.equal(m.long(), bits)
        assert torch.equal(o, torch.sort(m, stable=True).indices)


def test_maps_prepared_together_share_k():
    with pytest.raises(ValueError, match="share K"):
        TS.prepare_neighbor_maps([torch.zeros((3, 27), dtype=torch.int32),
                                  torch.zeros((3, 8), dtype=torch.int32)])
    with pytest.raises(ValueError, match="int32"):
        TS.prepare_neighbor_maps([torch.zeros((3, 27), dtype=torch.int64)])


def _c_signatures():
    """{C function: its parameters as 'P' (pointer), 'I' (int), 'L' (long
    long), 'F' (float) or 'D' (double)} of every ``extern "C"`` function
    in csrc/*.cu."""
    sigs = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                kinds.append("P" if "*" in p else
                             "F" if p.startswith("float") else
                             "D" if p.startswith("double") else
                             "L" if p.startswith("long long") else
                             "I" if p.startswith("int") else p)
            sigs[name] = (src.name, "".join(kinds))
    return sigs


def test_argtypes_match_the_c_signatures():
    """Every C entry point is declared in ``_build._LIBRARIES`` with one
    argtype per parameter: c_void_p for each pointer (a missing one would
    cut a pointer to 32 bits), c_int for each int, c_longlong for each
    long long (K4's scratch size: above ~180 000 boxes its words pass
    2^31), c_float for each float, c_double for each double."""
    letters = {_build._P: "P", _build._I: "I", _build._L: "L",
               _build._F: "F", _build._D: "D"}
    declared = {fn: (source, "".join(letters[t] for t in types))
                for source, _, fns in _build._LIBRARIES.values()
                for fn, types in fns.items()}
    sigs = _c_signatures()
    # K2, K3 share the scan and the pack; K1's library also gives its bit
    # rows and its descriptors, K4's has a float64 entry, K5's answers its
    # tile's rows and builds rule books; the BEV layers' epilogue has one,
    # the stage maps' chain M1 one
    assert len(sigs) == 14 and set(sigs) == set(declared)
    for fn, (source, kinds) in sigs.items():
        assert set(kinds) <= set("PILFD"), (fn, kinds)
        assert declared[fn] == (source, kinds), fn
    assert sigs["d3d_subm_conv"][1] == "PPPPPP" + "I" * 8 + "P"
    assert sigs["d3d_subm_conv_dw"][1] == "P" * 7 + "I" * 9 + "P"
    assert sigs["d3d_subm_conv_tile_rows"][1] == "I"
    assert sigs["d3d_subm_conv_rulebook_resident"][1] == ""
    assert sigs["d3d_bn_relu"][1] == "P" * 5 + "III" + "LI" + "L" * 5 + "P"
    assert sigs["d3d_subm_conv_rulebook"][1] == "PPIIPPPIP"
    assert sigs["d3d_stage_maps"][1] == "PPIPIPPLP"
    assert sigs["d3d_rbox_iou_matrix"][1] == "PPPIIPP"
    assert sigs["d3d_rbox_overlap_bits"][1] == "PPIFPP"
    assert sigs["d3d_nms_pack"][1] == "PPIP"
    assert sigs["d3d_nms_scan"][1] == "PPPFPPIP"
    assert sigs["d3d_rbox_descriptors"][1] == "PPIP"
    assert sigs["d3d_soft_nms_scan"][1] == "PPPPPLIFFFIP"
    assert sigs["d3d_soft_nms_scan_f64"][1] == "PPPPPLIDDDIP"


# ---------------------------------------------------------------------------
# the rule-book sort (csrc/subm_conv.cu rulebook_masks_kernel and
# rulebook_pass_kernel)
# ---------------------------------------------------------------------------

def _c_int(name):
    text = (_build.CSRC / "subm_conv.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_sort_constants_match_the_wrapper():
    assert _c_int("kChunk") == RB._SORT_CHUNK
    assert _c_int("kMaxPasses") == RB._SORT_MAX_PASSES
    assert 1 << _c_int("kRadixBits") == RB._SORT_RADIX
    assert _c_int("kSortThreads") * _c_int("kKeysPerThread") == RB._SORT_CHUNK


def _emulate_rulebook_sort(masks_list, k_off, rng):
    """The rule-book kernels in numpy, per map's masks -> per map's order.
    The masks kernel: keys (mask << 32 | row) and each map's digit counts
    of every pass. A pass: every chunk of 2048 keys ranks its keys stably
    (warp w takes keys w * 256 .. + 255 in rounds of 32, a key's rank is
    its warp's count of its digit so far plus the equal digits on lower
    lanes), publishes its counts, then (in a random order of the chunks:
    the look-back does not depend on it) adds the earlier chunks' published
    counts, back to the first inclusive one, and places each key at its
    digit's base plus that prior count plus the warps before it plus its
    rank. Every slot of a pass's output is written exactly once."""
    chunk, radix, warps = RB._SORT_CHUNK, RB._SORT_RADIX, 8
    per_warp = chunk // warps
    passes = -(-k_off // 8)
    keys = [(m.astype(np.uint64) << np.uint64(32))
            | np.arange(len(m), dtype=np.uint64) for m in masks_list]
    for p in range(passes):
        shift = np.uint64(32 + 8 * p)
        out = []
        for src in keys:
            nq = len(src)
            digits = ((src >> shift) & np.uint64(radix - 1)).astype(np.int64)
            hist = np.bincount(digits, minlength=radix)
            dbase = np.concatenate([[0], np.cumsum(hist)[:-1]])
            nch = -(-nq // chunk)
            counts, ranks, wexcl = [], [], []
            for c in range(nch):
                wcnt = np.zeros((warps, radix), np.int64)
                rank = np.full(chunk, -1, np.int64)
                for w in range(warps):
                    for j in range(per_warp // 32):
                        i = c * chunk + w * per_warp + j * 32 + np.arange(32)
                        ok = i < nq
                        d = np.where(ok, digits[np.minimum(i, nq - 1)], radix)
                        same = (d[:, None] == d[None, :]) & np.tri(
                            32, k=-1, dtype=bool)
                        loc = w * per_warp + j * 32 + np.arange(32)
                        for lane in np.nonzero(ok)[0]:
                            rank[loc[lane]] = (wcnt[w, d[lane]]
                                               + same[lane].sum())
                        np.add.at(wcnt[w], d[ok], 1)
                counts.append(wcnt.sum(0))
                wexcl.append(np.cumsum(wcnt, 0) - wcnt)
                ranks.append(rank)
            # publish aggregates (the map's first chunk: inclusive), then
            # look back in a random order of the chunks
            slots = [("inc" if c == 0 else "agg", counts[c])
                     for c in range(nch)]
            prior = [None] * nch
            for c in rng.permutation(nch):
                acc = np.zeros(radix, np.int64)
                k = c - 1
                while k >= 0:
                    flag, val = slots[k]
                    acc = acc + val
                    if flag == "inc":
                        break
                    k -= 1
                prior[c] = acc
                slots[c] = ("inc", acc + counts[c])
            dst = np.zeros(nq, np.uint64)
            writes = np.zeros(nq, np.int64)
            for c in range(nch):
                for w in range(warps):
                    loc = w * per_warp + np.arange(per_warp)
                    i = c * chunk + loc
                    ok = i < nq
                    d = digits[i[ok]]
                    pos = (dbase[d] + prior[c][d] + wexcl[c][w][d]
                           + ranks[c][loc[ok]])
                    dst[pos] = src[i[ok]]
                    np.add.at(writes, pos, 1)
            assert (writes == 1).all(), "a slot written twice or never"
            out.append(dst)
        keys = out
    return [(k & np.uint64(0xFFFFFFFF)).astype(np.int64) for k in keys]


def _sort_maps(rng, case):
    """(masks per map, K) for each case of the sort test."""
    k27 = 1 << 27
    if case == "one_row":
        return [rng.integers(0, k27, 1)], 27
    if case == "all_equal":
        return [np.full(3000, 0b101101, np.int64)], 27
    if case == "all_distinct":
        return [rng.choice(k27, 5000, replace=False)], 27
    if case == "ragged":
        return [rng.integers(0, 1 << 6, 2049)], 27
    if case == "second_rows":  # 32 000 rows, SECOND-like presence
        present = rng.random((32000, 27)) < 0.3
        return [(present << np.arange(27)).sum(1)], 27
    if case == "sixteen_maps":
        sizes = [0, 1, 5, 2048, 2049, 4100, 700, 64, 3000, 1, 2, 9000, 33,
                 2047, 100, 6000]
        return [rng.integers(0, 1 << int(rng.integers(1, 28)), n)
                for n in sizes], 27
    if case == "one_pass":
        return [rng.integers(0, 1 << 8, 3000)], 8
    return [rng.integers(0, 1 << 31, 4500)], 31   # "bit_30": four passes


@pytest.mark.parametrize("case", ["one_row", "all_equal", "all_distinct",
                                  "ragged", "second_rows", "sixteen_maps",
                                  "one_pass", "bit_30"])
def test_rulebook_sort_emulation_is_the_stable_sort(rng, case):
    """The emulated passes give each map the stable argsort of its masks,
    as does the plain version on maps with those masks."""
    masks_list, k_off = _sort_maps(rng, case)
    got = _emulate_rulebook_sort(masks_list, k_off, rng)
    for masks, order in zip(masks_list, got):
        np.testing.assert_array_equal(order,
                                      np.argsort(masks, kind="stable"))
    if case in ("sixteen_maps", "ragged"):
        nbrs = [torch.from_numpy(np.where(
            (m[:, None] >> np.arange(k_off)) & 1, 0, -1).astype(np.int32))
            for m in masks_list]
        for order, plain in zip(got, RB._subm_conv_rulebook_plain(nbrs)[1]):
            np.testing.assert_array_equal(order, plain.numpy())


def test_sort_scratch_holds_every_part():
    """The wrapper's scratch: two keys a row, then per chunk the look-back
    slots of every pass, per map the histograms, and the tickets."""
    nqs = [16000, 8000, 1, 0, 2049]
    chunks = 8 + 4 + 1 + 0 + 2
    words = RB._sort_scratch_words(nqs)
    assert words * 8 == (2 * sum(nqs) * 8 + chunks * 4 * 256 * 4
                         + len(nqs) * 4 * 256 * 4 + 4 * 4)

"""Every stage's neighbour maps of a batch at once
(``ops/stage_maps.py``): the batched entry's plain route against the maps
each frame's stages got from the single-stage functions, moved to the
frame's rows and joined, for SECOND's structures, VoxelNeXt's and a grid
above 2^26 cells (the sort join); and, on the card, the kernel chain M1
against the plain version bit for bit.

The card's tests carry the ``chip`` marker and skip without a card; they
import no JAX, so they run on the machine with the card as

    python -m pytest --noconftest tests/test_torch_stage_maps.py -m chip
"""

import numpy as np
import pytest
import torch

import _limits  # noqa: F401  (one torch thread a process)

from d3d_tpu_torch.models import SECONDLayout, presets
from d3d_tpu_torch.models import second as TSEC
from d3d_tpu_torch.ops import stage_maps as M
from d3d_tpu_torch.ops.sparse_conv import (
    _DENSE_CANVAS_MAX_CELLS, build_neighbor_map, build_neighbor_map_strided,
    conv_out_grid, downsample_coords)

_LAYOUT_CFG = dict(dtype="float32", stage_channels=(4, 8, 8, 8),
                   subm_per_stage=2)


def _layout_case(grid, rows, caps, out_sites, box):
    cfg = presets.second_kitti(grid=grid, max_voxels=rows, stage_sites=caps,
                               **_LAYOUT_CFG)
    layout = SECONDLayout(z_extent=grid[2] + 1, out_sites=out_sites)
    return cfg, layout, rows, box


# name: (config, layout, rows a frame, the box of cells the sites fill)
CASES = {
    # OpenPCDet's structure: z 41 -> 21 -> 11 -> 5 -> 2, the last under
    # conv_out's per-axis (1, 1, 3) / (1, 1, 2)
    "layout": _layout_case((24, 20, 40), 400, (400, 900, 500, 300), 200,
                           (12, 12, 41)),
    # z 9 -> 5 -> 3 -> 2 -> 0: conv_out has no output cells
    "layout_flat": _layout_case((16, 14, 8), 300, (300, 600, 300, 200),
                                100, (10, 10, 9)),
    # the JAX module's coords // 2 on odd extents, caps that bind
    "floor_rule": (presets.second_kitti(grid=(21, 19, 9), max_voxels=300,
                                        stage_sites=(300, 100, 40)),
                   None, 300, (11, 11, 9)),
    "voxelnext": (presets.voxelnext_nuscenes(
        grid=(26, 22, 10), max_voxels=350,
        stage_sites=(350, 200, 120, 60)), None, 350, (14, 12, 10)),
    # 1408 x 1600 x 41 cells: stage 0 by the sort join
    "sort_join": _layout_case((1408, 1600, 40), 300, (300, 600, 300, 200),
                              150, (10, 10, 12)),
}


def _frames(rng, batch, rows, grid, box, fill=None):
    """(B, rows, 3) int32 coords and (B, rows) valid: frame b has
    ``fill[b]`` (default about 80% of the rows, frame 0 the most) valid
    sites at distinct cells of a box of ``box`` cells at the grid's
    origin or its far corner, in random rows; the other rows hold
    arbitrary coords, some outside the grid."""
    coords = rng.integers(-4, max(grid) + 4, (batch, rows, 3)).astype(
        np.int32)
    valid = np.zeros((batch, rows), bool)
    box = tuple(min(b, g) for b, g in zip(box, grid))
    for b in range(batch):
        n = (fill[b] if fill is not None else
             min(int(np.prod(box)), rows * (8 - b) // 10))
        keys = rng.choice(int(np.prod(box)), n, replace=False)
        corner = [0 if (b + a) % 2 == 0 else g - x
                  for a, (g, x) in enumerate(zip(grid, box))]
        at = rng.choice(rows, n, replace=False)
        coords[b, at] = np.stack(np.unravel_index(keys, box), -1) + corner
        valid[b, at] = True
    return torch.from_numpy(coords), torch.from_numpy(valid)


def _grid0(cfg, layout):
    return tuple(cfg.grid) if layout is None else layout.grids(cfg)[0]


def _single_stage_maps(cfg, coords, valid, layout):
    """One frame's maps written out with the single-stage functions: the
    torch ops a frame's stages ran before they became a plan."""
    grid = _grid0(cfg, layout)
    maps = []
    for s in range(cfg.n_stages):
        nbr = build_neighbor_map(coords, valid, grid)
        if layout is None and s + 1 == cfg.n_stages:
            maps.append((nbr, valid, None, None))
            break
        if layout is None:
            oc, ov = downsample_coords(coords, valid, grid, 2,
                                       cfg.stage_sites[s + 1])
            nbr_s = build_neighbor_map_strided(oc, ov, coords, valid, grid,
                                               2)
            out_grid = tuple(-(-g // 2) for g in grid)
        else:
            kernel, stride, pad, cap = layout.down(cfg, s)
            oc, ov = downsample_coords(coords, valid, grid, stride, cap,
                                       kernel=kernel, padding=pad)
            nbr_s = build_neighbor_map_strided(oc, ov, coords, valid, grid,
                                               stride, kernel, padding=pad)
            out_grid = conv_out_grid(grid, kernel, stride, pad)
        maps.append((nbr, valid, nbr_s, ov))
        coords, valid, grid = oc, ov, out_grid
    return maps, (coords, valid, grid)


def _assert_maps_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and torch.equal(a, b)


def _assert_sites_equal(got, want):
    """Final (coords, valid, grid): valid and grid equal, coords on valid
    rows (padding rows' coords are arbitrary)."""
    (gc, gv, gg), (wc, wv, wg) = got, want
    assert gg == wg and torch.equal(gv, wv)
    assert torch.equal(gc[wv].to(torch.int32), wc[wv].to(torch.int32))


# the sort join's grid at one batch size: B = 2 covers the join
@pytest.mark.parametrize("case,batch", [
    (case, batch) for case in sorted(CASES) for batch in (1, 2, 3)
    if case != "sort_join" or batch == 2])
def test_plain_route_equals_per_frame_maps(case, batch):
    """The batched entry's plain route (the CPU's) is each frame's maps,
    moved to the frame's rows and joined, and each frame's maps are what
    the single-stage functions give."""
    cfg, layout, rows, box = CASES[case]
    grid = _grid0(cfg, layout)
    if case == "sort_join":
        assert int(np.prod(grid)) > _DENSE_CANVAS_MAX_CELLS
    coords, valid = _frames(np.random.default_rng(7 + batch), batch, rows,
                            grid, box)
    routes = dict(M._ROUTES)
    maps, final = M.build_stage_maps(coords, valid,
                                     *TSEC._stage_plan(cfg, layout))
    assert M._ROUTES == dict(routes, plain=routes["plain"] + 1)
    frames = [M.frame_stage_maps(c, v, *TSEC._stage_plan(cfg, layout))
              for c, v in zip(coords, valid)]
    for f, c, v in zip(frames, coords, valid):
        want_maps, want_final = _single_stage_maps(cfg, c, v, layout)
        _assert_maps_equal(f[0], want_maps)
        _assert_sites_equal(f[1], want_final)
    joined = []
    for s in range(len(frames[0][0])):
        per = [f[0][s] for f in frames]
        r = per[0][0].shape[0]
        joined.append((
            torch.cat([M._offset(p[0], b * r) for b, p in enumerate(per)]),
            torch.cat([p[1] for p in per]),
            None if per[0][2] is None else torch.cat(
                [M._offset(p[2], b * r) for b, p in enumerate(per)]),
            None if per[0][3] is None else torch.cat([p[3] for p in per])))
    _assert_maps_equal(maps, joined)
    _assert_sites_equal(final, (torch.stack([f[1][0] for f in frames]),
                                torch.stack([f[1][1] for f in frames]),
                                frames[0][1][2]))
    # a submanifold map reaches into its own frame's rows only
    for nbr, _, _, _ in maps:
        r = nbr.shape[0] // batch
        frame = torch.arange(nbr.shape[0])[:, None] // r
        assert bool(((nbr < 0) | (nbr // r == frame)).all())


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_outputs_match_its_plan(case):
    """The op's CPU kernel gives the plain route's maps and sites, in the
    shapes and dtypes the plan gives (its fake implementation's), with the
    intermediate sites of each strided layer."""
    cfg, layout, rows, box = CASES[case]
    grid, downs = TSEC._stage_plan(cfg, layout)
    coords, valid = _frames(np.random.default_rng(3), 2, rows, grid, box)
    plan = M._plan(rows, grid, downs)
    assert M._decode(plan) == (grid, [None if d is None else
                                      M.Down(*_resolved(d, plan, i))
                                      for i, d in enumerate(downs)])
    outs = torch.ops.d3d_tpu_torch.build_stage_maps(coords, valid, plan)
    fake = M._outputs(coords, 2, plan)
    assert [(o.shape, o.dtype) for o in outs] == [(f.shape, f.dtype)
                                                   for f in fake]
    maps, final = M.build_stage_maps(coords, valid, grid, downs)
    # the CUDA route's result from the same outputs
    got_maps, got_final = M._assemble(outs, plan, coords, valid)
    _assert_maps_equal(got_maps, maps)
    _assert_sites_equal(got_final, final)
    flat = [t for nbr, _, nbr_s, ov in maps
            for t in ((nbr,) if nbr_s is None else (nbr, nbr_s, ov))]
    assert all(torch.equal(o.reshape(f.shape), f) for o, f in zip(
        [o for o in outs if o.ndim != 3], flat))
    if downs[-1] is not None:
        assert torch.equal(outs[-2][final[1]], final[0][final[1]])


def _resolved(down, plan, i):
    """A Down as the plan gives it back: per-axis tuples for spconv's
    rule, the cap the rows a frame."""
    out_rows = plan[i * M._PLAN_INTS + 14]
    if down.kernel is None:
        return down.stride, out_rows
    ax = M._axes
    return ax(down.stride), out_rows, ax(down.kernel), ax(down.padding)


def test_scratch_matches_the_kernel_layout():
    """The scratch is a frame's hash table (a power of two of at least
    twice the rows and 1024 slots) and, a strided layer, its bitmap and
    ranks in whole blocks of 2048 words, a count a block and a frame."""
    cfg, layout, rows, _ = CASES["layout"]
    plan = M._plan(rows, *TSEC._stage_plan(cfg, layout))
    want = 2 * 2 * 1024
    for st in M._stages(plan):
        words = -(-int(np.prod(st[15:18])) // 32)
        blocks = -(-words // 2048)
        want += 2 * 2 * blocks * 2048 + -(-2 * blocks // 4) * 4 + 4
    assert M._scratch_ints(2, plan) == want
    assert M._scratch_ints(1, M._plan(5000, (8, 8, 8), [None])) == 2 * 16384


# ---------------------------------------------------------------- the card


@pytest.fixture
def card():
    """Skip unless a CUDA card is here (decided in the test, not at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: M1 has no CPU route")
    return torch.device("cuda", 0)


def _published_layout():
    cfg = presets.second_kitti(
        dtype="float32", grid=(1408, 1600, 40), max_voxels=40000,
        stage_channels=(16, 32, 64, 64),
        stage_sites=(40000, 90000, 60000, 20000))
    return cfg, SECONDLayout(out_sites=12000)


def _card_cases():
    """name: (config, layout, (coords, valid)) on the CPU."""
    rng = np.random.default_rng(23)
    pub, pub_layout = _published_layout()
    cases = {}
    cfg, layout, rows, box = CASES["layout"]
    cases["random"] = (cfg, layout, _frames(rng, 3, rows, _grid0(
        cfg, layout), box))
    cases["empty_frame"] = (cfg, layout, _frames(
        rng, 2, rows, _grid0(cfg, layout), box, fill=(0, 300)))
    tight = presets.second_kitti(grid=(24, 20, 40), max_voxels=400,
                                 stage_sites=(400, 60, 30, 12),
                                 **_LAYOUT_CFG)
    cases["caps_bind"] = (tight, SECONDLayout(z_extent=41, out_sites=5),
                          _frames(rng, 2, 400, (24, 20, 41), (12, 12, 41)))
    cfg, layout, rows, box = CASES["layout_flat"]
    cases["empty_extent"] = (cfg, layout, _frames(rng, 2, rows, _grid0(
        cfg, layout), box))
    cfg, layout, rows, box = CASES["floor_rule"]
    cases["floor_rule_odd"] = (cfg, layout, _frames(rng, 2, rows, cfg.grid,
                                                    box))
    cfg, layout, rows, box = CASES["voxelnext"]
    cases["voxelnext"] = (cfg, layout, _frames(rng, 2, rows, cfg.grid, box))
    cases["published"] = (pub, pub_layout, _frames(
        rng, 2, 40000, pub_layout.grids(pub)[0], (160, 200, 41)))
    waymo = presets.voxelnext_nuscenes(
        bounds=(-75.2, 75.2, -75.2, 75.2, -2.0, 4.0), grid=(1504, 1504, 40),
        max_voxels=20000, stage_sites=(20000, 15000, 8000, 4000))
    cases["waymo_extent"] = (waymo, None, _frames(rng, 1, 20000, waymo.grid,
                                                  (120, 120, 40)))
    coords, valid = _frames(rng, 2, rows, cfg.grid, box)
    coords[:, 1::7] = coords[:, ::7][:, :coords[:, 1::7].shape[1]]
    valid[:, 1::7] = valid[:, ::7][:, :valid[:, 1::7].shape[1]]
    cases["duplicates"] = (cfg, layout, (coords, valid))
    # the voxelizer's layout: coords a transposed view
    coords, valid = _frames(rng, 2, rows, cfg.grid, box)
    cases["strided_coords"] = (cfg, layout, (
        coords.transpose(1, 2).contiguous().transpose(1, 2), valid))
    return cases


@pytest.mark.chip
@pytest.mark.parametrize("case", ["random", "empty_frame", "caps_bind",
                                  "empty_extent", "floor_rule_odd",
                                  "voxelnext", "published", "waymo_extent",
                                  "duplicates", "strided_coords"])
def test_kernel_equals_plain(card, case):
    """M1's every output against the plain version's on the CPU: maps and
    valid bit for bit, coords on valid rows; the route count moves."""
    cfg, layout, (coords, valid) = _card_cases()[case]
    grid, downs = TSEC._stage_plan(cfg, layout)
    plan = M._plan(valid.shape[1], grid, downs)
    want = torch.ops.d3d_tpu_torch.build_stage_maps(coords, valid, plan)
    before, routes = M.build_stage_maps.launches, dict(M._ROUTES)
    maps, final = M.build_stage_maps(coords.to(card), valid.to(card), grid,
                                     downs)
    got = torch.ops.d3d_tpu_torch.build_stage_maps(
        coords.to(card), valid.to(card), plan)
    torch.cuda.synchronize()
    assert M.build_stage_maps.launches == before + 2
    assert M._ROUTES["kernel"] == routes["kernel"] + 1
    valids = [w for w in want if w.dtype == torch.bool]
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu()
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if w.ndim == 3:  # a strided layer's output coords
            v = valids.pop(0)
            assert torch.equal(g[v], w[v]), (case, i)
        else:
            assert torch.equal(g, w), (case, i)
    plain, plain_final = M.build_stage_maps(coords, valid, grid, downs)
    _assert_maps_equal([tuple(None if t is None else t.cpu() for t in m)
                        for m in maps], plain)
    _assert_sites_equal(tuple(t.cpu() if torch.is_tensor(t) else t
                              for t in final), plain_final)


@pytest.mark.chip
def test_a_frames_maps_take_few_launches_and_no_sync(card):
    """A published-size frame's maps and rule books (``_batch_stage_maps``):
    at most 40 launches, one M1 call, and no call that waits for the
    device."""
    from torch.profiler import ProfilerActivity, profile

    cfg, layout = _published_layout()
    coords, valid = _frames(np.random.default_rng(5), 1, 40000,
                            layout.grids(cfg)[0], (200, 240, 41),
                            fill=(30000,))
    coords, valid = coords.to(card), valid.to(card)
    TSEC._batch_stage_maps(cfg, coords, valid, layout)  # build, warm
    torch.cuda.synchronize()
    before = M.build_stage_maps.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            TSEC._batch_stage_maps(cfg, coords, valid, layout)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launch = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
              "cuLaunchKernel", "cudaMemcpy", "cudaMemset", "cuMemcpy",
              "cuMemset")
    launches = sum(e.count for e in prof.key_averages()
                   if e.key.startswith(launch))
    assert M.build_stage_maps.launches == before + 1
    assert 0 < launches <= 40, launches

"""SECOND at OpenPCDet's structure on the port (``SECONDLayout``): the
exact per-voxel mean of ``second_voxelize``, spconv's strided maps, and the
network against the benchmark's plain reference (``perfbench/reference/
second.py``) at a small size."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _limits  # noqa: F401  (one torch thread a process)

import jax.numpy as jnp

from d3d_tpu.ops.voxel import voxelize_mean_fm_exact
from d3d_tpu_torch.models import SECOND, SECONDLayout, presets
from d3d_tpu_torch.models import second_voxelize
from d3d_tpu_torch.ops import sparse_conv as TS
from d3d_tpu_torch.ops import voxel as TV

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.core.frames import kitti_like_points  # noqa: E402
from perfbench.reference import second as ref  # noqa: E402

PUBLISHED = presets.second_kitti(
    dtype="float32", grid=(1408, 1600, 40), max_voxels=40000,
    stage_channels=(16, 32, 64, 64), stage_sites=(40000, 90000, 60000, 20000))

# a small grid with the published structure: z 41 -> 21 -> 11 -> 5 -> 2
SMALL = dict(bounds=(0.0, 10.24, -5.12, 5.12, -3.0, 1.0), grid=(32, 32, 40),
             max_voxels=1500, stage_channels=(4, 8, 8, 8),
             stage_sites=(1500, 6000, 3000, 1500), subm_per_stage=2,
             dtype="float32")
SMALL_LAYOUT = SECONDLayout(out_channels=8, out_sites=1000,
                            bev_channels=(8, 16), bev_convs=(2, 2),
                            bev_up_channels=(8, 8))


def _ref_model(cfg, layout):
    return dict(bounds=cfg.bounds, grid=cfg.grid, max_voxels=cfg.max_voxels,
                stage_channels=cfg.stage_channels,
                subm_per_stage=cfg.subm_per_stage,
                num_classes=cfg.num_classes, anchor_sizes=cfg.anchor_sizes,
                anchor_rotations=cfg.anchor_rotations,
                layout=dict(z_extent=layout.z_extent,
                            down_padding=layout.down_padding,
                            out_channels=layout.out_channels,
                            out_kernel=layout.out_kernel,
                            out_stride=layout.out_stride,
                            bev_channels=layout.bev_channels,
                            bev_convs=layout.bev_convs,
                            bev_up_channels=layout.bev_up_channels))


@pytest.fixture(scope="module")
def frames():
    return [kitti_like_points(s) for s in (3, 4)]


def _by_key(coords, npoints, agg, grid):
    """{cell key: (points, mean row)} of a voxelizer's kept voxels."""
    c, agg = (np.asarray(t) for t in (coords, agg))
    c = c.astype(np.int64)
    key = (c[:, 0] * grid[1] + c[:, 1]) * grid[2] + c[:, 2]
    return {int(k): (int(n), a) for k, n, a in zip(key, np.asarray(npoints),
                                                   agg)}


@pytest.mark.parametrize("frame", [0, 1])
def test_exact_mean_route(frames, frame):
    """F7's repair at 0.05 m voxels. The exact route's voxels are the
    float64 reference's, with its means to float32 rounding (1.5 ulp of 64
    m in x, y, z; 2 ulp of an intensity); the default route keeps the JAX
    module's prefix-sum arithmetic, off by centimetres there.

    Against the JAX package's ``voxelize_mean_fm_exact``: XLA:CPU divides
    by the voxel size as a multiply by its reciprocal, which puts a few
    points in ~70 000 that lie on a cell boundary in the next cell, so
    those few voxels differ (here under 0.1%). Every other voxel has the
    same points and a mean within two float32 ulp of 70.4 m (x, y, z; XLA
    rounds ``(cell + offset) * size + low`` in another order) and one ulp
    of its intensity."""
    pts = frames[frame]
    grid = PUBLISHED.grid
    want_f, want_c = ref.voxelize(torch.from_numpy(pts),
                                  _ref_model(PUBLISHED, SECONDLayout()))
    got_f, got_c, got_v = second_voxelize(torch.from_numpy(pts), PUBLISHED,
                                          exact_mean=True)
    n = len(want_c)
    assert 20000 < n == int(got_v.sum()) <= PUBLISHED.max_voxels
    np.testing.assert_array_equal(got_c[:n].numpy(), want_c.numpy())
    err = (got_f[:n] - want_f).abs()
    assert float(err[:, :3].max()) <= 1.5 * 2 ** -23 * 64
    assert float(err[:, 3].max()) <= 2 * 2 ** -24
    old_f = second_voxelize(torch.from_numpy(pts), PUBLISHED)[0]
    assert float((old_f[:n, :3] - want_f[:, :3]).abs().max()) > 1e-3

    mine, theirs = (
        _by_key(v.coords[:, :v.nvoxels].T, v.voxel_npoints[:v.nvoxels],
                v.aggregates[:, :v.nvoxels].T, grid)
        for v in (TV.voxelize_mean_fm_exact(torch.from_numpy(pts.T), grid,
                                            torch.tensor(PUBLISHED.bounds),
                                            PUBLISHED.max_voxels),
                  voxelize_mean_fm_exact(jnp.asarray(pts.T), grid,
                                         jnp.asarray(PUBLISHED.bounds),
                                         PUBLISHED.max_voxels)))
    assert len(mine) == n
    np.testing.assert_array_equal(
        np.stack([mine[k][1] for k in sorted(mine)]), got_f[:n].numpy())
    same = [k for k in mine if k in theirs and theirs[k][0] == mine[k][0]]
    assert len(same) > 0.999 * max(len(mine), len(theirs))
    d = np.abs(np.array([mine[k][1] - theirs[k][1] for k in same]))
    assert d[:, :3].max() <= 2 * np.spacing(np.float32(70.4))
    assert np.all(d[:, 3] <= np.spacing(np.float32(1.0)))


def test_published_extents():
    """The published model: sparse extents, the sort join at stage 0,
    256 channels into the BEV network and 512 into the heads."""
    layout = SECONDLayout()
    assert layout.grids(PUBLISHED) == [(1408, 1600, 41), (704, 800, 21),
                                       (352, 400, 11), (176, 200, 5),
                                       (176, 200, 2)]
    assert np.prod(layout.grids(PUBLISHED)[0]) > TS._DENSE_CANVAS_MAX_CELLS
    assert np.prod(layout.grids(PUBLISHED)[1]) <= TS._DENSE_CANVAS_MAX_CELLS
    model = SECOND(PUBLISHED, device="meta", layout=layout)
    assert model.blocks[0].convs[0].in_channels == 256
    assert model.head_cls.in_channels == 512
    assert model.middle["down3"].weight.shape == (3, 64, 128)
    with pytest.raises(ValueError, match="sparse middle"):
        SECOND(presets.second_kitti(middle="dense", dense_max_cells=10 ** 9),
               device="meta", layout=layout)


@pytest.mark.parametrize("kernel,stride,pad", [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 0)),
    ((1, 1, 3), (1, 1, 2), (0, 0, 0))])
def test_strided_maps_follow_spconv(kernel, stride, pad, monkeypatch):
    """Output sites by spconv's rule (a max pool of the input's active set
    over each window) and the layer on them (a dense 3D convolution,
    masked), in float64; the sort join gives the canvas's map."""
    rng = np.random.default_rng(sum(kernel) + sum(pad))
    grid = (9, 10, 11)
    cells = rng.choice(int(np.prod(grid)), 120, replace=False)
    coords = torch.from_numpy(np.stack(np.unravel_index(cells, grid), 1)
                              ).to(torch.int32)
    valid = torch.ones(len(coords), dtype=torch.bool)
    valid[-7:] = False
    oc, ov = TS.downsample_coords(coords, valid, grid, stride, 400,
                                  kernel=kernel, padding=pad)
    nbr = TS.build_neighbor_map_strided(oc, ov, coords, valid, grid, stride,
                                        kernel, padding=pad)
    monkeypatch.setattr(TS, "_DENSE_CANVAS_MAX_CELLS", 0)
    joined = TS.build_neighbor_map_strided(oc, ov, coords, valid, grid,
                                           stride, kernel, padding=pad)
    np.testing.assert_array_equal(joined.numpy(), nbr.numpy())

    mask = torch.zeros(grid, dtype=torch.float64)
    c = coords[valid].long()
    mask[c[:, 0], c[:, 1], c[:, 2]] = 1
    out_mask = F.max_pool3d(mask[None, None], kernel, stride, pad)[0, 0] > 0
    og = TS.conv_out_grid(grid, kernel, stride, pad)
    assert tuple(out_mask.shape) == og
    keys = TS.linearize(oc[ov], og)
    assert (keys[1:] > keys[:-1]).all()          # ascending, unique
    want_sites = out_mask.nonzero()
    np.testing.assert_array_equal(oc[ov].numpy(), want_sites.numpy())

    feats = torch.from_numpy(rng.standard_normal((len(coords), 3)))
    feats[~valid] = 0
    w = torch.from_numpy(rng.standard_normal((int(np.prod(kernel)), 3, 5)))
    got = TS.subm_conv_apply(feats, nbr, w, ov)
    canvas = torch.zeros((1, 3) + grid, dtype=torch.float64)
    canvas[0][:, c[:, 0], c[:, 1], c[:, 2]] = feats[valid].T
    dense = F.conv3d(canvas, w.reshape(*kernel, 3, 5).permute(4, 3, 0, 1, 2),
                     stride=stride, padding=pad)[0]
    want = dense[:, out_mask].T
    np.testing.assert_allclose(got[ov].numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert not got[~ov].any()


def test_default_maps_unchanged():
    """The cubic default (kernel 3 centred at stride x the output) is the
    window of padding 1: the existing calls' maps, and the ``coords // 2``
    outputs, bit for bit."""
    rng = np.random.default_rng(5)
    grid = (12, 9, 7)
    cells = rng.choice(int(np.prod(grid)), 150, replace=False)
    coords = torch.from_numpy(np.stack(np.unravel_index(cells, grid), 1)
                              ).to(torch.int32)
    valid = torch.from_numpy(rng.random(150) < 0.9)
    oc, ov = TS.downsample_coords(coords, valid, grid, 2, 60)
    want = np.unique(coords[valid].numpy() // 2, axis=0)[:60]
    np.testing.assert_array_equal(oc[ov].numpy(), want)
    default = TS.build_neighbor_map_strided(oc, ov, coords, valid, grid, 2)
    window = TS.build_neighbor_map_strided(oc, ov, coords, valid, grid, 2, 3,
                                           padding=1)
    np.testing.assert_array_equal(default.numpy(), window.numpy())
    np.testing.assert_array_equal(TS._window_offsets(3, 1),
                                  TS.kernel_offsets(3))


@pytest.fixture(scope="module")
def small():
    """The port at SMALL (BatchNorm statistics and affine drawn from a
    seed, so a swapped parameter shows), a voxelized frame, and the
    reference's head outputs on the port's weights."""
    cfg = presets.second_kitti(**SMALL)
    model = SECOND(cfg, device="cpu", layout=SMALL_LAYOUT,
                   generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(("running_var", "bn.weight")) or (
                    ".bns." in name and name.endswith("weight")):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            elif name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    pts = torch.from_numpy(kitti_like_points(8, objects=6, az_step_deg=0.5))
    st = {k: v.clone() for k, v in model.state_dict().items()}
    rmodel = _ref_model(cfg, SMALL_LAYOUT)
    with torch.no_grad():
        want = ref.forward(st, rmodel, *ref.voxelize(pts, rmodel))
    return cfg, model.eval(), pts, want


def _port_outputs(model, cfg, pts):
    f, c, v = second_voxelize(pts, cfg, exact_mean=True)
    with torch.no_grad():
        return model(f[None], c[None], v[None])


def test_small_matches_reference(small):
    """float32: sums in other orders (the plain K5's einsum against
    ``F.conv3d``) over 12 sparse and 6 BEV layers; outputs of magnitude
    0.2-0.4 agree within 1e-6 (9e-8 seen). A bfloat16 network (8 mantissa
    bits) misses by more than 100 times that (2e-3 to 4e-3 seen)."""
    cfg, model, pts, want = small
    got = _port_outputs(model, cfg, pts)
    nx, ny, _ = SMALL_LAYOUT.grids(cfg)[-1]
    for g, w, c in zip(got, want, (1, 7, 2)):
        assert g.shape == w.shape == (1, nx * ny * 2, c)
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)
        assert float(w.std()) > 0.05
    bf16 = SECOND(presets.second_kitti(**dict(SMALL, dtype="bfloat16")),
                  device="cpu", layout=SMALL_LAYOUT)
    bf16.load_state_dict(model.state_dict())
    got = _port_outputs(bf16.eval(), cfg, pts)
    assert max(float((g - w).abs().max()) for g, w in zip(got, want)) > 1e-4

"""The port's SECOND inference path against the JAX package: the same flax
weights (randomized, BatchNorm statistics included) carried across by
``second_state_from_flax``, the same points, the same outputs.

The configurations are ``tests/test_second.py``'s TINY and odd-grid ones,
with stage caps lowered so that every cap binds (the voxel cap, then the
site caps after each strided layer keep only the first keys), as
``presets.second_kitti``'s caps do on a 120k-point frame."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.models import make_anchors, presets
from d3d_tpu.models.inference import make_second_detector
from d3d_tpu.models.second import SECOND, SECONDConfig, head_config
from d3d_tpu.models.second import second_voxelize

from d3d_tpu_torch.models import SECOND as TSECOND
from d3d_tpu_torch.models import SECONDConfig as TConfig
from d3d_tpu_torch.models import head_config as t_head_config
from d3d_tpu_torch.models import make_anchors as t_make_anchors
from d3d_tpu_torch.models import make_second_detector as t_make_detector
from d3d_tpu_torch.models import presets as t_presets
from d3d_tpu_torch.models import second_state_from_flax
from d3d_tpu_torch.models import second_voxelize as t_second_voxelize
from d3d_tpu_torch.ops import sparse_conv as TS

CONFIGS = {
    "tiny": dict(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32, 8),
                 max_voxels=512, stage_channels=(8, 16, 32),
                 stage_sites=(512, 160, 24), subm_per_stage=1,
                 head_channels=16),
    "odd_grid": dict(bounds=(0.0, 16.5, -8.0, 8.5, -3.0, 1.2),
                     grid=(33, 33, 7), max_voxels=256,
                     stage_channels=(8, 16, 32), stage_sites=(256, 96, 12),
                     subm_per_stage=1, head_channels=8),
}


def _points(name, seed):
    rng = np.random.default_rng(seed)
    b = CONFIGS[name]["bounds"]
    cols = [rng.uniform(b[2 * i], b[2 * i + 1], 2048) for i in range(3)]
    return np.stack(cols + [rng.random(2048)], axis=1).astype(np.float32)


def _randomize(tree, rng):
    """Every leaf of a tree of shapes filled with seeded random values
    (variances positive), so a swapped BatchNorm scale/bias/mean/var or
    kernel axis shows up."""
    def leaf(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(x.dtype)
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        std = 1.0 / np.sqrt(np.prod(x.shape[:-1])) if x.ndim > 1 else 0.1
        return (rng.standard_normal(x.shape) * std).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(name, flax model, numpy variables, port model in f32, points)."""
    name = request.param
    cfg = SECONDConfig(**CONFIGS[name])
    model = SECOND(cfg)
    pts = _points(name, 0)
    f, c, v = second_voxelize(jnp.asarray(pts), cfg)
    # the tree's shapes only: no need to compile the initializers
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), f[None],
                            c[None], v[None])
    variables = _randomize(shapes, np.random.default_rng(1))
    tmodel = TSECOND(TConfig(**CONFIGS[name]), device="cpu")
    tmodel.load_state_dict(second_state_from_flax(variables))
    return name, model, variables, tmodel.eval(), pts


def test_voxelize_matches(pair):
    name, model, _, tmodel, pts = pair
    want = second_voxelize(jnp.asarray(pts), model.cfg)
    got = t_second_voxelize(torch.from_numpy(pts), tmodel.cfg)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].all()  # the voxel cap binds: every row is a voxel


def test_stage_caps_bind(pair):
    """Each strided layer finds more unique sites than its cap."""
    _, _, _, tmodel, pts = pair
    cfg = tmodel.cfg
    _, coords, valid = t_second_voxelize(torch.from_numpy(pts), cfg)
    grid = cfg.grid
    for cap in cfg.stage_sites[1:]:
        down = coords[valid] // 2
        assert len(torch.unique(down, dim=0)) > cap
        coords, valid = TS.downsample_coords(coords, valid, grid, 2, cap)
        assert int(valid.sum()) == cap
        grid = tuple(-(-g // 2) for g in grid)


def _outputs_both(model, variables, tmodel, pts):
    f, c, v = second_voxelize(jnp.asarray(pts), model.cfg)
    want = model.apply(variables, f[None], c[None], v[None])
    tf, tc, tv = t_second_voxelize(torch.from_numpy(pts), tmodel.cfg)
    with torch.no_grad():
        got = tmodel(tf[None], tc[None], tv[None])
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_network_f32_matches(pair):
    """f32: the sums run in other orders (the conv einsums, cuDNN-style 2D
    convs), a few f32 ulps per layer over 4 sparse and 2 dense layers;
    stated rtol/atol 1e-5 on outputs of magnitude 0.05 to 1."""
    _, model, variables, tmodel, pts = pair
    want, got = _outputs_both(model, variables, tmodel, pts)
    fg = tmodel.cfg.final_grid
    for w, g, c in zip(want, got, (1, 7, 2)):
        assert g.shape == w.shape == (1, fg[0] * fg[1] * 2, c)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        assert np.ptp(w) > 0.02  # outputs that vary across anchors


def test_network_bf16_matches(pair):
    """bfloat16 compute: each op rounds to 8 mantissa bits in both
    frameworks, but at other places (XLA may keep an intermediate of the
    masked BatchNorm in f32 where torch rounds it, and the two sum in other
    orders before rounding). The outputs reach magnitude ~0.3, where a bf16
    ulp is 2^-9; the stated bound is 2.5 such ulps at the largest output,
    atol 0.005 (the worst case seen is 0.001)."""
    name, _, variables, tmodel32, pts = pair
    model = SECOND(SECONDConfig(**CONFIGS[name], dtype="bfloat16"))
    tmodel = TSECOND(TConfig(**CONFIGS[name], dtype="bfloat16"), device="cpu")
    tmodel.load_state_dict(tmodel32.state_dict())
    want, got = _outputs_both(model, variables, tmodel.eval(), pts)
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=0.005)


def test_detector_matches(pair):
    """``make_second_detector(...).device_fn`` against the JAX one: boxes,
    scores, labels and the keep mask."""
    name, model, variables, _, _ = pair
    cfg = model.cfg
    det = make_second_detector(model, variables, cfg,
                               make_anchors(head_config(cfg)), ["Car"],
                               score_threshold=0.0, top_k=24)
    tcfg = TConfig(**CONFIGS[name])
    tdet = t_make_detector(TSECOND(tcfg, device="cpu"),
                           second_state_from_flax(variables), tcfg,
                           t_make_anchors(t_head_config(tcfg), device="cpu"),
                           ["Car"], score_threshold=0.0, top_k=24,
                           device="cpu")
    pts = _points(name, 7)
    want = [np.asarray(a) for a in det.device_fn(jnp.asarray(pts))]
    got = [t.numpy() for t in tdet.device_fn(torch.from_numpy(pts))]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)  # boxes
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)  # scores
    np.testing.assert_array_equal(got[2], want[2])                  # labels
    np.testing.assert_array_equal(got[3], want[3])                  # keep
    assert got[0].shape == (24, 7) and 0 < got[3].sum() <= 24
    out = tdet(pts)
    assert len(out.scores) == int(got[3].sum())


def test_presets_match():
    want = dataclasses.asdict(presets.second_kitti())
    got = dataclasses.asdict(t_presets.second_kitti())
    assert got == want
    assert t_presets.second_kitti(dtype="float32").dtype == "float32"
    assert t_head_config(t_presets.second_kitti()).grid == (88, 100)


def test_dense_middle_is_not_ported():
    with pytest.raises(NotImplementedError, match="dense"):
        TSECOND(TConfig(**CONFIGS["tiny"], middle="dense"), device="cpu")

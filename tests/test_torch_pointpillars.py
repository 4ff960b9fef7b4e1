"""The port's PointPillars inference path against the JAX package: the same
flax weights (randomized, BatchNorm statistics included) carried across by
``pointpillars_state_from_flax``, the same points, the same outputs.

The tiny configuration is the one ``tests/test_export.py`` uses; its two
backbone levels exercise the stride-2 SAME padding and the transposed
convolution."""

import dataclasses

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.dataset.kitti.utils import KittiObjectClass
from d3d_tpu.models import PointPillars, PointPillarsConfig, make_anchors
from d3d_tpu.models import presets
from d3d_tpu.models.inference import make_pointpillars_detector
from d3d_tpu.models.pointpillars import decode_boxes, pillarize

from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TClass
from d3d_tpu_torch.models import PointPillars as TPointPillars
from d3d_tpu_torch.models import PointPillarsConfig as TConfig
from d3d_tpu_torch.models import decode_boxes as t_decode_boxes
from d3d_tpu_torch.models import make_anchors as t_make_anchors
from d3d_tpu_torch.models import make_pointpillars_detector as t_make_detector
from d3d_tpu_torch.models import pillarize as t_pillarize
from d3d_tpu_torch.models import pointpillars_state_from_flax
from d3d_tpu_torch.models import presets as t_presets
from d3d_tpu_torch.models.pointpillars import _same_padding

CFG = dict(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32),
           max_pillars=256, max_points_per_pillar=16, pfn_features=32,
           backbone_channels=(32, 64), backbone_blocks=(1, 1),
           upsample_channels=32)


def _points(seed, n=2048):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 16, n), rng.uniform(-8, 8, n),
                     rng.uniform(-3, 1, n), rng.uniform(0, 1, n)],
                    axis=1).astype(np.float32)


def _randomize(tree, rng):
    """Every leaf replaced by seeded random values (variances positive), so
    a swapped BatchNorm scale/bias/mean/var or kernel axis shows up."""
    def leaf(path, x):
        x = np.asarray(x)
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(x.dtype)
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        std = 1.0 / np.sqrt(np.prod(x.shape[:-1])) if x.ndim > 1 else 0.1
        return (rng.standard_normal(x.shape) * std).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture(scope="module")
def pair():
    """(flax model, numpy variables, port model in f32, points)."""
    cfg = PointPillarsConfig(**CFG)
    model = PointPillars(cfg)
    pts = _points(0)
    feats, coords, valid = pillarize(jnp.asarray(pts), cfg)
    variables = model.init(jax.random.PRNGKey(0), feats[None], coords[None],
                           valid[None], train=False)
    variables = _randomize(jax.tree.map(np.asarray, variables),
                           np.random.default_rng(1))
    tmodel = TPointPillars(TConfig(**CFG), device="cpu")
    tmodel.load_state_dict(pointpillars_state_from_flax(variables))
    return model, variables, tmodel.eval(), pts


def test_same_padding_is_asymmetric_at_stride_2():
    # flax SAME at stride 2 on an even input pads 0 before, 1 after
    assert _same_padding(32, 3, 2) == (0, 1)
    assert _same_padding(33, 3, 2) == (1, 1)
    assert _same_padding(32, 3, 1) == (1, 1)


def test_pillarize_matches(pair):
    *_, pts = pair
    cfg = PointPillarsConfig(**CFG)
    want = pillarize(jnp.asarray(pts), cfg)
    got = t_pillarize(torch.from_numpy(pts), TConfig(**CFG))
    # coords and the pillar mask are integer results: equal
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # features: equal up to the summation order of the 16-point centroid
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=0, atol=2e-6)


def _outputs_both(model, variables, tmodel, pts):
    feats, coords, valid = pillarize(jnp.asarray(pts), model.cfg)
    want = model.apply(variables, feats[None], coords[None], valid[None],
                       train=False)
    tf, tc, tv = t_pillarize(torch.from_numpy(pts), tmodel.cfg)
    with torch.no_grad():
        got = tmodel(tf[None], tc[None], tv[None])
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_network_f32_matches(pair):
    model, variables, tmodel, pts = pair
    want, got = _outputs_both(model, variables, tmodel, pts)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_network_bf16_matches(pair):
    """bfloat16 compute: each op rounds to 8 mantissa bits in both
    frameworks, but at other places (flax adds the head bias in bf16 after
    the product, torch inside it; flax's BatchNorm promotes to f32 and
    rounds once at the end, as torch's does, but its inputs were rounded
    differently upstream). The outputs here reach magnitude ~2.3, where a
    bf16 ulp is 2^-6; the stated bound is 2.5 such ulps, atol 0.04 (the
    observed worst case is 0.0078)."""
    _, variables, tmodel32, pts = pair
    model = PointPillars(PointPillarsConfig(**CFG, dtype="bfloat16"))
    tmodel = TPointPillars(TConfig(**CFG, dtype="bfloat16"), device="cpu")
    tmodel.load_state_dict(tmodel32.state_dict())
    want, got = _outputs_both(model, variables, tmodel.eval(), pts)
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=0.04)


def _detectors(model, variables):
    """The JAX detector and the port's, on the same variables (each tags
    its boxes with its own package's KITTI Car)."""
    cfg = PointPillarsConfig(**CFG)
    det = make_pointpillars_detector(model, variables, cfg,
                                     make_anchors(cfg),
                                     [KittiObjectClass.Car],
                                     score_threshold=0.0, top_k=32)
    tdet = t_make_detector(TPointPillars(TConfig(**CFG), device="cpu"),
                           pointpillars_state_from_flax(variables),
                           TConfig(**CFG),
                           t_make_anchors(TConfig(**CFG), device="cpu"),
                           [TClass.Car], score_threshold=0.0, top_k=32,
                           device="cpu")
    return det, tdet


def _compare_detections(det, tdet, pts):
    want = [np.asarray(a) for a in det.device_fn(jnp.asarray(pts))]
    got = [t.numpy() for t in tdet.device_fn(torch.from_numpy(pts))]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)  # boxes
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)  # scores
    np.testing.assert_array_equal(got[2], want[2])                  # labels
    np.testing.assert_array_equal(got[3], want[3])                  # keep
    return got


def test_detector_end_to_end(pair):
    model, variables, _, _ = pair
    det, tdet = _detectors(model, variables)
    pts = _points(7)
    boxes, scores, labels, keep = _compare_detections(det, tdet, pts)
    assert boxes.shape == (32, 7) and keep.dtype == bool
    out = tdet(pts)
    assert len(out) == int(keep.sum()) and out.frame is None
    np.testing.assert_array_equal(out.columns()["position"],
                                  boxes[keep][:, 0:3])
    assert [o.tag_top for o in out] == [TClass.Car] * len(out)


def test_detect_returns_equal_target_arrays(pair):
    """``detect(points, frame, timestamp)`` gives the JAX detector's
    Target3DArray: the same length, frame and timestamp, positions and
    dimensions within the boxes' 1e-4, equal labels, scores within
    1e-5."""
    model, variables, _, _ = pair
    det, tdet = _detectors(model, variables)
    pts = _points(11)
    want = det(pts, frame="velo", timestamp=7)
    got = tdet(pts, frame="velo", timestamp=7)
    assert len(got) == len(want) > 0
    assert (got.frame, got.timestamp) == (want.frame, want.timestamp)
    w, g = want.columns(), got.columns()
    for key in ("position", "dimension"):
        np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(g["label"], w["label"])
    np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-5)
    assert [o.tag_top.name for o in got] == [o.tag_top.name for o in want]


def test_detector_ties_take_lowest_index(pair):
    """All-zero class head: every anchor scores sigmoid(0) = 0.5, and the
    top-k must pick anchors 0..k-1 in order, as lax.top_k does."""
    model, variables, _, pts = pair
    params = dict(variables["params"])
    params["head_cls"] = {k: np.zeros_like(v)
                          for k, v in params["head_cls"].items()}
    det, tdet = _detectors(model, dict(variables, params=params))
    _, scores, _, _ = _compare_detections(det, tdet, pts)
    assert np.all(scores == 0.5)


def test_anchors_and_decode_match():
    cfg = PointPillarsConfig(**CFG, anchor_sizes=((3.9, 1.6, 1.56),
                                                  (0.8, 0.6, 1.73)))
    tcfg = TConfig(**CFG, anchor_sizes=cfg.anchor_sizes)
    anchors = np.asarray(make_anchors(cfg))
    t_anchors = t_make_anchors(tcfg, device="cpu").numpy()
    np.testing.assert_array_equal(t_anchors, anchors)
    rng = np.random.default_rng(3)
    deltas = rng.normal(0, 0.5, anchors.shape).astype(np.float32)
    deltas[:5, 6] = [-1.0, 1.0, -0.99995, 0.99995, 0.0]  # the arcsin clip
    want = np.asarray(decode_boxes(jnp.asarray(anchors),
                                   jnp.asarray(deltas)))
    got = t_decode_boxes(torch.tensor(anchors),
                         torch.from_numpy(deltas)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["pointpillars_kitti",
                                  "pointpillars_kitti_3class"])
def test_presets_match(name):
    want = dataclasses.asdict(getattr(presets, name)())
    got = dataclasses.asdict(getattr(t_presets, name)())
    assert got == want
    assert getattr(t_presets, name)(dtype="float32").dtype == "float32"


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 0.016)])
def test_conv_block_training_batchnorm_matches(dtype, tol):
    """The BEV block in training mode against the flax one: flax's
    BatchNorm (momentum 0.99, use_fast_variance: var = E[x^2] - E[x]^2
    clamped at 0) normalises by the biased batch variance and moves the
    running variance by 0.01 of it (torch's F.batch_norm would move it by
    0.1 of the unbiased one). Outputs: f32 atol 1e-5 (8e-7 seen); bf16 one
    bf16 ulp at their magnitude ~3, 0.016 (equal seen). Running statistics,
    float32 in both dtypes: rtol/atol 1e-5 (2e-10 seen)."""
    from d3d_tpu.models.pointpillars import _ConvBlock
    from d3d_tpu_torch.models.pointpillars import _ConvBlock as TBlock

    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, (2, 9, 8, 5)).astype(np.float32)  # NHWC
    block = _ConvBlock(6, 2, 2, dtype)
    variables = block.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    variables = _randomize(jax.tree.map(np.asarray, variables), rng)
    want, upd = block.apply(variables, jnp.asarray(x), True,
                            mutable=["batch_stats"])
    tblock = TBlock(5, 6, 2, 2, dtype)
    sd = {}
    for j in range(2):
        sd[f"convs.{j}.weight"] = np.asarray(
            variables["params"][f"Conv_{j}"]["kernel"]).transpose(3, 2, 0, 1)
        for k, n in (("scale", "weight"), ("bias", "bias")):
            sd[f"bns.{j}.{n}"] = variables["params"][f"BatchNorm_{j}"][k]
        for k, n in (("mean", "running_mean"), ("var", "running_var")):
            sd[f"bns.{j}.{n}"] = variables["batch_stats"][f"BatchNorm_{j}"][k]
        sd[f"bns.{j}.num_batches_tracked"] = np.zeros((), np.int64)
    tblock.load_state_dict({k: torch.as_tensor(np.array(v))
                            for k, v in sd.items()})
    got = tblock(torch.from_numpy(x).permute(0, 3, 1, 2), train=True)
    np.testing.assert_allclose(
        got.detach().float().permute(0, 2, 3, 1).numpy(),
        np.asarray(want.astype(jnp.float32)), rtol=0, atol=tol)
    for j in range(2):
        for k, n in (("mean", "running_mean"), ("var", "running_var")):
            np.testing.assert_allclose(
                getattr(tblock.bns[j], n).numpy(),
                np.asarray(upd["batch_stats"][f"BatchNorm_{j}"][k]),
                rtol=1e-5, atol=1e-5)

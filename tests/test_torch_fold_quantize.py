"""The port's serving tail against the JAX package's: BatchNorm folding
(``models/fold.py``), int8 weights (``quantize.py``) and the flip
ensemble (``models/tta.py``), on the same flax weights carried across by
``models/convert.py`` (randomized, BatchNorm statistics included), for
PointPillars and SECOND. The folded and quantized tensors equal the JAX
package's converted ones exactly: the two scale along the same output
channels, which is the last axis of a flax kernel but axis 0 of a torch
``Conv2d``/``Linear`` weight and axis 1 of a ``ConvTranspose2d`` one."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.dataset.kitti.utils import KittiObjectClass
from d3d_tpu.models import PointPillars, PointPillarsConfig, make_anchors
from d3d_tpu.models import make_pointpillars_detector
from d3d_tpu.models.fold import fold_batchnorm as j_fold
from d3d_tpu.models.second import SECOND, SECONDConfig
from d3d_tpu.models.tta import _unflip_boxes as j_unflip
from d3d_tpu.models.tta import make_tta_detector as j_tta
from d3d_tpu.quantize import quantize_params as j_quantize

from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TClass
from d3d_tpu_torch.models import PointPillars as TPointPillars
from d3d_tpu_torch.models import PointPillarsConfig as TConfig
from d3d_tpu_torch.models import SECOND as TSECOND
from d3d_tpu_torch.models import SECONDConfig as TSConfig
from d3d_tpu_torch.models import make_anchors as t_make_anchors
from d3d_tpu_torch.models import make_pointpillars_detector as t_detector
from d3d_tpu_torch.models import (pointpillars_params_from_flax,
                                  pointpillars_state_from_flax,
                                  second_params_from_flax,
                                  second_state_from_flax)
from d3d_tpu_torch.models.fold import fold_batchnorm, output_axes
from d3d_tpu_torch.models.pointpillars import pillarize as t_pillarize
from d3d_tpu_torch.models.tta import FLIP_MODES, _flip_points, _unflip_boxes
from d3d_tpu_torch.models.tta import make_tta_detector
from d3d_tpu_torch.quantize import (dequantize_params, quantize_params,
                                    quantized_bytes)

from tests.test_torch_pointpillars import CFG, _points
from tests.test_torch_second import CONFIGS as SECOND_CONFIGS

SCFG = SECOND_CONFIGS["tiny"]


def _randomize(shapes, rng):
    def leaf(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(x.dtype)
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        std = 1.0 / np.sqrt(np.prod(x.shape[:-1])) if x.ndim > 1 else 0.1
        return (rng.standard_normal(x.shape) * std).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def pp():
    """(flax model, randomized variables, port model with them)."""
    cfg = PointPillarsConfig(**CFG)
    model = PointPillars(cfg)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, cfg.max_pillars, cfg.max_points_per_pillar,
                              9), jnp.float32),
        jax.ShapeDtypeStruct((1, cfg.max_pillars, 2), jnp.int32),
        jax.ShapeDtypeStruct((1, cfg.max_pillars), jnp.bool_))
    variables = _randomize(shapes, np.random.default_rng(1))
    tmodel = TPointPillars(TConfig(**CFG), device="cpu")
    tmodel.load_state_dict(pointpillars_state_from_flax(variables))
    return model, variables, tmodel.eval()


@pytest.fixture(scope="module")
def second():
    cfg = SECONDConfig(**SCFG)
    model = SECOND(cfg)
    shapes = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, cfg.max_voxels, 4), jnp.float32),
        jax.ShapeDtypeStruct((1, cfg.max_voxels, 3), jnp.int32),
        jax.ShapeDtypeStruct((1, cfg.max_voxels), jnp.bool_))
    variables = _randomize(shapes, np.random.default_rng(2))
    tmodel = TSECOND(TSConfig(**SCFG), device="cpu")
    tmodel.load_state_dict(second_state_from_flax(variables))
    return model, variables, tmodel.eval()


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        assert torch.equal(got[name], w), name


@pytest.mark.parametrize("family", ["pointpillars", "second"])
def test_fold_equals_jax(family, pp, second):
    """The folded state_dict equals the JAX package's folded variables
    converted, exactly; SECOND's sparse layers (``_MaskedBN``) stay as
    they were, as the JAX function folds none of them."""
    _, variables, tmodel = pp if family == "pointpillars" else second
    convert = (pointpillars_state_from_flax if family == "pointpillars"
               else second_state_from_flax)
    want = convert(j_fold(variables, eps=1e-3))
    got = fold_batchnorm(tmodel, eps=1e-3)
    _assert_state_equal(got, want)
    before = tmodel.state_dict()
    folded = [k for k in got if not torch.equal(got[k], before[k])]
    assert folded and not any(k.startswith("middle.") for k in folded)
    if family == "pointpillars":
        assert {"pfn.dense.weight", "ups.1.conv.weight",
                "blocks.1.convs.0.weight"} <= set(folded)


def test_output_axes_follow_the_layouts(pp, second):
    axes = output_axes(pp[2])
    assert axes["pfn.dense.weight"] == 0
    assert axes["blocks.0.convs.0.weight"] == 0
    assert axes["ups.0.conv.weight"] == 0   # 1x1 Conv2d
    assert axes["ups.1.conv.weight"] == 1   # ConvTranspose2d (in, out, ..)
    assert axes["head_cls.weight"] == 0
    assert output_axes(second[2])["middle.subm0_0.weight"] == 2


def _outputs(tmodel, sd, pts):
    model = TPointPillars(tmodel.cfg, device="cpu")
    model.load_state_dict(sd)
    f, c, v = t_pillarize(torch.from_numpy(pts), tmodel.cfg)
    with torch.no_grad():
        return [o.numpy() for o in model.eval()(f[None], c[None], v[None])]


def test_folded_outputs_equal_the_unfolded(pp):
    """Inference through the folded weights: atol/rtol 2e-4, the JAX
    package's fold test's bound (one rounding of the rescaled weights a
    layer)."""
    _, _, tmodel = pp
    pts = _points(3)
    want = _outputs(tmodel, tmodel.state_dict(), pts)
    got = _outputs(tmodel, fold_batchnorm(tmodel), pts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("family", ["pointpillars", "second"])
def test_quantize_equals_jax(family, pp, second):
    """int8 values and float32 scales equal the JAX package's, converted
    (the int8 kernels through the same layout change as the weights;
    per-output-channel scales compared as vectors); the round trip within
    0.51 of a step; under half the float32 bytes."""
    _, variables, tmodel = pp if family == "pointpillars" else second
    convert = (pointpillars_params_from_flax if family == "pointpillars"
               else second_params_from_flax)
    jq = j_quantize(variables["params"])
    want_q = convert(jax.tree.map(np.asarray, _strip(jq, "_int8")))
    want_s = _flat_scales(jq, family)
    got = quantize_params(tmodel)
    params = dict(tmodel.named_parameters())
    quantized = [k for k, v in got.items() if isinstance(v, dict)]
    assert set(quantized) == set(want_q) & set(output_axes(tmodel))
    for name in quantized:
        assert got[name]["_int8"].dtype == torch.int8
        assert torch.equal(got[name]["_int8"], want_q[name]), name
        np.testing.assert_array_equal(got[name]["_scale"].numpy(),
                                      want_s[name], err_msg=name)
    deq = dequantize_params(got)
    for name in quantized:
        w, d = params[name].detach(), deq[name]
        shape = [1] * w.ndim
        shape[got[name]["_axis"]] = -1
        tol = got[name]["_scale"].view(shape) * 0.51
        assert bool(((w - d).abs() <= tol).all()), name
    assert quantized_bytes(got) < 0.5 * quantized_bytes(tmodel.state_dict())


def _strip(tree, key):
    """The JAX quantized tree with each ``{"_int8", "_scale"}`` leaf
    replaced by its ``key`` array (the params tree's structure)."""
    if isinstance(tree, dict) and "_int8" in tree:
        return tree[key]
    if isinstance(tree, dict):
        return {k: _strip(v, key) for k, v in tree.items()}
    return tree


def _flat_scales(jq, family):
    """{port weight name: JAX scale vector}: the converter applied to a
    tree whose kernels are tiled scale vectors, reading one output
    channel's vector back."""
    def tiled(path, x):
        if isinstance(x, dict) and "_int8" in x:
            return np.broadcast_to(np.asarray(x["_scale"]),
                                   x["_int8"].shape).copy()
        return np.asarray(x)
    tree = jax.tree_util.tree_map_with_path(
        tiled, jq, is_leaf=lambda x: isinstance(x, dict) and "_int8" in x)
    convert = (pointpillars_params_from_flax if family == "pointpillars"
               else second_params_from_flax)
    out = {}
    ref = TPointPillars(TConfig(**CFG), device="cpu") \
        if family == "pointpillars" else TSECOND(TSConfig(**SCFG),
                                                 device="cpu")
    axes = output_axes(ref)
    for name, t in convert(tree).items():
        if name in axes:
            a = axes[name]
            idx = [0] * t.ndim
            idx[a] = slice(None)
            out[name] = t[tuple(idx)].numpy()
    return out


def test_quantized_model_stays_close(pp):
    """The dequantized weights' outputs within the JAX package's
    quantization test's bound: each output's largest deviation under 0.1
    of its largest magnitude (tests/test_quantize.py:61)."""
    _, _, tmodel = pp
    pts = _points(4)
    want = _outputs(tmodel, tmodel.state_dict(), pts)
    got = _outputs(tmodel, dequantize_params(quantize_params(tmodel)), pts)
    for g, w in zip(got, want):
        assert np.abs(g - w).max() / max(np.abs(w).max(), 1e-3) < 0.1


def test_unflip_boxes_matches(rng):
    boxes = rng.normal(0, 10, (6, 7)).astype(np.float32)
    vel = rng.normal(0, 5, (6, 2)).astype(np.float32)
    for mode in FLIP_MODES:
        want, _ = j_unflip(jnp.asarray(boxes), None, mode)
        got, none = _unflip_boxes(torch.from_numpy(boxes), None, mode)
        assert none is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        # velocities mirror exactly (sign changes only)
        _, want_v = j_unflip(jnp.asarray(boxes), jnp.asarray(vel), mode)
        _, got_v = _unflip_boxes(torch.from_numpy(boxes),
                                 torch.from_numpy(vel), mode)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        pts = torch.from_numpy(boxes[:, :4].copy())
        assert torch.equal(_flip_points(_flip_points(pts, mode), mode), pts)


def test_tta_matches_jax(pp):
    """The flip ensemble on the same converted weights: the merged boxes
    within 1e-4, scores within 1e-5, labels and the keep mask equal (the
    base detectors are held to the same tolerances in
    tests/test_torch_pointpillars.py); three of the four modes (all four
    mirror correctly in test_unflip_boxes_matches)."""
    modes = ("none", "flip_y", "flip_xy")
    model, variables, tmodel = pp
    cfg = PointPillarsConfig(**CFG)
    det = make_pointpillars_detector(model, variables, cfg,
                                     make_anchors(cfg),
                                     [KittiObjectClass.Car],
                                     score_threshold=0.0, top_k=16)
    tdet = t_detector(TPointPillars(tmodel.cfg, device="cpu"),
                      tmodel.state_dict(), tmodel.cfg,
                      t_make_anchors(tmodel.cfg, device="cpu"), [TClass.Car],
                      score_threshold=0.0, top_k=16, device="cpu")
    jt = j_tta(det, [KittiObjectClass.Car], modes=modes,
               score_threshold=0.0)
    tt = make_tta_detector(tdet, [TClass.Car], modes=modes,
                           score_threshold=0.0)
    pts = _points(9)
    want = [np.asarray(a) for a in jt.device_fn(jnp.asarray(pts))]
    got = [t.numpy() for t in tt.device_fn(pts)]
    assert got[0].shape == (16 * len(modes), 7)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    out = tt(pts, frame="velo")
    assert len(out) == int(got[3].sum()) and out.frame == "velo"


def test_tta_velocity_route_is_not_ported(pp):
    """The velocity route (ported since): a 5-output base detector keeps
    its contract through the flip ensemble, velocities mirrored back as
    the JAX module's, the merge equal to JAX's on the same base outputs
    (boxes within 1e-6, masks and velocities exact), TrackingTarget3D
    elements out."""
    boxes = np.array([[1.0, 2.0, -1.0, 4.0, 1.8, 1.6, 0.3],
                      [10.0, -6.0, -1.0, 4.2, 1.7, 1.5, -1.0],
                      [20.0, 5.0, -1.0, 0.8, 0.6, 1.7, 2.0],
                      [1.2, 2.1, -1.0, 4.0, 1.8, 1.6, 0.35]], np.float32)
    scores = np.array([0.9, 0.6, 0.4, 0.8], np.float32)
    vel = np.array([[3.0, -1.0], [0.5, 2.0], [-1.0, 0.0], [2.5, -1.5]],
                   np.float32)

    def base(lib):
        def fn(points):
            # the base sees the flipped cloud: it reports the boxes
            # mirrored in y (y, yaw and vy negated) when the point is
            s = points[0, 1] / abs(float(pts[0, 1])) - 1.0   # 0 or -2
            b = lib(boxes) * (1.0 + s * lib(np.float32([0, 1, 0, 0, 0, 0,
                                                        1])))
            v = lib(vel) * (1.0 + s * lib(np.float32([0, 1])))
            return (b, lib(scores), lib(np.zeros(4, np.int32)),
                    lib(np.ones(4, bool)), v)
        return fn

    pts = np.array([[1.0, 1.0, 0.0, 0.5]], np.float32)
    device_fn = base(torch.from_numpy)
    device_fn.device = torch.device("cpu")

    def detect(points):
        raise AssertionError("not called")
    detect.device_fn = device_fn
    tta = make_tta_detector(detect, [TClass.Car])
    got = [t.numpy() for t in tta.device_fn(pts)]

    def jdetect(points):
        raise AssertionError("not called")
    jdetect.device_fn = base(jnp.asarray)
    want = [np.asarray(a) for a in j_tta(
        jdetect, [KittiObjectClass.Car]).device_fn(jnp.asarray(pts))]
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_array_equal(got[4][4:], vel)  # the flip undone
    out = tta(pts, frame="velo", timestamp=3)
    assert len(out) == int(got[3].sum()) and out.timestamp == 3
    assert all(type(o).__name__ == "TrackingTarget3D" for o in out)
    with pytest.raises(ValueError, match="unknown TTA mode"):
        make_tta_detector(detect, [TClass.Car], modes=("mirror",))

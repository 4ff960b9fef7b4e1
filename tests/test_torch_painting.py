"""The port's PointPainting (``ops/painting.py``) and its camera half
(``models/seg2d.py``) against the JAX package's on the same seeded
inputs: the bilinear sample (NaN and out-of-bounds points take ``fill``),
single- and multi-camera painting (the first seeing camera wins),
``painting_rig`` on rotated and stereo-baseline calibrations, and Seg2D
through the flax bridge: forward in float32 and bfloat16, one training
step, the segmenter.

Tolerances are stated per test: a bilinear sample is a few float32
products of pixel values in [0, 1), within 1e-6; a painted sample also
carries the projection's rounding (an ulp of a pixel coordinate), within
1e-5."""

import dataclasses

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import optax
import torch

from d3d_tpu.abstraction import TransformSet
from d3d_tpu.models.seg2d import (Seg2D, Seg2DConfig, make_seg2d_train_step,
                                  make_segmenter)
from d3d_tpu.ops.painting import (bilinear_sample, paint_points,
                                  paint_points_multi, painting_rig)

from d3d_tpu_torch.abstraction import TransformSet as TTransformSet
from d3d_tpu_torch.models import seg2d as TS
from d3d_tpu_torch.models.convert import (seg2d_params_from_flax,
                                          seg2d_state_from_flax)
from d3d_tpu_torch.ops import painting as TP

from tests.test_seg2d import TINY, _scene
from tests.test_torch_second import _randomize
from tests.test_torch_voxelnext import _capture_grads

K = np.array([[300.0, 0, 32.0], [0, 300.0, 24.0], [0, 0, 1]], np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_bilinear_sample_matches_with_nan_and_out_of_bounds():
    """In-image samples within 1e-6; out of bounds, masked and NaN
    coordinates take ``fill`` exactly, as in JAX (a NaN fails every bound
    test; the port clears it before the integer cast)."""
    rng = np.random.default_rng(1)
    img = rng.random((12, 17, 5)).astype(np.float32)
    u = np.concatenate([rng.uniform(-3, 20, 60), [np.nan, 3.0, np.nan, 16.0,
                                                  0.0]]).astype(np.float32)
    v = np.concatenate([rng.uniform(-3, 15, 60), [2.0, np.nan, np.nan, 11.0,
                                                  0.0]]).astype(np.float32)
    valid = rng.random(65) < 0.8
    valid[-5:] = True
    for args in ((), (valid,)):
        want = np.asarray(bilinear_sample(*map(jnp.asarray, (img, u, v)
                                               + args), fill=-1.5))
        got = TP.bilinear_sample(*_t(img, u, v, *args), fill=-1.5).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got[-5:-2] == -1.5).all() and (got[-2:] != -1.5).all()


def _cloud(rng, n=400):
    pts = np.stack([rng.uniform(-12, 12, n), rng.uniform(-12, 12, n),
                    rng.uniform(-3, 3, n), rng.random(n)], 1)
    pts[:3, :3] = np.nan
    return pts.astype(np.float32)


def _rig(rng, ncam=3):
    """Cameras looking along +x, -y and +x again (overlapping the first),
    lidar -> camera extrinsics of FLU -> RDF with small offsets."""
    rdf = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)
    exts = []
    for yaw in (0.0, -np.pi / 2, 0.1)[:ncam]:
        c, s = np.cos(yaw), np.sin(yaw)
        rz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
        e = np.eye(4)
        e[:3, :3] = rdf @ rz
        e[:3, 3] = rng.normal(0, 0.2, 3)
        exts.append(e)
    return (np.stack([K] * ncam), np.stack(exts).astype(np.float32))


def test_paint_points_matches():
    """One camera with an extrinsic and without: the painted cloud within
    1e-5 (the rotation as products; XLA's matmul rounds otherwise by an
    ulp), NaN points and points behind the lens take ``fill``."""
    rng = np.random.default_rng(2)
    pts = _cloud(rng)
    feats = rng.random((48, 64, 4)).astype(np.float32)
    ks, exts = _rig(rng, 1)
    # without an extrinsic the cloud is in the camera frame: z ahead
    cam = pts.copy()
    cam[:, :3] = np.stack([pts[:, 0] * 0.05, pts[:, 1] * 0.05,
                           pts[:, 2] * 4], 1)
    for ext, pts in ((exts[0], pts), (None, cam)):
        extra = () if ext is None else (jnp.asarray(ext),)
        want = np.asarray(paint_points(jnp.asarray(pts), jnp.asarray(feats),
                                       jnp.asarray(K), *extra, fill=0.25))
        got = TP.paint_points(*_t(pts, feats, K), *_t(*[e for e in [ext]
                                                        if e is not None]),
                              fill=0.25).numpy()
        assert got.shape == (len(pts), 8)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   equal_nan=True)
        assert (got[:3, 4:] == 0.25).all()
        assert 0 < (got[3:, 4:] != 0.25).any(-1).sum() < len(pts) - 3


def test_paint_points_multi_first_seeing_camera():
    """Three cameras, the third overlapping the first: every point takes
    the first seeing camera's sample (the port's amin of the seeing
    cameras' indices, JAX's argmax of a bool), unseen and NaN points
    ``fill``; within 1e-5 of the JAX package's."""
    rng = np.random.default_rng(3)
    pts = _cloud(rng, 600)
    feats = rng.random((3, 48, 64, 2)).astype(np.float32)
    feats[2] += 10.0   # the overlapping camera's samples stand out
    ks, exts = _rig(rng)
    want = np.asarray(paint_points_multi(*map(jnp.asarray,
                                              (pts, feats, ks, exts)),
                                         fill=-1.0))
    got = TP.paint_points_multi(*_t(pts, feats, ks, exts), fill=-1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                               equal_nan=True)
    cols = got[:, 4]
    assert (cols[:3] == -1.0).all()
    assert (cols >= 10.0).sum() > 0          # seen by the third camera only
    assert ((cols >= 0) & (cols < 10.0)).sum() > 0
    assert (cols == -1.0).sum() > 3


def _calibrations(cls):
    """tests/test_painting.py's rotated (FLU pinhole, rotate=True) and
    stereo-baseline (3x4 projection) cameras."""
    ts = cls("base")
    ts.set_intrinsic_lidar("velo")
    ts.set_extrinsic(np.eye(4), frame_to="velo")
    ts.set_intrinsic_pinhole("camflu", (1280, 960), 640, 480, 700, 700)
    t = np.eye(4)
    t[:3, 3] = [0.0, 1.0, 0.2]
    ts.set_extrinsic(t, frame_to="camflu")
    p34 = np.array([[700.0, 0, 640, -350.0], [0, 700.0, 480, 0],
                    [0, 0, 1, 0]])
    ts.set_intrinsic_camera("camstereo", p34, (1280, 960), rotate=False)
    t2 = np.eye(4)
    t2[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    ts.set_extrinsic(t2, frame_to="camstereo")
    return ts


def test_painting_rig_matches():
    """The rig of the port's TransformSet equals the JAX package's on its
    own TransformSet exactly (both host numpy and scipy), and its
    projections equal the port's ``project_points_to_camera`` within
    0.3 px, as the JAX package's test holds its own."""
    cams = ["camflu", "camstereo"]
    want = painting_rig(_calibrations(TransformSet), cams, frame_from="velo")
    calib = _calibrations(TTransformSet)
    got = TP.painting_rig(calib, cams, frame_from="velo")
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(w))
    rng = np.random.default_rng(4)
    pts = np.stack([rng.uniform(5, 40, 48), rng.uniform(-6, 6, 48),
                    rng.uniform(-2, 1, 48)], axis=1)
    for i, cam in enumerate(cams):
        uv, _, dmask = calib.project_points_to_camera(
            pts, frame_to=cam, frame_from="velo", remove_outlier=False,
            return_dmask=True)
        u, v, ahead = TP._project(*_t(pts.astype(np.float32), got[0][i],
                                      got[1][i]))
        sel = np.zeros(len(pts), bool)
        sel[dmask] = True
        np.testing.assert_array_equal(ahead.numpy(), sel)
        np.testing.assert_allclose(u.numpy()[sel], uv[sel, 0], rtol=1e-4,
                                   atol=0.3)
        np.testing.assert_allclose(v.numpy()[sel], uv[sel, 1], rtol=1e-4,
                                   atol=0.3)


@pytest.fixture(scope="module")
def seg_bank():
    """Seeded flax Seg2D variables (BatchNorm statistics and an
    asymmetric transposed kernel included), images, labels and the JAX
    package's logits and one float64 training step."""
    rng = np.random.default_rng(20261017)
    scenes = [_scene(rng) for _ in range(2)]
    images = np.stack([s[0] for s in scenes])
    labels = np.stack([s[1] for s in scenes])
    labels[0, :4] = -1                       # ignored pixels
    model = Seg2D(TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    variables = _randomize(shapes, np.random.default_rng(5))
    logits = np.asarray(jax.jit(lambda v, x: model.apply(v, x))(
        variables, jnp.asarray(images)))
    cfg64 = dataclasses.replace(TINY, dtype="float64")
    var64 = jax.tree.map(lambda x: np.asarray(x, np.float64), variables)
    tx = optax.chain(_capture_grads(), optax.sgd(0.1))
    step = jax.jit(make_seg2d_train_step(Seg2D(cfg64), tx, cfg64))
    _, bs, opt_state, aux = step(
        var64["params"], var64["batch_stats"], tx.init(var64["params"]),
        dict(images=jnp.asarray(images, jnp.float64),
             labels=jnp.asarray(labels)))
    return dict(images=images, labels=labels, model=model,
                variables=variables, logits=logits,
                loss=float(aux["total"]), acc=float(aux["acc"]),
                grads=seg2d_params_from_flax(opt_state[0]),
                stats=jax.tree.map(np.asarray, bs))


def _port_seg(bank, dtype="float32"):
    model = TS.Seg2D(dataclasses.replace(TINY, dtype=dtype), device="cpu")
    model.load_state_dict(seg2d_state_from_flax(bank["variables"]))
    return model


def test_seg2d_transposed_kernel_is_not_symmetric(seg_bank):
    """The bridge is held on a kernel its spatial flip changes."""
    k = np.asarray(seg_bank["variables"]["params"]["_Block_3"]
                   ["ConvTranspose_0"]["kernel"])
    assert np.abs(k - k[::-1, ::-1]).max() > 0.1


def test_seg2d_forward_matches(seg_bank):
    """Logits (B, H, W, C) within 2e-5 of their largest magnitude in
    float32 (six convolutions summed in other orders), within 2^-5 in
    bfloat16; the shape checks raise as JAX's."""
    want = seg_bank["logits"]
    for dtype, tol in (("float32", 2e-5), ("bfloat16", 2 ** -5)):
        model = _port_seg(seg_bank, dtype)
        with torch.no_grad():
            got = model(torch.from_numpy(seg_bank["images"])).numpy()
        assert got.shape == want.shape == (2, *TINY.image_size, 3)
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), dtype
    with pytest.raises(ValueError, match="image_size"):
        model(torch.zeros((1, 16, 64, 3)))


def test_seg2d_train_step_matches_f64(seg_bank):
    """One float32 step of the port against the JAX package's float64
    step: loss rtol 1e-5, accuracy exact, every gradient leaf within 1e-4
    of its largest |g| (BatchNorm over 48x64 pixels in float32), the
    running statistics within 1e-5."""
    model = _port_seg(seg_bank)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    aux = TS.make_seg2d_train_step(model, opt, TINY)(
        dict(images=torch.from_numpy(seg_bank["images"]),
             labels=torch.from_numpy(seg_bank["labels"])))
    np.testing.assert_allclose(float(aux["total"]), seg_bank["loss"],
                               rtol=1e-5)
    assert float(aux["acc"]) == pytest.approx(seg_bank["acc"], abs=1e-7)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(seg_bank["grads"])
    for name, g in grads.items():
        ref = seg_bank["grads"][name].numpy()
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-4, (name, err)
    st = seg_bank["stats"]["_Block_0"]["BatchNorm_0"]
    np.testing.assert_allclose(model.blocks[0].bn.running_mean.numpy(),
                               st["mean"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.blocks[0].bn.running_var.numpy(),
                               st["var"], rtol=1e-5, atol=1e-5)


def test_segmenter_matches(seg_bank):
    """``make_segmenter`` on one image: softmax scores within 1e-6 of the
    JAX segmenter's, rows summing to 1."""
    img = seg_bank["images"][1]
    want = np.asarray(make_segmenter(seg_bank["model"],
                                     seg_bank["variables"])(
        jnp.asarray(img)))
    seg = TS.make_segmenter(TS.Seg2D(TINY, device="cpu"),
                            seg2d_state_from_flax(seg_bank["variables"]),
                            device="cpu")
    got = seg(img).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)

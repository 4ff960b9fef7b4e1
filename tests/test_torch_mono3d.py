"""The port's Mono3D (``models/mono3d.py``) against the JAX package on
``tests/test_mono3d.py``'s TINY configuration (96 x 128 images, backbone
8/16/32, two classes): the same flax weights (randomized, BatchNorm
statistics and asymmetric transposed kernels included) carried across by
``mono3d_state_from_flax``, then the forward in float32 and bfloat16, the
targets (a box behind the camera, one past ``max_depth``, a masked one and
labels outside the classes included), the loss, the decode (ties among
zero peaks included), the camera <-> velo conversions with a calibration
trio, the detector, ``flip_camera_frame`` with the targets, BatchNorm
folding and one training step.

One module-scoped bank holds the inputs and the JAX package's results, so
each JAX program compiles once. Tolerances are stated per test."""

import dataclasses

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import optax
import torch

from d3d_tpu.augment import flip_camera_frame
from d3d_tpu.dataset.kitti.object import _cam_to_velo
from d3d_tpu.dataset.kitti.utils import KittiObjectClass
from d3d_tpu.models import presets
from d3d_tpu.models.fold import fold_batchnorm
from d3d_tpu.models.mono3d import (Mono3D, assign_mono3d_targets,
                                   decode_mono3d, make_mono3d_detector,
                                   make_train_step, mono3d_gt_from_targets,
                                   mono3d_loss, mono3d_to_targets)

from d3d_tpu_torch.augment import flip_camera_frame as t_flip
from d3d_tpu_torch.dataset.kitti.object import _cam_to_velo as t_cam_to_velo
from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TClass
from d3d_tpu_torch.models import mono3d as TM
from d3d_tpu_torch.models import presets as t_presets
from d3d_tpu_torch.models.convert import (mono3d_params_from_flax,
                                          mono3d_state_from_flax)
from d3d_tpu_torch.models.fold import fold_batchnorm as t_fold

from tests.test_mono3d import TINY, K, _gt_cam
from tests.test_torch_second import _randomize
from tests.test_torch_voxelnext import _capture_grads, _rel_max

TCFG = TM.Mono3DConfig(**dataclasses.asdict(TINY))
B, M = 2, 6
CLASSES = [KittiObjectClass.Car, KittiObjectClass.Pedestrian]
T_CLASSES = [TClass.Car, TClass.Pedestrian]


def _gt_batch(rng):
    """Two frames of M camera-frame boxes: frame 0's box 3 behind the
    camera and 300 km aside (its projection through max(z, 1e-3) past
    int32's range), box 4 past max_depth, box 5 masked; frame 1's box 3
    behind the camera, box 4 labelled -1 (clamped to 0) and box 5
    labelled 2 (outside the two classes: no heatmap splat)."""
    gt = np.stack([_gt_cam(rng, M) for _ in range(B)])
    gt[0, 3, [0, 2]] = [3e5, -6.0]
    gt[0, 4, 2] = 95.0
    gt[1, 3, 2] = -3.0
    labels = rng.integers(0, 2, (B, M)).astype(np.int32)
    labels[1, 4], labels[1, 5] = -1, 2
    mask = np.ones((B, M), bool)
    mask[0, 5] = False
    return dict(intrinsics=np.stack([K, K * [[1.1], [1.1], [1]]]).astype(
        np.float32), gt_boxes=gt, gt_labels=labels, gt_mask=mask)


def _calib():
    """A KITTI-like raw calibration (tests/test_mono3d.py's) and its trio
    from each package."""
    tr = np.eye(4)[:3]
    tr[:3, :3] = Rotation.from_euler("xyz", [0.01, -0.02, 1.55]).as_matrix()
    tr[:, 3] = [0.27, -0.01, -0.06]
    rect = Rotation.from_euler("zyx", [0.002, -0.001, 0.003])
    raw = {"Tr_velo_to_cam": tr.reshape(-1),
           "R0_rect": rect.as_matrix().reshape(-1)}
    return _cam_to_velo(raw), t_cam_to_velo(raw)


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(20261017)
    images = rng.random((B, *TINY.image_size, 3)).astype(np.float32)
    batch = dict(images=images, **_gt_batch(rng))
    model = Mono3D(TINY)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))
    variables = _randomize(shapes, np.random.default_rng(5))
    apply = jax.jit(lambda v, x: model.apply(v, x))
    out = {k: np.asarray(v) for k, v in
           apply(variables, jnp.asarray(images)).items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    targets = [assign_mono3d_targets(TINY, jb["intrinsics"][i],
                                     jb["gt_boxes"][i], jb["gt_labels"][i],
                                     jb["gt_mask"][i]) for i in range(B)]
    targets = {k: np.stack([np.asarray(t[k]) for t in targets])
               for k in targets[0]}
    tx = optax.chain(_capture_grads(), optax.sgd(0.1))
    step = jax.jit(make_train_step(model, tx, TINY))
    _, stats, opt_state, aux = step(variables["params"],
                                    variables["batch_stats"],
                                    tx.init(variables["params"]), jb)
    return dict(batch=batch, model=model, variables=variables, apply=apply,
                out=out, targets=targets, loss=float(aux["total"]),
                grads=mono3d_params_from_flax(opt_state[0]),
                stats=jax.tree.map(np.asarray, stats))


def _port(bank, dtype="float32"):
    model = TM.Mono3D(dataclasses.replace(TCFG, dtype=dtype), device="cpu")
    model.load_state_dict(mono3d_state_from_flax(bank["variables"]))
    return model


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_preset_matches():
    """mono3d_kitti equals the JAX preset; at its full width the port's
    stride-4 output of a 384 x 1280 image is 96 x 320 (five strided
    blocks, then 4 - log2(4) + 1 = 3 transposed ones)."""
    cfg = t_presets.mono3d_kitti()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        presets.mono3d_kitti())
    model = TM.Mono3D(dataclasses.replace(cfg, dtype="float32"),
                      device="cpu")
    assert len(model.blocks) == 8 and sum(
        b.transpose for b in model.blocks) == 3
    assert cfg.out_size == (96, 320)


def test_forward_matches(bank):
    """Every head (B, h, w, C) within 2e-5 of its largest magnitude in
    float32 (the convolutions sum in other orders), within 2^-5 in
    bfloat16; float32 out either way. The bridge is held on a transposed
    kernel its spatial flip changes."""
    k = np.asarray(bank["variables"]["params"]["_Block_4"]
                   ["ConvTranspose_0"]["kernel"])
    assert np.abs(k - k[::-1, ::-1]).max() > 0.1
    h, w = TINY.out_size
    for dtype, tol in (("float32", 2e-5), ("bfloat16", 2 ** -5)):
        with torch.no_grad():
            got = _port(bank, dtype)(torch.from_numpy(bank["batch"]
                                                      ["images"]))
        assert set(got) == set(bank["out"])
        for name, want in bank["out"].items():
            g = got[name]
            assert g.dtype == torch.float32 and g.shape[:3] == (B, h, w)
            err = np.abs(g.numpy() - want).max() / np.abs(want).max()
            assert err <= tol, (dtype, name, err)


def test_targets_match(bank):
    """Heatmap within 1e-6, the regression vectors within 1e-5 (f32 trig
    and logs of two libraries), cells and masks exact, in every row: the
    boxes behind the camera project through max(z, 1e-3) outside the map
    (the 300 km one's cell index saturating as XLA's), the masked and far
    boxes are unassigned, and the label past the classes splats
    nothing."""
    t = bank["targets"]
    b = _torch(bank["batch"])
    got = [TM.assign_mono3d_targets(TCFG, b["intrinsics"][i],
                                    b["gt_boxes"][i], b["gt_labels"][i],
                                    b["gt_mask"][i]) for i in range(B)]
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g["mask"].numpy(), t["mask"][i])
        np.testing.assert_array_equal(g["cell"].numpy(), t["cell"][i])
        np.testing.assert_allclose(g["heatmap"].numpy(), t["heatmap"][i],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(g["vec"].numpy(), t["vec"][i],
                                   rtol=1e-5, atol=1e-5)
    assert not t["mask"][0, 3:].any() and not t["mask"][1, 3]
    assert t["vec"][0, 3, 0] > 1e9                 # u - 2^31: saturated
    assert t["mask"][1, 5] and t["heatmap"][1].max() == 1.0


def test_loss_matches(bank):
    """The focal + L1 loss on the JAX package's outputs and targets
    within 1e-5 relative, each term."""
    want = mono3d_loss(jax.tree.map(jnp.asarray, bank["out"]),
                       jax.tree.map(jnp.asarray, bank["targets"]))[1]
    got = TM.mono3d_loss(_torch(bank["out"]), _torch(bank["targets"]))[1]
    for k in ("hm", "reg", "total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)


def _peaky(bank):
    """Frame 0's outputs with three heatmap peaks and every other logit at
    -200 (sigmoid 0): the top-8 holds five tied zeros."""
    out = {k: v[0].copy() for k, v in bank["out"].items()}
    hm = np.full_like(out["heatmap"], -200.0)
    for v, u, c, s in ((3, 4, 0, 3.0), (10, 20, 1, 2.0), (17, 9, 0, 1.0)):
        hm[v, u, c] = s
    out["heatmap"] = hm
    return out


@pytest.mark.parametrize("case", ["network", "tied_zeros"])
def test_decode_matches(bank, case):
    """decode_mono3d of one frame: the top-k order over (h, w, C) equal
    (equal scores lowest index first, as lax.top_k: the tied zeros fill
    the top-k in index order), labels exact, scores within 1e-6, boxes
    within 1e-4 relative (exp and atan2 of two libraries)."""
    out = ({k: v[0] for k, v in bank["out"].items()} if case == "network"
           else _peaky(bank))
    want = [np.asarray(a) for a in decode_mono3d(
        TINY, jax.tree.map(jnp.asarray, out), jnp.asarray(K))]
    got = [a.numpy() for a in TM.decode_mono3d(TCFG, _torch(out),
                                               torch.from_numpy(K))]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    if case == "tied_zeros":
        assert (want[1][3:] == 0).all()


def test_camera_velo_conversions_match():
    """mono3d_to_targets with a calibration trio: positions and sizes
    within 1e-6 m, orientations within 1e-6 rad of the JAX package's;
    mono3d_gt_from_targets of each side's targets back to the boxes
    within 1e-5; the camera-frame call without a trio too."""
    trio, t_trio = _calib()
    boxes = np.array([[4.5, 1.2, 14.0, 3.9, 1.6, 1.5, 0.6],
                      [-3.0, 1.6, 22.0, 0.8, 0.6, 1.7, -2.8]], np.float32)
    scores, labels = np.array([0.9, 0.5]), np.array([0, 1], np.int32)
    for jt, tt in ((trio, t_trio), (None, None)):
        want = mono3d_to_targets(boxes, scores, labels, CLASSES,
                                 cam_to_velo=jt, score_threshold=0.0)
        got = TM.mono3d_to_targets(boxes, scores, labels, T_CLASSES,
                                   cam_to_velo=tt, score_threshold=0.0)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.position, w.position, atol=1e-6)
            np.testing.assert_allclose(g.dimension, w.dimension, atol=1e-6)
            assert (g.orientation.inv() * w.orientation).magnitude() < 1e-6
            assert g.tag_top.name == w.tag_top.name
        back, lab = TM.mono3d_gt_from_targets(got, cam_to_velo=tt)
        want_back, want_lab = mono3d_gt_from_targets(want, cam_to_velo=jt)
        np.testing.assert_allclose(back, want_back, atol=1e-5)
        np.testing.assert_allclose(back[:, :6], boxes[:, :6], atol=1e-5)
        np.testing.assert_array_equal(lab, want_lab)


def test_detector_matches(bank):
    """make_mono3d_detector on one image with the trio: the same
    Target3DArray (velo frame) as the JAX detector's at score threshold
    0, positions within 1e-3 m (the decode's exp of depth), labels
    equal; ``device_fn`` gives the decode's (K, 7), (K,), (K,)."""
    trio, t_trio = _calib()
    image = bank["batch"]["images"][1]
    want = make_mono3d_detector(bank["model"], bank["variables"], TINY,
                                CLASSES, cam_to_velo=trio,
                                score_threshold=0.0)(image, K)
    detect = TM.make_mono3d_detector(
        TM.Mono3D(TCFG, device="cpu"),
        mono3d_state_from_flax(bank["variables"]), TCFG, T_CLASSES,
        cam_to_velo=t_trio, score_threshold=0.0, device="cpu")
    got = detect(image, K)
    assert got.frame == want.frame == "velo" and len(got) == len(want)
    np.testing.assert_allclose(got.columns()["position"],
                               want.columns()["position"], rtol=1e-4,
                               atol=1e-3)
    assert [o.tag_top.name for o in got] == [o.tag_top.name for o in want]
    boxes, scores, labels = detect.device_fn(image, K)
    assert boxes.shape == (TINY.top_k, 7) and labels.dtype == torch.int32


def test_flip_camera_frame_mirrors_targets(bank):
    """The port's flip_camera_frame on numpy inputs equals the JAX
    package's; the targets of the flipped frame equal JAX's on its flipped
    frame and sit at the mirrored cells (tests/test_mono3d.py's mirror
    check, on the port)."""
    gt = bank["batch"]["gt_boxes"][1, :3]
    img = bank["batch"]["images"][0]
    want = [np.asarray(a) for a in flip_camera_frame(img, K, gt)]
    got = t_flip(img, K, gt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    labels = torch.zeros(3, dtype=torch.int32)
    mask = torch.ones(3, dtype=torch.bool)
    t0 = TM.assign_mono3d_targets(TCFG, torch.from_numpy(K),
                                  torch.from_numpy(gt), labels, mask)
    t1 = TM.assign_mono3d_targets(TCFG, torch.from_numpy(got[1]),
                                  torch.from_numpy(got[2]), labels, mask)
    w1 = assign_mono3d_targets(TINY, jnp.asarray(want[1]),
                               jnp.asarray(want[2]), jnp.zeros(3, jnp.int32),
                               jnp.ones(3, bool))
    np.testing.assert_array_equal(t1["cell"].numpy(), np.asarray(w1["cell"]))
    np.testing.assert_allclose(t1["heatmap"].numpy(),
                               np.asarray(w1["heatmap"]), atol=1e-6)
    assert bool(t1["mask"].all())
    h, w = TINY.out_size
    hm0, hm1 = t0["heatmap"][..., 0].numpy(), t1["heatmap"][..., 0].numpy()
    for m in range(3):
        c0, c1 = int(t0["cell"][m]), int(t1["cell"][m])
        u0 = (c0 % w + float(t0["vec"][m, 0])) * TINY.stride
        u1 = (c1 % w + float(t1["vec"][m, 0])) * TINY.stride
        assert abs(u1 - (img.shape[1] - 1 - u0)) < 1e-3
        assert c0 // w == c1 // w and hm0.flat[c0] == hm1.flat[c1] == 1.0
    np.testing.assert_allclose(t1["vec"][:, 2:6].numpy(),
                               t0["vec"][:, 2:6].numpy(), atol=1e-6)


def test_fold_batchnorm_matches(bank):
    """fold_batchnorm on the port's Mono3D (every Conv/ConvTranspose +
    BatchNorm pair, tests/test_mono3d.py's check): inference outputs
    within 2e-5 of the unfolded model's and of the JAX package's folded
    model's."""
    var = dict(bank["variables"], batch_stats=jax.tree.map(
        lambda a: a + 0.25, bank["variables"]["batch_stats"]))
    images = bank["batch"]["images"][:1]
    want = bank["apply"](fold_batchnorm(var), jnp.asarray(images))
    model = TM.Mono3D(TCFG, device="cpu")
    model.load_state_dict(mono3d_state_from_flax(var))
    with torch.no_grad():
        base = model(torch.from_numpy(images))
        model.load_state_dict(t_fold(model))
        got = model(torch.from_numpy(images))
    assert float(model.blocks[0].bn.weight.detach().sum()) == len(
        model.blocks[0].bn.weight)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), base[k].numpy(), rtol=0,
                                   atol=2e-5, err_msg=k)
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), rtol=0,
                                   atol=2e-5, err_msg=k)


def test_train_step_matches(bank):
    """One float32 step of the port against the JAX package's own
    make_train_step (float32; its heads cast to float32 whatever the
    dtype, so no float64 reference exists): loss rtol 1e-5, every
    gradient leaf within 1e-4 of its largest |g|, the first block's
    running statistics within 1e-5; remat gives the same loss and
    gradients bit for bit."""
    runs = []
    for remat in (False, True):
        model = _port(bank)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        aux = TM.make_train_step(model, opt, TCFG, remat=remat)(
            _torch(bank["batch"]))
        runs.append((model, float(aux["total"]),
                     {n: p.grad for n, p in model.named_parameters()}))
    model, loss, grads = runs[0]
    assert runs[1][1] == loss and all(
        torch.equal(g, runs[1][2][n]) for n, g in grads.items())
    np.testing.assert_allclose(loss, bank["loss"], rtol=1e-5)
    assert set(grads) == set(bank["grads"])
    for name, g in grads.items():
        err = _rel_max(g.numpy(), bank["grads"][name].numpy())
        assert err <= 1e-4, (name, err)
    st = bank["stats"]["_Block_0"]["BatchNorm_0"]
    np.testing.assert_allclose(model.blocks[0].bn.running_mean.numpy(),
                               st["mean"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.blocks[0].bn.running_var.numpy(),
                               st["var"], rtol=1e-5, atol=1e-5)

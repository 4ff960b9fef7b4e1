"""The port's VoxelNeXt against the JAX package on
``tests/test_voxelnext.py``'s TINY configuration (with the velocity head, the nuScenes preset's): the same
flax weights (randomized, BatchNorm statistics included) carried across by
``voxelnext_state_from_flax``, the same voxels, the same outputs, targets,
loss, gradients, detections and TTA merge.

One module-scoped bank holds the inputs and the JAX package's results, so
each JAX program compiles once. Tolerances are stated per test: integer
outputs and masks exact; float32 values within f32 rounding (XLA:CPU and
torch sum, exponentiate and fuse in other orders)."""

import dataclasses

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import optax
import torch

from d3d_tpu.dataset.kitti.utils import KittiObjectClass
from d3d_tpu.models import presets
from d3d_tpu.models.inference import make_voxelnext_detector
from d3d_tpu.models.tta import make_tta_detector
from d3d_tpu.models.voxelnext import (VoxelNeXt, assign_voxelnext_targets,
                                      compress_height, decode_voxelnext,
                                      make_train_step, voxelnext_loss)
from d3d_tpu.train import make_optimizer

from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TClass
from d3d_tpu_torch.models import VoxelNeXt as TVoxelNeXt
from d3d_tpu_torch.models import VoxelNeXtConfig as TConfig
from d3d_tpu_torch.models import make_tta_detector as t_tta
from d3d_tpu_torch.models import make_voxelnext_detector as t_detector
from d3d_tpu_torch.models import presets as t_presets
from d3d_tpu_torch.models import (voxelnext_params_from_flax,
                                  voxelnext_state_from_flax,
                                  voxelnext_voxelize)
from d3d_tpu_torch.models import voxelnext as TV
from d3d_tpu_torch.train import make_optimizer as t_make_optimizer

from tests.test_torch_second import _randomize
from tests.test_voxelnext import TINY, _cloud, _gt

CFG = dataclasses.replace(TINY, predict_velocity=True)
TCFG = TConfig(**dataclasses.asdict(CFG))
CLASSES = [KittiObjectClass.Car, KittiObjectClass.Pedestrian]
T_CLASSES = [TClass.Car, TClass.Pedestrian]
STEPS = 3
B = 2


def _capture_grads():
    """An optax transformation whose state keeps the gradient it got."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def _voxels(clouds):
    """The port's voxels of each cloud, stacked (held to the JAX
    package's by tests/test_torch_second.py::test_voxelize_matches)."""
    vox = [voxelnext_voxelize(torch.from_numpy(p), TCFG) for p in clouds]
    return [torch.stack([v[i] for v in vox]) for i in range(3)]


@pytest.fixture(scope="module")
def bank():
    """Inputs and the JAX package's results on them, computed once."""
    rng = np.random.default_rng(20261017)
    clouds = [_cloud(rng) for _ in range(B)]
    feats, coords, valid = _voxels(clouds)
    gt = np.stack([_gt(rng, 4) for _ in range(B)])
    gt[1, 3, 0] = 40.0                     # outside the grid
    batch = dict(features=feats.numpy(), coords=coords.numpy(),
                 valid=valid.numpy(), gt_boxes=gt,
                 gt_labels=rng.integers(0, 2, (B, 4)).astype(np.int32),
                 gt_mask=np.array([[1, 1, 1, 1], [1, 1, 0, 1]], bool),
                 gt_velocity=rng.normal(0, 2, (B, 4, 2)).astype(np.float32))
    model = VoxelNeXt(CFG)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            batch["features"], batch["coords"],
                            batch["valid"])
    variables = _randomize(shapes, np.random.default_rng(3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jax.jit(lambda v, f, c, m: model.apply(v, f, c, m))(
        variables, jb["features"], jb["coords"], jb["valid"])
    out = {k: np.asarray(v) for k, v in out.items()}
    targets = [assign_voxelnext_targets(
        CFG, jnp.asarray(out["site_xy"][i]), jnp.asarray(out["site_valid"][i]),
        jb["gt_boxes"][i], jb["gt_labels"][i], jb["gt_mask"][i],
        jb["gt_velocity"][i]) for i in range(B)]
    targets = {k: np.stack([np.asarray(t[k]) for t in targets])
               for k in targets[0]}
    loss, _ = voxelnext_loss(jax.tree.map(jnp.asarray, out),
                             jax.tree.map(jnp.asarray, targets))
    return dict(clouds=clouds, batch=batch, model=model, variables=variables,
                out=out, targets=targets, loss=float(loss))


def _port_model(bank, dtype="float32"):
    model = TVoxelNeXt(dataclasses.replace(TCFG, dtype=dtype), device="cpu")
    model.load_state_dict(voxelnext_state_from_flax(bank["variables"]))
    return model


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_presets_match():
    want = dataclasses.asdict(presets.voxelnext_nuscenes())
    assert dataclasses.asdict(t_presets.voxelnext_nuscenes()) == want
    cfg = t_presets.voxelnext_nuscenes()
    assert cfg.bev_grid == (135, 135) and cfg.bev_voxel == (0.8, 0.8)


@pytest.mark.parametrize("case", ["oracle", "overflow"])
def test_compress_height_exact(case):
    """Features, cells and masks bit for bit, the overflow case's dropped
    cells included (one stable sort and an in-order segment sum on both
    sides)."""
    rng = np.random.default_rng(7)
    if case == "oracle":
        n, grid, cap = 96, (16, 16), 64
        coords = rng.integers(0, 12, (n, 3)).astype(np.int32)
        valid = rng.random(n) < 0.8
    else:
        n, grid, cap = 40, (40, 4), 16
        coords = np.stack([rng.permutation(n) % 24, np.zeros(n),
                           rng.integers(0, 3, n)], 1).astype(np.int32)
        valid = np.ones(n, bool)
    feats = rng.normal(size=(n, 5)).astype(np.float32)
    want = compress_height(jnp.asarray(feats), jnp.asarray(coords),
                           jnp.asarray(valid), grid, cap)
    got = TV.compress_height(torch.from_numpy(feats), torch.from_numpy(coords),
                             torch.from_numpy(valid), grid, cap)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2].sum()) == min(cap, len(np.unique(
        coords[valid][:, :2], axis=0)))


def test_forward_matches(bank):
    """Batch of 2 with the velocity head: site cells and masks exact,
    heatmap and regression within 2e-5 of each output's largest
    magnitude (f32 sums in other orders through five sparse layers)."""
    model = _port_model(bank)
    b = _torch({k: bank["batch"][k] for k in ("features", "coords",
                                               "valid")})
    with torch.no_grad():
        got = model(b["features"], b["coords"], b["valid"])
    want = bank["out"]
    np.testing.assert_array_equal(got["site_valid"].numpy(),
                                  want["site_valid"])
    np.testing.assert_array_equal(got["site_xy"].numpy(), want["site_xy"])
    assert want["site_valid"].sum() > 20
    for key in ("heatmap", "reg"):
        g, w = got[key].numpy(), want[key]
        assert g.shape == w.shape == (B, CFG.bev_sites, w.shape[-1])
        assert np.abs(g - w).max() <= 2e-5 * np.abs(w).max(), key


def test_bf16_forward_matches(bank):
    """The preset's bfloat16: sites exact, heads within 2^-5 of the f32
    outputs' largest magnitude (bf16's 2^-8 over a few layers)."""
    model = _port_model(bank, "bfloat16")
    b = _torch({k: bank["batch"][k] for k in ("features", "coords",
                                               "valid")})
    with torch.no_grad():
        got = model(b["features"], b["coords"], b["valid"])
    np.testing.assert_array_equal(got["site_valid"].numpy(),
                                  bank["out"]["site_valid"])
    for key in ("heatmap", "reg"):
        assert got[key].dtype == torch.float32
        w = bank["out"][key]
        assert np.abs(got[key].numpy() - w).max() <= 2 ** -5 * np.abs(w).max()


def test_decode_matches(bank):
    """Decoding the same outputs: the top-k's labels exact, scores within
    1e-6, boxes within 1e-5 (exp and atan2 to an ulp), velocities exact."""
    out = {k: v[0] for k, v in bank["out"].items()}
    want = [np.asarray(a) for a in decode_voxelnext(
        CFG, jax.tree.map(jnp.asarray, out))]
    got = [t.numpy() for t in TV.decode_voxelnext(TCFG, _torch(out))]
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3], want[3])
    cfg8 = dataclasses.replace(TCFG, predict_velocity=False)
    out8 = dict(_torch(out), reg=torch.from_numpy(np.array(out["reg"][:, :8])))
    assert len(TV.decode_voxelnext(cfg8, out8)) == 3


def test_targets_match(bank):
    """On the forward's sites: pos_site and pos_mask exact (a box outside
    the grid and a masked one unassigned), heat and vec within 1e-6
    (exp, log, sin, cos to an ulp)."""
    want = bank["targets"]
    for i in range(B):
        got = TV.assign_voxelnext_targets(
            TCFG, *(torch.from_numpy(np.array(bank["out"][k][i]))
                    for k in ("site_xy", "site_valid")),
            *(torch.from_numpy(bank["batch"][k][i])
              for k in ("gt_boxes", "gt_labels", "gt_mask", "gt_velocity")))
        np.testing.assert_array_equal(got["pos_site"].numpy(),
                                      want["pos_site"][i])
        np.testing.assert_array_equal(got["pos_mask"].numpy(),
                                      want["pos_mask"][i])
        for key in ("heat", "vec"):
            np.testing.assert_allclose(got[key].numpy(), want[key][i],
                                       rtol=1e-6, atol=1e-6, err_msg=key)
    assert not want["pos_mask"][1, 2] and not want["pos_mask"][1, 3]
    assert 0 < (want["heat"] == 1.0).sum() <= want["pos_mask"].sum()


def test_loss_matches(bank):
    """The loss of the same outputs and targets: rtol 1e-6."""
    total, aux = TV.voxelnext_loss(_torch(bank["out"]),
                                   _torch(bank["targets"]))
    np.testing.assert_allclose(float(total), bank["loss"], rtol=1e-6)
    assert float(aux["reg"]) > 0 and float(aux["hm"]) > 0


@pytest.fixture(scope="module")
def jax_steps(bank):
    """The JAX package's own make_train_step, one step from the flax
    weights in float32 and float64: (loss, gradients in port names)."""
    out = {}
    for dtype in ("float32", "float64"):
        cfg = dataclasses.replace(CFG, dtype=dtype)
        fdt = np.float64 if dtype == "float64" else np.float32
        var = jax.tree.map(lambda x: np.asarray(x, fdt), bank["variables"])
        batch = dict(bank["batch"])
        batch["features"] = batch["features"].astype(fdt)
        tx = optax.chain(_capture_grads(), make_optimizer(STEPS)[0])
        step = jax.jit(make_train_step(VoxelNeXt(cfg), tx, cfg))
        _, bs, opt_state, aux = step(
            var["params"], var["batch_stats"], tx.init(var["params"]),
            {k: jnp.asarray(v) for k, v in batch.items()})
        out[dtype] = dict(loss=float(aux["total"]),
                          grads=voxelnext_params_from_flax(opt_state[0]),
                          stats=jax.tree.map(np.asarray, bs))
    return out


def _rel_max(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def test_train_step_matches_f64(bank, jax_steps):
    """One float32 step of the port (K5 forward and features' gradient,
    K6 on the card; their plain versions here) against the JAX package's
    float64 step (its float32 CPU step is itself off its float64 one):
    loss rtol 1e-5; every gradient leaf within 5e-6 of its largest |g|
    (1.2e-6 seen; the JAX float32 step's own, 1.0e-6) and no farther than
    twice the JAX float32 step's distance plus 1e-6; the running
    statistics of head_bn within 1e-5."""
    model = _port_model(bank)
    opt, _ = t_make_optimizer(model.parameters(), STEPS)
    step = TV.make_train_step(model, opt, TCFG)
    aux = step({k: torch.from_numpy(v) for k, v in bank["batch"].items()})
    want64, want32 = jax_steps["float64"], jax_steps["float32"]
    np.testing.assert_allclose(float(aux["total"]), want64["loss"],
                               rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want64["grads"])
    for name, g in grads.items():
        ref = want64["grads"][name].numpy()
        if name == "head1.bias":
            # a bias before a batch-statistics BatchNorm: its gradient is 0
            # but for rounding (7e-8 in float64), so held absolutely
            scale = np.abs(want64["grads"]["head1.weight"].numpy()).max()
            assert np.abs(g.numpy()).max() <= 1e-6 * scale
            continue
        err = _rel_max(g.numpy().astype(np.float64), ref)
        ref_err = _rel_max(want32["grads"][name].numpy(), ref)
        assert err <= 5e-6 and err <= 2 * ref_err + 1e-6, (name, err,
                                                           ref_err)
    st = jax_steps["float32"]["stats"]["head_bn"]
    np.testing.assert_allclose(model.head_bn.running_mean.numpy(),
                               st["mean"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.head_bn.running_var.numpy(),
                               st["var"], rtol=1e-5, atol=1e-5)


def test_remat_step_equals_plain(bank):
    """remat recomputes the forward: loss and gradients bit-equal."""
    runs = []
    for remat in (False, True):
        model = _port_model(bank)
        opt, _ = t_make_optimizer(model.parameters(), STEPS)
        aux = TV.make_train_step(model, opt, TCFG, remat=remat)(
            {k: torch.from_numpy(v) for k, v in bank["batch"].items()})
        runs.append((float(aux["total"]),
                     [p.grad.clone() for p in model.parameters()],
                     model.head_bn.running_var.clone()))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert torch.equal(runs[0][2], runs[1][2])


@pytest.fixture(scope="module")
def detectors(bank):
    """The JAX package's and the port's velocity detectors on the same
    weights, with the JAX device_fn's outputs on the first cloud."""
    jdet = make_voxelnext_detector(bank["model"], bank["variables"], CFG,
                                   CLASSES, score_threshold=0.0)
    tdet = t_detector(_port_model(bank), None, TCFG, T_CLASSES,
                      score_threshold=0.0, device="cpu")
    return jdet, tdet


def test_detector_matches(bank, detectors):
    """The 5-output device_fn: keep mask and labels exact, boxes within
    1e-4 (f32 network outputs through exp), scores within 1e-5,
    velocities within 1e-4; detect's TrackingTarget3Ds equal in count,
    tags and velocities."""
    jdet, tdet = detectors
    pts = bank["clouds"][0]
    want = [np.asarray(a) for a in jdet.device_fn(jnp.asarray(pts))]
    got = [t.numpy() for t in tdet.device_fn(pts)]
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-4)
    a = jdet(pts, frame="velo", timestamp=5)
    b = tdet(pts, frame="velo", timestamp=5)
    assert len(a) == len(b) == int(want[3].sum()) > 0
    assert b.frame == "velo" and b.timestamp == 5
    for x, y in zip(a, b):
        assert type(y).__name__ == "TrackingTarget3D"
        assert y.tag.labels == x.tag.labels
        np.testing.assert_allclose(y.velocity, x.velocity, atol=1e-4)
        np.testing.assert_allclose(y.position, x.position, atol=1e-4)


def test_tta_with_velocities_matches(bank, detectors):
    """The flip ensemble over the velocity detector: 5 outputs, keep mask
    exact, boxes, scores and velocities as test_detector_matches'."""
    jdet, tdet = detectors
    pts = bank["clouds"][1]
    want = [np.asarray(a) for a in make_tta_detector(
        jdet, CLASSES, score_threshold=0.0).device_fn(jnp.asarray(pts))]
    tt = t_tta(tdet, T_CLASSES, score_threshold=0.0)
    got = [t.numpy() for t in tt.device_fn(pts)]
    assert len(got) == len(want) == 5
    assert got[0].shape == (2 * CFG.top_k, 7)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-4)
    out = tt(pts, frame="velo")
    assert len(out) == int(got[3].sum())

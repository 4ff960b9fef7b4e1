"""The port's CenterPoint (one- and two-stage) against the JAX package on
``tests/test_centerpoint.py``'s TINY configuration with two classes and
the velocity head (the nuScenes preset's): the same flax weights
(randomized, BatchNorm statistics included) carried across by the
bridges, the same pillars, then the heads, targets (two boxes in one
cell), loss, decode (ties included), one training step, the detector,
the refinement stage, TTA and the fused tracking step.

One module-scoped bank holds the inputs and the JAX package's results, so
each JAX program compiles once. Tolerances are stated per test: integer
outputs, masks and slot tables exact; float32 values within f32 rounding
(XLA:CPU and torch sum, exponentiate and fuse in other orders)."""

import dataclasses
import warnings

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import optax
import torch

from d3d_tpu.dataset.kitti.utils import KittiObjectClass
from d3d_tpu.models import presets
from d3d_tpu.models.centerpoint import (CenterPoint, assign_center_targets,
                                        center_loss, decode_centers,
                                        make_train_step)
from d3d_tpu.models.centerpoint2 import (CenterPointRefine,
                                         encode_refinement_targets,
                                         make_refine_train_step,
                                         roi_grid_features)
from d3d_tpu.models.inference import make_centerpoint_detector
from d3d_tpu.models.tta import make_tta_detector
from d3d_tpu.tracking import device_tracker as JD
from d3d_tpu.train import make_optimizer

from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TClass
from d3d_tpu_torch.models import centerpoint as TC
from d3d_tpu_torch.models import centerpoint2 as TC2
from d3d_tpu_torch.models import (centerpoint_params_from_flax,
                                  centerpoint_refine_state_from_flax,
                                  centerpoint_state_from_flax, pillarize)
from d3d_tpu_torch.models import make_centerpoint_detector as t_detector
from d3d_tpu_torch.models import make_tta_detector as t_tta
from d3d_tpu_torch.models import presets as t_presets
from d3d_tpu_torch.tracking import device_tracker as TD
from d3d_tpu_torch.train import make_optimizer as t_make_optimizer

from tests.test_centerpoint import TINY, _cloud, _gt
from tests.test_centerpoint2 import RCFG
from tests.test_torch_second import _randomize
from tests.test_torch_tracking import SLOT_EXACT, SLOT_FLOAT
from tests.test_torch_voxelnext import _capture_grads, _rel_max

CFG = dataclasses.replace(TINY, num_classes=2, predict_velocity=True)
TCFG = TC.CenterPointConfig(**dataclasses.asdict(CFG))
TRCFG = TC2.RefineConfig(**dataclasses.asdict(RCFG))
CLASSES = [KittiObjectClass.Car, KittiObjectClass.Pedestrian]
T_CLASSES = [TClass.Car, TClass.Pedestrian]
FEAT_C = CFG.upsample_channels * len(CFG.backbone_channels)
B, M = 2, 6


def _pillars(clouds):
    """The port's pillars of each cloud, stacked (held to the JAX
    package's by tests/test_torch_pointpillars.py)."""
    pil = [pillarize(torch.from_numpy(p), TCFG) for p in clouds]
    return [torch.stack([p[i] for p in pil]) for i in range(3)]


def _gt_batch(rng):
    """Two frames of M boxes: frame 0's boxes 0 and 1 share a centre cell
    (the later one's vector wins), frame 1's box 4 lies outside the grid
    and its box 5 is masked; velocities for every box."""
    gt = np.stack([_gt(rng, M) for _ in range(B)])
    gt[0, 1, :2] = gt[0, 0, :2] + 0.05
    gt[0, 1, 3:6] = [4.4, 1.8, 1.6]
    gt[1, 4, 0] = 40.0
    mask = np.ones((B, M), bool)
    mask[1, 5] = False
    return dict(gt_boxes=gt,
                gt_labels=rng.integers(0, 2, (B, M)).astype(np.int32),
                gt_mask=mask,
                gt_velocity=rng.normal(0, 2, (B, M, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def bank():
    """Inputs and the JAX package's results on them, computed once."""
    rng = np.random.default_rng(20261017)
    clouds = [_cloud(rng) for _ in range(B)]
    feats, coords, valid = _pillars(clouds)
    batch = dict(features=feats.numpy(), coords=coords.numpy(),
                 valid=valid.numpy(), **_gt_batch(rng))
    model = CenterPoint(CFG, return_feat=True)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            batch["features"], batch["coords"],
                            batch["valid"])
    variables = _randomize(shapes, np.random.default_rng(3))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jax.jit(lambda v, f, c, m: model.apply(v, f, c, m))(
        variables, jb["features"], jb["coords"], jb["valid"])
    out = {k: np.asarray(v) for k, v in out.items()}
    targets = [assign_center_targets(
        CFG, jb["gt_boxes"][i], jb["gt_labels"][i], jb["gt_mask"][i],
        jb["gt_velocity"][i]) for i in range(B)]
    targets = {k: np.stack([np.asarray(t[k]) for t in targets])
               for k in targets[0]}
    heads = {k: v for k, v in out.items() if k != "feat"}
    loss, _ = center_loss(jax.tree.map(jnp.asarray, heads),
                          jax.tree.map(jnp.asarray, targets))
    refine = CenterPointRefine(RCFG)
    rshapes = jax.eval_shape(refine.init, jax.random.PRNGKey(1),
                             jnp.zeros((CFG.top_k, RCFG.grid_points ** 2
                                        * FEAT_C)),
                             jnp.ones((CFG.top_k, 7)))
    rvars = _randomize(rshapes, np.random.default_rng(4))
    return dict(clouds=clouds, batch=batch, model=model, variables=variables,
                out=out, heads=heads, targets=targets, loss=float(loss),
                refine=refine, rvars=rvars)


def _port_model(bank, dtype="float32", return_feat=True):
    model = TC.CenterPoint(dataclasses.replace(TCFG, dtype=dtype),
                           return_feat=return_feat, device="cpu")
    model.load_state_dict(centerpoint_state_from_flax(bank["variables"]))
    return model


def _port_refine(bank):
    model = TC2.CenterPointRefine(TRCFG, FEAT_C, device="cpu")
    model.load_state_dict(centerpoint_refine_state_from_flax(bank["rvars"]))
    return model


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _inputs(bank):
    return [torch.from_numpy(bank["batch"][k])
            for k in ("features", "coords", "valid")]


def test_presets_match():
    for name in ("centerpoint_nuscenes", "centerpoint_nuscenes_10sweep",
                 "centerpoint_waymo"):
        want = dataclasses.asdict(getattr(presets, name)())
        assert dataclasses.asdict(getattr(t_presets, name)()) == want, name
    cfg = t_presets.centerpoint_nuscenes_10sweep(top_k=50)
    assert cfg.top_k == 50 and cfg.predict_velocity
    assert tuple(cfg.voxel_size[:2]) == pytest.approx((0.2, 0.2))


def test_constrain_raises(bank):
    """``constrain`` no longer raises: the hook is called once, on the
    NCHW canvas with kind "bev", and an identity hook leaves the head
    maps as they are (the spatial hook runs on ranks:
    tests/test_torch_parallel.py)."""
    seen, outs = [], []
    args = [torch.from_numpy(bank["batch"][k])
            for k in ("features", "coords", "valid")]
    for hook in (None, lambda x, kind: seen.append((kind, x.shape)) or x):
        model = TC.CenterPoint(TCFG, constrain=hook, device="cpu",
                               generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            outs.append(model(*args))
    assert all(torch.equal(outs[0][k], outs[1][k]) for k in outs[0])
    assert seen == [("bev", (args[0].shape[0], TCFG.pfn_features)
                     + tuple(TCFG.grid))]


def test_forward_matches(bank):
    """Batch of 2: every head and the BEV map (B, W, H, C) within 2e-5 of
    each output's largest magnitude in float32 (the backbone's sums in
    other orders); within 2^-5 in bfloat16, float32 out."""
    want = bank["out"]
    for dtype, tol in (("float32", 2e-5), ("bfloat16", 2 ** -5)):
        model = _port_model(bank, dtype)
        with torch.no_grad():
            got = model(*_inputs(bank))
        assert set(got) == set(want)
        for key, w in want.items():
            g = got[key]
            assert g.dtype == torch.float32 and g.shape == w.shape, key
            err = np.abs(g.numpy() - w).max() / np.abs(w).max()
            assert err <= tol, (dtype, key, err)
    assert want["heatmap"].shape == (B, 32, 32, 2)
    assert want["feat"].shape == (B, 32, 32, FEAT_C)
    with torch.no_grad():
        plain = _port_model(bank, return_feat=False)(*_inputs(bank))
    assert "feat" not in plain


def test_targets_match(bank):
    """Heatmap and vec within 1e-6 (exp, log, sin, cos to an ulp), mask
    exact; the shared cell takes the later box's vector, the outside and
    masked boxes none; the velocity columns are the boxes' velocities."""
    want = bank["targets"]
    b = _torch({k: bank["batch"][k] for k in ("gt_boxes", "gt_labels",
                                              "gt_mask", "gt_velocity")})
    for i in range(B):
        got = TC.assign_center_targets(TCFG, b["gt_boxes"][i],
                                       b["gt_labels"][i], b["gt_mask"][i],
                                       b["gt_velocity"][i])
        np.testing.assert_array_equal(got["mask"].numpy(), want["mask"][i])
        for key in ("heatmap", "vec"):
            np.testing.assert_allclose(got[key].numpy(), want[key][i],
                                       rtol=1e-6, atol=1e-6, err_msg=key)
    gt = bank["batch"]["gt_boxes"][0]
    vx, vy, _ = CFG.voxel_size
    ix = int((gt[0, 0] - CFG.bounds[0]) / vx)
    iy = int((gt[0, 1] - CFG.bounds[2]) / vy)
    assert ix == int((gt[1, 0] - CFG.bounds[0]) / vx)
    vec = want["vec"][0, ix, iy]
    np.testing.assert_allclose(np.exp(vec[3:6]), gt[1, 3:6], rtol=1e-5)
    np.testing.assert_allclose(vec[8:], bank["batch"]["gt_velocity"][0, 1],
                               rtol=1e-6)
    assert want["mask"][0].sum() == M - 1 and want["mask"][1].sum() == M - 2


def test_targets_without_velocity_warn(bank):
    """A velocity-head batch without gt_velocity warns (the JAX text) and
    renders zero velocity columns."""
    batch = _torch({k: bank["batch"][k] for k in ("gt_boxes", "gt_labels",
                                                  "gt_mask")})
    with pytest.warns(UserWarning, match="velocity targets default to ZERO"):
        t = TC.prepare_center_targets(TCFG, batch)["targets"]
    assert t["vec"].shape == (B, 32, 32, 10)
    assert float(t["vec"][..., 8:].abs().max()) == 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TC.prepare_center_targets(dataclasses.replace(
            TCFG, predict_velocity=False), batch)


def test_loss_matches(bank):
    """The loss of the same outputs and targets: rtol 1e-5 (float32 sums
    of 4096 focal terms in other orders: ~sqrt(n) ulps)."""
    total, aux = TC.center_loss(_torch(bank["heads"]),
                                _torch(bank["targets"]))
    np.testing.assert_allclose(float(total), bank["loss"], rtol=1e-5)
    assert float(aux["reg"]) > 0 and float(aux["hm"]) > 0


def _decode_both(heads):
    want = [np.asarray(a) for a in decode_centers(
        CFG, jax.tree.map(jnp.asarray, heads))]
    got = [t.numpy() for t in TC.decode_centers(TCFG, _torch(heads))]
    assert len(got) == len(want) == 4
    return got, want


def test_decode_matches(bank):
    """Decoding the JAX heads of frame 0: the top-k's labels exact, scores
    within 1e-6, boxes within 1e-5 (exp and atan2 to an ulp), velocities
    exact; the same selection as JAX's, so the indices are equal."""
    heads = {k: v[0] for k, v in bank["heads"].items()}
    got, want = _decode_both(heads)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[3], want[3])


def test_decode_ties_in_index_order(bank):
    """Ties: a heatmap cast through bfloat16 (as the preset computes it)
    on a few levels, and a flat one with three peaks (every other cell
    scores 0 and fills the top-k in (W, H, C) index order): labels and
    boxes exactly JAX's selection."""
    heads = {k: v[0] for k, v in bank["heads"].items()}
    rng = np.random.default_rng(9)
    levels = rng.integers(0, 3, heads["heatmap"].shape).astype(np.float32)
    # logits falling off with the Chebyshev distance to three peaks: every
    # other cell has a larger neighbour, so it scores 0
    w, h = CFG.grid
    gx, gy = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    peaks = {0: [(3, 5), (20, 30)], 1: [(10, 5)]}
    flat = np.stack([2.0 - 0.5 * np.min([np.maximum(abs(gx - x), abs(gy - y))
                                         for x, y in peaks[c]], axis=0)
                     for c in range(2)], -1).astype(np.float32)
    for hm in (np.asarray(jnp.asarray(levels - 1.0, jnp.bfloat16)
                          .astype(jnp.float32)), flat):
        got, want = _decode_both(dict(heads, heatmap=hm))
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert (want[1][3:] == 0).all()


@pytest.fixture(scope="module")
def jax_steps(bank):
    """The JAX package's own make_train_step, one step from the flax
    weights in float32 and float64: (loss, gradients in port names,
    batch statistics)."""
    out = {}
    for dtype in ("float32", "float64"):
        cfg = dataclasses.replace(CFG, dtype=dtype)
        fdt = np.float64 if dtype == "float64" else np.float32
        var = jax.tree.map(lambda x: np.asarray(x, fdt), bank["variables"])
        batch = dict(bank["batch"])
        batch["features"] = batch["features"].astype(fdt)
        tx = optax.chain(_capture_grads(), make_optimizer(3)[0])
        step = jax.jit(make_train_step(CenterPoint(cfg), tx, cfg))
        _, bs, opt_state, aux = step(
            var["params"], var["batch_stats"], tx.init(var["params"]),
            {k: jnp.asarray(v) for k, v in batch.items()})
        out[dtype] = dict(loss=float(aux["total"]),
                          grads=centerpoint_params_from_flax(opt_state[0]),
                          stats=jax.tree.map(np.asarray, bs))
    return out


def test_train_step_matches_f64(bank, jax_steps):
    """One float32 step of the port against the JAX package's float64
    step: loss rtol 1e-5; every gradient leaf within 1e-4 of its largest
    |g| and no farther than twice the JAX float32 step's distance plus
    2e-5; the first block's running statistics within 1e-5. remat gives
    the same loss and gradients bit for bit."""
    runs = []
    for remat in (False, True):
        model = _port_model(bank, return_feat=False)
        opt, _ = t_make_optimizer(model.parameters(), 3)
        aux = TC.make_train_step(model, opt, TCFG, remat=remat)(
            {k: torch.from_numpy(v) for k, v in bank["batch"].items()})
        runs.append((model, float(aux["total"]),
                     {n: p.grad for n, p in model.named_parameters()}))
    model, loss, grads = runs[0]
    assert runs[1][1] == loss and all(
        torch.equal(g, runs[1][2][n]) for n, g in grads.items())
    want64, want32 = jax_steps["float64"], jax_steps["float32"]
    np.testing.assert_allclose(loss, want64["loss"], rtol=1e-5)
    assert set(grads) == set(want64["grads"])
    for name, g in grads.items():
        ref = want64["grads"][name].numpy()
        err = _rel_max(g.numpy().astype(np.float64), ref)
        ref_err = _rel_max(want32["grads"][name].numpy(), ref)
        assert err <= 1e-4 and err <= 2 * ref_err + 2e-5, (name, err,
                                                           ref_err)
    st = jax_steps["float32"]["stats"]["_ConvBlock_0"]["BatchNorm_0"]
    np.testing.assert_allclose(model.blocks[0].bns[0].running_mean.numpy(),
                               st["mean"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.blocks[0].bns[0].running_var.numpy(),
                               st["var"], rtol=1e-5, atol=1e-5)


def test_external_targets_step_equals_in_step(bank):
    """prepare_center_targets outside the step gives the in-step loss and
    gradients bit for bit."""
    runs = []
    for external in (False, True):
        model = _port_model(bank, return_feat=False)
        opt, _ = t_make_optimizer(model.parameters(), 3)
        batch = {k: torch.from_numpy(v) for k, v in bank["batch"].items()}
        if external:
            batch = TC.prepare_center_targets(TCFG, batch)
        aux = TC.make_train_step(model, opt, TCFG,
                                 external_targets=external)(batch)
        runs.append((float(aux["total"]),
                     [p.grad.clone() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_roi_pooling_and_refine_targets_match(bank):
    """On the JAX decode's proposals of frame 0: pooled features within
    1e-5 of their largest magnitude (bilinear sums), the refinement MLP
    through its bridge within 1e-5, the targets' conf and deltas within
    1e-5 and pos exact."""
    heads = {k: v[0] for k, v in bank["heads"].items()}
    boxes = np.asarray(decode_centers(CFG, jax.tree.map(jnp.asarray,
                                                        heads))[0])
    feat = bank["out"]["feat"][0]
    want = np.asarray(roi_grid_features(jnp.asarray(feat), jnp.asarray(boxes),
                                        CFG.bounds, CFG.grid,
                                        RCFG.grid_points))
    got = TC2.roi_grid_features(*_torch(dict(f=feat, b=boxes)).values(),
                                TCFG.bounds, TCFG.grid,
                                TRCFG.grid_points).numpy()
    assert got.shape == (CFG.top_k, RCFG.grid_points ** 2 * FEAT_C)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    wout = bank["refine"].apply(bank["rvars"], jnp.asarray(want),
                                jnp.asarray(boxes))
    with torch.no_grad():
        tout = _port_refine(bank)(torch.from_numpy(want),
                                  torch.from_numpy(boxes))
    for key in ("conf", "deltas"):
        w = np.asarray(wout[key])
        assert np.abs(tout[key].numpy() - w).max() <= 1e-5 * np.abs(w).max()
    # proposals on the boxes: some overlap the ground truth well
    gt = bank["batch"]["gt_boxes"][0].copy()
    rois = np.concatenate([gt[:4] + [0.3, -0.2, 0.1, 0.2, 0.1, 0, 0.1],
                           boxes[4:]]).astype(np.float32)
    mask = bank["batch"]["gt_mask"][0]
    wt = encode_refinement_targets(RCFG, jnp.asarray(rois), jnp.asarray(gt),
                                   jnp.asarray(mask))
    tt = TC2.encode_refinement_targets(TRCFG, *_torch(dict(
        r=rois, g=gt, m=mask)).values())
    np.testing.assert_array_equal(tt["pos"].numpy(), np.asarray(wt["pos"]))
    assert 0 < int(tt["pos"].sum()) < CFG.top_k
    for key in ("conf", "deltas"):
        np.testing.assert_allclose(tt[key].numpy(), np.asarray(wt[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(
        TC2.apply_refinements(torch.from_numpy(rois), tt["deltas"])[:4].numpy(),
        gt[:4], rtol=1e-5, atol=1e-5)


def test_refine_train_step_matches(bank):
    """One step of make_refine_train_step over the frozen first stage,
    float32 on both sides: loss rtol 1e-5, every gradient leaf within
    1e-4 of its largest |g| (the same proposals: boxes within f32
    rounding, the same top-k)."""
    tx = optax.chain(_capture_grads(), optax.sgd(1e-3))
    step = make_refine_train_step(bank["model"], bank["variables"],
                                  bank["refine"], CFG, RCFG, tx)
    params = bank["rvars"]["params"]
    _, state, aux = step(params, tx.init(params),
                         {k: jnp.asarray(v) for k, v in bank["batch"].items()})
    want = centerpoint_refine_state_from_flax(state[0])
    refine = _port_refine(bank)
    opt = torch.optim.SGD(refine.parameters(), lr=1e-3)
    got = TC2.make_refine_train_step(
        _port_model(bank), None, refine, TCFG, TRCFG, opt)(
        {k: torch.from_numpy(v) for k, v in bank["batch"].items()})
    np.testing.assert_allclose(float(got["total"]), float(aux["total"]),
                               rtol=1e-5)
    for name, p in refine.named_parameters():
        ref = want[name].numpy()
        err = _rel_max(p.grad.numpy(), ref)
        assert err <= 1e-4, (name, err)


@pytest.fixture(scope="module")
def detectors(bank):
    """The JAX package's and the port's one- and two-stage velocity
    detectors on the same weights."""
    out = {}
    for name, refine in (("one", None), ("two", True)):
        jref = (bank["refine"], bank["rvars"], RCFG) if refine else None
        tref = (_port_refine(bank), None, TRCFG) if refine else None
        jdet = make_centerpoint_detector(bank["model"], bank["variables"],
                                         CFG, CFG, CLASSES,
                                         score_threshold=0.0, refine=jref)
        tdet = t_detector(_port_model(bank), None, TCFG, TCFG, T_CLASSES,
                          score_threshold=0.0, refine=tref, device="cpu")
        out[name] = (jdet, tdet)
    return out


def _same_outputs(got, want):
    assert len(got) == len(want) == 5
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[4], want[4], rtol=0, atol=1e-4)


@pytest.mark.parametrize("stages", ["one", "two"])
def test_detector_matches(bank, detectors, stages):
    """The 5-output device_fn, one- and two-stage (the fused score
    s^(1-a) sigmoid(conf)^a): keep mask and labels exact, boxes within
    1e-4, scores within 1e-5, velocities within 1e-4; detect's
    TrackingTarget3Ds equal in count, tags and velocities."""
    jdet, tdet = detectors[stages]
    pts = bank["clouds"][0]
    want = [np.asarray(a) for a in jdet.device_fn(jnp.asarray(pts))]
    got = [t.numpy() for t in tdet.device_fn(pts)]
    _same_outputs(got, want)
    a = jdet(pts, frame="velo", timestamp=5)
    b = tdet(pts, frame="velo", timestamp=5)
    assert len(a) == len(b) == int(want[3].sum()) > 1
    for x, y in zip(a, b):
        assert type(y).__name__ == "TrackingTarget3D"
        assert y.tag.labels == x.tag.labels
        np.testing.assert_allclose(y.velocity, x.velocity, atol=1e-4)
        np.testing.assert_allclose(y.position, x.position, atol=1e-4)


def test_detector_refine_needs_feat(bank):
    with pytest.raises(ValueError, match="return_feat"):
        t_detector(_port_model(bank, return_feat=False), None, TCFG, TCFG,
                   T_CLASSES, refine=(_port_refine(bank), None, TRCFG),
                   device="cpu")


def test_tta_matches(bank, detectors):
    """The flip ensemble over the one-stage velocity detector: 5 outputs
    of 2 top-k, as test_detector_matches holds them."""
    jdet, tdet = detectors["one"]
    pts = bank["clouds"][1]
    want = [np.asarray(a) for a in make_tta_detector(
        jdet, CLASSES, score_threshold=0.0).device_fn(jnp.asarray(pts))]
    got = [t.numpy() for t in t_tta(tdet, T_CLASSES,
                                    score_threshold=0.0).device_fn(pts)]
    assert got[0].shape == (2 * CFG.top_k, 7)
    _same_outputs(got, want)


def test_tracking_step_matches(bank, detectors):
    """make_tracking_step on the two-stage detector over three frames
    0.5 s apart: the slot tables' ids, labels and masks exact, slot boxes
    within 1e-4 (the detections' own tolerance)."""
    jdet, tdet = detectors["two"]
    rng = np.random.default_rng(11)
    clouds = [_cloud(rng) for _ in range(3)]
    jstep = JD.make_tracking_step(jdet.device_fn, [3.0, 1.0], capacity=16,
                                  score_threshold=0.0)
    tstep = TD.make_tracking_step(tdet.device_fn, [3.0, 1.0], capacity=16,
                                  score_threshold=0.0)
    sj, st = jstep.init(), tstep.init()
    for i, pts in enumerate(clouds):
        dt = 0.0 if i == 0 else 0.5
        sj, _ = jstep(sj, jnp.asarray(pts), jnp.float32(dt))
        st, out = tstep(st, pts, dt)
        want = jax.tree.map(np.asarray, sj)
        for k in SLOT_EXACT:
            np.testing.assert_array_equal(st[k].numpy(), want[k], err_msg=k)
        for k in SLOT_FLOAT:
            np.testing.assert_allclose(st[k].numpy(), want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    assert int(want["active"].sum()) > 0 and want["next_tid"] > 1

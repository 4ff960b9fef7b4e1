"""The port's BEVSeg (``models/bevseg.py``), semantic and panoptic, against
the JAX package on a small configuration (a 64 x 64 grid, one block a
stage, 8-16 channels, ~2 000 points a frame, six instances where the
panoptic targets keep four): the same flax weights (randomized,
BatchNorm statistics and asymmetric transposed kernels included) carried
across by ``bevseg_state_from_flax``, then ``point_cell_coords``, the
forward of both heads in float32 and bfloat16, ``segmentation_loss``
(ignored points, labels outside the classes, label smoothing),
``panoptic_targets``, ``panoptic_loss``, ``group_instances`` (ties, no
peak above 0.1, no thing classes), both predictors and one panoptic
training step, whose gradients flow back through ``aligned_scatter``'s
gather.

One module-scoped bank holds the inputs and the JAX package's results, so
each JAX program compiles once. Tolerances are stated per test."""

import dataclasses

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import optax
import torch

from d3d_tpu.models import presets
from d3d_tpu.models.bevseg import (BEVSeg, BEVSegConfig, bevseg_pillarize,
                                   group_instances, make_panoptic_predictor,
                                   make_predictor, make_train_step,
                                   panoptic_loss, panoptic_targets,
                                   point_cell_coords, segmentation_loss)

from d3d_tpu_torch.models import bevseg as TB
from d3d_tpu_torch.models import presets as t_presets
from d3d_tpu_torch.models.convert import (bevseg_params_from_flax,
                                          bevseg_state_from_flax)

from tests.test_torch_second import _randomize
from tests.test_torch_voxelnext import _capture_grads, _rel_max

PANO = BEVSegConfig(
    bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(64, 64),
    max_pillars=768, max_points_per_pillar=8, pfn_features=8,
    enc_channels=(8, 16, 16), enc_blocks=(1, 1, 1), dec_channels=16,
    num_classes=4, ignore_index=0, panoptic=True, thing_classes=(1, 2),
    max_instances=4, center_sigma=1.0, center_radius=2.0)
SEM = dataclasses.replace(PANO, panoptic=False)
T_PANO = TB.BEVSegConfig(**dataclasses.asdict(PANO))
T_SEM = TB.BEVSegConfig(**dataclasses.asdict(SEM))
B, N = 2, 2048
# six instances (class, id, centre): ids out of order, more than
# PANO.max_instances
INSTANCES = ((1, 7, (3.0, -5.0)), (1, 3, (4.0, 4.0)), (2, 12, (12.0, 0.0)),
             (2, 5, (9.0, -5.0)), (1, 9, (7.0, 1.0)), (2, 1, (13.0, 5.5)))


def _frame(rng):
    """N points: six compact instances of 200 points, the rest stuff
    (class 3), a few unlabelled (0) and a few labelled 7 (outside the
    classes)."""
    pts = np.zeros((N, 4), np.float32)
    labels = np.full(N, 3, np.int32)
    ids = np.zeros(N, np.int32)
    per = 200
    for i, (cls, iid, c) in enumerate(INSTANCES):
        s = slice(i * per, (i + 1) * per)
        pts[s, :2] = np.asarray(c) + rng.normal(0, 0.4, (per, 2))
        labels[s], ids[s] = cls, iid
    s = slice(len(INSTANCES) * per, N)
    pts[s, 0] = rng.random(N - len(INSTANCES) * per) * 16
    pts[s, 1] = rng.random(N - len(INSTANCES) * per) * 16 - 8
    pts[:, 2] = rng.random(N) * 4 - 3
    pts[:, 3] = rng.random(N)
    labels[rng.random(N) < 0.04] = 0
    labels[N - 5:] = 7
    return pts, labels, ids


def _pillars(clouds, cfg=T_PANO):
    pil = [TB.bevseg_pillarize(torch.from_numpy(p), cfg) for p in clouds]
    return [torch.stack([p[i] for p in pil]).numpy() for i in range(3)]


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(20261017)
    frames = [_frame(rng) for _ in range(B)]
    pts = np.stack([f[0] for f in frames])
    feats, coords, valid = _pillars(pts)
    pc = np.array(jax.vmap(lambda p: point_cell_coords(p, PANO))(
        jnp.asarray(pts)))
    batch = dict(features=feats, coords=coords, valid=valid,
                 point_coords=pc, points=pts,
                 labels=np.stack([f[1] for f in frames]),
                 inst_ids=np.stack([f[2] for f in frames]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = (jb["features"], jb["coords"], jb["valid"], jb["point_coords"])
    out = {}
    for name, cfg in (("pano", PANO), ("sem", SEM)):
        model = BEVSeg(cfg)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
        variables = _randomize(shapes, np.random.default_rng(7))
        o = jax.jit(lambda v, *a: model.apply(v, *a))(variables, *args)
        out[name] = dict(model=model, variables=variables,
                         out=jax.tree.map(np.array, o))
    targets = [panoptic_targets(PANO, jb["points"][i], jb["labels"][i],
                                jb["inst_ids"][i]) for i in range(B)]
    targets = {k: np.stack([np.asarray(t[k]) for t in targets])
               for k in targets[0]}
    steps = {}
    for dtype in ("float32", "float64"):
        cfg = dataclasses.replace(PANO, dtype=dtype)
        var = jax.tree.map(lambda x: np.asarray(x, dtype),
                           out["pano"]["variables"])
        tx = optax.chain(_capture_grads(), optax.sgd(0.1))
        step = jax.jit(make_train_step(BEVSeg(cfg), tx, cfg))
        fb = {k: (jnp.asarray(v, dtype) if v.dtype.kind == "f" else v)
              for k, v in jb.items()}
        _, stats, opt_state, aux = step(var["params"], var["batch_stats"],
                                        tx.init(var["params"]), fb)
        steps[dtype] = dict(loss=float(aux["total"]),
                            grads=bevseg_params_from_flax(opt_state[0]),
                            stats=jax.tree.map(np.asarray, stats))
    return dict(batch=batch, targets=targets, steps=steps, **out)


def _port(bank, name="pano", dtype="float32"):
    cfg = T_PANO if name == "pano" else T_SEM
    model = TB.BEVSeg(dataclasses.replace(cfg, dtype=dtype), device="cpu")
    model.load_state_dict(bevseg_state_from_flax(bank[name]["variables"]))
    return model


def _inputs(bank):
    return [torch.from_numpy(bank["batch"][k]) for k in
            ("features", "coords", "valid", "point_coords")]


def test_preset_and_constrain(bank):
    """bevseg_semantickitti equals the JAX preset; a ``constrain`` hook is
    called once, on the NCHW canvas with kind "bev", and an identity hook
    leaves the outputs as they are (the spatial hook runs on ranks:
    tests/test_torch_parallel.py)."""
    assert dataclasses.asdict(t_presets.bevseg_semantickitti()) == \
        dataclasses.asdict(presets.bevseg_semantickitti())
    seen = []
    outs = []
    for hook in (None, lambda x, kind: seen.append((kind, x.shape)) or x):
        model = TB.BEVSeg(T_SEM, constrain=hook, device="cpu",
                          generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            outs.append(model(*_inputs(bank)))
    assert torch.equal(outs[0], outs[1])
    b = bank["batch"]["features"].shape[0]
    assert seen == [("bev", (b, T_SEM.pfn_features) + tuple(T_SEM.grid))]


def test_pillars_and_cell_coords_match(bank):
    """bevseg_pillarize of frame 0 equals the JAX package's (features
    within 1e-6, cells and mask exact); point_cell_coords within 1e-6."""
    pts = bank["batch"]["points"][0]
    want = [np.asarray(a) for a in bevseg_pillarize(jnp.asarray(pts), PANO)]
    got = [a.numpy() for a in TB.bevseg_pillarize(torch.from_numpy(pts),
                                                   T_PANO)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(
        TB.point_cell_coords(torch.from_numpy(bank["batch"]["points"]),
                             T_PANO).numpy(),
        bank["batch"]["point_coords"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["sem", "pano"])
def test_forward_matches(bank, name):
    """Per-point logits (and the panoptic heads: the (B, W, H) centre
    heatmap, per-point offsets) within 2e-5 of each output's largest
    magnitude in float32, within 2^-5 in bfloat16; float32 out. The
    bridge is held on an ``_Up`` kernel its spatial flip changes."""
    k = np.asarray(bank[name]["variables"]["params"]["_Up_0"]
                   ["ConvTranspose_0"]["kernel"])
    assert np.abs(k - k[::-1, ::-1]).max() > 0.1
    want = bank[name]["out"]
    want = want if isinstance(want, dict) else {"sem": want}
    for dtype, tol in (("float32", 2e-5), ("bfloat16", 2 ** -5)):
        with torch.no_grad():
            got = _port(bank, name, dtype)(*_inputs(bank))
        got = got if isinstance(got, dict) else {"sem": got}
        assert set(got) == set(want)
        for key, w in want.items():
            assert got[key].dtype == torch.float32
            assert got[key].shape == w.shape
            err = np.abs(got[key].numpy() - w).max() / np.abs(w).max()
            assert err <= tol, (name, dtype, key, err)


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_segmentation_loss_matches(bank, smooth):
    """Cross-entropy with ignored (0) points and labels outside the
    classes (7: an all-zero one-hot row, counted in the mean as in JAX),
    with and without label smoothing: loss within 1e-6 relative,
    accuracy within 1e-7; all-ignored labels give 0."""
    logits = bank["sem"]["out"]
    labels = bank["batch"]["labels"]
    want = segmentation_loss(jnp.asarray(logits), jnp.asarray(labels), SEM,
                             smooth)[1]
    got = TB.segmentation_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels), T_SEM, smooth)[1]
    np.testing.assert_allclose(float(got["seg"]), float(want["seg"]),
                               rtol=1e-6)
    assert float(got["acc"]) == pytest.approx(float(want["acc"]), abs=1e-7)
    zero = TB.segmentation_loss(torch.from_numpy(logits),
                                torch.zeros(B, N, dtype=torch.int32),
                                T_SEM, smooth)[0]
    assert float(zero) == 0.0


def test_panoptic_targets_match(bank):
    """Per frame: the offset mask exact, offsets and heatmap within 1e-5
    (centres are segment sums in sorted order; JAX's sort is not stable,
    so a centre may move by an ulp). Of the six instances only the four
    of lowest id get targets (ascending id order, not first encounter)."""
    t = bank["targets"]
    b = bank["batch"]
    for i in range(B):
        got = TB.panoptic_targets(T_PANO, *(torch.from_numpy(b[k][i]) for k
                                            in ("points", "labels",
                                                "inst_ids")))
        np.testing.assert_array_equal(got["offset_mask"].numpy(),
                                      t["offset_mask"][i])
        np.testing.assert_allclose(got["offset"].numpy(), t["offset"][i],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["heatmap"].numpy(), t["heatmap"][i],
                                   rtol=0, atol=1e-5)
    kept = set(np.unique(b["inst_ids"][0][t["offset_mask"][0]]).tolist())
    assert kept == {1, 3, 5, 7}


def test_panoptic_loss_matches(bank):
    """Each term of the panoptic loss on the JAX package's outputs and
    targets within 1e-6 relative."""
    out, t = bank["pano"]["out"], bank["targets"]
    labels = bank["batch"]["labels"]
    want = panoptic_loss(jax.tree.map(jnp.asarray, out),
                         jax.tree.map(jnp.asarray, t), PANO,
                         jnp.asarray(labels), 0.1)[1]
    got = TB.panoptic_loss({k: torch.from_numpy(v) for k, v in out.items()},
                           {k: torch.from_numpy(v) for k, v in t.items()},
                           T_PANO, torch.from_numpy(labels), 0.1)[1]
    for k in ("seg", "acc", "hm", "offset", "total"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)


def _logit(p):
    p = np.clip(p, 1e-6, 1 - 1e-6)
    return (np.log(p) - np.log1p(-p)).astype(np.float32)


@pytest.mark.parametrize("case", ["targets", "network", "no_peak",
                                  "no_things"])
def test_group_instances_matches(bank, case):
    """Instance ids equal the JAX package's exactly, uint16: on the
    targets used as predictions (each kept instance one id, the top-k
    filled by tied zeros in index order), on the network's random heads,
    with no heatmap peak above 0.1 (every id 0) and with no thing classes
    (every id 0)."""
    b, t = bank["batch"], bank["targets"]
    cfg, t_cfg = PANO, T_PANO
    labels, pts = b["labels"][0], b["points"][0]
    if case == "network":
        out = bank["pano"]["out"]
        hm, off = out["heatmap"][0], out["offset"][0]
    else:
        hm, off = _logit(t["heatmap"][0]), t["offset"][0]
    if case == "no_peak":
        hm = np.full_like(hm, -5.0)
    if case == "no_things":
        cfg = dataclasses.replace(PANO, thing_classes=())
        t_cfg = dataclasses.replace(T_PANO, thing_classes=())
    want = np.asarray(group_instances(cfg, *map(jnp.asarray,
                                                (labels, pts, off, hm)),
                                      top_k=8))
    got = TB.group_instances(t_cfg, *map(torch.from_numpy,
                                         (labels, pts, off, hm)), top_k=8)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "targets":
        for iid in (1, 3, 5, 7):
            ids = want[(b["inst_ids"][0] == iid) & (labels > 0)]
            assert (ids > 0).all() and len(set(ids.tolist())) == 1
    if case in ("no_peak", "no_things"):
        assert (want == 0).all()


def test_predictors_match(bank):
    """make_predictor and make_panoptic_predictor on frame 1 through the
    port's pillars: labels and instance ids equal the JAX predictors'."""
    pts = bank["batch"]["points"][1]
    for name, cfg, t_cfg in (("sem", SEM, T_SEM), ("pano", PANO, T_PANO)):
        jmodel, var = bank[name]["model"], bank[name]["variables"]
        sd = bevseg_state_from_flax(var)
        if name == "sem":
            want = [make_predictor(jmodel, cfg)(var, jnp.asarray(pts))]
            got = [TB.make_predictor(TB.BEVSeg(t_cfg, device="cpu"), t_cfg,
                                     device="cpu")(sd, pts)]
        else:
            want = make_panoptic_predictor(jmodel, cfg, top_k=8)(
                var, jnp.asarray(pts))
            got = TB.make_panoptic_predictor(
                TB.BEVSeg(t_cfg, device="cpu"), t_cfg, top_k=8,
                device="cpu")(sd, pts)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[0].dtype == torch.int32


def test_train_step_matches(bank):
    """One float32 panoptic step of the port against the JAX package's own
    make_train_step: loss within 1e-5 of its float64 step's; every
    gradient leaf within 1e-4 of the float64 step's largest |g| and no
    farther than twice the JAX float32 step's distance plus 2e-5 (the
    per-point gather's backward scatters into the BEV map; the PFN's
    BatchNorm over the pillars amplifies float32 rounding), the first
    block's running statistics within 1e-5 of the float32 step's."""
    model = _port(bank)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    aux = TB.make_train_step(model, opt, T_PANO)(
        {k: torch.from_numpy(v) for k, v in bank["batch"].items()})
    want64, want32 = bank["steps"]["float64"], bank["steps"]["float32"]
    np.testing.assert_allclose(float(aux["total"]), want64["loss"],
                               rtol=1e-5)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want64["grads"])
    for name, g in grads.items():
        ref = want64["grads"][name].numpy()
        err = _rel_max(g.numpy().astype(np.float64), ref)
        ref_err = _rel_max(want32["grads"][name].numpy(), ref)
        assert err <= 1e-4 and err <= 2 * ref_err + 2e-5, (name, err,
                                                           ref_err)
    st = want32["stats"]["_ConvBlock_0"]["BatchNorm_0"]
    np.testing.assert_allclose(model.blocks[0].bns[0].running_mean.numpy(),
                               st["mean"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(model.blocks[0].bns[0].running_var.numpy(),
                               st["var"], rtol=1e-5, atol=1e-5)

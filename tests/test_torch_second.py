"""The port's SECOND inference and training paths against the JAX package:
the same flax weights (randomized, BatchNorm statistics included) carried
across by ``second_state_from_flax``, the same points, the same outputs,
gradients, BatchNorm statistics and optimizer steps.

The configurations are ``tests/test_second.py``'s TINY and odd-grid ones,
with stage caps lowered so that every cap binds (the voxel cap, then the
site caps after each strided layer keep only the first keys), as
``presets.second_kitti``'s caps do on a 120k-point frame."""

import dataclasses

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import optax
import torch

from d3d_tpu.models import make_anchors, presets
from d3d_tpu.models.inference import make_second_detector
from d3d_tpu.models.second import SECOND, SECONDConfig, _MaskedBN, head_config
from d3d_tpu.models.second import make_train_step, second_voxelize
from d3d_tpu.train import make_optimizer

from d3d_tpu_torch.dataset.kitti import KittiObjectClass as TClass
from d3d_tpu_torch.models import SECOND as TSECOND
from d3d_tpu_torch.models import SECONDConfig as TConfig
from d3d_tpu_torch.models import head_config as t_head_config
from d3d_tpu_torch.models import make_anchors as t_make_anchors
from d3d_tpu_torch.models import make_second_detector as t_make_detector
from d3d_tpu_torch.models import presets as t_presets
from d3d_tpu_torch.models.second import make_train_step as t_make_train_step
from d3d_tpu_torch.models import second_params_from_flax
from d3d_tpu_torch.models import second_state_from_flax
from d3d_tpu_torch.models import second_voxelize as t_second_voxelize
from d3d_tpu_torch.models.second import _MaskedBN as TMaskedBN
from d3d_tpu_torch.ops import sparse_conv as TS
from d3d_tpu_torch.train import make_optimizer as t_make_optimizer

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
                           [TClass.Car], score_threshold=0.0, top_k=24,
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
    assert len(out) == int(got[3].sum())
    assert [o.tag_top for o in out] == [TClass.Car] * len(out)


def test_presets_match():
    want = dataclasses.asdict(presets.second_kitti())
    got = dataclasses.asdict(t_presets.second_kitti())
    assert got == want
    assert t_presets.second_kitti(dtype="float32").dtype == "float32"
    assert t_head_config(t_presets.second_kitti()).grid == (88, 100)


def test_dense_middle_is_not_ported():
    """The dense middle (ported since; held to JAX in
    tests/test_torch_second_dense.py) keeps the sparse path's parameter
    tree, so one state_dict serves both, and its cell budget still
    raises."""
    dense = TSECOND(TConfig(**CONFIGS["tiny"], middle="dense"), device="cpu")
    sparse = TSECOND(TConfig(**CONFIGS["tiny"]), device="cpu")
    assert ({k: v.shape for k, v in dense.state_dict().items()}
            == {k: v.shape for k, v in sparse.state_dict().items()})
    with pytest.raises(ValueError, match="dense_max_cells"):
        TSECOND(TConfig(**CONFIGS["tiny"], middle="dense",
                        dense_max_cells=100), device="cpu")


def test_masked_bn_batch_statistics():
    """Training-mode _MaskedBN over a batch of two frames: the JAX module
    reduces over every valid site of (B, V); the port's one joined list of
    B*V rows must give the same statistics (per-frame ones would not),
    outputs and running statistics (0.99 / 0.01, biased variance).
    rtol/atol 1e-6 (f32 sums in other orders)."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 40, 6)).astype(np.float32)
    x[1] = x[1] * 3 + 2  # frames with other statistics
    valid = rng.random((2, 40)) < 0.7
    bn = _MaskedBN()
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(valid), False)
    variables = {"params": {"scale": jnp.linspace(0.5, 1.5, 6),
                            "bias": jnp.linspace(-0.2, 0.3, 6)},
                 "batch_stats": {"mean": jnp.full(6, 0.1),
                                 "var": jnp.full(6, 1.5)}}
    want, upd = bn.apply(variables, jnp.asarray(x), jnp.asarray(valid), True,
                         mutable=["batch_stats"])
    tbn = TMaskedBN(6)
    tbn.load_state_dict({"weight": torch.linspace(0.5, 1.5, 6),
                         "bias": torch.linspace(-0.2, 0.3, 6),
                         "running_mean": torch.full((6,), 0.1),
                         "running_var": torch.full((6,), 1.5)})
    got = tbn(torch.from_numpy(x.reshape(80, 6)),
              torch.from_numpy(valid.reshape(80)), train=True)
    np.testing.assert_allclose(got.detach().numpy().reshape(2, 40, 6),
                               np.asarray(want), rtol=1e-6, atol=1e-6)
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(tbn, name).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-6)
    # a per-frame reduction would move the statistics far from these
    frame0 = x[0][valid[0]].mean(0)
    assert np.abs(frame0 - np.asarray(
        (upd["batch_stats"]["mean"] - 0.099) / 0.01)).max() > 0.3


STEPS = 5
RIOU = 0.1


def _train_batch(name, b=2):
    """B frames of the config's points and 4 car-like gts a frame (the last
    of frame 0 padded), voxelized by the JAX package: numpy arrays."""
    cfg = SECONDConfig(**CONFIGS[name])
    rng = np.random.default_rng(11)
    bd = cfg.bounds
    frames = [second_voxelize(jnp.asarray(_points(name, 20 + i)), cfg)
              for i in range(b)]
    gt = np.stack([
        rng.uniform(bd[0] + 2, bd[1] - 2, (b, 4)),
        rng.uniform(bd[2] + 2, bd[3] - 2, (b, 4)), np.full((b, 4), -1.0),
        rng.uniform(3.5, 4.2, (b, 4)), rng.uniform(1.5, 1.8, (b, 4)),
        np.full((b, 4), 1.56), rng.uniform(-np.pi, np.pi, (b, 4))],
        -1).astype(np.float32)
    mask = np.ones((b, 4), bool)
    mask[0, -1] = False
    return dict(features=np.stack([np.array(f[0]) for f in frames]),
                coords=np.stack([np.array(f[1]) for f in frames]),
                valid=np.stack([np.array(f[2]) for f in frames]),
                gt_boxes=gt, gt_labels=np.zeros((b, 4), np.int32),
                gt_mask=mask)


def _capture_grads():
    """An optax transformation whose state keeps the gradient it was given,
    so the JAX package's own make_train_step hands its gradients out."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def trained(pair):
    """STEPS train steps of the JAX package (make_train_step, make_optimizer)
    and of the port from the same flax weights on the same batch of two
    frames: per step the loss, the gradient, the parameters and the
    BatchNorm statistics, as the port's names and layouts."""
    name, model, variables, _, _ = pair
    batch = _train_batch(name)
    cfg = model.cfg
    tx = optax.chain(_capture_grads(), make_optimizer(STEPS)[0])
    step = jax.jit(make_train_step(model, tx, cfg,
                                   make_anchors(head_config(cfg)),
                                   riou_weight=RIOU))
    params, bs = variables["params"], variables["batch_stats"]
    opt_state = tx.init(params)
    jax_steps = []
    for _ in range(STEPS):
        params, bs, opt_state, aux = step(params, bs, opt_state,
                                          {k: jnp.asarray(v)
                                           for k, v in batch.items()})
        jax_steps.append(dict(
            loss=float(aux["total"]),
            grads=second_params_from_flax(opt_state[0]),
            state=second_state_from_flax({"params": params,
                                          "batch_stats": bs})))

    tcfg = TConfig(**CONFIGS[name])
    tmodel = TSECOND(tcfg, device="cpu")
    tmodel.load_state_dict(second_state_from_flax(variables))
    opt, _ = t_make_optimizer(tmodel.parameters(), STEPS)
    tstep = t_make_train_step(tmodel, opt, tcfg,
                              t_make_anchors(t_head_config(tcfg),
                                             device="cpu"),
                              riou_weight=RIOU)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    port_steps = []
    for _ in range(STEPS):
        aux = tstep(tbatch)
        port_steps.append(dict(
            loss=float(aux["total"]),
            grads={n: p.grad.clone() for n, p in tmodel.named_parameters()},
            state={k: v.clone() for k, v in tmodel.state_dict().items()}))
    return jax_steps, port_steps


def test_train_step_matches(trained):
    """One step from the same weights and batch (B = 2). The loss: rtol 1e-5.
    Every gradient leaf: within 2e-5 of the leaf's largest |g| (f32 sums in
    other orders through 4 sparse layers, 2 dense ones and batch-statistic
    BatchNorm; 4e-6 seen). The BatchNorm running statistics: rtol/atol
    1e-5. The parameters after Adam's first step, whose update is
    ~lr * sign(g): to 1e-6 where |g| exceeds 1e-3 of the leaf's max, and
    everywhere within 2 lr + 1e-6 (lr is 1e-4 at count 0 of the one-cycle
    schedule), since a gradient entry near 0 may round to the other
    sign."""
    jax_steps, port_steps = trained
    want, got = jax_steps[0], port_steps[0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert set(got["grads"]) == set(want["grads"])
    for name, g in got["grads"].items():
        w = want["grads"][name].numpy()
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5 * scale,
                                   err_msg=name)
    for name, v in got["state"].items():
        w = want["state"][name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        elif name in want["grads"]:
            g = want["grads"][name].numpy()
            big = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(v.numpy()[big], w[big], rtol=0,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                       atol=2e-4 + 1e-6, err_msg=name)


def test_five_steps_track_and_fall(trained):
    """Five steps: the port's losses track the JAX package's (rtol 1e-5;
    9e-7 seen: the gradients' rounding differences feed back through
    Adam's steps) and both fall, as tests/test_second.py asserts of the
    JAX step."""
    jax_steps, port_steps = trained
    want = [s["loss"] for s in jax_steps]
    got = [s["loss"] for s in port_steps]
    assert all(np.isfinite(got)), got
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0] and want[-1] < want[0], (got, want)

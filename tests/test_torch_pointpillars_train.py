"""The port's PointPillars training network against the JAX package: the
same flax weights (randomized, BatchNorm statistics included) carried
across by ``pointpillars_state_from_flax``, the same pillarized batch, and
one step of the JAX package's own ``make_train_step`` (its gradients
handed out through an optax transformation that keeps them in its state,
as ``tests/test_torch_second.py`` does) against the port's.

The configuration is ``tests/test_torch_pointpillars.py``'s tiny one (two
backbone levels, the transposed convolution).

**Reference for the float32 gradients.** The JAX package's float32 step
on the CPU is itself off its float64 run of the same function by up to
4.3e-5 of a leaf's largest entry at batch 2 and 2.0e-3 at batch 3 (the
full-resolution layers; its jitted and eager runs agree with each other),
while the port's float32 step is within 6e-6 of that float64 run at both
batches. So the float32 gradients are held to the JAX package's float64
step, and to its float32 step only in that the port's worst leaf must be
at least as close to the float64 one.

**The bfloat16 bound.** Each bfloat16 layer rounds its inputs and weights
to 8 significant bits (a relative error of at most u = 2^-8 for the
pair) and accumulates in float32 (K u32 over a K-term sum, u32 = 2^-24);
BatchNorm rescales but keeps relative errors. Over the D such layers of
the network's longest path, to first order, the outputs and the loss then
lie within ``bf16_bound(D, K) = D (2^-8 + K 2^-24)`` of the float32 ones,
relative to their largest magnitude: tiny config D = 5 (PFN, two blocks of
one conv, the stride-2 level's upsampling, the head), K = 9 x 64; full
width D = 16 (PFN, 3 + 5 + 5 convs, upsampling, head), K = 9 x 256
(``chip_smoke.py`` checks it there, on the card). The gradients pass
back through those layers and BatchNorm's backward, whose mean
subtraction cancels: their relative L2 error against the float64 step is
held to ``D 2^-5`` (seen: 0.13 at the PFN weight, 0.10 for the JAX
package's own bf16 step; 0.67 for its head bias, which flax adds in
bfloat16).
"""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import optax
import torch

from d3d_tpu.models import PointPillars, PointPillarsConfig, make_anchors
from d3d_tpu.models.pointpillars import make_train_step, pillarize
from d3d_tpu.models.pointpillars import scatter_to_bev
from d3d_tpu.train import make_optimizer

from d3d_tpu_torch.models import PointPillars as TPointPillars
from d3d_tpu_torch.models import PointPillarsConfig as TConfig
from d3d_tpu_torch.models import make_anchors as t_make_anchors
from d3d_tpu_torch.models import pointpillars_params_from_flax
from d3d_tpu_torch.models import pointpillars_state_from_flax
from d3d_tpu_torch.models.pointpillars import (
    make_train_step as t_make_train_step)
from d3d_tpu_torch.models.pointpillars import scatter_to_bev as t_scatter
from d3d_tpu_torch.train import make_optimizer as t_make_optimizer
from d3d_tpu_torch.train import repeat_batch_step

from tests.test_torch_pointpillars import CFG, _points

STEPS = 3
DEPTH_TINY = 5
WIDTH_TINY = 9 * 64


def bf16_bound(depth, width):
    """The bfloat16 network's error relative to the largest float32
    output (module docstring)."""
    return depth * (2.0 ** -8 + width * 2.0 ** -24)


def _randomize(shapes, rng):
    def leaf(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(x.dtype)
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
        std = 1.0 / np.sqrt(np.prod(x.shape[:-1])) if x.ndim > 1 else 0.1
        return (rng.standard_normal(x.shape) * std).astype(x.dtype)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(b):
    """B frames pillarized by the JAX package and 4 car-like gts a frame
    (the last of frame 0 padded): numpy arrays."""
    cfg = PointPillarsConfig(**CFG)
    frames = [pillarize(jnp.asarray(_points(20 + i)), cfg) for i in range(b)]
    rng = np.random.default_rng(11)
    gt = np.stack([
        rng.uniform(2, 14, (b, 4)), rng.uniform(-6, 6, (b, 4)),
        np.full((b, 4), -1.0), rng.uniform(3.5, 4.2, (b, 4)),
        rng.uniform(1.5, 1.8, (b, 4)), np.full((b, 4), 1.56),
        rng.uniform(-np.pi, np.pi, (b, 4))], -1).astype(np.float32)
    mask = np.ones((b, 4), bool)
    mask[0, -1] = False
    return dict(features=np.stack([np.array(f[0]) for f in frames]),
                coords=np.stack([np.array(f[1]) for f in frames]),
                valid=np.stack([np.array(f[2]) for f in frames]),
                gt_boxes=gt, gt_labels=np.zeros((b, 4), np.int32),
                gt_mask=mask)


def _capture_grads():
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def variables():
    cfg = PointPillarsConfig(**CFG)
    b = _batch(1)
    shapes = jax.eval_shape(PointPillars(cfg).init, jax.random.PRNGKey(0),
                            b["features"], b["coords"], b["valid"])
    return _randomize(shapes, np.random.default_rng(1))


@pytest.fixture(scope="module")
def jax_run(variables):
    """``run(dtype, b, steps)``: the JAX package's steps from the flax
    weights on a batch of b frames, cached: per step the loss, the
    gradients, the parameters and statistics after it (port names and
    layouts)."""
    cache = {}

    def run(dtype, b, steps=1):
        key = (dtype, b)
        if key in cache and len(cache[key]) >= steps:
            return cache[key][:steps]
        cfg = PointPillarsConfig(**CFG, dtype=dtype)
        model = PointPillars(cfg)
        fdt = np.float64 if dtype == "float64" else np.float32
        var = jax.tree.map(lambda x: np.asarray(x, fdt), variables)
        batch = _batch(b)
        batch["features"] = batch["features"].astype(fdt)
        tx = optax.chain(_capture_grads(), make_optimizer(STEPS)[0])
        step = jax.jit(make_train_step(model, tx, cfg, make_anchors(cfg)))
        params, bs = var["params"], var["batch_stats"]
        opt_state = tx.init(params)
        out = []
        for _ in range(steps):
            params, bs, opt_state, aux = step(
                params, bs, opt_state,
                {k: jnp.asarray(v) for k, v in batch.items()})
            out.append(dict(
                loss=float(aux["total"]),
                grads=pointpillars_params_from_flax(opt_state[0]),
                state=pointpillars_state_from_flax(
                    {"params": params, "batch_stats": bs})))
        cache[key] = out
        return out

    return run


def _port_model(variables, dtype):
    tcfg = TConfig(**CFG, dtype=dtype)
    model = TPointPillars(tcfg, device="cpu")
    model.load_state_dict(pointpillars_state_from_flax(variables))
    return model, tcfg


def port_run(variables, dtype, b, steps=1, remat=False, repeat=1):
    """The port's steps on the same weights and batch."""
    model, tcfg = _port_model(variables, dtype)
    opt, _ = t_make_optimizer(model.parameters(), STEPS)
    step = t_make_train_step(model, opt, tcfg,
                             t_make_anchors(tcfg, device="cpu"), remat=remat)
    step = repeat_batch_step(step, repeat)
    batch = {k: torch.from_numpy(v) for k, v in _batch(b).items()}
    out = []
    for _ in range(steps):
        aux = step(batch)
        out.append(dict(
            loss=float(aux["total"]),
            grads={n: p.grad.clone() for n, p in model.named_parameters()},
            state={k: v.clone() for k, v in model.state_dict().items()}))
    return out


def _rel_max(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("b", [2, 3])
def test_train_step_matches_f32(variables, jax_run, b):
    """One float32 step (batch 2, and 3 where the masked max's argmax
    route matters). Loss: rtol 1e-5 against the JAX package's float32 and
    float64 steps. Gradients: every leaf within 2e-5 of its largest |g| of
    the float64 step's, and no farther from it than the JAX package's
    float32 step (module docstring). BatchNorm running statistics: rtol /
    atol 1e-5. Parameters after Adam's first step (~lr sign(g)): to 1e-6
    where |g| exceeds 1e-3 of the leaf's max, everywhere within 2 lr +
    1e-6 (lr 1e-4 at count 0 of the one-cycle schedule)."""
    want32, want64 = jax_run("float32", b)[0], jax_run("float64", b)[0]
    got = port_run(variables, "float32", b)[0]
    np.testing.assert_allclose(got["loss"], want32["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["loss"], want64["loss"], rtol=1e-5)
    assert set(got["grads"]) == set(want64["grads"])
    worst, worst_jax = 0.0, 0.0
    for name, g in got["grads"].items():
        ref = want64["grads"][name].numpy()
        assert np.abs(ref).max() > 0, name
        err = _rel_max(g.numpy().astype(np.float64), ref)
        assert err <= 2e-5, (name, err)
        worst = max(worst, err)
        worst_jax = max(worst_jax,
                        _rel_max(want32["grads"][name].numpy(), ref))
    assert worst <= worst_jax, (worst, worst_jax)
    for name, v in got["state"].items():
        w = want32["state"][name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        elif name in got["grads"]:
            g = want64["grads"][name].numpy()
            big = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(v.numpy()[big], w[big], rtol=0,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                       atol=2e-4 + 1e-6, err_msg=name)


@pytest.mark.parametrize("b", [2, 3])
def test_train_step_matches_bf16(variables, jax_run, b):
    """One bfloat16 step against the JAX package's bfloat16 and float64
    steps, within the module docstring's bound at the tiny config
    (bf16_bound(5, 576) = 0.0197): the loss relative to the float64 one
    (seen 7.7e-4 at batch 2; the JAX package's bf16 1.8e-3), the BatchNorm
    running statistics against the JAX package's bf16 step relative to
    each buffer's largest entry, every gradient leaf's relative L2 error
    against the float64 step within D 2^-5 = 0.156."""
    bound = bf16_bound(DEPTH_TINY, WIDTH_TINY)
    want16, want64 = jax_run("bfloat16", b)[0], jax_run("float64", b)[0]
    got = port_run(variables, "bfloat16", b)[0]
    assert abs(got["loss"] - want64["loss"]) <= bound * abs(want64["loss"])
    assert abs(want16["loss"] - want64["loss"]) <= bound * abs(
        want64["loss"])
    for name, v in got["state"].items():
        if name.endswith(("running_mean", "running_var")):
            w = want16["state"][name].numpy()
            assert np.abs(v.numpy() - w).max() <= bound * np.abs(w).max(), \
                name
    for name, g in got["grads"].items():
        ref = want64["grads"][name].numpy()
        err = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert err <= DEPTH_TINY * 2.0 ** -5, (name, err)


def test_steps_track_and_fall(variables, jax_run):
    """Three float32 steps at batch 2: the port's losses track the JAX
    package's (rtol 1e-5; 2e-6 seen) and both fall."""
    want = [s["loss"] for s in jax_run("float32", 2, STEPS)]
    got = [s["loss"] for s in port_run(variables, "float32", 2, STEPS)]
    assert all(np.isfinite(got)), got
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0] and want[-1] < want[0], (got, want)


def test_remat_equals_the_plain_step(variables):
    """``remat=True`` recomputes the forward in the backward; the recompute
    must not move the BatchNorm running statistics a second time. Two
    steps at batch 3: losses, gradients and every state entry equal, bit
    for bit (the CPU recomputes the same operations in the same order)."""
    plain = port_run(variables, "float32", 3, steps=2)
    remat = port_run(variables, "float32", 3, steps=2, remat=True)
    for p, r in zip(plain, remat):
        assert p["loss"] == r["loss"]
        for name in p["grads"]:
            assert torch.equal(p["grads"][name], r["grads"][name]), name
        for name in p["state"]:
            assert torch.equal(p["state"][name], r["state"][name]), name


def test_repeat_batch_step_is_exact(variables):
    """The batch tiled twice inside the step gives the same update
    (tests/test_train.py's check of the JAX function): with SGD, loss
    rtol 1e-5, parameters and BatchNorm statistics rtol 1e-5 / atol 1e-6
    (only the reduction order differs)."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    out = []
    for repeat in (1, 2):
        model, tcfg = _port_model(variables, "float32")
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        step = repeat_batch_step(
            t_make_train_step(model, opt, tcfg,
                              t_make_anchors(tcfg, device="cpu")), repeat)
        aux = step(batch)
        out.append((float(aux["total"]), model.state_dict()))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-5)
    for name, v in out[0][1].items():
        np.testing.assert_allclose(out[1][1][name].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_bev_gather_matches_and_backward_is_a_gather():
    """scatter_to_bev forward and its gradient against the JAX package's
    ``_bev_gather`` custom VJP (exact: both are copies), invalid pillars'
    gradient 0, and the backward is the custom gather's (no autograd
    scatter-add)."""
    rng = np.random.default_rng(5)
    b, p, nf, grid = 2, 40, 6, (9, 7)
    coords = np.stack([np.stack(np.unravel_index(
        rng.permutation(grid[0] * grid[1])[:p], grid), -1)
        for _ in range(b)]).astype(np.int32)
    valid = rng.random((b, p)) < 0.8
    pf = rng.normal(size=(b, p, nf)).astype(np.float32)
    cot = rng.normal(size=(b, *grid, nf)).astype(np.float32)

    def loss(x):
        return jnp.sum(scatter_to_bev(x, jnp.asarray(coords),
                                      jnp.asarray(valid), grid)
                       * jnp.asarray(cot))
    want = np.asarray(scatter_to_bev(jnp.asarray(pf), jnp.asarray(coords),
                                     jnp.asarray(valid), grid))
    want_g = np.asarray(jax.grad(loss)(jnp.asarray(pf)))
    x = torch.from_numpy(pf).requires_grad_()
    got = t_scatter(x, torch.from_numpy(coords), torch.from_numpy(valid),
                    grid)
    assert got.grad_fn.name() == "_BevGatherBackward"
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(x.grad.numpy(), want_g)
    assert np.all(x.grad.numpy()[~valid] == 0)


def test_masked_max_sends_a_tie_to_the_first_point():
    """Two points of a pillar with equal features tie in the masked max:
    the whole cotangent goes to the first (the JAX module's argmax route
    on the CPU), as the JAX package's PFN gradient has it, where ``amax``
    would split it evenly."""
    from d3d_tpu.models.pointpillars import _PFN
    from d3d_tpu_torch.models.pointpillars import _PFN as TPFN

    rng = np.random.default_rng(9)
    x = rng.normal(size=(1, 3, 4, 5)).astype(np.float32)
    x[0, 0, 2] = x[0, 0, 0]   # a tie in pillar 0
    x[0, 1, 3] = 0.0          # a padded point
    pmask = np.any(x != 0, axis=-1)
    mod = _PFN(6, "float32")
    var = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x),
                                            jnp.asarray(pmask), True))

    def jloss(inp):
        out, _ = mod.apply(var, inp, jnp.asarray(pmask), True,
                           mutable=["batch_stats"])
        return jnp.sum(out * jnp.arange(1.0, 7.0))
    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tmod = TPFN(5, 6, "float32")
    tmod.dense.weight.data = torch.tensor(
        np.asarray(var["params"]["Dense_0"]["kernel"]).T)
    tmod.bn.weight.data = torch.tensor(
        np.asarray(var["params"]["BatchNorm_0"]["scale"]))
    tmod.bn.bias.data = torch.tensor(
        np.asarray(var["params"]["BatchNorm_0"]["bias"]))
    tx = torch.from_numpy(x).requires_grad_()
    out = tmod(tx, torch.from_numpy(pmask), train=True)
    (out * torch.arange(1.0, 7.0)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-5, atol=1e-6)

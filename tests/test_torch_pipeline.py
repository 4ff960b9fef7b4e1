"""The port's GPipe pipeline and expert-parallel MoE on 4 gloo ranks
(``tests/_torch_dist_worker.py``) against the sequential stack, the dense
MoE and the JAX package's functions on its 8-device CPU mesh: the cases
and tolerances of ``tests/test_pipeline.py`` (forward atol 1e-6,
gradients 1e-5; 8 stages on 4 ranks 1e-5), ``tests/test_sst.py``'s
pipelined trunk (atol 2e-5) and ``tests/test_moe.py``'s expert sharding
(atol 1e-5, the load-balance loss rtol 1e-6); an SST MoE step on a
(dp2, ep2) mesh against the single-process step."""

import dataclasses

import numpy as np
import pytest
import torch

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp

from d3d_tpu.models import SST as JSST, SSTConfig as JSSTConfig
from d3d_tpu.models import pillarize as j_pillarize
from d3d_tpu.models.sst import pipeline_sst_trunk as j_pipeline_sst_trunk
from d3d_tpu.parallel import moe as JM
from d3d_tpu.parallel.pipeline import (make_pp_mesh, microbatch,
                                       pipeline_apply, unmicrobatch)

from d3d_tpu_torch.models import SSTConfig as TSSTConfig
from d3d_tpu_torch.models import sst_state_from_flax

from _torch_dist_worker import Group

C = 16
SST_TINY = dict(bounds=(0.0, 16.0, -8.0, 8.0, -3.0, 1.0), grid=(32, 32),
                max_pillars=256, max_points_per_pillar=16, pfn_features=32,
                window=8, capacity=16, depth=4, num_heads=2,
                neck_channels=32)
E, N = 4, 32


def _stage_state(rng, s):
    return {"w": rng.normal(0, 0.3, (s, C, C)).astype(np.float32),
            "b": rng.normal(0, 0.1, (s, C)).astype(np.float32)}


def _j_stage(state, x, mb):
    return jax.nn.gelu(x @ state["w"] + state["b"])


def _j_pipeline(state, x, m, mesh, batch_axis=None, grad=False):
    """JAX's pipeline_apply: the outputs and, with ``grad``, the gradients
    of sum(out^2)."""
    def loss(st, xx):
        out = unmicrobatch(pipeline_apply(_j_stage, st, microbatch(xx, m),
                                          mesh, batch_axis=batch_axis))
        return jnp.sum(out ** 2), out

    st = jax.tree.map(jnp.asarray, state)
    if not grad:
        return np.asarray(jax.jit(lambda a, b: loss(a, b)[1])(
            st, jnp.asarray(x))), None
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        st, jnp.asarray(x))
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def _sst_batch(seed=3, b=4):
    rng = np.random.default_rng(seed)
    pts = np.stack([np.stack([
        rng.random(2048) * 16, rng.random(2048) * 16 - 8,
        rng.random(2048) * 4 - 3, rng.random(2048)], axis=1)
        for _ in range(b)]).astype(np.float32)
    feats, coords, valid = jax.vmap(lambda p: j_pillarize(
        p, JSSTConfig(**SST_TINY)))(jnp.asarray(pts))
    m = 3
    gt = np.stack([np.stack([
        rng.random(m) * 12 + 2, rng.random(m) * 12 - 6, np.full(m, -1.0),
        np.full(m, 3.9), np.full(m, 1.6), np.full(m, 1.56),
        rng.random(m) * np.pi - np.pi / 2], axis=1)
        for _ in range(b)]).astype(np.float32)
    mask = np.ones((b, m), bool)
    mask[b // 2:, 1:] = False
    return dict(features=np.asarray(feats), coords=np.asarray(coords),
                valid=np.asarray(valid), gt_boxes=gt,
                gt_labels=np.zeros((b, m), np.int32), gt_mask=mask)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX references and the pp/ep rank group's results."""
    rng = np.random.default_rng(11)
    pipe = dict(s2=_stage_state(rng, 2), s4=_stage_state(rng, 4),
                s8=_stage_state(rng, 8), s4b=_stage_state(rng, 4),
                s6=_stage_state(rng, 6),
                x8=rng.normal(size=(8, C)).astype(np.float32),
                x12=rng.normal(size=(12, C)).astype(np.float32))
    batch = _sst_batch()
    cfg = JSSTConfig(**SST_TINY)
    args = (batch["features"], batch["coords"], batch["valid"])
    var = jax.jit(JSST(cfg).init)(jax.random.PRNGKey(0), *args)
    moe_cfg = dataclasses.replace(cfg, depth=2, moe_experts=2,
                                  moe_group=256)
    moe_var = jax.jit(JSST(moe_cfg).init)(jax.random.PRNGKey(1), *args)
    moe_params = {k: np.asarray(v, np.float32)
                  for k, v in JM.init_moe_params(
                      jax.random.PRNGKey(2), E, C, 2 * C).items()}
    moe_x = rng.normal(size=(2, N, C)).astype(np.float32)

    out = tmp_path_factory.mktemp("pipeline")
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    torch.save(dict(
        pipe={k: ({n: t(a) for n, a in v.items()} if isinstance(v, dict)
                  else t(v)) for k, v in pipe.items()},
        sst_cfg=TSSTConfig(**SST_TINY), sst_state=sst_state_from_flax(var),
        sst_batch={k: t(v) for k, v in batch.items()},
        sst_moe_cfg=TSSTConfig(**dataclasses.asdict(moe_cfg)),
        sst_moe_state=sst_state_from_flax(moe_var),
        moe_params={k: t(v) for k, v in moe_params.items()}, moe_x=t(moe_x)),
        out / "inputs.pt")
    group = Group("pp_ep", 4, out)

    # the JAX side while the ranks run
    ref = {}
    pp4, pp2dp2 = make_pp_mesh(4), make_pp_mesh(2, dp=2)
    ref["s2m4"] = _j_pipeline(pipe["s2"], pipe["x8"], 4, make_pp_mesh(2))
    ref["s4m4"] = _j_pipeline(pipe["s4"], pipe["x8"], 4, pp4, grad=True)
    ref["s8m4"] = _j_pipeline(pipe["s8"], pipe["x8"], 4, pp4)
    ref["dp_pp"] = _j_pipeline(pipe["s4b"], pipe["x12"], 3, pp2dp2,
                               batch_axis="dp")
    pf0 = jax.jit(lambda v: JSST(cfg, stage="embed").apply(
        v, *args, train=False))(var)
    mb = lambda a: microbatch(jnp.asarray(a), 2)  # noqa: E731
    ref["trunk_pp4"] = np.asarray(unmicrobatch(j_pipeline_sst_trunk(
        var, cfg, pp4, mb(pf0), mb(batch["coords"]), mb(batch["valid"]))))
    ref["trunk_dp_pp"] = np.asarray(unmicrobatch(j_pipeline_sst_trunk(
        var, cfg, pp2dp2, mb(pf0), mb(batch["coords"]), mb(batch["valid"]),
        batch_axis="dp")))
    for gs in (None, 16):
        y, aux = jax.jit(lambda p, x: JM.moe_mlp(p, x, group_size=gs))(
            jax.tree.map(jnp.asarray, moe_params), jnp.asarray(moe_x))
        ref[f"moe_{gs}"] = (np.asarray(y), float(aux))
    return dict(ranks=group.results(), ref=ref)


@pytest.mark.parametrize("name,atol", [("s2m4", 1e-6), ("s4m4", 1e-6),
                                       ("s8m4", 1e-5), ("dp_pp", 1e-6)])
def test_pipeline_forward_matches_sequential_and_jax(case, name, atol):
    want, _ = case["ref"][name]
    for r in case["ranks"]:
        res = r[name]
        assert res["err"]["out"] <= atol, res["err"]
        np.testing.assert_allclose(res["outputs"].numpy(), want, rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("name", ["s2m4", "s4m4", "s8m4", "dp_pp"])
def test_pipeline_gradients_match_sequential_and_jax(case, name):
    """Gradients of the stages' weights and of the input, whole on every
    rank, against the sequential stack's, and (4 stages, 4 microbatches,
    as ``tests/test_pipeline.py``'s gradient test) against ``jax.grad``
    of JAX's pipeline."""
    _, want = case["ref"][name]
    for r in case["ranks"]:
        res = r[name]
        for k in ("w", "b", "x"):
            assert res["err"][k] <= 1e-5, (k, res["err"])
        for k in ("w", "b") if want is not None else ():
            np.testing.assert_allclose(res["grads"][k].numpy(), want[k],
                                       rtol=0, atol=1e-5, err_msg=k)


def test_stage_count_must_divide_the_ranks(case):
    for r in case["ranks"]:
        assert "divide" in r["stage_count"]


@pytest.mark.parametrize("name", ["trunk_pp4", "trunk_dp_pp"])
def test_pipelined_sst_trunk(case, name):
    """Equal to SST(stage="trunk") on the same inputs and to the JAX
    package's pipelined trunk."""
    for r in case["ranks"]:
        assert r[name]["err"] <= 2e-5, r[name]["err"]
        np.testing.assert_allclose(r[name]["got"].numpy(),
                                   case["ref"][name], rtol=0, atol=2e-5)


@pytest.mark.parametrize("ep", ["ep2", "ep4"])
@pytest.mark.parametrize("gs", [None, 16])
def test_moe_mesh_matches_dense_and_jax(case, ep, gs):
    want_y, want_aux = case["ref"][f"moe_{gs}"]
    for r in case["ranks"]:
        res = r[f"moe_{ep}_{gs}"]
        for k, err in res["err"].items():
            assert err <= 1e-5, (k, err)
        np.testing.assert_allclose(res["y"].numpy(), want_y, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(res["aux"], want_aux, rtol=1e-6)
        np.testing.assert_allclose(res["aux"], res["dense_aux"], rtol=1e-6)


def test_sst_moe_step_on_dp_ep(case):
    """The expert leaves hold E/2 experts a rank (the router whole); the
    loss, load-balance loss and updated parameters equal the
    single-process step's. Adam's first step is about lr * sign(g), so
    parameters are compared where the gradient is not rounding noise
    (above 1e-4 of its leaf's largest: the attention's key bias, for
    one, has a zero gradient)."""
    for r in case["ranks"]:
        res = r["sst_moe"]
        assert res["w1_local"][0] == 1
        assert res["router_local"] == (SST_TINY["pfn_features"], 2)
        assert "moe_aux" in res["ep"]["loss"]
        for k, v in res["plain"]["loss"].items():
            np.testing.assert_allclose(res["ep"]["loss"][k], v, rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        grads = res["plain_grads"]
        for k, want in res["plain"]["state"].items():
            got = res["ep"]["state"][k]
            assert got.shape == want.shape, k
            if not want.dtype.is_floating_point:
                continue
            keep = np.ones(want.shape, bool)
            if k in grads:
                g = grads[k].abs().numpy()
                keep = g > 1e-4 * g.max()
            np.testing.assert_allclose(got.numpy()[keep],
                                       want.numpy()[keep], rtol=0,
                                       atol=1e-5, err_msg=k)

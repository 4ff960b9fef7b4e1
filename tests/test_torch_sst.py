"""The port's SST (``models/sst.py``) against the JAX package on
``tests/test_sst.py``'s TINY configuration: the window-slot routing (both
tilings, capacity overflow), tokenization, the forward in float32 and
bfloat16 through ``sst_state_from_flax`` (randomized flax weights,
BatchNorm statistics and LayerNorm scales included), the ``embed`` and
``trunk`` stages, padded pillars that must not leak, one training step
against the JAX package's float64 step, ``remat_blocks``, the Switch-MoE
variant and ``make_sst_detector``.

One module-scoped bank holds the inputs and the JAX package's results, so
each JAX program compiles once. Tolerances are stated per test: integer
routing exact; float32 within f32 rounding (XLA:CPU and torch sum in
other orders)."""

import dataclasses

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import optax
import torch

from d3d_tpu.dataset.kitti.utils import KittiObjectClass
from d3d_tpu.models import SST, make_anchors, make_sst_detector, presets
from d3d_tpu.models.pointpillars import make_train_step
from d3d_tpu.models.sst import detok_tokens, route_tokens, window_slots

from d3d_tpu_torch.dataset.kitti.utils import KittiObjectClass as TClass
from d3d_tpu_torch.models import SST as TSST
from d3d_tpu_torch.models import SSTConfig as TConfig
from d3d_tpu_torch.models import make_anchors as t_make_anchors
from d3d_tpu_torch.models import make_sst_detector as t_detector
from d3d_tpu_torch.models import pillarize as t_pillarize
from d3d_tpu_torch.models import presets as t_presets
from d3d_tpu_torch.models import sst as TS
from d3d_tpu_torch.models import (sst_params_from_flax, sst_state_from_flax,
                                  window_slots as t_window_slots)
from d3d_tpu_torch.models.pointpillars import (
    make_train_step as t_make_train_step)

from tests.test_sst import TINY, _cloud, _gt
from tests.test_torch_second import _randomize

MOE = dataclasses.replace(TINY, moe_experts=2, moe_group=200)
B, M = 2, 3


def _tcfg(cfg, **kw):
    return TConfig(**dataclasses.asdict(dataclasses.replace(cfg, **kw)))


def _capture_grads():
    """An optax transformation whose state keeps the gradient it got."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def _inputs(clouds):
    """The port's pillars of each cloud, stacked (pillarize is held to the
    JAX package's by tests/test_torch_pointpillars.py)."""
    pil = [t_pillarize(torch.from_numpy(p), _tcfg(TINY)) for p in clouds]
    return [torch.stack([v[i] for v in pil]).numpy() for i in range(3)]


@pytest.fixture(scope="module")
def bank():
    """Inputs, randomized flax weights of the dense and the MoE model, and
    the JAX package's forward, one-step and detector results."""
    rng = np.random.default_rng(20261018)
    clouds = [_cloud(rng) for _ in range(B)] + [_cloud(rng, n=160)]
    feats, coords, valid = _inputs(clouds[:B])
    batch = dict(features=feats, coords=coords, valid=valid,
                 gt_boxes=np.stack([_gt(rng, M) for _ in range(B)]),
                 gt_labels=np.zeros((B, M), np.int32),
                 gt_mask=np.array([[1, 1, 1], [1, 0, 1]], bool))
    out = dict(clouds=clouds, batch=batch)
    for name, cfg in (("dense", TINY), ("moe", MOE)):
        shapes = jax.eval_shape(SST(cfg).init, jax.random.PRNGKey(0),
                                feats, coords, valid)
        out[name] = _randomize({k: shapes[k] for k in ("params",
                                                       "batch_stats")},
                               np.random.default_rng(7))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = (jb["features"], jb["coords"], jb["valid"])
    for dtype in ("float32", "bfloat16"):
        model = SST(dataclasses.replace(TINY, dtype=dtype))
        out[f"fwd_{dtype}"] = [np.asarray(o) for o in jax.jit(
            lambda v: model.apply(v, *args))(out["dense"])]
    for stage in ("embed", "trunk"):
        out[stage] = np.asarray(jax.jit(lambda v: SST(TINY, stage=stage)
                                        .apply(v, *args))(out["dense"]))
    out["fwd_moe"] = [np.asarray(o) for o in jax.jit(
        lambda v: SST(MOE).apply(v, *args))(out["moe"])]
    # one step of the JAX package's own make_train_step, the dense model
    # in float64 and the MoE model in float32: loss, aux and gradients
    for name, cfg, fdt in (("step_f64", dataclasses.replace(
            TINY, dtype="float64"), np.float64), ("step_moe", MOE,
                                                  np.float32)):
        var = jax.tree.map(lambda x: np.asarray(x, fdt),
                           out["moe" if cfg.moe_experts else "dense"])
        b = dict(jb, features=jnp.asarray(batch["features"], fdt))
        tx = _capture_grads()
        step = jax.jit(make_train_step(SST(cfg), tx, cfg, make_anchors(cfg)))
        _, _, opt_state, aux = step(var["params"], var["batch_stats"],
                                    tx.init(var["params"]), b)
        out[name] = dict(aux={k: float(v) for k, v in aux.items()},
                         grads=sst_params_from_flax(opt_state))
    detect = make_sst_detector(SST(TINY), out["dense"], TINY,
                               make_anchors(TINY), [KittiObjectClass.Car],
                               score_threshold=0.0, top_k=32)
    out["detect"] = [np.asarray(a) for a in
                     detect.device_fn(jnp.asarray(clouds[0]))]
    return out


def _port(bank, cfg=TINY, stage="full", **kw):
    model = TSST(_tcfg(cfg, **kw), stage=stage, device="cpu")
    model.load_state_dict(sst_state_from_flax(
        bank["moe" if cfg.moe_experts else "dense"]))
    return model


def _torch_inputs(bank):
    return [torch.from_numpy(bank["batch"][k])
            for k in ("features", "coords", "valid")]


def _rel_max(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def test_presets_match():
    assert dataclasses.asdict(t_presets.sst_kitti()) == dataclasses.asdict(
        presets.sst_kitti())
    assert (dataclasses.asdict(t_presets.sst_kitti(moe_experts=8))
            == dataclasses.asdict(presets.sst_kitti(moe_experts=8)))


@pytest.mark.parametrize("case", ["unshifted", "shifted", "overflow",
                                  "overflow_shifted"])
def test_window_slots_exact(case):
    """slot and inv equal to the JAX function's, both tilings (the shifted
    one over the grid padded by one window) and a capacity that overflows
    into the trash slot: 256 pillars on a 16 x 16 corner, capacity 5."""
    rng = np.random.default_rng(3)
    shift = case in ("shifted", "overflow_shifted")
    overflow = case.startswith("overflow")
    p, grid, window = 256, (32, 40), 8
    hi = (16, 16) if overflow else grid
    coords = np.stack([rng.integers(0, h, (2, p)) for h in hi],
                      axis=-1).astype(np.int32)
    valid = rng.random((2, p)) < 0.85
    cap = 5 if overflow else 64
    want = jax.vmap(lambda c, v: window_slots(c, v, grid, window, cap,
                                              shift))(coords, valid)
    got = t_window_slots(torch.from_numpy(coords), torch.from_numpy(valid),
                         grid, window, cap, shift)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dropped = (got[0] == got[1].shape[-1]) & torch.from_numpy(valid)
    assert bool(dropped.any()) == overflow


def test_route_and_detok_bit_equal():
    """Tokens, masks and detokenized rows bit for bit; overflow pillars
    keep their own rows."""
    rng = np.random.default_rng(4)
    p, c, cap = 96, 8, 4
    coords = rng.integers(0, 16, (2, p, 2)).astype(np.int32)
    valid = rng.random((2, p)) < 0.9
    pf = rng.normal(size=(2, p, c)).astype(np.float32)
    slot, inv = (np.asarray(a) for a in jax.vmap(
        lambda cd, v: window_slots(cd, v, (16, 16), 8, cap, True))(
            coords, valid))
    tok, tmask = route_tokens(jnp.asarray(pf), jnp.asarray(inv), cap)
    ttok, ttmask = TS.route_tokens(torch.from_numpy(pf),
                                   torch.from_numpy(inv), cap)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(tok))
    np.testing.assert_array_equal(ttmask.numpy(), np.asarray(tmask))
    new = rng.normal(size=tok.shape).astype(np.float32)
    want = detok_tokens(jnp.asarray(pf), jnp.asarray(new), jnp.asarray(slot),
                        inv.shape[1])
    got = TS.detok_tokens(torch.from_numpy(pf), torch.from_numpy(new),
                          torch.from_numpy(slot), inv.shape[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches(bank, dtype):
    """The heads through sst_state_from_flax: float32 within 1e-5 of each
    output's largest magnitude (7.4e-7 seen); bfloat16 within 3e-2 (9.1e-3
    seen here, 0.80e-2 to 1.14e-2 over six other seeds of weights and
    clouds: bf16 rounds the attention, LayerNorm and MLP at other places
    in XLA and torch, and two blocks compound it)."""
    model = _port(bank, dtype=dtype)
    with torch.no_grad():
        got = model(*_torch_inputs(bank))
    bound = 1e-5 if dtype == "float32" else 3e-2
    for g, w in zip(got, bank[f"fwd_{dtype}"]):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel_max(g.numpy(), w) <= bound


@pytest.mark.parametrize("stage", ["embed", "trunk"])
def test_stages_match(bank, stage):
    """The pillar features after the embedding and after the blocks, each
    within 1e-5 of its largest magnitude (3.6e-7 seen)."""
    model = _port(bank, stage=stage)
    with torch.no_grad():
        got = model(*_torch_inputs(bank))
    assert got.shape == bank[stage].shape
    assert _rel_max(got.numpy(), bank[stage]) <= 1e-5


def test_padded_pillars_do_not_leak(bank):
    """Features of an invalid pillar (and so of the empty window slots
    that read its row) changed to 123: every head output bit-equal."""
    feats, coords, valid = (torch.from_numpy(a) for a in _inputs(
        bank["clouds"][B:]))
    assert not bool(valid.all())
    model = _port(bank)
    dead = int(torch.nonzero(~valid[0])[0, 0])
    with torch.no_grad():
        ref = model(feats, coords, valid)
        feats2 = feats.clone()
        feats2[0, dead] = 123.0
        got = model(feats2, coords, valid)
    assert all(torch.equal(a, b) for a, b in zip(ref, got))


def _step(bank, cfg=TINY, remat=False, **kw):
    """One port step (SGD at lr 0: the gradient is what is compared)."""
    model = _port(bank, cfg, **kw)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    tcfg = _tcfg(cfg, **kw)
    step = t_make_train_step(model, opt, tcfg,
                             t_make_anchors(tcfg, device="cpu"), remat=remat)
    aux = step({k: torch.from_numpy(v) for k, v in bank["batch"].items()})
    return aux, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_train_step_matches_f64(bank):
    """One float32 step against the JAX package's float64 step: loss rtol
    1e-5; every gradient leaf within 2e-5 of its largest |g| (1.0e-5
    seen, head_cls.bias: the attention's softmax and the LayerNorms'
    backward in f32)."""
    aux, grads = _step(bank)
    want = bank["step_f64"]
    np.testing.assert_allclose(float(aux["total"]), want["aux"]["total"],
                               rtol=1e-5)
    assert set(grads) == set(want["grads"])
    for name, g in grads.items():
        err = _rel_max(g.numpy().astype(np.float64),
                       want["grads"][name].numpy())
        assert err <= 2e-5, (name, err)


@pytest.mark.parametrize("how", ["remat_blocks", "remat"])
def test_remat_equals_plain_step(bank, how):
    """remat_blocks (a checkpoint a block) and remat (the whole forward)
    recompute: loss and gradients bit-equal to the plain step, MoE blocks'
    aux included."""
    kw = dict(remat_blocks=True) if how == "remat_blocks" else {}
    for cfg in (TINY, MOE):
        a0, g0 = _step(bank, cfg)
        a1, g1 = _step(bank, cfg, remat=how == "remat", **kw)
        assert all(float(a0[k]) == float(a1[k]) for k in a0)
        assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_moe_forward_and_step(bank):
    """moe_experts=2 (groups of 200 tokens over the batch's 2 x 256
    pillars: a padded last group): the heads within 1e-5 of JAX's; one
    step's moe_aux within 1e-6 and at the Switch bound depth x (1 - 1e-4),
    the loss within rtol 1e-5 (its moe term included), every gradient
    leaf within 1e-4 of JAX's float32 step's largest |g| (both float32;
    5.1e-5 seen)."""
    model = _port(bank, MOE)
    assert set(model.state_dict()) == set(sst_state_from_flax(bank["moe"]))
    with torch.no_grad():
        got = model(*_torch_inputs(bank))
    assert len(model.sown_losses) == MOE.depth
    for g, w in zip(got, bank["fwd_moe"]):
        assert _rel_max(g.numpy(), w) <= 1e-5
    aux, grads = _step(bank, MOE)
    want = bank["step_moe"]
    assert abs(float(aux["moe_aux"]) - want["aux"]["moe_aux"]) <= 1e-6
    assert float(aux["moe_aux"]) >= MOE.depth * (1.0 - 1e-4)
    np.testing.assert_allclose(float(aux["total"]), want["aux"]["total"],
                               rtol=1e-5)
    loss = float(aux["total"]) + MOE.moe_aux_weight * float(aux["moe_aux"])
    assert loss > float(aux["total"])
    for name, g in grads.items():
        err = _rel_max(g.numpy(), want["grads"][name].numpy())
        assert err <= 1e-4, (name, err)


def test_detector_matches(bank):
    """make_sst_detector's device_fn: keep mask and labels exact, boxes
    within 1e-4, scores within 1e-5; detect's Target3DArray of the kept
    boxes."""
    tdet = t_detector(_port(bank), None, _tcfg(TINY),
                      t_make_anchors(_tcfg(TINY), device="cpu"),
                      [TClass.Car], score_threshold=0.0, top_k=32,
                      device="cpu")
    pts = bank["clouds"][0]
    want = bank["detect"]
    got = [t.numpy() for t in tdet.device_fn(pts)]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    out = tdet(pts, frame="velo")
    assert len(out) == int(want[3].sum()) > 0 and out.frame == "velo"


def test_mesh_hooks_raise(bank):
    """constrain / moe_constrain no longer raise: ``constrain`` is called
    once, on the neck's NCHW canvas with kind "bev", ``moe_constrain``
    (a ``t -> t`` hook) on each MoE block's expert blocks, and identity
    hooks leave the outputs as they are (the mesh hooks run on ranks:
    tests/test_torch_parallel.py, test_torch_pipeline.py)."""
    args = [torch.from_numpy(np.asarray(bank["batch"][k]))
            for k in ("features", "coords", "valid")]
    for cfg, kw in ((TINY, "constrain"), (MOE, "moe_constrain")):
        seen, outs = [], []
        hook = ((lambda x, kind: seen.append(kind) or x) if kw == "constrain"
                else (lambda t: seen.append(t.ndim) or t))
        for h in (None, hook):
            model = TSST(_tcfg(cfg), device="cpu", **{kw: h},
                         generator=torch.Generator().manual_seed(3))
            with torch.no_grad():
                outs.append(model(*args))
        assert all(torch.equal(a, b) for a, b in zip(*outs))
        assert seen == (["bev"] if kw == "constrain"
                        else [4] * 2 * cfg.depth)


def test_empty_slot_share(bank):
    """empty_slot_share: 1 - routed pillars / slots over the blocks'
    tilings (TINY's depth 2: one of each)."""
    cfg = _tcfg(TINY)
    _, coords, valid = (torch.from_numpy(a) for a in _inputs(
        bank["clouds"][B:]))
    filled = slots = 0
    for shift in (False, True):
        slot, inv = t_window_slots(coords, valid, cfg.grid, cfg.window,
                                   cfg.capacity, shift)
        filled += int((slot < inv.shape[-1]).sum())
        slots += inv.numel()
    share = TS.empty_slot_share(cfg, coords, valid)
    assert 0 < share < 1 and share == pytest.approx(1 - filled / slots)

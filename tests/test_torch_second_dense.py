"""The port's dense-canvas middle (``SECONDConfig(middle="dense")``,
``dense_stage_loop``) against the JAX package's dense path and against the
port's own sparse path, on ``tests/test_second_dense.py``'s configuration,
where no site cap binds (so both paths compute the same convolution).

One module-scoped bank holds the weights, the batch and the JAX package's
results, so each JAX program compiles once."""

import dataclasses

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.models.second import SECOND, _pool_mask, dense_stage_loop

from d3d_tpu_torch.models import SECOND as TSECOND
from d3d_tpu_torch.models import SECONDConfig as TConfig
from d3d_tpu_torch.models import second_params_from_flax
from d3d_tpu_torch.models import second_state_from_flax
from d3d_tpu_torch.models import second as TS2

from tests.test_second_dense import CFG, _batch
from tests.test_torch_second import _randomize

DENSE = dataclasses.replace(CFG, middle="dense")


@pytest.fixture(scope="module")
def bank():
    feats, coords, valid = _batch(np.random.default_rng(3))
    shapes = jax.eval_shape(SECOND(DENSE).init, jax.random.PRNGKey(0),
                            feats, coords, valid)
    variables = _randomize(shapes, np.random.default_rng(8))
    out = jax.jit(lambda v, f, c, m: SECOND(DENSE).apply(v, f, c, m))(
        variables, feats, coords, valid)

    import flax.linen as nn

    class DenseTrunk(nn.Module):
        @nn.compact
        def __call__(self, f, c, v):
            return dense_stage_loop(CFG, f, c, v, False)

    canvas, mask = jax.jit(DenseTrunk().apply)(
        {"params": variables["params"],
         "batch_stats": variables["batch_stats"]}, feats, coords, valid)

    def loss(params):
        o, upd = SECOND(DENSE).apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            feats, coords, valid, train=True, mutable=["batch_stats"])
        return sum(jnp.sum(jnp.abs(x)) for x in o), upd["batch_stats"]

    (l, stats), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    batch = [torch.from_numpy(np.array(a)) for a in (feats, coords, valid)]
    return dict(batch=batch, variables=variables,
                out=[np.asarray(o) for o in out], canvas=np.asarray(canvas),
                mask=np.asarray(mask), loss=float(l), grads=grads,
                stats=jax.tree.map(np.asarray, stats))


def _model(bank, cfg):
    model = TSECOND(TConfig(**dataclasses.asdict(cfg)), device="cpu")
    model.load_state_dict(second_state_from_flax(bank["variables"]))
    return model


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_pool_mask_matches():
    """The pooled active set exactly, odd dims padded up (ceil-div)."""
    rng = np.random.default_rng(1)
    mask = rng.random((2, 7, 9, 5)) < 0.1
    want = np.asarray(_pool_mask(jnp.asarray(mask), 2))
    got = TS2._pool_mask(torch.from_numpy(mask), 2).numpy()
    assert got.shape == want.shape == (2, 4, 5, 3)
    np.testing.assert_array_equal(got, want)


def test_dense_stage_loop_matches(bank):
    """The final canvas within 1e-5 of its largest magnitude (f32
    convolutions summed in other orders) and the final mask exact."""
    model = _model(bank, DENSE)
    with torch.no_grad():
        canvas, mask = TS2.dense_stage_loop(model.cfg, model.middle,
                                            *bank["batch"])
    np.testing.assert_array_equal(mask.numpy(), bank["mask"])
    assert canvas.shape == bank["canvas"].shape
    assert _rel(canvas.numpy(), bank["canvas"]) <= 1e-5


def test_dense_forward_matches_jax_and_the_sparse_path(bank):
    """The three head outputs within 1e-5 of each one's largest magnitude
    of the JAX package's dense forward, and within 1e-4 of the port's
    sparse path on the same weights (the caps do not bind: the same
    convolution, gathered instead of dense)."""
    dense, sparse = _model(bank, DENSE), _model(bank, CFG)
    with torch.no_grad():
        got = dense(*bank["batch"])
        other = sparse(*bank["batch"])
    for g, s, w in zip(got, other, bank["out"]):
        assert _rel(g.numpy(), w) <= 1e-5
        assert _rel(s.numpy(), w) <= 1e-4


def test_dense_gradients_and_statistics_match(bank):
    """Training mode, loss sum |outputs|: the loss rtol 1e-5, every
    gradient leaf within 1e-4 of its largest |g| of the JAX package's, the
    running statistics within 1e-5."""
    model = _model(bank, DENSE)
    out = model(*bank["batch"], train=True)
    loss = sum(o.abs().sum() for o in out)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), bank["loss"], rtol=1e-5)
    want = second_params_from_flax(bank["grads"])
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), want[name].numpy()) <= 1e-4, name
    stats = second_state_from_flax({"params": bank["variables"]["params"],
                                    "batch_stats": bank["stats"]})
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), stats[name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


def test_dense_bf16_forward_is_close(bank):
    """The preset's bfloat16 through the dense middle: finite, within
    2^-4 of the f32 outputs' largest magnitude."""
    model = _model(bank, dataclasses.replace(DENSE, dtype="bfloat16"))
    with torch.no_grad():
        got = model(*bank["batch"])
    for g, w in zip(got, bank["out"]):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        assert _rel(g.numpy(), w) <= 2 ** -4

"""The port's Switch-MoE MLP (``parallel/moe.py``) against the JAX
package's ``moe_mlp`` on the same numpy parameters and tokens: outputs and
the load-balance loss in float32 and bfloat16, capacity drops, grouped
routing with a padded last group, the token mask, and the gradient of a
loss through both against ``jax.grad``. The port dispatches by index, the
JAX module by one-hot einsums; each output entry is one product in both.
Tolerances are stated per test."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.parallel.moe import moe_mlp

from d3d_tpu_torch.parallel import init_moe_params
from d3d_tpu_torch.parallel import moe_mlp as t_moe_mlp
from d3d_tpu_torch.parallel.moe import gelu_tanh

E, C, H, N = 4, 16, 32, 24


@pytest.fixture(scope="module")
def params():
    """Seeded numpy parameters (nonzero biases, so a dropped bias shows)."""
    rng = np.random.default_rng(5)
    return dict(
        router=rng.normal(0, 1 / np.sqrt(C), (C, E)),
        w1=rng.normal(0, 1 / np.sqrt(C), (E, C, H)),
        b1=rng.normal(0, 0.1, (E, H)),
        w2=rng.normal(0, 1 / np.sqrt(H), (E, H, C)),
        b2=rng.normal(0, 0.1, (E, C)))


def _cast(params, dtype):
    """The JAX and torch trees of ``params`` in ``dtype`` (the router in
    float32 as SST keeps it)."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
          for k, v in params.items()}
    tp = {k: torch.tensor(v, dtype=torch.float32).to(
        torch.float32 if k == "router" else tdt) for k, v in params.items()}
    return jp, tp


def _run(params, x, dtype="float32", mask=None, **kw):
    jp, tp = _cast(params, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = jax.jit(lambda p, t, m: moe_mlp(p, t, mask=m, **kw))(
        jp, jnp.asarray(x, jdt), None if mask is None else jnp.asarray(mask))
    got = t_moe_mlp(tp, torch.tensor(x, dtype=torch.float32).to(
        getattr(torch, dtype)),
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    return ([np.asarray(w, np.float32) for w in want],
            [g.float().numpy() for g in got])


@pytest.mark.parametrize("case", ["plain", "capacity_drop", "grouped_8",
                                  "grouped_10_padded", "masked", "batched"])
def test_f32_matches(params, case):
    """float32: outputs and aux within 1e-6 (2.4e-7 seen: each output
    entry is one gate-weighted expert row in both forms; the expert
    products sum in another order). Capacity E / N keeps one token an
    expert; a group of
    10 does not divide 24 (a padded last group); the mask drops a third of
    the tokens."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, C))
    kw, mask = dict(capacity_factor=1.25), None
    if case == "capacity_drop":
        kw["capacity_factor"] = E / N
    elif case.startswith("grouped"):
        kw["group_size"] = int(case.split("_")[1])
    elif case == "masked":
        mask = rng.random(N) < 0.66
    elif case == "batched":
        x = rng.normal(size=(2, N, C))
        mask = rng.random((2, N)) < 0.8
        kw["group_size"] = 16
    (yw, aw), (yg, ag) = _run(params, x, mask=mask, **kw)
    np.testing.assert_allclose(yg, yw, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ag, aw, rtol=0, atol=1e-6)
    dropped = np.abs(yw).reshape(-1, C).sum(-1) == 0
    assert ((np.abs(yg).reshape(-1, C).sum(-1) == 0) == dropped).all()
    if case == "capacity_drop":
        assert (~dropped).sum() <= E
    if mask is not None:
        assert dropped[~mask.reshape(-1)].all()
    assert float(ag) >= 1.0 - 1e-6  # E * sum(f * P) >= 1 (Cauchy-Schwarz)


def test_bf16_matches(params):
    """bfloat16 tokens and experts: the routing (which rows are dropped)
    equal and outputs within one bf16 ulp of the largest (2^-8 of it: the
    expert products may round their sums at other places in XLA and
    torch; equal bits over six seeds), aux within 1e-6 (2.4e-7 seen)."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(N, C))
    (yw, aw), (yg, ag) = _run(params, x, "bfloat16", group_size=12)
    scale = np.abs(yw).max()
    assert np.abs(yg - yw).max() <= 2 ** -8 * scale
    np.testing.assert_allclose(ag, aw, rtol=0, atol=1e-6)
    assert ((np.abs(yg).sum(-1) == 0) == (np.abs(yw).sum(-1) == 0)).all()


def test_gelu_is_the_tanh_form():
    """gelu_tanh equals jax.nn.gelu (approximate) in float32 within 1e-6
    and is not F.gelu's erf form."""
    x = np.linspace(-6, 6, 401).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = gelu_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_gradient_matches_jax_grad(params):
    """d/d(params, x) of mean((y - 1)^2) + 0.01 aux in float32 against
    jax.grad: each leaf within 1e-6 of its largest |g| (2.1e-7 seen); the
    router gets gradient through the gates and the aux."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(N, C))
    mask = rng.random(N) < 0.9

    def jloss(p, t):
        y, aux = moe_mlp(p, t, mask=jnp.asarray(mask), group_size=10)
        return jnp.mean((y - 1.0) ** 2) + 0.01 * aux

    jp, tp = _cast(params, "float32")
    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x, jnp.float32))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    y, aux = t_moe_mlp(tp, tx, mask=torch.from_numpy(mask), group_size=10)
    (torch.mean((y - 1.0) ** 2) + 0.01 * aux).backward()
    got = {**{k: v.grad for k, v in tp.items()}, "x": tx.grad}
    ref = {**want[0], "x": want[1]}
    for k, g in got.items():
        r = np.asarray(ref[k])
        err = np.abs(g.numpy() - r).max() / np.abs(r).max()
        assert err <= 1e-6, (k, err)
    assert np.abs(got["router"].numpy()).sum() > 0


def test_init_and_mesh_hooks():
    """init_moe_params' layouts from a torch.Generator; a ``t -> t``
    constrain hook sees the (G, E, cap, C) expert blocks, as the JAX
    module's does, and an identity hook leaves the output as it is (the
    mesh= path runs on ranks: tests/test_torch_pipeline.py)."""
    p = init_moe_params(torch.Generator().manual_seed(0), E, C, H)
    assert {k: tuple(v.shape) for k, v in p.items()} == dict(
        router=(C, E), w1=(E, C, H), b1=(E, H), w2=(E, H, C), b2=(E, C))
    again = init_moe_params(torch.Generator().manual_seed(0), E, C, H)
    assert all(torch.equal(p[k], again[k]) for k in p)
    x = torch.randn(N, C, generator=torch.Generator().manual_seed(1))
    seen = []
    y, aux = t_moe_mlp(p, x, constrain=lambda t: seen.append(t.shape) or t)
    y0, aux0 = t_moe_mlp(p, x)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)
    cap = int(np.ceil(N / E * 1.25))
    assert seen and all(s[:3] == (1, E, cap) for s in seen)


def test_table_gather_backward_equals_scatter_add():
    """ops.gather.table_gather (routing and dispatch): forward equal to an
    index gather through an appended zero row, backward (a gather) equal
    to autograd's scatter-add, a table of unique rows and many entries of
    the zero row."""
    from d3d_tpu_torch.ops.gather import gather_rows, table_gather

    rng = np.random.default_rng(14)
    b, r, c, length = 2, 30, 5, 70
    table = np.full((b, length), r)
    for i in range(b):
        table[i, rng.choice(length, 20, replace=False)] = rng.choice(
            r, 20, replace=False)
    table = torch.from_numpy(table)
    x = torch.randn(b, r, c, dtype=torch.float64, requires_grad=True)
    g = torch.randn(b, length, c, dtype=torch.float64)
    got = table_gather(x, table)
    (dx,) = torch.autograd.grad(got, x, g)
    x_pad = torch.cat([x, x.new_zeros((b, 1, c))], 1)
    want = torch.stack([x_pad[i][table[i]] for i in range(b)])
    (dx_want,) = torch.autograd.grad(want, x, g)
    assert torch.equal(got, want) and torch.equal(gather_rows(x, table), want)
    assert torch.equal(dx, dx_want)

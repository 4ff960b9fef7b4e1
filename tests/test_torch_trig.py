"""The port's precise sin/cos (``d3d_tpu_torch.ops.trig``) against
``d3d_tpu.ops.trig``: float64 through the same Cody-Waite reduction and
Taylor polynomials in the same operation order, so equal to within one
ulp (bit-equal on these arguments); other dtypes take torch's own."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.ops import trig as JT

from d3d_tpu_torch.ops import trig as TT

ARGS = np.array([0.0, -0.0, 0.3, 0.9, 1.2, 1.87, 3.0, 6.0, -2.5, -6.1,
                 100.0, -314.15, np.pi / 4, np.pi / 2, 3 * np.pi / 4,
                 1e5 + 0.25])


@pytest.mark.parametrize("spread", [4.0, 1e3, 1e5])
def test_sincos_f64_matches_jax(rng, spread):
    x = np.concatenate([ARGS, rng.uniform(-spread, spread, 2000)])
    s, c = jax.jit(JT.sincos)(jnp.asarray(x))
    ts, tc = TT.sincos(torch.from_numpy(x))
    assert ts.dtype == tc.dtype == torch.float64
    for got, want in ((ts.numpy(), np.asarray(s)), (tc.numpy(),
                                                    np.asarray(c))):
        assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
    # and the accuracy the JAX module promises, against numpy's libm
    assert np.abs(ts.numpy() - np.sin(x)).max() < 5e-16 * max(1, spread
                                                               / 1e3)
    np.testing.assert_array_equal(TT.sin(torch.from_numpy(x)), ts)
    np.testing.assert_array_equal(TT.cos(torch.from_numpy(x)), tc)


def test_zero_d_argument():
    for a in ARGS:
        s, c = TT.sincos(torch.tensor(a, dtype=torch.float64))
        assert s.shape == () and abs(float(s) - np.sin(a)) < 5e-16
        assert abs(float(c) - np.cos(a)) < 5e-16


def test_grad_matches_jax():
    x = torch.tensor([0.7, -2.0, 40.0], dtype=torch.float64,
                     requires_grad=True)
    TT.sin(x).sum().backward()
    want = jax.grad(lambda v: JT.sin(v).sum())(jnp.asarray(x.detach()
                                                           .numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(x.grad.numpy(), np.cos([0.7, -2.0, 40.0]),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_other_dtypes_pass_through(dtype):
    x = torch.tensor([1.87, -0.4], dtype=dtype)
    s, c = TT.sincos(x)
    assert s.dtype == c.dtype == dtype
    assert torch.equal(s, torch.sin(x)) and torch.equal(c, torch.cos(x))

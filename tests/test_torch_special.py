"""The port's special math (``d3d_tpu_torch.ops.special``) against
``d3d_tpu.ops.special``: ``i0e``/``i1e`` (``torch.special`` against
``jax.scipy.special``) within 1e-12 relative in float64 and 4 ulp in
float32, their gradients, the numpy/tensor conventions and the numpy
helpers, equal.

Float32: both libraries sum a Chebyshev series in float32, each up to ~10
ulp from the float64 value (measured over 100 000 normal(0, 10) samples),
and they differ from each other by up to 4 ulp (``i0e``; 2 for ``i1e``):
the bound is that measured difference."""

import numpy as np
import pytest

import _limits  # noqa: F401  (one torch thread a process)

import jax
import jax.numpy as jnp
import torch

from d3d_tpu.ops import special as JS

from d3d_tpu_torch.ops import special as TS


def _ulps_apart(a, b):
    """How many float32 values lie between a and b, plus one (0: equal;
    +0 and -0 count as equal)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("name", ["i0e", "i1e"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bessel_matches_jax(rng, name, dtype):
    x = np.concatenate([[0.0, -0.0, 1e-8, -3.0, 7.5, 700.0, -1e4],
                        rng.normal(0, 10, 500)]).astype(dtype)
    want = np.asarray(getattr(JS, name)(x))
    got = getattr(TS, name)(x, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype == dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        assert np.all(_ulps_apart(got, want) <= 4)


def test_bessel_gradients_match_jax():
    x = np.array([-4.0, -0.3, 0.2, 1.0, 9.0])
    for name in ("i0e", "i1e"):
        t = torch.from_numpy(x).requires_grad_()
        getattr(TS, name)(t).sum().backward()
        want = jax.grad(lambda v: getattr(JS, name)(v).sum())(
            jnp.asarray(x))
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-15)


def test_conventions():
    """Tensors stay tensors on their device; numpy and scalars come back
    as numpy, computed on CUDA unless asked for the CPU."""
    t = torch.tensor([0.5, 2.0], dtype=torch.float64)
    assert isinstance(TS.i0e(t), torch.Tensor)
    out = TS.i1e(1.5, device="cpu")
    assert isinstance(out, np.ndarray) and out.shape == ()
    np.testing.assert_allclose(out, np.asarray(JS.i1e(1.5)), rtol=1e-12)
    assert np.asarray(TS.i0e(np.array([1, 2]), device="cpu")).dtype == \
        np.float64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TS.i0e(np.array([1.0]))


def test_helpers_match_jax(rng):
    assert TS.wmean(1.0, 0, 5.0, 2.0) == JS.wmean(1.0, 0, 5.0, 2.0) == 5.0
    assert TS.wmean(np.nan, 3.0, 5.0, 0) is not None
    assert TS.wmean(2.0, 1.0, 5.0, 2.0) == JS.wmean(2.0, 1.0, 5.0, 2.0)
    p1, p2 = rng.random((10, 3)), rng.random((10, 3))
    np.testing.assert_array_equal(TS.diffnorm3(p1, p2), JS.diffnorm3(p1, p2))
    q1, q2 = rng.normal(size=(10, 4)), rng.normal(size=(10, 4))
    q1 /= np.linalg.norm(q1, axis=1, keepdims=True)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    np.testing.assert_array_equal(TS.quatdiff(q1, q2), JS.quatdiff(q1, q2))

"""Precise float64 sin/cos (port of ``d3d_tpu.ops.trig``).

Float64 takes an explicit Cody-Waite range reduction and Taylor
polynomials in the JAX module's operation order, so float64 box corners
agree with it to about an ulp whatever the device's libm does. Other
dtypes take ``torch.sin``/``torch.cos``.
"""

import math

import torch

__all__ = ["sincos", "sin", "cos"]

# pi/2 split with a 33-bit head so k * _PI2_1 is exact for |k| < 2^20
# (fdlibm-style Cody-Waite constants)
_PI2_1 = 1.57079632673412561417e00
_PI2_1T = 6.07710050650619224932e-11
_PI2_2T = 2.02226624879595063154e-21

# Taylor coefficients; remainder at |x| <= pi/4 is < 1.1e-19 for sin
# (x^19/19!) and < 1.3e-18 for cos (x^18/18!)
_SIN_C = [
    -1.0 / 6,
    1.0 / 120,
    -1.0 / 5040,
    1.0 / 362880,
    -1.0 / 39916800,
    1.0 / 6227020800,
    -1.0 / 1307674368000,
    1.0 / 355687428096000,
]
_COS_C = [
    -1.0 / 2,
    1.0 / 24,
    -1.0 / 720,
    1.0 / 40320,
    -1.0 / 3628800,
    1.0 / 479001600,
    -1.0 / 87178291200,
    1.0 / 20922789888000,
    -1.0 / 6402373705728000,
]


def _poly_sin(x):
    x2 = x * x
    acc = torch.zeros_like(x)
    for c in reversed(_SIN_C):
        acc = (acc + c) * x2
    return x + x * acc


def _poly_cos(x):
    x2 = x * x
    acc = torch.zeros_like(x)
    for c in reversed(_COS_C[1:]):
        acc = (acc + c) * x2
    return 1.0 + x2 * (_COS_C[0] + acc)


def sincos(x):
    """Return (sin(x), cos(x)); float64 by range reduction, accurate to
    about an ulp for |x| < ~1e6."""
    if x.dtype != torch.float64:
        return torch.sin(x), torch.cos(x)
    k = torch.round(x * (2.0 / math.pi))
    # eager torch does not merge k * _PI2_1 + k * _PI2_1T into k * (pi/2),
    # the rewrite the JAX module keeps XLA from making
    r = x - k * _PI2_1
    r = r - k * _PI2_1T
    r = r - k * _PI2_2T
    s, c = _poly_sin(r), _poly_cos(r)
    q = (k.to(torch.int64) & 3)
    sin_x = torch.where(q == 0, s, torch.where(
        q == 1, c, torch.where(q == 2, -s, -c)))
    cos_x = torch.where(q == 0, c, torch.where(
        q == 1, -s, torch.where(q == 2, -c, s)))
    return sin_x, cos_x


def sin(x):
    return sincos(x)[0]


def cos(x):
    return sincos(x)[1]

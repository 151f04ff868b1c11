#
# XLA's float32 elementwise approximations, term for term, in torch.
#
# The JAX package's UMAP runs on XLA, whose CPU backend evaluates exp and
# erf_inv in float32 by fixed polynomials with fused multiply-adds.  A
# bisection that compares a sum of exps with a target, or a layout whose
# edge order and prune follow those weights, flips where a result differs
# by one ulp, so the port evaluates the same polynomials.  Each fused
# multiply-add runs in float64 and rounds once to float32: the product of
# two float32 is exact in float64, so the result is the fused one except
# where the float64 sum itself rounds a second time (not seen in 200,000
# checked arguments of exp).  The same code runs on the card, where IEEE
# float64 arithmetic gives the same bits.
#

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _c(value: float) -> float:
    """A float32 constant, as a float64 value."""
    return float(np.float32(value))


# Cephes's expf, as XLA's CPU backend emits it
_EXP_HI = _c(88.3762626647950)
_EXP_LO = _c(-88.3762626647949)
_LOG2E = _c(1.44269504088896341)
_EXP_C1 = _c(0.693359375)
_EXP_C2 = _c(-2.12194440e-4)
_EXP_P = tuple(_c(p) for p in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1,
))


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of a float32 tensor, bit for bit XLA's CPU float32 exp: range
    reduction by fx = floor(x log2 e + 1/2), the degree-5 Cephes polynomial
    in the remainder, then the power of two built in the exponent bits."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    xd = x.double()
    fx = torch.floor((xd * _LOG2E + 0.5).float())
    fxd = fx.double()
    r = (xd - fxd * _EXP_C1).float()
    r = (r.double() - fxd * _EXP_C2).float()
    rd = r.double()
    z = (r * r).double()
    y = (rd * _EXP_P[0] + _EXP_P[1]).float()
    for p in _EXP_P[2:]:
        y = (y.double() * rd + p).float()
    y = 1.0 + (y.double() * z + rd).float()
    pow2 = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return torch.maximum(y * pow2, x)


# Cephes's logf, as XLA's CPU backend emits it: the mantissa's polynomial
# coefficients in three interleaved Horner chains
_LOG_SQRTHF = _c(0.707106781186547524)
_LOG_P = tuple(_c(p) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1,
))
_LOG_Q1 = _c(-2.12194440e-4)
_LOG_Q2 = _c(0.693359375)
_TINY_F32 = float(np.finfo(np.float32).tiny)


@functools.lru_cache(maxsize=None)
def _log_chains(device: torch.device) -> tuple:
    """(a, b, c) of the three chains (r a + b) r + c, each a (3,) float64
    tensor on `device`."""
    return tuple(torch.tensor([_LOG_P[i + j] for i in (0, 3, 6)], dtype=torch.float64, device=device)
                 for j in range(3))


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """log of a float32 tensor, bit for bit XLA's CPU float32 log: the
    argument clamped up to the smallest normal, split into a mantissa m in
    [sqrt(1/2), sqrt(2)) and an exponent e, then (m - 1) through the
    degree-8 polynomial, plus e log 2 in two parts.  Read off the object
    code of a jitted jnp.log: every multiply-add of the polynomial is fused,
    the e * q1 product rounds on its own.  0 gives -inf, +inf gives +inf,
    a negative or NaN argument NaN.  XLA's CPU code reads a subnormal as
    zero, so a subnormal gives -inf here too."""
    normal = x >= _TINY_F32
    bits = torch.where(normal, x, _TINY_F32).view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    small = m < _LOG_SQRTHF
    r = (m - 1.0) + torch.where(small, m, 0.0)
    # the exponent, less one where the mantissa doubles: exact in float32
    e = ((bits >> 23) - 126 - small.int()).float()
    rd = r.double()
    r2 = r * r
    r3 = (r2 * r).double()
    # the three Horner chains side by side, one row each
    a, b, c = (t.view((3,) + (1,) * rd.dim()) for t in _log_chains(rd.device))
    y = (rd * a + b).float()
    y0, y1, y2 = (y.double() * rd + c).float().double()
    y = (y0 * r3 + y1).float().double()
    y = (y * r3 + y2).float().double()
    y = (y * r3 + (e * _LOG_Q1).double()).float()
    out = (rd - 0.5 * r2.double()).float() + y
    out = (e.double() * _LOG_Q2 + out.double()).float()
    out = torch.where(normal, out, torch.where(x.abs() < _TINY_F32, -math.inf, math.nan))
    return torch.where(x == math.inf, math.inf, out)


# XLA's float32 ErfInv (Giles, "Approximating the erfinv function"): the
# coefficients of its w < 5 and w >= 5 polynomials, highest degree first
_ERFINV_SMALL = (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
)
_ERFINV_LARGE = (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv polynomial, each Horner step fused.  log1p and
    sqrt are torch's, so results may differ from XLA's by a few ulps."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = None
    for s, g in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        c = torch.where(small, _c(s), _c(g)).double()
        p = c if p is None else (c + p * w).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) else float(x)


def fma_f32(a, b, c) -> torch.Tensor:
    """a * b + c (float32 tensors or float32-exact numbers) rounded once,
    as XLA's fused multiply-add."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def pow_f32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x ** y in float32 through float64: the correctly rounded power in
    all but rare cases, where XLA's CPU powf agrees to an ulp."""
    return (x.double() ** y.double()).float()


_REDUCE_WINDOW = 32


def sum_dim0(v: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 in XLA's CPU order: up to 32 rows added in turn; a
    longer axis padded with zeros to a multiple of 32, half the padding in
    front, each window of 32 added in turn, and the window sums reduced the
    same way."""
    n = v.shape[0]
    if n <= _REDUCE_WINDOW:
        out = v[0].clone()
        for i in range(1, n):
            out += v[i]
        return out
    n_pad = -(-n // _REDUCE_WINDOW) * _REDUCE_WINDOW
    low = (n_pad - n) // 2
    padded = v.new_zeros((n_pad,) + tuple(v.shape[1:]))
    padded[low : low + n] = v
    windows = padded.view((n_pad // _REDUCE_WINDOW, _REDUCE_WINDOW) + tuple(v.shape[1:]))
    acc = windows[:, 0].clone()
    for i in range(1, _REDUCE_WINDOW):
        acc += windows[:, i]
    return sum_dim0(acc)

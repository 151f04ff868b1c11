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

#
# Counter-based threefry random draws, bit for bit those of jax.random.
#
# The port's copy of the parts of jax.random that the UMAP path draws from,
# with JAX's defaults of the version the JAX package runs on:
# jax_default_prng_impl = "threefry2x32" and jax_threefry_partitionable =
# True.  A key is an int64 tensor (..., 2) holding the two uint32 words; a
# leading batch shape draws for many keys in one call (the layout draws
# every epoch's keys and negative tables at once).  Every function runs on
# the device of the tensors it is given and none uses a torch.Generator.
#
#   threefry_2x32(key, counts)  compat.threefry_2x32: halves the flat count
#                               array and hashes the pairs (count[i],
#                               count[i + half]), an odd count padded by one 0
#   prng_key(seed)              jax.random.PRNGKey: [seed >> 32, seed & M]
#   fold_in(key, data)          hash (0, data) under key
#   split(key, num)             hash (0, i) under key for i < num
#   random_bits(key, shape)     hash (i >> 32, i & M) of the row-major flat
#                               index i, the two output words xor-ed
#   uniform / randint / normal  jax.random's transforms of those bits
#   uniform_at(key, idx)        uniform's draws at chosen flat positions
#
# The words are carried in int64 tensors masked to 32 bits: torch's uint32
# lacks arithmetic on CUDA, and int64 holds every sum and shift of the hash
# without overflow.  normal() applies XLA's float32 erf_inv polynomial
# (ops/xla_math.py), so it agrees with jax.random.normal to a few ulps:
# log1p and sqrt may round apart.  Everything else is exact.
#

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .xla_math import erfinv_f32

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _hash(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry-2x32 block function on int64 words in
    [0, 2^32); key and count words broadcast together."""
    shape = torch.broadcast_shapes(k0.shape, k1.shape, x0.shape, x1.shape)
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(_M32).expand(shape).contiguous()
    x1 = (x1 + ks[1]).bitwise_and_(_M32).expand(shape).contiguous()
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            x1.bitwise_left_shift_(r).bitwise_and_(_M32).bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M32)
    return x0, x1


def _key_words(key: torch.Tensor, extra_dims: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two words of a (..., 2) key, with `extra_dims` trailing unit
    dims to broadcast against a draw's shape."""
    k0, k1 = key[..., 0], key[..., 1]
    for _ in range(extra_dims):
        k0, k1 = k0.unsqueeze(-1), k1.unsqueeze(-1)
    return k0, k1


def threefry_2x32(key: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Raw counter-mode threefry (compat.threefry_2x32): the (2,) key hashes
    the flat counts as pairs (count[i], count[i + half]) of its two halves,
    an odd count padded by one zero; out[i] is word 0 of pair i for the
    first half, word 1 of pair i - half for the second."""
    flat = counts.reshape(-1).to(torch.int64)
    n = flat.numel()
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.numel() // 2
    k0, k1 = _key_words(key.to(flat.device), 0)
    o0, o1 = _hash(k0, k1, flat[:half], flat[half:])
    return torch.cat([o0, o1])[:n].reshape(counts.shape)


def prng_key(seed: int, device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2^64: the (2,) key
    [seed >> 32, seed & 0xFFFFFFFF]."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} is outside [0, 2^64)")
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64, device=device)


def _as_words(data: IntLike, device: torch.device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.int64).bitwise_and(_M32)
    return torch.tensor(int(data) & _M32, dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """jax.random.fold_in: data (an int, or an int tensor broadcast against
    the key's batch shape) as a uint32 hashed under the key.  Returns keys
    (*batch, 2)."""
    d = _as_words(data, key.device)
    k0, k1 = _key_words(key, 0)
    o0, o1 = _hash(k0, k1, torch.zeros_like(d), d)
    return torch.stack([o0, o1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (partitionable threefry): keys (*batch, num, 2)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    k0, k1 = _key_words(key, 1)
    o0, o1 = _hash(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack([o0, o1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.bits at 32 bits (partitionable threefry): int64 words in
    [0, 2^32) of shape (*batch, *shape)."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=key.device)
    k0, k1 = _key_words(key, 1)
    o0, o1 = _hash(k0, k1, idx >> 32, idx & _M32)
    return (o0 ^ o1).reshape(key.shape[:-1] + shape)


def _float32(value: Union[float, torch.Tensor], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def _uniform_from_bits(bits: torch.Tensor, minval, maxval, device: torch.device) -> torch.Tensor:
    """jax.random.uniform's float32 transform of 32-bit words."""
    lo = _float32(minval, device)
    hi = _float32(maxval, device)
    # the mantissa trick: the top 23 bits as the mantissa of a float32 in
    # [1, 2), minus 1
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    fused = (floats.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def uniform(
    key: torch.Tensor,
    shape: Sequence[int],
    minval: Union[float, torch.Tensor] = 0.0,
    maxval: Union[float, torch.Tensor] = 1.0,
) -> torch.Tensor:
    """jax.random.uniform in float32: floats * (maxval - minval) + minval,
    then max(minval, .).  XLA contracts the product and the sum into one
    fused multiply-add, rounded once; here they run in float64 and round
    once to float32, the same value whenever the exact result fits 53 bits
    (it does for the package's bounds: [0, 1), [-10, 10) and normal()'s)."""
    return _uniform_from_bits(random_bits(key, shape), minval, maxval, key.device)


def uniform_at(key: torch.Tensor, flat_index: torch.Tensor) -> torch.Tensor:
    """uniform(key, shape) in [0, 1) at the row-major flat positions
    `flat_index` of shape (any shape, int64) only: the draws of the rows a
    caller needs of a large draw, bit for bit.  One key (2,)."""
    idx = flat_index.to(device=key.device, dtype=torch.int64)
    k0, k1 = _key_words(key, idx.dim())
    o0, o1 = _hash(k0, k1, idx >> 32, idx & _M32)
    return _uniform_from_bits(o0 ^ o1, 0.0, 1.0, key.device)


def randint(key: torch.Tensor, shape: Sequence[int], minval: IntLike, maxval: IntLike) -> torch.Tensor:
    """jax.random.randint in int32 (returned as int64): two bit draws from
    split(key), reduced mod span with the multiplier ((2^16 mod span)^2
    mod 2^32) mod span, every product and sum wrapping as uint32 does.  maxval may be a tensor (a
    traced maxval in the JAX package); span 1 where maxval <= minval.  Both
    bounds must lie in int32."""
    k1, k2 = split(key).unbind(-2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    dev = key.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=dev)
    span = torch.where(hi <= lo, torch.ones_like(hi), (hi - lo) & _M32)
    # uint32 products wrap: (2^16 mod span)^2 is 2^32 -> 0 for span > 2^16
    mult = torch.remainder(torch.full_like(span, 1 << 16), span)
    mult = torch.remainder((mult * mult) & _M32, span)
    # span < 2^31, so (higher % span) * mult < 2^62: no int64 overflow
    offset = (torch.remainder(higher, span) * mult + torch.remainder(lower, span)) & _M32
    offset = torch.remainder(offset, span)
    out = (lo + offset) & _M32
    return torch.where(out >= 1 << 31, out - (1 << 32), out)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2_F32 = float(np.float32(np.sqrt(2)))


def normal(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.normal in float32: sqrt(2) * erf_inv(uniform(key, shape,
    nextafter(-1, 0), 1))."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _float32(_SQRT2_F32, key.device) * erfinv_f32(u)

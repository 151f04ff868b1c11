#
# Counter-based threefry random draws, bit for bit those of jax.random.
#
# The port's copy of the parts of jax.random that the port draws from (the
# UMAP path, the forests' feature subsets and Poisson bootstrap, the KMeans
# inits' Gumbel noise), with JAX's defaults of the version the JAX package
# runs on:
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
#   gumbel / gumbel_at          jax.random.gumbel's default ("low") mode:
#                               -log(-log(uniform(key, shape, tiny, 1)))
#   poisson / poisson_at        jax.random.poisson for lam < 10 (Knuth's
#                               loop, one key split and one uniform an
#                               iteration), in chunks of the flat index
#   split_chain(key, n)         the subkeys of n turns of `key, sub =
#                               split(key)`, hashed on the host
#
# The words are carried in int64 tensors masked to 32 bits: torch's uint32
# lacks arithmetic on CUDA, and int64 holds every sum and shift of the hash
# without overflow.  normal() applies XLA's float32 erf_inv polynomial
# (ops/xla_math.py), so it agrees with jax.random.normal to a few ulps:
# log1p and sqrt may round apart.  gumbel and poisson take XLA's float32
# log (xla_math.log_f32) and are exact in float32; a float64 Gumbel draw
# (the JAX package's x64 fits) takes the 64-bit words exactly and torch's
# float64 log, which may round a last bit apart from the CPU's libm.
# Everything else is exact.
#

from __future__ import annotations

import math
import sys
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .xla_math import erfinv_f32, log_f32

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _hash(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry-2x32 block function on int64 words in
    [0, 2^32); key and count words broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    # broadcast_tensors, not broadcast_shapes: the latter's first call
    # imports torch._refs (~1 s)
    x0, x1 = torch.broadcast_tensors((x0 + ks[0]).bitwise_and_(_M32), (x1 + ks[1]).bitwise_and_(_M32))
    x0, x1 = x0.contiguous(), x1.contiguous()
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
    o0, o1 = _words_at(key, torch.arange(math.prod(shape), dtype=torch.int64, device=key.device))
    return (o0 ^ o1).reshape(key.shape[:-1] + shape)


def _words_at(key: torch.Tensor, flat_index: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two hash words of the row-major flat positions `flat_index`
    under keys (*batch, 2): words (*batch, *flat_index.shape)."""
    idx = flat_index.to(device=key.device, dtype=torch.int64)
    k0, k1 = _key_words(key, idx.dim())
    return _hash(k0, k1, idx >> 32, idx & _M32)


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
    o0, o1 = _words_at(key, flat_index)
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


def _hash_host(key: Tuple[int, int], x0: int, x1: int) -> Tuple[int, int]:
    """_hash on Python ints: one block, for key chains on the host."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0, x1 = (x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def split_chain(key: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The subkeys (n, 2) of n turns of `key, sub = split(key)` and the key
    after them, hashed on the host (two words a key: a launch chain would
    cost more than the hash) and returned on the key's device."""
    words = tuple(int(v) for v in key.tolist())
    subs = []
    for _ in range(int(n)):
        words, sub = _hash_host(words, 0, 0), _hash_host(words, 0, 1)
        subs.append(sub)
    dev = key.device
    return (torch.tensor(subs, dtype=torch.int64, device=dev).reshape(-1, 2),
            torch.tensor(words, dtype=torch.int64, device=dev))


_TINY_F32 = float(np.finfo(np.float32).tiny)
_TINY_F64 = sys.float_info.min
_ONE_F64_BITS = 0x3FF0000000000000


def gumbel_at(key: torch.Tensor, flat_index: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """gumbel(key, shape, dtype) at the row-major flat positions
    `flat_index` only, under keys (*batch, 2): (*batch, *flat_index.shape).
    float32 draws the 32-bit words (o0 ^ o1); float64 the 64-bit words
    (o0 << 32 | o1), as jax.random does under x64."""
    o0, o1 = _words_at(key, flat_index)
    if dtype == torch.float32:
        u = _uniform_from_bits(o0 ^ o1, _TINY_F32, 1.0, key.device)
        return -log_f32(-log_f32(u))
    if dtype != torch.float64:
        raise ValueError(f"gumbel draws float32 or float64, not {dtype}")
    # the top 52 of the 64 bits as a mantissa in [1, 2), minus 1; then
    # max(tiny, floats * (1 - tiny) + tiny), which is floats, or tiny at 0
    floats = ((o0 << 20) | (o1 >> 12) | _ONE_F64_BITS).view(torch.float64) - 1.0
    u = torch.where(floats == 0.0, _TINY_F64, floats)
    return -torch.log(-torch.log(u))


def gumbel(key: torch.Tensor, shape: Sequence[int], dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """jax.random.gumbel (mode "low"): -log(-log(u)) of u = uniform(key,
    shape, tiny, 1) (*batch, *shape)."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    return gumbel_at(key, idx, dtype).reshape(key.shape[:-1] + shape)


# flat positions a Poisson chunk draws at once (~100 bytes of temporaries
# an element): on an H100 the (50, 1,001,472) bootstrap takes 0.43 s in
# chunks of 2^22, 0.22 s in chunks of 2^24 (2.5 GB at its peak) and 0.17 s
# in one (6.3 GB) (chip_smoke.py's draws phase)
POISSON_CHUNK = 1 << 24


def poisson_at(key: torch.Tensor, lam: float, flat_index: torch.Tensor) -> torch.Tensor:
    """poisson(key, lam, shape) (int32) at the row-major flat positions
    `flat_index` of the drawn shape.  One key (2,), 0 <= lam < 10.

    jax.random.poisson's Knuth loop: each turn splits the key once, draws
    one uniform of the whole shape, counts the elements whose float32 log
    product is still above -lam, then adds the uniform's log; the result
    is the count less one.  An element that has dropped to -lam never
    changes again, so the draw runs over POISSON_CHUNK positions at a time and
    each turn hashes only the positions still live; a chunk ends when none
    is.  The keys come from split_chain, extended as the turns need them."""
    lam = float(np.float32(lam))
    if not 0.0 <= lam < 10.0:
        raise ValueError(f"poisson draws lam in [0, 10) (Knuth's loop), not {lam}")
    dev = key.device
    idx_all = flat_index.to(device=dev, dtype=torch.int64).reshape(-1)
    out = torch.zeros(idx_all.shape[0], dtype=torch.int32, device=dev)
    if lam == 0.0 or idx_all.numel() == 0:
        return out.reshape(flat_index.shape)
    subs, rest = split_chain(key, 16)
    neg_lam = -lam
    for start in range(0, idx_all.shape[0], POISSON_CHUNK):
        idx = idx_all[start : start + POISSON_CHUNK]
        pos = torch.arange(start, start + idx.shape[0], dtype=torch.int64, device=dev)
        log_prod = torch.zeros(idx.shape[0], dtype=torch.float32, device=dev)
        turn = 0
        while idx.numel():
            if turn == subs.shape[0]:
                more, rest = split_chain(rest, subs.shape[0])
                subs = torch.cat([subs, more])
            out.index_add_(0, pos, torch.ones(1, dtype=torch.int32, device=dev).expand(pos.shape[0]))
            log_prod += log_f32(uniform_at(subs[turn], idx))
            live = (log_prod > neg_lam).nonzero().squeeze(1)
            idx, pos, log_prod = idx[live], pos[live], log_prod[live]
            turn += 1
    return (out - 1).reshape(flat_index.shape)


def poisson(key: torch.Tensor, lam: float, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.poisson(key, lam, shape) for 0 <= lam < 10, int32, bit
    for bit (partitionable threefry: an element's draws depend on its flat
    index, so a (T, N) draw depends on N)."""
    shape = tuple(int(s) for s in shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    return poisson_at(key, lam, idx).reshape(shape)

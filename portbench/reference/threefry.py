#
# Threefry-2x32 words of jax.random's partitionable counter mode, in plain
# PyTorch: the word at flat position i under a key is o0 ^ o1 of the
# 20-round block function of (i >> 32, i & 0xFFFFFFFF).  A frozen copy of
# the arithmetic (the published Threefry-2x32 with JAX's rotations), so the
# reference draws an init without the port's code.
#

from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def key(seed: int) -> Tuple[int, int]:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2^64."""
    return (int(seed) >> 32) & M32, int(seed) & M32


def block(k: Tuple[int, int], x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block function on int64 words in [0, 2^32)."""
    ks = (k[0], k[1], k[0] ^ k[1] ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def words(k: Tuple[int, int], index: torch.Tensor) -> torch.Tensor:
    """The 32-bit word at each flat position of `index` (int64)."""
    o0, o1 = block(k, index >> 32, index & M32)
    return o0 ^ o1

"""Counter-based random draws that reproduce jax.random bit for bit.

The JAX package keys every stochastic draw on the main path off
`jax.random` with the threefry2x32 generator (its default) under
`jax_threefry_partitionable=True` (its default since jax 0.5): the
stochastic rounding of the gradient levels (boosting._quantize:
`fold_in(key(data_random_seed), it * K + k)`, then quantize's
`split` + two `uniform` draws), the bagging and GOSS row draws
(sample_strategy) and the feature_fraction permutation. Each must land
on the same values or the trees diverge, so this module re-implements
those functions on torch tensors:

- `key(seed)`: the raw (2,) uint32 pair (seed >> 32, seed & 0xffffffff);
- `fold_in(key, data)`: threefry2x32(key, (0, data));
- `split(key, num)`: threefry2x32(key, (hi(i), lo(i))) for i < num;
- `uniform(key, shape)`: 23 random mantissa bits of
  threefry2x32(key, (hi(i), lo(i))) xor-folded, as a float in [1, 2),
  minus 1;
- `fold_in_many` / `uniform_many`: the same two functions over a batch
  of data words or keys (jax.vmap of them: the per-node draws of a
  round's children, grower.make_node_candidates);
- `permutation(key, n)`: jax's `_shuffle` of arange(n), a few rounds of
  a stable sort by fresh 32-bit keys (the per-tree feature_fraction
  mask, boosting._sample_features).

A key is a (2,) int64 tensor holding the two uint32 words. torch has
no full set of uint32 operations, so words live in int64 and are
masked back to 32 bits after every add and shift.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) on int64 tensors that
    hold uint32 words — jax's `_threefry2x32_lowering`, round for round."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key(seed: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """jax.random.key(seed) -> its (2,) key data, filled on `device` (no
    host-to-device copy, so a CUDA graph can capture it)."""
    s = int(seed)
    k = torch.full((2,), s & _MASK, dtype=torch.int64, device=device)
    k[:1].fill_((s >> 32) & _MASK if s >= 0 else 0)
    return k


def fold_in(k: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """jax.random.fold_in: hash the (2,) counter (0, data) under k. data is
    a host int or a 0-dim integer tensor on k's device (a device
    iteration counter); both give the same bits."""
    if isinstance(data, torch.Tensor):
        d = (data.to(torch.int64) & _MASK).reshape(1)
    else:
        d = torch.full((1,), int(data) & _MASK, dtype=torch.int64,
                       device=k.device)
    h1, h2 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return torch.cat([h1, h2])


def fold_in_many(k: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """fold_in(k, data[j]) for each j of an (n,) integer tensor, as one
    batch: (n, 2) keys (jax.vmap of fold_in over the data)."""
    d = data.to(torch.int64).reshape(-1) & _MASK
    h1, h2 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return torch.stack([h1, h2], dim=1)


def uniform_many(keys: torch.Tensor, n: int) -> torch.Tensor:
    """uniform(keys[j], (n,)) for each of (m, 2) keys, as one batch:
    (m, n) float32 on [0, 1) (jax.vmap of uniform over the keys)."""
    hi, lo = _counters(int(n), keys.device)
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], hi[None, :], lo[None, :])
    fbits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)


def _counters(n: int, device, offset: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) words of the uint64 iota offset..offset+n-1 (jax
    iota_2x32_shape from 0)."""
    i = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    return (i >> 32) & _MASK, i & _MASK


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split (partitionable) -> (num, 2) keys."""
    hi, lo = _counters(num, k.device)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([b1, b2], dim=1)


def random_bits(k: torch.Tensor, shape: Sequence[int],
                offset: int = 0) -> torch.Tensor:
    """32 random bits per element (partitionable), int64 in [0, 2^32).
    offset: the flat position of the first element in a longer stream
    (a data-parallel rank's slice of the rows: element i of the stream
    depends on i alone)."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    hi, lo = _counters(n, k.device, int(offset))
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(k: torch.Tensor, shape: Sequence[int],
            offset: int = 0) -> torch.Tensor:
    """jax.random.uniform(k, shape) for float32 on [0, 1) (offset: as
    random_bits')."""
    bits = random_bits(k, shape, offset)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)


def permutation(k: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.permutation(k, n) (jax 0.9's _shuffle of arange(n)):
    ceil(3 ln n / ln(2^32 - 1)) rounds, each splitting the key, drawing
    32-bit sort keys from the second half and sorting the values by them
    stably (lax.sort_key_val is stable). int64 values on k's device."""
    n = int(n)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(random_bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x

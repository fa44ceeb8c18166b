"""Counter-based keys: the port's copy of the ``jax.random`` calls on the
training and sampling paths.

Keys are threefry2x32 keys, as ``jax.random.PRNGKey`` makes them with
``jax_threefry_partitionable=True`` (the default of the JAX versions the
package is tested against): a ``(..., 2)`` tensor of 32-bit words. The
words are held in int64 tensors on the CPU and masked to 32 bits after every
add, shift and multiply, so the bits are those of ``jax.random`` exactly.
The dropout sites and the flash kernels read their seeds from these keys;
the work is a few keys per training step, done on the host. Sampling draws
its Gumbel noise from a key on the logits' device (:func:`categorical`).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & MASK32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 32-bit x and a 32-bit constant c, without
    overflowing int64: c is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 block cipher (20 rounds) of JAX's
    ``prng._threefry2x32_lowering``: keys and counters broadcast together."""
    k1, k2, x1, x2 = (_u32(t) for t in (k1, k2, x1, x2))
    ks = [k1, k2, k1 ^ k2 ^ 0x1BD11BDA]
    x = [(x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK32
    return x[0], x[1]


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit): threefry of the
    row-major counter of each element, the two output words XORed
    (``prng._threefry_random_bits_partitionable``); int64 in [0, 2^32)."""
    n = 1
    for d in shape:
        n *= d
    count = torch.arange(n, dtype=torch.int64, device=device)
    k = _u32(key)
    b1, b2 = threefry2x32(k[0], k[1], count >> 32, count & MASK32)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32: the top 23 bits of
    :func:`random_bits` as a float in [1, 2), less 1."""
    bits = random_bits(key, shape, device)
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p, shape, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: :func:`uniform` below p,
    taken as f32."""
    return uniform(key, shape, device) < torch.tensor(p, dtype=torch.float32)


def gumbel(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in f32 (its "low" mode):
    :func:`uniform` floored at the smallest normal, then -log(-log(u))."""
    f = uniform(key, shape, device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp_min(f + tiny, tiny)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the Gumbel-max
    draw over the last axis (f32 logits)."""
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g + logits.float(), dim=-1)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (JAX's default):
    the seed is taken as a 32-bit integer, so the key is (0, seed mod 2^32)."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def split(key: torch.Tensor, num: Union[int, Sequence[int]] = 2
          ) -> torch.Tensor:
    """``jax.random.split(key, num)``; num may be a shape. Returns
    ``(*shape, 2)``: key n (row-major) is threefry of the 64-bit counter n."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    n = 1
    for d in shape:
        n *= d
    count = torch.arange(n, dtype=torch.int64)
    k = _u32(key)
    b1, b2 = threefry2x32(k[0], k[1], count >> 32, count & MASK32)
    return torch.stack([b1, b2], dim=-1).reshape(*shape, 2)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit ``data``."""
    k = _u32(key)
    b1, b2 = threefry2x32(k[0], k[1], torch.zeros((), dtype=torch.int64),
                          _u32(int(data)))
    return torch.stack([b1, b2])


def key_data(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.key_data``: the raw words (keys are raw already)."""
    return _u32(key)


def seed_words(key: torch.Tensor) -> tuple:
    """The two uint32 seed words a dropout site reads from its key
    (``key_data(key).astype(uint32).reshape(-1)[:2]``), as Python ints."""
    w = key_data(key).reshape(-1)[:2].tolist()
    return int(w[0]), int(w[1])

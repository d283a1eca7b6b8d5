"""Threefry-2x32 keys (counterpart of ``jax.random``'s default
implementation, which the JAX package uses everywhere).

A key is two uint32 words held on the host as a CPU ``int64`` tensor of
shape ``(2,)``; :func:`split` gives ``(n, 2)``, whose rows are keys.
Deriving a key never touches the card: the words are computed with Python
integers masked to 32 bits.  The kernels take the words as scalar
arguments, and :func:`key_words` gives them as two Python ints.

``split`` is the *partitionable* variant (``jax_threefry_partitionable``,
on by default since JAX 0.5): key ``i`` of ``split(k, n)`` is
``threefry2x32(k, (0, i))``, the same as ``fold_in(k, i)``.

The same hash runs on tensors of any device (:func:`threefry2x32_tensor`):
:func:`random_bits` draws ``jax.random.bits`` from a key or a batch of
keys, and :func:`fold_in_tensor` derives a batch of keys on the device.
Tensors hold uint32 values in ``int64``, masked to 32 bits after every
add and every left shift.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["key", "fold_in", "split", "key_data", "key_words",
           "threefry2x32", "threefry2x32_tensor", "random_bits",
           "fold_in_tensor"]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: int, x1: int) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of the counter pair ``(x0,
    x1)`` under key ``(k0, k1)``, all uint32 as Python ints."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _as_key(words) -> torch.Tensor:
    return torch.tensor([int(w) & _M32 for w in words], dtype=torch.int64)


def key_words(k) -> tuple:
    """The two words of a key (a tensor, array or sequence of two uint32
    values) as Python ints."""
    w = k.tolist() if hasattr(k, "tolist") else list(k)
    if len(w) != 2 or isinstance(w[0], list):
        raise ValueError(f"a key is two uint32 words, got {w!r}")
    return int(w[0]) & _M32, int(w[1]) & _M32


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)`` under JAX's default, where 64-bit types
    are off: the seed becomes a 32-bit integer, so word 0 is 0 and word 1
    is the seed's low 32 bits (a negative seed's two's-complement low
    word; ``2**32 + 5`` gives ``[0, 5]``)."""
    return _as_key((0, int(seed) & _M32))


def fold_in(k, data) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the counter ``(0, data)``.  A
    Python int outside ``[0, 2**32)`` raises ``OverflowError``, as the
    reference does; other integer types wrap to their low 32 bits."""
    if isinstance(data, int) and not 0 <= data <= _M32:
        raise OverflowError(f"Python integer {data} out of bounds for "
                            f"uint32")
    return _as_key(threefry2x32(*key_words(k), 0, int(data) & _M32))


def split(k, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable): ``(num, 2)`` keys, row ``i``
    the threefry of the counter ``(0, i)``."""
    k0, k1 = key_words(k)
    return torch.tensor([threefry2x32(k0, k1, 0, i) for i in range(num)],
                        dtype=torch.int64).reshape(num, 2)


def key_data(k) -> torch.Tensor:
    """The raw words of a key or a stack of keys as a CPU ``int64``
    tensor (``jax.random.key_data``); takes the port's tensors and numpy
    arrays of uint32 words alike."""
    if isinstance(k, torch.Tensor):
        return k.to(device="cpu", dtype=torch.int64) & _M32
    return torch.from_numpy(np.asarray(k, dtype=np.uint32).astype(np.int64))


def _rotl_tensor(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32_tensor(k0, k1, x0, x1) -> tuple:
    """:func:`threefry2x32` elementwise on ``int64`` tensors holding uint32
    values (any device; the key words may be tensors or Python ints, and
    all four broadcast), so a batch of keys hashes in one pass."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl_tensor(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _key_tensor(keys) -> torch.Tensor:
    keys = keys if isinstance(keys, torch.Tensor) else key_data(keys)
    if keys.shape[-1:] != (2,) or keys.dim() not in (1, 2):
        raise ValueError(f"keys must be one key (2,) or a batch (n, 2), "
                         f"got {tuple(keys.shape)}")
    return keys.to(torch.int64) & _M32


def random_bits(keys, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) on the keys' device as
    ``int64`` values in ``[0, 2**32)``: JAX's partitionable path, where
    element ``i`` of the flattened shape is ``x0 ^ x1`` of the threefry
    of the counter ``(i >> 32, i & 0xFFFFFFFF)``.  ``keys`` is one key
    ``(2,)``, giving ``shape``, or a batch ``(n, 2)``, giving ``(n,
    *shape)`` with row ``r`` drawn from key ``r``."""
    keys = _key_tensor(keys)
    shape = tuple(int(d) for d in shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=keys.device)
    k = keys.reshape(-1, 2)
    x0, x1 = threefry2x32_tensor(k[:, :1], k[:, 1:], i >> 32, i & _M32)
    bits = x0 ^ x1
    return bits.reshape(shape if keys.dim() == 1 else (k.shape[0], *shape))


def fold_in_tensor(keys, data) -> torch.Tensor:
    """``jax.vmap(jax.random.fold_in)(keys, data)`` on the keys' device:
    keys ``(n, 2)`` (or one key ``(2,)``, shared by every row), data
    ``(n,)`` of any integer type, cast to uint32 as ``fold_in`` casts it
    (a negative int32 becomes its two's complement).  Returns ``(n, 2)``
    keys."""
    keys = _key_tensor(keys)
    data = torch.as_tensor(data, device=keys.device).to(torch.int64) & _M32
    k = keys.reshape(-1, 2)
    x0, x1 = threefry2x32_tensor(k[:, 0], k[:, 1], torch.zeros_like(data),
                                 data)
    return torch.stack([x0, x1], dim=-1)

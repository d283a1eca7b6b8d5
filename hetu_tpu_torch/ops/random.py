"""Random sampling ops (counterpart of ``hetu_tpu/ops/random.py``).

Every draw is ``jax.random``'s, from the same threefry2x32 key: the bits
come from :func:`hetu_tpu_torch.core.prng.random_bits` (JAX's
partitionable path) and each private building block below follows JAX
0.9's own definition, step for step.  The bits, the uniform and
``randint`` are bitwise JAX's; the Gumbel field and the normals go
through ``torch.log`` / ``torch.erfinv``, which differ from XLA's by an
ulp or so, and are equal to JAX's within a stated tolerance (the tests
hold them to it), the tokens drawn from them equal on the tested seeds.

A key is a ``(2,)`` tensor of uint32 words in ``int64``, as
:mod:`hetu_tpu_torch.core.prng` makes it; ``key=None`` draws
``core.rng.next_key()``.  The draws (``rand`` to ``randint_sample``) run
on ``device``, which ``None`` makes the card (``core.device``; pass
``device="cpu"`` for the CPU), and the key is moved there; the token
samplers draw on their logits' device.  The private blocks draw on their
keys' device, and also take a batch of keys ``(n, 2)``: row ``r`` of the
result is then drawn from key ``r`` alone, as ``jax.vmap`` over the keys
gives it.
"""

from __future__ import annotations

import math

import torch

from hetu_tpu_torch.core.device import resolve_device
from hetu_tpu_torch.core.prng import fold_in_tensor, key_data, random_bits
from hetu_tpu_torch.core.rng import next_key

__all__ = [
    "rand", "normal_sample", "uniform_sample", "truncated_normal_sample",
    "gumbel_sample", "randint_sample",
    "greedy_sample", "temperature_sample", "top_k_sample",
]

# float type -> (bits, mantissa bits, the bits of 1.0, integer type of
# the same width for the bitcast)
_FLOATS = {
    torch.float32: (32, 23, 0x3F800000, torch.int32),
    torch.bfloat16: (16, 7, 0x3F80, torch.int16),
    torch.float16: (16, 10, 0x3C00, torch.int16),
}
_INTS = (torch.int8, torch.uint8, torch.int16, torch.int32)
_M32 = 0xFFFFFFFF
_SQRT2 = math.sqrt(2)


def _key(key, device):
    """``key`` (or ``next_key()`` when None) on the resolved ``device``;
    a device that cannot be had raises before a key is drawn."""
    dev = resolve_device(device)
    k = next_key() if key is None else key
    return (k if isinstance(k, torch.Tensor) else key_data(k)).to(dev)


def _as_dtype(x: float, dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float (exact)."""
    return float(torch.tensor(x, dtype=torch.float64).to(dtype))


def _check_float(name, dtype):
    if dtype not in _FLOATS:
        raise TypeError(f"{name} draws float32, bfloat16 or float16, got "
                        f"{dtype}")


# -- JAX's building blocks ------------------------------------------------


def _uniform(keys, shape, dtype, minval, maxval):
    """``jax._src.random._uniform``: the top mantissa bits under the
    exponent of 1.0, bitcast, minus 1, then ``* (max - min)`` and ``+
    min`` as two operations, each rounded, and the max with ``min``.  A
    type with fewer than 8 mantissa bits takes 8 random bits, as JAX
    does.  (XLA's CPU backend at its default optimisation level fuses
    that multiply and add into one fma, rounded once; that moves low
    bits only where ``max - min`` is not a power of 2 and ``min`` is not
    0, so never in ``rand``, the Gumbel field or the normal.)"""
    _check_float("uniform", dtype)
    nbits, nmant, one, itype = _FLOATS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    lo, hi = (torch.tensor(float(x), dtype=dtype) for x in (minval, maxval))
    span, lo = float(hi - lo), float(lo)
    bits = random_bits(keys, shape) & ((1 << rng_bits) - 1)
    fbits = (bits >> (rng_bits - nmant)) | one
    floats = fbits.to(itype).view(dtype) - 1.0
    return torch.clamp_min(floats * span + lo, lo)


def _gumbel(keys, shape, dtype=torch.float32):
    """``jax._src.random._gumbel`` in its default "low" mode:
    ``-log(-log(uniform(tiny, 1)))``."""
    u = _uniform(keys, shape, dtype, torch.finfo(dtype).tiny, 1.0)
    return -torch.log(-torch.log(u))


def _categorical(keys, logits):
    """``jax.random.categorical``: the argmax of ``gumbel + logits`` over
    the last axis, in ``greedy_sample``'s order.  One key draws a field of
    ``logits.shape``; a batch of keys ``(n, 2)`` draws row ``r`` of
    ``(n, V)`` logits from key ``r``."""
    keys = torch.as_tensor(keys).to(logits.device)
    shape = logits.shape[1:] if keys.dim() == 2 else logits.shape
    return greedy_sample(_gumbel(keys, shape, logits.dtype) + logits)


def _top_k(x, k: int):
    """The ``k`` largest entries of each row and their indices (int32),
    ``lax.top_k``'s order: every NaN first, values descending, equal
    values smallest index first (a stable descending sort; -0.0 equals
    +0.0 here, where ``lax.top_k`` puts +0.0 first)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return (vals[..., :k].contiguous(),
            idx[..., :k].to(torch.int32).contiguous())


# -- the reference's ops --------------------------------------------------


def rand(shape, dtype=torch.float32, key=None, device=None):
    """U[0, 1) samples (reference rand_op)."""
    return _uniform(_key(key, device), shape, dtype, 0.0, 1.0)


def normal_sample(shape, mean: float = 0.0, stddev: float = 1.0,
                  dtype=torch.float32, key=None, device=None):
    """``mean + stddev * jax.random.normal``: ``sqrt(2) * erfinv(u)`` of a
    uniform over ``(nextafter(-1, 0), 1)``."""
    _check_float("normal", dtype)
    lo = -(1.0 - torch.finfo(dtype).eps / 2)      # nextafter(-1, 0)
    u = _uniform(_key(key, device), shape, dtype, lo, 1.0)
    return mean + stddev * (_as_dtype(_SQRT2, dtype) * torch.erfinv(u))


def uniform_sample(shape, low: float = 0.0, high: float = 1.0,
                   dtype=torch.float32, key=None, device=None):
    return _uniform(_key(key, device), shape, dtype, low, high)


def truncated_normal_sample(shape, mean: float = 0.0, stddev: float = 1.0,
                            dtype=torch.float32, key=None, device=None):
    """Normal truncated to ±2σ (reference truncated_normal_sample_op):
    ``jax.random.truncated_normal(key, -2, 2)``, ``sqrt(2) * erfinv`` of a
    uniform between ``erf(∓2 / sqrt(2))``, clipped into the open
    interval."""
    _check_float("truncated_normal", dtype)
    sqrt2 = torch.tensor(_as_dtype(_SQRT2, dtype), dtype=dtype)
    a, b = (float(torch.erf(torch.tensor(x, dtype=dtype) / sqrt2))
            for x in (-2.0, 2.0))
    u = _uniform(_key(key, device), shape, dtype, a, b)
    out = float(sqrt2) * torch.erfinv(u)
    edge = 2.0 - torch.finfo(dtype).eps           # nextafter(2, 0)
    return mean + stddev * torch.clamp(out, -edge, edge)


def gumbel_sample(shape, dtype=torch.float32, key=None, device=None):
    """Standard Gumbel(0,1) samples (reference gumbel_sample_op; noisy MoE
    gates and Gumbel-softmax tricks)."""
    return _gumbel(_key(key, device), shape, dtype)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 values held in int64, taken in
    16-bit halves so that no ``int64`` product overflows."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def randint_sample(shape, low: int, high: int, dtype=torch.int32,
                   key=None, device=None):
    """``jax.random.randint``, bitwise: two 32-bit draws from the key's
    two split keys, combined modulo the span (biased a little unless the
    span is a power of 2, as JAX's is).  A narrower type is drawn as
    int32 between bounds clipped to it, then cast, as JAX does."""
    if dtype not in _INTS:
        raise TypeError(f"randint draws int8, uint8, int16 or int32, got "
                        f"{dtype}")
    low, high = int(low), int(high)
    info = torch.iinfo(dtype)
    if info.bits < 32:
        low = min(max(low, info.min), info.max)
        high = min(max(high, info.min), info.max + 1)
    i32 = torch.iinfo(torch.int32)
    lo = min(max(low, i32.min), i32.max)
    hi = min(max(high, i32.min), i32.max)
    span = (hi - lo) & _M32
    if hi <= lo:
        span = 1
    elif high > i32.max:             # the span is one larger; may wrap
        span = (span + 1) & _M32

    def rem(x, s):                    # XLA: an unsigned x rem 0 is x
        return x if s == 0 else x % s

    mult = rem(1 << 16, span)
    mult = rem((mult * mult) & _M32, span)
    keys = _key(key, device)
    k = fold_in_tensor(keys, torch.arange(2, device=keys.device))  # split
    high_bits, low_bits = (random_bits(kk, shape) for kk in k)
    offset = (_mul32(rem(high_bits, span), mult)
              + rem(low_bits, span)) & _M32
    val = (lo + rem(offset, span)) & _M32
    return torch.where(val > i32.max, val - (1 << 32), val).to(dtype)


# -- token-sampling helpers (the serving decode loop, serve/engine.py) ------
#
# All three take logits whose LAST axis is the vocabulary (leading axes are
# batch) and return int32 token ids with the last axis reduced away.  Every
# draw is a pure function of (logits, key): the serving engine derives one
# key per (request, position), so a token stream is reproducible bit for
# bit whatever requests were batched together.


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis as int32.  ``torch.argmax`` returns the
    first maximum, and the first NaN before any number: the same order
    as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(logits, temperature: float = 1.0, key=None):
    """Softmax sampling at ``temperature``; ``temperature <= 0`` collapses
    to :func:`greedy_sample` (the conventional T->0 limit)."""
    if temperature <= 0.0:
        return greedy_sample(logits)
    return _categorical(_key(key, logits.device), logits.float() / temperature)


def top_k_sample(logits, k: int, temperature: float = 1.0, key=None):
    """Sample among the ``k`` highest-scoring tokens at ``temperature``
    (temperature <= 0 -> greedy; ``k`` >= vocab -> plain temperature
    sampling over the full distribution, top_k being a no-op there)."""
    if temperature <= 0.0:
        return greedy_sample(logits)
    k = min(int(k), logits.shape[-1])
    vals, idx = _top_k(logits.float(), k)
    choice = _categorical(_key(key, logits.device), vals / temperature)
    return torch.gather(idx, -1, choice.long()[..., None])[..., 0]

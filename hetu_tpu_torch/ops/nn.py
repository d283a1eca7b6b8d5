"""Convolution, pooling, normalisation, dropout and softmax (counterpart
of ``hetu_tpu/ops/nn.py``).

The vision ops keep the JAX package's layouts at their API: activations
NHWC, convolution weights HWIO.  Inside, an NHWC tensor is handed to
torch as ``x.permute(0, 3, 1, 2)``, which for a contiguous NHWC tensor is
already a ``channels_last`` NCHW tensor (no copy); the result comes
back in that format, so permuted back it is NHWC again (cuDNN may
convert inside: in fp32 without TF32 it runs NCHW kernels).  Padding
follows ``lax``: ``"SAME"`` pads TF-style (an odd total puts the extra
row and column at the bottom and right), an int pads both sides, and a
sequence of ``(lo, hi)`` pairs is taken as it is.  The padded average pool divides
by the count of real elements; the max pool pads with ``-inf``.  An HWIO
weight goes to torch as its OIHW view ``w.permute(3, 2, 0, 1)``, which
``F.conv2d`` lays out for cuDNN on each call (and its gradient back),
so the layer ``layers.conv.Conv2d`` keeps the JAX layout and the weight
bridge copies its kernel as it is.  Precision is torch's: a float32 convolution
on the card runs in TF32 unless ``torch.backends.cudnn.allow_tf32`` is
False, a flag the port never sets.

Dropout's mask is the JAX package's counter hash, bit for bit: two
murmur3-finalizer rounds over the flat element index, folded with the
key's two words, kept where the bits fall under
:func:`dropout_keep_thresh`.  The uint32 arithmetic runs in ``int64``
masked to 32 bits, and each product by a 32-bit constant is taken in
16-bit halves so that no ``int64`` product overflows.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from hetu_tpu_torch.core.prng import key_data

__all__ = ["conv2d", "conv2d_transpose", "max_pool2d",
           "avg_pool2d", "batch_norm", "layer_norm", "instance_norm2d",
           "group_norm", "rms_norm", "dropout", "dropout_keep_thresh",
           "softmax", "log_softmax"]

_M32 = 0xFFFFFFFF
_MIX1, _MIX2 = 0x7FEB352D, 0x846CA68B


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _same_pads(size: int, k: int, s: int, d: int = 1) -> tuple:
    """``lax``'s ``"SAME"`` padding of one spatial dim: the output is
    ``ceil(size / s)`` and the odd row goes at the end."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _pads(padding, hw, window, stride, dilation=(1, 1)) -> tuple:
    """``((top, bottom), (left, right))`` for ``"SAME"``, ``"VALID"``, an
    int, or ``(lo, hi)`` pairs: two (H, W), or four (N, H, W, C, the
    pools' ``lax`` form; N and C are not padded)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0), (0, 0)
        if padding.upper() == "SAME":
            return tuple(_same_pads(n, k, s, d) for n, k, s, d in
                         zip(hw, window, stride, dilation))
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    pairs = tuple(tuple(p) for p in padding)
    return pairs[1:3] if len(pairs) == 4 else pairs


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def conv2d(x, w, stride=1, padding="SAME", dilation=1, groups: int = 1,
           precision=None):
    """2-D convolution, NHWC activations, HWIO weights, as the JAX
    package's ``conv2d``; the NHWC result.  A symmetric padding goes to
    ``F.conv2d``, an uneven one is padded explicitly
    (``F.conv2d(padding="same")`` refuses a stride above 1).
    ``precision`` is accepted for the reference's signature and has no
    effect, as in :func:`~hetu_tpu_torch.ops.math.matmul`."""
    stride, dilation = _pair(stride), _pair(dilation)
    (pt, pb), (pl, pr) = _pads(padding, x.shape[1:3], w.shape[:2], stride,
                               dilation)
    xc = _nchw(x)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xc, pad = F.pad(xc, (pl, pr, pt, pb)), 0
    return _nhwc(F.conv2d(xc, w.permute(3, 2, 0, 1), None, stride, pad,
                          dilation, groups))


def _transpose_pads(k: int, s: int, padding: str) -> tuple:
    """``lax.conv_transpose``'s padding of the stride-dilated input."""
    if padding == "SAME":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else -(-total // 2)
    elif padding == "VALID":
        total = k + s - 2 + max(k - s, 0)
        lo = k - 1
    else:
        raise ValueError(f"unknown padding {padding!r}")
    return lo, total - lo


def conv2d_transpose(x, w, stride=1, padding="SAME", precision=None):
    """``lax.conv_transpose`` with NHWC / HWIO and an unflipped kernel:
    the input dilated by ``stride`` (zeros between its pixels), padded,
    and convolved at stride 1.  ``precision`` has no effect, as in
    :func:`conv2d`."""
    stride = _pair(stride)
    if isinstance(padding, int):
        pads = ((padding, padding), (padding, padding))
    elif isinstance(padding, str):
        pads = tuple(_transpose_pads(k, s, padding.upper())
                     for k, s in zip(w.shape[:2], stride))
    else:
        pads = tuple(tuple(p) for p in padding)
    n, h, wd, c = x.shape
    sh, sw = stride
    xd = x.new_zeros((n, (h - 1) * sh + 1, (wd - 1) * sw + 1, c))
    xd[:, ::sh, ::sw] = x
    return conv2d(xd, w, 1, pads)


def max_pool2d(x, window=2, stride=None, padding="VALID"):
    """Max pooling over NHWC; padding is ``-inf`` (the integer minimum
    for integer types)."""
    window = _pair(window)
    stride = _pair(stride) if stride is not None else window
    (pt, pb), (pl, pr) = _pads(padding, x.shape[1:3], window, stride)
    xc = _nchw(x)
    if pt == pb and pl == pr and 2 * pt <= window[0] and 2 * pl <= window[1]:
        return _nhwc(F.max_pool2d(xc, window, stride, (pt, pl)))
    low = (-math.inf if x.is_floating_point()
           else torch.iinfo(x.dtype).min)
    xc = F.pad(xc, (pl, pr, pt, pb), value=low)
    return _nhwc(F.max_pool2d(xc, window, stride))


def avg_pool2d(x, window=2, stride=None, padding="VALID"):
    """Average pooling over NHWC.  With padding, each output divides by
    the count of real elements in its window (``count_include_pad=False``,
    not torch's default)."""
    window = _pair(window)
    stride = _pair(stride) if stride is not None else window
    (pt, pb), (pl, pr) = _pads(padding, x.shape[1:3], window, stride)
    xc = _nchw(x)
    if pt == pb and pl == pr and 2 * pt <= window[0] and 2 * pl <= window[1]:
        return _nhwc(F.avg_pool2d(xc, window, stride, (pt, pl),
                                  count_include_pad=False))
    summed = F.avg_pool2d(F.pad(xc, (pl, pr, pt, pb)), window, stride,
                          divisor_override=1)
    ones = F.pad(torch.ones_like(xc[:1, :1]), (pl, pr, pt, pb))
    counts = F.avg_pool2d(ones, window, stride, divisor_override=1)
    return _nhwc(summed / counts)


def batch_norm(x, scale, bias, mean, var, *, axis: int = -1, training: bool,
               momentum: float = 0.9, eps: float = 1e-5):
    """Batch norm over every axis but ``axis``; returns ``(y, new_mean,
    new_var)`` as the JAX function does, the running statistics updated
    out of place and detached: ``new = momentum * old + (1 - momentum) *
    batch`` with the biased batch variance (torch's ``momentum=0.1`` and
    unbiased ``running_var`` differ on both counts, so the buffers never
    reach ``F.batch_norm``).  Eval mode normalizes with ``mean`` and
    ``var``."""
    ax = axis % x.ndim
    dims = tuple(i for i in range(x.ndim) if i != ax)
    shape = [1] * x.ndim
    shape[ax] = x.shape[ax]
    if training:
        use_var, use_mean = torch.var_mean(x, dim=dims, correction=0)
        with torch.no_grad():
            new_mean = momentum * mean + (1 - momentum) * use_mean
            new_var = momentum * var + (1 - momentum) * use_var
    else:
        new_mean, new_var = mean, var
        use_mean, use_var = mean, var
    a = (torch.rsqrt(use_var + eps) * scale).reshape(shape)
    y = torch.addcmul(bias.reshape(shape), x - use_mean.reshape(shape), a)
    return y, new_mean, new_var


def layer_norm(x: torch.Tensor, scale=None, bias=None, *, axis: int = -1,
               eps: float = 1e-5):
    """Layer norm over ``axis`` (the last by default).  Statistics are
    fp32 whatever the input type; the result comes back in the input's
    type."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(dim=axis, keepdim=True)
    var = (xf - mean).square().mean(dim=axis, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def rms_norm(x: torch.Tensor, scale=None, *, axis: int = -1,
             eps: float = 1e-6):
    """RMSNorm over ``axis`` (the last by default), the result in the
    input's type.  The
    statistics are fp32 for fp32 and narrower inputs, as in JAX, and
    float64 for a float64 input (JAX takes those to fp32 too): a float64
    copy of a model then carries no fp32 rounding, which the card's
    checks against the CPU rely on."""
    dtype = x.dtype
    xf = x.to(torch.promote_types(dtype, torch.float32))
    y = xf * torch.rsqrt(xf.square().mean(dim=axis, keepdim=True) + eps)
    if scale is not None:
        y = y * scale.to(xf.dtype)
    return y.to(dtype)


def instance_norm2d(x: torch.Tensor, eps: float = 1e-7):
    """Instance norm over the spatial dims of NHWC ``x`` (no affine)."""
    var, mean = torch.var_mean(x, dim=(1, 2), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def group_norm(x: torch.Tensor, scale, bias, *, groups: int,
               eps: float = 1e-5):
    """Group norm over NHWC: statistics over H, W and each group's
    channels."""
    n, h, w, c = x.shape
    xg = x.reshape(n, h, w, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 2, 4), keepdim=True,
                               correction=0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return y * scale + bias


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 values held in int64."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash_mix(x: torch.Tensor, k: int) -> torch.Tensor:
    """One murmur3-finalizer round folded with key word ``k``."""
    x = x ^ k
    x = _mul32(x ^ (x >> 16), _MIX1)
    x = _mul32(x ^ (x >> 15), _MIX2)
    return x ^ (x >> 16)


def _key_words(k) -> tuple:
    """The two words the hash folds in: a one-word key is used twice."""
    w = key_data(k).reshape(-1).tolist()
    return w[0], w[1 % len(w)]


def _hash_bits(key, shape, device=None) -> torch.Tensor:
    """Counter-hash bits (uint32 values in int64) of ``shape``: the two
    rounds over the flat index ``0 .. prod(shape)-1``."""
    w0, w1 = _key_words(key)
    n = math.prod(shape) if shape else 1
    x = torch.arange(n, dtype=torch.int64, device=device)
    return _hash_mix(_hash_mix(x, w0), w1).reshape(shape)


def dropout_keep_thresh(rate: float) -> int:
    """The keep threshold: ``_hash_bits < thresh`` keeps an element.
    Clamped, because ``keep * 2**32`` rounds to ``2**32`` for rates below
    about 1e-16."""
    keep = 1.0 - rate
    return int(min(keep * 4294967296.0, 4294967295.0))


def dropout(x: torch.Tensor, rate: float, key, *, training: bool = True):
    """Inverted dropout with the counter-hash mask.  The kept values are
    ``x / keep`` with ``keep`` rounded to ``x``'s type first (JAX divides
    by the weakly typed constant): in bf16 that is 0.8984375 for rate
    0.1.  The divisor is a tensor on ``x``'s device, so the division is a
    true one (a CPU scalar would become a product by its reciprocal on
    CUDA)."""
    if not training or rate == 0.0:
        return x
    keep = torch.full((), 1.0 - rate, dtype=x.dtype, device=x.device)
    mask = _hash_bits(key, x.shape, x.device) < dropout_keep_thresh(rate)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def softmax(x: torch.Tensor, axis: int = -1):
    return torch.softmax(x, dim=axis)


def log_softmax(x: torch.Tensor, axis: int = -1):
    return torch.log_softmax(x, dim=axis)

"""Fused residual + dropout + LayerNorm: the CUDA kernels' wrappers and
their plain versions.

Replaces the Pallas TPU kernels of ``hetu_tpu/ops/pallas/fused_ln.py``:
the forward ``_ln_fwd`` (``_fwd_kernel``) and the backward ``_ln_bwd``
(``_bwd_kernel``), entry ``fused_residual_dropout_ln``.  The CUDA kernels
are ``hetu_tpu_torch/csrc/fused_ln.cu``; its header says what bounds them
on the H100 (bytes) and how the design deals with it (the forward: one
warp per row, the row in registers; the backward: one row at a time over
a block of a persistent grid, the next row staged by ``cp.async``; the
dropout mask regenerated in both directions and never stored).  The
backward's grid, :func:`bwd_parts`, is a function of the row count
alone, so its fixed-order dscale / dbias sums do not depend on the
device.

For ``x, y (T, D)`` and fp32 ``scale, bias (D,)`` the forward gives
``out = LN(x + drop(y))`` with fp32 per-row ``mean`` and ``rstd``: ``v =
f32(x) + f32(drop(y))`` (not rounded to the inputs' type), the two-pass
variance, ``drop(y) = keep ? y / keep_y : 0`` in y's type with ``keep_y``
the keep probability rounded to that type.  The backward gives ``dx =
dv``, ``dy = keep ? dv / f32(keep) : 0`` with ``dv = rstd * (dxhat -
mean(dxhat) - xhat * mean(dxhat * xhat))``, and fp32 ``dscale``,
``dbias``.  The mask is the port's dropout mask (``ops.nn._hash_bits``
over the ``(T, D)`` flat index), so with the same key the fused site
equals ``layer_norm(x + dropout(y))`` up to where the sum is rounded.

:func:`fused_ln_fwd` / :func:`fused_ln_bwd` run their plain versions only
when their inputs lie on the CPU; for CUDA tensors they launch the
kernels or raise, with no fallback.
"""

from __future__ import annotations

import math

import torch

from hetu_tpu_torch.ops.kernels import _build
from hetu_tpu_torch.ops.nn import _hash_bits, _key_words, dropout_keep_thresh

__all__ = ["fused_residual_dropout_ln", "fused_ln_fwd", "fused_ln_bwd",
           "fused_ln_fwd_plain", "fused_ln_bwd_plain", "FusedResidualLN",
           "bwd_parts", "fwd_launch_count", "bwd_launch_count",
           "reset_launch_count"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Most blocks of the backward's persistent grid: one wave of 8 blocks of
# 128 threads on each of an H100's 132 SMs.  A constant, not the device's
# SM count: the partial sums' order must not depend on the card.
BWD_WAVE = 132 * 8


def bwd_parts(T: int) -> int:
    """Blocks of the backward for ``T`` rows, each summing its rows'
    dscale / dbias into one ``(D,)`` partial: at most :data:`BWD_WAVE`
    blocks, each taking at most ``ceil(T / BWD_WAVE)`` rows, and no
    more blocks than that needs (1024 blocks of 12 rows at T = 12288)."""
    per = -(-T // BWD_WAVE)
    return -(-T // per)


def fwd_launch_count() -> int:
    """Forward launches since the last reset."""
    return _build.launch_count("fused_ln_fwd")


def bwd_launch_count() -> int:
    """Backward launches (one C call: the rows, then the partial sums)
    since the last reset."""
    return _build.launch_count("fused_ln_bwd")


def reset_launch_count() -> None:
    _build.reset_launches("fused_ln_fwd", "fused_ln_bwd")


def _keep_y(rate: float, dtype) -> float:
    """The keep probability rounded to the inputs' type (the forward's
    divisor)."""
    return float(torch.tensor(1.0 - rate, dtype=dtype))


def _residual_plain(x2, y2, words, thresh, keep_y):
    """``(v, mask)``: ``v = f32(x) + f32(drop(y))``, mask None without
    dropout."""
    if not thresh:
        return x2.float() + y2.float(), None
    mask = _hash_bits(words, x2.shape, x2.device) < thresh
    keep = torch.full((), keep_y, dtype=y2.dtype, device=y2.device)
    yd = torch.where(mask, y2 / keep, torch.zeros((), dtype=y2.dtype,
                                                  device=y2.device))
    return x2.float() + yd.float(), mask


def fused_ln_fwd_plain(x2, y2, scale, bias, *, words=(0, 0),
                       thresh: int = 0, keep_y: float = 1.0,
                       eps: float = 1e-5):
    """``(out, mean, rstd)``: out in x's type, mean and rstd ``(T,)``
    fp32."""
    v, _ = _residual_plain(x2, y2, words, thresh, keep_y)
    mean = v.mean(dim=-1, keepdim=True)
    c = v - mean
    rstd = torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    out = c * rstd * scale.float() + bias.float()
    return out.to(x2.dtype), mean[:, 0], rstd[:, 0]


def fused_ln_bwd_plain(dout, x2, y2, scale, mean, rstd, *, words=(0, 0),
                       thresh: int = 0, keep_y: float = 1.0,
                       keep_g: float = 1.0):
    """``(dx, dy, dscale, dbias)``: dx, dy in the inputs' type, dscale and
    dbias ``(D,)`` fp32."""
    v, mask = _residual_plain(x2, y2, words, thresh, keep_y)
    do = dout.float()
    xhat = (v - mean[:, None]) * rstd[:, None]
    dxhat = do * scale.float()
    d1 = dxhat.mean(dim=-1, keepdim=True)
    d2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dv = rstd[:, None] * (dxhat - d1 - xhat * d2)
    keep = torch.full((), keep_g, dtype=torch.float32, device=dv.device)
    dy = dv if mask is None else torch.where(
        mask, dv / keep, torch.zeros((), device=dv.device))
    return (dv.to(x2.dtype), dy.to(y2.dtype), (do * xhat).sum(0),
            do.sum(0))


def _check(lib, x2, rows: dict, vecs: dict):
    """A launch's checks: ``x2`` is ``(T, D)`` float32 or bfloat16;
    ``rows`` (name: tensor) share its shape and type; ``vecs`` (name:
    (tensor, length)) are float32 vectors; all lie contiguous and 16-byte
    aligned on x's CUDA device; D is one the kernels take."""
    if x2.dtype not in _DTYPES or x2.dim() != 2:
        raise TypeError(f"x must be (T, D) float32 or bfloat16, got "
                        f"{x2.dtype} {tuple(x2.shape)}")
    T, D = x2.shape
    for name, t in {**rows, **{n: v for n, (v, _) in vecs.items()}}.items():
        if t.device != x2.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device of x "
                             f"({x2.device}), got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    for name, t in rows.items():
        if t.shape != x2.shape or t.dtype != x2.dtype:
            raise ValueError(f"{name} must match x ({x2.dtype} "
                             f"{tuple(x2.shape)}), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, (t, n) in vecs.items():
        if t.dtype != torch.float32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be float32 ({n},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    max_d = lib.hetu_fused_ln_max_d()
    if D % 128 or D > max_d:
        raise ValueError(f"the fused LN kernels take D a multiple of 128 up "
                         f"to {max_d}, got {D}")


def fused_ln_fwd(x2, y2, scale, bias, *, words=(0, 0), thresh: int = 0,
                 keep_y: float = 1.0, eps: float = 1e-5):
    """``(out, mean, rstd)`` for ``x2, y2 (T, D)`` and fp32 ``scale``,
    ``bias (D,)``; ``words`` are the key's two uint32 words, ``thresh``
    the keep threshold (0: no dropout), ``keep_y`` the keep probability
    rounded to the inputs' type."""
    if x2.device.type == "cpu":
        return fused_ln_fwd_plain(x2, y2, scale, bias, words=words,
                                  thresh=thresh, keep_y=keep_y, eps=eps)
    lib = _build.load_library()
    T, D = x2.shape[0], x2.shape[-1]
    _check(lib, x2, {"x": x2, "y": y2},
           {"scale": (scale, D), "bias": (bias, D)})
    out = torch.empty_like(x2)
    mean = torch.empty((T,), dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mean)
    err = lib.hetu_fused_ln_fwd(
        _DTYPES[x2.dtype], x2.data_ptr(), y2.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), out.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        T, D, words[0], words[1], thresh, keep_y, eps,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "fused_ln_fwd")
    _build.count_launch("fused_ln_fwd")
    return out, mean, rstd


def fused_ln_bwd(dout, x2, y2, scale, mean, rstd, *, words=(0, 0),
                 thresh: int = 0, keep_y: float = 1.0, keep_g: float = 1.0):
    """``(dx, dy, dscale, dbias)`` from ``dout (T, D)`` and the forward's
    ``mean`` and ``rstd``; ``keep_g`` is the keep probability in fp32."""
    if x2.device.type == "cpu":
        return fused_ln_bwd_plain(dout, x2, y2, scale, mean, rstd,
                                  words=words, thresh=thresh, keep_y=keep_y,
                                  keep_g=keep_g)
    lib = _build.load_library()
    T, D = x2.shape[0], x2.shape[-1]
    _check(lib, x2, {"dout": dout, "x": x2, "y": y2},
           {"scale": (scale, D), "mean": (mean, T), "rstd": (rstd, T)})
    parts = bwd_parts(T)
    part = torch.empty((2, parts, D), dtype=torch.float32, device=x2.device)
    dx = torch.empty_like(x2)
    dy = torch.empty_like(y2)
    dsb = torch.empty((2, D), dtype=torch.float32, device=x2.device)
    err = lib.hetu_fused_ln_bwd(
        _DTYPES[x2.dtype], dout.data_ptr(), x2.data_ptr(), y2.data_ptr(),
        scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        dy.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
        dsb[0].data_ptr(), dsb[1].data_ptr(), T, D, parts, words[0],
        words[1], thresh, keep_y, keep_g,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, "fused_ln_bwd")
    _build.count_launch("fused_ln_bwd")
    return dx, dy, dsb[0], dsb[1]


def _aligned(t):
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class FusedResidualLN(torch.autograd.Function):
    """``LN(x + drop(y))`` over ``(T, D)`` with the kernels' backward.
    ``args`` carries ``(words, thresh, keep_y, keep_g, eps)``."""

    @staticmethod
    def forward(ctx, x2, y2, scale, bias, args):
        words, thresh, keep_y, keep_g, eps = args
        s32 = _aligned(scale.float())
        out, mean, rstd = fused_ln_fwd(x2, y2, s32, _aligned(bias.float()),
                                       words=words, thresh=thresh,
                                       keep_y=keep_y, eps=eps)
        ctx.save_for_backward(x2, y2, s32, mean, rstd)
        ctx.args = args
        ctx.param_dtypes = (scale.dtype, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        x2, y2, s32, mean, rstd = ctx.saved_tensors
        words, thresh, keep_y, keep_g, _ = ctx.args
        dx, dy, ds, db = fused_ln_bwd(
            _aligned(dout.to(x2.dtype)), x2, y2, s32, mean, rstd,
            words=words, thresh=thresh, keep_y=keep_y, keep_g=keep_g)
        return (dx, dy, ds.to(ctx.param_dtypes[0]),
                db.to(ctx.param_dtypes[1]), None)


def fused_residual_dropout_ln(x, y, scale, bias, *, rate: float = 0.0,
                              key=None, eps: float = 1e-5):
    """``layer_norm(x + dropout(y, rate, key))`` in one pass per direction
    (the CUDA kernels for CUDA tensors).  x, y ``(..., D)`` of one type;
    scale, bias ``(D,)``.  ``rate`` must lie in ``[0, 1)``; ``rate = 0`` or
    ``key=None`` is plain residual + LN; a one-word key is used twice."""
    if not 0.0 <= rate < 1.0:
        # rate 1 would make the keep threshold 0, which the kernels read
        # as "no dropout", the opposite of dropping everything
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if key is None:
        rate = 0.0
    D = x.shape[-1]
    lead = x.shape[:-1]
    T = math.prod(lead) if lead else 1
    if rate > 0.0:
        words = _key_words(key)
        args = (words, dropout_keep_thresh(rate), _keep_y(rate, y.dtype),
                float(torch.tensor(1.0 - rate, dtype=torch.float32)),
                float(eps))
    else:
        args = ((0, 0), 0, 1.0, 1.0, float(eps))
    out = FusedResidualLN.apply(_aligned(x.reshape(T, D)),
                                _aligned(y.reshape(T, D)), scale, bias, args)
    return out.reshape(*lead, D)

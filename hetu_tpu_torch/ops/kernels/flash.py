"""Flash attention: the CUDA kernels' wrappers and their plain versions.

Replaces the Pallas TPU kernels of ``hetu_tpu/ops/pallas/flash.py``: the
forward (``_fwd_call``: ``_fwd_kernel``, ``_fwd_one_kernel``), the
backward (``_bwd`` / ``_bwd_one_call``: the fused, one-block and two-pass
kernels), and the ring attention's block entry points ``flash_block_fwd``
(``_fwd_call`` again) and ``flash_block_bwd`` (the same backward kernels
fed an external lse and delta, with fp32 outputs).  The CUDA kernels are
``hetu_tpu_torch/csrc/flash_attn.cu``; its header says what bounds them
on the H100 (operations) and how the design deals with it (``mma.sync``
on the tensor cores, 3xTF32 in fp32; one block per (b, h, q tile)
looping over kv tiles staged by ``cp.async``, with fp32 online-softmax
state; a two-pass backward in one launch, with no atomics).  The
kernels take contiguous tensors that start on a 16-byte boundary; the
wrappers raise for any other.

The function is the TPU kernels': for q ``(B, H, Sq, D)`` and k, v ``(B,
H, Sk, D)``, ``O = softmax(q k^T * scale) v`` and the per-row ``LSE``
(fp32), with fp32 statistics; ``causal`` masks key positions after the
query position (``col <= row``, as the TPU kernel's block mask), and the
ragged sequence edge needs no padding.  The probabilities are rounded to
v's type before the ``P @ V`` product and ``dS`` to q's type before the
``dK`` / ``dQ`` products, as in the TPU kernels (nothing changes in
fp32).

:func:`flash_fwd` / :func:`flash_bwd` and the block entries
:func:`flash_block_fwd` / :func:`flash_block_bwd` run their plain
versions only when their inputs lie on the CPU.  For CUDA tensors they
launch the kernels or raise; there is no fallback.  ``fwd_launch_count()``
and ``bwd_launch_count()`` count the whole-sequence calls that launched,
``block_fwd_launch_count()`` and ``block_bwd_launch_count()`` the block
calls.
"""

from __future__ import annotations

import math

import torch

from hetu_tpu_torch.ops.kernels import _build

__all__ = ["flash_attention", "flash_attention_bhsd", "flash_attn_fn",
           "flash_fwd", "flash_bwd", "flash_fwd_plain", "flash_bwd_plain",
           "flash_block_fwd", "flash_block_bwd", "flash_block_bwd_plain",
           "FlashAttention", "fwd_launch_count", "bwd_launch_count",
           "block_fwd_launch_count", "block_bwd_launch_count",
           "reset_launch_count"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 96, 128)


def fwd_launch_count() -> int:
    """Forward kernel launches (one per call) since the last reset."""
    return _build.launch_count("flash_fwd")


def bwd_launch_count() -> int:
    """Backward launches (one call of the C entry, which runs the delta,
    dK/dV and dQ kernels) since the last reset."""
    return _build.launch_count("flash_bwd")


def block_fwd_launch_count() -> int:
    """Block-forward launches (:func:`flash_block_fwd`) since the last
    reset; they do not count in :func:`fwd_launch_count`."""
    return _build.launch_count("flash_block_fwd")


def block_bwd_launch_count() -> int:
    """Block-backward launches (one call of the C entry, which runs the
    dK/dV and dQ kernels) since the last reset."""
    return _build.launch_count("flash_block_bwd")


def reset_launch_count() -> None:
    _build.reset_launches("flash_fwd", "flash_bwd", "flash_block_fwd",
                          "flash_block_bwd")


def _mask(Sq, Sk, causal, device):
    col = torch.arange(Sk, device=device)[None, :]
    row = torch.arange(Sq, device=device)[:, None]
    return (col <= row) if causal else torch.ones(
        (Sq, Sk), dtype=torch.bool, device=device)


def _scores(q, k, causal, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    live = _mask(q.shape[2], k.shape[2], causal, q.device)
    return torch.where(live, s, torch.full_like(s, _NEG_INF)), live


def flash_fwd_plain(q, k, v, *, causal: bool, scale: float):
    """``(O, LSE)`` in plain PyTorch: the scores materialized in fp32,
    then the one-block softmax of ``_fwd_one_kernel``.  O in q's type,
    LSE ``(B, H, Sq)`` fp32."""
    s, _ = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_block_bwd_plain(q, k, v, do, lse, delta, *, causal: bool,
                          scale: float):
    """``(dQ, dK, dV)`` of one block pair in plain PyTorch, by the TPU
    backward's formulas, given the q chunk's ``lse`` and ``delta`` as
    ``(B, H, Sq, 1)`` fp32: P recomputed from the lse, ``dS = P (dP -
    delta) * scale``.  Gradients in fp32."""
    s, live = _scores(q, k, causal, scale)
    p = torch.where(live, torch.exp(s - lse), torch.zeros_like(s))
    dof = do.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float())
    return dq, dk, dv


def flash_bwd_plain(q, k, v, o, lse, do, *, causal: bool, scale: float):
    """``(dQ, dK, dV)`` in plain PyTorch: ``delta = rowsum(dO * O)``, then
    :func:`flash_block_bwd_plain` with the whole sequence as one block.
    Gradients in the inputs' types."""
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    dq, dk, dv = flash_block_bwd_plain(q, k, v, do, lse[..., None], delta,
                                       causal=causal, scale=scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(tensors: dict, ref):
    for name, t in tensors.items():
        if t.device != ref.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device of q "
                             f"({ref.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(the kernels stage rows by 16-byte copies)")


def _check_qkv(q, k, v):
    _check({"q": q, "k": k, "v": v}, q)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of float32 / bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Sq, D) and k, v (B, H, Sk, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, D = q.shape
    if tuple(k.shape[:2]) != (B, H) or k.shape[3] != D:
        raise ValueError("q, k and v must share batch, heads and head_dim")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {_HEAD_DIMS}, got {D}")
    if B * H > 65535:
        raise ValueError(f"batch * heads must be at most 65535, got {B * H}")


def _launch_fwd(q, k, v, lse, causal, scale):
    """O of one ``hetu_flash_fwd`` launch; the LSE lands in ``lse``."""
    lib = _build.load_library()
    _check_qkv(q, k, v)
    B, H, Sq, D = q.shape
    o = torch.empty_like(q)
    err = lib.hetu_flash_fwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), B, H, Sq, k.shape[2], D, int(causal),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_fwd")
    return o


def flash_fwd(q, k, v, *, causal: bool, scale: float):
    """``(O, LSE)`` of q ``(B, H, Sq, D)`` against k, v ``(B, H, Sk, D)``:
    O in q's type, LSE ``(B, H, Sq)`` fp32."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    o = _launch_fwd(q, k, v, lse, causal, scale)
    _build.count_launch("flash_fwd")
    return o, lse


def flash_block_fwd(q, k, v, *, scale: float, causal: bool = False):
    """``(O, LSE)`` of one ring block pair, in the JAX entry's layout: q
    ``(B, H, Sq, D)``, k, v ``(B, H, Sk, D)``; O in q's type, LSE ``(B, H,
    Sq, 1)`` fp32.  The same kernel as :func:`flash_fwd`, counted apart."""
    if q.device.type == "cpu":
        o, lse = flash_fwd_plain(q, k, v, causal=causal, scale=scale)
        return o, lse[..., None]
    lse = torch.empty((*q.shape[:3], 1), dtype=torch.float32,
                      device=q.device)
    o = _launch_fwd(q, k, v, lse, causal, scale)
    _build.count_launch("flash_block_fwd")
    return o, lse


def flash_bwd(q, k, v, o, lse, do, *, causal: bool, scale: float):
    """``(dQ, dK, dV)`` of :func:`flash_fwd` given the upstream ``dO``."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal=causal,
                               scale=scale)
    lib = _build.load_library()
    _check_qkv(q, k, v)
    _check({"o": o, "lse": lse, "do": do}, q)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("o and do must have q's shape and type")
    B, H, Sq, D = q.shape
    if lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq):
        raise ValueError("lse must be float32 of shape (B, H, Sq)")
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    err = lib.hetu_flash_bwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, Sq, k.shape[2],
        D, int(causal), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_bwd")
    _build.count_launch("flash_bwd")
    return dq, dk, dv


def flash_block_bwd(q, k, v, do, lse, delta, *, scale: float,
                    causal: bool = False):
    """``(dQ, dK, dV)`` of one ring block pair, all fp32, given the q
    chunk's GLOBAL ``lse`` and ``delta = rowsum(dO * O)``, both ``(B, H,
    Sq, 1)`` fp32; q, k, v, do ``(B, H, S, D)`` with do in q's type."""
    if q.device.type == "cpu":
        return flash_block_bwd_plain(q, k, v, do, lse, delta, causal=causal,
                                     scale=scale)
    lib = _build.load_library()
    _check_qkv(q, k, v)
    _check({"do": do, "lse": lse, "delta": delta}, q)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("do must have q's shape and type")
    B, H, Sq, D = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, Sq, 1):
            raise ValueError(f"{name} must be float32 of shape (B, H, Sq, 1)")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, **f32)
    dk, dv = torch.empty(k.shape, **f32), torch.empty(v.shape, **f32)
    err = lib.hetu_flash_block_bwd(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, H, Sq, k.shape[2], D, int(causal),
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_block_bwd")
    _build.count_launch("flash_block_bwd")
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``O`` with a backward through :func:`flash_bwd`; saves ``(q, k, v,
    O, LSE)`` as ``_flash_fwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(),
                               causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bhsd(q, k, v, *, causal: bool = False,
                         scale: float | None = None):
    """Fused attention in the kernels' native ``(B, H, S, D)`` layout:
    returns O ``(B, H, Sq, D)``, differentiable in q, k and v."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, causal, float(scale))


def flash_attention(q, k, v, mask=None, *, causal: bool = False,
                    scale: float | None = None):
    """Drop-in for ``dot_product_attention``: q, k, v ``(B, S, H, D)``.
    An arbitrary ``mask`` goes to the materialized core, as in the JAX
    package; otherwise the operands are transposed to ``(B, H, S, D)``
    (one copy each way) around :func:`flash_attention_bhsd`."""
    if mask is not None:
        from hetu_tpu_torch.layers.attention import dot_product_attention
        return dot_product_attention(q, k, v, mask, scale=scale,
                                     causal=causal)
    out = flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal, scale=scale)
    return out.transpose(1, 2)


def flash_attn_fn(*, native_layout: bool = False):
    """An ``attn_fn`` for ``MultiHeadAttention`` / ``TransformerBlock``.

    ``native_layout=True`` returns a callable marked ``bhsd``: the
    attention layer then hands it q, k, v in ``(B, H, S, D)`` and it
    returns that layout.  Otherwise the callable is the ``(B, S, H, D)``
    drop-in :func:`flash_attention`.  Either routes a given ``mask`` to
    the materialized core."""
    if not native_layout:
        def fn(q, k, v, mask=None, *, scale=None, causal=False):
            return flash_attention(q, k, v, mask, causal=causal, scale=scale)
        return fn

    def fn(q, k, v, mask=None, *, scale=None, causal=False):
        if mask is not None:
            from hetu_tpu_torch.layers.attention import (
                dot_product_attention_bhsd)
            return dot_product_attention_bhsd(q, k, v, mask, scale=scale,
                                              causal=causal)
        return flash_attention_bhsd(q, k, v, causal=causal, scale=scale)

    fn.bhsd = True
    return fn

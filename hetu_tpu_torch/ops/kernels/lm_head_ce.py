"""Fused LM-head cross entropy: the CUDA kernels' wrappers and their plain
versions.

Replaces the Pallas TPU kernels of ``hetu_tpu/ops/pallas/lm_head.py``:
the forward ``_head_fwd`` (``_fwd_kernel``) and the backward ``_head_bwd``
(``_dh_kernel``, ``_dw_kernel``), entry ``lm_head_cross_entropy_pallas``.
The CUDA kernels are ``hetu_tpu_torch/csrc/lm_head_ce.cu``.

**Bound and design.**  The head is three matrix products of ``2 N E V``
flops each (the logits, ``t @ W``, ``t^T @ h``): on an H100 80GB HBM3 at
700 W it is bound by operations.  In fp32 the products run on the TF32
tensor cores as 3xTF32 (each operand split into two TF32 parts, three
products each: fp32-grade sums at 495 / 3 = 165 TFLOP/s), so at N =
8184, E = 768, V = 50257 the forward's bound is 3.83 ms and the
backward's 11.49 ms; bf16 runs at 989 TFLOP/s (0.64 and 1.92 ms).  One
tensor-core mainloop (128 x 128 block tiles, a four-stage ``cp.async``
ring; ``wgmma`` in fp32, ``mma.sync`` in bf16) serves every product.  The
forward splits the vocabulary across blocks and merges the per-chunk
(max, normalizer, label logit) partials in a fixed order, so W is
streamed from memory about once.  The backward walks the vocabulary in
chunks of at most 8192 columns and runs three launches a chunk: the t
pass (the logits once, ``t`` written in the inputs' type), ``dh += t @
W_c`` and ``dW_c = t^T @ h`` with ``db_c``.  No atomics: a rerun gives
bitwise the same gradients; E has no limit.  The source's header has the
details.

**Scratch**, allocated here with ``torch.empty``: the forward's partials
``(3, N, ceil(V / 1024))`` fp32; the backward's ``t`` slice ``(N,
chunk)`` in the inputs' type (239 MB at N = 8184, V = 50257 in fp32,
chunk 7296; the plain version's ``t`` too holds one chunk) and, in
bf16, an ``(N, E)`` fp32 accumulator for dh (fp32 accumulates in dh
itself).  The ``(N, V)`` logits never reach device memory.

The function is the TPU kernels': for hidden ``h (N, E)``, the head
``W`` and an optional fp32 ``bias (V,)``, the per-row ``lse`` of ``h @
W^T + b`` over the vocabulary and the label's logit, both fp32; the
backward gives ``dh = t @ W``, ``dW = t^T @ h`` and ``db = colsum(t)``
with ``t = (softmax - onehot(y)) * dnll``, t rounded to the inputs' type
before the products (nothing changes in fp32).

**Weight layout.**  ``W`` is the embedding's ``(V, E)`` (``GPT._head()``,
the tied ``wte.weight`` itself), and ``dW`` comes back ``(V, E)``, so the
tied embedding receives the head's gradient with no transposed copy.  The
JAX package passes ``(E, V)``; the tests transpose on their side.

:func:`lm_head_ce_fwd` / :func:`lm_head_ce_bwd` run their plain versions
only when their inputs lie on the CPU; for CUDA tensors they launch the
kernels or raise, with no fallback.  The plain versions walk the
vocabulary in chunks with an online logsumexp (the JAX package's
``impl="scan"``), so they too never hold more than ``(N, chunk)`` logits.
"""

from __future__ import annotations

import torch

from hetu_tpu_torch.ops.kernels import _build

__all__ = ["lm_head_ce_fwd", "lm_head_ce_bwd", "lm_head_ce_fwd_plain",
           "lm_head_ce_bwd_plain", "LMHeadCrossEntropy", "fwd_launch_count",
           "bwd_launch_count", "reset_launch_count"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_VCHUNK = 1024   # vocab rows per forward block (8 tiles of 128)
_BWD_VCHUNK = 8192   # most vocab rows per backward chunk


def fwd_launch_count() -> int:
    """Forward launches (one C call: partials, then the merge) since the
    last reset."""
    return _build.launch_count("lm_head_ce_fwd")


def bwd_launch_count() -> int:
    """Backward launches (one C call: per vocab chunk the t pass, dh and
    dW/db) since the last reset."""
    return _build.launch_count("lm_head_ce_bwd")


def reset_launch_count() -> None:
    _build.reset_launches("lm_head_ce_fwd", "lm_head_ce_bwd")


def _chunk_logits(hf, weight, bias, c0, c1):
    lg = hf @ weight[c0:c1].float().T
    return lg if bias is None else lg + bias[c0:c1].float()


def lm_head_ce_fwd_plain(hidden, weight, labels, *, bias=None,
                         chunk: int = 8192):
    """``(lse, label_logit)``, both ``(N,)`` fp32, over vocab chunks of
    ``chunk`` rows with an online logsumexp."""
    N, V = hidden.shape[0], weight.shape[0]
    hf = hidden.to(weight.dtype).float()
    y = labels.long()
    m = torch.full((N,), _NEG_INF, device=hidden.device)
    l = torch.zeros((N,), device=hidden.device)
    ylog = torch.zeros((N,), device=hidden.device)
    for c0 in range(0, V, chunk):
        c1 = min(V, c0 + chunk)
        lg = _chunk_logits(hf, weight, bias, c0, c1)
        m_new = torch.maximum(m, lg.amax(dim=1))
        l = l * torch.exp(m - m_new) + torch.exp(lg - m_new[:, None]).sum(1)
        m = m_new
        inside = (y >= c0) & (y < c1)
        got = lg.gather(1, (y - c0).clamp(0, c1 - c0 - 1)[:, None])[:, 0]
        ylog = torch.where(inside, got, ylog)
    return m + torch.log(l), ylog


def lm_head_ce_bwd_plain(hidden, weight, labels, lse, g, *, bias=None,
                         chunk: int = 8192):
    """``(dh, dW, db)`` over vocab chunks, from the forward's ``lse`` and
    ``g = dnll`` (fp32, zero on ignored rows).  dh in hidden's type, dW
    ``(V, E)`` in weight's, db fp32 or None without a bias."""
    V = weight.shape[0]
    hf = hidden.to(weight.dtype).float()
    y = labels.long()
    dh = torch.zeros(hf.shape, device=hidden.device)
    dw = torch.empty_like(weight)
    db = None if bias is None else torch.empty((V,), device=hidden.device)
    for c0 in range(0, V, chunk):
        c1 = min(V, c0 + chunk)
        lg = _chunk_logits(hf, weight, bias, c0, c1)
        cols = torch.arange(c0, c1, device=hidden.device)
        onehot = (cols[None, :] == y[:, None]).float()
        t = ((torch.exp(lg - lse[:, None]) - onehot) * g[:, None])
        t = t.to(weight.dtype).float()
        dh += t @ weight[c0:c1].float()
        dw[c0:c1] = (t.T @ hf).to(weight.dtype)
        if db is not None:
            db[c0:c1] = t.sum(0)
    return dh.to(hidden.dtype), dw, db


def _check(hidden, weight, labels, bias):
    tensors = {"hidden": hidden, "weight": weight, "labels": labels,
               "bias": bias}
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != hidden.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device of hidden "
                             f"({hidden.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hidden.dtype not in _DTYPES or weight.dtype != hidden.dtype:
        raise TypeError(f"hidden and weight must share one of float32 / "
                        f"bfloat16, got {hidden.dtype}, {weight.dtype}")
    if hidden.dim() != 2 or weight.dim() != 2 \
            or weight.shape[1] != hidden.shape[1]:
        raise ValueError(f"hidden must be (N, E) and weight (V, E), got "
                         f"{tuple(hidden.shape)}, {tuple(weight.shape)}")
    N, E = hidden.shape
    V = weight.shape[0]
    if labels.dtype != torch.int32 or tuple(labels.shape) != (N,):
        raise ValueError("labels must be int32 of shape (N,)")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (V,)):
        raise ValueError("bias must be float32 of shape (V,)")
    return N, E, V


def _bwd_chunk(V: int) -> int:
    """The backward's vocab chunk: at most ``_BWD_VCHUNK`` columns, the
    chunks of about equal size, a multiple of the 128-column tile."""
    n = -(-V // _BWD_VCHUNK)
    per = -(-V // n)
    return -(-per // 128) * 128


def lm_head_ce_fwd(hidden, weight, labels, *, bias=None, chunk: int = 8192):
    """``(lse, label_logit)``, both ``(N,)`` fp32.  hidden ``(N, E)``,
    weight ``(V, E)`` of hidden's type, labels ``(N,)`` int32 (a label
    outside ``[0, V)`` matches no column), bias ``(V,)`` fp32 or None.
    ``chunk`` is the plain version's vocab chunk (CPU tensors only)."""
    if hidden.device.type == "cpu":
        return lm_head_ce_fwd_plain(hidden, weight, labels, bias=bias,
                                    chunk=chunk)
    lib = _build.load_library()
    N, E, V = _check(hidden, weight, labels, bias)
    n_chunks = -(-V // _FWD_VCHUNK)
    part = torch.empty((3, N, n_chunks), dtype=torch.float32,
                       device=hidden.device)
    lse = torch.empty((N,), dtype=torch.float32, device=hidden.device)
    ylog = torch.empty_like(lse)
    err = lib.hetu_ce_fwd(
        _DTYPES[hidden.dtype], hidden.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), labels.data_ptr(), N, E,
        V, _FWD_VCHUNK, part.data_ptr(), lse.data_ptr(), ylog.data_ptr(),
        torch.cuda.current_stream(hidden.device).cuda_stream)
    _build.check(err, "lm_head_ce_fwd")
    _build.count_launch("lm_head_ce_fwd")
    return lse, ylog


def lm_head_ce_bwd(hidden, weight, labels, lse, g, *, bias=None,
                   chunk: int = 8192):
    """``(dh, dW, db)`` given the forward's ``lse`` and ``g = dnll``
    (``(N,)`` fp32, zero on ignored rows).  dW is ``(V, E)``; db is None
    without a bias.  ``chunk`` as in :func:`lm_head_ce_fwd`."""
    if hidden.device.type == "cpu":
        return lm_head_ce_bwd_plain(hidden, weight, labels, lse, g,
                                    bias=bias, chunk=chunk)
    lib = _build.load_library()
    N, E, V = _check(hidden, weight, labels, bias)
    for name, t in (("lse", lse), ("g", g)):
        if t.device != hidden.device or not t.is_contiguous() \
                or t.dtype != torch.float32 or tuple(t.shape) != (N,):
            raise ValueError(f"{name} must be contiguous float32 (N,) on "
                             f"{hidden.device}")
    vchunk = _bwd_chunk(V)
    tbuf = torch.empty((N, vchunk), dtype=hidden.dtype,
                       device=hidden.device)
    dh_acc = None if hidden.dtype == torch.float32 else torch.empty(
        (N, E), dtype=torch.float32, device=hidden.device)
    dh = torch.empty_like(hidden)
    dw = torch.empty_like(weight)
    db = None if bias is None else torch.empty(
        (V,), dtype=torch.float32, device=hidden.device)
    err = lib.hetu_ce_bwd(
        _DTYPES[hidden.dtype], hidden.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), labels.data_ptr(),
        lse.data_ptr(), g.data_ptr(), N, E, V, vchunk, tbuf.data_ptr(),
        None if dh_acc is None else dh_acc.data_ptr(), dh.data_ptr(),
        dw.data_ptr(),
        None if db is None else db.data_ptr(),
        torch.cuda.current_stream(hidden.device).cuda_stream)
    _build.check(err, "lm_head_ce_bwd")
    _build.count_launch("lm_head_ce_bwd")
    return dh, dw, db


class LMHeadCrossEntropy(torch.autograd.Function):
    """Per-row nll, ``ignore_index`` rows zeroed.  The forward saves the
    LSE (as ``_head_vjp_fwd``); the backward zeroes ``dnll`` on ignored
    rows before the kernels run.  ``plain=True`` runs the plain
    vocab-chunked versions whatever the device; ``chunk`` is their vocab
    chunk."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, labels, ignore_index: int,
                chunk: int, plain: bool):
        fwd = lm_head_ce_fwd_plain if plain else lm_head_ce_fwd
        lse, ylog = fwd(hidden, weight, labels, bias=bias, chunk=chunk)
        ctx.save_for_backward(hidden, weight, bias, labels, lse)
        ctx.ignore_index, ctx.chunk, ctx.plain = ignore_index, chunk, plain
        return torch.where(labels == ignore_index, torch.zeros_like(lse),
                           lse - ylog)

    @staticmethod
    def backward(ctx, dnll):
        hidden, weight, bias, labels, lse = ctx.saved_tensors
        g = torch.where(labels == ctx.ignore_index, torch.zeros_like(lse),
                        dnll.float()).contiguous()
        bwd = lm_head_ce_bwd_plain if ctx.plain else lm_head_ce_bwd
        dh, dw, db = bwd(hidden, weight, labels, lse, g, bias=bias,
                         chunk=ctx.chunk)
        return dh, dw, db, None, None, None, None

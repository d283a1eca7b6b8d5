"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``hetu_tpu/ops/pallas/paged_decode.py``
(``_kernel``, entry ``paged_decode_attention``).  The CUDA kernel is
``hetu_tpu_torch/csrc/paged_decode.cu``; its header says what bounds it
on the H100 (memory: each live K/V row is read once) and how the design
deals with it (each row split into fixed chunks of whole pages, staged
by ``cp.async``, one fp32 partial softmax state per chunk and head,
merged in chunk order by a second kernel).

The split is :func:`chunk_plan`, a function of the page size and the
table width alone: a row's result never depends on the batch it is in,
on the other rows or on the lengths.  :func:`heads_per_block` is the
head group a block takes, from the head count, the head width and the
type.

:func:`paged_decode_attention` runs :func:`paged_decode_attention_plain`
only when its inputs lie on the CPU.  For CUDA tensors it launches the
kernels or raises; there is no fallback.  ``launch_count()`` counts the
wrapper's calls that launched them (``_build``'s registry, which a CUDA
graph's replay advances too).
"""

from __future__ import annotations

import math

import torch

from hetu_tpu_torch.ops.kernels import _build

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "chunk_plan", "heads_per_block", "launch_count",
           "reset_launch_count"]

_NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Positions a chunk holds at least: 64 at GPT-2 small's page of 16 cuts
# lengths 1..1024 into 47 chunks, 282 blocks of two heads, under one wave
# of the H100's 132 SMs at three blocks each.
CHUNK_POSITIONS = 64
# Bytes of one position's head-group row that a block stages: 512 gives
# two fp32 heads of 64 (68 KB of shared memory for two stages of K and V).
ROW_BYTES = 512


def chunk_plan(page: int, pages_per_seq: int) -> tuple:
    """``(chunk_pages, n_chunks)``: every row is cut into chunks of
    ``chunk_pages`` whole pages, at least :data:`CHUNK_POSITIONS`
    positions, and ``n_chunks`` of them cover ``pages_per_seq`` pages."""
    chunk_pages = max(1, -(-CHUNK_POSITIONS // page))
    return chunk_pages, -(-pages_per_seq // chunk_pages)


def heads_per_block(H: int, D: int, itemsize: int) -> int:
    """Heads (one warp each) a block of the chunk kernel takes: as many
    as fit :data:`ROW_BYTES` of a position's row, at least 1, at most 8
    and at most ``H``."""
    return max(1, min(8, H, ROW_BYTES // (D * itemsize)))


def launch_count() -> int:
    """CUDA kernel launches since the last reset."""
    return _build.launch_count("paged_decode_attention")


def reset_launch_count() -> None:
    _build.reset_launches("paged_decode_attention")



def _layer_pools(k_pool, v_pool, layer):
    if k_pool.dim() == 5:
        if layer is None:
            raise ValueError("a stacked (layers, pages, ...) pool needs the "
                             "layer index")
        return k_pool[layer], v_pool[layer]
    if k_pool.dim() != 4:
        raise ValueError(f"pool must be (pages, page, H, D) or (layers, "
                         f"pages, page, H, D), got {tuple(k_pool.shape)}")
    return k_pool, v_pool


def paged_decode_attention_plain(q, k_pool, v_pool, page_tables, seq_lengths,
                                 *, layer=None, scale=None):
    """The same function in plain PyTorch: gather each row's pages, mask
    positions at or past ``seq_lengths`` (scores to -1e30 and the dead V
    rows to zero, both by selection, so a NaN there never reaches the
    arithmetic), softmax in fp32, cast to q's type.  A row of length 0
    attends to nothing and is NaN, as the TPU kernel's ``0 / 0``."""
    k_pool, v_pool = _layer_pools(k_pool, v_pool, layer)
    B, H, D = q.shape
    P, page = page_tables.shape[1], k_pool.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    tables = page_tables.long()
    k = k_pool[tables].reshape(B, P * page, H, D).float()
    v = v_pool[tables].reshape(B, P * page, H, D).float()
    pos = torch.arange(P * page, device=q.device)
    live = pos[None, :] < seq_lengths.long()[:, None]          # (B, S)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    s = torch.where(live[:, None, :], s, torch.full_like(s, _NEG_INF))
    v = torch.where(live[:, :, None, None], v, torch.zeros_like(v))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", p, v)
    o = torch.where(live[:, :1, None], o, torch.full_like(o, float("nan")))
    return o.to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, page_tables, seq_lengths, *,
                           layer=None, scale=None):
    """One query per sequence attends over its paged K/V history, read in
    place from the pool.

    q: ``(B, H, D)``.  k_pool/v_pool: ``(pages, page_size, H, D)``, or the
    stacked ``(layers, pages, ...)`` pool with ``layer`` (the view
    ``pool[layer]`` is contiguous, so the kernel gets a pointer offset and
    no copy).  page_tables: ``(B, pages_per_seq)`` int32, short tables
    padded with the scratch page.  seq_lengths: ``(B,)`` int32, the valid
    tokens per row including the new one; a row of length 0 gives NaN.
    Returns ``(B, H, D)`` in q's type, with fp32 statistics and
    accumulation.  On CUDA the pools must be 16-byte aligned."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_tables,
                                            seq_lengths, layer=layer,
                                            scale=scale)
    lib = _build.load_library()
    k_l, v_l = _layer_pools(k_pool, v_pool, layer)
    B, H, D = q.shape
    P, page = page_tables.shape[1], k_l.shape[1]
    tensors = {"q": q, "k_pool": k_l, "v_pool": v_l,
               "page_tables": page_tables, "seq_lengths": seq_lengths}
    for name, t in tensors.items():
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device of q "
                             f"({q.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pool", k_l), ("v_pool", v_l)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             f"stages rows by 16-byte copies)")
    if q.dtype not in _DTYPES or k_l.dtype != q.dtype or v_l.dtype != q.dtype:
        raise TypeError(f"q and the pools must share one of float32 / "
                        f"bfloat16, got {q.dtype}, {k_l.dtype}, {v_l.dtype}")
    if page_tables.dtype != torch.int32 or seq_lengths.dtype != torch.int32:
        raise TypeError("page_tables and seq_lengths must be int32")
    if tuple(k_l.shape[2:]) != (H, D) or v_l.shape != k_l.shape:
        raise ValueError(f"pool rows {tuple(k_l.shape[2:])} do not match q "
                         f"heads/head_dim {(H, D)}")
    if tuple(page_tables.shape) != (B, P) or tuple(seq_lengths.shape) != (B,):
        raise ValueError("page_tables must be (B, pages_per_seq) and "
                         "seq_lengths (B,)")
    if D % 32 or not 32 <= D <= 256:
        raise ValueError(f"head_dim must be a multiple of 32 up to 256, "
                         f"got {D}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    chunk_pages, n_chunks = chunk_plan(page, P)
    out = torch.empty_like(q)
    part = torch.empty(B * n_chunks * H * (D + 2), dtype=torch.float32,
                       device=q.device)
    err = lib.hetu_paged_decode(
        _DTYPES[q.dtype], q.data_ptr(), k_l.data_ptr(), v_l.data_ptr(),
        page_tables.data_ptr(), seq_lengths.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, H, D, page, P, chunk_pages, n_chunks,
        heads_per_block(H, D, q.element_size()), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    _build.count_launch("paged_decode_attention")
    return out

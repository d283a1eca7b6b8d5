"""Sequence parallelism: ring attention and Ulysses (counterpart of
``hetu_tpu/parallel/ring_attention.py``).

Rank ``r`` of the ``sp`` axis holds the sequence chunk ``[r*c, (r+1)*c)``
of q, k and v, ``(b, c, h, d)``.  A core takes the chunks this process
holds of one ``sp`` group, as a list, and returns their outputs:

* on a local mesh (``mesh=None``, or one group's view inside
  ``RankHandle.collective``) the list is the whole group, rank ``r``'s
  chunk at index ``r``; every rank's visits run in turn on the one
  device, each with the shapes a rank of a multi-card run launches;
* on a process mesh (``mesh`` a ``ProcessMesh``, ``axis`` its ring axis)
  the list is this process's one chunk, its ring index its coordinate on
  ``axis``, and K/V hop through ``ppermute`` over the axis's process
  group, forward and backward.

K/V move between ranks only through ``parallel.collectives``.  A chunk's
causal offset is its index on ``axis`` times the chunk length, never its
flat rank.

- :func:`ring_flash_attention` (default core): K/V chunks circulate the
  ring; every (q-chunk, kv-chunk) visit runs the flash kernels
  (``flash_block_fwd`` / ``flash_block_bwd``), folded by an online
  logsumexp, with a ring-level backward (an autograd Function, as the
  JAX ``custom_vjp``) that circulates fp32 dK/dV accumulators with their
  chunks.  Causal: the diagonal visit runs the causal kernel, past
  chunks run unmasked, future chunks are skipped; for ``sp = 4`` that is
  10 block forwards and 10 block backwards a call, for ``sp = 2`` 3.
- :func:`ring_attention` (``impl="blockwise"``): the plain blockwise
  core, any chunk size or type; with ``remat`` (the default, as JAX's)
  each visit is recomputed in the backward (``torch.utils.checkpoint``).
- :func:`ulysses_attention`: all-to-all from sequence to head shards, a
  local attention core at full length, all-to-all back.

The ``attn_fn`` factories (:func:`ring_attn_fn`, :func:`ulysses_attn_fn`)
are the reference's ``_sp_sharded``, in two contexts:

* **Outside a strategy's rank** (a plain model with ``attn_fn=
  ring_attn_fn(mesh)`` on a local mesh), whole ``(B, S, H, D)`` tensors
  come in and the function plays every rank: the batch split over
  ``dp``, the sequence over ``axis``, each dp piece's ring one call of
  the core on all its heads (attention is independent per head, so
  splitting them over ``head_axis`` would change no number).
* **Inside a strategy's rank**, the rank's tensors come in: its dp piece
  and, under Megatron's column-parallel qkv, its ``H/tp`` heads.  The
  seam is ``attn_fn.for_rank(handle)``: ``ShardingStrategy.install``
  replaces each ``MultiHeadAttention``'s ``attn_fn`` by the one bound to
  the rank's ``RankHandle``, beside the layers' ``_tp_setup``.  The bound
  function meets its ``sp`` group through ``RankHandle.collective`` in
  one list collective (``_island``): each rank keeps its chunk of its own
  q, k, v (``scatter_to_group``, whose backward gathers the chunks'
  gradients), the core rings over the group, and the outputs are
  gathered (``gather_from_group``, whose backward is each rank's slice of
  its own gradient).  On a local mesh the group's ring is one call of
  the group-level core, so one autograd node spans the group, as every
  collective there does (``parallel.ranks``).  Each rank holds its dp
  piece's whole sequence outside the attention, as the reference's
  ``shard_map`` island leaves it, so every weight gradient is equal over
  ``sp`` and is not summed over it.  A rank rings the heads it holds:
  with ``head_axis="tp"`` its tp shard; without it, whatever the layer
  gave it, which under Megatron is the same shard and the same numbers
  as the reference's reshard (gather the heads over tp on entry, scatter
  them on exit).  Ulysses needs the heads a rank holds to divide over
  ``sp``.  On a process mesh the attention runs only bound to its rank.

The returned ``attn_fn`` has ``spec``, the reference's ``P("dp", axis,
head_axis)``.  The CUDA kernels take any chunk length and have fixed
64-row tiles, so the JAX entries' ``interpret``, ``block_q`` and
``block_k`` (Pallas block choices) have no counterpart and are not
accepted.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from hetu_tpu_torch.obs.numerics import kernel_op
from hetu_tpu_torch.ops.kernels.flash import (flash_attn_fn,
                                              flash_block_bwd,
                                              flash_block_fwd)
from hetu_tpu_torch.parallel.collectives import (_process, all_to_all,
                                                 gather_from_group,
                                                 scatter_to_group, send_next)
from hetu_tpu_torch.parallel.mesh import local_mesh_size
from hetu_tpu_torch.parallel.ranks import RankHandle
from hetu_tpu_torch.parallel.spec import P

__all__ = ["ring_attention", "ring_flash_attention", "ulysses_attention",
           "ring_attn_fn", "ulysses_attn_fn"]

_NEG = -1e30


def _scale(d, scale):
    return scale if scale is not None else 1.0 / (d ** 0.5)


def _ring_pos(n_list: int, axis, mesh) -> tuple:
    """The ring's size and the ring index of each listed chunk."""
    if _process(mesh):
        _, ranks = mesh.group(axis)
        return len(ranks), [ranks.index(mesh.rank)]
    return n_list, list(range(n_list))


def _visit(r: int, src: int, causal: bool):
    """The kernel's mask for rank ``r`` holding chunk ``src``: causal on
    the diagonal, unmasked for past chunks, None (skipped) for future
    chunks under causal masking."""
    if not causal:
        return False
    if src > r:
        return None
    return src == r


def _add(acc, x):
    return x if acc is None else acc + x


class _RingFlash(torch.autograd.Function):
    """``apply(causal, scale, axis, mesh, *qs, *ks, *vs)`` over the listed
    chunks ``(b, c, h, d)``; returns their outputs.  Saves each chunk's
    q, k, v in the kernels' ``(b, h, c, d)`` layout (made contiguous once
    here, not once per visit), its output in q's type and its GLOBAL
    lse."""

    @staticmethod
    def forward(ctx, causal, scale, axis, mesh, *chunks):
        n = len(chunks) // 3
        qs, ks, vs = ([c.transpose(1, 2).contiguous()
                       for c in chunks[i * n:(i + 1) * n]] for i in range(3))
        outs, lses = _ring_flash_fwd(qs, ks, vs, causal, scale, axis, mesh)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.causal, ctx.scale, ctx.n = causal, scale, n
        ctx.axis, ctx.mesh = axis, mesh
        return tuple(o.transpose(1, 2) for o in outs)

    @staticmethod
    def backward(ctx, *gs):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        dq, dk, dv = _ring_flash_bwd(qs, ks, vs, outs, lses, gs, ctx.causal,
                                     ctx.scale, ctx.axis, ctx.mesh)
        grads = [g.transpose(1, 2).to(x.dtype)
                 for g, x in zip(dq + dk + dv, qs + ks + vs)]
        return (None, None, None, None, *grads)


def _ring_flash_fwd(qs, ks, vs, causal, scale, axis=None, mesh=None):
    """Each chunk folds its visits' ``(out_t, lse_t)`` into an online
    logsumexp in visit order; a skipped visit (lse -1e30) would leave the
    fold unchanged, so it is not run.  K/V hop after every visit but the
    last.  Returns the outputs in q's type and the global lse,
    ``(b, h, c, 1)`` fp32."""
    n, at = _ring_pos(len(qs), axis, mesh)
    kb, vb = list(ks), list(vs)
    m = [torch.full_like(q[..., :1], _NEG, dtype=torch.float32) for q in qs]
    s = [torch.zeros_like(x) for x in m]
    o = [torch.zeros_like(q, dtype=torch.float32) for q in qs]
    for t in range(n):
        for i, r in enumerate(at):
            mask = _visit(r, (r - t) % n, causal)
            if mask is None:
                continue
            out_t, lse_t = kernel_op("flash_block_fwd", flash_block_fwd,
                                     qs[i], kb[i], vb[i], scale=scale,
                                     causal=mask)
            m_new = torch.maximum(m[i], lse_t)
            c_old = torch.where(m[i] <= _NEG, 0.0, torch.exp(m[i] - m_new))
            c_t = torch.where(lse_t <= _NEG, 0.0, torch.exp(lse_t - m_new))
            s[i] = s[i] * c_old + c_t
            o[i] = o[i] * c_old + out_t.float() * c_t
            m[i] = m_new
        if t < n - 1:
            kb = send_next(kb, axis, mesh=mesh)
            vb = send_next(vb, axis, mesh=mesh)
    outs, lses = [], []
    for i, q in enumerate(qs):
        si = s[i].clamp_min(1e-30)
        outs.append((o[i] / si).to(q.dtype))
        lses.append(m[i] + torch.log(si))
    return outs, lses


def _ring_flash_bwd(qs, ks, vs, outs, lses, gs, causal, scale, axis=None,
                    mesh=None):
    """delta = rowsum(dO * O) once per chunk from the rounded output; then
    K/V circulate again with fp32 dK/dV accumulators riding along, each
    visit adding the block backward fed the global lse and delta (every
    chunk's first visit is its diagonal one, so no accumulator travels
    empty).  After the full cycle every accumulator is home, summed in
    visit order, the order an NCCL ring sums in."""
    n, at = _ring_pos(len(qs), axis, mesh)
    dos = [g.transpose(1, 2) for g in gs]
    deltas = [(do.float() * o.float()).sum(dim=-1, keepdim=True)
              for do, o in zip(dos, outs)]
    dos = [do.to(q.dtype).contiguous() for do, q in zip(dos, qs)]
    k_n = len(qs)
    kb, vb = list(ks), list(vs)
    dkb, dvb, dq = [None] * k_n, [None] * k_n, [None] * k_n
    for t in range(n):
        for i, r in enumerate(at):
            mask = _visit(r, (r - t) % n, causal)
            if mask is None:
                continue
            dq_t, dk_t, dv_t = kernel_op(
                "flash_block_bwd", flash_block_bwd, qs[i], kb[i], vb[i],
                dos[i], lses[i], deltas[i], scale=scale, causal=mask)
            dq[i] = _add(dq[i], dq_t)
            dkb[i] = _add(dkb[i], dk_t)
            dvb[i] = _add(dvb[i], dv_t)
        if t < n - 1:
            kb = send_next(kb, axis, mesh=mesh)
            vb = send_next(vb, axis, mesh=mesh)
        dkb = send_next(dkb, axis, mesh=mesh)
        dvb = send_next(dvb, axis, mesh=mesh)
    return dq, dkb, dvb


def ring_flash_attention(qs, ks, vs, *, causal: bool = False,
                         scale: Optional[float] = None, axis=None,
                         mesh=None) -> list:
    """Ring attention with the flash kernels as the block core: the
    listed chunks ``(b, c, h, d)`` in (the module docstring says which),
    their outputs out, differentiable in every chunk."""
    sc = _scale(qs[0].shape[-1], scale)
    return list(_RingFlash.apply(bool(causal), float(sc), axis, mesh,
                                 *qs, *ks, *vs))


def _block(qb, kb, vb, q0, k0, causal, scale):
    """One K/V chunk folded into the online softmax: the block's rowmax,
    exp-sum and V-weighted partial, fp32.  Products take the inputs'
    values and accumulate in fp32, as ``preferred_element_type=f32``."""
    logits = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) * scale
    if causal:
        q_pos = q0 + torch.arange(qb.shape[1], device=qb.device)
        k_pos = k0 + torch.arange(kb.shape[1], device=kb.device)
        cm = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(cm, logits, _NEG)
    m = logits.amax(dim=-1)                                # (b, h, q)
    p = torch.exp(logits - m[..., None])
    p = torch.where((m == _NEG)[..., None], 0.0, p)        # masked rows
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(vb.dtype).float(), vb.float())
    return m, l, o


def ring_attention(qs, ks, vs, *, causal: bool = False,
                   scale: Optional[float] = None, remat: bool = True,
                   axis=None, mesh=None) -> list:
    """Blockwise ring attention in plain PyTorch: the listed chunks
    ``(b, c, h, d)`` in, their outputs (q's type) out.  Every visit runs,
    masked ones included, as the JAX scan does; with ``remat`` each is
    recomputed in the backward."""
    n, at = _ring_pos(len(qs), axis, mesh)
    b, c, h, d = qs[0].shape
    sc = _scale(d, scale)
    kb, vb = list(ks), list(vs)
    zero = qs[0].new_zeros((b, h, c), dtype=torch.float32)
    m, l = [zero + _NEG] * len(qs), [zero] * len(qs)
    o = [torch.zeros_like(q, dtype=torch.float32) for q in qs]
    for t in range(n):
        for i, r in enumerate(at):
            src = (r - t) % n
            args = (qs[i], kb[i], vb[i], r * c, src * c, causal, sc)
            bm, bl, bo = (checkpoint(_block, *args, use_reentrant=False)
                          if remat else _block(*args))
            m_new = torch.maximum(m[i], bm)
            c_old = torch.where(m[i] == _NEG, 0.0, torch.exp(m[i] - m_new))
            c_new = torch.where(bm == _NEG, 0.0, torch.exp(bm - m_new))
            l[i] = l[i] * c_old + bl * c_new
            o[i] = (o[i] * c_old.transpose(1, 2)[..., None]
                    + bo * c_new.transpose(1, 2)[..., None])
            m[i] = m_new
        if t < n - 1:
            kb = send_next(kb, axis, mesh=mesh)
            vb = send_next(vb, axis, mesh=mesh)
    return [(o[i] / l[i].clamp_min(1e-30).transpose(1, 2)[..., None])
            .to(q.dtype) for i, q in enumerate(qs)]


def ulysses_attention(qs, ks, vs, *, causal: bool = False, mask=None,
                      inner_fn: Optional[Callable] = None, axis=None,
                      mesh=None) -> list:
    """DeepSpeed-Ulysses: all-to-all from sequence chunks to head shards,
    ``inner_fn(q, k, v, mask, causal=...)`` at full length on each
    rank's heads (default: the materialized core), all-to-all back.
    Heads must divide by the number of ranks."""
    from hetu_tpu_torch.layers.attention import dot_product_attention
    inner = inner_fn or dot_product_attention
    sp, _ = _ring_pos(len(qs), axis, mesh)
    h = qs[0].shape[2]
    if h % sp:
        raise ValueError(f"{h} heads not divisible over sp={sp}")

    def swap(xs, split, concat):
        return all_to_all(xs, axis, split_dim=split, concat_dim=concat,
                          mesh=mesh)

    outs = [inner(q, k, v, mask, causal=causal) for q, k, v in
            zip(swap(qs, 2, 1), swap(ks, 2, 1), swap(vs, 2, 1))]
    return swap(outs, 1, 2)


def _island(xs: list, axis, *, mesh, core, causal) -> list:
    """The list collective of one ``sp`` group's ranks, each ``(q, k, v)``
    over its dp piece's whole sequence: each rank's chunk cut, the
    core's ring over the group, the outputs gathered."""
    def cut(ts):
        return scatter_to_group(ts, axis, dim=1, mesh=mesh)

    qs, ks, vs = (cut([x[j] for x in xs]) for j in range(3))
    outs = core(qs, ks, vs, causal=causal, axis=axis, mesh=mesh)
    return gather_from_group(outs, axis, dim=1, mesh=mesh)


def _sp_sharded(core, mesh, axis: str, head_axis: Optional[str],
                handle: Optional[RankHandle] = None):
    """Wrap a core into a drop-in ``attn_fn`` for ``MultiHeadAttention``
    (the module docstring's two contexts: bound to ``handle``'s rank, or
    playing every rank when ``handle`` is None)."""
    sp = local_mesh_size(mesh, axis)
    if head_axis is not None and head_axis not in mesh.axis_names:
        raise ValueError(f"head_axis {head_axis!r} not in mesh axes "
                         f"{mesh.axis_names}")
    dp = mesh.shape["dp"]
    nh = mesh.shape[head_axis] if head_axis is not None else 1

    def attn_fn(q, k, v, mask=None, *, causal: bool = False):
        if mask is not None:
            raise NotImplementedError(
                "sequence-parallel attention supports causal/full, not "
                "padding masks yet")
        if q.shape[1] % sp or k.shape[1] != q.shape[1]:
            raise ValueError(f"sequence length {q.shape[1]} (keys "
                             f"{k.shape[1]}) must be one length divisible "
                             f"by {axis}={sp}")
        if handle is not None:
            return handle.collective(_island, (q, k, v), axis, core=core,
                                     causal=causal)
        if _process(mesh):
            raise ValueError(
                "on a process mesh the attention runs bound to its rank: "
                "install the model with ShardingStrategy(mesh=...)")
        if q.device != mesh.device:
            raise ValueError(f"q lies on {q.device}, the mesh on "
                             f"{mesh.device}")
        if q.shape[0] % dp or q.shape[2] % nh:
            raise ValueError(f"batch {q.shape[0]} and heads {q.shape[2]} "
                             f"must divide over dp={dp} and "
                             f"{head_axis}={nh}")
        out = []
        for piece in zip(*(x.chunk(dp, 0) for x in (q, k, v))):
            outs = core(*(list(x.chunk(sp, dim=1)) for x in piece),
                        causal=causal)
            out.append(torch.cat(outs, dim=1))
        return torch.cat(out, dim=0)

    def for_rank(rank: RankHandle):
        """This ``attn_fn`` bound to ``rank`` (``ShardingStrategy.install``
        calls it for each rank's attention layers)."""
        if dict(rank.mesh.shape) != dict(mesh.shape):
            raise ValueError(f"the attention's mesh {mesh.shape} is not "
                             f"its rank's {rank.mesh.shape}")
        return _sp_sharded(core, mesh, axis, head_axis, rank)

    attn_fn.spec = P("dp", axis, head_axis)
    attn_fn.for_rank = for_rank
    return attn_fn


def ring_attn_fn(mesh, axis: str = "sp", *, remat: bool = True,
                 impl: str = "flash", head_axis: Optional[str] = None):
    """``attn_fn`` running ring attention over ``axis``; plug into
    ``MultiHeadAttention(attn_fn=...)``.  ``impl="flash"`` (default) runs
    the flash block kernels with the ring-level backward;
    ``impl="blockwise"`` the plain core, whose visits are recomputed in
    the backward when ``remat`` (the flash core keeps its block
    statistics and ignores it, as the reference's does).
    ``head_axis="tp"`` keeps the heads tp-sharded through the ring."""
    if impl == "flash":
        core = ring_flash_attention
    elif impl == "blockwise":
        def core(qs, ks, vs, *, causal, axis=None, mesh=None):
            return ring_attention(qs, ks, vs, causal=causal, remat=remat,
                                  axis=axis, mesh=mesh)
    else:
        raise ValueError(f"unknown ring impl {impl!r}")
    return _sp_sharded(core, mesh, axis, head_axis)


def ulysses_attn_fn(mesh, axis: str = "sp", *,
                    inner_fn: Optional[Callable] = None,
                    head_axis: Optional[str] = None):
    """``attn_fn`` running Ulysses attention over ``axis``.  The local core
    defaults to the flash kernels (``flash_attn_fn()``), each rank holding
    the full sequence for its head slice; with ``head_axis="tp"`` the
    exchange redistributes only the rank's tp heads, so ``heads / tp``
    must divide over ``sp``."""
    inner = inner_fn or flash_attn_fn()

    def core(qs, ks, vs, *, causal, axis=None, mesh=None):
        return ulysses_attention(qs, ks, vs, causal=causal, inner_fn=inner,
                                 axis=axis, mesh=mesh)

    return _sp_sharded(core, mesh, axis, head_axis)

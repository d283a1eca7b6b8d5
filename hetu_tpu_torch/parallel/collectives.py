"""Collectives (counterpart of ``hetu_tpu/parallel/collectives.py``).

Every collective takes **the list of shards this process holds, in rank
order**, and returns the list each of those ranks holds afterwards:

* on a :class:`~hetu_tpu_torch.parallel.mesh.LocalMesh` the list has one
  entry per rank of the mesh (all of them lie on the one device), and
  the collective is a re-index, a sum or a concatenation within each
  group of ``axis``;
* on a :class:`~hetu_tpu_torch.parallel.mesh.ProcessMesh` the list has
  one entry, this process's, and the collective calls
  ``torch.distributed`` over the process group of ``axis``;
* with ``mesh=None`` the list is the ranks of one axis on one device
  (the form the ring and the MoE exchange use).

The semantics are ``jax.lax``'s under ``shard_map``: ``reduce_scatter``
and ``all_gather`` are tiled, ``ppermute`` gives zeros to a rank that
receives nothing, ``hierarchical_all_to_all`` over ``(outer, inner)`` is
the flat exchange over both axes (the outer index outermost).

**Autograd.**  On a local mesh the re-indexing, sums and concatenations
are torch ops, so every collective there is differentiable.  The three
that tensor-parallel layers differentiate through have Megatron's
gradients on both meshes, as ``torch.autograd.Function``\\ s:
:func:`all_reduce` (sum forward, identity backward: each rank keeps its
own upstream gradient), :func:`copy_to_group` (identity forward, sum of
the group's gradients backward) and :func:`gather_from_group` (tiled
gather forward, each rank's slice of its own gradient backward).
:func:`scatter_to_group` is the gather's transpose (each rank's slice of
its own tensor forward, the tiled gather of the group's gradients
backward): the two bound sequence-parallel attention, whose ranks hold
the whole sequence outside it (``parallel.ring_attention``).
:func:`ppermute` carries its gradient across processes too: its
backward is the permutation's inverse, as ``lax.ppermute``'s transpose
is (the pipelines' activation hops, ``parallel.pipeline``, and the
ring's K/V hops), and so does :func:`all_to_all`, over one axis or a
tuple of them: its backward is the transposed exchange (split and
concatenated dimensions swapped), as ``lax.all_to_all``'s is (Ulysses,
the expert exchange), and :func:`all_gather`: its backward is the
reduce-scatter of the group's gradients, as ``lax.all_gather``'s
transpose is (the expert layer's routing block under a strategy).  The
others carry no gradient across processes.

**Backends.**  Where the process group's backend lacks an op for the
tensor's device (gloo with CUDA tensors takes ``all_reduce`` and
``broadcast`` only), the op is composed from ``all_reduce``: a gather
is the sum of zero buffers in which each rank filled its own slot, a
reduce-scatter is the sum's slice; :func:`counts` lists such
compositions under ``composed``.  Only names that torch 2.11 and later
both keep are called (the list forms ``all_gather``, ``reduce_scatter``
and ``all_to_all``, ``batch_isend_irecv``).

**Counters.**  Each call adds one to its kind's ``calls`` and the bytes
of the shards it was given (all of them on a local mesh, this process's
on a process mesh) to its ``bytes``, as the kernels count launches;
:func:`reset_counts` zeroes them.  Under :func:`timed` each process-mesh
call also adds its wall time (the card synchronized before and after)
to ``s``.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = [
    "all_reduce", "all_reduce_mean", "reduce_scatter", "all_gather",
    "all_to_all", "hierarchical_all_to_all", "broadcast", "ppermute",
    "send_next", "recv_prev", "axis_index", "axis_size", "pmean",
    "copy_to_group", "gather_from_group", "scatter_to_group", "counts",
    "reset_counts", "timed",
]

_COUNTS: dict = {}
_TIMED = False


def counts() -> dict:
    """``{kind: {"calls", "bytes", "s", "composed"}}`` since the last
    reset (``composed``: calls built from ``all_reduce``)."""
    return {k: dict(v) for k, v in sorted(_COUNTS.items())}


def reset_counts() -> None:
    _COUNTS.clear()


@contextlib.contextmanager
def timed():
    """Time every process-mesh call inside the block into ``s``."""
    global _TIMED
    prev, _TIMED = _TIMED, True
    try:
        yield
    finally:
        _TIMED = prev


def _count(kind: str, shards, composed: bool = False, s: float = 0.0):
    c = _COUNTS.setdefault(kind, {"calls": 0, "bytes": 0, "s": 0.0,
                                  "composed": 0})
    c["calls"] += 1
    c["bytes"] += sum(x.numel() * x.element_size() for x in shards
                      if isinstance(x, torch.Tensor))
    c["composed"] += int(composed)
    c["s"] += s


def _process(mesh) -> bool:
    return mesh is not None and hasattr(mesh, "group")


def _groups(shards, axis, mesh) -> list:
    """The local list's groups on ``axis`` (indices into ``shards``)."""
    if mesh is None or axis is None:
        return [list(range(len(shards)))]
    groups = mesh.groups(axis)
    if sum(map(len, groups)) != len(shards):
        raise ValueError(f"{len(shards)} shards for a mesh of "
                         f"{mesh.size} ranks")
    return groups


def _native(mesh, x, op: str) -> bool:
    """Whether the process group's backend runs ``op`` on ``x``'s
    device (gloo on CUDA tensors runs only all_reduce and broadcast)."""
    if mesh.backend == "gloo" and x.is_cuda:
        return op in ("all_reduce", "broadcast")
    return True


def _sync(x):
    if _TIMED and x.is_cuda:
        torch.cuda.synchronize(x.device)


def _run(kind, mesh, x, fn, composed=False):
    """One process-mesh call: counted, timed under :func:`timed`."""
    _sync(x)
    t0 = time.perf_counter()
    out = fn()
    _sync(x)
    _count(kind, [x], composed, time.perf_counter() - t0 if _TIMED else 0.)
    return out


def _dist_sum(x, mesh, axis):
    import torch.distributed as dist
    g, _ = mesh.group(axis)
    y = x.detach().clone()
    dist.all_reduce(y, group=g)
    return y


def _dist_gather(x, mesh, axis) -> list:
    """Every rank of the group's ``x`` (equal shapes), in group order."""
    import torch.distributed as dist
    g, ranks = mesh.group(axis)
    x = x.detach().contiguous()
    if _native(mesh, x, "all_gather"):
        out = [torch.empty_like(x) for _ in ranks]
        dist.all_gather(out, x, group=g)
        return out
    buf = torch.zeros((len(ranks),) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[ranks.index(mesh.rank)] = x
    dist.all_reduce(buf, group=g)
    return list(buf.unbind(0))


# --------------------------------------------------------------------------
# the differentiable three (Megatron's conjugate pair, and the gather)
# --------------------------------------------------------------------------


class _LocalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, mean, *xs):
        outs = [None] * len(xs)
        for g in groups:
            s = xs[g[0]]
            for i in g[1:]:
                s = s + xs[i]
            if mean:
                s = s / len(g)
            for i in g:
                outs[i] = s.clone()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dys):
        return (None, None, *dys)


class _LocalCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, *xs):
        ctx.groups = groups
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *dys):
        _count("all_reduce", dys)
        dxs = [None] * len(dys)
        for g in ctx.groups:
            s = dys[g[0]]
            for i in g[1:]:
                s = s + dys[i]
            # each rank its own tensor: autograd may accumulate into a
            # gradient in place
            for k, i in enumerate(g):
                dxs[i] = s if k == 0 else s.clone()
        return (None, *dxs)


class _LocalGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, dim, *xs):
        ctx.groups, ctx.dim = groups, dim
        ctx.sizes = [x.shape[dim] for x in xs]
        outs = [None] * len(xs)
        for g in groups:
            cat = torch.cat([xs[i] for i in g], dim=dim)
            for i in g:
                outs[i] = cat.clone()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dys):
        dxs = [None] * len(dys)
        for g in ctx.groups:
            off = 0
            for i in g:
                n = ctx.sizes[i]
                dxs[i] = dys[i].narrow(ctx.dim, off, n)
                off += n
        return (None, None, *dxs)


class _LocalScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, dim, *xs):
        ctx.groups, ctx.dim = groups, dim
        outs = [None] * len(xs)
        for g in groups:
            for k, i in enumerate(g):
                outs[i] = xs[i].chunk(len(g), dim)[k].clone()
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dys):
        _count("all_gather", dys)
        dxs = [None] * len(dys)
        for g in ctx.groups:
            full = torch.cat([dys[i] for i in g], dim=ctx.dim)
            for k, i in enumerate(g):
                dxs[i] = full if k == 0 else full.clone()
        return (None, None, *dxs)


class _ProcSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        y = _run("all_reduce", mesh, x, lambda: _dist_sum(x, mesh, axis))
        return y / len(mesh.group(axis)[1]) if mean else y

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None, None


class _ProcCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return (_run("all_reduce", ctx.mesh, dy,
                     lambda: _dist_sum(dy, ctx.mesh, ctx.axis)), None, None)


class _ProcGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        _, ranks = mesh.group(axis)
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.at = ranks.index(mesh.rank)
        parts = _run("all_gather", mesh, x,
                     lambda: _dist_gather(x, mesh, axis),
                     composed=not _native(mesh, x, "all_gather"))
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.at * ctx.n, ctx.n), None, None, None


class _ProcScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        _, ranks = mesh.group(axis)
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return x.chunk(len(ranks), dim)[ranks.index(mesh.rank)].clone()

    @staticmethod
    def backward(ctx, dy):
        parts = _run("all_gather", ctx.mesh, dy,
                     lambda: _dist_gather(dy, ctx.mesh, ctx.axis),
                     composed=not _native(ctx.mesh, dy, "all_gather"))
        return torch.cat(parts, dim=ctx.dim), None, None, None


def all_reduce(shards: list, axis=None, *, mesh=None) -> list:
    """Sum over ``axis``'s groups (``lax.psum``); differentiable with
    Megatron's gradient (identity: each rank keeps its own)."""
    if _process(mesh):
        return [_ProcSum.apply(shards[0], mesh, axis, False)]
    _count("all_reduce", shards)
    return list(_LocalSum.apply(_groups(shards, axis, mesh), False,
                                *shards))


def all_reduce_mean(shards: list, axis=None, *, mesh=None) -> list:
    """Mean over ``axis``'s groups (``lax.pmean``): the sum, divided."""
    if _process(mesh):
        return [_ProcSum.apply(shards[0], mesh, axis, True)]
    _count("all_reduce", shards)
    return list(_LocalSum.apply(_groups(shards, axis, mesh), True, *shards))


pmean = all_reduce_mean


def copy_to_group(shards: list, axis=None, *, mesh=None) -> list:
    """Identity forward; backward, the sum of the group's gradients (the
    input of a column-parallel product: each rank's part of dx)."""
    if _process(mesh):
        return [_ProcCopy.apply(shards[0], mesh, axis)]
    return list(_LocalCopy.apply(_groups(shards, axis, mesh), *shards))


def gather_from_group(shards: list, axis=None, *, dim: int = -1,
                      mesh=None) -> list:
    """Tiled all-gather along ``dim`` (the shards may differ in size
    there on a local mesh); backward, each rank's slice of its own
    gradient."""
    dim = dim % shards[0].dim()
    if _process(mesh):
        return [_ProcGather.apply(shards[0], mesh, axis, dim)]
    _count("all_gather", shards)
    return list(_LocalGather.apply(_groups(shards, axis, mesh), dim,
                                   *shards))


def scatter_to_group(shards: list, axis=None, *, dim: int = -1,
                     mesh=None) -> list:
    """Rank ``i`` of each group keeps the ``i``-th of ``n`` equal pieces
    of its own tensor along ``dim`` (the ranks hold the same values);
    backward, the tiled gather of the group's gradients, so each rank
    gets the whole gradient (:func:`gather_from_group`'s transpose)."""
    dim = dim % shards[0].dim()
    if _process(mesh):
        return [_ProcScatter.apply(shards[0], mesh, axis, dim)]
    return list(_LocalScatter.apply(_groups(shards, axis, mesh), dim,
                                    *shards))


# --------------------------------------------------------------------------
# the rest of the JAX names
# --------------------------------------------------------------------------


def reduce_scatter(shards: list, axis=None, *, scatter_dim: int = 0,
                   tiled: bool = True, mesh=None) -> list:
    """Sum over the group, then rank ``i`` of the group keeps the
    ``i``-th of ``n`` equal pieces along ``scatter_dim``
    (``lax.psum_scatter``; ``tiled=False`` drops that dimension, whose
    size must then be ``n``)."""
    if _process(mesh):
        x = shards[0]
        _, ranks = mesh.group(axis)
        n, at = len(ranks), ranks.index(mesh.rank)

        def native():
            import torch.distributed as dist
            ins = [c.contiguous() for c in x.detach().chunk(n, scatter_dim)]
            out = torch.empty_like(ins[at])
            dist.reduce_scatter(out, ins, group=mesh.group(axis)[0])
            return out

        composed = not _native(mesh, x, "reduce_scatter")
        y = _run("reduce_scatter", mesh, x, native if not composed else
                 (lambda: _dist_sum(x, mesh, axis).chunk(n, scatter_dim)[at]
                  .contiguous()), composed)
        return [y if tiled else y.squeeze(scatter_dim)]
    _count("reduce_scatter", shards)
    out = [None] * len(shards)
    for g in _groups(shards, axis, mesh):
        s = shards[g[0]]
        for i in g[1:]:
            s = s + shards[i]
        for j, piece in enumerate(s.chunk(len(g), scatter_dim)):
            out[g[j]] = piece if tiled else piece.squeeze(scatter_dim)
    return out


class _ProcAllGather(torch.autograd.Function):
    """The tiled gather over ``axis``'s process group; backward, the sum
    over the group of the gradients of this process's slice."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        parts = _run("all_gather", mesh, x,
                     lambda: _dist_gather(x, mesh, axis),
                     composed=not _native(mesh, x, "all_gather"))
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, dy):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        dy = dy.contiguous()
        _, ranks = mesh.group(axis)
        n, at = len(ranks), ranks.index(mesh.rank)
        dx = _run("reduce_scatter", mesh, dy,
                  lambda: _dist_sum(dy, mesh, axis).chunk(n, dim)[at]
                  .contiguous(), composed=True)
        return dx, None, None, None


def all_gather(shards: list, axis=None, *, gather_dim: int = 0,
               tiled: bool = True, mesh=None) -> list:
    """Every rank gets the group's shards joined along ``gather_dim``
    (``lax.all_gather``; ``tiled=False`` stacks them on a new
    dimension there).  Differentiable on both meshes: the backward gives
    each rank the sum over the group of its slice's gradients."""
    if _process(mesh):
        x = shards[0]
        if tiled and torch.is_grad_enabled() and x.requires_grad:
            return [_ProcAllGather.apply(x, mesh, axis,
                                         gather_dim % x.dim())]
        parts = _run("all_gather", mesh, x,
                     lambda: _dist_gather(x, mesh, axis),
                     composed=not _native(mesh, x, "all_gather"))
        return [torch.cat(parts, gather_dim) if tiled
                else torch.stack(parts, gather_dim)]
    _count("all_gather", shards)
    out = [None] * len(shards)
    for g in _groups(shards, axis, mesh):
        parts = [shards[i] for i in g]
        joined = (torch.cat(parts, gather_dim) if tiled
                  else torch.stack(parts, gather_dim))
        for i in g:
            out[i] = joined
    return out


def all_to_all(shards: list, axis=None, *, split_dim: int,
               concat_dim: int, tiled: bool = True, mesh=None) -> list:
    """Tiled all-to-all: every rank splits its shard along ``split_dim``
    into one piece per rank of the group, and rank ``r`` concatenates
    the ``r``-th pieces along ``concat_dim`` in group order."""
    if _process(mesh):
        return [_ProcAllToAll.apply(shards[0], mesh, axis, split_dim,
                                    concat_dim)]
    _count("all_to_all", shards)
    out = [None] * len(shards)
    for g in _groups(shards, axis, mesh):
        pieces = [shards[i].chunk(len(g), dim=split_dim) for i in g]
        for r, i in enumerate(g):
            out[i] = torch.cat([p[r] for p in pieces], dim=concat_dim)
    return out


def _proc_all_to_all(x, mesh, axis, split_dim, concat_dim):
    """This process's result of the tiled exchange over ``axis``."""
    _, ranks = mesh.group(axis)
    n, at = len(ranks), ranks.index(mesh.rank)

    def native():
        import torch.distributed as dist
        ins = [c.contiguous() for c in x.detach().chunk(n, split_dim)]
        outs = [torch.empty_like(c) for c in ins]
        dist.all_to_all(outs, ins, group=mesh.group(axis)[0])
        return outs

    composed = not _native(mesh, x, "all_to_all")
    parts = _run("all_to_all", mesh, x, native if not composed else
                 (lambda: [p.chunk(n, split_dim)[at]
                           for p in _dist_gather(x, mesh, axis)]),
                 composed)
    return torch.cat(parts, concat_dim)


class _ProcAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, concat_dim, split_dim)
        return _proc_all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, dy):
        return (_proc_all_to_all(dy.contiguous(), *ctx.args), None, None,
                None, None)


def hierarchical_all_to_all(shards: list, outer_axis: str, inner_axis: str,
                            *, split_dim: int, concat_dim: int,
                            mesh=None) -> list:
    """The hierarchical exchange (intra-node gather, inter-node
    exchange, intra-node scatter) is the flat all-to-all over the
    factored ``(outer, inner)`` axis pair, outer index outermost."""
    return all_to_all(shards, (outer_axis, inner_axis), split_dim=split_dim,
                      concat_dim=concat_dim, mesh=mesh)


def broadcast(shards: list, axis=None, root: int = 0, *,
              mesh=None) -> list:
    """Every rank of the group gets the shard of the group's rank
    ``root``."""
    if _process(mesh):
        import torch.distributed as dist
        x = shards[0]
        g, ranks = mesh.group(axis)

        def call():
            y = x.detach().clone()
            dist.broadcast(y, src=ranks[root], group=g)
            return y

        return [_run("broadcast", mesh, x, call)]
    _count("broadcast", shards)
    out = [None] * len(shards)
    for g in _groups(shards, axis, mesh):
        for i in g:
            out[i] = shards[g[root]]
    return out


def ppermute(shards: list, perm, axis=None, *, mesh=None,
             after=None) -> list:
    """Point-to-point permutation within each group: for each
    ``(src, dst)`` pair of ``perm`` (indices on ``axis``), rank ``dst``
    receives rank ``src``'s shard; a rank that receives nothing gets
    zeros, as ``lax.ppermute`` gives.  ``after`` (a process mesh):
    another permutation's output whose backward must wait for this
    one's, so that every process runs a chain of them backward in one
    order (the pipelines pass the previous hop's)."""
    perm = [(int(s), int(d)) for s, d in perm]
    if _process(mesh):
        return [_ProcPermute.apply(shards[0], mesh, axis, tuple(perm),
                                   after)]
    _count("ppermute", [x for x in shards if isinstance(x, torch.Tensor)])
    out = list(shards)
    for g in _groups(shards, axis, mesh):
        got = {g[d]: shards[g[s]] for s, d in perm}
        for i in g:
            out[i] = got[i] if i in got else torch.zeros_like(shards[i])
    return out


def _proc_permute(x, mesh, axis, perm):
    """This process's piece after ``perm`` over ``axis``'s group."""
    _, ranks = mesh.group(axis)
    at = ranks.index(mesh.rank)
    srcs = [s for s, d in perm if d == at]
    dsts = [d for s, d in perm if s == at]

    def native():
        import torch.distributed as dist
        xc = x.detach().contiguous()
        got = torch.zeros_like(xc)
        # a rank's shard to itself is a copy, not a message
        ops = [dist.P2POp(dist.isend, xc, ranks[d]) for d in dsts
               if d != at]
        ops += [dist.P2POp(dist.irecv, got, ranks[s]) for s in srcs
                if s != at]
        if at in srcs:
            got.copy_(xc)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got

    def composed_call():
        parts = _dist_gather(x, mesh, axis)
        return parts[srcs[0]] if srcs else torch.zeros_like(x)

    composed = not _native(mesh, x, "ppermute")
    return _run("ppermute", mesh, x, composed_call if composed else native,
                composed)


class _ProcPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm, after):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.inverse = tuple((d, s) for s, d in perm)
        return _proc_permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, dy):
        return (_proc_permute(dy.contiguous(), ctx.mesh, ctx.axis,
                              ctx.inverse), None, None, None, None)


def _ring(shards, axis, mesh, step: int) -> list:
    if _process(mesh):
        n = len(mesh.group(axis)[1])
    else:
        n = len(_groups(shards, axis, mesh)[0])
    return ppermute(shards, [(i, (i + step) % n) for i in range(n)], axis,
                    mesh=mesh)


def send_next(shards: list, axis=None, *, mesh=None) -> list:
    """Ring shift toward higher ranks (rank i -> i+1, wrapping)."""
    return _ring(shards, axis, mesh, 1)


def recv_prev(shards: list, axis=None, *, mesh=None) -> list:
    """Ring shift toward lower ranks (rank i -> i-1, wrapping)."""
    return _ring(shards, axis, mesh, -1)


def axis_index(axis, *, mesh) -> list:
    """Each held rank's index on ``axis`` (a tuple: the combined index,
    first name outermost)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    out = []
    for r in mesh.held:
        c, i = mesh.coords(r), 0
        for a in axes:
            i = i * mesh.shape[a] + c[a]
        out.append(i)
    return out


def axis_size(axis, *, mesh) -> int:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n

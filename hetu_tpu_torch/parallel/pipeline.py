"""Pipeline parallelism over a mesh's ``pp`` axis (counterpart of
``hetu_tpu/parallel/pipeline.py``).

The JAX package runs a pipeline as one SPMD program: the blocks'
parameters are stacked on a leading ``layers`` axis split over ``pp``,
and a ``lax.scan`` over ticks moves each microbatch one stage a tick
through ``lax.ppermute``; autodiff through the scan gives GPipe's
backward.  The port keeps the wavefront and writes it per rank:

* **The stack** is an ``nn.ModuleList`` of the blocks (:class:`Stack`)
  whose parameters keep no stack dimension.  Their logical axes gain a
  leading ``layers`` entry (``parallel.spec.logical_axes``), which the
  rules place on ``pp``: under a sharding strategy a rank's module holds
  only its stage's blocks (the others are :class:`Absent`), with their
  tp shards.  The weight bridge and the checkpoints read and write the
  JAX layout's stacked ``[n_layers, ...]`` leaves
  (``interop.from_jax``).
* **The wavefront.**  Stage ``s`` runs microbatch ``m`` at tick
  ``m + s``; at the end of a tick each stage's output moves to the next
  stage through ``parallel.collectives.ppermute`` (a re-index on a
  local mesh, ``torch.distributed`` across processes, where its backward
  sends the gradients along the reverse ring).  A tick where a stage has
  no microbatch does no work (the JAX program computes a clipped
  microbatch there and throws the result away).  The output is the last
  stage's, for the whole batch; the backward is autograd's through the
  ticks, so the gradients are the whole batch's.
* **The keys** are the JAX package's bit for bit: without a pipeline
  block ``li`` draws ``fold_in(key, li)``; in one, microbatch ``m`` at
  the stage whose first layer is ``offset`` draws
  ``fold_in(fold_in(key, m), offset + li)``.
* **remat** names a ``mem.policy`` policy applied to each block.

Under a strategy (``parallel.strategies``) the pipeline's output is
published to every rank of the pp group (the JAX ``psum``; backward,
each rank keeps its own gradient) and the model's head runs on each of
them; the step seeds the backward from the last stage's loss alone, so
a parameter replicated over pp (an embedding tied to the head, the final
norm) gets its gradient once, as the sum over pp of the first stage's
part and the last's.  On a process mesh every other stage seeds the
chain of its hops (``Pipelined.sinks``) with zeros, so that each process
runs its hops' backwards in the one order the ring needs.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch import nn

from hetu_tpu_torch.core.prng import fold_in
from hetu_tpu_torch.parallel import collectives as col
from hetu_tpu_torch.parallel.pipedream import _microbatch

__all__ = ["stack_modules", "prepend_logical_axis", "stage_partition",
           "spmd_pipeline", "Pipelined", "Stack", "Absent"]


class Stack(nn.ModuleList):
    """Structurally identical blocks that the JAX package stacks into one
    module with ``[n_layers, ...]`` leaves.  ``stack_axis`` is the
    logical axis of that leading dimension (``layers``), or None."""

    stack_axis: Optional[str] = None


class Absent(nn.Module):
    """Where a rank's stack holds no block: another stage's."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this rank's stage does not hold the block")


def stack_modules(blocks) -> Stack:
    """The blocks as a :class:`Stack` (the port's ``[N, ...]`` stack;
    parameters keep their own shapes).  The blocks must have the same
    parameter names and shapes, as ``jnp.stack`` of their leaves
    requires."""
    blocks = list(blocks)
    if not blocks:
        raise ValueError("need at least one block")
    want = [(n, tuple(p.shape)) for n, p in blocks[0].named_parameters()]
    for i, b in enumerate(blocks[1:], 1):
        got = [(n, tuple(p.shape)) for n, p in b.named_parameters()]
        if got != want:
            raise ValueError(f"block {i} differs from block 0: {got} vs "
                             f"{want}")
    return Stack(blocks)


def prepend_logical_axis(module: Stack, axis_name: str = "layers") -> Stack:
    """Give every parameter of the stack's blocks a leading logical axis
    ``axis_name`` (``parallel.spec.logical_axes``), so the rules place
    the stack's layers on ``pp``."""
    if not isinstance(module, Stack):
        module = stack_modules(module)
    module.stack_axis = axis_name
    return module


def stage_partition(n_layers: int, n_stages: int) -> list:
    """Balanced contiguous layer -> stage assignment; ``Pipelined``
    itself needs ``n_layers % n_stages == 0``."""
    base, rem = divmod(n_layers, n_stages)
    out, start = [], 0
    for s in range(n_stages):
        size = base + (1 if s < rem else 0)
        out.append(range(start, start + size))
        start += size
    return out


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _stage_slice(params, s: int, S: int):
    """Stage ``s``'s parameters: entry ``s`` of a per-stage list, or row
    ``s`` of every tensor leaf of stacked ``[S, ...]`` parameters."""
    if isinstance(params, (list, tuple, nn.ModuleList)):
        if len(params) != S:
            raise ValueError(f"{len(params)} stage parameters for {S} "
                             f"stages")
        return params[s]

    def row(t):
        if t.shape[0] != S:
            raise ValueError(f"a leaf's leading dim {t.shape[0]} is not "
                             f"the {S} stages")
        return t[s]
    return _tree_map(row, params)


def _hop(shards, axis, *, mesh, perm, after=None):
    return col.ppermute(shards, perm, axis, mesh=mesh, after=after)


def _stage_loop(stage_fn, params, x, extras, key, *, handle, stage: int,
                S: int, M: int, axis: str, publish: bool):
    """One rank's part of the wavefront: ``(output, sink)``.  The output
    is the last stage's for the whole batch, published to every rank of
    the pp group (``publish``) or, unpublished, zeros on the other
    stages; ``sink`` is the last hop's output on a process mesh (None on
    a local one)."""
    xs = _microbatch(x, M, "x")
    exs = _tree_map(lambda e: _microbatch(e, M, "extras"), extras)
    chain = [(i, i + 1) for i in range(S - 1)]
    process = len(handle.mesh.held) == 1
    state, outs = None, []
    last_tick = M + S - 2
    for t in range(last_tick + 1):
        m = t - stage
        if 0 <= m < M:
            h = xs[m] if stage == 0 else state
            k = None if key is None else fold_in(key, m)
            y = stage_fn(params, h, _tree_map(lambda e: e[m], exs), k)
            if stage == S - 1:
                outs.append(y)
        else:
            y = torch.zeros_like(xs[0])
            if process and torch.is_grad_enabled():
                # every process's hops must each have a backward
                y.requires_grad_()
        if t < last_tick:
            state = handle.collective(_hop, y, axis, perm=chain,
                                      after=state if process else None)
    out = torch.cat(outs, 0) if stage == S - 1 else torch.zeros_like(x)
    if publish:
        out = handle.collective(col.all_reduce, out, axis)
    return out, (state if process else None)


def spmd_pipeline(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                  extras: Any = None, *, mesh, axis: str = "pp",
                  n_microbatches: int, key=None):
    """Run ``x`` through the stage ring of a local mesh's ``axis``; the
    last stage's output for the whole batch.

    ``stage_fn(stage_params_s, h, extras_mb, key_mb) -> h'`` is one
    stage's computation; ``stage_params`` is a list of the ``S`` stages'
    parameters or stacked ``[S, ...]`` tensors (stage ``s`` takes row
    ``s``); ``x`` and ``extras`` (batch-leading tensors, e.g. masks) are
    cut into ``n_microbatches``.  The stages run as the ranks of a
    ``pp`` mesh on the mesh's device (``parallel.ranks.run_ranks``); on
    a process mesh a pipeline runs under a sharding strategy
    (:class:`Pipelined` in a model given to ``Trainer(strategy=)``)."""
    from hetu_tpu_torch.parallel.mesh import LocalMesh, MeshSpec
    from hetu_tpu_torch.parallel.ranks import RankHandle, run_ranks
    if hasattr(mesh, "group"):
        raise NotImplementedError(
            "spmd_pipeline on a process mesh: run the Pipelined model "
            "under a sharding strategy (Trainer(strategy=...)), which "
            "seeds every stage's backward")
    S = mesh.shape[axis]
    if S == 1:
        return _sequential_microbatch(
            stage_fn, _stage_slice(stage_params, 0, 1), x, extras, key,
            n_microbatches)
    ring = LocalMesh(MeshSpec(pp=S), mesh.device)

    def rank(s):
        return _stage_loop(stage_fn, _stage_slice(stage_params, s, S), x,
                           extras, key, handle=RankHandle(ring, s), stage=s,
                           S=S, M=n_microbatches, axis="pp",
                           publish=False)[0]

    outs = run_ranks(ring, [lambda s=s: rank(s) for s in range(S)])
    return outs[S - 1]


def _sequential_microbatch(stage_fn, params, x, extras, key, M):
    xs = _microbatch(x, M, "x")
    exs = _tree_map(lambda e: _microbatch(e, M, "extras"), extras)
    return torch.cat([
        stage_fn(params, xs[m], _tree_map(lambda e: e[m], exs),
                 None if key is None else fold_in(key, m))
        for m in range(M)], 0)


class Pipelined(nn.Module):
    """A homogeneous block stack pipelined over the mesh's ``axis``.

    ``Pipelined(blocks, n_microbatches=8, mesh=mesh)(x, mask, key=key,
    training=True)`` stands where a sequential stack would.  With
    ``mesh=None`` (or an axis of size 1) the blocks run in order, block
    ``li`` under ``fold_in(key, li)``.  On a mesh the layers split evenly
    over its ``axis`` and the batch runs as ``n_microbatches`` through
    the GPipe wavefront (module docstring): standalone, the stages run in
    turn on the mesh's device; installed by a sharding strategy whose
    mesh has the axis, each rank runs its own stage.  ``remat`` names a
    ``mem.policy`` policy for each block ('full' by default, 'none' to
    save every activation)."""

    def __init__(self, blocks, *, n_microbatches: int, mesh=None,
                 axis: str = "pp", remat="full"):
        super().__init__()
        from hetu_tpu_torch.mem.policy import normalize_remat
        n_stages = mesh.shape[axis] if mesh is not None else 1
        if len(blocks) % max(n_stages, 1):
            raise ValueError(f"{len(blocks)} layers not divisible into "
                             f"{n_stages} stages")
        self.stacked = prepend_logical_axis(stack_modules(blocks), "layers")
        self.n_layers = len(blocks)
        self.n_microbatches = n_microbatches
        self.axis = axis
        self.mesh = mesh
        self.remat = normalize_remat(remat)
        self._rank = None     # (handle, stage, stages) once installed
        self.sinks = []       # the hop chains' ends on a process mesh

    def _pp_setup(self, handle, coords: dict, shape: dict) -> None:
        """A strategy installs this rank's module: keep this stage's
        blocks only and run the rank's part of the wavefront."""
        S = shape.get(self.axis, 1)
        own = self.mesh.shape[self.axis] if self.mesh is not None else 1
        if own != S:
            raise ValueError(
                f"a Pipelined built for {self.axis}={own} under a strategy "
                f"whose mesh has {self.axis}={S}: build it with the "
                f"strategy's mesh")
        if S == 1:
            return
        s, L = coords[self.axis], self.n_layers // S
        for li in range(self.n_layers):
            if li // L != s:
                self.stacked[li] = Absent()
        self._rank = (handle, s, S)

    def _block_apply(self, blk, h, mask, key, training):
        from hetu_tpu_torch.mem.policy import apply_policy
        fn = lambda b, v, m, k: b(v, m, key=k, training=training)  # noqa: E731
        return apply_policy(fn, self.remat)(blk, h, mask, key)

    def _run_stage(self, stage, h, mask, key, training):
        offset, blocks = stage
        for j, blk in enumerate(blocks):
            k = None if key is None else fold_in(key, offset + j)
            h = self._block_apply(blk, h, mask, k, training)
        return h

    def forward(self, x, mask=None, *, key=None, training: bool = False):
        if self._rank is None and (self.mesh is None
                                   or self.mesh.shape[self.axis] <= 1):
            for li, blk in enumerate(self.stacked):
                k = None if key is None else fold_in(key, li)
                x = self._block_apply(blk, x, mask, k, training)
            return x
        fn = lambda st, h, ex, k: self._run_stage(  # noqa: E731
            st, h, ex, k, training)
        if self._rank is None:
            S = self.mesh.shape[self.axis]
            L = self.n_layers // S
            stages = [(s * L, list(self.stacked)[s * L:(s + 1) * L])
                      for s in range(S)]
            return spmd_pipeline(fn, stages, x, mask, mesh=self.mesh,
                                 axis=self.axis,
                                 n_microbatches=self.n_microbatches,
                                 key=key)
        handle, s, S = self._rank
        L = self.n_layers // S
        stage = (s * L, list(self.stacked)[s * L:(s + 1) * L])
        out, sink = _stage_loop(fn, stage, x, mask, key, handle=handle,
                                stage=s, S=S, M=self.n_microbatches,
                                axis=self.axis, publish=True)
        if sink is not None and torch.is_grad_enabled():
            self.sinks.append(sink)
        return out

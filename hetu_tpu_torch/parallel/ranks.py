"""Running the ranks a process holds (the port's counterpart of
``shard_map``'s per-device program).

A sharded model's layers are written once, for one rank: the rank's own
shards, and a collective at each point where the ranks meet
(``RankHandle.collective``).  :func:`run_ranks` runs one function per
rank this process holds:

* on a process mesh, the one rank, in the calling thread; a collective
  calls ``torch.distributed``;
* on a local mesh, every rank of the mesh, each in a thread of its own
  that runs only while it holds the baton: rank 0 runs until its first
  collective, hands the baton to rank 1, and so on; the last rank of a
  group of the collective's axis to arrive runs the collective over the
  group's tensors (one list call of ``parallel.collectives``, so one
  autograd node spans the group and the backward, run afterwards in
  one call, meets each collective once), and the baton goes on, round
  the ranks, to the next one that is not waiting for its group.  One
  thread runs at a time, always in the same order: the ranks' kernels
  are launched in one order on one stream, every counter is exact and
  two runs are bitwise equal.  Groups meet apart, so the ranks of one
  pipeline stage may meet over ``tp`` while another stage's ranks idle
  in the pipeline's bubble (``parallel.pipeline``).

The threads take the caller's grad mode and, on the card, its current
stream.  The ranks of a group must reach the same collectives in the
same order (the SPMD contract); a rank that raises ends the run and the
error is raised in the caller, as does a state where every rank left
waits for a group that cannot complete.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch

__all__ = ["RankHandle", "run_ranks"]

_ACTIVE = None   # the local run in progress


class _Aborted(Exception):
    pass


class _LocalRun:
    def __init__(self, n: int):
        self.n = n
        self.cv = threading.Condition()
        self.turn = 0
        self.waiting = [False] * n
        self.done = [False] * n
        self.pending = {}    # a group's members -> {member: (name, x)}
        self.outs = [None] * n
        self.error = None

    def _wait(self, me):
        while self.turn != me and self.error is None:
            self.cv.wait()
        if self.error is not None:
            raise _Aborted

    def _pass(self, me):
        """The baton to the next rank after ``me`` (``me`` last) that
        runs: neither done nor waiting for its group."""
        for k in range(1, self.n + 1):
            j = (me + k) % self.n
            if not self.done[j] and not self.waiting[j]:
                self.turn = j
                self.cv.notify_all()
                return
        self.turn = None
        if any(self.waiting):
            self.error = RuntimeError(
                f"ranks {[i for i in range(self.n) if self.waiting[i]]} "
                f"wait for collectives whose groups cannot complete: "
                f"{sorted(self.pending)}")
        self.cv.notify_all()

    def exchange(self, me: int, members: tuple, name: str, op: Callable,
                 x):
        """Rank ``me``'s ``x`` into the collective of its group
        ``members`` (held indices, group order); ``op`` maps the group's
        tensors to their results.  Returns ``me``'s result."""
        with self.cv:
            slot = self.pending.setdefault(members, {})
            slot[me] = (name, x)
            if len(slot) < len(members):
                self.waiting[me] = True
            else:
                del self.pending[members]
                names = [slot[m][0] for m in members]
                if len(set(names)) != 1:
                    raise RuntimeError(
                        f"the ranks reached different collectives: {names}")
                outs = op([slot[m][1] for m in members])
                for m, o in zip(members, outs):
                    self.outs[m] = o
                    self.waiting[m] = False
            self._pass(me)
            self._wait(me)
            out, self.outs[me] = self.outs[me], None
            return out

    def body(self, me, fn, results, grad, stream):
        try:
            with torch.set_grad_enabled(grad), \
                    (torch.cuda.stream(stream) if stream is not None
                     else contextlib.nullcontext()):
                with self.cv:
                    self._wait(me)
                results[me] = fn()
                with self.cv:
                    self.done[me] = True
                    self._pass(me)
        except _Aborted:
            pass
        except BaseException as e:   # noqa: BLE001 - re-raised by the caller
            with self.cv:
                if self.error is None:
                    self.error = e
                self.cv.notify_all()


def run_ranks(mesh, fns: list) -> list:
    """``[fn() for fn in fns]``, one function per held rank of ``mesh``
    (``mesh.held`` order), the ranks' collectives meeting as the module
    docstring says."""
    global _ACTIVE
    if len(fns) != len(mesh.held):
        raise ValueError(f"{len(fns)} functions for {len(mesh.held)} "
                         f"held ranks")
    if len(fns) == 1:
        return [fns[0]()]
    if _ACTIVE is not None:
        raise RuntimeError("run_ranks does not nest")
    run = _LocalRun(len(fns))
    results = [None] * len(fns)
    grad = torch.is_grad_enabled()
    stream = (torch.cuda.current_stream(mesh.device)
              if mesh.device.type == "cuda" else None)
    threads = [threading.Thread(target=run.body,
                                args=(i, f, results, grad, stream),
                                name=f"rank-{i}", daemon=True)
               for i, f in enumerate(fns)]
    _ACTIVE = run
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        _ACTIVE = None
    if run.error is not None:
        raise run.error
    return results


class RankHandle:
    """One rank of a mesh (``rank``, its index in the mesh), as a sharded
    module sees it: the axes' sizes and :meth:`collective`."""

    def __init__(self, mesh, rank: int):
        self.mesh = mesh
        self.index = mesh.held.index(rank)

    def size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    def collective(self, fn: Callable, x, axis, **kw):
        """``fn`` (a list collective of ``parallel.collectives``) over
        ``axis`` for this rank's ``x``; this rank's result."""
        if len(self.mesh.held) == 1:
            return fn([x], axis, mesh=self.mesh, **kw)[0]
        if _ACTIVE is None:
            raise RuntimeError("a rank of a local mesh meets the others "
                               "only inside run_ranks")
        rank = self.mesh.held[self.index]
        group = next(g for g in self.mesh.groups(axis) if rank in g)
        members = tuple(self.mesh.held.index(r) for r in group)
        view = _GroupView(self.mesh, len(group))
        return _ACTIVE.exchange(
            self.index, members, getattr(fn, "__name__", str(fn)),
            lambda xs: fn(xs, axis, mesh=view, **kw), x)


class _GroupView:
    """One group of a local mesh's axis as a list collective sees its
    mesh: one group, every rank of it in the list."""

    def __init__(self, mesh, size: int):
        self.shape, self.device, self.size = mesh.shape, mesh.device, size
        self.axis_names = mesh.axis_names

    def groups(self, axis) -> list:
        return [list(range(self.size))]

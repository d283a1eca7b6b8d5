"""The paged decode step as one CUDA graph (counterpart of
``jax.jit(ServingEngine._paged_decode_impl)`` in
``hetu_tpu/serve/engine.py``).

A decode step launches a few hundred small kernels (twelve layers of
projections, norms and the paged-decode kernel, the LM-head kernel, and
in temperature mode the threefry hash of the Gumbel field), and the
host's time to launch them is most of the step.  :class:`DecodeGraph`
captures the step once and replays it: the host copies five small int32
arrays into one static device buffer, replays, and reads the tokens
back, which is the step's only wait for the device.

The first call runs the step eagerly on a side stream (that warms up the
kernel library, the LM-head kernel's occupancy query and cuBLAS, and its
tokens are that step's result), then captures the same step.  The graph
reads and writes the tensors it captured by address: the model's
weights and the pool's K/V (each layer's new row is written in place),
so both must stay the same tensors for the engine's life; its scratch
comes from the graph's private memory pool.  A capture that fails
raises.

The kernels' launch counters (``ops/kernels/_build.py``'s registry) are
Python integers, advanced when a wrapper runs: a capture advances them
without launching anything, so the capture's increase of every counter
is taken back and added again on every replay.
"""

from __future__ import annotations

import numpy as np
import torch

from hetu_tpu_torch.ops.kernels import _build

__all__ = ["DecodeGraph"]


class DecodeGraph:
    """``step(page_tables, lengths, tokens, request_ids, positions)``
    captured at ``(num_slots, pages_per_seq)`` on a CUDA ``device``;
    call it with the same arguments as host arrays."""

    def __init__(self, step, num_slots: int, pages_per_seq: int, device):
        n, P = num_slots, pages_per_seq
        self._step = step
        self._device = device
        self._host = torch.zeros(4 * n + n * P, dtype=torch.int32,
                                 pin_memory=True)
        self._dev = torch.zeros_like(self._host, device=device)
        d = self._dev
        self._args = (d[4 * n:].view(n, P), d[:n], d[n:2 * n].view(n, 1),
                      d[2 * n:3 * n], d[3 * n:4 * n])
        self._graph = None
        self._out = None
        self._launches = {}

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self, page_tables, lengths, tokens, request_ids,
                 positions) -> list:
        """One decode step: the ``(num_slots,)`` tokens as a list."""
        n = len(lengths)
        h = self._host.numpy()
        h[4 * n:] = np.asarray(page_tables).ravel()
        for i, a in enumerate((lengths, tokens, request_ids, positions)):
            h[i * n:(i + 1) * n] = np.asarray(a).ravel()
        self._dev.copy_(self._host, non_blocking=True)
        if self._graph is None:
            return self._capture().tolist()
        self._graph.replay()
        _build.add_launches(self._launches)
        return self._out.tolist()

    def _capture(self) -> torch.Tensor:
        """Run the step eagerly on a side stream, then capture it; returns
        the eager run's tokens."""
        current = torch.cuda.current_stream(self._device)
        side = torch.cuda.Stream(self._device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = self._step(*self._args)
        current.wait_stream(side)
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._out = self._step(*self._args)
        self._launches = {n: c - before.get(n, 0)
                          for n, c in _build.launch_counts().items()
                          if c != before.get(n, 0)}
        # the capture launched nothing
        _build.add_launches({n: -c for n, c in self._launches.items()})
        self._graph = graph
        return first


def _replay_vs_eager(engine) -> tuple:
    """The engine's next decode step through its captured graph and
    through its eager impl, from the same pool: ``(tokens equal, pool
    bytes equal, pool written)``, bitwise.  The pool is left as the eager
    step wrote it.  For the tests and the chip smoke run."""
    args = engine._decode_inputs(engine.batcher.active())[1]
    pool = engine.pool
    k0, v0 = pool.k.clone(), pool.v.clone()
    replayed = engine._decode_graph(*args)
    kg, vg = pool.k.clone(), pool.v.clone()
    pool.k.copy_(k0)
    pool.v.copy_(v0)
    eager = engine._paged_decode_impl(*map(engine._tensor, args)).tolist()

    def same(a, b):
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    return (replayed == eager, same(kg, pool.k) and same(vg, pool.v),
            not same(kg, k0))

"""``ServingEngine``: continuous-batching GPT generation (counterpart of
``hetu_tpu/serve/engine.py``).

Prefill runs the bucketed gather step at ``(1, bucket)``: the request's
pages are gathered into a contiguous view, the model's cached path runs
over it, and the view is scattered back.  Decode — the per-token hot
path — runs at the fixed ``(num_slots, 1)`` shape.  With
``paged_decode=True`` (the default) it is the paged step: attention is
the paged-decode CUDA kernel reading K/V pages in place through the page
tables (``kv_cache.gather_view_count`` shows no view is built), and the
next token comes from the fused LM-head CUDA kernel, so neither the
contiguous K/V views nor the ``(slots, vocab)`` logits reach device
memory.  On CUDA the paged step runs as one captured CUDA graph
(``serve/graph.py``), the counterpart of the reference's one jitted
program; on the CPU it runs eagerly.  ``paged_decode=False`` restores the
gather step for decode, and ``fused_sampling=False`` samples from
materialised logits.

Sampling: ``"greedy"``, ``"temperature"`` (softmax at ``temperature``)
or ``"top_k"`` (among the ``top_k`` best logits at ``temperature``), the
reference's samplers drawn from the reference's keys:
``fold_in(fold_in(key(seed), request id), position)`` for each row,
derived on the device from the request ids and positions, so the same
seed gives the reference's token streams.  A request's token stream
depends only on its prompt, the weights and the seed, not on which
requests shared its batch: every step runs at fixed shapes and each
row's arithmetic and key are independent of the others'.

Deadlines: a request past ``deadline_s`` while queued is dropped before
admission; one that passes it while running is retired at the next tick
with the tokens it has.  Both resolve with status ``expired``.

Left out of this slice, and listed in ``ROADMAP.md``: the
observability registry, request tracing and SLOs, the runtime
controller, tenant metering, CTR inference, fleet tiers (prefix sharing,
speculative decoding, disaggregation, failover) and the HTTP server.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from hetu_tpu_torch.core.device import resolve_device
from hetu_tpu_torch.core.prng import fold_in_tensor, key
from hetu_tpu_torch.ops.kernels.lm_head import lm_head_sample_tokens
from hetu_tpu_torch.ops.random import (greedy_sample, temperature_sample,
                                       top_k_sample)
from hetu_tpu_torch.serve import kv_cache as _kv
from hetu_tpu_torch.serve.batcher import (AdmissionQueueFull,
                                          ContinuousBatcher, Request)
from hetu_tpu_torch.serve.graph import DecodeGraph
from hetu_tpu_torch.serve.kv_cache import (KVCachePool, OutOfPages,
                                           gather_views, scatter_views)

__all__ = ["ServingEngine", "RequestHandle"]


class RequestHandle:
    """Caller-side future for one generation request."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._done = threading.Event()
        # completed | rejected | expired | evicted (overcommitted pool only)
        self.status: Optional[str] = None
        self.tokens: list = []
        self.ttft_s: Optional[float] = None
        self.latency_s: Optional[float] = None
        self.error: Optional[str] = None

    def _finish(self, status: str, tokens=(), ttft_s=None, latency_s=None,
                error=None):
        self.status = status
        self.tokens = list(tokens)
        self.ttft_s = ttft_s
        self.latency_s = latency_s
        self.error = error
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    @property
    def done(self) -> bool:
        return self._done.is_set()


class ServingEngine:
    """Continuous-batching inference over one GPT.  ``device=None`` is
    CUDA (raises without it); the model must live on the same device."""

    def __init__(self, model, *, num_slots: int = 8, page_size: int = 16,
                 max_seq_len: Optional[int] = None,
                 num_pages: Optional[int] = None, queue_depth: int = 64,
                 prompt_buckets=None, sampling: str = "greedy",
                 top_k: int = 5, temperature: float = 1.0,
                 eos_id: Optional[int] = None, seed: int = 0,
                 clock=time.monotonic, paged_decode: bool = True,
                 fused_sampling: Optional[bool] = None, device=None):
        if sampling not in ("greedy", "top_k", "temperature"):
            raise ValueError(f"unknown sampling mode {sampling!r}; one of "
                             f"'greedy', 'top_k', 'temperature'")
        if sampling == "top_k" and top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, the engine on "
                             f"{self.device}")
        cfg = model.config
        self.model = model
        self.eos_id = eos_id
        self.sampling = sampling
        self.top_k = top_k
        self.temperature = temperature
        self.seed = seed
        self._base_key = key(seed).to(self.device)
        self.clock = clock
        self.max_seq_len = min(max_seq_len or cfg.max_seq_len,
                               cfg.max_seq_len)
        self.max_seq_len -= self.max_seq_len % page_size
        pages_per_seq = self.max_seq_len // page_size
        self.pool = KVCachePool(
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            head_dim=cfg.hidden_size // cfg.num_heads,
            num_pages=(num_pages if num_pages is not None
                       else 1 + num_slots * pages_per_seq),
            page_size=page_size, max_seq_len=self.max_seq_len,
            dtype=cfg.dtype, device=self.device)
        if prompt_buckets is None:
            prompt_buckets = (8, 16, 32, 64, 128)
        buckets = tuple(b for b in sorted(prompt_buckets)
                        if b <= self.max_seq_len) or (self.max_seq_len,)
        self.batcher = ContinuousBatcher(num_slots, queue_depth=queue_depth,
                                         prompt_buckets=buckets)
        self.paged_decode = bool(paged_decode)
        if fused_sampling is None:
            # the fused kernel keeps at most 128 candidates a row; a wider
            # top-k samples from materialised logits (still paged)
            fused_sampling = (sampling != "top_k"
                              or min(top_k, cfg.vocab_size) <= 128)
        self._fused_sampling = bool(fused_sampling)
        self._decode_graph = (
            DecodeGraph(self._paged_decode_impl, num_slots, pages_per_seq,
                        self.device)
            if self.paged_decode and self.device.type == "cuda" else None)
        self._lock = threading.RLock()
        self._handles: dict = {}
        self._next_id = 0
        self._counts = {"tokens": 0, "decode_steps": 0, "prefills": 0,
                        "requests": {}}
        self._decode_s: list = []

    # -- compute ------------------------------------------------------------

    def _step_impl(self, page_idx, cache_index, tokens, seq_lengths):
        """The gather step at any bucket shape: gather the paged views,
        run the model's cached path over them (K/V written into the views
        in place), scatter the views back.  Returns the last logits."""
        k_view, v_view = gather_views(self.pool.k, self.pool.v, page_idx)
        kv = [(k_view[i], v_view[i]) for i in range(self.pool.num_layers)]
        logits, _ = self.model(tokens, kv_cache=kv, cache_index=cache_index,
                               seq_lengths=seq_lengths)
        scatter_views(self.pool.k, self.pool.v, page_idx, k_view, v_view)
        return logits

    def _paged_decode_impl(self, page_tables, lengths, tokens, request_ids,
                           positions):
        """The paged decode step: attention reads K/V pages in place
        (paged-decode kernel), each layer's new K/V lands with one small
        in-place write, and the next token comes from the fused LM-head
        kernel.  Same keys as :meth:`_sample_impl`, so the streams are
        the same; ``request_ids`` and ``positions`` (device tensors, or
        host arrays when eager) are read by the stochastic modes only.
        Returns ``(num_slots,)`` int32 tokens.  On CUDA this is what
        :class:`DecodeGraph` captures."""
        x, _ = self.model.hidden_states(
            tokens, kv_cache=(self.pool.k, self.pool.v),
            cache_index=lengths, paged_tables=page_tables)
        last = x[:, -1]
        head = self.model._head()
        if self._fused_sampling:
            keys = (None if self.sampling == "greedy"
                    else self._keys(request_ids, positions))
            return lm_head_sample_tokens(
                last, head, mode=self.sampling, top_k=self.top_k,
                temperature=self.temperature, keys=keys)
        return self._sample_impl(F.linear(last, head.to(last.dtype)),
                                 request_ids, positions)

    def _keys(self, request_ids, positions) -> torch.Tensor:
        """Each row's key ``fold_in(fold_in(key(seed), rid), pos)``,
        derived on the device: the host ships two int vectors (host
        arrays are copied here), not keys."""
        return fold_in_tensor(fold_in_tensor(self._base_key, request_ids),
                              positions)

    def _sample_impl(self, logits, request_ids, positions):
        """Per-row seeded sampling of ``(rows, vocab)`` logits, each row
        from its own key (:meth:`_keys`), so batch composition cannot
        perturb any request's stream.  Greedy reads neither the request
        ids nor the positions, so it never copies them to the device."""
        if self.sampling == "greedy":
            return greedy_sample(logits)
        keys = self._keys(request_ids, positions)
        if self.sampling == "temperature":
            return temperature_sample(logits, self.temperature, key=keys)
        return top_k_sample(logits, self.top_k, self.temperature, key=keys)

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    # -- submission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 16, *,
               deadline_s: Optional[float] = None,
               request_id: Optional[int] = None) -> RequestHandle:
        """Queue one generation request; never blocks.  The handle
        resolves when the request completes, is rejected, or expires.

        ``request_id`` pins the id instead of drawing from this engine's
        counter: a stochastic stream is a function of ``(seed, request
        id, prompt)``, so a request served alone under its batched id
        reproduces its batched stream."""
        prompt = [int(t) for t in np.asarray(prompt).ravel()]
        with self._lock:
            if request_id is None:
                rid = self._next_id
            else:
                rid = int(request_id)
                if rid in self._handles:
                    raise ValueError(f"request id {rid} is already in "
                                     f"flight on this engine")
            self._next_id = max(self._next_id, rid + 1)
            handle = RequestHandle(rid)
            req = Request(id=rid, prompt=prompt,
                          max_new_tokens=int(max_new_tokens),
                          arrival=self.clock(), deadline_s=deadline_s)
            reason = None
            max_bucket = self.batcher.prompt_buckets[-1]
            if not prompt:
                reason = "empty prompt"
            elif req.max_new_tokens < 1:
                reason = (f"max_new_tokens must be >= 1, got "
                          f"{req.max_new_tokens}")
            elif req.total_budget > self.max_seq_len:
                reason = (f"prompt+budget {req.total_budget} exceeds "
                          f"max_seq_len {self.max_seq_len}")
            elif len(prompt) > max_bucket:
                reason = (f"prompt of {len(prompt)} tokens exceeds the "
                          f"largest prefill bucket {max_bucket}")
            else:
                try:
                    self.batcher.submit(req)
                except AdmissionQueueFull as e:
                    reason = str(e)
            if reason is not None:
                self._count("rejected")
                handle._finish("rejected", error=reason)
                return handle
            self._handles[rid] = handle
        return handle

    # -- the scheduler loop -------------------------------------------------

    @torch.no_grad()
    def step(self) -> int:
        """One scheduler tick: expire, admit + prefill, one decode step.
        Returns the number of tokens the decode step produced."""
        with self._lock:
            now = self.clock()
            budget = self.pool.free_pages

            def gate(r):
                nonlocal budget
                need = self.pool.pages_needed(len(r.prompt))
                if need > budget:
                    return False
                budget -= need
                return True

            tick = self.batcher.poll(now, can_admit=gate)
            for req in tick.expired:
                waited = now - req.arrival
                self._count("expired")
                self._handles.pop(req.id)._finish(
                    "expired",
                    error=f"deadline of {req.deadline_s}s expired after "
                          f"{waited:.6g}s in the admission queue")
            for req in tick.admitted:
                self._count("admitted")
                self._prefill(req)
            for _slot, req in self.batcher.active():
                if req.expired(now):
                    self._retire(req, "expired", now)
            return self._decode()

    def run_until_idle(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            self.step()
            if self.batcher.idle:
                return
        raise RuntimeError(f"not idle after {max_steps} scheduler steps")

    # -- phases -------------------------------------------------------------

    def _prefill(self, req: Request) -> None:
        """Right-pad the prompt to its bucket, run one ``(1, bucket)``
        gather step at ``cache_index = 0``, and sample the first token at
        the prompt's true last position."""
        plen = len(req.prompt)
        bucket = self.batcher.bucket_for(plen)
        self.pool.alloc(req.id, plen)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :plen] = req.prompt
        logits = self._step_impl(
            self.pool.gather_indices([req.id]), self._tensor([0]),
            self._tensor(tokens), self._tensor([plen]))
        # the bucket's pad positions wrote garbage K/V beyond plen; the
        # table's length stays plen, so decode overwrites them in turn
        self.pool.table(req.id).length = plen
        _kv.note_pages_written(self.pool.pages_needed(plen))
        tok = int(self._sample_impl(logits, [req.id], [plen])[0])
        done_at = self.clock()
        req.prefill_at = done_at
        self._counts["prefills"] += 1
        self._append_token(req, tok, done_at)

    def _decode(self) -> int:
        """One fixed-shape ``(num_slots, 1)`` decode step over every active
        slot; idle slots ride along on the scratch page."""
        active = self.batcher.active()
        if not active:
            return 0
        t0 = self.clock()
        active, args = self._decode_inputs(active)
        if not active:
            return 0
        if self._decode_graph is not None:
            toks = self._decode_graph(*args)  # waits for the device
        else:
            tables, index, tokens = map(self._tensor, args[:3])
            rids, positions = args[3:]     # copied only if a mode reads them
            if self.paged_decode:
                toks = self._paged_decode_impl(tables, index, tokens, rids,
                                               positions)
            else:
                toks = self._sample_impl(
                    self._step_impl(tables, index, tokens, None), rids,
                    positions)
            toks = toks.tolist()  # waits for the device
        now = self.clock()
        self._counts["decode_steps"] += 1
        self._decode_s.append(now - t0)
        for slot, req in active:
            self.pool.table(req.id).length += 1  # fed token's K/V written
            self._append_token(req, int(toks[slot]), now)
        return len(active)

    def _decode_inputs(self, active):
        """Grow each active sequence by the fed token's page, retire what
        an overcommitted pool cannot hold, and build the step's host
        arrays ``(page_tables, lengths, tokens, request_ids,
        positions)``: the fed token's K/V lands at index ``length`` and
        its successor is sampled at position ``length + 1``; idle slots
        ride along on the scratch page with request id and position 0.
        Returns the slots still active and the arrays."""
        n = self.batcher.num_slots
        seq_ids = [None] * n
        tokens = np.zeros((n, 1), np.int64)
        index = np.zeros(n, np.int32)
        rids = np.zeros(n, np.int32)
        positions = np.zeros(n, np.int32)
        evicted = []
        for slot, req in active:
            try:
                self.pool.ensure(req.id, self.pool.table(req.id).length + 1)
            except OutOfPages:
                # only reachable under an explicitly overcommitted pool
                evicted.append(req)
                continue
            seq_ids[slot] = req.id
            tokens[slot, 0] = req.tokens[-1]
            index[slot] = self.pool.table(req.id).length
            rids[slot] = req.id
            positions[slot] = index[slot] + 1
        for req in evicted:
            self._retire(req, "evicted", self.clock())
        active = [(s, r) for s, r in active if r.slot is not None]
        return active, (self.pool.table_rows(seq_ids), index, tokens, rids,
                        positions)

    def _append_token(self, req: Request, tok: int, now: float) -> None:
        """Account one generated token; retire the request on EOS, budget
        exhaustion, or context exhaustion."""
        req.tokens.append(tok)
        self._counts["tokens"] += 1
        done = (self.eos_id is not None and tok == self.eos_id) \
            or len(req.tokens) >= req.max_new_tokens \
            or self.pool.table(req.id).length >= self.max_seq_len
        if done:
            self._retire(req, "completed", now)

    def _retire(self, req: Request, outcome: str, now: float) -> None:
        """Recycle the slot and pages and resolve the handle."""
        self.batcher.finish(req.slot)
        self.pool.free(req.id)
        self._count(outcome)
        error = None
        if outcome == "evicted":
            error = "evicted: KV pool exhausted (overcommitted num_pages)"
        elif outcome == "expired":
            error = (f"deadline of {req.deadline_s}s expired after "
                     f"{now - req.arrival:.6g}s while decoding "
                     f"({len(req.tokens)} tokens generated)")
        self._handles.pop(req.id)._finish(
            outcome, req.tokens,
            ttft_s=(None if req.prefill_at is None
                    else req.prefill_at - req.arrival),
            latency_s=now - req.arrival, error=error)

    def _count(self, outcome: str) -> None:
        reqs = self._counts["requests"]
        reqs[outcome] = reqs.get(outcome, 0) + 1

    # -- introspection ------------------------------------------------------

    def stats(self) -> dict:
        """Scheduler and pool occupancy, counters, and the median decode
        step time on the engine's clock."""
        with self._lock:
            steps = self._decode_s
            return {
                "queue_len": self.batcher.queue_len,
                "active_slots": self.batcher.active_slots,
                "num_slots": self.batcher.num_slots,
                "pool": self.pool.utilization(),
                "max_seq_len": self.max_seq_len,
                "sampling": self.sampling,
                "top_k": self.top_k,
                "temperature": self.temperature,
                "paged_decode": self.paged_decode,
                "fused_sampling": self._fused_sampling,
                "device": str(self.device),
                "tokens": self._counts["tokens"],
                "prefills": self._counts["prefills"],
                "decode_steps": self._counts["decode_steps"],
                "requests": dict(self._counts["requests"]),
                "decode_step_s_p50": (float(np.median(steps)) if steps
                                      else None),
            }

"""Block-allocated KV-cache pool with per-sequence page tables
(counterpart of ``hetu_tpu/serve/kv_cache.py``).

The K/V of all concurrent sequences lives in one pair of device tensors

    k, v : (num_layers, num_pages, page_size, num_heads, head_dim)

and each sequence owns an ordered list of physical pages (its page
table).  Sequences grow a page at a time and free their pages the moment
they finish.  Physical page 0 is the reserved scratch page: page-table
padding points at it, idle decode rows write into it, and nothing reads
it unmasked.

Pages are refcounted (``retain`` / ``release``), and ``stats`` asserts
the pool's accounting invariants on every call.  Host-side management is
plain Python over a sorted free list, so the same request schedule gives
the same physical placement.

The port updates the pool **in place**: the paged decode step writes
each new K/V row with ``index_put_``, and :func:`scatter_views` writes a
gathered view back the same way.  Nothing in the port calls ``commit``:
it is kept only for API parity with the JAX package, where a step
returns new arrays for the pool to adopt.

Not carried over in this slice: KV migration (export / import), prefix
sharing's copy-on-write, ``defrag``, and the memory-ledger hooks
(ROADMAP Queue 1).
"""

from __future__ import annotations

import bisect
import dataclasses

import numpy as np
import torch

from hetu_tpu_torch.core.device import resolve_device
from hetu_tpu_torch.core.dtypes import as_dtype

__all__ = ["KVCachePool", "PageTable", "OutOfPages", "DoubleFree",
           "SCRATCH_PAGE", "gather_views", "scatter_views",
           "gather_view_count", "reset_gather_view_count",
           "pages_written_count", "reset_pages_written_count",
           "note_pages_written"]

# Counting seam: gather_views is THE place a contiguous (L, batch, max_len,
# H, D) view of the pool is built.  The paged decode step must build none;
# the bucketed prefill builds one per request.
_gather_view_calls = 0


def gather_view_count() -> int:
    """How many contiguous views :func:`gather_views` has built."""
    return _gather_view_calls


def reset_gather_view_count() -> None:
    global _gather_view_calls
    _gather_view_calls = 0


# Second seam: pages freshly computed and written by prefill.
_pages_written = 0


def pages_written_count() -> int:
    return _pages_written


def note_pages_written(n: int) -> None:
    global _pages_written
    _pages_written += int(n)


def reset_pages_written_count() -> None:
    global _pages_written
    _pages_written = 0


SCRATCH_PAGE = 0


class OutOfPages(RuntimeError):
    """The pool cannot satisfy an allocation."""


class DoubleFree(RuntimeError):
    """A sequence (or page) was freed twice."""


@dataclasses.dataclass
class PageTable:
    """One sequence's allocation: ordered physical pages + token length."""

    seq_id: int
    pages: list
    length: int = 0  # valid tokens written so far

    def capacity(self, page_size: int) -> int:
        return len(self.pages) * page_size


class KVCachePool:
    """Paged KV storage for all layers of one model + its allocator.
    ``device=None`` is CUDA (raises without it)."""

    def __init__(self, *, num_layers: int, num_heads: int, head_dim: int,
                 num_pages: int, page_size: int, max_seq_len: int,
                 dtype=torch.float32, device=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the reserved "
                             "scratch page)")
        if max_seq_len % page_size:
            raise ValueError(f"max_seq_len {max_seq_len} must be a "
                             f"multiple of page_size {page_size}")
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.pages_per_seq = max_seq_len // page_size
        shape = (num_layers, num_pages, page_size, num_heads, head_dim)
        self.k = torch.zeros(shape, dtype=as_dtype(dtype), device=self.device)
        self.v = torch.zeros(shape, dtype=as_dtype(dtype), device=self.device)
        self._free: list = list(range(1, num_pages))
        self._tables: dict = {}
        # page -> reference count; absent == on the free list
        self._refcount: dict = {}
        self._allocs = 0
        self._frees = 0

    # -- allocator ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def alloc(self, seq_id: int, n_tokens: int) -> PageTable:
        """Reserve capacity for ``n_tokens`` (>= 1 page).  Raises
        :exc:`OutOfPages` without side effects when the pool is short."""
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id} already allocated")
        if n_tokens > self.max_seq_len:
            raise ValueError(f"sequence of {n_tokens} tokens exceeds "
                             f"max_seq_len {self.max_seq_len}")
        need = self.pages_needed(n_tokens)
        if need > len(self._free):
            raise OutOfPages(f"need {need} pages, {len(self._free)} free")
        pages = [self._free.pop(0) for _ in range(need)]
        for p in pages:
            self._refcount[p] = 1
        pt = PageTable(seq_id, pages)
        self._tables[seq_id] = pt
        self._allocs += 1
        return pt

    def ensure(self, seq_id: int, n_tokens: int) -> PageTable:
        """Grow ``seq_id``'s allocation to cover ``n_tokens``."""
        pt = self._tables[seq_id]
        if n_tokens > self.max_seq_len:
            raise ValueError(f"sequence {seq_id} would exceed max_seq_len "
                             f"{self.max_seq_len}")
        while pt.capacity(self.page_size) < n_tokens:
            if not self._free:
                raise OutOfPages(f"growing sequence {seq_id}: no free pages")
            p = self._free.pop(0)
            self._refcount[p] = 1
            pt.pages.append(p)
        return pt

    def retain(self, page: int) -> None:
        """Add one reference to an allocated page."""
        if self._refcount.get(page, 0) < 1:
            raise ValueError(f"retain of unallocated page {page}")
        self._refcount[page] += 1

    def release(self, page: int) -> None:
        """Drop one reference; the page returns to the free list at zero."""
        rc = self._refcount.get(page)
        if rc is None:
            raise DoubleFree(f"page {page} is already on the free list")
        if rc == 1:
            del self._refcount[page]
            bisect.insort(self._free, page)
        else:
            self._refcount[page] = rc - 1

    def free(self, seq_id: int) -> None:
        """Drop the sequence's reference on each of its pages.  A second
        ``free`` of the same sequence raises :exc:`DoubleFree`."""
        pt = self._tables.pop(seq_id, None)
        if pt is None:
            raise DoubleFree(f"sequence {seq_id} already freed (or never "
                             f"allocated)")
        for p in pt.pages:
            self.release(p)
        self._frees += 1

    def table(self, seq_id: int) -> PageTable:
        return self._tables[seq_id]

    def stats(self) -> dict:
        """Page counts, the refcount histogram and the alloc/free balance,
        with the accounting invariants asserted on every call."""
        self._check_invariants()
        hist: dict = {}
        for rc in self._refcount.values():
            hist[rc] = hist.get(rc, 0) + 1
        held = {p for pt in self._tables.values() for p in pt.pages}
        shared = sum(1 for p, rc in self._refcount.items()
                     if rc > 1 or p not in held)
        return {
            "pages_total": self.num_pages - 1,
            "pages_free": len(self._free),
            "pages_private": len(self._refcount) - shared,
            "pages_shared": shared,
            "refcount_histogram": {str(k): hist[k] for k in sorted(hist)},
            "sequences": len(self._tables),
            "allocs": self._allocs,
            "frees": self._frees,
            "page_size": self.page_size,
        }

    def _check_invariants(self) -> None:
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError(f"free list holds duplicates: "
                                 f"{sorted(self._free)}")
        if SCRATCH_PAGE in free or SCRATCH_PAGE in self._refcount:
            raise AssertionError("scratch page was allocated")
        overlap = free & set(self._refcount)
        if overlap:
            raise AssertionError(f"pages {sorted(overlap)} are both free "
                                 f"and refcounted")
        if len(free) + len(self._refcount) != self.num_pages - 1:
            raise AssertionError(
                f"page accounting leak: {len(free)} free + "
                f"{len(self._refcount)} allocated != {self.num_pages - 1}")
        held: dict = {}
        for pt in self._tables.values():
            for p in pt.pages:
                held[p] = held.get(p, 0) + 1
        for p, n in held.items():
            if self._refcount.get(p, 0) < n:
                raise AssertionError(
                    f"page {p} referenced by {n} tables but refcount is "
                    f"{self._refcount.get(p, 0)}")
        if self._allocs - self._frees != len(self._tables):
            raise AssertionError(
                f"alloc/free imbalance: {self._allocs} allocs - "
                f"{self._frees} frees != {len(self._tables)} live")

    # -- the fixed-shape bridge --------------------------------------------

    def table_rows(self, seq_ids) -> np.ndarray:
        """``(batch, pages_per_seq)`` int32 page tables on the host,
        padded with the scratch page; ``None`` entries (idle slots) become
        all-scratch rows."""
        out = np.full((len(seq_ids), self.pages_per_seq), SCRATCH_PAGE,
                      np.int32)
        for row, sid in zip(out, seq_ids):
            if sid is not None:
                pages = self._tables[sid].pages
                row[:len(pages)] = pages
        return out

    def gather_indices(self, seq_ids) -> torch.Tensor:
        """:meth:`table_rows` as a tensor on the pool's device."""
        return torch.from_numpy(self.table_rows(seq_ids)).to(self.device)

    def commit(self, k, v) -> None:
        """Adopt the pool tensors a step returned (the same tensors, since
        the port writes in place)."""
        self.k = k
        self.v = v

    def utilization(self) -> dict:
        used = self.num_pages - 1 - len(self._free)
        return {"pages_total": self.num_pages - 1, "pages_used": used,
                "sequences": len(self._tables),
                "page_size": self.page_size}


def gather_views(k, v, page_idx):
    """Build the bucket-padded contiguous views ``(L, batch, max_len, H,
    D)`` from the pool (one gather each; copies).  Counted, so a test can
    show that the paged decode step builds none."""
    global _gather_view_calls
    _gather_view_calls += 1
    L, _, page, H, D = k.shape
    b, P = page_idx.shape
    idx = page_idx.long()
    shape = (L, b, P * page, H, D)
    return k[:, idx].reshape(shape), v[:, idx].reshape(shape)


def scatter_views(k, v, page_idx, k_view, v_view):
    """Write updated contiguous views back into the pool, in place.  Every
    live page belongs to one (sequence, slot), so only the scratch page
    sees several writes, and it is never read unmasked."""
    L, _, page, H, D = k.shape
    b, P = page_idx.shape
    idx = page_idx.long()
    shape = (L, b, P, page, H, D)
    k[:, idx] = k_view.reshape(shape)
    v[:, idx] = v_view.reshape(shape)
    return k, v

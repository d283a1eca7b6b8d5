"""Execution-layer profiling (counterpart of ``hetu_tpu/exec/profiler.py``):
per-section timers, per-op counts and flops, cost analysis, the in-place
update audit, timing and trace capture on the card.

- :class:`HetuTimer`: named wall-clock sections, a device synchronize at
  each section's end when ``sync=True``;
- :func:`primitive_counts`: the aten ops a call runs (a
  ``TorchDispatchMode``) and the matmuls' and convolutions' flops;
- :func:`compiled_cost`: ``torch.utils.flop_counter.FlopCounterMode``'s
  flops, with the argument, output and aliased bytes of the call and, on
  the card, its temporary bytes (the allocator's peak above what the
  call started and ended with);
- :func:`audit_donation`: whether a ``Trainer``'s update writes the
  parameters and the optimizer state in place, the port's counterpart
  of XLA's donated-buffer aliasing;
- :func:`profile_fn`: CUDA-event timing of a call on the card;
- :func:`trace` and :func:`device_op_breakdown`: a ``torch.profiler``
  Chrome trace under a directory, parsed into device time per kernel.

What is timed runs where the caller's tensors are: ``device=None`` is
the CUDA device and raises without one; the CPU is timed only when the
caller names it.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import statistics
import time
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from hetu_tpu_torch.core.device import resolve_device

__all__ = ["HetuTimer", "audit_donation", "device_op_breakdown",
           "profile_fn", "compiled_cost", "primitive_counts", "trace"]


class HetuTimer:
    """Named-section wall timer with accumulation.

    >>> timer = HetuTimer()
    >>> with timer("forward"):
    ...     out = model(x)
    >>> timer.log_out()

    With ``sync=True`` each section ends with a synchronize of the CUDA
    device (when one is in use), so a section's time includes the device
    work it launched."""

    def __init__(self, sync: bool = True):
        self.totals: dict = defaultdict(float)
        self.counts: dict = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str, result: Any = None):
        """A section named ``name``; ``result`` is accepted for the
        reference's signature (which ignores it too): the section's
        synchronize covers any result."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if self.sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def observe(self, result: Any) -> Any:
        """The reference's hook for an asynchronous result; the section's
        synchronize covers it here.  Returns ``result``."""
        return result

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def log_out(self, printer: Callable = print) -> dict:
        """Per-section totals and means."""
        stats = {name: {"total_s": self.totals[name],
                        "count": self.counts[name],
                        "mean_s": self.mean(name)}
                 for name in sorted(self.totals)}
        for name, s in stats.items():
            printer(f"[hetu-timer] {name}: total {s['total_s']*1e3:.2f}ms "
                    f"count {s['count']} mean {s['mean_s']*1e3:.3f}ms")
        return stats

    def reset(self):
        self.totals.clear()
        self.counts.clear()


# --------------------------------------------------------------- op counts

_MATMULS = ("mm", "addmm", "bmm", "baddbmm")


def _op_flops(name: str, args, out) -> float:
    """2 x multiply-adds of a matmul or a convolution (a bias add is not
    counted, as the reference's ``dot_general`` count has none)."""
    def numel(shape):
        n = 1
        for d in shape:
            n *= int(d)
        return n

    if name in ("mm", "bmm"):
        a = args[0]
        return 2.0 * numel(out.shape) * a.shape[-1]
    if name in ("addmm", "baddbmm"):
        a = args[1]
        return 2.0 * numel(out.shape) * a.shape[-1]
    if name == "convolution":
        w = args[1]
        # 2 * out elements * (kernel spatial * in channels per group)
        return 2.0 * numel(out.shape) * numel(w.shape[1:])
    return 0.0


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts: dict = defaultdict(int)
        self.flops: dict = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        self.counts[name] += 1
        if name in _MATMULS or name == "convolution":
            self.flops[name] += _op_flops(name, args, out)
        return out


def primitive_counts(fn: Callable, *example_args) -> dict:
    """Runs ``fn(*example_args)`` once and counts the aten ops it
    dispatches (``{"mm": 2, "relu": 1, ...}``), with the flops of its
    matrix products and convolutions: the counterpart of the reference's
    per-primitive jaxpr count.  Returns ``{"counts", "flops",
    "total_flops"}``."""
    counter = _OpCounter()
    with counter:
        fn(*example_args)
    return {"counts": dict(counter.counts), "flops": dict(counter.flops),
            "total_flops": float(sum(counter.flops.values()))}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for k in sorted(x, key=str):
            yield from _tensors(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _bytes(tensors) -> float:
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return float(total)


def compiled_cost(fn: Callable, *example_args) -> dict:
    """One call's cost: ``flops`` (``FlopCounterMode``), and the bytes the
    reference's keys name where the port can have them:
    ``argument_bytes`` (the tensor arguments), ``output_bytes``,
    ``aliased_bytes`` (outputs that share an argument's storage) and, for
    a call on the card, ``temp_bytes`` (the allocator's peak during the
    call above what it held at the start and at the end).  The
    reference's ``bytes_accessed`` has no counterpart and is left out."""
    from torch.utils.flop_counter import FlopCounterMode
    args = list(_tensors(example_args))
    cuda = any(t.is_cuda for t in args)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as counter:
        out = fn(*example_args)
    outs = list(_tensors(out))
    ptrs = {t.untyped_storage().data_ptr() for t in args}
    res = {"flops": float(counter.get_total_flops()),
           "argument_bytes": _bytes(args), "output_bytes": _bytes(outs),
           "aliased_bytes": _bytes(t for t in outs
                                   if t.untyped_storage().data_ptr()
                                   in ptrs)}
    if cuda:
        torch.cuda.synchronize()
        end = torch.cuda.memory_allocated()
        res["temp_bytes"] = float(max(
            torch.cuda.max_memory_allocated() - max(start, end), 0))
    return res


def audit_donation(trainer, batch, key=None) -> dict:
    """Does the ``Trainer``'s step update its state in place?  The port's
    counterpart of the reference's donated-buffer audit: a step that
    rebinds a parameter or an optimizer-state tensor instead of writing
    it holds both copies at its peak.  Runs one step (no push of staged
    embeddings) on ``batch``, compares every parameter's and state
    tensor's ``data_ptr`` before and after, and restores the state.

    Returns ``{"argument_bytes", "output_bytes", "aliased_bytes",
    "temp_bytes", "donated_fraction", "unusable"}``: the state's bytes
    (read and written by the step), the bytes written in place, the
    step's temporary bytes on the card (0.0 on the CPU), their ratio,
    and the names of the tensors that were rebound.  It degrades, never
    raises: a failed step is reported under ``"error"``."""
    out: dict = {"argument_bytes": 0.0, "output_bytes": 0.0,
                 "aliased_bytes": 0.0, "temp_bytes": 0.0,
                 "donated_fraction": 0.0, "unusable": []}

    def state():
        named = {f"model.{n}": p for n, p in
                 trainer.model.named_parameters()}
        for slot, v in sorted(trainer.opt_state.items()):
            if isinstance(v, dict):
                named.update((f"opt_state.{slot}.{n}", t)
                             for n, t in v.items()
                             if isinstance(t, torch.Tensor))
        return named

    saved = trainer._save_state()
    try:
        before = {n: (t.data_ptr(), t.numel() * t.element_size())
                  for n, t in state().items()}
        cuda = trainer._on_cuda()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
        try:
            trainer._step(batch, key, push=False)
        except Exception as e:  # the degrade-don't-raise contract
            out["error"] = f"{type(e).__name__}: {e}"
            return out
        after = state()
        if cuda:
            torch.cuda.synchronize()
            out["temp_bytes"] = float(max(
                torch.cuda.max_memory_allocated() - start, 0))
        total = float(sum(nb for _p, nb in before.values()))
        kept = [n for n, (p, _nb) in before.items()
                if n in after and after[n].data_ptr() == p]
        out["argument_bytes"] = out["output_bytes"] = total
        out["aliased_bytes"] = float(sum(before[n][1] for n in kept))
        out["unusable"] = sorted(set(before) - set(kept))
        if total:
            out["donated_fraction"] = out["aliased_bytes"] / total
        return out
    finally:
        trainer._restore_state(saved)


# ----------------------------------------------------------------- timing

def profile_fn(fn: Callable, *example_args, iters: int = 10,
               warmup: int = 2, device=None, cost: bool = True) -> dict:
    """Time ``fn(*example_args)`` after ``warmup`` calls: on the CUDA
    device (``device=None``; raises without one) each call between two
    CUDA events, on the CPU (only when ``device="cpu"``) by the host
    clock.  Returns ``{mean_s, p50_s, min_s, iters}`` and, with
    ``cost``, :func:`compiled_cost`'s keys, the op counts
    (``primitive_counts``) and ``achieved_flops`` (flops / p50)."""
    dev = resolve_device(device)
    for _ in range(max(warmup, 1)):
        fn(*example_args)
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*example_args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn(*example_args)
            times.append(time.perf_counter() - t0)
    prof = {"mean_s": statistics.fmean(times),
            "p50_s": statistics.median(times), "min_s": min(times),
            "iters": iters}
    if cost:
        prof.update(compiled_cost(fn, *example_args))
        prims = primitive_counts(fn, *example_args)
        prof["primitive_counts"] = prims["counts"]
        if not prof.get("flops"):
            prof["flops"] = prims["total_flops"]
        if prof["flops"]:
            prof["achieved_flops"] = prof["flops"] / prof["p50_s"]
    return prof


# ------------------------------------------------------------------ traces

_trace_seq = itertools.count()
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str, *, device=None):
    """Profile the block with ``torch.profiler`` and write its Chrome
    trace under ``logdir`` (``hetu_<pid>_<n>.pt.trace.json``).  On the
    CUDA device (``device=None``; raises without one) the trace records
    the CPU and the card; with ``device="cpu"`` the CPU alone.  Yields
    the profiler, whose ``events()`` the caller may read as well."""
    from torch.profiler import ProfilerActivity, profile
    dev = resolve_device(device)
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(os.path.join(
        logdir, f"hetu_{os.getpid()}_{next(_trace_seq):04d}.pt.trace.json"))


def _newest_trace(logdir: str) -> str:
    import glob
    paths = [p for pat in ("*.pt.trace.json", "*.trace.json.gz")
             for p in glob.glob(os.path.join(logdir, "**", pat),
                                recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    return max(paths, key=lambda p: (os.path.getmtime(p), p))


def device_op_breakdown(logdir: str, *, steps: int = 1, top: int = 0,
                        device_kind: str | None = None):
    """Parse the newest trace under ``logdir`` (written by :func:`trace`)
    into device seconds per kernel, divided by ``steps``.

    The device events are the trace's ``kernel``, ``gpu_memcpy`` and
    ``gpu_memset`` complete events, grouped by name.  A trace with none
    (a CPU run's) falls through to its ``cpu_op`` events, as the
    reference's parser falls through to every timeline event when it
    finds no device timeline; those nest, so their sum is not a time.
    Returns ``(per_op, totals)``: ``per_op`` maps a name to seconds per
    step (all, or the ``top`` largest), ``totals`` has ``device_s`` (the
    sum of every listed event's duration, overlaps counted twice) and
    ``copy_s`` (the memcpy events).  The table goes to the installed
    calibration store keyed by ``device_kind`` (default: the card named
    in the trace, or ``"cpu"`` for a trace without device events)."""
    import gzip
    import json
    path = _newest_trace(logdir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    events = [ev for ev in doc.get("traceEvents", [])
              if ev.get("ph") == "X" and "dur" in ev and ev.get("name")]
    dev = [ev for ev in events if ev.get("cat") in _DEVICE_CATS]
    rows = dev or [ev for ev in events if ev.get("cat") == "cpu_op"]
    per = defaultdict(float)
    copy = 0.0
    for ev in rows:
        secs = float(ev["dur"]) / 1e6 / steps
        per[ev["name"]] += secs
        if ev.get("cat") == "gpu_memcpy":
            copy += secs
    totals = {"device_s": float(sum(per.values())), "copy_s": copy}
    ranked = dict(sorted(per.items(), key=lambda kv: (-kv[1], kv[0])))
    if top:
        ranked = dict(list(ranked.items())[:top])
    if device_kind is None and not dev:
        device_kind = "cpu"
    elif device_kind is None:
        props = doc.get("deviceProperties") or [{}]
        device_kind = (str(props[0].get("name", ""))
                       or torch.cuda.get_device_name())
    from hetu_tpu_torch.obs.calibration import note_op_breakdown
    note_op_breakdown(per, totals, device_kind=device_kind)
    return ranked, totals

"""Checkpoint save/load (counterpart of ``hetu_tpu/exec/checkpoint.py``),
in the JAX package's file format so that each package reads the other's
files.

A file is a pickle of ``{"state": ..., "rng": (seed, seqnum), "extra":
{...}}`` followed by an integrity footer, the 8-byte magic ``HTCKPT1\\0``
and the CRC32 of the payload; it is written to ``path.tmp``, fsynced and
renamed, so a crash leaves the old file or the new one, never a torn one.

The state is numpy in the JAX layout: :func:`state_dict` gives a model's
parameters, and the buffers that hold a JAX state field (BatchNorm's
running statistics), as ``{name: array}`` with the arrays that the model
declares transposed (``interop.from_jax.transposed_names``: the linears
it hands to ``F.linear``) turned back to JAX's ``(in, out)``, and an
optimizer state as ``{"step": n, slot: {name: array}}`` in the same
layout; an integer state buffer is written in its JAX dtype
(``interop.from_jax.state_dtypes``).  The layout of an optimizer state,
or of a ``{name: tensor}`` dict of a model's arrays, is its model's:
pass ``model=``.  Without one, an optimizer state is refused, and so is
a dict that holds an ``nn.Parameter`` (it is a model's, and its layout
cannot be read off its shapes); a plain dict of other tensors is taken
as it is.  :func:`load_state_dict` copies either back in place.  A bf16
tensor is written as fp32 (lossless) under ``{"dtype": "bfloat16",
"data": array}``, since unpickling a bf16 numpy array needs
``ml_dtypes``; loading restores bf16.  A bf16 array in a file the JAX
package wrote is read where ``ml_dtypes`` is installed.
"""

from __future__ import annotations

import copy
import mmap
import os
import pickle
import re
import struct
import sys
import threading
import time
import zlib
from typing import Any, Optional

import numpy as np
import torch

from hetu_tpu_torch.core.rng import get_seed_status, reset_seed_seqnum
from hetu_tpu_torch.interop.from_jax import (stack_jax, stack_prefixes,
                                            state_dtypes, state_tensors,
                                            to_jax_array, to_jax_layout,
                                            transposed_names, unstack_jax)
from hetu_tpu_torch.obs import journal as _obs_journal
from hetu_tpu_torch.obs import registry as _obs

__all__ = ["save_checkpoint", "load_checkpoint", "state_dict",
           "load_state_dict", "trainer_state_dict", "load_trainer_state",
           "AsyncCheckpointer", "CheckpointError", "CheckpointCorrupt",
           "read_footer_crc"]


class CheckpointError(Exception):
    """A checkpoint file could not be loaded (torn write, wrong file, ...)."""


class CheckpointCorrupt(CheckpointError):
    """The integrity footer is present but the CRC32 does not match: the
    bytes were damaged after a complete write."""


_FOOTER_MAGIC = b"HTCKPT1\x00"
_FOOTER = struct.Struct("<8sI")
_BF16_TAG = "bfloat16"

# Fault-injection seam (``exec.faults.install`` sets it; None otherwise,
# one global load): called with ("ckpt_write", path) after every durable
# write.
_fault_hook = None

# The step in a resilience checkpoint's name (``ckpt.step_NNN``): the
# journal and the fault harness key checkpoint events on it.
_STEP_IN_NAME = re.compile(r"ckpt\.step_(\d+)$")

_ckpt_metrics = None


def _ckpt_m() -> dict:
    global _ckpt_metrics
    if _ckpt_metrics is None:
        reg = _obs.get_registry()
        _ckpt_metrics = {
            "seconds": reg.histogram(
                "hetu_checkpoint_write_seconds",
                "durable checkpoint write time (pickle+fsync+rename, on "
                "whichever thread ran it)"),
            "bytes": reg.counter(
                "hetu_checkpoint_bytes_total",
                "bytes durably written as checkpoints"),
            "writes": reg.counter(
                "hetu_checkpoint_writes_total",
                "checkpoints durably written"),
        }
    return _ckpt_metrics


def _to_numpy(name: str, t: torch.Tensor, transposed: frozenset,
              dtypes: dict):
    """One tensor in the JAX layout, as numpy; bf16 widened and tagged,
    an integer state buffer in its JAX dtype (``dtypes``)."""
    if t.dtype == torch.bfloat16:
        a = to_jax_layout(name, t.detach(), transposed)
        return {"dtype": _BF16_TAG, "data": _host_copy(a.float())}
    if t.is_floating_point():
        return _host_copy(to_jax_layout(name, t.detach(), transposed))
    return to_jax_array(name, t, transposed, dtypes)


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """``t`` as a fresh C-ordered numpy array, copied once: a transposed
    view is laid out on its own device before the fetch (a card does the
    strided copy, not the host)."""
    c = t.contiguous()
    if c.device.type != "cpu":
        return c.cpu().numpy()
    return c.numpy().copy() if c is t else c.numpy()


def _from_numpy(name: str, val, like: torch.Tensor,
                transposed: frozenset) -> torch.Tensor:
    """A saved entry as a tensor of ``like``'s type, in the port's
    layout."""
    if isinstance(val, dict):
        val = val["data"]
    a = np.asarray(val)
    if a.dtype.name == "bfloat16":      # a JAX file; needs ml_dtypes here
        a = a.astype(np.float32)
    elif np.issubdtype(a.dtype, np.integer):   # uint32 values exactly
        a = a.astype(np.int64)
    t = to_jax_layout(name, torch.from_numpy(np.ascontiguousarray(a)),
                      transposed)
    return t.to(like.dtype)


def _named(tree) -> dict:
    """A module's parameters and the buffers that hold a JAX state field
    (``BatchNorm2d``'s running statistics, ``BalanceGate``'s centroids),
    as the JAX ``state_dict`` lists its state fields; or a dict as it
    is."""
    if isinstance(tree, torch.nn.Module):
        return state_tensors(tree)
    return dict(tree)


def _layout(tree, model, optimizer_state: bool) -> frozenset:
    """The names stored transposed: the model's declarations (``tree``'s
    own for a module); none for a plain dict of other tensors without a
    model.  An optimizer state, or a dict holding a model's
    ``nn.Parameter``, without ``model=`` is refused."""
    if model is None and isinstance(tree, torch.nn.Module):
        model = tree
    if model is not None:
        return transposed_names(model)
    if optimizer_state:
        raise ValueError("an optimizer state is laid out as its model's "
                         "parameters: pass model=")
    if any(isinstance(t, torch.nn.Parameter) for t in tree.values()):
        raise ValueError("a dict of a model's parameters is laid out as "
                         "its model's: pass model=")
    return frozenset()


def _stacks(tree, model) -> dict:
    """The model's block stacks, which the JAX layout stacks."""
    model = tree if isinstance(tree, torch.nn.Module) else model
    return stack_prefixes(model) if model is not None else {}


def _dtypes(tree, model) -> dict:
    """The JAX dtypes of the model's integer state buffers."""
    model = tree if isinstance(tree, torch.nn.Module) else model
    return state_dtypes(model) if model is not None else {}


def state_dict(tree, *, model=None) -> dict:
    """``{name: numpy}`` in the JAX layout of a module's parameters (or
    of a ``{name: tensor}`` dict of ``model``'s), or of an optimizer
    state ``{"step": n, slot: {name: tensor}}`` of ``model``'s
    parameters as ``{"step": n, slot: {name: numpy}}``."""
    stacks = _stacks(tree, model)
    if isinstance(tree, dict) and "step" in tree:
        transposed = _layout(tree, model, True)
        return {k: int(v) if k == "step" else stack_jax(
                    {n: _to_numpy(n, t, transposed, {})
                     for n, t in v.items()}, stacks)
                for k, v in tree.items()}
    transposed = _layout(tree, model, False)
    dtypes = _dtypes(tree, model)
    return stack_jax({n: _to_numpy(n, t, transposed, dtypes)
                      for n, t in _named(tree).items()}, stacks)


def load_state_dict(tree, sd: dict, *, model=None,
                    consider_splits: bool = False):
    """Copy ``sd`` (as :func:`state_dict` gives it, or as the JAX
    package's ``state_dict`` wrote it) into ``tree`` in place and return
    ``tree``; a name ``sd`` lacks is left alone.  For an optimizer state
    (of ``model``'s parameters) the step is set and every slot loaded.
    With ``consider_splits`` a saved entry larger than the tensor is
    sliced down to fit (the reference's re-sharded reload); a smaller one
    raises either way."""
    stacks = _stacks(tree, model)
    if isinstance(tree, dict) and "step" in tree:
        transposed = _layout(tree, model, True)
        for k in tree:
            if k == "step":
                tree[k] = int(sd[k])
            elif k in sd:
                _load_named(tree[k], unstack_jax(sd[k], stacks), transposed,
                            consider_splits)
        return tree
    _load_named(_named(tree), unstack_jax(sd, stacks),
                _layout(tree, model, False), consider_splits)
    return tree


def trainer_state_dict(trainer) -> dict:
    """A ``Trainer``'s whole state as one flat ``{name: numpy}`` dict,
    named as the JAX package names its ``TrainState``'s leaves
    (``model.<param>``, ``opt_state.step``, ``opt_state.<slot>.<param>``)
    and in the JAX layout: the form resilience and gang checkpoints hold,
    so each package resumes from the other's.  A trainer under a sharding
    strategy is refused (its state is its ranks' shards)."""
    if getattr(trainer, "strategy", None) is not None:
        raise NotImplementedError(
            "trainer_state_dict of a trainer under a sharding strategy: "
            "export the gathered weights with interop.export_params")
    out = {f"model.{n}": a for n, a in state_dict(trainer.model).items()}
    for k, v in state_dict(trainer.opt_state, model=trainer.model).items():
        if k == "step":
            out["opt_state.step"] = np.asarray(v, np.int32)
        else:
            out.update((f"opt_state.{k}.{n}", a) for n, a in v.items())
    return out


def load_trainer_state(trainer, sd: dict, *,
                       consider_splits: bool = False) -> None:
    """Copy a :func:`trainer_state_dict` (or the JAX package's flat
    ``TrainState``) into ``trainer`` in place; a name ``sd`` lacks is
    left alone.  Under a sharding strategy every rank the process holds
    takes its pieces of the whole tensors (``ShardedModel.load``)."""
    model_sd, opt_sd = {}, {}
    for k, v in sd.items():
        if k.startswith("model."):
            model_sd[k[len("model."):]] = v
        elif k == "opt_state.step":
            opt_sd["step"] = int(np.asarray(v))
        elif k.startswith("opt_state."):
            slot, _, name = k[len("opt_state."):].partition(".")
            opt_sd.setdefault(slot, {})[name] = v
    sharded = getattr(trainer, "_sharded", None)
    if sharded is not None:
        _load_sharded(sharded, model_sd, opt_sd, consider_splits)
        return
    load_state_dict(trainer.model, model_sd,
                    consider_splits=consider_splits)
    opt_sd.setdefault("step", trainer.opt_state["step"])
    load_state_dict(trainer.opt_state, opt_sd, model=trainer.model,
                    consider_splits=consider_splits)


def _load_sharded(sharded, model_sd: dict, opt_sd: dict,
                  consider_splits: bool) -> None:
    """:func:`load_trainer_state` for a ``ShardedModel``: the saved
    entries as whole tensors, each rank's pieces cut from them."""
    transposed = sharded.transposed
    stacks = stack_prefixes(sharded.models[0])
    opt = sharded.opt_states[0]

    def whole(sd, slot: bool):
        sd = unstack_jax(sd, stacks)
        # a slot is fp32 whatever its parameter's type
        out = {n: torch.empty(sharded.place[n].shape,
                              dtype=(torch.float32 if slot
                                     else sharded.place[n].dtype),
                              device=sharded.mesh.device)
               for n in sd if n in sharded.place}
        _load_named(out, sd, transposed, consider_splits)
        return out

    for m in sharded.models:     # state buffers: whole on every rank
        _load_named({n: b for n, b in state_tensors(m).items()
                     if n not in sharded.place},
                    unstack_jax(model_sd, stacks), transposed,
                    consider_splits)
    sharded.load(whole(model_sd, False),
                 {k: whole(v, True) for k, v in opt_sd.items()
                  if k != "step" and k in opt},
                 step=opt_sd.get("step"))


def _load_named(named: dict, sd: dict, transposed: frozenset,
                consider_splits: bool) -> None:
    with torch.no_grad():
        for name, t in named.items():
            if name not in sd:
                continue
            val = _from_numpy(name, sd[name], t, transposed)
            if tuple(val.shape) != tuple(t.shape):
                if (not consider_splits or val.ndim != t.ndim
                        or any(v < s for v, s in zip(val.shape, t.shape))):
                    raise ValueError(f"shape mismatch for {name}: ckpt "
                                     f"{tuple(val.shape)} vs model "
                                     f"{tuple(t.shape)}")
                val = val[tuple(slice(0, s) for s in t.shape)]
            t.copy_(val)


def _make_payload(state: Any, extra: Optional[dict]) -> dict:
    """``state`` as it is, the global RNG's status and a copy of
    ``extra``: a caller that writes in the background hands in a state
    of its own."""
    return {"state": state, "rng": get_seed_status(),
            "extra": copy.deepcopy(extra) if extra else {}}


def _atomic_write_bytes(path: str, *chunks: bytes) -> None:
    """Write ``chunks`` back to back to ``path.tmp``, fsync, rename and
    fsync the directory: a crash at any point leaves the old file or the
    new one, never a torn one (no concatenation copy of a large
    payload)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for chunk in chunks:
            f.write(chunk)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    try:
        os.fsync(dfd)  # make the rename itself durable
    finally:
        os.close(dfd)


def _atomic_write(path: str, payload: dict) -> None:
    """Pickle with a CRC32 footer, written atomically; with telemetry on,
    the write's time and bytes go to the ``hetu_checkpoint_*`` metrics
    and a ``checkpoint_saved`` journal event."""
    t0 = time.perf_counter() if _obs.enabled() else None
    buf = pickle.dumps(payload)
    crc = zlib.crc32(buf) & 0xFFFFFFFF
    footer = _FOOTER.pack(_FOOTER_MAGIC, crc)
    _atomic_write_bytes(path, buf, footer)
    if t0 is not None:
        dt = time.perf_counter() - t0
        nbytes = len(buf) + _FOOTER.size
        m = _ckpt_m()
        m["seconds"].observe(dt)
        m["bytes"].inc(nbytes)
        m["writes"].inc()
        step = _STEP_IN_NAME.search(path)
        _obs_journal.record(
            "checkpoint_saved", path=path,
            step=int(step.group(1)) if step else None,
            bytes=nbytes, crc32=crc, duration_s=round(dt, 6))
    if _fault_hook is not None:
        _fault_hook("ckpt_write", path)


def save_checkpoint(path: str, state: Any,
                    extra: Optional[dict] = None) -> None:
    """Write ``state`` (numpy, as :func:`state_dict` gives it) with the
    global RNG's ``(seed, seqnum)``; atomic against crashes.  The write
    is synchronous, so ``state`` is pickled as it is, not copied first."""
    _atomic_write(path, _make_payload(state, extra))


def read_footer_crc(path: str) -> Optional[int]:
    """The CRC32 in a file's footer, or None when the file is missing,
    too short, or has no footer (a torn write)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            if size < _FOOTER.size:
                return None
            f.seek(size - _FOOTER.size)
            magic, crc = _FOOTER.unpack(f.read(_FOOTER.size))
    except OSError:
        return None
    return crc if magic == _FOOTER_MAGIC else None


class AsyncCheckpointer:
    """Checkpoints written on a background thread: the snapshot is taken
    on the caller's thread, the pickle, fsync and rename on the writer's,
    so the train loop does not wait on the disk."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state: Any, extra: Optional[dict] = None,
             *, owned: bool = False):
        """Snapshot ``state`` now and persist it in the background, after
        the save before it (checkpoints stay ordered).  ``owned=True``
        hands over a host snapshot the caller made for this save and
        will not touch again: it is written as it is, not copied."""
        self.wait()
        payload = _make_payload(state if owned else copy.deepcopy(state),
                                extra)

        def write():
            try:
                _atomic_write(path, payload)
            except BaseException as e:
                print(f"AsyncCheckpointer: write to {path} failed: {e!r}",
                      file=sys.stderr)
                self._error = e

        # not a daemon: the interpreter's exit joins it, so a final save
        # lands on disk even without wait()
        self._thread = threading.Thread(target=write, daemon=False)
        self._thread.start()

    def wait(self):
        """Block until the save in flight is durable; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _parse_payload(raw, path: str) -> dict:
    """Decode a file's bytes, checking the CRC32 footer when present."""
    if len(raw) >= _FOOTER.size:
        magic, crc = _FOOTER.unpack_from(raw, len(raw) - _FOOTER.size)
        if magic == _FOOTER_MAGIC:
            body = memoryview(raw)[:len(raw) - _FOOTER.size]
            if zlib.crc32(body) & 0xFFFFFFFF != crc:
                raise CheckpointCorrupt(
                    f"checkpoint {path}: CRC32 mismatch: the file was "
                    f"corrupted after a complete write; pick an older "
                    f"checkpoint")
            try:
                return pickle.loads(body)
            except Exception as e:
                raise CheckpointError(
                    f"checkpoint {path}: integrity footer valid but payload "
                    f"does not unpickle ({e!r})") from e
    try:
        return pickle.loads(raw)
    except Exception as e:
        raise CheckpointError(
            f"cannot load checkpoint {path}: {e!r}: most likely a torn "
            f"write (the file lacks the integrity footer), or not a "
            f"checkpoint file") from e


def load_checkpoint(path: str, restore_rng: bool = True):
    """``(state, extra)``; restores the global RNG's ``(seed, seqnum)`` by
    default, so a resumed run draws the same keys.  Raises
    ``CheckpointCorrupt`` on a CRC mismatch and ``CheckpointError`` for a
    torn or foreign file."""
    with open(path, "rb") as f:
        try:
            raw = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):    # an empty file
            raw = f.read()
        try:
            payload = _parse_payload(raw, path)
        finally:
            if isinstance(raw, mmap.mmap):
                try:
                    raw.close()
                except BufferError:
                    pass    # a traceback still holds a view; GC closes it
    if not isinstance(payload, dict) or "state" not in payload:
        raise CheckpointError(f"checkpoint {path} decoded to "
                              f"{type(payload).__name__} without a 'state' "
                              f"entry: wrong file?")
    if restore_rng and "rng" in payload:
        reset_seed_seqnum(*payload["rng"])
    return payload["state"], payload.get("extra", {})

"""Build and load the port's CUDA kernels.

At first use, every ``hetu_tpu_torch/csrc/*.cu`` is compiled by ``nvcc``
for ``sm_90a`` — one ``nvcc`` process per source, all started together —
and linked into one shared library with a plain C interface under
``build/torch_kernels/`` at the root of the checkout.  The library's name
carries a hash of the sources, the shared ``*.cuh`` headers and the
flags, so a changed source or header rebuilds and an unchanged tree is
reused.  The library is loaded with ``ctypes``: every
pointer and the stream are ``c_void_p``, and every C entry returns
``cudaGetLastError()`` after its launch, which :func:`check` turns into an
exception.

Every wrapper's launch counter lives here, in one registry keyed by the
wrapper's name: a wrapper calls :func:`count_launch` where it launches
its kernel and nowhere else, and a CUDA graph's replay adds the launches
its capture counted (:func:`launch_counts`, :func:`add_launches`).

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc`` or a card.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["KernelUnavailable", "build", "load_library", "check",
           "build_log", "SRC_DIR", "BUILD_DIR", "count_launch",
           "launch_count", "launch_counts", "add_launches", "reset_launches"]

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib = None
_log = ""
_launches = collections.Counter()


def count_launch(name: str) -> None:
    """Count one launch by the wrapper ``name``."""
    _launches[name] += 1


def launch_count(name: str) -> int:
    """The wrapper ``name``'s launches since its last reset."""
    return _launches[name]


def launch_counts() -> dict:
    """Every wrapper's launches since its last reset, by name."""
    return dict(_launches)


def add_launches(deltas: dict) -> None:
    """Add ``deltas`` (name -> launches, may be negative) to the counts:
    a CUDA graph's replay launches what its capture counted."""
    _launches.update(deltas)


def reset_launches(*names: str) -> None:
    """Set the named wrappers' counts to 0."""
    for n in names:
        _launches.pop(n, None)


class KernelUnavailable(RuntimeError):
    """The CUDA kernels cannot be built or loaded here (no ``nvcc``, no
    CUDA device, or a failed compile)."""


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelUnavailable("nvcc not found (set CUDA_HOME, or put nvcc on "
                            "PATH)")


def _sources() -> list:
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise KernelUnavailable(f"no CUDA sources under {SRC_DIR}")
    return srcs


def _digest(srcs) -> str:
    """Hash of the flags, the sources and every shared ``csrc/*.cuh``
    header they may include (only the ``*.cu`` files are compiled)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if their hash is new) and return the path of
    the shared library.  Raises :class:`KernelUnavailable` on failure,
    with the compiler's output."""
    global _log
    srcs = _sources()
    lib_path = BUILD_DIR / f"libhetu_torch_kernels_{_digest(srcs)}.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp_{os.getpid()}_{threading.get_ident()}"
    tmp.mkdir(exist_ok=True)
    try:
        procs = []
        for s in srcs:
            obj = tmp / (s.stem + ".o")
            procs.append((s, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for s, _obj, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {s.name}\n{out}")
            if p.returncode != 0:
                failed.append(s.name)
        _log = "\n".join(logs)
        if failed:
            raise KernelUnavailable(f"nvcc failed on {failed}:\n{_log}")
        part = tmp / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(part),
             *[str(obj) for _s, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelUnavailable(f"linking failed:\n{link.stdout}")
        os.replace(part, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def build_log() -> str:
    """The compiler's output (``-Xptxas=-v`` register and shared-memory
    counts) of the last build this process ran; empty if it reused one."""
    return _log


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U = ctypes.c_uint32
_SIGNATURES = {
    "hetu_paged_decode": [_I] + [_VP] * 7 + [_I] * 8 + [_F, _VP],
    "hetu_lm_head_sample": [_I, _VP, _VP, _VP, _VP, _F, _I, _I, _I, _I,
                            _I, _VP, _VP, _VP, _VP, _VP],
    "hetu_lm_head_blocks": [_I, _I, _I],
    "hetu_flash_fwd": [_I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                       _F, _VP],
    "hetu_flash_bwd": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                       _I, _I, _I, _I, _I, _I, _F, _VP],
    "hetu_flash_block_bwd": [_I] + [_VP] * 9 + [_I] * 6 + [_F, _VP],
    "hetu_ce_fwd": [_I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP, _VP,
                    _VP],
    "hetu_ce_bwd": [_I, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP,
                    _VP, _VP, _VP, _VP, _VP],
    "hetu_fused_ln_max_d": [],
    "hetu_fused_ln_fwd": [_I] + [_VP] * 7 + [_I, _I, _U, _U, _U, _F, _F, _VP],
    "hetu_fused_ln_bwd": [_I] + [_VP] * 12 + [_I, _I, _I, _U, _U, _U, _F,
                                              _F, _VP],
}


def load_library():
    """The loaded kernel library (built on first call).  Raises
    :class:`KernelUnavailable` when there is no CUDA device or no
    ``nvcc``; there is no fallback."""
    global _lib
    with _lock:
        if _lib is None:
            if not torch.cuda.is_available():
                raise KernelUnavailable("no CUDA device is available")
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({torch.cuda.get_device_name()})")

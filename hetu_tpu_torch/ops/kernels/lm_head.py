"""Fused LM-head top-k sampling: the CUDA kernel's wrapper and its plain
version.

Replaces the Pallas TPU kernel ``hetu_tpu/ops/pallas/lm_head.py``
(``_sample_kernel``, entry ``lm_head_sample_pallas``).  The CUDA kernel is
``hetu_tpu_torch/csrc/lm_head_sample.cu``; its header says what bounds it
on the H100 (memory: the whole weight is streamed once per call at
decode batch sizes) and how the design deals with it (one wave of
blocks streams W in its ``(V, E)`` embedding layout through a
``cp.async`` ring into ``mma.sync`` tensor-core tiles, each block keeps
its range's top-k, and a merge launched as a programmatic dependent
takes each row's; the logits never reach device memory).

The function is the TPU kernel's: the top-k ``(vals, idx)`` of each row
of ``h @ W^T (+ b)``, or of ``g + (h @ W^T + b) / T`` when a Gumbel field
``g`` is given, in one order on every path: any NaN, whatever its sign
bit, above every number (``jnp.argmax`` returns the first NaN); then the
values descending, with -0.0 equal to +0.0; equal values, and NaNs among
themselves, smallest index first.  A row of -inf gives index 0, and so
does a row of NaN.  That is ``lax.top_k``'s order except in two corners
where ``lax.top_k`` sorts by total order (+0.0 above -0.0, a NaN with its
sign bit set below -inf) and ``jnp.argmax`` does not.  h is cast to W's
type first and the products accumulate in fp32.  ``k = 1`` is greedy
decoding, which is all the serving engine asks of it; ``g`` and ``T``
are there so the whole function is ported.

:func:`lm_head_sample` runs :func:`lm_head_sample_plain` only when its
inputs lie on the CPU.  For CUDA tensors it launches the kernel or
raises; there is no fallback.  ``launch_count()`` counts its calls that
launched the kernel.
"""

from __future__ import annotations

import torch

from hetu_tpu_torch.ops.kernels import _build

__all__ = ["lm_head_sample", "lm_head_sample_plain", "lm_head_greedy",
           "launch_count", "reset_launch_count"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_K = 128
_launches = 0
_block_counts = {}


def launch_count() -> int:
    """Kernel launches (one per call) since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _blocks(lib, dtype: int, E: int, V: int, device) -> int:
    """The kernel's block count for (type, E, V) on ``device``: one wave
    of the card, which sizes the ``(N, G, k)`` candidate scratch."""
    key = (dtype, E, V, device.index)
    if key not in _block_counts:
        with torch.cuda.device(device):
            G = lib.hetu_lm_head_blocks(dtype, E, V)
        if G < 1:
            raise ValueError(f"lm_head_sample: E={E} is too wide for the "
                             f"kernel (h's rows stay in shared memory: at "
                             f"most 2368 in float32, 4736 in bfloat16)")
        _block_counts[key] = G
    return _block_counts[key]


def _check_k(k: int, V: int) -> int:
    k = int(k)
    if not 1 <= k <= min(_MAX_K, V):
        raise ValueError(f"k must be in [1, min(128, V={V})], got {k}")
    return k


def lm_head_sample_plain(hidden, weight, *, k: int = 1, bias=None,
                         gumbel=None, temperature: float = 1.0):
    """The same function in plain PyTorch: fp32 logits, then a stable
    descending sort.  ``torch.sort`` ranks every NaN above every number
    and compares -0.0 equal to +0.0, and the stable sort keeps equal
    values in ascending index order: the module's order."""
    k = _check_k(k, weight.shape[0])
    lg = (hidden.to(weight.dtype).float() @ weight.float().T)
    if bias is not None:
        lg = lg + bias.float()
    if gumbel is not None:
        lg = gumbel.float() + lg / temperature
    vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


def lm_head_sample(hidden, weight, *, k: int = 1, bias=None, gumbel=None,
                   temperature: float = 1.0):
    """Top-k of ``hidden @ weight.T (+ bias)`` per row, or of ``gumbel +
    (hidden @ weight.T + bias) / temperature`` when ``gumbel`` is given.

    hidden: ``(N, E)``.  weight: ``(V, E)``, the embedding's layout (the
    tied head is ``wte.weight`` itself, never a transposed copy).  bias:
    ``(V,)`` fp32 or None.  gumbel: ``(N, V)`` fp32 or None.  Returns
    ``vals (N, k)`` fp32 and ``idx (N, k)`` int32, 1 <= k <= 128."""
    if hidden.device.type == "cpu":
        return lm_head_sample_plain(hidden, weight, k=k, bias=bias,
                                    gumbel=gumbel, temperature=temperature)
    global _launches
    lib = _build.load_library()
    N, E = hidden.shape
    V = weight.shape[0]
    k = _check_k(k, V)
    h = hidden.to(weight.dtype).contiguous()
    tensors = {"hidden": h, "weight": weight, "bias": bias,
               "gumbel": gumbel}
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != hidden.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be on the CUDA device of hidden "
                             f"({hidden.device}), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weight.dtype not in _DTYPES:
        raise TypeError(f"weight must be float32 or bfloat16, got "
                        f"{weight.dtype}")
    if weight.dim() != 2 or weight.shape[1] != E:
        raise ValueError(f"weight must be (V, E={E}), got "
                         f"{tuple(weight.shape)}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (V,)):
        raise ValueError("bias must be float32 of shape (V,)")
    if gumbel is not None and (gumbel.dtype != torch.float32
                               or tuple(gumbel.shape) != (N, V)):
        raise ValueError("gumbel must be float32 of shape (N, V)")
    G = _blocks(lib, _DTYPES[weight.dtype], E, V, h.device)
    part_v = torch.empty((N, G, k), dtype=torch.float32, device=h.device)
    part_i = torch.empty((N, G, k), dtype=torch.int32, device=h.device)
    vals = torch.empty((N, k), dtype=torch.float32, device=h.device)
    idx = torch.empty((N, k), dtype=torch.int32, device=h.device)
    err = lib.hetu_lm_head_sample(
        _DTYPES[weight.dtype], h.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if gumbel is None else gumbel.data_ptr(),
        float(temperature), N, E, V, k, G, part_v.data_ptr(),
        part_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "lm_head_sample")
    _launches += 1
    return vals, idx


def lm_head_greedy(hidden, weight, *, bias=None):
    """Greedy tokens ``(N,)`` int32: the first maximum of each row's
    logits, as ``greedy_sample(hidden @ weight.T)`` gives it."""
    return lm_head_sample(hidden, weight, k=1, bias=bias)[1][:, 0]

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
decoding; with ``g`` and ``T`` it is the temperature sampler's draw,
and with ``k > 1`` the top-k sampler's candidates.
:func:`lm_head_sample_tokens` is the TPU module's entry
(``lm_head_sample_pallas``): the serving engine's next tokens in each
sampling mode, drawn from per-row threefry keys as ``ops.random``'s
samplers draw them from the same logits.

:func:`lm_head_sample` runs :func:`lm_head_sample_plain` only when its
inputs lie on the CPU.  For CUDA tensors it launches the kernel or
raises; there is no fallback.  ``launch_count()`` counts its calls that
launched the kernel (``_build``'s registry, which a CUDA graph's replay
advances too).
"""

from __future__ import annotations

import torch

from hetu_tpu_torch.ops.kernels import _build
from hetu_tpu_torch.ops.random import (_categorical, _gumbel, _top_k,
                                       greedy_sample)

__all__ = ["lm_head_sample", "lm_head_sample_plain", "lm_head_greedy",
           "lm_head_sample_tokens", "launch_count", "reset_launch_count"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_K = 128
_block_counts = {}


def launch_count() -> int:
    """Kernel launches (one per call) since the last reset."""
    return _build.launch_count("lm_head_sample")


def reset_launch_count() -> None:
    _build.reset_launches("lm_head_sample")



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
    descending sort (``ops.random._top_k``).  ``torch.sort`` ranks every
    NaN above every number and compares -0.0 equal to +0.0, and the
    stable sort keeps equal values in ascending index order: the
    module's order."""
    k = _check_k(k, weight.shape[0])
    lg = (hidden.to(weight.dtype).float() @ weight.float().T)
    if bias is not None:
        lg = lg + bias.float()
    if gumbel is not None:
        lg = gumbel.float() + lg / temperature
    return _top_k(lg, k)


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
    _build.count_launch("lm_head_sample")
    return vals, idx


def lm_head_greedy(hidden, weight, *, bias=None):
    """Greedy tokens ``(N,)`` int32: the first maximum of each row's
    logits, as ``greedy_sample(hidden @ weight.T)`` gives it."""
    return lm_head_sample(hidden, weight, k=1, bias=bias)[1][:, 0]


def lm_head_sample_tokens(hidden, weight, *, bias=None, mode: str = "greedy",
                          top_k: int = 5, temperature: float = 1.0,
                          keys=None):
    """Next tokens ``(N,)`` int32 straight from decode hidden states, in
    sampling ``mode`` (the TPU module's ``lm_head_sample_pallas``):

    - ``"greedy"``: the first maximum of each row's logits;
    - ``"temperature"``: ``temperature_sample(logits, T, key=keys[r])``
      for each row, as the argmax of ``g + logits / T`` with ``g`` the
      row's ``(V,)`` Gumbel field, built here and streamed through the
      kernel (``k = 1``);
    - ``"top_k"``: the kernel's ``k`` best logits of each row, then
      ``jax.random.categorical(keys[r], vals[r] / T)`` among them (a
      Gumbel of shape ``(k,)`` from the row's key), as ``top_k_sample``.

    ``keys``: ``(N, 2)`` threefry keys, one per row, required by the
    stochastic modes; ``temperature <= 0`` collapses them to greedy.
    ``k = min(top_k, V)`` must lie in ``[1, 128]``.  On CUDA tensors the
    kernel runs (or raises); CPU tensors run its plain version."""
    if mode not in ("greedy", "temperature", "top_k"):
        raise ValueError(f"unknown sampling mode {mode!r}; one of "
                         f"'greedy', 'temperature', 'top_k'")
    if mode != "greedy" and temperature <= 0.0:
        mode = "greedy"  # the samplers' conventional T->0 collapse
    if mode != "greedy" and keys is None:
        raise ValueError(f"mode={mode!r} needs per-row PRNG keys")
    V = weight.shape[0]
    k = 1 if mode != "top_k" else min(int(top_k), V)
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"top_k must be in [1, 128], got {k}")
    if mode == "greedy":
        return lm_head_greedy(hidden, weight, bias=bias)
    keys = torch.as_tensor(keys).to(hidden.device)
    if mode == "temperature":
        g = _gumbel(keys, (V,))
        return lm_head_sample(hidden, weight, k=1, bias=bias, gumbel=g,
                              temperature=temperature)[1][:, 0]
    vals, idx = lm_head_sample(hidden, weight, k=k, bias=bias)
    choice = _categorical(keys, vals / temperature)
    return torch.gather(idx, 1, choice.long()[:, None])[:, 0]


def _sample_tokens_plain(hidden, weight, *, mode: str, top_k: int,
                         temperature: float, keys):
    """:func:`lm_head_sample_tokens`'s two stochastic modes through
    :func:`lm_head_sample_plain`, on the same Gumbel field or the same
    candidates, on the inputs' device.  Returns ``(tokens, gap)``: each
    row's token and the gap between its two best perturbed scores, which
    says where the kernel's value tolerance could pick the other one.
    For the tests and the chip smoke run."""
    V = weight.shape[0]
    if mode == "temperature":
        vals, idx = lm_head_sample_plain(
            hidden, weight, k=2, gumbel=_gumbel(keys, (V,)),
            temperature=temperature)
        return idx[:, 0], vals[:, 0] - vals[:, 1]
    vals, idx = lm_head_sample_plain(hidden, weight, k=top_k)
    scores = _gumbel(keys, (top_k,)) + vals / temperature
    top = torch.sort(scores, dim=-1, descending=True).values
    tokens = torch.gather(idx, 1, greedy_sample(scores).long()[:, None])
    return tokens[:, 0], top[:, 0] - top[:, 1]

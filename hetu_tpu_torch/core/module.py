"""What the port keeps of ``hetu_tpu/core/module.py``.

The reference's ``Module`` is a pytree of arrays; the port's modules are
``torch.nn.Module``\\ s, so ``Module``, ``FrozenDict``, ``trainable_mask``
(parameters against buffers) and ``tree_replace`` (a functional update
of an immutable tree; a torch module is updated in place) have no
counterpart.  The helpers below take a module, or a dict / list / tuple
of tensors, where the reference takes a pytree; ``hetu_tpu_torch.core``
exports ``logical_axes`` (``parallel.spec``) and ``maybe_remat``
(``mem.policy``) beside them."""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["param_count", "named_parameters"]


def named_parameters(tree: Any, prefix: str = "") -> list:
    """``[(dotted path, tensor), ...]``: a module's parameters and the
    buffers that hold a reference state field (BatchNorm's statistics,
    ``interop.from_jax.state_tensors``), the leaves of the reference's
    module tree; or the tensors of a dict / list / tuple."""
    if isinstance(tree, torch.nn.Module):
        from hetu_tpu_torch.interop.from_jax import state_tensors
        return [(f"{prefix}{n}", t) for n, t in state_tensors(tree).items()]
    if isinstance(tree, torch.Tensor):
        return [(prefix.rstrip("."), tree)]
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in named_parameters(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in named_parameters(v, f"{prefix}{i}.")]
    return []


def param_count(tree: Any) -> int:
    """The number of elements over :func:`named_parameters`' tensors, as
    the reference counts every array leaf of its tree."""
    return sum(int(t.numel()) for _, t in named_parameters(tree))

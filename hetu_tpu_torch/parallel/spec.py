"""Sharding-state algebra and logical axes (counterpart of
``hetu_tpu/parallel/spec.py``).

``ShardState`` and :func:`transition` are the JAX package's host logic,
copied: a tensor's placement (splits per dimension, replicas, pending
partial sums) and the collective that moves one placement to another.
``AxisRules`` maps the logical axis names that modules declare
('mlp', 'heads_merged', 'vocab', ...) to mesh axes, one model definition
serving every strategy.

**Logical axes.**  Each port module class declares its parameters' axes
in the JAX layout in a class attribute ``_logical_axes`` (``{attr:
axes}``), the way ``_jax_transposed`` declares the layout; ``Linear`` and
``Embedding`` take ``axes=`` per instance as the JAX layers do.
:func:`logical_axes` gives them per parameter **in torch's layout**,
reversed where the module stores the weight transposed; a parameter
without declared axes is replicated, as in JAX.  :class:`PartitionSpec`
is the port's ``jax.sharding.PartitionSpec``: one entry per dimension
(``None``, a mesh axis or a tuple of them).

**Rank shards.**  :func:`shard_index` gives a rank its piece of each
sharded dimension and :func:`shard_param` / :func:`gather_param` cut and
join a parameter (the torch counterpart of ``named_shardings`` /
``shard_tree`` and of reading a sharded array back).  Two rules differ
from a plain contiguous split:

* **Uneven dimensions** take ceil-sized pieces, the last one short, as
  GSPMD pads the last shard: GPT-2's vocabulary of 50257 splits 25129 +
  25128 at tp = 2 and 12565 x 3 + 12562 at tp = 4.
* **Head-strided qkv.**  The fused ``wqkv`` is laid out ``[q | k | v]``,
  each head-major, so a contiguous split of its ``qkv_three_heads``
  dimension (what JAX's ``P(None, "tp")`` gives, GSPMD resharding
  afterwards) would hand rank 0 all of q.  A port rank must hold its
  own heads' q, k and v: the dimension is cut as three blocks, rank
  ``i`` taking piece ``i`` of each (``_BLOCKS``).  The shards gather
  back to the full weight (``tests/test_torch_strategies.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

__all__ = [
    "PartitionSpec", "P", "ShardState", "transition", "AxisRules",
    "resolve_specs", "logical_axes", "stacked_names", "MEGATRON_RULES",
    "DP_RULES", "shard_index", "shard_param", "gather_param",
]


class PartitionSpec(tuple):
    """One entry per dimension: ``None`` (replicated), a mesh axis name,
    or a tuple of names (``jax.sharding.PartitionSpec``'s shape; a tuple
    of one name is that name, as JAX reads it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardState:
    """Placement of one tensor over a device group of size
    ``prod(splits) * duplicate * partial`` (context.py:248 semantics).

    splits: per-dim split counts, e.g. {0: 2, 1: 4}
    duplicate: replication factor (the '-1' axis of the reference order)
    partial: pending-reduce copies (the '-2' axis; matmul partial sums)
    mesh_axes: optional per-dim mesh-axis names for lowering to PartitionSpec
    """

    splits: Mapping[int, int] = dataclasses.field(default_factory=dict)
    duplicate: int = 1
    partial: int = 1
    mesh_axes: Mapping[int, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "splits", dict(self.splits))
        object.__setattr__(self, "mesh_axes", dict(self.mesh_axes))

    def device_count(self) -> int:
        n = self.duplicate * self.partial
        for v in self.splits.values():
            n *= v
        return n

    def split(self, dim: int, parts: int, mesh_axis: Optional[str] = None) -> "ShardState":
        splits = dict(self.splits)
        splits[dim] = splits.get(dim, 1) * parts
        axes = dict(self.mesh_axes)
        if mesh_axis is not None:
            prev = axes.get(dim)
            axes[dim] = (*(prev or ()), mesh_axis) if isinstance(prev, tuple) or prev is None else (prev, mesh_axis)
        return dataclasses.replace(self, splits=splits, mesh_axes=axes)

    def replicate(self, copies: int) -> "ShardState":
        return dataclasses.replace(self, duplicate=self.duplicate * copies)

    def make_partial(self, copies: int) -> "ShardState":
        return dataclasses.replace(self, partial=self.partial * copies)

    def reduce_partial(self) -> "ShardState":
        """After an all-reduce over the partial axis: copies become replicas
        (context.py combine_state reduce semantics)."""
        return dataclasses.replace(
            self, partial=1, duplicate=self.duplicate * self.partial
        )

    def to_partition_spec(self, ndim: int) -> PartitionSpec:
        entries = []
        for d in range(ndim):
            ax = self.mesh_axes.get(d)
            if ax is None or self.splits.get(d, 1) == 1:
                entries.append(None)
            elif isinstance(ax, tuple) and len(ax) == 1:
                entries.append(ax[0])
            else:
                entries.append(ax)
        return P(*entries)


def transition(src: ShardState, dst: ShardState, ndim: int) -> str:
    """Name the collective that moves ``src`` to ``dst`` (the reference's
    pattern checks, context.py:769-782), which the cost model prices."""
    if src.partial > 1 and dst.partial == 1:
        if dst.duplicate >= src.partial:
            return "all_reduce"
        for d in range(ndim):
            if dst.splits.get(d, 1) > src.splits.get(d, 1):
                return "reduce_scatter"
        return "reduce"
    for d in range(ndim):
        if src.splits.get(d, 1) > dst.splits.get(d, 1):
            if any(
                dst.splits.get(e, 1) > src.splits.get(e, 1) for e in range(ndim)
            ):
                return "all_to_all"
            return "all_gather"
    if dst.duplicate > src.duplicate and src.duplicate == 1:
        return "broadcast"
    for d in range(ndim):
        if dst.splits.get(d, 1) > src.splits.get(d, 1):
            return "dynamic_slice"  # a local slice
    return "identity"


# -----------------------------------------------------------------------------
# Logical-axis rules
# -----------------------------------------------------------------------------


class AxisRules:
    """logical axis name -> mesh axis (or None = replicate)."""

    def __init__(self, rules: Mapping[str, Any]):
        self.rules = dict(rules)

    def physical(self, spec) -> PartitionSpec:
        out = []
        for entry in spec:
            if entry is None:
                out.append(None)
            elif isinstance(entry, (tuple, list)):
                mapped = tuple(
                    m for e in entry
                    if (m := self.rules.get(e)) is not None
                )
                out.append(mapped if mapped else None)
            else:
                out.append(self.rules.get(entry))
        return P(*out)


# Megatron-LM preset (reference distributed_strategies/simple.py:174
# MegatronLM): column-parallel in-proj, row-parallel out-proj, vocab-parallel
# embedding; everything else replicated over tp.
MEGATRON_RULES = AxisRules({
    "mlp": "tp",                # MLP hidden — column parallel
    "qkv_three_heads": "tp",    # attention qkv — column parallel (head-major)
    "heads_merged": "tp",       # attention out-proj — row parallel
    "vocab": "tp",              # embedding/vocab parallel
    "embed": None,
    "in": None, "out": None,
    "conv_in": None, "conv_out": None,
    "layers": "pp",             # stacked pipeline-stage dim
    "experts": "ep",            # stacked expert dim (layers/moe.py)
})

# Pure data parallel: everything replicated over tp (reference simple.py:6);
# stacked layer/expert dims still follow their pp/ep axes.
DP_RULES = AxisRules({"layers": "pp", "experts": "ep"})

# A logical axis cut as this many equal blocks, each split over the mesh
# axis (the fused qkv: rank i holds its heads' q, k and v).
_BLOCKS = {"qkv_three_heads": 3}


def _declared(mod) -> dict:
    return getattr(mod, "_logical_axes", None) or {}


def stacked_names(model) -> dict:
    """``{name: (stack axis, layer index, layers)}`` for every parameter
    of a block in a stack whose layers carry a logical axis
    (``parallel.pipeline.Stack``; the JAX package's ``[n_layers, ...]``
    leaves)."""
    out = {}
    for prefix, mod in model.named_modules():
        axis = getattr(mod, "stack_axis", None)
        if axis is None or not isinstance(mod, torch.nn.ModuleList):
            continue
        for li, blk in enumerate(mod):
            for q, _ in blk.named_parameters():
                out[f"{prefix}.{li}.{q}" if prefix else f"{li}.{q}"] = (
                    axis, li, len(mod))
    return out


def logical_axes(model) -> dict:
    """``{name: PartitionSpec}`` of every parameter of ``model`` in
    torch's layout: the declared JAX-layout axes, reversed for a weight
    the module stores transposed (``_jax_transposed``); ``P()`` where
    nothing is declared.  A parameter of a stacked block
    (:func:`stacked_names`) has one entry more, first: its stack's axis
    (``layers``), the JAX layout's leading dimension."""
    out = {}
    for prefix, mod in model.named_modules():
        axes = _declared(mod)
        transposed = getattr(type(mod), "_jax_transposed", ())
        for attr, p in mod.named_parameters(recurse=False):
            name = f"{prefix}.{attr}" if prefix else attr
            ax = axes.get(attr)
            if ax is None:
                out[name] = P()
                continue
            ax = tuple(a if a else None for a in ax)
            out[name] = P(*(reversed(ax) if attr in transposed else ax))
    params = dict(model.named_parameters())
    for name, (axis, _, _) in stacked_names(model).items():
        spec = tuple(out[name])
        spec += (None,) * (params[name].dim() - len(spec))
        out[name] = P(axis, *spec)
    return out


def resolve_specs(model, rules: AxisRules) -> dict:
    """``{name: PartitionSpec}`` of physical mesh axes per parameter, in
    torch's layout."""
    return {n: rules.physical(s) for n, s in logical_axes(model).items()}


# -----------------------------------------------------------------------------
# Rank shards
# -----------------------------------------------------------------------------


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_index(shape, spec, coords: dict, mesh_shape: dict,
                blocks=None) -> list:
    """Per dimension of ``shape``, the indices (a ``torch.long`` range)
    the rank at ``coords`` holds under ``spec``: ceil-sized pieces over
    the dimension's mesh axes (first name outermost), cut within each of
    ``blocks[d]`` equal blocks where that is above 1."""
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = [a for a in _entry_axes(entry) if mesh_shape.get(a, 1) > 1]
        parts, i = 1, 0
        for a in axes:
            parts *= mesh_shape[a]
            i = i * mesh_shape[a] + coords[a]
        nb = (blocks[d] if blocks is not None and d < len(blocks) else 1) \
            or 1
        if parts == 1:
            out.append(torch.arange(n))
            continue
        if n % nb:
            raise ValueError(f"dimension {d} of {tuple(shape)} is not "
                             f"{nb} equal blocks")
        per = n // nb
        c = -(-per // parts)
        lo, hi = min(i * c, per), min((i + 1) * c, per)
        out.append(torch.cat([torch.arange(b * per + lo, b * per + hi)
                              for b in range(nb)]))
    return out


def _ix(idx: list, device) -> tuple:
    nd = len(idx)
    return tuple(t.to(device).reshape([-1 if k == d else 1
                                       for k in range(nd)])
                 for d, t in enumerate(idx))


def shard_param(t: torch.Tensor, spec, coords: dict, mesh_shape: dict,
                blocks=None) -> torch.Tensor:
    """The rank's piece of ``t`` (a new contiguous tensor)."""
    if t.dim() == 0:
        return t.detach().clone()
    idx = shard_index(t.shape, spec, coords, mesh_shape, blocks)
    return t.detach()[_ix(idx, t.device)].contiguous()


def gather_param(pieces: list, shape, spec, coords: list, mesh_shape: dict,
                 blocks=None) -> torch.Tensor:
    """The full tensor from every rank's piece (``coords[i]`` the
    coordinates of ``pieces[i]``); replicas write the same values."""
    first = pieces[0]
    if len(shape) == 0:
        return first.detach().clone()
    full = torch.empty(tuple(shape), dtype=first.dtype, device=first.device)
    for piece, c in zip(pieces, coords):
        idx = shard_index(shape, spec, c, mesh_shape, blocks)
        full[_ix(idx, full.device)] = piece.detach().to(full.device)
    return full


def blocks_of(logical) -> tuple:
    """Per dimension, the block count its logical axis is cut in."""
    return tuple(_BLOCKS.get(a, 1) if isinstance(a, str) else 1
                 for a in logical)

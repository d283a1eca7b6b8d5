"""Mixture-of-Experts with expert parallelism (counterpart of
``hetu_tpu/layers/moe.py``).

The gates (``TopKGate``, ``HashGate``, ``KTop1Gate``, ``SAMGate``,
``BalanceGate``) route each token to experts with a per-expert capacity
of ``C`` slots.  Each gate's ``index_plan`` is the one source of routing
truth: per choice rank ``(expert [T], slot [T], keep [T], gate [T])``,
with the capacity bucketing of ``_slot_positions`` (first come, first
served; a token past ``C`` is dropped).  A gate's ``forward`` densifies
that plan into the ``[T, E, C]`` one-hot dispatch and combine tensors,
for the einsum path and as the tests' oracle.

``MoELayer`` dispatches by index: one ``index_add`` of the kept tokens
into ``E * C`` capacity rows plus a junk row that the dropped tokens are
aimed at and that is then cut off (no boolean indexing, so no host
sync), the stacked experts (``ExpertMLP``, batched matrix products over
the expert dim), and a gather back at each token's slot weighted by its
gate.  Kept slots are unique and a dropped token's combine weight is an
exact zero, so the scatter's and the gather's atomics on CUDA add only
exact zeros to a shared row: the values and the gradients are bitwise
repeatable.

Expert parallelism is the JAX ``shard_map`` body's, whose manual axes
are the layer's ``axis`` (a name, or a tuple such as ``("ep", "tp")``:
the hierarchical exchange, the flat exchange over the axes' product,
first name outermost): the tokens' dim 0 is cut into ``ep`` blocks (the
product of the axes' sizes), each block is routed with its own capacity,
the ``[E, C, d]`` buckets are exchanged with the tiled ``all_to_all`` of
``parallel.collectives``, rank ``r`` runs its ``E / ep`` experts on
``[E / ep, ep * C, d]``, the outputs go back by the reverse exchange,
and ``aux`` and the routing stats are averaged over the ranks.  The
mesh's other axes change nothing of that function.  Two contexts:

* **Without a strategy** (a local mesh), whole tensors come in and the
  layer plays every rank: ``x.chunk(ep)``, each block on the one device.
* **Inside a strategy's rank** (``ShardingStrategy.install`` binds each
  rank's layer through ``_ep_setup``, as it binds the attention), the
  rank's piece of the batch comes in (``batch_axes``, which must hold the
  layer's axes) and the rank's module holds its ``E / ep`` experts (the
  rules' ``"experts": "ep"``).  The reference's block ``b`` spans the
  ``R = pieces / ep`` pieces ``b * R .. b * R + R - 1``: the pieces are
  permuted (``ppermute`` over the batch axes) so that the ``R`` ranks of
  ep index ``b`` hold them, and gathered over the batch axes other than
  ``axis``, so each of those ranks routes the whole block with the
  reference's capacity (the routing and the experts' products repeat
  ``R`` times).  Each rank keeps only its own piece's outputs and sends
  them home by the inverse permutation; the gather's backward sums the
  ranks' gradients of a piece, so each token's gradient reaches the gate
  and the experts once, and ``aux``, averaged over the ep group with
  Megatron's identity backward, is counted ``R`` times, as the
  reference's loss counts it.  An expert slice's gradient is partial
  over the ``R`` replicas: ``ShardedModel.reduce_grads`` sums it over
  them.  A layer without a mesh under a strategy routes the whole batch
  as one block, as the reference's does under ``jit``.

The gates' ``w`` is kept in torch's ``(E, d)`` layout and applied with
``F.linear`` (``interop.from_jax`` transposes the JAX ``(d, E)`` array);
the experts keep the JAX ``(E, d, h)`` / ``(E, h, d)`` layout.
``BalanceGate.centroids`` is a buffer, so no optimizer moves it.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hetu_tpu_torch.core.device import resolve_device
from hetu_tpu_torch.init import normal, zeros
from hetu_tpu_torch.ops import gelu
from hetu_tpu_torch.parallel.collectives import (all_gather, all_reduce_mean,
                                                 all_to_all, ppermute)

__all__ = [
    "TopKGate", "HashGate", "KTop1Gate", "SAMGate", "BalanceGate",
    "ExpertMLP", "MoELayer", "moe_transformer_mlp", "routing_stats",
]


def _one_hot(x, n, dtype=torch.float32):
    return F.one_hot(x.long(), n).to(dtype)


def _slot_positions(mask, capacity: int, fill=None):
    """Capacity bucketing shared by all gates: first-come-first-served
    positions per expert, tokens past ``capacity`` dropped.  ``mask``:
    [T,E] one-hot choices; ``fill``: [1,E] running per-expert occupancy
    from earlier choice ranks.  Returns (slot [T] int64, in_cap [T,E],
    new_fill).  The running count is taken along the rows of the
    transposed mask: on CUDA a scan along the outer dim of a [T, E]
    tensor runs E sequential scans (1.27 ms at T=8192, E=8 on an H100),
    the innermost-dim scan of its [E, T] copy a fraction of that; the
    counts are exact integers either way."""
    if fill is None:
        fill = torch.zeros((1, mask.shape[1]), dtype=torch.float32,
                           device=mask.device)
    pos = torch.cumsum(mask.T, dim=1).T - mask + fill
    new_fill = fill + mask.sum(dim=0, keepdim=True)
    in_cap = (pos < capacity).float() * mask
    slot = (pos * in_cap).sum(dim=-1).long()
    return slot, in_cap, new_fill


def _densify(plans, T: int, E: int, C: int, device):
    """Dense [T,E,C] (dispatch, combine) from an index plan: the einsum
    path and the tests' oracle."""
    dispatch = torch.zeros((T, E, C), dtype=torch.float32, device=device)
    combine = torch.zeros((T, E, C), dtype=torch.float32, device=device)
    for e_idx, slot, keep, g in plans:
        oh = (_one_hot(e_idx, E)[:, :, None] * _one_hot(slot, C)[:, None, :]
              * keep.float()[:, None, None])
        dispatch = dispatch + oh
        combine = combine + g[:, None, None] * oh
    return dispatch, combine


def routing_stats(plans, E: int):
    """Routing observability from an index plan:

    - ``overflow_frac``: the fraction of (token, choice) assignments that
      the capacity buckets dropped;
    - ``load_entropy``: the entropy of the kept per-expert load,
      normalized to [0, 1] (1 = balanced, 0 = every kept token on one
      expert: router collapse)."""
    total = 0
    kept = 0.0
    load = None
    for e_idx, _slot, keep, _g in plans:
        kf = keep.float()
        kept = kept + kf.sum()
        total += e_idx.shape[0]
        part = (_one_hot(e_idx, E) * kf[:, None]).sum(dim=0)
        load = part if load is None else load + part
    p = load / load.sum().clamp_min(1e-9)
    ent = -torch.where(p > 0, p * torch.log(p.clamp_min(1e-30)),
                       torch.zeros_like(p)).sum()
    return {
        "overflow_frac": 1.0 - kept / total,
        "load_entropy": (ent / math.log(E) if E > 1
                         else torch.ones((), device=load.device)),
    }


def _linear_gate(dim, num_experts, generator, dtype, device):
    """The router's ``w (E, d)`` and ``b (E,)``."""
    w = nn.Parameter(normal(stddev=0.02)(generator, (num_experts, dim),
                                         dtype, device))
    b = nn.Parameter(zeros(None, (num_experts,), dtype, device))
    return w, b


class _Gate(nn.Module):
    """``forward`` densifies ``index_plan``: ``(dispatch [T,E,C], combine
    [T,E,C], aux)``.  A gate's router ``w`` is ``(E, d)``, the JAX
    ``(d, E)`` transposed; gates without one have none to declare."""

    _jax_transposed = ("w",)

    def forward(self, x, *args, training: bool = True):
        plans, C, aux = self.index_plan(x, *args, training=training)
        dispatch, combine = _densify(plans, x.shape[0], self.num_experts, C,
                                     x.device)
        return dispatch, combine, aux

    def _logits(self, x):
        """``x @ w.T + b`` in the input's type, as fp32."""
        return F.linear(x, self.w.to(x.dtype), self.b.to(x.dtype)).float()

    def _probs(self, x):
        return torch.softmax(self._logits(x), dim=-1)


class TopKGate(_Gate):
    """Top-k router with capacity buckets and the load-balance auxiliary
    loss: softmax, k rounds of argmax / mask / fill, the balance term
    ``sum(mean gate * mean mask) * E`` per round, and for k > 1 the
    kept gates renormalized per token."""

    _logical_axes = {"w": ("embed", None)}

    def __init__(self, dim: int, num_experts: int, k: int = 2, *,
                 capacity_factor: float = 1.25,
                 eval_capacity_factor: Optional[float] = None,
                 generator=None, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.w, self.b = _linear_gate(dim, num_experts, generator, dtype,
                                      device)
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor or capacity_factor

    def capacity(self, n_tokens: int, training: bool = True) -> int:
        cf = self.capacity_factor if training else self.eval_capacity_factor
        return max(self.k, self.k * math.ceil(n_tokens / self.num_experts
                                              * cf))

    def index_plan(self, x, *, training: bool = True):
        T, E = x.shape[0], self.num_experts
        C = self.capacity(T, training)
        gates = self._probs(x)
        plans = []
        aux = 0.0
        remaining = gates
        fill = None
        for _ in range(self.k):
            idx = torch.argmax(remaining, dim=-1)
            mask = _one_hot(idx, E)
            remaining = remaining * (1.0 - mask)
            slot, in_cap, fill = _slot_positions(mask, C, fill)
            keep = in_cap.sum(dim=-1) > 0.0
            gate_i = (gates * mask).sum(dim=-1)
            plans.append((idx, slot, keep, gate_i))
            me = gates.mean(dim=0)
            ce = mask.mean(dim=0)
            aux = aux + (me * ce).sum() * E
        if self.k > 1:
            denom = sum(g * kp.float() for _, _, kp, g in plans)
            denom = denom.clamp_min(1e-9)
            plans = [(i, s, kp, g / denom) for i, s, kp, g in plans]
        return plans, C, aux


class HashGate(_Gate):
    """Content-independent routing: ``token_index % E`` by default, or
    the given ``indices``; every combine weight is 1 and aux is 0."""

    def __init__(self, dim: int, num_experts: int, *,
                 capacity_factor: float = 1.0):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.k = 1

    def capacity(self, n_tokens: int, training: bool = True) -> int:
        return max(1, math.ceil(n_tokens / self.num_experts
                                * self.capacity_factor))

    def index_plan(self, x, indices=None, *, training: bool = True):
        T, E = x.shape[0], self.num_experts
        C = self.capacity(T, training)
        if indices is None:
            indices = torch.arange(T, device=x.device) % E
        indices = indices.long()
        slot, in_cap, _ = _slot_positions(_one_hot(indices, E), C)
        keep = in_cap.sum(dim=-1) > 0.0
        gate = torch.ones((T,), dtype=torch.float32, device=x.device)
        return ([(indices, slot, keep, gate)], C,
                torch.zeros((), dtype=torch.float32, device=x.device))


class KTop1Gate(_Gate):
    """k independent top-1 routers over disjoint prototype groups of E/k
    experts: a softmax per prototype, top-1 inside it, so every token goes
    to exactly k experts; the balance loss is summed per prototype."""

    _logical_axes = {"w": ("embed", None)}

    def __init__(self, dim: int, num_experts: int, k: int = 2, *,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: Optional[float] = None,
                 generator=None, dtype=torch.float32, device=None):
        super().__init__()
        if num_experts % k:
            raise ValueError(f"{num_experts} experts not divisible by k={k}")
        device = resolve_device(device)
        self.w, self.b = _linear_gate(dim, num_experts, generator, dtype,
                                      device)
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor or capacity_factor

    def capacity(self, n_tokens: int, training: bool = True) -> int:
        cf = self.capacity_factor if training else self.eval_capacity_factor
        return max(1, self.k * math.ceil(n_tokens / self.num_experts * cf))

    def _pgates(self, x):
        """[T, k, E/k]: the softmax of each prototype's logits."""
        return torch.softmax(self._logits(x).reshape(x.shape[0], self.k, -1),
                             dim=-1)

    def index_plan(self, x, *, training: bool = True):
        T, E, k = x.shape[0], self.num_experts, self.k
        Ep = E // k
        C = self.capacity(T, training)
        pgates = self._pgates(x)
        idx = torch.argmax(pgates, dim=-1)             # [T, k]
        pmask = _one_hot(idx, Ep)                      # [T, k, Ep]
        gate_val = (pgates * pmask).sum(dim=-1)        # [T, k]
        me = pgates.mean(dim=0)
        ce = pmask.mean(dim=0)
        aux = ((me * ce).sum(dim=-1) * Ep).sum()
        plans = []
        for i in range(k):
            mask_i = torch.zeros((T, k, Ep), dtype=torch.float32,
                                 device=x.device)
            mask_i[:, i] = pmask[:, i]
            slot, in_cap, _ = _slot_positions(mask_i.reshape(T, E), C)
            keep = in_cap.sum(dim=-1) > 0.0
            plans.append((i * Ep + idx[:, i], slot, keep, gate_val[:, i]))
        return plans, C, aux


class SAMGate(_Gate):
    """Switch-and-mix locality-aware gate: softmax over all E experts,
    the gates summed within each of G contiguous groups, the token routed
    to its top-1 group, then top-k inside that group (``-inf`` outside).
    Aux: the balance term per choice plus ``alignment_weight`` times the
    mean over tokens of the out-of-group gates above the k-th chosen
    gate."""

    _logical_axes = {"w": ("embed", None)}

    def __init__(self, dim: int, num_experts: int, k: int = 2, *,
                 num_groups: int, capacity_factor: float = 1.0,
                 eval_capacity_factor: Optional[float] = None,
                 alignment_weight: float = 1.0, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if num_experts % num_groups:
            raise ValueError(f"{num_experts} experts not divisible into "
                             f"{num_groups} groups")
        if k > num_experts // num_groups:
            raise ValueError("k exceeds experts per group")
        device = resolve_device(device)
        self.w, self.b = _linear_gate(dim, num_experts, generator, dtype,
                                      device)
        self.num_experts = num_experts
        self.k = k
        self.num_groups = num_groups
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor or capacity_factor
        self.alignment_weight = alignment_weight

    def capacity(self, n_tokens: int, training: bool = True) -> int:
        cf = self.capacity_factor if training else self.eval_capacity_factor
        return max(1, self.k * math.ceil(n_tokens / self.num_experts * cf))

    def _grouped(self, x):
        """(gates [T,E], group sums [T,G], in-group mask [T,E], gates
        masked to the chosen group with -inf)."""
        T, E, G = x.shape[0], self.num_experts, self.num_groups
        gates = self._probs(x)
        group_sum = gates.reshape(T, G, E // G).sum(dim=-1)
        top1_group = torch.argmax(group_sum, dim=-1)
        in_group = _one_hot(top1_group, G).repeat_interleave(E // G, dim=1)
        masked = torch.where(in_group > 0, gates,
                             torch.full_like(gates, -math.inf))
        return gates, group_sum, in_group, masked

    def index_plan(self, x, *, training: bool = True):
        T, E = x.shape[0], self.num_experts
        C = self.capacity(T, training)
        gates, _, in_group, remaining = self._grouped(x)
        plans = []
        aux = 0.0
        fill = None
        last_gate = None
        for _ in range(self.k):
            idx = torch.argmax(remaining, dim=-1)
            mask = _one_hot(idx, E)
            remaining = torch.where(mask > 0,
                                    torch.full_like(remaining, -math.inf),
                                    remaining)
            slot, in_cap, fill = _slot_positions(mask, C, fill)
            keep = in_cap.sum(dim=-1) > 0.0
            gate_i = (gates * mask).sum(dim=-1)
            last_gate = gate_i
            plans.append((idx, slot, keep, gate_i))
            me = gates.mean(dim=0)
            ce = mask.mean(dim=0)
            aux = aux + (me * ce).sum() * E
        overflow = torch.clamp_min(gates - last_gate[:, None], 0.0)
        alignment = (overflow * (1.0 - in_group)).sum() / T
        return plans, C, aux + self.alignment_weight * alignment


class BalanceGate(_Gate):
    """BASE-layer balanced assignment: tokens scored against fixed
    orthogonal centroids (gain 0.1), ``sinkhorn_iters`` rounds of
    log-domain Sinkhorn towards rows summing to 1 and columns to T/E,
    then argmax with ``C = ceil(T/E)``; the combine weight is
    ``sigmoid(score)`` and aux is 0.  The centroids are a buffer: no
    optimizer moves them."""

    _jax_state = {"centroids": "float32"}

    def __init__(self, dim: int, num_experts: int, *,
                 sinkhorn_iters: int = 8, temperature: float = 1.0,
                 generator=None, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        w = torch.empty((num_experts, dim), dtype=torch.float32)
        w.normal_(generator=generator)
        tall = num_experts < dim
        q, r = torch.linalg.qr(w.T if tall else w)
        q = q * torch.sign(torch.diagonal(r))
        c = (q.T if tall else q).to(dtype) * 0.1
        self.register_buffer("centroids", c.to(device))
        self.num_experts = num_experts
        self.k = 1
        self.sinkhorn_iters = sinkhorn_iters
        self.temperature = temperature

    def capacity(self, n_tokens: int, training: bool = True) -> int:
        return max(1, math.ceil(n_tokens / self.num_experts))

    def _plan(self, x):
        """(scores [T,E] fp32, the balanced log-plan [T,E])."""
        T, E = x.shape[0], self.num_experts
        scores = (x @ self.centroids.to(x.dtype).T).float()
        logp = scores / self.temperature
        f = torch.zeros((T, 1), dtype=torch.float32, device=x.device)
        g = torch.zeros((1, E), dtype=torch.float32, device=x.device)
        for _ in range(self.sinkhorn_iters):
            f = -torch.logsumexp(logp + g, dim=1, keepdim=True)
            g = math.log(T / E) - torch.logsumexp(logp + f, dim=0,
                                                  keepdim=True)
        return scores, logp + f + g

    def index_plan(self, x, *, training: bool = True):
        E = self.num_experts
        C = self.capacity(x.shape[0], training)
        scores, plan = self._plan(x)
        idx = torch.argmax(plan, dim=-1)
        mask = _one_hot(idx, E)
        slot, in_cap, _ = _slot_positions(mask, C)
        keep = in_cap.sum(dim=-1) > 0.0
        weight = torch.sigmoid((scores * mask).sum(dim=-1))
        return ([(idx, slot, keep, weight)], C,
                torch.zeros((), dtype=torch.float32, device=x.device))


class ExpertMLP(nn.Module):
    """Stacked expert FFNs, ``w1 [E,d,h]``, ``b1 [E,h]``, ``w2 [E,h,d]``,
    ``b2 [E,d]`` with ``activation`` between (any callable; the tanh gelu
    by default), applied with batched matrix products over the expert
    dim (the JAX package ``vmap``s its XLA dots)."""

    _logical_axes = {"w1": ("experts", "embed", "mlp"),
                     "b1": ("experts", "mlp"),
                     "w2": ("experts", "mlp", "embed"),
                     "b2": ("experts", "embed")}

    def __init__(self, num_experts: int, dim: int, hidden: int, *,
                 activation: Callable = gelu, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        init = normal(stddev=0.02)
        p = nn.Parameter
        self.w1 = p(init(generator, (num_experts, dim, hidden), dtype,
                         device))
        self.b1 = p(zeros(None, (num_experts, hidden), dtype, device))
        self.w2 = p(init(generator, (num_experts, hidden, dim), dtype,
                         device))
        self.b2 = p(zeros(None, (num_experts, dim), dtype, device))
        self.activation = activation
        self.num_experts = num_experts

    def _tp_setup(self, handle, specs: dict, index: dict) -> None:
        """A strategy's rank holds the experts of its ep index: the rules
        may place the expert dimension, and nothing else."""
        for attr, spec in specs.items():
            if any(e is not None for e in spec[1:]):
                raise NotImplementedError(
                    f"ExpertMLP.{attr} sharded {spec}: only the expert "
                    f"dimension is placed (over the layer's ep axes)")

    def forward(self, x, first: int = 0):
        """x ``[n, tokens, dim]`` through experts ``first .. first+n-1``
        (all of them by default) -> the same shape."""
        sl = slice(first, first + x.shape[0])
        dt = x.dtype
        h = self.activation(torch.bmm(x, self.w1[sl].to(dt))
                            + self.b1[sl].to(dt)[:, None, :])
        return (torch.bmm(h, self.w2[sl].to(dt))
                + self.b2[sl].to(dt)[:, None, :])


def _pmean(values):
    return sum(values[1:], values[0]) / len(values)


def _ravel(coords: dict, axes, shape: dict) -> int:
    """The combined index over ``axes``, the first outermost."""
    i = 0
    for a in axes:
        i = i * shape[a] + coords[a]
    return i


def _unravel(i: int, axes, shape: dict) -> dict:
    out = {}
    for a in reversed(axes):
        out[a] = i % shape[a]
        i //= shape[a]
    return out


def _permute(shards, axis, *, perm, mesh):
    return ppermute(shards, perm, axis, mesh=mesh)


class MoELayer(nn.Module):
    """Gate, dispatch, experts, combine.  ``mesh=None`` (or ``ep`` of 1) is
    the single-group layer; a mesh whose ``axis`` (a name or a tuple of
    names) is above 1 runs expert parallelism over its ranks (the module
    docstring's two contexts).

    Call: ``y, aux = moe(x, training=True)`` with x ``[..., dim]``;
    ``with_stats=True`` returns ``(y, (aux, stats))`` with
    :func:`routing_stats` of the call's plan."""

    _rank = None   # (handle, batch axes, ep axes) inside a strategy's rank

    def __init__(self, gate: nn.Module, experts: ExpertMLP, *, mesh=None,
                 axis: "str | Sequence[str]" = "ep"):
        super().__init__()
        self.gate = gate
        self.experts = experts
        self.mesh = mesh
        self.axis = (axis,) if isinstance(axis, str) else tuple(axis)
        if mesh is not None:
            for a in self.axis:
                if a not in mesh.axis_names:
                    raise ValueError(f"axis {a!r} not in mesh axes "
                                     f"{mesh.axis_names}")

    def _ep_setup(self, handle, batch_axes: tuple) -> None:
        """Bind this layer to a strategy's rank (``handle``), whose piece
        of the batch is cut over ``batch_axes`` (the module docstring's
        second context)."""
        mesh = handle.mesh
        if self.mesh is not None and \
                dict(self.mesh.shape) != dict(mesh.shape):
            raise ValueError(f"the MoE layer's mesh {self.mesh.shape} is "
                             f"not its rank's {mesh.shape}")
        ep_axes = tuple(a for a in (self.axis if self.mesh is not None
                                    else ()) if mesh.shape[a] > 1)
        batch = tuple(a for a in batch_axes if mesh.shape[a] > 1)
        if not set(ep_axes) <= set(batch):
            raise NotImplementedError(
                f"expert parallelism over {ep_axes} under a strategy that "
                f"splits the batch over {tuple(batch_axes)}: the layer's "
                f"axes must be among the batch axes")
        self._rank = (handle, batch, ep_axes)

    def _route_in(self, gate, t, training):
        """(ex_in [E,C,d], routing context, aux).  The index path when the
        gate has ``index_plan``: one ``index_add`` per choice rank into
        ``E*C + 1`` rows, the dropped tokens aimed at the last row, which
        is cut off; else the one-hot einsum."""
        E = self.experts.num_experts
        d = t.shape[1]
        if hasattr(gate, "index_plan"):
            plans, C, aux = gate.index_plan(t, training=training)
            flat = t.new_zeros((E * C + 1, d))
            for e_idx, slot, keep, _g in plans:
                tgt = torch.where(keep, e_idx * C + slot,
                                  torch.full_like(e_idx, E * C))
                flat = flat.index_add(0, tgt, t)
            return flat[:E * C].reshape(E, C, d), ("idx", plans, C), aux
        dispatch, combine, aux = gate(t, training=training)
        ex_in = torch.einsum("tec,td->ecd", dispatch.to(t.dtype), t)
        return ex_in, ("oh", combine), aux

    def _route_out(self, ctx, ex_out, t_dtype):
        """Expert outputs back to tokens: a gather at each token's clipped
        ``e*C + slot``, weighted by ``gate * keep`` in the token type and
        summed over the choice ranks."""
        if ctx[0] == "idx":
            _, plans, C = ctx
            flat = ex_out.reshape(-1, ex_out.shape[-1])
            y = 0.0
            for e_idx, slot, keep, g in plans:
                src = (e_idx * C + slot).clamp(0, flat.shape[0] - 1)
                w = (g * keep.float()).to(t_dtype)
                y = y + flat[src] * w[:, None]
            return y
        _, combine = ctx
        return torch.einsum("tec,ecd->td", combine.to(t_dtype), ex_out)

    def _stats_of(self, ctx, E):
        if ctx[0] != "idx":
            raise ValueError(
                "with_stats needs a gate with index_plan (scatter path)")
        return routing_stats(ctx[1], E)

    def ep_size(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.axis)

    def forward(self, x, *, training: bool = True,
                with_stats: bool = False):
        if self._rank is not None:
            return self._forward_rank(x, training, with_stats)
        if self.mesh is not None and hasattr(self.mesh, "group") and \
                self.ep_size() > 1:
            raise ValueError(
                "on a process mesh the MoE layer runs bound to its rank: "
                "install the model with ShardingStrategy(mesh=...)")
        shape = x.shape
        d = shape[-1]
        ep = self.ep_size()
        E = self.experts.num_experts
        if E % ep:
            raise ValueError(f"{E} experts not divisible over ep={ep}")
        if ep == 1:
            t = x.reshape(-1, d)
            ex_in, ctx, aux = self._route_in(self.gate, t, training)
            y = self._route_out(ctx, self.experts(ex_in), t.dtype)
            if with_stats:
                return y.reshape(shape), (aux, self._stats_of(ctx, E))
            return y.reshape(shape), aux
        if shape[0] % ep:
            raise ValueError(f"dim 0 of {tuple(shape)} is not divisible "
                             f"over ep={ep}")
        shards = x.chunk(ep, dim=0)
        routed = [self._route_in(self.gate, s.reshape(-1, d), training)
                  for s in shards]
        # [E, C, d] on each rank -> rank r holds its E/ep experts' buckets
        # from every rank, [E/ep, ep*C, d]
        ex_in = all_to_all([r[0] for r in routed], split_dim=0,
                           concat_dim=1)
        e_local = E // ep
        ex_out = [self.experts(a, first=r * e_local)
                  for r, a in enumerate(ex_in)]
        ex_out = all_to_all(ex_out, split_dim=1, concat_dim=0)
        y = torch.cat([self._route_out(ctx, o, x.dtype).reshape(s.shape)
                       for (_, ctx, _), o, s in zip(routed, ex_out, shards)],
                      dim=0)
        aux = _pmean([r[2] for r in routed])
        if with_stats:
            per_rank = [self._stats_of(r[1], E) for r in routed]
            stats = {k: _pmean([s[k] for s in per_rank])
                     for k in per_rank[0]}
            return y, (aux, stats)
        return y, aux


    def _forward_rank(self, x, training, with_stats):
        """One strategy rank's call on its piece ``x`` (the module
        docstring's second context)."""
        handle, batch, ep_axes = self._rank
        mesh = handle.mesh
        shape = mesh.shape
        E = self.experts.num_experts
        ep = math.prod(shape[a] for a in ep_axes)
        if E % ep or self.experts.w1.shape[0] != E // ep:
            raise ValueError(f"a rank holds {self.experts.w1.shape[0]} of "
                             f"{E} experts over ep={ep}: the rules must "
                             f"place the experts over {ep_axes}")
        reps = tuple(a for a in batch if a not in ep_axes)
        R = math.prod(shape[a] for a in reps)
        i = _ravel(mesh.coords(mesh.held[handle.index]), reps, shape)
        # the rank at batch index p routes block j(p) as replica i(p) and
        # keeps the piece j(p) * R + i(p): ``perm`` sends it home
        perm = []
        for p in range(R * ep):
            c = _unravel(p, batch, shape)
            perm.append((p, _ravel(c, ep_axes, shape) * R
                         + _ravel(c, reps, shape)))
        moved = any(s != t for s, t in perm)
        xb = x
        if moved:
            xb = handle.collective(_permute, xb, batch,
                                   perm=[(t, s) for s, t in perm])
        if R > 1:
            xb = handle.collective(all_gather, xb, reps, gather_dim=0)
        t = xb.reshape(-1, x.shape[-1])
        ex_in, ctx, aux = self._route_in(self.gate, t, training)
        if ep > 1:
            ex_in = handle.collective(all_to_all, ex_in, ep_axes,
                                      split_dim=0, concat_dim=1)
        ex_out = self.experts(ex_in)
        if ep > 1:
            ex_out = handle.collective(all_to_all, ex_out, ep_axes,
                                       split_dim=1, concat_dim=0)
        y = self._route_out(ctx, ex_out, t.dtype).reshape(xb.shape)
        if R > 1:
            y = y.chunk(R, dim=0)[i]
        if moved:
            y = handle.collective(_permute, y, batch, perm=perm)
        stats = self._stats_of(ctx, E) if with_stats else None
        if ep > 1:
            aux = handle.collective(all_reduce_mean, aux, ep_axes)
            if with_stats:
                stats = {k: handle.collective(all_reduce_mean, v, ep_axes)
                         for k, v in sorted(stats.items())}
        if with_stats:
            return y, (aux, stats)
        return y, aux


def moe_transformer_mlp(dim: int, hidden: int, num_experts: int, *,
                        k: int = 2, capacity_factor: float = 1.25,
                        mesh=None, generator=None, dtype=torch.float32,
                        device=None) -> MoELayer:
    """The MoE-transformer FFN: a ``TopKGate`` and an ``ExpertMLP``."""
    gate = TopKGate(dim, num_experts, k, capacity_factor=capacity_factor,
                    generator=generator, dtype=dtype, device=device)
    experts = ExpertMLP(num_experts, dim, hidden, generator=generator,
                        dtype=dtype, device=device)
    return MoELayer(gate, experts, mesh=mesh)

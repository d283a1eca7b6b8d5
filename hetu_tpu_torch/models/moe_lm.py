"""MoE transformer LM (counterpart of ``hetu_tpu/models/moe_lm.py``): the
expert-parallel benchmark model family, ``bench.py`` config 3.

Pre-LN causal blocks whose FFN is a top-k MoE layer
(``layers.moe.moe_transformer_mlp``; with a local ``ep`` mesh its experts
run expert-parallel), learned positions, and logits tied to the token
embedding, materialized as ``x @ wte.weight.T`` (as in the JAX model).
The loss is the next-token cross entropy plus ``aux_weight`` times the
gates' balance loss summed over the blocks; with ``log_routing_stats``
its metrics carry the layer-averaged ``overflow_frac`` and
``load_entropy`` beside ``aux``.  ``remat`` applies a policy of
``hetu_tpu_torch.mem.policy`` to each block, the expert dispatch
included.  Weights come from an explicit seeded ``torch.Generator``, or
from a JAX model through ``interop.from_jax.load_jax_params``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from hetu_tpu_torch.core.device import resolve_device
from hetu_tpu_torch.core.dtypes import as_dtype
from hetu_tpu_torch.init import normal
from hetu_tpu_torch.layers import Embedding, LayerNorm, MultiHeadAttention
from hetu_tpu_torch.layers.moe import moe_transformer_mlp
from hetu_tpu_torch.mem.policy import maybe_remat, normalize_remat_field
from hetu_tpu_torch.ops.losses import softmax_cross_entropy_sparse

__all__ = ["MoELMConfig", "MoEBlock", "MoELM"]


@dataclasses.dataclass(frozen=True)
class MoELMConfig:
    """The JAX config's fields.  ``log_routing_stats`` threads the
    routing stats into the loss metrics; ``remat`` is the blocks' remat
    policy (``True`` means ``"full"``, deprecated)."""

    vocab_size: int = 32000
    hidden_size: int = 512
    num_layers: int = 4
    num_heads: int = 8
    num_experts: int = 8
    mlp_ratio: int = 4
    top_k: int = 2
    capacity_factor: float = 1.25
    max_seq_len: int = 1024
    aux_weight: float = 0.01
    initializer_range: float = 0.02
    log_routing_stats: bool = False
    remat: object = "none"
    dtype: object = torch.float32

    def __post_init__(self):
        normalize_remat_field(self)


class MoEBlock(nn.Module):
    """Pre-LN causal attention + MoE FFN; returns ``(x, aux)`` or, with
    stats, ``(x, (aux, stats))``.  ``use_moe=False`` is the dense variant
    of every-other-layer MoE: no FFN, an aux of 0 and no stats."""

    def __init__(self, cfg: MoELMConfig, *, mesh=None, attn_fn=None,
                 use_moe: bool = True, generator=None, device=None):
        super().__init__()
        d = cfg.hidden_size
        dtype = as_dtype(cfg.dtype)
        self.ln1 = LayerNorm(d, device=device)
        self.attn = MultiHeadAttention(d, cfg.num_heads, causal=True,
                                       attn_fn=attn_fn, generator=generator,
                                       dtype=dtype, device=device)
        self.ln2 = LayerNorm(d, device=device)
        self.moe = moe_transformer_mlp(
            d, cfg.mlp_ratio * d, cfg.num_experts, k=cfg.top_k,
            capacity_factor=cfg.capacity_factor, mesh=mesh,
            generator=generator, dtype=dtype, device=device) \
            if use_moe else None

    def forward(self, x, *, training: bool = False,
                with_stats: bool = False):
        x = x + self.attn(self.ln1(x))
        if self.moe is None:
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            return x, ((zero, None) if with_stats else zero)
        y, aux = self.moe(self.ln2(x), training=training,
                          with_stats=with_stats)
        return x + y, aux


class MoELM(nn.Module):
    """Decoder-only MoE LM; ``forward`` returns ``(logits, aux_total)``.
    ``MoELM(cfg, mesh=None, attn_fn=None, device=None, generator=None)``:
    ``attn_fn`` is the blocks' attention core (None: materialized;
    ``flash_attn_fn(native_layout=True)`` for the flash kernels);
    ``device=None`` is CUDA (raises without it); ``generator`` defaults
    to a CPU generator seeded with 0."""

    def __init__(self, cfg: MoELMConfig, *, mesh=None, attn_fn=None,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dtype = as_dtype(cfg.dtype)
        init = normal(stddev=cfg.initializer_range)
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size,
                             initializer=init, generator=generator,
                             dtype=dtype, device=device)
        self.wpe = Embedding(cfg.max_seq_len, cfg.hidden_size,
                             initializer=init, generator=generator,
                             dtype=dtype, device=device)
        self.blocks = nn.ModuleList([
            MoEBlock(cfg, mesh=mesh, attn_fn=attn_fn, generator=generator,
                     device=device)
            for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, device=device)
        self.config = cfg

    def forward(self, input_ids, *, training: bool = False,
                with_stats: bool = False):
        """``(logits (b, s, V), aux)``, or with stats ``(logits, (aux,
        stats))`` where stats are the blocks' routing stats averaged."""
        s = input_ids.shape[-1]
        x = self.wte(input_ids) + self.wpe(
            torch.arange(s, device=input_ids.device))
        aux_total = 0.0
        stats_acc, n_moe = None, 0
        step = maybe_remat(
            lambda b, xx: b(xx, training=training, with_stats=with_stats),
            self.config.remat)
        for blk in self.blocks:
            x, aux = step(blk, x)
            if with_stats:
                aux, stats = aux
                if stats is not None:
                    n_moe += 1
                    stats_acc = stats if stats_acc is None else {
                        k: stats_acc[k] + v for k, v in stats.items()}
            aux_total = aux_total + aux
        logits = self._head(self.ln_f(x))
        if with_stats:
            return logits, (aux_total,
                            {k: v / n_moe for k, v in stats_acc.items()}
                            if stats_acc else {})
        return logits, aux_total

    def _head(self, x):
        """The tied head: ``x @ wte.weight.T`` in x's type."""
        return F.linear(x, self.wte.weight.to(x.dtype))

    def loss(self, input_ids, *, training: bool = True):
        """``(nll.mean() + aux_weight * aux, metrics)``: the next-token
        cross entropy over ``batch * (seq - 1)`` positions; metrics hold
        ``aux``, and with ``log_routing_stats`` ``overflow_frac`` and
        ``load_entropy``."""
        with_stats = self.config.log_routing_stats
        out = self(input_ids, training=training, with_stats=with_stats)
        metrics = {}
        if with_stats:
            logits, (aux, stats) = out
            metrics.update(stats)
        else:
            logits, aux = out
        nll = softmax_cross_entropy_sparse(logits[:, :-1], input_ids[:, 1:])
        metrics["aux"] = aux
        return nll.mean() + self.config.aux_weight * aux, metrics

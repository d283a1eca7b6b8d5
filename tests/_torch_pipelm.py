"""The pipelined causal LM of ``__graft_entry__.py``'s config A in both
packages: an embedding, ``Pipelined`` transformer blocks, a final layer
norm and the head tied to the embedding.  Not a test module; the
pipeline tests import it."""

import numpy as np
import torch

from hetu_tpu_torch.layers import Embedding, LayerNorm, TransformerBlock
from hetu_tpu_torch.ops.losses import (lm_head_cross_entropy,
                                       softmax_cross_entropy_sparse,
                                       vocab_parallel_cross_entropy)
from hetu_tpu_torch.parallel.pipeline import Pipelined


def jax_pipelm(vocab, d, heads, n_layers, *, mesh, n_microbatches,
               remat="full"):
    from hetu_tpu.core.module import Module
    from hetu_tpu.layers import Embedding as JEmbedding
    from hetu_tpu.layers import LayerNorm as JLayerNorm
    from hetu_tpu.layers import TransformerBlock as JBlock
    from hetu_tpu.ops import softmax_cross_entropy_sparse as jce
    from hetu_tpu.parallel.pipeline import Pipelined as JPipelined

    class PipeLM(Module):
        def __init__(self):
            self.embed = JEmbedding(vocab, d)
            self.blocks = JPipelined(
                [JBlock(d, heads, causal=True) for _ in range(n_layers)],
                n_microbatches=n_microbatches, mesh=mesh, remat=remat)
            self.ln = JLayerNorm(d)

        def loss(self, ids, key=None, training=False):
            h = self.blocks(self.embed(ids), key=key, training=training)
            logits = self.ln(h) @ self.embed.weight.T
            return jce(logits[:, :-1], ids[:, 1:]).mean()

    return PipeLM()


class PipeLM(torch.nn.Module):
    """The port's config-A LM; ``chunk > 0`` streams the head through
    ``lm_head_cross_entropy``, and a rank holding a vocabulary shard
    streams its shard through ``vocab_parallel_cross_entropy``."""

    def __init__(self, vocab, d, heads, n_layers, *, mesh, n_microbatches,
                 remat="full", chunk=0, attn_fn=None, dropout_rate=0.0,
                 device="cpu"):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.embed = Embedding(vocab, d, generator=g, device=device)
        self.blocks = Pipelined(
            [TransformerBlock(d, heads, causal=True, attn_fn=attn_fn,
                              dropout_rate=dropout_rate, generator=g,
                              device=device) for _ in range(n_layers)],
            n_microbatches=n_microbatches, mesh=mesh, remat=remat)
        self.ln = LayerNorm(d, device=device)
        self.chunk = chunk

    def loss(self, ids, key=None, training=False):
        h = self.ln(self.blocks(self.embed(ids), key=key, training=training))
        b, s = ids.shape
        x = h[:, :-1].reshape(b * (s - 1), -1)
        labels = ids[:, 1:].reshape(-1)
        if self.embed._tp is not None:
            return vocab_parallel_cross_entropy(
                x, self.embed.weight, labels, self.embed.vocab_start,
                self.embed._tp, chunk=self.chunk or 8192).mean()
        if self.chunk:
            return lm_head_cross_entropy(x, self.embed.weight, labels,
                                         chunk=self.chunk).mean()
        logits = h @ self.embed.weight.T
        return softmax_cross_entropy_sparse(logits[:, :-1],
                                            ids[:, 1:]).mean()


def jax_named(model) -> dict:
    from hetu_tpu.core.module import named_parameters
    return {n: np.asarray(a) for n, a in named_parameters(model)}

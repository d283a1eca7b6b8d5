"""hetu_tpu_torch — the PyTorch/CUDA port of ``hetu_tpu``.

The package mirrors ``hetu_tpu``'s module names so each counterpart is
easy to find.  It imports ``torch`` and numpy, never ``jax`` and nothing
of ``hetu_tpu``; the jax-free host logic it needs (the batcher, the obs
registry and journal, the metrics, the CTR and image data, the
dataloader) is carried over as its own copy.

Nine slices are ported.  GPT serving: prefill on the bucketed gather
path, the paged decode step and the fused greedy LM head.  GPT training:
``GPT.loss`` through flash attention and the streamed LM-head cross
entropy, gradients, AdamW and the ``Trainer``.  BERT pretraining:
``BertForPreTraining.loss`` with dropout keyed by the port's
threefry2x32 (``core.prng``, ``core.rng``) and the fused post-LN
residual + dropout + LayerNorm.  The training knobs of both models:
the remat policies (``mem``), ``compute_dtype``, the optimizers and
schedulers (``optim``), the ``Trainer``'s ``grad_guard``,
``scan_steps`` and ``profile``, and checkpoints in the JAX package's
file format (``exec.checkpoint``).  Sequence parallelism: ring attention
(``ring_attn_fn``) and Ulysses over a local ``sp`` mesh whose ranks share
this process's device (``parallel``), the ring's visits running the
flash block kernels.  Data, ZeRO and Megatron tensor parallelism
(``parallel.strategies``, ``Trainer(strategy=)``) over a local mesh or
a ``torch.distributed`` world, each rank running the flash and LM-head
CE kernels at its own shapes.  CTR training with the HET host-embedding cache:
the CTR and NCF models (``models.ctr``, ``models.ncf``) with their rows
in the host engine (``embed``: the reference's C++ engine, built by the
port with ``g++``, and its staged, HBM-cached and tiered layers), the
``Trainer``'s staged seams and the optimizers' lazy ``IndexedSlices``
path.  The MoE transformer LM (``models.moe_lm``, ``bench.py`` config
3) with the five gates, the capacity dispatch, the stacked experts and
expert parallelism over a local ``ep`` mesh (``layers.moe``), and
BERT's MoE and task heads.  The vision family (``bench.py`` config 1,
ResNet-18 on CIFAR-10): convolution, pooling, BatchNorm and the other
norms (``ops.nn``, ``layers.conv``, ``layers.norm``), ResNet, the small
CNNs and MLPs (``models.simple``), ViT (its attention on the flash
kernels) and Swin, on ``data``'s ``cifar10`` / ``mnist`` and its
``Dataloader``.  T5 (``models.t5``), the RNN cells and classifiers
(``models.rnn``) and the GCN (``models.gnn``), on the whole op surface
(``ops``: shape, reduce, math, losses, the CSR matrices).  The
embedding compression suite (``embed.compress``) and the distributed
embedding path: shard tables on network PS servers (``embed.net``,
``embedding="remote"``), versioned snapshots streamed to read-only CTR
serving replicas (``embed.stream``, ``ServingEngine.infer_ctr``), dense
training through the PS (``embed.ps_dp``) and server-side graph
sampling (``embed.graph``).  The ten
Pallas kernel entry points on those paths are hand-written CUDA C++ for
``sm_90a`` (``hetu_tpu_torch/csrc``), built with ``nvcc`` at first use;
no Pallas kernel lies on T5's, the RNNs', the GCN's or the embedding
path's.

Entry points (``GPT``, ``BertForPreTraining`` and the other BERT
models, ``MoELM``, the MoE gates and experts, the vision models, T5,
the RNNs, the GCN and ``normalize_adjacency``, ``Dataloader.prefetch``,
``KVCachePool``, ``ServingEngine``, ``make_mesh``, the CTR and NCF
models, the embedding layers, ``PSDataParallel`` and the op surface's
tensor factories)
take ``device=None``, which means CUDA and raises when no CUDA device
exists.
The CPU runs only when a caller asks for it with ``device="cpu"``.
"""

from hetu_tpu_torch.core import (Policy, get_seed_status, logical_axes,
                                 next_key, param_count, reset_seed_seqnum,
                                 resolve_device, set_random_seed)
from hetu_tpu_torch.data import Dataloader, cifar10, mnist, synthetic_lm
from hetu_tpu_torch.exec.executor import Executor, Trainer
from hetu_tpu_torch.models.gnn import GCN, normalize_adjacency
from hetu_tpu_torch.models.bert import (BertConfig, BertForPreTraining,
                                        bert_base, bert_large)
from hetu_tpu_torch.models.gpt import (GPT, GPTConfig, gpt2_large,
                                       gpt2_medium, gpt2_small)
from hetu_tpu_torch.models.moe_lm import MoELM, MoELMConfig
from hetu_tpu_torch.models.resnet import ResNet, resnet18, resnet34
from hetu_tpu_torch.models.rnn import RNNClassifier
from hetu_tpu_torch.models.swin import Swin, SwinConfig, swin_tiny
from hetu_tpu_torch.models.t5 import (T5Config, T5ForConditionalGeneration,
                                      t5_base)
from hetu_tpu_torch.models.vit import ViT, ViTConfig, vit_base
from hetu_tpu_torch.ops.kernels.flash import flash_attn_fn
from hetu_tpu_torch.optim.optimizers import (AdamOptimizer, AdamWOptimizer,
                                             MomentumOptimizer)
from hetu_tpu_torch.parallel import (DataParallel, MegatronTP, MeshSpec,
                                     ShardingStrategy, ZeRO, make_mesh,
                                     ring_attn_fn, ulysses_attn_fn)
from hetu_tpu_torch.serve.engine import RequestHandle, ServingEngine
from hetu_tpu_torch.serve.kv_cache import KVCachePool

__all__ = ["resolve_device", "GPT", "GPTConfig", "gpt2_small",
           "gpt2_medium", "gpt2_large", "KVCachePool", "ServingEngine",
           "RequestHandle", "Trainer", "Executor", "AdamOptimizer",
           "AdamWOptimizer", "MomentumOptimizer", "MoELM", "MoELMConfig",
           "ResNet", "resnet18", "resnet34", "ViT", "ViTConfig", "vit_base",
           "Swin", "SwinConfig", "swin_tiny", "Dataloader", "cifar10",
           "mnist", "synthetic_lm", "T5Config", "T5ForConditionalGeneration",
           "t5_base", "RNNClassifier", "GCN", "normalize_adjacency",
           "flash_attn_fn", "BertConfig", "BertForPreTraining", "bert_base",
           "bert_large", "set_random_seed", "next_key", "get_seed_status",
           "reset_seed_seqnum", "logical_axes", "param_count", "Policy",
           "MeshSpec",
           "make_mesh", "ring_attn_fn", "ulysses_attn_fn",
           "ShardingStrategy", "DataParallel", "ZeRO", "MegatronTP"]

"""Parallelism (counterpart of ``hetu_tpu/parallel``): the meshes (a
local mesh whose ranks share this process's device, and a process mesh
over a ``torch.distributed`` world), the collectives over both, the
sharding algebra and logical-axis rules (``spec``), the strategies —
data parallelism, ZeRO 1-3 and Megatron tensor parallelism, with
pipelines over ``pp``, run by the ``Trainer`` through ``strategy=`` —
the pipelines themselves (GPipe, ``pipeline``; synchronous, interleaved
and asynchronous 1F1B with HetPipe's dp mean, ``pipedream``;
heterogeneous dp degrees per stage, ``hetero``), the sequence-parallel
cores (ring attention and Ulysses, over ``sp`` alone or beside ``dp``
and ``tp`` with the heads kept tp-sharded, on both meshes), expert
parallelism beside them (the MoE exchange over ``ep`` or a tuple of
axes, the batch cut over ``("dp", "ep")``, on both meshes) and the
auto-parallel search (``parallel.autoparallel``).  Still refused, each
naming its ROADMAP item: ``sp`` beside ``pp`` or under a remat policy in
a strategy (part 12), a tp-sharded convolution (part 7), and the
strategies' other refusals (part 11)."""

from hetu_tpu_torch.parallel.mesh import (DEFAULT_AXES, LocalMesh, MeshSpec,
                                          ProcessMesh, local_mesh_size,
                                          make_grid_mesh, make_mesh)
from hetu_tpu_torch.parallel.spec import (DP_RULES, MEGATRON_RULES, AxisRules,
                                          PartitionSpec, ShardState,
                                          gather_param, logical_axes,
                                          resolve_specs, shard_param,
                                          transition)
from hetu_tpu_torch.parallel.strategies import (DataParallel, MegatronTP,
                                                ShardingStrategy, ZeRO)
from hetu_tpu_torch.parallel.pipeline import (Pipelined, spmd_pipeline,
                                              stack_modules, stage_partition)
from hetu_tpu_torch.parallel.pipedream import (interleave_stages,
                                               pipedream_grads,
                                               pipedream_schedule_stats,
                                               pipedream_train_step,
                                               uninterleave_stages)
from hetu_tpu_torch.parallel.hetero import (HeteroPipeline, HeteroStage,
                                            plan_hetero_dp)
from hetu_tpu_torch.parallel.collectives import (all_to_all,
                                                 hierarchical_all_to_all,
                                                 ppermute, send_next)
from hetu_tpu_torch.parallel.ring_attention import (ring_attention,
                                                    ring_attn_fn,
                                                    ring_flash_attention,
                                                    ulysses_attention,
                                                    ulysses_attn_fn)
from hetu_tpu_torch.parallel import collectives

__all__ = ["DEFAULT_AXES", "LocalMesh", "MeshSpec", "ProcessMesh",
           "local_mesh_size", "make_grid_mesh", "make_mesh", "DP_RULES", "MEGATRON_RULES",
           "AxisRules", "PartitionSpec", "ShardState", "gather_param",
           "logical_axes", "resolve_specs", "shard_param", "transition",
           "DataParallel", "MegatronTP", "ShardingStrategy", "ZeRO",
           "Pipelined", "spmd_pipeline", "stack_modules", "stage_partition",
           "interleave_stages", "pipedream_grads", "pipedream_schedule_stats",
           "pipedream_train_step", "uninterleave_stages", "HeteroPipeline",
           "HeteroStage", "plan_hetero_dp",
           "all_to_all", "hierarchical_all_to_all", "ppermute", "send_next",
           "ring_attention",
           "ring_attn_fn", "ring_flash_attention", "ulysses_attention",
           "ulysses_attn_fn", "collectives"]

#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``hetu_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()`` so a fault shows
where it happened; any failure exits non-zero:

1. device: torch / CUDA versions and the card's name and power limit;
2. build: the CUDA kernels compiled from ``hetu_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/``;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its main path gives it (fp32 and bf16; the paged pool's
   scratch page poisoned with NaN, a length-0 row NaN, the length-1024
   row served alone bitwise the same as in the batch, and paged decode
   timed again at the lengths phase 4's 126 decode steps reach; LM-head
   sampling at N=8 E=768 V=50257, k 1 and 5, plus rows of NaN, +inf and
   -inf logits whose indices must equal the plain version's; the
   threefry bits, the uniform (bitwise) and the Gumbel field (2e-6) of
   the decode step's (8, 50257) on the card against the CPU, and
   ``lm_head_sample_tokens`` in temperature and top-k mode against its
   plain route on the same field; flash at
   B=8 H=12 S=1024 D=64 causal,
   at a ragged S=1000, and in bf16 at BERT-large's seq-512 shape,
   B=24 H=16 S=512 D=64 non-causal (the reference's one-kv-block case); the LM-head cross entropy at N=8184 E=768
   V=50257 with ignored labels and a bias, and at GPT-2 XL's width
   E=1600 with N and V ragged; the ring's block kernels at
   one rank's q, k, v of (8, 12, 256, 64), a diagonal and a past visit
   fed the whole sequence's lse and delta), with the maximum error, the
   tolerance, every backward run twice and compared bitwise, and
   CUDA-event medians of kernel / plain / library times beside the
   least time the card could take (the bound);
4. engine: GPT-2 small at full width and depth (random weights from a
   seeded generator, trainable) serves 16 requests through
   ``ServingEngine`` with autograd off in every module call, the paged
   decode step one captured CUDA graph; both kernels must have launched
   on that run (12 paged-decode and 1 LM-head launch a decode step,
   counted through the graph's replays), decode must build no
   contiguous K/V view, a request served alone must give the same
   stream as inside the batch, a replayed step must equal the eager
   step bitwise (tokens and pool bytes), and the first generated tokens
   must agree with a full-recompute greedy reference run on the CPU;
   a one-token request alone at 16 and 128 prompt tokens is timed for
   information (the prefill runs its products in blocks of one page).
   Then the same 16 requests again in ``temperature`` (T = 0.8) and
   ``top_k`` (k = 5, T = 0.8) mode, each with the same launch counts, a
   same-seed rerun bitwise equal, the probe request alone (under its
   batched id) equal to its batched stream and a replayed step equal to
   the eager one; agreement with the gather path, tokens/s, the median
   decode step and the decode profile with the graph and without it are
   printed for information;
5. train: GPT-2 small at full width and depth, fp32, with
   ``flash_attn_fn(native_layout=True)`` and the streamed head (chunk
   1024): the step-0 loss and every gradient against the plain path on
   the card (materialized attention and head, same weights), then 5
   AdamW ``Trainer`` steps on one 8 x 1024 batch, each launching 12
   flash forwards, 12 flash backwards, 1 CE forward and 1 CE backward,
   with a falling loss; step time, tokens/s, peak memory and a profiled
   step with the CE kernels' summed device time;
6. train: BERT-large post-LN pretraining (24 layers, hidden 1024, 16
   heads, vocab 30522, dropout 0.1, ``fused_ln=True``, materialized
   ``(B, H, S, D)`` attention and MLM head): a step-0 check in fp32 at
   batch 8 x 128 with one fixed key, the fused kernels against plain
   ``dropout`` + ``layer_norm`` with the same weights (loss and every
   gradient), then 5 AdamW ``Trainer`` steps in bf16 at batch 96 x 128
   (keys from ``next_key``), each launching 48 fused-LN forwards and 48
   backwards, with a falling loss; step time, samples/s, tokens/s, peak
   memory and a profiled step;
7. train: GPT-2 small as in phase 5 with sequence-parallel ring
   attention, ``ring_attn_fn(make_mesh(MeshSpec(sp=4)))``, whose four
   ranks share the one card: the step-0 loss and every gradient against
   the flash path (same weights and batch), bitwise repeatable, and the
   blockwise core's against the flash path too; then 5 AdamW ``Trainer``
   steps, each launching 120 block forwards, 120 block backwards, no
   whole-sequence flash, 1 CE forward and 1 CE backward, with a falling
   loss; step time, tokens/s, peak memory and a profiled step;
8. train: BERT-large at seq 512 (``bench.py`` ``bench_bert_long``):
   first every remat policy on a 2-layer bf16 BERT at BERT-large's
   width (flash core, fused LN, dropout 0.1, 4 x 512, one key), the loss
   and every gradient bitwise equal to ``"none"``'s, twice, with each
   block's flash and fused-LN forwards replayed in the backward under
   every policy but ``"none"``; then the four (attention core, fused LN)
   variants of bench's ``BERT512_VARIANTS`` at full depth, bf16, batch
   24, 3 AdamW ``Trainer`` steps each with their launches asserted per
   step (24 flash forwards and backwards with the flash core, 48
   fused-LN forwards and backwards with the fused LN); then the fastest
   at batch 48 under remat ``"full"`` (twice the forwards), whose peak
   memory must lie below the same variant's at batch 24 without remat;
   bench's decision by samples/s, and a profiled step of the winner;
9. train: ``bench.py``'s wdl_ctr workload (config 2), Wide&Deep with
   the HET host-embedding cache, through the port: (a) the embedding
   engine's library built with ``g++`` from ``native/embed/*.cpp``
   (``build.sh``'s flags) into ``build/torch_kernels/``, its path and
   build time; (b) the bench model on the card against the same model
   on the CPU (same dense weights, same host-table seed, the same
   512-row batch): the loss (1e-5 relative), every dense gradient and
   the staged rows' gradient (1e-4 of each one's max), then the host
   rows after one async push bitwise equal to the card's gradient
   pushed on the host, and within 1e-4 of the CPU model's where the
   gradients are not tiny; (c) ``embedding="hbm"`` at ``pull_bound=0``
   against the staged layer, 5 steps, losses and host table bitwise;
   (d) 5 steps with async pushes (each copy queued behind a 25 ms
   ``torch.cuda._sleep``) and a flush after each, bitwise equal to
   synchronous pushes, and a control without the event wait that must
   differ; (e) the bench loop (batch 512 of ``synthetic_ctr(n=4096)``,
   Adam 1e-3, stage / step / prefetch, 5 chunks of 10 steps after 3)
   for the ``host`` arm (staged bridge, async push, lfuopt cache of
   65536), the tiered arm in f32 and int8 (HBM budget 8192 rows, pull
   bound 2; promotions and HBM hits above 0), ``embedding="hbm"`` at
   the tiered arm's budget and the on-card table, each with a falling
   loss and an AUC above 0.6 on its last 5 batches; (f) for each,
   steps/s, samples/s, the median split of 10 synchronized steps into
   stage, device step, push and prefetch, the device-busy share of a
   profiled step and the caches' stats, beside the card's name and
   power limit;
10. train: ``bench.py``'s MoE transformer LM (config 3) through the
   port: (a) each of the five gates driving a ``MoELayer`` at d=1024,
   E=8, T=8192 in fp32 (TF32 off) on the card against the port on the
   CPU, same weights: the index plans equal but for tokens whose routing
   margin is under 1e-6 (counted and printed), ``y`` and ``aux`` within
   1e-5 relative; (b) ``ep=4`` on the local mesh at capacity factor 8
   equal to four single-group calls on the token shards (1e-5); (c) a
   2-layer ``MoELM`` at config 3's width, fp32, 4 x 256: the step-0 loss
   (1e-5 relative) and every gradient (1e-4 of its max) against the CPU,
   and two backwards on the card bitwise equal; (d) config 3 as written
   (4 layers, hidden 1024, 16 heads, 8 experts, top-1, capacity 1.25,
   bf16, batch 32 x 256, Adam 1e-4) in two arms, the bench's
   materialized attention and ``flash_attn_fn(native_layout=True)``
   (4 flash forwards and 4 backwards a step), 3 warm-up and 10 timed
   steps: the median step, samples/s, tokens/s, peak memory, the last
   step's routing stats, and a profiled step's launches, device-busy
   share and device time by group (gate, dispatch scatter, experts,
   combine, attention, LM head + CE, Adam); the arms' step-0 losses
   (MOE_ARM_LOSS_TOL) and logits (MOE_LOGIT_TOL, which the logits with
   expert 0's output dropped must exceed) agree, and every loss and aux
   is finite; (e) the flash kernels at that arm's shape, B=32 H=16 S=256
   D=64 causal bf16, against their plain versions with the bf16-state
   control, timed beside SDPA and the bound; (f)
   ``BertMoEForPreTraining`` (2 layers at BERT-base width, E=8, top-2,
   bf16, dropout 0.1): step 0 on the card against the CPU, the loss
   (MOE_BERT_LOSS_TOL) and every gradient (MOE_BERT_GRAD_TOL of its max,
   which the dropped-expert control must exceed), and the gradients
   bitwise repeatable;
11. train: the vision family through the port (fp32 checks with TF32
   off): (a) ResNet-18 on CIFAR-10 as ``bench.py`` config 1 runs it
   (``bench_resnet``): step 0 at batch 8 on the card against the CPU,
   the loss, the logits, every gradient and the running statistics
   (VISION_*_TOL; the gradients between float64 copies, since fp32
   forwards can fall on two sides of a relu's 0), with a control, the
   logits with cuDNN's TF32 on, that must exceed the logits' limit; then
   60 Momentum(0.1, 0.9)
   ``Trainer`` steps at batch 128, fp32, over
   ``Dataloader(cifar10(), 128, shuffle=True).prefetch()`` with cuDNN's
   TF32 off and then on, steps 4 to 23 timed, each arm with a falling
   loss over the 60 steps, the median step,
   samples/s, peak memory and a profiled step (launches, device-busy
   share, host and device time of the forward, the backward and the
   update); (b) ViT-B/16 (224 px, 12 layers, hidden 768, 12 heads, 1000
   classes): step 0 in fp32 at batch 2 through the flash kernels against
   the CPU, then bf16 at batch 64 with AdamW 1e-4, 3 + 10 steps in the
   materialized and the flash arm (12 flash forwards and 12 backwards a
   step); (c) Swin-T at 224 px: step 0 in fp32 at batch 2 against the
   CPU, then bf16 at batch 64, AdamW 1e-4, 3 + 10 steps; (d) one
   Momentum step each of VGG-16 on ``cifar10()`` and LeNet on
   ``mnist()`` at batch 128, fp32, the step-0 loss and logits held to
   the CPU; (e) the flash pair at ViT-B/16's shape, B=64 H=12 S=197
   D=64 non-causal bf16 (a ragged last tile), against the plain
   versions with the bf16-state control, timed beside SDPA and the bound
   over the 197 tokens;
12. train: T5-base, the LSTM and GRU classifiers and a 3-layer GCN at
   ogbn-arxiv's size, through the port's plain torch path (no CUDA
   kernel of the port lies on it), fp32 checks with TF32 off: (a) T5's
   relative-position bucket tables at 512x512 and 114x114, both
   directions, computed on the card equal to the CPU's; T5 at t5_base
   width with 2+2 layers, batch 2 x 512 / 114, dropout 0.1: the step-0
   loss and every gradient against the CPU, then 3 AdamW(1e-4)
   ``Trainer`` steps whose losses and parameters are held to the CPU's
   (P12_*_TOL); the same for the LSTM and GRU classifiers (28
   timesteps of 28 features, hidden 128, batch 128, Adam 1e-3) and for
   ``GCN(128, 256, 40, num_layers=3, dropout_rate=0.5)`` full batch on
   ``arxiv_sbm()`` (169,343 nodes, 1,166,243 undirected edges, 128
   features, 40 classes; Adam 0.01); (b) 3 + 5 timed steps, each from
   the fetch of its batch: T5-base at batch 32 x 512 / 114, fp32,
   AdamW 1e-4, with TF32 off and on (ms a step, input and target
   tokens/s, peak memory, a profiled step's busy share and top-10
   kernels), the LSTM and GRU over ``Dataloader(mnist(), 128)`` (ms a
   step, a profiled step's device activities), the GCN's full-batch
   epoch (ms, peak memory, busy share); (c) each loss falls (the mean
   of the last 3 under the first 3's); T5's targets are the first 114
   input tokens;
13. train: Wide&Deep at ``bench.py`` config 2's widths (dim 16, hidden
   256, 13 dense and 26 sparse fields) over ``synthetic_ctr`` at Criteo
   Kaggle's vocabulary, 26 x 1,298,561 = 33,762,586 rows, through the
   embedding compression suite and the sharded host table (no CUDA
   kernel of the port lies on this path: the JAX package writes every
   method in jnp ops), fp32 with TF32 off: (a) at 10,000 rows a field (a
   cut of the check only) every arm's step-0 loss (1e-5 relative) and
   gradients (1e-4 of each one's max) on the card against the CPU, DPQ's
   and MGQE's codes equal, and each transition's result equal to the
   CPU's (DeepLight's threshold, PEP's mask, AutoSrh's hardened alpha,
   AutoDim's selected dims, ``DedupEmbedding.from_dense``, the CSR
   form's lookups); (b) at full size 3 + 10 Adam(1e-3) ``Trainer`` steps
   of batch 512 for the arms ``device`` (the dense table), ``dedup``
   (``from_dense`` of its trained table), ``hash`` (N/10 rows),
   ``compo`` (5811 x 5811), ``robe`` (N*16/10, Z=1), ``dhe``,
   ``quantize`` and ``alpt`` (8 bits), ``dpq`` (256 x 4), ``mgqe``
   (256 / 64, the drawn ids' counts), ``optembed`` (26 slots, the step's
   key), ``md`` (8 -> 16), ``tt`` ((324, 324, 322) x (2, 2, 4), rank 8),
   ``adapt`` (N/20 + N/20), ``sharded`` (4 shards, host adagrad 0.05),
   ``deeplight`` (its schedule pruning every 10 steps, then
   ``prune(100000)``), ``sparse`` (the CSR form of that pruned table,
   lookups timed), ``pep`` -> ``pep_retrain`` and ``autosrh`` ->
   ``autosrh_retrain`` (their schedules), ``autodim`` (candidates 2, 4,
   8, 16 with the step's key, then ``materialize``): each arm's build
   time, embedding bytes and compression, median step, samples/s, peak
   memory, a profiled step's device busy share, the loss at step 0 and
   after the steps, and each transition's time; (c) NeuMF at
   MovieLens-20M's 138,493 users and 26,744 items, dim 20, batch 512,
   Adam 3e-3, through ``hash`` and ``tt`` (``examples/train_rec.py``'s
   sizes): step 0 against the CPU, then 3 + 10 timed steps;
14. the distributed embedding path, no CUDA kernel of the port on it:
   (a) the same Wide&Deep at 33,762,586 rows with ``embedding="remote"``
   over four ``EmbeddingServer``s on loopback (server-side adagrad
   0.05), step 0 against the same model on the CPU over the same
   servers, then 3 + 10 timed steps: median step, samples/s, the stage /
   device / push split, a profiled step's busy share, payload bytes over
   the wire and each server's ``get_loads``; (b) a ``SnapshotWriter`` on
   that embedding (version 1 the full table, pulled over the wire; a
   delta after each timed step) and two read-only replicas, Wide&Deep
   with ``embedding="hbm"`` (capacity 8192, pull bound 2) and the
   trainer's step-0 tower, served by ``ServingEngine(gpt2_small,
   ctr_model=, ctr_follower=)`` at staleness bounds 0 and 2, 8
   ``infer_ctr`` requests of 512 rows a step: at bound 0 every
   prediction within 1e-6 of the trainer's (its tower over
   ``pull_rows``), with a request of resident rows trained and published
   in between, at bound 2 the lag never above 2; one delta's payload byte
   flipped is skipped as ``crc``, the next as ``missing_base``, and a
   full snapshot re-anchors the replica (timed); the snapshots live in a
   temporary directory checked for free disk first and removed after;
   (c) ResNet-18 at CIFAR-10's shapes, batch 128, through
   ``PSDataParallel`` (bsp, sgd) in two worker processes of this script
   (``--ps-dp-worker``) sharing the card: their parameters' fingerprints
   equal at every step, worker 0's step-0 loss within 1e-5 of the CPU's;
   (d) the GCN of phase 12 on 2-hop subgraphs (128 seeds, fanout 8) that
   a ``RemoteGraph`` server samples, 20 steps, a second client with the
   same seed drawing the same subgraphs;
15. serve: GPT-2 small (fp32, phase 4's 1024-token window, 8 slots,
   page 16; arm (c) a 256-token window) as a fleet on the one card: (a) two tenants, WFQ weights 3:1, a quota and
   a shed latch on one, each stream equal to a one-tenant engine's, TTFT
   p50 / p99 per tenant; (b) prefix sharing under
   ``generate_shared_prefix_load``, no prefix page written twice, streams
   equal the unshared engine's; (c) speculative decoding, k = 4, with a
   2-layer draft of GPT-2's widths in greedy, temperature and top-k
   (streams equal the plain engine's) and the target as a perfect draft
   (every proposal accepted, fewer steps), the verify step a second
   captured graph at 8 x 5 rows; (d) a ``FleetRouter`` over 4 replicas
   on 24 requests, same-seed replay bitwise, tokens/s beside one
   replica's; (e) one
   prefill and one decode worker, streams equal colocated serving, and a
   record corrupted in its payload, a page CRC and its fingerprint, each
   detected under its reason, journaled and re-prefilled; (f) failover
   under a ``replica_crash``, a ``decode_hang`` and a ``migrate_drop``,
   streams equal the crash-free run; (g) ``defrag`` every 8 ticks under
   the captured graph, the pool's addresses unchanged; (h)
   ``serve_fleet_router`` on loopback.  In (b), (c) and (e) paged decode
   and LM-head sampling are held against their plain versions on a copy
   of the engine's pool taken at the live shape (aliased prefix tables,
   the verify step's 40 chained rows, imported tables; the tick with the
   longest rows), after the arm's launch counts were read;
16. survival: GPT-2 small as phase 5 trains it at ``CUT_LAYERS`` of its 12
   layers (fp32, TF32 off, flash, the streamed head with chunk 1024,
   AdamW, batch 8 x 1024), its
   checkpoints in a temporary directory removed at the end: (0) one
   step run twice from the same state and key, every parameter and
   optimizer slot bitwise equal (cuDNN's deterministic algorithms, then
   ``torch.use_deterministic_algorithms``, switched on only where a step
   is not; what was needed is printed, and (b) checks ResNet-18 so); (a)
   ``ResilientTrainer`` with async saves every 2 steps (each save's
   stall on the step and its bytes and write time), SIGTERM between
   steps 3 and 4 (the final synchronous save, ``Preempted``), a fresh
   driver resuming to the uninterrupted run's state bitwise, a corrupt
   and a torn file skipped on resume with their diagnoses, a ``hang`` at
   ``step_begin`` raising ``BackendUnresponsive`` with the abandoned
   step never committing, and the driver's overhead over the bare
   ``Trainer``; (b) ResNet-18 at CIFAR-10's shapes, batch 128: a
   ``grad_nan`` step skipped with the surviving lineage bitwise an
   unfaulted run's and the NaN provenance naming the input leaf
   ``batch.x``, and three in a row rolled back to the last checkpoint;
   (c) ``ElasticGang`` of 4 simulated workers: a ``worker_kill`` and a
   ``shard_loss`` at step 3 rescale to 3 workers through the ring
   replica (``shard_restore``), then ``rejoin()``; the end state and
   ``losses_by_step`` bitwise an uninterrupted run's; save, compose and
   rescale times; (d) partial reduce on that gang, each worker's
   gradient over its 2 x 1024 shard (the flash and CE pairs held against
   their plain versions and timed at that shape first): seeded pareto
   stalls at deadline 1.0 with a ``RuntimeController`` retuning it
   within its clamp, and at ``inf``, ``sim_time`` and the losses at
   matched steps, the straggler replay bitwise, the goodput buckets
   summing to the total, and a ``bit_flip`` named by the divergence
   detector, quarantined and restored from the ring; (e)
   ``ServingEngine(controller=)`` on phase 4's engine: sustained SLO burn
   sheds and releases, a ``compile_storm`` freezes bucket growth and
   lifts, every admitted stream bitwise a plain engine's;
17. accounting, with ``HETU_TPU_TUNE_CACHE`` pointed at a temporary
   directory removed at the end: (a) phase 4's engine with a
   ``MemoryLedger`` installed, each tick's snapshot exact, no leak at
   the end, the bytes by KV class, the high-water marks, the decode
   graph's private pool under ``compile``, the ledger's total beside
   ``torch.cuda.memory_allocated()``, and ``/memory`` over HTTP equal to
   the snapshot; (b) ``autotune_paged_decode(12, 64, 16)`` in bf16 and
   fp32, head blocks 1, 2 and 4 bitwise equal at phase 4's decode
   lengths, the DB reloaded under the card's name, and an engine built
   after the sweep launching at the tuned head block with (a)'s streams;
   (c) phase 5's GPT-2 small for 5 steps with the ledger (its weights
   and AdamW bytes beside the allocator's growth), a goodput meter, a
   trace of two steps parsed by ``device_op_breakdown`` beside the union
   of the same profile's device spans, ``Trainer.profile`` and
   ``HetuTimer`` sections; (d) a ``ProfileStore`` from (a)-(c)'s
   readings, byte-identical across a save/load round trip and two
   builds, its fits, and a planted step record 1.5x slower flipping
   ``/healthz`` to ``perf_regression``; (e) phase 9's tiered Wide&Deep
   arm, ``embed_hbm`` equal to the resident rows x dim x 4 after each
   stage;
18. planning, offload and interchange: (a) GPT-2 small (phase 5's
   settings, ``CUT_LAYERS`` layers) at 8 x 1024's sequence with microbatches 8 and 16 under
   the remat policies none, full, dots_saveable, dots_no_batch and
   offload_dots: one real AdamW step of each candidate with its
   ``torch.cuda.max_memory_allocated`` growth, a budget below ``none`` at
   16's measured peak, ``plan_memory``'s prediction for each candidate
   reconciled against its measurement, and the chosen plan's
   ``Trainer(memory_plan=)`` for 3 steps under the budget with the flash
   and CE kernels launched, then its ``profile``; (b) 8 x 1024 under
   none, dots_no_batch, offload_dots and dots_no_batch with the AdamW
   state in pinned host memory: peak bytes, median step of 3, bytes to
   the host a step, offload_dots' losses and gradients bitwise
   dots_no_batch's and its packed bytes equal to dots_no_batch's saved
   products; (c) GLUE fine-tuning: SST-2- and MRPC-layout TSVs of seeded
   words read by ``glue_tsv``, a built vocabulary and ``batch_encode``
   at 128, BERT-base with ``fused_ln=True`` warm-started from a written
   ``BertForPreTraining`` checkpoint, 10 AdamW steps under
   ``WarmupLinearScheduler`` at batch 32, the fused-LN kernels launched;
   (d) GPT-2 small exported to ONNX at 1 x 128, saved, loaded and
   imported on the card, its logits against the module's own;
19. planning and brokering, the JAX package's own planner runs with the
   hardware fields the card's: (a) ``CostProfiler().calibrate()`` (the
   sustained bf16 matmul rate by CUDA events, the card's memory),
   ``dp_search`` over 8 x ``transformer_layer_spec(1024, 512)`` at
   global batch 32, then that plan's remat policy on a bf16 GPT (vocab
   32000, hidden 1024, 8 layers, 16 heads, seq 512) with flash, 5 AdamW
   steps: finite losses, 8 flash forwards and backwards a step, the
   predicted step and peak beside the measured; (b) ``plan_deployment``
   on a 2-device serving spec (hidden 1024, 8 layers, seq 2048, prompts
   p50 128 / p99 1024, decode 48, 8 slots, page 64) calibrated with the
   named defaults, the plan file saved, loaded and re-signed identically,
   ``build_fleet`` against a stock one-engine ``FleetRouter`` on the same
   24 seeded requests on zero clocks: every planned request completes,
   the stock engine completes every prompt within its top bucket (128)
   and rejects the longer ones, as the JAX package's does; decode tokens
   per router tick, tokens/s, and each engine's paged-decode and
   sampling launches (none may be 0); (c) the broker's day: the brokered
   episode and the two static splits with (b)'s GPT on every replica and
   the gang's MLP workers on the card, lease grants and reclaims, train
   steps and violations, the joint dominance margin, ``/broker`` over
   HTTP, each replica's launches, and the brokered episode's decisions,
   lease events, world by tick, statuses and train steps equal to the
   same call on the CPU at the JAX package's default model;
20. strategies: GPT-2 small as phase 5 trains it (fp32, 8 x 1024, flash,
   streamed head, AdamW) through ``Trainer(strategy=)`` on a local mesh
   (every rank on the card, each running the flash and CE kernels at its
   own shapes): (a) DataParallel dp=4, ZeRO(1) and ZeRO(3) dp=4,
   MegatronTP(tp=2, dp=2) and MegatronTP(tp=4), each with its step-0
   loss (1e-5) and every gradient (1e-3 of its max) against the
   unsharded flash path, the ranks' step-0 gradients bitwise on a second
   run, 3 steps within ``ST_TOL`` of phase 5's unsharded losses (a
   control with two tp ranks' qkv and MLP-input shards swapped must exceed it), 48
   flash forwards and backwards and 4 CE forwards and backwards a step,
   the collectives' calls and bytes, step time, tokens/s, peak memory;
   a local DataParallel dp=2 arm; (b) the CE kernels on tp=2's
   vocabulary shard against their plain versions, about half the labels
   outside it, timed beside the bound; (c) DataParallel dp=2 across two
   processes of this script sharing the card over gloo (losses bitwise
   equal, within 1e-6 of the local dp=2 arm), the gradient all-reduce's
   bytes and ms, ``collective_bandwidth`` over that world; a one-rank
   NCCL world through ``launch.initialize()`` running every collective;
   what NCCL says to two ranks on one card; (d) ``dp_search`` for
   bench.py config 4 over four of this card, ``plan_to_strategy`` on a
   local mesh, 2 steps;
21. pipelines: GPT-2 small at full width and depth composed as
   ``__graft_entry__.py``'s config A composes its LM (the embedding,
   ``Pipelined`` blocks with flash, the final LN, the streamed head tied
   to the embedding; fp32, TF32 off, 8 x 1024, AdamW 3e-4): (a) GPipe on
   a local pp=4 mesh, M=8, under remat "none" and "full": the step-0
   loss (1e-5) and every gradient (1e-3 of its max) against the model
   with ``mesh=None``, 3 ``Trainer`` steps within ``ST_TOL`` of its
   losses, 96 flash forwards ("full": 192) and 96 backwards, 4 CE
   forwards (every pp rank runs the head on the published output) and 1
   backward (the last stage's loss alone seeds the backward) a step, a
   control with two stages' blocks swapped that must leave the gradient
   limit; (b) config A's dp=2 tp=2 pp=2 with ZeRO-1, 8 ranks: each
   rank's parameter and slot bytes, 3 steps within ``ST_TOL``, the
   collectives a step; (c) ``pipedream_grads`` over the 12 blocks, S=4,
   M=8, V=3 through ``interleave_stages``, the head per microbatch: the
   blocks' gradients against the unsharded ones, the schedule's stats
   for V=1 and 3; (d) ``pipedream_train_step`` at lr 0 bitwise, at S=1
   against a sequential per-microbatch SGD loop, 2 HetPipe steps at
   pp=4 x dp=2; (e) ``HeteroPipeline`` at ``plan_hetero_dp([2, 1, 1],
   4)``, M=4: loss and gradients, one step; (f) GPipe pp=2 across two
   processes of this script over gloo (``--pipeline-worker``), losses and
   step-0 gradients bitwise the local pp=2 arm's, the hops' calls, bytes
   and ms; then the flash pair at a microbatch (B=1, H=12 and 6) and the
   CE pair at N=1023 and on (b)'s vocabulary shard timed;
22. sequence parallelism: GPT-2 small at phase 5's settings through
   ``Trainer(strategy=ShardingStrategy(rules=MEGATRON_RULES,
   batch_axes="dp"))`` on a local dp=2 sp=2 tp=2 mesh (8 ranks on the
   card, run in turn): (a) ``__graft_entry__.py``'s config G, the flash
   ring with the heads over tp (``head_axis="tp"``): the step-0 loss
   (1e-5) and every gradient (1e-3 of its max) against the unsharded
   flash path, each sp rank's gradients bitwise its group's (none summed
   over sp), a control with the two sp chunks' causal offsets swapped
   that must leave those limits, 3 steps within ``ST_TOL`` of phase 5's
   losses, 144 block forwards and backwards (4 groups x 3 visits x 12
   layers) and 8 CE forwards and backwards a step, each rank's
   parameter bytes and the collectives a step; (b) the blockwise core
   and (c) Ulysses (96 flash forwards and backwards a step) on the same
   mesh, step 0 and one step; (d) ``GPT(attn_fn=ring_attn_fn(mesh))`` on
   the reference's ``MeshSpec(sp=4, dp=2)`` without a strategy, loss and
   gradients; (e) sp=2 across two processes of this script over gloo
   (``--sp-worker``), the ring and then Ulysses, 4 x 1024, losses and
   step-0 gradients against a local sp=2 run, the hops' calls, bytes and
   ms; then the block pair at a rank's chunk, the flash pair at
   Ulysses' rank shape (B=4, H=3) and the CE pair at a rank's
   vocabulary shard timed;
23. expert parallelism: (a) ``__graft_entry__.py``'s config B at
   ``bench.py`` config 3's widths (the MoE LM, vocabulary 32000, hidden
   1024, 4 layers, 16 heads, 8 experts, top-1, capacity factor 1.25,
   32 x 256, fp32) with the flash ring on a local dp=2 ep=2 sp=2 mesh
   under ``ShardingStrategy(DP_RULES, batch_axes=("dp", "ep"))``: the
   step-0 loss (1e-6 relative) and every gradient (1e-5 of its max)
   against the same weights on ``MeshSpec(ep=2)`` with the flash core,
   every rank's reduced gradients bitwise its ep index's, a control
   routing each rank's own (dp, ep) piece that must leave the loss limit
   (at capacity factor 0.5 where 1.25 drops no token), then 3 AdamW
   steps with 48 block forwards and backwards a step; (b) the
   hierarchical exchange, ``MoELayer(axis=("ep", "tp"))`` at config 3's
   layer, bitwise the flat ep=4 layer and within ``MOE_TOL`` of four
   single-group calls; (c) ep=2 across two processes of this script over
   gloo (``--ep-worker``), 4 x 256 rows each, losses and step-0 gradients
   bitwise a local ep=2 run; (d) ``DistGCN15D`` on a gr=2 x gc=2 mesh
   over a 16,384-node stochastic-block graph against the dense oracle,
   then 5 Adam steps; then the block pair at a rank's chunk and the
   flash pair at the reference's shape timed;
24. a ``kernels`` JSON line (the one-kv-block flash pair once for each
   path that runs it: phase 8 at seq 512, phase 10's flash arm, phase
   11's ViT, phase 23's reference in fp32; the flash and CE pairs at
   phase 20's rank shapes, phase 21's microbatch and shard shapes and
   phase 22's, the block pair at phases 22's and 23's rank chunks), then
   the last line ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Phase 3 also holds the fused residual + dropout + LayerNorm kernels
against their plain versions at T = 12288, D = 1024, rate 0.1 (BERT-large
at 96 x 128), fp32 and bf16: the kept/dropped pattern bitwise, the
backward bitwise repeatable, and controls (the key's words swapped; in
bf16 also the residual sum rounded to bf16) that must fail the check,
the ring's block backward fed the block's own lse, a control that must
fail its check, and the plain versions of the CE forward fed h and W,
and of the flash forward fed q, k and v, rounded to TF32: controls that
must fail the fp32 limits (a kernel that ran one-pass TF32 products
would).  Phase 24 prints each flash kernel's time beside the prediction
made before its tensor-core redesign first ran, and likewise paged
decode's, the fused-LN backward's and LM-head sampling's beside their
predictions and their times before their redesign, and paged decode's
device time over phase 4's run at phase 4's lengths.  Phase 4's decode
profile prints the sampling kernels' busy time per step.

Without a CUDA device the script prints no result and exits 2.
"""

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# Peak rates of the data sheet.  fp32: the least time for fp32-accurate
# products is 3xTF32 on the tensor cores, three TF32 products (495
# TFLOP/s) for each, so 165 TFLOP/s; the SIMT rate, 67 TFLOP/s, gave the
# bounds of the kernel table up to its restatement (PERF.md).
PEAK_OPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
FLUSH_BYTES = 256 << 20         # larger than the 50 MB L2
# GPT-2 small's layers in phases 16 and 18 (full width): the whole
# script must end within its time limit (PERF.md section 4 lists the cuts)
CUT_LAYERS = 6
SERVE_SLOTS, SERVE_BUDGET = 8, 64   # phase 4: slots, new tokens a request


_START = time.monotonic()


def phase(name):
    torch.cuda.synchronize()
    print(f"== {name} (at {time.monotonic() - _START:.1f} s)", flush=True)


def time_ms(fn, flush, reps=30, warmup=3):
    """Median device time of ``fn`` over ``reps`` launches, each after an
    L2 flush (the caller finds the data cold, as the engine does).  A
    spin of about 0.1 ms follows each flush, so the host has enqueued
    ``fn``'s launches before the start event: a wrapper's Python time
    (slower when the host is busy) does not reach the measurement."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_excess(x, ref):
    """Largest ``|x - ref|`` beyond one bf16 spacing at ``ref``
    (``2**(e - 7)`` for ``|ref|`` in ``[2**e, 2**(e + 1))``)."""
    ref = ref.float()
    e = torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
    return ((x.float() - ref).abs() - torch.exp2(e - 7)).max().item()


def paged_decode_bf16_state(q, k_l, v_l, tables, lens):
    """Control for the bf16 tolerance: the paged online softmax with its
    max, normalizer and accumulator rounded to bf16 after every page, as
    a kernel that accumulates in the input type would keep them."""
    B, H, D = q.shape
    page = k_l.shape[1]
    bf = torch.bfloat16
    m = torch.full((B, H), -1e30, device=q.device).to(bf)
    den = torch.zeros((B, H), device=q.device, dtype=bf)
    acc = torch.zeros((B, H, D), device=q.device, dtype=bf)
    qf = q.float() / D ** 0.5
    for p in range(-(-int(lens.max()) // page)):
        kp = k_l[tables[:, p].long()].float()          # (B, page, H, D)
        vp = v_l[tables[:, p].long()].float()
        pos = p * page + torch.arange(page, device=q.device)
        live = pos[None, :] < lens.long()[:, None]     # (B, page)
        s = torch.einsum("bhd,bshd->bhs", qf, kp)
        s = torch.where(live[:, None, :], s, torch.full_like(s, -1e30))
        vp = torch.where(live[:, :, None, None], vp, torch.zeros_like(vp))
        m_new = torch.maximum(m.float(), s.amax(-1))
        alpha = torch.exp(m.float() - m_new)
        pr = torch.exp(s - m_new[..., None])
        den = (den.float() * alpha + pr.sum(-1)).to(bf)
        acc = (acc.float() * alpha[..., None]
               + torch.einsum("bhs,bshd->bhd", pr, vp)).to(bf)
        m = m_new.to(bf)
    return (acc.float() / den.float()[..., None]).to(bf)


def check_paged_decode(pd, flush, dtype, gen):
    """Kernel vs plain at B=8, H=12, D=64, page 16, 12-layer stacked pool
    read at its last layer, ragged lengths 1..1024."""
    B, H, D, page, L, pps = 8, 12, 64, 16, 12, 64
    lens = [1, 16, 17, 100, 256, 513, 800, 1024]
    need = [-(-n // page) for n in lens]
    P = 1 + sum(need)
    perm = (torch.randperm(P - 1, generator=gen) + 1).tolist()
    tables = torch.zeros((B, pps), dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(need):
        tables[b, :n] = torch.tensor(perm[nxt:nxt + n])
        nxt += n
    shape = (L, P, page, H, D)
    k = torch.randn(shape, generator=gen).to("cuda", dtype)
    v = torch.randn(shape, generator=gen).to("cuda", dtype)
    q = torch.randn((B, H, D), generator=gen).to("cuda", dtype)
    tables = tables.cuda()
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    layer = L - 1
    clean = pd.paged_decode_attention(q, k, v, tables, sl, layer=layer)
    k[:, 0] = float("nan")
    v[:, 0] = float("nan")
    out = pd.paged_decode_attention(q, k, v, tables, sl, layer=layer)
    plain = pd.paged_decode_attention_plain(q, k, v, tables, sl, layer=layer)
    # the row of length 1024 served alone; row 0 cut to length 0
    alone = pd.paged_decode_attention(q[-1:].contiguous(), k, v,
                                      tables[-1:].contiguous(),
                                      sl[-1:].contiguous(), layer=layer)
    sl0 = sl.clone()
    sl0[0] = 0
    out0 = pd.paged_decode_attention(q, k, v, tables, sl0, layer=layer)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all(), "NaN leaked from scratch page"
    assert torch.equal(out, clean), "scratch-page poison changed the output"
    assert torch.equal(alone[0], out[-1]), \
        "the 1024-length row alone differs from the same row in the batch"
    assert torch.isnan(out0[0].float()).all(), "a length-0 row is not NaN"
    assert torch.equal(out0[1:], out[1:]), "a length-0 row moved the others"
    print(f"paged_decode {dtype}: the length-1024 row alone == in the batch "
          f"(bitwise); a length-0 row is NaN, the other rows unchanged")
    err = (out.float() - plain.float()).abs().max().item()
    tol = 2e-5
    if dtype == torch.float32:
        print(f"paged_decode {dtype}: max_abs_err {err:.3e} tol {tol:g}")
        assert err <= tol, f"paged_decode {dtype}: {err} > {tol}"
    else:
        # Kernel and plain both round an fp32 result to bf16 once, so a
        # correct kernel is off by at most one bf16 spacing of the output
        # (where the two fp32 sums, which differ by fp32 summation order,
        # straddle a rounding boundary) plus that fp32 slack.  A kernel
        # keeping its softmax state or accumulator in bf16 is off by more;
        # the control below emulates one and must fail the same check.
        ctrl = paged_decode_bf16_state(q, k[layer], v[layer], tables, sl)
        excess = bf16_excess(out, plain)
        ctrl_err = (ctrl.float() - plain.float()).abs().max().item()
        ctrl_excess = bf16_excess(ctrl, plain)
        print(f"paged_decode {dtype}: max_abs_err {err:.3e}, beyond one "
              f"bf16 spacing {excess:.3e} tol {tol:g}; control with bf16 "
              f"softmax state: max_abs_err {ctrl_err:.3e}, beyond one "
              f"spacing {ctrl_excess:.3e}")
        assert excess <= tol, f"paged_decode {dtype}: {excess} > {tol}"
        assert ctrl_excess > tol, "the bf16 check cannot tell bf16 state"
    s = torch.finfo(dtype).bits // 8
    nbytes = (2 * sum(lens) * H * D * s + 2 * B * H * D * s
              + B * pps * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4 * sum(lens) * H * D, dtype)
    ms = time_ms(lambda: pd.paged_decode_attention(q, k, v, tables, sl,
                                                   layer=layer), flush)
    plain_ms = time_ms(lambda: pd.paged_decode_attention_plain(
        q, k, v, tables, sl, layer=layer), flush)
    print(f"paged_decode {dtype}: kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms null bound_ms {b_ms:.4f} ({b_by}, "
          f"{nbytes} bytes)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def serve_prompts(vocab):
    """Phase 4's 16 prompts of 5-128 tokens (numpy seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(n)).tolist()
            for n in rng.integers(5, 129, 16)]


def serve_decode_lengths(prompt_lens):
    """Each decode step's paged-decode lengths in phase 4.  Every request
    has the same budget, so the slots fill in waves of SERVE_SLOTS in
    submission order; decode step j (1 .. budget - 1) of a wave reads
    prompt + j positions, the fed token's K/V included, and an idle slot
    reads 1 (the scratch page)."""
    steps = []
    for w in range(0, len(prompt_lens), SERVE_SLOTS):
        wave = list(prompt_lens[w:w + SERVE_SLOTS])
        wave += [0] * (SERVE_SLOTS - len(wave))
        for j in range(1, SERVE_BUDGET):
            steps.append([n + j if n else 1 for n in wave])
    return steps


def time_paged_decode_serve(pd, flush, gen, prompt_lens):
    """fp32 kernel vs plain at the lengths phase 4's decode steps reach,
    on GPT-2 small's pool (12 layers, page 16, 64 pages a row) read at
    its last layer: every step's kernel output against the plain
    version's (2e-5), and each step's median time; returns the means
    over the steps."""
    steps = serve_decode_lengths(prompt_lens)
    H, D, page, L, pps = 12, 64, 16, 12, 64
    per_row = -(-max(max(s) for s in steps) // page)
    P = 1 + SERVE_SLOTS * per_row
    tables = torch.zeros((SERVE_SLOTS, pps), dtype=torch.int32)
    for b in range(SERVE_SLOTS):
        tables[b, :per_row] = 1 + b * per_row + torch.arange(per_row)
    k, v = (torch.randn((L, P, page, H, D), generator=gen).cuda()
            for _ in range(2))
    q = torch.randn((SERVE_SLOTS, H, D), generator=gen).cuda()
    tables = tables.cuda()
    ms, plain_ms, bound_ms, err = [], [], [], 0.0
    for lens in steps:
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (q, k, v, tables, sl)
        out = pd.paged_decode_attention(*args, layer=L - 1)
        ref = pd.paged_decode_attention_plain(*args, layer=L - 1)
        err = max(err, (out - ref).abs().max().item())
        ms.append(time_ms(lambda: pd.paged_decode_attention(
            *args, layer=L - 1), flush, reps=10, warmup=1))
        plain_ms.append(time_ms(lambda: pd.paged_decode_attention_plain(
            *args, layer=L - 1), flush, reps=3, warmup=1))
        nbytes = (2 * sum(lens) * H * D * 4 + 2 * SERVE_SLOTS * H * D * 4
                  + SERVE_SLOTS * pps * 4 + SERVE_SLOTS * 4)
        bound_ms.append(bound(nbytes, 4 * sum(lens) * H * D,
                              torch.float32)[0])
    mean = statistics.mean
    print(f"paged_decode float32 at phase 4's lengths ({len(steps)} decode "
          f"steps, lengths {min(min(s) for s in steps)}-"
          f"{max(max(s) for s in steps)}): max_abs_err {err:.3e} tol 2e-5; "
          f"kernel_ms {mean(ms):.4f} (median of steps {statistics.median(ms):.4f}, "
          f"max {max(ms):.4f}) plain_ms {mean(plain_ms):.4f} bound_ms "
          f"{mean(bound_ms):.4f} (bytes), means over the steps")
    assert err <= 2e-5, f"paged_decode at the serve lengths: {err} > 2e-5"
    return {"serve_steps": len(steps), "serve_ms": mean(ms),
            "serve_plain_ms": mean(plain_ms),
            "serve_bound_ms": mean(bound_ms)}


def check_lm_head(lh, flush, dtype, k, gen):
    """Kernel vs plain at N=8, E=768, V=50257 (GPT-2 small's head)."""
    N, E, V = 8, 768, 50257
    w = (torch.randn((V, E), generator=gen) * 0.02).to("cuda", dtype)
    h = torch.randn((N, E), generator=gen).to("cuda", dtype)
    vals, idx = lh.lm_head_sample(h, w, k=k)
    pv, pi = lh.lm_head_sample_plain(h, w, k=min(k + 1, V))
    torch.cuda.synchronize()
    tol = 1e-4
    err = (vals - pv[:, :k]).abs().max().item()
    gaps = pv[:, :-1] - pv[:, 1:]                        # (N, k)
    sep = gaps > tol
    sep_prev = torch.cat([torch.ones_like(sep[:, :1]), sep[:, :-1]], 1)
    checked = (sep & sep_prev)[:, :k]
    mism = (idx != pi[:, :k]) & checked
    print(f"lm_head_sample {dtype} k={k}: max_abs_err {err:.3e} tol {tol:g}"
          f"; indices checked {int(checked.sum())}/{N * k}, mismatched "
          f"{int(mism.sum())}")
    assert err <= tol, f"lm_head_sample {dtype} k={k}: {err} > {tol}"
    assert not mism.any(), "lm_head_sample: index mismatch beyond a tie"
    check_lm_head_order(lh, h, w, k)
    s = torch.finfo(dtype).bits // 8
    nbytes = V * E * s + N * E * s + N * k * 8
    b_ms, b_by = bound(nbytes, 2 * N * E * V, dtype)
    ms = time_ms(lambda: lh.lm_head_sample(h, w, k=k), flush)
    plain_ms = time_ms(lambda: lh.lm_head_sample_plain(h, w, k=k), flush)
    lib_ms = time_ms(lambda: torch.topk(h @ w.T, k), flush)
    # one plain read of W, timed the same way: the flush leaves the L2
    # full of dirty lines, written back while the next call reads
    read_ms = time_ms(lambda: w.sum(), flush)
    print(f"lm_head_sample {dtype} k={k}: kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {b_ms:.4f} "
          f"({b_by}, {nbytes} bytes); w.sum() {read_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_lm_head_order(lh, h, w, k):
    """NaN, +inf and -inf logits: where the plain top values are not
    finite, the kernel's indices must be the plain version's exactly (a
    NaN of either sign first, the first NaN first), and a row of NaN or
    of -inf gives 0, 1, ..., k - 1.  Three rows join the batch: one whose
    h is NaN, one whose Gumbel field is NaN at columns 7 and 20000 (two
    blocks apart) and +inf at 30000, one whose field is -inf; the eight
    rows keep a zero field.  A second call puts NaN at 7 and 25000 and
    +inf at 50000 through the bias, in every row."""
    N, V = h.shape[0], w.shape[0]
    nan, inf = float("nan"), float("inf")
    hx = torch.cat([h, torch.full_like(h[:1], nan), h[:2]])
    gx = torch.zeros((N + 3, V), device=h.device)
    gx[N + 1, [7, 20000]] = nan
    gx[N + 1, 30000] = inf
    gx[N + 2] = -inf
    bias = torch.zeros(V, device=h.device)
    bias[[7, 25000]] = nan
    bias[50000] = inf
    checked = 0
    for hh, kw, all_first in ((hx, {"gumbel": gx}, (N, N + 2)),
                              (h, {"bias": bias}, ())):
        vals, idx = lh.lm_head_sample(hh, w, k=k, **kw)
        pv, pi = lh.lm_head_sample_plain(hh, w, k=k, **kw)
        torch.cuda.synchronize()
        special = ~torch.isfinite(pv)
        assert torch.equal(idx[special], pi[special]), \
            "lm_head_sample: indices differ on NaN / inf logits"
        assert torch.equal(torch.isnan(vals), torch.isnan(pv))
        for r in all_first:
            assert idx[r].tolist() == list(range(k)), \
                f"lm_head_sample: row {r} of NaN / -inf gave {idx[r]}"
        checked += int(special.sum())
    print(f"lm_head_sample {w.dtype} k={k}: NaN / inf rows: {checked} "
          f"non-finite top entries, indices equal to the plain version's")


def rel_err(x, ref):
    """``max |x - ref|`` over ``max |ref|``, in fp32."""
    ref = ref.float()
    return ((x.float() - ref).abs().max() / ref.abs().max()).item()


# Each redesigned kernel's time predicted before its redesign first ran
# (PERF.md, Findings), in ms, with its time in PERF.md's table before the
# redesign (None where none was kept): (name, dtype) -> (low, high,
# before).  PR 6's flash kernels at (8, 12, 1024, 64) causal, the ring's
# block kernels per launch at (8, 12, 256, 64), a causal sp=4 layer's
# mean; PR 7's paged decode at B=8 H=12 D=64 page 16, lengths 1..1024,
# and fused-LN backward at T=12288 D=1024; the LM-head sampling kernel's
# at N=8 E=768 V=50257 k=1.
PREDICTED_MS = {
    ("flash_fwd", torch.float32): (0.20, 0.40, 0.6654),
    ("flash_bwd", torch.float32): (0.7, 1.4, 2.0543),
    ("flash_block_fwd", torch.float32): (0.03, 0.06, 0.0822),
    ("flash_block_bwd", torch.float32): (0.08, 0.16, 0.2591),
    ("flash_fwd", torch.bfloat16): (0.06, 0.15, 0.6688),
    ("flash_bwd", torch.bfloat16): (0.25, 0.6, 2.0751),
    ("paged_decode_attention", torch.float32): (0.010, 0.025, 0.0871),
    ("paged_decode_attention", torch.bfloat16): (0.008, 0.020, None),
    ("fused_ln_bwd", torch.bfloat16): (0.045, 0.075, 0.1553),
    ("fused_ln_bwd", torch.float32): (0.085, 0.12, 0.1636),
    ("lm_head_sample", torch.float32): (0.050, 0.075, 0.1106),
    ("lm_head_sample", torch.bfloat16): (0.027, 0.050, 0.1247),
}


def print_predictions(rows):
    """Each redesigned kernel's time beside its prediction, its time
    before the redesign, its bound and its library call's time; rows maps
    (name, dtype) to a kernels-line entry."""
    for (name, dtype), (lo, hi, before) in PREDICTED_MS.items():
        r = rows[(name, dtype)]
        ms, lib = r["ms"], r["library_ms"]
        was = ("not recorded" if before is None
               else f"{before:g} ms ({before / ms:.2f}x this)")
        lib_txt = "none" if lib is None else f"{lib:.4f} ms ({ms / lib:.2f}x)"
        print(f"prediction: {name} {dtype} {ms:.4f} ms, predicted "
              f"{lo:g}-{hi:g} ms ({'in' if lo <= ms <= hi else 'out of'} "
              f"range); before the redesign {was}; bound "
              f"{r['bound_ms']:.4f} ms; library {lib_txt}")


# (forward O, gradients) tolerances of the flash check, relative to the
# largest reference value.  fp32: summation order only.  bf16: the kernel
# and the plain version round P, dS and the outputs to bf16 at the same
# points, but P against another running max, so O differs by under one
# bf16 spacing of the largest output (2**-8 = 3.9e-3 relative; the
# kernel reads 1.0e-3 at the train shape) while a kernel that kept its
# softmax state in bf16 reads 4.1e-3 (the control below): O's limit sits
# between the two.  The gradients need no running max, and the kernel
# reads 0 against the plain version; their limit is one spacing.
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2.5e-3, 4e-3)}


def flash_bf16_state(q, k, v, scale, causal=True, tile=64):
    """Control for the bf16 tolerance: the online softmax over kv tiles
    of 64 with its max, normalizer and accumulator rounded to bf16 after
    every tile, as a kernel that kept its state in the input type
    would."""
    B, H, S, D = q.shape
    Sk = k.shape[2]
    bf = torch.bfloat16
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, S), -1e30, device=q.device).to(bf)
    den = torch.zeros((B, H, S), device=q.device, dtype=bf)
    acc = torch.zeros((B, H, S, D), device=q.device, dtype=bf)
    row = torch.arange(S, device=q.device)[:, None]
    for c0 in range(0, Sk, tile):
        sc = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, c0:c0 + tile])
        col = torch.arange(c0, min(Sk, c0 + tile), device=q.device)[None, :]
        live = col <= row if causal else torch.ones_like(col, dtype=bool)
        sc = torch.where(live, sc * scale, torch.full_like(sc, -1e30))
        m_new = torch.maximum(m.float(), sc.amax(-1))
        alpha = torch.exp(m.float() - m_new)
        pr = torch.exp(sc - m_new[..., None])
        den = (den.float() * alpha + pr.sum(-1)).to(bf)
        acc = (acc.float() * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", pr.to(bf).float(),
            vf[:, :, c0:c0 + tile])).to(bf)
        m = m_new.to(bf)
    return (acc.float() / den.float()[..., None]).to(bf)


def check_flash(fl, flush, dtype, S, gen, timed, B=8, H=12, causal=True):
    """Kernels vs plain at D=64, by default B=8, H=12, causal (the GPT
    train step's shape at S=1024): O, LSE, dQ, dK, dV; each backward run
    twice and compared bitwise, and a control that must fail the O
    limit.  Without the causal mask no row's output is exact, so bf16 O
    is held as the block check holds a past visit: what lies beyond one
    bf16 spacing, relative to the largest output (BLOCK_BF16_O_TOL).
    ``timed`` adds kernel / plain / SDPA times."""
    D = 64
    q, k, v, do = (torch.randn((B, H, S, D), generator=gen).to("cuda", dtype)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = fl.flash_fwd(q, k, v, causal=causal, scale=scale)
    grads = fl.flash_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    again = fl.flash_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    po, plse = fl.flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    pgrads = fl.flash_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                scale=scale)
    torch.cuda.synchronize()
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    full_bf16 = dtype == torch.bfloat16 and not causal
    peak = po.float().abs().max().item()

    def o_err(x):
        if full_bf16:
            return max(0.0, bf16_excess(x, po)) / peak
        return rel_err(x, po)

    if full_bf16:
        fwd_tol = BLOCK_BF16_O_TOL
    errs = {"O": o_err(o), "LSE": rel_err(lse, plse)}
    errs.update({n: rel_err(a, b) for n, a, b in
                 zip(("dQ", "dK", "dV"), grads, pgrads)})
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    shape = f"B={B} H={H} S={S} D={D} {'causal' if causal else 'full'}"
    print(f"flash {dtype} {shape}: relative errors "
          + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f"; tol O {fwd_tol:g}"
          + (" beyond one bf16 spacing (BLOCK_BF16_O_TOL)" if full_bf16
             else "") + f", LSE 2e-5, grads {bwd_tol:g} (fp32: summation "
          f"order; bf16: see FLASH_TOL); backward bitwise repeatable: "
          f"{same}")
    assert errs["O"] <= fwd_tol and errs["LSE"] <= 2e-5, errs
    assert max(errs[n] for n in ("dQ", "dK", "dV")) <= bwd_tol, errs
    assert same, "flash backward is not bitwise repeatable"
    if dtype == torch.bfloat16:
        ctrl = o_err(flash_bf16_state(q, k, v, scale, causal=causal))
        print(f"flash {dtype} {shape}: control with bf16 softmax state: O "
              f"error {ctrl:.3e} (must exceed tol {fwd_tol:g})")
        assert ctrl > fwd_tol, "the bf16 check cannot tell bf16 state"
    else:
        to, _ = fl.flash_fwd_plain(tf32_inputs(q), tf32_inputs(k),
                                   tf32_inputs(v), causal=causal,
                                   scale=scale)
        ctrl = o_err(to)
        print(f"flash {dtype} {shape}: control with q, k, v rounded to "
              f"TF32 (a one-pass TF32 kernel): O relative error {ctrl:.3e} "
              f"(must exceed tol {fwd_tol:g})")
        assert ctrl > fwd_tol, "the fp32 check cannot tell one-pass TF32"
        del to
    if not timed:
        return None
    s = torch.finfo(dtype).bits // 8
    ops_fwd = 4 * B * H * S * S * D / (2 if causal else 1)
    io = B * H * S * D * s
    f_ms, f_by = bound(4 * io + B * H * S * 4, ops_fwd, dtype)
    b_ms, b_by = bound(7 * io + 2 * B * H * S * 4, 2.5 * ops_fwd, dtype)
    ms = time_ms(lambda: fl.flash_fwd(q, k, v, causal=causal, scale=scale),
                 flush)
    plain_ms = time_ms(lambda: fl.flash_fwd_plain(q, k, v, causal=causal,
                                                  scale=scale), flush)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=causal, scale=scale),
                     flush)
    bms = time_ms(lambda: fl.flash_bwd(q, k, v, o, lse, do, causal=causal,
                                       scale=scale), flush)
    bplain_ms = time_ms(lambda: fl.flash_bwd_plain(
        q, k, v, o, lse, do, causal=causal, scale=scale), flush)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        sdpa(qg, kg, vg, is_causal=causal, scale=scale).backward(do)

    lib_fb_ms = time_ms(sdpa_fwd_bwd, flush)
    print(f"flash {dtype} {shape}: forward kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA) bound_ms "
          f"{f_ms:.4f} ({f_by}); backward kernel_ms {bms:.4f} plain_ms "
          f"{bplain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); SDPA forward+"
          f"backward {lib_fb_ms:.4f} ms")
    fwd = {"max_abs_err": (o.float() - po.float()).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": f_ms,
           "bound_by": f_by, "library_ms": lib_ms}
    bwd = {"max_abs_err": max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(grads, pgrads)),
           "ms": bms, "plain_ms": bplain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_fb_ms,
           "library_call": "scaled_dot_product_attention forward+backward"}
    return fwd, bwd


def sdpa_efficient_times(q, k, v, do, o, lse, causal, scale, flush):
    """The yardstick of the block kernels, which the port never calls:
    the memory-efficient SDPA op with its lse, and its backward fed the
    global out and lse (its own delta is then the global one).  Returns
    (forward ms, backward ms, text); the times are None, and the text
    says why, when this PyTorch build cannot run them here."""
    aten = torch.ops.aten
    try:
        efa = aten._scaled_dot_product_efficient_attention
        efa_bwd = aten._scaled_dot_product_efficient_attention_backward
        _, _, seed, offset = efa(q, k, v, None, True, 0.0, causal,
                                 scale=scale)
        lse = lse[..., 0].contiguous()
        bwd = lambda: efa_bwd(do, q, k, v, None, o, lse, seed,  # noqa: E731
                              offset, 0.0, [True, True, True, False],
                              causal, scale=scale)
        bwd()
    except (AttributeError, NotImplementedError, RuntimeError,
            TypeError) as e:
        why = str(e).splitlines()[0][:160]
        return None, None, f"library none (memory-efficient SDPA: {why})"
    f_ms = time_ms(lambda: efa(q, k, v, None, True, 0.0, causal,
                               scale=scale), flush)
    b_ms = time_ms(bwd, flush)
    return f_ms, b_ms, (f"library (memory-efficient SDPA with its lse) "
                        f"forward {f_ms:.4f} ms, its backward fed the "
                        f"global out and lse {b_ms:.4f} ms")


# bf16 O limit of the block check, on the part of |O - plain| beyond one
# bf16 spacing at each element, relative to the largest output.  The
# flash check's relative limit relies on rows whose output is exact (the
# first rows of a causal sequence set the largest output); a past visit
# has none, and there one bf16 spacing of the largest output (2**-8
# relative) is within reach of a correct kernel.  What lies beyond that
# spacing is the kernel's P rounded to bf16 against its running max
# rather than the row's, each term off by at most 2**-9 and the errors
# averaging out over the 256 keys; a kernel that kept its softmax state
# in bf16 adds a rounding of the whole row every tile.  The control
# below emulates that one at the past visit (four tiles a row) and must
# exceed the limit; at the diagonal, where most rows see one or two
# tiles, the same control is too close to a correct kernel to tell.
BLOCK_BF16_O_TOL = 2.5e-3


def check_flash_block(fl, flush, dtype, gen, shape=(8, 12, 1024, 64), sp=4):
    """The ring's block kernels at one rank's shapes of the sp=4 ring over
    GPT-2 small at 8 x 1024: q, k, v (8, 12, 256, 64).  The last rank's q
    chunk against its diagonal chunk (causal) and against the first chunk
    (a past visit, unmasked), fed the lse and delta of the whole causal
    sequence (the global ones, as the ring feeds them; not the block's
    own).  Each backward runs twice and is compared bitwise; a control
    fed the block-local lse must fail the gradient limit.  Returns, per
    case, kernel / plain / library times beside the bound."""
    B, H, S, D = shape
    c = S // sp
    q, k, v, do = (torch.randn((B, H, S, D), generator=gen).to("cuda", dtype)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = fl.flash_fwd_plain(q, k, v, causal=True, scale=scale)
    rows = slice(S - c, S)
    qc, oc, doc = (x[:, :, rows].contiguous() for x in (q, o, do))
    lse_g = lse[:, :, rows, None].contiguous()
    delta = (doc.float() * oc.float()).sum(-1, keepdim=True)
    del o, lse
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    o_tol, o_how = fwd_tol, " (as the flash check)"
    if dtype == torch.bfloat16:
        o_tol, o_how = BLOCK_BF16_O_TOL, (" beyond one bf16 spacing, of the "
                                          "largest output (BLOCK_BF16_O_TOL)")
    sz = torch.finfo(dtype).bits // 8
    io = B * H * c * D * sz
    out = {}
    for case, kv, mask in (("diagonal", S - c, True), ("past", 0, False)):
        kc, vc = (x[:, :, kv:kv + c].contiguous() for x in (k, v))
        bo, blse = fl.flash_block_fwd(qc, kc, vc, scale=scale, causal=mask)
        grads = fl.flash_block_bwd(qc, kc, vc, doc, lse_g, delta,
                                   scale=scale, causal=mask)
        again = fl.flash_block_bwd(qc, kc, vc, doc, lse_g, delta,
                                   scale=scale, causal=mask)
        local = fl.flash_block_bwd(qc, kc, vc, doc, blse, delta,
                                   scale=scale, causal=mask)
        po, plse = fl.flash_fwd_plain(qc, kc, vc, causal=mask, scale=scale)
        pgrads = fl.flash_block_bwd_plain(qc, kc, vc, doc, lse_g, delta,
                                          causal=mask, scale=scale)
        torch.cuda.synchronize()
        peak = po.float().abs().max().item()
        o_err = (max(0.0, bf16_excess(bo, po)) / peak
                 if dtype == torch.bfloat16 else rel_err(bo, po))
        errs = {"O": o_err, "LSE": rel_err(blse[..., 0], plse)}
        errs.update({n: rel_err(a, b) for n, a, b in
                     zip(("dQ", "dK", "dV"), grads, pgrads)})
        ctrl = max(rel_err(a, b) for a, b in zip(local, pgrads))
        same = all(torch.equal(a, b) for a, b in zip(grads, again))
        print(f"flash_block {dtype} {case} (q chunk {sp - 1} of {sp}, kv "
              f"chunk {kv // c}, causal {mask}, {tuple(qc.shape)}): relative "
              f"errors "
              + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f"; tol O {o_tol:g}{o_how}, LSE 2e-5, grads {bwd_tol:g} (as "
              f"the flash check); backward bitwise repeatable: {same}; "
              f"control fed the block-local lse: grads {ctrl:.3e} (must "
              f"exceed {bwd_tol:g})")
        assert errs["O"] <= o_tol and errs["LSE"] <= 2e-5, errs
        assert max(errs[n] for n in ("dQ", "dK", "dV")) <= bwd_tol, errs
        assert all(g.dtype == torch.float32 for g in grads)
        assert same, "flash block backward is not bitwise repeatable"
        assert ctrl > bwd_tol, "the block check cannot tell a local lse"
        if dtype == torch.bfloat16 and not mask:
            st = flash_bf16_state(qc, kc, vc, scale, causal=False)
            st_err = max(0.0, bf16_excess(st, po)) / peak
            print(f"flash_block {dtype} {case}: control with bf16 softmax "
                  f"state: O beyond one bf16 spacing {st_err:.3e} (must "
                  f"exceed {o_tol:g})")
            assert st_err > o_tol, "the block check cannot tell bf16 state"
            del st
        del local, again
        ops = B * H * c * c * D * (0.5 if mask else 1.0)
        f_ms, f_by = bound(4 * io + B * H * c * 4, 4 * ops, dtype)
        b_ms, b_by = bound(4 * io + 2 * B * H * c * 4 + 3 * B * H * c * D * 4,
                           10 * ops, dtype)
        ms = time_ms(lambda: fl.flash_block_fwd(qc, kc, vc, scale=scale,
                                                causal=mask), flush)
        plain_ms = time_ms(lambda: fl.flash_fwd_plain(
            qc, kc, vc, causal=mask, scale=scale), flush)
        bms = time_ms(lambda: fl.flash_block_bwd(
            qc, kc, vc, doc, lse_g, delta, scale=scale, causal=mask), flush)
        bplain_ms = time_ms(lambda: fl.flash_block_bwd_plain(
            qc, kc, vc, doc, lse_g, delta, causal=mask, scale=scale), flush)
        lib_ms, lib_bms, lib_txt = sdpa_efficient_times(
            qc, kc, vc, doc, oc, lse_g, mask, scale, flush)
        print(f"flash_block {dtype} {case}: forward kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {f_ms:.4f} ({f_by}); "
              f"backward kernel_ms {bms:.4f} plain_ms {bplain_ms:.4f} "
              f"bound_ms {b_ms:.4f} ({b_by}); {lib_txt}")
        out[case] = (
            {"max_abs_err": (bo.float() - po.float()).abs().max().item(),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": f_ms,
             "bound_by": f_by, "library_ms": lib_ms},
            {"max_abs_err": max((a - b).abs().max().item()
                                for a, b in zip(grads, pgrads)),
             "ms": bms, "plain_ms": bplain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": lib_bms})
    return out


# Visits of one causal sp=4 ring layer: 4 diagonal, 6 past.
RING_VISITS = {"diagonal": 4, "past": 6}


def ring_mix(rows, which, visits=None, timed=None):
    """One summary row for a block kernel: each number the per-launch mean
    over one causal ring layer's visits (by default sp=4's: 4 diagonal,
    6 past)."""
    visits = visits or RING_VISITS
    n = sum(visits.values())
    parts = {case: rows[case][which] for case in visits}

    def mean(key):
        vals = [parts[c][key] for c in visits]
        if any(x is None for x in vals):
            return None
        return sum(visits[c] * parts[c][key] for c in visits) / n

    return {"max_abs_err": max(p["max_abs_err"] for p in parts.values()),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": parts["past"]["bound_by"],
            "library_ms": mean("library_ms"),
            "timed": timed or "mean per launch of one causal sp=4 layer: 4 "
                     "diagonal (causal) + 6 past (unmasked) visits at (8, "
                     "12, 256, 64)"}


# Gradient tolerance of the CE check, relative to each gradient's own
# largest value.  fp32: the same products summed in another order.  bf16:
# t, dh and dW are rounded to bf16 at the same points in the kernel and
# the plain version, so an element may differ by one bf16 spacing where
# the two fp32 sums straddle a rounding boundary; only what lies beyond
# that spacing counts (``ce_grad_err``).  A control with a fault
# (``ce_bwd_control``) must exceed the limit.
CE_TOL = 1e-4


def ce_grad_err(x, ref):
    """CE gradient error over ``max |ref|``; for a bf16 output, only the
    part beyond one bf16 spacing at ``ref`` (``bf16_excess``)."""
    if x.dtype == torch.bfloat16:
        return max(0.0, bf16_excess(x, ref)) / ref.float().abs().max().item()
    return rel_err(x, ref)


def ce_bwd_control(h, w, y, lse, g, b, chunk=8192):
    """Control for the CE gradient check: the plain backward's dh and dW
    with t rounded to bf16, which in an fp32 run is the fault; in a bf16
    run, where that rounding is the function's own, t also loses its
    softmax term (only ``-onehot * dnll`` is left)."""
    hf = h.float()
    yl = y.long()
    dh = torch.zeros(hf.shape, device=h.device)
    dw = torch.empty_like(w)
    for c0 in range(0, w.shape[0], chunk):
        c1 = min(w.shape[0], c0 + chunk)
        cols = torch.arange(c0, c1, device=h.device)
        t = -(cols[None, :] == yl[:, None]).float()
        if w.dtype == torch.float32:
            t += torch.exp(hf @ w[c0:c1].T + b[c0:c1] - lse[:, None])
        t = (t * g[:, None]).to(torch.bfloat16).float()
        dh += t @ w[c0:c1].float()
        dw[c0:c1] = (t.T @ hf).to(w.dtype)
    return dh.to(h.dtype), dw


def tf32_inputs(x):
    """x with the low 13 mantissa bits cleared: an fp32 tensor as a
    one-pass TF32 product reads it."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def ce_case(gen, dtype, N, E, V):
    """Inputs of a CE check: a bias, every 97th label ignored, dnll / N."""
    h = torch.randn((N, E), generator=gen).to("cuda", dtype)
    w = (torch.randn((V, E), generator=gen) * 0.02).to("cuda", dtype)
    b = (torch.randn(V, generator=gen) * 0.1).cuda()
    y = torch.randint(0, V, (N,), generator=gen, dtype=torch.int32)
    y[::97] = -1
    y = y.cuda()
    dn = torch.randn(N, generator=gen).cuda() * (y != -1) / N
    return h, w, b, y, dn


def ce_compare(ce, name, h, w, b, y, dn):
    """Kernels vs plain with the bias: nll / lse within 1e-5, every
    gradient within ``CE_TOL``, each backward run twice and compared
    bitwise.  Returns what the timing and the controls need."""
    live = y != -1
    lse, ylog = ce.lm_head_ce_fwd(h, w, y, bias=b)
    grads = ce.lm_head_ce_bwd(h, w, y, lse, dn, bias=b)
    again = ce.lm_head_ce_bwd(h, w, y, lse, dn, bias=b)
    plse, pylog = ce.lm_head_ce_fwd_plain(h, w, y, bias=b)
    pgrads = ce.lm_head_ce_bwd_plain(h, w, y, lse, dn, bias=b)
    torch.cuda.synchronize()
    nll, pnll = lse - ylog, plse - pylog
    errs = {"nll": rel_err(nll[live], pnll[live]), "lse": rel_err(lse, plse)}
    errs.update({n: ce_grad_err(a, c) for n, a, c in
                 zip(("dh", "dW", "db"), grads, pgrads)})
    same = all(torch.equal(a, c) for a, c in zip(grads, again))
    print(f"lm_head_ce {name}: relative errors "
          + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f"; tol nll/lse 1e-5, grads {CE_TOL:g} of each gradient's own "
          f"max (fp32 sums in another order; bf16: beyond one bf16 "
          f"spacing); backward bitwise repeatable: {same}")
    assert errs["nll"] <= 1e-5 and errs["lse"] <= 1e-5, errs
    assert max(errs[n] for n in ("dh", "dW", "db")) <= CE_TOL, errs
    assert same, "lm_head_ce backward is not bitwise repeatable"
    return lse, nll, pnll, grads, pgrads


def check_lm_head_ce(ce, flush, dtype, gen, card, N=8184, extra=True):
    """Kernels vs plain at N=8184, E=768, V=50257 (the train step's head),
    with a bias (db checked) and every 97th label ignored; each backward
    run twice and compared bitwise; controls that must fail; then a
    ragged case at GPT-2 XL's width (N=300, E=1600, V=8193), untimed;
    times without the bias, as the GPT head runs.  ``N`` sets the rows
    (another path's shape); ``extra=False`` leaves out the controls and
    the ragged case."""
    E, V = 768, 50257
    h, w, b, y, dn = ce_case(gen, dtype, N, E, V)
    live = y != -1
    lse, nll, pnll, grads, pgrads = ce_compare(ce, f"{dtype} N={N}", h, w,
                                               b, y, dn)
    if dtype == torch.float32 and extra:
        # a kernel that ran one-pass TF32 products reads its inputs so
        clse, cylog = ce.lm_head_ce_fwd_plain(tf32_inputs(h), tf32_inputs(w),
                                              y, bias=b)
        c_nll = rel_err((clse - cylog)[live], pnll[live])
        print(f"lm_head_ce {dtype}: control with h and W rounded to TF32: "
              f"nll {c_nll:.3e} (must exceed tol 1e-5)")
        assert c_nll > 1e-5, "the CE check cannot tell one-pass TF32"
        del clse, cylog
    if extra:
        cdh, cdw = ce_bwd_control(h, w, y, lse, dn, b)
        ctrl = {"dh": ce_grad_err(cdh, pgrads[0]),
                "dW": ce_grad_err(cdw, pgrads[1])}
        fault = "t rounded to bf16" if dtype == torch.float32 else \
            "t without its softmax term"
        print(f"lm_head_ce {dtype}: control with {fault}: dh "
              f"{ctrl['dh']:.3e} dW {ctrl['dW']:.3e} (each must exceed tol "
              f"{CE_TOL:g})")
        assert min(ctrl.values()) > CE_TOL, \
            "the CE check cannot tell the fault"
        del cdh, cdw
        ce_compare(ce, f"{dtype} N=300 E=1600 V=8193",
                   *ce_case(gen, dtype, 300, 1600, 8193))
    s = torch.finfo(dtype).bits // 8
    ops = 2 * N * E * V
    f_ms, f_by = bound((N + V) * E * s + N * 4 + 2 * N * 4, ops, dtype)
    # the logits once, dh = t @ W and dW = t^T @ h
    b_ms, b_by = bound(2 * (N + V) * E * s + 3 * N * 4, 3 * ops, dtype)
    ms = time_ms(lambda: ce.lm_head_ce_fwd(h, w, y), flush, reps=10)
    plain_ms = time_ms(lambda: ce.lm_head_ce_fwd_plain(h, w, y), flush,
                       reps=10)
    yl = y.long()
    xent = torch.nn.functional.cross_entropy
    lib_ms = time_ms(lambda: xent(h @ w.T, yl, ignore_index=-1,
                                  reduction="none"), flush, reps=10)
    lse0, _ = ce.lm_head_ce_fwd(h, w, y)
    bms = time_ms(lambda: ce.lm_head_ce_bwd(h, w, y, lse0, dn), flush,
                  reps=10)
    bplain_ms = time_ms(lambda: ce.lm_head_ce_bwd_plain(h, w, y, lse0, dn),
                        flush, reps=10)
    hg, wg = h.detach().clone().requires_grad_(), \
        w.detach().clone().requires_grad_()

    def lib_fwd_bwd():
        xent(hg @ wg.T, yl, ignore_index=-1, reduction="none").backward(dn)

    lib_fb_ms = time_ms(lib_fwd_bwd, flush, reps=10)
    print(f"lm_head_ce {dtype} N={N}: forward kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} (cross_entropy(h @ W.T))"
          f" bound_ms {f_ms:.4f} ({f_by}); backward kernel_ms {bms:.4f} "
          f"plain_ms {bplain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); library "
          f"forward+backward {lib_fb_ms:.4f} ms; {card}")
    print(f"lm_head_ce {dtype}: kernel below the library: forward "
          f"{ms < lib_ms}, backward {bms < lib_fb_ms}")
    fwd = {"max_abs_err": (nll[live] - pnll[live]).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": f_ms,
           "bound_by": f_by, "library_ms": lib_ms}
    bwd = {"max_abs_err": max((a.float() - c.float()).abs().max().item()
                              for a, c in zip(grads, pgrads)),
           "ms": bms, "plain_ms": bplain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_fb_ms,
           "library_call": "cross_entropy(h @ W.T) forward+backward"}
    return fwd, bwd


# Fused LN tolerances, relative to each output's own largest value.  fp32:
# the same fp32 operations summed in another order.  bf16: out, dx and dy
# are rounded once from fp32 in both versions, so an element may differ by
# one bf16 spacing where the two fp32 values straddle a rounding boundary;
# only what lies beyond that spacing counts, and the share of elements of
# out that differ at all must stay under FLN_SHARE (a kernel that rounded
# v = x + drop(y) to bf16 before the statistics, as an unfused bf16 graph
# does, moves a large share by one spacing: the control below).
FLN_TOL = 1e-5
FLN_SHARE = 1e-3


def fln_err(x, ref):
    """Fused-LN error over ``max |ref|``; for bf16 the part beyond one
    bf16 spacing at ``ref``."""
    if x.dtype == torch.bfloat16:
        return max(0.0, bf16_excess(x, ref)) / ref.float().abs().max().item()
    return rel_err(x, ref)


def fln_rounded_v(fln, x, y, s, b, kw):
    """Control: the plain forward with v = x + drop(y) rounded to the
    inputs' type before the statistics."""
    v, _ = fln._residual_plain(x, y, kw["words"], kw["thresh"], kw["keep_y"])
    v = v.to(x.dtype).float()
    mean = v.mean(-1, keepdim=True)
    c = v - mean
    rstd = torch.rsqrt((c * c).mean(-1, keepdim=True) + 1e-5)
    return (c * rstd * s + b).to(x.dtype)


def check_fused_ln(fln, prng, flush, dtype, gen):
    """Kernels vs plain at T=12288, D=1024 (BERT-large at 96 x 128), rate
    0.1: out, dx, dy, dscale, dbias; the dropped pattern of dy bitwise
    where dv != 0; the backward run twice and compared bitwise; controls
    that must fail; times beside the bound, the plain version and
    ``F.layer_norm(x + F.dropout(y))`` (another mask: the yardstick's
    dropout draws its own)."""
    T, D, rate = 12288, 1024, 0.1
    x, y, do = (torch.randn((T, D), generator=gen).to("cuda", dtype)
                for _ in range(3))
    s = (1 + 0.1 * torch.randn(D, generator=gen)).cuda()
    b = (0.1 * torch.randn(D, generator=gen)).cuda()
    words = prng.key_words(prng.fold_in(prng.key(0), 3))
    kw = dict(words=words, thresh=fln.dropout_keep_thresh(rate),
              keep_y=fln._keep_y(rate, dtype))
    keep_g = float(torch.tensor(1.0 - rate, dtype=torch.float32))
    out, mean, rstd = fln.fused_ln_fwd(x, y, s, b, **kw)
    grads = fln.fused_ln_bwd(do, x, y, s, mean, rstd, keep_g=keep_g, **kw)
    again = fln.fused_ln_bwd(do, x, y, s, mean, rstd, keep_g=keep_g, **kw)
    pout, pmean, prstd = fln.fused_ln_fwd_plain(x, y, s, b, **kw)
    pgrads = fln.fused_ln_bwd_plain(do, x, y, s, mean, rstd, keep_g=keep_g,
                                    **kw)
    torch.cuda.synchronize()
    errs = {"out": fln_err(out, pout), "mean": rel_err(mean, pmean),
            "rstd": rel_err(rstd, prstd)}
    errs.update({n: fln_err(a, p) for n, a, p in
                 zip(("dx", "dy", "dscale", "dbias"), grads, pgrads)})
    same = all(torch.equal(a, c) for a, c in zip(grads, again))
    live = grads[0] != 0
    dropped = (grads[1] == 0) & live
    pattern = torch.equal(dropped, (pgrads[1] == 0) & live)
    kept = 1.0 - dropped.sum().item() / live.sum().item()
    share = (out != pout).float().mean().item() \
        if dtype == torch.bfloat16 else 0.0
    print(f"fused_ln {dtype}: relative errors "
          + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (tol {FLN_TOL:g} of each output's own max; bf16: beyond one "
          f"bf16 spacing); bf16 out elements differing {share:.3e} (tol "
          f"{FLN_SHARE:g}); dropped pattern bitwise equal: {pattern} (kept "
          f"{kept:.5f}, keep 0.9); backward bitwise repeatable: {same}")
    assert max(errs.values()) <= FLN_TOL, errs
    assert share <= FLN_SHARE and pattern and same
    swapped = dict(kw, words=words[::-1])
    c_out, _, _ = fln.fused_ln_fwd(x, y, s, b, **swapped)
    ctrl = {"key words swapped": fln_err(c_out, pout)}
    if dtype == torch.bfloat16:
        c_share = (fln_rounded_v(fln, x, y, s, b, kw) != pout).float()
        ctrl["v rounded to bf16 (share differing)"] = c_share.mean().item()
    print(f"fused_ln {dtype}: controls " + ", ".join(
        f"{n} {e:.3e}" for n, e in ctrl.items())
        + f" (must exceed {FLN_TOL:g}; the share {FLN_SHARE:g})")
    assert ctrl["key words swapped"] > FLN_TOL
    assert dtype == torch.float32 or \
        ctrl["v rounded to bf16 (share differing)"] > FLN_SHARE
    del c_out
    sz = torch.finfo(dtype).bits // 8
    f_ms, f_by = bound(3 * T * D * sz + 2 * T * 4 + 2 * D * 4, 8 * T * D,
                       torch.float32)
    b_ms, b_by = bound(5 * T * D * sz + 2 * T * 4 + 3 * D * 4, 16 * T * D,
                       torch.float32)
    ms = time_ms(lambda: fln.fused_ln_fwd(x, y, s, b, **kw), flush)
    plain_ms = time_ms(lambda: fln.fused_ln_fwd_plain(x, y, s, b, **kw),
                       flush, reps=10)
    F = torch.nn.functional
    sl, bl = s.to(dtype), b.to(dtype)
    lib_ms = time_ms(lambda: F.layer_norm(x + F.dropout(y, rate), (D,), sl,
                                          bl), flush)
    bms = time_ms(lambda: fln.fused_ln_bwd(do, x, y, s, mean, rstd,
                                           keep_g=keep_g, **kw), flush)
    # information: the same bytes without the mask's two hash rounds and
    # two exact divisions an element (thresh 0)
    b0ms = time_ms(lambda: fln.fused_ln_bwd(do, x, y, s, mean, rstd), flush)
    bplain_ms = time_ms(lambda: fln.fused_ln_bwd_plain(
        do, x, y, s, mean, rstd, keep_g=keep_g, **kw), flush, reps=10)
    xg, yg, sg, bg = (t.detach().clone().requires_grad_()
                      for t in (x, y, sl, bl))

    def lib_fwd_bwd():
        F.layer_norm(xg + F.dropout(yg, rate), (D,), sg, bg).backward(do)

    lib_fb_ms = time_ms(lib_fwd_bwd, flush)
    print(f"fused_ln {dtype}: forward kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} (layer_norm(x + "
          f"dropout(y)), another mask) bound_ms {f_ms:.4f} ({f_by}); "
          f"backward kernel_ms {bms:.4f} plain_ms {bplain_ms:.4f} bound_ms "
          f"{b_ms:.4f} ({b_by}); library forward+backward {lib_fb_ms:.4f} "
          f"ms; backward without dropout {b0ms:.4f} ms")
    fwd = {"max_abs_err": (out.float() - pout.float()).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": f_ms,
           "bound_by": f_by, "library_ms": lib_ms,
           "library_call": "layer_norm(x + dropout(y)), another mask"}
    bwd = {"max_abs_err": max((a.float() - p.float()).abs().max().item()
                              for a, p in zip(grads, pgrads)),
           "ms": bms, "plain_ms": bplain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_fb_ms,
           "library_call": "layer_norm(x + dropout(y)) forward+backward, "
                           "another mask"}
    return fwd, bwd


def train_phase(fl, ce, gpt_mod, card):
    """GPT-2 small at full width and depth, fp32, flash attention and the
    streamed head (chunk 1024): a step-0 check of the loss and every
    gradient against the plain path on the card (materialized attention
    and head, same weights), then 5 AdamW ``Trainer`` steps on one
    numpy-seeded 8 x 1024 batch with the launch counters read per step,
    then one profiled step.  Returns the counts and the losses of the
    5-step run."""
    from hetu_tpu_torch import AdamWOptimizer, GPT, Trainer, flash_attn_fn
    cfg = gpt_mod.gpt2_small(streamed_head_chunk=1024)
    model = GPT(cfg, attn_fn=flash_attn_fn(native_layout=True),
                generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, cfg.max_seq_len))).cuda()
    tokens = ids.numel()

    def grads_of(m):
        m.zero_grad(set_to_none=True)
        loss = m.loss(ids)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in m.named_parameters()}

    fl.reset_launch_count()
    ce.reset_launch_count()
    k_loss, k_grads = grads_of(model)
    torch.cuda.synchronize()
    counts0 = (fl.fwd_launch_count(), fl.bwd_launch_count(),
               ce.fwd_launch_count(), ce.bwd_launch_count())
    assert counts0 == (12, 12, 1, 1), counts0
    plain = GPT(gpt_mod.gpt2_small(), generator=torch.Generator())
    plain.load_state_dict(model.state_dict())
    p_loss, p_grads = grads_of(plain)
    torch.cuda.synchronize()
    assert (fl.fwd_launch_count(), ce.fwd_launch_count()) == (12, 1), \
        "the plain path launched a train kernel"
    lrel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    worst = max((((k_grads[n] - g).abs().max()
                  / g.abs().max().clamp_min(1e-30)).item(), n)
                for n, g in p_grads.items())
    print(f"train step 0: loss kernel path {float(k_loss):.6f} plain path "
          f"{float(p_loss):.6f}, relative difference {lrel:.3e} (tol 1e-5);"
          f" worst gradient {worst[1]}: max |diff| / max |plain| "
          f"{worst[0]:.3e} (tol 1e-3: fp32 sums over 8192 tokens taken in "
          f"other orders)")
    assert lrel <= 1e-5 and worst[0] <= 1e-3
    del plain, p_grads, k_grads
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    trainer = Trainer(model, AdamWOptimizer(3e-4, weight_decay=0.01),
                      lambda m, batch, key: (m.loss(batch, key=key), {}))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fl.reset_launch_count()
    ce.reset_launch_count()
    losses, step_s = [], []
    for _ in range(5):
        before = (fl.fwd_launch_count(), fl.bwd_launch_count(),
                  ce.fwd_launch_count(), ce.bwd_launch_count())
        t0 = time.monotonic()
        losses.append(float(trainer.step(ids)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        after = (fl.fwd_launch_count(), fl.bwd_launch_count(),
                 ce.fwd_launch_count(), ce.bwd_launch_count())
        delta = tuple(a - b for a, b in zip(after, before))
        assert delta == (12, 12, 1, 1), f"launches per step {delta}"
    counts = {"flash_fwd": fl.fwd_launch_count(),
              "flash_bwd": fl.bwd_launch_count(),
              "lm_head_ce_fwd": ce.fwd_launch_count(),
              "lm_head_ce_bwd": ce.bwd_launch_count()}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_s)
    print(f"train: losses {[round(x, 6) for x in losses]}; launches "
          f"{counts} (12/12/1/1 per step); median step {med * 1e3:.3f} ms "
          f"(steps {[round(s * 1e3, 3) for s in step_s]} ms), "
          f"{tokens / med:.1f} tokens/s, peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB), {card}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

    profile_step(lambda: trainer.step(ids), med)
    torch.cuda.synchronize()
    return counts, losses


def ring_phase(fl, ce, gpt_mod, card, flash_losses):
    """GPT-2 small trained with sequence-parallel ring attention, sp=4, on
    the one card (a local mesh: the four ranks' visits run in turn with a
    rank's shapes).  Same weights and batch as the train phase.  Step 0:
    the ring's loss and every gradient against the flash path's, the
    ring's gradients bitwise equal on a second run, the blockwise core
    against the flash path too; then 5 AdamW ``Trainer`` steps, each
    launching 120 block forwards and 120 block backwards (12 layers x 10
    visits), no whole-sequence flash, 1 CE forward and 1 CE backward, with
    a falling loss; step time, tokens/s, peak memory and a profiled step.
    Returns the counts of the 5-step run."""
    from hetu_tpu_torch import (AdamWOptimizer, GPT, MeshSpec, Trainer,
                                flash_attn_fn, make_mesh, ring_attn_fn)
    cfg = gpt_mod.gpt2_small(streamed_head_chunk=1024)
    mesh = make_mesh(MeshSpec(sp=4))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, cfg.max_seq_len))).cuda()
    tokens = ids.numel()

    def grads_of(m):
        m.zero_grad(set_to_none=True)
        loss = m.loss(ids)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in m.named_parameters()}

    def counts():
        return (fl.block_fwd_launch_count(), fl.block_bwd_launch_count(),
                fl.fwd_launch_count(), fl.bwd_launch_count(),
                ce.fwd_launch_count(), ce.bwd_launch_count())

    def against_flash(name, loss, grads):
        lrel = abs(float(loss) - float(f_loss)) / abs(float(f_loss))
        worst = max((((grads[n] - g).abs().max()
                      / g.abs().max().clamp_min(1e-30)).item(), n)
                    for n, g in f_grads.items())
        print(f"ring step 0 ({name}): loss {float(loss):.6f}, flash path "
              f"{float(f_loss):.6f}, relative difference {lrel:.3e} (tol "
              f"1e-5); worst gradient {worst[1]}: max |diff| / max |flash| "
              f"{worst[0]:.3e} (tol 1e-3: fp32 sums in other orders)")
        assert lrel <= 1e-5 and worst[0] <= 1e-3

    flash = GPT(cfg, attn_fn=flash_attn_fn(native_layout=True),
                generator=torch.Generator().manual_seed(0))
    f_loss, f_grads = grads_of(flash)
    ring = GPT(cfg, attn_fn=ring_attn_fn(mesh), generator=torch.Generator())
    ring.load_state_dict(flash.state_dict())
    del flash
    torch.cuda.synchronize()
    fl.reset_launch_count()
    ce.reset_launch_count()
    r_loss, r_grads = grads_of(ring)
    torch.cuda.synchronize()
    assert counts() == (120, 120, 0, 0, 1, 1), counts()
    against_flash("flash block kernels", r_loss, r_grads)
    again_loss, again = grads_of(ring)
    same = torch.equal(again_loss, r_loss) and all(
        torch.equal(again[n], g) for n, g in r_grads.items())
    print(f"ring step 0: loss and all {len(r_grads)} gradients bitwise "
          f"equal on a second run: {same}")
    assert same, "the ring's step-0 gradients are not bitwise repeatable"
    del r_grads, again
    blockwise = GPT(cfg, attn_fn=ring_attn_fn(mesh, impl="blockwise"),
                    generator=torch.Generator())
    blockwise.load_state_dict(ring.state_dict())
    before = counts()
    b_loss, b_grads = grads_of(blockwise)
    torch.cuda.synchronize()
    assert counts()[:4] == before[:4], "the blockwise core launched flash"
    against_flash("blockwise core", b_loss, b_grads)
    del blockwise, b_grads, f_grads
    ring.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    trainer = Trainer(ring, AdamWOptimizer(3e-4, weight_decay=0.01),
                      lambda m, batch, key: (m.loss(batch, key=key), {}))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fl.reset_launch_count()
    ce.reset_launch_count()
    losses, step_s = [], []
    for _ in range(5):
        before = counts()
        t0 = time.monotonic()
        losses.append(float(trainer.step(ids)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        delta = tuple(a - b for a, b in zip(counts(), before))
        assert delta == (120, 120, 0, 0, 1, 1), f"launches per step {delta}"
    launches = {"flash_block_fwd": fl.block_fwd_launch_count(),
                "flash_block_bwd": fl.block_bwd_launch_count(),
                "flash_fwd": fl.fwd_launch_count(),
                "flash_bwd": fl.bwd_launch_count(),
                "lm_head_ce_fwd": ce.fwd_launch_count(),
                "lm_head_ce_bwd": ce.bwd_launch_count()}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_s)
    gap = max(abs(a - b) for a, b in zip(losses, flash_losses))
    print(f"ring train (sp=4): losses {[round(x, 6) for x in losses]}; "
          f"launches {launches} (120/120/0/0/1/1 per step); median step "
          f"{med * 1e3:.3f} ms (steps {[round(t * 1e3, 3) for t in step_s]}"
          f" ms), {tokens / med:.1f} tokens/s, peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB), {card}; info: largest loss gap to the "
          f"train phase's flash path, step for step, {gap:.3e}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    profile_step(lambda: trainer.step(ids), med)
    torch.cuda.synchronize()
    return launches


# Kernel-name marks of the groups a profiled step's device time is summed
# into (the first group that matches wins).
PROFILE_GROUPS = (
    ("fused LN", ("::ln_fwd", "::ln_bwd", "::ln_sum_parts")),
    ("flash (whole-sequence, or the ring's blocks)", ("::flash_",)),
    ("LM-head cross entropy", ("::ce_",)),
    ("the port's other CUDA kernels", (
        "::head_topk_", "::paged_decode_")),
    ("matrix products", ("gemm", "nvjet", "cutlass", "xmma")),
    ("int64 elementwise (dropout hash)", ("<long",)),
    ("elementwise and copies", ("elementwise", "copy")),
    ("reductions", ("reduce_kernel",)),
)


def union_ms(spans):
    """The length of the union of ``(start, end)`` intervals in µs, in
    ms."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def device_spans(prof):
    """``(name, start, end)`` of every device activity under ``prof``.
    Busy time is the union of these: a kernel launched as a programmatic
    dependent (paged decode's merge, the fused-LN backward's partial
    sums) starts while the kernel before it runs and waits inside
    itself, so summed durations would count that overlap twice.  A
    ``record_function`` range is mirrored on the device's timeline as a
    user annotation spanning its kernels and the gaps between them: it
    is no work, and is left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith((MOE_GROUP_MARK, VISION_MARK))]


def profile_step(step, med):
    """One profiled call of ``step``: the device's busy time, its ten
    largest items and the busy time of each group of kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    if not rows:
        print("train step device time: not measured (the profiler saw no "
              "device activity)")
        return
    spans = device_spans(prof)
    dev_ms = union_ms([sp[1:] for sp in spans])
    print(f"train step under the profiler: device busy {dev_ms:.3f} ms "
          f"({dev_ms / (med * 1e3):.1%} of the median bare step; kernel "
          f"durations sum to {sum(r[1] for r in rows) / 1e3:.3f} ms)")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"  {us / 1e3:9.3f} ms  {n:5d} launches  {key[:90]}")
    groups = {}
    for name, a, b in spans:
        g = next((g for g, marks in PROFILE_GROUPS
                  if any(m in name for m in marks)), "other")
        groups.setdefault(g, []).append((a, b))
    groups = {g: (union_ms(sp), len(sp)) for g, sp in groups.items()}
    print("  by group (busy time): " + "; ".join(
        f"{g} {t:.3f} ms ({c} launches)"
        for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    if "LM-head cross entropy" in groups:
        t, c = groups["LM-head cross entropy"]
        print(f"  LM-head CE kernels (forward and backward): {t:.3f} ms of "
              f"device time in {c} launches")


def bert_batch(vocab, batch, seq, seed=0):
    """A pretraining batch as the JAX package's bench makes it: numpy
    seed 0, 15% of positions carry an MLM label (else -1), random NSP
    labels; token types all 0, no attention mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq))
    mlm = np.where(rng.random((batch, seq)) < 0.15,
                   rng.integers(0, vocab, (batch, seq)), -1)
    nsp = rng.integers(0, 2, (batch,))
    return tuple(torch.from_numpy(a).cuda() for a in (ids, mlm, nsp))


def bert_phase(fln, card):
    """BERT-large pretraining: the fp32 step-0 check of the fused kernels
    against the plain sites at batch 8 x 128 with one fixed key, then 5
    bf16 AdamW ``Trainer`` steps at batch 96 x 128 with the launch counts
    read per step, then one profiled step, then (information) the same 5
    steps through the plain sites.  Returns the counts of the 5-step
    run."""
    from hetu_tpu_torch import (AdamWOptimizer, BertForPreTraining, Trainer,
                                bert_large, set_random_seed)
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.layers import dot_product_attention_bhsd
    attn = dot_product_attention_bhsd

    def grads_of(m, batch, key):
        ids, mlm, nsp = batch
        m.zero_grad(set_to_none=True)
        loss, _ = m.loss(ids, None, None, mlm, nsp, key=key)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in m.named_parameters()
                               if p.grad is not None}

    t0 = time.monotonic()
    fused = BertForPreTraining(bert_large(fused_ln=True), attn_fn=attn,
                               generator=torch.Generator().manual_seed(0))
    cfg = fused.config
    print(f"model: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
          f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, dropout "
          f"{cfg.dropout_rate}, {sum(p.numel() for p in fused.parameters())}"
          f" parameters, built in {time.monotonic() - t0:.2f} s")
    small = bert_batch(cfg.vocab_size, 8, 128, seed=1)
    key = prng.fold_in(prng.key(0), 1)
    fln.reset_launch_count()
    k_loss, k_grads = grads_of(fused, small, key)
    torch.cuda.synchronize()
    counts0 = (fln.fwd_launch_count(), fln.bwd_launch_count())
    assert counts0 == (48, 48), counts0
    plain = BertForPreTraining(bert_large(), attn_fn=attn,
                               generator=torch.Generator())
    plain.load_state_dict(fused.state_dict())
    p_loss, p_grads = grads_of(plain, small, key)
    torch.cuda.synchronize()
    assert (fln.fwd_launch_count(), fln.bwd_launch_count()) == counts0, \
        "the plain path launched a fused-LN kernel"
    assert sorted(k_grads) == sorted(p_grads)
    lrel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    worst = max((((k_grads[n] - g).abs().max()
                  / g.abs().max().clamp_min(1e-30)).item(), n)
                for n, g in p_grads.items())
    print(f"BERT step 0 (fp32, 8 x 128, dropout on, one key): loss fused "
          f"{float(k_loss):.6f} plain {float(p_loss):.6f}, relative "
          f"difference {lrel:.3e} (tol 1e-5); worst gradient {worst[1]}: "
          f"max |diff| / max |plain| {worst[0]:.3e} (tol 1e-3: fp32 sums "
          f"taken in other orders); launches {counts0}")
    assert lrel <= 1e-5 and worst[0] <= 1e-3
    del fused, plain, k_grads, p_grads
    torch.cuda.empty_cache()

    set_random_seed(0)
    model = BertForPreTraining(bert_large(fused_ln=True,
                                          dtype=torch.bfloat16),
                               attn_fn=attn,
                               generator=torch.Generator().manual_seed(0))
    batch = bert_batch(model.config.vocab_size, 96, 128)
    samples, tokens = batch[0].shape[0], batch[0].numel()

    def loss_fn(m, bt, k):
        ids, mlm, nsp = bt
        loss, _ = m.loss(ids, None, None, mlm, nsp, key=k)
        return loss, {}

    trainer = Trainer(model, AdamWOptimizer(1e-4, weight_decay=0.01),
                      loss_fn)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fln.reset_launch_count()
    losses, step_s = [], []
    for _ in range(5):
        before = (fln.fwd_launch_count(), fln.bwd_launch_count())
        t0 = time.monotonic()
        losses.append(float(trainer.step(batch)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        delta = (fln.fwd_launch_count() - before[0],
                 fln.bwd_launch_count() - before[1])
        assert delta == (48, 48), f"fused-LN launches per step {delta}"
    counts = {"fused_ln_fwd": fln.fwd_launch_count(),
              "fused_ln_bwd": fln.bwd_launch_count()}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_s)
    print(f"BERT train (bf16, 96 x 128, AdamW 1e-4): losses "
          f"{[round(x, 6) for x in losses]}; launches {counts} (48/48 per "
          f"step); median step {med * 1e3:.3f} ms (steps "
          f"{[round(t * 1e3, 3) for t in step_s]} ms), {samples / med:.2f} "
          f"samples/s, {tokens / med:.1f} tokens/s, peak memory {peak} "
          f"bytes ({peak / 2**30:.3f} GiB), {card}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    profile_step(lambda: trainer.step(batch), med)
    del trainer, model
    torch.cuda.empty_cache()
    # information: the same steps through the plain sites (dropout +
    # layer_norm, v rounded to bf16), same weights and keys
    set_random_seed(0)
    plain = BertForPreTraining(bert_large(dtype=torch.bfloat16),
                               attn_fn=attn,
                               generator=torch.Generator().manual_seed(0))
    ptrainer = Trainer(plain, AdamWOptimizer(1e-4, weight_decay=0.01),
                       loss_fn)
    plosses = [float(ptrainer.step(batch)["loss"]) for _ in range(5)]
    print(f"info: the same 5 steps with fused_ln=False: losses "
          f"{[round(x, 6) for x in plosses]}")
    torch.cuda.synchronize()
    return counts


# Phase 8, BERT-large at seq 512 (``bench.py`` ``bench_bert_long``): each
# (attention core, fused LN) variant of bench's ``BERT512_VARIANTS``, in
# its order, at batch 24, then the fastest at batch 48 under remat
# "full"; 3 steps each, bench's ``k``.
BERT512_VARIANTS = (("xla", False), ("flash", False), ("xla", True),
                    ("flash", True))
BERT512_SEQ, BERT512_BATCH, BERT512_REMAT_BATCH, BERT512_STEPS = \
    512, 24, 48, 3


def bert512_batch(vocab, batch, seed=0):
    """``model.loss``'s arguments as ``bench.py`` ``_bert_time`` makes its
    batch: numpy seed 0, token types all 0, 15% of positions with an MLM
    label (else -1), random NSP labels, no attention mask."""
    rng = np.random.default_rng(seed)
    shape = (batch, BERT512_SEQ)
    ids = rng.integers(0, vocab, shape)
    mlm = np.where(rng.random(shape) < 0.15, rng.integers(0, vocab, shape),
                   -1)
    nsp = rng.integers(0, 2, (batch,))
    cuda = [torch.from_numpy(a).cuda() for a in (ids, mlm, nsp)]
    return (cuda[0], torch.zeros_like(cuda[0]), None, cuda[1], cuda[2])


def bert512_counts(fl, fln):
    return (fl.fwd_launch_count(), fl.bwd_launch_count(),
            fln.fwd_launch_count(), fln.bwd_launch_count())


def bert512_exactness(fl, fln):
    """BERT-large's width with 2 layers, bf16, the flash core and the
    fused LN, dropout 0.1, batch 4 x 512, one key: under every remat
    policy the loss and every gradient equal ``"none"``'s bitwise, twice,
    with each block's flash and fused-LN forwards run twice under every
    policy but ``"none"`` (the replay in the backward)."""
    import dataclasses
    from hetu_tpu_torch import (BertForPreTraining, bert_large,
                                flash_attn_fn)
    from hetu_tpu_torch.mem import policy_names
    from hetu_tpu_torch.core import prng
    L = 2
    model = BertForPreTraining(
        dataclasses.replace(bert_large(fused_ln=True, dtype=torch.bfloat16),
                            num_layers=L),
        attn_fn=flash_attn_fn(native_layout=True),
        generator=torch.Generator().manual_seed(0))
    batch = bert512_batch(model.config.vocab_size, 4, seed=1)
    key = prng.fold_in(prng.key(0), 11)
    cfg = model.bert.config

    def run(policy):
        model.bert.config = dataclasses.replace(cfg, remat=policy)
        model.zero_grad(set_to_none=True)
        fl.reset_launch_count()
        fln.reset_launch_count()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = model.loss(*batch, key=key)
        loss.backward()
        torch.cuda.synchronize()
        return (loss.detach(), {n: p.grad.clone()
                                for n, p in model.named_parameters()
                                if p.grad is not None},
                bert512_counts(fl, fln), torch.cuda.max_memory_allocated())

    base = run("none")
    for policy in policy_names():
        twice = 1 if policy == "none" else 2
        want = (twice * L, L, 2 * twice * L, 2 * L)
        for attempt in range(2):
            loss, grads, counts, peak = run(policy)
            same = torch.equal(loss, base[0]) and all(
                torch.equal(grads[n], g) for n, g in base[1].items())
            assert same, f"remat {policy}: not bitwise equal to none"
            assert counts == want, f"remat {policy}: launches {counts}"
        print(f"remat {policy} (2 layers, bf16, 4 x 512): loss "
              f"{float(loss):.6f} and {len(grads)} gradients bitwise equal "
              f"to none's, twice; flash fwd/bwd, fused-LN fwd/bwd launches "
              f"{counts}; peak {peak} bytes ({peak / 2**30:.3f} GiB)")
    model.bert.config = cfg
    del model, base, grads
    torch.cuda.empty_cache()


def bert512_variant(fl, fln, variant, batch_size, remat, card):
    """``bench.py`` ``_bert_time`` at full width and depth: a fresh
    BERT-large (bf16, dropout 0.1) with the variant's attention core and
    LN sites, AdamW(1e-4, wd 0.01), 3 ``Trainer`` steps on one batch with
    keys from ``next_key``; asserts the launches of every step and finite
    losses.  Returns the trainer, the batch and the measurements."""
    from hetu_tpu_torch import (AdamWOptimizer, BertForPreTraining, Trainer,
                                bert_large, flash_attn_fn, set_random_seed)
    from hetu_tpu_torch.layers import dot_product_attention_bhsd
    attn, fused = variant
    set_random_seed(0)
    model = BertForPreTraining(
        bert_large(max_position_embeddings=BERT512_SEQ, fused_ln=fused,
                   remat=remat, dtype=torch.bfloat16),
        attn_fn=(flash_attn_fn(native_layout=True) if attn == "flash"
                 else dot_product_attention_bhsd),
        generator=torch.Generator().manual_seed(0))
    L = model.config.num_layers
    batch = bert512_batch(model.config.vocab_size, batch_size)

    def loss_fn(m, bt, k):
        loss, _ = m.loss(*bt, key=k)
        return loss, {}

    trainer = Trainer(model, AdamWOptimizer(1e-4, weight_decay=0.01),
                      loss_fn)
    twice = 1 if remat == "none" else 2
    want = ((twice * L, L) if attn == "flash" else (0, 0)) + \
        ((2 * twice * L, 2 * L) if fused else (0, 0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(BERT512_STEPS):
        before = bert512_counts(fl, fln)
        t0 = time.monotonic()
        losses.append(float(trainer.step(batch)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        delta = tuple(a - b for a, b in zip(bert512_counts(fl, fln), before))
        assert delta == want, (f"{variant} remat {remat}: launches per step "
                               f"{delta}, expected {want}")
    assert all(np.isfinite(losses)), losses
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_s)
    tag = f"{attn}{'+fused_ln' if fused else ''}"
    print(f"BERT-large seq {BERT512_SEQ} {tag}, batch {batch_size}, remat "
          f"{remat}: losses {[round(x, 6) for x in losses]}; median step "
          f"{med * 1e3:.3f} ms (steps {[round(t * 1e3, 3) for t in step_s]}"
          f" ms), {batch_size / med:.2f} samples/s, "
          f"{batch_size * BERT512_SEQ / med:.1f} tokens/s, peak memory "
          f"{peak} bytes ({peak / 2**30:.3f} GiB); flash fwd/bwd, fused-LN "
          f"fwd/bwd launches a step {want}; {card}")
    return {"trainer": trainer, "batch": batch, "median_s": med,
            "peak": peak, "samples_per_s": batch_size / med, "tag": tag}


def bert512_phase(fl, fln, card):
    """Phase 8: the remat policies' exactness on the card, the four
    variants at batch 24, the fastest at batch 48 under remat "full",
    bench's decision between the two, and one profiled step of the
    winner.  Returns the flash and fused-LN launches of the variants'
    and the remat run's steps."""
    bert512_exactness(fl, fln)
    fl.reset_launch_count()
    fln.reset_launch_count()
    best = None
    for variant in BERT512_VARIANTS:
        r = bert512_variant(fl, fln, variant, BERT512_BATCH, "none", card)
        if best is None or r["median_s"] < best[1]["median_s"]:
            best = (variant, r)
        else:
            del r
        torch.cuda.empty_cache()
    variant, base = best
    remat = bert512_variant(fl, fln, variant, BERT512_REMAT_BATCH, "full",
                            card)
    print(f"remat probe: {base['tag']} at batch {BERT512_REMAT_BATCH} under "
          f"full peaks at {remat['peak'] / 2**30:.3f} GiB against "
          f"{base['peak'] / 2**30:.3f} GiB at batch {BERT512_BATCH} under "
          f"none")
    assert remat["peak"] < base["peak"], "remat did not lower the peak"
    won = remat if remat["samples_per_s"] > base["samples_per_s"] else base
    print(f"decision (bench.py: whichever moves more samples/s): "
          f"{base['tag']} at batch "
          f"{BERT512_REMAT_BATCH if won is remat else BERT512_BATCH}"
          f"{' with remat full' if won is remat else ' without remat'} "
          f"({remat['samples_per_s']:.2f} against "
          f"{base['samples_per_s']:.2f} samples/s)")
    counts = dict(zip(("flash_fwd", "flash_bwd", "fused_ln_fwd",
                       "fused_ln_bwd"), bert512_counts(fl, fln)))
    trainer, batch = won["trainer"], won["batch"]
    profile_step(lambda: trainer.step(batch), won["median_s"])
    del best, base, remat, won, trainer, batch
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return counts


# Phase 4's stochastic modes: top-k's k, and both modes' temperature.
SERVE_TOP_K, SERVE_TEMPERATURE = 5, 0.8
GUMBEL_TOL = 2e-6   # torch.log on the card against torch.log on the CPU


def check_rng(flush, N=SERVE_SLOTS, V=50257):
    """The threefry bits, the uniform and the Gumbel field at the decode
    step's shape, ``(N, V)`` from N per-row keys derived as the engine
    derives them, on the card against the CPU: bits and uniform bitwise,
    the field within GUMBEL_TOL; and the field's device time."""
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.ops import random as rnd
    keys = prng.fold_in_tensor(prng.fold_in_tensor(
        prng.key(0), torch.arange(N)), torch.arange(N) + 100)
    dk = keys.cuda()
    assert torch.equal(prng.random_bits(dk, (V,)).cpu(),
                       prng.random_bits(keys, (V,))), \
        "random_bits on the card differ from the CPU's"
    tiny = torch.finfo(torch.float32).tiny
    for lo, hi in ((tiny, 1.0), (-3.5, 7.25)):
        u = rnd._uniform(dk, (V,), torch.float32, lo, hi).cpu()
        ref = rnd._uniform(keys, (V,), torch.float32, lo, hi)
        assert torch.equal(u.view(torch.int32), ref.view(torch.int32)), \
            f"the uniform on ({lo}, {hi}) differs on the card"
    err = (rnd._gumbel(dk, (V,)).cpu() - rnd._gumbel(keys, (V,))).abs()
    err = err.max().item()
    ms = time_ms(lambda: rnd._gumbel(dk, (V,)), flush, reps=10)
    print(f"threefry bits and uniform ({N}, {V}): bitwise equal to the "
          f"CPU's; Gumbel field max_abs_err {err:.3e} tol {GUMBEL_TOL:g}; "
          f"the field takes {ms:.4f} ms on the card (eager, L2 flushed)")
    assert err <= GUMBEL_TOL, f"Gumbel field on the card: {err}"


def check_sample_tokens(lh, N=SERVE_SLOTS, E=768, V=50257):
    """``lm_head_sample_tokens`` at GPT-2 small's head in the two
    stochastic modes against its plain route on the same Gumbel field or
    the same candidates: tokens equal wherever the two best perturbed
    scores are separated by more than the kernel's 1e-4 value tolerance."""
    from hetu_tpu_torch.core import prng
    g = torch.Generator().manual_seed(11)
    w = (torch.randn((V, E), generator=g) * 0.02).cuda()
    h = torch.randn((N, E), generator=g).cuda()
    keys = prng.fold_in_tensor(prng.key(1), torch.arange(N)).cuda()
    T = SERVE_TEMPERATURE
    for mode in ("temperature", "top_k"):
        lh.reset_launch_count()
        got = lh.lm_head_sample_tokens(h, w, mode=mode, top_k=SERVE_TOP_K,
                                       temperature=T, keys=keys)
        assert lh.launch_count() == 1, \
            f"lm_head_sample_tokens {mode} did not launch the kernel once"
        ref, gap = lh._sample_tokens_plain(
            h, w, mode=mode, top_k=SERVE_TOP_K, temperature=T, keys=keys)
        sep = gap > 1e-4
        same = int((got == ref).sum())
        print(f"lm_head_sample_tokens {mode} (k={SERVE_TOP_K}, T={T}): "
              f"{same}/{N} tokens equal to the plain route, {int(sep.sum())}"
              f" rows separated by more than 1e-4")
        assert torch.equal(got[sep], ref[sep]) and sep.sum() >= N - 1, \
            f"lm_head_sample_tokens {mode} differs from its plain route"


def check_replay(engine, prompts, budget, **kw):
    """Three ticks of the phase's 16 requests (the first decode step
    captures the graph), then one replayed step against the eager impl,
    bitwise in tokens and pool bytes."""
    from hetu_tpu_torch.serve.graph import _replay_vs_eager
    eng = engine(**kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=budget)
    for _ in range(3):
        eng.step()
    assert eng._decode_graph.captured
    toks, pool, wrote = _replay_vs_eager(eng)
    assert wrote, "the replayed decode step wrote no K/V"
    print(f"graph replay vs eager impl ({kw.get('sampling', 'greedy')}): "
          f"tokens {'equal' if toks else 'DIFFER'}, pool bytes "
          f"{'equal' if pool else 'DIFFER'} (bitwise)")
    assert toks and pool, "a replayed decode step differs from the eager one"


def serve_mode(engine, eager_engine, prompts, budget, cfg, pd, lh, mode):
    """Phase 4 in a stochastic mode: the 16 requests with their counts
    read just after, a same-seed rerun, the probe request alone under its
    batched id, a replayed step against the eager one; then, for
    information, agreement with the gather path, tokens/s, the median
    decode step and the decode profile with the graph and without it."""
    kw = dict(sampling=mode, top_k=SERVE_TOP_K,
              temperature=SERVE_TEMPERATURE)
    eng = engine(**kw)
    torch.cuda.synchronize()
    pd.reset_launch_count()
    lh.reset_launch_count()
    t0 = time.monotonic()
    handles = [eng.submit(p, max_new_tokens=budget) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = (pd.launch_count(), lh.launch_count())
    st = eng.stats()
    bad = [(h.request_id, h.status, h.error) for h in handles
           if h.status != "completed" or len(h.tokens) != budget]
    assert not bad, f"{mode}: requests not completed: {bad}"
    assert all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens)
    steps = st["decode_steps"]
    print(f"{mode} (k={SERVE_TOP_K}, T={SERVE_TEMPERATURE}): launches "
          f"paged_decode {launches[0]}, lm_head_sample {launches[1]}, "
          f"decode steps {steps} (one CUDA graph, captured: "
          f"{eng._decode_graph.captured})")
    assert launches[0] == cfg.num_layers * steps > 0
    assert launches[1] == steps
    streams = [h.tokens for h in handles]
    del eng
    again = engine(**kw)
    ah = [again.submit(p, max_new_tokens=budget) for p in prompts]
    again.run_until_idle()
    assert [h.tokens for h in ah] == streams, f"{mode}: same-seed rerun"
    probe = 11
    alone = engine(**kw)
    h = alone.submit(prompts[probe], max_new_tokens=budget,
                     request_id=probe)
    alone.run_until_idle()
    assert h.tokens == streams[probe], f"{mode}: alone != batched"
    print(f"{mode}: same-seed rerun bitwise equal; request {probe} alone "
          f"== batched ({budget} tokens)")
    del again, alone
    check_replay(engine, prompts, budget, **kw)
    gather = engine(paged_decode=False, fused_sampling=False, **kw)
    gh = [gather.submit(p, max_new_tokens=budget) for p in prompts]
    gather.run_until_idle()
    same = sum(a == b.tokens for a, b in zip(streams, gh))
    del gather
    print(f"info: {mode} kernel path vs gather path: {same}/{len(gh)} "
          f"streams identical")
    print(f"{mode}: served {len(handles)} requests, {st['tokens']} tokens "
          f"in {wall:.3f} s: {st['tokens'] / wall:.1f} tokens/s; median "
          f"decode step {st['decode_step_s_p50'] * 1e3:.3f} ms")
    graph = profile_decode(lambda: engine(**kw), prompts, f"{mode}, graph")
    eager = profile_decode(lambda: eager_engine(**kw), prompts,
                           f"{mode}, eager")
    return {"steps": steps, "tokens_per_s": st["tokens"] / wall,
            "median_step_ms": st["decode_step_s_p50"] * 1e3,
            "graph": graph, "eager": eager}


def prefill_alone_ms(make_engine, prompt, lengths=(16, 128), reps=5):
    """Information: a one-token request served alone (its prefill, no
    decode step), the median of ``reps`` runs after a warm one, for each
    prompt length (``prompt`` repeated to it)."""
    eng = make_engine()
    out = {}
    for n in lengths:
        p = (prompt * -(-n // len(prompt)))[:n]
        ts = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.submit(p, max_new_tokens=1)
            eng.run_until_idle()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        out[n] = statistics.median(ts[1:]) * 1e3
    return out


def serve_ab(make_engine, prompts, budget, reps=3):
    """Phase 4's 16-request run in each sampler, ``reps`` times on fresh
    engines built by ``make_engine(**kw)``, with the time spent inside
    prefill, and :func:`prefill_alone_ms`: readings that compare two
    trees' engines within one call."""
    modes = {"greedy": {},
             "temperature": dict(sampling="temperature",
                                 temperature=SERVE_TEMPERATURE),
             "top_k": dict(sampling="top_k", top_k=SERVE_TOP_K,
                           temperature=SERVE_TEMPERATURE)}
    out = {}
    for mode, kw in modes.items():
        runs, streams = [], None
        for _ in range(reps):
            eng = make_engine(**kw)
            spent = []

            def timed(*a, orig=eng._prefill, spent=spent):
                torch.cuda.synchronize()
                t = time.perf_counter()
                orig(*a)
                torch.cuda.synchronize()
                spent.append(time.perf_counter() - t)
            eng._prefill = timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hs = [eng.submit(p, max_new_tokens=budget) for p in prompts]
            eng.run_until_idle()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = eng.stats()
            got = [h.tokens for h in hs]
            assert streams is None or got == streams, f"{mode}: rerun"
            streams = got
            runs.append({"tokens_per_s": st["tokens"] / wall,
                         "step_p50_ms": st["decode_step_s_p50"] * 1e3,
                         "prefill_s": sum(spent), "wall_s": wall,
                         "ttft_p50_ms": statistics.median(
                             h.ttft_s for h in hs) * 1e3})
            del eng
        out[mode] = runs
    out["prefill_alone_ms"] = prefill_alone_ms(make_engine, prompts[1])
    return out


def reference_greedy(cpu_model, prompt, n):
    """Greedy continuation by full recomputation on the CPU; returns the
    tokens and each step's last-position logits."""
    ids = list(prompt)
    toks, logits = [], []
    with torch.no_grad():
        for _ in range(n):
            lg = cpu_model(torch.tensor([ids]))[0, -1]
            toks.append(int(torch.argmax(lg)))
            logits.append(lg)
            ids.append(toks[-1])
    return toks, logits


def profile_decode(make_engine, prompts, label, steps=10):
    """Information only: where a decode step's time goes.  Eight requests
    fill the slots; ``steps`` decode ticks are timed bare, then again
    under ``torch.profiler``, whose device time by kernel name gives the
    device's busy share of the step.  Returns ``(bare step ms, device
    busy ms per step or None)``."""
    from torch.profiler import ProfilerActivity, profile
    eng = make_engine()
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=steps * 2 + 8)
    for _ in range(4):       # admission + prefill tick, then warm decode
        eng.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    bare = (time.monotonic() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's row repeats its kernels' time
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    print(f"decode step ({label}, 8 active slots): {bare * 1e3:.3f} ms wall "
          f"without the profiler")
    if not rows:
        print("device busy time: not measured (the profiler saw no device "
              "activity)")
        return bare * 1e3, None
    dev_ms = union_ms([sp[1:] for sp in device_spans(prof)]) / steps
    print(f"device busy {dev_ms:.3f} ms per step, {dev_ms / (bare * 1e3):.1%}"
          f" of the bare step (torch.profiler; kernel durations sum to "
          f"{sum(r[1] for r in rows) / 1e3 / steps:.3f} ms)")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {us / 1e3 / steps:8.4f} ms/step  {n // steps:4d} "
              f"launches/step  {key[:90]}")
    # the merge is a programmatic dependent: count the union of the two
    # kernels' intervals, not their summed durations
    sample = [sp[1:] for sp in device_spans(prof) if "head_topk_" in sp[0]]
    print(f"LM-head sampling (head_topk_partial + head_topk_merge): "
          f"{union_ms(sample) / steps:.4f} ms per step busy, "
          f"{len(sample) // steps} launches per step")
    return bare * 1e3, dev_ms


# Phase 9: bench.py's wdl_ctr workload (config 2, Wide&Deep with the HET
# host-embedding cache) through the port.  The arms are bench.py
# ``_ctr_cfg``'s at the chip's sizes; the loop is ``_ctr_time``'s: batch
# 512 of ``synthetic_ctr(n=4096, vocab_per_field=1000)``, Adam(1e-3),
# stage, step, prefetch, timed as ``timed_chunks`` times it.
CTR_BATCH, CTR_N, CTR_VOCAB_PER_FIELD = 512, 4096, 1000
CTR_CHUNK, CTR_REPS, CTR_WARMUP = 10, 5, 3
CTR_STEP0_TOL = 1e-4     # each dense and row gradient, of its own max
CTR_ROWS_TOL = 1e-4      # host rows after one push, where |g| is large
CTR_AUC = 0.6            # tests/test_ctr.py's bar for the host arm


def ctr_config(arm):
    """The ``CTRConfig`` of one arm: ``host`` is bench's standing
    baseline (the staged bridge, as ``"auto"`` resolved on the chip the
    bench was written for, since the reference refuses async pushes
    through its callback bridge), ``tiered-f32`` / ``tiered-int8`` its
    tiered A/B arm, ``hbm`` the HBM-staged layer at the tiered arm's
    device budget, ``device`` the on-card table."""
    from hetu_tpu_torch.models.ctr import CTRConfig
    common = dict(vocab=26000, embed_dim=16, mlp_hidden=256,
                  host_optimizer="adagrad", host_lr=0.05)
    if arm == "host":
        return CTRConfig(embedding="host", cache_capacity=65536,
                         cache_policy="lfuopt", host_async_push=True,
                         host_bridge="staged", **common)
    if arm.startswith("tiered"):
        return CTRConfig(embedding="tiered", cache_capacity=8192,
                         host_cache_capacity=65536, cache_policy="lfuopt",
                         storage=arm.split("-")[1], pull_bound=2,
                         promote_touches=2, demote_idle=0, **common)
    if arm == "hbm":
        return CTRConfig(embedding="hbm", cache_capacity=8192, pull_bound=2,
                         **common)
    return CTRConfig(embedding="device", **common)


def ctr_data():
    from hetu_tpu_torch.data import synthetic_ctr
    data = synthetic_ctr(n=CTR_N, vocab_per_field=CTR_VOCAB_PER_FIELD)
    return data, {k: torch.from_numpy(v).cuda() for k, v in data.items()}


def ctr_trainer(model):
    from hetu_tpu_torch.exec import Trainer
    from hetu_tpu_torch.optim import AdamOptimizer
    return Trainer(model, AdamOptimizer(1e-3),
                   lambda m, b, k: m.loss(b["dense"], b["sparse"],
                                          b["label"]))


def ctr_batch(data, dev, i):
    lo = (i * CTR_BATCH) % (CTR_N - CTR_BATCH)
    return (data["sparse"][lo:lo + CTR_BATCH],
            {k: v[lo:lo + CTR_BATCH] for k, v in dev.items()})


def ctr_flush(trainer):
    for m in trainer.staged_modules():
        if getattr(m, "async_push", False):
            m.flush_pushes()


def ctr_step0(data, dev):
    """(b): the bench model on the card against the same model on the
    CPU (dense weights from one seeded generator, host tables from one
    engine seed, the same batch): the loss, every dense gradient and the
    staged rows' gradient, then the host rows after one push."""
    from hetu_tpu_torch.models.ctr import WideDeep, make_embedding
    cfg = ctr_config("host")
    ids, b = ctr_batch(data, dev, 0)
    side = {}
    for where in ("cuda", "cpu"):
        m = WideDeep(cfg, device=where,
                     generator=torch.Generator().manual_seed(0))
        m.embed.stage(ids)
        bb = {k: v.to(where) for k, v in b.items()}
        loss = m.loss(bb["dense"], bb["sparse"], bb["label"])[0]
        loss.backward()
        side[where] = (m, loss.detach().cpu())
    (gm, gl), (cm, cl) = side["cuda"], side["cpu"]
    rel = abs(float(gl) - float(cl)) / abs(float(cl))
    print(f"step 0: loss card {float(gl):.7f} cpu {float(cl):.7f}, "
          f"relative error {rel:.3e} (limit 1e-5)")
    assert rel <= 1e-5
    worst = 0.0
    named = {**{n: p.grad for n, p in gm.named_parameters()},
             "embed.rows": gm.embed.rows.grad}
    ref = {**{n: p.grad for n, p in cm.named_parameters()},
           "embed.rows": cm.embed.rows.grad}
    for n, g in named.items():
        err = (g.cpu() - ref[n]).abs().max().item()
        scale = ref[n].abs().max().item()
        worst = max(worst, err / scale)
        assert err <= CTR_STEP0_TOL * scale, (n, err, scale)
    print(f"step 0: {len(named)} gradients (dense, and the pushed rows') "
          f"within {worst:.3e} of their max (limit {CTR_STEP0_TOL})")
    g_card = gm.embed.rows.grad.cpu()
    g_cpu = cm.embed.rows.grad
    for m in (gm, cm):
        m.embed.push_grads(m.embed.rows.grad)
        m.embed.flush_pushes()
    # the push path alone, exactly: the card's gradient pushed on the host
    oracle = make_embedding(cfg, device="cpu")
    oracle.stage(ids)
    oracle.push_grads(g_card)
    oracle.flush_pushes()
    touched = np.unique(ids)
    card_rows = gm.embed.table.pull(touched)
    assert np.array_equal(card_rows, oracle.table.pull(touched)), \
        "the async push from the card did not apply its gradient exactly"
    cpu_rows = cm.embed.table.pull(touched)
    # elements whose every occurrence's gradient is at least 1e-3 of the
    # largest: AdaGrad's step is g / sqrt(sum g^2), so a tiny gradient's
    # step follows its sign and is not a measure of agreement
    g = g_cpu.numpy().reshape(-1, g_cpu.shape[-1])
    flat = ids.ravel()
    big = np.abs(g) >= 1e-3 * np.abs(g).max()
    order = np.searchsorted(touched, flat)
    all_big = np.ones((touched.size, g.shape[1]), bool)
    np.logical_and.at(all_big, order, big)
    diff = np.abs(card_rows - cpu_rows)
    print(f"after one push: card rows == the card's gradient pushed on the "
          f"host (bitwise, {touched.size} rows); card vs CPU rows max "
          f"{diff[all_big].max():.3e} where every |g| >= 1e-3 of the max "
          f"(limit {CTR_ROWS_TOL}, {all_big.mean():.1%} of elements), "
          f"{diff.max():.3e} over all")
    assert diff[all_big].max() <= CTR_ROWS_TOL


def ctr_train_steps(model, data, dev, n, after_step=None):
    trainer = ctr_trainer(model)
    losses = []
    for i in range(n):
        ids, b = ctr_batch(data, dev, i)
        for m in trainer.staged_modules():
            m.stage(ids)
        losses.append(trainer.step(b)["loss"])
        if after_step is not None:
            after_step(trainer)
    return trainer, torch.stack(losses).cpu()


def ctr_hbm_oracle(data, dev):
    """(c): ``embedding="hbm"`` at ``pull_bound=0`` trains bitwise as the
    staged layer does (the reference's oracle, tests/test_embed_hbm.py):
    5 steps, the losses and the host tables."""
    from hetu_tpu_torch.models.ctr import CTRConfig, WideDeep
    common = dict(vocab=26000, embed_dim=16, host_optimizer="adagrad",
                  host_lr=0.05)
    runs = {}
    for arm, cfg in (
            ("staged", CTRConfig(embedding="host", host_bridge="staged",
                                 **common)),
            ("hbm", CTRConfig(embedding="hbm", cache_capacity=8192,
                              pull_bound=0, **common))):
        model = WideDeep(cfg, generator=torch.Generator().manual_seed(0))
        tr, losses = ctr_train_steps(model, data, dev, 5)
        runs[arm] = (losses, model.embed.table.pull(np.arange(26000)), tr)
    (sl, st, _), (hl, ht, htr) = runs["staged"], runs["hbm"]
    hs = htr.staged_modules()[0].hit_stats()
    print(f"hbm oracle: 5 steps, losses {[f'{x:.6f}' for x in hl.tolist()]}"
          f"; equal to the staged layer's bitwise: losses "
          f"{torch.equal(sl, hl)}, host table {np.array_equal(st, ht)} "
          f"(hbm: {hs['overflows']} overflow rows, {hs['evictions']} "
          f"evictions)")
    assert torch.equal(sl, hl) and np.array_equal(st, ht)


CTR_SLEEP_CYCLES = 50_000_000   # about 25 ms of the card's clock


def ctr_async_push(data, dev):
    """(d): 5 steps of the bench config with ``flush_pushes()`` after
    each, bitwise equal to the same steps with synchronous pushes.  The
    step is host-bound, so the card is idle when a push's copy is queued
    and the copy lands before the worker thread wakes: in both async arms
    the stream is first held busy for about 25 ms (``torch.cuda._sleep``)
    before each push, so the copy lands late.  The arm with the event
    wait must still equal the synchronous pushes; the control, whose
    worker reads the pinned buffer without waiting, must differ."""
    from hetu_tpu_torch.embed import layer as layer_mod
    from hetu_tpu_torch.models.ctr import WideDeep
    tables = {}
    for arm in ("sync", "async", "control"):
        cfg = ctr_config("host")
        if arm == "sync":
            cfg.host_async_push = False
        model = WideDeep(cfg, generator=torch.Generator().manual_seed(0))
        if arm != "sync":
            def late_push(g, orig=model.embed.push_grads):
                torch.cuda._sleep(CTR_SLEEP_CYCLES)
                orig(g)
            model.embed.push_grads = late_push
        ready = layer_mod._ready
        if arm == "control":
            layer_mod._ready = lambda event: None
        try:
            ctr_train_steps(model, data, dev, 5, after_step=ctr_flush)
        finally:
            layer_mod._ready = ready
        tables[arm] = model.embed.table.pull(np.arange(26000))
    same = np.array_equal(tables["sync"], tables["async"])
    differ = int((tables["control"] != tables["sync"]).sum())
    print(f"async push (each copy queued behind a 25 ms sleep): 5 steps "
          f"with a flush after each equal the synchronous pushes bitwise: "
          f"{same}; the control without the event wait differs in "
          f"{differ} of {tables['sync'].size} table elements")
    assert same, "async pushes changed the host table"
    assert differ > 0, "the control read its buffers after the copies landed"


def ctr_run(arm, data, dev, card):
    """(e)/(f): one arm of the bench loop: the timed chunks, a falling
    loss and the AUC of the last batches, the median split of a step,
    the device-busy share of a profiled step, the caches' stats."""
    from hetu_tpu_torch.exec.metrics import auc_roc
    from hetu_tpu_torch.models.ctr import WideDeep
    model = WideDeep(ctr_config(arm),
                     generator=torch.Generator().manual_seed(0))
    trainer = ctr_trainer(model)
    staged = trainer.staged_modules()
    state = {"i": 0}
    seen = []

    def step():
        ids, b = ctr_batch(data, dev, state["i"])
        state["i"] += 1
        for m in staged:
            m.stage(ids)
        out = trainer.step(b)
        nxt, _ = ctr_batch(data, dev, state["i"])
        for m in staged:
            m.prefetch(nxt)
        seen.append((out["loss"], out["pred"], b["label"]))
        return out

    for _ in range(CTR_WARMUP):
        out = step()
    float(out["loss"])
    per = []
    for _ in range(CTR_REPS):
        t0 = time.perf_counter()
        for _ in range(CTR_CHUNK):
            out = step()
        float(out["loss"])
        per.append((time.perf_counter() - t0) / CTR_CHUNK)
    med, best = statistics.median(per), min(per)
    losses = torch.stack([s[0] for s in seen]).cpu()
    tail = seen[-5:]
    auc = auc_roc(torch.cat([s[1] for s in tail]).cpu().numpy(),
                  torch.cat([s[2] for s in tail]).cpu().numpy())
    first, last = float(losses[0]), float(losses[-CTR_CHUNK:].mean())
    print(f"wdl_ctr {arm}: median step {med * 1e3:.3f} ms (best "
          f"{best * 1e3:.3f}), {1 / med:.2f} steps/s, "
          f"{CTR_BATCH / med:.1f} samples/s over {CTR_REPS} x {CTR_CHUNK} "
          f"steps after {CTR_WARMUP}; loss {first:.4f} -> {last:.4f} (last "
          f"{CTR_CHUNK} mean), AUC of the last 5 batches {auc:.4f} "
          f"[{card}]")
    assert torch.isfinite(losses).all()
    assert last < first, f"{arm}: the loss did not fall"
    assert auc > CTR_AUC, f"{arm}: AUC {auc} not above {CTR_AUC}"

    # the split of a step, each part ended by a synchronize
    parts = {"stage": [], "device step": [], "push": [], "prefetch": []}
    pushes = []
    for m in staged:
        orig = m.push_grads

        def timed_push(g, orig=orig):
            torch.cuda.synchronize()
            t = time.perf_counter()
            orig(g)
            torch.cuda.synchronize()
            pushes.append(time.perf_counter() - t)
        m.push_grads = timed_push
    for _ in range(10):
        ids, b = ctr_batch(data, dev, state["i"])
        state["i"] += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m in staged:
            m.stage(ids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        del pushes[:]
        trainer.step(b)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        nxt, _ = ctr_batch(data, dev, state["i"])
        for m in staged:
            m.prefetch(nxt)
        t3 = time.perf_counter()
        parts["stage"].append(t1 - t0)
        parts["device step"].append(t2 - t1 - sum(pushes))
        parts["push"].append(sum(pushes))
        parts["prefetch"].append(t3 - t2)
    for m in staged:
        del m.push_grads
    ctr_flush(trainer)
    print(f"  split (median of 10 synchronized steps): " + ", ".join(
        f"{k} {statistics.median(v) * 1e3:.3f} ms"
        for k, v in parts.items()) + (" (the push's call on the training "
                                      "thread; the engine applies it on a "
                                      "worker)" if any(
                                          getattr(m, "async_push", False)
                                          for m in staged) else ""))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = device_spans(prof)
    busy = union_ms([sp[1:] for sp in spans]) if spans else None
    print("  profiled step: " + (
        "device time not measured (the profiler saw no device activity)"
        if busy is None else
        f"device busy {busy:.3f} ms in {len(spans)} device activities, "
        f"{busy / (med * 1e3):.1%} of the median step ({wall * 1e3:.3f} ms "
        f"under the profiler)"))
    for m in staged:
        if hasattr(m, "tier_stats"):
            ts = m.tier_stats()
            print(f"  tier_stats: hbm {ts['hbm']}; host {ts['host']}; ps "
                  f"{ts['ps']}; pull bytes a stage "
                  f"{ts['pull_bytes_per_stage']:.1f}")
            assert ts["hbm"]["promotions"] > 0 and ts["hbm"]["hits"] > 0
        if hasattr(m, "hit_stats"):
            print(f"  hit_stats: {m.hit_stats()}")
        if hasattr(m.store, "stats"):
            print(f"  host cache stats: {m.store.stats()}")
    ctr_flush(trainer)
    out = {"median_s": med, "best_s": best, "auc": auc, "busy_ms": busy,
           "split": {k: statistics.median(v) for k, v in parts.items()}}
    del trainer, model
    return out


def ctr_phase(card):
    """Phase 9: (a) the engine library, (b) the step-0 check against the
    CPU, (c) the HBM oracle, (d) the async push, (e)/(f) the training
    runs."""
    from hetu_tpu_torch.embed import engine
    t0 = time.perf_counter()
    path = engine.build()
    engine._load()
    print(f"embedding engine library {path} ready in "
          f"{time.perf_counter() - t0:.2f} s (g++ compile "
          f"{engine.build_seconds():.2f} s of it; flags "
          f"{' '.join(engine.CXX_FLAGS)})")
    data, dev = ctr_data()
    ctr_step0(data, dev)
    ctr_hbm_oracle(data, dev)
    ctr_async_push(data, dev)
    runs = {arm: ctr_run(arm, data, dev, card)
            for arm in ("host", "tiered-f32", "tiered-int8", "hbm",
                        "device")}
    print(f"wdl_ctr summary [{card}]: " + "; ".join(
        f"{arm} {1 / r['median_s']:.2f} steps/s "
        f"({CTR_BATCH / r['median_s']:.0f} samples/s)"
        for arm, r in runs.items()))
    torch.cuda.synchronize()
    return runs


# ---------------------------------------------------------------------------
# Phase 10: the MoE transformer LM of bench.py config 3
# ---------------------------------------------------------------------------

# bench.py bench_moe's config as written (dtype added where it is built)
MOE_CFG = dict(vocab_size=32000, hidden_size=1024, num_layers=4,
               num_heads=16, num_experts=8, top_k=1, capacity_factor=1.25,
               max_seq_len=256, log_routing_stats=True)
MOE_BATCH = 32
MOE_TOL = 1e-5          # fp32, TF32 off: y and aux, card vs CPU
MOE_GRAD_TOL = 1e-4     # step-0 gradients, of each one's largest value
MOE_MARGIN = 1e-6       # routing margins below this may flip
MOE_GATE_T = 8192
# bf16 limits, each a small multiple of its reading on the card and
# below what the model with expert 0's output dropped gives (PERF.md §6,
# PR 13: readings 2.4e-6, 1.43e-2 against the control's 0.115, 5.6e-6
# against 1.5e-3, 3.9e-2 against 0.96).  At a random init config 3's
# loss is about ln(V) whatever the blocks compute, so its logits carry
# the check.
MOE_ARM_LOSS_TOL = 2e-5     # (d) step-0 loss, flash arm vs materialized
MOE_LOGIT_TOL = 3e-2        # (d) step-0 logits, mean |diff| / mean |ref|
MOE_BERT_LOSS_TOL = 5e-5    # (f) BertMoE loss, card vs CPU
MOE_BERT_GRAD_TOL = 8e-2    # (f) gradients, of each one's largest value


def moe_routing_margin(gate, x):
    """[T] fp32: for each token, the smallest gap between a score that one
    of the gate's argmax choices took and the next score (inf for the hash
    gate, whose routing reads no scores), recomputed from the gate's own
    pieces (a copy of the port's tests' helper).  A token whose margin is
    within a rounding of 0 can route differently in another summation
    order; plans are compared without such tokens."""
    from hetu_tpu_torch.layers import moe
    if isinstance(gate, moe.TopKGate):
        choices = [(gate._probs(x), gate.k)]
    elif isinstance(gate, moe.KTop1Gate):
        pg = gate._pgates(x)
        choices = [(pg[:, i], 1) for i in range(gate.k)]
    elif isinstance(gate, moe.SAMGate):
        _, group_sum, _, masked = gate._grouped(x)
        choices = [(group_sum, 1), (masked, gate.k)]
    elif isinstance(gate, moe.BalanceGate):
        choices = [(gate._plan(x)[1], 1)]
    else:
        choices = []
    out = torch.full((x.shape[0],), math.inf, device=x.device)
    for scores, k in choices:
        if scores.shape[-1] <= k:
            continue
        top = scores.topk(k + 1, dim=-1).values
        out = torch.minimum(out, (top[:, :-1] - top[:, 1:]).amin(dim=-1))
    return out


@contextlib.contextmanager
def moe_drop_expert(model):
    """The control of the bf16 checks: expert 0's output zeroed in every
    ExpertMLP of ``model`` (its w2 and b2), restored on exit."""
    from hetu_tpu_torch.layers import moe
    saved = [(m, m.w2[0].detach().clone(), m.b2[0].detach().clone())
             for m in model.modules() if isinstance(m, moe.ExpertMLP)]
    assert saved
    with torch.no_grad():
        for m, _, _ in saved:
            m.w2[0].zero_()
            m.b2[0].zero_()
    try:
        yield
    finally:
        with torch.no_grad():
            for m, w2, b2 in saved:
                m.w2[0].copy_(w2)
                m.b2[0].copy_(b2)


def mean_rel(x, ref):
    """mean |x - ref| / mean |ref|, in fp32: a routing flip at a near tie
    moves a few tokens' rows, which a max would read as the whole error."""
    ref = ref.float()
    return ((x.float() - ref).abs().mean() / ref.abs().mean()).item()


def moe_gates(d, E):
    """The five gates as phase 10 (a) drives them."""
    from hetu_tpu_torch.layers import moe
    kw = dict(device="cpu")
    return {
        "topk": lambda g: moe.TopKGate(d, E, 1, capacity_factor=1.25,
                                       generator=g, **kw),
        "hash": lambda g: moe.HashGate(d, E),
        "ktop1": lambda g: moe.KTop1Gate(d, E, 2, capacity_factor=1.0,
                                         generator=g, **kw),
        "sam": lambda g: moe.SAMGate(d, E, 2, num_groups=4,
                                     capacity_factor=1.0, generator=g, **kw),
        "balance": lambda g: moe.BalanceGate(d, E, generator=g, **kw),
    }


def moe_plans_agree(card_plans, cpu_plans, margin):
    """Experts, slots and keeps of two plans equal, except tokens whose
    routing margin is under MOE_MARGIN and the experts such a token
    flipped.  Returns (near-tie count, flipped count, the mask of tokens
    whose routing is held equal)."""
    near = margin.cpu() < MOE_MARGIN
    flipped = torch.zeros_like(near)
    for (ce, *_), (pe, *_) in zip(card_plans, cpu_plans):
        diff = ce.cpu() != pe
        assert not (diff & ~near).any(), \
            "a token away from a near tie routed differently"
        flipped |= diff
    touched = set()
    for (ce, *_), (pe, *_) in zip(card_plans, cpu_plans):
        touched |= set(ce.cpu()[flipped].tolist()) | set(
            pe[flipped].tolist())
    ok = torch.ones_like(near)
    for (ce, *_), (pe, *_) in zip(card_plans, cpu_plans):
        for e in touched:
            ok &= (ce.cpu() != e) & (pe != e)
    for (ce, cs, ck, _), (pe, ps, pk, _) in zip(card_plans, cpu_plans):
        assert torch.equal(cs.cpu()[ok], ps[ok]), "slots differ"
        assert torch.equal(ck.cpu()[ok], pk[ok]), "keeps differ"
    return int(near.sum()), int(flipped.sum()), ok


def moe_gate_check(card):
    """(a) each gate driving a MoELayer at d=1024, E=8, T=8192, fp32: the
    card against the port on the CPU, same weights and tokens."""
    from hetu_tpu_torch.layers import moe
    d, E, T = MOE_CFG["hidden_size"], MOE_CFG["num_experts"], MOE_GATE_T
    x = torch.randn((T, d), generator=torch.Generator().manual_seed(10))
    xc = x.cuda()
    for i, (name, make) in enumerate(moe_gates(d, E).items()):
        g = torch.Generator().manual_seed(100 + i)
        cpu = moe.MoELayer(make(g), moe.ExpertMLP(E, d, 4 * d, generator=g,
                                                  device="cpu"))
        dev = copy.deepcopy(cpu).cuda()
        with torch.no_grad():
            y, aux = cpu(x)
            yc, auxc = dev(xc)
            plans, C, _ = cpu.gate.index_plan(x)
            cplans, cC, _ = dev.gate.index_plan(xc)
            margin = moe_routing_margin(dev.gate, xc)
        torch.cuda.synchronize()
        assert C == cC
        near, flipped, ok = moe_plans_agree(cplans, plans, margin)
        dropped = sum(int((~kp).sum()) for _, _, kp, _ in plans)
        y_err = ((yc.cpu() - y)[ok].abs().max()
                 / y[ok].abs().max()).item()
        a_err = abs(float(auxc) - float(aux)) / max(abs(float(aux)), 1e-30)
        print(f"moe gate {name}: C {C}, dropped {dropped} of "
              f"{T * len(plans)} assignments; plans equal, {near} tokens "
              f"excluded as near ties (margin < {MOE_MARGIN:g}), {flipped} "
              f"flipped; y relative error {y_err:.3e}, aux {float(auxc):.6f}"
              f" relative error {a_err:.3e} (tol {MOE_TOL:g}), {card}")
        assert y_err <= MOE_TOL and a_err <= MOE_TOL, (name, y_err, a_err)
        assert torch.isfinite(yc).all()
        del cpu, dev, y, yc


def moe_ep_check(card):
    """(b) ep=4 on the local mesh at capacity factor 8 against four
    single-group calls on the token shards, on the card."""
    from hetu_tpu_torch.layers import moe
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    d, E, T = MOE_CFG["hidden_size"], MOE_CFG["num_experts"], MOE_GATE_T
    g = torch.Generator().manual_seed(11)
    gate = moe.TopKGate(d, E, 2, capacity_factor=8.0, generator=g)
    experts = moe.ExpertMLP(E, d, 4 * d, generator=g)
    ep = moe.MoELayer(gate, experts, mesh=make_mesh(MeshSpec(ep=4)))
    one = moe.MoELayer(gate, experts)
    x = torch.randn((T, d), generator=g).cuda()
    with torch.no_grad():
        y, (aux, stats) = ep(x, with_stats=True)
        parts = [one(s, with_stats=True) for s in x.chunk(4)]
    torch.cuda.synchronize()
    ref = torch.cat([p[0] for p in parts])
    ref_aux = sum(p[1][0] for p in parts) / 4
    y_err = ((y - ref).abs().max() / ref.abs().max()).item()
    a_err = abs(float(aux) - float(ref_aux)) / abs(float(ref_aux))
    print(f"moe ep=4 (local mesh, capacity factor 8, top-2, T {T}): y "
          f"relative error {y_err:.3e}, aux relative error {a_err:.3e} "
          f"against four single-group calls (tol {MOE_TOL:g}); overflow "
          f"{float(stats['overflow_frac']):.4f}, {card}")
    assert y_err <= MOE_TOL and a_err <= MOE_TOL
    assert float(stats["overflow_frac"]) == 0.0


def moe_step0_check(card):
    """(c) step 0 of a 2-layer MoELM at config 3's width, fp32, 4 x 256:
    the card against the CPU, and two backwards on the card bitwise."""
    from hetu_tpu_torch import MoELM, MoELMConfig
    cfg = MoELMConfig(**{**MOE_CFG, "num_layers": 2})
    cpu = MoELM(cfg, device="cpu",
                generator=torch.Generator().manual_seed(12))
    dev = copy.deepcopy(cpu).cuda()
    ids = torch.from_numpy(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (4, cfg.max_seq_len)))

    def grads_of(m, batch):
        m.zero_grad(set_to_none=True)
        loss, metrics = m.loss(batch)
        loss.backward()
        return loss.detach(), metrics, {
            n: p.grad.clone() for n, p in m.named_parameters()}

    t0 = time.monotonic()
    c_loss, c_met, c_grads = grads_of(cpu, ids)
    cpu_s = time.monotonic() - t0
    d_loss, d_met, d_grads = grads_of(dev, ids.cuda())
    _, _, again = grads_of(dev, ids.cuda())
    torch.cuda.synchronize()
    lrel = abs(float(d_loss) - float(c_loss)) / abs(float(c_loss))
    worst = max((((d_grads[n].cpu() - g).abs().max()
                  / g.abs().max().clamp_min(1e-30)).item(), n)
                for n, g in c_grads.items())
    same = all(torch.equal(d_grads[n], again[n]) for n in d_grads)
    print(f"moe step 0 (2 layers at config 3's width, fp32, 4 x 256): loss "
          f"card {float(d_loss):.6f} CPU {float(c_loss):.6f}, relative "
          f"difference {lrel:.3e} (tol {MOE_TOL:g}); worst gradient "
          f"{worst[1]}: max |diff| / max |CPU| {worst[0]:.3e} (tol "
          f"{MOE_GRAD_TOL:g}); overflow card "
          f"{float(d_met['overflow_frac']):.4f} CPU "
          f"{float(c_met['overflow_frac']):.4f}; two backwards on the card "
          f"bitwise equal: {same} (CPU step {cpu_s:.1f} s), {card}")
    assert lrel <= MOE_TOL and worst[0] <= MOE_GRAD_TOL
    assert same, "the MoE step-0 gradients are not bitwise repeatable"


# Labels of the profiled MoE step: (class or module, attribute, group).
# A kernel goes to the innermost labelled range around the op that
# launched it; a backward kernel to the group of the forward op whose
# autograd node launched it (the profiler's sequence numbers).
MOE_GROUP_MARK = "moe_group::"


def moe_labels():
    from hetu_tpu_torch.layers import moe
    from hetu_tpu_torch.layers.attention import MultiHeadAttention
    from hetu_tpu_torch.models import moe_lm
    from hetu_tpu_torch.optim import AdamOptimizer
    return ((moe.TopKGate, "index_plan", "gate"),
            (moe.MoELayer, "_route_in", "dispatch scatter"),
            (moe.ExpertMLP, "forward", "experts"),
            (moe.MoELayer, "_route_out", "combine"),
            (MultiHeadAttention, "forward", "attention"),
            (moe_lm.MoELM, "_head", "LM head + CE"),
            (moe_lm, "softmax_cross_entropy_sparse", "LM head + CE"),
            (AdamOptimizer, "update", "Adam"))


def moe_label_calls():
    """Wrap each labelled call in a profiler range; returns the undo."""
    undo = []
    for owner, attr, group in moe_labels():
        orig = getattr(owner, attr)

        def wrapped(*a, _orig=orig, _name=MOE_GROUP_MARK + group, **k):
            with torch.profiler.record_function(_name):
                return _orig(*a, **k)

        setattr(owner, attr, wrapped)
        undo.append((owner, attr, orig))
    return lambda: [setattr(o, a, f) for o, a, f in undo]


def moe_group_of(evt, seq_groups):
    """The group of a CPU event: its innermost labelled range, or for an
    autograd node, the group of its forward op."""
    e = evt
    while e is not None:
        if e.name.startswith(MOE_GROUP_MARK):
            return e.name[len(MOE_GROUP_MARK):]
        if re.search(r"Backward\d*$", e.name) and e.sequence_nr in seq_groups:
            return seq_groups[e.sequence_nr]
        e = e.cpu_parent
    return None


def profile_grouped(name, step, med, group, mark):
    """One profiled call of ``step``: its device activities, the device's
    busy time against the profiled step's wall time and the median bare
    step ``med``, the ten largest kernels (the ranges named ``mark``...
    left out), and the kernels' device time by the parts that
    ``group(cpu_ops) -> {part: (ms, launches)}`` assigns them."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    spans = device_spans(prof)
    if not spans:
        print(f"{name} step device time: not measured (the profiler saw no "
              f"device activity)")
        return None
    cuda = torch.autograd.DeviceType.CUDA
    cpu_ops = [e for e in prof.events() if e.device_type != cuda]
    busy = union_ms([sp[1:] for sp in spans])
    print(f"  profiled step: {len(spans)} device activities, wall "
          f"{wall * 1e3:.3f} ms under the profiler, device busy "
          f"{busy:.3f} ms ({busy / (wall * 1e3):.1%} of it; the median "
          f"bare step is {med * 1e3:.3f} ms)")
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and not e.key.startswith(mark)]
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"  {us / 1e3:9.3f} ms  {n:5d} launches  {key[:90]}")
    groups = group(cpu_ops)
    print("  device time by part (kernel durations summed; launches): "
          + "; ".join(f"{g} {t:.3f} ms ({c})" for g, (t, c) in
                      sorted(groups.items(), key=lambda kv: -kv[1][0])))
    return {"launches": len(spans), "busy_ms": busy, "wall_ms": wall * 1e3,
            "groups": {g: t for g, (t, _) in groups.items()}}


def moe_groups(cpu_ops):
    """The kernels' device time and launches by ``moe_labels`` group."""
    seq_groups = {}
    for e in cpu_ops:
        if e.sequence_nr >= 0 and not re.search(r"Backward\d*$", e.name):
            g = moe_group_of(e, {})
            if g is not None:
                seq_groups.setdefault(e.sequence_nr, g)
    groups = {}
    for e in cpu_ops:
        if not e.kernels:
            continue
        g = moe_group_of(e, seq_groups) or \
            "other (embeddings, LN, residuals, stats, copies)"
        t, c = groups.get(g, (0.0, 0))
        groups[g] = (t + sum(k.duration for k in e.kernels) / 1e3,
                     c + len(e.kernels))
    return groups


def moe_profile(step, med):
    """One profiled MoE step, its kernels grouped by ``moe_labels``."""
    undo = moe_label_calls()
    try:
        return profile_grouped("moe", step, med, moe_groups,
                               MOE_GROUP_MARK)
    finally:
        undo()


def moe_arm(fl, arm, card, warmup=3, timed=10):
    """(d) config 3 as written, one arm: 3 warm-up and 10 timed Adam
    steps on bench's batch, launch counters read per step, then one
    profiled step.  Before the counters are reset, the step-0 logits (on
    the host) and, in the materialized arm, the control: those logits
    with expert 0's output dropped, as ``mean_rel`` reads them.  Returns
    (step-0 loss, flash launches, the arm's readings)."""
    from hetu_tpu_torch import (AdamOptimizer, MoELM, MoELMConfig, Trainer,
                                flash_attn_fn)
    cfg = MoELMConfig(**MOE_CFG, dtype=torch.bfloat16)
    attn = flash_attn_fn(native_layout=True) if arm == "flash" else None
    held = torch.cuda.memory_allocated()
    model = MoELM(cfg, attn_fn=attn,
                  generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, AdamOptimizer(1e-4),
                      lambda m, b, k: m.loss(b["ids"], training=True))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_BATCH, cfg.max_seq_len))).cuda()
    batch = {"ids": ids}
    want = (cfg.num_layers, cfg.num_layers) if arm == "flash" else (0, 0)
    losses, auxes, step_s, metrics = [], [], [], None
    control = None
    with torch.no_grad():
        logits0 = model(ids, training=True)[0]
        if arm == "materialized":
            with moe_drop_expert(model):
                control = mean_rel(model(ids, training=True)[0], logits0)
        logits0 = logits0.cpu()
    torch.cuda.synchronize()
    fl.reset_launch_count()
    for i in range(warmup + timed):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        before = (fl.fwd_launch_count(), fl.bwd_launch_count())
        t0 = time.monotonic()
        metrics = trainer.step(batch)
        torch.cuda.synchronize()
        if i >= warmup:
            step_s.append(time.monotonic() - t0)
        delta = (fl.fwd_launch_count() - before[0],
                 fl.bwd_launch_count() - before[1])
        assert delta == want, f"{arm}: flash launches a step {delta}"
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux"]))
    launches = fl.fwd_launch_count(), fl.bwd_launch_count()
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_s)
    tokens = ids.numel()
    print(f"moe {arm}: losses {[round(x, 5) for x in losses]}; aux "
          f"{[round(x, 5) for x in auxes]}; flash launches {launches} "
          f"({want[0]} + {want[1]} a step); median step {med * 1e3:.3f} ms "
          f"(timed steps {[round(s * 1e3, 3) for s in step_s]} ms), "
          f"{MOE_BATCH / med:.2f} samples/s, {tokens / med:.1f} tokens/s, "
          f"peak memory {peak} bytes ({peak / 2**30:.3f} GiB; "
          f"{(peak - held) / 2**30:.3f} GiB above the {held} bytes held "
          f"before the model was built); last step "
          f"overflow_frac {float(metrics['overflow_frac']):.4f} load_entropy"
          f" {float(metrics['load_entropy']):.4f}; {card}")
    assert all(np.isfinite(losses)) and all(np.isfinite(auxes))
    prof = moe_profile(lambda: trainer.step(batch), med)
    del trainer, model
    torch.cuda.empty_cache()
    return losses[0], launches, {"median_ms": med * 1e3,
                                 "peak": peak - held,
                                 "profile": prof, "logits0": logits0,
                                 "control": control}


def moe_bert_check(card):
    """(f) BertMoEForPreTraining, 2 layers at BERT-base width, E=8, top-2,
    bf16, dropout 0.1, one key, 2 x 128: step 0 on the card against the
    CPU, the loss and every gradient (of its largest value), with the
    control (expert 0's output dropped on the card) failing the gradient
    limit; and the card's gradients bitwise repeatable."""
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.models import BertMoEForPreTraining, bert_base
    cfg = bert_base(num_layers=2, dtype=torch.bfloat16)
    cpu = BertMoEForPreTraining(cfg, num_experts=8, top_k=2, device="cpu",
                                generator=torch.Generator().manual_seed(13))
    dev = copy.deepcopy(cpu).cuda()
    batch = bert_batch(cfg.vocab_size, 2, 128, seed=13)
    key = prng.key(13)

    def grads_of(m, b):
        ids, mlm, nsp = b
        m.zero_grad(set_to_none=True)
        loss, met = m.loss(ids, None, None, mlm, nsp, key=key)
        loss.backward()
        return loss.detach(), met, {n: p.grad.clone()
                                    for n, p in m.named_parameters()
                                    if p.grad is not None}

    def worst_grad(grads, ref):
        assert sorted(grads) == sorted(ref)
        return max((((grads[n].cpu().float() - g.float()).abs().max()
                     / g.float().abs().max().clamp_min(1e-30)).item(), n)
                   for n, g in ref.items())

    c_loss, _, c_grads = grads_of(cpu, tuple(t.cpu() for t in batch))
    d_loss, d_met, d_grads = grads_of(dev, batch)
    _, _, again = grads_of(dev, batch)
    with moe_drop_expert(dev):
        x_loss, _, x_grads = grads_of(dev, batch)
    torch.cuda.synchronize()
    lrel = abs(float(d_loss) - float(c_loss)) / abs(float(c_loss))
    xrel = abs(float(x_loss) - float(c_loss)) / abs(float(c_loss))
    worst, ctrl = worst_grad(d_grads, c_grads), worst_grad(x_grads, c_grads)
    same = sorted(d_grads) == sorted(again) and all(
        torch.equal(d_grads[n], again[n]) for n in d_grads)
    print(f"BertMoEForPreTraining (2 layers, hidden 768, E 8, top-2, bf16, "
          f"dropout 0.1, 2 x 128): loss card {float(d_loss):.5f} CPU "
          f"{float(c_loss):.5f}, relative difference {lrel:.3e} (tol "
          f"{MOE_BERT_LOSS_TOL:g}); worst gradient {worst[1]}: max |diff| / "
          f"max |CPU| {worst[0]:.3e} (tol {MOE_BERT_GRAD_TOL:g}); control, "
          f"expert 0's output dropped on the card: loss relative difference "
          f"{xrel:.3e}, worst gradient {ctrl[1]} {ctrl[0]:.3e} (each must "
          f"exceed its tol); "
          f"moe_aux {d_met['moe_aux'].item():.5f}; gradients bitwise "
          f"repeatable on the card: {same}, {card}")
    assert lrel <= MOE_BERT_LOSS_TOL < xrel and np.isfinite(float(d_loss))
    assert worst[0] <= MOE_BERT_GRAD_TOL < ctrl[0]
    assert same, "the BertMoE gradients are not bitwise repeatable"


def moe_phase(fl, card):
    """Phase 10: the MoE LM of bench.py config 3, (a)-(f).  Returns the
    flash arm's launches and the flash pair's rows at its shape."""
    t0 = time.monotonic()
    moe_gate_check(card)
    moe_ep_check(card)
    moe_step0_check(card)
    torch.cuda.empty_cache()
    print(f"moe checks (a)-(c) in {time.monotonic() - t0:.1f} s")
    loss0, _, plain = moe_arm(fl, "materialized", card)
    flash0, launches, flash = moe_arm(fl, "flash", card)
    rel = abs(flash0 - loss0) / abs(loss0)
    lerr = mean_rel(flash.pop("logits0").cuda(), plain.pop("logits0").cuda())
    ctrl = plain["control"]
    print(f"moe step 0: loss flash arm {flash0:.6f}, materialized "
          f"{loss0:.6f}, relative difference {rel:.3e} (tol "
          f"{MOE_ARM_LOSS_TOL:g}); logits mean |diff| / mean |materialized| "
          f"{lerr:.3e} (tol {MOE_LOGIT_TOL:g}); control, the materialized "
          f"logits with expert 0's output dropped: {ctrl:.3e} (must exceed "
          f"the tol); median step flash {flash['median_ms']:.3f} ms, "
          f"materialized {plain['median_ms']:.3f} ms")
    assert rel <= MOE_ARM_LOSS_TOL and lerr <= MOE_LOGIT_TOL < ctrl
    torch.cuda.empty_cache()
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = check_flash(fl, flush, torch.bfloat16, MOE_CFG["max_seq_len"],
                       torch.Generator().manual_seed(14), timed=True,
                       B=MOE_BATCH, H=MOE_CFG["num_heads"], causal=True)
    del flush
    torch.cuda.empty_cache()
    moe_bert_check(card)
    print(f"phase 10 in {time.monotonic() - t0:.1f} s")
    return {"flash_fwd": launches[0], "flash_bwd": launches[1]}, rows


# ---------------------------------------------------------------------------
# Phase 11: the vision family (bench.py config 1, ViT-B/16, Swin-T)
# ---------------------------------------------------------------------------

VISION_LOSS_TOL = 1e-5      # fp32 step-0 loss, card vs CPU, relative
VISION_GRAD_TOL = 1e-4      # fp32 step-0 gradients, of each one's max
VISION_GRAD64_TOL = 1e-5    # the same in float64 (the loss itself fp32)
# ResNet-18's fp32 step-0 gradients, card vs CPU, of each one's max: a
# reading of 0.093 (relu flips, see vision_step0)
VISION_GRAD32_TOL = 0.5
VISION_LOGIT_TOL = 1e-4     # fp32 step-0 logits, max |diff| / max |CPU|
# ResNet: 20 timed steps; the loss is read over 60 (at lr 0.1 without
# warm-up it first rises for some steps)
RESNET_BATCH, RESNET_STEPS, RESNET_TOTAL = 128, 20, 60
VIT_BATCH, SWIN_BATCH, CNN_BATCH = 64, 64, 128
VISION_WARMUP, VISION_TIMED = 3, 10
VISION_MARK = "vision::"
VISION_MARKS = (VISION_MARK + "forward", VISION_MARK + "update")


def _step0_readings(model, batch, loss_fn):
    """The loss, logits, gradients and running statistics of one step 0,
    on the host."""
    model.zero_grad(set_to_none=True)
    loss, logits = loss_fn(model, batch)
    loss.backward()
    out = (loss.detach().cpu(), logits.detach().cpu(),
           {n: p.grad.cpu() for n, p in model.named_parameters()},
           {n: t.cpu() for n, t in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))})
    model.zero_grad(set_to_none=True)
    return out


def f64(batch):
    """``batch`` with its floating tensors in float64."""
    return {k: v.double() if v.is_floating_point() else v
            for k, v in batch.items()}


def vision_step0(name, model, batch, loss_fn, grads_fp64=False):
    """The step-0 loss, logits, every gradient and, for BatchNorm models,
    the running statistics after the training forward: the model on the
    card against a copy on the CPU, same weights and batch, fp32.  With
    ``grads_fp64`` the gradients are held between float64 copies of the
    two (the fp32 ones are printed): a relu passes no gradient where its
    input is negative, and where an input lies within an fp32 rounding of
    0 the card's and the CPU's fp32 forwards can fall on its two sides,
    which moves the gradients of every layer below (ResNet-18 at batch 8:
    0.093 of a gradient's max on the CPU alone, fp32 against float64,
    and 0.014 on the card; card against CPU in fp32 0.093); float64
    forwards fall on the same side.  The fp32 gradients are then held only to
    ``VISION_GRAD32_TOL``, which a wrong convolution or a missing term
    (a gradient off by its whole size) still fails.  Returns the CPU's
    fp32 logits."""
    cpu = copy.deepcopy(model).cpu()
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    kl, klog, kg, kb = _step0_readings(model, batch, loss_fn)
    cl, clog, cg, cb = _step0_readings(cpu, cpu_batch, loss_fn)
    lrel = abs(float(kl) - float(cl)) / abs(float(cl))
    lg = rel_err(klog, clog)
    worst32 = max((rel_err(kg[n], g), n) for n, g in cg.items())
    stats = max((rel_err(kb[n], t) for n, t in cb.items()), default=0.0)
    tol = VISION_GRAD64_TOL if grads_fp64 else VISION_GRAD_TOL
    exact = ""
    if grads_fp64:
        kg32, cg32 = kg, cg
        kg = _step0_readings(copy.deepcopy(model).double(), f64(batch),
                             loss_fn)[2]
        cg = _step0_readings(cpu.double(), f64(cpu_batch), loss_fn)[2]
        card32 = max((rel_err(kg32[n], g), n) for n, g in cg.items())
        cpu32 = max((rel_err(cg32[n], g), n) for n, g in cg.items())
        exact = (f"; fp32 against the CPU's float64: card {card32[1]} "
                 f"{card32[0]:.3e}, CPU {cpu32[1]} {cpu32[0]:.3e}")
        assert worst32[0] <= VISION_GRAD32_TOL, worst32
    worst = max((rel_err(kg[n], g), n) for n, g in cg.items())
    print(f"{name} step 0, card vs CPU (fp32, TF32 off): loss "
          f"{float(kl):.6f} / {float(cl):.6f}, relative difference "
          f"{lrel:.3e} (tol {VISION_LOSS_TOL:g}); logits max |diff| / max "
          f"|CPU| {lg:.3e} (tol {VISION_LOGIT_TOL:g}); worst gradient "
          + (f"in float64 {worst[1]} {worst[0]:.3e} of its max (tol "
             f"{tol:g}; in fp32 {worst32[1]} {worst32[0]:.3e}, tol "
             f"{VISION_GRAD32_TOL:g}{exact})"
             if grads_fp64 else
             f"{worst[1]} {worst[0]:.3e} of its max (tol {tol:g})")
          + (f"; running statistics {stats:.3e} (tol "
             f"{VISION_LOSS_TOL:g})" if cb else ""))
    assert lrel <= VISION_LOSS_TOL and lg <= VISION_LOGIT_TOL, (lrel, lg)
    assert worst[0] <= tol and stats <= VISION_LOSS_TOL, (worst, stats)
    return clog


def resnet_steps_check(model, loss_fn, batches):
    """Three Momentum(0.1, 0.9) ``Trainer`` steps of ``model`` with
    ``loss_fn``, which hands the model back under ``aux["model"]``, over
    ``batches``: float64 copies on the card and on the CPU, the same
    weights.  The losses, every parameter, the velocity slots and the
    running statistics after the steps within ``VISION_GRAD64_TOL`` of
    each one's max.  In float64, as the step-0 gradients are held: in
    fp32 the two devices' relu flips move the gradients (see
    ``vision_step0``), and three steps at lr 0.1 carry that into every
    parameter."""
    from hetu_tpu_torch import MomentumOptimizer, Trainer
    from hetu_tpu_torch.interop import export_params
    card = copy.deepcopy(model).double()
    cpu = copy.deepcopy(model).cpu().double()
    out = []
    for m, dev in ((card, True), (cpu, False)):
        trainer = Trainer(m, MomentumOptimizer(0.1, momentum=0.9), loss_fn)
        losses = [float(trainer.step(f64(b) if dev else
                                     {k: v.cpu() for k, v in
                                      f64(b).items()})["loss"])
                  for b in batches]
        vel = {n: t.cpu() for n, t in trainer.opt_state["velocity"].items()}
        out.append((losses, export_params(m), vel))
    (kl, kp, kv), (cl, cp, cv) = out
    lrel = max(abs(a - b) / abs(b) for a, b in zip(kl, cl))
    worst = max((rel_err(torch.from_numpy(kp[n]), torch.from_numpy(a)), n)
                for n, a in cp.items())
    vworst = max((rel_err(kv[n], t), n) for n, t in cv.items())
    stats = sorted(n for n in cp if "running_" in n)
    start = export_params(model)
    moved = max(float(np.abs(cp[n] - start[n]).max()) for n in stats)
    print(f"resnet18 3 Momentum Trainer steps at batch 8, float64, card vs "
          f"CPU: losses {[round(a, 6) for a in kl]} / "
          f"{[round(b, 6) for b in cl]}, relative difference {lrel:.3e}; "
          f"worst of {len(cp)} parameters and running statistics "
          f"{worst[1]} {worst[0]:.3e} of its max, worst velocity "
          f"{vworst[1]} {vworst[0]:.3e} (tol {VISION_GRAD64_TOL:g}); the "
          f"running statistics moved by up to {moved:.3e}")
    assert len(stats) == 40 and moved > 0
    assert max(lrel, worst[0], vworst[0]) <= VISION_GRAD64_TOL, \
        (lrel, worst, vworst)


def vision_parts(cpu_ops):
    """The kernels' device time and launches in the forward and the
    optimizer update (``VISION_MARKS`` ranges) and the rest, the
    backward; prints the host time of each marked range."""
    marks = {m: [(e.time_range.start, e.time_range.end) for e in cpu_ops
                 if e.name == m] for m in VISION_MARKS}
    parts = {}
    for e in cpu_ops:
        if not e.kernels:
            continue
        t = e.time_range.start
        part = next((m[len(VISION_MARK):] for m, rs in marks.items()
                     if any(a <= t <= b for a, b in rs)), "backward")
        ms, n = parts.get(part, (0.0, 0))
        parts[part] = (ms + sum(k.duration for k in e.kernels) / 1e3,
                       n + len(e.kernels))
    print("  host ms under the profiler: " + "; ".join(
        f"{m[len(VISION_MARK):]} {sum(b - a for a, b in rs) / 1e3:.3f}"
        for m, rs in marks.items()))
    return parts


def vision_train(name, trainer, batches, warmup, timed, card,
                 flash=None, per_step=None, total=0, window=5):
    """``warmup`` + ``timed`` ``Trainer`` steps over ``batches`` (an
    iterator of device batches), then untimed ones up to ``total``: the
    median timed step (from the call for its batch, so a loader's host
    work and the copy it waits on count), samples/s, peak memory above what was held
    before, the losses (finite, and falling: the mean of the last
    ``window`` under the first ``window``'s), the flash launches a step
    when ``flash`` is given (``per_step`` of each), then one profiled
    step.  The forward and the update run under the profile's marks."""
    from torch.profiler import record_function
    update = trainer.optimizer.update
    loss_fn = trainer.loss_fn

    def marked_update(*a, **kw):
        with record_function(VISION_MARKS[1]):
            return update(*a, **kw)

    def marked_loss(*a, **kw):
        with record_function(VISION_MARKS[0]):
            return loss_fn(*a, **kw)

    trainer.optimizer.update = marked_update
    trainer.loss_fn = marked_loss
    held = torch.cuda.memory_allocated()
    losses, step_s = [], []
    batch = None
    if flash is not None:
        flash.reset_launch_count()
    for i in range(max(warmup + timed, total)):
        if i == warmup:
            torch.cuda.reset_peak_memory_stats()
        before = (flash.fwd_launch_count(), flash.bwd_launch_count()) \
            if flash is not None else None
        torch.cuda.synchronize()
        t0 = time.monotonic()
        batch = next(batches)
        losses.append(trainer.step(batch)["loss"])
        torch.cuda.synchronize()
        if warmup <= i < warmup + timed:
            step_s.append(time.monotonic() - t0)
        if flash is not None:
            delta = (flash.fwd_launch_count() - before[0],
                     flash.bwd_launch_count() - before[1])
            assert delta == (per_step, per_step), \
                f"{name}: flash launches a step {delta}"
    losses = [float(x) for x in losses]
    peak = torch.cuda.max_memory_allocated() - held
    med = statistics.median(step_s)
    n = len(next(iter(batch.values())))
    launches = ((flash.fwd_launch_count(), flash.bwd_launch_count())
                if flash is not None else None)
    print(f"{name}: {len(losses)} steps, losses "
          f"{[round(x, 5) for x in losses]}; median step "
          f"{med * 1e3:.3f} ms (timed steps "
          f"{[round(s * 1e3, 3) for s in step_s]} ms), {n / med:.2f} "
          f"samples/s, peak memory {peak} bytes ({peak / 2**30:.3f} GiB "
          f"above what was held before); "
          + (f"flash launches {launches} ({per_step} + {per_step} a step); "
             if flash is not None else "") + card)
    assert all(np.isfinite(losses)), losses
    assert (statistics.fmean(losses[-window:])
            < statistics.fmean(losses[:window])), \
        f"{name}: the loss did not fall"
    prof = profile_grouped(name, lambda: trainer.step(batch), med,
                           vision_parts, VISION_MARK)
    trainer.optimizer.update = update
    trainer.loss_fn = loss_fn
    return {"median_ms": med * 1e3, "samples_per_s": n / med,
            "peak": peak, "profile": prof, "launches": launches,
            "losses": losses}


def cls_loss(call):
    """``(model, batch) -> (loss, logits)``: the mean CE of the logits
    that ``call(model, images)`` gives."""
    from hetu_tpu_torch.ops import softmax_cross_entropy_sparse

    def loss(m, b):
        logits = call(m, b["x"])
        return softmax_cross_entropy_sparse(logits, b["y"]).mean(), logits

    return loss


def resnet_call(m, x):
    """ResNet's logits with its BatchNorms in training mode, as
    ``bench.py`` steps them."""
    return m(x, training=True)[0]


def train_call(m, x):
    return m(x, training=True)


def plain_call(m, x):
    return m(x)


def vision_batch(cfg, n, seed):
    """``n`` fp32 images of ``cfg``'s size and channels (standard normal)
    and labels over its classes, from ``default_rng(seed)``, on the
    card."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, cfg.image_size, cfg.image_size,
                             cfg.num_channels)).astype(np.float32)
    return {"x": torch.from_numpy(x).cuda(),
            "y": torch.from_numpy(rng.integers(0, cfg.num_classes,
                                               n)).cuda()}


def resnet_arm(card):
    """(a) ResNet-18 / CIFAR-10 as ``bench_resnet`` runs it: step 0 at
    batch 8 against the CPU (TF32 off) with the TF32 control, then 60
    Momentum steps (3 warm-up, 20 timed) over ``Dataloader(cifar10(),
    128, shuffle=True)`` with cuDNN's TF32 off and on."""
    from hetu_tpu_torch import (Dataloader, MomentumOptimizer, Trainer,
                                cifar10, resnet18)
    from hetu_tpu_torch.ops import softmax_cross_entropy_sparse

    def loss_fn(model, b, key):      # bench.py config 1's, as written
        logits, new_model = model(b["x"], training=True)
        loss = softmax_cross_entropy_sparse(logits, b["y"]).mean()
        return loss, {"model": new_model}

    x, y, _, _ = cifar10()
    print(f"cifar10(): {x.shape} {x.dtype} images, {y.shape} labels "
          f"(the synthetic fallback: no CIFAR-10 files in the checkout)")
    model = resnet18(num_classes=10,
                     generator=torch.Generator().manual_seed(0))
    n_par = sum(p.numel() for p in model.parameters())
    print(f"resnet18: {len(list(model.parameters()))} parameter tensors, "
          f"{n_par} parameters")
    small = {"x": torch.from_numpy(x[:8]).cuda(),
             "y": torch.from_numpy(y[:8]).cuda()}
    clog = vision_step0("resnet18 batch 8", model, small,
                        cls_loss(resnet_call), grads_fp64=True)
    resnet_steps_check(model, loss_fn, [
        {"x": torch.from_numpy(x[i:i + 8]).cuda(),
         "y": torch.from_numpy(y[i:i + 8]).cuda()} for i in (8, 16, 24)])
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            tlog = cls_loss(resnet_call)(copy.deepcopy(model),
                                         small)[1].cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    ctrl = rel_err(tlog, clog)
    print(f"resnet18 step 0 control, cuDNN TF32 on: logits max |diff| / "
          f"max |CPU| {ctrl:.3e} (must exceed tol {VISION_LOGIT_TOL:g})")
    assert ctrl > VISION_LOGIT_TOL, "the fp32 check cannot tell TF32"
    arms = {}
    for tf32_on in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32_on
        try:
            m = resnet18(num_classes=10,
                         generator=torch.Generator().manual_seed(0))
            trainer = Trainer(m, MomentumOptimizer(0.1, momentum=0.9),
                              loss_fn)
            dl = Dataloader({"x": x, "y": y}, RESNET_BATCH, shuffle=True)
            arms[tf32_on] = vision_train(
                f"resnet18 / cifar10, batch {RESNET_BATCH}, fp32, cuDNN "
                f"TF32 {'on' if tf32_on else 'off'}", trainer,
                iter(dl.prefetch()), VISION_WARMUP, RESNET_STEPS, card,
                total=RESNET_TOTAL)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        del trainer, m
        torch.cuda.empty_cache()
    off, on = arms[False], arms[True]
    print(f"resnet18 headline (cuDNN TF32 off, fp32 as the CPU check holds "
          f"it): {off['median_ms']:.3f} ms a step, "
          f"{off['samples_per_s']:.1f} samples/s; TF32 on (PyTorch's "
          f"default for convolutions): {on['median_ms']:.3f} ms, "
          f"{on['samples_per_s']:.1f} samples/s; {card}")
    return arms


def vit_arms(fl, card):
    """(b) ViT-B/16 at 224 px, bf16, batch 64, AdamW 1e-4: step 0 against
    the CPU in fp32 at batch 2 (flash on the card, the port's plain
    flash on the CPU), then the materialized and the flash arm, 3 + 10
    steps each, 12 flash forwards and backwards a step in the flash
    arm."""
    from hetu_tpu_torch import AdamWOptimizer, Trainer, ViT, flash_attn_fn
    from hetu_tpu_torch.models import vit_base
    cfg = vit_base(dtype=torch.bfloat16)
    small = vision_batch(cfg, 2, 3)
    fp32 = ViT(vit_base(), attn_fn=flash_attn_fn(native_layout=True),
               generator=torch.Generator().manual_seed(0))
    fl.reset_launch_count()
    vision_step0("vit_base flash, batch 2", fp32, small,
                 cls_loss(train_call))
    assert (fl.fwd_launch_count(), fl.bwd_launch_count()) == \
        (cfg.num_layers, cfg.num_layers)
    del fp32
    torch.cuda.empty_cache()
    big = vision_batch(cfg, VIT_BATCH, 4)
    x, y = big["x"].bfloat16(), big["y"]
    arms = {}
    for arm in ("materialized", "flash"):
        attn = flash_attn_fn(native_layout=True) if arm == "flash" else None
        model = ViT(cfg, attn_fn=attn,
                    generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, AdamWOptimizer(1e-4),
                          lambda m, b, k: m.loss(b["x"], b["y"]))
        fl.reset_launch_count()
        arms[arm] = vision_train(
            f"vit_base {arm}, batch {VIT_BATCH}, bf16", trainer,
            iter(lambda: {"x": x, "y": y}, None), VISION_WARMUP,
            VISION_TIMED, card, flash=fl,
            per_step=cfg.num_layers if arm == "flash" else 0)
        del trainer, model
        torch.cuda.empty_cache()
    print(f"vit_base: flash arm {arms['flash']['median_ms']:.3f} ms a step "
          f"against materialized {arms['materialized']['median_ms']:.3f} "
          f"ms; {card}")
    return arms


def swin_arm(card):
    """(c) Swin-T at 224 px, bf16, batch 64, AdamW 1e-4, the window
    attention materialized: step 0 against the CPU in fp32 at batch 2,
    then 3 + 10 steps."""
    from hetu_tpu_torch import AdamWOptimizer, Swin, Trainer, swin_tiny
    cfg = swin_tiny(dtype=torch.bfloat16)
    small = vision_batch(cfg, 2, 6)
    fp32 = Swin(swin_tiny(), generator=torch.Generator().manual_seed(0))
    vision_step0("swin_tiny, batch 2", fp32, small, cls_loss(train_call))
    del fp32
    big = vision_batch(cfg, SWIN_BATCH, 7)
    x, y = big["x"].bfloat16(), big["y"]
    model = Swin(cfg, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, AdamWOptimizer(1e-4),
                      lambda m, b, k: m.loss(b["x"], b["y"]))
    out = vision_train(f"swin_tiny, batch {SWIN_BATCH}, bf16", trainer,
                       iter(lambda: {"x": x, "y": y}, None), VISION_WARMUP,
                       VISION_TIMED, card)
    del trainer, model
    torch.cuda.empty_cache()
    return out


def small_cnn_arms(card):
    """(d) One Momentum step each of VGG-16 on ``cifar10()`` and LeNet on
    ``mnist()`` at batch 128, fp32: the step-0 loss and logits against
    the CPU (same weights, same batch), and the step's loss finite."""
    from hetu_tpu_torch import MomentumOptimizer, Trainer, cifar10, mnist
    from hetu_tpu_torch.models import LeNet, vgg16
    for name, make, data in (("vgg16", vgg16, cifar10),
                             ("lenet", LeNet, mnist)):
        x, y, _, _ = data()
        b = {"x": torch.from_numpy(x[:CNN_BATCH]).cuda(),
             "y": torch.from_numpy(y[:CNN_BATCH]).cuda()}
        model = make(generator=torch.Generator().manual_seed(0))
        cpu = copy.deepcopy(model).cpu()
        loss_of = cls_loss(plain_call)
        with torch.no_grad():
            kl, klog = loss_of(model, b)
            cl, clog = loss_of(cpu, {k: v.cpu() for k, v in b.items()})
        lrel = abs(float(kl) - float(cl)) / abs(float(cl))
        lg = rel_err(klog.cpu(), clog)
        trainer = Trainer(model, MomentumOptimizer(0.1, momentum=0.9),
                          lambda m, bb, k: (loss_of(m, bb)[0], {}))
        torch.cuda.synchronize()
        t0 = time.monotonic()
        loss = float(trainer.step(b)["loss"])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        print(f"{name} batch {CNN_BATCH} fp32: step-0 loss card "
              f"{float(kl):.6f} CPU {float(cl):.6f}, relative difference "
              f"{lrel:.3e} (tol "
              f"{VISION_LOSS_TOL:g}); logits {lg:.3e} (tol "
              f"{VISION_LOGIT_TOL:g}); one Momentum step {wall * 1e3:.3f} "
              f"ms (the first: allocation and cuDNN's choice included), "
              f"loss {loss:.6f}; {card}")
        assert lrel <= VISION_LOSS_TOL and lg <= VISION_LOGIT_TOL
        assert np.isfinite(loss)
        del trainer, model, cpu
        torch.cuda.empty_cache()


def vision_phase(fl, card):
    """Phase 11, (a)-(e).  Returns the ViT flash arm's launches and the
    flash pair's rows at ViT-B/16's shape."""
    t0 = time.monotonic()
    resnet = resnet_arm(card)
    vit = vit_arms(fl, card)
    swin = swin_arm(card)
    small_cnn_arms(card)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rows = check_flash(fl, flush, torch.bfloat16, 197,
                       torch.Generator().manual_seed(15), timed=True,
                       B=VIT_BATCH, H=12, causal=False)
    del flush
    torch.cuda.empty_cache()
    launches = vit["flash"]["launches"]
    print(f"phase 11 in {time.monotonic() - t0:.1f} s; ViT flash arm "
          f"launches {launches}; resnet18 {resnet[False]['median_ms']:.3f}"
          f" ms a step, swin_tiny {swin['median_ms']:.3f} ms")
    return {"flash_fwd": launches[0], "flash_bwd": launches[1]}, rows


# ---------------------------------------------------------------------------
# Phase 12: T5-base, the RNN classifiers and a 3-layer GCN at ogbn-arxiv's
# size.  No CUDA kernel of the port lies on these paths (T5 materialises
# its attention with the relative-position bias; the RNNs are a loop of
# products; the GCN a gather and an index_add): the phase checks the
# plain torch path on the card against the CPU and times it.
# ---------------------------------------------------------------------------

T5_BATCH, T5_ENC, T5_DEC = 32, 512, 114     # C4 span-corruption shapes
T5_CHECK_BATCH, T5_LR = 2, 1e-4
RNN_BATCH, RNN_HIDDEN, RNN_LR = 128, 128, 1e-3
# ogbn-arxiv: nodes, undirected edges, features, classes, train split
ARXIV_NODES, ARXIV_EDGES, ARXIV_FEATS, ARXIV_CLASSES = 169343, 1166243, 128, 40
ARXIV_TRAIN, GCN_HIDDEN, GCN_LR = 90941, 256, 0.01
P12_LOSS_TOL = 1e-5     # fp32 step-0 losses, card vs CPU, relative
P12_GRAD_TOL = 1e-4     # fp32 step-0 gradients, of each one's max
P12_GRAD64_TOL = 1e-5   # the same between float64 copies (T5)
# T5's fp32 step-0 gradients, card vs CPU, of each one's max: a reading
# of 0.090 (relu flips in the decoder's MLP, see step0_vs_cpu); its
# float64 copies read 2.8e-8
P12_GRAD32_TOL = 0.5
# parameters after 3 steps (the GCN's GCN_CPU_STEPS), card vs CPU,
# absolute: a tenth of one step.
# Readings: T5 (float64) 2.4e-7, LSTM 1.2e-6, GRU 2.7e-6, and the GCN
# 2.1e-5, whose index_add sums each node's messages with atomics on the
# card (in no fixed order; its step-0 gradients read 6.0e-7 of a max)
P12_STEP_TOL = {"t5": 0.1 * T5_LR, "rnn": 0.1 * RNN_LR, "gcn": 0.1 * GCN_LR}
# the GCN's steps held against the CPU (each about 15 s of the host): two
# move its parameters by about 2 * GCN_LR, twice the 10 * tol the check
# asks
GCN_CPU_STEPS = 2
P12_WARMUP, P12_TIMED, P12_WINDOW = 3, 5, 3


def _grads_of(model, batch, loss_of):
    """The loss and every gradient of one backward, on the host."""
    model.zero_grad(set_to_none=True)
    loss = loss_of(model, batch)
    loss.backward()
    out = (float(loss.detach()), {n: p.grad.cpu()
                                  for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    return out


def step0_vs_cpu(name, model, batch, loss_of, card, loss64=None):
    """The step-0 loss and every gradient of ``model`` on the card
    against a copy on the CPU, same weights, batch and key.  With
    ``loss64`` the gradients are held between float64 copies that take
    that loss (the fp32 ones only to ``P12_GRAD32_TOL``): a relu input
    within an fp32 rounding of 0 falls on its two sides on the two
    devices and moves the gradients below it (see ``vision_step0``).
    Returns the CPU copy."""
    cpu = copy.deepcopy(model).cpu()
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    kl, kg = _grads_of(model, batch, loss_of)
    cl, cg = _grads_of(cpu, cpu_batch, loss_of)
    lrel = abs(kl - cl) / abs(cl)
    worst = worst32 = max((rel_err(kg[n], g), n) for n, g in cg.items())
    tol = P12_GRAD_TOL
    if loss64 is not None:
        kg = _grads_of(copy.deepcopy(model).double(), f64(batch), loss64)[1]
        cg = _grads_of(copy.deepcopy(cpu).double(), f64(cpu_batch),
                       loss64)[1]
        worst = max((rel_err(kg[n], g), n) for n, g in cg.items())
        tol = P12_GRAD64_TOL
    print(f"{name} step 0, card vs CPU (fp32, TF32 off): loss {kl:.6f} / "
          f"{cl:.6f}, relative difference {lrel:.3e} (tol "
          f"{P12_LOSS_TOL:g}); worst of {len(cg)} gradients "
          + (f"in float64 {worst[1]} {worst[0]:.3e} of its max (tol "
             f"{tol:g}; in fp32 {worst32[1]} {worst32[0]:.3e}, tol "
             f"{P12_GRAD32_TOL:g})" if loss64 is not None else
             f"{worst[1]} {worst[0]:.3e} of its max (tol {tol:g})")
          + f"; {card}")
    assert lrel <= P12_LOSS_TOL and worst[0] <= tol, (lrel, worst)
    assert worst32[0] <= P12_GRAD32_TOL, worst32
    return cpu


def steps_vs_cpu(name, model, cpu, make_opt, loss_fn, batches, tol, card,
                 fp64=False):
    """Three ``Trainer`` steps of ``model`` on the card and of its CPU
    copy ``cpu`` over ``batches`` with the keys ``fold_in(key(1), i)``
    (with ``fp64`` on float64 copies of both, as ``resnet_steps_check``
    takes them): the losses (relative) and every parameter after the
    steps (absolute, ``tol``), with how far the parameters moved."""
    from hetu_tpu_torch import Trainer
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.interop import export_params
    start = export_params(cpu)
    if fp64:
        model = copy.deepcopy(model).double()
        cpu = copy.deepcopy(cpu).double()
        batches = [f64(b) for b in batches]
    runs = []
    for m, on_card in ((model, True), (cpu, False)):
        trainer = Trainer(m, make_opt(), loss_fn)
        losses = [float(trainer.step(
            b if on_card else {k: v.cpu() for k, v in b.items()},
            prng.fold_in(prng.key(1), i))["loss"])
            for i, b in enumerate(batches)]
        runs.append((losses, export_params(m)))
    (kl, kp), (cl, cp) = runs
    lrel = max(abs(a - b) / abs(b) for a, b in zip(kl, cl))
    worst = max((float(np.abs(kp[n] - a).max()), n) for n, a in cp.items())
    moved = max(float(np.abs(cp[n] - start[n]).max()) for n in cp)
    print(f"{name} {len(batches)} Trainer steps, card vs CPU "
          f"({'float64' if fp64 else 'fp32'}, TF32 off): losses {[round(a, 6) for a in kl]} / "
          f"{[round(b, 6) for b in cl]}, relative difference {lrel:.3e} "
          f"(tol {P12_LOSS_TOL:g}); worst parameter {worst[1]} "
          f"|diff| {worst[0]:.3e} (tol {tol:g}); the parameters moved by "
          f"up to {moved:.3e}; {card}")
    assert lrel <= P12_LOSS_TOL and worst[0] <= tol, (lrel, worst)
    assert moved > 10 * tol


def t5_batches(n, batch, seed):
    """``n`` batches of ``synthetic_lm`` sequences of T5_ENC tokens
    (T5's vocab) on the host; the targets are each input's first T5_DEC
    tokens (a copy task), the decoder inputs the targets shifted right
    behind token 0."""
    from hetu_tpu_torch import synthetic_lm
    ids = torch.from_numpy(synthetic_lm(n=n * batch, seq_len=T5_ENC,
                                        vocab=32128, seed=seed))
    labels = ids[:, :T5_DEC]
    dec = torch.cat([torch.zeros_like(labels[:, :1]), labels[:, :-1]], 1)
    return [{"ids": ids[i:i + batch], "dec": dec[i:i + batch],
             "labels": labels[i:i + batch]}
            for i in range(0, n * batch, batch)]


def t5_loss(m, b, k):
    return m.loss(b["ids"], b["dec"], b["labels"], key=k)


def t5_loss64(m, b, k):
    """``T5ForConditionalGeneration.loss``'s arithmetic with the cross
    entropy in the logits' own type: float64 for the float64 copies
    (``ops.losses`` takes it to fp32, as the reference does)."""
    logits = m(b["ids"], b["dec"], key=k, training=True)
    labels = b["labels"].long()
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(logits.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0), {}


def on_card(batches):
    """An endless iterator over host ``batches``, each copied to the card
    when it is fetched."""
    while True:
        for b in batches:
            yield {k: v.cuda(non_blocking=True) for k, v in b.items()}


def t5_buckets_check(card):
    """The relative-position bucket table computed on the card against
    the CPU (``logf`` on CUDA), at 512x512 and 114x114, both
    directions, equal."""
    from hetu_tpu_torch.models.t5 import relative_position_bucket
    for n in (T5_ENC, T5_DEC):
        rel = torch.arange(n)[None, :] - torch.arange(n)[:, None]
        for bidirectional in (True, False):
            kw = dict(bidirectional=bidirectional, num_buckets=32,
                      max_distance=128)
            ref = relative_position_bucket(rel, **kw)
            got = relative_position_bucket(rel.cuda(), **kw).cpu()
            assert torch.equal(got, ref), (n, bidirectional)
    print(f"T5 buckets {T5_ENC}x{T5_ENC} and {T5_DEC}x{T5_DEC}, both "
          f"directions: card == CPU; {card}")


def t5_arm(card):
    """T5-base: (a) buckets, the step-0 loss and gradients at t5_base
    width with 2+2 layers (batch 2, dropout 0.1, one key) and 3 AdamW
    ``Trainer`` steps against the CPU; (b) batch 32 x 512 / 114, fp32,
    AdamW 1e-4, 3 + 5 steps with TF32 off and on; (c) the loss falls."""
    from hetu_tpu_torch import (AdamWOptimizer, T5ForConditionalGeneration,
                                Trainer, t5_base)
    from hetu_tpu_torch.core import prng
    t5_buckets_check(card)
    small = T5ForConditionalGeneration(
        dataclasses.replace(t5_base(), num_layers=2),
        generator=torch.Generator().manual_seed(0))
    data = t5_batches(4, T5_CHECK_BATCH, seed=1)
    key = prng.key(5)
    cpu = step0_vs_cpu(
        "t5_base 2+2 layers, batch 2, dropout 0.1", small,
        {k: v.cuda() for k, v in data[0].items()},
        lambda m, b: t5_loss(m, b, key)[0], card,
        loss64=lambda m, b: t5_loss64(m, b, key)[0])
    steps_vs_cpu("t5_base 2+2 layers", small, cpu,
                 lambda: AdamWOptimizer(T5_LR), t5_loss64,
                 [{k: v.cuda() for k, v in b.items()} for b in data[1:]],
                 P12_STEP_TOL["t5"], card, fp64=True)
    del small, cpu
    torch.cuda.empty_cache()
    host = t5_batches(P12_WARMUP + P12_TIMED, T5_BATCH, seed=2)
    arms = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            model = T5ForConditionalGeneration(
                t5_base(), generator=torch.Generator().manual_seed(0))
            trainer = Trainer(model, AdamWOptimizer(T5_LR), t5_loss)
            r = vision_train(
                f"t5_base, batch {T5_BATCH} x {T5_ENC} / {T5_DEC}, fp32, "
                f"TF32 {'on' if tf32 else 'off'}", trainer, on_card(host),
                P12_WARMUP, P12_TIMED, card, window=P12_WINDOW)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        ms = r["median_ms"]
        r["input_tokens_per_s"] = T5_BATCH * T5_ENC / ms * 1e3
        r["target_tokens_per_s"] = T5_BATCH * T5_DEC / ms * 1e3
        prof = r["profile"] or {}
        print(f"t5_base TF32 {'on' if tf32 else 'off'}: {ms:.3f} ms a step, "
              f"{r['input_tokens_per_s']:.1f} input and "
              f"{r['target_tokens_per_s']:.1f} target tokens/s, peak "
              f"{r['peak'] / 2**30:.3f} GiB, device busy "
              f"{prof.get('busy_ms', float('nan')):.3f} ms of the profiled "
              f"step's {prof.get('wall_ms', float('nan')):.3f}; {card}")
        arms[tf32] = r
        del trainer, model
        torch.cuda.empty_cache()
    return arms


def rnn_arm(card):
    """The LSTM and GRU classifiers on ``mnist()`` read as 28 timesteps of
    28 features, hidden 128, batch 128, Adam 1e-3: step 0 and 3 steps
    against the CPU, then 3 + 5 timed steps over the loader."""
    from hetu_tpu_torch import (AdamOptimizer, Dataloader, RNNClassifier,
                                mnist)
    x, y, _, _ = mnist()
    x = x.reshape(-1, 28, 28)
    loss_of = cls_loss(plain_call)
    arms = {}
    for cell in ("lstm", "gru"):
        model = RNNClassifier(28, RNN_HIDDEN, 10, cell=cell,
                              generator=torch.Generator().manual_seed(0))
        b = [{"x": torch.from_numpy(x[i:i + RNN_BATCH]).cuda(),
              "y": torch.from_numpy(y[i:i + RNN_BATCH]).cuda()}
             for i in range(0, 4 * RNN_BATCH, RNN_BATCH)]
        cpu = step0_vs_cpu(f"{cell} classifier, batch {RNN_BATCH}", model,
                           b[0], lambda m, bb: loss_of(m, bb)[0], card)
        steps_vs_cpu(f"{cell} classifier", model, cpu,
                     lambda: AdamOptimizer(RNN_LR),
                     lambda m, bb, k: (loss_of(m, bb)[0], {}), b[1:],
                     P12_STEP_TOL["rnn"], card)
        from hetu_tpu_torch import Trainer
        model = RNNClassifier(28, RNN_HIDDEN, 10, cell=cell,
                              generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, AdamOptimizer(RNN_LR),
                          lambda m, bb, k: (loss_of(m, bb)[0], {}))
        dl = Dataloader({"x": x, "y": y}, RNN_BATCH, shuffle=True)
        r = vision_train(f"{cell} classifier, batch {RNN_BATCH}, fp32",
                         trainer, iter(dl.prefetch()), P12_WARMUP,
                         P12_TIMED, card, window=P12_WINDOW)
        launches = (r["profile"] or {}).get("launches")
        print(f"{cell} classifier: {r['median_ms']:.3f} ms a step, "
              f"{r['samples_per_s']:.1f} samples/s, {launches} device "
              f"activities in the profiled step; {card}")
        arms[cell] = r
        del trainer, model, cpu
    torch.cuda.empty_cache()
    return arms


def arxiv_sbm(seed=0):
    """A stochastic-block graph at ogbn-arxiv's size: ARXIV_NODES nodes
    in ARXIV_CLASSES blocks (the labels), ARXIV_EDGES undirected edges of
    which 80% join two nodes of one block, both directions stored;
    ARXIV_FEATS features, the block's centroid plus unit noise; the
    first ARXIV_TRAIN nodes of a permutation are the train split."""
    rng = np.random.default_rng(seed)
    n, e = ARXIV_NODES, ARXIV_EDGES
    y = rng.integers(0, ARXIV_CLASSES, n)
    order = np.argsort(y, kind="stable")
    counts = np.bincount(y, minlength=ARXIV_CLASSES)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    src = rng.integers(0, n, e)
    same = rng.random(e) < 0.8
    pick = starts[y[src]] + (rng.random(e) * counts[y[src]]).astype(np.int64)
    dst = np.where(same, order[pick], rng.integers(0, n, e))
    edges = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
    centroids = rng.standard_normal((ARXIV_CLASSES, ARXIV_FEATS))
    x = (centroids[y] + rng.standard_normal((n, ARXIV_FEATS))).astype(
        np.float32)
    train = rng.permutation(n)[:ARXIV_TRAIN]
    return edges, x, y.astype(np.int64), train


def gcn_loss(m, b, k):
    from hetu_tpu_torch.ops import softmax_cross_entropy_sparse
    logits = m(b["x"], b["edges"], b["weights"], key=k, training=k is not None)
    t = b["train"]
    return softmax_cross_entropy_sparse(logits[t], b["y"][t]).mean(), {}


def gcn_arm(card):
    """``GCN(128, 256, 40, num_layers=3, dropout_rate=0.5)``, Adam 0.01,
    full batch on ``arxiv_sbm()``: step 0 and ``GCN_CPU_STEPS`` steps
    against the CPU (each about 15 s on the CPU), then 3 + 5 timed
    epochs."""
    from hetu_tpu_torch import GCN, AdamOptimizer, Trainer
    from hetu_tpu_torch import normalize_adjacency
    from hetu_tpu_torch.core import prng
    t0 = time.monotonic()
    edges, x, y, train = arxiv_sbm()
    ei, w = normalize_adjacency(edges, ARXIV_NODES)
    print(f"arxiv_sbm(): {ARXIV_NODES} nodes, {edges.shape[1]} directed "
          f"edges + {ARXIV_NODES} self-loops = {ei.shape[1]}, "
          f"{ARXIV_FEATS} features, {ARXIV_CLASSES} classes, "
          f"{len(train)} train nodes; made in {time.monotonic() - t0:.2f} s")
    graph = {"x": torch.from_numpy(x).cuda(), "edges": ei, "weights": w,
             "y": torch.from_numpy(y).cuda(),
             "train": torch.from_numpy(train).cuda()}
    model = GCN(ARXIV_FEATS, GCN_HIDDEN, ARXIV_CLASSES, num_layers=3,
                dropout_rate=0.5, generator=torch.Generator().manual_seed(0))
    key = prng.key(7)
    cpu = step0_vs_cpu("gcn arxiv, full batch, dropout 0.5", model, graph,
                       lambda m, b: gcn_loss(m, b, key)[0], card)
    steps_vs_cpu("gcn arxiv", model, cpu, lambda: AdamOptimizer(GCN_LR),
                 gcn_loss, [graph] * GCN_CPU_STEPS, P12_STEP_TOL["gcn"],
                 card)
    del cpu
    model = GCN(ARXIV_FEATS, GCN_HIDDEN, ARXIV_CLASSES, num_layers=3,
                dropout_rate=0.5, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, AdamOptimizer(GCN_LR), gcn_loss)
    r = vision_train("gcn arxiv, full batch, fp32", trainer,
                     iter(lambda: graph, None), P12_WARMUP, P12_TIMED, card,
                     window=P12_WINDOW)
    prof = r["profile"] or {}
    print(f"gcn arxiv: {r['median_ms']:.3f} ms a full-batch epoch, peak "
          f"{r['peak'] / 2**30:.3f} GiB, device busy "
          f"{prof.get('busy_ms', float('nan')):.3f} ms of the profiled "
          f"step's {prof.get('wall_ms', float('nan')):.3f}; {card}")
    del trainer, model, graph
    torch.cuda.empty_cache()
    return r


def seq_graph_phase(card):
    """Phase 12: T5-base, the LSTM and GRU classifiers and the GCN,
    (a)-(c) each."""
    t0 = time.monotonic()
    t5 = t5_arm(card)
    rnns = rnn_arm(card)
    gcn = gcn_arm(card)
    print(f"phase 12 in {time.monotonic() - t0:.1f} s; t5_base "
          f"{t5[False]['median_ms']:.3f} ms a step (TF32 off), "
          f"{t5[True]['median_ms']:.3f} (on); lstm "
          f"{rnns['lstm']['median_ms']:.3f}, gru "
          f"{rnns['gru']['median_ms']:.3f}; gcn "
          f"{gcn['median_ms']:.3f} ms an epoch")
    return t5, rnns, gcn



# ---------------------------------------------------------------------------
# Phase 13: Wide&Deep (bench.py config 2's widths) at Criteo Kaggle's
# 33.76M-row vocabulary through the embedding compression suite and the
# sharded host table, and NeuMF at MovieLens-20M's size through two of the
# methods (examples/train_rec.py's path).  The JAX package writes every
# method in jnp ops with no Pallas kernel, so the port's methods are plain
# torch on the card: the phase checks them against the CPU and times them.
# ---------------------------------------------------------------------------

# 26 x 1,298,561 = 33,762,586 rows (Criteo Kaggle: 33,762,577)
CMP_FIELDS, CMP_VPF = 26, 1_298_561
CMP_ROWS = CMP_FIELDS * CMP_VPF
CMP_DIM, CMP_HIDDEN, CMP_BATCH, CMP_LR = 16, 256, 512, 1e-3
CMP_WARMUP, CMP_TIMED = 3, 10
CMP_CHECK_VPF = 10_000                     # the step-0 check's cut vocabulary
CMP_LOSS_TOL = 1e-5      # fp32 step-0 losses, card vs CPU, relative
CMP_GRAD_TOL = 1e-4      # fp32 step-0 gradients, of each one's max
ML_USERS, ML_ITEMS, ML_DIM, ML_LR = 138_493, 26_744, 20, 3e-3


def cmp_sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cmp_inits(dev, base):
    """``(init16, init)``: the initializer of the arms' ``N x 16`` tables
    (a copy of ``base``, one table drawn once by the port's
    ``xavier_normal``, where given; other shapes as ``init``) and of
    their other tables (xavier normal drawn on ``dev`` from a seeded
    generator, which the CPU generator of the port's initializers would
    take seconds for at this size)."""
    from hetu_tpu_torch.init.initializers import _fans, _jax_shape
    gen = torch.Generator(device=dev).manual_seed(1)

    def init(generator, shape, dtype=torch.float32, device=None):
        fan_in, fan_out = _fans(_jax_shape(shape))
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return torch.empty(shape, dtype=dtype, device=dev).normal_(
            0.0, std, generator=gen)

    def init16(generator, shape, dtype=torch.float32, device=None):
        if base is None or tuple(shape) != tuple(base.shape):
            return init(generator, shape, dtype, device)
        return base.clone()

    return init16, init


def three_factors(n):
    """``examples/train_rec.py``'s row factorization: ``[a, a,
    ceil(n / a**2)]`` with ``a = ceil(n ** (1/3))``."""
    a = math.ceil(n ** (1 / 3))
    return [a, a, math.ceil(n / a ** 2)]


def three_factor_exact(x):
    """``examples/train_rec.py``'s exact factorization of the dim."""
    a = max(d for d in range(1, int(round(x ** (1 / 3))) + 2) if x % d == 0)
    rem = x // a
    b = max(d for d in range(1, int(rem ** 0.5) + 1) if rem % d == 0)
    return [a, b, rem // b]


def cmp_counts(data, n):
    return np.bincount(data["sparse"].ravel(), minlength=n)


def cmp_makers(n, dev, inits, counts):
    """Each arm's embedding at ``n`` rows on ``dev``: name -> a function
    that makes it."""
    from hetu_tpu_torch.embed import compress as c
    from hetu_tpu_torch.layers import Embedding
    init16, init = inits
    d = CMP_DIM
    q = math.ceil(math.sqrt(n))

    def groups():
        order = torch.argsort(-torch.from_numpy(counts).to(dev), stable=True)
        g = torch.empty(n, dtype=torch.int32, device=dev)
        g[order] = (torch.arange(n, device=dev) * 8 // n).to(torch.int32)
        return g

    def dense_normal(g, shape, dtype=torch.float32, device=None):
        # the dense Embedding's normal(0.02), from the xavier-scaled table
        return init16(g, shape, dtype, device) * (
            0.02 / math.sqrt(2.0 / (n + d)))

    return {
        "device": lambda: Embedding(n, d, initializer=dense_normal,
                                    device=dev),
        "hash": lambda: c.HashEmbedding(n // 10, d, initializer=init,
                                        device=dev),
        "compo": lambda: c.CompositionalEmbedding(q, q, d, initializer=init,
                                                  device=dev),
        "robe": lambda: c.RobeEmbedding(n * d // 10, d, Z=1,
                                        initializer=init, device=dev),
        "dhe": lambda: c.DeepHashEmbedding(d, device=dev),
        "quantize": lambda: c.QuantizedEmbedding(n, d, digit=8,
                                                 initializer=init16,
                                                 device=dev),
        "alpt": lambda: c.ALPTEmbedding(n, d, digit=8, initializer=init16,
                                        device=dev),
        "dpq": lambda: c.DPQEmbedding(n, d, num_choices=256, num_parts=4,
                                      initializer=init16, device=dev),
        "mgqe": lambda: c.MGQEmbedding(n, d, 256, 64, 4, frequency=counts,
                                       initializer=init16, device=dev),
        "deeplight": lambda: c.DeepLightEmbedding(n, d, initializer=init16,
                                                  device=dev),
        "pep": lambda: c.PEPEmbedding(n, d, initializer=init16, device=dev),
        "optembed": lambda: c.OptEmbedding(n, d, num_slot=CMP_FIELDS,
                                           initializer=init16, device=dev),
        "autosrh": lambda: c.AutoSrhEmbedding(n, d, nsplit=8,
                                              group_indices=groups(),
                                              initializer=init16,
                                              device=dev),
        "md": lambda: c.MDEmbedding(n, 8, d, initializer=init, device=dev),
        "autodim": lambda: c.AutoDimEmbedding(n, (2, 4, 8, 16), CMP_FIELDS,
                                              initializer=init, device=dev),
        "tt": lambda: c.TensorTrainEmbedding(three_factors(n), (2, 2, 4), 8,
                                             device=dev),
        "adapt": lambda: c.AdaptiveEmbedding.from_frequency(
            counts, n // 20, n // 20, d, initializer=init, device=dev),
    }


def cmp_keyed(arm):
    """The loss of an arm whose embedding takes the step's key (OptEmbed's
    field masks, AutoDim's Gumbel noise), as the JAX ``Trainer`` hands
    its ``k`` to the loss; else the model's own loss."""
    from hetu_tpu_torch.ops import binary_cross_entropy_with_logits as bce

    def loss(m, b, k):
        if arm == "optembed":
            emb = m.embed(b["sparse"], key=k, training=True)
        else:
            emb = m.embed(b["sparse"], key=k)
        logits = m.head(torch.cat([emb.reshape(b["dense"].shape[0], -1),
                                   m.deep(b["dense"])], dim=1))[:, 0]
        return bce(logits, b["label"]).mean(), {}

    if arm in ("optembed", "autodim"):
        return loss
    return lambda m, b, k: m.loss(b["dense"], b["sparse"], b["label"])


def cmp_model(embed, dev):
    """``WideDeep`` at config 2's widths with ``embed`` set (built with a
    one-row table first: its dense layers do not depend on the rows)."""
    from hetu_tpu_torch.models.ctr import CTRConfig, WideDeep
    model = WideDeep(CTRConfig(vocab=1, embed_dim=CMP_DIM,
                               mlp_hidden=CMP_HIDDEN), device=dev,
                     generator=torch.Generator().manual_seed(0))
    model.embed = embed
    return model


def cmp_state_bytes(module):
    """Bytes of a module's parameters and buffers (shared ones once)."""
    seen = {id(t): t for t in [*module.parameters(), *module.buffers()]}
    return sum(t.numel() * t.element_size() for t in seen.values())


def cmp_grads_close(name, card, cpu, keys=None):
    """Every gradient of ``card`` within ``CMP_GRAD_TOL`` of its CPU
    twin's max (a gradient that is zero on the CPU must be zero on the
    card); the worst ratio."""
    worst = (0.0, "")
    for n, g in cpu.items():
        scale = float(g.abs().max())
        err = float((card[n].cpu() - g).abs().max())
        r = err / scale if scale > 0 else (0.0 if err == 0 else math.inf)
        worst = max(worst, (r, n))
    assert worst[0] <= CMP_GRAD_TOL, (name, worst)
    return worst


def cmp_step0(arm, model, batch, loss_fn, key, dev):
    """Step 0 of ``model`` (on ``dev``) against a copy on the CPU, same
    weights, batch and key: the loss (relative) and every gradient."""
    cpu = copy.deepcopy(model).cpu()
    out = []
    for m, b in ((model, batch), (cpu, {k: v.cpu()
                                        for k, v in batch.items()})):
        m.zero_grad(set_to_none=True)
        loss = loss_fn(m, b, key)[0]
        loss.backward()
        out.append((float(loss.detach()),
                    {n: (p.grad if p.grad is not None
                         else torch.zeros_like(p)).detach().cpu()
                     for n, p in m.named_parameters()}))
        m.zero_grad(set_to_none=True)
    (kl, kg), (cl, cg) = out
    rel = abs(kl - cl) / abs(cl)
    worst = cmp_grads_close(arm, kg, cg)
    assert rel <= CMP_LOSS_TOL, (arm, kl, cl)
    return cpu, rel, worst, len(cg)


def cmp_batches(data, dev, n_steps):
    """``n_steps`` consecutive batches of ``data`` on ``dev``."""
    return [{k: torch.from_numpy(v[i * CMP_BATCH:(i + 1) * CMP_BATCH]).to(
        dev) for k, v in data.items()} for i in range(n_steps)]


def cmp_busy(step, dev):
    """One profiled call of ``step``: ``(device busy ms, wall ms, the
    three largest kernels as (ms, launches, name))``, the busy time the
    union of the device's activities; None where the profiler saw no
    device activity (and on the CPU)."""
    from torch.profiler import ProfilerActivity, profile
    if torch.device(dev).type != "cuda":
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        wall = (time.monotonic() - t0) * 1e3
    spans = device_spans(prof)
    if not spans:
        return None
    cuda = torch.autograd.DeviceType.CUDA
    top = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == cuda and e.self_device_time_total > 0),
                 reverse=True)[:3]
    return union_ms([sp[1:] for sp in spans]), wall, top


def cmp_train(arm, model, loss_fn, batches, dev, card, sched=None):
    """``CMP_WARMUP`` + ``CMP_TIMED`` Adam ``Trainer`` steps, each from its
    stage (for a staged layer) to its synchronize, the last warm-up step
    under the profiler; a schedule's ``sched.step`` after each, timed
    apart as the arm's transitions.  Prints and returns the median step,
    samples/s, peak memory, the profiled step's device busy share, and
    the losses."""
    from hetu_tpu_torch.exec import Trainer
    from hetu_tpu_torch.optim import AdamOptimizer
    cuda = torch.device(dev).type == "cuda"
    trainer = Trainer(model, AdamOptimizer(CMP_LR), loss_fn)
    losses, step_s, hooks, busy = [], [], [], None

    def one(b):
        for m in trainer.staged_modules():
            m.stage(b["sparse"])
        losses.append(trainer.step(b)["loss"])

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i, b in enumerate(batches[:CMP_WARMUP + CMP_TIMED]):
        cmp_sync(dev)
        t0 = time.monotonic()
        if i == CMP_WARMUP - 1:
            busy = cmp_busy(lambda: one(b), dev)
            if busy is None:
                one(b)
        else:
            one(b)
        cmp_sync(dev)
        if i >= CMP_WARMUP:
            step_s.append(time.monotonic() - t0)
        if sched is not None and not sched.done:
            t0 = time.monotonic()
            emb = sched.step(model.embed)
            cmp_sync(dev)
            if emb is not model.embed:
                hooks.append((i + 1, time.monotonic() - t0))
                model.embed = emb
    losses = [float(x) for x in losses]
    med = statistics.median(step_s)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    fell = losses[-1] < losses[0]
    print(f"{arm}: median step {med * 1e3:.3f} ms, "
          f"{CMP_BATCH / med:.1f} samples/s, peak memory "
          f"{peak / 2**30:.3f} GiB, device busy "
          + ("not measured" if busy is None else
             f"{busy[0]:.3f} ms of a profiled {busy[1]:.3f} ms step "
             f"({busy[0] / busy[1]:.1%})")
          + ("" if busy is None else " [" + "; ".join(
              f"{ms:.3f} ms {n}x {name[:48]}" for ms, n, name in busy[2])
             + "]")
          + f"; loss {losses[0]:.6f} at step 0, {losses[-1]:.6f} after "
          f"{len(losses)} steps" + ("" if fell else " (did not fall)")
          + "".join(f"; schedule transition after step {s}: "
                    f"{t * 1e3:.1f} ms" for s, t in hooks) + f"; {card}")
    assert all(np.isfinite(losses)), (arm, losses)
    return {"median_ms": med * 1e3, "samples_per_s": CMP_BATCH / med,
            "peak": peak, "busy": busy, "losses": losses, "hooks": hooks,
            "fell": fell}


def cmp_check_phase(dev, card):
    """(a) Step 0 of every arm at ``CMP_CHECK_VPF`` rows a field (a cut of
    the check only), on ``dev`` against the CPU, and each transition's
    result on ``dev`` against the CPU's."""
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.data import synthetic_ctr
    from hetu_tpu_torch.embed import ShardedHostEmbedding
    from hetu_tpu_torch.embed import compress as c
    n = CMP_FIELDS * CMP_CHECK_VPF
    data = synthetic_ctr(n=CMP_BATCH, vocab_per_field=CMP_CHECK_VPF, seed=3)
    (batch,) = cmp_batches(data, dev, 1)
    counts = cmp_counts(data, n)
    key = prng.key(11)
    makers = cmp_makers(n, dev, cmp_inits(dev, None), counts)
    table = makers["device"]().weight.detach()
    makers["dedup"] = lambda: c.DedupEmbedding.from_dense(table)
    models = {}
    for arm, build in makers.items():
        model = cmp_model(build(), dev)
        cpu, rel, worst, ng = cmp_step0(arm, model, batch, cmp_keyed(arm),
                                        key, dev)
        print(f"check {arm}: step 0 at {n} rows, {dev} vs CPU: loss "
              f"relative difference {rel:.3e} (tol {CMP_LOSS_TOL:g}); worst "
              f"of {ng} gradients {worst[1]} {worst[0]:.3e} of its max (tol "
              f"{CMP_GRAD_TOL:g})")
        models[arm] = (model, cpu)
    # the codes of the two quantizers: equal (a near-tie flip would show)
    for arm in ("dpq", "mgqe"):
        k_, c_ = (m.embed.codes(batch["sparse"].to(m.embed.weight.device))
                  for m in models[arm])
        assert torch.equal(k_.cpu(), c_), f"{arm}: codes differ"
    # the sharded host table: two instances from one engine seed
    side = {}
    for where in (dev, "cpu"):
        m = cmp_model(ShardedHostEmbedding(n, CMP_DIM, n_shards=4,
                                           optimizer="adagrad", lr=0.05,
                                           device=where), where)
        b = {k: v.to(where) for k, v in batch.items()}
        m.embed.stage(b["sparse"])
        loss = m.loss(b["dense"], b["sparse"], b["label"])[0]
        loss.backward()
        side[where] = (float(loss.detach()),
                       {**{k: p.grad for k, p in m.named_parameters()},
                        "embed.rows": m.embed.rows.grad})
    rel = abs(side[dev][0] - side["cpu"][0]) / abs(side["cpu"][0])
    worst = cmp_grads_close("sharded", side[dev][1], side["cpu"][1])
    assert rel <= CMP_LOSS_TOL
    print(f"check sharded: step 0, {dev} vs CPU: loss relative difference "
          f"{rel:.3e}; worst of {len(side['cpu'][1])} gradients (the staged "
          f"rows' included) {worst[1]} {worst[0]:.3e} of its max")
    # transitions on identical inputs, dev against the CPU
    gen = torch.Generator().manual_seed(5)
    dl, dl_cpu = (m.embed for m in models["deeplight"])
    thr = [float(e.threshold(100_000)) for e in (dl, dl_cpu)]
    assert thr[0] == thr[1], thr
    mask = [m.embed.make_mask().cpu() for m in models["pep"]]
    assert torch.equal(*mask)
    alpha = torch.randn(8, CMP_DIM, generator=gen)
    hard = []
    for m in models["autosrh"]:
        with torch.no_grad():
            m.embed.alpha.copy_(alpha)
        hard.append(m.embed.harden(0.5).alpha.detach().cpu())
    assert torch.equal(*hard) and 0.3 < float(hard[0].mean()) < 0.7
    logits = torch.randn(CMP_FIELDS, 4, generator=gen)
    dims = []
    for m in models["autodim"]:
        with torch.no_grad():
            m.embed.alpha.copy_(logits)
        dims.append(m.embed.selected_dims())
    assert dims[0] == dims[1]
    dedup_cpu = c.DedupEmbedding.from_dense(table.cpu())
    assert torch.equal(models["dedup"][0].embed.remap.cpu(), dedup_cpu.remap)
    assert torch.equal(models["dedup"][0].embed.weight.detach().cpu(),
                       dedup_cpu.weight.detach())
    pruned = [dl.prune(100_000), dl_cpu.prune(100_000)]
    sp = [c.SparseInferenceEmbedding.from_dense(p.weight) for p in pruned]
    looked = [s(batch["sparse"].to(s.csr.data.device)).cpu() for s in sp]
    assert torch.equal(*looked)
    assert torch.equal(looked[0], pruned[1](batch["sparse"].cpu()).detach())
    print(f"check transitions, {dev} vs CPU, equal: DeepLight's threshold "
          f"at step 100000 ({thr[0]:.6e}), PEP's mask ({int(mask[0].sum())} "
          f"of {mask[0].numel()} kept), AutoSrh's hardened alpha "
          f"({float(hard[0].mean()):.3f} kept), AutoDim's selected dims "
          f"{dims[0][:6]}..., DedupEmbedding.from_dense "
          f"({dedup_cpu.weight.shape[0]} blocks), the CSR form's lookups; "
          f"{card}")
    del models, side


def cmp_phase(card, dev="cuda", vpf=CMP_VPF, ml=(ML_USERS, ML_ITEMS)):
    """Phase 13, (a) the step-0 and transition checks, (b) every arm at
    ``vpf`` rows a field: 3 + 10 timed steps, (c) NeuMF through hash and
    tt.  Returns the arms' readings."""
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.data import synthetic_ctr
    from hetu_tpu_torch.embed import ShardedHostEmbedding
    from hetu_tpu_torch.embed import compress as c
    from hetu_tpu_torch.embed.compress import scheduler as sch
    from hetu_tpu_torch.init import xavier_normal
    t_phase = time.monotonic()
    cmp_check_phase(dev, card)
    n = CMP_FIELDS * vpf
    dense_bytes = n * CMP_DIM * 4
    steps = CMP_WARMUP + CMP_TIMED
    t0 = time.monotonic()
    data = synthetic_ctr(n=steps * CMP_BATCH, vocab_per_field=vpf)
    batches = cmp_batches(data, dev, steps)
    counts = cmp_counts(data, n)
    base = xavier_normal()(torch.Generator().manual_seed(0), (n, CMP_DIM),
                           torch.float32, dev)
    cmp_sync(dev)
    build_s = {"data and the base table": time.monotonic() - t0}
    print(f"phase 13 workload: Wide&Deep, {CMP_FIELDS} fields x {vpf} = "
          f"{n} "
          f"rows, dim {CMP_DIM}, hidden {CMP_HIDDEN}, batch {CMP_BATCH}, "
          f"Adam {CMP_LR}, fp32, TF32 off; data and one xavier table drawn "
          f"in {build_s['data and the base table']:.2f} s")
    inits = cmp_inits(dev, base)
    makers = cmp_makers(n, dev, inits, counts)
    rows = {}

    def run(arm, make, sched=None, loss_fn=None):
        held = torch.cuda.memory_allocated() if dev == "cuda" else 0
        t0 = time.monotonic()
        embed = make()
        model = cmp_model(embed, dev)
        cmp_sync(dev)
        build_s[arm] = time.monotonic() - t0
        nbytes = (sum(t.rows * t.dim * 4 for t in embed.tables)
                  if arm == "sharded" else cmp_state_bytes(embed))
        print(f"{arm}: built in {build_s[arm]:.2f} s, embedding "
              f"{nbytes} bytes, compression {dense_bytes / nbytes:.2f}x "
              f"(the dense table's {dense_bytes} bytes over these); "
              f"{held / 2**30:.3f} GiB held on the card before it")
        r = cmp_train(arm, model, loss_fn or cmp_keyed(arm), batches, dev,
                      card, sched=sched)
        r["bytes"], r["ratio"] = nbytes, dense_bytes / nbytes
        rows[arm] = r
        return model, r

    model, r = run("device", makers["device"])
    trained = model.embed.weight.detach()
    del model
    t0 = time.monotonic()
    dedup = c.DedupEmbedding.from_dense(trained)
    cmp_sync(dev)
    build_s["dedup.from_dense"] = time.monotonic() - t0
    del trained
    print(f"DedupEmbedding.from_dense of the device arm's trained table: "
          f"{time.monotonic() - t0:.2f} s, {dedup.weight.shape[0]} unique "
          f"blocks of {n}")
    run("dedup", lambda: dedup)
    del dedup
    for arm in ("hash", "compo", "robe", "dhe", "quantize", "alpt", "dpq",
                "mgqe", "optembed", "md", "tt", "adapt"):
        run(arm, makers[arm])
        if dev == "cuda":
            torch.cuda.empty_cache()
    run("sharded", lambda: ShardedHostEmbedding(
        n, CMP_DIM, n_shards=4, optimizer="adagrad", lr=0.05, device=dev))
    # DeepLight: its schedule prunes every 10 steps; then the rate a long
    # run reaches
    model, r = run("deeplight", makers["deeplight"],
                   sched=sch.deeplight_schedule(steps, prune_every=10))
    t0 = time.monotonic()
    pruned = model.embed.prune(100_000)
    cmp_sync(dev)
    r["prune_s"] = time.monotonic() - t0
    print(f"deeplight: prune(100000) in {r['prune_s']:.2f} s, sparsity "
          f"{pruned.sparsity():.4f}")
    del model
    t0 = time.monotonic()
    sp = c.SparseInferenceEmbedding.from_dense(pruned.weight)
    cmp_sync(dev)
    build_s["sparse"] = time.monotonic() - t0
    ids = batches[0]["sparse"]
    assert torch.equal(sp(ids), pruned(ids).detach())
    lookups = []
    for _ in range(steps):
        cmp_sync(dev)
        t0 = time.monotonic()
        sp(ids)
        cmp_sync(dev)
        lookups.append(time.monotonic() - t0)
    nb = cmp_state_bytes(sp)
    rows["sparse"] = {"median_ms": statistics.median(lookups[CMP_WARMUP:])
                      * 1e3, "bytes": nb, "ratio": dense_bytes / nb}
    print(f"sparse: from_dense in {build_s['sparse']:.2f} s, {sp.nnz()} "
          f"entries, {nb} bytes (compression {dense_bytes / nb:.2f}x); "
          f"lookups "
          f"of a batch ({ids.numel()} ids) equal the pruned table's, median "
          f"{rows['sparse']['median_ms']:.3f} ms; {card}")
    del sp, pruned
    # PEP: search, the mask, then the retrain from a fresh table
    pep_sched = sch.pep_schedule(
        steps, steps, make_retrain=lambda m, mask: c.PEPRetrainEmbedding(
            n, CMP_DIM, mask, initializer=inits[0], device=dev))
    model, r = run("pep", makers["pep"], sched=pep_sched)
    assert isinstance(model.embed, c.PEPRetrainEmbedding)
    kept = float(model.embed.mask.float().mean())
    print(f"pep -> pep_retrain: mask keeps {kept:.4f} of the entries")
    retrain = model.embed
    del model
    run("pep_retrain", lambda: retrain, sched=pep_sched)
    del retrain
    srh_sched = sch.autosrh_schedule(steps, steps, keep_rate=0.5)
    model, r = run("autosrh", makers["autosrh"], sched=srh_sched)
    hardened = model.embed
    print(f"autosrh: hardened alpha keeps "
          f"{float(hardened.alpha.detach().mean()):.3f}")
    del model
    run("autosrh_retrain", lambda: hardened, sched=srh_sched)
    del hardened
    model, r = run("autodim", makers["autodim"])
    t0 = time.monotonic()
    finals = model.embed.materialize()
    r["materialize_s"] = time.monotonic() - t0
    dims = model.embed.selected_dims()
    nbytes = sum(t.numel() * t.element_size() for t in
                 {id(t): t for f in finals for t in f.parameters()}.values())
    print(f"autodim: materialize in {r['materialize_s'] * 1e3:.1f} ms, "
          f"selected dims {dims}, the materialized tables {nbytes} bytes")
    del model, finals
    del base, inits, makers, pep_sched   # the closures hold the table
    if dev == "cuda":
        torch.cuda.empty_cache()
    rows.update(cmp_neumf(dev, card, ml))
    print("phase 13 build times (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in build_s.items()))
    return rows, time.monotonic() - t_phase


def cmp_neumf(dev, card, ml):
    """(c) NeuMF at MovieLens-20M's users and items, dim 20, batch 512,
    Adam 3e-3, through ``hash`` (vocab // 8) and ``tt`` (train_rec's
    factorization): step 0 against the CPU, then 3 + 10 timed steps."""
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.embed import compress as c
    from hetu_tpu_torch.exec import Trainer
    from hetu_tpu_torch.models.ncf import NeuMF
    from hetu_tpu_torch.optim import AdamOptimizer
    users, items = ml
    vocab = users + items
    rng = np.random.default_rng(0)
    u_sign, i_sign = rng.integers(0, 2, users), rng.integers(0, 2, items)
    steps = CMP_WARMUP + CMP_TIMED
    batches = []
    for _ in range(steps):
        u = rng.integers(0, users, CMP_BATCH)
        i = rng.integers(0, items, CMP_BATCH)
        batches.append({
            "ids": torch.from_numpy(np.stack([u, users + i], 1).astype(
                np.int32)).to(dev),
            "y": torch.from_numpy((u_sign[u] == i_sign[i]).astype(
                np.float32)).to(dev)})
    makes = {
        "neumf hash": lambda: c.HashEmbedding(max(vocab // 8, 16), ML_DIM,
                                              device=dev),
        "neumf tt": lambda: c.TensorTrainEmbedding(
            three_factors(vocab), three_factor_exact(ML_DIM), 8,
            device=dev),
    }
    out = {}
    for arm, make in makes.items():
        model = NeuMF(vocab, ML_DIM, embedding=make(), device=dev,
                      generator=torch.Generator().manual_seed(0))

        def loss_fn(m, b, k):
            return m.loss(b["ids"], b["y"])

        _, rel, worst, ng = cmp_step0(arm, model, batches[0], loss_fn, None,
                                      dev)
        print(f"check {arm}: step 0, {dev} vs CPU: loss relative "
              f"difference {rel:.3e}; worst of {ng} gradients {worst[1]} "
              f"{worst[0]:.3e} of its max")
        trainer = Trainer(model, AdamOptimizer(ML_LR), loss_fn)
        losses, step_s = [], []
        cuda = torch.device(dev).type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        for i, b in enumerate(batches):
            cmp_sync(dev)
            t0 = time.monotonic()
            losses.append(trainer.step(b)["loss"])
            cmp_sync(dev)
            if i >= CMP_WARMUP:
                step_s.append(time.monotonic() - t0)
        losses = [float(x) for x in losses]
        med = statistics.median(step_s)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        busy = cmp_busy(lambda: trainer.step(batches[0]), dev)
        nb = cmp_state_bytes(model.embed)
        print(f"{arm}: {users} users + {items} items, dim {ML_DIM}, "
              f"embedding {nb} bytes (compression "
              f"{vocab * ML_DIM * 4 / nb:.2f}x); median step "
              f"{med * 1e3:.3f} ms, "
              f"{CMP_BATCH / med:.1f} samples/s, peak memory "
              f"{peak / 2**30:.3f} GiB, device busy "
              + ("not measured" if busy is None else
                 f"{busy[0]:.3f} ms of a profiled {busy[1]:.3f} ms step "
                 f"({busy[0] / busy[1]:.1%})")
              + f"; loss {losses[0]:.6f} -> {losses[-1]:.6f}; {card}")
        assert all(np.isfinite(losses))
        out[arm] = {"median_ms": med * 1e3, "samples_per_s": CMP_BATCH / med,
                    "busy": busy, "losses": losses, "bytes": nb,
                    "ratio": vocab * ML_DIM * 4 / nb, "peak": peak}
    return out


# ---------------------------------------------------------------------------
# Phase 14: the distributed half of the embedding path.  (a) Wide&Deep at
# phase 13's 33.76M rows trained over four network PS servers on loopback
# (embedding="remote"); (b) its table streamed as versioned snapshots to two
# read-only serving replicas (HBM-cached, staleness bounds 0 and 2) behind
# ServingEngine.infer_ctr; (c) ResNet-18 trained through the PS by two BSP
# worker processes sharing the card (PSDataParallel); (d) the GCN of phase
# 12 on subgraphs sampled by a graph server (RemoteGraph).  No file of the
# JAX package's embed/ reaches pl.pallas_call: torch code and the host
# engine, no CUDA kernel of this port on these paths.
# ---------------------------------------------------------------------------

PS_SHARDS = 4
PS_OPT, PS_LR = "adagrad", 0.05          # phase 13's sharded arm
PS_HBM_CAPACITY = 8192                   # phase 9's hbm arm
SERVE_REQS, SERVE_ROWS = 8, 512          # infer_ctr requests a step, rows
SERVE_TOL = 1e-6                         # bound 0: served vs trainer, abs
SNAP_MARGIN = 1 << 30                    # free disk beyond two full snapshots
PSDP_STEPS, PSDP_BATCH, PSDP_LR = 10, 128, 0.05
PSDP_TOL = 1e-5                          # worker 0's step-0 loss vs CPU
GRAPH_SEEDS, GRAPH_FANOUT, GRAPH_HOPS = 128, 8, 2
GRAPH_STEPS, GRAPH_SEED = 20, 1234


def ps_wdl(cfg_kw, dev):
    """Wide&Deep at config 2's widths through ``CTRConfig`` (the entry
    point a user calls), dense weights from generator seed 0."""
    from hetu_tpu_torch.models.ctr import CTRConfig, WideDeep
    return WideDeep(CTRConfig(embed_dim=CMP_DIM, mlp_hidden=CMP_HIDDEN,
                              **cfg_kw), device=dev,
                    generator=torch.Generator().manual_seed(0))


def ps_trainer(model):
    from hetu_tpu_torch.exec import Trainer
    from hetu_tpu_torch.optim import AdamOptimizer
    return Trainer(model, AdamOptimizer(CMP_LR),
                   lambda m, b, k: m.loss(b["dense"], b["sparse"],
                                          b["label"]))


def ps_step0(model, servers, batch, dev):
    """Step 0 of the trainer against the same model on the CPU over the
    same servers (the CPU model attaches to the trainer's tables, its
    dense weights copied): the loss and every gradient, the staged rows'
    included, with phase 13's limits.  Nothing is pushed."""
    from hetu_tpu_torch.embed import RemoteHostEmbedding
    cpu = ps_wdl(dict(vocab=PS_SHARDS, embedding="remote", servers=servers,
                      host_optimizer=PS_OPT, host_lr=PS_LR), "cpu")
    cpu.embed = RemoteHostEmbedding(
        model.embed.num_embeddings, CMP_DIM, servers=servers,
        table_id=model.embed.tables[0].table_id, optimizer=PS_OPT,
        lr=PS_LR, device="cpu")
    for part in ("deep", "head"):
        getattr(cpu, part).load_state_dict(getattr(model, part).state_dict())
    side = {}
    for m, where in ((model, dev), (cpu, "cpu")):
        b = {k: v.to(where) for k, v in batch.items()}
        m.embed.stage(b["sparse"])
        loss = m.loss(b["dense"], b["sparse"], b["label"])[0]
        loss.backward()
        side[where] = (float(loss.detach()),
                       {**{k: p.grad.detach().cpu()
                           for k, p in m.named_parameters()},
                        "embed.rows": m.embed.rows.grad.detach().cpu()})
        m.zero_grad(set_to_none=True)
    cmp_sync(dev)
    rel = abs(side[dev][0] - side["cpu"][0]) / abs(side["cpu"][0])
    worst = cmp_grads_close("ps step 0", side[dev][1], side["cpu"][1])
    assert rel <= CMP_LOSS_TOL, (side[dev][0], side["cpu"][0])
    return rel, worst, len(side["cpu"][1])


def ps_wire_bytes(loads):
    """Payload bytes of the pulls and pushes counted in ``loads``: a key
    (8 bytes) and a row (dim x 4) each way."""
    per = 8 + CMP_DIM * 4
    return int(loads["pull_rows"].sum() + loads["push_rows"].sum()) * per


def stream_replica(n, dev, tower0, bound, snap_dir, gpt):
    """A serving replica: Wide&Deep with ``embedding="hbm"`` (its own
    host table), its dense tower the trainer's at step 0, frozen; a
    follower at ``bound``; the engine."""
    from hetu_tpu_torch import ServingEngine
    from hetu_tpu_torch.embed import SnapshotFollower
    model = ps_wdl(dict(vocab=n, embedding="hbm",
                        cache_capacity=PS_HBM_CAPACITY, pull_bound=2), dev)
    missing, unexpected = model.load_state_dict(tower0, strict=False)
    assert not unexpected and all(k.startswith("embed.") for k in missing)
    model.requires_grad_(False)
    follower = SnapshotFollower(model.embed, snap_dir, name="wdl",
                                staleness_bound=bound)
    engine = ServingEngine(gpt, num_slots=1, page_size=16,
                           ctr_model=model, ctr_follower=follower,
                           device=dev)
    return {"model": model, "follower": follower, "engine": engine,
            "bound": bound, "lat": [], "lags": [], "installs": [],
            "err": 0.0}


def stream_gate(rep):
    """The replica's gate, timed: ``(first, last, seconds)`` of the
    versions it installed, or None."""
    f = rep["follower"]
    before = f.installed
    t0 = time.perf_counter()
    f.gate()
    dt = time.perf_counter() - t0
    if f.installed == before:
        return None
    rep["installs"].append((before + 1, f.installed, dt))
    return rep["installs"][-1]


def stream_reference(trainer_embed, rep, dense, sparse, dev):
    """The trainer-side prediction: the replica's frozen tower over the
    rows ``pull_rows`` reads from the PS."""
    m = rep["model"]
    rows = torch.from_numpy(trainer_embed.pull_rows(sparse.ravel())).to(dev)
    d = torch.from_numpy(dense).to(dev)
    with torch.no_grad():
        logits = m.head(torch.cat([rows.reshape(d.shape[0], -1),
                                   m.deep(d)], dim=1))[:, 0]
    return torch.sigmoid(logits).cpu().numpy()


def stream_serve(rep, trainer_embed, dense, sparse, dev, check):
    """One ``infer_ctr`` request, timed; the lag after it within the
    bound; at bound 0 (``check``) every prediction within ``SERVE_TOL``
    of the trainer's."""
    t0 = time.perf_counter()
    pred = rep["engine"].infer_ctr(dense, sparse)
    rep["lat"].append(time.perf_counter() - t0)
    lag = rep["follower"].lag()
    rep["lags"].append(lag)
    assert lag <= rep["bound"], (rep["bound"], rep["follower"].stats())
    assert pred.shape == (sparse.shape[0],) and np.isfinite(pred).all()
    if check:
        err = float(np.abs(pred - stream_reference(
            trainer_embed, rep, dense, sparse, dev)).max())
        rep["err"] = max(rep["err"], err)
        assert err <= SERVE_TOL, err
    return pred


def stream_skips(publish_and_gate):
    """Run ``publish_and_gate()`` under a journal; the versions skipped,
    by reason."""
    from hetu_tpu_torch.obs import journal as obs_journal
    j = obs_journal.EventJournal()
    with obs_journal.use(j):
        publish_and_gate()
    return {e["version"]: e["reason"] for e in j.events
            if e["kind"] == "snapshot_skipped"}


def ps_stream_arms(card, dev="cuda", vpf=CMP_VPF, gpt_cfg=None):
    """(a) and (b): the trainer over four loopback servers, each timed
    step publishing a delta that two replicas serve.  The snapshots go
    under a fresh temporary directory, removed at the end."""
    import shutil
    import tempfile

    from hetu_tpu_torch.embed import EmbeddingServer
    n = CMP_FIELDS * vpf
    snap_dir = tempfile.mkdtemp(prefix="hetu_snapshots_")
    need = 2 * n * (8 + CMP_DIM * 4) + SNAP_MARGIN
    free = shutil.disk_usage(snap_dir).free
    print(f"snapshots under {snap_dir}: {free / 2**30:.1f} GiB free, "
          f"{need / 2**30:.1f} GiB needed (two full snapshots and a margin)")
    servers = []
    try:
        if free < need:
            raise RuntimeError(
                f"phase 14 needs {need} bytes of free disk for its "
                f"snapshots under {snap_dir}, only {free} are free")
        servers = [EmbeddingServer() for _ in range(PS_SHARDS)]
        return stream_run(card, dev, n, servers, snap_dir, gpt_cfg)
    finally:
        for srv in servers:
            srv.stop()
        shutil.rmtree(snap_dir, ignore_errors=True)


def stream_run(card, dev, n, servers, snap_dir, gpt_cfg):
    from hetu_tpu_torch import GPT, gpt2_small
    from hetu_tpu_torch.data import synthetic_ctr
    from hetu_tpu_torch.embed import SnapshotWriter
    from hetu_tpu_torch.embed import stream as snap
    steps = CMP_WARMUP + CMP_TIMED
    addrs = [f"127.0.0.1:{s.port}" for s in servers]
    t0 = time.perf_counter()
    model = ps_wdl(dict(vocab=n, embedding="remote", servers=addrs,
                        host_optimizer=PS_OPT, host_lr=PS_LR), dev)
    cmp_sync(dev)
    build_s = time.perf_counter() - t0
    emb = model.embed
    print(f"(a) Wide&Deep, {CMP_FIELDS} x {n // CMP_FIELDS} = {n} rows over "
          f"{PS_SHARDS} loopback servers ({', '.join(addrs)}; "
          f"{emb.tables[0].rows} rows a shard, {PS_OPT} {PS_LR} on the "
          f"servers), dim {CMP_DIM}, hidden {CMP_HIDDEN}, batch {CMP_BATCH}, "
          f"Adam {CMP_LR} on {dev}, fp32, TF32 off; tables built in "
          f"{build_s:.2f} s")
    data = synthetic_ctr(n=steps * CMP_BATCH + 2 * CMP_BATCH,
                         vocab_per_field=n // CMP_FIELDS)
    batches = cmp_batches(data, dev, steps + 2)
    rel, worst, ng = ps_step0(model, addrs, batches[0], dev)
    print(f"(a) step 0, {dev} vs CPU over the same servers: loss relative "
          f"difference {rel:.3e} (tol {CMP_LOSS_TOL:g}); worst of {ng} "
          f"gradients (the staged rows' included) {worst[1]} "
          f"{worst[0]:.3e} of its max (tol {CMP_GRAD_TOL:g})")
    tower0 = {k: v.detach().clone() for k, v in model.state_dict().items()
              if not k.startswith("embed.")}
    trainer = ps_trainer(model)
    pushes = []
    orig_push = emb.push_grads

    def timed_push(g):
        cmp_sync(dev)
        t = time.perf_counter()
        orig_push(g)
        pushes.append(time.perf_counter() - t)

    emb.push_grads = timed_push
    losses = []

    def one(b):
        cmp_sync(dev)
        t0 = time.perf_counter()
        emb.stage(b["sparse"])
        cmp_sync(dev)
        t1 = time.perf_counter()
        losses.append(trainer.step(b)["loss"])
        cmp_sync(dev)
        t2 = time.perf_counter()
        return t1 - t0, t2 - t1 - pushes[-1], pushes[-1], t2 - t0

    busy = None
    for i in range(CMP_WARMUP):
        if i == CMP_WARMUP - 1:
            busy = cmp_busy(lambda: one(batches[i]), dev)
            if busy is None:
                one(batches[i])
        else:
            one(batches[i])

    # (b) the writer attaches after the warm-up; version 1 is the full
    # table, pulled over the wire
    writer = SnapshotWriter(emb, snap_dir, name="wdl")
    t0 = time.perf_counter()
    v1 = writer.publish()
    full_pub = time.perf_counter() - t0
    full_bytes = sum(os.path.getsize(p) for p in (
        snap._payload_path(snap_dir, "wdl", v1),
        snap._manifest_path(snap_dir, "wdl", v1)))
    print(f"(b) version {v1}: the full table, {n} rows pulled over the "
          f"wire, published in {full_pub:.2f} s, {full_bytes} bytes")
    gpt = GPT(gpt_cfg or gpt2_small(),
              generator=torch.Generator().manual_seed(0), device=dev)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:   # their host tables init at once
        reps = dict(zip((0, 2), pool.map(
            lambda b: stream_replica(n, dev, tower0, b, snap_dir, gpt),
            (0, 2))))
    print(f"(b) two replicas (hbm, capacity {PS_HBM_CAPACITY}, pull bound "
          f"2, own host tables of {n} rows) built in "
          f"{time.perf_counter() - t0:.2f} s; staleness bounds 0 and 2")
    full_install = stream_gate(reps[0])       # bound 0: lag 1 > 0
    assert full_install == (1, v1, full_install[2]), full_install
    print(f"(b) bound 0 installed the full snapshot in "
          f"{full_install[2]:.2f} s; bound 2 waits until it lags by 3")
    sdata = synthetic_ctr(n=CMP_TIMED * SERVE_REQS * SERVE_ROWS,
                          vocab_per_field=n // CMP_FIELDS, seed=7)
    timed, deltas = [], []
    emb.loads(reset=True)
    for i in range(CMP_TIMED):
        timed.append(one(batches[CMP_WARMUP + i]))
        t0 = time.perf_counter()
        v = writer.publish()
        pub = time.perf_counter() - t0
        body = snap.read_snapshot(snap_dir, "wdl", v)[0]
        assert not body["full"]
        installs = {}
        for b, rep in reps.items():
            installs[b] = stream_gate(rep)
            for r in range(SERVE_REQS):
                lo = (i * SERVE_REQS + r) * SERVE_ROWS
                stream_serve(rep, emb, sdata["dense"][lo:lo + SERVE_ROWS],
                             sdata["sparse"][lo:lo + SERVE_ROWS], dev,
                             check=b == 0)
        deltas.append((v, body["rows"], pub, installs))
    cmp_sync(dev)
    loads = emb.loads()
    emb.push_grads = orig_push
    losses = [float(x) for x in losses]
    stage, device, push, step = (statistics.median(t[k] for t in timed)
                                 for k in range(4))
    print(f"(a) {CMP_TIMED} timed steps: median {step * 1e3:.3f} ms, "
          f"{CMP_BATCH / step:.1f} samples/s; stage {stage * 1e3:.3f} ms, "
          f"device {device * 1e3:.3f} ms, push {push * 1e3:.3f} ms; device "
          + ("busy not measured" if busy is None else
             f"busy {busy[0]:.3f} ms of a profiled {busy[1]:.3f} ms step "
             f"({busy[0] / busy[1]:.1%})")
          + f"; {ps_wire_bytes(loads) / CMP_TIMED:.0f} payload bytes over "
          f"the wire a step (rows pulled {int(loads['pull_rows'].sum())}, "
          f"pushed {int(loads['push_rows'].sum())} in {CMP_TIMED} steps); "
          f"loss {losses[0]:.6f} at step 0, {losses[-1]:.6f} after "
          f"{len(losses)}; {card}")
    assert all(np.isfinite(losses)), losses
    for s, t in enumerate(emb.tables):
        ld = t.get_loads()
        print(f"(a) server {s} get_loads: pull_reqs {ld['pull_reqs']}, "
              f"push_reqs {ld['push_reqs']}, pull_rows {ld['pull_rows']}, "
              f"push_rows {ld['push_rows']}")
    for v, rows, pub, inst in deltas:
        print(f"(b) delta v{v}: {rows} rows, published in {pub * 1e3:.1f} "
              f"ms; " + "; ".join(
                  f"bound {b} " + ("installed nothing" if inst[b] is None
                                   else f"installed v{inst[b][0]}-"
                                   f"v{inst[b][1]} in "
                                   f"{inst[b][2] * 1e3:.1f} ms")
                  for b in (0, 2)))
    out = {"median_ms": step * 1e3, "samples_per_s": CMP_BATCH / step,
           "split_ms": (stage * 1e3, device * 1e3, push * 1e3),
           "busy": busy, "wire_bytes": ps_wire_bytes(loads) / CMP_TIMED,
           "full_publish_s": full_pub, "full_bytes": full_bytes,
           "build_s": build_s, "deltas": deltas}
    for b, rep in reps.items():
        lat = sorted(rep["lat"])
        p50 = statistics.median(lat)
        p99 = lat[min(len(lat) - 1, math.ceil(0.99 * len(lat)) - 1)]
        full = next(dt for a, z, dt in rep["installs"] if a <= v1 <= z)
        hs = rep["model"].embed.hit_stats()
        print(f"(b) bound {b}: {len(lat)} infer_ctr requests of "
              f"{SERVE_ROWS} rows, p50 {p50 * 1e3:.3f} ms, p99 "
              f"{p99 * 1e3:.3f} ms; the gate that installed the full "
              f"snapshot took {full:.2f} s; lag after each request max "
              f"{max(rep['lags'])} (bound {b}); HBM hit rate "
              f"{hs['hit_rate']:.4f} ({hs['hits']} hits, {hs['misses']} "
              f"misses, {hs['overflows']} overflows); follower "
              f"{rep['follower'].stats()}"
              + (f"; every prediction within {rep['err']:.3e} of the "
                 f"trainer's (tol {SERVE_TOL:g})" if b == 0 else ""))
        out[f"bound{b}"] = {"p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
                            "full_install_s": full,
                            "hit_rate": hs["hit_rate"]}

    # bound 0 serves what was installed, not the HBM copy: a request of a
    # training batch's ids, its rows resident, then that batch trained and
    # published; the replica never pushes, so only invalidate_rows makes
    # it re-pull them
    rep = reps[0]
    last = batches[steps]
    ids = last["sparse"].cpu().numpy()[:SERVE_ROWS]
    dense = last["dense"].cpu().numpy()[:SERVE_ROWS]
    before = stream_serve(rep, emb, dense, ids, dev, check=True)
    emb.stage(last["sparse"])
    trainer.step(last)
    writer.publish()
    after = stream_serve(rep, emb, dense, ids, dev, check=True)
    moved = float(np.abs(after - before).max())
    assert moved > SERVE_TOL, moved
    print(f"(b) bound 0, invalidation: a request of resident rows, then "
          f"those rows trained and published: the prediction moved by up "
          f"to {moved:.3e} and equals the trainer's within {rep['err']:.3e}")

    # a damaged delta is skipped as crc, the next as missing_base, and a
    # full snapshot re-anchors the replica
    f = rep["follower"]
    extra = batches[steps + 1]

    def train_publish():
        emb.stage(extra["sparse"])
        trainer.step(extra)
        return writer.publish()

    def corrupt_then_gate():
        v = train_publish()
        ppath = snap._payload_path(snap_dir, "wdl", v)
        rows = snap.read_snapshot(snap_dir, "wdl", v)[0]["rows"]
        with open(ppath, "r+b") as fh:
            fh.seek(rows * 8 + 3)           # a byte of the first row
            b = fh.read(1)
            fh.seek(rows * 8 + 3)
            fh.write(bytes([b[0] ^ 0x10]))
        stream_gate(rep)

    kept = f.installed
    skipped = stream_skips(corrupt_then_gate)
    assert list(skipped.values()) == ["crc"] and f.installed == kept, skipped
    skipped.update(stream_skips(lambda: (train_publish(),
                                         stream_gate(rep))))
    assert list(skipped.values()) == ["crc", "missing_base"], skipped
    assert f.installed == kept
    t0 = time.perf_counter()
    vf = writer.publish(full=True)
    t1 = time.perf_counter()
    stream_gate(rep)
    t2 = time.perf_counter()
    assert f.installed == vf, f.stats()
    stream_serve(rep, emb, dense, ids, dev, check=True)
    cmp_sync(dev)
    print(f"(b) damaged v{min(skipped)}: skipped {skipped}; full v{vf} "
          f"re-anchored the replica in {t2 - t0:.2f} s (publish "
          f"{t1 - t0:.2f} s, install {t2 - t1:.2f} s): its time to recover; "
          f"served within {rep['err']:.3e} of the trainer after it; {card}")
    out["reanchor_s"] = (t2 - t0, t1 - t0, t2 - t1)
    out["skipped"] = skipped
    for r in reps.values():
        del r["engine"], r["model"], r["follower"]
    del reps, gpt, trainer, model, emb, writer
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def psdp_loss(model, b, key):
    """bench.py config 1's loss: ResNet in training mode (its BatchNorms
    update their statistics, local to each worker)."""
    from hetu_tpu_torch.ops import softmax_cross_entropy_sparse
    logits, new_model = model(b["x"], training=True)
    return softmax_cross_entropy_sparse(logits, b["y"]).mean(), {
        "model": new_model}


def psdp_worker(rank, port, dev="cuda", batch=PSDP_BATCH):
    """(c) one BSP worker: ResNet-18 through ``PSDataParallel`` against the
    server at ``port``; prints one ``PSDP`` JSON line a step (its
    parameters' fingerprint, loss and times) and, on worker 0, the
    step-0 loss against the CPU."""
    from hetu_tpu_torch import cifar10, resnet18
    from hetu_tpu_torch.embed import PSDataParallel
    from hetu_tpu_torch.obs.numerics import fingerprint, host_combine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x, y, _, _ = cifar10()
    model = resnet18(num_classes=10,
                     generator=torch.Generator().manual_seed(0), device=dev)
    ps = PSDataParallel(model, psdp_loss, [f"127.0.0.1:{port}"],
                        optimizer="sgd", lr=PSDP_LR, worker=rank, world=2,
                        mode="bsp", group_id=14, device=dev)
    lo = rank * PSDP_STEPS * batch   # each worker its own shard
    for i in range(PSDP_STEPS):
        s = slice(lo + i * batch, lo + (i + 1) * batch)
        b = {"x": torch.from_numpy(x[s]).to(dev),
             "y": torch.from_numpy(y[s]).to(dev)}
        if rank == 0 and i == 0:
            cpu = copy.deepcopy(model).cpu()
            want = float(psdp_loss(cpu, {k: v.cpu() for k, v in b.items()},
                                   None)[0])
            del cpu
        cmp_sync(dev)
        t0 = time.perf_counter()
        loss = float(ps.step(b)["loss"])
        wall = time.perf_counter() - t0
        fp = host_combine(int(fingerprint(p)) for p in model.parameters())
        rec = {"rank": rank, "step": i, "fp": fp, "loss": loss,
               "ms": wall * 1e3,
               **{k: v * 1e3 for k, v in ps.last_step_s.items()}}
        if rank == 0 and i == 0:
            rec["cpu_loss"] = want
        print("PSDP " + json.dumps(rec), flush=True)
    return 0


def psdp_arm(card, dev="cuda", batch=PSDP_BATCH):
    """(c) two worker processes against one loopback server; their
    fingerprints equal at every step, worker 0's step-0 loss within
    ``PSDP_TOL`` of the CPU's."""
    from hetu_tpu_torch.embed import EmbeddingServer
    t0 = time.perf_counter()
    with EmbeddingServer() as srv:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--ps-dp-worker",
             str(r), str(srv.port), dev, str(batch)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(30)
    wall = time.perf_counter() - t0
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    recs = [[json.loads(ln[5:]) for ln in out.splitlines()
             if ln.startswith("PSDP ")] for out in outs]
    assert all(len(r) == PSDP_STEPS for r in recs), outs
    for a, b in zip(*recs):
        assert a["fp"] == b["fp"], (a, b)
    first = recs[0][0]
    rel = abs(first["loss"] - first["cpu_loss"]) / abs(first["cpu_loss"])
    assert rel <= PSDP_TOL, first
    losses = [r["loss"] for r in recs[0]]
    assert np.isfinite(losses).all(), losses
    med = {k: statistics.median(r[k] for r in recs[0][1:])
           for k in ("ms", "grad", "push", "sync", "pull")}
    print(f"(c) ResNet-18 / CIFAR-10 shapes, batch {batch}, fp32, "
          f"PSDataParallel bsp, sgd {PSDP_LR} on one loopback server, two "
          f"worker processes on one {dev}: {PSDP_STEPS} steps, fingerprints "
          f"equal at every step ({', '.join(str(r['fp']) for r in recs[0][:3])}"
          f", ...); worker 0's step-0 loss {first['loss']:.6f} vs CPU "
          f"{first['cpu_loss']:.6f} (relative {rel:.3e}, tol {PSDP_TOL:g}); "
          f"median step {med['ms']:.3f} ms (grad {med['grad']:.3f}, push "
          f"{med['push']:.3f}, barriers {med['sync']:.3f}, pull "
          f"{med['pull']:.3f}); loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{wall:.1f} s with the processes' start; {card}")
    return {"median_ms": med["ms"], "split_ms": med, "rel": rel}


def graph_arm(card, dev="cuda", steps=GRAPH_STEPS):
    """(d) phase 12's GCN on ``arxiv_sbm()``, trained on 2-hop subgraphs
    sampled by a graph server (``examples/train_gnn.py --sample
    --graph-server local``); a second client uploading with the same seed
    draws the same subgraphs."""
    from hetu_tpu_torch import GCN, AdamOptimizer, Trainer
    from hetu_tpu_torch import normalize_adjacency
    from hetu_tpu_torch.embed import EmbeddingServer, RemoteGraph
    from hetu_tpu_torch.ops import softmax_cross_entropy_sparse
    edges, x, y, _ = arxiv_sbm()
    n = x.shape[0]
    xd, yd = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    def loss_fn(m, b, k):
        logits = m(b["x"], b["ei"], b["ew"], key=k, training=True)
        return softmax_cross_entropy_sparse(logits, b["y"]).mean(), {}

    with EmbeddingServer() as srv:
        addr = f"127.0.0.1:{srv.port}"
        t0 = time.perf_counter()
        a = RemoteGraph(addr, 1, edges, num_nodes=n, seed=GRAPH_SEED)
        upload = time.perf_counter() - t0
        b = RemoteGraph(addr, 2, edges, num_nodes=n, seed=GRAPH_SEED)
        model = GCN(ARXIV_FEATS, GCN_HIDDEN, ARXIV_CLASSES, num_layers=3,
                    dropout_rate=0.5,
                    generator=torch.Generator().manual_seed(0), device=dev)
        trainer = Trainer(model, AdamOptimizer(GCN_LR), loss_fn)
        rng = np.random.default_rng(0)
        sample_s, step_s, sizes, losses = [], [], [], []
        for _ in range(steps):
            seeds = rng.integers(0, n, GRAPH_SEEDS)
            t0 = time.perf_counter()
            nodes, sub, _pos = a.sample_subgraph(seeds, GRAPH_HOPS,
                                                 GRAPH_FANOUT)
            t1 = time.perf_counter()
            ei, ew = normalize_adjacency(sub, len(nodes), device=dev)
            idx = torch.from_numpy(nodes).to(dev)
            out = trainer.step({"x": xd[idx], "y": yd[idx], "ei": ei,
                                "ew": ew})
            losses.append(float(out["loss"]))
            cmp_sync(dev)
            t2 = time.perf_counter()
            for p, q in zip((nodes, sub, _pos), b.sample_subgraph(
                    seeds, GRAPH_HOPS, GRAPH_FANOUT)):
                assert np.array_equal(p, q), "the second client differs"
            sample_s.append(t1 - t0)
            step_s.append(t2 - t1)
            sizes.append((len(nodes), sub.shape[1]))
    assert np.isfinite(losses).all(), losses
    sm, st = (statistics.median(v) * 1e3 for v in (sample_s, step_s))
    print(f"(d) GCN(128, 256, 40, 3 layers) on arxiv_sbm() ({n} nodes, "
          f"{edges.shape[1]} directed edges; uploaded in {upload:.2f} s), "
          f"{steps} steps of {GRAPH_SEEDS} seeds, fanout {GRAPH_FANOUT}, "
          f"{GRAPH_HOPS} hops: median sample {sm:.3f} ms, median step "
          f"{st:.3f} ms (normalize, gather, Adam step); subgraphs "
          f"{min(s[0] for s in sizes)}-{max(s[0] for s in sizes)} nodes, "
          f"{min(s[1] for s in sizes)}-{max(s[1] for s in sizes)} edges; a "
          f"second client with seed {GRAPH_SEED} drew the same {steps} "
          f"subgraphs; loss {losses[0]:.4f} -> {losses[-1]:.4f}; {card}")
    return {"sample_ms": sm, "step_ms": st}


def ps_phase(card, dev="cuda", vpf=CMP_VPF, gpt_cfg=None,
             psdp_batch=PSDP_BATCH, graph_steps=GRAPH_STEPS):
    """Phase 14, (a)-(d).  Returns the arms' readings and the seconds."""
    t0 = time.perf_counter()
    out = {"stream": ps_stream_arms(card, dev, vpf, gpt_cfg)}
    out["psdp"] = psdp_arm(card, dev, psdp_batch)
    out["graph"] = graph_arm(card, dev, graph_steps)
    cmp_sync(dev)
    return out, time.perf_counter() - t0


# phase 15: GPT-2 small served as a fleet on the one card, at phase 4's
# 1024-token window.  Arm (c) alone cuts it to 256 tokens (16 pages of
# 16) so that the draft models' full-context proposals stay cheap; the
# widths are GPT-2 small's.
FLEET_SEQ, FLEET_SPEC_SEQ, FLEET_SLOTS, FLEET_PAGE = 1024, 256, 8, 16
FLEET_BUCKETS = (16, 32, 64, 128, 256)
FLEET_SEED, FLEET_SPEC_K = 11, 4
FLEET_PD_TOL, FLEET_LH_TOL = 2e-5, 1e-4     # phase 3's tolerances


class FleetClock:
    """Phase 15's virtual clock: the deterministic runs advance it by one
    millisecond a scheduler tick, so schedules replay bitwise."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def fleet_engine(model, clock=None, **kw):
    from hetu_tpu_torch import ServingEngine
    kw.setdefault("num_slots", FLEET_SLOTS)
    kw.setdefault("seed", FLEET_SEED)
    kw.setdefault("max_seq_len", FLEET_SEQ)
    return ServingEngine(model, page_size=FLEET_PAGE,
                         prompt_buckets=FLEET_BUCKETS,
                         clock=clock or time.monotonic, device=model.device,
                         **kw)


def fleet_idle(target):
    return target.batcher.idle if hasattr(target, "batcher") \
        else target.idle


def fleet_drive(target, clock, trace, submit, between=None,
                max_ticks=100_000):
    """Submit each trace item when the virtual clock reaches it, step the
    engine or router until idle; ``between(tick)`` runs after each tick.
    Returns the handles in trace order and the ticks taken."""
    handles, i, ticks = [], 0, 0
    while i < len(trace) or not fleet_idle(target):
        while i < len(trace) and trace[i].submit_at <= clock.t:
            handles.append(submit(trace[i]))
            i += 1
        target.step()
        clock.t += 0.001
        ticks += 1
        if between is not None:
            between(ticks)
        assert ticks < max_ticks, "fleet wedged"
    return handles, ticks


def fleet_streams(handles):
    return [(h.status, tuple(h.tokens)) for h in handles]


def fleet_sync(dev):
    if dev == "cuda" or getattr(dev, "type", None) == "cuda":
        torch.cuda.synchronize()


def fleet_counts(pd, lh):
    return pd.launch_count(), lh.launch_count()


def fleet_reset(pd, lh):
    pd.reset_launch_count()
    lh.reset_launch_count()


def page_bytes_read(tables, lens, page, per_pos):
    """The K/V bytes a paged-decode call must read at least: each distinct
    page once, as far as the longest row that reads it reaches."""
    used = {}
    for row, n in zip(tables, lens):
        for j in range(-(-int(n) // page)):
            p = int(row[j])
            used[p] = max(used.get(p, 0), min(page, int(n) - j * page))
    return 2 * sum(used.values()) * per_pos


class FleetSnapshot:
    """A live shape kept for the kernel check: page tables, attention
    lengths, and a copy of the engine's pool as it stood, taken at the
    qualifying tick whose rows reach furthest, so that the check runs
    after the arm's launch counts were read."""

    def __init__(self):
        self.reach = -1
        self.k = self.v = None

    def offer(self, eng, tables, lens):
        if sum(lens) <= self.reach:
            return
        self.reach = sum(lens)
        self.tables, self.lens = np.asarray(tables).copy(), list(lens)
        self.cfg, self.head = eng.model.config, eng.model._head().detach()
        if self.k is None:
            self.k, self.v = eng.pool.k.clone(), eng.pool.v.clone()
        else:
            self.k.copy_(eng.pool.k)
            self.v.copy_(eng.pool.v)

    @property
    def taken(self) -> bool:
        return self.k is not None


def fleet_kernel_check(pd, lh, snap, label, flush, dev):
    """Rows 1 and 2 at a live shape kept by a :class:`FleetSnapshot`:
    paged decode over its tables and lengths (aliased pages or the verify
    step's chained rows) and its copy of the pool against its plain
    version (phase 3's 2e-5), its first and last rows served alone
    bitwise; LM-head sampling at the same row count with the model's
    head against its plain version (1e-4, indices where the top values
    are separated), each row group of 8 served alone bitwise.  Timed on
    the card; returns the readings.  Called after the arm's counts were
    read: these launches compare, they are not the main path's."""
    tables, lens, cfg = snap.tables, snap.lens, snap.cfg
    H, D, E = cfg.num_heads, cfg.hidden_size // cfg.num_heads, \
        cfg.hidden_size
    N = len(lens)
    g = torch.Generator().manual_seed(N)
    q = torch.randn((N, H, D), generator=g).to(dev)
    t = torch.as_tensor(np.asarray(tables), dtype=torch.int32).to(dev)
    sl = torch.as_tensor(np.asarray(lens), dtype=torch.int32).to(dev)
    layer = cfg.num_layers - 1
    k, v = snap.k, snap.v
    out = pd.paged_decode_attention(q, k, v, t, sl, layer=layer)
    ref = pd.paged_decode_attention_plain(q, k, v, t, sl, layer=layer)
    pd_err = (out - ref).abs().max().item()
    assert torch.isfinite(out).all() and pd_err <= FLEET_PD_TOL, \
        f"{label}: paged decode {pd_err} > {FLEET_PD_TOL}"
    # the kernels are row-invariant by construction (the CPU's plain
    # versions are not, so the rehearsal skips this)
    for r in ((0, N - 1) if flush is not None else ()):
        alone = pd.paged_decode_attention(
            q[r:r + 1].contiguous(), k, v, t[r:r + 1].contiguous(),
            sl[r:r + 1].contiguous(), layer=layer)
        assert torch.equal(alone[0], out[r]), f"{label}: row {r} alone"
    head = snap.head
    h = torch.randn((N, E), generator=g).to(dev)
    vals, idx = lh.lm_head_sample(h, head, k=1)
    pv, pi = lh.lm_head_sample_plain(h, head, k=2)
    lh_err = (vals - pv[:, :1]).abs().max().item()
    sep = (pv[:, 0] - pv[:, 1]) > FLEET_LH_TOL
    assert lh_err <= FLEET_LH_TOL, f"{label}: lm_head {lh_err}"
    assert bool(((idx[:, 0] == pi[:, 0]) | ~sep).all()), \
        f"{label}: lm_head index beyond a tie"
    for r0 in (range(0, N, 8) if flush is not None else ()):
        v8, i8 = lh.lm_head_sample(h[r0:r0 + 8].contiguous(), head, k=1)
        assert torch.equal(v8, vals[r0:r0 + 8]) and \
            torch.equal(i8, idx[r0:r0 + 8]), f"{label}: rows {r0}+ alone"
    shared = tables_alias(tables)
    row = {"rows": N, "aliased": shared, "pd_err": pd_err,
           "lh_err": lh_err, "pd_ms": None, "pd_plain_ms": None,
           "pd_bound_ms": None, "lh_ms": None, "lh_plain_ms": None,
           "lh_bound_ms": None}
    if flush is not None:
        per_pos = H * D * 4
        nbytes = page_bytes_read(np.asarray(tables), lens, FLEET_PAGE,
                                 per_pos) + 2 * N * H * D * 4 \
            + t.numel() * 4 + N * 4
        row["pd_bound_ms"] = bound(nbytes, 4 * int(sum(lens)) * H * D,
                                   torch.float32)[0]
        row["pd_ms"] = time_ms(lambda: pd.paged_decode_attention(
            q, k, v, t, sl, layer=layer), flush, reps=20)
        row["pd_plain_ms"] = time_ms(lambda: pd.paged_decode_attention_plain(
            q, k, v, t, sl, layer=layer), flush, reps=5)
        V = head.shape[0]
        row["lh_bound_ms"] = bound(V * E * 4 + N * E * 4 + N * 8,
                                   2 * N * E * V, torch.float32)[0]
        row["lh_ms"] = time_ms(lambda: lh.lm_head_sample(h, head, k=1),
                               flush, reps=20)
        row["lh_plain_ms"] = time_ms(
            lambda: lh.lm_head_sample_plain(h, head, k=1), flush, reps=5)
    times = ("" if flush is None else
             f"; paged_decode {row['pd_ms']:.4f} ms (plain "
             f"{row['pd_plain_ms']:.4f}, bound {row['pd_bound_ms']:.4f}), "
             f"lm_head_sample {row['lh_ms']:.4f} ms (plain "
             f"{row['lh_plain_ms']:.4f}, bound {row['lh_bound_ms']:.4f})")
    fleet_sync(dev)
    print(f"  kernels at {label}: {N} rows, lengths {min(lens)}-{max(lens)}"
          f"{', tables alias shared pages' if shared else ''}: paged_decode "
          f"max_abs_err {pd_err:.3e} tol {FLEET_PD_TOL:g}, rows alone "
          f"bitwise; lm_head_sample max_abs_err {lh_err:.3e} tol "
          f"{FLEET_LH_TOL:g}, row groups alone bitwise{times}")
    return row


def tables_alias(tables) -> bool:
    """Whether two different page tables name one page (rows that share
    one table, the verify step's chained rows, do not count)."""
    seen = {}
    for row in {tuple(int(p) for p in r) for r in np.asarray(tables)}:
        for p in set(row) - {0}:
            seen[p] = seen.get(p, 0) + 1
    return any(c > 1 for c in seen.values())


def live_tables(eng):
    """The active slots' page tables and attention lengths (the fed
    token's position included), as the next decode step reads them."""
    act = eng.batcher.active()
    ids = [r.id for _s, r in act]
    return (eng.pool.table_rows(ids),
            [eng.pool.table(i).length + 1 for i in ids])


def fleet_tenants(model, pd, lh, card, dev, n=32):
    """(a) Two tenants, WFQ weights 3:1, a quota on one and a shed latch
    engaged on it halfway through the submissions."""
    from hetu_tpu_torch.serve import (Tenant, TenantPolicy, TokenBucket,
                                      generate_multitenant_load)
    V = model.config.vocab_size
    specs = [{"id": "gold", "share": 0.5, "prompt_len": (8, 96),
              "max_new": (8, 24)},
             {"id": "bronze", "share": 0.5, "prompt_len": (8, 96),
              "max_new": (8, 24)}]
    trace = generate_multitenant_load(FLEET_SEED, n, vocab=V, tenants=specs)
    policy = TenantPolicy([Tenant(id="gold", weight=3.0),
                           Tenant(id="bronze", klass="batch", weight=1.0)],
                          quotas={"bronze": TokenBucket(600.0, 100.0)})
    eng = fleet_engine(model, tenants=policy)
    fleet_sync(dev)
    fleet_reset(pd, lh)
    handles = []
    for i, it in enumerate(trace):
        if i == n // 2:
            eng.batcher.set_tenant_shed("bronze", "phase 15 latch")
        if i == n // 2 + 6:
            eng.batcher.clear_tenant_shed("bronze")
        handles.append((it.tenant, eng.submit(list(it.prompt),
                                              it.max_new_tokens,
                                              tenant=it.tenant)))
    t0 = time.perf_counter()
    eng.run_until_idle()
    fleet_sync(dev)
    wall = time.perf_counter() - t0
    steps = eng.stats()["decode_steps"]
    pdn, lhn = fleet_counts(pd, lh)
    done = [(t, h) for t, h in handles if h.status == "completed"]
    shed = {}
    for _t, h in handles:
        if h.status == "rejected":
            shed[h.shed_reason] = shed.get(h.shed_reason, 0) + 1
    assert {"quota", "controller"} <= set(shed), shed
    assert all(t == "bronze" for t, h in handles if h.status == "rejected")
    if dev == "cuda":
        assert pdn == model.config.num_layers * steps > 0 and lhn == steps
    # each request's stream: the same request on a one-tenant engine
    plain = fleet_engine(model)
    again = [plain.submit(list(it.prompt), it.max_new_tokens,
                          request_id=h.request_id)
             for it, (_t, h) in zip(trace, handles)
             if h.status == "completed"]
    plain.run_until_idle()
    assert [h.tokens for _t, h in done] == [h.tokens for h in again], \
        "a tenant's stream differs from the one-tenant engine's"
    ttft = {}
    for t, h in done:
        ttft.setdefault(t, []).append(h.ttft_s * 1e3)
    q = {t: (statistics.median(v), float(np.percentile(v, 99)))
         for t, v in ttft.items()}
    tokens = sum(len(h.tokens) for _t, h in done)
    print(f"(a) tenants gold (weight 3) / bronze (weight 1, quota 600 "
          f"tokens + 100/s, latch over 6 submissions): {len(done)}/{n} "
          f"completed, shed {shed}, all on bronze; TTFT p50/p99 "
          + ", ".join(f"{t} {a:.2f}/{b:.2f} ms" for t, (a, b) in
                      sorted(q.items()))
          + f"; {tokens} tokens in {wall:.3f} s; launches paged_decode "
          f"{pdn}, lm_head_sample {lhn} ({steps} decode steps); every "
          f"stream equals the one-tenant engine's (bitwise); {card}")
    return {"ttft_ms": q, "shed": shed, "launches": (pdn, lhn)}


def fleet_prefix(model, pd, lh, card, dev, flush, n=24, prefix=192):
    """(b) Prefix sharing under a template-heavy load."""
    from hetu_tpu_torch.obs import journal
    from hetu_tpu_torch.serve import generate_shared_prefix_load
    from hetu_tpu_torch.serve import kv_cache as kvc
    V = model.config.vocab_size
    trace = generate_shared_prefix_load(
        FLEET_SEED, n, vocab=V, n_templates=2, prefix_len=prefix,
        suffix_len=(4, 32), max_new=(8, 16), shared_fraction=0.75,
        unique_len=(8, 160), mean_gap_s=0.004)

    def run(sharing, snap=None):
        clock = FleetClock()
        eng = fleet_engine(model, clock, prefix_sharing=sharing)
        jr = journal.EventJournal(clock=clock)
        kvc.reset_pages_written_count()
        fleet_reset(pd, lh)

        def between(tick):
            if snap is not None:
                tables, lens = live_tables(eng)
                if tables_alias(tables):
                    snap.offer(eng, tables, lens)

        t0 = time.perf_counter()
        with journal.use(jr):
            handles, _ = fleet_drive(
                eng, clock, trace,
                lambda it: eng.submit(list(it.prompt), it.max_new_tokens),
                between)
        fleet_sync(dev)
        wall = time.perf_counter() - t0
        return (eng, handles, jr, kvc.pages_written_count(),
                fleet_counts(pd, lh), wall)

    base = run(False)
    snap = FleetSnapshot()
    eng, handles, jr, written, launches, wall = run(True, snap)
    assert fleet_streams(handles) == fleet_streams(base[1]), \
        "sharing changed a stream"
    assert snap.taken, "no decode step read aliased tables"
    shares = {e["request_id"]: e["shared_tokens"]
              for e in jr.of_kind("prefix_share")}
    for tid in {it.template for it in trace if it.template is not None}:
        rids = [h.request_id for it, h in zip(trace, handles)
                if it.template == tid]
        assert [rid for rid in rids if shares.get(rid) != prefix] \
            == rids[:1], f"template {tid}: a prefix page was written twice"
    need = sum(eng.pool.pages_needed(len(it.prompt)) for it in trace)
    saved = sum(shares.values()) // FLEET_PAGE
    assert written == need - saved and base[3] == need, (written, need)
    steps = eng.stats()["decode_steps"]
    if dev == "cuda":
        assert launches[0] == model.config.num_layers * steps > 0
        assert launches[1] == steps
    cow = eng.pool.stats()["cow_pages"]
    row = fleet_kernel_check(pd, lh, snap, "aliased prefix tables", flush,
                             dev)
    del snap
    n_bits, p_bits = fleet_prefill_bits(model, dev)
    print(f"(b) prefix sharing, {n} requests (2 templates of {prefix} "
          f"tokens, 75% shared): streams equal the unshared engine's "
          f"(bitwise); pages written {written} (unshared {base[3]}), "
          f"{saved} prefix pages aliased, 0 written twice; copy-on-write "
          f"pages {cow}; launches paged_decode {launches[0]}, "
          f"lm_head_sample {launches[1]}; wall {wall:.3f} s (unshared "
          f"{base[5]:.3f} s); a {n_bits}-token prompt after a shared "
          f"{p_bits}-token prefix: K/V pages and first logits bitwise "
          f"those of its unshared prefill; {card}")
    return {"written": written, "unshared": base[3], "cow": cow,
            "kernels": row, "launches": launches}


def fleet_prefill_bits(model, dev, prefix=112):
    """A prompt prefilled whole (bucket 128) against the same prompt
    after another request published its first ``prefix`` tokens (written
    by a prefill at bucket 256; the suffix of 5 tokens at bucket 16): the
    prompt's K/V pages and the first token's logits bitwise equal.  The
    prefill runs its products in blocks of one page; F.linear alone gives
    a row other bits at 16 rows than at 256 (the (c) info line)."""
    V = model.config.vocab_size
    rng = np.random.default_rng(FLEET_SEED)
    tmpl = rng.integers(0, V, prefix).tolist()
    first = tmpl + rng.integers(0, V, 100).tolist()
    second = tmpl + rng.integers(0, V, 5).tolist()
    got = []
    for sharing in (False, True):
        eng = fleet_engine(model, prefix_sharing=sharing)
        seen = []
        sample = eng._sample_impl
        eng._sample_impl = lambda lg, *a: (seen.append(lg.clone()),
                                           sample(lg, *a))[1]
        eng.submit(first, 2)
        eng.run_until_idle()
        h = eng.submit(second, 4)
        eng.step()
        pages = eng.pool.table(h.request_id).pages
        kv = [t[:, pages].flatten(1, 2)[:, :len(second)].clone()
              for t in (eng.pool.k, eng.pool.v)]
        got.append((seen[-1], kv, eng.stats()["prefills"]))
        eng.run_until_idle()
        del eng
    (la, kva, _), (lb, kvb, _) = got
    assert torch.equal(la, lb), "a shared prefill's logits differ"
    assert all(torch.equal(a, b) for a, b in zip(kva, kvb)), \
        "a shared prefill's K/V pages differ"
    return len(second), prefix


def fleet_row_invariance(model, dev, S=FLEET_SLOTS, W=FLEET_SPEC_K + 1):
    """For information: whether the card's GEMMs give a row the same bits
    at S x W rows as at S rows (GPT-2 small's four products), and the
    eager verify step's time with its products in row blocks of S against
    one product of S x W rows."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(5)
    same = {}
    blk = model.blocks[0]
    mats = {"qkv": blk.attn.wqkv, "out": blk.attn.wo, "mlp_in": blk.mlp.w_in,
            "mlp_out": blk.mlp.w_out}
    for name, w in mats.items():
        x = torch.randn((FLEET_BUCKETS[-1], w.shape[1]), generator=g).to(dev)
        with torch.no_grad():
            same[name] = (
                torch.equal(F.linear(x[:S], w), F.linear(x[:S * W], w)[:S]),
                # a prefill's rows at two buckets (why the engine prefills
                # in page-sized chunks)
                torch.equal(F.linear(x[:FLEET_BUCKETS[0]], w),
                            F.linear(x, w)[:FLEET_BUCKETS[0]]))
    return same


def fleet_verify_cost(model, dev, S=FLEET_SLOTS, W=FLEET_SPEC_K + 1):
    """Eager verify steps at S x W rows, products in blocks of S against
    one product of all rows: tokens and pool bytes compared, times taken
    with the card's events (for information)."""
    eng = fleet_engine(model, max_seq_len=FLEET_SPEC_SEQ)
    g = torch.Generator().manual_seed(6)
    for sid in range(S):
        eng.pool.alloc(sid, 100 + W)
        eng.pool.table(sid).length = 100
    with torch.no_grad():
        eng.pool.k.normal_(generator=None)
        eng.pool.v.normal_(generator=None)
    tables = np.repeat(eng.pool.table_rows(list(range(S))), W, axis=0)
    index = np.array([100 + j for _ in range(S) for j in range(W)],
                     np.int32)
    toks = torch.randint(0, model.config.vocab_size, (S * W, 1),
                         generator=g).numpy()
    rids = np.repeat(np.arange(S, dtype=np.int32), W)
    args = [eng._tensor(a) for a in (tables, index, toks, rids, index + 1)]
    k0, v0 = eng.pool.k.clone(), eng.pool.v.clone()
    outs = {}
    for rb in (S, 0):
        eng.pool.k.copy_(k0)
        eng.pool.v.copy_(v0)
        with torch.no_grad():
            outs[rb] = (eng._paged_decode_impl(*args, row_block=rb).tolist(),
                        eng.pool.k.clone())
    equal_tokens = outs[S][0] == outs[0][0]
    equal_kv = torch.equal(outs[S][1], outs[0][1])
    ms = {}
    if dev == "cuda":
        for rb in (S, 0, S, 0):
            def f(rb=rb):
                with torch.no_grad():
                    eng._paged_decode_impl(*args, row_block=rb)
            ms.setdefault(rb, []).append(time_ms(f, torch.empty(
                FLUSH_BYTES, dtype=torch.uint8, device=dev), reps=10))
    del eng, k0, v0
    return equal_tokens, equal_kv, {rb: min(v) for rb, v in ms.items()}


def fleet_spec(model, pd, lh, card, dev, flush, n=16):
    """(c) Speculative decoding, k = 4, with a 2-layer draft of GPT-2's
    widths in greedy, temperature and top-k, and the target as its own
    (perfect) draft."""
    from hetu_tpu_torch import GPT
    from hetu_tpu_torch.serve import generate_load
    cfg = model.config
    draft = GPT(dataclasses.replace(cfg, num_layers=2),
                generator=torch.Generator().manual_seed(1), device=dev)
    trace = generate_load(FLEET_SEED, n, vocab=cfg.vocab_size,
                          prompt_len=(8, 64), max_new=(24, 40),
                          mean_gap_s=0.002)
    out = {}

    def run(mode, draft_model, snap=None):
        # arrivals on the virtual clock, the engine on the host's (its
        # step times are wall times; no request has a deadline)
        clock = FleetClock()
        eng = fleet_engine(model, None, sampling=mode, top_k=SERVE_TOP_K,
                           temperature=SERVE_TEMPERATURE,
                           draft_model=draft_model, spec_k=FLEET_SPEC_K,
                           max_seq_len=FLEET_SPEC_SEQ)
        fleet_reset(pd, lh)

        def between(tick):
            if snap is not None and \
                    len(eng.batcher.active()) == FLEET_SLOTS:
                tables, lens = live_tables(eng)
                W = FLEET_SPEC_K + 1
                snap.offer(eng, np.repeat(tables, W, axis=0),
                           [n + j for n in lens for j in range(W)])

        t0 = time.perf_counter()
        handles, ticks = fleet_drive(
            eng, clock, trace,
            lambda it: eng.submit(list(it.prompt), it.max_new_tokens),
            between)
        fleet_sync(dev)
        return (eng, fleet_streams(handles), fleet_counts(pd, lh),
                time.perf_counter() - t0)

    for mode in ("greedy", "temperature", "top_k"):
        base = run(mode, None)
        snap = FleetSnapshot() if mode == "greedy" else None
        spec = run(mode, draft, snap)
        assert spec[1] == base[1], f"{mode}: speculative stream differs"
        st = spec[0].stats()["speculative"]
        if dev == "cuda":
            assert spec[2] == (cfg.num_layers * st["verify_steps"],
                               st["verify_steps"]), spec[2]
            assert spec[2][0] > 0
        tokens = sum(len(t) for _s, t in spec[1])
        out[mode] = {"verify_steps": st["verify_steps"],
                     "tokens_per_verify": tokens / st["verify_steps"],
                     "accepted": st["accepted"], "proposed": st["proposed"],
                     "verify_ms": st["verify_step_s_p50"] * 1e3,
                     "draft_ms": st["draft_s_p50"] * 1e3,
                     "plain_step_ms":
                         base[0].stats()["decode_step_s_p50"] * 1e3,
                     "plain_steps": base[0].stats()["decode_steps"],
                     "wall": spec[3], "plain_wall": base[3],
                     "launches": spec[2], "kernels": None}
        if snap is not None:
            assert snap.taken, "no verify step ran with every slot busy"
            out[mode]["kernels"] = fleet_kernel_check(
                pd, lh, snap, f"the verify shape ({FLEET_SLOTS} x "
                f"{FLEET_SPEC_K + 1} rows)", flush, dev)
            del snap
        r = out[mode]
        print(f"(c) spec k={FLEET_SPEC_K} {mode}: streams equal the plain "
              f"engine's (bitwise); accepted {r['accepted']}/"
              f"{r['proposed']}, {r['tokens_per_verify']:.2f} tokens a "
              f"verify step over {r['verify_steps']} steps (plain "
              f"{r['plain_steps']} steps); verify step p50 "
              f"{r['verify_ms']:.3f} ms + draft {r['draft_ms']:.3f} ms vs "
              f"plain step {r['plain_step_ms']:.3f} ms; paged_decode "
              f"launches at {FLEET_SLOTS * (FLEET_SPEC_K + 1)} rows "
              f"{r['launches'][0]}; wall {r['wall']:.3f} s (plain "
              f"{r['plain_wall']:.3f} s); {card}")
    perfect = run("greedy", model)
    st = perfect[0].stats()["speculative"]
    assert perfect[1] == run("greedy", None)[1]
    assert st["accepted"] == st["proposed"] > 0, st
    assert st["verify_steps"] < out["greedy"]["plain_steps"]
    tokens = sum(len(t) for _s, t in perfect[1])
    out["perfect"] = {"verify_steps": st["verify_steps"],
                      "tokens_per_verify": tokens / st["verify_steps"],
                      "verify_ms": st["verify_step_s_p50"] * 1e3,
                      "draft_ms": st["draft_s_p50"] * 1e3}
    print(f"(c) perfect draft (the target itself), greedy: accepted "
          f"{st['accepted']}/{st['proposed']}, {st['verify_steps']} verify "
          f"steps against {out['greedy']['plain_steps']} plain steps, "
          f"{out['perfect']['tokens_per_verify']:.2f} tokens a step; "
          f"verify p50 {out['perfect']['verify_ms']:.3f} ms + draft "
          f"{out['perfect']['draft_ms']:.3f} ms; {card}")
    same = fleet_row_invariance(model, dev)
    eq_tok, eq_kv, ms = fleet_verify_cost(model, dev)
    out["row_invariance"] = {"gemm_rows_equal": same, "tokens": eq_tok,
                             "kv": eq_kv, "ms": ms}
    print(f"(c) info: rows of F.linear bitwise equal at {FLEET_SLOTS} vs "
          f"{FLEET_SLOTS * (FLEET_SPEC_K + 1)} rows, and at "
          f"{FLEET_BUCKETS[0]} vs {FLEET_BUCKETS[-1]}: {same}; "
          f"verify step in row blocks of {FLEET_SLOTS} vs one product: "
          f"tokens {'equal' if eq_tok else 'DIFFER'}, K/V "
          f"{'equal' if eq_kv else 'differ'}"
          + ("" if not ms else
             f"; eager {ms[FLEET_SLOTS]:.3f} ms vs {ms[0]:.3f} ms")
          + f"; {card}")
    del draft
    return out


def fleet_router(model, pd, lh, card, dev, n=24, replicas=4):
    """(d) A FleetRouter over 4 replicas of one model: same-seed replay
    bitwise, tokens/s beside one replica's on the same trace."""
    from hetu_tpu_torch.serve import FleetRouter, generate_load
    trace = generate_load(FLEET_SEED + 1, n, vocab=model.config.vocab_size,
                          prompt_len=(8, 96), max_new=(16, 32),
                          mean_gap_s=0.0005)

    def run(k):
        clock = FleetClock()
        engines = [fleet_engine(model, clock) for _ in range(k)]
        target = FleetRouter(engines) if k > 1 else engines[0]
        fleet_reset(pd, lh)
        fleet_sync(dev)
        t0 = time.perf_counter()
        handles, ticks = fleet_drive(
            target, clock, trace,
            lambda it: target.submit(list(it.prompt), it.max_new_tokens))
        fleet_sync(dev)
        wall = time.perf_counter() - t0
        steps = sum(e.stats()["decode_steps"] for e in engines)
        tokens = sum(len(h.tokens) for h in handles)
        placements = target.placements if k > 1 else None
        return (fleet_streams(handles), placements, tokens / wall, ticks,
                fleet_counts(pd, lh), steps)

    a = run(replicas)
    b = run(replicas)
    one = run(1)
    assert a[0] == b[0] and a[1] == b[1], "fleet replay differs"
    assert a[0] == one[0], "a fleet stream differs from one replica's"
    if dev == "cuda":
        assert a[4] == (model.config.num_layers * a[5], a[5]) and a[5] > 0
    reasons = {}
    for p in a[1]:
        reasons[p["reason"]] = reasons.get(p["reason"], 0) + 1
    print(f"(d) router over {replicas} replicas, {n} requests: replay "
          f"bitwise (placements and streams), streams equal one replica's; "
          f"placements {reasons}; fleet {a[2]:.1f} / {b[2]:.1f} tokens/s "
          f"({a[3]} ticks) vs one replica {one[2]:.1f} tokens/s ({one[3]} "
          f"ticks); launches paged_decode {a[4][0]}, lm_head_sample "
          f"{a[4][1]}; {card}")
    return {"fleet_tps": (a[2], b[2]), "one_tps": one[2],
            "ticks": (a[3], one[3]), "launches": a[4]}


def fleet_disagg(model, pd, lh, card, dev, flush, n=24):
    """(e) One prefill worker and one decode worker against colocated
    serving, then each of three corruptions of one exported record."""
    from hetu_tpu_torch.obs import journal
    from hetu_tpu_torch.serve import (DisaggRouter, FleetRouter,
                                      KVCachePool,
                                      generate_prefill_burst_load)
    trace = generate_prefill_burst_load(
        FLEET_SEED, n, vocab=model.config.vocab_size, short_len=(4, 16),
        short_new=(8, 16), long_len=(96, 240), long_new=(2, 6),
        burst_every=6, burst_size=3, mean_gap_s=0.003)
    moves = []

    def timed(pool, name):
        fn = getattr(pool, name)

        def wrapped(*a, **kw):
            fleet_sync(dev)
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            fleet_sync(dev)
            rec = r if name == "export_pages" else a[0]
            moves.append((name, time.perf_counter() - t0, rec.nbytes))
            return r
        setattr(pool, name, wrapped)

    def run(roles, snap=None):
        clock = FleetClock()
        engines = [fleet_engine(model, clock, role=r) for r in roles]
        router = (DisaggRouter if "prefill" in roles else
                  FleetRouter)(engines)
        for e in engines:
            timed(e.pool, "export_pages")
            timed(e.pool, "import_pages")
        jr = journal.EventJournal(clock=clock)
        fleet_reset(pd, lh)

        def between(tick):
            dec = engines[-1]
            if snap is not None and dec.pool.stats()["imported_pages"] \
                    and dec.batcher.active_slots >= 2:
                snap.offer(dec, *live_tables(dec))

        with journal.use(jr):
            handles, _ = fleet_drive(
                router, clock, trace,
                lambda it: router.submit(list(it.prompt),
                                         it.max_new_tokens), between)
        fleet_sync(dev)
        for e in engines:
            s = e.pool.stats()
            assert s["exports_outstanding"] == 0 and s["sequences"] == 0
        return fleet_streams(handles), router, jr, fleet_counts(pd, lh)

    colo = run(["colocated", "colocated"])
    moves.clear()
    snap = FleetSnapshot()
    dis = run(["prefill", "decode"], snap)
    assert dis[0] == colo[0], "a migrated stream differs from colocated"
    migrated = len(dis[1].migrations)
    assert migrated > 0 and snap.taken
    ex = [(s, b) for name, s, b in moves if name == "export_pages"]
    im = [(s, b) for name, s, b in moves if name == "import_pages"]
    dec_steps = dis[1].engines[1].stats()["decode_steps"]
    if dev == "cuda":
        assert dis[3][0] == model.config.num_layers * (
            dec_steps + dis[1].engines[0].stats()["decode_steps"]) > 0
    row = fleet_kernel_check(pd, lh, snap,
                             "imported tables on the decode worker", flush,
                             dev)
    del snap
    corruptions = [
        ("payload", "page_crc", lambda rec: rec.k_pages.__setitem__(
            (0, 0, 0, 0, 0), rec.k_pages[0, 0, 0, 0, 0] + 1.0)),
        ("crc", "page_crc", lambda rec: rec.page_crcs.__setitem__(
            0, rec.page_crcs[0] ^ 1)),
        ("fingerprint", "fingerprint",
         lambda rec: setattr(rec, "fingerprint", rec.fingerprint ^ 1))]
    orig = KVCachePool.export_pages
    detected = {}
    for name, reason, corrupt in corruptions:
        def patched(pool, sid, corrupt=corrupt):
            rec = orig(pool, sid)
            if sid == 1:
                rec.k_pages = np.array(rec.k_pages)
                corrupt(rec)
            return rec
        KVCachePool.export_pages = patched
        try:
            streams, router, jr, _c = run(["prefill", "decode"])
        finally:
            KVCachePool.export_pages = orig
        fails = jr.of_kind("migrate_verify_failed")
        assert [(e["request_id"], e["reason"]) for e in fails] == \
            [(1, reason)], (name, fails)
        assert router.engines[1]._migrations["reprefill"] == 1
        assert streams == colo[0], f"{name}: stream differs after reprefill"
        detected[name] = reason
    mean = statistics.mean
    mb = mean(b for _s, b in ex) / 1e6
    ex_ms, im_ms = (mean(s for s, _b in m) * 1e3 for m in (ex, im))
    big_ex, big_im = max(ex, key=lambda r: r[1]), max(im, key=lambda r: r[1])
    print(f"(e) disaggregated 1 prefill + 1 decode worker, {n} requests: "
          f"{migrated} migrated, streams equal colocated serving "
          f"(bitwise); per migrated request {mb:.2f} MB, export "
          f"{ex_ms:.3f} ms (device to host, CRC, fingerprint), import "
          f"{im_ms:.3f} ms (verify, host to device); the largest record "
          f"{big_ex[1] / 1e6:.2f} MB, export {big_ex[0] * 1e3:.3f} ms, "
          f"import {big_im[0] * 1e3:.3f} ms; corruptions detected "
          f"{detected}, journaled, re-prefilled, streams bitwise; launches "
          f"paged_decode {dis[3][0]}, lm_head_sample {dis[3][1]}; {card}")
    return {"migrated": migrated, "mb": mb, "export_ms": ex_ms,
            "import_ms": im_ms, "big_mb": big_ex[1] / 1e6,
            "big_export_ms": big_ex[0] * 1e3,
            "big_import_ms": big_im[0] * 1e3, "kernels": row,
            "launches": dis[3]}


def fleet_failover(model, pd, lh, card, dev, n=12):
    """(f) Three replicas under a failover monitor: a replica_crash at
    tick 3, a decode_hang, a migrate_drop; streams against the crash-free
    run."""
    from hetu_tpu_torch.exec import faults
    from hetu_tpu_torch.obs import journal
    from hetu_tpu_torch.serve import FleetRouter, generate_load
    from hetu_tpu_torch.serve.fleet import FailoverMonitor
    trace = generate_load(FLEET_SEED + 2, n, vocab=model.config.vocab_size,
                          prompt_len=(8, 64), max_new=(8, 24))
    rehome = []

    def run(plan):
        clock = FleetClock()
        engines = [fleet_engine(model, clock, sampling="top_k",
                                top_k=SERVE_TOP_K,
                                temperature=SERVE_TEMPERATURE)
                   for _ in range(3)]
        router = FleetRouter(engines)
        monitor = FailoverMonitor(router, lease_ticks=2)
        evac = monitor._evacuate

        def timed(replica):
            fleet_sync(dev)
            t0 = time.perf_counter()
            out = evac(replica)
            fleet_sync(dev)
            rehome.append((time.perf_counter() - t0, len(out)))
            return out
        monitor._evacuate = timed
        jr = journal.EventJournal(clock=clock)
        fleet_reset(pd, lh)
        with journal.use(jr), faults.inject(faults.FaultPlan(plan)):
            handles = [router.submit(list(it.prompt), it.max_new_tokens,
                                     request_id=i)
                       for i, it in enumerate(trace)]
            ticks = 0
            while not router.idle or ticks < 30:
                router.step()
                clock.t += 0.001
                ticks += 1
                assert ticks < 100_000
        for e in engines:
            s = e.pool.stats()
            assert s["pages_export_held"] == 0 and s["allocs"] == s["frees"]
        return fleet_streams(handles), monitor, jr, fleet_counts(pd, lh)

    base = run([])
    rehome.clear()
    plan = [(3, faults.Fault("replica_crash", worker=0)),
            (6, faults.Fault("decode_hang", worker=1, arg=8.0)),
            (7, faults.Fault("migrate_drop"))]
    streams, monitor, jr, launches = run(plan)
    assert streams == base[0], "a re-homed stream differs"
    assert all(s == "completed" for s, _t in streams)
    kv = [e["kv"] for e in jr.of_kind("request_rehome")]
    reasons = [d["reason"] for d in monitor.decisions]
    assert "crashed" in reasons and "lease_expired" in reasons, reasons
    assert "salvaged" in kv and "reprefill" in kv, kv
    assert any(e["reason"] == "dropped"
               for e in jr.of_kind("migrate_verify_failed"))
    if dev == "cuda":
        assert launches[0] > 0 and launches[1] > 0
    print(f"(f) failover, 3 replicas, {n} requests, lease 2 ticks: "
          f"decisions {reasons}; re-homes {kv.count('salvaged')} salvaged, "
          f"{kv.count('reprefill')} re-prefilled (one record dropped in "
          f"transit); streams equal the crash-free run (bitwise); re-home "
          + ", ".join(f"{s * 1e3:.3f} ms for {k} requests"
                      for s, k in rehome)
          + f"; launches paged_decode {launches[0]}, lm_head_sample "
          f"{launches[1]}; {card}")
    return {"rehome_ms": [s * 1e3 for s, _k in rehome], "kv": kv}


def fleet_defrag(model, pd, lh, card, dev, n=24, every=8):
    """(g) Defragment the pool every 8 ticks under the captured graph."""
    from hetu_tpu_torch.serve import generate_load
    trace = generate_load(FLEET_SEED + 3, n, vocab=model.config.vocab_size,
                          prompt_len=(8, 240), max_new=(4, 32))

    def run(defrag):
        clock = FleetClock()
        eng = fleet_engine(model, clock, sampling="temperature",
                           temperature=SERVE_TEMPERATURE)
        ptr = eng.pool.k.data_ptr(), eng.pool.v.data_ptr()
        moved = []

        def between(tick):
            if defrag and tick % every == 0:
                moved.append(eng.pool.defrag())
                assert (eng.pool.k.data_ptr(), eng.pool.v.data_ptr()) == ptr
        fleet_reset(pd, lh)
        handles, _ = fleet_drive(
            eng, clock, trace,
            lambda it: eng.submit(list(it.prompt), it.max_new_tokens),
            between)
        fleet_sync(dev)
        eng.pool.stats()
        return fleet_streams(handles), moved, eng, fleet_counts(pd, lh)

    base = run(False)
    streams, moved, eng, launches = run(True)
    assert streams == base[0], "defrag changed a stream"
    assert sum(moved) > 0, "defrag never moved a page"
    if dev == "cuda":
        assert eng._decode_graph.captured
        assert launches[0] == model.config.num_layers * \
            eng.stats()["decode_steps"]
    print(f"(g) defrag every {every} ticks under the captured graph: "
          f"{len(moved)} passes moved {sum(moved)} pages; pool tensors kept "
          f"their addresses; streams equal the run without defrag "
          f"(bitwise); {card}")
    return {"passes": len(moved), "moved": sum(moved)}


def fleet_http(model, pd, lh, card, dev, n_seq=4, n_par=8):
    """(h) ``serve_fleet_router`` over two replicas on loopback, each
    replica stepping on its own thread."""
    import urllib.request
    from hetu_tpu_torch.serve import FleetRouter, serve_fleet_router
    V = model.config.vocab_size
    rng = np.random.default_rng(FLEET_SEED)
    prompts = [rng.integers(0, V, int(k)).tolist()
               for k in rng.integers(8, 64, n_seq + n_par)]
    router = FleetRouter([fleet_engine(model) for _ in range(2)])
    srv = serve_fleet_router(router, port=0)
    fleet_sync(dev)
    fleet_reset(pd, lh)
    router.start()
    url = f"http://127.0.0.1:{srv.port}/infer"

    def post(p):
        t0 = time.perf_counter()
        req = urllib.request.Request(url, method="POST", data=json.dumps(
            {"prompt": p, "max_new_tokens": 16,
             "timeout_s": 120}).encode())
        with urllib.request.urlopen(req, timeout=180) as r:
            body = json.loads(r.read())
        return body, time.perf_counter() - t0

    try:
        seq = [post(p) for p in prompts[:n_seq]]
        with ThreadPoolExecutor(n_par) as pool:
            par = list(pool.map(post, prompts[n_seq:]))
    finally:
        srv.stop()
        router.stop()
    fleet_sync(dev)
    launches = fleet_counts(pd, lh)
    steps = sum(e.stats()["decode_steps"] for e in router.engines)
    if dev == "cuda":
        assert launches == (model.config.num_layers * steps, steps) and \
            steps > 0, launches
    bodies = [b for b, _s in seq + par]
    assert all(b["status"] == "completed" and len(b["tokens"]) == 16
               for b in bodies), bodies
    check = fleet_engine(model)
    again = [check.submit(p, 16, request_id=b["request_id"])
             for p, b in zip(prompts, bodies)]
    check.run_until_idle()
    assert [h.tokens for h in again] == [b["tokens"] for b in bodies], \
        "an HTTP stream differs from the engine's"
    lat = [s * 1e3 for _b, s in seq]
    plat = sorted(s * 1e3 for _b, s in par)
    print(f"(h) HTTP: serve_fleet_router over 2 replicas on loopback, "
          f"16 new tokens a request: {n_seq} sequential POST /infer "
          f"{', '.join(f'{x:.1f}' for x in lat)} ms; {n_par} concurrent: "
          f"p50 {statistics.median(plat):.1f} ms, max {plat[-1]:.1f} ms; "
          f"every stream equals a direct engine's under its request id; "
          f"launches paged_decode {launches[0]}, lm_head_sample "
          f"{launches[1]}; {card}")
    return {"seq_ms": lat, "par_ms": plat, "launches": launches}


def fleet_phase(pd, lh, card, dev="cuda", cfg=None):
    """Phase 15, arms (a)-(h).  Returns the readings and the seconds."""
    from hetu_tpu_torch import GPT, gpt2_small
    from hetu_tpu_torch.obs import compile as obs_compile
    t0 = time.perf_counter()
    cfg = cfg or gpt2_small()
    model = GPT(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
             if dev == "cuda" else None)
    # the storm detector counts captures process-wide on a wall clock;
    # dozens of engines capture here, which is no storm
    obs_compile.configure_storm(obs_compile.StormDetector(threshold=10_000))
    print(f"fleet: GPT-2 small widths ({cfg.num_layers} layers, hidden "
          f"{cfg.hidden_size}, vocab {cfg.vocab_size}), fp32, window "
          f"{FLEET_SEQ} tokens (arm (c) {FLEET_SPEC_SEQ}), {FLEET_SLOTS} "
          f"slots, page {FLEET_PAGE}, buckets {FLEET_BUCKETS}, seed "
          f"{FLEET_SEED}")
    out = {}
    warm = fleet_engine(model)
    warm.submit([1, 2, 3, 4, 5], 2)
    warm.run_until_idle()
    del warm
    arms = (("tenants", lambda: fleet_tenants(model, pd, lh, card, dev)),
            ("prefix", lambda: fleet_prefix(model, pd, lh, card, dev,
                                            flush)),
            ("spec", lambda: fleet_spec(model, pd, lh, card, dev, flush)),
            ("router", lambda: fleet_router(model, pd, lh, card, dev)),
            ("disagg", lambda: fleet_disagg(model, pd, lh, card, dev,
                                            flush)),
            ("failover", lambda: fleet_failover(model, pd, lh, card, dev)),
            ("defrag", lambda: fleet_defrag(model, pd, lh, card, dev)),
            ("http", lambda: fleet_http(model, pd, lh, card, dev)))
    for name, arm in arms:
        t1 = time.perf_counter()
        out[name] = arm()
        # an engine and its captured graphs form a cycle: collect them so
        # the graphs' private pools go back before the next arm
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
        print(f"  ({name} in {time.perf_counter() - t1:.1f} s)")
    obs_compile.configure_storm(None)
    del model, flush
    if dev == "cuda":
        torch.cuda.empty_cache()
    fleet_sync(dev)
    return out, time.perf_counter() - t0


# -- phase 16: the survival layer -------------------------------------------

SURV_BATCH = 8                  # GPT-2 small's phase-5 batch, 8 x 1024
SURV_WORLD = 4                  # simulated gang workers: 2 x 1024 each
SURV_STEPS = 6                  # (a) the uninterrupted run's steps
SURV_TIMEOUT = 1.0              # (a) the watchdog's deadline, seconds
SURV_HANG = 1.5                 # (a) the injected hang, seconds
SURV_RESNET_BATCH = 128         # (b) bench.py config 1's batch
SURV_PARTIAL_STEPS = 6          # (d) steps of each partial-reduce run
SURV_STALL_SEED = 3             # (d) FaultPlan.random's seed for stalls
SURV_DISK = 16 << 30            # free disk (c) and (d) need beyond the
                                # checkpoints' keep=2 windows


def surv_snapshot(trainer):
    """Device copies of a trainer's parameters, state buffers and
    optimizer state, for bitwise comparisons and restores."""
    from hetu_tpu_torch.interop.from_jax import state_tensors
    params = {n: t.detach().clone()
              for n, t in state_tensors(trainer.model).items()}
    opt = {k: (v if k == "step" else {n: t.clone() for n, t in v.items()})
           for k, v in trainer.opt_state.items()}
    return params, opt


def surv_restore(trainer, snap):
    from hetu_tpu_torch.interop.from_jax import state_tensors
    with torch.no_grad():
        for n, t in state_tensors(trainer.model).items():
            t.copy_(snap[0][n])
    trainer.opt_state = {k: (v if k == "step" else
                             {n: t.clone() for n, t in v.items()})
                         for k, v in snap[1].items()}


def surv_diff(a, b) -> list:
    """Names of the tensors two snapshots hold with other bits."""
    out = [n for n in a[0] if not torch.equal(a[0][n], b[0][n])]
    for k, v in a[1].items():
        if k == "step":
            if v != b[1][k]:
                out.append("opt_state.step")
            continue
        out += [f"opt_state.{k}.{n}" for n in v
                if not torch.equal(v[n], b[1][k][n])]
    return out


def surv_events(jr, *kinds):
    return [e for e in jr.events if e["kind"] in kinds]


def surv_gpt(dev, cfg):
    """GPT-2 small as phase 5 trains it (fp32, flash, streamed head with
    chunk 1024, AdamW) and its trainer; ``cfg`` cuts it for a CPU
    rehearsal."""
    from hetu_tpu_torch import AdamWOptimizer, GPT, Trainer, flash_attn_fn
    from hetu_tpu_torch.models import gpt as gpt_mod
    cfg = cfg or gpt_mod.gpt2_small(streamed_head_chunk=1024)
    model = GPT(cfg, attn_fn=flash_attn_fn(native_layout=True),
                generator=torch.Generator().manual_seed(0), device=dev)

    def loss_fn(m, b, key):
        ids = b["ids"] if isinstance(b, dict) else b
        return m.loss(ids, key=key), {}

    trainer = Trainer(model, AdamWOptimizer(3e-4, weight_decay=0.01),
                      loss_fn)
    rng = np.random.default_rng(16)
    ids = [rng.integers(0, cfg.vocab_size, (SURV_BATCH, cfg.max_seq_len))
           for _ in range(SURV_STEPS)]
    return cfg, trainer, ids


SURV_FIXES = (
    ("nothing", lambda: None),
    ("torch.backends.cudnn.deterministic = True",
     lambda: setattr(torch.backends.cudnn, "deterministic", True)),
    ("torch.use_deterministic_algorithms(True)",
     lambda: torch.use_deterministic_algorithms(True, warn_only=True)))


def surv_repeat(trainer, batch, dev, label):
    """One step twice from the same state and key, every parameter, state
    buffer and optimizer slot compared bitwise; where they differ, the
    next of ``SURV_FIXES`` is switched on (for the rest of the phase) and
    the check repeated.  Returns what was needed."""
    from hetu_tpu_torch.core.rng import (get_seed_status, next_key,
                                         reset_seed_seqnum)
    s0, r0 = surv_snapshot(trainer), get_seed_status()

    def once():
        surv_restore(trainer, s0)
        reset_seed_seqnum(*r0)
        loss = float(trainer.step(batch, next_key())["loss"])
        fleet_sync(dev)
        return loss, surv_snapshot(trainer)

    for needed, fix in SURV_FIXES:
        fix()
        (l1, a), (l2, b) = once(), once()
        diff = surv_diff(a, b)
        if not diff and l1 == l2:
            break
        print(f"survival: {label}: one step twice differs in {len(diff)} "
              f"tensors (first {diff[:4]}), losses {l1!r} / {l2!r}, with "
              f"{needed}")
    print(f"survival: {label}: one step twice from the same state and key:"
          f" losses {l1!r} / {l2!r}, {len(a[0])} parameters and state "
          f"buffers and {sum(len(v) for k, v in a[1].items() if k != 'step')}"
          f" optimizer slots bitwise equal: {not diff}; needed: {needed}")
    assert not diff and l1 == l2, f"step not repeatable: {diff[:8]}"
    surv_restore(trainer, s0)
    reset_seed_seqnum(*r0)
    return needed


def surv_time_saves(rt, stalls):
    """Record each ``rt.save`` call's time on the caller's thread (the
    step's stall: the host snapshot; the write runs on the writer's)."""
    orig = rt.save

    def timed(sync=False):
        t0 = time.perf_counter()
        path = orig(sync)
        stalls.append((rt.step_count, time.perf_counter() - t0))
        return path

    rt.save = timed


def surv_resilient(trainer, ids, dev, card, tmp):
    """(a) ``ResilientTrainer`` on GPT-2 small: async saves every 2 steps,
    SIGTERM, resume bitwise, damaged files skipped, the watchdog."""
    import signal as _signal

    from hetu_tpu_torch.core.rng import (get_seed_status, next_key,
                                         reset_seed_seqnum, set_random_seed)
    from hetu_tpu_torch.exec import (BackendUnresponsive, Preempted,
                                     ResilientTrainer, faults)
    from hetu_tpu_torch.obs import journal as obs_journal

    def batch(i):
        return torch.from_numpy(ids[i]).to(dev)

    set_random_seed(16)
    s0, r0 = surv_snapshot(trainer), get_seed_status()
    out = {}
    # A: the uninterrupted run, bare Trainer steps (timed)
    bare = []
    for i in range(SURV_STEPS):
        t0 = time.perf_counter()
        trainer.step(batch(i))
        fleet_sync(dev)
        bare.append(time.perf_counter() - t0)
    ref = surv_snapshot(trainer)
    d = os.path.join(tmp, "resilient")
    jr = obs_journal.EventJournal()
    with obs_journal.use(jr):
        # B: saves every 2 steps, then SIGTERM between steps 3 and 4
        surv_restore(trainer, s0)
        reset_seed_seqnum(*r0)
        rt = ResilientTrainer(trainer, d, save_every=2, keep=3,
                              handle_signals=True)
        stalls = []
        surv_time_saves(rt, stalls)
        for i in range(3):
            rt.step(batch(i))
        os.kill(os.getpid(), _signal.SIGTERM)
        t0 = time.perf_counter()
        try:
            rt.step(batch(3))
            raise AssertionError("SIGTERM did not preempt")
        except Preempted as e:
            final_s = time.perf_counter() - t0
            assert e.step == 3, e.step
        rt.close()
        # C: a fresh driver over scrambled state resumes and finishes,
        # with a torn and a corrupt file injected at its saves
        with torch.no_grad():
            for p in trainer.model.parameters():
                p.fill_(0.5)
        set_random_seed(99)
        rt2 = ResilientTrainer(trainer, d, save_every=2, keep=3)
        surv_time_saves(rt2, stalls)
        t0 = time.perf_counter()
        resumed = rt2.resume()
        resume_s = time.perf_counter() - t0
        assert resumed == 3, resumed
        plan = faults.FaultPlan([(4, "ckpt_corrupt"), (6, "ckpt_truncate")])
        with faults.inject(plan):
            for i in range(3, SURV_STEPS):
                rt2.step(batch(i))
            rt2.close()
        assert plan.remaining() == [], plan.remaining()
        fleet_sync(dev)
        diff = surv_diff(surv_snapshot(trainer), ref)
        print(f"survival (a): SIGTERM after step 3 -> final synchronous "
              f"save and Preempted in {final_s * 1e3:.1f} ms; a fresh "
              f"ResilientTrainer resumed step {resumed} in "
              f"{resume_s * 1e3:.1f} ms and ran steps 4-{SURV_STEPS}: final "
              f"state bitwise the uninterrupted run's: {not diff}")
        assert not diff, f"resumed run differs: {diff[:8]}"
        # D: the torn and the corrupt file are skipped on resume
        rt3 = ResilientTrainer(trainer, d)
        again = rt3.resume()
        rt3.close()
        for step, path, why in rt3.resume_report:
            print(f"survival (a): resume scan step {step}: "
                  f"{why or 'loaded'}")
        diag = {s: w for s, _p, w in rt3.resume_report}
        assert again == 3 and "CRC32 mismatch" in diag[4] \
            and "torn write" in diag[6], rt3.resume_report
        saves = surv_events(jr, "checkpoint_saved")
    for e in saves:
        print(f"survival (a): saved step {e['step']}: {e['bytes']} bytes "
              f"written in {e['duration_s'] * 1e3:.1f} ms (writer side)")
    for step, s in stalls:
        print(f"survival (a): save at step {step}: the step stalled "
              f"{s * 1e3:.1f} ms (host snapshot on the caller's thread)")
    out["stall_ms"] = [s * 1e3 for _st, s in stalls]
    out["save_bytes"] = [e["bytes"] for e in saves]
    out["save_ms"] = [e["duration_s"] * 1e3 for e in saves]
    out["resume_ms"] = resume_s * 1e3
    out["preempt_save_ms"] = final_s * 1e3
    # E: a hang at step_begin past the watchdog's deadline, then a retry
    # at once: it waits for the abandoned step's thread, and its step is
    # bitwise one clean step's
    surv_restore(trainer, s0)
    key = next_key()
    trainer.step(batch(0), key)
    clean = surv_snapshot(trainer)
    surv_restore(trainer, s0)
    rt4 = ResilientTrainer(trainer, os.path.join(tmp, "watchdog"),
                           save_every=0, step_timeout=SURV_TIMEOUT)
    plan = faults.FaultPlan([(1, faults.Fault("hang", arg=SURV_HANG))])
    t0 = time.perf_counter()
    with faults.inject(plan):
        try:
            rt4.step(batch(0), key)
            raise AssertionError("the watchdog did not fire")
        except BackendUnresponsive as e:
            fired_s = time.perf_counter() - t0
            msg = str(e)
        t0 = time.perf_counter()
        rt4.step(batch(0), key)
        fleet_sync(dev)
        retry_s = time.perf_counter() - t0
    diff = surv_diff(surv_snapshot(trainer), clean)
    print(f"survival (a): hang of {SURV_HANG} s at step_begin -> "
          f"BackendUnresponsive after {fired_s:.3f} s (deadline "
          f"{SURV_TIMEOUT} s); a retry at once waited for the abandoned "
          f"step and took {retry_s:.3f} s; the state bitwise one clean "
          f"step's: {not diff} ({msg[:60]}...)")
    assert not diff and "nothing was committed" in msg, diff[:8]
    rt4.close()
    out["watchdog_retry_ms"] = retry_s * 1e3
    # F: the driver's overhead over the bare Trainer, no saves
    rt5 = ResilientTrainer(trainer, os.path.join(tmp, "overhead"),
                           save_every=0)
    guarded = []
    for i in range(SURV_STEPS):
        t0 = time.perf_counter()
        rt5.step(batch(i))
        fleet_sync(dev)
        guarded.append(time.perf_counter() - t0)
    rt5.close()
    mb, mg = statistics.median(bare[1:]), statistics.median(guarded[1:])
    print(f"survival (a): median step bare Trainer {mb * 1e3:.3f} ms, "
          f"ResilientTrainer {mg * 1e3:.3f} ms: overhead "
          f"{(mg - mb) * 1e3:+.3f} ms ({mg / mb - 1:+.2%}); {card}")
    out.update(bare_ms=mb * 1e3, guarded_ms=mg * 1e3)
    surv_restore(trainer, s0)
    reset_seed_seqnum(*r0)
    return out


def surv_resnet(dev, card, tmp, image=32, n=SURV_RESNET_BATCH):
    """(b) The anomaly policy on ResNet-18 at CIFAR-10's shapes (bench.py
    config 1, batch 128): a grad_nan step skipped with the lineage
    bitwise an unfaulted run's, three in a row rolled back to the last
    checkpoint, and the provenance naming the poisoned batch leaf."""
    from hetu_tpu_torch import MomentumOptimizer, Trainer, resnet18
    from hetu_tpu_torch.core.rng import set_random_seed
    from hetu_tpu_torch.exec import (BackendUnresponsive, ResilientTrainer,
                                     faults)
    from hetu_tpu_torch.obs import journal as obs_journal
    from hetu_tpu_torch.ops import softmax_cross_entropy_sparse

    def loss_fn(model, b, key):
        logits, new_model = model(b["x"], training=True)
        loss = softmax_cross_entropy_sparse(logits, b["y"]).mean()
        return loss, {"model": new_model}

    rng = np.random.default_rng(3)
    batches = [{"x": torch.from_numpy(rng.standard_normal(
                    (n, image, image, 3)).astype(np.float32)).to(dev),
                "y": torch.from_numpy(rng.integers(0, 10, n)).to(dev)}
               for _ in range(8)]

    def fresh():
        set_random_seed(5)
        m = resnet18(num_classes=10, device=dev,
                     generator=torch.Generator().manual_seed(0))
        return Trainer(m, MomentumOptimizer(0.1, momentum=0.9), loss_fn)

    # the probe runs on a trainer that a ResilientTrainer drives: its
    # constructor switches on what a bitwise lineage of a convolution
    # model needs (cuDNN's deterministic algorithms)
    tr0 = fresh()
    ResilientTrainer(tr0, os.path.join(tmp, "resnet_repeat"),
                     save_every=0).close()
    needed = surv_repeat(tr0, batches[0], dev, "(b) resnet18")
    assert needed == "nothing", needed
    del tr0
    # the unfaulted run of the surviving batches (batch 3 dropped)
    tr = fresh()
    for i, b in enumerate(batches):
        if i != 3:
            tr.step(b)
    ref = surv_snapshot(tr)
    jr = obs_journal.EventJournal()
    with obs_journal.use(jr):
        tr = fresh()
        rt = ResilientTrainer(tr, os.path.join(tmp, "resnet_skip"),
                              save_every=0)
        plan = faults.FaultPlan([(4, "grad_nan")])
        with faults.inject(plan):
            skipped = [bool(rt.step(b).get("skipped")) for b in batches]
        rt.close()
        fleet_sync(dev)
        diff = surv_diff(surv_snapshot(tr), ref)
        prov = surv_events(jr, "nan_provenance")
        print(f"survival (b): resnet18 batch {n}: grad_nan at step 4 "
              f"skipped {skipped}; the 7 surviving steps bitwise an "
              f"unfaulted run's: {not diff}; provenance {prov[:1]}")
        assert skipped == [False] * 3 + [True] + [False] * 4
        assert not diff, diff[:8]
        assert prov and prov[0]["origin"] == "input" \
            and prov[0]["leaf"] == "batch.x", prov
        # three anomalies in a row roll back to the last checkpoint
        tr = fresh()
        rt = ResilientTrainer(tr, os.path.join(tmp, "resnet_rollback"),
                              save_every=2, keep=2,
                              max_consecutive_anomalies=3)
        plan = faults.FaultPlan([(5, "grad_nan")] * 3)
        rolled = []
        with faults.inject(plan):
            for i, b in enumerate(batches[:7]):
                m = rt.step(b)
                if rt.step_count == 4 and i == 3:
                    rt._ck.wait()
                    at4 = surv_snapshot(tr)
                if "rolled_back_to" in m:
                    rolled.append(m["rolled_back_to"])
                    after = surv_snapshot(tr)
        rt.close()
    diff = surv_diff(after, at4)
    print(f"survival (b): three grad_nan steps in a row rolled back to "
          f"{rolled} (rollbacks {rt.rollbacks}); the state bitwise the "
          f"step-4 checkpoint's: {not diff}; {card}")
    assert rolled == [4] and not diff, (rolled, diff[:8])
    # a step that blows the watchdog's deadline inside its forward, after
    # BatchNorm wrote its running statistics: a retry at once waits for
    # the abandoned thread, and its step is bitwise one clean step's
    tr = fresh()
    tr.step(batches[0])
    clean = surv_snapshot(tr)
    tr = fresh()
    pending = [SURV_HANG]

    def slow_loss(model, b, key):
        logits, new_model = model(b["x"], training=True)
        if pending:
            fleet_sync(dev)
            time.sleep(pending.pop())
        loss = softmax_cross_entropy_sparse(logits, b["y"]).mean()
        return loss, {"model": new_model}

    tr.loss_fn = slow_loss
    rt = ResilientTrainer(tr, os.path.join(tmp, "resnet_watchdog"),
                          save_every=0, step_timeout=SURV_TIMEOUT)
    try:
        rt.step(batches[0])
        raise AssertionError("the watchdog did not fire")
    except BackendUnresponsive as e:
        assert "nothing was committed" in str(e)
    t0 = time.perf_counter()
    rt.step(batches[0])
    fleet_sync(dev)
    retry_s = time.perf_counter() - t0
    rt.close()
    diff = surv_diff(surv_snapshot(tr), clean)
    print(f"survival (b): a forward slept {SURV_HANG} s past the "
          f"{SURV_TIMEOUT} s deadline after BatchNorm's update; a retry at "
          f"once waited for the abandoned step and took {retry_s:.3f} s; "
          f"parameters, running statistics and momenta bitwise one clean "
          f"step's: {not diff}; {card}")
    assert not diff, diff[:8]
    return {"rolled_back_to": rolled, "repeat": needed,
            "watchdog_retry_ms": retry_s * 1e3}


def surv_gang_timers(gang, out):
    """Time the gang's saves, restores (the compose) and rescales."""
    for name in ("save", "_restore", "_rescale"):
        fn = getattr(gang, name)

        def timed(*a, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            r = _fn(*a, **kw)
            out.setdefault(_name, []).append(time.perf_counter() - t0)
            return r

        setattr(gang, name, timed)


def surv_elastic(trainer, ids, dev, card, tmp):
    """(c) ``ElasticGang``, 4 simulated workers: a worker_kill and a
    shard_loss at step 3 rescale to 3 workers through the ring replica,
    then rejoin(); the end state and losses_by_step bitwise an
    uninterrupted run's."""
    from hetu_tpu_torch.core.rng import get_seed_status, reset_seed_seqnum
    from hetu_tpu_torch.exec import ElasticGang, faults
    from hetu_tpu_torch.obs import journal as obs_journal

    s0, r0 = surv_snapshot(trainer), get_seed_status()

    def data_fn(s):
        return {"ids": ids[(s - 1) % len(ids)]}

    def gang(d, **kw):
        return ElasticGang(trainer, os.path.join(tmp, d),
                           world_size=SURV_WORLD, data_fn=data_fn,
                           global_batch_size=SURV_BATCH, seed=0, **kw)

    g = gang("gang_ref", save_every=0)
    g.run_until(5)
    fleet_sync(dev)
    ref, ref_losses = surv_snapshot(trainer), dict(g.losses_by_step)
    surv_restore(trainer, s0)
    reset_seed_seqnum(*r0)
    times: dict = {}
    jr = obs_journal.EventJournal()
    with obs_journal.use(jr):
        g = gang("gang_chaos", save_every=2, keep=2)
        surv_gang_timers(g, times)
        plan = faults.FaultPlan([
            (3, faults.Fault("worker_kill", worker=1)),
            (3, faults.Fault("shard_loss", worker=1))])
        with faults.inject(plan):
            g.run_until(4)
        assert g.world_size == 3, g.world_size
        g.rejoin(1)
        g.run_until(5)
        fleet_sync(dev)
    kinds = [(e["kind"], e.get("rank")) for e in jr.events
             if e["kind"] in ("worker_lost", "shard_restore",
                              "gang_rescale")]
    diff = surv_diff(surv_snapshot(trainer), ref)
    same_losses = g.losses_by_step == ref_losses
    saves = surv_events(jr, "checkpoint_saved")
    print(f"survival (c): gang of {SURV_WORLD}: journal {kinds}; world "
          f"{g.world_size} at the end; losses_by_step bitwise the "
          f"uninterrupted run's: {same_losses}; end state bitwise: "
          f"{not diff}")
    assert ("shard_restore", 1) in kinds and ("worker_lost", 1) in kinds
    assert same_losses and not diff, diff[:8]
    nbytes = sum(e["bytes"] for e in saves)
    print(f"survival (c): {len(times.get('save', []))} gang saves "
          f"{[round(t * 1e3, 1) for t in times.get('save', [])]} ms "
          f"({len(saves)} files, {nbytes} bytes); compose (restore from "
          f"the manifest) {[round(t * 1e3, 1) for t in times['_restore']]}"
          f" ms; rescale {[round(t * 1e3, 1) for t in times['_rescale']]}"
          f" ms; {card}")
    surv_restore(trainer, s0)
    reset_seed_seqnum(*r0)
    return {"save_ms": [t * 1e3 for t in times.get("save", [])],
            "save_bytes": nbytes,
            "compose_ms": [t * 1e3 for t in times["_restore"]],
            "rescale_ms": [t * 1e3 for t in times["_rescale"]]}


def surv_stall_plan():
    """The seeded pareto straggler schedule of (d): stalls on the step
    clock, each drawn from FaultPlan.random's default shifted Pareto."""
    from hetu_tpu_torch.exec import faults
    return faults.FaultPlan.random(SURV_STALL_SEED, SURV_PARTIAL_STEPS,
                                   kinds=("worker_stall",), rate=0.35,
                                   n_workers=SURV_WORLD)


def surv_partial(trainer, ids, fl, ce, dev, card, tmp):
    """(d) Partial reduce on the same gang: seeded pareto stalls at a
    finite deadline (a RuntimeController tuning it) and at inf, the
    straggler replay bitwise, a bit_flip named, quarantined and restored
    from the ring, and the goodput buckets."""
    from hetu_tpu_torch.core.rng import get_seed_status, reset_seed_seqnum
    from hetu_tpu_torch.exec import (ControllerConfig, ElasticGang,
                                     PartialReduceConfig, RuntimeController,
                                     faults)
    from hetu_tpu_torch.obs import journal as obs_journal
    from hetu_tpu_torch.obs.goodput import GoodputMeter

    s0, r0 = surv_snapshot(trainer), get_seed_status()
    stalls = [(s, f.worker, f.arg) for s, f in surv_stall_plan().remaining()]
    assert len(stalls) >= 2, stalls

    def data_fn(s):
        return {"ids": ids[(s - 1) % len(ids)]}

    def run(name, deadline, controller=None, plan=None,
            steps=SURV_PARTIAL_STEPS, save_every=0, **kw):
        surv_restore(trainer, s0)
        reset_seed_seqnum(*r0)
        cfg = PartialReduceConfig(deadline=deadline, tau=4,
                                  min_deadline=0.5, max_deadline=8.0)
        meter = GoodputMeter()
        jr = obs_journal.EventJournal()
        calls = [0]
        with obs_journal.use(jr):
            g = ElasticGang(trainer, os.path.join(tmp, name),
                            world_size=SURV_WORLD, data_fn=data_fn,
                            global_batch_size=SURV_BATCH, seed=0,
                            partial=cfg, controller=controller,
                            goodput=meter, save_every=save_every, **kw)
            grad = g._grad_fn

            def counted(*a):
                calls[0] += 1
                return grad(*a)

            g._grad_fn = counted
            counts0 = (fl.fwd_launch_count(), fl.bwd_launch_count(),
                       ce.fwd_launch_count(), ce.bwd_launch_count())
            t0 = time.perf_counter()
            with faults.inject(plan or surv_stall_plan()):
                g.run_until(steps)
            fleet_sync(dev)
            wall = time.perf_counter() - t0
            counts = tuple(b - a for a, b in zip(counts0, (
                fl.fwd_launch_count(), fl.bwd_launch_count(),
                ce.fwd_launch_count(), ce.bwd_launch_count())))
        return {"gang": g, "snap": surv_snapshot(trainer), "meter": meter,
                "journal": jr, "calls": calls[0], "counts": counts,
                "wall": wall}

    def ctrl():
        return RuntimeController(ControllerConfig(
            cooldown_steps=1, quarantine=False, shed=False,
            freeze_buckets=False))

    fin = run("partial_a", 1.0, controller=ctrl())
    again = run("partial_b", 1.0, controller=ctrl())
    sync = run("partial_sync", float("inf"))
    g = fin["gang"]
    on_dev = dev == "cuda" or getattr(dev, "type", None) == "cuda"
    if on_dev:
        n, L = fin["calls"], trainer.model.config.num_layers
        assert fin["counts"] == (L * n, L * n, n, n), (fin["counts"], n)
    diff = surv_diff(fin["snap"], again["snap"])
    same = g.losses_by_step == again["gang"].losses_by_step
    steps = sorted(g.losses_by_step)
    print(f"survival (d): stalls (step, worker, steps) {stalls}; "
          f"deadline 1.0 -> sim_time {g.sim_time} over {len(steps)} steps; "
          f"deadline inf -> sim_time {sync['gang'].sim_time}; losses at "
          f"matched steps " + ", ".join(
              f"{s}: {g.losses_by_step[s]:.6f} / "
              f"{sync['gang'].losses_by_step[s]:.6f}" for s in steps))
    print(f"survival (d): {fin['calls']} per-worker gradients of 2 x "
          f"{ids[0].shape[1]} tokens, launches flash {fin['counts'][0]} / "
          f"{fin['counts'][1]}, CE {fin['counts'][2]} / "
          f"{fin['counts'][3]} (12 / 12 / 1 / 1 a gradient); wall "
          f"{fin['wall']:.2f} s; the straggler replay bitwise: losses "
          f"{same}, state {not diff}")
    assert same and not diff, diff[:8]
    assert g.sim_time < sync["gang"].sim_time, (g.sim_time,
                                                sync["gang"].sim_time)
    acts = [a for a in fin["gang"].controller.actions
            if a["action"] == "deadline_retune"]
    cfg = g.partial
    print(f"survival (d): the controller retuned the deadline {len(acts)} "
          f"times: {[round(a['new'], 4) for a in acts]}; final "
          f"{cfg.deadline} ({cfg.deadline_source}) within the clamp "
          f"[{cfg.min_deadline}, {cfg.max_deadline}]")
    assert acts and cfg.deadline_source == "controller" \
        and cfg.min_deadline <= cfg.deadline <= cfg.max_deadline
    for label, r in (("deadline 1.0", fin), ("deadline inf", sync)):
        snap = r["meter"].snapshot()
        total = sum(snap["totals"].values())
        print(f"survival (d): goodput buckets at {label} (sim-time units) "
              f"{snap['totals']}, sum {total} == total {snap['total']} == "
              f"sim_time {r['gang'].sim_time}; straggler wait by worker "
              f"{snap['straggler_wait_by_worker']}")
        assert total == snap["total"] \
            and abs(total - r["gang"].sim_time) < 1e-9
    snap = fin["meter"].snapshot()
    # a bit flip on worker 2's replica after step 3's update
    flip = run("partial_flip", 1.0, controller=RuntimeController(
        ControllerConfig(tune_deadline=False, quarantine=True, shed=False,
                         freeze_buckets=False)),
        numerics=True, save_every=2, keep=2, steps=4,
        plan=faults.FaultPlan([(3, faults.Fault("bit_flip", worker=2,
                                                arg=5))]))
    jr = flip["journal"]
    div = surv_events(jr, "replica_divergence")
    rem = [e for e in surv_events(jr, "remediation")
           if e["action"] == "quarantine"]
    restore = surv_events(jr, "shard_restore")
    print(f"survival (d): bit_flip -> replica_divergence {div[:1]}; "
          f"quarantine {rem[:1]}; shard_restore "
          f"{[(e['rank'], e['from_rank']) for e in restore]}; world "
          f"{flip['gang'].world_size}; {card}")
    assert div and div[0]["step"] == 3 and div[0]["worker"] == 2
    assert rem and rem[0]["worker"] == 2
    assert restore and restore[0]["rank"] == 2
    surv_restore(trainer, s0)
    reset_seed_seqnum(*r0)
    return {"sim_time": (g.sim_time, sync["gang"].sim_time),
            "goodput": (snap["totals"], sync["meter"].snapshot()["totals"]),
            "counts": fin["counts"],
            "calls": fin["calls"]}


def surv_serve(model, dev, card, vocab, budget=8):
    """(e) ``ServingEngine(controller=)`` on phase 4's engine: sustained
    SLO burn sheds and releases, a compile_storm freezes bucket growth
    and lifts, every admitted stream the plain engine's."""
    from hetu_tpu_torch import ServingEngine
    from hetu_tpu_torch.exec import ControllerConfig, RuntimeController, faults
    from hetu_tpu_torch.obs import compile as obs_compile

    clk = FleetClock()

    def engine(**kw):
        return ServingEngine(model, num_slots=SERVE_SLOTS, page_size=16,
                             clock=clk, device=dev, **kw)

    def alone(prompt):
        eng = engine()
        h = eng.submit(prompt, max_new_tokens=budget)
        eng.run_until_idle()
        return h.tokens

    rng = np.random.default_rng(16)
    short, other, long = (rng.integers(0, vocab, n).tolist()
                          for n in (5, 6, 40))
    plain = {n: alone(p) for n, p in (("short", short), ("other", other),
                                      ("long", long))}
    base = dict(sustain_ticks=2, shed_on=0.9, shed_off=0.1,
                tune_deadline=False, quarantine=False)
    ctrl = RuntimeController(ControllerConfig(freeze_buckets=False, **base))
    eng = engine(controller=ctrl)
    h = eng.submit(short, max_new_tokens=budget)
    clk.t += 1.0                  # a second in the queue burns every target
    eng.run_until_idle()
    eng.step()
    engaged_one = ctrl.shed_active
    eng.step()
    assert not engaged_one and ctrl.shed_active and eng.batcher.shedding
    h2 = eng.submit(other, max_new_tokens=budget)
    assert h2.status == "rejected" and "controller shed" in h2.error
    clk.t += 700.0
    eng.step()
    eng.step()
    assert not ctrl.shed_active and not eng.batcher.shedding
    h3 = eng.submit(other, max_new_tokens=budget)
    eng.run_until_idle()
    assert h.tokens == plain["short"] and h3.tokens == plain["other"]
    acts = [a["action"] for a in ctrl.actions]
    print(f"survival (e): sustained burn: shed after 2 ticks, a request "
          f"rejected ({h2.error[:40]}...), released after the windows "
          f"drained; actions {acts}; admitted streams bitwise the plain "
          f"engine's: True")
    prev = obs_compile.get_storm()
    obs_compile.configure_storm(obs_compile.StormDetector(
        threshold=2, window_s=50.0, clock=clk))
    try:
        ctrl = RuntimeController(ControllerConfig(shed=False, **base))
        eng = engine(controller=ctrl)
        h = eng.submit(short, max_new_tokens=budget)
        eng.run_until_idle()
        plan = faults.FaultPlan([(1, faults.Fault("compile_storm", arg=3))])
        with faults.inject(plan):
            eng.step()
        assert not plan.remaining()
        assert ctrl.freeze_active and eng.freeze_bucket_growth
        h2 = eng.submit(long, max_new_tokens=budget)
        assert h2.status == "rejected" and "frozen" in h2.error
        h3 = eng.submit(other, max_new_tokens=budget)
        eng.run_until_idle()
        clk.t += 100.0
        eng.step()
        assert not ctrl.freeze_active and not eng.freeze_bucket_growth
        h4 = eng.submit(long, max_new_tokens=budget)
        eng.run_until_idle()
    finally:
        obs_compile.configure_storm(prev)
    assert (h.tokens, h3.tokens, h4.tokens) == (
        plain["short"], plain["other"], plain["long"])
    acts = [a["action"] for a in ctrl.actions]
    print(f"survival (e): compile_storm: bucket growth frozen (a "
          f"{len(long)}-token prompt rejected, a warm bucket served), "
          f"lifted when the window cleared; actions {acts}; admitted "
          f"streams bitwise the plain engine's: True; {card}")


def surv_shard_kernels(fl, ce, card):
    """(d)'s kernels at the worker shard's shape, 2 x 1024 tokens: the
    flash pair and the CE pair against their plain versions, timed."""
    gen = torch.Generator().manual_seed(16)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fl_rows = check_flash(fl, flush, torch.float32, 1024, gen, timed=True,
                          B=2, H=12)
    ce_rows = check_lm_head_ce(ce, flush, torch.float32, gen, card,
                               N=2 * 1023, extra=False)
    del flush
    torch.cuda.empty_cache()
    return fl_rows, ce_rows


def survival_phase(fl, ce, card, dev="cuda", cfg=None, resnet_image=32,
                   resnet_batch=SURV_RESNET_BATCH):
    """Phase 16: the survival layer on GPT-2 small at full width and
    depth (fp32, TF32 off, flash, the streamed head with chunk 1024,
    AdamW, batch 8 x 1024), and the anomaly policy on ResNet-18.
    ``cfg``, ``resnet_image`` and ``resnet_batch`` cut it for a CPU
    rehearsal (``dev="cpu"``).  Returns its readings and the seconds it
    took."""
    import shutil
    import tempfile
    t_phase = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="hetu_survival_")
    try:
        free = shutil.disk_usage(tmp).free
        print(f"survival: checkpoints under {tmp}, {free} bytes free")
        assert free > SURV_DISK or dev == "cpu", \
            f"need {SURV_DISK} bytes free for phase 16's checkpoints"
        on_dev = dev == "cuda"
        shard = surv_shard_kernels(fl, ce, card) if on_dev else None
        gcfg, trainer, ids = surv_gpt(dev, cfg)
        batch0 = torch.from_numpy(ids[0]).to(dev)
        needed = surv_repeat(trainer, batch0, dev, "(0) GPT-2 small")
        out = {"repeat": needed, "shard": shard}
        out["resilient"] = surv_resilient(trainer, ids, dev, card, tmp)
        out["resnet"] = surv_resnet(dev, card, tmp, image=resnet_image,
                                    n=resnet_batch)
        out["elastic"] = surv_elastic(trainer, ids, dev, card, tmp)
        out["partial"] = surv_partial(trainer, ids, fl, ce, dev, card, tmp)
        del trainer
        from hetu_tpu_torch import GPT
        serve_cfg = dataclasses.replace(gcfg, streamed_head_chunk=0)
        model = GPT(serve_cfg, generator=torch.Generator().manual_seed(0),
                    device=dev)
        surv_serve(model, dev, card, serve_cfg.vocab_size)
        del model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    fleet_sync(dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out, time.monotonic() - t_phase


# -- phase 17: accounting ------------------------------------------------------

ACCT_TRACE_STEPS = 2            # (c) steps under the trace
ACCT_UNION_TOL = 0.05           # (c) breakdown total vs the union of spans
ACCT_SLOWDOWN = 1.5             # (d) the planted step record
ACCT_CTR_STEPS = 6              # (e) tiered Wide&Deep steps
ACCT_ALLOC_SLACK = 0.005        # (c) allocator growth over the ledger's bytes
FP32_PEAK = 67e12               # (c) MFU's peak: fp32 outside the tensor cores


class FrozenSLO:
    """An ``SLOEngine``'s readings taken once, so the two stores that
    (d) builds from the same inputs read the same values (the live
    engine's shed pressure moves with the clock)."""

    def __init__(self, slo):
        self.requests = slo.requests
        self._pressure = slo.shed_pressure()
        self._stages = slo.stage_summary()
        self.violations = dict(slo.violations)

    def shed_pressure(self):
        return self._pressure

    def stage_summary(self):
        return self._stages


def http_json(url):
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def acct_serve(pd, lh, card, dev, cfg, prompts, led):
    """(a) phase 4's engine (8 slots, page 16, the model's window) with
    the ledger installed: exact at every tick, no leak at the end; the
    bytes by class and component beside the allocator's."""
    from hetu_tpu_torch import GPT, ServingEngine
    from hetu_tpu_torch.obs import server as obs_server
    cuda = dev == "cuda"
    model = GPT(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    eng = ServingEngine(model, num_slots=SERVE_SLOTS, page_size=16,
                        device=dev)
    pd.reset_launch_count()
    lh.reset_launch_count()
    handles = [eng.submit(p, max_new_tokens=SERVE_BUDGET) for p in prompts]
    ticks = 0
    while not eng.batcher.idle:
        eng.step()
        led.snapshot()             # asserts the KV classes' exactness
        ticks += 1
    if cuda:
        torch.cuda.synchronize()
    launches = pd.launches_by_head_block()
    sample_launches = lh.launch_count()
    bad = [(h.request_id, h.status) for h in handles
           if h.status != "completed" or len(h.tokens) != SERVE_BUDGET]
    assert not bad, f"requests not completed: {bad}"
    snap = led.snapshot()
    (p,) = snap["kv_pools"].values()
    assert p["balance"] == 0 and p["drift"] == 0 and p["live_sequences"] == 0
    assert snap["leak_suspects"] == []
    steps = eng.stats()["decode_steps"]
    if cuda:
        assert sum(launches.values()) == cfg.num_layers * steps > 0, launches
        assert sample_launches == steps, sample_launches
    print(f"(a) {len(handles)} requests, {ticks} ticks, each snapshot exact;"
          f" paged decode launches by head block {launches}, sampling "
          f"{sample_launches}; allocs {p['allocs']} frees {p['frees']} "
          f"balance {p['balance']} drift {p['drift']}, no leak suspects "
          f"[{card}]")
    print(f"(a) KV pool {p['bytes_total']} bytes, {p['page_bytes']} a page;"
          f" at the end by class {p['bytes_by_class']}; peak "
          f"{p['peak_used_pages']} pages used ({p['peak_used_fraction']:.4f})"
          f", {p['peak_shared_pages']} shared; fragmentation "
          f"{snap['fragmentation']:.4f}; high-water marks "
          f"{snap['hwm_bytes']} [{card}]")
    graph = snap["compile_sites"].get("serve.decode_graph")
    print(f"(a) compile component {snap['components']['compile']} bytes: "
          f"decode graph {graph} [{card}]")
    if cuda:
        assert graph and graph["programs"] == 1
        assert graph["temp_bytes"] == eng._decode_graph.pool_bytes > 0
        alloc = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        rest = alloc - snap["total_bytes"]
        print(f"(a) ledger total {snap['total_bytes']} bytes beside "
              f"torch.cuda.memory_allocated() {alloc} (reserved "
              f"{reserved}): unattributed {rest} bytes, of which the "
              f"model's weights are {weights} (serving posts no weights) "
              f"and the rest {rest - weights} [{card}]")
    with obs_server.serve(port=0) as srv:
        body = http_json(srv.url + "/memory")
    again = led.snapshot()
    assert body["snapshots"] + 1 == again["snapshots"]
    body.pop("snapshots")
    again.pop("snapshots")
    assert body == again, "/memory differs from the ledger's snapshot"
    print(f"(a) /memory over HTTP on port {srv.port} equals the snapshot "
          f"({len(json.dumps(body))} bytes of JSON)")
    tokens = [h.tokens for h in handles]
    return {"model": model, "site": eng._graph_site,
            "slo": FrozenSLO(eng.slo), "tokens": tokens, "snap": snap,
            "launches": launches, "weights": weights}


def acct_autotune(pd, card, prompts, kind):
    """(b) paged decode's head block tuned on the card in bf16 and fp32
    (the fp32 entry is the one the fp32 engine reads), each head block
    bitwise the others at phase 4's decode lengths."""
    from hetu_tpu_torch.ops.kernels import autotune as at
    entries = {}
    for dtype in (torch.bfloat16, torch.float32):
        e = at.autotune_paged_decode(12, 64, 16, dtype=dtype,
                                     pages_per_seq=64)
        entries[dtype] = e
        print(f"(b) autotune paged_decode h12 d64 p16 {dtype}: " + ", ".join(
            f"head block {hb} {t * 1e3:.4f} ms" for hb, t in
            sorted(e["table"].items(), key=lambda kv: int(kv[0])))
            + f" -> {e['head_block']} [{card}]")
    steps = serve_decode_lengths([len(p) for p in prompts])
    H, D, page, L, pps = 12, 64, 16, 12, 64
    per_row = -(-max(max(s) for s in steps) // page)
    P = 1 + SERVE_SLOTS * per_row
    gen = torch.Generator().manual_seed(17)
    tables = torch.zeros((SERVE_SLOTS, pps), dtype=torch.int32)
    for b in range(SERVE_SLOTS):
        tables[b, :per_row] = 1 + b * per_row + torch.arange(per_row)
    tables = tables.cuda()
    for dtype in (torch.float32, torch.bfloat16):
        k, v = (torch.randn((L, P, page, H, D), generator=gen).to(
            "cuda", dtype) for _ in range(2))
        q = torch.randn((SERVE_SLOTS, H, D), generator=gen).to("cuda", dtype)
        for lens in steps:
            sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            outs = [pd.paged_decode_attention(q, k, v, tables, sl,
                                              layer=L - 1, head_block=hb)
                    for hb in (1, 2, 4)]
            assert all(torch.equal(o, outs[0]) for o in outs[1:]), \
                f"head blocks differ at lengths {lens} ({dtype})"
        print(f"(b) {dtype}: head blocks 1, 2, 4 bitwise equal at all "
              f"{len(steps)} of phase 4's decode steps")
        del k, v
    at.clear_tune_cache()
    path = at._cache_path()
    disk = json.loads(path.read_text())
    hit = at.tuned_entry("paged_decode", "h12|d64|p16", kind=kind)
    assert hit is not None and hit == disk[f"paged_decode|{kind}|h12|d64|p16"]
    assert hit["head_block"] == entries[torch.float32]["head_block"]
    print(f"(b) the DB reloads with paged_decode|{kind}|h12|d64|p16 -> head "
          f"block {hit['head_block']} ({len(disk)} entries in {path.name})")
    return entries


def acct_tuned_engine(pd, card, model, prompts, tokens, tuned):
    """(b) an engine built after the sweep captures its decode graph at
    the tuned head block; its greedy streams equal (a)'s."""
    from hetu_tpu_torch import ServingEngine
    eng = ServingEngine(model, num_slots=SERVE_SLOTS, page_size=16)
    pd.reset_launch_count()
    handles = [eng.submit(p, max_new_tokens=SERVE_BUDGET) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    launches = pd.launches_by_head_block()
    assert list(launches) == [tuned], launches
    same = [h.tokens == t for h, t in zip(handles, tokens)]
    assert all(same), f"tuned engine's streams differ: {same}"
    del eng
    print(f"(b) engine after the sweep: paged decode launches by head block "
          f"{launches}; all {len(handles)} greedy streams bitwise (a)'s "
          f"[{card}]")


def acct_train(fl, ce, card, dev, cfg, led, kind):
    """(c) phase 5's GPT-2 small (fp32, TF32 off, flash, streamed head
    chunk 1024, AdamW, 8 x 1024) for 5 steps with the ledger and a
    goodput meter installed; the trace's breakdown, ``Trainer.profile``
    and ``HetuTimer`` sections."""
    from hetu_tpu_torch import AdamWOptimizer, GPT, Trainer, flash_attn_fn
    from hetu_tpu_torch.exec import profiler
    from hetu_tpu_torch.obs import goodput
    cuda = dev == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    alloc = torch.cuda.memory_allocated if cuda else (lambda: 0)
    sync()
    a0 = alloc()
    model = GPT(cfg, attn_fn=flash_attn_fn(native_layout=True),
                generator=torch.Generator().manual_seed(0), device=dev)
    sync()
    a1 = alloc()
    trainer = Trainer(model, AdamWOptimizer(3e-4, weight_decay=0.01),
                      lambda m, batch, key: (m.loss(batch, key=key), {}))
    sync()
    a2 = alloc()
    nparams = sum(p.numel() for p in model.parameters())
    train = led.snapshot()["train"]
    assert train["weights_bytes"] == 4 * nparams + sum(
        b.numel() * b.element_size() for b in model.buffers())
    assert train["optimizer_bytes"] == 2 * 4 * nparams
    print(f"(c) train_weights {train['weights_bytes']} bytes = "
          f"{nparams} parameters x 4; train_optimizer "
          f"{train['optimizer_bytes']} = 2 x that (AdamW's step is a host "
          f"int: 0 device bytes); allocator growth over the model's build "
          f"{a1 - a0}, over the Trainer's {a2 - a1} [{card}]")
    if cuda:
        # the caching allocator rounds each block up (a tensor over 1 MiB
        # may hold up to 2 MiB more), so the growth is a little larger
        for grew, want in ((a1 - a0, train["weights_bytes"]),
                           (a2 - a1, train["optimizer_bytes"])):
            assert 0 <= grew - want <= ACCT_ALLOC_SLACK * want, (grew, want)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, cfg.max_seq_len))).to(dev)
    meter = goodput.GoodputMeter()
    meter.set_flops_model(goodput.transformer_train_flops(
        cfg.num_layers, cfg.hidden_size, cfg.vocab_size, 8, cfg.max_seq_len),
        peak=FP32_PEAK)
    goodput.install_meter(meter)
    fl.reset_launch_count()
    ce.reset_launch_count()
    losses, step_s = [], []
    try:
        for _ in range(5):
            t0 = time.monotonic()
            losses.append(float(trainer.step(ids)["loss"]))
            sync()
            step_s.append(time.monotonic() - t0)
    finally:
        goodput.install_meter(None)
    counts = (fl.fwd_launch_count(), fl.bwd_launch_count(),
              ce.fwd_launch_count(), ce.bwd_launch_count())
    if cuda:
        assert counts == (60, 60, 5, 5), f"launches over 5 steps {counts}"
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    med = statistics.median(step_s)
    gsnap = meter.snapshot()
    print(f"(c) 5 steps: losses {[round(x, 6) for x in losses]}; launches "
          f"flash fwd/bwd, CE fwd/bwd {counts}; median step "
          f"{med * 1e3:.3f} ms; goodput MFU (fp32 peak 67 TFLOP/s) "
          f"rolling {gsnap['mfu_rolling']:.4f} [{card}]")
    logdir = os.path.join(ACCT_TMP, "trace")
    with profiler.trace(logdir, device=dev) as prof:
        for _ in range(ACCT_TRACE_STEPS):
            trainer.step(ids)
    per, totals = profiler.device_op_breakdown(logdir,
                                               steps=ACCT_TRACE_STEPS)
    print(f"(c) device_op_breakdown over {ACCT_TRACE_STEPS} traced steps, "
          f"per step: device {totals['device_s'] * 1e3:.3f} ms, copies "
          f"{totals['copy_s'] * 1e3:.3f} ms, {len(per)} kernels [{card}]")
    for name, s in list(per.items())[:8]:
        print(f"  {s * 1e3:9.3f} ms  {name[:100]}")
    ours = {n: s for n, s in per.items() if "::flash_" in n or "::ce_" in n}
    for name, s in sorted(ours.items(), key=lambda kv: -kv[1]):
        print(f"  {s * 1e3:9.3f} ms  (port) {name[:90]}")
    out = {"per": per, "totals": totals, "median_s": med, "meter": meter}
    if cuda:
        assert any("::flash_fwd" in n for n in ours) \
            and any("::ce_" in n for n in ours), sorted(ours)
        spans = device_spans(prof)
        union = union_ms([sp[1:] for sp in spans]) / ACCT_TRACE_STEPS
        summed = sum(b - a for _, a, b in spans) / 1e3 / ACCT_TRACE_STEPS
        total_ms = totals["device_s"] * 1e3
        gap = total_ms / union - 1
        print(f"(c) breakdown total {total_ms:.3f} ms a step; the same "
              f"profile's device spans sum to {summed:.3f} ms and their "
              f"union (profile_step's measure) is {union:.3f} ms: "
              f"breakdown / union - 1 = {gap:+.2%} (limit "
              f"{ACCT_UNION_TOL:.0%}); overlap counted twice in the sum "
              f"{summed - union:.3f} ms [{card}]")
        assert abs(total_ms / summed - 1) < 1e-3, (total_ms, summed)
        assert abs(gap) <= ACCT_UNION_TOL, (total_ms, union)
        out["union_ms"] = union
        out["union_gap"] = gap
    from hetu_tpu_torch.obs import calibration as calib
    mem_store = calib.install_store(
        calib.ProfileStore(clock=lambda: 0.0))
    try:
        prof_out = trainer.profile(ids, iters=5)
    finally:
        calib.install_store(None)
    mem = mem_store.get("mem", model_sig="train.step", device_kind=kind)
    print(f"(c) Trainer.profile: p50 {prof_out['p50_s'] * 1e3:.3f} ms, "
          f"mean {prof_out['mean_s'] * 1e3:.3f} ms (CUDA events, 5 calls) "
          f"beside the median step {med * 1e3:.3f} ms (host clock); peak "
          f"{prof_out.get('peak_bytes')} bytes; its mem record (the "
          f"ledger's train bytes over the bytes resident before the "
          f"calls) {mem and mem['values']} [{card}]")
    out["profile"] = prof_out
    timer = profiler.HetuTimer()
    params = dict(model.named_parameters())
    for _ in range(3):
        for p_ in params.values():
            p_.grad = None
        with timer("forward"):
            loss = model.loss(ids)
        with timer("backward"):
            loss.backward()
        with timer("update"):
            trainer.optimizer.update({k: p_.grad for k, p_ in params.items()},
                                     trainer.opt_state, params)
    stats = timer.log_out(printer=lambda *a: None)
    print("(c) HetuTimer (synchronized sections, mean of 3): " + ", ".join(
        f"{n} {s['mean_s'] * 1e3:.3f} ms" for n, s in stats.items())
        + f" [{card}]")
    out["timer"] = stats
    out["snap"] = led.snapshot()
    del trainer, model, params
    return out


def acct_store(path, kind, site, train, slo, mem_a, mem_c):
    """(d) one ``ProfileStore`` from (a)-(c)'s readings, under a pinned
    clock: goodput, op breakdown and memory of the train run, (b)'s
    autotune entries, (a)'s compile site and SLO."""
    from hetu_tpu_torch.obs.calibration import ProfileStore
    store = ProfileStore(path, clock=lambda: 0.0, autosave=False)
    train_sig, serve_sig = "gpt2_small.train", "gpt2_small.serve"
    store.ingest_goodput(train["meter"], model_sig=train_sig,
                         device_kind=kind)
    store.ingest_op_breakdown(train["per"], train["totals"],
                              model_sig=train_sig, device_kind=kind)
    store.ingest_memory(mem_c, model_sig=train_sig, device_kind=kind)
    store.ingest_memory(mem_a, model_sig=serve_sig, device_kind=kind)
    store.ingest_autotune(device_kind=kind)
    store.ingest_compile(site, model_sig=serve_sig, device_kind=kind)
    store.ingest_slo(slo, model_sig=serve_sig, device_kind=kind)
    store.put("step", {"step_time_s": train["median_s"]},
              model_sig=train_sig, device_kind=kind, source="chip_smoke")
    return store


def acct_calibration(card, kind, site, slo, train, mem_a):
    """(d) the store: byte-identical across a save/load round trip and
    across two builds from the same inputs; the fits; a planted step
    record 1.5x slower graded a regression, which ``/healthz`` shows."""
    from hetu_tpu_torch.obs import calibration as calib
    from hetu_tpu_torch.obs import server as obs_server
    path = os.path.join(ACCT_TMP, "calibration.json")
    store = acct_store(path, kind, site, train, slo, mem_a, train["snap"])
    twin = acct_store(None, kind, site, train, slo, mem_a, train["snap"])
    assert store.to_json() == twin.to_json(), "two builds differ"
    store.save()
    loaded = calib.ProfileStore.load(path)
    assert loaded.to_json() == store.to_json(), "round trip differs"
    assert store.regressions() == []
    print(f"(d) ProfileStore: {len(store.records)} keys, "
          f"{len(store.to_json())} bytes, byte-identical across the round "
          f"trip and across two builds [{card}]")
    for sig, n_layers in (("gpt2_small.train", 12),
                          ("gpt2_small.serve", None)):
        fit = calib.fit_calibration(store, model_sig=sig, device_kind=kind,
                                    n_layers=n_layers)
        print(f"(d) fit {sig}: " + ", ".join(
            f"{c.name} {c.value:.6g} (n={c.n})" for c in fit.constants)
            + f" [{card}]")
    calib.install_store(store)
    try:
        with obs_server.serve(port=0) as srv:
            before = http_json(srv.url + "/healthz")
            base = store.get("step", model_sig="gpt2_small.train",
                             device_kind=kind)["values"]["step_time_s"]
            store.put("step", {"step_time_s": base * ACCT_SLOWDOWN},
                      model_sig="gpt2_small.train", device_kind=kind,
                      source="chip_smoke planted")
            after = http_json(srv.url + "/healthz")
            summary = http_json(srv.url + "/calibration")
    finally:
        calib.install_store(None)
    flags = [f for f in after["flags"] if f["flag"] == "perf_regression"]
    assert all(f["flag"] != "perf_regression" for f in before["flags"])
    assert after["status"] == "unhealthy" and flags, after
    assert flags[0]["worst"] == "step_time_s" and flags[0]["ratio"] == 1.5
    assert summary["regressions"] == store.regressions()
    print(f"(d) planted step record x{ACCT_SLOWDOWN}: /healthz "
          f"{before['status']} -> {after['status']} with {flags[0]}")
    return store


def acct_tier(card, led, store, kind):
    """(e) phase 9's tiered Wide&Deep arm with the ledger installed:
    after every stage ``embed_hbm`` is the resident rows x dim x 4."""
    from hetu_tpu_torch.models.ctr import WideDeep
    data, dev = ctr_data()
    model = WideDeep(ctr_config("tiered-f32"),
                     generator=torch.Generator().manual_seed(0))
    trainer = ctr_trainer(model)
    staged = trainer.staged_modules()
    tiers = [m for m in staged if hasattr(m, "tier_stats")]
    assert tiers
    for i in range(ACCT_CTR_STEPS):
        ids, b = ctr_batch(data, dev, i)
        for m in staged:
            m.stage(ids)
        snap = led.snapshot()
        for m in tiers:
            resident = m.tier_stats()["hbm"]["resident"]
            assert snap["embed"][m.name] == {
                "rows": resident, "bytes": resident * m.dim * 4}, \
                (snap["embed"], resident)
        assert snap["components"]["embed_hbm"] == sum(
            e["bytes"] for e in snap["embed"].values())
        out = trainer.step(b)
    ctr_flush(trainer)
    assert torch.isfinite(out["loss"]).all()
    recs = [store.ingest_embed(m, model_sig=f"wdl_ctr.{m.name}",
                               device_kind=kind)["values"] for m in tiers]
    print(f"(e) tiered Wide&Deep, {ACCT_CTR_STEPS} steps: after each stage "
          f"embed_hbm == resident rows x dim x 4; last {snap['embed']}; "
          f"embed records {recs} [{card}]")
    del trainer, model


ACCT_TMP = None


def accounting_phase(pd, lh, fl, ce, card):
    """Phase 17: the ledger, the autotune database, the profiler and the
    calibration store driven on GPT-2 small's serve and train paths and
    the tiered CTR arm.  Returns its readings and seconds."""
    import shutil
    import tempfile
    from hetu_tpu_torch import gpt2_small
    from hetu_tpu_torch.obs import memledger
    from hetu_tpu_torch.ops.kernels import autotune as at
    global ACCT_TMP
    t0 = time.monotonic()
    kind = torch.cuda.get_device_name(0)
    ACCT_TMP = tempfile.mkdtemp(prefix="hetu_acct_")
    old_db = os.environ.get(at._CACHE_ENV)
    os.environ[at._CACHE_ENV] = os.path.join(ACCT_TMP, "tune_db.json")
    at.clear_tune_cache()
    led = memledger.install_ledger(memledger.MemoryLedger())
    try:
        cfg = gpt2_small()
        prompts = serve_prompts(cfg.vocab_size)
        serve = acct_serve(pd, lh, card, "cuda", cfg, prompts, led)
        default = pd.heads_per_block(cfg.num_heads, cfg.hidden_size
                                     // cfg.num_heads, 4)
        assert list(serve["launches"]) == [default], serve["launches"]
        entries = acct_autotune(pd, card, prompts, kind)
        tuned = entries[torch.float32]["head_block"]
        acct_tuned_engine(pd, card, serve.pop("model"), prompts,
                          serve["tokens"], tuned)
        gc.collect()
        torch.cuda.empty_cache()
        train = acct_train(fl, ce, card, "cuda",
                           gpt2_small(streamed_head_chunk=1024), led, kind)
        gc.collect()
        torch.cuda.empty_cache()
        store = acct_calibration(card, kind, serve["site"], serve["slo"],
                                 train, serve["snap"])
        acct_tier(card, led, store, kind)
    finally:
        memledger.install_ledger(None)
        if old_db is None:
            os.environ.pop(at._CACHE_ENV, None)
        else:
            os.environ[at._CACHE_ENV] = old_db
        at.clear_tune_cache()
        shutil.rmtree(ACCT_TMP, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"tuned": tuned, "entries": entries, "train": train,
            "serve": serve}, time.monotonic() - t0


# --------------------------------------------------------------- phase 18

PLAN_POLICIES = ("dots_no_batch", "dots_saveable", "full", "none",
                 "offload_dots")
PLAN_MICROBATCHES = (8, 16)     # (a) microbatches of 1024 tokens
PLAN_BUDGET_FRAC = 0.8          # (a) the budget: this share of none @ 16
PLAN_STEPS = 3                  # (a) the chosen plan's steps
OFF_BATCH = 8                   # (b) phase 5's batch
OFF_STEPS = 3                   # (b) timed steps an arm (the median)
GLUE_BATCH = 32                 # (c) the reference's GLUE recipe
GLUE_SEQ = 128
GLUE_STEPS = 10
GLUE_ROWS = 256                 # (c) rows of each written TSV
ONNX_BATCH, ONNX_SEQ = 1, 128   # (d) the exported call
ONNX_TOL = 1e-5                 # (d) max |diff| over max |logits|


def plan_cfg(gpt_mod, policy, cfg=None):
    base = cfg or gpt_mod.gpt2_small(streamed_head_chunk=1024)
    return dataclasses.replace(base, remat=policy)


def plan_model(gpt_mod, policy, dev, cfg=None):
    """Phase 5's GPT-2 small (flash, streamed head) under ``policy``,
    the same seeded weights whatever the policy."""
    from hetu_tpu_torch import GPT, flash_attn_fn
    attn = flash_attn_fn(native_layout=True) if dev == "cuda" else None
    return GPT(plan_cfg(gpt_mod, policy, cfg), attn_fn=attn,
               generator=torch.Generator().manual_seed(0), device=dev)


def plan_trainer(model, plan=None):
    from hetu_tpu_torch import AdamWOptimizer, Trainer
    return Trainer(model, AdamWOptimizer(3e-4, weight_decay=0.01),
                   lambda m, batch, key: (m.loss(batch, key=key), {}),
                   memory_plan=plan)


def plan_loss(m, batch):
    return m.loss(batch)


def dev_alloc(dev):
    """(sync, allocated, reset_peak, max_allocated) on ``dev`` (zeros on
    the CPU, where the allocator keeps no counts)."""
    if dev == "cuda":
        return (torch.cuda.synchronize, torch.cuda.memory_allocated,
                torch.cuda.reset_peak_memory_stats,
                torch.cuda.max_memory_allocated)
    return (lambda: None, lambda: 0, lambda: None, lambda: 0)


def plan_measure(model, model_bytes, batch, dev, steps=1, plan=None,
                 counts=None):
    """``steps`` AdamW steps of ``model`` on ``batch`` from a fresh
    trainer: the candidate's own device peak (the allocator's peak over
    the steps less what was allocated before the trainer, plus
    ``model_bytes``, the allocator's growth when the model was built),
    the last loss and the median step seconds.  ``counts`` (the launch
    counters to reset and read around the steps) returns their reading
    too; ``plan`` also runs the trainer's ``profile``."""
    sync, alloc, reset, peak = dev_alloc(dev)
    model.zero_grad(set_to_none=True)
    gc.collect()
    sync()
    a0 = alloc()
    trainer = plan_trainer(model, plan)
    b = batch.clone()
    sync()
    reset()
    if counts is not None:
        _build_mod().reset_launches(*counts)
    times, loss = [], None
    for _ in range(steps):
        t0 = time.monotonic()
        loss = float(trainer.step(b)["loss"])
        sync()
        times.append(time.monotonic() - t0)
    out = {"peak": peak() - a0 + model_bytes, "loss": loss,
           "step_s": statistics.median(times)}
    if counts is not None:
        out["launches"] = {n: _build_mod().launch_count(n) for n in counts}
    if plan is not None:
        out["profile"] = trainer.profile(b, iters=1)
    del trainer, b
    model.zero_grad(set_to_none=True)
    gc.collect()
    sync()
    out["left"] = alloc() - a0
    return out


def _build_mod():
    from hetu_tpu_torch.ops.kernels import _build
    return _build


def plan_arm(gpt_mod, card, dev="cuda", cfg=None, micros=PLAN_MICROBATCHES):
    """(a) One real step of every (policy, microbatch), a budget below
    none @ largest's measured peak, ``plan_memory``'s predictions against
    the measurements, and the chosen plan's ``Trainer(memory_plan=)``."""
    from hetu_tpu_torch import AdamWOptimizer
    from hetu_tpu_torch.mem import estimator, plan_memory
    vocab = plan_cfg(gpt_mod, "none", cfg).vocab_size
    seq = plan_cfg(gpt_mod, "none", cfg).max_seq_len
    ids = torch.from_numpy(np.random.default_rng(18).integers(
        0, vocab, (max(micros), seq))).to(dev)
    sync, alloc, _, _ = dev_alloc(dev)
    models, model_bytes, measured = {}, {}, {}
    for policy in PLAN_POLICIES:
        sync()
        a = alloc()
        models[policy] = plan_model(gpt_mod, policy, dev, cfg)
        sync()
        model_bytes[policy] = alloc() - a
        for mb in micros:
            r = plan_measure(models[policy], model_bytes[policy],
                             ids[:mb], dev)
            measured[(policy, mb)] = r
            print(f"(a) {policy} @ {mb} x {seq}: measured peak "
                  f"{r['peak']} bytes, loss {r['loss']:.6f}, step "
                  f"{r['step_s'] * 1e3:.1f} ms (first step), "
                  f"{r['left']} bytes left after [{card}]")
    top = max(micros)
    budget = int(PLAN_BUDGET_FRAC * measured[("none", top)]["peak"]) \
        if dev == "cuda" else 10 ** 15
    t0 = time.monotonic()
    plan = plan_memory(plan_loss, models.__getitem__,
                       lambda mb: ids[:mb].clone(), budget,
                       policies=PLAN_POLICIES, microbatch_options=micros,
                       optimizer=AdamWOptimizer(3e-4, weight_decay=0.01))
    plan_s = time.monotonic() - t0
    print(f"(a) budget {budget} bytes ({PLAN_BUDGET_FRAC} x none @ {top}'s "
          f"measured peak); plan_memory over {len(plan.candidates)} "
          f"candidates in {plan_s:.1f} s: {plan.describe()}")
    rows = []
    for c in plan.candidates:
        m = measured[(c.policy, c.microbatch)]
        r = (estimator.reconcile(c.predicted_peak_bytes, m["peak"],
                                 model_sig=f"{c.policy}@{c.microbatch}")
             if dev == "cuda" else {"ratio": float("nan"),
                                    "within_band": True})
        rows.append((c.policy, c.microbatch, c.predicted_peak_bytes,
                     m["peak"], r["ratio"], c.fits))
        print(f"(a) {c.policy:>13} @ {c.microbatch:>2}: predicted "
              f"{c.predicted_peak_bytes:>12} measured {m['peak']:>12} "
              f"ratio {r['ratio']:.4f} (band {estimator.ERROR_BAND}: "
              f"{r['within_band']}); fits {c.fits}; recompute "
              f"{c.recompute_factor}")
    assert plan.fits, plan.describe()
    counts = ("flash_fwd", "flash_bwd", "lm_head_ce_fwd", "lm_head_ce_bwd")
    chosen = models[plan.policy]
    run = plan_measure(chosen, model_bytes[plan.policy],
                       ids[:plan.microbatch], dev, steps=PLAN_STEPS,
                       plan=plan, counts=counts if dev == "cuda" else None)
    del models, chosen
    prof = run["profile"]
    print(f"(a) the plan's Trainer(memory_plan=): {PLAN_STEPS} steps, "
          f"measured peak {run['peak']} bytes under the budget {budget}: "
          f"{run['peak'] < budget}; loss {run['loss']:.6f}; launches "
          f"{run.get('launches')}; profile p50 "
          f"{prof['p50_s'] * 1e3:.1f} ms, step_peak_bytes "
          f"{prof.get('step_peak_bytes')}, estimator_error_ratio "
          f"{prof.get('estimator_error_ratio')}; {prof['memory_plan']} "
          f"[{card}]")
    if dev == "cuda":
        assert run["peak"] < budget, (run["peak"], budget)
        assert all(run["launches"][n] > 0 for n in counts), run["launches"]
        assert measured[("none", top)]["peak"] > budget
    return {"budget": budget, "plan": plan, "rows": rows, "run": run,
            "plan_s": plan_s}


def offload_counting_policy(saved):
    """A selective-checkpoint policy saving dots_no_batch's products and
    adding up their output bytes in the forward (from the products'
    operands, before they run)."""
    from torch.utils.checkpoint import CheckpointPolicy
    from hetu_tpu_torch.mem import policy as pol

    def fn(ctx, op, *args, **kw):
        if op not in pol._BATCH_FREE_DOTS:
            return CheckpointPolicy.PREFER_RECOMPUTE
        if not ctx.is_recompute:
            a, b = args[-2], args[-1]
            saved[0] += a.shape[0] * b.shape[1] * a.element_size()
        return CheckpointPolicy.MUST_SAVE
    return fn


def host_state_restores(trainer, ids, card, dev="cuda"):
    """(b) A trainer whose AdamW state lives on the host through a save,
    a ``profile`` (which restores the state it ran from) and a load: the
    state stays in the same pinned buffers, and the step after the load
    repeats the step after the profile bitwise (both start from the
    saved state)."""
    from hetu_tpu_torch.core.prng import key
    from hetu_tpu_torch.exec.checkpoint import (load_trainer_state,
                                                trainer_state_dict)

    def buffers():
        return [t for v in trainer.opt_state.values() if isinstance(v, dict)
                for t in v.values()]
    bufs = [id(t) for t in buffers()]
    saved = trainer_state_dict(trainer)
    trainer.profile(ids, iters=1)
    after_profile = trainer.step(ids, key(21))["loss"]
    first = trainer_state_dict(trainer)
    load_trainer_state(trainer, saved)
    after_load = trainer.step(ids, key(21))["loss"]
    second = trainer_state_dict(trainer)
    differ = [k for k in first if not np.array_equal(first[k], second[k])]
    print(f"(b) host AdamW state through save, profile and load: "
          f"{len(first) - len(differ)} of {len(first)} state entries "
          f"bitwise after the step from the saved state, losses "
          f"{float(after_profile)!r} / {float(after_load)!r} [{card}]")
    if dev == "cuda":
        assert [id(t) for t in buffers()] == bufs
        assert all(t.is_pinned() for t in buffers())
    assert torch.equal(after_profile, after_load)
    assert not differ, differ[:8]


def offload_arm(gpt_mod, card, dev="cuda", cfg=None, batch=OFF_BATCH):
    """(b) none, dots_no_batch, offload_dots and dots_no_batch with the
    AdamW state on the host: peak, median step, bytes to the host; the
    gradients of offload_dots bitwise dots_no_batch's."""
    from hetu_tpu_torch.mem import offload
    seq = plan_cfg(gpt_mod, "none", cfg).max_seq_len
    vocab = plan_cfg(gpt_mod, "none", cfg).vocab_size
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, vocab, (batch, seq))).to(dev)
    sync, alloc, reset, peak = dev_alloc(dev)
    # one backward each on the same weights and batch, gradients bitwise
    saved = [0]
    grads, losses, stats = {}, {}, {}
    for name, remat in (("dots_no_batch", "dots_no_batch"),
                        ("offload_dots", "offload_dots"),
                        ("counted", offload_counting_policy(saved))):
        m = plan_model(gpt_mod, remat, dev, cfg)
        offload.reset_offload_stats()
        loss = m.loss(ids)
        loss.backward()
        sync()
        stats[name] = offload.offload_stats()
        losses[name] = loss.detach()
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
        del m, loss
    same = [n for n in grads["dots_no_batch"]
            if not torch.equal(grads["dots_no_batch"][n],
                               grads["offload_dots"][n])]
    packed = stats["offload_dots"].get("packed_bytes", 0)
    print(f"(b) offload_dots vs dots_no_batch at {batch} x {seq}: losses "
          f"{float(losses['offload_dots'])!r} / "
          f"{float(losses['dots_no_batch'])!r}, "
          f"{len(grads['dots_no_batch']) - len(same)} of "
          f"{len(grads['dots_no_batch'])} gradients bitwise equal; packed "
          f"{packed} bytes in {stats['offload_dots'].get('packed', 0)} "
          f"products (dots_no_batch's saved set {saved[0]} bytes), back "
          f"{stats['offload_dots'].get('to_device_bytes', 0)} bytes")
    assert torch.equal(losses["offload_dots"], losses["dots_no_batch"])
    assert not same, same[:8]
    assert torch.equal(losses["counted"], losses["dots_no_batch"])
    if dev == "cuda":
        assert packed == saved[0] > 0, (packed, saved[0])
    del grads
    gc.collect()
    arms = {}
    for name, remat, host_state in (("none", "none", False),
                                    ("dots_no_batch", "dots_no_batch", False),
                                    ("offload_dots", "offload_dots", False),
                                    ("dots_no_batch + host AdamW state",
                                     "dots_no_batch", True)):
        gc.collect()
        sync()
        a0 = alloc()
        model = plan_model(gpt_mod, remat, dev, cfg)
        trainer = plan_trainer(model)
        if host_state:
            trainer.offload_optimizer_state()
        trainer.step(ids)                   # warm: pinned buffers, handles
        sync()
        reset()
        offload.reset_offload_stats()
        times, loss = [], None
        for _ in range(OFF_STEPS):
            t0 = time.monotonic()
            loss = float(trainer.step(ids)["loss"])
            sync()
            times.append(time.monotonic() - t0)
        st = offload.offload_stats()
        arms[name] = {"peak": peak() - a0, "loss": loss,
                      "step_ms": statistics.median(times) * 1e3,
                      "host_bytes": st.get("to_host_bytes", 0) // OFF_STEPS,
                      "device_bytes": st.get("to_device_bytes", 0)
                      // OFF_STEPS,
                      "host_state": offload.is_on_host(trainer.opt_state)}
        a = arms[name]
        print(f"(b) {name}: peak {a['peak']} bytes, step "
              f"{a['step_ms']:.1f} ms (median of {OFF_STEPS}), to the host "
              f"{a['host_bytes']} bytes a step, back {a['device_bytes']}, "
              f"loss {loss:.6f} [{card}]")
        if host_state:
            host_state_restores(trainer, ids, card, dev)
        del trainer, model
    if dev == "cuda":
        assert arms["dots_no_batch + host AdamW state"]["host_state"]
        assert arms["offload_dots"]["host_bytes"] >= packed
    return {"arms": arms, "packed": packed, "saved": saved[0]}


GLUE_WORDS = ("the", "a", "movie", "plot", "actor", "film", "scene", "story",
              "great", "dull", "fine", "bad", "good", "slow", "funny",
              "café", "naïve", "运动", "!", "?", "was", "is", "not", "very")


def glue_write(root, rng, rows=GLUE_ROWS):
    """SST-2's (``sentence\\tlabel``) and MRPC's (``a\\tb\\tlabel``) TSV
    layouts, with a header, of seeded words."""
    def sent(n):
        return " ".join(rng.choice(GLUE_WORDS, n))
    os.makedirs(os.path.join(root, "sst2"), exist_ok=True)
    os.makedirs(os.path.join(root, "mrpc"), exist_ok=True)
    with open(os.path.join(root, "sst2", "train.tsv"), "w") as f:
        f.write("sentence\tlabel\n")
        for _ in range(rows):
            f.write(f"{sent(rng.integers(4, 60))}\t{rng.integers(0, 2)}\n")
    with open(os.path.join(root, "mrpc", "train.tsv"), "w") as f:
        f.write("sentence1\tsentence2\tlabel\n")
        for _ in range(rows):
            f.write(f"{sent(rng.integers(4, 40))}\t"
                    f"{sent(rng.integers(4, 40))}\t{rng.integers(0, 2)}\n")


def glue_arm(card, dev="cuda", bert_cfg=None, steps=GLUE_STEPS,
             batch=GLUE_BATCH):
    """(c) The fine-tuning example's path on the port: ``glue_tsv``,
    ``build_vocab``, ``batch_encode``, a ``BertForPreTraining`` checkpoint
    warm-starting ``BertForSequenceClassification`` (fused LN), AdamW
    under ``WarmupLinearScheduler``."""
    import tempfile
    from hetu_tpu_torch import (AdamWOptimizer, BertForPreTraining, Trainer,
                                bert_base)
    from hetu_tpu_torch.data import BertTokenizer, build_vocab, glue_tsv
    from hetu_tpu_torch.exec import checkpoint as ckpt
    from hetu_tpu_torch.models import BertForSequenceClassification
    from hetu_tpu_torch.ops.kernels import fused_ln as fln
    from hetu_tpu_torch.optim import WarmupLinearScheduler
    cfg = bert_cfg or bert_base(fused_ln=True)
    tmp = tempfile.mkdtemp(prefix="hetu_glue_")
    out = {}
    try:
        glue_write(tmp, np.random.default_rng(21))
        data = {}
        for task in ("sst2", "mrpc"):
            sents, pairs, labels = glue_tsv(tmp, task, "train")
            corpus = sents + (pairs or [])
            tok = BertTokenizer(build_vocab(corpus, max_size=cfg.vocab_size),
                                max_len=GLUE_SEQ)
            enc = tok.batch_encode(sents, pairs, max_len=GLUE_SEQ,
                                   pad_to=GLUE_SEQ)
            data[task] = (enc, labels)
            print(f"(c) {task}: {len(sents)} rows, pairs "
                  f"{pairs is not None}, vocabulary {len(tok.vocab)}, ids "
                  f"{enc['input_ids'].shape}, mean length "
                  f"{enc['attention_mask'].sum(1).mean():.1f}, labels "
                  f"{np.bincount(labels).tolist()}")
        pre = BertForPreTraining(cfg, generator=torch.Generator()
                                 .manual_seed(3), device=dev)
        path = os.path.join(tmp, "pretrained.ckpt")
        ckpt.save_checkpoint(path, {"model": ckpt.state_dict(pre)})
        pre_sd = {k: v.detach().cpu() for k, v in pre.bert.state_dict()
                  .items()}
        del pre
        for task in ("sst2", "mrpc"):
            enc, labels = data[task]
            model = BertForSequenceClassification(
                cfg, 2, generator=torch.Generator().manual_seed(4),
                device=dev)
            saved = ckpt.load_checkpoint(path, restore_rng=False)[0]["model"]
            enc_sd = {k[len("bert."):]: v for k, v in saved.items()
                      if k.startswith("bert.")}
            ckpt.load_state_dict(model.bert, enc_sd)
            warm = all(torch.equal(v.cpu(), pre_sd[k])
                       for k, v in model.bert.state_dict().items())
            sched = WarmupLinearScheduler(5e-5, steps // 10, steps)
            trainer = Trainer(
                model, AdamWOptimizer(sched, weight_decay=0.01),
                lambda m, b, k: m.loss(b["ids"], b["tt"], b["mask"],
                                       b["y"], key=k, training=True))
            cols = {"ids": enc["input_ids"], "tt": enc["token_type_ids"],
                    "mask": enc["attention_mask"], "y": labels}
            fln.reset_launch_count()
            losses, times = [], []
            n = len(labels)
            for step in range(steps):
                lo = (step * batch) % (n - batch + 1)
                b = {k: torch.from_numpy(np.ascontiguousarray(
                    v[lo:lo + batch])).to(dev) for k, v in cols.items()}
                b["mask"] = b["mask"].bool()
                t0 = time.monotonic()
                m = trainer.step(b)
                losses.append(float(m["loss"]))
                if dev == "cuda":
                    torch.cuda.synchronize()
                times.append(time.monotonic() - t0)
            counts = (fln.fwd_launch_count(), fln.bwd_launch_count())
            step_ms = statistics.median(times[1:]) * 1e3
            out[task] = {"first": losses[0], "last": losses[-1],
                         "step_ms": step_ms, "launches": counts}
            print(f"(c) {task}: BERT-base ({cfg.num_layers} layers, hidden "
                  f"{cfg.hidden_size}, fused_ln {cfg.fused_ln}) warm-started"
                  f" from the checkpoint ({warm}); {steps} AdamW steps at "
                  f"{batch} x {GLUE_SEQ}, loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}, step {step_ms:.2f} ms (median after "
                  f"the first), fused-LN launches {counts} [{card}]")
            assert all(math.isfinite(x) for x in losses)
            assert warm
            if dev == "cuda":
                assert counts[0] > 0 and counts[1] > 0, counts
            del trainer, model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def onnx_arm(gpt_mod, card, dev="cuda", cfg=None):
    """(d) GPT-2 small exported by the port (plain attention and head),
    saved, loaded and imported on the card; logits against the module's
    own forward in fp32 with TF32 off."""
    import collections
    import tempfile
    from hetu_tpu_torch import GPT
    from hetu_tpu_torch.interop import export_module, load_model, save_model
    cfg = dataclasses.replace(cfg or gpt_mod.gpt2_small(),
                              streamed_head_chunk=0)
    model = GPT(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    ids = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (ONNX_BATCH, ONNX_SEQ))).to(dev)
    tmp = tempfile.mkdtemp(prefix="hetu_onnx_")
    try:
        t0 = time.monotonic()
        with torch.no_grad():
            proto = export_module(model, ids)
        export_s = time.monotonic() - t0
        path = os.path.join(tmp, "gpt2_small.onnx")
        t0 = time.monotonic()
        save_model(proto, path)
        save_s = time.monotonic() - t0
        size = os.path.getsize(path)
        ops = collections.Counter(n.op_type for n in proto.graph.nodes)
        del proto
        t0 = time.monotonic()
        fn, params = load_model(path, device=dev)
        import_s = time.monotonic() - t0
        with torch.no_grad():
            got = fn(params, ids)
            want = model(ids)
        if dev == "cuda":
            torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        print(f"(d) ONNX: {sum(ops.values())} nodes "
              f"{dict(sorted(ops.items()))}, {len(params)} initializers, "
              f"file {size} bytes; export {export_s:.2f} s, serialize "
              f"{save_s:.2f} s, load + import {import_s:.2f} s; logits "
              f"{tuple(got.shape)} max |diff| {err:.3e} over max |logit| "
              f"{scale:.3e} = {err / scale:.3e} (tol {ONNX_TOL}) [{card}]")
        assert tuple(got.shape) == tuple(want.shape)
        assert got.device.type == dev and params["wte.weight"].device.type \
            == dev
        assert err <= ONNX_TOL * scale, (err, scale)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"nodes": sum(ops.values()), "bytes": size, "export_s": export_s,
            "save_s": save_s, "import_s": import_s, "rel_err": err / scale}


def planning_phase(card, dev="cuda", cfg=None, bert_cfg=None,
                   micros=PLAN_MICROBATCHES, off_batch=OFF_BATCH):
    """Phase 18: (a) the memory plan, (b) offload, (c) GLUE fine-tuning,
    (d) the ONNX round trip.  Returns the readings and the seconds."""
    from hetu_tpu_torch.models import gpt as gpt_mod
    t0 = time.monotonic()
    out = {"plan": plan_arm(gpt_mod, card, dev, cfg, micros)}
    out["offload"] = offload_arm(gpt_mod, card, dev, cfg, off_batch)
    out["glue"] = glue_arm(card, dev, bert_cfg)
    out["onnx"] = onnx_arm(gpt_mod, card, dev, cfg)
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out, time.monotonic() - t0


# --------------------------------------------------------------- phase 19
# planning and brokering on the card: the JAX package's own planner runs
# (bench.py config 4's profile -> plan -> train, --mode plan, --mode
# broker) with only the hardware fields the card's.

PB_TRAIN = dict(vocab_size=32000, hidden_size=1024, num_layers=8,
                num_heads=16, max_seq_len=512)      # (a) config 4's shape
PB_BATCH, PB_STEPS = 32, 5                          # (a) its batch, steps
PB_SERVE = dict(vocab_size=32000, hidden_size=1024, num_layers=8,
                num_heads=16, max_seq_len=2048)     # (b), (c) replicas
PB_TRACE = (17, 24)                                 # (b) seed, requests
PB_PROMPT, PB_NEW = (64, 1024), (32, 64)            # (b) trace shape
H100_BF16 = 989e12                                  # data sheet, dense


def counting_engine_class(pd, lh, built):
    """A ``ServingEngine`` whose ``step`` keeps its own paged-decode and
    LM-head-sampling launches (the global counters' growth across it:
    a router steps its engines in turn on one thread, so each launch
    lands on the engine that made it); every instance joins ``built``."""
    from hetu_tpu_torch.serve.engine import ServingEngine

    class Engine(ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.launches = [0, 0]
            built.append(self)

        def step(self):
            a = fleet_counts(pd, lh)
            out = super().step()
            b = fleet_counts(pd, lh)
            self.launches[0] += b[0] - a[0]
            self.launches[1] += b[1] - a[1]
            return out

    return Engine


@contextlib.contextmanager
def counting_engines(pd, lh):
    """``serve.engine.ServingEngine`` is the counting subclass inside the
    block (``plan.build_fleet`` and the broker's episode import it when
    called); yields the list of engines built."""
    from hetu_tpu_torch.serve import engine as engine_mod
    built = []
    orig = engine_mod.ServingEngine
    engine_mod.ServingEngine = counting_engine_class(pd, lh, built)
    try:
        yield built, engine_mod.ServingEngine
    finally:
        engine_mod.ServingEngine = orig


def pb_train(fl, card, dev, tmp, cfg_kw=None, batch=PB_BATCH,
             steps=PB_STEPS):
    """(a) CostProfiler().calibrate() on the card, dp_search over the
    model's blocks at the global batch, then the plan's remat policy
    trained ``steps`` AdamW steps through the flash kernels."""
    from hetu_tpu_torch import AdamWOptimizer, GPT, GPTConfig, Trainer
    from hetu_tpu_torch import flash_attn_fn
    from hetu_tpu_torch.exec import profiler
    from hetu_tpu_torch.parallel.autoparallel import (
        CostProfiler, dp_search, transformer_layer_spec)
    cfg_kw = cfg_kw or PB_TRAIN
    prof = CostProfiler(cache_path=os.path.join(tmp, "profile.json"),
                        device=dev)
    t0 = time.monotonic()
    cluster = prof.calibrate()
    calib_s = time.monotonic() - t0
    sustained = prof.matmul_flops()
    assert CostProfiler(cache_path=os.path.join(tmp, "profile.json"),
                        device=dev).matmul_flops() == sustained
    specs = [transformer_layer_spec(cfg_kw["hidden_size"],
                                    cfg_kw["max_seq_len"], name=f"l{i}")
             for i in range(cfg_kw["num_layers"])]
    plan = dp_search(specs, cluster, global_batch=batch)
    assert plan.feasible and plan.pp == 1, plan.describe()
    cfg = GPTConfig(**cfg_kw, dtype=torch.bfloat16 if dev == "cuda"
                    else torch.float32, remat=plan.remat_policy)
    sync, alloc, reset, peak = dev_alloc(dev)
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    sync()
    a0 = alloc()
    reset()
    attn = flash_attn_fn(native_layout=True) if dev == "cuda" else None
    model = GPT(cfg, attn_fn=attn, generator=torch.Generator().manual_seed(0),
                device=dev)
    trainer = Trainer(model, AdamWOptimizer(3e-4),
                      lambda m, b, key: (m.loss(b, key=key), {}))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, cfg.max_seq_len))).to(dev)
    fl.reset_launch_count()
    losses, times = [], []
    for _ in range(steps):
        sync()
        t0 = time.monotonic()
        losses.append(float(trainer.step(ids)["loss"]))
        sync()
        times.append(time.monotonic() - t0)
    launches = (fl.fwd_launch_count(), fl.bwd_launch_count())
    measured_peak = peak() - a0
    assert all(math.isfinite(x) for x in losses), losses
    # where a step's time goes: one more step traced, outside the count
    logdir = os.path.join(tmp, "trace")
    with profiler.trace(logdir, device=dev):
        trainer.step(ids)
    per, totals = profiler.device_op_breakdown(logdir, steps=1, top=6)
    if dev == "cuda":
        assert launches == (steps * cfg.num_layers,) * 2, launches
    step_s = statistics.median(times)
    print(f"(a) profiler: sustained bf16 matmul {sustained / 1e12:.1f} "
          f"TFLOP/s ({sustained / H100_BF16:.1%} of the data sheet's "
          f"{H100_BF16 / 1e12:.0f}), calibrate {calib_s:.2f} s, HBM "
          f"{cluster.hbm_bytes:.0f} bytes; plan {plan.describe()}; "
          f"predicted step {plan.time * 1e3:.3f} ms and peak "
          f"{plan.peak_bytes:.0f} bytes vs measured median step "
          f"{step_s * 1e3:.3f} ms ({[round(t * 1e3, 2) for t in times]}) "
          f"and peak {measured_peak} bytes over the model; losses "
          f"{[round(x, 4) for x in losses]}; flash launches fwd "
          f"{launches[0]}, bwd {launches[1]}; {card}")
    print(f"(a) one traced step: device {totals['device_s'] * 1e3:.3f} ms "
          f"(copies {totals['copy_s'] * 1e3:.3f}) of the median "
          f"{step_s * 1e3:.3f}; largest: " + "; ".join(
              f"{name[:60]} {sec * 1e3:.3f} ms" for name, sec in per.items()))
    del trainer, model, ids
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"cluster": cluster, "sustained": sustained, "plan": plan,
            "step_ms": step_s * 1e3, "peak": measured_peak,
            "device_ms": totals["device_s"] * 1e3,
            "losses": losses, "launches": launches, "calib_s": calib_s}


def pb_warm(router):
    """Every prefill bucket of every replica run once outside the window
    (bench.py ``bench_plan``'s warm-up); returns the router."""
    for eng in router.engines:
        for bucket in eng.batcher.prompt_buckets:
            eng.submit(list(range(1, bucket + 1)), 2)
        eng.run_until_idle()
    return router


def pb_run(router, trace, pd, lh, dev):
    """bench.py ``bench_plan``'s drive on zero clocks, the launch counts
    set to 0 just before: decode tokens per router tick, wall tokens/s,
    each engine's launches."""
    for eng in router.engines:
        eng.launches = [0, 0]
    fleet_reset(pd, lh)
    fleet_sync(dev)
    t0 = time.perf_counter()
    handles = [router.submit(list(it.prompt), it.max_new_tokens)
               for it in trace]
    ticks = 0
    while not router.idle and ticks < 10**6:
        router.step()
        ticks += 1
    fleet_sync(dev)
    wall = time.perf_counter() - t0
    done = [h for h in handles if h.status == "completed"]
    tokens = sum(max(len(h.tokens) - 1, 0) for h in done)
    return {"tpt": tokens / max(ticks, 1), "tokens": tokens,
            "ticks": ticks, "tps": sum(len(h.tokens) for h in done) / wall,
            "handles": handles, "done": len(done),
            "engines": [list(e.launches) for e in router.engines],
            "counts": fleet_counts(pd, lh)}


def pb_fleet(pd, lh, card, dev, train, tmp, cfg_kw=None,
             n_requests=None):
    """(b) plan_deployment on the calibrated spec, build_fleet against
    the stock one-engine FleetRouter, the same seeded trace on both."""
    from hetu_tpu_torch import GPT, GPTConfig
    from hetu_tpu_torch.obs import calibration as _calibration
    from hetu_tpu_torch.plan import (DeploymentSpec, Plan, build_fleet,
                                     plan_deployment)
    from hetu_tpu_torch.serve import FleetRouter, generate_load
    cfg_kw = cfg_kw or PB_SERVE
    kind = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    cluster = train["cluster"]
    spec = DeploymentSpec(
        model_sig="gpt-bench", n_layers=cfg_kw["num_layers"],
        hidden_size=cfg_kw["hidden_size"], seq_len=cfg_kw["max_seq_len"],
        vocab_size=cfg_kw["vocab_size"], global_batch=8, n_devices=2,
        serve_devices=2, hbm_bytes=cluster.hbm_bytes,
        peak_flops=cluster.peak_flops, device_kind=kind,
        requests_per_s=4.0, prompt_p50=128, prompt_p99=1024, decode_len=48,
        slots_per_replica=8, page_size=64)
    store = _calibration.ProfileStore(clock=lambda: 0.0)
    cal = _calibration.fit_calibration(store, model_sig=spec.model_sig,
                                       device_kind=kind, defaults=True)
    plan = plan_deployment(spec, calibration=cal)
    assert plan.feasible and plan.replicas >= 1, plan.describe()
    path = plan.save(os.path.join(tmp, "plan.json"))
    back = Plan.load(path)
    assert back.to_json() == plan.to_json() and back.sha256 == plan.sha256
    seed, n = PB_TRACE
    trace = generate_load(seed, n_requests or n,
                          vocab=cfg_kw["vocab_size"], prompt_len=PB_PROMPT,
                          max_new=PB_NEW, mean_gap_s=0.0)
    cfg = GPTConfig(**cfg_kw, dtype=torch.bfloat16 if dev == "cuda"
                    else torch.float32)
    model = GPT(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    with counting_engines(pd, lh) as (built, Engine):
        planned = pb_warm(build_fleet(model, plan, clock=lambda: 0.0,
                                      queue_depth=len(trace) + 8,
                                      device=dev))
        stock = pb_warm(FleetRouter([Engine(
            model, clock=lambda: 0.0, queue_depth=len(trace) + 8,
            device=dev)]))
        p = pb_run(planned, trace, pd, lh, dev)
        d = pb_run(stock, trace, pd, lh, dev)
    top = max(stock.engines[0].batcher.prompt_buckets)
    over = [i for i, it in enumerate(trace) if len(it.prompt) > top]
    assert p["done"] == len(trace), "a planned request did not complete"
    # the stock engine's top prefill bucket refuses longer prompts, as
    # the JAX package's does: every other request completes
    for i, h in enumerate(d["handles"]):
        want = "rejected" if i in over else "completed"
        assert h.status == want, (i, h.status, h.error)
    if dev == "cuda":
        for arm, r in (("planned", p), ("stock", d)):
            assert all(a > 0 and b > 0 for a, b in r["engines"]), \
                f"a {arm} engine launched no paged decode / sampling"
            assert tuple(map(sum, zip(*r["engines"]))) == r["counts"]
    ratio = p["tpt"] / d["tpt"] if d["tpt"] > 0 else float("inf")
    print(f"(b) plan {plan.describe()} ladder {plan.bucket_ladder} pool "
          f"{plan.kv_pool_pages} pages of {plan.page_size}, sha256 "
          f"{plan.sha256}; predicted {dict(plan.predicted)}; the file "
          f"loads and re-signs identically")
    print(f"(b) planned {plan.replicas} replicas: {p['tpt']:.4f} decode "
          f"tokens/tick ({p['tokens']} tokens, {p['ticks']} ticks), "
          f"{p['tps']:.1f} tokens/s, {p['done']}/{len(trace)} completed; "
          f"stock: {d['tpt']:.4f} tokens/tick ({d['tokens']} tokens, "
          f"{d['ticks']} ticks), {d['tps']:.1f} tokens/s, "
          f"{d['done']}/{len(trace)} completed ({len(over)} prompts over "
          f"its top bucket {top} rejected); planned/stock {ratio:.4f} "
          f"tokens/tick; launches (paged decode, sampling) per engine "
          f"planned {p['engines']}, stock {d['engines']}; {card}")
    del model, planned, stock, built
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return {"plan": plan, "planned": {k: v for k, v in p.items()
                                      if k != "handles"},
            "stock": {k: v for k, v in d.items() if k != "handles"},
            "ratio": ratio, "over": len(over)}


EPISODE_KEYS = ("decisions", "lease_events", "world_by_tick", "statuses",
                "train_steps")


def pb_broker(pd, lh, card, dev, tmp, cfg_kw=None):
    """(c) bench.py ``bench_broker``'s three episodes on the card, the
    replicas serving (b)'s GPT, then the brokered one again on the CPU at
    the JAX package's default model: the same decision record."""
    from hetu_tpu_torch import GPTConfig
    from hetu_tpu_torch.broker import episode as ep
    from hetu_tpu_torch.broker import get_broker, install
    from hetu_tpu_torch.obs.server import serve
    cfg = GPTConfig(**(cfg_kw or PB_SERVE), dtype=torch.bfloat16
                    if dev == "cuda" else torch.float32)

    class Installed(ep.CapacityBroker):
        """The episode's broker, installed process-wide for ``/broker``."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            install(self)

    arms = {"brokered": dict(brokered=True),
            "split_a": dict(brokered=False, train_world=4,
                            serve_replicas=1),
            "split_b": dict(brokered=False, train_world=3,
                            serve_replicas=2)}
    out, engines, secs = {}, {}, {}
    orig = ep.CapacityBroker
    ep.CapacityBroker = Installed
    try:
        for name, kw in arms.items():
            with counting_engines(pd, lh) as (built, _):
                fleet_reset(pd, lh)
                t0 = time.monotonic()
                out[name] = ep.run_broker_episode(
                    os.path.join(tmp, name), seed=0, device=dev,
                    serve_config=cfg, **kw)
                fleet_sync(dev)
                secs[name] = time.monotonic() - t0
                engines[name] = ([list(e.launches) for e in built],
                                 fleet_counts(pd, lh))
            if name == "brokered":
                with serve() as srv:
                    view = http_json(srv.url + "/broker")
                assert view == json.loads(json.dumps(
                    out[name]["broker_summary"])), "/broker differs"
                install(None)
    finally:
        ep.CapacityBroker = orig
        install(None)
    assert get_broker() is None
    t0 = time.monotonic()
    cpu = ep.run_broker_episode(os.path.join(tmp, "cpu"), seed=0,
                                device="cpu")
    secs["cpu"] = time.monotonic() - t0
    br, a, b = out["brokered"], out["split_a"], out["split_b"]
    for key in EPISODE_KEYS:
        assert br[key] == cpu[key], f"the card's {key} differs from the CPU's"
    for name, r in out.items():
        assert sum(r["statuses"].values()) > 0 and r["train_steps"] > 0
        if dev == "cuda":
            per, total = engines[name]
            assert all(x > 0 and y > 0 for x, y in per), \
                f"a {name} replica launched no paged decode / sampling"
            assert tuple(map(sum, zip(*per))) == total
    kinds = [e["kind"] for e in br["lease_events"]]
    steps_margin = (br.goodput / b.goodput if b.goodput > 0
                    else float("inf"))
    viol_margin = (a.violations / br.violations if br.violations > 0
                   else float("inf"))
    dominance = min(steps_margin, viol_margin)
    print(f"(c) brokered: {kinds.count('lease_grant')} grants, "
          f"{kinds.count('lease_reclaim')} reclaims, chips lent at the end "
          f"{br['chips_lent']}, final world {br['final_world']}, "
          f"{br.goodput} train steps, {br.violations} violations, statuses "
          f"{br['statuses']}; split A {a.goodput} steps, {a.violations} "
          f"violations; split B {b.goodput} steps, {b.violations} "
          f"violations; joint dominance min({steps_margin:.4f}, "
          f"{viol_margin:.4f}) = {dominance:.4f}")
    print(f"(c) decisions, lease events, world by tick, statuses and train "
          f"steps equal the CPU episode's (the JAX package's default model,"
          f" {secs['cpu']:.2f} s); /broker over HTTP equals the summary "
          f"({len(view['leases'])} leases); launches (paged decode, "
          f"sampling) per replica: " + "; ".join(
              f"{n} {engines[n][0]}" for n in arms) + f"; seconds "
          f"{ {n: round(s, 2) for n, s in secs.items()} }; {card}")
    return {"dominance": dominance, "steps_margin": steps_margin,
            "viol_margin": viol_margin, "secs": secs,
            "engines": {n: engines[n][0] for n in arms},
            "arms": {n: (r.goodput, r.violations) for n, r in out.items()},
            "grants": kinds.count("lease_grant"),
            "reclaims": kinds.count("lease_reclaim")}


def broker_plan_phase(pd, lh, fl, card, dev="cuda", train_cfg=None,
                      serve_cfg=None, batch=PB_BATCH, n_requests=None):
    """Phase 19: (a) profile -> plan -> train, (b) plan -> fleet, (c) the
    broker's day.  Returns the readings and the seconds."""
    import tempfile
    t0 = time.monotonic()
    tmp = tempfile.mkdtemp(prefix="hetu_phase19_")
    try:
        out = {"train": pb_train(fl, card, dev, tmp, train_cfg, batch)}
        out["fleet"] = pb_fleet(pd, lh, card, dev, out["train"], tmp,
                                serve_cfg, n_requests)
        out["broker"] = pb_broker(pd, lh, card, dev, tmp, serve_cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, time.monotonic() - t0


# --------------------------------------------------------------- phase 20
# strategies: DataParallel, ZeRO and Megatron tensor parallelism through
# ``Trainer(strategy=)`` on a local mesh (every rank on the one card, each
# running the flash and CE kernels at its own shapes), the CE kernels on
# a vocabulary shard, data parallelism across two processes sharing the
# card over gloo, a one-rank NCCL world, and plan_to_strategy.

ST_ARMS = {"dp4": "DataParallel dp=4", "zero1": "ZeRO(1) dp=4",
           "zero3": "ZeRO(3) dp=4", "tp2dp2": "MegatronTP(tp=2, dp=2)",
           "tp4": "MegatronTP(tp=4)", "dp2": "DataParallel dp=2"}
ST_STEPS = 3
# The 3-step loss limit against the unsharded trainer, relative.  Step 0
# is held to 1e-5 (fp32 sums over 8192 tokens in another order); AdamW
# then normalizes each gradient, so a rounding difference moves a
# parameter by up to lr (3e-4) only where its gradient is near 0 and
# changes sign, which moves the loss of the next steps by far less than
# 1e-4 of it.  The control (two tp ranks' qkv and MLP-input shards
# swapped) must exceed it.
ST_TOL = 1e-4
ST_PROC_TOL = 1e-6     # two processes vs the local dp = 2 arm, relative


def st_strategy(arm, dev):
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    from hetu_tpu_torch.parallel.strategies import (DataParallel,
                                                    MegatronTP, ZeRO)

    def mesh(**sizes):
        return make_mesh(MeshSpec(**sizes), device=dev)

    return {"dp4": lambda: DataParallel(mesh=mesh(dp=4)),
            "zero1": lambda: ZeRO(1, mesh=mesh(dp=4)),
            "zero3": lambda: ZeRO(3, mesh=mesh(dp=4)),
            "tp2dp2": lambda: MegatronTP(2, dp=2, mesh=mesh(dp=2, tp=2)),
            "tp4": lambda: MegatronTP(4, mesh=mesh(tp=4)),
            "dp2": lambda: DataParallel(mesh=mesh(dp=2))}[arm]()


def st_model(cfg, dev):
    from hetu_tpu_torch import GPT, flash_attn_fn
    return GPT(cfg, attn_fn=flash_attn_fn(native_layout=True),
               generator=torch.Generator().manual_seed(0), device=dev)


def st_loss(m, batch, key):
    return m.loss(batch, key=key), {}


def st_full_grads(sh):
    """Every parameter's global gradient from the ranks' own: each dp
    group's tp pieces joined, then the mean over dp; under ZeRO stage 3
    a sharded parameter's slices (each already its part of the mean)
    joined over dp, then over tp."""
    from hetu_tpu_torch.parallel.spec import gather_param
    grads = [{n: p.grad for n, p in m.named_parameters()}
             for m in sh.models]

    def same_but_dp(c, d):
        return all(c[a] == d[a] for a in c if a != "dp")

    out = {}
    for name, pl in sh.place.items():
        if sh.stage >= 3 and pl.zdim is not None:
            lead = [i for i, c in enumerate(sh.coords) if c["dp"] == 0]
            joined = [torch.cat([grads[j][name] for j in sorted(
                (j for j, d in enumerate(sh.coords)
                 if same_but_dp(sh.coords[i], d)),
                key=lambda j: sh.coords[j]["dp"])], pl.zdim) for i in lead]
            out[name] = gather_param(joined, pl.shape, pl.tp_spec,
                                     [sh.coords[i] for i in lead],
                                     sh.mesh.shape, pl.blocks)
            continue
        total = None
        for d in range(sh.dp):
            idx = [i for i, c in enumerate(sh.coords) if c["dp"] == d]
            g = gather_param([grads[i][name] for i in idx], pl.shape,
                             pl.tp_spec, [sh.coords[i] for i in idx],
                             sh.mesh.shape, pl.blocks)
            total = g if total is None else total + g
        out[name] = total / sh.dp
    return out


def st_counts(fl, ce):
    return (fl.fwd_launch_count(), fl.bwd_launch_count(),
            ce.fwd_launch_count(), ce.bwd_launch_count())


def st_arm(arm, cfg, ids, ref, fl, ce, col, card, dev, swap_qkv=False):
    """One strategy arm: the step-0 loss and every gradient against the
    unsharded flash path, the step-0 gradients bitwise on a second run,
    then ``ST_STEPS`` AdamW ``Trainer`` steps with each step's kernel
    launches and collectives.  ``swap_qkv``: the control, two tp ranks'
    qkv and MLP-input shards swapped in every block before the steps."""
    from hetu_tpu_torch import AdamWOptimizer, Trainer
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    trainer = Trainer(st_model(cfg, dev), AdamWOptimizer(3e-4,
                                                         weight_decay=0.01),
                      st_loss, strategy=st_strategy(arm, dev))
    sh = trainer._sharded
    n = len(sh.held)
    row = {"ranks": n}
    if not swap_qkv:
        out = sh.forward_backward(st_loss, ids, None)
        loss = float(sh.mean_loss([o[0] for o in out]))
        full = st_full_grads(sh)
        lrel = abs(loss - ref["loss"]) / abs(ref["loss"])
        worst = max((((full[k] - g).abs().max()
                      / g.abs().max().clamp_min(1e-30)).item(), k)
                    for k, g in ref["grads"].items())
        del full
        first = [[p.grad.clone() for p in m.parameters()] for m in sh.models]
        out2 = sh.forward_backward(st_loss, ids, None)
        same = float(sh.mean_loss([o[0] for o in out2])) == loss and all(
            torch.equal(a, p.grad) for m, gs in zip(sh.models, first)
            for a, p in zip(gs, m.parameters()))
        del first, out, out2
        print(f"{ST_ARMS[arm]} step 0: loss {loss:.6f} vs unsharded "
              f"{ref['loss']:.6f}, relative {lrel:.3e} (tol 1e-5); worst "
              f"gradient {worst[1]}: {worst[0]:.3e} of its max (tol 1e-3: "
              f"fp32 sums in other orders); {n} ranks' gradients bitwise "
              f"equal on a second run: {same}; {card}")
        assert lrel <= 1e-5 and worst[0] <= 1e-3, (lrel, worst)
        assert same, f"{arm}: step-0 gradients not bitwise repeatable"
        row.update(step0_rel=lrel, grad_rel=worst[0])
    else:
        with torch.no_grad():
            for i, c in enumerate(sh.coords):
                j = next(k for k, d in enumerate(sh.coords)
                         if d["dp"] == c["dp"] and d["tp"] != c["tp"])
                if i < j:
                    for a, b in zip(sh.models[i].blocks, sh.models[j].blocks):
                        for pa, pb in ((a.attn.wqkv, b.attn.wqkv),
                                       (a.mlp.w_in, b.mlp.w_in)):
                            w = pa.detach().clone()
                            pa.copy_(pb)
                            pb.copy_(w)
    for m in sh.models:
        for p in m.parameters():
            p.grad = None
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sync()
    col.reset_counts()
    losses, times, per_step = [], [], []
    for _ in range(ST_STEPS):
        before = st_counts(fl, ce)
        sync()
        t0 = time.monotonic()
        losses.append(float(trainer.step(ids)["loss"]))
        sync()
        times.append(time.monotonic() - t0)
        per_step.append(tuple(a - b for a, b in
                              zip(st_counts(fl, ce), before)))
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    kinds = {k: (v["calls"] // ST_STEPS, v["bytes"] // ST_STEPS)
             for k, v in col.counts().items()}
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    label = ST_ARMS[arm] + (" control: qkv and w_in shards swapped" if swap_qkv
                            else "")
    print(f"{label}: losses {[round(x, 6) for x in losses]} vs unsharded "
          f"{[round(x, 6) for x in ref['losses']]}, largest relative gap "
          f"{gap:.3e} (tol {ST_TOL:g}); launches a step (flash fwd, bwd, "
          f"CE fwd, bwd) {per_step}; collectives a step (calls, bytes) "
          f"{kinds}; median step {med * 1e3:.3f} ms "
          f"({[round(t * 1e3, 3) for t in times]}), "
          f"{ids.numel() / med:.1f} tokens/s, peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB); {card}")
    row.update(losses=losses, gap=gap, per_step=per_step, kinds=kinds,
               step_ms=med * 1e3, peak=peak)
    del trainer, sh
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    return row


def st_reference(cfg, ids, dev, train_losses):
    """The unsharded flash path's step-0 loss and gradients on the same
    weights and batch, beside phase 5's first losses (the unsharded
    trainer's, same weights, batch and optimizer)."""
    model = st_model(cfg, dev)
    loss = model.loss(ids)
    loss.backward()
    ref = {"loss": float(loss), "losses": list(train_losses[:ST_STEPS]),
           "grads": {n: p.grad for n, p in model.named_parameters()}}
    del model
    return ref


def st_shard_ce(ce, flush, gen, card, N=4092, E=768, V=50257, tp=2):
    """(b) The CE kernels on tp = 2's first vocabulary shard (rows of the
    tp = 2, dp = 2 rank), labels over the whole vocabulary so about half
    fall outside (-1 locally), against the plain versions; the backward
    with the global lse.  Times beside the bound."""
    vr = -(-V // tp)
    h = torch.randn((N, E), generator=gen).cuda()
    w = (torch.randn((V, E), generator=gen) * 0.02).cuda()
    y = torch.randint(0, V, (N,), generator=gen).cuda()
    inside = y < vr
    local = torch.where(inside, y, -1).to(torch.int32)
    shard = w[:vr].contiguous()
    lse_r, ylog_r = ce.lm_head_ce_fwd(h, shard, local)
    plse, pylog = ce.lm_head_ce_fwd_plain(h, shard, local)
    other = torch.where(~inside, y - vr, -1).to(torch.int32)
    lse_o, _ = ce.lm_head_ce_fwd(h, w[vr:].contiguous(), other)
    lse = torch.logsumexp(torch.stack([lse_r, lse_o]), 0)
    dn = torch.randn(N, generator=gen).cuda() / N
    grads = ce.lm_head_ce_bwd(h, shard, local, lse, dn)
    pgrads = ce.lm_head_ce_bwd_plain(h, shard, local, lse, dn)
    torch.cuda.synchronize()
    share = float(inside.float().mean())
    zero_out = bool((ylog_r[~inside] == 0).all())
    errs = {"lse": rel_err(lse_r, plse),
            "ylog": rel_err(ylog_r[inside], pylog[inside]),
            "dh": rel_err(grads[0], pgrads[0]),
            "dW": rel_err(grads[1], pgrads[1])}
    print(f"(b) CE on the tp=2 vocabulary shard (N={N}, E={E}, V_r={vr}, "
          f"{share:.1%} of labels inside): relative errors "
          + " ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol lse/ylog 1e-5, grads {CE_TOL:g}); out-of-shard label "
          f"logits all 0: {zero_out}; {card}")
    assert 0.4 < share < 0.6 and zero_out
    assert errs["lse"] <= 1e-5 and errs["ylog"] <= 1e-5, errs
    assert errs["dh"] <= CE_TOL and errs["dW"] <= CE_TOL, errs
    ops = 2 * N * E * vr
    f_ms, f_by = bound((N + vr) * E * 4 + 3 * N * 4, ops, torch.float32)
    b_ms, b_by = bound(2 * (N + vr) * E * 4 + 3 * N * 4, 3 * ops,
                       torch.float32)
    ms = time_ms(lambda: ce.lm_head_ce_fwd(h, shard, local), flush, reps=10)
    plain_ms = time_ms(lambda: ce.lm_head_ce_fwd_plain(h, shard, local),
                       flush, reps=10)
    lib_ms = time_ms(lambda: torch.logsumexp(h @ shard.T, 1), flush,
                     reps=10)
    bms = time_ms(lambda: ce.lm_head_ce_bwd(h, shard, local, lse, dn), flush,
                  reps=10)
    bplain_ms = time_ms(lambda: ce.lm_head_ce_bwd_plain(h, shard, local, lse,
                                                        dn), flush, reps=10)
    hg, wg = h.clone().requires_grad_(), shard.clone().requires_grad_()

    def lib_fwd_bwd():
        torch.logsumexp(hg @ wg.T, 1).backward(dn)

    lib_fb_ms = time_ms(lib_fwd_bwd, flush, reps=10)
    print(f"(b) forward kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
          f"library_ms {lib_ms:.4f} (logsumexp(h @ W_r.T)) bound_ms "
          f"{f_ms:.4f} ({f_by}); backward kernel_ms {bms:.4f} plain_ms "
          f"{bplain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}), library "
          f"forward+backward {lib_fb_ms:.4f} ms; {card}")
    fwd = {"max_abs_err": max((lse_r - plse).abs().max().item(),
                              (ylog_r - pylog).abs().max().item()),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": f_ms,
           "bound_by": f_by, "library_ms": lib_ms}
    bwd = {"max_abs_err": max((a - c).abs().max().item()
                              for a, c in zip(grads[:2], pgrads[:2])),
           "ms": bms, "plain_ms": bplain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_fb_ms,
           "library_call": "logsumexp(h @ W_r.T) forward+backward"}
    return fwd, bwd


def st_worker(rank, nproc, coord, dev, cfg_kw):
    """(c) one process of the two: joins a gloo world, keeps its tensors
    on ``dev`` (the shared card), trains ``DataParallel`` over the process
    mesh on the global batch (its half), prints one ``STRATEGY`` JSON
    line."""
    import datetime
    import tempfile

    import torch.distributed as dist
    from hetu_tpu_torch import AdamWOptimizer, Trainer
    from hetu_tpu_torch.models.gpt import GPTConfig
    from hetu_tpu_torch.parallel import MeshSpec, collectives as col
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.autoparallel import CostProfiler
    from hetu_tpu_torch.parallel.strategies import DataParallel
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=nproc, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    cfg = GPTConfig(**cfg_kw)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    mesh = make_mesh(MeshSpec(dp=nproc), device=dev, processes=True)
    trainer = Trainer(st_model(cfg, dev),
                      AdamWOptimizer(3e-4, weight_decay=0.01), st_loss,
                      strategy=DataParallel(mesh=mesh))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (ST_BATCH, cfg.max_seq_len))).to(dev)
    losses, times = [], []
    col.reset_counts()
    with col.timed():
        for _ in range(ST_STEPS):
            sync()
            t0 = time.monotonic()
            losses.append(float(trainer.step(ids)["loss"]))
            sync()
            times.append(time.monotonic() - t0)
    ar = col.counts()["all_reduce"]
    with tempfile.TemporaryDirectory() as tmp:
        bw = CostProfiler(cache_path=os.path.join(tmp, "p.json"),
                          device=dev).collective_bandwidth(
            mesh, "dp", nbytes=64 << 20)
    print("STRATEGY " + json.dumps({
        "rank": rank, "losses": losses, "step_ms": [t * 1e3 for t in times],
        "allreduce_calls": ar["calls"] // ST_STEPS,
        "allreduce_bytes": ar["bytes"] // ST_STEPS,
        "allreduce_ms": ar["s"] * 1e3 / ST_STEPS, "bandwidth": bw}),
        flush=True)
    dist.destroy_process_group()
    return 0


def st_nccl_world(port):
    """(c) a one-process NCCL world through ``launch.initialize()``: each
    collective once over its one-rank group (and the autograd pair), each
    equal to its input; prints one ``NCCL`` JSON line."""
    import torch.distributed as dist
    from hetu_tpu_torch import launch
    from hetu_tpu_torch.parallel import MeshSpec, collectives as col
    from hetu_tpu_torch.parallel import make_mesh
    launch.initialize(f"127.0.0.1:{port}", 1, 0, timeout_s=120)
    mesh = make_mesh(MeshSpec(), processes=True)
    x = torch.arange(24, dtype=torch.float32, device=mesh.device).reshape(
        4, 6)
    both = ("dp", "tp")
    cases = {
        "all_reduce": (col.all_reduce([x], "dp", mesh=mesh), x),
        "all_reduce_mean": (col.all_reduce_mean([x], "dp", mesh=mesh), x),
        "reduce_scatter": (col.reduce_scatter([x], "dp", mesh=mesh), x),
        "all_gather": (col.all_gather([x], "dp", gather_dim=1, mesh=mesh), x),
        "all_gather_stacked": (col.all_gather([x], both, tiled=False,
                                              mesh=mesh), x[None]),
        "all_to_all": (col.all_to_all([x], "dp", split_dim=0, concat_dim=1,
                                      mesh=mesh), x),
        "hierarchical_all_to_all": (col.hierarchical_all_to_all(
            [x], "dp", "tp", split_dim=0, concat_dim=1, mesh=mesh), x),
        "broadcast": (col.broadcast([x], "dp", root=0, mesh=mesh), x),
        "ppermute": (col.ppermute([x], [(0, 0)], "dp", mesh=mesh), x),
        "send_next": (col.send_next([x], "dp", mesh=mesh), x),
        "recv_prev": (col.recv_prev([x], both, mesh=mesh), x),
    }
    xg = x.clone().requires_grad_()
    y = col.all_reduce(col.copy_to_group([xg], "dp", mesh=mesh), "dp",
                       mesh=mesh)
    z = col.gather_from_group(y, "dp", dim=1, mesh=mesh)[0]
    (z * z).sum().backward()
    cases["autograd pair"] = ([xg.grad], 2 * x)
    torch.cuda.synchronize()
    ok = {k: bool(torch.equal(got[0], want)) for k, (got, want)
          in cases.items()}
    print("NCCL " + json.dumps({"backend": dist.get_backend(), "ok": ok,
                                "calls": {k: v["calls"] for k, v in
                                          col.counts().items()}}),
          flush=True)
    dist.destroy_process_group()
    return 0 if all(ok.values()) else 1


def st_nccl_pair(rank, port):
    """(c) two NCCL ranks on the one card (each ``process_id %
    device_count`` is card 0): what NCCL says to its first all-reduce."""
    import torch.distributed as dist
    from hetu_tpu_torch import launch
    try:
        launch.initialize(f"127.0.0.1:{port}", 2, rank, timeout_s=60)
        x = torch.ones(4, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        said = f"ran: {x.tolist()}"
    except Exception as e:   # noqa: BLE001 - the observation is the error
        said = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    print("PAIR " + json.dumps({"rank": rank, "said": said}), flush=True)
    return 0


def st_free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def st_spawn(args, n, timeout, env_of=None):
    """``n`` processes of this script with ``args`` (new processes, not
    forks), the launcher's environment variables set; their stdout."""
    from hetu_tpu_torch import launch
    port = st_free_port()
    cfg = launch.DistConfig(hosts=[launch.HostSpec("127.0.0.1", workers=n,
                                                   chief=True)], port=port)
    procs = []
    for r in range(n):
        env = {**os.environ, **launch.worker_env(cfg, r)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *args(r, port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs, rcs = [], []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline -
                                               time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
        rcs.append(p.returncode)
    return outs, rcs


def st_lines(outs, tag):
    return [json.loads(line[len(tag) + 1:]) for out in outs
            for line in out.splitlines() if line.startswith(tag + " ")]


def st_processes(card, local_dp2, cfg_kw, dev="cuda"):
    """(c) DataParallel across two real processes on the one card over
    gloo, against the local dp = 2 arm; then the one-rank NCCL world and
    two NCCL ranks on the one card."""
    t0 = time.monotonic()
    outs, rcs = st_spawn(
        lambda r, port: ["--strategy-worker", str(r), "2",
                         f"127.0.0.1:{port}", dev, json.dumps(cfg_kw)],
        2, 600)
    rows = sorted(st_lines(outs, "STRATEGY"), key=lambda r: r["rank"])
    assert rcs == [0, 0] and len(rows) == 2, (rcs, [o[-3000:] for o in outs])
    a, b = rows
    gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], local_dp2))
    print(f"(c) two processes, gloo, tensors on the one card: losses "
          f"{a['losses']} and {b['losses']}, bitwise equal: "
          f"{a['losses'] == b['losses']}; against the local dp=2 arm "
          f"{[round(x, 7) for x in local_dp2]}: largest relative gap "
          f"{gap:.3e} (tol {ST_PROC_TOL:g}); step ms "
          f"{[round(t, 1) for t in a['step_ms']]}; the gradient "
          f"all-reduce a step: {a['allreduce_calls']} calls, "
          f"{a['allreduce_bytes']} bytes, {a['allreduce_ms']:.1f} ms "
          f"(through host memory); collective_bandwidth over this world "
          f"{a['bandwidth'] / 1e9:.3f} / {b['bandwidth'] / 1e9:.3f} GB/s "
          f"(gloo through host memory on one card, not a link); "
          f"{time.monotonic() - t0:.1f} s; {card}")
    assert a["losses"] == b["losses"], "the two processes disagree"
    assert gap <= ST_PROC_TOL, gap
    assert a["losses"][-1] < a["losses"][0]
    if dev != "cuda":
        return {"proc": a}
    outs, rcs = st_spawn(lambda r, port: ["--nccl-world", str(port)], 1, 180)
    rows = st_lines(outs, "NCCL")
    assert rcs == [0] and rows, (rcs, outs[0][-3000:])
    print(f"(c) one-rank NCCL world through launch.initialize(): backend "
          f"{rows[0]['backend']}, each collective equal to its input: "
          f"{rows[0]['ok']}; calls {rows[0]['calls']}; {card}")
    outs, rcs = st_spawn(lambda r, port: ["--nccl-pair", str(r), str(port)],
                         2, 90)
    said = [r["said"] for r in sorted(st_lines(outs, "PAIR"),
                                      key=lambda r: r["rank"])]
    print(f"(c) info: two NCCL ranks on the one card: {said or 'no answer'}"
          f" (exit codes {rcs}); {card}")
    return {"proc": a, "nccl": rows[0], "pair": said}


def st_plan(fl, ce, card, cluster, dev="cuda", cfg_kw=None, batch=None,
            steps=2):
    """(d) ``dp_search`` for bench.py config 4's shape over four of this
    card (phase 19's calibration, ``n_devices=4``; the link bandwidth the
    data sheet's), the plan materialized by ``plan_to_strategy`` on a
    local mesh, ``steps`` AdamW steps through the flash and CE
    kernels."""
    from hetu_tpu_torch import AdamWOptimizer, GPT, GPTConfig, Trainer
    from hetu_tpu_torch import flash_attn_fn
    from hetu_tpu_torch.parallel import make_mesh
    from hetu_tpu_torch.parallel.autoparallel import (
        dp_search, plan_to_strategy, transformer_layer_spec)
    from hetu_tpu_torch.parallel.strategies import ShardingStrategy
    cfg_kw = cfg_kw or PB_TRAIN
    batch = batch or PB_BATCH
    four = dataclasses.replace(cluster, n_devices=4)
    specs = [transformer_layer_spec(cfg_kw["hidden_size"],
                                    cfg_kw["max_seq_len"], name=f"l{i}")
             for i in range(cfg_kw["num_layers"])]
    plan = dp_search(specs, four, global_batch=batch)
    assert plan.feasible and plan.pp == 1, plan.describe()
    spec, kw = plan_to_strategy(plan)
    cfg = GPTConfig(**cfg_kw, dtype=torch.bfloat16 if dev == "cuda"
                    else torch.float32, remat=plan.remat_policy,
                    streamed_head_chunk=1024)
    model = GPT(cfg, attn_fn=flash_attn_fn(native_layout=True),
                generator=torch.Generator().manual_seed(0), device=dev)
    trainer = Trainer(model, AdamWOptimizer(3e-4), st_loss,
                      strategy=ShardingStrategy(
                          mesh=make_mesh(spec, device=dev), **kw))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, cfg.max_seq_len))).to(dev)
    fl.reset_launch_count()
    ce.reset_launch_count()
    losses = [float(trainer.step(ids)["loss"]) for _ in range(steps)]
    launches = st_counts(fl, ce)
    print(f"(d) plan over 4 x {card}: {plan.describe()} -> {spec}, "
          f"zero_stage {kw['zero_stage']}; {steps} steps on a local mesh: "
          f"losses {[round(x, 4) for x in losses]}; launches (flash fwd, "
          f"bwd, CE fwd, bwd) {launches}")
    assert all(math.isfinite(x) for x in losses), losses
    if dev == "cuda":
        ranks = spec.total()
        fwd = steps * ranks * cfg.num_layers
        assert launches[0] >= fwd and launches[2] == steps * ranks, launches
    del trainer, model
    gc.collect()
    return {"plan": plan.describe(), "spec": spec, "losses": losses,
            "launches": launches}


ST_BATCH = 8


def strategy_phase(fl, ce, gpt_mod, card, train_losses, cluster,
                   dev="cuda", cfg=None, plan_kw=None, plan_batch=None):
    """Phase 20: (a) the five strategy arms (and the local dp = 2 arm
    that (c) is held against) at phase 5's settings, with the control;
    (b) the CE kernels on a vocabulary shard; (c) two processes over
    gloo, the one-rank NCCL world; (d) plan_to_strategy.  Returns the
    rows the summary needs."""
    from hetu_tpu_torch.parallel import collectives as col
    t_start = time.monotonic()
    cfg = cfg or gpt_mod.gpt2_small(streamed_head_chunk=1024)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (ST_BATCH, cfg.max_seq_len))).to(dev)
    ref = st_reference(cfg, ids, dev, train_losses)
    rows = {}
    fl.reset_launch_count()
    ce.reset_launch_count()
    for arm in ("dp4", "zero1", "zero3", "tp2dp2", "tp4"):
        rows[arm] = st_arm(arm, cfg, ids, ref, fl, ce, col, card, dev)
    launches = dict(zip(("flash_fwd", "flash_bwd", "lm_head_ce_fwd",
                         "lm_head_ce_bwd"), st_counts(fl, ce)))
    for arm, r in rows.items():
        assert r["gap"] <= ST_TOL, (arm, r["gap"])
        assert r["losses"][-1] < r["losses"][0], (arm, r["losses"])
        if dev == "cuda":
            want = (4 * cfg.num_layers,) * 2 + (4, 4)
            assert all(s == want for s in r["per_step"]), (arm, r["per_step"])
    ctrl = st_arm("tp2dp2", cfg, ids, ref, fl, ce, col, card, dev,
                  swap_qkv=True)
    print(f"(a) control: qkv and w_in shards swapped between tp ranks: "
          f"relative gap {ctrl['gap']:.3e} (must exceed tol {ST_TOL:g}); "
          f"{card}")
    assert ctrl["gap"] > ST_TOL, "the 3-step check cannot tell swapped shards"
    rows["dp2"] = st_arm("dp2", cfg, ids, ref, fl, ce, col, card, dev)
    del ref
    gc.collect()
    out = {"arms": rows, "launches": launches}
    if dev == "cuda":
        gen = torch.Generator().manual_seed(20)
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        out["ce"] = st_shard_ce(ce, flush, gen, card)
        out["flash"] = check_flash(fl, flush, torch.float32, 1024, gen,
                                   timed=True, B=8, H=3)
        del flush
        torch.cuda.empty_cache()
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("dtype", "remat")}
    out["proc"] = st_processes(card, rows["dp2"]["losses"], cfg_kw, dev)
    out["plan"] = st_plan(fl, ce, card, cluster, dev, cfg_kw=plan_kw,
                          batch=plan_batch)
    return out, time.monotonic() - t_start


# --------------------------------------------------------------- phase 21
# pipelines: GPT-2 small composed as __graft_entry__.py's config A composes
# its LM (an embedding, ``Pipelined`` blocks, a final LN, the head tied to
# the embedding) through GPipe on a local mesh, config A's dp x tp x pp
# composition, synchronous and interleaved 1F1B, asynchronous PipeDream
# with HetPipe's dp mean, heterogeneous dp degrees, and GPipe across two
# processes sharing the card over gloo.

PP_STEPS = 3
PP_BATCH = 8
PP_TOL = 1e-5          # step-0 loss, relative
PP_GRAD_TOL = 1e-3     # step-0 gradients, of each one's max (other sums)
PP_PROC_TOL = 1e-6     # two processes vs the local pp = 2 arm, relative
PP_LR = 3e-4


def pp_model(cfg, dev, mesh, n_microbatches, remat="none"):
    """Config A's LM at ``cfg``'s widths: the embedding, ``Pipelined``
    blocks with flash, the final LN and the head tied to the embedding,
    streamed through the CE kernels (a rank holding a vocabulary shard
    streams its shard).  Weights from a seeded generator, the same for
    every mesh."""
    from hetu_tpu_torch import flash_attn_fn
    from hetu_tpu_torch.init import normal
    from hetu_tpu_torch.layers import Embedding, LayerNorm, TransformerBlock
    from hetu_tpu_torch.ops.losses import (lm_head_cross_entropy,
                                           vocab_parallel_cross_entropy)
    from hetu_tpu_torch.parallel import Pipelined

    class PipeLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(0)
            self.embed = Embedding(cfg.vocab_size, cfg.hidden_size,
                                   initializer=normal(stddev=0.02),
                                   generator=g, device=dev)
            self.blocks = Pipelined(
                [TransformerBlock(cfg.hidden_size, cfg.num_heads, 4,
                                  causal=True,
                                  attn_fn=flash_attn_fn(native_layout=True),
                                  generator=g, device=dev)
                 for _ in range(cfg.num_layers)],
                n_microbatches=n_microbatches, mesh=mesh, remat=remat)
            self.ln = LayerNorm(cfg.hidden_size, device=dev)

        def head_loss(self, h, ids):
            b, s = ids.shape
            x = self.ln(h)[:, :-1].reshape(b * (s - 1), -1)
            labels = ids[:, 1:].reshape(-1)
            chunk = cfg.streamed_head_chunk
            if self.embed._tp is not None:
                return vocab_parallel_cross_entropy(
                    x, self.embed.weight, labels, self.embed.vocab_start,
                    self.embed._tp, chunk=chunk).mean()
            return lm_head_cross_entropy(x, self.embed.weight, labels,
                                         chunk=chunk).mean()

        def loss(self, ids, key=None, training=False):
            return self.head_loss(self.blocks(self.embed(ids), key=key,
                                              training=training), ids)

    return PipeLM()


def pp_loss(m, batch, key):
    return m.loss(batch), {}


def pp_trainer(cfg, dev, mesh, M, remat="none", zero=0):
    from hetu_tpu_torch import AdamWOptimizer, Trainer
    from hetu_tpu_torch.parallel.spec import MEGATRON_RULES
    from hetu_tpu_torch.parallel.strategies import ShardingStrategy
    model = pp_model(cfg, dev, mesh, M, remat)
    strat = None if mesh is None else ShardingStrategy(
        mesh=mesh, rules=MEGATRON_RULES, zero_stage=zero)
    return Trainer(model, AdamWOptimizer(PP_LR, weight_decay=0.01), pp_loss,
                   strategy=strat)


def pp_full_grads(sh):
    """Every parameter's gradient from the ranks' reduced ones (the pp
    sum of the replicated parameters, the dp mean): a holding rank's, its
    tp pieces joined."""
    from hetu_tpu_torch.parallel.spec import gather_param
    grads = sh.reduce_grads()
    out = {}
    for name, pl in sh.place.items():
        idx = [i for i, c in enumerate(sh.coords)
               if c["dp"] == 0 and name in grads[i]]
        out[name] = gather_param([grads[i][name] for i in idx], pl.shape,
                                 pl.tp_spec, [sh.coords[i] for i in idx],
                                 sh.mesh.shape, pl.blocks)
    return out


def pp_worst(grads, ref, names=None):
    """The largest gradient error, of each gradient's own max."""
    return max((((grads[k] - g).abs().max()
                 / g.abs().max().clamp_min(1e-30)).item(), k)
               for k, g in ref.items() if names is None or k in names)


def pp_reference(cfg, ids, dev):
    """The unsharded model (``mesh=None``): its step-0 loss and
    gradients, then ``PP_STEPS`` AdamW steps' losses and median step."""
    tr = pp_trainer(cfg, dev, None, 1)
    loss = tr.model.loss(ids)
    loss.backward()
    ref = {"loss": float(loss.detach()), "grads": {n: p.grad.clone() for n, p in
                                          tr.model.named_parameters()}}
    for p in tr.model.parameters():
        p.grad = None
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    losses, times = [], []
    for _ in range(PP_STEPS):
        sync()
        t0 = time.monotonic()
        losses.append(float(tr.step(ids)["loss"]))
        sync()
        times.append(time.monotonic() - t0)
    ref.update(losses=losses, step_ms=statistics.median(times) * 1e3)
    del tr
    gc.collect()
    return ref


def pp_steps(trainer, ids, fl, ce, dev):
    """``PP_STEPS`` steps: losses, step times, launches a step, the
    collectives a step, the peak."""
    from hetu_tpu_torch.parallel import collectives as col
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    col.reset_counts()
    losses, times, per_step = [], [], []
    for _ in range(PP_STEPS):
        before = st_counts(fl, ce)
        sync()
        t0 = time.monotonic()
        losses.append(float(trainer.step(ids)["loss"]))
        sync()
        times.append(time.monotonic() - t0)
        per_step.append(tuple(a - b for a, b in
                              zip(st_counts(fl, ce), before)))
    kinds = {k: (v["calls"] // PP_STEPS, v["bytes"] // PP_STEPS)
             for k, v in col.counts().items()}
    med = statistics.median(times)
    return {"losses": losses, "step_ms": med * 1e3,
            "times": [t * 1e3 for t in times], "per_step": per_step,
            "kinds": kinds, "tokens_s": ids.numel() / med,
            "peak": (torch.cuda.max_memory_allocated() if dev == "cuda"
                     else 0)}


def pp_gpipe(cfg, ids, ref, fl, ce, card, dev, remat, control=False):
    """(a) GPipe on a local pp = 4 mesh, M = 8: the step-0 loss and every
    gradient against the unsharded model, ``PP_STEPS`` steps against its
    losses, each step's launches; ``control``: two stages' blocks swapped
    (weights exchanged between rank 0's first block and rank 1's last)
    must leave the gradient limit."""
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    mesh = make_mesh(MeshSpec(pp=4), device=dev)
    tr = pp_trainer(cfg, dev, mesh, 8, remat)
    sh = tr._sharded
    out = sh.forward_backward(pp_loss, ids, None)
    loss = float(sh.mean_loss([o[0] for o in out]))
    full = pp_full_grads(sh)
    lrel = abs(loss - ref["loss"]) / abs(ref["loss"])
    worst = pp_worst(full, ref["grads"])
    del full, out
    row = {"step0_rel": lrel, "grad_rel": worst[0]}
    print(f"(a) GPipe pp=4 M=8 remat={remat!r} step 0: loss {loss:.6f} vs "
          f"unsharded {ref['loss']:.6f}, relative {lrel:.3e} (tol "
          f"{PP_TOL:g}); worst gradient {worst[1]}: {worst[0]:.3e} of its "
          f"max (tol {PP_GRAD_TOL:g}); {card}")
    assert lrel <= PP_TOL and worst[0] <= PP_GRAD_TOL, (lrel, worst)
    if control:
        L = cfg.num_layers // 4
        a, b = sh.models[0].blocks.stacked[0], sh.models[1].blocks.stacked[
            2 * L - 1]
        with torch.no_grad():
            for pa, pb in zip(a.parameters(), b.parameters()):
                w = pa.detach().clone()
                pa.copy_(pb)
                pb.copy_(w)
        sh.forward_backward(pp_loss, ids, None)
        cworst = pp_worst(pp_full_grads(sh), ref["grads"])
        with torch.no_grad():
            for pa, pb in zip(a.parameters(), b.parameters()):
                w = pa.detach().clone()
                pa.copy_(pb)
                pb.copy_(w)
        print(f"(a) control: stage 0's first block and stage 1's last "
              f"swapped: worst gradient {cworst[1]} {cworst[0]:.3e} of its "
              f"max (must exceed tol {PP_GRAD_TOL:g}); {card}")
        assert cworst[0] > PP_GRAD_TOL, "the check cannot tell swapped stages"
        row["control"] = cworst[0]
    for m in sh.models:
        for p in m.parameters():
            p.grad = None
    gc.collect()
    row.update(pp_steps(tr, ids, fl, ce, dev))
    gap = max(abs(x - y) / abs(y) for x, y in zip(row["losses"],
                                                    ref["losses"]))
    row["gap"] = gap
    print(f"(a) remat={remat!r}: losses {[round(x, 6) for x in row['losses']]}"
          f" vs unsharded {[round(x, 6) for x in ref['losses']]}, largest "
          f"relative gap {gap:.3e} (tol {ST_TOL:g}); launches a step (flash "
          f"fwd, bwd, CE fwd, bwd) {row['per_step']}; collectives a step "
          f"(calls, bytes) {row['kinds']}; median step {row['step_ms']:.3f} ms"
          f" ({[round(t, 1) for t in row['times']]}; unsharded "
          f"{ref['step_ms']:.3f} ms), {row['tokens_s']:.1f} tokens/s, peak "
          f"{row['peak']} bytes ({row['peak'] / 2**30:.3f} GiB); the four "
          f"ranks run in turn on the one card, not a multi-card step; "
          f"{card}")
    assert gap <= ST_TOL, gap
    del tr, sh
    gc.collect()
    return row


def pp_config_a(cfg, ids, ref, fl, ce, card, dev):
    """(b) config A's composition: dp = 2, tp = 2, pp = 2, Megatron rules,
    ZeRO-1, M = 4 microbatches of a rank's 4 rows, ``PP_STEPS`` steps
    against the unsharded ones; each rank's parameter and slot bytes."""
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    mesh = make_mesh(MeshSpec(dp=2, tp=2, pp=2), device=dev)
    tr = pp_trainer(cfg, dev, mesh, 4, "none", zero=1)
    sh = tr._sharded
    pbytes = [sum(p.numel() * p.element_size() for p in m.parameters())
              for m in sh.models]
    sbytes = [sum(t.numel() * t.element_size() for k, v in st.items()
                  if k != "step" for t in v.values())
              for st in sh.opt_states]
    zeroed = sorted(n for n, pl in sh.place.items() if pl.zdim is not None)
    print(f"(b) dp=2 tp=2 pp=2 ZeRO-1: {len(sh.models)} ranks; parameter "
          f"bytes by rank {pbytes}; AdamW slot bytes by rank {sbytes}; "
          f"ZeRO-sharded slots {zeroed} (a stacked block's dimension 0 is "
          f"its layers: none of the blocks'); {card}")
    assert not any(n in sh.stacked for n in zeroed)
    row = pp_steps(tr, ids, fl, ce, dev)
    gap = max(abs(x - y) / abs(y) for x, y in zip(row["losses"],
                                                    ref["losses"]))
    row.update(gap=gap, param_bytes=pbytes, slot_bytes=sbytes)
    print(f"(b) losses {[round(x, 6) for x in row['losses']]} vs unsharded "
          f"{[round(x, 6) for x in ref['losses']]}, largest relative gap "
          f"{gap:.3e} (tol {ST_TOL:g}); launches a step (flash fwd, bwd, CE "
          f"fwd, bwd) {row['per_step']}; collectives a step (calls, bytes) "
          f"{row['kinds']}; median step {row['step_ms']:.3f} ms, "
          f"{row['tokens_s']:.1f} tokens/s, peak {row['peak']} bytes; the "
          f"eight ranks run in turn on the one card; {card}")
    assert gap <= ST_TOL, gap
    del tr, sh
    gc.collect()
    return row


def pp_blocks(cfg, dev):
    """The unsharded model's blocks, embedding output and head loss: the
    1F1B and heterogeneous arms' stages and ``loss_fn``."""
    model = pp_model(cfg, dev, None, 1)
    for p in model.parameters():
        p.requires_grad_(False)
    for p in model.blocks.parameters():
        p.requires_grad_(True)
    return model, list(model.blocks.stacked)


def pp_pipedream(cfg, ids, ref, fl, ce, card, dev):
    """(c) synchronous 1F1B over the 12 blocks, S = 4, M = 8, V = 3 through
    ``interleave_stages``: the blocks' gradients against the unsharded
    model's; (d) asynchronous PipeDream: lr 0 bitwise, S = 1 against a
    sequential per-microbatch loop, two HetPipe steps at pp = 4 x dp =
    2."""
    from hetu_tpu_torch.optim import SGDOptimizer
    from hetu_tpu_torch.parallel import (MeshSpec, interleave_stages,
                                         make_mesh, pipedream_grads,
                                         pipedream_schedule_stats,
                                         pipedream_train_step,
                                         uninterleave_stages)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    model, blocks = pp_blocks(cfg, dev)
    with torch.no_grad():
        x = model.embed(ids)
    stage1 = lambda blk, h, ex: blk(h)  # noqa: E731

    def stage_n(stage, h, ex):
        for blk in stage:
            h = blk(h)
        return h

    S, V, M = 4, 3, 8
    out = {"stats": {v: pipedream_schedule_stats(S, v, M) for v in (1, V)}}
    for v, st in out["stats"].items():
        print(f"(c) pipedream_schedule_stats(S={S}, V={v}, M={M}): {st}")
    before = st_counts(fl, ce)
    sync()
    t0 = time.monotonic()
    loss, g = pipedream_grads(stage1, model.head_loss,
                              interleave_stages(blocks, S, V), x, ids,
                              mesh=make_mesh(MeshSpec(pp=S), device=dev),
                              n_microbatches=M, virtual_stages=V)
    sync()
    sync_ms = (time.monotonic() - t0) * 1e3
    g = uninterleave_stages(g, S, V)
    launches = tuple(a - b for a, b in zip(st_counts(fl, ce), before))
    got = {f"blocks.stacked.{li}.{n}": t for li, gd in enumerate(g)
           for n, t in gd.items()}
    worst = pp_worst(got, ref["grads"], names=set(got))
    lrel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    print(f"(c) synchronous 1F1B S={S} V={V} M={M}: loss {float(loss):.6f} "
          f"(relative {lrel:.3e} to the unsharded step 0, tol {PP_TOL:g}); "
          f"worst block gradient {worst[1]}: {worst[0]:.3e} of its max (tol "
          f"{PP_GRAD_TOL:g}); launches (flash fwd, bwd, CE fwd, bwd) "
          f"{launches}; {sync_ms:.1f} ms, the stages in turn on the one "
          f"card; {card}")
    assert lrel <= PP_TOL and worst[0] <= PP_GRAD_TOL, (lrel, worst)
    out["sync"] = {"loss": float(loss), "grad_rel": worst[0],
                   "launches": launches, "ms": sync_ms}
    del g, got
    # (d) asynchronous: lr 0 keeps every weight bitwise
    stages = [torch.nn.ModuleList(blocks[s * 3:(s + 1) * 3]) for s in range(S)]
    snap = [p.detach().clone() for p in model.blocks.parameters()]
    opt = SGDOptimizer(0.0)
    loss0, _, _ = pipedream_train_step(
        stage_n, model.head_loss, opt, stages,
        [opt.init(st.named_parameters()) for st in stages], x, ids,
        mesh=make_mesh(MeshSpec(pp=S), device=dev), n_microbatches=M)
    same = all(torch.equal(a, p) for a, p in zip(snap,
                                                  model.blocks.parameters()))
    l0rel = abs(float(loss0) - float(loss)) / abs(float(loss))
    print(f"(d) asynchronous S={S} M={M} at lr 0: every weight bitwise "
          f"unchanged: {same}; loss {float(loss0):.6f}, relative "
          f"{l0rel:.3e} to the synchronous one (tol {PP_TOL:g}); {card}")
    assert same and l0rel <= PP_TOL, (same, l0rel)
    # S = 1 against a sequential per-microbatch SGD loop
    lr = 1e-2
    opt = SGDOptimizer(lr)
    whole = [torch.nn.ModuleList(blocks)]
    seq = copy.deepcopy(whole[0])
    pipedream_train_step(stage_n, model.head_loss, opt, whole,
                         [opt.init(whole[0].named_parameters())], x, ids,
                         mesh=make_mesh(MeshSpec(pp=1), device=dev),
                         n_microbatches=M)
    mb = ids.shape[0] // M
    for m in range(M):
        lm = model.head_loss(stage_n(seq, x[m * mb:(m + 1) * mb], None),
                             ids[m * mb:(m + 1) * mb])
        gs = torch.autograd.grad(lm, list(seq.parameters()))
        with torch.no_grad():
            for p, gp in zip(seq.parameters(), gs):
                p.sub_(lr * gp)
    pairs = list(zip(whole[0].parameters(), seq.parameters()))
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    s1 = max(((a - b).abs().max() / b.abs().max()).item() for a, b in pairs)
    print(f"(d) asynchronous S=1 M={M} SGD {lr:g} against the sequential "
          f"per-microbatch loop: bitwise {bitwise}, worst weight "
          f"{s1:.3e} of its max (tol {PP_PROC_TOL:g}); {card}")
    assert s1 <= PP_PROC_TOL, s1
    with torch.no_grad():
        for a, p in zip(snap, model.blocks.parameters()):
            p.copy_(a)
    del seq, whole
    # two HetPipe steps: pp = 4 x dp = 2, each gradient the dp mean
    opt = SGDOptimizer(0.1)
    states = [opt.init(st.named_parameters()) for st in stages]
    mesh = make_mesh(MeshSpec(pp=S, dp=2), device=dev)
    het, het_ms = [], []
    for _ in range(2):
        sync()
        t0 = time.monotonic()
        lh, _, states = pipedream_train_step(
            stage_n, model.head_loss, opt, stages, states, x, ids,
            mesh=mesh, n_microbatches=4, dp_axis="dp")
        sync()
        het_ms.append((time.monotonic() - t0) * 1e3)
        het.append(float(lh))
    print(f"(d) HetPipe pp={S} x dp=2 M=4, SGD 0.1: losses "
          f"{[round(v, 6) for v in het]}, step {[round(v, 1) for v in het_ms]}"
          f" ms, optimizer steps {[st['step'] for st in states]}; {card}")
    assert all(math.isfinite(v) for v in het) and all(
        st["step"] == 8 for st in states)
    out["async"] = {"lr0_same": same, "s1": s1, "bitwise_s1": bitwise,
                    "hetpipe": het, "hetpipe_ms": het_ms}
    del model, blocks, stages, x
    gc.collect()
    return out


def pp_hetero(cfg, ids, ref, card, dev):
    """(e) ``HeteroPipeline`` over 3 stages of 4 blocks at
    ``plan_hetero_dp([2, 1, 1], 4)``, M = 4 microbatches of 2 x 1024: its
    loss and gradients against the unsharded model's, then one AdamW
    step."""
    from hetu_tpu_torch import AdamWOptimizer
    from hetu_tpu_torch.parallel import (HeteroPipeline, HeteroStage,
                                         plan_hetero_dp)
    model, blocks = pp_blocks(cfg, dev)
    with torch.no_grad():
        x = model.embed(ids)
    plan = plan_hetero_dp([2, 1, 1], 4)
    n = cfg.num_layers // 3

    def stage_fn(stage, h, ex):
        for blk in stage:
            h = blk(h)
        return h

    stages = [HeteroStage(stage_fn, torch.nn.ModuleList(
        blocks[s * n:(s + 1) * n]), [dev] * d) for s, d in enumerate(plan)]
    pipe = HeteroPipeline(stages, lambda out, y: model.head_loss(out, y),
                          AdamWOptimizer(PP_LR, weight_decay=0.01))
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.monotonic()
    loss, grads = pipe.grads(x, ids, n_microbatches=4)
    sync()
    ms = (time.monotonic() - t0) * 1e3
    got = {f"blocks.stacked.{s * n + int(k.split('.', 1)[0])}."
           f"{k.split('.', 1)[1]}": g for s, gd in enumerate(grads)
           for k, g in gd.items()}
    worst = pp_worst(got, ref["grads"], names=set(got))
    lrel = abs(loss - ref["loss"]) / abs(ref["loss"])
    step_loss = pipe.step(x, ids, n_microbatches=4)
    print(f"(e) HeteroPipeline dp {plan} over 3 stages of {n} blocks, M=4: "
          f"loss {loss:.6f} (a float; relative {lrel:.3e}, tol {PP_TOL:g}), "
          f"worst block gradient {worst[1]}: {worst[0]:.3e} of its max (tol "
          f"{PP_GRAD_TOL:g}), grads {ms:.1f} ms; one AdamW step: loss "
          f"{step_loss:.6f}, optimizer steps "
          f"{[s['step'] for s in pipe.opt_states]}; {card}")
    assert isinstance(loss, float) and lrel <= PP_TOL, lrel
    assert worst[0] <= PP_GRAD_TOL, worst
    assert all(s["step"] == 1 for s in pipe.opt_states)
    del model, blocks, stages, pipe, x
    gc.collect()
    return {"plan": plan, "loss": loss, "grad_rel": worst[0], "ms": ms}


def pp_digest(sh):
    """Each held parameter's reduced step-0 gradient as a digest of its
    bytes (the processes and the local arm compare them bitwise)."""
    import hashlib
    grads = sh.reduce_grads()
    out = {}
    for i, g in enumerate(grads):
        for name, t in sorted(g.items()):
            key = f"{sh.coords[i]['pp']}:{name}"
            out[key] = hashlib.sha1(
                t.detach().float().cpu().numpy().tobytes()).hexdigest()
    return out


def pp_worker(rank, nproc, coord, dev, cfg_kw):
    """(f) one process of two: joins a gloo world, its tensors on ``dev``
    (the shared card), GPipe pp = 2, M = 4 over the process mesh; prints
    one ``PIPELINE`` JSON line (losses, the step-0 gradients' digests,
    the hops' count, bytes and ms a step)."""
    import datetime

    import torch.distributed as dist
    from hetu_tpu_torch.models.gpt import GPTConfig
    from hetu_tpu_torch.parallel import MeshSpec, collectives as col
    from hetu_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=nproc, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    cfg = GPTConfig(**cfg_kw)
    mesh = make_mesh(MeshSpec(pp=nproc), device=dev, processes=True)
    tr = pp_trainer(cfg, dev, mesh, 4)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (PP_BATCH, cfg.max_seq_len))).to(dev)
    tr._sharded.forward_backward(pp_loss, ids, None)
    digest = pp_digest(tr._sharded)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    losses, times = [], []
    col.reset_counts()
    with col.timed():
        for _ in range(PP_STEPS):
            sync()
            t0 = time.monotonic()
            losses.append(float(tr.step(ids)["loss"]))
            sync()
            times.append(time.monotonic() - t0)
    kinds = {k: {"calls": v["calls"] // PP_STEPS,
                 "bytes": v["bytes"] // PP_STEPS,
                 "ms": v["s"] * 1e3 / PP_STEPS,
                 "composed": v["composed"] // PP_STEPS}
             for k, v in col.counts().items()}
    print("PIPELINE " + json.dumps({
        "rank": rank, "losses": losses, "digest": digest,
        "step_ms": [t * 1e3 for t in times], "kinds": kinds}), flush=True)
    dist.destroy_process_group()
    return 0


def pp_processes(cfg, ids, card, dev):
    """(f) GPipe pp = 2 across two processes of this script on the card
    over gloo against the same arm on a local pp = 2 mesh: losses and
    step-0 gradients bitwise."""
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    t0 = time.monotonic()
    tr = pp_trainer(cfg, dev, make_mesh(MeshSpec(pp=2), device=dev), 4)
    tr._sharded.forward_backward(pp_loss, ids, None)
    local = pp_digest(tr._sharded)
    local_losses = [float(tr.step(ids)["loss"]) for _ in range(PP_STEPS)]
    del tr
    gc.collect()
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("dtype", "remat")}
    outs, rcs = st_spawn(
        lambda r, port: ["--pipeline-worker", str(r), "2",
                         f"127.0.0.1:{port}", dev, json.dumps(cfg_kw)],
        2, 600)
    rows = sorted(st_lines(outs, "PIPELINE"), key=lambda r: r["rank"])
    assert rcs == [0, 0] and len(rows) == 2, (rcs, [o[-3000:] for o in outs])
    digest = {**rows[0]["digest"], **rows[1]["digest"]}
    same_grads = digest == local
    gap = max(abs(a - b) / abs(b) for a, b in zip(rows[0]["losses"],
                                                    local_losses))
    hop = rows[0]["kinds"].get("ppermute", {})
    print(f"(f) GPipe pp=2 M=4 across two processes on the one card (gloo): "
          f"losses {[round(v, 6) for v in rows[0]['losses']]} vs local pp=2 "
          f"{[round(v, 6) for v in local_losses]}, relative gap {gap:.3e} "
          f"(tol {PP_PROC_TOL:g}), bitwise {rows[0]['losses'] == local_losses}"
          f"; step-0 gradients bitwise the local arm's "
          f"({len(digest)} tensors): {same_grads}; rank 0's hops a step "
          f"{hop.get('calls')} calls, {hop.get('bytes')} bytes, "
          f"{hop.get('ms', 0):.1f} ms ({hop.get('composed')} composed from "
          f"all_reduce: gloo has no CUDA send/recv); collectives a step "
          f"{rows[0]['kinds']}; step ms "
          f"{[round(t, 1) for t in rows[0]['step_ms']]}; "
          f"{time.monotonic() - t0:.1f} s; {card}")
    assert rows[0]["losses"] == rows[1]["losses"], "the processes disagree"
    assert gap <= PP_PROC_TOL and same_grads, (gap, same_grads)
    return {"losses": rows[0]["losses"], "local": local_losses, "gap": gap,
            "hop": hop, "kinds": rows[0]["kinds"],
            "step_ms": rows[0]["step_ms"]}


def pipeline_phase(fl, ce, gpt_mod, card, dev="cuda", cfg=None):
    """Phase 21: (a) GPipe on a local pp = 4 mesh under remat 'full' and
    'none' with the control; (b) config A's dp x tp x pp composition;
    (c) synchronous interleaved 1F1B; (d) asynchronous PipeDream and
    HetPipe; (e) heterogeneous dp; (f) two processes over gloo.  Returns
    the rows the summary needs and the launches of the phase's run."""
    t_start = time.monotonic()
    cfg = cfg or gpt_mod.gpt2_small(streamed_head_chunk=1024)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (PP_BATCH, cfg.max_seq_len))).to(dev)
    ref = pp_reference(cfg, ids, dev)
    fl.reset_launch_count()
    ce.reset_launch_count()
    rows = {}
    L = cfg.num_layers
    for remat, want in (("none", (8 * L, 8 * L, 4, 1)),
                        ("full", (16 * L, 8 * L, 4, 1))):
        rows[remat] = pp_gpipe(cfg, ids, ref, fl, ce, card, dev, remat,
                               control=remat == "none")
        if dev == "cuda":
            assert all(s == want for s in rows[remat]["per_step"]), \
                (remat, rows[remat]["per_step"], want)
    a_launches = st_counts(fl, ce)
    rows["config_a"] = pp_config_a(cfg, ids, ref, fl, ce, card, dev)
    if dev == "cuda":
        want = (16 * L, 16 * L, 8, 4)
        assert all(s == want for s in rows["config_a"]["per_step"]), \
            (rows["config_a"]["per_step"], want)
    b_launches = tuple(a - b for a, b in zip(st_counts(fl, ce), a_launches))
    mid = st_counts(fl, ce)
    rows["pipedream"] = pp_pipedream(cfg, ids, ref, fl, ce, card, dev)
    rows["hetero"] = pp_hetero(cfg, ids, ref, card, dev)
    cde = tuple(a - b for a, b in zip(st_counts(fl, ce), mid))
    del ref
    gc.collect()
    rows["proc"] = pp_processes(cfg, ids, card, dev)
    launches = st_counts(fl, ce)
    print(f"phase 21 launches (flash fwd, bwd, CE fwd, bwd): (a) "
          f"{a_launches}, (b) {b_launches}, (c)-(e) {cde}, in all {launches}")
    assert dev != "cuda" or all(n > 0 for n in launches), launches
    out = {"arms": rows, "launches": {"a": a_launches, "b": b_launches,
                                      "cde": cde}}
    if dev == "cuda":
        gen = torch.Generator().manual_seed(21)
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        out["flash_mb"] = check_flash(fl, flush, torch.float32, 1024, gen,
                                      timed=True, B=1, H=12)
        out["flash_tp"] = check_flash(fl, flush, torch.float32, 1024, gen,
                                      timed=True, B=1, H=6)
        out["ce_mb"] = check_lm_head_ce(ce, flush, torch.float32, gen, card,
                                        N=1023, extra=False)
        out["ce_shard"] = st_shard_ce(ce, flush, gen, card, N=4092)
        del flush
        torch.cuda.empty_cache()
    return out, time.monotonic() - t_start


# --------------------------------------------------------------- phase 22
# sequence parallelism beside data and tensor parallelism: GPT-2 small at
# phase 5's settings on a local dp=2 sp=2 tp=2 mesh (__graft_entry__.py's
# config G: ring attention with the heads sharded over tp), the
# blockwise core and Ulysses on the same mesh, the reference's own sp=4
# dp=2 mesh without a strategy, and sp=2 across two processes sharing
# the card over gloo.

SP_STEPS = 3    # ST_STEPS too: st_reference's losses
SP_BATCH = 8
SP_PROC_BATCH = 4      # (e): each process holds the whole 4 x 1024
SP_TOL = 1e-5          # step-0 loss, relative
SP_GRAD_TOL = 1e-3     # step-0 gradients, of each one's max (other sums)
SP_PROC_TOL = 1e-6     # two processes vs the local sp = 2 arm, relative
SP_MESH3 = dict(dp=2, sp=2, tp=2)
# one causal sp=2 ring's visits: 2 diagonal, 1 past
SP2_VISITS = {"diagonal": 2, "past": 1}


def sp_counts(fl, ce):
    return (fl.block_fwd_launch_count(), fl.block_bwd_launch_count(),
            fl.fwd_launch_count(), fl.bwd_launch_count(),
            ce.fwd_launch_count(), ce.bwd_launch_count())


def sp_attn(kind, mesh):
    from hetu_tpu_torch.parallel import ring_attn_fn, ulysses_attn_fn
    return {"ring": lambda: ring_attn_fn(mesh, impl="flash", head_axis="tp"),
            "blockwise": lambda: ring_attn_fn(mesh, impl="blockwise",
                                              head_axis="tp"),
            "ulysses": lambda: ulysses_attn_fn(mesh, head_axis="tp"),
            "ring_plain": lambda: ring_attn_fn(mesh)}[kind]()


def sp_model(cfg, dev, attn_fn):
    from hetu_tpu_torch import GPT
    return GPT(cfg, attn_fn=attn_fn,
               generator=torch.Generator().manual_seed(0), device=dev)


def sp_trainer(cfg, dev, mesh, kind, rules=None):
    from hetu_tpu_torch import AdamWOptimizer, Trainer
    from hetu_tpu_torch.parallel import ShardingStrategy
    from hetu_tpu_torch.parallel.spec import DP_RULES, MEGATRON_RULES
    return Trainer(sp_model(cfg, dev, sp_attn(kind, mesh)),
                   AdamWOptimizer(3e-4, weight_decay=0.01), st_loss,
                   strategy=ShardingStrategy(
                       mesh=mesh, rules=rules or (
                           MEGATRON_RULES if mesh.shape["tp"] > 1
                           else DP_RULES), batch_axes="dp"))


def sp_full_grads(sh):
    """Every parameter's global gradient from the ranks' own: for each
    dp piece the tp pieces of its sp = 0 ranks joined, then the mean over
    dp; and whether every sp rank's gradients equal its group's sp = 0
    rank's bitwise (none is summed over sp)."""
    from hetu_tpu_torch.parallel.spec import gather_param
    grads = [{n: p.grad for n, p in m.named_parameters()} for m in sh.models]
    same = all(torch.equal(grads[i][n], grads[j][n])
               for i, c in enumerate(sh.coords) if c["sp"] == 0
               for j, d in enumerate(sh.coords)
               if d["sp"] > 0 and d["dp"] == c["dp"] and d["tp"] == c["tp"]
               for n in grads[i])
    out = {}
    for name, pl in sh.place.items():
        total = None
        for k in range(sh.dp):
            idx = [i for i, c in enumerate(sh.coords)
                   if c["dp"] == k and c["sp"] == 0]
            g = gather_param([grads[i][name] for i in idx], pl.shape,
                             pl.tp_spec, [sh.coords[i] for i in idx],
                             sh.mesh.shape, pl.blocks)
            total = g if total is None else total + g
        out[name] = total / sh.dp
    return out, same


def sp_worst(grads, ref):
    return max((((grads[k] - g).abs().max()
                 / g.abs().max().clamp_min(1e-30)).item(), k)
               for k, g in ref.items())


def sp_step0(label, sh, loss, ref, card):
    """Step 0's mean ``loss`` and every rank's gradients (left in ``.grad``
    by the forward and backward) against the unsharded flash path's;
    returns the readings."""
    full, same = sp_full_grads(sh)
    lrel = abs(loss - ref["loss"]) / abs(ref["loss"])
    worst = sp_worst(full, ref["grads"])
    print(f"{label} step 0: loss {loss:.6f} vs unsharded {ref['loss']:.6f},"
          f" relative {lrel:.3e} (tol {SP_TOL:g}); worst gradient "
          f"{worst[1]}: {worst[0]:.3e} of its max (tol {SP_GRAD_TOL:g}); "
          f"each sp rank's gradients bitwise its group's sp=0 rank's (none "
          f"summed over sp): {same}; {card}")
    del full
    return {"loss": loss, "rel": lrel, "grad_rel": worst[0], "same": same}


def sp_steps(label, trainer, ids, ref, fl, ce, col, card, dev, steps):
    """``steps`` AdamW steps from the reference's weights: the first one's
    loss and gradients as step 0 (``sp_step0``), each step's launches
    (block fwd, bwd, flash fwd, bwd, CE fwd, bwd), the losses against the
    unsharded trainer's, the collectives a step, median step, tokens/s
    and peak memory."""
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    for m in trainer._sharded.models:
        for p in m.parameters():
            p.grad = None
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    col.reset_counts()
    losses, times, per_step, step0 = [], [], [], None
    for _ in range(steps):
        before = sp_counts(fl, ce)
        sync()
        t0 = time.monotonic()
        losses.append(float(trainer.step(ids)["loss"]))
        sync()
        times.append(time.monotonic() - t0)
        per_step.append(tuple(a - b for a, b in
                              zip(sp_counts(fl, ce), before)))
        if step0 is None:
            step0 = sp_step0(label, trainer._sharded, losses[0], ref, card)
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    kinds = {k: (v["calls"] // steps, v["bytes"] // steps)
             for k, v in col.counts().items()}
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    print(f"{label}: losses {[round(x, 6) for x in losses]} vs unsharded "
          f"{[round(x, 6) for x in ref['losses'][:steps]]}, largest "
          f"relative gap {gap:.3e} (tol {ST_TOL:g}); launches a step "
          f"(block fwd, bwd, flash fwd, bwd, CE fwd, bwd) {per_step}; "
          f"collectives a step (calls, bytes) {kinds}; median step "
          f"{med * 1e3:.3f} ms ({[round(t * 1e3, 3) for t in times]}; the "
          f"ranks run in turn on one card, not a multi-card step), "
          f"{ids.numel() / med:.1f} tokens/s, peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB); {card}")
    return {"step0": step0, "losses": losses, "gap": gap,
            "per_step": per_step, "kinds": kinds, "step_ms": med * 1e3,
            "peak": peak}


@contextlib.contextmanager
def sp_offsets_swapped():
    """The control of arm (a): the two sp chunks' causal offsets swapped
    in the ring (chunk 0 masked as if it stood second, chunk 1 first)."""
    import importlib
    # the package's ``ring_attention`` function shadows the submodule
    ra = importlib.import_module("hetu_tpu_torch.parallel.ring_attention")
    orig = ra._visit
    ra._visit = lambda r, src, causal: orig(1 - r, 1 - src, causal)
    try:
        yield
    finally:
        ra._visit = orig


def sp_config_g(cfg, ids, ref, fl, ce, col, card, dev):
    """(a) config G at full width: dp=2 sp=2 tp=2, the flash ring with
    the heads over tp, MEGATRON_RULES."""
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    mesh = make_mesh(MeshSpec(**SP_MESH3), device=dev)
    trainer = sp_trainer(cfg, dev, mesh, "ring")
    sh = trainer._sharded
    row = {"ranks": len(sh.held),
           "param_bytes": [sum(p.numel() * p.element_size()
                               for p in m.parameters()) for m in sh.models]}
    with sp_offsets_swapped():
        out = sh.forward_backward(st_loss, ids, None)
        ctrl = sp_step0("(a) control: the two sp chunks' causal offsets "
                        "swapped", sh, float(sh.mean_loss(
                            [o[0] for o in out])), ref, card)
    del out
    print(f"(a) control: loss {ctrl['rel']:.3e} relative, gradients "
          f"{ctrl['grad_rel']:.3e} of their max (one must exceed its tol "
          f"{SP_TOL:g} / {SP_GRAD_TOL:g}); {card}")
    assert ctrl["rel"] > SP_TOL or ctrl["grad_rel"] > SP_GRAD_TOL, \
        "the step-0 check cannot tell swapped causal offsets"
    row["control"] = ctrl
    row.update(sp_steps("(a) config G dp2 sp2 tp2, ring", trainer, ids,
                        ref, fl, ce, col, card, dev, SP_STEPS))
    print(f"(a) parameter bytes a rank {row['param_bytes']} (the tp halves "
          f"of the blocks and of the vocabulary; the same on both sp ranks "
          f"of a group); {card}")
    del trainer, sh
    return row


def sp_one_step(label, kind, cfg, ids, ref, fl, ce, col, card, dev):
    """(b), (c): the core ``kind`` on the dp2 sp2 tp2 mesh, one timed
    step, its loss and gradients against the unsharded path's."""
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    mesh = make_mesh(MeshSpec(**SP_MESH3), device=dev)
    trainer = sp_trainer(cfg, dev, mesh, kind)
    row = sp_steps(label, trainer, ids, ref, fl, ce, col, card, dev, 1)
    del trainer
    return row


def sp_no_strategy(cfg, ids, ref, fl, ce, card, dev):
    """(d) the reference's own MeshSpec(sp=4, dp=2) without a strategy:
    ``GPT(attn_fn=ring_attn_fn(mesh))`` plays every rank (each dp half's
    ring of four chunks); forward and gradients against the unsharded
    model."""
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh, ring_attn_fn
    model = sp_model(cfg, dev, ring_attn_fn(make_mesh(MeshSpec(sp=4, dp=2),
                                                      device=dev)))
    before = sp_counts(fl, ce)
    loss = model.loss(ids)
    loss.backward()
    loss = float(loss.detach())
    launches = tuple(a - b for a, b in zip(sp_counts(fl, ce), before))
    lrel = abs(loss - ref["loss"]) / abs(ref["loss"])
    worst = sp_worst({n: p.grad for n, p in model.named_parameters()},
                     ref["grads"])
    print(f"(d) MeshSpec(sp=4, dp=2), no strategy: loss {loss:.6f}, "
          f"relative {lrel:.3e} (tol {SP_TOL:g}); worst gradient "
          f"{worst[1]}: {worst[0]:.3e} of its max (tol {SP_GRAD_TOL:g}); "
          f"launches (block fwd, bwd, flash fwd, bwd, CE fwd, bwd) "
          f"{launches}; {card}")
    del model
    return {"rel": lrel, "grad_rel": worst[0], "launches": launches}


def sp_digest(sh):
    """Each held rank's gradients of the last forward and backward (dp = 1:
    what the update got) as digests of their bytes, keyed by the rank's
    sp coordinate."""
    import hashlib
    out = {}
    for c, m in zip(sh.coords, sh.models):
        for name, p in m.named_parameters():
            out[f"{c['sp']}:{name}"] = hashlib.sha1(
                p.grad.detach().float().cpu().numpy().tobytes()).hexdigest()
    return out


def sp_two_rank_run(cfg, dev, mesh, kind, ids):
    """An sp = 2 run on ``mesh`` (local or over processes): ``SP_STEPS``
    steps with each one's losses and times, the first step's gradients'
    digests and the collectives a step."""
    from hetu_tpu_torch.parallel import collectives as col
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    tr = sp_trainer(cfg, dev, mesh, "ring_plain" if kind == "ring"
                    else kind)
    losses, times, digest = [], [], None
    col.reset_counts()
    with col.timed():
        for _ in range(SP_STEPS):
            sync()
            t0 = time.monotonic()
            losses.append(float(tr.step(ids)["loss"]))
            sync()
            times.append(time.monotonic() - t0)
            digest = digest or sp_digest(tr._sharded)
    kinds = {k: {"calls": v["calls"] // SP_STEPS,
                 "bytes": v["bytes"] // SP_STEPS,
                 "ms": v["s"] * 1e3 / SP_STEPS,
                 "composed": v["composed"] // SP_STEPS}
             for k, v in col.counts().items()}
    del tr
    return {"losses": losses, "digest": digest,
            "step_ms": [t * 1e3 for t in times], "kinds": kinds}


def sp_worker(rank, nproc, coord, dev, cfg_kw):
    """(e) one process of two: joins a gloo world, its tensors on ``dev``
    (the shared card), sp = 2 over the process mesh (this process one sp
    rank, the whole 4 x 1024 batch), the ring and then Ulysses; prints
    one ``SEQPAR`` JSON line."""
    import datetime

    import torch.distributed as dist
    from hetu_tpu_torch.models.gpt import GPTConfig
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=nproc, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    cfg = GPTConfig(**cfg_kw)
    mesh = make_mesh(MeshSpec(sp=nproc), device=dev, processes=True)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SP_PROC_BATCH, cfg.max_seq_len))).to(dev)
    out = {kind: sp_two_rank_run(cfg, dev, mesh, kind, ids)
           for kind in ("ring", "ulysses")}
    print("SEQPAR " + json.dumps({"rank": rank, "runs": out}), flush=True)
    dist.destroy_process_group()
    return 0


def sp_processes(cfg, card, dev):
    """(e) sp = 2 across two processes of this script over gloo, against
    the same runs on a local sp = 2 mesh: losses within ``SP_PROC_TOL``,
    each rank's step-0 gradients bitwise, the hops' count, bytes and
    ms."""
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    t0 = time.monotonic()
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SP_PROC_BATCH, cfg.max_seq_len))).to(dev)
    mesh = make_mesh(MeshSpec(sp=2), device=dev)
    local = {kind: sp_two_rank_run(cfg, dev, mesh, kind, ids)
             for kind in ("ring", "ulysses")}
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("dtype", "remat")}
    outs, rcs = st_spawn(
        lambda r, port: ["--sp-worker", str(r), "2", f"127.0.0.1:{port}",
                         dev, json.dumps(cfg_kw)], 2, 900)
    rows = sorted(st_lines(outs, "SEQPAR"), key=lambda r: r["rank"])
    assert rcs == [0, 0] and len(rows) == 2, (rcs, [o[-3000:] for o in outs])
    out = {}
    for kind in ("ring", "ulysses"):
        a, b = (r["runs"][kind] for r in rows)
        ref = local[kind]
        gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                      ref["losses"]))
        same = all(r["runs"][kind]["digest"][k] == ref["digest"][k]
                   for r in rows for k in r["runs"][kind]["digest"])
        hop = "ppermute" if kind == "ring" else "all_to_all"
        print(f"(e) {kind}, two processes, gloo, tensors on the one card: "
              f"losses {a['losses']} and {b['losses']}; local sp=2 "
              f"{ref['losses']}: largest relative gap {gap:.3e} (tol "
              f"{SP_PROC_TOL:g}); every step-0 gradient of both processes "
              f"bitwise the local arm's: {same}; step ms "
              f"{[round(t, 1) for t in a['step_ms']]} (local "
              f"{[round(t, 1) for t in ref['step_ms']]}); a step: "
              + "; ".join(f"{k} {v['calls']} calls ({v['composed']} "
                          f"composed from all_reduce), {v['bytes']} bytes, "
                          f"{v['ms']:.1f} ms" for k, v in
                          sorted(a["kinds"].items()))
              + f" (gloo through host memory on one card, not a link); "
              f"{card}")
        assert gap <= SP_PROC_TOL, (kind, gap)
        # the losses alone cannot tell a gradient counted sp times: step
        # 0's loss precedes it and AdamW nearly ignores a common scale
        assert same, (kind, "the step-0 gradients differ from the local "
                            "sp=2 arm's")
        assert a["losses"] == b["losses"], f"{kind}: the processes disagree"
        assert a["kinds"].get(hop, {}).get("calls", 0) > 0, a["kinds"]
        assert a["losses"][-1] < a["losses"][0], a["losses"]
        out[kind] = {"proc": a, "local": ref, "gap": gap, "grads_same": same}
    print(f"(e) in {time.monotonic() - t0:.1f} s; {card}")
    return out


def sp_phase(fl, ce, gpt_mod, card, train_losses, dev="cuda", cfg=None,
             ce_rows=None):
    """Phase 22: (a) config G at full width on a local dp2 sp2 tp2 mesh
    with the control; (b) the blockwise core and (c) Ulysses there; (d)
    the reference's sp=4 dp=2 mesh without a strategy; (e) sp=2 across
    two processes over gloo; then this path's kernels at its shapes (the
    CE pair's rows on a rank's vocabulary shard: ``ce_rows`` where an
    earlier phase of the run timed that same shape, N=4092 on
    V_r=25129).  Returns the rows the summary needs and the launches of
    the arms."""
    from hetu_tpu_torch.parallel import collectives as col
    t_start = time.monotonic()
    cfg = cfg or gpt_mod.gpt2_small(streamed_head_chunk=1024)
    L = cfg.num_layers
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SP_BATCH, cfg.max_seq_len))).to(dev)
    ref = st_reference(cfg, ids, dev, train_losses)
    rows = {"a": sp_config_g(cfg, ids, ref, fl, ce, col, card, dev)}
    a_end = sp_counts(fl, ce)
    rows["b"] = sp_one_step("(b) dp2 sp2 tp2, blockwise ring", "blockwise",
                            cfg, ids, ref, fl, ce, col, card, dev)
    b_end = sp_counts(fl, ce)
    rows["c"] = sp_one_step("(c) dp2 sp2 tp2, Ulysses", "ulysses", cfg, ids,
                            ref, fl, ce, col, card, dev)
    c_end = sp_counts(fl, ce)
    rows["d"] = sp_no_strategy(cfg, ids, ref, fl, ce, card, dev)
    d_end = sp_counts(fl, ce)
    del ref
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    for arm in ("a", "b", "c"):
        r = rows[arm]["step0"]
        assert r["rel"] <= SP_TOL and r["grad_rel"] <= SP_GRAD_TOL, (arm, r)
        assert r["same"], f"{arm}: an sp rank's gradients differ"
        assert rows[arm]["gap"] <= ST_TOL, (arm, rows[arm]["gap"])
    assert rows["a"]["losses"][-1] < rows["a"]["losses"][0], rows["a"]
    assert rows["d"]["rel"] <= SP_TOL and rows["d"]["grad_rel"] <= \
        SP_GRAD_TOL, rows["d"]
    if dev == "cuda":
        # 4 (dp, tp) groups x 3 visits x L layers of the ring; 8 ranks x L
        # flash calls for Ulysses; every rank runs the head
        ring, uly = (12 * L, 12 * L, 0, 0, 8, 8), (0, 0, 8 * L, 8 * L, 8, 8)
        assert all(s == ring for s in rows["a"]["per_step"]), rows["a"]
        assert all(s == (0, 0, 0, 0, 8, 8) for s in rows["b"]["per_step"])
        assert all(s == uly for s in rows["c"]["per_step"]), rows["c"]
        assert rows["d"]["launches"][:4] == (20 * L, 20 * L, 0, 0), rows["d"]
    rows["proc"] = sp_processes(cfg, card, dev)
    # (a)'s launches are its 3 steps' (the control's run is left out)
    launches = {"a": tuple(map(sum, zip(*rows["a"]["per_step"]))),
                "bcd": tuple(x - y for x, y in zip(d_end, a_end)),
                "c": tuple(x - y for x, y in zip(c_end, b_end))}
    print(f"phase 22 launches (block fwd, bwd, flash fwd, bwd, CE fwd, bwd):"
          f" (a) {launches['a']}, (b)-(d) {launches['bcd']}, of which (c) "
          f"{launches['c']}")
    out = {"arms": rows, "launches": launches}
    if dev == "cuda":
        gen = torch.Generator().manual_seed(22)
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        out["block"] = check_flash_block(
            fl, flush, torch.float32, gen,
            shape=(SP_BATCH // 2, cfg.num_heads // 2, cfg.max_seq_len,
                   cfg.hidden_size // cfg.num_heads), sp=2)
        out["flash"] = check_flash(fl, flush, torch.float32,
                                   cfg.max_seq_len, gen, timed=True,
                                   B=SP_BATCH // 2, H=cfg.num_heads // 4)
        out["ce"] = ce_rows or st_shard_ce(
            ce, flush, gen, card, N=SP_BATCH // 2 * (cfg.max_seq_len - 1))
        del flush
        torch.cuda.empty_cache()
    return out, time.monotonic() - t_start


# ---------------------------------------------------------------------------
# Phase 23: expert parallelism beside the other mesh axes -- the
# reference's config B (a MoE LM with the ring over dp x ep x sp under
# ShardingStrategy(DP_RULES, batch_axes=("dp", "ep"))) at bench.py config
# 3's widths, the hierarchical (ep, tp) exchange, ep across two processes
# and the 1.5D GCN.
# ---------------------------------------------------------------------------

# __graft_entry__.py's config B at bench.py config 3's widths
EP_CFG = dict(vocab_size=32000, hidden_size=1024, num_layers=4,
              num_heads=16, num_experts=8, top_k=1, capacity_factor=1.25,
              max_seq_len=256)
EP_MESH = dict(dp=2, ep=2, sp=2)
EP_BATCH = 32
EP_STEPS = 3
EP_TOL = 1e-6           # step-0 loss, relative
EP_GRAD_TOL = 1e-5      # step-0 gradients, of each one's largest value
EP_CONTROL_CF = 0.5     # the control's capacity factor where 1.25 drops none
EP_PROC_BATCH = 4       # (c): rows a process holds
GCN15_NODES = 16384     # (d): a 1.07 GB dense fp32 adjacency
GCN15_STEPS = 5
GCN15_TOL = 1e-5


def ep_loss(m, b, k):
    return m.loss(b, training=True)


def ep_counts(fl):
    return (fl.block_fwd_launch_count(), fl.block_bwd_launch_count(),
            fl.fwd_launch_count(), fl.bwd_launch_count())


def ep_model(cfg, dev, mesh, attn_fn):
    from hetu_tpu_torch.models.moe_lm import MoELM
    return MoELM(cfg, mesh=mesh, attn_fn=attn_fn,
                 generator=torch.Generator().manual_seed(0), device=dev)


def ep_trainer(cfg, dev, mesh, attn_fn):
    from hetu_tpu_torch import AdamWOptimizer, Trainer
    from hetu_tpu_torch.parallel import ShardingStrategy
    from hetu_tpu_torch.parallel.spec import DP_RULES
    return Trainer(ep_model(cfg, dev, mesh, attn_fn),
                   AdamWOptimizer(3e-4, weight_decay=0.01), ep_loss,
                   strategy=ShardingStrategy(mesh=mesh, rules=DP_RULES,
                                             batch_axes=("dp", "ep")))


def ep_full_grads(sh, grads):
    """Each parameter's reduced gradient joined from the ranks at dp = 0,
    sp = 0 (one per ep index: the experts' slices), and whether every
    rank's reduced gradients equal those of its ep index's rank there
    bitwise (a replica counted twice, or its share lost, would not)."""
    from hetu_tpu_torch.parallel.spec import gather_param
    home = {c["ep"]: i for i, c in enumerate(sh.coords)
            if c["dp"] == 0 and c["sp"] == 0}
    same = all(torch.equal(grads[i][n], grads[home[c["ep"]]][n])
               for i, c in enumerate(sh.coords) for n in grads[i])
    idx = sorted(home.values())
    full = {n: gather_param([grads[i][n] for i in idx], pl.shape,
                            pl.tp_spec, [sh.coords[i] for i in idx],
                            sh.mesh.shape, pl.blocks)
            for n, pl in sh.place.items()}
    return full, same


def ep_set_cf(models, cf):
    for m in models:
        for blk in m.blocks:
            blk.moe.gate.capacity_factor = cf
            blk.moe.gate.eval_capacity_factor = cf


@contextlib.contextmanager
def ep_own_piece_routing(sh):
    """The control: each rank routes its own (dp, ep) piece, as if the
    batch were cut over ep alone (the ``MeshSpec(ep=4)`` function)."""
    layers = [blk.moe for m in sh.models for blk in m.blocks]
    saved = [lay._rank for lay in layers]
    for lay in layers:
        handle, _, ep_axes = lay._rank
        lay._rank = (handle, ep_axes, ep_axes)
    try:
        yield
    finally:
        for lay, r in zip(layers, saved):
            lay._rank = r


def ep_reference(cfg, ids, fl, card, dev):
    """(a)'s reference: the same model and weights on ``MeshSpec(ep=2)``
    alone with the flash core (``flash_attn_fn(native_layout=True)``),
    step 0's loss and gradients, the routing stats, and where capacity
    factor 1.25 drops no token the loss at ``EP_CONTROL_CF``."""
    from hetu_tpu_torch.ops.kernels.flash import flash_attn_fn
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    model = ep_model(cfg, dev, make_mesh(MeshSpec(ep=2), device=dev),
                     flash_attn_fn(native_layout=True))
    with torch.no_grad():
        _, (_, stats) = model(ids, training=True, with_stats=True)
    overflow = float(stats["overflow_frac"])
    before = (fl.fwd_launch_count(), fl.bwd_launch_count())
    loss, _ = model.loss(ids, training=True)
    loss.backward()
    launches = (fl.fwd_launch_count() - before[0],
                fl.bwd_launch_count() - before[1])
    out = {"loss": float(loss.detach()), "overflow": overflow,
           "grads": {n: p.grad for n, p in model.named_parameters()},
           "launches": launches, "control_cf": cfg.capacity_factor}
    if overflow == 0.0:
        out["control_cf"] = EP_CONTROL_CF
        ep_set_cf([model], EP_CONTROL_CF)
        with torch.no_grad():
            out["control_loss"] = float(model.loss(ids, training=True)[0])
    else:
        out["control_loss"] = out["loss"]
    print(f"(a) reference, MeshSpec(ep=2) with the flash core: step-0 "
          f"loss {out['loss']:.6f}, overflow {overflow:.4f} at capacity "
          f"factor {cfg.capacity_factor}"
          + (f" (no token dropped: the control runs at capacity factor "
             f"{EP_CONTROL_CF}, loss there {out['control_loss']:.6f})"
             if overflow == 0.0 else "")
          + f"; flash fwd / bwd launches {launches}; {card}")
    del model
    return out


def ep_config_b(cfg, ids, fl, col, card, dev):
    """(a) config B at bench.py config 3's widths on a local dp2 ep2 sp2
    mesh: step 0 against the reference, the replicas, the own-piece
    control, then ``EP_STEPS`` AdamW steps with their launches, the
    exchange's calls and bytes, the step time and the peak."""
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh, ring_attn_fn
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    ref = ep_reference(cfg, ids, fl, card, dev)
    mesh = make_mesh(MeshSpec(**EP_MESH), device=dev)
    trainer = ep_trainer(cfg, dev, mesh, ring_attn_fn(mesh))
    sh = trainer._sharded
    row = {"ranks": len(sh.held), "overflow": ref["overflow"],
           "param_bytes": [sum(p.numel() * p.element_size()
                               for p in m.parameters()) for m in sh.models]}
    out = sh.forward_backward(ep_loss, ids, None)
    loss = float(sh.mean_loss([o[0] for o in out]))
    del out
    full, same = ep_full_grads(sh, sh.reduce_grads())
    for m in sh.models:
        for p in m.parameters():
            p.grad = None
    lrel = abs(loss - ref["loss"]) / abs(ref["loss"])
    worst = max((((full[n] - g).abs().max()
                  / g.abs().max().clamp_min(1e-30)).item(), n)
                for n, g in ref["grads"].items())
    del full, ref["grads"]
    print(f"(a) config B dp2 ep2 sp2 step 0: loss {loss:.6f} vs "
          f"{ref['loss']:.6f}, relative {lrel:.3e} (tol {EP_TOL:g}); worst "
          f"gradient {worst[1]}: {worst[0]:.3e} of its max (tol "
          f"{EP_GRAD_TOL:g}); every rank's reduced gradients bitwise its "
          f"ep index's (dp 0, sp 0) rank's: {same}; {card}")
    row.update(rel=lrel, grad_rel=worst[0], same=same)
    cf = ref["control_cf"]
    ep_set_cf(sh.models, cf)
    with torch.no_grad():
        right = float(sh.evaluate(ep_loss, ids)[0])
        with ep_own_piece_routing(sh):
            own = float(sh.evaluate(ep_loss, ids)[0])
    ep_set_cf(sh.models, cfg.capacity_factor)
    base = ref["control_loss"]
    row["control"] = {"cf": cf, "right": abs(right - base) / abs(base),
                      "own": abs(own - base) / abs(base)}
    print(f"(a) control at capacity factor {cf}: the reference block "
          f"routing {row['control']['right']:.3e} relative (tol "
          f"{EP_TOL:g}); each rank routing its own (dp, ep) piece (the "
          f"MeshSpec(ep=4) function) {row['control']['own']:.3e} relative "
          f"(must exceed {EP_TOL:g}); {card}")
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    col.reset_counts()
    losses, times, per_step = [], [], []
    for _ in range(EP_STEPS):
        before = ep_counts(fl)
        sync()
        t0 = time.monotonic()
        losses.append(float(trainer.step(ids)["loss"]))
        sync()
        times.append(time.monotonic() - t0)
        per_step.append(tuple(a - b for a, b in
                              zip(ep_counts(fl), before)))
    kinds = {k: (v["calls"] // EP_STEPS, v["bytes"] // EP_STEPS)
             for k, v in col.counts().items()}
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    print(f"(a) {EP_STEPS} AdamW steps: losses "
          f"{[round(x, 6) for x in losses]}; launches a step (block fwd, "
          f"bwd, flash fwd, bwd) {per_step}; collectives a step (calls, "
          f"bytes) {kinds}; median step {med * 1e3:.3f} ms "
          f"({[round(t * 1e3, 3) for t in times]}; eight ranks in turn on "
          f"one card, not a multi-card step), {ids.numel() / med:.1f} "
          f"tokens/s, peak memory {peak} bytes ({peak / 2**30:.3f} GiB); "
          f"parameter bytes a rank {row['param_bytes']}; {card}")
    row.update(losses=losses, per_step=per_step, kinds=kinds,
               step_ms=med * 1e3, peak=peak, ref_launches=ref["launches"])
    del trainer, sh
    return row


def ep_hier_check(cfg, card, dev="cuda", T=MOE_GATE_T):
    """(b) ``MoELayer(axis=("ep", "tp"))`` on ``MeshSpec(ep=2, tp=2)`` at
    config 3's layer (top-2, ``T`` tokens), forward and backward: bitwise
    the flat ``ep=4`` layer, within ``MOE_TOL`` of four single-group
    calls."""
    from hetu_tpu_torch.layers import moe
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    from hetu_tpu_torch.parallel import collectives as col
    d, E = cfg.hidden_size, cfg.num_experts
    g = torch.Generator().manual_seed(23)
    gate = moe.TopKGate(d, E, 2, capacity_factor=1.25, generator=g,
                        device=dev)
    experts = moe.ExpertMLP(E, d, 4 * d, generator=g, device=dev)
    x = torch.randn((T, d), generator=g).to(dev)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)

    def run(layer):
        for p in (*gate.parameters(), *experts.parameters()):
            p.grad = None
        xi = x.clone().requires_grad_()
        col.reset_counts()
        sync()
        t0 = time.monotonic()
        y, (aux, stats) = layer(xi, with_stats=True)
        ((y ** 2).mean() + 0.01 * aux).backward()
        sync()
        ms = (time.monotonic() - t0) * 1e3
        grads = [xi.grad] + [p.grad.clone() for p in
                             (*gate.parameters(), *experts.parameters())]
        return y.detach(), aux.detach(), stats, grads, ms, col.counts()

    layers = [moe.MoELayer(gate, experts, axis=("ep", "tp"),
                           mesh=make_mesh(MeshSpec(ep=2, tp=2), device=dev)),
              moe.MoELayer(gate, experts,
                           mesh=make_mesh(MeshSpec(ep=4), device=dev))]
    for layer in layers:    # warm-up: the times are a second call's
        run(layer)
    hier, flat = (run(layer) for layer in layers)
    same = (torch.equal(hier[0], flat[0]) and torch.equal(hier[1], flat[1])
            and all(torch.equal(a, b) for a, b in zip(hier[3], flat[3])))
    one = moe.MoELayer(gate, experts)
    with torch.no_grad():
        parts = [one(s) for s in x.chunk(4)]
    ref = torch.cat([p[0] for p in parts])
    ref_aux = sum(p[1] for p in parts) / 4
    y_err = ((hier[0] - ref).abs().max() / ref.abs().max()).item()
    a_err = abs(float(hier[1]) - float(ref_aux)) / abs(float(ref_aux))
    a2a = hier[5].get("all_to_all", {})
    print(f"(b) hierarchical exchange over (ep, tp) on MeshSpec(ep=2, "
          f"tp=2), d {d}, {E} experts, hidden {4 * d}, top-2, capacity "
          f"factor 1.25, {T} tokens: forward and backward bitwise the flat "
          f"ep=4 layer's: {same}; y {y_err:.3e}, aux {a_err:.3e} relative "
          f"to four single-group calls (tol {MOE_TOL:g}); overflow "
          f"{float(hier[2]['overflow_frac']):.4f}; {a2a.get('calls', 0)} "
          f"exchanges, {a2a.get('bytes', 0)} bytes; forward + backward "
          f"{hier[4]:.1f} ms (flat {flat[4]:.1f}), a second call; {card}")
    return {"same": same, "y_err": y_err, "aux_err": a_err,
            "ms": hier[4], "a2a": a2a}


def ep_digest(sh):
    """Each held rank's step-0 gradients as digests of their bytes, keyed
    by the rank's ep coordinate and the parameter."""
    import hashlib
    return {f"{c['ep']}:{name}": hashlib.sha1(
        p.grad.detach().float().cpu().numpy().tobytes()).hexdigest()
        for c, m in zip(sh.coords, sh.models)
        for name, p in m.named_parameters()}


def ep_two_rank_run(cfg, dev, mesh, ids):
    """An ep = 2 run of config B's model without sp on ``mesh`` (local or
    over processes), the flash core: ``EP_STEPS`` steps with their
    losses and times, step 0's gradient digests and the collectives a
    step."""
    from hetu_tpu_torch.ops.kernels.flash import flash_attn_fn
    from hetu_tpu_torch.parallel import collectives as col
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    tr = ep_trainer(cfg, dev, mesh, flash_attn_fn(native_layout=True))
    losses, times, digest = [], [], None
    col.reset_counts()
    with col.timed():
        for _ in range(EP_STEPS):
            sync()
            t0 = time.monotonic()
            losses.append(float(tr.step(ids)["loss"]))
            sync()
            times.append(time.monotonic() - t0)
            digest = digest or ep_digest(tr._sharded)
    kinds = {k: {"calls": v["calls"] // EP_STEPS,
                 "bytes": v["bytes"] // EP_STEPS,
                 "ms": v["s"] * 1e3 / EP_STEPS,
                 "composed": v["composed"] // EP_STEPS}
             for k, v in col.counts().items()}
    del tr
    return {"losses": losses, "digest": digest,
            "step_ms": [t * 1e3 for t in times], "kinds": kinds}


def ep_ids(cfg, dev, rows):
    return torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (rows, cfg.max_seq_len))).to(dev)


def ep_worker(rank, nproc, coord, dev, cfg_kw):
    """(c) one process of two: joins a gloo world, its tensors on ``dev``
    (the shared card), ep = 2 over the process mesh (this process one ep
    rank and its ``EP_PROC_BATCH`` rows); prints one ``EXPPAR`` JSON
    line."""
    import datetime

    import torch.distributed as dist
    from hetu_tpu_torch.models.moe_lm import MoELMConfig
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev == "cpu":
        torch.set_num_threads(1)   # one summation order, as the rehearsal
    dist.init_process_group("gloo", init_method=f"tcp://{coord}",
                            world_size=nproc, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    cfg = MoELMConfig(**cfg_kw)
    mesh = make_mesh(MeshSpec(ep=nproc), device=dev, processes=True)
    out = ep_two_rank_run(cfg, dev, mesh,
                          ep_ids(cfg, dev, EP_PROC_BATCH * nproc))
    print("EXPPAR " + json.dumps({"rank": rank, "run": out}), flush=True)
    dist.destroy_process_group()
    return 0


def ep_processes(cfg, card, dev):
    """(c) ep = 2 across two processes of this script over gloo, against
    the same run on a local ep = 2 mesh: losses and every step-0
    gradient digest bitwise, the exchanges' calls, bytes and ms."""
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    t0 = time.monotonic()
    local = ep_two_rank_run(cfg, dev, make_mesh(MeshSpec(ep=2), device=dev),
                            ep_ids(cfg, dev, EP_PROC_BATCH * 2))
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("dtype", "remat")}
    outs, rcs = st_spawn(
        lambda r, port: ["--ep-worker", str(r), "2", f"127.0.0.1:{port}",
                         dev, json.dumps(cfg_kw)], 2, 600)
    rows = sorted(st_lines(outs, "EXPPAR"), key=lambda r: r["rank"])
    assert rcs == [0, 0] and len(rows) == 2, (rcs, [o[-3000:] for o in outs])
    a, b = (r["run"] for r in rows)
    same = all(r["run"]["digest"][k] == local["digest"][k]
               for r in rows for k in r["run"]["digest"])
    print(f"(c) ep=2, two processes, gloo, tensors on the one card, "
          f"{EP_PROC_BATCH} x {cfg.max_seq_len} rows a process: losses "
          f"{a['losses']} and {b['losses']}; local ep=2 {local['losses']}; "
          f"bitwise equal: {a['losses'] == local['losses']}; every step-0 "
          f"gradient of both processes bitwise the local arm's: {same}; "
          f"step ms {[round(t, 1) for t in a['step_ms']]} (local "
          f"{[round(t, 1) for t in local['step_ms']]}); a step: "
          + "; ".join(f"{k} {v['calls']} calls ({v['composed']} composed "
                      f"from all_reduce), {v['bytes']} bytes, "
                      f"{v['ms']:.1f} ms" for k, v in
                      sorted(a["kinds"].items()))
          + f" (gloo through host memory on one card, not a link); in "
          f"{time.monotonic() - t0:.1f} s; {card}")
    assert a["losses"] == local["losses"] == b["losses"], \
        (a["losses"], b["losses"], local["losses"])
    # step 0's loss precedes the gradients and AdamW nearly ignores a
    # common scale: the digests hold an expert slice counted twice
    assert same, "the step-0 gradients differ from the local ep=2 arm's"
    assert a["kinds"].get("all_to_all", {}).get("calls", 0) > 0, a["kinds"]
    assert a["losses"][-1] < a["losses"][0], a["losses"]
    return {"proc": a, "local": local, "grads_same": same}


def gcn15_graph(n, dev, seed=3):
    """A stochastic-block graph of ``n`` nodes at ogbn-arxiv's density
    (``arxiv_sbm``'s recipe: 40 blocks, 80% of the edges inside one),
    the normalized dense adjacency on ``dev``, the features and labels."""
    from hetu_tpu_torch.models.gnn import dense_adjacency, normalize_adjacency
    rng = np.random.default_rng(seed)
    e = n * ARXIV_EDGES // ARXIV_NODES
    y = rng.integers(0, ARXIV_CLASSES, n)
    order = np.argsort(y, kind="stable")
    counts = np.bincount(y, minlength=ARXIV_CLASSES)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    src = rng.integers(0, n, e)
    same = rng.random(e) < 0.8
    pick = starts[y[src]] + (rng.random(e) * counts[y[src]]).astype(np.int64)
    dst = np.where(same, order[pick], rng.integers(0, n, e))
    edges = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
    ei, w = normalize_adjacency(edges, n, device=dev)
    a = dense_adjacency(ei, w, n)
    centroids = rng.standard_normal((ARXIV_CLASSES, ARXIV_FEATS))
    x = (centroids[y] + rng.standard_normal((n, ARXIV_FEATS))).astype(
        np.float32)
    return a, torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), e


def gcn15_check(card, dev="cuda", n=GCN15_NODES):
    """(d) ``DistGCN15D(128, 256, 40, num_layers=3)`` on a local gr=2 x
    gc=2 mesh over ``gcn15_graph(n)``: forward and step-0 gradients
    against the dense oracle ``A @ (x W) + b`` with the same weights (the
    biases seeded, so the oracle sees where they are added), then
    ``GCN15_STEPS`` Adam steps with a falling loss."""
    from hetu_tpu_torch import AdamOptimizer, Trainer
    from hetu_tpu_torch.models import DistGCN15D
    from hetu_tpu_torch.ops import softmax_cross_entropy_sparse
    from hetu_tpu_torch.parallel import make_grid_mesh
    from hetu_tpu_torch.parallel import collectives as col
    t0 = time.monotonic()
    a, x, y, e = gcn15_graph(n, dev)
    mesh = make_grid_mesh({"gr": 2, "gc": 2}, device=dev)
    model = DistGCN15D(ARXIV_FEATS, GCN_HIDDEN, ARXIV_CLASSES, mesh,
                       num_layers=3, generator=torch.Generator().manual_seed(5),
                       device=dev)
    with torch.no_grad():
        g = torch.Generator().manual_seed(6)
        for b in model.bs:
            b.copy_(torch.randn(b.shape, generator=g))

    def loss_of(logits):
        return softmax_cross_entropy_sparse(logits, y).mean()

    col.reset_counts()
    out = model(a, x)
    loss = loss_of(out)
    loss.backward()
    gathers = col.counts().get("all_gather", {})
    ws = [p.detach().clone().requires_grad_() for p in model.parameters()]
    h = x
    n_layers = len(model.ws)
    for i, (w, b) in enumerate(zip(ws[:n_layers], ws[n_layers:])):
        h = a @ (h @ w) + b
        if i < n_layers - 1:
            h = torch.relu(h)
    ref_loss = loss_of(h)
    ref_loss.backward()
    f_err = ((out - h).abs().max() / h.abs().max()).item()
    worst = max(((p.grad - r.grad).abs().max()
                 / r.grad.abs().max().clamp_min(1e-30)).item()
                for p, r in zip(model.parameters(), ws))
    del h, ws, out
    trainer = Trainer(model, AdamOptimizer(GCN_LR),
                      lambda m, b, k: (loss_of(m(a, x)), {}))
    losses = [float(trainer.step(None)["loss"]) for _ in range(GCN15_STEPS)]
    print(f"(d) DistGCN15D({ARXIV_FEATS}, {GCN_HIDDEN}, {ARXIV_CLASSES}, 3 "
          f"layers) on gr=2 x gc=2, a stochastic-block graph of {n} nodes "
          f"and {e} undirected edges (dense fp32 adjacency {a.numel() * 4} "
          f"bytes): forward {f_err:.3e}, worst step-0 gradient "
          f"{worst:.3e} of its max against A @ (x W) + b (tol "
          f"{GCN15_TOL:g}); loss {float(ref_loss):.6f}; "
          f"{gathers.get('calls', 0)} gathers of the partial products over "
          f"gc ({gathers.get('bytes', 0)} bytes) a forward; Adam "
          f"{GCN15_STEPS} steps {[round(v, 5) for v in losses]}; in "
          f"{time.monotonic() - t0:.1f} s; {card}")
    del trainer, model, a
    return {"f_err": f_err, "grad_rel": worst, "losses": losses}


def ep_phase(fl, card, dev="cuda", cfg=None, hier_tokens=MOE_GATE_T,
             gcn_nodes=GCN15_NODES):
    """Phase 23: (a) config B at config 3's widths on a local dp2 ep2 sp2
    mesh against the ep=2 flash path, with the control; (b) the
    hierarchical exchange; (c) ep=2 across two processes; (d) the 1.5D
    GCN; then the block and flash pairs at (a)'s shapes.  Returns the
    rows the summary needs."""
    from hetu_tpu_torch.models.moe_lm import MoELMConfig
    from hetu_tpu_torch.parallel import collectives as col
    t_start = time.monotonic()
    cfg = cfg or MoELMConfig(**EP_CFG)
    ids = ep_ids(cfg, dev, EP_BATCH)
    rows = {"a": ep_config_b(cfg, ids, fl, col, card, dev)}
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    rows["b"] = ep_hier_check(cfg, card, dev, hier_tokens)
    rows["c"] = ep_processes(cfg, card, dev)
    rows["d"] = gcn15_check(card, dev, gcn_nodes)
    r = rows["a"]
    assert r["rel"] <= EP_TOL and r["grad_rel"] <= EP_GRAD_TOL, r
    assert r["same"], "a replica's gradients differ from its group's"
    assert r["control"]["right"] <= EP_TOL, r["control"]
    assert r["control"]["own"] > EP_TOL, \
        "the step-0 check cannot tell each rank routing its own piece"
    assert r["losses"][-1] < r["losses"][0], r["losses"]
    if dev == "cuda":
        # 4 (dp, ep) groups x 3 visits of a causal sp=2 ring x L layers
        ring = 12 * cfg.num_layers
        assert all(s[:4] == (ring, ring, 0, 0) for s in r["per_step"]), \
            r["per_step"]
        assert r["ref_launches"] == (cfg.num_layers, cfg.num_layers), r
    b = rows["b"]
    assert b["same"], "the (ep, tp) exchange differs from the flat ep=4 one"
    assert b["y_err"] <= MOE_TOL and b["aux_err"] <= MOE_TOL, b
    d = rows["d"]
    assert d["f_err"] <= GCN15_TOL and d["grad_rel"] <= GCN15_TOL, d
    assert d["losses"][-1] < d["losses"][0], d["losses"]
    out = {"arms": rows}
    if dev == "cuda":
        gen = torch.Generator().manual_seed(23)
        flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        hd = cfg.hidden_size // cfg.num_heads
        out["block"] = check_flash_block(
            fl, flush, torch.float32, gen,
            shape=(EP_BATCH // 4, cfg.num_heads, cfg.max_seq_len, hd), sp=2)
        out["flash"] = check_flash(fl, flush, torch.float32,
                                   cfg.max_seq_len, gen, timed=True,
                                   B=EP_BATCH, H=cfg.num_heads)
        del flush
        torch.cuda.empty_cache()
    return out, time.monotonic() - t_start


def main() -> int:
    if sys.argv[1:2] == ["--ps-dp-worker"]:
        # phase 14 (c)'s worker processes: rank, port, device, batch
        rank, port, dev, batch = sys.argv[2:6]
        if dev == "cuda" and not torch.cuda.is_available():
            return 2
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return psdp_worker(int(rank), int(port), dev, int(batch))
    if sys.argv[1:2] == ["--strategy-worker"]:
        # phase 20 (c)'s two processes: rank, world, coordinator, device,
        # the GPT config
        rank, n, coord, dev, cfg_kw = sys.argv[2:7]
        if dev == "cuda" and not torch.cuda.is_available():
            return 2
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return st_worker(int(rank), int(n), coord, dev, json.loads(cfg_kw))
    if sys.argv[1:2] == ["--pipeline-worker"]:
        # phase 21 (f)'s two processes: rank, world, coordinator, device,
        # the GPT config
        rank, n, coord, dev, cfg_kw = sys.argv[2:7]
        if dev == "cuda" and not torch.cuda.is_available():
            return 2
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return pp_worker(int(rank), int(n), coord, dev, json.loads(cfg_kw))
    if sys.argv[1:2] == ["--sp-worker"]:
        # phase 22 (e)'s two processes: rank, world, coordinator, device,
        # the GPT config
        rank, n, coord, dev, cfg_kw = sys.argv[2:7]
        if dev == "cuda" and not torch.cuda.is_available():
            return 2
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return sp_worker(int(rank), int(n), coord, dev, json.loads(cfg_kw))
    if sys.argv[1:2] == ["--ep-worker"]:
        # phase 23 (c)'s two processes: rank, world, coordinator, device,
        # the MoE LM config
        rank, n, coord, dev, cfg_kw = sys.argv[2:7]
        if dev == "cuda" and not torch.cuda.is_available():
            return 2
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return ep_worker(int(rank), int(n), coord, dev, json.loads(cfg_kw))
    if sys.argv[1:2] in (["--nccl-world"], ["--nccl-pair"]):
        if not torch.cuda.is_available():
            return 2
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        if sys.argv[1] == "--nccl-world":
            return st_nccl_world(int(sys.argv[2]))
        return st_nccl_pair(int(sys.argv[2]), int(sys.argv[3]))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hetu_tpu_torch import GPT, ServingEngine, gpt2_small
    from hetu_tpu_torch.models import gpt as gpt_mod
    from hetu_tpu_torch.ops.kernels import _build
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.ops.kernels import flash as fl
    from hetu_tpu_torch.ops.kernels import fused_ln as fln
    from hetu_tpu_torch.ops.kernels import lm_head as lh
    from hetu_tpu_torch.ops.kernels import lm_head_ce as ce
    from hetu_tpu_torch.ops.kernels import paged_decode as pd
    from hetu_tpu_torch.serve import kv_cache as kvc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {kind} count {count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)

    phase("2 build")
    t0 = time.monotonic()
    _build.load_library()
    print(f"kernels built and loaded in {time.monotonic() - t0:.2f} s "
          f"from {_build.SRC_DIR}")
    for line in _build.build_log().splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:   # the mangled name, its anonymous-namespace prefix cut
            print("  " + re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+",
                                "", entry.group(1))[:100])
        elif "registers" in line or "spill" in line or "==" in line:
            print("  " + line.strip())

    phase("3 kernels vs plain")
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pd_rows = {dt: check_paged_decode(pd, flush, dt, gen)
               for dt in (torch.float32, torch.bfloat16)}
    serve_lens = [len(p) for p in serve_prompts(gpt2_small().vocab_size)]
    pd_rows[torch.float32].update(
        time_paged_decode_serve(pd, flush, torch.Generator().manual_seed(7),
                                serve_lens))
    lm_rows = {(dt, k): check_lm_head(lh, flush, dt, k, gen)
               for dt in (torch.float32, torch.bfloat16) for k in (1, 5)}
    check_rng(flush)
    check_sample_tokens(lh)
    fl_rows = {dt: check_flash(fl, flush, dt, 1024, gen, timed=True)
               for dt in (torch.float32, torch.bfloat16)}
    check_flash(fl, flush, torch.float32, 1000, gen, timed=False)
    fl512 = check_flash(fl, flush, torch.bfloat16, BERT512_SEQ, gen,
                        timed=True, B=BERT512_BATCH, H=16, causal=False)
    blk_rows = {dt: check_flash_block(fl, flush, dt, gen)
                for dt in (torch.float32, torch.bfloat16)}
    ce_rows = {dt: check_lm_head_ce(ce, flush, dt, gen, smi)
               for dt in (torch.float32, torch.bfloat16)}
    fln_rows = {dt: check_fused_ln(fln, prng, flush, dt, gen)
                for dt in (torch.float32, torch.bfloat16)}
    del flush
    torch.cuda.empty_cache()

    phase("4 engine: GPT-2 small")
    cfg = gpt2_small()
    t0 = time.monotonic()
    model = GPT(cfg, generator=torch.Generator().manual_seed(0))
    print(f"model: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
          f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"built in {time.monotonic() - t0:.2f} s")
    prompts = serve_prompts(cfg.vocab_size)
    budget = SERVE_BUDGET

    def engine(**kw):
        return ServingEngine(model, num_slots=SERVE_SLOTS, page_size=16,
                             **kw)

    def eager_engine(**kw):
        """The same engine with its paged step run eagerly (the graph
        dropped), for the profile's comparison only."""
        eng = engine(**kw)
        eng._decode_graph = None
        return eng

    warm = engine()
    warm.submit(prompts[0][:5], max_new_tokens=2)
    warm.run_until_idle()
    del warm
    eng = engine()
    # the parameters are trainable: every module call of the serving run
    # must see autograd off, and the pools must stay out of any graph
    grad_modes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: grad_modes.append(torch.is_grad_enabled()))
        for m in model.modules()]
    torch.cuda.synchronize()
    pd.reset_launch_count()
    lh.reset_launch_count()
    kvc.reset_gather_view_count()
    t0 = time.monotonic()
    handles = [eng.submit(p, max_new_tokens=budget) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for hk in hooks:
        hk.remove()
    assert all(p.requires_grad for p in model.parameters())
    assert grad_modes and not any(grad_modes), "serving ran with autograd on"
    assert not (eng.pool.k.requires_grad or eng.pool.v.requires_grad)
    print(f"no autograd graph: {len(grad_modes)} module calls, all with "
          f"grad off; pools require no grad")
    launches = {"paged_decode_attention": pd.launch_count(),
                "lm_head_sample": lh.launch_count()}
    views = kvc.gather_view_count()
    st = eng.stats()
    bad = [(h.request_id, h.status, h.error) for h in handles
           if h.status != "completed" or len(h.tokens) != budget]
    assert not bad, f"requests not completed: {bad}"
    assert all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens)
    steps = st["decode_steps"]
    print(f"launches {launches}, decode steps {steps}, prefills "
          f"{st['prefills']}, contiguous views {views}")
    assert launches["paged_decode_attention"] == cfg.num_layers * steps > 0
    assert steps == len(serve_decode_lengths(serve_lens)), \
        "phase 3 timed paged decode at other lengths than this run's"
    assert launches["lm_head_sample"] == steps > 0
    assert views == len(prompts), "decode built a contiguous K/V view"
    ttft = sorted(h.ttft_s for h in handles)
    print(f"served {len(handles)} requests, {st['tokens']} tokens in "
          f"{wall:.3f} s: {st['tokens'] / wall:.1f} tokens/s; median decode "
          f"step {st['decode_step_s_p50'] * 1e3:.3f} ms; TTFT p50 "
          f"{statistics.median(ttft) * 1e3:.2f} ms max {ttft[-1] * 1e3:.2f}"
          f" ms (8 slots, prompts 5-128 tokens, {budget} new tokens each)")

    assert eng._decode_graph.captured
    greedy_profile = (profile_decode(engine, prompts, "greedy, graph"),
                      profile_decode(eager_engine, prompts, "greedy, eager"))
    check_replay(engine, prompts, budget)

    probe = 11   # admitted in the second wave, into a reused slot
    alone = engine()
    h = alone.submit(prompts[probe], max_new_tokens=budget)
    alone.run_until_idle()
    assert h.tokens == handles[probe].tokens, \
        "stream served alone differs from the batched stream"
    print(f"batch invariance: request {probe} alone == batched "
          f"({budget} tokens, bitwise)")

    gather = engine(paged_decode=False, fused_sampling=False)
    gh = [gather.submit(p, max_new_tokens=budget) for p in prompts]
    gather.run_until_idle()
    same = sum(a.tokens == b.tokens for a, b in zip(handles, gh))
    first_diff = [next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                        if x != y), budget) for a, b in zip(handles, gh)]
    print(f"info: kernel path vs gather path (paged_decode=False, "
          f"fused_sampling=False): {same}/{len(gh)} streams identical, "
          f"mean first divergence at token "
          f"{statistics.mean(first_diff):.1f} of {budget}")

    cpu_model = copy.deepcopy(model).cpu()
    ref, logits = reference_greedy(cpu_model, prompts[0], 8)
    got = handles[0].tokens[:8]
    agreed = 0
    for t, (r, g) in enumerate(zip(ref, got)):
        if r == g:
            agreed += 1
            continue
        gap = float(logits[t][r] - logits[t][g])
        assert gap < 1e-3, (f"token {t}: engine chose {g}, CPU reference "
                            f"{r} with logit gap {gap}")
        break
    print(f"reference: first {agreed}/8 tokens of request 0 equal a CPU "
          f"full-recompute greedy run (any divergence only at a near-tie)")
    with torch.no_grad():
        ids = torch.tensor([prompts[0]])
        full_gpu = model(ids.cuda()).cpu()
        full_cpu = cpu_model(ids)
    lerr = (full_gpu - full_cpu).abs().max().item()
    print(f"reference: GPU vs CPU full-sequence logits max_abs_err "
          f"{lerr:.3e} tol 1e-3")
    assert torch.isfinite(full_gpu).all() and lerr <= 1e-3
    pre = prefill_alone_ms(engine, prompts[1])
    print("info: a one-token request alone (prefill, products in blocks of "
          "one page): " + ", ".join(f"{n} tokens {ms:.3f} ms"
                                    for n, ms in pre.items()))

    del cpu_model, eng, alone, gather
    modes = {m: serve_mode(engine, eager_engine, prompts, budget, cfg, pd,
                           lh, m) for m in ("temperature", "top_k")}
    modes["greedy"] = {"steps": steps, "tokens_per_s": st["tokens"] / wall,
                       "median_step_ms": st["decode_step_s_p50"] * 1e3,
                       "graph": greedy_profile[0],
                       "eager": greedy_profile[1]}
    for m, r in modes.items():
        busy = [("not measured" if b is None else
                 f"{b:.3f} ms busy of {ms:.3f} ({b / ms:.1%})")
                for ms, b in (r["graph"], r["eager"])]
        print(f"decode step {m}: graph {busy[0]}, eager {busy[1]}; "
              f"{r['tokens_per_s']:.1f} tokens/s, median step "
              f"{r['median_step_ms']:.3f} ms over the 16-request run")
    del model
    torch.cuda.empty_cache()

    phase("5 train: GPT-2 small")
    train_launches, flash_losses = train_phase(fl, ce, gpt_mod, smi)

    phase("6 train: BERT-large")
    bert_launches = bert_phase(fln, smi)

    phase("7 train: GPT-2 small, ring sp=4")
    ring_launches = ring_phase(fl, ce, gpt_mod, smi, flash_losses)

    phase("8 train: BERT-large, seq 512")
    bert512_launches = bert512_phase(fl, fln, smi)

    phase("9 train: Wide&Deep CTR with the HET host-embedding cache")
    ctr_phase(smi)

    phase("10 train: MoE LM (bench.py config 3)")
    moe_launches, moe_flash = moe_phase(fl, smi)

    phase("11 train: vision (bench.py config 1, ViT-B/16, Swin-T)")
    vit_launches, vit_flash = vision_phase(fl, smi)

    phase("12 train: T5-base, the LSTM and GRU classifiers, GCN on "
          "ogbn-arxiv's size")
    seq_graph_phase(smi)

    phase("13 train: Wide&Deep on Criteo Kaggle's vocabulary through the "
          "compression suite")
    cmp_rows, cmp_s = cmp_phase(smi)
    print(f"phase 13 in {cmp_s:.1f} s; " + "; ".join(
        f"{arm} {r['median_ms']:.3f} ms ({r['ratio']:.1f}x)"
        for arm, r in cmp_rows.items()))

    phase("14 the distributed embedding path: Wide&Deep over the network "
          "PS, snapshots to serving replicas, PS data parallelism, the "
          "graph server")
    ps_rows, ps_s = ps_phase(smi)
    st = ps_rows["stream"]
    print(f"phase 14 in {ps_s:.1f} s; PS step {st['median_ms']:.3f} ms, "
          f"full snapshot {st['full_publish_s']:.2f} s, infer_ctr p50 "
          f"{st['bound0']['p50_ms']:.3f} / {st['bound2']['p50_ms']:.3f} ms "
          f"(bounds 0 / 2), re-anchor {st['reanchor_s'][0]:.2f} s; PS-DP "
          f"step {ps_rows['psdp']['median_ms']:.3f} ms; graph sample "
          f"{ps_rows['graph']['sample_ms']:.3f} ms, step "
          f"{ps_rows['graph']['step_ms']:.3f} ms")

    phase("15 serving fleet: GPT-2 small as tenants, prefix sharing, "
          "speculative decoding, a router, disaggregated prefill/decode, "
          "failover, defrag and HTTP")
    fleet_rows, fleet_s = fleet_phase(pd, lh, smi)
    sp = fleet_rows["spec"]
    print(f"phase 15 in {fleet_s:.1f} s; verify step "
          f"{sp['greedy']['verify_ms']:.3f} ms vs plain step "
          f"{sp['greedy']['plain_step_ms']:.3f} ms; fleet "
          f"{fleet_rows['router']['fleet_tps'][0]:.1f} vs one replica "
          f"{fleet_rows['router']['one_tps']:.1f} tokens/s; migration "
          f"{fleet_rows['disagg']['mb']:.2f} MB, export "
          f"{fleet_rows['disagg']['export_ms']:.3f} ms, import "
          f"{fleet_rows['disagg']['import_ms']:.3f} ms")

    phase("16 survival: GPT-2 small through faults (ResilientTrainer, "
          "the elastic gang, partial reduce, the runtime controller) and "
          "ResNet-18's anomaly policy")
    # phases 16 and 18 run GPT-2 small at full width and CUT_LAYERS of
    # its 12 layers (PERF.md section 4: the script's time limit)
    cut = gpt2_small(streamed_head_chunk=1024, num_layers=CUT_LAYERS)
    surv, surv_s = survival_phase(fl, ce, smi, cfg=cut)
    r, p = surv["resilient"], surv["partial"]
    print(f"phase 16 in {surv_s:.1f} s; repeatability needed "
          f"{surv['repeat']} (GPT-2), {surv['resnet']['repeat']} "
          f"(ResNet-18); save stall {[round(x, 1) for x in r['stall_ms']]}"
          f" ms, write {[round(x, 1) for x in r['save_ms']]} ms, resume "
          f"{r['resume_ms']:.1f} ms, guard overhead "
          f"{r['guarded_ms'] - r['bare_ms']:+.3f} ms a step; gang compose "
          f"{[round(x, 1) for x in surv['elastic']['compose_ms']]} ms, "
          f"rescale {[round(x, 1) for x in surv['elastic']['rescale_ms']]}"
          f" ms; sim_time {p['sim_time'][0]} (deadline 1.0) vs "
          f"{p['sim_time'][1]} (inf); {smi}")

    phase("17 accounting: the HBM ledger, the autotune database, the "
          "profiler and the calibration store on GPT-2 small's serve and "
          "train paths and the tiered Wide&Deep arm")
    acct, acct_s = accounting_phase(pd, lh, fl, ce, smi)
    tr = acct["train"]
    print(f"phase 17 in {acct_s:.1f} s; tuned paged-decode head block "
          f"{acct['tuned']} (fp32), breakdown {tr['totals']['device_s'] * 1e3:.3f}"
          f" ms a train step vs union {tr.get('union_ms', float('nan')):.3f} "
          f"ms; {smi}")

    phase("18 planning, offload and interchange: GPT-2 small's memory plan "
          "and offload_dots, BERT-base GLUE fine-tuning, GPT-2 small's ONNX "
          "round trip")
    plan18, plan18_s = planning_phase(smi, cfg=cut)
    pa, po = plan18["plan"], plan18["offload"]["arms"]
    print(f"phase 18 in {plan18_s:.1f} s; plan {pa['plan'].policy} @ "
          f"{pa['plan'].microbatch} under {pa['budget']} bytes (peak "
          f"{pa['run']['peak']}); offload_dots step "
          f"{po['offload_dots']['step_ms']:.1f} ms vs dots_no_batch "
          f"{po['dots_no_batch']['step_ms']:.1f} ms; GLUE sst2 step "
          f"{plan18['glue']['sst2']['step_ms']:.2f} ms; ONNX rel err "
          f"{plan18['onnx']['rel_err']:.3e}; {smi}")

    phase("19 planning and brokering on the card: profile -> plan -> "
          "train, plan -> fleet, the broker's day")
    pb, pb_s = broker_plan_phase(pd, lh, fl, smi)
    print(f"phase 19 in {pb_s:.1f} s; sustained bf16 "
          f"{pb['train']['sustained'] / 1e12:.1f} TFLOP/s; planned/stock "
          f"{pb['fleet']['ratio']:.4f} tokens/tick; broker joint dominance "
          f"{pb['broker']['dominance']:.4f}; {smi}")

    phase("20 strategies: GPT-2 small under DataParallel, ZeRO 1 and 3 and "
          "Megatron TP on a local mesh, the CE kernels on a vocabulary "
          "shard, two processes over gloo, a one-rank NCCL world, "
          "plan_to_strategy")
    st, st_s = strategy_phase(fl, ce, gpt_mod, smi, train_losses=flash_losses,
                              cluster=pb["train"]["cluster"])
    arms = st["arms"]
    print(f"phase 20 in {st_s:.1f} s; median step ms " + ", ".join(
        f"{ST_ARMS[a]} {r['step_ms']:.1f}" for a, r in arms.items())
        + f"; two processes {statistics.median(st['proc']['proc']['step_ms']):.1f}"
        f" ms a step, gradient all-reduce {st['proc']['proc']['allreduce_ms']:.1f}"
        f" ms; plan {st['plan']['plan']}; {smi}")

    phase("21 pipelines: GPT-2 small through GPipe on a local pp=4 mesh, "
          "config A's dp x tp x pp with ZeRO-1, interleaved 1F1B, "
          "asynchronous PipeDream and HetPipe, heterogeneous dp, GPipe "
          "across two processes")
    pp, pp_s = pipeline_phase(fl, ce, gpt_mod, smi)
    pa = pp["arms"]
    print(f"phase 21 in {pp_s:.1f} s; median step ms GPipe pp=4 remat none "
          f"{pa['none']['step_ms']:.1f}, full {pa['full']['step_ms']:.1f}, "
          f"dp2 tp2 pp2 {pa['config_a']['step_ms']:.1f}; 1F1B V=3 grads "
          f"{pa['pipedream']['sync']['ms']:.1f} ms; two processes "
          f"{statistics.median(pa['proc']['step_ms']):.1f} ms a step; {smi}")
    pl = pp["launches"]
    mb = tuple(a + c for a, c in zip(pl["a"], pl["cde"]))

    phase("22 sequence parallelism: GPT-2 small on a local dp=2 sp=2 tp=2 "
          "mesh with the heads over tp (config G), the blockwise core and "
          "Ulysses there, the sp=4 dp=2 mesh without a strategy, sp=2 "
          "across two processes")
    sq, sq_s = sp_phase(fl, ce, gpt_mod, smi, flash_losses, ce_rows=st["ce"])
    sa = sq["arms"]
    print(f"phase 22 in {sq_s:.1f} s; median step ms config G "
          f"{sa['a']['step_ms']:.1f}, blockwise {sa['b']['step_ms']:.1f}, "
          f"Ulysses {sa['c']['step_ms']:.1f}; two processes ring "
          f"{statistics.median(sa['proc']['ring']['proc']['step_ms']):.1f}"
          f", Ulysses "
          f"{statistics.median(sa['proc']['ulysses']['proc']['step_ms']):.1f}"
          f" ms a step; {smi}")
    sl = sq["launches"]
    sp_timed = ("mean per launch of one causal sp=2 layer: 2 diagonal "
                "(causal) + 1 past (unmasked) visits at a dp2 sp2 tp2 rank's "
                "chunk (4, 6, 512, 64)")

    phase("23 expert parallelism: config B (a MoE LM with the ring over a "
          "local dp=2 ep=2 sp=2 mesh) at bench.py config 3's widths, the "
          "hierarchical (ep, tp) exchange, ep=2 across two processes, the "
          "1.5D GCN")
    ex, ex_s = ep_phase(fl, smi)
    ea = ex["arms"]
    print(f"phase 23 in {ex_s:.1f} s; config B median step "
          f"{ea['a']['step_ms']:.1f} ms, peak {ea['a']['peak'] / 2**30:.2f} "
          f"GiB; two processes "
          f"{statistics.median(ea['c']['proc']['step_ms']):.1f} ms a step; "
          f"{smi}")
    el = tuple(map(sum, zip(*ea["a"]["per_step"])))
    ep_timed = ("mean per launch of one causal sp=2 layer: 2 diagonal "
                "(causal) + 1 past (unmasked) visits at a dp2 ep2 sp2 "
                "rank's chunk (8, 16, 128, 64)")

    phase("24 summary")
    f32, bf16 = torch.float32, torch.bfloat16
    kernels = [
        dict(name="paged_decode_attention", route="cuda",
             source="hetu_tpu_torch/csrc/paged_decode.cu",
             replaces="hetu_tpu/ops/pallas/paged_decode.py:59",
             launches=launches["paged_decode_attention"], **pd_rows[f32]),
        dict(name="lm_head_sample", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_sample.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:346",
             launches=launches["lm_head_sample"], **lm_rows[(f32, 1)]),
        dict(name="flash_fwd", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:191",
             launches=train_launches["flash_fwd"], **fl_rows[f32][0]),
        dict(name="flash_bwd", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:462",
             launches=train_launches["flash_bwd"], **fl_rows[f32][1]),
        dict(name="lm_head_ce_fwd", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:177",
             launches=train_launches["lm_head_ce_fwd"], **ce_rows[f32][0]),
        dict(name="lm_head_ce_bwd", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:202",
             launches=train_launches["lm_head_ce_bwd"], **ce_rows[f32][1]),
        dict(name="fused_ln_fwd", route="cuda",
             source="hetu_tpu_torch/csrc/fused_ln.cu",
             replaces="hetu_tpu/ops/pallas/fused_ln.py:122",
             launches=bert_launches["fused_ln_fwd"], **fln_rows[bf16][0]),
        dict(name="fused_ln_bwd", route="cuda",
             source="hetu_tpu_torch/csrc/fused_ln.cu",
             replaces="hetu_tpu/ops/pallas/fused_ln.py:147",
             launches=bert_launches["fused_ln_bwd"], **fln_rows[bf16][1]),
        dict(name="flash_block_fwd", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:608",
             launches=ring_launches["flash_block_fwd"],
             **ring_mix(blk_rows[f32], 0)),
        dict(name="flash_block_bwd", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:619",
             launches=ring_launches["flash_block_bwd"],
             **ring_mix(blk_rows[f32], 1)),
        dict(name="flash_fwd_one_kv_block", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:168",
             path="BERT-large seq 512 (phase 8)",
             launches=bert512_launches["flash_fwd"], **fl512[0]),
        dict(name="flash_bwd_one_kv_block", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:358",
             path="BERT-large seq 512 (phase 8)",
             launches=bert512_launches["flash_bwd"], **fl512[1]),
        dict(name="flash_fwd_one_kv_block_moe", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:168",
             path="MoE LM, bench.py config 3, flash arm (phase 10)",
             launches=moe_launches["flash_fwd"], **moe_flash[0]),
        dict(name="flash_bwd_one_kv_block_moe", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:358",
             path="MoE LM, bench.py config 3, flash arm (phase 10)",
             launches=moe_launches["flash_bwd"], **moe_flash[1]),
        dict(name="flash_fwd_one_kv_block_vit", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:168",
             path="ViT-B/16, flash arm (phase 11)",
             launches=vit_launches["flash_fwd"], **vit_flash[0]),
        dict(name="flash_bwd_one_kv_block_vit", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:358",
             path="ViT-B/16, flash arm (phase 11)",
             launches=vit_launches["flash_bwd"], **vit_flash[1]),
        dict(name="flash_fwd_rank", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:191",
             path="strategies on a local mesh, timed at tp=4's rank shape "
                  "B=8 H=3 (phase 20)",
             launches=st["launches"]["flash_fwd"], **st["flash"][0]),
        dict(name="flash_bwd_rank", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:462",
             path="strategies on a local mesh, timed at tp=4's rank shape "
                  "B=8 H=3 (phase 20)",
             launches=st["launches"]["flash_bwd"], **st["flash"][1]),
        dict(name="lm_head_ce_fwd_vocab_shard", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:177",
             path="strategies on a local mesh, timed on tp=2's vocabulary "
                  "shard N=4092 V_r=25129 (phase 20)",
             launches=st["launches"]["lm_head_ce_fwd"], **st["ce"][0]),
        dict(name="lm_head_ce_bwd_vocab_shard", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:202",
             path="strategies on a local mesh, timed on tp=2's vocabulary "
                  "shard N=4092 V_r=25129 (phase 20)",
             launches=st["launches"]["lm_head_ce_bwd"], **st["ce"][1]),
        dict(name="flash_fwd_microbatch", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:191",
             path="pipelines: GPipe, 1F1B, PipeDream and heterogeneous dp, "
                  "timed at one microbatch B=1 H=12 (phase 21 (a), "
                  "(c)-(e))", launches=mb[0], **pp["flash_mb"][0]),
        dict(name="flash_bwd_microbatch", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:462",
             path="pipelines: GPipe, 1F1B, PipeDream and heterogeneous dp, "
                  "timed at one microbatch B=1 H=12 (phase 21 (a), "
                  "(c)-(e))", launches=mb[1], **pp["flash_mb"][1]),
        dict(name="flash_fwd_microbatch_tp2", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:191",
             path="dp=2 tp=2 pp=2, a rank's microbatch B=1 H=6 (phase 21 "
                  "(b))", launches=pl["b"][0], **pp["flash_tp"][0]),
        dict(name="flash_bwd_microbatch_tp2", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:462",
             path="dp=2 tp=2 pp=2, a rank's microbatch B=1 H=6 (phase 21 "
                  "(b))", launches=pl["b"][1], **pp["flash_tp"][1]),
        dict(name="lm_head_ce_fwd_microbatch", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:177",
             path="pipelines: the head on the whole batch in GPipe, per "
                  "microbatch in 1F1B and heterogeneous dp, timed at one "
                  "microbatch N=1023 (phase 21 (a), (c)-(e))",
             launches=mb[2], **pp["ce_mb"][0]),
        dict(name="lm_head_ce_bwd_microbatch", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:202",
             path="pipelines: the head on the whole batch in GPipe, per "
                  "microbatch in 1F1B and heterogeneous dp, timed at one "
                  "microbatch N=1023 (phase 21 (a), (c)-(e))",
             launches=mb[3], **pp["ce_mb"][1]),
        dict(name="lm_head_ce_fwd_pp_vocab_shard", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:177",
             path="dp=2 tp=2 pp=2, a rank's N=4092 on V_r=25129 (phase 21 "
                  "(b))", launches=pl["b"][2], **pp["ce_shard"][0]),
        dict(name="lm_head_ce_bwd_pp_vocab_shard", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:202",
             path="dp=2 tp=2 pp=2, a rank's N=4092 on V_r=25129 (phase 21 "
                  "(b))", launches=pl["b"][3], **pp["ce_shard"][1]),
        dict(name="flash_block_fwd_sp_rank", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:608",
             path="config G: dp=2 sp=2 tp=2 ring with the heads over tp "
                  "(phase 22 (a))", launches=sl["a"][0],
             **ring_mix(sq["block"], 0, SP2_VISITS, sp_timed)),
        dict(name="flash_block_bwd_sp_rank", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:619",
             path="config G: dp=2 sp=2 tp=2 ring with the heads over tp "
                  "(phase 22 (a))", launches=sl["a"][1],
             **ring_mix(sq["block"], 1, SP2_VISITS, sp_timed)),
        dict(name="flash_fwd_ulysses_rank", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:191",
             path="Ulysses on dp=2 sp=2 tp=2, a rank's B=4 H=3 S=1024 "
                  "(phase 22 (c))", launches=sl["c"][2], **sq["flash"][0]),
        dict(name="flash_bwd_ulysses_rank", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:462",
             path="Ulysses on dp=2 sp=2 tp=2, a rank's B=4 H=3 S=1024 "
                  "(phase 22 (c))", launches=sl["c"][3], **sq["flash"][1]),
        dict(name="lm_head_ce_fwd_sp_vocab_shard", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:177",
             path="dp=2 sp=2 tp=2, a rank's whole 4 x 1024 piece, N=4092 on "
                  "V_r=25129 (phase 22 (a))", launches=sl["a"][4],
             **sq["ce"][0]),
        dict(name="lm_head_ce_bwd_sp_vocab_shard", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:202",
             path="dp=2 sp=2 tp=2, a rank's whole 4 x 1024 piece, N=4092 on "
                  "V_r=25129 (phase 22 (a))", launches=sl["a"][5],
             **sq["ce"][1]),
        dict(name="flash_block_fwd_ep_rank", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:608",
             path="config B: dp=2 ep=2 sp=2 MoE LM with the ring at config "
                  "3's widths (phase 23 (a))", launches=el[0],
             **ring_mix(ex["block"], 0, SP2_VISITS, ep_timed)),
        dict(name="flash_block_bwd_ep_rank", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:619",
             path="config B: dp=2 ep=2 sp=2 MoE LM with the ring at config "
                  "3's widths (phase 23 (a))", launches=el[1],
             **ring_mix(ex["block"], 1, SP2_VISITS, ep_timed)),
        dict(name="flash_fwd_one_kv_block_moe_fp32", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:168",
             path="config B's reference: the MoE LM on ep=2 with the flash "
                  "core, B=32 H=16 S=256 fp32 (phase 23 (a))",
             launches=ea["a"]["ref_launches"][0], **ex["flash"][0]),
        dict(name="flash_bwd_one_kv_block_moe_fp32", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:358",
             path="config B's reference: the MoE LM on ep=2 with the flash "
                  "core, B=32 H=16 S=256 fp32 (phase 23 (a))",
             launches=ea["a"]["ref_launches"][1], **ex["flash"][1]),
    ]
    print_predictions({
        ("flash_fwd", f32): fl_rows[f32][0],
        ("flash_bwd", f32): fl_rows[f32][1],
        ("flash_fwd", bf16): fl_rows[bf16][0],
        ("flash_bwd", bf16): fl_rows[bf16][1],
        ("flash_block_fwd", f32): ring_mix(blk_rows[f32], 0),
        ("flash_block_bwd", f32): ring_mix(blk_rows[f32], 1),
        ("paged_decode_attention", f32): pd_rows[f32],
        ("paged_decode_attention", bf16): pd_rows[bf16],
        ("fused_ln_bwd", f32): fln_rows[f32][1],
        ("fused_ln_bwd", bf16): fln_rows[bf16][1],
        ("lm_head_sample", f32): lm_rows[(f32, 1)],
        ("lm_head_sample", bf16): lm_rows[(bf16, 1)]})
    for dt in (f32, bf16):
        one, five = lm_rows[(dt, 1)]["ms"], lm_rows[(dt, 5)]["ms"]
        print(f"prediction: lm_head_sample {dt} k=5 {five:.4f} ms, "
              f"{five / one - 1:+.1%} over k=1 (predicted within 15%)")
    r = pd_rows[f32]
    n = launches["paged_decode_attention"]
    print(f"paged_decode over phase 4's run: {n} launches x "
          f"{r['serve_ms']:.4f} ms = {n * r['serve_ms']:.3f} ms, "
          f"{n * (r['serve_ms'] - r['serve_bound_ms']):.3f} ms above the "
          f"bound ({n} x {r['serve_bound_ms']:.4f} ms)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Strategy search (counterpart of ``hetu_tpu/parallel/autoparallel/
search.py``; Galvatron dp_utils.py:55,129 + FlexFlow flexflow.py:12).

``dp_search``: exact enumeration over pp_deg x per-stage ParallelChoice with
a per-layer dynamic program under the HBM budget — the Galvatron ``DpOnModel``
algorithm: the result is a mesh shape + uniform-or-per-layer choice list, not
a rewritten graph.

``mcmc_search``: simulated-annealing walk over per-layer choices (the
FlexFlow MCMC capability, flexflow.py:136) against the same cost models —
useful when the choice space is non-uniform (mixed layer types).  It
draws from ``random.Random(seed)``, as the JAX package does, so the same
seed proposes the same walk in both packages.

The searches are the JAX package's, operation for operation: the same
layers and cluster give equal plans and byte-identical ``Plan.to_json()``.
:func:`plan_to_strategy` needs the port's sharding rules and the
``torch.distributed`` transport (ROADMAP queue 1 item 10 part 2) and
raises until they exist; a one-device plan needs no strategy.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
from typing import Optional, Sequence

from hetu_tpu_torch.parallel.autoparallel.cost_model import (
    ClusterSpec,
    LayerSpec,
    MemoryCostModel,
    ParallelChoice,
    TimeCostModel,
)

__all__ = ["Plan", "dp_search", "mcmc_search", "plan_to_strategy",
           "partition_stages", "gpipe_search", "pipedream_search",
           "pipeopt_search"]


@dataclasses.dataclass
class Plan:
    pp: int
    n_microbatches: int
    choices: list          # per-layer ParallelChoice
    time: float            # modeled step time (s)
    peak_bytes: float      # modeled per-device memory
    feasible: bool
    # interleaved virtual stages per device (pipedream schedule; the
    # runtime knob is pipedream_grads(virtual_stages=V))
    virtual_stages: int = 1
    # named remat policy the memory/time accounting assumed
    # (hetu_tpu_torch.mem.policy registry; the runtime knob is the model
    # config's `remat` field)
    remat_policy: str = "none"

    @property
    def dominant(self) -> ParallelChoice:
        """Most common per-layer choice (drives the global mesh)."""
        from collections import Counter
        return Counter(self.choices).most_common(1)[0][0]

    def describe(self) -> str:
        d = self.dominant
        v = f" V={self.virtual_stages}" if self.virtual_stages > 1 else ""
        r = (f" remat={self.remat_policy}"
             if self.remat_policy != "none" else "")
        return (f"pp={self.pp} micro={self.n_microbatches}{v} {d}{r} "
                f"time={self.time * 1e3:.2f}ms "
                f"mem={self.peak_bytes / 1e9:.2f}GB")

    def to_json(self) -> str:
        """Canonical serialization (sorted keys, canonical separators,
        rounded floats): byte-identical for identical search inputs —
        what the determinism regression asserts on."""
        body = {"pp": self.pp, "n_microbatches": self.n_microbatches,
                "choices": [str(c) for c in self.choices],
                "time": round(float(self.time), 12),
                "peak_bytes": round(float(self.peak_bytes), 3),
                "feasible": bool(self.feasible),
                "virtual_stages": self.virtual_stages,
                "remat_policy": self.remat_policy}
        return json.dumps(body, sort_keys=True, separators=(",", ":"))


def _plan_order(plan: Plan) -> tuple:
    """The winner's total order: time first, then a canonical tuple
    over every decision axis — so an exact float-time tie resolves
    identically no matter what order candidates were enumerated in."""
    return (plan.time, plan.pp, plan.n_microbatches, plan.remat_policy,
            plan.virtual_stages, tuple(str(c) for c in plan.choices))


def _choices_for(devices_per_stage: int) -> list[ParallelChoice]:
    out = []
    tp = 1
    while tp <= devices_per_stage:
        dp = devices_per_stage // tp
        if dp * tp == devices_per_stage:
            out.append(ParallelChoice(dp=dp, tp=tp, zero=False))
            if dp > 1:
                out.append(ParallelChoice(dp=dp, tp=tp, zero=True))
        tp *= 2
    return out


def _stage_layers(n_layers: int, pp: int) -> list[int]:
    base, rem = divmod(n_layers, pp)
    return [base + (1 if i < rem else 0) for i in range(pp)]


def _evaluate(layers: Sequence[LayerSpec], choices: Sequence[ParallelChoice],
              pp: int, n_micro: int, global_batch: int,
              cluster: ClusterSpec, mem_model: MemoryCostModel,
              time_model: TimeCostModel,
              remat_policy: str = "none") -> tuple[float, float]:
    """(step_time, peak_stage_bytes) for a per-layer assignment."""
    counts = _stage_layers(len(layers), pp)
    idx = 0
    stage_times, stage_mems = [], []
    p2p_time = 0.0
    for stage, cnt in enumerate(counts):
        t = m = 0.0
        for li in range(idx, idx + cnt):
            ch = choices[li]
            bpr = math.ceil(global_batch / ch.dp)
            t += time_model.layer_time(layers[li], ch, bpr, remat_policy)
            m += mem_model.layer_bytes(layers[li], ch, bpr, n_micro,
                                       remat_policy)
            if li + 1 == idx + cnt and stage + 1 < pp:
                # this boundary's output tensor crosses once per microbatch
                # in each direction (GPipe critical path, no async overlap)
                boundary = (layers[li].boundary_per_sample
                            or layers[li].activation_per_sample / 16)
                p2p_time += 2 * n_micro * cluster.p2p_time(
                    boundary * math.ceil(bpr / n_micro))
        idx += cnt
        stage_times.append(t)
        stage_mems.append(m)
    if pp == 1:
        return stage_times[0], stage_mems[0]
    # GPipe/1F1B schedule: (n_micro + pp - 1) slots of the slowest stage
    slot = max(stage_times) / n_micro
    bubble_time = (n_micro + pp - 1) * slot + p2p_time
    return bubble_time, max(stage_mems)


def dp_search(layers: Sequence[LayerSpec], cluster: ClusterSpec,
              global_batch: int, *, mem_model: MemoryCostModel | None = None,
              time_model: TimeCostModel | None = None,
              microbatch_options: Sequence[int] = (1, 2, 4, 8),
              uniform: bool = False, max_pp: int | None = None,
              remat_policies: Sequence[str] = ("none",),
              calibration=None) -> Plan:
    """Search pp_deg x per-layer choices; returns the fastest feasible plan.

    With ``uniform=False`` a dynamic program picks each layer's choice
    independently (Galvatron's per-layer DP, dp_utils.py:55): state =
    (layer index), value = (time, mem) per candidate choice — since memory
    adds and time adds within a stage, greedy-per-layer minimization under
    the budget is exact for uniform stages; feasibility is re-checked on the
    assembled plan.

    ``remat_policies`` widens the search over named remat policies
    (hetu_tpu_torch.mem.policy): each policy scales activation memory by its
    ``activation_fraction`` and compute by its ``recompute_factor``, so a
    config that OOMs at 'none' can be *rescued* by e.g. 'full' instead of
    being discarded — the searcher then weighs the recompute slowdown
    against alternative parallelism.  Default ('none',) keeps the legacy
    behavior.

    ``calibration`` (a :class:`~hetu_tpu_torch.obs.calibration.Calibration`,
    fitted via ``fit_calibration`` or built with ``Calibration.of``)
    builds the default cost models from MEASURED constants —
    goodput-measured MFU and dp_overlap instead of the 0.4/0.7 guesses
    — so two plans are ranked by what the card actually did.  A
    calibration carrying ``bytes_weight``/``bytes_state``/
    ``bytes_grad``/``activation_scale`` constants (manual overrides;
    the fit layer does not emit these yet) feeds the memory model too.
    Explicit ``time_model=`` / ``mem_model=`` win over it.
    """
    if not remat_policies:
        raise ValueError("remat_policies must name at least one policy")
    # canonicalize the caller-supplied enumeration axes: a shuffled (or
    # set-typed) microbatch_options / remat_policies argument must yield
    # a byte-identical plan — candidate order is never a tie-breaker
    microbatch_options = sorted({int(m) for m in microbatch_options})
    remat_policies = sorted({str(p) for p in remat_policies})
    mem_model = mem_model or MemoryCostModel(cluster,
                                             calibration=calibration)
    time_model = time_model or TimeCostModel(cluster,
                                             calibration=calibration)
    best: Optional[Plan] = None
    pp = 1
    # max_pp caps the pipeline search space (e.g. a runtime without a
    # pipelined model must plan within tp/zero/dp)
    pp_cap = min(cluster.n_devices, len(layers),
                 max_pp if max_pp is not None else cluster.n_devices)
    while pp <= pp_cap:
        per_stage = cluster.n_devices // pp
        if per_stage * pp != cluster.n_devices:
            pp *= 2
            continue
        cands = _choices_for(per_stage)
        for n_micro in microbatch_options:
            if pp == 1 and n_micro > 1:
                continue
            for policy in remat_policies:
                if uniform:
                    assignments = [[c] * len(layers) for c in cands]
                else:
                    # per-layer: pick the fastest choice that fits a
                    # pro-rata memory slice; fall back to min-memory choice
                    budget = cluster.hbm_bytes
                    counts = _stage_layers(len(layers), pp)
                    per_layer_budget = [budget / counts[s]
                                        for s in range(pp)
                                        for _ in range(counts[s])]
                    chosen = []
                    for li, layer in enumerate(layers):
                        def key(c):
                            bpr = math.ceil(global_batch / c.dp)
                            # total order: an exact time tie resolves to
                            # the widest dp, then narrowest tp, then
                            # zero=False (the historical enumeration
                            # preference, now explicit)
                            return (time_model.layer_time(layer, c, bpr,
                                                          policy),
                                    -c.dp, c.tp, c.zero)
                        fits = [c for c in cands
                                if mem_model.layer_bytes(
                                    layer, c, math.ceil(global_batch / c.dp),
                                    n_micro, policy) <= per_layer_budget[li]]
                        pool = fits or cands
                        chosen.append(min(pool, key=key))
                    assignments = [chosen]
                for choices in assignments:
                    t, m = _evaluate(layers, choices, pp, n_micro,
                                     global_batch, cluster, mem_model,
                                     time_model, policy)
                    plan = Plan(pp, n_micro, list(choices), t, m,
                                m <= cluster.hbm_bytes,
                                remat_policy=policy)
                    if plan.feasible and (
                            best is None
                            or _plan_order(plan) < _plan_order(best)):
                        best = plan
        pp *= 2
    if best is None:  # nothing fits: return min-memory plan, flagged
        from hetu_tpu_torch.mem.policy import get_policy
        pp = min(cluster.n_devices, len(layers))
        per_stage = max(cluster.n_devices // pp, 1)
        c = ParallelChoice(dp=1, tp=per_stage, zero=False)
        choices = [c] * len(layers)
        # the genuinely most memory-saving candidate, not whichever the
        # caller happened to list last
        policy = min(remat_policies,
                     key=lambda p: (get_policy(p).cost_knobs()[0], p))
        t, m = _evaluate(layers, choices, pp, 8, global_batch, cluster,
                         mem_model, time_model, policy)
        best = Plan(pp, 8, choices, t, m, False, remat_policy=policy)
    return best


def mcmc_search(layers: Sequence[LayerSpec], cluster: ClusterSpec,
                global_batch: int, *, iters: int = 2000,
                temperature: float = 0.1, seed: int = 0,
                pp: int = 1, n_micro: int = 1) -> Plan:
    """FlexFlow-style MCMC (flexflow.py:12): random per-layer proposal,
    accept if better or with exp(-dT/T) probability; infeasible states pay a
    large penalty instead of being rejected outright."""
    rng = random.Random(seed)
    mem_model = MemoryCostModel(cluster)
    time_model = TimeCostModel(cluster)
    per_stage = cluster.n_devices // pp
    cands = _choices_for(per_stage)

    def cost(choices):
        t, m = _evaluate(layers, choices, pp, n_micro, global_batch,
                         cluster, mem_model, time_model)
        penalty = max(0.0, m - cluster.hbm_bytes) / cluster.hbm_bytes
        return t * (1 + 10 * penalty), t, m

    cur = [rng.choice(cands) for _ in layers]
    cur_cost, cur_t, cur_m = cost(cur)
    best = (cur_cost, list(cur), cur_t, cur_m)
    for _ in range(iters):
        prop = list(cur)
        prop[rng.randrange(len(layers))] = rng.choice(cands)
        c, t, m = cost(prop)
        if c < cur_cost or rng.random() < math.exp(
                -(c - cur_cost) / (temperature * max(cur_cost, 1e-12))):
            cur, cur_cost = prop, c
            if c < best[0]:
                best = (c, list(prop), t, m)
    _, choices, t, m = best
    return Plan(pp, n_micro, choices, t, m, m <= cluster.hbm_bytes)


def _phase_bounds(S: int, V: int, M: int):
    """The three-phase pipeline schedule's static tick boundaries (a copy
    of the JAX package's ``parallel/pipedream.py`` ``_phase_bounds``):
    [0, T1) is forward-only warmup (no backward can exist before the
    depth-S*V pipeline fills), [T1, T2) steady 1F1B (T2 = last forward +
    1), and [T2, T3) backward-only drain."""
    SV = S * V
    g_last, r_last = divmod(M - 1, S)
    t_last = g_last * SV + (V - 1) * S + r_last + (S - 1)
    return SV - 1, t_last + 1, SV - 1 + t_last + 1


def partition_stages(costs: Sequence[float], pp: int) -> list[int]:
    """Balanced contiguous partition of per-layer costs into ``pp`` stages,
    minimizing the max stage cost (the GPipe/PipeDream stage-partition
    problem, reference distributed_strategies/gpipe.py:6 /pipedream.py:7).

    Classic linear-partition dynamic program; returns per-stage layer counts.
    """
    n = len(costs)
    pp = min(pp, n)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)

    def span(i, j):  # cost of layers [i, j)
        return prefix[j] - prefix[i]

    INF = float("inf")
    # best[k][j] = minimal max-stage-cost partitioning layers[:j] into k stages
    best = [[INF] * (n + 1) for _ in range(pp + 1)]
    cut = [[0] * (n + 1) for _ in range(pp + 1)]
    best[0][0] = 0.0
    for k in range(1, pp + 1):
        for j in range(k, n + 1):
            for i in range(k - 1, j):
                cand = max(best[k - 1][i], span(i, j))
                if cand < best[k][j]:
                    best[k][j] = cand
                    cut[k][j] = i
    bounds = []
    j = n
    for k in range(pp, 0, -1):
        i = cut[k][j]
        bounds.append(j - i)
        j = i
    return list(reversed(bounds))


def _pipeline_search(layers: Sequence[LayerSpec], cluster: ClusterSpec,
                     global_batch: int, *, schedule: str,
                     microbatch_options: Sequence[int],
                     virtual_stage_options: Sequence[int] = (1,)
                     ) -> tuple[Plan, list[int]]:
    """Shared machinery for GPipe/PipeDream/PipeOpt searching: pick pp, a
    cost-balanced stage partition, a uniform per-stage choice, and the
    microbatch count.  Both schedules share the (n_micro + pp - 1) x slot
    critical-path time bound; 1F1B ('pipedream') additionally charges
    weight-stash memory for in-flight microbatches, which changes which
    plans are feasible — and may interleave V virtual stages per device
    (pipedream_grads' three-phase schedule), shrinking the bubble term
    toward (pp - 1) x slot / V at ~V x the in-flight activation stash.
    The interleaved time is computed from the runtime scheduler's OWN
    phase bounds (:func:`_phase_bounds`, a copy of the JAX package's
    ``pipedream._phase_bounds``), so the model is exact for
    every (n_micro, pp, V) — including microbatch counts the group
    timetable cannot fill, where interleaving buys nothing."""
    mem_model = MemoryCostModel(cluster)
    time_model = TimeCostModel(cluster)
    best: Optional[Plan] = None
    best_bounds: list[int] = [len(layers)]
    # same canonicalization as dp_search: caller-supplied enumeration
    # order must never decide a tie
    microbatch_options = sorted({int(m) for m in microbatch_options})
    v_options = (sorted({int(v) for v in virtual_stage_options})
                 if schedule == "pipedream" else (1,))
    if any(v < 1 for v in v_options):
        # the runtime rejects V < 1 too (pipedream._run_1f1b); V=0 would
        # divide by zero and V<0 would win the search with negative time
        raise ValueError(f"virtual_stage_options must be >= 1: {v_options}")
    pp = 1
    while pp <= cluster.n_devices and pp <= len(layers):
        per_stage = cluster.n_devices // pp
        if per_stage * pp != cluster.n_devices:
            pp *= 2
            continue
        cands = _choices_for(per_stage)
        for n_micro in microbatch_options:
            if pp == 1 and n_micro > 1:
                continue
            for c in cands:
                bpr = math.ceil(global_batch / c.dp)
                costs = [time_model.layer_time(l, c, bpr) for l in layers]
                bounds = partition_stages(costs, pp)
                # per-stage time and base memory are V-invariant: compute
                # once, apply the V-dependent stash surcharge per V
                idx, stage_times, base_mems = 0, [], []
                for cnt in bounds:
                    stage_times.append(sum(costs[idx:idx + cnt]))
                    base_mems.append(sum(mem_model.layer_bytes(
                        layers[li], c, bpr, n_micro)
                        for li in range(idx, idx + cnt)))
                    idx += cnt
                slot = max(stage_times) / n_micro
                for V in v_options:
                    if pp == 1 and V > 1:
                        continue  # no bubble to interleave away
                    if V > 1 and min(bounds) < V:
                        continue  # every stage must split into V chunks
                    if schedule == "pipedream":
                        # weight stashing keeps up to pp weight versions
                        # of the stage (pipedream_subexecutor.py:130);
                        # interleaving keeps each chunk's activations
                        # in flight ~V x longer (pipedream.py K slots)
                        mems = [m + m / max(n_micro, 1) * (pp - 1) * 0.1 * V
                                for m in base_mems]
                    else:
                        mems = base_mems
                    # chunk-tick count straight from the runtime schedule's
                    # own phase algebra (_phase_bounds, T2 = last
                    # forward + 1; drain overlaps in combined-slot units):
                    # exact for every (M, pp, V), including M not a
                    # multiple of pp, where the naive M*V + pp - 1 model
                    # would credit V > 1 with a speedup that does not
                    # exist (wasted group slots eat it)
                    t2 = _phase_bounds(pp, V, n_micro)[1]
                    t_total = t2 * slot / V
                    plan = Plan(pp, n_micro, [c] * len(layers), t_total,
                                max(mems), max(mems) <= cluster.hbm_bytes,
                                virtual_stages=V)
                    if plan.feasible and (
                            best is None
                            or _plan_order(plan) < _plan_order(best)):
                        best, best_bounds = plan, bounds
        pp *= 2
    if best is None:
        plan = dp_search(layers, cluster, global_batch,
                         microbatch_options=microbatch_options)
        return plan, _stage_layers(len(layers), plan.pp)
    return best, best_bounds


def gpipe_search(layers: Sequence[LayerSpec], cluster: ClusterSpec,
                 global_batch: int,
                 microbatch_options: Sequence[int] = (1, 2, 4, 8, 16)):
    """GPipe partitioner (reference GPipeSearching, gpipe.py:6): balanced
    stages + microbatch count under the memory budget."""
    return _pipeline_search(layers, cluster, global_batch, schedule="gpipe",
                            microbatch_options=microbatch_options)


def pipedream_search(layers: Sequence[LayerSpec], cluster: ClusterSpec,
                     global_batch: int,
                     microbatch_options: Sequence[int] = (1, 2, 4, 8, 16),
                     virtual_stage_options: Sequence[int] = (1, 2, 4)):
    """PipeDream partitioner (reference PipeDreamSearching, pipedream.py:7):
    1F1B steady-state objective + weight-stash memory.  Additionally
    searches interleaved virtual stages (no reference counterpart —
    pipedream_grads' Megatron-style schedule): the planner picks V where
    the bubble saving beats the stash-memory cost."""
    return _pipeline_search(layers, cluster, global_batch,
                            schedule="pipedream",
                            microbatch_options=microbatch_options,
                            virtual_stage_options=virtual_stage_options)


def pipeopt_search(layers: Sequence[LayerSpec], cluster: ClusterSpec,
                   global_batch: int,
                   microbatch_options: Sequence[int] = (1, 2, 4, 8, 16),
                   virtual_stage_options: Sequence[int] = (1, 2, 4)):
    """Joint pipeline + intra-layer search (reference PipeOptSearching,
    pipeopt.py:9): compare the balanced-pipeline plans against dp_search's
    per-layer plans and take the faster feasible one."""
    pipe_plan, bounds = _pipeline_search(
        layers, cluster, global_batch, schedule="pipedream",
        microbatch_options=microbatch_options,
        virtual_stage_options=virtual_stage_options)
    flat_plan = dp_search(layers, cluster, global_batch,
                          microbatch_options=microbatch_options)
    if flat_plan.feasible and (not pipe_plan.feasible
                               or flat_plan.time < pipe_plan.time):
        return flat_plan, _stage_layers(len(layers), flat_plan.pp)
    return pipe_plan, bounds


def plan_to_strategy(plan: Plan, *, rules=None, devices=None):
    """Materialize a Plan as (MeshSpec, ShardingStrategy kwargs) for the
    runtime (``parallel/strategies.py``): ``ShardingStrategy(mesh=
    make_mesh(spec, ...), **kwargs)``.  A plan with ``pp > 1`` runs a
    model whose blocks are a ``parallel.pipeline.Pipelined`` built on
    that mesh, its stack split over ``pp``."""
    from hetu_tpu_torch.parallel.mesh import MeshSpec
    from hetu_tpu_torch.parallel.spec import MEGATRON_RULES
    d = plan.dominant
    mesh_spec = MeshSpec(dp=d.dp, tp=d.tp, pp=plan.pp)
    kwargs = dict(rules=rules or MEGATRON_RULES, batch_axes="dp",
                  zero_stage=1 if d.zero else 0)
    return mesh_spec, kwargs

"""The port's ServingEngine: greedy, temperature and top-k token streams
equal to the JAX package's engine with the same (bridged) weights and
seed on a fixed prompt set (fp32, virtual clock), bitwise
reproducibility and batch invariance within the port, the paged and
gather decode paths and the fused and unfused samplers agreeing, the pool's
refcount / free-list invariants after a run, and the scheduler's
rejections, deadlines and a request that fills the context."""

import numpy as np
import pytest
import torch

from hetu_tpu.core import set_random_seed
from hetu_tpu.core.module import named_parameters
from hetu_tpu.models.gpt import GPT as JaxGPT
from hetu_tpu.models.gpt import GPTConfig as JaxConfig
from hetu_tpu.serve import ServingEngine as JaxEngine
from hetu_tpu_torch.interop import load_jax_params
from hetu_tpu_torch.models.gpt import GPT, GPTConfig
from hetu_tpu_torch.serve import ServingEngine
from hetu_tpu_torch.serve import kv_cache as kvc

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2,
           max_seq_len=64)
ENGINE = dict(num_slots=4, page_size=4, prompt_buckets=(8, 16))
PROMPTS = [[5, 9, 2], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], [42],
           [7, 7, 7, 7, 7, 7], [100, 3, 64, 12, 9], [8, 1, 8, 1, 8, 1, 8]]
BUDGETS = [6, 4, 9, 5, 7, 3]


class VirtualClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _models(seed=0):
    set_random_seed(seed)
    jm = JaxGPT(JaxConfig(**CFG))
    tm = GPT(GPTConfig(**CFG), device="cpu")
    load_jax_params(tm, {n: np.asarray(a) for n, a in named_parameters(jm)})
    return jm, tm


def _run(engine, prompts=PROMPTS, budgets=BUDGETS):
    hs = [engine.submit(p, max_new_tokens=n) for p, n in zip(prompts,
                                                               budgets)]
    engine.run_until_idle()
    assert all(h.status == "completed" for h in hs), \
        [(h.status, h.error) for h in hs]
    return [h.tokens for h in hs]


@pytest.fixture(scope="module")
def port_model():
    return _models()[1]


def test_greedy_streams_equal_the_jax_engine():
    jm, tm = _models()
    ref = _run(JaxEngine(jm, clock=VirtualClock(), **ENGINE))
    got = _run(ServingEngine(tm, clock=VirtualClock(), device="cpu",
                             **ENGINE))
    assert got == ref
    assert [len(t) for t in got] == BUDGETS


def test_same_seed_runs_are_bitwise_equal_and_batch_invariant(port_model):
    a = _run(ServingEngine(port_model, clock=VirtualClock(), device="cpu",
                           **ENGINE))
    b = _run(ServingEngine(port_model, clock=VirtualClock(), device="cpu",
                           **ENGINE))
    assert a == b
    for i in (1, 4):
        alone = _run(ServingEngine(port_model, clock=VirtualClock(),
                                   device="cpu", **ENGINE),
                     [PROMPTS[i]], [BUDGETS[i]])
        assert alone[0] == a[i]


@pytest.mark.parametrize("paged,fused", [(False, False), (True, False),
                                         (False, True)])
def test_paged_and_gather_decode_paths_agree(port_model, paged, fused):
    base = _run(ServingEngine(port_model, clock=VirtualClock(),
                              device="cpu", **ENGINE))
    other = _run(ServingEngine(port_model, clock=VirtualClock(),
                               device="cpu", paged_decode=paged,
                               fused_sampling=fused, **ENGINE))
    assert other == base


def test_paged_decode_builds_no_contiguous_view(port_model):
    eng = ServingEngine(port_model, clock=VirtualClock(), device="cpu",
                        **ENGINE)
    kvc.reset_gather_view_count()
    hs = [eng.submit(p, max_new_tokens=4) for p in PROMPTS[:4]]
    eng.step()  # admits and prefills all four, then one decode step
    assert kvc.gather_view_count() == 4
    eng.run_until_idle()
    assert kvc.gather_view_count() == 4
    assert all(h.status == "completed" for h in hs)


def test_pool_invariants_hold_during_and_after_a_run(port_model):
    eng = ServingEngine(port_model, clock=VirtualClock(), device="cpu",
                        **ENGINE)
    for p, n in zip(PROMPTS, BUDGETS):
        eng.submit(p, max_new_tokens=n)
    eng.step()
    mid = eng.pool.stats()
    assert mid["sequences"] == 4 and mid["pages_free"] < mid["pages_total"]
    eng.run_until_idle()
    st = eng.pool.stats()
    assert st["pages_free"] == st["pages_total"]
    assert st["sequences"] == 0 and st["refcount_histogram"] == {}
    assert st["allocs"] == st["frees"] == len(PROMPTS)
    assert eng.stats()["requests"]["completed"] == len(PROMPTS)


STOCHASTIC = ["temperature", "top_k"]
SAMPLING = dict(top_k=5, temperature=0.8, seed=3)


def _engine(model, mode, **kw):
    return ServingEngine(model, clock=VirtualClock(), device="cpu",
                         sampling=mode, **{**SAMPLING, **ENGINE, **kw})


@pytest.mark.parametrize("mode", STOCHASTIC)
def test_stochastic_streams_equal_the_jax_engine(mode):
    """Keys ``fold_in(fold_in(key(seed), rid), pos)`` on both sides: the
    Gumbel fields agree within an ulp and every token is equal."""
    jm, tm = _models()
    ref = _run(JaxEngine(jm, clock=VirtualClock(), sampling=mode,
                         **SAMPLING, **ENGINE))
    got = _run(_engine(tm, mode))
    assert got == ref
    assert [len(t) for t in got] == BUDGETS


@pytest.mark.parametrize("mode", STOCHASTIC)
def test_stochastic_same_seed_is_bitwise_and_batch_invariant(port_model,
                                                             mode):
    a = _run(_engine(port_model, mode))
    assert _run(_engine(port_model, mode)) == a
    assert _run(_engine(port_model, mode, seed=4)) != a
    for i in (2, 4):   # alone under its batched request id
        eng = _engine(port_model, mode)
        h = eng.submit(PROMPTS[i], BUDGETS[i], request_id=i)
        eng.run_until_idle()
        assert h.tokens == a[i]
    eng = _engine(port_model, mode)
    eng.submit([1, 2], 3, request_id=7)
    with pytest.raises(ValueError, match="in flight"):
        eng.submit([3], 3, request_id=7)
    assert eng.submit([3], 3).request_id == 8


@pytest.mark.parametrize("paged,fused", [(False, False), (True, False),
                                         (False, True)])
@pytest.mark.parametrize("mode", STOCHASTIC)
def test_stochastic_decode_paths_agree(port_model, mode, paged, fused):
    base = _run(_engine(port_model, mode))
    other = _run(_engine(port_model, mode, paged_decode=paged,
                         fused_sampling=fused))
    assert other == base


def test_wide_top_k_samples_from_materialised_logits(port_model):
    """``fused_sampling=None`` keeps the fused kernel unless top-k asks
    for more than its 128 candidates; top_k=200 clamps to the vocabulary
    (128) and samples unfused, with the same streams as forcing it."""
    wide = _engine(port_model, "top_k", top_k=200)
    assert wide.stats()["fused_sampling"] is True     # min(200, V) <= 128
    cfg = dict(CFG, vocab_size=256)
    set_random_seed(1)
    big = GPT(GPTConfig(**cfg), device="cpu")
    eng = _engine(big, "top_k", top_k=200)
    assert eng.stats()["fused_sampling"] is False
    assert _engine(big, "top_k", top_k=128).stats()["fused_sampling"]
    assert _engine(big, "temperature").stats()["fused_sampling"]
    assert _run(eng) == _run(_engine(big, "top_k", top_k=200,
                                     fused_sampling=False))


@pytest.mark.parametrize("kw,match", [
    (dict(sampling="nucleus"), "sampling mode"),
    (dict(sampling="top_k", top_k=0), "top_k must be")])
def test_invalid_sampling_raises(port_model, kw, match):
    with pytest.raises(ValueError, match=match):
        ServingEngine(port_model, device="cpu", **kw)


def test_temperature_mode_is_not_top_k_truncated(port_model):
    """sampling='temperature' draws from the full distribution, not a
    top-k-truncated one (the reference's ``tests/test_serve.py``)."""
    def collect(mode):
        eng = ServingEngine(port_model, num_slots=2, page_size=8,
                            max_seq_len=64, prompt_buckets=(8,),
                            sampling=mode, top_k=1, temperature=3.0,
                            seed=0, device="cpu", clock=VirtualClock())
        hs = [eng.submit([i + 1, i + 2], 8) for i in range(8)]
        eng.run_until_idle()
        return [t for h in hs for t in h.tokens]

    assert len(set(collect("temperature"))) > len(set(collect("top_k")))


def test_greedy_collapse_at_zero_temperature(port_model):
    greedy = _run(ServingEngine(port_model, clock=VirtualClock(),
                                device="cpu", **ENGINE))
    for mode in STOCHASTIC:
        assert _run(_engine(port_model, mode, temperature=0.0)) == greedy


def test_rejections_deadlines_and_a_full_context(port_model):
    clock = VirtualClock()
    eng = ServingEngine(port_model, clock=clock, device="cpu",
                        max_seq_len=16, num_slots=1, page_size=4,
                        prompt_buckets=(8, 16))
    assert eng.submit([], 3).status == "rejected"
    assert eng.submit([1] * 10, 10).status == "rejected"   # > max_seq_len
    first = eng.submit([1, 2], 4)
    queued = eng.submit([3, 4], 4, deadline_s=0.5)
    clock.t = 1.0  # the queued request's deadline passes before a slot frees
    eng.run_until_idle()
    assert first.status == "completed" and len(first.tokens) == 4
    assert queued.status == "expired" and "admission queue" in queued.error
    # prompt + budget filling the context exactly is served in full
    long = eng.submit(list(range(1, 13)), 4)
    eng.run_until_idle()
    assert long.status == "completed" and len(long.tokens) == 4


def test_engine_rejects_a_model_on_another_device(port_model):
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(port_model)   # device=None means CUDA
    assert port_model.device == torch.device("cpu")


def test_pool_refcounts_retain_release_and_double_free():
    from hetu_tpu_torch.serve import DoubleFree, KVCachePool, OutOfPages
    pool = KVCachePool(num_layers=1, num_heads=1, head_dim=2, num_pages=6,
                       page_size=4, max_seq_len=16, device="cpu")
    a = pool.alloc(10, 5)
    assert a.pages == [1, 2] and pool.free_pages == 3
    pool.retain(2)
    pool.free(10)
    assert pool.free_pages == 4                 # page 2 still held
    assert pool.stats()["pages_shared"] == 1
    with pytest.raises(DoubleFree):
        pool.free(10)
    pool.release(2)
    with pytest.raises(DoubleFree):
        pool.release(2)
    assert pool.alloc(11, 16).pages == [1, 2, 3, 4]
    with pytest.raises(OutOfPages):
        pool.alloc(12, 8)
    assert pool.stats()["pages_free"] == 1
    assert pool.gather_indices([11, None]).tolist() == [[1, 2, 3, 4],
                                                        [0, 0, 0, 0]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fifo_batcher_schedules_as_the_single_tenant_reference(seed):
    """Random submit / poll / finish sequences (deadlines, a capacity gate,
    a full queue) give the same admissions, expiries, slots and rejections
    in the port's FIFO batcher as in the reference's WFQ batcher with one
    tenant."""
    from hetu_tpu.serve.batcher import AdmissionQueueFull as JaxFull
    from hetu_tpu.serve.batcher import ContinuousBatcher as JaxBatcher
    from hetu_tpu.serve.batcher import Request as JaxRequest
    from hetu_tpu_torch.serve import (AdmissionQueueFull, ContinuousBatcher,
                                      Request)
    rng = np.random.default_rng(seed)
    pair = [(JaxBatcher(3, queue_depth=4), JaxRequest, JaxFull),
            (ContinuousBatcher(3, queue_depth=4), Request,
             AdmissionQueueFull)]
    logs = [[], []]
    rid = 0
    for now in range(40):
        op = rng.integers(0, 3)
        plen = int(rng.integers(1, 30))
        deadline = [None, 2.0][int(rng.integers(0, 2))]
        room = int(rng.integers(0, 4))
        done = int(rng.integers(0, 3))
        for (b, req_cls, full), log in zip(pair, logs):
            if op == 0:
                try:
                    b.submit(req_cls(id=rid, prompt=[1] * plen,
                                     max_new_tokens=4, arrival=float(now),
                                     deadline_s=deadline))
                    log.append(("queued", rid))
                except full:
                    log.append(("full", rid))
            elif op == 1:
                left = [room]

                def gate(r, left=left):
                    left[0] -= 1
                    return left[0] >= 0
                tick = b.poll(float(now), can_admit=gate)
                log.append(("tick", [r.id for r in tick.expired],
                            [(r.id, r.slot) for r in tick.admitted]))
            else:
                active = b.active()
                if active:
                    slot = active[done % len(active)][0]
                    log.append(("finish", slot, b.finish(slot).id))
            log.append((b.queue_len, b.active_slots, b.idle,
                        b.bucket_for(plen)))
        rid += op == 0
    assert logs[0] == logs[1]
    assert any(e[0] == "tick" and e[2] for e in logs[1])


def test_every_kernel_counter_lives_in_one_registry():
    """The decode graph adds what its capture counted to every counter at
    once (``_build.add_launches``): each wrapper module's count reads that
    registry, and a module's reset clears its own names only."""
    from hetu_tpu_torch.ops.kernels import (_build, flash, fused_ln,
                                            lm_head, lm_head_ce,
                                            paged_decode)
    reads = {"paged_decode_attention": paged_decode.launch_count,
             "lm_head_sample": lm_head.launch_count,
             "flash_fwd": flash.fwd_launch_count,
             "flash_bwd": flash.bwd_launch_count,
             "flash_block_fwd": flash.block_fwd_launch_count,
             "flash_block_bwd": flash.block_bwd_launch_count,
             "lm_head_ce_fwd": lm_head_ce.fwd_launch_count,
             "lm_head_ce_bwd": lm_head_ce.bwd_launch_count,
             "fused_ln_fwd": fused_ln.fwd_launch_count,
             "fused_ln_bwd": fused_ln.bwd_launch_count}
    for m in (paged_decode, lm_head, flash, lm_head_ce, fused_ln):
        m.reset_launch_count()
    deltas = {n: i + 1 for i, n in enumerate(reads)}
    _build.add_launches(deltas)
    _build.count_launch("lm_head_sample")
    assert {n: f() for n, f in reads.items()} == {
        **deltas, "lm_head_sample": deltas["lm_head_sample"] + 1}
    _build.add_launches({n: -c for n, c in deltas.items()})
    flash.reset_launch_count()
    assert lm_head.launch_count() == 1
    lm_head.reset_launch_count()
    assert all(f() == 0 for f in reads.values())

"""The port's MoE path (``hetu_tpu_torch.layers.moe``,
``models.moe_lm``, BERT's MoE classes and the local ``ep`` mesh) on the
CPU: twins of ``tests/test_moe.py``'s tests, and the port held against
the JAX package with the JAX weights loaded through ``load_jax_params``.

Tolerances against JAX, in fp32:

- index plans (expert, slot, keep) equal, except tokens whose routing
  margin (``_routing_margin``: the gap between a chosen score and the
  next) is under 1e-6, and the experts such a token flipped;
- the layer's ``y`` and ``aux`` within rtol 1e-5, atol 1e-6, also on an
  ``ep=4`` mesh against the JAX ``shard_map`` on the virtual CPU mesh;
- the ``MoELM`` loss and every step-0 gradient within rtol 1e-4 (atol
  1e-6), three Adam ``Trainer`` steps' losses within 1e-4;
- ``BertMoEForPreTraining`` with dropout and one key: the loss within
  2e-5, gradients within rtol 5e-3 / atol 1e-5 (``test_torch_bert.py``'s
  step-0 tolerances).

Remat: ``MoELM`` under every policy of ``mem.policy`` bitwise equal to
``"none"`` (loss, aux and gradients), and the JAX model's remat within
the step-0 tolerances."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.core import rng as jrng
from hetu_tpu.core import set_random_seed
from hetu_tpu.core.module import named_parameters
from hetu_tpu.exec.executor import Trainer as JaxTrainer
from hetu_tpu.layers import moe as jmoe
from hetu_tpu.models.bert import BertMoEForPreTraining as JaxBertMoE
from hetu_tpu.models.bert import bert_base as jax_bert_base
from hetu_tpu.models.moe_lm import MoELM as JaxMoELM
from hetu_tpu.models.moe_lm import MoELMConfig as JaxMoELMConfig
from hetu_tpu.optim import AdamOptimizer as JaxAdam
from hetu_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from hetu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hetu_tpu_torch import AdamOptimizer, Trainer, mem
from hetu_tpu_torch.core import rng as trng
from hetu_tpu_torch.core.prng import key_data
from hetu_tpu_torch.interop import export_params, load_jax_params
from hetu_tpu_torch.layers import TransformerBlock
from hetu_tpu_torch.layers import moe
from hetu_tpu_torch.models.bert import BertMoEForPreTraining, bert_base
from hetu_tpu_torch.models.moe_lm import MoELM, MoELMConfig
from hetu_tpu_torch.parallel import MeshSpec, make_mesh

CPU = dict(device="cpu")
MARGIN = 1e-6
_TRANSPOSED = ("wqkv", "wo", ".w")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _tokens(T=32, d=8, seed=0):
    a = np.random.default_rng(seed).normal(size=(T, d)).astype(np.float32)
    return torch.from_numpy(a)


def _routing_margin(gate, x):
    """[T] fp32: for each token, the smallest gap between a score that one
    of the gate's argmax choices took and the next score (inf for the hash
    gate, whose routing reads no scores), recomputed from the gate's own
    pieces.  A token whose margin is within a rounding of 0 can route
    differently in another summation order; plans are compared without
    such tokens."""
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


@pytest.fixture
def ep_mesh():
    return make_mesh(MeshSpec(ep=4), device="cpu")


# ---------------------------------------------------------------------------
# Twins of tests/test_moe.py
# ---------------------------------------------------------------------------

def test_topk_gate_shapes_and_dispatch():
    T, d, E, k = 16, 8, 4, 2
    gate = moe.TopKGate(d, E, k, capacity_factor=2.0, generator=_gen(),
                        **CPU)
    dispatch, combine, aux = gate(_tokens(T, d))
    C = gate.capacity(T)
    assert dispatch.shape == (T, E, C) and combine.shape == (T, E, C)
    np.testing.assert_allclose(_np(dispatch.sum((1, 2))), k, rtol=1e-6)
    np.testing.assert_allclose(_np(combine.sum((1, 2))), 1.0, rtol=1e-5)
    assert float(dispatch.sum(0).max()) <= 1.0 + 1e-6
    assert float(aux) > 0


def test_topk_gate_capacity_drops():
    T, d, E = 16, 8, 4
    gate = moe.TopKGate(d, E, 1, capacity_factor=0.25, generator=_gen(1),
                        **CPU)
    dispatch, _, _ = gate(_tokens(T, d, 1))
    assert gate.capacity(T) == 1
    assert float(dispatch.sum()) <= E * gate.capacity(T) + 1e-6
    assert float(dispatch.sum()) < T


def test_hash_gate_balanced():
    T, d, E = 16, 8, 4
    dispatch, _, aux = moe.HashGate(d, E)(_tokens(T, d))
    np.testing.assert_allclose(_np(dispatch.sum((0, 2))), T / E)
    assert float(aux) == 0.0


def test_ktop1_gate_one_expert_per_prototype():
    T, d, E, k = 16, 8, 8, 2
    gate = moe.KTop1Gate(d, E, k, capacity_factor=4.0, generator=_gen(5),
                         **CPU)
    dispatch, combine, aux = gate(_tokens(T, d, 5))
    assert dispatch.shape == (T, E, gate.capacity(T))
    per_proto = _np(dispatch.sum(2).reshape(T, k, E // k).sum(-1))
    np.testing.assert_allclose(per_proto, 1.0, rtol=1e-6)
    assert float(combine.max()) <= 1.0 + 1e-6
    assert float(aux) > 0
    with pytest.raises(ValueError, match="divisible"):
        moe.KTop1Gate(d, 6, 4, **CPU)


def test_sam_gate_routes_within_one_group():
    T, d, E, G, k = 16, 8, 8, 4, 2
    gate = moe.SAMGate(d, E, k, num_groups=G, capacity_factor=8.0,
                       generator=_gen(6), **CPU)
    dispatch, _, aux = gate(_tokens(T, d, 6))
    chosen = dispatch.sum(2).detach().numpy()
    groups = chosen.reshape(T, G, E // G).sum(-1)
    assert ((groups > 0).sum(-1) == 1).all()
    np.testing.assert_allclose(chosen.sum(-1), k, rtol=1e-6)
    assert float(aux) >= 0


def test_balance_gate_exactly_balanced():
    T, d, E = 32, 16, 4
    gate = moe.BalanceGate(d, E, sinkhorn_iters=16, generator=_gen(7), **CPU)
    dispatch, _, aux = gate(_tokens(T, d, 7))
    per_expert = dispatch.sum((0, 2)).detach().numpy()
    assert per_expert.max() <= T / E + 1e-6
    assert per_expert.sum() >= 0.75 * T
    assert float(aux) == 0.0


def test_balance_gate_centroids_not_trainable():
    gate = moe.BalanceGate(8, 4, generator=_gen(8), **CPU)
    assert "centroids" in dict(gate.named_buffers())
    assert "centroids" not in dict(gate.named_parameters())
    c = gate.centroids.float()
    # orthogonal rows of norm 0.1
    np.testing.assert_allclose(_np(c @ c.T), 0.01 * np.eye(4), atol=1e-6)


@pytest.mark.parametrize("make_gate", [
    lambda d, E: moe.KTop1Gate(d, E, 2, capacity_factor=4.0, **CPU),
    lambda d, E: moe.SAMGate(d, E, 2, num_groups=4, capacity_factor=8.0,
                             **CPU),
    lambda d, E: moe.BalanceGate(d, E, **CPU),
], ids=["ktop1", "sam", "balance"])
def test_new_gates_drive_moe_layer(make_gate):
    torch.manual_seed(9)
    T, d, E = 32, 8, 8
    layer = moe.MoELayer(make_gate(d, E), moe.ExpertMLP(E, d, 16, **CPU))
    y, aux = layer(_tokens(T, d, 9))
    assert y.shape == (T, d)
    assert torch.isfinite(y).all() and torch.isfinite(aux)


def _topk_layer(d, E, k, cf, mesh=None, seed=2):
    g = _gen(seed)
    return moe.MoELayer(
        moe.TopKGate(d, E, k, capacity_factor=cf, generator=g, **CPU),
        moe.ExpertMLP(E, d, 16, generator=g, **CPU), mesh=mesh)


def test_moe_ep_matches_single_group(ep_mesh):
    T, d, E = 32, 8, 8
    moe_ep = _topk_layer(d, E, 2, 8.0, mesh=ep_mesh)
    moe_1 = moe.MoELayer(moe_ep.gate, moe_ep.experts)
    x = _tokens(T, d, 2)
    y_ep, aux_ep = moe_ep(x)
    ys, auxes = zip(*(moe_1(x[s * 8:(s + 1) * 8]) for s in range(4)))
    np.testing.assert_allclose(y_ep.detach().numpy(),
                               torch.cat(ys).detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux_ep), float(sum(auxes) / 4),
                               rtol=1e-6)


def test_moe_grads_flow(ep_mesh):
    T, d, E = 32, 8, 8
    layer = _topk_layer(d, E, 1, 2.0, mesh=ep_mesh, seed=3)
    y, aux = layer(_tokens(T, d, 3))
    ((y ** 2).mean() + 0.01 * aux).backward()
    assert float(layer.experts.w1.grad.abs().sum()) > 0
    assert float(layer.gate.w.grad.abs().sum()) > 0


def test_moe_in_train_step(ep_mesh):
    """A MoE FFN on the ep mesh trained 30 Adam steps."""
    d, E = 8, 8
    g = _gen(4)
    layer = moe.moe_transformer_mlp(d, 16, E, k=2, mesh=ep_mesh,
                                    generator=g, **CPU)

    def loss_fn(m, batch, key):
        y, aux = m(batch["x"])
        return ((y - batch["y"]) ** 2).mean() + 0.01 * aux, {}

    tr = Trainer(layer, AdamOptimizer(1e-2), loss_fn)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.normal(size=(32, d)).astype(np.float32))
             for k in ("x", "y")}
    losses = [float(tr.step(batch, key=torch.tensor([0, i]))["loss"])
              for i in range(30)]
    assert losses[-1] < losses[0]


def test_moe_hierarchical_ep_and_other_axes_are_refused():
    """The JAX package factors the exchange over (ep, tp); the port's
    local mesh runs it as the flat exchange over the pair, and ep beside
    another axis as the ep blocks alone: both equal the single-group
    layer on ``x.chunk(ep)``.  An axis the mesh lacks and experts that
    do not divide over ep are refused."""
    d, E = 8, 4
    gate = moe.TopKGate(d, E, 2, capacity_factor=8.0, **CPU)
    experts = moe.ExpertMLP(E, d, 16, **CPU)
    one = moe.MoELayer(gate, experts)
    x = _tokens(16, d, 5)
    for mesh, axis, ep in (
            (make_mesh(MeshSpec(ep=2, tp=2), **CPU), ("ep", "tp"), 4),
            (make_mesh(MeshSpec(ep=2, sp=2), **CPU), "ep", 2),
            (make_mesh(MeshSpec(ep=2, dp=2), **CPU), "ep", 2)):
        y, aux = moe.MoELayer(gate, experts, mesh=mesh, axis=axis)(x)
        parts = [one(s) for s in x.chunk(ep)]
        torch.testing.assert_close(y, torch.cat([p[0] for p in parts]),
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(aux, sum(p[1] for p in parts) / ep)
    with pytest.raises(ValueError, match="not in mesh axes"):
        moe.MoELayer(gate, experts, mesh=make_mesh(MeshSpec(ep=2), **CPU),
                     axis=("ep", "xp"))
    with pytest.raises(ValueError, match="divisible"):
        moe.MoELayer(gate, moe.ExpertMLP(E, d, 16, **CPU),
                     mesh=make_mesh(MeshSpec(ep=8), **CPU))(_tokens(16, d))


def _bert_moe_batch(vocab, B=8, S=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (B, S))
    mlm = np.where(np.arange(S)[None] < 3, ids, -1)
    nsp = rng.integers(0, 2, (B,))
    return ids, np.zeros((B, S), np.int64), mlm, nsp


def test_bert_moe_pretraining_trains():
    cfg = bert_base(num_layers=2, hidden_size=32, num_heads=2, vocab_size=96,
                    max_position_embeddings=16)
    model = BertMoEForPreTraining(cfg, num_experts=4, top_k=2, **CPU)
    ids, tt, mlm, nsp = (torch.from_numpy(a) for a in _bert_moe_batch(96))
    tr = Trainer(model, AdamOptimizer(3e-3),
                 lambda m, b, k: m.loss(ids, tt, None, mlm, nsp, key=k,
                                        training=False))
    l0 = float(tr.step(None)["loss"])
    for _ in range(30):
        m = tr.step(None)
    assert float(m["loss"]) < l0
    assert math.isfinite(float(m["moe_aux"]))


def test_bert_moe_expert_parallel_mesh():
    cfg = bert_base(num_layers=1, hidden_size=32, num_heads=2, vocab_size=64,
                    max_position_embeddings=16)
    mesh = make_mesh(MeshSpec(ep=4), **CPU)
    model = BertMoEForPreTraining(cfg, num_experts=4, top_k=1, mesh=mesh,
                                  **CPU)
    ids, tt, mlm, nsp = (torch.from_numpy(a)
                         for a in _bert_moe_batch(64, seed=1))
    tr = Trainer(model, AdamOptimizer(1e-3),
                 lambda m, b, k: m.loss(ids, tt, None, mlm, nsp, key=k,
                                        training=False))
    assert math.isfinite(float(tr.step(None)["loss"]))


class _NoPlanGate:
    """Hides ``index_plan`` so ``MoELayer`` takes the einsum path."""

    def __init__(self, gate):
        self._g = gate
        self.num_experts = gate.num_experts

    def __call__(self, t, *, training=True):
        return self._g(t, training=training)


def test_index_dispatch_matches_einsum_dispatch():
    """Top-2 with capacity drops: the scatter/gather path against the
    one-hot einsum path, outputs, aux and input gradients."""
    g = _gen(0)
    gate = moe.TopKGate(16, 4, k=2, capacity_factor=0.6, generator=g, **CPU)
    experts = moe.ExpertMLP(4, 16, 32, generator=g, **CPU)
    moe_idx = moe.MoELayer(gate, experts)
    moe_oh = moe.MoELayer(_NoPlanGate(gate), experts)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 24, 16)).astype(np.float32))
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    y1, aux1 = moe_idx(x1)
    y2, aux2 = moe_oh(x2)
    np.testing.assert_allclose(y1.detach().numpy(), y2.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(aux1), float(aux2), rtol=1e-6)
    y1.sum().backward()
    y2.sum().backward()
    np.testing.assert_allclose(_np(x1.grad), _np(x2.grad), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="index_plan"):
        moe_oh(x, with_stats=True)


PORT_GATES = {
    "topk": lambda d, E: moe.TopKGate(d, E, 2, capacity_factor=1.0, **CPU),
    "hash": lambda d, E: moe.HashGate(d, E, capacity_factor=2.0),
    "ktop1": lambda d, E: moe.KTop1Gate(d, E, 2, capacity_factor=4.0, **CPU),
    "sam": lambda d, E: moe.SAMGate(d, E, 2, num_groups=4,
                                    capacity_factor=8.0, **CPU),
    "balance": lambda d, E: moe.BalanceGate(d, E, **CPU),
}
JAX_GATES = {
    "topk": lambda d, E: jmoe.TopKGate(d, E, 2, capacity_factor=1.0),
    "hash": lambda d, E: jmoe.HashGate(d, E, capacity_factor=2.0),
    "ktop1": lambda d, E: jmoe.KTop1Gate(d, E, 2, capacity_factor=4.0),
    "sam": lambda d, E: jmoe.SAMGate(d, E, 2, num_groups=4,
                                     capacity_factor=8.0),
    "balance": lambda d, E: jmoe.BalanceGate(d, E),
}


@pytest.mark.parametrize("name", list(PORT_GATES))
def test_index_plan_matches_einsum_dispatch(name):
    torch.manual_seed(3)
    T, d, E = 32, 16, 8
    gate = PORT_GATES[name](d, E)
    experts = moe.ExpertMLP(E, d, 32, **CPU)
    x = _tokens(T, d, 3)
    y_idx, aux_idx = moe.MoELayer(gate, experts)(x)
    dispatch, combine, aux_oh = gate(x)
    ex_out = experts(torch.einsum("tec,td->ecd", dispatch, x))
    y_oh = torch.einsum("tec,ecd->td", combine, ex_out)
    np.testing.assert_allclose(y_idx.detach().numpy(), y_oh.detach().numpy(),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(float(aux_idx), float(aux_oh), rtol=1e-6)


def test_routing_stats_oracle():
    e_idx = torch.tensor([0, 0, 2, 1])
    slot = torch.tensor([0, 1, 0, 0])
    keep = torch.tensor([True, True, True, False])
    g = torch.ones(4)
    s = moe.routing_stats([(e_idx, slot, keep, g)], E=4)
    np.testing.assert_allclose(float(s["overflow_frac"]), 0.25, atol=1e-6)
    expect = (np.log(3) - (2 / 3) * np.log(2)) / np.log(4)
    np.testing.assert_allclose(float(s["load_entropy"]), expect, rtol=1e-5)
    s2 = moe.routing_stats(
        [(torch.tensor([0, 1, 2, 3]), slot, torch.ones(4, dtype=bool), g)],
        E=4)
    np.testing.assert_allclose(float(s2["overflow_frac"]), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(s2["load_entropy"]), 1.0, rtol=1e-6)
    # the same plan through the JAX function
    js = jmoe.routing_stats([(jnp.asarray(e_idx.detach().numpy()),
                              jnp.asarray(slot.detach().numpy()),
                              jnp.asarray(keep.detach().numpy()),
                              jnp.ones(4))], E=4)
    for k in s:
        np.testing.assert_allclose(float(s[k]), float(js[k]), rtol=1e-6)


def test_moe_ep_stats_and_overflow_threshold(ep_mesh):
    T, d, E = 64, 8, 8
    layer = _topk_layer(d, E, 2, 2.0, mesh=ep_mesh, seed=11)
    _, (aux, stats) = layer(_tokens(T, d, 4), with_stats=True)
    assert set(stats) == {"overflow_frac", "load_entropy"}
    ov, ent = float(stats["overflow_frac"]), float(stats["load_entropy"])
    assert 0.0 <= ov < 0.3, f"capacity overflow {ov} out of bounds"
    assert 0.5 < ent <= 1.0 + 1e-6, f"router collapse? entropy {ent}"
    _, (_, stats1) = moe.MoELayer(layer.gate, layer.experts)(
        _tokens(T, d, 4), with_stats=True)
    assert set(stats1) == {"overflow_frac", "load_entropy"}


def test_moe_lm_logs_routing_stats():
    cfg = MoELMConfig(vocab_size=64, hidden_size=32, num_layers=2,
                      num_heads=2, num_experts=4, top_k=1, max_seq_len=16,
                      log_routing_stats=True)
    m = MoELM(cfg, **CPU)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 16)))
    loss, metrics = m.loss(ids)
    assert {"aux", "overflow_frac", "load_entropy"} <= set(metrics)
    assert math.isfinite(float(loss))
    assert 0.0 <= float(metrics["overflow_frac"]) <= 1.0


REMAT_KW = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                num_experts=2, max_seq_len=32)


def _remat_grads(policy, counter=None):
    m = MoELM(MoELMConfig(remat=policy, **REMAT_KW), **CPU)
    if counter is not None:
        for blk in m.blocks:
            blk.moe.experts.register_forward_hook(
                lambda *a: counter.append(1))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 16)))
    loss, metrics = m.loss(ids, training=False)
    loss.backward()
    return loss.detach(), metrics["aux"].detach(), {
        n: p.grad for n, p in m.named_parameters()}


@pytest.mark.parametrize("policy", mem.policy_names())
def test_moelm_remat_is_exact(policy):
    """Every remat policy: loss, aux and gradients bitwise ``"none"``'s;
    every policy but ``"none"`` runs each block's experts twice (the
    dispatch replays in the backward)."""
    ref = _remat_grads("none")
    calls = []
    got = _remat_grads(policy, calls)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for n, g in ref[2].items():
        assert torch.equal(got[2][n], g), n
    assert len(calls) == (2 if policy == "none" else 4)


def test_moelm_remat_matches_the_jax_model():
    set_random_seed(0)
    jm = JaxMoELM(JaxMoELMConfig(remat="full", **REMAT_KW))
    tm = MoELM(MoELMConfig(remat="full", **REMAT_KW), **CPU)
    _load(tm, jm)
    ids = np.random.default_rng(0).integers(0, 128, (2, 16))
    _loss_and_grads(jm, tm, ids, training=False)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

def _load(tm, jm):
    load_jax_params(tm, {n: np.asarray(a) for n, a in named_parameters(jm)})


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_plans_match(tplans, jplans, margin):
    """Experts, slots and keeps equal and the gates within 1e-5, except
    where the routing margin is under MARGIN: such a token may pick
    another expert, and then the slots of the experts it touched may
    shift.  Returns (near-tie count, mask of the tokens compared)."""
    near = _np(margin) < MARGIN
    flipped = np.zeros(near.shape, bool)
    for (te, *_), (je, *_) in zip(tplans, jplans):
        diff = _np(te) != _np(je)
        assert not (diff & ~near).any(), "a routing away from a tie differs"
        flipped |= diff
    touched = set()
    for (te, *_), (je, *_) in zip(tplans, jplans):
        touched |= set(_np(te)[flipped]) | set(_np(je)[flipped])
    ok = np.ones(near.shape, bool)
    for (te, *_), (je, *_) in zip(tplans, jplans):
        ok &= ~np.isin(_np(te), list(touched)) & ~np.isin(_np(je),
                                                          list(touched))
    for (te, ts, tk, tg), (je, js, jk, jg) in zip(tplans, jplans):
        np.testing.assert_array_equal(_np(ts)[ok], _np(js)[ok])
        np.testing.assert_array_equal(_np(tk)[ok], _np(jk)[ok])
        np.testing.assert_allclose(_np(tg)[ok & ~near], _np(jg)[ok & ~near],
                                   rtol=1e-5, atol=1e-6)
    return int(near.sum()), ok


def _layer_pair(name, T, d, E, seed):
    set_random_seed(seed)
    jl = jmoe.MoELayer(JAX_GATES[name](d, E), jmoe.ExpertMLP(E, d, 2 * d))
    tl = moe.MoELayer(PORT_GATES[name](d, E), moe.ExpertMLP(E, d, 2 * d,
                                                            **CPU))
    _load(tl, jl)
    return jl, tl


@pytest.mark.parametrize("name", list(PORT_GATES))
def test_gate_plan_and_layer_match_jax(name):
    T, d, E = 64, 16, 8
    jl, tl = _layer_pair(name, T, d, E, seed=21)
    x = _tokens(T, d, 21)
    jx = jnp.asarray(x.detach().numpy())
    jplans, jC, jaux = jl.gate.index_plan(jx, training=True)
    tplans, tC, taux = tl.gate.index_plan(x, training=True)
    assert tC == jC
    _, ok = _assert_plans_match(tplans, jplans,
                                _routing_margin(tl.gate, x))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-6)
    jy, jaux2 = jl(jx, training=True)
    ty, taux2 = tl(x, training=True)
    np.testing.assert_allclose(_np(ty)[ok], _np(jy)[ok], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(taux2), float(jaux2), rtol=1e-5,
                               atol=1e-6)
    # eval capacity and the densified oracle
    jd, jc, _ = jl.gate(jx, training=False)
    td, tc, _ = tl.gate(x, training=False)
    assert td.shape == jd.shape
    if ok.all():
        np.testing.assert_array_equal(_np(td), _np(jd))
        np.testing.assert_allclose(_np(tc), _np(jc), rtol=1e-5, atol=1e-6)


def test_topk_capacity_drops_match_jax():
    """Top-1 and top-2 with capacity factors that drop tokens; with
    ``training=False`` the eval factor sizes the buckets."""
    T, d, E = 48, 16, 4
    x = _tokens(T, d, 5)
    for k, cf, ecf in ((1, 0.5, 2.0), (2, 0.6, 0.3)):
        set_random_seed(k)
        jg = jmoe.TopKGate(d, E, k, capacity_factor=cf,
                           eval_capacity_factor=ecf)
        tg = moe.TopKGate(d, E, k, capacity_factor=cf,
                          eval_capacity_factor=ecf, **CPU)
        _load(tg, jg)
        for training in (True, False):
            jp, jC, _ = jg.index_plan(jnp.asarray(x.detach().numpy()),
                                      training=training)
            tp, tC, _ = tg.index_plan(x, training=training)
            assert tC == jC == tg.capacity(T, training)
            _assert_plans_match(tp, jp, _routing_margin(tg, x))
        assert sum(int((~kp).sum()) for *_, kp, _ in tg.index_plan(x)[0]) > 0


def test_moe_layer_grads_match_jax():
    T, d, E = 32, 16, 4
    jl, tl = _layer_pair("topk", T, d, E, seed=22)
    x = _tokens(T, d, 22)

    def jloss(m, v):
        y, aux = m(v, training=True)
        return (y ** 2).mean() + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jl, jnp.asarray(_np(x)))
    xt = x.clone().requires_grad_()
    y, aux = tl(xt)
    ((y ** 2).mean() + 0.01 * aux).backward()
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jgx), rtol=1e-5,
                               atol=1e-7)
    _assert_grads_match(jg, tl, rtol=1e-5, atol=1e-7)


def test_moe_ep_layer_matches_jax_on_its_mesh():
    """ep=4: the port's local mesh against the JAX ``shard_map`` over the
    virtual CPU devices (ep=4, dp=2), with stats and gradients."""
    T, d, E = 32, 8, 8
    set_random_seed(2)
    jmesh = jax_make_mesh(JaxMeshSpec(ep=4, dp=2), devices=jax.devices())
    jl = jmoe.MoELayer(jmoe.TopKGate(d, E, 2, capacity_factor=2.0),
                       jmoe.ExpertMLP(E, d, 16), mesh=jmesh)
    tl = moe.MoELayer(moe.TopKGate(d, E, 2, capacity_factor=2.0, **CPU),
                      moe.ExpertMLP(E, d, 16, **CPU),
                      mesh=make_mesh(MeshSpec(ep=4), **CPU))
    _load(tl, jl)
    x = _tokens(T, d, 2)

    def jloss(m, v):
        y, (aux, stats) = m(v, with_stats=True)
        return (y ** 2).mean() + 0.01 * aux, (y, aux, stats)

    (jl_, (jy, jaux, jstats)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jl, jnp.asarray(x.detach().numpy()))
    ty, (taux, tstats) = tl(x, with_stats=True)
    ((ty ** 2).mean() + 0.01 * taux).backward()
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-6)
    for k in jstats:
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-5, atol=1e-6)
    _assert_grads_match(jg, tl, rtol=1e-4, atol=1e-7)


def _assert_grads_match(jg, tm, rtol, atol):
    own = dict(tm.named_parameters())
    seen = []
    for name, g in named_parameters(jg):
        if name not in own:         # a state field (centroids)
            continue
        seen.append(name)
        ours = own[name].grad
        ours = np.zeros(own[name].shape, np.float32) if ours is None \
            else ours.float().detach().numpy()
        if name.endswith(_TRANSPOSED):
            ours = ours.T
        g = np.asarray(g, np.float32)
        np.testing.assert_allclose(ours, g, rtol=rtol,
                                   atol=max(atol, 1e-6 * np.abs(g).max()),
                                   err_msg=name)
    assert sorted(seen) == sorted(own)


LM_KW = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=4,
             num_experts=4, max_seq_len=16, log_routing_stats=True)


def _lm_pair(**kw):
    set_random_seed(0)
    jm = JaxMoELM(JaxMoELMConfig(**{**LM_KW, **kw}))
    tm = MoELM(MoELMConfig(**{**LM_KW, **kw}), **CPU)
    _load(tm, jm)
    return jm, tm


def _loss_and_grads(jm, tm, ids, training=True):
    (jl, jmet), jg = jax.value_and_grad(
        lambda m: m.loss(jnp.asarray(ids, jnp.int32), training=training),
        has_aux=True)(jm)
    tl, tmet = tm.loss(torch.from_numpy(ids), training=training)
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    _assert_grads_match(jg, tm, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moelm_loss_and_step0_gradients_match_jax(top_k):
    jm, tm = _lm_pair(top_k=top_k, capacity_factor=1.0)
    _loss_and_grads(jm, tm, np.random.default_rng(3).integers(0, 96, (4, 16)))


def _worst_grad_err(jg, tm):
    """The largest ``max |port - JAX| / max |JAX|`` over the gradients."""
    own = dict(tm.named_parameters())
    worst = 0.0
    for name, g in named_parameters(jg):
        ours = own[name].grad.float().detach().numpy()
        if name.endswith(_TRANSPOSED):
            ours = ours.T
        g = np.asarray(g, np.float32)
        worst = max(worst, float(np.abs(ours - g).max() / np.abs(g).max()))
    return worst


def test_moelm_bf16_loss_matches_jax():
    """bf16 parameters (LayerNorm stays fp32).  At a random init the loss
    is about ln(V) whatever the blocks compute (dropping an expert moves
    it by 1.3e-5 here, under the bf16 gap of 2.0e-5), so the step-0
    gradients carry the check: each within 5e-2 of its largest value
    (worst 2.6e-2 here), a limit that the same model with expert 0's
    output dropped fails (worst 1.0)."""
    ids = np.random.default_rng(4).integers(0, 96, (4, 16))
    errs = []
    for drop in (False, True):
        jm, tm = _lm_pair(dtype=jnp.bfloat16)
        assert tm.wte.weight.dtype == torch.bfloat16
        assert tm.blocks[0].ln1.scale.dtype == torch.float32
        assert tm.blocks[0].moe.experts.w1.dtype == torch.bfloat16
        if drop:
            with torch.no_grad():
                for blk in tm.blocks:
                    blk.moe.experts.w2[0].zero_()
                    blk.moe.experts.b2[0].zero_()
        (jl, _), jg = jax.value_and_grad(
            lambda m: m.loss(jnp.asarray(ids, jnp.int32)), has_aux=True)(jm)
        tl, _ = tm.loss(torch.from_numpy(ids))
        tl.backward()
        if not drop:
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        errs.append(_worst_grad_err(jg, tm))
    assert errs[0] <= 5e-2 < errs[1], errs


@pytest.fixture
def restore_rngs():
    saved = (jrng.get_seed_status(), trng.get_seed_status())
    yield
    jrng.reset_seed_seqnum(*saved[0])
    trng.reset_seed_seqnum(*saved[1])


def test_three_adam_trainer_steps_match_jax(restore_rngs):
    """bench.py's config-3 loss_fn on both ``Trainer``s, Adam, 3 steps."""
    jm, tm = _lm_pair()
    ids = np.random.default_rng(5).integers(0, 96, (4, 16))
    jt = JaxTrainer(jm, JaxAdam(3e-3),
                    lambda m, b, k: m.loss(b["ids"], training=True))
    tt = Trainer(tm, AdamOptimizer(3e-3),
                 lambda m, b, k: m.loss(b["ids"], training=True))
    jb, tb = {"ids": jnp.asarray(ids, jnp.int32)}, {"ids": torch.from_numpy(
        ids)}
    jl, tl = [], []
    for _ in range(3):
        jmet, tmet = jt.step(jb), tt.step(tb)
        jl.append(float(jmet["loss"]))
        tl.append(float(tmet["loss"]))
        assert {"aux", "overflow_frac", "load_entropy"} <= set(tmet)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    assert tl[-1] < tl[0]
    ref = {n: np.asarray(a) for n, a in named_parameters(jt.model)}
    got = export_params(tt.model)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-4,
                                   err_msg=name)


BERT_KW = dict(num_layers=2, hidden_size=64, num_heads=2, vocab_size=128,
               max_position_embeddings=16)
JKEY = jax.random.fold_in(jax.random.key(0), 7)


def _bert_pair(**kw):
    set_random_seed(0)
    jm = JaxBertMoE(jax_bert_base(**BERT_KW), num_experts=4, **kw)
    tm = BertMoEForPreTraining(bert_base(**BERT_KW), num_experts=4, **kw,
                               **CPU)
    _load(tm, jm)
    return jm, tm


def test_bert_moe_loss_and_step0_gradients_match_jax():
    jm, tm = _bert_pair(top_k=2, capacity_factor=2.0)
    batch = _bert_moe_batch(128, B=4, seed=3)
    (jl, jmet), jg = jax.value_and_grad(
        lambda m: m.loss(*(jnp.asarray(a, jnp.int32) for a in batch[:2]),
                         None, *(jnp.asarray(a, jnp.int32)
                                 for a in batch[2:]),
                         key=JKEY, training=True), has_aux=True)(jm)
    tb = [torch.from_numpy(a) for a in batch]
    tl, tmet = tm.loss(tb[0], tb[1], None, tb[2], tb[3],
                       key=key_data(np.asarray(jax.random.key_data(JKEY))))
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl), rtol=0, atol=2e-5)
    assert set(tmet) == {"mlm_loss", "nsp_loss", "moe_aux"}
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   atol=2e-5, err_msg=k)
    _assert_grads_match(jg, tm, rtol=5e-3, atol=1e-5)


def test_bridge_round_trips_moe_models_and_their_logits():
    """A bridged ``MoELM`` and ``BertMoEForPreTraining`` give JAX's logits
    and losses, and ``export_params`` gives back the JAX arrays, the gate
    ``w`` transposed back to ``(d, E)``; a ``BalanceGate``'s centroids
    are copied into its buffer."""
    jm, tm = _lm_pair()
    assert tm.blocks[0].moe.gate.w.shape == (4, 32)
    assert tm.blocks[0].moe.experts.w1.shape == (4, 32, 128)
    ids = np.random.default_rng(6).integers(0, 96, (2, 16))
    jlog, _ = jm(jnp.asarray(ids, jnp.int32), training=False)
    with torch.no_grad():
        tlog, _ = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
    jb, tb = _bert_pair()
    for j, t in ((jm, tm), (jb, tb)):
        ref = {n: np.asarray(a) for n, a in named_parameters(j)}
        got = export_params(t)
        assert sorted(got) == sorted(ref)
        for name in ref:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    batch = _bert_moe_batch(128, B=4, seed=8)
    jl, _ = jb.loss(*(jnp.asarray(a, jnp.int32) for a in batch[:2]), None,
                    *(jnp.asarray(a, jnp.int32) for a in batch[2:]),
                    training=False)
    with torch.no_grad():
        tl, _ = tb.loss(*(torch.from_numpy(a) for a in batch[:2]), None,
                        *(torch.from_numpy(a) for a in batch[2:]),
                        training=False)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _, tl_ = _layer_pair("balance", 8, 8, 4, seed=3)
    jlb, _ = _layer_pair("balance", 8, 8, 4, seed=3)
    np.testing.assert_array_equal(tl_.gate.centroids.detach().numpy(),
                                  np.asarray(jlb.gate.centroids))
    assert sorted(export_params(tl_)) == sorted(
        n for n, _ in named_parameters(jlb))


def test_transformer_block_takes_an_aux_returning_ffn():
    """The block's ``mlp=`` seam: an aux-returning FFN makes it return
    ``(x, aux)`` (pre-LN and post-LN), and the cached path refuses it."""
    d = 16
    for post_ln in (False, True):
        blk = TransformerBlock(d, 2, post_ln=post_ln, dropout_rate=0.1,
                               mlp=moe.moe_transformer_mlp(d, 32, 4, **CPU),
                               **CPU)
        x = _tokens(8, d).reshape(2, 4, d)
        out, aux = blk(x, key=torch.tensor([0, 3]), training=True)
        assert out.shape == x.shape and aux.ndim == 0
        with pytest.raises(NotImplementedError, match="incremental"):
            blk(x[:, :1], kv_cache=(torch.zeros(2, 8, 2, 8),
                                    torch.zeros(2, 8, 2, 8)),
                cache_index=torch.zeros(2, dtype=torch.int32))
    dense = TransformerBlock(d, 2, **CPU)
    assert isinstance(dense(_tokens(8, d).reshape(2, 4, d)), torch.Tensor)

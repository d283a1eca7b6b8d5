"""The port's expert parallelism beside the other mesh axes
(``hetu_tpu_torch.layers.moe.MoELayer`` on mixed meshes and inside a
strategy's rank, ``ShardingStrategy(batch_axes=("dp", "ep"))``, the
hierarchical exchange, ``ep`` across processes) and the 1.5D GCN
(``models.gnn.dist_spmm_15d``, ``DistGCN15D``) against the JAX package's,
on the suite's 8 virtual CPU devices for the JAX side and local CPU
meshes (plus a gloo world of two processes) for the port, with inputs
made from a numpy seed:

- ``MoELayer`` on ``dp2 ep2``, ``ep2 sp2``, ``ep2 tp2`` and the tuple
  axis ``("ep", "tp")`` at capacity factor 0.5 (tokens dropped) against
  the JAX layer jitted on the same mesh: y, aux and the stats within
  1e-6, gradients within rtol 1e-5 / atol 1e-6 of their max;
- ``hierarchical_all_to_all`` against ``lax.all_to_all`` over the pair;
- the reference's config B at its dryrun size (``dp2 ep2 sp2``, the ring,
  ``DP_RULES``, ``batch_axes=("dp", "ep")``) against the JAX ``Trainer``
  under its strategy: step-0 loss within 1e-6 relative, every gradient
  within 1e-5 of its max, three AdamW steps within 1e-5; a control that
  routes each rank's own piece (the ``ep=4`` function) must fail;
- the step-0 gradients counting each token once, beside controls that
  count an expert slice ``ep`` times or average a replicated parameter
  over ``dp`` alone;
- ``BertMoEForPreTraining`` on ``dp2 ep4`` (the reference's
  ``tests/test_moe.py`` case) against the JAX trainer;
- the JAX weights into the sharded model and back, a checkpoint of an
  unsharded trainer continued under the strategy;
- two gloo processes at ``ep=2``: losses, each rank's step-0 gradients
  and the weights bitwise the local ``ep=2`` run's; the hierarchical
  exchange and ``dist_spmm_15d`` over the process groups;
- ``dist_spmm_15d`` and ``DistGCN15D`` at ``tests/test_gnn.py``'s sizes,
  forward and gradients, against the JAX ones."""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from hetu_tpu.core import set_random_seed
from hetu_tpu.core.module import named_parameters
from hetu_tpu.exec import Trainer as JaxTrainer
from hetu_tpu.layers import moe as jmoe
from hetu_tpu.models.bert import BertMoEForPreTraining as JaxBertMoE
from hetu_tpu.models.bert import bert_base as jax_bert_base
from hetu_tpu.models.gnn import DistGCN15D as JaxDistGCN15D
from hetu_tpu.models.gnn import dist_spmm_15d as jax_dist_spmm_15d
from hetu_tpu.models.moe_lm import MoELM as JaxMoELM
from hetu_tpu.models.moe_lm import MoELMConfig as JaxMoELMConfig
from hetu_tpu.optim import AdamOptimizer as JaxAdam
from hetu_tpu.optim import AdamWOptimizer as JaxAdamW
from hetu_tpu.parallel.collectives import (
    hierarchical_all_to_all as jax_hierarchical_all_to_all)
from hetu_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from hetu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hetu_tpu.parallel.ring_attention import ring_attn_fn as jax_ring_attn_fn
from hetu_tpu.parallel.spec import DP_RULES as JAX_DP_RULES
from hetu_tpu.parallel.strategies import (
    ShardingStrategy as JaxShardingStrategy)
from hetu_tpu_torch import AdamOptimizer, AdamWOptimizer, Trainer
from hetu_tpu_torch.interop import export_params, load_jax_params
from hetu_tpu_torch.launch import simulate_workers
from hetu_tpu_torch.layers import moe
from hetu_tpu_torch.models import DistGCN15D, dist_spmm_15d
from hetu_tpu_torch.models.bert import BertMoEForPreTraining, bert_base
from hetu_tpu_torch.models.moe_lm import MoELM, MoELMConfig
from hetu_tpu_torch.parallel import (DP_RULES, MeshSpec, ShardingStrategy,
                                     collectives as col,
                                     hierarchical_all_to_all,
                                     make_grid_mesh, make_mesh, ring_attn_fn)
from hetu_tpu_torch.parallel.spec import gather_param

CPU = dict(device="cpu")
LAYER_TOL = 1e-6
LOSS_TOL = 1e-6        # step-0 loss, relative
GRAD_TOL = 1e-5        # step-0 gradients, of each one's largest value
TRACE_TOL = 1e-5       # three AdamW steps, relative
_TRANSPOSED = ("wqkv", "wo", ".w")
# the reference's config B at its dryrun size (__graft_entry__.py), at
# the capacity factor whose drops tell the routing block apart
CFG_B = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             num_experts=4, capacity_factor=0.5, max_seq_len=64)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _params(jm) -> dict:
    return {n: np.asarray(a) for n, a in named_parameters(jm)}


def _port_grad(name, g):
    """A port gradient in the JAX layout."""
    g = _np(g)
    return g.T if g.ndim == 2 and name.endswith(_TRANSPOSED) else g


def _worst(ours: dict, ref: dict) -> tuple:
    """The largest gap of a gradient over its reference's largest value,
    and the parameter it is in."""
    return max((float(np.abs(_port_grad(n, ours[n]) - np.asarray(g)).max()
                      / max(float(np.abs(np.asarray(g)).max()), 1e-30)), n)
               for n, g in ref.items())


# -- the layer on mixed meshes ----------------------------------------------------

LAYER_MESHES = {"dp2ep2": (dict(dp=2, ep=2), "ep"),
                "ep2sp2": (dict(ep=2, sp=2), "ep"),
                "ep2tp2": (dict(ep=2, tp=2), "ep"),
                "ep_tp": (dict(ep=2, tp=2), ("ep", "tp"))}


@pytest.mark.parametrize("case", sorted(LAYER_MESHES))
def test_moe_layer_on_mixed_meshes_matches_jax(case):
    """The port's layer on a local mesh with other axes beside ``ep`` (and
    over the tuple ``("ep", "tp")``) plays every rank: ``x.chunk(ep)``
    blocks, each routed with its own capacity, as the JAX layer jitted on
    the same mesh computes."""
    sizes, axis = LAYER_MESHES[case]
    T, d, E, k = 64, 8, 8, 2
    set_random_seed(3)
    jmesh = jax_make_mesh(JaxMeshSpec(**sizes),
                          devices=jax.devices()[:np.prod(list(
                              sizes.values()))])
    jl = jmoe.MoELayer(jmoe.TopKGate(d, E, k, capacity_factor=0.5),
                       jmoe.ExpertMLP(E, d, 16), mesh=jmesh, axis=axis)
    tl = moe.MoELayer(moe.TopKGate(d, E, k, capacity_factor=0.5, **CPU),
                      moe.ExpertMLP(E, d, 16, **CPU),
                      mesh=make_mesh(MeshSpec(**sizes), **CPU), axis=axis)
    load_jax_params(tl, _params(jl))
    x = np.random.default_rng(3).normal(size=(T, d)).astype(np.float32)

    def jloss(m, v):
        y, (aux, stats) = m(v, with_stats=True)
        return (y ** 2).mean() + 0.01 * aux, (y, aux, stats)

    (_, (jy, jaux, jstats)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jl, jnp.asarray(x))
    ty, (taux, tstats) = tl(torch.from_numpy(x), with_stats=True)
    ((ty ** 2).mean() + 0.01 * taux).backward()
    assert float(tstats["overflow_frac"]) > 0.0      # tokens dropped
    np.testing.assert_allclose(_np(ty), np.asarray(jy), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    for key in jstats:
        np.testing.assert_allclose(float(tstats[key]), float(jstats[key]),
                                   rtol=LAYER_TOL, atol=LAYER_TOL)
    grads = {n: p.grad for n, p in tl.named_parameters()}
    ref = {n: g for n, g in named_parameters(jg)}
    assert sorted(ref) == sorted(grads)
    worst = _worst(grads, ref)
    assert worst[0] <= GRAD_TOL, worst


def test_hierarchical_all_to_all_matches_lax():
    """The exchange over ``(ep, tp)`` on a ``dp2 ep2 tp2`` local mesh
    against ``lax.all_to_all`` over the pair inside ``shard_map``; the
    flat ``all_to_all`` over the tuple axis is the same exchange."""
    jmesh = jax_make_mesh(JaxMeshSpec(dp=2, ep=2, tp=2),
                          devices=jax.devices())
    x = np.random.default_rng(5).normal(size=(8 * 4, 6)).astype(np.float32)
    spec = JP(("dp", "ep", "tp"))
    ref = jax.jit(jax.shard_map(
        lambda v: jax_hierarchical_all_to_all(v, "ep", "tp", split_dim=0,
                                              concat_dim=1),
        mesh=jmesh, in_specs=spec, out_specs=spec))(jnp.asarray(x))
    mesh = make_mesh(MeshSpec(dp=2, ep=2, tp=2), **CPU)
    shards = list(torch.from_numpy(x).chunk(8))
    col.reset_counts()
    out = hierarchical_all_to_all(shards, "ep", "tp", split_dim=0,
                                  concat_dim=1, mesh=mesh)
    np.testing.assert_array_equal(torch.cat(out).numpy(), np.asarray(ref))
    flat = col.all_to_all(shards, ("ep", "tp"), split_dim=0, concat_dim=1,
                          mesh=mesh)
    assert all(torch.equal(a, b) for a, b in zip(out, flat))
    assert col.counts()["all_to_all"]["calls"] == 2
    assert col.counts()["all_to_all"]["bytes"] == 2 * x.nbytes


def test_meshes_admit_ep_beside_every_axis():
    mesh = make_mesh(MeshSpec(dp=2, ep=2, sp=2), **CPU)
    assert mesh.groups("ep")[:2] == [[0, 2], [1, 3]]
    assert mesh.groups(("dp", "ep"))[0] == [0, 2, 4, 6]
    assert make_mesh(MeshSpec(ep=2, tp=2, pp=2), **CPU).size == 8
    grid = make_grid_mesh({"gr": 2, "gc": 4}, **CPU)
    assert grid.axis_names == ("gr", "gc")
    assert grid.shape == {"gr": 2, "gc": 4}
    assert grid.groups("gc") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert grid.held == list(range(8))
    with pytest.raises(ValueError, match="divisible"):
        moe.MoELayer(moe.TopKGate(8, 4, 2, **CPU), moe.ExpertMLP(4, 8, 16,
                                                                 **CPU),
                     mesh=make_mesh(MeshSpec(ep=8), **CPU))(
            torch.zeros(16, 8))


# -- config B under its strategy ---------------------------------------------------


def _jax_model_b():
    set_random_seed(1)
    jmesh = jax_make_mesh(JaxMeshSpec(dp=2, ep=2, sp=2),
                          devices=jax.devices())
    return JaxMoELM(JaxMoELMConfig(**CFG_B), mesh=jmesh,
                    attn_fn=jax_ring_attn_fn(jmesh, impl="blockwise"))


@pytest.fixture(scope="module")
def ref_b():
    """Config B's JAX weights, its step-0 loss and gradients (the model
    on its mesh, jitted) and three AdamW steps of the JAX ``Trainer``
    under ``ShardingStrategy(DP_RULES, batch_axes=("dp", "ep"))``."""
    ids = np.random.default_rng(0).integers(0, 512, (8, 32)).astype(
        np.int32)
    jm = _jax_model_b()
    params = _params(jm)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda m, v: m.loss(v, training=True), has_aux=True))(
        jm, jnp.asarray(ids))
    tr = JaxTrainer(_jax_model_b(), JaxAdamW(1e-4, weight_decay=0.01),
                    lambda m, b, k: m.loss(b["ids"], training=True),
                    strategy=JaxShardingStrategy(
                        mesh=jm.blocks[0].moe.mesh, rules=JAX_DP_RULES,
                        batch_axes=("dp", "ep")))
    trace = [float(tr.step({"ids": jnp.asarray(ids)})["loss"])
             for _ in range(3)]
    return {"ids": ids, "params": params, "loss": float(loss),
            "grads": {n: np.asarray(g) for n, g in named_parameters(grads)},
            "trace": trace}


def _loss_b(m, b, k):
    return m.loss(b, training=True)


def _trainer_b(ref, mesh=None, batch_axes=("dp", "ep")):
    mesh = mesh or make_mesh(MeshSpec(dp=2, ep=2, sp=2), **CPU)
    model = MoELM(MoELMConfig(**CFG_B), mesh=mesh,
                  attn_fn=ring_attn_fn(mesh), **CPU)
    load_jax_params(model, ref["params"])
    return Trainer(model, AdamWOptimizer(1e-4, weight_decay=0.01), _loss_b,
                   strategy=ShardingStrategy(mesh=mesh, rules=DP_RULES,
                                             batch_axes=batch_axes))


def _full_grads(sh, grads) -> dict:
    """Every parameter's gradient after ``reduce_grads``, joined from the
    ranks of ``sp = 0`` and ``dp = 0`` (the ep slices of the experts)."""
    idx = [i for i, c in enumerate(sh.coords) if c["sp"] == 0
           and c["dp"] == 0]
    return {n: gather_param([grads[i][n] for i in idx], pl.shape,
                            pl.tp_spec, [sh.coords[i] for i in idx],
                            sh.mesh.shape, pl.blocks)
            for n, pl in sh.place.items()}


def _step0(sh, ids):
    out = sh.forward_backward(_loss_b, torch.from_numpy(ids).long(), None)
    return float(sh.mean_loss([o[0] for o in out])), sh.reduce_grads()


def _routing_own_piece(monkeypatch):
    """The control: each rank routes its own (dp, ep) piece, as if the
    batch were cut over ep alone (the ``MeshSpec(ep=4)`` function)."""
    setup = moe.MoELayer._ep_setup
    monkeypatch.setattr(moe.MoELayer, "_ep_setup",
                        lambda self, handle, batch_axes: setup(
                            self, handle, ("ep",)))


def test_config_b_step0_matches_jax(ref_b, monkeypatch):
    sh = _trainer_b(ref_b)._sharded
    assert [tuple(m.blocks[0].moe.experts.w1.shape) for m in sh.models] \
        == [(2, 64, 256)] * 8
    loss, grads = _step0(sh, ref_b["ids"])
    assert abs(loss - ref_b["loss"]) <= LOSS_TOL * abs(ref_b["loss"]), \
        (loss, ref_b["loss"])
    worst = _worst(_full_grads(sh, grads), ref_b["grads"])
    assert worst[0] <= GRAD_TOL, worst
    # every replica's gradients are its group's: sp and dp ranks agree
    for i, c in enumerate(sh.coords):
        j = next(k for k, d in enumerate(sh.coords)
                 if d["ep"] == c["ep"] and d["sp"] == 0 and d["dp"] == 0)
        for n in grads[i]:
            assert torch.equal(grads[i][n], grads[j][n]), (c, n)
    _routing_own_piece(monkeypatch)
    loss, _ = _step0(_trainer_b(ref_b)._sharded, ref_b["ids"])
    assert abs(loss - ref_b["loss"]) > LOSS_TOL * abs(ref_b["loss"]), loss


def test_config_b_trace_matches_jax(ref_b):
    tr = _trainer_b(ref_b)
    ids = torch.from_numpy(ref_b["ids"]).long()
    trace = [float(tr.step(ids)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(trace, ref_b["trace"], rtol=TRACE_TOL)


def test_step0_gradients_count_each_token_once(ref_b):
    """The expert slices' gradients hold every ep rank's tokens once (the
    exchange's backward, then the sum over the dp replicas over the
    pieces); the replicated ones are the mean over dp and ep.  Counting
    an expert slice ``ep`` times, or averaging a replicated gradient over
    dp alone (each ep index's pieces), must fail."""
    sh = _trainer_b(ref_b)._sharded
    out = sh.forward_backward(_loss_b, torch.from_numpy(
        ref_b["ids"]).long(), None)
    raw = [{n: p.grad.clone() for n, p in m.named_parameters()}
           for m in sh.models]
    del out
    grads = sh.reduce_grads()
    full = _full_grads(sh, grads)
    assert _worst(full, ref_b["grads"])[0] <= GRAD_TOL
    experts = [n for n in full if ".experts." in n]
    assert experts
    twice = {**full, **{n: full[n] * 2 for n in experts}}
    assert _worst(twice, ref_b["grads"])[0] > GRAD_TOL
    dp_only = dict(full)
    idx = [i for i, c in enumerate(sh.coords) if c["sp"] == 0
           and c["ep"] == 0]
    for n in full:
        if n not in experts:
            dp_only[n] = sum(raw[i][n] for i in idx) / len(idx)
    assert _worst(dp_only, ref_b["grads"])[0] > GRAD_TOL


def test_weights_and_checkpoints_round_trip(ref_b):
    """The JAX weights into the sharded model (each rank its ep slice of
    the experts) and back; an unsharded trainer's checkpoint loaded under
    the strategy continues its trace."""
    from hetu_tpu_torch.exec.checkpoint import (load_trainer_state,
                                                trainer_state_dict)
    tr = _trainer_b(ref_b)
    sh = tr._sharded
    w1 = ref_b["params"]["blocks.0.moe.experts.w1"]
    for c, m in zip(sh.coords, sh.models):
        np.testing.assert_array_equal(
            _np(m.blocks[0].moe.experts.w1), w1[2 * c["ep"]:2 * c["ep"] + 2])
    back = export_params(tr.model)
    assert sorted(back) == sorted(ref_b["params"])
    for n, a in ref_b["params"].items():
        np.testing.assert_array_equal(np.asarray(back[n]), a, err_msg=n)
    ids = torch.from_numpy(ref_b["ids"]).long()
    model = MoELM(MoELMConfig(**CFG_B), mesh=make_mesh(MeshSpec(ep=2),
                                                       **CPU), **CPU)
    load_jax_params(model, ref_b["params"])
    plain = Trainer(model, AdamWOptimizer(1e-4, weight_decay=0.01), _loss_b)
    plain.step(ids)
    load_trainer_state(tr, trainer_state_dict(plain))
    for n, a in export_params(plain.model).items():
        np.testing.assert_array_equal(np.asarray(export_params(
            tr.model)[n]), np.asarray(a), err_msg=n)
    np.testing.assert_allclose(float(tr.step(ids)["loss"]),
                               float(plain.step(ids)["loss"]),
                               rtol=TRACE_TOL)


def test_batch_axes_refusals():
    with pytest.raises(NotImplementedError, match="item 11"):
        ShardingStrategy(batch_axes=("dp", "sp"))
    with pytest.raises(NotImplementedError, match="item 11"):
        ShardingStrategy(batch_axes=("dp", "ep"), zero_stage=1)
    mesh = make_mesh(MeshSpec(dp=2, ep=2), **CPU)
    model = MoELM(MoELMConfig(**CFG_B), mesh=mesh, **CPU)
    with pytest.raises(NotImplementedError, match="batch axes"):
        ShardingStrategy(mesh=mesh, rules=DP_RULES,
                         batch_axes="dp").install(model, AdamWOptimizer(1e-4))
    remat = MoELM(MoELMConfig(**CFG_B, remat="full"), mesh=mesh, **CPU)
    with pytest.raises(NotImplementedError, match="part 12"):
        ShardingStrategy(mesh=mesh, rules=DP_RULES,
                         batch_axes=("dp", "ep")).install(
            remat, AdamWOptimizer(1e-4))


def test_moe_without_a_mesh_under_data_parallel_routes_the_whole_batch():
    """The reference's layer without a mesh routes the whole batch as one
    group under ``jit``, whatever the strategy cuts; the port's ranks
    under ``DataParallel`` gather it (they used to route each dp piece
    alone, whose ``aux`` and drops differ).  Step-0 loss and gradients
    against ``jax.grad`` of the JAX model."""
    from hetu_tpu_torch.parallel import DataParallel
    set_random_seed(2)
    jm = JaxMoELM(JaxMoELMConfig(**CFG_B))
    ids = np.random.default_rng(4).integers(0, 512, (8, 32)).astype(
        np.int32)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda m, v: m.loss(v, training=True), has_aux=True))(
        jm, jnp.asarray(ids))
    model = MoELM(MoELMConfig(**CFG_B), **CPU)
    load_jax_params(model, _params(jm))
    sh = Trainer(model, AdamWOptimizer(1e-4), _loss_b,
                 strategy=DataParallel(mesh=make_mesh(MeshSpec(dp=2),
                                                      **CPU)))._sharded
    got, reduced = _step0(sh, ids)
    assert abs(got - float(loss)) <= LOSS_TOL * abs(float(loss))
    worst = _worst(reduced[0], {n: np.asarray(g)
                                for n, g in named_parameters(grads)})
    assert worst[0] <= GRAD_TOL, worst


def test_bert_moe_on_dp2_ep4_matches_jax():
    """The reference's ``test_bert_moe_expert_parallel_mesh``: BERT-MoE on
    ``dp2 ep4`` under ``DP_RULES`` and ``batch_axes=("dp", "ep")``, two
    Adam steps against the JAX trainer's."""
    set_random_seed(0)
    jmesh = jax_make_mesh(JaxMeshSpec(dp=2, ep=4), devices=jax.devices())
    kw = dict(num_layers=1, hidden_size=32, num_heads=2, vocab_size=64,
              max_position_embeddings=16)
    jm = JaxBertMoE(jax_bert_base(**kw), num_experts=4, top_k=1, mesh=jmesh)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 64, (8, 16)).astype(np.int32)
    mlm = np.where(np.arange(16)[None] < 3, ids, -1).astype(np.int32)
    nsp = rng.integers(0, 2, (8,)).astype(np.int32)
    tt = np.zeros((8, 16), np.int32)
    params = _params(jm)
    jtr = JaxTrainer(jm, JaxAdam(1e-3), lambda m, b, k: m.loss(
        b["ids"], b["tt"], None, b["mlm"], b["nsp"], key=k, training=False),
        strategy=JaxShardingStrategy(mesh=jmesh, rules=JAX_DP_RULES,
                                     batch_axes=("dp", "ep")))
    jb = {k: jnp.asarray(v) for k, v in
          dict(ids=ids, tt=tt, mlm=mlm, nsp=nsp).items()}
    ref = [float(jtr.step(jb)["loss"]) for _ in range(2)]
    mesh = make_mesh(MeshSpec(dp=2, ep=4), **CPU)
    tm = BertMoEForPreTraining(bert_base(**kw), num_experts=4, top_k=1,
                               mesh=mesh, **CPU)
    load_jax_params(tm, params)
    tr = Trainer(tm, AdamOptimizer(1e-3), lambda m, b, k: m.loss(
        b["ids"], b["tt"], None, b["mlm"], b["nsp"], key=k, training=False),
        strategy=ShardingStrategy(mesh=mesh, rules=DP_RULES,
                                  batch_axes=("dp", "ep")))
    tb = {k: torch.from_numpy(v).long() for k, v in
          dict(ids=ids, tt=tt, mlm=mlm, nsp=nsp).items()}
    got = [float(tr.step(tb)["loss"]) for _ in range(2)]
    np.testing.assert_allclose(got, ref, rtol=TRACE_TOL)


# -- the 1.5D GCN ---------------------------------------------------------------


def _graph(n, e, seed):
    from hetu_tpu.models.gnn import dense_adjacency as jax_dense
    from hetu_tpu.models.gnn import normalize_adjacency as jax_norm
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e))
    edges, w = jax_norm(ei, n)
    return np.asarray(jax_dense(edges, w, n))


@pytest.mark.parametrize("grid", [(4, 2), (2, 4)])
def test_dist_spmm_15d_matches_jax(grid):
    n, f = 32, 8
    a = _graph(n, 100, 2)
    x = np.random.default_rng(2).normal(size=(n, f)).astype(np.float32)
    jmesh = Mesh(np.asarray(jax.devices()).reshape(grid), ("gr", "gc"))
    ref = jax_dist_spmm_15d(jnp.asarray(a), jnp.asarray(x), jmesh)
    mesh = make_grid_mesh({"gr": grid[0], "gc": grid[1]}, **CPU)
    xt = torch.from_numpy(x).requires_grad_()
    z = dist_spmm_15d(torch.from_numpy(a), xt, mesh)
    np.testing.assert_allclose(_np(z), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    (z ** 2).sum().backward()
    np.testing.assert_allclose(_np(xt.grad), 2 * a.T @ (a @ x), rtol=1e-5,
                               atol=1e-5)


def test_distgcn15d_forward_and_grads_match_jax():
    n, f = 16, 8
    a = _graph(n, 64, 3)
    x = np.random.default_rng(3).normal(size=(n, f)).astype(np.float32)
    jmesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("gr", "gc"))
    set_random_seed(4)
    jm = JaxDistGCN15D(f, 16, 4, jmesh)
    rng = np.random.default_rng(7)
    jm = jm.replace(bs=[jnp.asarray(rng.normal(size=b.shape), jnp.float32)
                        for b in jm.bs])
    jout, jg = jax.jit(jax.value_and_grad(
        lambda m, a, x: jnp.sum(m(a, x) ** 2)))(jm, jnp.asarray(a),
                                               jnp.asarray(x))
    tm = DistGCN15D(f, 16, 4, make_grid_mesh({"gr": 2, "gc": 4}, **CPU),
                    **CPU)
    load_jax_params(tm, _params(jm))
    out = tm(torch.from_numpy(a), torch.from_numpy(x))
    (out ** 2).sum().backward()
    np.testing.assert_allclose(float((out ** 2).sum()), float(jout),
                               rtol=1e-5)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    ref = {n: g for n, g in named_parameters(jg)}
    assert sorted(grads) == sorted(ref) == ["bs.0", "bs.1", "ws.0", "ws.1"]
    worst = _worst(grads, ref)
    assert worst[0] <= 1e-5, worst


# -- two processes ---------------------------------------------------------------

WORKER = textwrap.dedent("""
    import hashlib, json
    import numpy as np, torch
    torch.set_num_threads(1)   # one summation order, whatever the load
    import hetu_tpu_torch.launch as L
    L.initialize(device="cpu")
    import torch.distributed as dist
    from hetu_tpu_torch import AdamWOptimizer, Trainer
    from hetu_tpu_torch.models import DistGCN15D, dist_spmm_15d
    from hetu_tpu_torch.models.moe_lm import MoELM, MoELMConfig
    from hetu_tpu_torch.parallel import (DP_RULES, MeshSpec,
                                         ShardingStrategy,
                                         collectives as col,
                                         hierarchical_all_to_all,
                                         make_grid_mesh, make_mesh)
    cfg = MoELMConfig(**json.loads(%r))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 512,
                                                             (8, 32)))
    lf = lambda m, b, k: m.loss(b, training=True)
    out = {}
    for proc in (True, False):
        mesh = make_mesh(MeshSpec(ep=2), device="cpu", processes=proc)
        model = MoELM(cfg, mesh=mesh, device="cpu",
                      generator=torch.Generator().manual_seed(0))
        tr = Trainer(model, AdamWOptimizer(1e-3), lf,
                     strategy=ShardingStrategy(mesh=mesh, rules=DP_RULES,
                                               batch_axes=("dp", "ep")))
        col.reset_counts()
        losses = [float(tr.step(ids)["loss"])]
        sh = tr._sharded
        grads = ";".join(
            f"ep{c['ep']}:" + hashlib.sha1(b"".join(
                p.grad.numpy().tobytes() for p in m.parameters()
            )).hexdigest() for c, m in zip(sh.coords, sh.models))
        calls = col.counts()["all_to_all"]["calls"]
        losses += [float(tr.step(ids)["loss"]) for _ in range(2)]
        full = sh.full_parameters()
        digest = hashlib.sha1(b"".join(full[n].numpy().tobytes()
                                       for n in sorted(full))).hexdigest()
        out["proc" if proc else "local"] = dict(
            losses=losses, grads=grads, calls=calls, weights=digest)
    pmesh = make_mesh(MeshSpec(ep=2), device="cpu", processes=True)
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(8, 6)).astype(np.float32))
    mine = x.chunk(2)[dist.get_rank()]
    got = hierarchical_all_to_all([mine], "ep", "tp", split_dim=0,
                                  concat_dim=1, mesh=pmesh)[0]
    want = col.all_to_all(list(x.chunk(2)), split_dim=0,
                          concat_dim=1)[dist.get_rank()]
    out["a2a"] = bool(torch.equal(got, want))
    grid = make_grid_mesh({"gr": 1, "gc": 2}, device="cpu", processes=True)
    a = torch.from_numpy(np.random.default_rng(6).random(
        (16, 16)).astype(np.float32))
    m = DistGCN15D(8, 16, 4, grid, device="cpu",
                   generator=torch.Generator().manual_seed(1))
    xg = torch.from_numpy(np.random.default_rng(7).normal(
        size=(16, 8)).astype(np.float32))
    (m(a, xg) ** 2).sum().backward()
    m.ws[0].grad, g_proc = None, m.ws[0].grad.clone()
    local = make_grid_mesh({"gr": 1, "gc": 2}, device="cpu")
    m.mesh = local
    (m(a, xg) ** 2).sum().backward()
    out["gcn"] = float((g_proc - m.ws[0].grad).abs().max()
                       / m.ws[0].grad.abs().max())
    print("RESULT " + json.dumps({"rank": dist.get_rank(), **out}),
          flush=True)
    dist.destroy_process_group()
""")


def test_two_processes_equal_the_local_ep2_run():
    """Each process holds one ``ep`` rank of config B's model without
    ``sp``; the exchange is ``all_to_all`` over the ep process group,
    forward and backward.  Losses, each rank's step-0 gradients (an
    expert slice counted twice would change them) and the final weights
    equal the local ``ep=2`` mesh's bitwise.  The hierarchical exchange
    over ``("ep", "tp")`` and ``DistGCN15D`` over a ``1 x 2`` process grid
    agree with their local runs."""
    import json
    outs = simulate_workers(2, WORKER % json.dumps(CFG_B), timeout=150.0)
    rows = sorted((json.loads(line[len("RESULT "):]) for out in outs
                   for line in out.splitlines()
                   if line.startswith("RESULT")), key=lambda r: r["rank"])
    assert len(rows) == 2, outs
    for r in rows:
        assert r["proc"]["losses"] == r["local"]["losses"], r
        assert r["proc"]["weights"] == r["local"]["weights"], r
        assert r["a2a"] and r["gcn"] <= 1e-6, r
        assert r["proc"]["calls"] > 0
    theirs = dict(g.split(":") for g in rows[0]["local"]["grads"].split(";"))
    assert sorted(r["proc"]["grads"] for r in rows) == \
        [f"ep{c}:{theirs[f'ep{c}']}" for c in (0, 1)]
    losses = rows[0]["proc"]["losses"]
    assert losses[-1] < losses[0]

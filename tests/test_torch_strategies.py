"""The port's strategies (``hetu_tpu_torch.parallel.{spec,strategies}``,
``Trainer(strategy=)``) against the JAX package's, on the suite's virtual
CPU devices for the JAX side and local CPU meshes (plus gloo worlds of
processes) for the port:

- the sharding algebra: ``ShardState``, ``transition`` and
  ``AxisRules.physical`` over the JAX tests' cases;
- logical axes and ``resolve_specs`` for every parameter of GPT and BERT
  (torch's layout: reversed where a weight is stored transposed) and the
  presets' specs;
- rank shards: the ZeRO slot and Megatron shard shapes JAX's shardings
  give, the head-strided qkv and ceil-sized vocabulary pieces gathering
  back to the full weight, ``load_jax_params`` -> install ->
  ``export_params`` giving the JAX weights back under every preset, and
  whole weights loaded after install reaching every rank;
- 4-step Adam traces of ``tests/test_parallel.py``'s tiny GPT, at
  2e-5: DataParallel and MegatronTP(tp=4, dp=2) against the JAX
  strategies' traces and the JAX unsharded trace, ZeRO 1/2/3 against
  the unsharded one (the JAX ZeRO trace test is in the slow tier), and
  once more through flash and the streamed head's plain versions;
- two gloo processes training DataParallel and ZeRO stage 3 (the
  counterpart of ``test_two_process_dp_training_smoke``);
- ``plan_to_strategy`` against the JAX one, and the refusals.
"""

import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from hetu_tpu.core import set_random_seed
from hetu_tpu.core.module import named_parameters
from hetu_tpu.exec import Trainer as JaxTrainer
from hetu_tpu.models import GPT as JaxGPT
from hetu_tpu.models import gpt2_small as jax_gpt2_small
from hetu_tpu.optim import AdamOptimizer as JaxAdam
from hetu_tpu.parallel import spec as jspec
from hetu_tpu.parallel import strategies as jstrat
from hetu_tpu_torch import AdamOptimizer, Trainer, flash_attn_fn
from hetu_tpu_torch.interop import export_params, load_jax_params
from hetu_tpu_torch.launch import simulate_workers
from hetu_tpu_torch.models.gpt import GPT, GPTConfig
from hetu_tpu_torch.parallel import collectives as col
from hetu_tpu_torch.parallel import spec as tspec
from hetu_tpu_torch.parallel import strategies as tstrat
from hetu_tpu_torch.parallel.mesh import MeshSpec, make_mesh

CPU = dict(device="cpu")
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=16)
TOL = 2e-5


def _jax_tiny():
    set_random_seed(3)
    return JaxGPT(jax_gpt2_small(**TINY))


@pytest.fixture(scope="module")
def jax_params():
    return {n: np.asarray(a) for n, a in named_parameters(_jax_tiny())}


def _ids():
    return np.random.default_rng(0).integers(0, 64, (16, 12))


def _port_tiny(params, **kw):
    m = GPT(GPTConfig(**TINY, **kw), device="cpu",
            attn_fn=(flash_attn_fn(native_layout=True)
                     if kw.get("streamed_head_chunk") else None))
    load_jax_params(m, params)
    return m


def _loss(m, b, k):
    return m.loss(b), {}


def _port_trace(params, strategy, steps=4, **kw):
    tr = Trainer(_port_tiny(params, **kw), AdamOptimizer(1e-2), _loss,
                 strategy=strategy)
    ids = torch.from_numpy(_ids())
    return [float(tr.step(ids)["loss"]) for _ in range(steps)]


def _jax_trace(strategy, steps=4):
    import jax.numpy as jnp
    tr = JaxTrainer(_jax_tiny(), JaxAdam(1e-2),
                    lambda m, b, k: (m.loss(b["ids"]), {}),
                    strategy=strategy)
    b = {"ids": jnp.asarray(_ids(), jnp.int32)}
    return [float(tr.step(b, key=jax.random.key(0))["loss"])
            for _ in range(steps)]


def _mesh(**sizes):
    return make_mesh(MeshSpec(**sizes), **CPU)


def _norm(spec, ndim):
    """A spec as a full-length tuple (JAX's and the port's compare
    equal whatever their trailing Nones)."""
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


# -- the sharding algebra ------------------------------------------------------

def _states(mod):
    S = mod.ShardState
    return [S(), S().split(0, 4, "tp").replicate(2), S().make_partial(4),
            S().make_partial(4).reduce_partial(),
            S(splits={0: 4}, mesh_axes={0: ("tp",)}),
            S(splits={1: 4}, mesh_axes={1: ("tp",)}), S(duplicate=4),
            S().split(1, 2, "dp").split(1, 2, "tp")]


def test_shard_state_and_transition_equal_jax():
    js, ts = _states(jspec), _states(tspec)
    for j, t in zip(js, ts):
        assert t.device_count() == j.device_count()
        assert (t.splits, t.duplicate, t.partial, t.mesh_axes) == \
            (j.splits, j.duplicate, j.partial, j.mesh_axes)
        assert tuple(t.to_partition_spec(2)) == tuple(j.to_partition_spec(2))
    for a in range(len(js)):
        for b in range(len(js)):
            assert tspec.transition(ts[a], ts[b], 2) == \
                jspec.transition(js[a], js[b], 2), (a, b)
    assert tspec.transition(ts[2], ts[4], 2) == "reduce_scatter"
    assert tspec.transition(ts[4], ts[5], 2) == "all_to_all"


@pytest.mark.parametrize("rules", ["MEGATRON_RULES", "DP_RULES",
                                   "CNN_MP_RULES", "OWT_RULES",
                                   "custom"])
def test_axis_rules_physical_equal_jax(rules):
    if rules == "custom":
        j = jspec.AxisRules({"mlp": "tp", "embed": None})
        t = tspec.AxisRules({"mlp": "tp", "embed": None})
    else:
        mod_j = jspec if hasattr(jspec, rules) else jstrat
        mod_t = tspec if hasattr(tspec, rules) else tstrat
        j, t = getattr(mod_j, rules), getattr(mod_t, rules)
    for logical in [(), ("embed", "mlp"), ("mlp", "embed"),
                    (None, None, "conv_in", "conv_out"), ("in", "out"),
                    ("vocab", "embed"), ("qkv_three_heads",),
                    (("heads_merged", "mlp"), None), ("layers", "experts")]:
        assert tuple(t.physical(tspec.P(*logical))) == \
            tuple(j.physical(JP(*logical))), logical


# -- logical axes and specs ----------------------------------------------------

def _jax_specs(model, rules):
    """``{dotted name: PartitionSpec}``, named as ``named_parameters``
    names the model's leaves."""
    specs = jspec.resolve_specs(model, rules)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))[0]
    return {".".join(str(getattr(k, "name", getattr(k, "idx",
                                                    getattr(k, "key", k))))
                     for k in path): leaf for path, leaf in flat}


def _models(kind):
    from hetu_tpu.models.bert import BertConfig as JBC
    from hetu_tpu.models.bert import BertForPreTraining as JBert
    from hetu_tpu_torch.models.bert import BertConfig as TBC
    from hetu_tpu_torch.models.bert import BertForPreTraining as TBert
    set_random_seed(0)
    if kind == "gpt":
        kw = dict(TINY, tie_embeddings=False)
        return (JaxGPT(jax_gpt2_small(**kw)),
                GPT(GPTConfig(**kw), device="cpu"))
    kw = dict(vocab_size=50, hidden_size=16, num_layers=2, num_heads=2,
              max_position_embeddings=16)
    return JBert(JBC(**kw)), TBert(TBC(**kw), device="cpu")


@pytest.mark.parametrize("kind", ["gpt", "bert"])
@pytest.mark.parametrize("rules", ["MEGATRON_RULES", "DP_RULES"])
def test_resolve_specs_equal_jax_per_parameter(kind, rules):
    from hetu_tpu_torch.interop.from_jax import transposed_names
    jm, tm = _models(kind)
    jsp = _jax_specs(jm, getattr(jspec, rules))
    tsp = tspec.resolve_specs(tm, getattr(tspec, rules))
    assert sorted(jsp) == sorted(tsp)
    transposed = transposed_names(tm)
    params = dict(tm.named_parameters())
    for name, js in jsp.items():
        nd = params[name].dim()
        want = _norm(js, nd)
        if name in transposed:
            want = want[::-1]
        assert _norm(tsp[name], nd) == want, name


def test_presets_construct_and_resolve_specs():
    from hetu_tpu_torch.layers import Conv2d, Linear
    for factory in (lambda m: tstrat.ModelParallel4CNN(2, dp=4, mesh=m),
                    lambda m: tstrat.ModelParallel4LM(2, dp=4, mesh=m),
                    lambda m: tstrat.OneWeirdTrick4CNN(2, dp=4, mesh=m),
                    lambda m: tstrat.MegatronLM(2, dp=4, mesh=m)):
        strat = factory(_mesh(dp=4, tp=2))
        specs = strat.model_specs(Linear(16, 32, axes=(None, "mlp"), **CPU))
        assert tuple(specs["w"]) == ("tp", None)   # torch's (out, in)
    conv = tspec.resolve_specs(Conv2d(3, 8, **CPU), tstrat.CNN_MP_RULES)
    assert tuple(conv["w"]) == (None, None, None, "tp")
    assert tuple(tspec.resolve_specs(Conv2d(3, 8, **CPU),
                                     tstrat.OWT_RULES)["w"]) == (None,) * 4


def test_make_mesh_admits_dp_and_tp():
    m = _mesh(dp=2, tp=4)
    assert m.shape == {"pp": 1, "dp": 2, "ep": 1, "sp": 1, "tp": 4}
    assert m.groups("tp")[1] == [4, 5, 6, 7]
    assert m.groups("dp")[0] == [0, 4]
    assert m.coords(6) == {"pp": 0, "dp": 1, "ep": 0, "sp": 0, "tp": 2}


# -- rank shards -----------------------------------------------------------------

def test_zero_state_is_sharded(jax_params):
    strat = tstrat.ZeRO(1, mesh=_mesh(dp=8))
    model = _port_tiny(jax_params)
    specs = strat.opt_specs({"step": 0, "m": {}}, strat.model_specs(model),
                            model)
    assert tuple(specs["m"]["wte.weight"]) == ("dp", None)   # JAX: P("dp")
    assert tuple(specs["m"]["blocks.0.mlp.w_in"]) == (None, "dp")
    assert tuple(specs["step"]) == ()
    tr = Trainer(model, AdamOptimizer(1e-2), _loss, strategy=strat)
    # wte.weight is (64, 32): dim 0 divides over dp=8, so each rank's
    # slots hold 8 rows (JAX: P("dp") on the slot); the parameter stays
    # whole on every rank
    assert tuple(tr.opt_state["m"]["wte.weight"].shape) == (8, 32)
    assert tuple(tr.model.wte.weight.shape) == (64, 32)
    # a Linear weight shards the JAX layout's dim 0: torch's dim 1
    assert tuple(tr.opt_state["m"]["blocks.0.mlp.w_in"].shape) == (128, 4)
    z3 = Trainer(_port_tiny(jax_params), AdamOptimizer(1e-2), _loss,
                 strategy=tstrat.ZeRO(3, mesh=_mesh(dp=8)))
    # stage 3: the rank's module holds its slice of the parameter
    assert tuple(z3.model.wte.weight.shape) == (8, 32)


def test_zero3_frees_each_block_after_its_forward(jax_params):
    """Stage 3: no block's gathered parameter outlives the forward (the
    backward gathers what it saved again), and the step still equals
    the unsharded one."""
    import weakref
    tr = Trainer(_port_tiny(jax_params), AdamOptimizer(1e-2), _loss,
                 strategy=tstrat.ZeRO(3, mesh=_mesh(dp=2)))
    sh = tr._sharded
    gathered, gather = [], sh._gather

    def spy(i, mod, attrs, path=None):
        gather(i, mod, attrs, path)
        if path is not None:
            gathered.extend(weakref.ref(mod._parameters[a]) for a, _ in attrs)

    sh._gather = spy
    ids = torch.from_numpy(_ids())
    pieces = sh.split_batch(ids)
    col.reset_counts()
    out = sh.run(lambda i: _loss(sh.models[i], pieces[i], None))
    assert len(gathered) == 2 * 2 * 12   # ranks x blocks x parameters
    assert all(r() is None for r in gathered)
    forward_gathers = col.counts()["all_gather"]["calls"]
    torch.autograd.backward([o[0] for o in out])
    assert col.counts()["all_gather"]["calls"] > forward_gathers
    ref = _port_tiny(jax_params)
    _loss(ref, ids, None)[0].backward()
    for name, g in sh.full_parameters().items():
        assert g.shape == dict(ref.named_parameters())[name].shape
    grads = sh.reduce_grads()
    w = dict(ref.named_parameters())["blocks.0.mlp.w_in"].grad
    got = torch.cat([grads[k]["blocks.0.mlp.w_in"] for k in range(2)], 1)
    np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_megatron_params_sharded(jax_params):
    tr = Trainer(_port_tiny(jax_params), AdamOptimizer(1e-2), _loss,
                 strategy=tstrat.MegatronTP(tp=4, dp=2,
                                            mesh=_mesh(dp=2, tp=4)))
    blk = tr.model.blocks[0]
    # JAX: w_in P(None, "tp") (in, out) -> torch (out/tp, in)
    assert tuple(blk.mlp.w_in.shape) == (32, 32)
    assert tuple(blk.attn.wo.shape) == (32, 8)     # P("tp", None) in JAX
    assert tuple(blk.attn.wqkv.shape) == (24, 32)
    assert blk.attn.num_heads == 1
    assert len(tr._sharded.models) == 8


def test_qkv_shards_are_head_strided_and_gather_back():
    E, H, tp = 8, 4, 2
    w = torch.arange(3 * E * E, dtype=torch.float32).reshape(3 * E, E)
    spec, blocks = ("tp", None), tspec.blocks_of(
        ("qkv_three_heads", "embed"))
    mesh_shape = {"tp": tp}
    pieces = [tspec.shard_param(w, spec, {"tp": t}, mesh_shape, blocks)
              for t in range(tp)]
    hd = E // H
    per = E // tp
    for t, p in enumerate(pieces):
        # rank t: its heads' q rows, then its k rows, then its v rows
        want = torch.cat([w[b * E + t * per:b * E + (t + 1) * per]
                          for b in range(3)])
        assert torch.equal(p, want)
        assert p.shape[0] == 3 * (H // tp) * hd
    back = tspec.gather_param(pieces, w.shape, spec,
                              [{"tp": t} for t in range(tp)], mesh_shape,
                              blocks)
    assert torch.equal(back, w)


@pytest.mark.parametrize("tp,sizes", [(2, [25129, 25128]),
                                      (4, [12565, 12565, 12565, 12562])])
def test_uneven_vocab_takes_ceil_sized_pieces(tp, sizes):
    got = [len(tspec.shard_index((50257, 1), ("tp", None), {"tp": t},
                                 {"tp": tp})[0]) for t in range(tp)]
    assert got == sizes
    w = torch.randn(61, 3)
    pieces = [tspec.shard_param(w, ("tp",), {"tp": t}, {"tp": tp})
              for t in range(tp)]
    assert torch.equal(tspec.gather_param(
        pieces, w.shape, ("tp",), [{"tp": t} for t in range(tp)],
        {"tp": tp}), w)


PRESETS = {
    "DataParallel": lambda: tstrat.DataParallel(mesh=_mesh(dp=4)),
    "ZeRO1": lambda: tstrat.ZeRO(1, mesh=_mesh(dp=4)),
    "ZeRO2": lambda: tstrat.ZeRO(2, mesh=_mesh(dp=4)),
    "ZeRO3": lambda: tstrat.ZeRO(3, mesh=_mesh(dp=4)),
    "MegatronTP": lambda: tstrat.MegatronTP(4, dp=2, mesh=_mesh(dp=2, tp=4)),
    "ModelParallel4LM": lambda: tstrat.ModelParallel4LM(
        2, dp=2, mesh=_mesh(dp=2, tp=2), zero_stage=1),
    "MegatronLM": lambda: tstrat.MegatronLM(2, dp=2, mesh=_mesh(dp=2, tp=2),
                                            zero_stage=3),
    # on GPT these shard the MLP's "mlp" columns and rows only
    "OneWeirdTrick4CNN": lambda: tstrat.OneWeirdTrick4CNN(
        2, dp=2, mesh=_mesh(dp=2, tp=2)),
    "ModelParallel4CNN": lambda: tstrat.ModelParallel4CNN(
        2, mesh=_mesh(tp=2)),
}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_load_install_export_round_trip(preset, jax_params):
    """JAX weights in, each rank holding its shards, the JAX weights back
    out (untied head too, 61 rows: an uneven vocabulary)."""
    set_random_seed(5)
    jm = JaxGPT(jax_gpt2_small(**dict(TINY, vocab_size=61,
                                       tie_embeddings=False)))
    params = {n: np.asarray(a) for n, a in named_parameters(jm)}
    tm = GPT(GPTConfig(**dict(TINY, vocab_size=61, tie_embeddings=False)),
             **CPU)
    load_jax_params(tm, params)
    tr = Trainer(tm, AdamOptimizer(1e-2), _loss, strategy=PRESETS[preset]())
    out = export_params(tr.model)
    assert sorted(out) == sorted(params)
    for n, a in params.items():
        np.testing.assert_array_equal(out[n], a, err_msg=n)


LOADS = {
    "dp2": lambda: tstrat.DataParallel(mesh=_mesh(dp=2)),
    "zero1": lambda: tstrat.ZeRO(1, mesh=_mesh(dp=2)),
    "zero3": lambda: tstrat.ZeRO(3, mesh=_mesh(dp=2)),
    "tp2dp2": lambda: tstrat.MegatronTP(2, dp=2, mesh=_mesh(dp=2, tp=2)),
}


@pytest.mark.parametrize("arm", list(LOADS))
def test_loading_after_install_reaches_every_rank(arm, jax_params):
    """Whole weights loaded into a trainer under a strategy that started
    from other weights reach every rank it holds: an unsharded trainer's
    checkpoint (``load_trainer_state``) continues its trace, the dp
    replicas stay equal, and ``load_jax_params`` after install gives the
    JAX weights back through ``export_params``."""
    from hetu_tpu_torch.exec.checkpoint import (load_trainer_state,
                                                trainer_state_dict)
    ids = torch.from_numpy(_ids())

    def other():
        return GPT(GPTConfig(**TINY), device="cpu",
                   generator=torch.Generator().manual_seed(9))

    ref = Trainer(_port_tiny(jax_params), AdamOptimizer(1e-2), _loss)
    first = float(ref.step(ids)["loss"])
    tr = Trainer(other(), AdamOptimizer(1e-2), _loss, strategy=LOADS[arm]())
    load_trainer_state(tr, trainer_state_dict(ref))
    assert tr.opt_state["step"] == ref.opt_state["step"] == 1
    want = [float(ref.step(ids)["loss"]) for _ in range(2)]
    got = [float(tr.step(ids)["loss"]) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=TOL)
    sh = tr._sharded
    for i, c in enumerate(sh.coords):
        for j in range(i + 1, len(sh.coords)):
            if sh.coords[j]["tp"] != c["tp"]:
                continue
            for (n, p), q in zip(sh.models[i].named_parameters(),
                                 sh.models[j].parameters()):
                if sh.stage < 3 or sh.place[n].zdim is None:
                    assert torch.equal(p, q), (n, i, j)
    tr2 = Trainer(other(), AdamOptimizer(1e-2), _loss,
                  strategy=LOADS[arm]())
    load_jax_params(tr2.model, jax_params)
    out = export_params(tr2.model)
    for n, a in jax_params.items():
        np.testing.assert_array_equal(out[n], a, err_msg=n)
    np.testing.assert_allclose(float(tr2.step(ids)["loss"]), first,
                               rtol=TOL)


def test_owt_linear_is_column_parallel_then_gathered():
    from hetu_tpu_torch.layers import MLPTower
    m = MLPTower([16, 32, 8], final_relu=False, **CPU,
                 generator=torch.Generator().manual_seed(0))
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    ref = m(x)
    refl = (ref ** 2).mean()
    refl.backward()
    ref_g = {n: p.grad.clone() for n, p in m.named_parameters()}
    tr = Trainer(m, AdamOptimizer(1e-2),
                 lambda mm, b, k: ((mm(b) ** 2).mean(), {}),
                 strategy=tstrat.OneWeirdTrick4CNN(2, dp=2,
                                                   mesh=_mesh(dp=2, tp=2)))
    sh = tr._sharded
    out = sh.forward_backward(tr.loss_fn, x, None)
    loss = sh.mean_loss([o[0] for o in out])
    np.testing.assert_allclose(float(loss), float(refl.detach()), rtol=1e-6)
    grads = sh.reduce_grads()
    w0 = dict(sh.models[0].named_parameters())["layers.0.w"]
    assert tuple(w0.shape) == (16, 16)
    np.testing.assert_allclose(grads[0]["layers.0.w"].numpy(),
                               ref_g["layers.0.w"][:16].numpy(), rtol=1e-5,
                               atol=1e-7)


# -- training traces -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_traces():
    return {"none": _jax_trace(None),
            "dp": _jax_trace(jstrat.DataParallel()),
            "tp": _jax_trace(jstrat.MegatronTP(tp=4, dp=2))}


PORT = {
    "dp": lambda: tstrat.DataParallel(mesh=_mesh(dp=8)),
    "tp": lambda: tstrat.MegatronTP(tp=4, dp=2, mesh=_mesh(dp=2, tp=4)),
    "zero1": lambda: tstrat.ZeRO(1, mesh=_mesh(dp=8)),
    "zero2": lambda: tstrat.ZeRO(2, mesh=_mesh(dp=8)),
    "zero3": lambda: tstrat.ZeRO(3, mesh=_mesh(dp=8)),
}


@pytest.mark.parametrize("head", ["materialized", "flash_streamed"])
@pytest.mark.parametrize("arm", list(PORT))
def test_trace_equals_jax(arm, head, jax_params, jax_traces):
    kw = {} if head == "materialized" else dict(streamed_head_chunk=16)
    col.reset_counts()
    got = _port_trace(jax_params, PORT[arm](), **kw)
    np.testing.assert_allclose(got, jax_traces["none"], rtol=TOL)
    if arm in jax_traces:
        np.testing.assert_allclose(got, jax_traces[arm], rtol=TOL)
    kinds = col.counts()
    # the gradient reduction shows in the collectives' counters
    want = "reduce_scatter" if arm.startswith("zero") else "all_reduce"
    assert kinds[want]["calls"] >= 4, kinds
    assert got[-1] < got[0]


def test_trace_control_swapped_shards_fails_the_tolerance(jax_params,
                                                          jax_traces):
    """A control: two ranks' MLP shards swapped must leave the traces."""
    tr = Trainer(_port_tiny(jax_params), AdamOptimizer(1e-2), _loss,
                 strategy=PORT["tp"]())
    a, b = tr._sharded.models[0].blocks[0].mlp, tr._sharded.models[1].blocks[0].mlp
    with torch.no_grad():
        wa = a.w_in.detach().clone()
        a.w_in.copy_(b.w_in)
        b.w_in.copy_(wa)
    ids = torch.from_numpy(_ids())
    got = [float(tr.step(ids)["loss"]) for _ in range(4)]
    rel = np.max(np.abs(np.array(got) - jax_traces["none"])
                 / np.abs(jax_traces["none"]))
    assert rel > TOL, rel


# -- two processes ---------------------------------------------------------------

WORKER = textwrap.dedent("""
    import numpy as np, torch
    torch.set_num_threads(1)   # one summation order, whatever the load
    import hetu_tpu_torch.launch as L
    L.initialize(device="cpu")
    import torch.distributed as dist
    from hetu_tpu_torch import AdamOptimizer, Trainer
    from hetu_tpu_torch.models.gpt import GPT, GPTConfig
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    from hetu_tpu_torch.parallel.strategies import DataParallel, ZeRO
    from hetu_tpu_torch.parallel.autoparallel.profiler import CostProfiler
    cfg = GPTConfig(vocab_size=256, hidden_size=32, num_layers=2,
                    num_heads=2, max_seq_len=16)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 16)))
    lf = lambda m, b, k: (m.loss(b), {})
    out = {}
    for kind, strat in (("dp", DataParallel), ("z3", lambda mesh: ZeRO(
            3, mesh=mesh))):
        for proc in (True, False):
            mesh = make_mesh(MeshSpec(dp=2), device="cpu", processes=proc)
            tr = Trainer(GPT(cfg, device="cpu"), AdamOptimizer(1e-3), lf,
                         strategy=strat(mesh=mesh))
            out[kind, proc] = [float(tr.step(ids)["loss"])
                               for _ in range(3)]
    bw = CostProfiler(device="cpu").collective_bandwidth(
        make_mesh(MeshSpec(dp=2), device="cpu", processes=True), "dp",
        nbytes=1 << 16)
    print(f"RESULT pid={dist.get_rank()} " + " ".join(
          f"{k}{'proc' if p else 'local'}=" + ",".join(f"{x!r}" for x in v)
          for (k, p), v in out.items()) + f" bw={bw!r}", flush=True)
    # a world left up at exit can abort in gloo's threads
    dist.destroy_process_group()
""")


def test_two_process_dp_training_smoke():
    outs = simulate_workers(2, WORKER, timeout=150.0)
    results = sorted(line for out in outs for line in out.splitlines()
                     if line.startswith("RESULT"))
    assert len(results) == 2, outs
    fields = [dict(kv.split("=") for kv in r.split()[1:]) for r in results]
    for kind in ("dp", "z3"):    # DataParallel, and ZeRO stage 3
        assert fields[0][kind + "proc"] == fields[1][kind + "proc"]
        assert fields[0][kind + "proc"] == fields[0][kind + "local"]
        losses = [float(x) for x in fields[0][kind + "proc"].split(",")]
        assert losses[-1] < losses[0]
    assert fields[0]["z3proc"] == fields[0]["dpproc"]
    assert all(0 < float(f["bw"]) < float("inf") for f in fields)


# -- plan_to_strategy and refusals ------------------------------------------------

def test_plan_to_strategy_equals_jax():
    from hetu_tpu.parallel.autoparallel import search as J
    from hetu_tpu_torch.parallel.autoparallel import search as T
    from hetu_tpu.parallel.autoparallel.cost_model import \
        transformer_layer_spec as jlayer
    from hetu_tpu_torch.parallel.autoparallel.cost_model import \
        transformer_layer_spec as tlayer
    cl = dict(n_devices=8, hbm_bytes=16e9, peak_flops=197e12,
              ici_bandwidth=4.5e10, dcn_bandwidth=2.5e10)
    for fn in ("dp_search", "gpipe_search"):
        jp = getattr(J, fn)([jlayer(2048, 512) for _ in range(8)],
                            J.ClusterSpec(**cl), global_batch=32)
        tp_ = getattr(T, fn)([tlayer(2048, 512) for _ in range(8)],
                             T.ClusterSpec(**cl), global_batch=32)
        jp, tp_ = (jp[0], tp_[0]) if isinstance(jp, tuple) else (jp, tp_)
        jspec_, jkw = J.plan_to_strategy(jp)
        tspec_, tkw = T.plan_to_strategy(tp_)
        assert (tspec_.dp, tspec_.tp, tspec_.pp) == \
            (jspec_.dp, jspec_.tp, jspec_.pp), fn
        assert tkw["zero_stage"] == jkw["zero_stage"]
        assert tkw["batch_axes"] == jkw["batch_axes"] == "dp"
        assert tkw["rules"].rules == jkw["rules"].rules


def test_refusals(jax_params):
    from hetu_tpu_torch.layers import Conv2d
    from hetu_tpu_torch.optim.optimizers import LambOptimizer
    assert _mesh(pp=2, dp=2).shape["pp"] == 2        # pipelines run now
    tr = Trainer(_port_tiny(jax_params), AdamOptimizer(1e-2), _loss,
                 strategy=tstrat.MegatronLM(2, pp=2, mesh=_mesh(pp=2, tp=2)))
    assert len(tr._sharded.models) == 4
    assert _mesh(sp=2, tp=2).shape["sp"] == 2     # sequence parallelism too
    with pytest.raises(NotImplementedError, match="part 12"):
        _mesh(sp=2, pp=2)
    assert _mesh(ep=2, tp=2).shape["ep"] == 2     # expert parallelism too
    with pytest.raises(NotImplementedError, match="item 11"):
        tstrat.ShardingStrategy(batch_axes=("dp", "tp"))
    conv = torch.nn.Sequential(Conv2d(3, 8, **CPU))
    with pytest.raises(NotImplementedError, match="item 10 part 7"):
        Trainer(conv, AdamOptimizer(1e-2), _loss,
                strategy=tstrat.ModelParallel4CNN(2, mesh=_mesh(tp=2)))
    from hetu_tpu_torch.embed import StagedHostEmbedding
    staged = StagedHostEmbedding(16, 4, **CPU)
    with pytest.raises(ValueError, match="StagedHostEmbedding"):
        Trainer(staged, AdamOptimizer(1e-2), _loss,
                strategy=tstrat.DataParallel(mesh=_mesh(dp=2)))
    tr = Trainer(_port_tiny(jax_params), AdamOptimizer(1e-2), _loss,
                 strategy=tstrat.ZeRO(1, mesh=_mesh(dp=2)))
    with pytest.raises(NotImplementedError, match="host-offloaded"):
        tr.offload_optimizer_state()
    with pytest.raises(NotImplementedError, match="sharding strategy"):
        tr.state = tr.state
    with pytest.raises(NotImplementedError, match="remat"):
        Trainer(_port_tiny(jax_params, remat="full"), AdamOptimizer(1e-2),
                _loss, strategy=tstrat.ZeRO(3, mesh=_mesh(dp=2)))
    tr.grad_guard = lambda metrics: True
    with pytest.raises(NotImplementedError, match="grad_guard"):
        tr.step(torch.from_numpy(_ids()))
    with pytest.raises(NotImplementedError, match="LAMB"):
        Trainer(_port_tiny(jax_params), LambOptimizer(1e-2), _loss,
                strategy=tstrat.ZeRO(1, mesh=_mesh(dp=2)))

"""The port's GPipe pipeline (``hetu_tpu_torch.parallel.pipeline``) and
pipelines under a strategy against the JAX package's, on the suite's
virtual CPU devices for the JAX side and local CPU meshes (plus a gloo
world of two processes) for the port:

- ``stage_partition`` over a grid; ``stack_modules`` refusing unequal
  blocks;
- ``spmd_pipeline`` and ``Pipelined`` on pp=4 x dp=2, Tiny blocks and
  ``TransformerBlock``s, the JAX weights carried across: forward 1e-5,
  gradients 1e-4, with dropout 0.1 and one key on both the pipelined
  and the degenerate path (the masks are equal because the keys are
  bitwise), and a control with two stages' blocks swapped;
- config A's composition (``__graft_entry__.py``: dp=2, tp=2, pp=2,
  Megatron rules, ZeRO-1): a 4-step Adam trace against the JAX
  ``Trainer``'s at 2e-5, the ZeRO placement against the JAX
  ``opt_specs`` leaf by leaf, and ``load_jax_params`` -> install ->
  ``export_params`` and the checkpoint layout giving the JAX arrays
  back bitwise;
- two gloo processes at pp=2 against the local pp=2 run (bitwise), and
  ``plan_to_strategy`` of a pipelined plan training.
"""

import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from hetu_tpu.core import set_random_seed
from hetu_tpu.core.module import Module as JModule
from hetu_tpu.core.rng import next_key
from hetu_tpu.exec import Trainer as JaxTrainer
from hetu_tpu.init import normal as jnormal
from hetu_tpu.layers import TransformerBlock as JBlock
from hetu_tpu.optim import AdamOptimizer as JaxAdam
from hetu_tpu.parallel import pipeline as JPL
from hetu_tpu.parallel import spec as jspec
from hetu_tpu.parallel import strategies as jstrat
from hetu_tpu.parallel.mesh import MeshSpec as JMeshSpec
from hetu_tpu.parallel.mesh import make_mesh as jmake_mesh
from hetu_tpu_torch import AdamOptimizer, Trainer
from hetu_tpu_torch.core import prng
from hetu_tpu_torch.interop import export_params, load_jax_params
from hetu_tpu_torch.launch import simulate_workers
from hetu_tpu_torch.layers import TransformerBlock
from hetu_tpu_torch.parallel import collectives as col
from hetu_tpu_torch.parallel import pipeline as TPL
from hetu_tpu_torch.parallel import strategies as tstrat
from hetu_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from hetu_tpu_torch.parallel.spec import MEGATRON_RULES

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_pipelm import PipeLM, jax_named, jax_pipelm  # noqa: E402

TOL = 2e-5


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(JMeshSpec(pp=4, dp=2), devices=jax.devices())


def _tmesh(**kw):
    return make_mesh(MeshSpec(**kw), device="cpu")


class JTiny(JModule):
    def __init__(self, d):
        self.w = jnormal(stddev=0.5)(next_key(), (d, d), jnp.float32)
        self.w_axes = ("in", "out")

    def __call__(self, x, mask=None, *, key=None, training=False):
        return jnp.tanh(x @ self.w) + x


class Tiny(torch.nn.Module):
    _logical_axes = {"w": ("in", "out")}

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(np.asarray(w)))

    def forward(self, x, mask=None, *, key=None, training=False):
        return torch.tanh(x @ self.w) + x


def test_stage_partition_and_stacks():
    for n in range(1, 13):
        for s in range(1, n + 1):
            assert [list(r) for r in TPL.stage_partition(n, s)] == \
                [list(r) for r in JPL.stage_partition(n, s)]
    with pytest.raises(ValueError, match="differs"):
        TPL.stack_modules([Tiny(np.zeros((4, 4), np.float32)),
                           Tiny(np.zeros((4, 5), np.float32))])
    with pytest.raises(ValueError, match="not divisible"):
        TPL.Pipelined([Tiny(np.zeros((4, 4), np.float32))] * 3,
                      n_microbatches=2, mesh=_tmesh(pp=2))


def test_spmd_pipeline_equals_jax(jmesh):
    set_random_seed(0)
    blocks = [JTiny(8) for _ in range(4)]
    x = np.random.default_rng(0).normal(size=(8, 16, 8)).astype(np.float32)
    want = jax.jit(lambda p, v: JPL.spmd_pipeline(
        lambda blk, h, ex, k: blk(h), p, v, mesh=jmesh,
        n_microbatches=4))(JPL.stack_modules(blocks), jnp.asarray(x))
    stages = [Tiny(b.w) for b in blocks]
    got = TPL.spmd_pipeline(lambda blk, h, ex, k: blk(h), stages,
                            torch.tensor(x), mesh=_tmesh(pp=4, dp=2),
                            n_microbatches=4)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    stacked = {"w": torch.stack([s.w.detach() for s in stages])}
    got2 = TPL.spmd_pipeline(lambda W, h, ex, k: torch.tanh(h @ W["w"]) + h,
                             stacked, torch.tensor(x),
                             mesh=_tmesh(pp=4, dp=2), n_microbatches=4)
    np.testing.assert_array_equal(got2.numpy(), got.detach().numpy())


@pytest.mark.parametrize("remat", ["full", "none"])
def test_pipelined_tiny_fwd_and_grad_equal_jax(jmesh, remat):
    set_random_seed(1)
    blocks = [JTiny(8) for _ in range(8)]
    x = np.random.default_rng(1).normal(size=(8, 4, 8)).astype(np.float32)
    jpipe = JPL.Pipelined(blocks, n_microbatches=4, mesh=jmesh, remat=remat)
    loss = lambda m, v: (m(v) ** 2).mean()  # noqa: E731
    jl, jg = jax.jit(jax.value_and_grad(loss))(jpipe, jnp.asarray(x))
    for mesh in (_tmesh(pp=4, dp=2), None):
        pipe = TPL.Pipelined([Tiny(np.zeros((8, 8), np.float32))
                              for _ in range(8)], n_microbatches=4,
                             mesh=mesh, remat=remat)
        load_jax_params(pipe, jax_named(jpipe))
        out = loss(pipe, torch.tensor(x))
        out.backward()
        np.testing.assert_allclose(float(out.detach()), float(jl), rtol=1e-5)
        got = np.stack([b.w.grad.numpy() for b in pipe.stacked])
        np.testing.assert_allclose(got, np.asarray(jg.stacked.w), rtol=1e-4,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def jax_dropout_pipe(jmesh):
    """``TransformerBlock``s through the JAX pipeline, dropout 0.1 under
    one key: the pipelined and the degenerate path's losses and
    gradients."""
    set_random_seed(2)
    blocks = [JBlock(16, 4, causal=True, dropout_rate=0.1)
              for _ in range(4)]
    x = np.random.default_rng(2).normal(size=(8, 12, 16)).astype(np.float32)
    out = {"x": x}
    for name, mesh in (("pp", jmesh), ("seq", None)):
        pipe = JPL.Pipelined(blocks, n_microbatches=2, mesh=mesh,
                             remat="full")
        loss = lambda m, v: (m(v, key=jax.random.key(7),  # noqa: E731
                               training=True) ** 2).mean()
        val, g = jax.jit(jax.value_and_grad(loss))(pipe, jnp.asarray(x))
        out[name] = (float(val), jax_named(g))
        out["params"] = jax_named(pipe)
    return out


@pytest.mark.parametrize("path", ["pp", "seq", "swapped"])
def test_pipelined_blocks_with_dropout_equal_jax(jax_dropout_pipe, path):
    ref = jax_dropout_pipe
    mesh = None if path == "seq" else _tmesh(pp=4, dp=2)
    pipe = TPL.Pipelined([TransformerBlock(16, 4, causal=True,
                                           dropout_rate=0.1, device="cpu")
                          for _ in range(4)], n_microbatches=2, mesh=mesh)
    load_jax_params(pipe, ref["params"])
    if path == "swapped":
        # the control: stages 0 and 1 hold each other's blocks
        b = pipe.stacked
        b[0], b[1] = b[1], b[0]
    val = (pipe(torch.tensor(ref["x"]), key=prng.key(7), training=True)
           ** 2).mean()
    val.backward()
    want_val, want_g = ref["seq" if path == "seq" else "pp"]
    if path == "swapped":
        assert abs(float(val) - want_val) > 1e-4 * abs(want_val)
        return
    np.testing.assert_allclose(float(val), want_val, rtol=1e-5)
    got = export_params(_grads_as_params(pipe))
    for name, g in want_g.items():
        np.testing.assert_allclose(got[name], g, rtol=1e-4, atol=2e-6,
                                   err_msg=name)


def _grads_as_params(model):
    """A copy of ``model`` whose parameters hold its gradients."""
    import copy
    m = copy.deepcopy(model)
    with torch.no_grad():
        for (_, p), (_, q) in zip(model.named_parameters(),
                                  m.named_parameters()):
            q.copy_(p.grad)
    return m


# -- config A: dp x tp x pp, Megatron rules, ZeRO-1 ----------------------------

V, D, H, L, SEQ = 64, 32, 4, 4, 8


def _ids():
    return np.random.default_rng(0).integers(0, V, (8, SEQ))


def _jax_config_a():
    mesh = jmake_mesh(JMeshSpec(dp=2, tp=2, pp=2), devices=jax.devices())
    set_random_seed(5)
    return mesh, jax_pipelm(V, D, H, L, mesh=mesh, n_microbatches=2)


@pytest.fixture(scope="module")
def config_a():
    mesh, jm = _jax_config_a()
    params = jax_named(jm)
    strat = jstrat.ShardingStrategy(mesh=mesh, rules=jspec.MEGATRON_RULES,
                                    batch_axes="dp", zero_stage=1)
    mspec = strat.model_specs(jm)
    ospec = strat.opt_specs(JaxAdam(1e-2).init(jm), mspec, jm)
    flat = jax.tree_util.tree_flatten_with_path(
        ospec["m"], is_leaf=lambda x: isinstance(x, JP))[0]
    slot_specs = {".".join(str(getattr(k, "name", getattr(k, "key", k)))
                           for k in path): tuple(leaf)
                  for path, leaf in flat}
    tr = JaxTrainer(jm, JaxAdam(1e-2), lambda m, b, k: (m.loss(b["ids"]), {}),
                    strategy=strat)
    b = {"ids": jnp.asarray(_ids(), jnp.int32)}
    trace = [float(tr.step(b, key=jax.random.key(0))["loss"])
             for _ in range(4)]
    return params, slot_specs, trace


def _port_config_a(params, remat="none", zero=1):
    mesh = _tmesh(dp=2, tp=2, pp=2)
    m = PipeLM(V, D, H, L, mesh=mesh, n_microbatches=2, remat=remat)
    load_jax_params(m, params)
    tr = Trainer(m, AdamOptimizer(1e-2), lambda mm, b, k: (mm.loss(b), {}),
                 strategy=tstrat.ShardingStrategy(
                     mesh=mesh, rules=MEGATRON_RULES, zero_stage=zero))
    return m, tr


def test_config_a_trace_equals_jax(config_a):
    params, _, trace = config_a
    _, tr = _port_config_a(params)
    col.reset_counts()
    ids = torch.from_numpy(_ids())
    got = [float(tr.step(ids)["loss"]) for _ in range(4)]
    np.testing.assert_allclose(got, trace, rtol=TOL)
    assert col.counts()["ppermute"]["calls"] > 0


def test_config_a_zero_placement_equals_jax_opt_specs(config_a):
    params, slot_specs, _ = config_a
    _, tr = _port_config_a(params)
    sh = tr._sharded
    seen = set()
    for name, pl in sh.place.items():
        jname, jdim = name, pl.zdim
        if name in sh.stacked:
            parts = name.split(".")
            k = parts.index("stacked")
            jname = ".".join(parts[:k + 1] + parts[k + 2:])
        if jdim is not None and name in sh.transposed:
            jdim = len(pl.shape) - 1 - jdim
        if name in sh.stacked and jdim is not None:
            jdim += 1
        want = [d for d, e in enumerate(slot_specs[jname]) if e == "dp"]
        assert want == ([] if jdim is None else [jdim]), (name, want, jdim)
        seen.add(jname)
    assert seen == set(slot_specs)
    # only the parameters outside the stack are ZeRO-sharded
    assert all(sh.place[n].zdim is None for n in sh.stacked)
    assert any(pl.zdim is not None for pl in sh.place.values())


def test_config_a_bridge_round_trip_bitwise(config_a):
    from hetu_tpu_torch.exec import checkpoint
    params = config_a[0]
    m, tr = _port_config_a(params)
    got = export_params(m)
    assert sorted(got) == sorted(params)
    for name, a in params.items():
        np.testing.assert_array_equal(got[name], a, err_msg=name)
    # rank 0 holds stage 0's blocks only
    assert len(list(m.blocks.stacked[0].parameters())) > 0
    assert len(list(m.blocks.stacked[L - 1].parameters())) == 0
    # an unsharded model's checkpoint keeps the JAX layout too
    plain = PipeLM(V, D, H, L, mesh=None, n_microbatches=2)
    load_jax_params(plain, params)
    sd = checkpoint.state_dict(plain)
    assert sorted(sd) == sorted(params)
    again = PipeLM(V, D, H, L, mesh=None, n_microbatches=2)
    checkpoint.load_state_dict(again, sd)
    for name, a in export_params(again).items():
        np.testing.assert_array_equal(a, params[name], err_msg=name)


def test_local_remat_under_tp_refused(config_a):
    with pytest.raises(NotImplementedError, match="remat"):
        _port_config_a(config_a[0], remat="full")


# -- processes and plans ---------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys, numpy as np, torch
    sys.path.insert(0, "tests")
    torch.set_num_threads(1)   # one summation order, whatever the load
    import hetu_tpu_torch.launch as L
    L.initialize(device="cpu")
    import torch.distributed as dist
    from _torch_pipelm import PipeLM
    from hetu_tpu_torch import AdamOptimizer, Trainer
    from hetu_tpu_torch.interop import export_params
    from hetu_tpu_torch.parallel import MeshSpec, make_mesh
    from hetu_tpu_torch.parallel import collectives as col
    from hetu_tpu_torch.parallel.strategies import ShardingStrategy
    from hetu_tpu_torch.parallel.spec import MEGATRON_RULES
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (8, 12)))
    lf = lambda m, b, k: (m.loss(b), {})
    out = {}
    for proc in (True, False):
        mesh = make_mesh(MeshSpec(pp=2), device="cpu", processes=proc)
        m = PipeLM(64, 32, 4, 4, mesh=mesh, n_microbatches=4)
        tr = Trainer(m, AdamOptimizer(1e-2), lf,
                     strategy=ShardingStrategy(mesh=mesh,
                                               rules=MEGATRON_RULES))
        col.reset_counts()
        out[proc] = [float(tr.step(ids)["loss"]) for _ in range(3)]
        hops = col.counts()["ppermute"]["calls"]
        full = export_params(m)
        out[str(proc) + "w"] = [float(np.abs(v).sum())
                                for _, v in sorted(full.items())]
    print(f"RESULT pid={dist.get_rank()} hops={hops} " + " ".join(
        f"{k}=" + ",".join(repr(x) for x in v) for k, v in out.items()),
        flush=True)
    dist.destroy_process_group()
""")


def test_two_process_pipeline_equals_local():
    outs = simulate_workers(2, WORKER, timeout=150.0)
    results = sorted(line for out in outs for line in out.splitlines()
                     if line.startswith("RESULT"))
    assert len(results) == 2, outs
    fields = [dict(kv.split("=") for kv in r.split()[1:]) for r in results]
    for f in fields:
        assert f["True"] == f["False"]          # losses bitwise
        assert f["Truew"] == f["Falsew"]        # trained weights
    assert fields[0]["True"] == fields[1]["True"]
    losses = [float(x) for x in fields[0]["True"].split(",")]
    assert losses[-1] < losses[0]


def test_plan_to_strategy_pipelined_plan_trains():
    from hetu_tpu_torch.parallel.autoparallel import search as S
    from hetu_tpu_torch.parallel.autoparallel.cost_model import \
        transformer_layer_spec as tlayer
    cl = dict(n_devices=8, hbm_bytes=16e9, peak_flops=197e12,
              ici_bandwidth=4.5e10, dcn_bandwidth=2.5e10)
    plan = S.gpipe_search([tlayer(2048, 512) for _ in range(8)],
                          S.ClusterSpec(**cl), global_batch=32)
    plan = plan[0] if isinstance(plan, tuple) else plan
    spec, kw = S.plan_to_strategy(plan)
    assert spec.pp == plan.pp > 1
    mesh = make_mesh(spec, device="cpu")
    m = PipeLM(V, D, H, 2 * spec.pp, mesh=mesh, n_microbatches=2)
    tr = Trainer(m, AdamOptimizer(1e-2), lambda mm, b, k: (mm.loss(b), {}),
                 strategy=tstrat.ShardingStrategy(mesh=mesh, **kw))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, V, (2 * spec.dp, SEQ)))
    losses = [float(tr.step(ids)["loss"]) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]

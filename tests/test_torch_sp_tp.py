"""The port's sequence parallelism beside data and tensor parallelism
(``hetu_tpu_torch.parallel``: ``ring_attn_fn`` / ``ulysses_attn_fn`` with
``head_axis``, ``ShardingStrategy`` on a ``dp x sp x tp`` mesh) against
the JAX package's, at ``tests/test_sp_tp.py``'s sizes, on the suite's 8
virtual CPU devices for the JAX side and local CPU meshes (plus a gloo
world of two processes) for the port:

- the mesh's ``sp`` groups against the JAX mesh's device order;
- the head-sharded ring (flash and blockwise cores, causal and full) and
  Ulysses on ``dp=2, sp=2, tp=2``, played over every rank from whole
  tensors: values at rtol = atol = 2e-5 and gradients at rtol 1e-4 /
  atol 1e-5, as ``tests/test_sp_tp.py`` holds the JAX ones;
- ``MultiHeadAttention`` under ``MEGATRON_RULES`` with the ring: every
  rank's output against the JAX module's at 2e-5;
- a 2-step ``Trainer(strategy=)`` AdamW trace of the JAX test's GPT on
  ``dp=2, sp=2, tp=2`` (ring flash and blockwise, Ulysses) against the
  JAX ``Trainer``'s at 5e-5, with the JAX weights carried over by
  ``load_jax_params``; the JAX test's own sharded trace is in the slow
  tier, so the JAX side here is its unsharded trace, which that test
  holds the sharded one to;
- an unsharded trainer's checkpoint loaded under the strategy, its
  trace continued, the whole weights gathered back;
- the step-0 gradients after ``reduce_grads`` against ``jax.grad`` (rtol
  5e-3 / atol 1e-5, as ``tests/test_torch_ring.py`` holds its GPT), equal
  on the two ``sp`` ranks of a group, beside a control counted ``sp``
  times that must fail;
- ``install`` binding each rank's attention to its rank;
- two gloo processes at ``sp=2`` against the local ``sp=2`` run, ring and
  Ulysses: losses, step-0 gradients and weights bitwise."""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.core import set_random_seed
from hetu_tpu.core.module import named_parameters
from hetu_tpu.exec import Trainer as JaxTrainer
from hetu_tpu.layers import MultiHeadAttention as JaxMHA
from hetu_tpu.layers import dot_product_attention as jax_dot_product_attention
from hetu_tpu.models.gpt import GPT as JaxGPT
from hetu_tpu.models.gpt import GPTConfig as JaxConfig
from hetu_tpu.optim import AdamWOptimizer as JaxAdamW
from hetu_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from hetu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hetu_tpu.parallel.ring_attention import ring_attn_fn as jax_ring_attn_fn
from hetu_tpu.parallel.ring_attention import (
    ulysses_attn_fn as jax_ulysses_attn_fn)
from hetu_tpu_torch import AdamWOptimizer, GPT, GPTConfig, Trainer
from hetu_tpu_torch.interop import load_jax_params
from hetu_tpu_torch.layers import MultiHeadAttention, dot_product_attention
from hetu_tpu_torch.launch import simulate_workers
from hetu_tpu_torch.parallel import (MeshSpec, ShardingStrategy, make_mesh,
                                     ring_attn_fn, ulysses_attn_fn)
from hetu_tpu_torch.parallel.spec import MEGATRON_RULES, gather_param

CFG = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32)
TRACE_TOL = 5e-5


@pytest.fixture(scope="module")
def mesh3_jax():
    return jax_make_mesh(JaxMeshSpec(dp=2, sp=2, tp=2), devices=jax.devices())


@pytest.fixture(scope="module")
def mesh3():
    return make_mesh(MeshSpec(dp=2, sp=2, tp=2), device="cpu")


def _qkv(b=2, s=16, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def test_sp_groups_follow_the_jax_device_order(mesh3_jax, mesh3):
    """Rank ``r`` of the port's mesh is the ``r``-th device of the JAX
    mesh of the same spec, so their ``sp`` groups hold the same ranks."""
    order = {d.id: i for i, d in enumerate(jax.devices())}
    devs = np.vectorize(lambda d: order[d.id])(mesh3_jax.devices)
    names = list(mesh3_jax.axis_names)
    assert tuple(names) == mesh3.axis_names
    for axis in ("sp", "dp", "tp"):
        moved = np.moveaxis(devs, names.index(axis), -1)
        want = sorted(map(list, moved.reshape(-1, moved.shape[-1])))
        assert sorted(mesh3.groups(axis)) == want, axis
    assert mesh3.groups("sp")[:2] == [[0, 2], [1, 3]]


@pytest.mark.parametrize("impl", ["flash", "blockwise"])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_head_sharded_matches_jax(mesh3_jax, mesh3, causal, impl):
    q, k, v = _qkv()
    jfn = jax_ring_attn_fn(mesh3_jax, impl=impl, head_axis="tp")
    ref = jax.jit(lambda q, k, v: jfn(q, k, v, causal=causal))(
        *map(jnp.asarray, (q, k, v)))
    fn = ring_attn_fn(mesh3, impl=impl, head_axis="tp")
    assert fn.spec == tuple(jfn.spec) == ("dp", "sp", "tp")
    out = fn(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)
    # without head_axis the heads stay whole: the same numbers
    whole = ring_attn_fn(mesh3, impl=impl)(*map(torch.from_numpy, (q, k, v)),
                                           causal=causal)
    np.testing.assert_allclose(whole.numpy(), out.numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_head_sharded_matches_jax(mesh3_jax, mesh3, causal):
    q, k, v = _qkv(seed=1)
    jfn = jax_ulysses_attn_fn(mesh3_jax, head_axis="tp",
                              inner_fn=jax_dot_product_attention)
    ref = jax.jit(lambda q, k, v: jfn(q, k, v, causal=causal))(
        *map(jnp.asarray, (q, k, v)))
    out = ulysses_attn_fn(mesh3, head_axis="tp",
                          inner_fn=dot_product_attention)(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_ring_head_sharded_grads_match_jax(mesh3_jax, mesh3):
    q, k, v = _qkv(seed=2)
    jfn = jax_ring_attn_fn(mesh3_jax, impl="flash", head_axis="tp")
    ref = jax.jit(jax.grad(
        lambda q, k, v: (jfn(q, k, v, causal=True) ** 2).mean(),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (ring_attn_fn(mesh3, head_axis="tp")(*ts, causal=True) ** 2
     ).mean().backward()
    for name, a, b in zip("qkv", ts, ref):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


def test_head_axis_must_be_a_mesh_axis():
    mesh = make_mesh(MeshSpec(sp=4, dp=2), device="cpu")
    with pytest.raises(ValueError, match="head_axis"):
        ring_attn_fn(mesh, head_axis="heads")
    with pytest.raises(ValueError, match="head_axis"):
        ulysses_attn_fn(mesh, head_axis="heads")


def test_mha_megatron_sharded_with_sp_tp_ring(mesh3):
    """The JAX test's MHA, its weights loaded into the port's and placed
    by ``MEGATRON_RULES`` (qkv column-parallel, the output projection
    row-parallel): each rank's output against the JAX module's rows of
    the rank's dp piece."""
    set_random_seed(7)
    b, s, dmodel, heads = 2, 16, 32, 4
    jm = JaxMHA(dmodel, heads, causal=True)
    x = np.random.default_rng(7).normal(size=(b, s, dmodel)).astype(
        np.float32)
    ref = np.asarray(jax.jit(lambda m, v: m(v))(jm, jnp.asarray(x)))
    tm = MultiHeadAttention(dmodel, heads, causal=True, device="cpu",
                            attn_fn=ring_attn_fn(mesh3, head_axis="tp"))
    load_jax_params(tm, {n: np.asarray(a) for n, a in named_parameters(jm)})
    sh = ShardingStrategy(mesh=mesh3, rules=MEGATRON_RULES,
                          batch_axes="dp").install(tm, AdamWOptimizer(1e-3))
    assert tuple(sh.models[0].wqkv.shape) == (3 * dmodel // 2, dmodel)
    assert sh.models[0].num_heads == heads // 2
    pieces = sh.split_batch(torch.from_numpy(x))
    with torch.no_grad():
        outs = sh.run(lambda i: sh.models[i](pieces[i]))
    for c, out in zip(sh.coords, outs):
        np.testing.assert_allclose(out.numpy(), ref[c["dp"]:c["dp"] + 1],
                                   rtol=2e-5, atol=2e-5)


# -- the GPT step on dp x sp x tp ----------------------------------------------

def _jax_gpt():
    set_random_seed(13)
    return JaxGPT(JaxConfig(**CFG))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX GPT's weights, its 2-step AdamW trace and its step-0
    gradients, on the JAX test's batch."""
    ids = np.random.default_rng(11).integers(0, 128, (4, 32)).astype(
        np.int32)
    params = {n: np.asarray(a) for n, a in named_parameters(_jax_gpt())}
    tr = JaxTrainer(_jax_gpt(), JaxAdamW(1e-3),
                    lambda m, b, k: (m.loss(b["ids"], training=False), {}))
    trace = [float(tr.step({"ids": jnp.asarray(ids)})["loss"])
             for _ in range(2)]
    grads = jax.jit(jax.grad(lambda m, x: m.loss(x, training=False)))(
        _jax_gpt(), jnp.asarray(ids))
    return {"ids": ids, "params": params, "trace": trace,
            "grads": {n: np.asarray(g) for n, g in named_parameters(grads)}}


def _attn(kind, mesh):
    return {"flash": lambda: ring_attn_fn(mesh, head_axis="tp"),
            "ring": lambda: ring_attn_fn(mesh),
            "blockwise": lambda: ring_attn_fn(mesh, impl="blockwise",
                                              head_axis="tp"),
            "ulysses": lambda: ulysses_attn_fn(mesh, head_axis="tp")}[kind]()


def _sharded_trainer(jax_ref, mesh, kind):
    model = GPT(GPTConfig(**CFG), attn_fn=_attn(kind, mesh), device="cpu")
    load_jax_params(model, jax_ref["params"])
    return Trainer(model, AdamWOptimizer(1e-3),
                   lambda m, b, k: (m.loss(b["ids"], training=False), {}),
                   strategy=ShardingStrategy(mesh=mesh, rules=MEGATRON_RULES,
                                             batch_axes="dp"))


@pytest.mark.parametrize("kind", ["flash", "blockwise", "ulysses"])
def test_gpt_trainer_trace_matches_jax(jax_ref, mesh3, kind):
    tr = _sharded_trainer(jax_ref, mesh3, kind)
    assert tr._sharded.models[0].blocks[0].attn.num_heads == 2
    ids = torch.from_numpy(jax_ref["ids"]).long()
    trace = [float(tr.step({"ids": ids})["loss"]) for _ in range(2)]
    np.testing.assert_allclose(trace, jax_ref["trace"], rtol=TRACE_TOL,
                               atol=TRACE_TOL)


def test_weights_and_checkpoints_round_trip(jax_ref, mesh3):
    """An unsharded trainer's checkpoint loaded into the dp2 sp2 tp2
    trainer (every rank its pieces of the weights and the AdamW slots)
    continues its trace; ``export_params`` gathers the whole weights
    back, before and after the step."""
    from hetu_tpu_torch.exec.checkpoint import (load_trainer_state,
                                                trainer_state_dict)
    from hetu_tpu_torch.interop import export_params
    ids = {"ids": torch.from_numpy(jax_ref["ids"]).long()}
    model = GPT(GPTConfig(**CFG), device="cpu")
    load_jax_params(model, jax_ref["params"])
    ref = Trainer(model, AdamWOptimizer(1e-3),
                  lambda m, b, k: (m.loss(b["ids"], training=False), {}))
    ref.step(ids)
    tr = _sharded_trainer(jax_ref, mesh3, "ring")
    load_trainer_state(tr, trainer_state_dict(ref))
    got, want = export_params(tr.model), export_params(ref.model)
    for n, a in want.items():
        np.testing.assert_array_equal(got[n], a, err_msg=n)
    np.testing.assert_allclose(float(tr.step(ids)["loss"]),
                               float(ref.step(ids)["loss"]),
                               rtol=TRACE_TOL)
    # AdamW turns the last bits of a gradient near 0 into a fraction of
    # a step, so the weights after it are held to 1% of the lr (1e-3)
    got, want = export_params(tr.model), export_params(ref.model)
    for n, a in want.items():
        np.testing.assert_allclose(got[n], a, rtol=0, atol=1e-5, err_msg=n)


def _rel(ours: dict, ref: dict) -> float:
    """The largest gap over the parameters, each beyond rtol 5e-3 /
    atol 1e-5 of the reference (0: every one within)."""
    worst = 0.0
    for name, g in ref.items():
        a = ours[name]
        if a.ndim == 2 and name.endswith(("wqkv", "wo", "w_in", "w_out")):
            a = a.T
        gap = np.abs(a - g) - (1e-5 + 5e-3 * np.abs(g))
        worst = max(worst, float(gap.max()))
    return worst


def test_step0_gradients_count_each_token_once(jax_ref, mesh3):
    """After ``reduce_grads`` every rank of an ``sp`` group holds the
    same gradient, the unsharded one: the chunk cut's backward gathers
    the chunks' gradients, and nothing is summed over sp.  The control,
    the gradients summed over the group's two ranks, must fail."""
    tr = _sharded_trainer(jax_ref, mesh3, "flash")
    sh = tr._sharded
    ids = torch.from_numpy(jax_ref["ids"]).long()
    sh.forward_backward(lambda m, b, k: (m.loss(b["ids"], training=False),
                                         {}), {"ids": ids}, None)
    grads = sh.reduce_grads()

    def full(sp):
        idx = [i for i, c in enumerate(sh.coords)
               if c["dp"] == 0 and c["sp"] == sp]
        return {n: gather_param([grads[i][n] for i in idx], pl.shape,
                                pl.tp_spec, [sh.coords[i] for i in idx],
                                sh.mesh.shape, pl.blocks).numpy()
                for n, pl in sh.place.items()}

    g0, g1 = full(0), full(1)
    for name in g0:
        np.testing.assert_array_equal(g0[name], g1[name], err_msg=name)
    assert _rel(g0, jax_ref["grads"]) <= 0.0
    summed = {n: g0[n] + g1[n] for n in g0}
    assert _rel(summed, jax_ref["grads"]) > 0.0


def test_install_binds_each_rank_attention_to_its_rank(mesh3):
    """``install`` replaces each rank's attention by ``attn_fn.for_rank``
    of its handle; bound, it meets its sp group only inside the ranks'
    run, and a rank of another mesh is refused."""
    model = GPT(GPTConfig(**CFG), attn_fn=ring_attn_fn(mesh3, head_axis="tp"),
                device="cpu")
    sh = ShardingStrategy(mesh=mesh3, rules=MEGATRON_RULES).install(
        model, AdamWOptimizer(1e-3))
    fns = [m.blocks[0].attn.attn_fn for m in sh.models]
    assert len({id(f) for f in fns}) == len(fns) == 8
    assert all(f.spec == ("dp", "sp", "tp") for f in fns)
    q = torch.zeros(1, 16, 2, 8)
    with pytest.raises(RuntimeError, match="run_ranks"):
        fns[0](q, q, q, causal=True)
    other = ring_attn_fn(make_mesh(MeshSpec(sp=4, dp=2), device="cpu"))
    with pytest.raises(ValueError, match="mesh"):
        other.for_rank(sh.handles[0])


def test_sp_under_a_remat_policy_is_refused(mesh3):
    model = GPT(GPTConfig(**CFG, remat="full"),
                attn_fn=ring_attn_fn(mesh3, head_axis="tp"), device="cpu")
    with pytest.raises(NotImplementedError, match="part 12"):
        ShardingStrategy(mesh=mesh3, rules=MEGATRON_RULES).install(
            model, AdamWOptimizer(1e-3))


# -- two processes ---------------------------------------------------------------

WORKER = textwrap.dedent("""
    import hashlib
    import numpy as np, torch
    torch.set_num_threads(1)   # one summation order, whatever the load
    import hetu_tpu_torch.launch as L
    L.initialize(device="cpu")
    import torch.distributed as dist
    from hetu_tpu_torch import AdamWOptimizer, Trainer
    from hetu_tpu_torch.models.gpt import GPT, GPTConfig
    from hetu_tpu_torch.parallel import (MeshSpec, ShardingStrategy,
                                         collectives as col, make_mesh,
                                         ring_attn_fn, ulysses_attn_fn)
    cfg = GPTConfig(vocab_size=128, hidden_size=32, num_layers=2,
                    num_heads=4, max_seq_len=32)
    ids = torch.from_numpy(np.random.default_rng(11).integers(0, 128,
                                                              (4, 32)))
    lf = lambda m, b, k: (m.loss(b), {})
    out, grads = {}, {}
    for kind in ("ring", "ulysses"):
        for proc in (True, False):
            mesh = make_mesh(MeshSpec(sp=2), device="cpu", processes=proc)
            attn = (ring_attn_fn if kind == "ring" else ulysses_attn_fn)(
                mesh)
            model = GPT(cfg, attn_fn=attn, device="cpu",
                        generator=torch.Generator().manual_seed(0))
            tr = Trainer(model, AdamWOptimizer(1e-3), lf,
                         strategy=ShardingStrategy(mesh=mesh))
            col.reset_counts()
            losses = [float(tr.step(ids)["loss"])]
            # step 0's gradients, each held rank's under its sp coordinate
            # (dp = 1: what the update got)
            sh = tr._sharded
            grads[kind, proc] = ";".join(
                f"sp{c['sp']}:" + hashlib.sha1(b"".join(
                    p.grad.numpy().tobytes() for p in m.parameters()
                )).hexdigest() for c, m in zip(sh.coords, sh.models))
            losses += [float(tr.step(ids)["loss"]) for _ in range(2)]
            digest = sum(float(p.double().square().sum())
                         for p in model.parameters())
            hops = col.counts().get("ppermute" if kind == "ring"
                                    else "all_to_all", {}).get("calls", 0)
            out[kind, proc] = losses + [digest, hops]
    print(f"RESULT rank={dist.get_rank()} " + " ".join(
        f"{k}{'proc' if p else 'local'}=" + ",".join(repr(x) for x in v)
        + f" {k}{'proc' if p else 'local'}grads=" + grads[k, p]
        for (k, p), v in out.items()), flush=True)
    dist.destroy_process_group()
""")


def test_two_processes_equal_the_local_sp2_run():
    """Each process holds one ``sp`` rank; the ring's K/V hops are
    ``ppermute`` over the sp process group and Ulysses' exchange is
    ``all_to_all``, forward and backward, composed where gloo lacks the
    op.  Losses, each rank's step-0 gradients (a gradient counted sp
    times would change them) and the final weights equal the local
    ``sp=2`` mesh's bitwise."""
    outs = simulate_workers(2, WORKER, timeout=150.0)
    results = sorted(line for out in outs for line in out.splitlines()
                     if line.startswith("RESULT"))
    assert len(results) == 2, outs
    fields = [dict(kv.split("=") for kv in r.split()[1:]) for r in results]
    for kind in ("ring", "ulysses"):
        proc = fields[0][kind + "proc"].split(",")
        assert proc == fields[1][kind + "proc"].split(",")
        local = fields[0][kind + "local"].split(",")
        assert proc[:4] == local[:4], (kind, proc, local)
        mine = [f[kind + "procgrads"] for f in fields]
        theirs = dict(g.split(":") for g in
                      fields[0][kind + "localgrads"].split(";"))
        assert sorted(mine) == [f"sp{c}:{theirs[f'sp{c}']}"
                                for c in (0, 1)], (kind, mine, theirs)
        assert int(proc[4]) > 0 and int(local[4]) > 0
        losses = [float(x) for x in proc[:3]]
        assert losses[-1] < losses[0]

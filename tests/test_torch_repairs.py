"""Repairs of the port's op surface and of the survival layer's bitwise
promise, each held against the JAX package on the CPU:

- ``ops.layer_norm`` / ``ops.rms_norm`` take ``axis=`` as the reference's
  do; ``softmax_cross_entropy_sparse`` names its labels ``label_ids``;
- the edge values where torch's nearest op differed from JAX's:
  ``gelu(+-inf)`` in both forms, ``pow(-inf, p)`` and ``pow(-0, p)``, ``gelu`` of an integer
  tensor (promoted to fp32 as ``jnp`` promotes it), and ``reduce_mul``
  over a zero-length kept axis; every finite input keeps today's bits;
- ``ResilientTrainer`` and ``ElasticGang`` switch on
  ``torch.backends.cudnn.deterministic`` for a model that holds a
  convolution (cuDNN's default algorithms do not replay bitwise);
- the parameter names of every public function and method of the
  reference that has a port of the same path and name are accepted by
  the port (a walk with its skip list), each repaired parameter held
  against the reference's value (``ExpertMLP(activation=)``,
  ``MoEBlock(use_moe=False)``, ``conv2d(precision=)``,
  ``HetuTimer(..., result=)``, ``export_fn(const_names=)``;
  ``ring_attn_fn(remat=)`` in ``tests/test_torch_ring.py``);
- every name a reference package exports (its ``__all__``, or its public
  names where it has none) imports from the port's package of the same
  path, but a stated list of JAX-only names.

Tolerances: 1e-6 of the reference's largest magnitude for fp32 values
(NaN and the infinities exact), shapes and types exact."""

import importlib
import inspect
import pkgutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import hetu_tpu.ops as J
import hetu_tpu_torch.ops as P

TOL = 1e-6


def _close(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype, \
        (ours.shape, ref.shape, ours.dtype, ref.dtype)
    odd = ~np.isfinite(ref)
    np.testing.assert_array_equal(ours[odd], ref[odd])
    ref64 = np.where(odd, 0, ref).astype(np.float64)
    ours64 = np.where(odd, 0, ours).astype(np.float64)
    scale = max(np.abs(ref64).max(initial=0.0), 1e-30)
    assert np.abs(ours64 - ref64).max(initial=0.0) <= TOL * scale


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ----------------------------------------------------- signatures (item 1)

@pytest.mark.parametrize("axis", [0, 1, -1, 2])
@pytest.mark.parametrize("norm", ["layer_norm", "rms_norm"])
def test_norm_axis_matches_the_reference(norm, axis):
    x = _x(3, 5, 8)
    n = x.shape[axis]
    scale = _x(*[n if d == axis % 3 else 1 for d in range(3)], seed=1)
    kw = dict(axis=axis)
    if norm == "layer_norm":
        bias = _x(*scale.shape, seed=2)
        ref = J.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                           jnp.asarray(bias), **kw)
        ours = P.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias), **kw)
    else:
        ref = J.rms_norm(jnp.asarray(x), jnp.asarray(scale), **kw)
        ours = P.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), **kw)
    _close(ours, ref)


def test_last_axis_norms_keep_their_bits():
    x = torch.from_numpy(_x(4, 16))
    s, b = torch.from_numpy(_x(16, seed=1)), torch.from_numpy(_x(16, seed=2))
    assert torch.equal(P.layer_norm(x, s, b),
                       P.layer_norm(x, s, b, axis=-1))
    assert torch.equal(P.layer_norm(x, s, b), P.layer_norm(x, s, b, axis=1))
    assert torch.equal(P.rms_norm(x, s), P.rms_norm(x, s, axis=-1))


def test_cross_entropy_takes_label_ids_by_keyword():
    logits = _x(4, 7)
    ids = np.array([0, 6, 3, 6], np.int32)
    ref = J.softmax_cross_entropy_sparse(jnp.asarray(logits),
                                         label_ids=jnp.asarray(ids),
                                         ignore_index=6)
    ours = P.softmax_cross_entropy_sparse(torch.from_numpy(logits),
                                          label_ids=torch.from_numpy(ids),
                                          ignore_index=6)
    _close(ours, ref)


# ----------------------------------------------------- edge values (item 2)

EDGES = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1.5, -3.0, -2.0,
                  1e30, -1e30], np.float32)


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_edges_match_the_reference(approximate):
    ref = J.gelu(jnp.asarray(EDGES), approximate)
    ours = P.gelu(torch.from_numpy(EDGES), approximate)
    _close(ours, ref)
    assert np.asarray(ref)[0] == np.inf and ours[0].item() == np.inf


@pytest.mark.parametrize("approximate", [True, False])
def test_gelu_promotes_integers_as_jnp_does(approximate):
    x = np.array([-3, -1, 0, 2, 7], np.int32)
    ref = J.gelu(jnp.asarray(x), approximate)
    ours = P.gelu(torch.from_numpy(x), approximate)
    assert str(ours.dtype) == "torch.float32" and ref.dtype == jnp.float32
    _close(ours, ref)


@pytest.mark.parametrize("p", [0.5, -0.5, 1 / 3, 2.0, 3.0, -3.0, 0.0, -1.0,
                               np.nan, 2.5])
def test_pow_edges_match_the_reference(p):
    ref = J.pow(jnp.asarray(EDGES), p)
    ours = P.pow(torch.from_numpy(EDGES), p)
    _close(ours, ref)


def test_pow_with_a_tensor_exponent_at_minus_inf():
    x = np.array([-np.inf, -np.inf, -np.inf, -np.inf], np.float32)
    p = np.array([0.5, -0.5, 3.0, -3.0], np.float32)
    _close(P.pow(torch.from_numpy(x), torch.from_numpy(p)),
           J.pow(jnp.asarray(x), jnp.asarray(p)))


def test_edge_repairs_keep_finite_bits():
    x = torch.from_numpy(_x(64, seed=3) * 4)

    def same(a, b):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    same(P.gelu(x, False), F.gelu(x, approximate="none"))
    same(P.gelu(x, True), F.gelu(x, approximate="tanh"))
    for p in (0.5, 2.0, -1.5, 3.0):
        same(P.pow(x, p), torch.pow(x, p))
    y = torch.from_numpy(_x(3, 4, 5, seed=4))
    for axes in (1, (0, 2), None):
        dims = (1,) if axes == 1 else ((0, 2) if axes else (0, 1, 2))
        want = y
        for d in sorted(dims, reverse=True):
            want = want.prod(dim=d)
        assert torch.allclose(P.reduce_mul(y, axes), want)


def test_pow_gradient_stays_finite_beside_minus_inf():
    x = torch.tensor([-np.inf, -2.0, 1.5], requires_grad=True)
    P.pow(x, 2.0).sum().backward()
    assert torch.isfinite(x.grad[1:]).all()
    g = jax.grad(lambda a: J.pow(a, 2.0).sum())(jnp.asarray([-2.0, 1.5]))
    _close(x.grad[1:], g)


@pytest.mark.parametrize("axes,keep", [(2, False), ((2,), False),
                                       (1, False), (2, True), (None, False),
                                       ((0, 2), False)])
def test_reduce_mul_over_empty_axes_matches_the_reference(axes, keep):
    z = np.zeros((3, 0, 4), np.float32)
    ref = J.reduce_mul(jnp.asarray(z), axes, keep)
    ours = P.reduce_mul(torch.from_numpy(z), axes, keep)
    _close(ours, ref)


# ------------------------------------------- repeatable convolutions (item 3)

@pytest.fixture
def cudnn_switch():
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    yield
    torch.backends.cudnn.deterministic = before


def _conv_trainer():
    from hetu_tpu_torch.exec import Trainer
    from hetu_tpu_torch.models.simple import LeNet
    from hetu_tpu_torch.optim import SGDOptimizer
    model = LeNet(device="cpu")
    return Trainer(model, SGDOptimizer(0.1), lambda m, b, k: (m(b).sum(), {}))


def _mlp_trainer():
    from hetu_tpu_torch.exec import Trainer
    from hetu_tpu_torch.layers import Linear
    from hetu_tpu_torch.optim import SGDOptimizer
    model = Linear(4, 2, device="cpu")
    return Trainer(model, SGDOptimizer(0.1), lambda m, b, k: (m(b).sum(), {}))


def test_resilient_trainer_makes_convolutions_repeatable(cudnn_switch,
                                                         tmp_path):
    from hetu_tpu_torch.exec import ResilientTrainer
    ResilientTrainer(_mlp_trainer(), str(tmp_path / "mlp"), save_every=0)
    assert torch.backends.cudnn.deterministic is False
    rt = ResilientTrainer(_conv_trainer(), str(tmp_path / "cnn"),
                          save_every=0)
    assert torch.backends.cudnn.deterministic is True
    rt.close()


def test_elastic_gang_makes_convolutions_repeatable(cudnn_switch, tmp_path):
    from hetu_tpu_torch.exec import ElasticGang
    data = lambda step: {"x": torch.zeros((4, 28, 28, 1))}  # noqa: E731
    ElasticGang(_conv_trainer(), str(tmp_path), world_size=2, data_fn=data,
                global_batch_size=4)
    assert torch.backends.cudnn.deterministic is True


def test_ensure_repeatable_names_what_it_switched(cudnn_switch):
    from hetu_tpu_torch.exec.executor import ensure_repeatable
    assert ensure_repeatable(_mlp_trainer().model) is False
    assert torch.backends.cudnn.deterministic is False
    assert ensure_repeatable(_conv_trainer().model) is True
    assert torch.backends.cudnn.deterministic is True


# ------------------------------------- the reference's parameters (item 5)

# Names only JAX has: Pallas block choices and its interpreter, buffer
# donation, jit's arguments, a device count of the CPU backend, a jaxpr.
JAX_ONLY_PARAMS = {"interpret", "block_q", "block_k", "donate", "sharding",
                   "static_argnums", "cpu_devices_per_proc", "fn_or_jaxpr"}
_SHARDS = {"x"}   # the collectives take the list of shards a process holds
# Parameters that are another object in the port by design (ROADMAP queue 3
# item 5): the list collectives' shards, the per-rank attention cores'
# chunk lists (``qs``, ``ks``, ``vs``), and a pytree where the port takes a
# module, a name dict or a trainer; the port's ``init.ones`` / ``zeros``
# draw nothing and take a generator.
BY_DESIGN = {
    **{f"hetu_tpu.parallel.collectives.{f}": _SHARDS for f in (
        "all_reduce", "all_reduce_mean", "pmean", "reduce_scatter",
        "all_gather", "all_to_all", "hierarchical_all_to_all", "broadcast",
        "ppermute", "send_next", "recv_prev")},
    "hetu_tpu.parallel.ring_attention.ring_attention": {"q", "k", "v"},
    "hetu_tpu.parallel.ring_attention.ulysses_attention": {"q", "k", "v"},
    "hetu_tpu.parallel.spec.resolve_specs": {"tree"},
    "hetu_tpu.parallel.strategies.ShardingStrategy.opt_specs":
        {"model_spec_tree"},
    "hetu_tpu.parallel.strategies.ShardingStrategy.install":
        {"train_step", "eval_step", "state"},
    "hetu_tpu.obs.numerics.tree_fingerprints": {"tree"},
    "hetu_tpu.obs.numerics.group_stats": {"tree"},
    "hetu_tpu.obs.memledger.note_train_state": {"state"},
    "hetu_tpu.obs.memledger.MemoryLedger.note_train_state": {"state"},
    "hetu_tpu.init.initializers.zeros": {"key"},
    "hetu_tpu.init.initializers.ones": {"key"},
}


def _modules(root) -> list:
    return [root.__name__] + [m.name for m in pkgutil.walk_packages(
        root.__path__, root.__name__ + ".")]


def _accepts(fn):
    """``(names, takes **kwargs)`` of ``fn``'s parameters, or None."""
    try:
        ps = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    return ({p.name for p in ps if p.kind not in (p.VAR_POSITIONAL,
                                                  p.VAR_KEYWORD)},
            any(p.kind == p.VAR_KEYWORD for p in ps))


def _pairs(ref_mod, port_mod):
    """``(qualified name, reference callable, port callable)`` for each
    public function and method the two modules share by name."""
    for name, obj in vars(ref_mod).items():
        port = getattr(port_mod, name, None)
        if name.startswith("_") or port is None or \
                getattr(obj, "__module__", None) != ref_mod.__name__:
            continue
        qual = f"{ref_mod.__name__}.{name}"
        if inspect.isclass(obj) and inspect.isclass(port):
            for m in vars(obj):
                if (m.startswith("_") and m not in ("__init__", "__call__")
                        or not hasattr(port, m)):
                    continue
                yield f"{qual}.{m}", getattr(obj, m), getattr(port, m)
        elif inspect.isfunction(obj) and callable(port):
            yield qual, obj, port


def test_signatures_match_the_reference():
    for name in ("layer_norm", "rms_norm", "softmax_cross_entropy_sparse"):
        ours = list(inspect.signature(getattr(P, name)).parameters)
        ref = list(inspect.signature(getattr(J, name)).parameters)
        assert ours == ref, (name, ours, ref)
    import hetu_tpu
    missing, seen = [], 0
    for mod in _modules(hetu_tpu):
        if ".ops.pallas" in mod:    # replaced by ops.kernels by design
            continue
        ref_mod = importlib.import_module(mod)
        try:
            port_mod = importlib.import_module(
                mod.replace("hetu_tpu", "hetu_tpu_torch", 1))
        except ModuleNotFoundError:
            continue
        for qual, a, b in _pairs(ref_mod, port_mod):
            ra, pb = _accepts(a), _accepts(b)
            if ra is None or pb is None or pb[1]:
                continue
            seen += 1
            lack = ra[0] - pb[0] - {"self"} - JAX_ONLY_PARAMS \
                - BY_DESIGN.get(qual, set())
            if lack:
                missing.append((qual, sorted(lack)))
    assert seen > 500, seen
    assert not missing, missing


def test_expert_mlp_takes_the_reference_activation():
    from hetu_tpu.core.module import named_parameters
    from hetu_tpu.layers import moe as jmoe
    from hetu_tpu_torch.interop import load_jax_params
    from hetu_tpu_torch.layers import moe
    from hetu_tpu_torch.ops import gelu
    from hetu_tpu.core import set_random_seed
    set_random_seed(5)
    jm = jmoe.ExpertMLP(3, 8, 16, activation=jax.nn.relu)
    tm = moe.ExpertMLP(3, 8, 16, activation=torch.relu, device="cpu")
    load_jax_params(tm, {n: np.asarray(a) for n, a in named_parameters(jm)})
    x = _x(3, 5, 8, seed=6)
    _close(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))
    assert moe.ExpertMLP(3, 8, 16, device="cpu").activation is gelu
    tm.activation = gelu
    assert not torch.equal(tm(torch.from_numpy(x)),
                           torch.from_numpy(np.asarray(jm(jnp.asarray(x)))))


@pytest.mark.parametrize("with_stats", [False, True])
def test_dense_moe_block_matches_the_reference(with_stats):
    from hetu_tpu.core import set_random_seed
    from hetu_tpu.core.module import named_parameters
    from hetu_tpu.models.moe_lm import MoEBlock as JaxBlock
    from hetu_tpu.models.moe_lm import MoELMConfig as JaxConfig
    from hetu_tpu_torch.interop import load_jax_params
    from hetu_tpu_torch.models.moe_lm import MoEBlock, MoELMConfig
    kw = dict(vocab_size=32, hidden_size=16, num_layers=1, num_heads=2,
              num_experts=4)
    set_random_seed(2)
    jb = JaxBlock(JaxConfig(**kw), use_moe=False)
    tb = MoEBlock(MoELMConfig(**kw), use_moe=False, device="cpu")
    assert tb.moe is None
    load_jax_params(tb, {n: np.asarray(a) for n, a in named_parameters(jb)})
    x = _x(2, 6, 16, seed=7)
    jy, jaux = jb(jnp.asarray(x), with_stats=with_stats)
    ty, taux = tb(torch.from_numpy(x), with_stats=with_stats)
    _close(ty, jy)
    if with_stats:
        assert jaux[1] is None and taux[1] is None
        jaux, taux = jaux[0], taux[0]
    assert float(taux) == float(jaux) == 0.0


def test_dense_blocks_leave_the_lm_stats_to_the_moe_blocks():
    from hetu_tpu_torch.models.moe_lm import MoEBlock, MoELM, MoELMConfig
    cfg = MoELMConfig(vocab_size=32, hidden_size=16, num_layers=2,
                      num_heads=2, num_experts=4)
    lm = MoELM(cfg, device="cpu")
    lm.blocks[1] = MoEBlock(cfg, use_moe=False, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 32, (2, 8)))
    _, (aux, stats) = lm(ids, with_stats=True)
    _, (aux1, stats1) = lm.blocks[0](lm.wte(ids) + lm.wpe(
        torch.arange(8)), with_stats=True)
    assert set(stats) == set(stats1)
    assert float(aux) == float(aux1)


def test_convolutions_take_precision():
    x, w = _x(2, 6, 6, 3), _x(3, 3, 3, 4, seed=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    ref = J.conv2d(jnp.asarray(x), jnp.asarray(w), precision="highest")
    ours = P.conv2d(tx, tw, precision="highest")
    assert torch.equal(ours, P.conv2d(tx, tw))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    ref_t = J.conv2d_transpose(jnp.asarray(x), jnp.asarray(w), 2,
                               precision="highest")
    ours_t = P.conv2d_transpose(tx, tw, 2, precision="highest")
    assert torch.equal(ours_t, P.conv2d_transpose(tx, tw, 2))
    np.testing.assert_allclose(ours_t.numpy(), np.asarray(ref_t), rtol=0,
                               atol=1e-5)


def test_timer_section_takes_result():
    from hetu_tpu.exec.profiler import HetuTimer as JaxTimer
    from hetu_tpu_torch.exec.profiler import HetuTimer
    for timer, x in ((JaxTimer(), jnp.ones(3)), (HetuTimer(), torch.ones(3))):
        with timer("section", result=x):
            pass
        with timer("section"):
            pass
        assert timer.counts["section"] == 2 and timer.totals["section"] > 0


def test_export_fn_names_closure_constants():
    from hetu_tpu.interop.onnx_export import export_fn as jax_export
    from hetu_tpu_torch.interop.onnx_export import export_fn
    w, b, x = _x(3, 4), _x(4, seed=1), _x(2, 3, seed=2)
    jw, jb = jnp.asarray(w), jnp.asarray(b)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    jp = jax_export(lambda a: a @ jw + jb, jnp.asarray(x),
                    const_names={id(jw): "weight"})
    tp = export_fn(lambda a: a @ tw + tb, torch.from_numpy(x),
                   const_names={id(tw): "weight"})
    for proto in (jp, tp):
        inits = {t.name for t in proto.graph.initializers}
        assert "weight" in inits, inits
        uses = {i for n in proto.graph.nodes for i in n.inputs}
        assert "weight" in uses
    plain = export_fn(lambda a: a @ tw + tb, torch.from_numpy(x))
    assert "weight" not in {t.name for t in plain.graph.initializers}


# ------------------------------------------- package exports (item 6)

# What only JAX has: ``InstrumentedJit`` / ``instrument`` wrap ``jax.jit``
# (``obs.watch`` takes their place); ``Module``, ``FrozenDict``,
# ``trainable_mask`` and ``tree_replace`` are the reference's pytree
# module, which ``torch.nn.Module`` replaces (parameters against buffers,
# updated in place); ``named_shardings`` and ``shard_tree`` build
# ``jax.sharding.NamedSharding``\ s.
JAX_ONLY_NAMES = {"InstrumentedJit", "instrument", "Module", "FrozenDict",
                  "trainable_mask", "tree_replace", "named_shardings",
                  "shard_tree"}


def _exports(mod) -> list:
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items() if not n.startswith("_")
                 and not isinstance(v, types.ModuleType)]
    return sorted(set(names) - JAX_ONLY_NAMES)


def test_every_reference_export_imports_from_the_port():
    import hetu_tpu
    missing, seen = [], 0
    for mod in _modules(hetu_tpu):
        if ".ops.pallas" in mod:
            continue
        ref_mod = importlib.import_module(mod)
        if not hasattr(ref_mod, "__path__"):
            continue          # packages only
        port = importlib.import_module(
            mod.replace("hetu_tpu", "hetu_tpu_torch", 1))
        for name in _exports(ref_mod):
            seen += 1
            if not hasattr(port, name):
                missing.append(f"{port.__name__}.{name}")
    assert seen > 500, seen
    assert not missing, missing
    from hetu_tpu_torch.obs import MetricsRegistry, span  # noqa: F401
    from hetu_tpu_torch import get_seed_status, param_count  # noqa: F401


def test_param_count_matches_the_reference():
    from hetu_tpu.core import param_count as jax_count, set_random_seed
    from hetu_tpu.models.resnet import resnet18 as jax_resnet18
    from hetu_tpu.models.gpt import GPT as JaxGPT, GPTConfig as JaxCfg
    from hetu_tpu_torch import GPT, GPTConfig, param_count
    from hetu_tpu_torch.core import named_parameters
    from hetu_tpu_torch.models.resnet import resnet18
    kw = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
              max_seq_len=16)
    set_random_seed(0)
    pairs = ((JaxGPT(JaxCfg(**kw)), GPT(GPTConfig(**kw), device="cpu")),
             (jax_resnet18(num_classes=10), resnet18(num_classes=10,
                                                     device="cpu")))
    for jm, tm in pairs:
        assert param_count(tm) == jax_count(jm) > 0
        from hetu_tpu.core.module import named_parameters as jax_named
        assert {n for n, _ in named_parameters(tm)} == \
            {n for n, _ in jax_named(jm)}
    assert param_count({"a": torch.zeros(3, 4), "b": [torch.zeros(5)]}) == 17

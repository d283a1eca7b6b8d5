"""The port's 1F1B schedules (``hetu_tpu_torch.parallel.pipedream``)
against the JAX package's on the suite's virtual CPU devices (the JAX
side) and local CPU meshes (the port), at ``tests/test_pipedream.py``'s
sizes:

- the host logic: ``_phase_bounds``, ``pipedream_schedule_stats`` and
  the interleave permutations over a grid;
- ``pipedream_grads`` at V=1 and V=2 (with and without ``dp_axis``)
  against the JAX one, 1e-5 relative on the loss, 1e-4 on the
  gradients; GPT blocks as a list of stages against the port's own
  autograd through the sequential stack;
- ``pipedream_train_step``: at S=1 against a sequential per-microbatch
  SGD loop, at lr 0 bitwise unchanged, at S=4 with HetPipe's
  ``dp_axis`` two steps against the JAX step, and a control whose stash
  keeps references (not copies) that must leave the JAX step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.optim import SGDOptimizer as JSGD
from hetu_tpu.parallel import pipedream as J
from hetu_tpu.parallel.mesh import MeshSpec as JMeshSpec
from hetu_tpu.parallel.mesh import make_mesh as jmake_mesh
from hetu_tpu_torch.optim import SGDOptimizer
from hetu_tpu_torch.parallel import pipedream as T
from hetu_tpu_torch.parallel.mesh import MeshSpec, make_mesh


def _params(rng, n, d):
    return {"w": rng.normal(0, 0.5, (n, d, d)).astype(np.float32),
            "b": rng.normal(0, 0.1, (n, d)).astype(np.float32)}


def _jstage(W, h, ex):
    return jnp.tanh(h @ W["w"] + W["b"])


def _jloss(out, y):
    return jnp.mean((out - y) ** 2)


def _tstage(W, h, ex):
    return torch.tanh(h @ W["w"] + W["b"])


def _tloss(out, y):
    return torch.mean((out - y) ** 2)


def _t(a):
    return {k: torch.tensor(v) for k, v in a.items()}


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(JMeshSpec(pp=4, dp=2), devices=jax.devices())


def _tmesh(**kw):
    return make_mesh(MeshSpec(**kw), device="cpu")


# -- host logic ----------------------------------------------------------------

def test_host_logic_equals_jax():
    for S in (1, 2, 3, 4):
        for V in (1, 2, 3):
            for M in (1, 2, 3, 4, 5, 8, 16):
                assert T._phase_bounds(S, V, M) == J._phase_bounds(S, V, M)
                assert T.pipedream_schedule_stats(S, V, M) == \
                    J.pipedream_schedule_stats(S, V, M)
            x = np.arange(S * V * 2, dtype=np.float32).reshape(S * V, 2)
            for fn in ("interleave_stages", "uninterleave_stages"):
                got = getattr(T, fn)({"a": torch.tensor(x)}, S, V)["a"]
                want = getattr(J, fn)({"a": jnp.asarray(x)}, S, V)["a"]
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
                lst = getattr(T, fn)(list(range(S * V)), S, V)
                assert lst == [int(r[0]) // 2 for r in np.asarray(want)]
    s1 = T.pipedream_schedule_stats(4, 1, 16)
    assert abs(s1["bubble_fraction"] - 3 / 19) < 1e-9


def test_bad_leading_dim_refused():
    params = _t(_params(np.random.default_rng(5), 4, 8))
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="interleave_stages"):
        T.pipedream_grads(_tstage, _tloss, params, x, x, mesh=_tmesh(pp=4),
                          n_microbatches=4, virtual_stages=2)
    with pytest.raises(ValueError, match="interleave_stages"):
        T.interleave_stages(params, 4, 2)


# -- synchronous 1F1B ------------------------------------------------------------

@pytest.mark.parametrize("V,M,dp", [(1, 8, False), (2, 8, True),
                                    (2, 6, False)])
def test_sync_grads_equal_jax(jmesh, V, M, dp):
    rng = np.random.default_rng(3 + V)
    S, d, B = 4, 8, 16 if M == 8 else 24
    p = _params(rng, S * V, d)
    x = rng.normal(size=(B, d)).astype(np.float32)
    y = rng.normal(size=(B, d)).astype(np.float32)
    kw = dict(dp_axis="dp") if dp else {}
    jl, jg = jax.jit(lambda q: J.pipedream_grads(
        _jstage, _jloss, J.interleave_stages(q, S, V), jnp.asarray(x),
        jnp.asarray(y), mesh=jmesh, n_microbatches=M, virtual_stages=V,
        **kw))(jax.tree_util.tree_map(jnp.asarray, p))
    jg = J.uninterleave_stages(jg, S, V)
    mesh = _tmesh(pp=4, dp=2)
    tl, tg = T.pipedream_grads(
        _tstage, _tloss, T.interleave_stages(_t(p), S, V), torch.tensor(x),
        torch.tensor(y), mesh=mesh, n_microbatches=M, virtual_stages=V,
        **kw)
    tg = T.uninterleave_stages(tg, S, V)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in ("w", "b"):
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-4, atol=1e-6)


def test_sync_gpt_blocks_as_stage_list():
    """GPT blocks as a list of virtual stages (S=2, V=2) against the
    port's autograd through the sequential stack."""
    from hetu_tpu_torch.layers import TransformerBlock
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(1)
    blocks = [TransformerBlock(16, 2, causal=True, generator=g,
                               device="cpu") for _ in range(4)]
    head = torch.randn(32, 16, generator=g) * 0.1
    ids = torch.randint(0, 32, (8, 6), generator=g)
    x = torch.randn(8, 6, 16, generator=g)

    def loss_fn(out, y):
        return torch.nn.functional.cross_entropy(
            (out[:, :-1] @ head.T).reshape(-1, 32), y[:, 1:].reshape(-1))

    loss, grads = T.pipedream_grads(
        lambda blk, h, ex: blk(h), loss_fn,
        T.interleave_stages(blocks, 2, 2), x, ids, mesh=_tmesh(pp=2),
        n_microbatches=4, virtual_stages=2)
    grads = T.uninterleave_stages(grads, 2, 2)
    ref = 0.0
    for m in range(4):
        h = x[2 * m:2 * m + 2]
        for b in blocks:
            h = b(h)
        ref = ref + loss_fn(h, ids[2 * m:2 * m + 2]) / 4
    ref.backward()
    np.testing.assert_allclose(float(loss), float(ref.detach()),
                               rtol=1e-6)
    for b, gd in zip(blocks, grads):
        for n, p in b.named_parameters():
            np.testing.assert_allclose(gd[n].numpy(), p.grad.numpy(),
                                       rtol=1e-4, atol=1e-6)


# -- asynchronous PipeDream ------------------------------------------------------

def test_async_single_stage_equals_sequential_sgd():
    rng = np.random.default_rng(2)
    d, B, M, lr = 8, 16, 8, 0.05
    p = _t(_params(rng, 1, d))
    ref = {k: v[0].clone().requires_grad_() for k, v in p.items()}
    x = torch.tensor(rng.normal(size=(B, d)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=(B, d)), dtype=torch.float32)
    opt = SGDOptimizer(lr)
    state = opt.init(p)
    loss, newp, newst = T.pipedream_train_step(
        _tstage, _tloss, opt, p, state, x, y, mesh=_tmesh(pp=1),
        n_microbatches=M)
    for m in range(M):
        g = torch.autograd.grad(_tloss(_tstage(ref, x[2 * m:2 * m + 2],
                                               None), y[2 * m:2 * m + 2]),
                                [ref["w"], ref["b"]])
        with torch.no_grad():
            ref["w"] -= lr * g[0]
            ref["b"] -= lr * g[1]
    np.testing.assert_allclose(newp["w"][0].numpy(),
                               ref["w"].detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    assert newst["step"] == M


def test_async_zero_lr_keeps_weights_bitwise():
    rng = np.random.default_rng(3)
    S, d, B, M = 4, 8, 16, 8
    p = _t(_params(rng, S, d))
    before = {k: v.clone() for k, v in p.items()}
    x = torch.tensor(rng.normal(size=(B, d)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=(B, d)), dtype=torch.float32)
    opt = SGDOptimizer(0.0)
    loss, newp, _ = T.pipedream_train_step(
        _tstage, _tloss, opt, p, opt.init(p), x, y, mesh=_tmesh(pp=4, dp=2),
        n_microbatches=M)
    for k in before:
        assert torch.equal(newp[k], before[k])
    ref = np.mean([float(_tloss(_seq(before, x[2 * m:2 * m + 2]),
                                y[2 * m:2 * m + 2])) for m in range(M)])
    np.testing.assert_allclose(float(loss), ref, rtol=1e-6)


def _seq(p, h):
    for s in range(p["w"].shape[0]):
        h = _tstage({"w": p["w"][s], "b": p["b"][s]}, h, None)
    return h


@pytest.fixture(scope="module")
def jax_hetpipe(jmesh):
    """Two asynchronous HetPipe steps of the JAX package (S=4, dp=2)."""
    rng = np.random.default_rng(5)
    S, d, B, M = 4, 8, 32, 4
    p = _params(rng, S, d)
    x = rng.normal(size=(B, d)).astype(np.float32)
    y = (rng.normal(size=(B, d)) * 0.1).astype(np.float32)
    opt = JSGD(0.05)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    st = opt.init(jp)
    step = jax.jit(lambda q, s: J.pipedream_train_step(
        _jstage, _jloss, opt, q, s, jnp.asarray(x), jnp.asarray(y),
        mesh=jmesh, n_microbatches=M, dp_axis="dp"))
    losses = []
    for _ in range(2):
        loss, jp, st = step(jp, st)
        losses.append(float(loss))
    return p, x, y, losses, {k: np.asarray(v) for k, v in jp.items()}, \
        int(st["step"])


@pytest.mark.parametrize("stash", ["copies", "references"])
def test_async_hetpipe_equals_jax(jax_hetpipe, stash, monkeypatch):
    p, x, y, jlosses, jparams, jstep = jax_hetpipe
    if stash == "references":
        # the control: a stash of references turns every version into the
        # newest, so a backward no longer replays its forward's weights
        monkeypatch.setattr(T, "_version",
                            lambda named: [w.detach() for _, w in named])
    tp = _t(p)
    opt = SGDOptimizer(0.05)
    st = opt.init(tp)
    mesh = _tmesh(pp=4, dp=2)
    losses = []
    for _ in range(2):
        loss, tp, st = T.pipedream_train_step(
            _tstage, _tloss, opt, tp, st, torch.tensor(x), torch.tensor(y),
            mesh=mesh, n_microbatches=4, dp_axis="dp")
        losses.append(float(loss))
    if stash == "references":
        gap = max(np.max(np.abs(tp[k].numpy() - jparams[k]))
                  for k in jparams)
        assert gap > 1e-4, gap
        return
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert st["step"] == jstep == 8
    for k in jparams:
        np.testing.assert_allclose(tp[k].numpy(), jparams[k], rtol=1e-4,
                                   atol=1e-6)

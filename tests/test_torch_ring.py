"""The port's sequence-parallel ring (``hetu_tpu_torch.parallel``) against
the JAX package's, on the JAX tests' ``sp=4, dp=2`` mesh of virtual CPU
devices with the Pallas kernels in interpret mode; the port runs its
plain versions on a local mesh of the same spec on the CPU.

- the block kernels' plain versions against ``flash_block_fwd`` /
  ``flash_block_bwd(..., interpret=True)`` fed the same GLOBAL lse and
  delta, with chunks that JAX splits into several blocks (its fused and
  its two-kernel backward): fp32, forward atol 2e-5 and gradients atol
  2e-4, as ``tests/test_torch_flash.py``;
- ``ring_attn_fn`` (flash and blockwise cores) and ``ulysses_attn_fn``
  against the JAX factories: values rtol = atol = 2e-5, causal gradients
  rtol 1e-4 / atol 1e-5, as ``tests/test_sequence_parallel.py``;
- a tiny GPT with the ring ``attn_fn`` against the JAX GPT with the JAX
  ring (logits, loss and step-0 gradients at the tolerances of
  ``tests/test_torch_train.py``), then three AdamW ``Trainer`` steps
  against the port's own GPT without the ring on the same weights;
- the blockwise core with ``remat=False`` against ``remat=True`` and
  the JAX one;
- the local collectives, what the ring accepts (``head_axis``, the
  ``sp=4, dp=2`` mesh) and what it refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.core import set_random_seed
from hetu_tpu.core.module import named_parameters
from hetu_tpu.layers import dot_product_attention as jax_dot_product_attention
from hetu_tpu.models.gpt import GPT as JaxGPT
from hetu_tpu.models.gpt import GPTConfig as JaxConfig
from hetu_tpu.ops.pallas import flash as jflash
from hetu_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from hetu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from hetu_tpu.parallel.ring_attention import ring_attn_fn as jax_ring_attn_fn
from hetu_tpu.parallel.ring_attention import (
    ulysses_attn_fn as jax_ulysses_attn_fn)
from hetu_tpu_torch import AdamWOptimizer, GPT, GPTConfig, Trainer
from hetu_tpu_torch.interop import export_params, load_jax_params
from hetu_tpu_torch.ops.kernels import flash
from hetu_tpu_torch.layers import dot_product_attention
from hetu_tpu_torch.parallel import (MeshSpec, all_to_all, make_mesh,
                                     ppermute, ring_attn_fn, send_next,
                                     ulysses_attn_fn)

FWD_TOL, GRAD_TOL = 2e-5, 2e-4
IMPLS = ["flash", "blockwise"]


@pytest.fixture
def sp_mesh():
    return jax_make_mesh(JaxMeshSpec(sp=4, dp=2), devices=jax.devices())


@pytest.fixture
def mesh():
    return make_mesh(MeshSpec(sp=4, dp=2), device="cpu")


def _global_stats(q, k, v, do, causal, c):
    """The second chunk's rows of the whole-sequence attention: its lse
    and delta = rowsum(dO * O), ``(B, H, c, 1)``, as the ring computes
    them before its backward."""
    o, lse = flash.flash_fwd_plain(q, k, v, causal=causal,
                                   scale=q.shape[-1] ** -0.5)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    return lse[:, :, c:, None].contiguous(), delta[:, :, c:].contiguous()


# (global causal, kv chunk, block causal): the ring's diagonal and past
# visits under causal masking, and a visit without it
CASES = {"diagonal": (True, 1, True), "past": (True, 0, False),
         "full": (False, 0, False)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("blocks", [(8, 8), (16, 4)])
def test_block_backward_plain_matches_pallas(case, blocks):
    """(8, 8) runs JAX's fused backward over 4 x 4 blocks; (16, 4) its
    two-kernel backward (12 kv blocks, more than its 8 dQ partials)."""
    causal, kv, block_causal = CASES[case]
    B, H, c, D = 2, 3, 48, 16
    rng = np.random.default_rng(len(case) + blocks[1])
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, H, 2 * c, D)).astype(np.float32)) for _ in range(4))
    lse, delta = _global_stats(q, k, v, do, causal, c)
    qc, doc = q[:, :, c:].contiguous(), do[:, :, c:].contiguous()
    kc, vc = (x[:, :, kv * c:(kv + 1) * c].contiguous() for x in (k, v))
    scale = D ** -0.5
    got = flash.flash_block_bwd_plain(qc, kc, vc, doc, lse, delta,
                                      causal=block_causal, scale=scale)
    ref = jflash.flash_block_bwd(
        *(jnp.asarray(x.numpy()) for x in (qc, kc, vc, doc, lse, delta)),
        scale=scale, causal=block_causal, block_q=blocks[0],
        block_k=blocks[1], interpret=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
    # the wrapper's CPU route is the plain version
    same = flash.flash_block_bwd(qc, kc, vc, doc, lse, delta,
                                 causal=block_causal, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(same, got))


@pytest.mark.parametrize("causal", [False, True])
def test_block_forward_matches_pallas(causal):
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((2, 3, 40, 32)).astype(np.float32)
               for _ in range(3))
    scale = 32 ** -0.5
    jo, jl = jflash.flash_block_fwd(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), scale=scale,
                                    causal=causal, block_q=8, block_k=8,
                                    interpret=True)
    o, lse = flash.flash_block_fwd(*map(torch.from_numpy, (q, k, v)),
                                   scale=scale, causal=causal)
    assert tuple(lse.shape) == (2, 3, 40, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jl), rtol=0,
                               atol=FWD_TOL)


def _qkv(b=2, s=16, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("causal", [False, True])
def test_ring_forward_matches_jax(sp_mesh, mesh, impl, causal):
    q, k, v = _qkv()
    ref = jax.jit(lambda q, k, v: jax_ring_attn_fn(sp_mesh, impl=impl)(
        q, k, v, causal=causal))(*map(jnp.asarray, (q, k, v)))
    out = ring_attn_fn(mesh, impl=impl)(*map(torch.from_numpy, (q, k, v)),
                                        causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_ring_gradients_match_jax(sp_mesh, mesh, impl):
    q, k, v = _qkv(seed=2)
    jfn = jax_ring_attn_fn(sp_mesh, impl=impl)
    ref = jax.jit(jax.grad(
        lambda q, k, v: (jfn(q, k, v, causal=True) ** 2).mean(),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (ring_attn_fn(mesh, impl=impl)(tq, tk, tv, causal=True) ** 2
     ).mean().backward()
    for name, a, b in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("inner", ["flash", "dense"])
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(sp_mesh, mesh, causal, inner):
    """The default local core (flash) and the materialized one."""
    q, k, v = _qkv(seed=1)
    dense = inner == "dense"
    jfn = jax_ulysses_attn_fn(
        sp_mesh, inner_fn=jax_dot_product_attention if dense else None)
    ref = jax.jit(lambda q, k, v: jfn(q, k, v, causal=causal))(
        *map(jnp.asarray, (q, k, v)))
    fn = ulysses_attn_fn(mesh,
                         inner_fn=dot_product_attention if dense else None)
    out = fn(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


V, E, L, H, S, B = 128, 64, 2, 4, 32, 4


def _gpt_pair(sp_mesh, mesh, impl):
    kw = dict(vocab_size=V, hidden_size=E, num_layers=L, num_heads=H,
              max_seq_len=S)
    set_random_seed(0)
    jm = JaxGPT(JaxConfig(**kw),
                attn_fn=jax_ring_attn_fn(sp_mesh, impl=impl))
    tm = GPT(GPTConfig(**kw), attn_fn=ring_attn_fn(mesh, impl=impl),
             device="cpu")
    load_jax_params(tm, {n: np.asarray(a) for n, a in named_parameters(jm)})
    return jm, tm


@pytest.mark.parametrize("impl", IMPLS)
def test_gpt_with_the_ring_matches_jax(sp_mesh, mesh, impl):
    jm, tm = _gpt_pair(sp_mesh, mesh, impl)
    ids = np.random.default_rng(1).integers(0, V, (B, S))
    jids = jnp.asarray(ids, jnp.int32)
    jlogits = jax.jit(lambda m, x: m(x))(jm, jids)
    jl, jg = jax.jit(jax.value_and_grad(lambda m, x: m.loss(x)))(jm, jids)
    tids = torch.from_numpy(ids)
    with torch.no_grad():
        logits = tm(tids)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=2e-5)
    tl = tm.loss(tids)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=2e-5)
    own = dict(tm.named_parameters())
    for name, g in named_parameters(jg):
        ours = own[name].grad.numpy()
        if ours.ndim == 2 and name.endswith(("wqkv", "wo", "w_in", "w_out")):
            ours = ours.T
        np.testing.assert_allclose(ours, np.asarray(g), rtol=5e-3,
                                   atol=1e-5, err_msg=name)


def _loss_fn(model, batch, key):
    return model.loss(batch, key=key), {}


@pytest.mark.parametrize("impl", IMPLS)
def test_three_trainer_steps_match_the_model_without_the_ring(mesh, impl):
    kw = dict(vocab_size=V, hidden_size=E, num_layers=L, num_heads=H,
              max_seq_len=S)
    ring = GPT(GPTConfig(**kw), attn_fn=ring_attn_fn(mesh, impl=impl),
               device="cpu")
    dense = GPT(GPTConfig(**kw), device="cpu")
    dense.load_state_dict(ring.state_dict())
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, V, (B, S)))
    losses = {}
    for name, m in (("ring", ring), ("dense", dense)):
        tr = Trainer(m, AdamWOptimizer(learning_rate=3e-3,
                                       weight_decay=0.01), _loss_fn)
        losses[name] = [float(tr.step(ids)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(losses["ring"], losses["dense"], rtol=0,
                               atol=1e-4)
    assert losses["ring"][-1] < losses["ring"][0]
    got, ref = export_params(ring), export_params(dense)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_blockwise_remat_changes_no_number(sp_mesh, mesh):
    """``remat=False`` keeps each visit's intermediates instead of
    recomputing them: the same output and gradients as ``remat=True``,
    and as the JAX core without remat."""
    q, k, v = _qkv(seed=3)
    jfn = jax_ring_attn_fn(sp_mesh, impl="blockwise", remat=False)
    jout, jgrads = jax.jit(jax.value_and_grad(
        lambda q, k, v: (jfn(q, k, v, causal=True) ** 2).mean(),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    got = {}
    for remat in (True, False):
        ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        loss = (ring_attn_fn(mesh, impl="blockwise", remat=remat)(
            *ts, causal=True) ** 2).mean()
        loss.backward()
        got[remat] = [loss.detach()] + [t.grad for t in ts]
    assert all(torch.equal(a, b) for a, b in zip(got[True], got[False]))
    np.testing.assert_allclose(float(got[False][0]), float(jout), rtol=2e-5)
    for a, b in zip(got[False][1:], jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_local_collectives():
    xs = [torch.full((2,), float(i)) for i in range(4)]
    assert [float(x[0]) for x in send_next(xs)] == [3, 0, 1, 2]
    assert send_next([None, xs[1], None, None])[2] is xs[1]
    got = ppermute(xs, [(0, 2), (2, 0)])
    assert [float(x[0]) for x in got] == [2, 0, 0, 0]
    assert float(got[1].abs().sum()) == 0.0
    chunks = [torch.arange(24.).reshape(1, 2, 4, 3) + 100 * r
              for r in range(4)]
    heads = all_to_all(chunks, split_dim=2, concat_dim=1)
    assert heads[1].shape == (1, 8, 1, 3)
    assert torch.equal(torch.cat(heads, 2), torch.cat(chunks, 1))
    back = all_to_all(heads, split_dim=1, concat_dim=2)
    assert all(torch.equal(a, b) for a, b in zip(back, chunks))


def test_what_the_ring_refuses(mesh):
    q = torch.zeros((2, 16, 4, 8))
    mask = torch.ones((2, 1, 16, 16), dtype=torch.bool)
    for fn in (ring_attn_fn(mesh), ulysses_attn_fn(mesh)):
        with pytest.raises(NotImplementedError, match="padding masks"):
            fn(q, q, q, mask)
        with pytest.raises(ValueError, match="divisible"):
            fn(q[:, :14], q[:, :14], q[:, :14])
    with pytest.raises(ValueError, match="heads not divisible"):
        ulysses_attn_fn(mesh)(q[:, :, :3], q[:, :, :3], q[:, :, :3])
    # every canonical axis exists on the mesh (size 1 when unused), so
    # "tp" names one; a foreign name is refused, as the reference does
    assert ring_attn_fn(mesh, head_axis="tp").spec == ("dp", "sp", "tp")
    assert ulysses_attn_fn(mesh, head_axis="tp").spec == ("dp", "sp", "tp")
    assert ring_attn_fn(mesh).spec == ("dp", "sp", None)
    for make in (ring_attn_fn, ulysses_attn_fn):
        with pytest.raises(ValueError, match="head_axis"):
            make(mesh, head_axis="heads")
    for knob in ("interpret", "block_q", "block_k"):
        with pytest.raises(TypeError, match=knob):
            ring_attn_fn(mesh, **{knob: True})
    with pytest.raises(ValueError, match="impl"):
        ring_attn_fn(mesh, impl="pallas")
    with pytest.raises(ValueError, match="not in mesh axes"):
        ring_attn_fn(mesh, axis="cp")
    assert make_mesh(MeshSpec(sp=4, dp=2), device="cpu").shape["dp"] == 2
    with pytest.raises(ValueError, match="mesh on"):
        ring_attn_fn(mesh)(*(q.to("meta"),) * 3)

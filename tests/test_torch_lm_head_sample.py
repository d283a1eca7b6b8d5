"""Fused LM-head sampling in the PyTorch port: the plain version (what a
CPU tensor runs) against the JAX package.  Greedy tokens must equal
``lm_head_sample_pallas(mode="greedy", interpret=True)``; top-k values
and indices must equal ``jax.lax.top_k`` on the same fp32 logits,
including the tie order (smallest index first), with V not a multiple
of any block.  Values: fp32, atol 1e-5; indices exactly.

Rows with NaN, +inf and -inf logits are held to ``greedy_sample``
(``jnp.argmax``: the first NaN wins) and to ``lax.top_k`` on NaNs whose
sign bit is clear.  The Pallas kernel itself returns its sentinel index
for a row that holds a NaN (its ``==`` on a NaN max matches nothing), so
those rows are not compared with it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.ops.pallas.lm_head import lm_head_sample_pallas
from hetu_tpu.ops.random import greedy_sample
from hetu_tpu_torch.ops.kernels import lm_head as lh

ATOL = 1e-5


def _inputs(N, E, V, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, E)).astype(np.float32)
    w = (rng.standard_normal((E, V)) * 0.3).astype(np.float32)  # JAX (E, V)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    return h, w, b


@pytest.mark.parametrize("N,E,V", [(8, 64, 128), (3, 32, 257), (5, 48, 1000)])
def test_greedy_equals_pallas(N, E, V):
    h, w, b = _inputs(N, E, V)
    ref = np.asarray(lm_head_sample_pallas(
        jnp.asarray(h), jnp.asarray(w), bias=jnp.asarray(b), mode="greedy",
        interpret=True))
    got = lh.lm_head_greedy(torch.from_numpy(h),
                            torch.from_numpy(np.ascontiguousarray(w.T)),
                            bias=torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", [1, 5, 17])
def test_topk_equals_lax_top_k(k):
    N, E, V = 4, 32, 301
    h, w, b = _inputs(N, E, V, seed=k)
    vals, idx = lh.lm_head_sample(torch.from_numpy(h),
                                  torch.from_numpy(np.ascontiguousarray(w.T)),
                                  k=k, bias=torch.from_numpy(b))
    lg = jnp.asarray(h) @ jnp.asarray(w) + jnp.asarray(b)
    rv, ri = jax.lax.top_k(lg, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=0,
                               atol=ATOL)


def test_exact_ties_take_the_smallest_index_first():
    """Small integer inputs give exact logits with many equal values: the
    order must be lax.top_k's (ascending index among equal values), and
    greedy must pick the first maximum, as jnp.argmax does."""
    N, E, V, k = 4, 8, 203, 9
    rng = np.random.default_rng(7)
    h = rng.integers(-2, 3, (N, E)).astype(np.float32)
    w = rng.integers(-1, 2, (E, V)).astype(np.float32)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    vals, idx = lh.lm_head_sample(torch.from_numpy(h), wt, k=k)
    lg = jnp.asarray(h) @ jnp.asarray(w)
    rv, ri = jax.lax.top_k(lg, k)
    assert (np.diff(np.asarray(rv), axis=1) == 0).any()  # ties present
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))
    greedy = lh.lm_head_greedy(torch.from_numpy(h), wt).numpy()
    np.testing.assert_array_equal(greedy, np.asarray(lm_head_sample_pallas(
        jnp.asarray(h), jnp.asarray(w), mode="greedy", interpret=True)))
    np.testing.assert_array_equal(greedy, np.argmax(h @ w, axis=1))


def test_gumbel_field_matches_the_tpu_kernel_formula():
    """With a noise field g the function is top-k of g + lg / T."""
    N, E, V, T = 2, 16, 130, 0.7
    h, w, b = _inputs(N, E, V, seed=3)
    g = np.random.default_rng(4).gumbel(size=(N, V)).astype(np.float32)
    vals, idx = lh.lm_head_sample(torch.from_numpy(h),
                                  torch.from_numpy(np.ascontiguousarray(w.T)),
                                  k=3, bias=torch.from_numpy(b),
                                  gumbel=torch.from_numpy(g), temperature=T)
    lg = jnp.asarray(h) @ jnp.asarray(w) + jnp.asarray(b)
    rv, ri = jax.lax.top_k(jnp.asarray(g) + lg / T, 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=0,
                               atol=ATOL)


def test_k_out_of_range_raises_and_cpu_launches_nothing():
    h, w, _ = _inputs(2, 8, 50)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    with pytest.raises(ValueError):
        lh.lm_head_sample(torch.from_numpy(h), wt, k=0)
    with pytest.raises(ValueError):
        lh.lm_head_sample(torch.from_numpy(h), wt, k=51)
    lh.reset_launch_count()
    lh.lm_head_sample(torch.from_numpy(h), wt, k=2)
    assert lh.launch_count() == 0


# NaN, +inf and -inf logits placed through the bias (the same columns in
# every row) and an all-NaN row through a NaN in h.  V = 300 spans three
# of the Pallas kernel's 128-column vocab blocks: the NaNs at 7 and 200
# lie in two of them, the +inf at 250 in the second.
SPECIAL = ["nan_nan_inf", "nan", "inf", "neg_inf"]


def _special(case, N=4, E=32, V=300):
    h, w, b = _inputs(N, E, V, seed=11)
    if case == "nan_nan_inf":
        b[[7, 200]] = np.nan
        b[250] = np.inf
        h[1] = np.nan                  # row 1: every logit NaN
    elif case == "nan":
        b[200] = np.nan
    elif case == "inf":
        b[250] = np.inf
    else:                              # every row all -inf
        h[:] = 0.0
        b[:] = -np.inf
    return h, w, b


def _torch_args(h, w, b):
    return (torch.from_numpy(h), torch.from_numpy(np.ascontiguousarray(w.T)),
            torch.from_numpy(b))


@pytest.mark.parametrize("case", SPECIAL)
def test_greedy_ranks_nan_first_as_argmax(case):
    h, w, b = _special(case)
    lg = jnp.asarray(h) @ jnp.asarray(w) + jnp.asarray(b)
    th, tw, tb = _torch_args(h, w, b)
    got = lh.lm_head_greedy(th, tw, bias=tb).numpy()
    np.testing.assert_array_equal(got, np.asarray(greedy_sample(lg)))
    if case == "neg_inf":
        assert (got == 0).all()


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("case", SPECIAL)
def test_topk_ranks_nan_first_as_lax_top_k(case, k):
    h, w, b = _special(case)
    lg = jnp.asarray(h) @ jnp.asarray(w) + jnp.asarray(b)
    nans = np.asarray(lg)[np.isnan(np.asarray(lg))]
    assert not np.signbit(nans).any()   # lax.top_k ranks these NaNs first
    th, tw, tb = _torch_args(h, w, b)
    vals, idx = lh.lm_head_sample(th, tw, k=k, bias=tb)
    rv, ri = jax.lax.top_k(lg, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=0,
                               atol=ATOL)
    if case == "nan_nan_inf":
        np.testing.assert_array_equal(idx.numpy()[1], np.arange(k))


_NEG_NAN = np.copysign(np.float32(np.nan), np.float32(-1.0))


@pytest.mark.parametrize("logits,port,top_k", [
    ([-0.0, 0.0, -1.0], [0, 1, 2], [1, 0, 2]),
    ([_NEG_NAN, 1.0, np.nan, -np.inf], [0, 2, 1, 3], [2, 1, 3, 0]),
], ids=["signed_zeros", "nan_with_sign_bit"])
def test_port_order_where_lax_top_k_differs(logits, port, top_k):
    """The two corners where ``lax.top_k`` on the CPU differs from
    ``jnp.argmax``.  ``lax.top_k`` sorts by total order: +0.0 above -0.0,
    and a NaN whose sign bit is set below -inf.  ``jnp.argmax``, the
    Pallas kernel (``==`` on ``jnp.max``) and ``torch.sort`` treat the
    zeros as equal and rank every NaN first; the port keeps that one
    order for every k, so its indices here are not ``lax.top_k``'s.  With
    E = 1 and h = 1 the logits are the weights exactly, signs included;
    ``vals`` are the logits themselves."""
    w = np.asarray(logits, np.float32)[:, None]               # (V, 1)
    h = np.ones((2, 1), np.float32)
    vals, idx = lh.lm_head_sample(torch.from_numpy(h), torch.from_numpy(w),
                                  k=len(logits))
    lg = jnp.asarray(h) @ jnp.asarray(w.T)
    assert np.array_equal(np.signbit(np.asarray(lg)[0]), np.signbit(w[:, 0]))
    np.testing.assert_array_equal(idx.numpy(), [port, port])
    np.testing.assert_array_equal(np.signbit(vals.numpy()),
                                  np.signbit(w[port, 0])[None].repeat(2, 0))
    np.testing.assert_array_equal(lh.lm_head_greedy(
        torch.from_numpy(h), torch.from_numpy(w)).numpy(),
        np.asarray(greedy_sample(lg)))
    ref_idx = jax.lax.top_k(lg, len(logits))[1]
    np.testing.assert_array_equal(np.asarray(ref_idx), [top_k, top_k])


def _row_keys(N, seed=0):
    """Per-row keys as the serving engine derives them, in both forms."""
    keys = jax.vmap(lambda r, p: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(seed), r), p))(
        jnp.arange(N), jnp.arange(N) + 9)
    words = torch.from_numpy(
        np.asarray(jax.random.key_data(keys)).astype(np.int64))
    return keys, words


@pytest.mark.parametrize("mode,top_k,T", [
    ("greedy", 5, 1.0), ("temperature", 5, 0.8), ("temperature", 5, 1.7),
    ("top_k", 5, 0.8), ("top_k", 1, 0.8), ("top_k", 128, 1.2),
    ("temperature", 5, 0.0), ("top_k", 5, -1.0)])
@pytest.mark.parametrize("N,E,V", [(8, 32, 300), (3, 16, 1000)])
def test_sample_tokens_equal_pallas(mode, top_k, T, N, E, V):
    """``lm_head_sample_tokens`` against ``lm_head_sample_pallas(...,
    interpret=True)`` with the same per-row keys: tokens equal (T <= 0 is
    greedy in both)."""
    h, w, b = _inputs(N, E, V, seed=N + V)
    keys, words = _row_keys(N, seed=V)
    ref = np.asarray(lm_head_sample_pallas(
        jnp.asarray(h), jnp.asarray(w), bias=jnp.asarray(b), mode=mode,
        top_k=top_k, temperature=T, keys=keys, interpret=True))
    got = lh.lm_head_sample_tokens(
        torch.from_numpy(h), torch.from_numpy(np.ascontiguousarray(w.T)),
        bias=torch.from_numpy(b), mode=mode, top_k=top_k, temperature=T,
        keys=words)
    assert got.dtype == torch.int32 and tuple(got.shape) == (N,)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sample_tokens_refusals():
    h, w, _ = _inputs(2, 8, 200)
    th, tw = torch.from_numpy(h), torch.from_numpy(np.ascontiguousarray(w.T))
    _, words = _row_keys(2)
    with pytest.raises(ValueError, match="unknown sampling mode"):
        lh.lm_head_sample_tokens(th, tw, mode="nucleus", keys=words)
    for mode in ("temperature", "top_k"):
        with pytest.raises(ValueError, match="keys"):
            lh.lm_head_sample_tokens(th, tw, mode=mode)
    for k in (0, 129):
        with pytest.raises(ValueError, match="top_k"):
            lh.lm_head_sample_tokens(th, tw, mode="top_k", top_k=k,
                                     keys=words)
    # k above V is clamped to V first, as lax.top_k needs
    got = lh.lm_head_sample_tokens(th[:, :8], tw[:100], mode="top_k",
                                   top_k=1000, keys=words)
    assert tuple(got.shape) == (2,)
    # a greedy collapse needs no keys
    greedy = lh.lm_head_greedy(th, tw)
    assert torch.equal(lh.lm_head_sample_tokens(
        th, tw, mode="temperature", temperature=0.0), greedy)


@pytest.mark.parametrize("mode", ["temperature", "top_k"])
def test_plain_route_of_the_sample_tokens_equals_pallas(mode):
    """``_sample_tokens_plain``, the reference the card checks hold the
    kernel's tokens to, against ``lm_head_sample_pallas(...,
    interpret=True)``: tokens equal, and every gap between a row's two
    best perturbed scores is positive."""
    N, E, V, T = 8, 32, 300, 0.8
    h, w, _ = _inputs(N, E, V, seed=3)
    keys, words = _row_keys(N, seed=4)
    ref = np.asarray(lm_head_sample_pallas(
        jnp.asarray(h), jnp.asarray(w), mode=mode, top_k=5, temperature=T,
        keys=keys, interpret=True))
    got, gap = lh._sample_tokens_plain(
        torch.from_numpy(h), torch.from_numpy(np.ascontiguousarray(w.T)),
        mode=mode, top_k=5, temperature=T, keys=words)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tuple(gap.shape) == (N,) and bool((gap > 0).all())

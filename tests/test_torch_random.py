"""The port's threefry bits and random ops against ``jax.random`` and
``hetu_tpu.ops.random`` (JAX on the CPU), with numpy-seeded inputs.

Bitwise: ``core.prng.random_bits`` (JAX's partitionable path),
``fold_in_tensor``, the uniform (``rand``, ``uniform_sample``, with
``minval=tiny`` and other bounds) and ``randint_sample``.  The
uniform's ``* (max - min) + min`` is two rounded operations in JAX's
definition and in the port; XLA keeps them two at the suite's
``--xla_backend_optimization_level=0`` (``tests/conftest.py``), while
its CPU backend at the default level fuses them into one fma.  Within a
tolerance: the Gumbel field, absolute 2e-6 (``torch.log`` and XLA's
``log`` differ by an ulp on some inputs; 9.5e-7 at most measured), and
the normals, 1e-5 relative plus 1e-6 absolute (``torch.erfinv``
against XLA's polynomial; 5.6e-6 relative at most measured, in the
tails).  Equal: the tokens that
``temperature_sample`` and ``top_k_sample`` draw, at V = 128 over 200
rows and at V = 50257 over a few."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.core import rng as jrng
from hetu_tpu.ops import random as JR
from hetu_tpu_torch.core import prng
from hetu_tpu_torch.core import rng as trng
from hetu_tpu_torch.ops import random as R

TINY = float(np.finfo(np.float32).tiny)
GUMBEL_ATOL = 2e-6
NORMAL_RTOL, NORMAL_ATOL = 1e-5, 1e-6


def _key(seed, a=3, b=17):
    """A JAX key ``fold_in(fold_in(PRNGKey(seed), a), b)`` and its words."""
    k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), a),
                           b)
    return k, _words(k)


def _words(k):
    return torch.from_numpy(
        np.asarray(jax.random.key_data(k)).astype(np.int64))


def _bits(x):
    return np.asarray(x).view(np.uint32)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (50257,), (3, 5),
                                   (4, 33)])
def test_random_bits_match_jax(shape):
    jk, tk = _key(0)
    ref = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    got = prng.random_bits(tk, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("shape", [(), (129,), (6, 7)])
def test_random_bits_of_a_batch_of_keys_match_vmapped_jax(shape):
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    ref = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, shape, jnp.uint32))(keys))
    got = prng.random_bits(_words(keys), shape)
    assert tuple(got.shape) == (4, *shape)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
def test_fold_in_tensor_matches_host_fold_in_and_jax(seed):
    """int32 data (negative values wrap to uint32) and int64 data at and
    above 2**31, each row with its own key, and one key shared by all."""
    rng = np.random.default_rng(seed % 1000)
    keys = jnp.stack([jax.random.PRNGKey(int(s))
                      for s in rng.integers(0, 2**31, 5)])
    data = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.int64)
    ref = np.asarray(jax.vmap(lambda k, d: jax.random.key_data(
        jax.random.fold_in(k, d)))(keys, jnp.asarray(data, jnp.uint32)))
    got = prng.fold_in_tensor(_words(keys), torch.from_numpy(data))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    host = [prng.fold_in(k, int(d)).tolist()
            for k, d in zip(_words(keys), data)]
    assert got.tolist() == host
    neg = np.array([-1, -2**31, 5], np.int32)
    one = prng.key(seed)
    got = prng.fold_in_tensor(one, torch.from_numpy(neg))
    ref = [np.asarray(jax.random.key_data(jax.random.fold_in(
        jax.random.PRNGKey(seed % 2**32), int(d)))).tolist()
        for d in neg.astype(np.uint32)]
    assert got.tolist() == ref


@pytest.mark.parametrize("low,high", [(0.0, 1.0), (TINY, 1.0),
                                      (-3.5, 7.25), (0.1, 0.3),
                                      (-1.0, 1.0), (1e-3, 1e3)])
def test_uniform_is_bitwise_jax(low, high):
    jk, tk = _key(1)
    ref = JR.uniform_sample((50257,), low, high, key=jk)
    got = R.uniform_sample((50257,), low, high, key=tk, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("dtype,jdtype", [
    (torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
    (torch.float16, jnp.float16)])
def test_rand_is_bitwise_jax(dtype, jdtype):
    jk, tk = _key(2)
    ref = np.asarray(JR.rand((3, 1000), jdtype, key=jk)).astype(np.float32)
    got = R.rand((3, 1000), dtype, key=tk, device="cpu")
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert 0.0 <= got.min() and got.max() < 1.0


@pytest.mark.parametrize("low,high,dtype,jdtype", [
    (0, 10, torch.int32, jnp.int32), (-5, 50257, torch.int32, jnp.int32),
    (-2**31, 2**31 - 1, torch.int32, jnp.int32),
    (3, 100000, torch.int32, jnp.int32), (5, 3, torch.int32, jnp.int32),
    (0, 7, torch.int8, jnp.int8), (-100, 100, torch.int16, jnp.int16),
    (0, 256, torch.uint8, jnp.uint8)])
def test_randint_is_bitwise_jax(low, high, dtype, jdtype):
    jk, tk = _key(3)
    ref = np.asarray(JR.randint_sample((5000,), low, high, jdtype, key=jk))
    got = R.randint_sample((5000,), low, high, dtype, key=tk, device="cpu")
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", [(50257,), (8, 300)])
def test_gumbel_within_tolerance(shape):
    jk, tk = _key(4)
    ref = np.asarray(JR.gumbel_sample(shape, key=jk))
    got = R.gumbel_sample(shape, key=tk, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GUMBEL_ATOL)


@pytest.mark.parametrize("name", ["normal_sample", "truncated_normal_sample"])
@pytest.mark.parametrize("mean,stddev", [(0.0, 1.0), (0.5, 0.02)])
def test_normals_within_tolerance(name, mean, stddev):
    jk, tk = _key(5)
    ref = np.asarray(getattr(JR, name)((50257,), mean, stddev, key=jk))
    got = getattr(R, name)((50257,), mean, stddev, key=tk,
                           device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=NORMAL_RTOL, atol=NORMAL_ATOL)
    if name == "truncated_normal_sample":
        assert np.abs(got - mean).max() < 2 * stddev


def _margin(logits, key_words, k=None, T=0.8):
    """The two best candidates' gap in the port's perturbed logits: how
    close to a tie a mismatching row was."""
    lg = torch.from_numpy(logits).float()
    if k is not None:
        lg = R._top_k(lg, k)[0]
    s = torch.sort(R._gumbel(key_words, lg.shape[-1:]) + lg / T,
                   descending=True).values
    return float(s[..., 0] - s[..., 1])


def _assert_tokens_equal(got, ref, logits, keys, k=None):
    bad = np.nonzero(got != ref)[0]
    margins = [_margin(logits[i], keys[i], k) for i in bad]
    assert bad.size == 0, (f"rows {bad.tolist()} differ; margins between "
                           f"the two best candidates {margins}")


@pytest.mark.parametrize("V,rows", [(128, 200), (50257, 4)])
@pytest.mark.parametrize("mode", ["temperature", "top_k"])
def test_sampled_tokens_equal_jax(V, rows, mode):
    """Row ``r`` drawn with its own key, as the serving engine draws."""
    T, k = 0.8, 5
    rng = np.random.default_rng(V + rows)
    logits = (rng.standard_normal((rows, V)) * 3).astype(np.float32)
    jkeys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(7), i), 2 * i))(
        jnp.arange(rows))
    if mode == "temperature":
        ref = jax.vmap(lambda kk, lg: JR.temperature_sample(lg, T, key=kk))(
            jkeys, jnp.asarray(logits))
        got = R.temperature_sample(torch.from_numpy(logits), T,
                                   key=_words(jkeys))
    else:
        ref = jax.vmap(lambda kk, lg: JR.top_k_sample(lg, k, T, key=kk))(
            jkeys, jnp.asarray(logits))
        got = R.top_k_sample(torch.from_numpy(logits), k, T,
                             key=_words(jkeys))
    assert got.dtype == torch.int32 and tuple(got.shape) == (rows,)
    _assert_tokens_equal(got.numpy(), np.asarray(ref), logits,
                         _words(jkeys), None if mode == "temperature" else k)


@pytest.mark.parametrize("mode", ["temperature", "top_k"])
def test_one_key_draws_the_whole_field_of_batched_logits(mode):
    """One key and ``(N, V)`` logits: one Gumbel field of the whole shape,
    as ``jax.random.categorical`` draws it."""
    logits = np.random.default_rng(9).standard_normal((6, 300)).astype(
        np.float32)
    jk, tk = _key(6)
    if mode == "temperature":
        ref = JR.temperature_sample(jnp.asarray(logits), 1.3, key=jk)
        got = R.temperature_sample(torch.from_numpy(logits), 1.3, key=tk)
    else:
        ref = JR.top_k_sample(jnp.asarray(logits), 7, 1.3, key=jk)
        got = R.top_k_sample(torch.from_numpy(logits), 7, 1.3, key=tk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_zero_temperature_is_greedy_and_top_k_clamps_to_the_vocabulary():
    logits = np.random.default_rng(10).standard_normal((5, 40)).astype(
        np.float32)
    t = torch.from_numpy(logits)
    jk, tk = _key(7)
    greedy = R.greedy_sample(t).numpy()
    np.testing.assert_array_equal(greedy, np.argmax(logits, axis=-1))
    for T in (0.0, -1.0):
        np.testing.assert_array_equal(R.temperature_sample(t, T).numpy(),
                                      greedy)
        np.testing.assert_array_equal(R.top_k_sample(t, 3, T).numpy(),
                                      greedy)
    ref = JR.top_k_sample(jnp.asarray(logits), 1000, 0.9, key=jk)
    got = R.top_k_sample(t, 1000, 0.9, key=tk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (R.top_k_sample(t, 1, 0.9, key=tk).numpy() == greedy).all()


def test_key_none_follows_the_global_seed_as_the_reference():
    """``key=None`` draws ``next_key()``: the same sequence of keys as
    the JAX package's global RNG, so the same draws; a greedy collapse
    draws no key."""
    jrng.set_random_seed(11)
    trng.set_random_seed(11)
    refs = [np.asarray(JR.rand((16,))), np.asarray(JR.randint_sample(
        (16,), 0, 9)), np.asarray(JR.uniform_sample((16,), -2.0, 3.0))]
    gots = [R.rand((16,), device="cpu"),
            R.randint_sample((16,), 0, 9, device="cpu"),
            R.uniform_sample((16,), -2.0, 3.0, device="cpu")]
    for ref, got in zip(refs, gots):
        np.testing.assert_array_equal(got.numpy(), ref)
    R.temperature_sample(torch.zeros(3, 4), 0.0)
    JR.temperature_sample(jnp.zeros((3, 4)), 0.0)
    assert trng.get_seed_status() == jrng.get_seed_status() == (11, 3)
    np.testing.assert_allclose(R.gumbel_sample((64,), device="cpu").numpy(),
                               np.asarray(JR.gumbel_sample((64,))),
                               rtol=0, atol=GUMBEL_ATOL)


def test_unsupported_types_raise():
    with pytest.raises(TypeError):
        R.rand((2,), torch.float64, key=prng.key(0), device="cpu")
    with pytest.raises(TypeError):
        R.randint_sample((2,), 0, 5, torch.int64, key=prng.key(0),
                         device="cpu")
    with pytest.raises(ValueError):
        prng.random_bits(torch.zeros(3, dtype=torch.int64), (2,))


@pytest.mark.parametrize("name,args", [
    ("rand", ()), ("uniform_sample", (-1.0, 2.0)), ("normal_sample", ()),
    ("truncated_normal_sample", ()), ("gumbel_sample", ()),
    ("randint_sample", (0, 9))])
def test_draws_run_on_the_card_unless_the_cpu_is_asked_for(name, args):
    """``device=None`` is the card, as for every entry point of the port:
    without a card the draw raises, before it takes a key from the global
    RNG; ``device="cpu"`` moves a given key there (a tensor or an array
    of its words) and draws what the key alone decides."""
    fn = getattr(R, name)
    trng.set_random_seed(3)
    if torch.cuda.is_available():
        assert fn((4,), *args).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn((4,), *args)
        assert trng.get_seed_status() == (3, 0)
    a = fn((4,), *args, key=prng.key(1), device="cpu")
    b = fn((4,), *args, key=prng.key(1).numpy(), device=torch.device("cpu"))
    assert a.device.type == "cpu" and torch.equal(a, b)

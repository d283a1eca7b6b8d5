"""The plain version of the port's fused residual + dropout + LayerNorm
against the JAX package's Pallas kernels in interpret mode, on the CPU:
rates 0, 0.1 and 0.5, D = 128 with a ragged T (7 x 13 rows), fp32 and
bf16, the same inputs from a numpy seed and the same key; and the CUDA
backward's grid size, a pure function of the row count.

Tolerances: fp32 forward within 1e-6 of the largest output (sums in
another order), the kept/dropped pattern bitwise (the zeros of dy where
dx is not 0), gradients within 2e-4 of each gradient's largest value;
bf16 outputs and gradients within one bf16 spacing (both round fp32
results once), dscale/dbias (fp32 in both) within 2e-4."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.ops.pallas.fused_ln import (
    fused_residual_dropout_ln as jax_fused)
from hetu_tpu_torch.core import prng
from hetu_tpu_torch.ops.kernels import fused_ln as fln
from hetu_tpu_torch.ops.kernels.fused_ln import fused_residual_dropout_ln
from hetu_tpu_torch.ops.nn import dropout, layer_norm

SHAPE = (7, 13, 128)
JKEY = jax.random.fold_in(jax.random.key(0), 1)


def _inputs(seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x, y, g = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    d = shape[-1]
    s = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, y, s, b, g


def _jax(x, y, s, b, g, dtype, rate, key):
    def f(x, y, s, b):
        out = jax_fused(x, y, s, b, rate=rate, key=key, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * g), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                         has_aux=True)(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(s),
        jnp.asarray(b))
    return [np.asarray(a.astype(jnp.float32)) for a in (out, *grads)]


def _port(x, y, s, b, g, dtype, rate, key):
    tx, ty = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (x, y))
    ts, tb = (torch.from_numpy(a).requires_grad_() for a in (s, b))
    out = fused_residual_dropout_ln(tx, ty, ts, tb, rate=rate, key=key)
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert out.dtype == dtype and ts.grad.dtype == torch.float32
    return [t.detach().float().numpy()
            for t in (out, tx.grad, ty.grad, ts.grad, tb.grad)]


def _spacing(ref):
    """One bf16 spacing at each element of ``ref``."""
    e = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
    return np.exp2(e - 7)


def _check(ours, ref, dtype):
    names = ("out", "dx", "dy", "dscale", "dbias")
    for name, a, r in zip(names, ours, ref):
        if dtype == torch.bfloat16 and name in ("out", "dx", "dy"):
            assert np.all(np.abs(a - r) <= _spacing(r) + 1e-6), name
        else:
            tol = 1e-6 if name == "out" else 2e-4
            err = np.abs(a - r).max() / np.abs(r).max()
            assert err <= tol, (name, err)
    live = ours[1] != 0
    np.testing.assert_array_equal((ours[2] == 0) & live, (ref[2] == 0) & live)


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_plain_matches_pallas_interpret(dtype, rate):
    x, y, s, b, g = _inputs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _jax(x, y, s, b, g, jdt, rate, JKEY)
    ours = _port(x, y, s, b, g, dtype, rate,
                 torch.from_numpy(np.asarray(jax.random.key_data(JKEY))
                                  .astype(np.int64)))
    _check(ours, ref, dtype)
    if rate:
        kept = 1.0 - ((ours[2] == 0) & (ours[1] != 0)).sum() / ours[1].size
        assert abs(kept - (1.0 - rate)) < 0.05


def test_one_word_key_is_used_twice():
    x, y, s, b, g = _inputs(1, (4, 256))
    raw = jnp.asarray([987654321], jnp.uint32)
    ref = _jax(x, y, s, b, g, jnp.float32, 0.1, raw)
    ours = _port(x, y, s, b, g, torch.float32, 0.1, torch.tensor([987654321]))
    _check(ours, ref, torch.float32)


def test_no_key_means_no_dropout():
    x, y, s, b, g = _inputs(2, (5, 128))
    without = _port(x, y, s, b, g, torch.float32, 0.3, None)
    plain = _port(x, y, s, b, g, torch.float32, 0.0, prng.key(1))
    for a, r in zip(without, plain):
        np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("rate", [1.0, -0.1, 1.5])
def test_rate_outside_zero_one_raises(rate):
    x = torch.zeros((2, 128))
    with pytest.raises(ValueError, match="rate"):
        fused_residual_dropout_ln(x, x, torch.ones(128), torch.zeros(128),
                                  rate=rate, key=prng.key(0))
    with pytest.raises(ValueError, match="rate"):
        jax_fused(jnp.zeros((2, 128)), jnp.zeros((2, 128)), jnp.ones(128),
                  jnp.zeros(128), rate=rate, key=JKEY, interpret=True)


def test_fused_site_equals_dropout_then_layer_norm_in_fp32():
    """With the same key, the fused site is ``layer_norm(x + dropout(y))``
    in fp32 (the same mask; sums in another order, 1e-6)."""
    x, y, s, b, _ = (torch.from_numpy(a) for a in _inputs(3))
    k = prng.fold_in(prng.key(2), 9)
    fused = fused_residual_dropout_ln(x, y, s, b, rate=0.1, key=k)
    composed = layer_norm(x + dropout(y, 0.1, k), s, b)
    assert (fused - composed).abs().max() <= 1e-6 * composed.abs().max()


@pytest.mark.parametrize("T", [1, 2, 91, 1055, 1056, 1057, 2049, 4001,
                               12288, 100000])
def test_bwd_parts_depends_on_rows_alone(T):
    """The backward's persistent grid: one (D,) dscale / dbias partial a
    block, summed in a fixed order.  Its only input is the row count,
    so the sums' order cannot depend on the device or its SM count;
    every block gets a row, none gets more than ceil(T / BWD_WAVE)."""
    assert list(inspect.signature(fln.bwd_parts).parameters) == ["T"]
    parts = fln.bwd_parts(T)
    per = -(-T // fln.BWD_WAVE)
    assert 1 <= parts <= min(T, fln.BWD_WAVE)
    assert -(-T // parts) <= per           # rows of the busiest block
    assert (parts - 1) * per < T           # no more blocks than it needs
    assert fln.bwd_parts(T) == parts


def test_bwd_parts_at_the_bert_large_shape():
    assert fln.bwd_parts(96 * 128) == 1024

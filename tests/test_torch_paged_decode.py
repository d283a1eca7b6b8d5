"""Paged decode attention in the PyTorch port: its plain version (what a
CPU tensor runs) against the JAX package's Pallas kernel in interpret
mode, on the same numpy inputs, a row of length 0 (NaN in both) among
them; the CUDA kernel's chunk plan and head groups, which are pure
functions of the shapes.  Tolerance: fp32, atol 1e-5 (both take fp32
statistics; they differ only in summation order)."""

import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.ops.pallas.paged_decode import paged_decode_attention as jax_pd
from hetu_tpu_torch.ops.kernels import paged_decode as pd

ATOL = 1e-5


def _setup(lens, *, H=4, D=32, page=4, layers=None, seed=0):
    """Pools and page tables for ragged ``lens``, pages handed out
    low-first from 1 (page 0 is the scratch page), tables padded with it
    to the longest row plus one page."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    per = [-(-int(n) // page) for n in lens]
    n_pages = max(per) + 1
    P = 1 + sum(per)
    tables = np.zeros((B, n_pages), np.int32)
    nxt = 1
    for i, n in enumerate(per):
        tables[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
    pool_shape = (P, page, H, D) if layers is None else (layers, P, page, H,
                                                         D)
    k = rng.standard_normal(pool_shape).astype(np.float32)
    v = rng.standard_normal(pool_shape).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, k, v, tables, np.asarray(lens, np.int32)


def _port(q, k, v, tables, lens, layer=None):
    t = torch.from_numpy
    return pd.paged_decode_attention(t(q), t(k), t(v), t(tables), t(lens),
                                     layer=layer).numpy()


def _jax(q, k, v, tables, lens, layer=None):
    return np.asarray(jax_pd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(tables), jnp.asarray(lens),
                             layer=layer, interpret=True))


@pytest.mark.parametrize("lens", [[5, 16, 1], [4, 8], [13, 2, 7, 9],
                                  [3, 6, 11]])
def test_plain_matches_pallas_per_layer_pool(lens):
    """Ragged lengths, including rows ending mid-page (the tail of the
    last page is masked) and on a page boundary."""
    args = _setup(lens)
    np.testing.assert_allclose(_port(*args), _jax(*args), rtol=0, atol=ATOL)


@pytest.mark.parametrize("layer", [0, 2])
def test_plain_matches_pallas_stacked_pool(layer):
    args = _setup([6, 1, 12], layers=3, seed=layer + 1)
    np.testing.assert_allclose(_port(*args, layer=layer),
                               _jax(*args, layer=layer), rtol=0, atol=ATOL)


def test_stacked_layer_equals_per_layer_view():
    q, k, v, tables, lens = _setup([9, 3], layers=2, seed=5)
    stacked = _port(q, k, v, tables, lens, layer=1)
    per_layer = _port(q, k[1], v[1], tables, lens)
    np.testing.assert_array_equal(stacked, per_layer)


def test_scratch_page_and_tail_poisoning_leave_outputs_unchanged():
    """NaN in the scratch page and in every dead slot past each row's
    length must not reach any output: bitwise equal in the port, and
    still within tolerance of the clean Pallas result."""
    q, k, v, tables, lens = _setup([5, 16, 1, 7], page=4)
    clean = _port(q, k, v, tables, lens)
    kp, vp = k.copy(), v.copy()
    kp[0] = np.nan
    vp[0] = np.nan
    for row, n in enumerate(lens):
        last = tables[row, (n - 1) // 4]
        kp[last, n % 4 or 4:] = np.nan
        vp[last, n % 4 or 4:] = np.nan
    poisoned = _port(q, kp, vp, tables, lens)
    assert np.isfinite(poisoned).all()
    np.testing.assert_array_equal(poisoned, clean)
    np.testing.assert_allclose(poisoned, _jax(q, k, v, tables, lens),
                               rtol=0, atol=ATOL)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    q, k, v, tables, lens = _setup([4, 2])
    pd.reset_launch_count()
    t = torch.from_numpy
    out = pd.paged_decode_attention(t(q), t(k), t(v), t(tables), t(lens))
    ref = pd.paged_decode_attention_plain(t(q), t(k), t(v), t(tables),
                                          t(lens))
    assert torch.equal(out, ref)
    assert pd.launch_count() == 0


def test_stacked_pool_without_layer_raises():
    q, k, v, tables, lens = _setup([4], layers=2)
    with pytest.raises(ValueError, match="layer"):
        _port(q, k, v, tables, lens)


def _pre_fix_plain(q, k, v, tables, lens):
    """The plain version as it was before a length-0 row became NaN:
    rows of length 1 or more must keep these bits."""
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    tables, lens = torch.from_numpy(tables), torch.from_numpy(lens)
    B, H, D = q.shape
    P, page = tables.shape[1], k.shape[1]
    kk = k[tables.long()].reshape(B, P * page, H, D).float()
    vv = v[tables.long()].reshape(B, P * page, H, D).float()
    live = torch.arange(P * page)[None, :] < lens.long()[:, None]
    s = torch.einsum("bhd,bshd->bhs", q.float(), kk) * (1.0 / math.sqrt(D))
    s = torch.where(live[:, None, :], s, torch.full_like(s, -1e30))
    vv = torch.where(live[:, :, None, None], vv, torch.zeros_like(vv))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vv).to(q.dtype).numpy()


@pytest.mark.parametrize("lens", [[0, 5], [3, 0, 9, 0], [0]])
def test_length_zero_row_is_nan_as_in_pallas(lens):
    """A row of length 0 attends to nothing: the Pallas kernel gives 0 / 0
    = NaN there, and so does the plain version; the live rows agree
    within ATOL and keep the bits they had before the fix."""
    args = _setup([max(n, 1) for n in lens], H=2, D=32, page=4, seed=7)
    args = args[:4] + (np.asarray(lens, np.int32),)
    ours, ref = _port(*args), _jax(*args)
    dead = np.asarray(lens) == 0
    assert np.isnan(ref[dead]).all() and np.isnan(ours[dead]).all()
    assert np.isfinite(ours[~dead]).all()
    np.testing.assert_allclose(ours[~dead], ref[~dead], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ours[~dead], _pre_fix_plain(*args)[~dead])


def test_rows_of_length_one_or_more_keep_their_bits():
    args = _setup([1, 4, 5, 16, 13], H=3, D=64, page=4, seed=11)
    np.testing.assert_array_equal(_port(*args), _pre_fix_plain(*args))


@pytest.mark.parametrize("page", [1, 4, 5, 8, 16, 63, 64, 65, 256])
@pytest.mark.parametrize("pages_per_seq", [1, 3, 64, 1000])
def test_chunk_plan_depends_on_page_and_table_width_alone(page,
                                                          pages_per_seq):
    """The kernel's split of a row: whole pages, at least CHUNK_POSITIONS
    positions (or the whole page), and just enough chunks to cover the
    table.  Its only inputs are the page size and the table width, so a
    row's chunks (and bits) cannot depend on the batch size, the other
    rows' lengths or the device."""
    assert list(inspect.signature(pd.chunk_plan).parameters) == [
        "page", "pages_per_seq"]
    chunk_pages, n_chunks = pd.chunk_plan(page, pages_per_seq)
    assert chunk_pages >= 1 and n_chunks >= 1
    assert chunk_pages * page >= pd.CHUNK_POSITIONS
    assert (chunk_pages - 1) * page < pd.CHUNK_POSITIONS
    assert n_chunks * chunk_pages >= pages_per_seq
    assert (n_chunks - 1) * chunk_pages < pages_per_seq
    assert pd.chunk_plan(page, pages_per_seq) == (chunk_pages, n_chunks)


@pytest.mark.parametrize("H,D,itemsize,want", [
    (12, 64, 4, 2), (12, 64, 2, 4), (12, 32, 4, 4), (12, 32, 2, 8),
    (12, 128, 4, 1), (12, 256, 4, 1), (12, 256, 2, 1), (1, 32, 2, 1),
    (3, 32, 2, 3), (16, 32, 2, 8)])
def test_heads_per_block(H, D, itemsize, want):
    assert pd.heads_per_block(H, D, itemsize) == want

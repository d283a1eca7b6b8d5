"""The port's CUDA kernels against their plain versions on the card, at
small shapes, plus one tiny engine run through both serving kernels,
the threefry bits and the samplers on the card against the CPU's, a
replay of the captured decode graph against the eager step, and
one tiny training run through the flash and LM-head cross-entropy
kernels, the fused residual + dropout + LN kernels with one tiny
BERT run through them, and the ring's flash block kernels with one tiny
sequence-parallel (sp=4) GPT run through them.  These need
an NVIDIA GPU (sm_90a) and nvcc and skip without them.  This module
imports neither jax nor hetu_tpu, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances: paged decode fp32 2e-5, bf16 1.6e-2 (one bf16 rounding of
an output below 2), a row of length 0 NaN, a row alone bitwise the same
row in a batch; LM-head values 1e-4 (fp32 accumulation in another
order), indices exactly where the top values are separated by more and
where they are NaN or +-inf, a row alone bitwise the same row in a batch;
flash and cross entropy as stated beside each test, relative to the
largest reference value, and every backward bitwise repeatable."""

import pytest
import torch

from hetu_tpu_torch.ops.kernels import lm_head as lh
from hetu_tpu_torch.ops.kernels import paged_decode as pd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _paged_case(lens, page, D, dtype, device, H=3, seed=0, layers=2,
                pps=None):
    """A stacked pool whose scratch page 0 is NaN, each row's pages handed
    out in order from page 1, tables ``pps`` pages wide (the longest row
    plus a page by default) and padded with the scratch page."""
    g = torch.Generator().manual_seed(seed)
    need = [-(-n // page) for n in lens]
    pps = pps or max(need) + 1
    P = 1 + sum(need)
    tables = torch.zeros((len(lens), pps), dtype=torch.int32)
    nxt = 1
    for b, m in enumerate(need):
        tables[b, :m] = torch.arange(nxt, nxt + m)
        nxt += m
    k = torch.randn((layers, P, page, H, D), generator=g).to(device, dtype)
    v = torch.randn((layers, P, page, H, D), generator=g).to(device, dtype)
    q = torch.randn((len(lens), H, D), generator=g).to(device, dtype)
    k[:, 0] = float("nan")
    v[:, 0] = float("nan")
    return (q, k, v, tables.to(device),
            torch.tensor(lens, dtype=torch.int32, device=device))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("page", [4, 5, 8, 16])
def test_paged_decode_kernel_matches_plain(cuda, dtype, tol, D, page):
    """Lengths at the chunk's edges (C - 1, C, C + 1 for a chunk of C
    positions), a row filling its whole table, short rows and a row of
    length 0, which is NaN in both versions."""
    C = pd.chunk_plan(page, 1)[0] * page
    lens = [C - 1, C, C + 1, 1, page, 2 * C + 3, 0]
    pps = max(-(-n // page) for n in lens) + 1
    lens.append(pps * page)
    args = _paged_case(lens, page, D, dtype, cuda, seed=D + page, pps=pps)
    before = pd.launch_count()
    out = pd.paged_decode_attention(*args, layer=1)
    ref = pd.paged_decode_attention_plain(*args, layer=1)
    torch.cuda.synchronize()
    assert pd.launch_count() == before + 1
    dead = torch.tensor([n == 0 for n in lens], device=cuda)
    assert torch.isnan(out[dead].float()).all()
    assert torch.isnan(ref[dead].float()).all()
    assert torch.isfinite(out[~dead].float()).all()
    assert (out[~dead].float() - ref[~dead].float()).abs().max().item() <= tol
    again = pd.paged_decode_attention(*args, layer=1)
    assert torch.equal(again[~dead], out[~dead])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page", [(64, 16), (128, 5)])
def test_paged_decode_row_alone_equals_row_in_batch(cuda, dtype, D, page):
    """A row's chunk plan depends on the page size alone, so each row of
    a batch of 8 is bitwise the same row served alone."""
    lens = [1, 17, 64, 65, 200, 513, 1000, 1024]
    q, k, v, tables, sl = _paged_case(lens, page, D, dtype, cuda, H=4,
                                      seed=3)
    out = pd.paged_decode_attention(q, k, v, tables, sl, layer=0)
    for b in range(len(lens)):
        alone = pd.paged_decode_attention(
            q[b:b + 1].contiguous(), k, v, tables[b:b + 1].contiguous(),
            sl[b:b + 1].contiguous(), layer=0)
        assert torch.equal(alone[0], out[b]), f"row {b} (length {lens[b]})"


def test_paged_decode_refuses_misaligned_pool(cuda):
    """The kernel stages rows by 16-byte copies: a pool that starts 4
    bytes into its storage is refused before any launch."""
    q, k, v, tables, sl = _paged_case([5, 9], 4, 32, torch.float32, cuda)
    bad = torch.empty(k.numel() + 1, device=cuda)[1:].view(k.shape)
    bad.copy_(k)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    before = pd.launch_count()
    for kk, vv in ((bad, v), (k, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            pd.paged_decode_attention(q, kk, vv, tables, sl, layer=1)
    assert pd.launch_count() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,E,V,k", [(1, 64, 100, 1), (8, 768, 5000, 5),
                                     (11, 96, 1031, 128), (3, 32, 129, 129),
                                     (5, 50, 777, 3), (2, 1600, 3000, 2)])
def test_lm_head_kernel_matches_plain(cuda, dtype, N, E, V, k):
    """E = 50 leaves rows off 16-byte boundaries (the plain-load staging);
    E = 1600 ends on a partial 256-byte slab in bf16."""
    if k > 128:
        with pytest.raises(ValueError):
            lh.lm_head_sample(torch.zeros((N, E), device=cuda),
                              torch.zeros((V, E), device=cuda), k=k)
        return
    g = torch.Generator().manual_seed(N * V)
    w = (torch.randn((V, E), generator=g) * 0.05).to(cuda, dtype)
    h = torch.randn((N, E), generator=g).to(cuda, dtype)
    b = torch.randn(V, generator=g).to(cuda) * 0.1
    gum = torch.rand((N, V), generator=g).to(cuda)
    for kw in ({}, {"bias": b}, {"bias": b, "gumbel": gum,
                                 "temperature": 0.8}):
        vals, idx = lh.lm_head_sample(h, w, k=k, **kw)
        pv, pi = lh.lm_head_sample_plain(h, w, k=min(k + 1, 128, V), **kw)
        torch.cuda.synchronize()
        if pv.shape[1] == k:   # no (k+1)-th value: leave the last unchecked
            pv = torch.cat([pv, pv[:, -1:]], 1)
        assert (vals - pv[:, :k]).abs().max().item() <= 1e-4
        sep = (pv[:, :-1] - pv[:, 1:]) > 1e-4
        prev = torch.cat([torch.ones_like(sep[:, :1]), sep[:, :-1]], 1)
        checked = (sep & prev)[:, :k]
        assert ((idx == pi[:, :k]) | ~checked).all()


def test_lm_head_refuses_a_hidden_width_beyond_shared_memory(cuda):
    """h's 8 rows stay in shared memory: E above 2368 in fp32 raises
    before any launch; bf16 takes twice the width."""
    lh.reset_launch_count()
    w = torch.zeros((300, 2400), device=cuda)
    with pytest.raises(ValueError, match="too wide"):
        lh.lm_head_sample(torch.zeros((2, 2400), device=cuda), w)
    assert lh.launch_count() == 0
    vals, idx = lh.lm_head_sample(torch.ones((2, 2400), device=cuda,
                                             dtype=torch.bfloat16),
                                  w.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert idx.tolist() == [[0], [0]] and lh.launch_count() == 1


def _lm_special(case, dtype, device, N=8, E=96, V=5000):
    """h, w, b with NaN / +inf / -inf logits: through the bias (the same
    columns in every row; 7 and 3000 lie in different blocks of the
    kernel) and an all-NaN row through a NaN in h."""
    g = torch.Generator().manual_seed(V + E)
    w = (torch.randn((V, E), generator=g) * 0.05).to(device, dtype)
    h = torch.randn((N, E), generator=g)
    b = torch.randn(V, generator=g) * 0.1
    if case == "nan_nan_inf":
        b[[7, 3000]] = float("nan")
        b[4000] = float("inf")
        h[3] = float("nan")
    elif case == "nan":
        b[3000] = float("nan")
    elif case == "inf":
        b[4000] = float("inf")
    else:
        h.zero_()
        b.fill_(float("-inf"))
    return h.to(device, dtype), w, b.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("case", ["nan_nan_inf", "nan", "inf", "neg_inf"])
def test_lm_head_kernel_ranks_nan_and_inf_as_plain(cuda, dtype, k, case):
    """A NaN of either sign ranks first, then the values descending, ties
    smallest index first: where the plain top values are NaN or +-inf the
    kernel's indices are the plain version's exactly; a row of -inf or of
    NaN gives 0, 1, ..., k - 1."""
    h, w, b = _lm_special(case, dtype, cuda)
    vals, idx = lh.lm_head_sample(h, w, k=k, bias=b)
    pv, pi = lh.lm_head_sample_plain(h, w, k=k + 1, bias=b)
    torch.cuda.synchronize()
    special = ~torch.isfinite(pv[:, :k])
    assert special.any()
    assert (idx == pi[:, :k])[special].all()
    assert (torch.isnan(vals) == torch.isnan(pv[:, :k])).all()
    fin = torch.isfinite(pv[:, :k])
    assert ((vals - pv[:, :k]).abs() <= 1e-4)[fin].all()
    assert (vals == pv[:, :k])[special & ~torch.isnan(pv[:, :k])].all()
    gaps = pv[:, :-1] - pv[:, 1:]
    sep = (gaps > 1e-4) | torch.isinf(gaps)
    prev = torch.cat([torch.ones_like(sep[:, :1]), sep[:, :-1]], 1)
    checked = (sep & prev)[:, :k] | special
    assert ((idx == pi[:, :k]) | ~checked).all()
    if case in ("nan_nan_inf", "neg_inf"):
        row = 3 if case == "nan_nan_inf" else 0
        assert idx[row].tolist() == list(range(k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 5])
def test_lm_head_row_alone_equals_row_in_batch(cuda, dtype, k):
    """A row's result is bitwise the same alone as inside a batch of 8,
    and two calls are bitwise equal (no atomics, a fixed merge order)."""
    g = torch.Generator().manual_seed(3)
    N, E, V = 8, 768, 50257
    w = (torch.randn((V, E), generator=g) * 0.02).to(cuda, dtype)
    h = torch.randn((N, E), generator=g).to(cuda, dtype)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda)
    gum = torch.rand((N, V), generator=g).to(cuda)
    for kw in ({}, {"bias": b, "gumbel": gum, "temperature": 0.7}):
        vals, idx = lh.lm_head_sample(h, w, k=k, **kw)
        again = lh.lm_head_sample(h, w, k=k, **kw)
        assert torch.equal(vals, again[0]) and torch.equal(idx, again[1])
        for r in (0, 5, 7):
            one = {**kw, "gumbel": kw["gumbel"][r:r + 1].contiguous()} \
                if "gumbel" in kw else kw
            v1, i1 = lh.lm_head_sample(h[r:r + 1].contiguous(), w, k=k,
                                       **one)
            assert torch.equal(v1[0], vals[r]) and torch.equal(i1[0], idx[r])


def test_tiny_engine_runs_both_kernels(cuda):
    from hetu_tpu_torch import GPT, GPTConfig, ServingEngine
    model = GPT(GPTConfig(vocab_size=300, hidden_size=64, num_layers=2,
                          num_heads=2, max_seq_len=64), device=cuda)
    prompts = [[1, 2, 3], list(range(10, 30)), [7] * 9]
    runs = []
    for paged in (True, False):
        pd.reset_launch_count()
        lh.reset_launch_count()
        eng = ServingEngine(model, num_slots=2, page_size=8,
                            prompt_buckets=(8, 32), paged_decode=paged,
                            fused_sampling=paged, device=cuda)
        hs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_idle()
        assert all(h.status == "completed" for h in hs)
        runs.append([h.tokens for h in hs])
        steps = eng.stats()["decode_steps"]
        if paged:
            assert pd.launch_count() == 2 * steps > 0
            assert lh.launch_count() == steps
        else:
            assert pd.launch_count() == lh.launch_count() == 0
    assert runs[0] == runs[1]


@pytest.mark.parametrize("shape", [(), (50257,), (8, 300)])
def test_device_random_bits_and_uniform_equal_the_cpus(cuda, shape):
    """The threefry hash and the uniform built on it run on the card
    bitwise as on the CPU, for one key and for a batch of keys; the
    Gumbel field within 2e-6 of the CPU's (``torch.log`` on each)."""
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.ops import random as R
    keys = prng.fold_in_tensor(prng.key(3), torch.arange(8) * 977 + 5)
    for k in (keys[0], keys):
        bits = prng.random_bits(k.to(cuda), shape)
        assert torch.equal(bits.cpu(), prng.random_bits(k, shape))
        for lo, hi in ((torch.finfo(torch.float32).tiny, 1.0), (-3.5, 7.25)):
            u = R._uniform(k.to(cuda), shape, torch.float32, lo, hi)
            ref = R._uniform(k, shape, torch.float32, lo, hi)
            assert torch.equal(u.cpu().view(torch.int32),
                               ref.view(torch.int32))
        g = R._gumbel(k.to(cuda), shape)
        assert (g.cpu() - R._gumbel(k, shape)).abs().max() <= 2e-6
    data = torch.tensor([0, 1, -1, 2**31 - 1, -2**31], dtype=torch.int32)
    assert torch.equal(prng.fold_in_tensor(keys[:5].to(cuda),
                                           data.to(cuda)).cpu(),
                       prng.fold_in_tensor(keys[:5], data))


@pytest.mark.parametrize("name,args", [
    ("rand", ()), ("uniform_sample", (-1.0, 2.0)), ("normal_sample", ()),
    ("truncated_normal_sample", ()), ("gumbel_sample", ()),
    ("randint_sample", (0, 9))])
def test_draws_with_no_key_and_no_device_run_on_the_card(cuda, name, args):
    """``rand((n,))`` and its kin with neither key nor device draw
    ``next_key()`` on the card: the same values as the CPU's draw from the
    same global RNG state (bitwise but for the Gumbel field's and the
    normals' ``log`` / ``erfinv``)."""
    from hetu_tpu_torch.core import rng
    from hetu_tpu_torch.ops import random as R
    fn = getattr(R, name)
    rng.set_random_seed(4)
    got = fn((1000,), *args)
    rng.set_random_seed(4)
    ref = fn((1000,), *args, device="cpu")
    assert got.device.type == "cuda" and got.dtype == ref.dtype
    if name in ("rand", "uniform_sample", "randint_sample"):
        assert torch.equal(got.cpu(), ref)
    elif name == "gumbel_sample":
        assert (got.cpu() - ref).abs().max() <= 2e-6
    else:       # the tolerance tests/test_torch_random.py holds JAX's to
        torch.testing.assert_close(got.cpu(), ref, rtol=1e-5, atol=1e-6)
    assert rng.get_seed_status() == (4, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["temperature", "top_k"])
def test_lm_head_sample_tokens_matches_its_plain_route(cuda, dtype, mode):
    """On the card, ``lm_head_sample_tokens`` against the plain version fed
    the same Gumbel field (temperature) or the same candidates (top-k):
    tokens equal wherever the two best perturbed scores are separated by
    more than the kernel's 1e-4 value tolerance."""
    from hetu_tpu_torch.core import prng
    g = torch.Generator().manual_seed(5)
    N, E, V, T = 8, 768, 50257, 0.8
    w = (torch.randn((V, E), generator=g) * 0.02).to(cuda, dtype)
    h = torch.randn((N, E), generator=g).to(cuda, dtype)
    keys = prng.fold_in_tensor(prng.key(1), torch.arange(N)).to(cuda)
    lh.reset_launch_count()
    got = lh.lm_head_sample_tokens(h, w, mode=mode, top_k=5, temperature=T,
                                   keys=keys)
    assert lh.launch_count() == 1
    ref, gap = lh._sample_tokens_plain(h, w, mode=mode, top_k=5,
                                       temperature=T, keys=keys)
    assert lh.launch_count() == 1
    sep = gap > 1e-4
    assert sep.sum() >= N - 1
    assert torch.equal(got[sep], ref[sep])


@pytest.mark.parametrize("mode", ["greedy", "temperature", "top_k"])
def test_decode_graph_replay_equals_the_eager_step(cuda, mode):
    """After the first decode step captured the graph, a replay gives the
    eager step's tokens and writes the same pool bytes; the launch
    counters show both kernels on every replayed step."""
    from hetu_tpu_torch import GPT, GPTConfig, ServingEngine
    from hetu_tpu_torch.serve.graph import _replay_vs_eager
    model = GPT(GPTConfig(vocab_size=300, hidden_size=64, num_layers=2,
                          num_heads=2, max_seq_len=64), device=cuda,
                generator=torch.Generator().manual_seed(0))
    eng = ServingEngine(model, num_slots=2, page_size=8,
                        prompt_buckets=(8, 32), sampling=mode, top_k=5,
                        temperature=0.8, device=cuda)
    pd.reset_launch_count()
    lh.reset_launch_count()
    for p in ([1, 2, 3], list(range(10, 30))):
        eng.submit(p, max_new_tokens=12)
    for _ in range(4):
        eng.step()
    steps = eng.stats()["decode_steps"]
    assert eng._decode_graph.captured and steps >= 2
    assert pd.launch_count() == 2 * steps and lh.launch_count() == steps
    same_tokens, same_pool, wrote = _replay_vs_eager(eng)
    assert same_tokens and same_pool and wrote
    eng.run_until_idle()
    assert eng.stats()["requests"]["completed"] == 2


def _rel_err(x, ref):
    """max |x - ref| over max(1, max |ref|)."""
    ref = ref.float()
    return ((x.float() - ref).abs().max() / ref.abs().max().clamp_min(1.0)
            ).item()


# fp32: summation order only; bf16: a few roundings of P / dS / O to bf16
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 3e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("S,D", [(1, 64), (64, 32), (100, 64), (130, 96),
                                 (77, 128),
                                 # one row off the 64-row tiles' edges
                                 (63, 64), (65, 64), (127, 64), (129, 64)])
def test_flash_kernels_match_plain(cuda, dtype, causal, S, D):
    from hetu_tpu_torch.ops.kernels import flash as fl
    g = torch.Generator().manual_seed(S * D)
    q, k, v, do = (torch.randn((2, 3, S, D), generator=g).to(cuda, dtype)
                   for _ in range(4))
    scale = D ** -0.5
    before = (fl.fwd_launch_count(), fl.bwd_launch_count())
    o, lse = fl.flash_fwd(q, k, v, causal=causal, scale=scale)
    grads = fl.flash_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    again = fl.flash_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    po, plse = fl.flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    pgrads = fl.flash_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                scale=scale)
    torch.cuda.synchronize()
    assert (fl.fwd_launch_count(), fl.bwd_launch_count()) == (
        before[0] + 1, before[1] + 2)
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    assert _rel_err(o, po) <= fwd_tol
    assert _rel_err(lse, plse) <= 1e-5
    for name, a, b, c in zip(("dq", "dk", "dv"), grads, pgrads, again):
        assert torch.equal(a, c), f"{name} not bitwise repeatable"
        assert _rel_err(a, b) <= bwd_tol, name


def test_flash_wrappers_refuse_misaligned_tensors(cuda):
    """The kernels stage rows by 16-byte copies: a contiguous tensor that
    starts 4 bytes into its storage is refused before any launch."""
    from hetu_tpu_torch.ops.kernels import flash as fl
    shape = (1, 2, 8, 32)
    ok = torch.randn(shape, device=cuda)
    bad = torch.randn(ok.numel() + 1, device=cuda)[1:].view(shape)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    lse = torch.zeros(shape[:3], device=cuda)
    lse4 = lse[..., None]
    before = (fl.fwd_launch_count(), fl.bwd_launch_count(),
              fl.block_fwd_launch_count(), fl.block_bwd_launch_count())
    calls = [
        lambda: fl.flash_fwd(bad, ok, ok, causal=True, scale=1.0),
        lambda: fl.flash_fwd(ok, ok, bad, causal=True, scale=1.0),
        lambda: fl.flash_bwd(ok, ok, ok, ok, lse, bad, causal=True,
                             scale=1.0),
        lambda: fl.flash_block_fwd(ok, bad, ok, scale=1.0),
        lambda: fl.flash_block_bwd(ok, ok, ok, bad, lse4, lse4, scale=1.0)]
    for call in calls:
        with pytest.raises(ValueError, match="16-byte"):
            call()
    assert (fl.fwd_launch_count(), fl.bwd_launch_count(),
            fl.block_fwd_launch_count(),
            fl.block_bwd_launch_count()) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,E,V", [
    (1, 32, 7), (70, 64, 1100), (33, 96, 2049),
    # ragged at the 128 tile and the backward's vocab chunks; E off the K
    # slab (40), off a 16-byte row (100 in bf16, 33), GPT-2 XL's 1600
    (129, 40, 8193), (129, 100, 8193), (129, 33, 300), (64, 1600, 8193)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_lm_head_ce_kernels_match_plain(cuda, dtype, N, E, V, with_bias):
    from hetu_tpu_torch.ops.kernels import lm_head_ce as ce
    g = torch.Generator().manual_seed(N * V + E)
    h = torch.randn((N, E), generator=g).to(cuda, dtype)
    w = (torch.randn((V, E), generator=g) * 0.1).to(cuda, dtype)
    b = (torch.randn(V, generator=g) * 0.1).to(cuda) if with_bias else None
    y = torch.randint(0, V, (N,), generator=g, dtype=torch.int32)
    y[1::5] = -1
    y = y.to(cuda)
    dn = torch.randn(N, generator=g).to(cuda) * (y != -1)
    lse, ylog = ce.lm_head_ce_fwd(h, w, y, bias=b)
    dh, dw, db = ce.lm_head_ce_bwd(h, w, y, lse, dn, bias=b)
    dh2, dw2, db2 = ce.lm_head_ce_bwd(h, w, y, lse, dn, bias=b)
    plse, pylog = ce.lm_head_ce_fwd_plain(h, w, y, bias=b)
    pdh, pdw, pdb = ce.lm_head_ce_bwd_plain(h, w, y, lse, dn, bias=b)
    torch.cuda.synchronize()
    live = y != -1
    assert _rel_err(lse, plse) <= 1e-5
    assert _rel_err(ylog[live], pylog[live]) <= 1e-5
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert torch.equal(dh, dh2) and torch.equal(dw, dw2)
    assert _rel_err(dh, pdh) <= tol and _rel_err(dw, pdw) <= tol
    if with_bias:
        assert torch.equal(db, db2) and _rel_err(db, pdb) <= tol


def test_tiny_train_runs_the_four_train_kernels(cuda):
    from hetu_tpu_torch import (AdamWOptimizer, GPT, GPTConfig, Trainer,
                                flash_attn_fn)
    from hetu_tpu_torch.ops.kernels import flash as fl
    from hetu_tpu_torch.ops.kernels import lm_head_ce as ce
    cfg = GPTConfig(vocab_size=300, hidden_size=64, num_layers=2,
                    num_heads=2, max_seq_len=64, streamed_head_chunk=128)
    model = GPT(cfg, attn_fn=flash_attn_fn(native_layout=True), device=cuda)
    ids = torch.randint(0, 300, (3, 50), device=cuda)
    trainer = Trainer(model, AdamWOptimizer(1e-2),
                      lambda m, batch, key: (m.loss(batch, key=key), {}))
    fl.reset_launch_count()
    ce.reset_launch_count()
    losses = [float(trainer.step(ids)["loss"]) for _ in range(4)]
    assert (fl.fwd_launch_count(), fl.bwd_launch_count()) == (8, 8)
    assert (ce.fwd_launch_count(), ce.bwd_launch_count()) == (4, 4)
    assert all(map(lambda x: x == x, losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["diagonal", "past", "full"])
@pytest.mark.parametrize("c,D", [(8, 64), (100, 32), (256, 64), (70, 128)])
def test_flash_block_kernels_match_plain(cuda, dtype, case, c, D):
    """A q chunk (the second of two) against the diagonal chunk (causal)
    or the first (past, unmasked; full: no causal masking anywhere), fed
    the whole sequence's lse and delta, as the ring feeds them."""
    from hetu_tpu_torch.ops.kernels import flash as fl
    g = torch.Generator().manual_seed(c * D + len(case))
    q, k, v, do = (torch.randn((2, 3, 2 * c, D), generator=g).to(cuda, dtype)
                   for _ in range(4))
    scale = D ** -0.5
    causal = case != "full"
    o, lse = fl.flash_fwd_plain(q, k, v, causal=causal, scale=scale)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)[:, :, c:]
    lse = lse[:, :, c:, None].contiguous()
    kv = c if case == "diagonal" else 0
    qc, doc = q[:, :, c:].contiguous(), do[:, :, c:].contiguous()
    kc, vc = (x[:, :, kv:kv + c].contiguous() for x in (k, v))
    mask = case == "diagonal"
    before = (fl.block_fwd_launch_count(), fl.block_bwd_launch_count(),
              fl.fwd_launch_count(), fl.bwd_launch_count())
    bo, blse = fl.flash_block_fwd(qc, kc, vc, scale=scale, causal=mask)
    grads = fl.flash_block_bwd(qc, kc, vc, doc, lse, delta.contiguous(),
                               scale=scale, causal=mask)
    again = fl.flash_block_bwd(qc, kc, vc, doc, lse, delta.contiguous(),
                               scale=scale, causal=mask)
    po, plse = fl.flash_fwd_plain(qc, kc, vc, causal=mask, scale=scale)
    pgrads = fl.flash_block_bwd_plain(qc, kc, vc, doc, lse, delta,
                                      causal=mask, scale=scale)
    torch.cuda.synchronize()
    assert (fl.block_fwd_launch_count(), fl.block_bwd_launch_count(),
            fl.fwd_launch_count(), fl.bwd_launch_count()) == (
        before[0] + 1, before[1] + 2, before[2], before[3])
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    assert tuple(blse.shape) == (2, 3, c, 1)
    assert _rel_err(bo, po) <= fwd_tol
    assert _rel_err(blse[..., 0], plse) <= 1e-5
    for name, a, b, r in zip(("dq", "dk", "dv"), grads, pgrads, again):
        assert a.dtype == torch.float32, name
        assert torch.equal(a, r), f"{name} not bitwise repeatable"
        assert _rel_err(a, b) <= bwd_tol, name


def test_tiny_ring_train_runs_the_block_kernels(cuda):
    from hetu_tpu_torch import (AdamWOptimizer, GPT, GPTConfig, MeshSpec,
                                Trainer, make_mesh, ring_attn_fn)
    from hetu_tpu_torch.ops.kernels import flash as fl
    cfg = GPTConfig(vocab_size=300, hidden_size=64, num_layers=2,
                    num_heads=2, max_seq_len=64, streamed_head_chunk=128)
    ring = GPT(cfg, attn_fn=ring_attn_fn(make_mesh(MeshSpec(sp=4))),
               device=cuda)
    dense = GPT(cfg, device=cuda)
    dense.load_state_dict(ring.state_dict())
    ids = torch.randint(0, 300, (3, 64), device=cuda)
    with torch.no_grad():
        a, b = float(ring.loss(ids)), float(dense.loss(ids))
    assert abs(a - b) <= 1e-5 * abs(b)
    trainer = Trainer(ring, AdamWOptimizer(1e-2),
                      lambda m, batch, key: (m.loss(batch, key=key), {}))
    fl.reset_launch_count()
    losses = [float(trainer.step(ids)["loss"]) for _ in range(4)]
    assert (fl.block_fwd_launch_count(), fl.block_bwd_launch_count()) == (
        80, 80)
    assert (fl.fwd_launch_count(), fl.bwd_launch_count()) == (0, 0)
    assert all(x == x for x in losses) and losses[-1] < losses[0]


# fused residual + dropout + LN: fp32 sums in another order (values 1e-5,
# gradients 1e-4 of their largest value); bf16 outputs are rounded once
# from fp32 in both versions, so they may differ by one bf16 spacing
# (2**-7 relative at most).
FLN_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (8e-3, 8e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("T,D", [(1, 128), (91, 768), (2049, 1024),
                                 (12288, 1024),
                                 # a partial last round of the grid
                                 (4001, 1024), (1057, 384)])
def test_fused_ln_kernels_match_plain(cuda, dtype, rate, T, D):
    from hetu_tpu_torch.ops.kernels import fused_ln as fln
    g = torch.Generator().manual_seed(T + D)
    x, y, do = (torch.randn((T, D), generator=g).to(cuda, dtype)
                for _ in range(3))
    s = (1 + 0.1 * torch.randn(D, generator=g)).to(cuda)
    b = (0.1 * torch.randn(D, generator=g)).to(cuda)
    kw = dict(words=(2467461003, 3840466878),
              thresh=fln.dropout_keep_thresh(rate) if rate else 0,
              keep_y=fln._keep_y(rate, dtype))
    gk = float(torch.tensor(1.0 - rate, dtype=torch.float32))
    before = (fln.fwd_launch_count(), fln.bwd_launch_count())
    out, mean, rstd = fln.fused_ln_fwd(x, y, s, b, **kw)
    grads = fln.fused_ln_bwd(do, x, y, s, mean, rstd, keep_g=gk, **kw)
    again = fln.fused_ln_bwd(do, x, y, s, mean, rstd, keep_g=gk, **kw)
    pout, pmean, prstd = fln.fused_ln_fwd_plain(x, y, s, b, **kw)
    pgrads = fln.fused_ln_bwd_plain(do, x, y, s, mean, rstd, keep_g=gk,
                                    **kw)
    torch.cuda.synchronize()
    assert (fln.fwd_launch_count(), fln.bwd_launch_count()) == (
        before[0] + 1, before[1] + 2)
    vtol, gtol = FLN_TOL[dtype]
    assert _rel_err(out, pout) <= vtol
    assert _rel_err(mean, pmean) <= 1e-5 and _rel_err(rstd, prstd) <= 1e-5
    for name, a, p, c in zip(("dx", "dy", "ds", "db"), grads, pgrads, again):
        assert torch.equal(a, c), f"{name} not bitwise repeatable"
        assert _rel_err(a, p) <= gtol, name
    live = grads[0] != 0
    assert torch.equal((grads[1] == 0) & live, (pgrads[1] == 0) & live)


def test_tiny_bert_runs_the_fused_ln_kernels(cuda):
    from hetu_tpu_torch import (AdamWOptimizer, BertForPreTraining, Trainer,
                                bert_base)
    from hetu_tpu_torch.core.prng import key
    from hetu_tpu_torch.ops.kernels import fused_ln as fln
    kw = dict(num_layers=2, hidden_size=128, num_heads=2, vocab_size=300)
    ids = torch.randint(0, 300, (3, 40), device=cuda)
    mlm = torch.where(torch.rand((3, 40), device=cuda) < 0.3, ids, -1)
    nsp = torch.tensor([0, 1, 1], device=cuda)
    losses = {}
    for fused in (False, True):
        m = BertForPreTraining(bert_base(fused_ln=fused, **kw), device=cuda)
        loss, _ = m.loss(ids, None, None, mlm, nsp, key=key(3))
        losses[fused] = float(loss.detach())
    assert abs(losses[True] - losses[False]) <= 1e-5 * abs(losses[False])
    trainer = Trainer(m, AdamWOptimizer(1e-3),
                      lambda mm, bt, k: mm.loss(*bt, key=k))
    fln.reset_launch_count()
    steps = [float(trainer.step((ids, None, None, mlm, nsp))["loss"])
             for _ in range(4)]
    assert (fln.fwd_launch_count(), fln.bwd_launch_count()) == (16, 16)
    assert all(x == x for x in steps) and steps[-1] < steps[0]

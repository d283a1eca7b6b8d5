#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``hetu_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()`` so a fault shows
where it happened; any failure exits non-zero:

1. device: torch / CUDA versions and the card's name and power limit;
2. build: the CUDA kernels compiled from ``hetu_tpu_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/``;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes its main path gives it (fp32 and bf16; the paged pool's
   scratch page poisoned with NaN, a length-0 row NaN, the length-1024
   row served alone bitwise the same as in the batch, and paged decode
   timed again at the lengths phase 4's 126 decode steps reach; LM-head
   sampling at N=8 E=768 V=50257, k 1 and 5, plus rows of NaN, +inf and
   -inf logits whose indices must equal the plain version's; the
   threefry bits, the uniform (bitwise) and the Gumbel field (2e-6) of
   the decode step's (8, 50257) on the card against the CPU, and
   ``lm_head_sample_tokens`` in temperature and top-k mode against its
   plain route on the same field; flash at
   B=8 H=12 S=1024 D=64 causal
   and at a ragged S=1000; the LM-head cross entropy at N=8184 E=768
   V=50257 with ignored labels and a bias, and at GPT-2 XL's width
   E=1600 with N and V ragged; the ring's block kernels at
   one rank's q, k, v of (8, 12, 256, 64), a diagonal and a past visit
   fed the whole sequence's lse and delta), with the maximum error, the
   tolerance, every backward run twice and compared bitwise, and
   CUDA-event medians of kernel / plain / library times beside the
   least time the card could take (the bound);
4. engine: GPT-2 small at full width and depth (random weights from a
   seeded generator, trainable) serves 16 requests through
   ``ServingEngine`` with autograd off in every module call, the paged
   decode step one captured CUDA graph; both kernels must have launched
   on that run (12 paged-decode and 1 LM-head launch a decode step,
   counted through the graph's replays), decode must build no
   contiguous K/V view, a request served alone must give the same
   stream as inside the batch, a replayed step must equal the eager
   step bitwise (tokens and pool bytes), and the first generated tokens
   must agree with a full-recompute greedy reference run on the CPU.
   Then the same 16 requests again in ``temperature`` (T = 0.8) and
   ``top_k`` (k = 5, T = 0.8) mode, each with the same launch counts, a
   same-seed rerun bitwise equal, the probe request alone (under its
   batched id) equal to its batched stream and a replayed step equal to
   the eager one; agreement with the gather path, tokens/s, the median
   decode step and the decode profile with the graph and without it are
   printed for information;
5. train: GPT-2 small at full width and depth, fp32, with
   ``flash_attn_fn(native_layout=True)`` and the streamed head (chunk
   1024): the step-0 loss and every gradient against the plain path on
   the card (materialized attention and head, same weights), then 5
   AdamW ``Trainer`` steps on one 8 x 1024 batch, each launching 12
   flash forwards, 12 flash backwards, 1 CE forward and 1 CE backward,
   with a falling loss; step time, tokens/s, peak memory and a profiled
   step with the CE kernels' summed device time;
6. train: BERT-large post-LN pretraining (24 layers, hidden 1024, 16
   heads, vocab 30522, dropout 0.1, ``fused_ln=True``, materialized
   ``(B, H, S, D)`` attention and MLM head): a step-0 check in fp32 at
   batch 8 x 128 with one fixed key, the fused kernels against plain
   ``dropout`` + ``layer_norm`` with the same weights (loss and every
   gradient), then 5 AdamW ``Trainer`` steps in bf16 at batch 96 x 128
   (keys from ``next_key``), each launching 48 fused-LN forwards and 48
   backwards, with a falling loss; step time, samples/s, tokens/s, peak
   memory and a profiled step;
7. train: GPT-2 small as in phase 5 with sequence-parallel ring
   attention, ``ring_attn_fn(make_mesh(MeshSpec(sp=4)))``, whose four
   ranks share the one card: the step-0 loss and every gradient against
   the flash path (same weights and batch), bitwise repeatable, and the
   blockwise core's against the flash path too; then 5 AdamW ``Trainer``
   steps, each launching 120 block forwards, 120 block backwards, no
   whole-sequence flash, 1 CE forward and 1 CE backward, with a falling
   loss; step time, tokens/s, peak memory and a profiled step;
8. a ``kernels`` JSON line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

Phase 3 also holds the fused residual + dropout + LayerNorm kernels
against their plain versions at T = 12288, D = 1024, rate 0.1 (BERT-large
at 96 x 128), fp32 and bf16: the kept/dropped pattern bitwise, the
backward bitwise repeatable, and controls (the key's words swapped; in
bf16 also the residual sum rounded to bf16) that must fail the check,
the ring's block backward fed the block's own lse, a control that must
fail its check, and the plain versions of the CE forward fed h and W,
and of the flash forward fed q, k and v, rounded to TF32: controls that
must fail the fp32 limits (a kernel that ran one-pass TF32 products
would).  Phase 8 prints each flash kernel's time beside the prediction
made before its tensor-core redesign first ran, and likewise paged
decode's, the fused-LN backward's and LM-head sampling's beside their
predictions and their times before their redesign, and paged decode's
device time over phase 4's run at phase 4's lengths.  Phase 4's decode
profile prints the sampling kernels' busy time per step.

Without a CUDA device the script prints no result and exits 2.
"""

import copy
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
# Peak rates of the data sheet.  fp32: the least time for fp32-accurate
# products is 3xTF32 on the tensor cores, three TF32 products (495
# TFLOP/s) for each, so 165 TFLOP/s; the SIMT rate, 67 TFLOP/s, gave the
# bounds of the kernel table up to its restatement (PERF.md).
PEAK_OPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
FLUSH_BYTES = 256 << 20         # larger than the 50 MB L2
SERVE_SLOTS, SERVE_BUDGET = 8, 64   # phase 4: slots, new tokens a request


def phase(name):
    torch.cuda.synchronize()
    print(f"== {name}", flush=True)


def time_ms(fn, flush, reps=30, warmup=3):
    """Median device time of ``fn`` over ``reps`` launches, each after an
    L2 flush (the caller finds the data cold, as the engine does).  A
    spin of about 0.1 ms follows each flush, so the host has enqueued
    ``fn``'s launches before the start event: a wrapper's Python time
    (slower when the host is busy) does not reach the measurement."""
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_excess(x, ref):
    """Largest ``|x - ref|`` beyond one bf16 spacing at ``ref``
    (``2**(e - 7)`` for ``|ref|`` in ``[2**e, 2**(e + 1))``)."""
    ref = ref.float()
    e = torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -126)))
    return ((x.float() - ref).abs() - torch.exp2(e - 7)).max().item()


def paged_decode_bf16_state(q, k_l, v_l, tables, lens):
    """Control for the bf16 tolerance: the paged online softmax with its
    max, normalizer and accumulator rounded to bf16 after every page, as
    a kernel that accumulates in the input type would keep them."""
    B, H, D = q.shape
    page = k_l.shape[1]
    bf = torch.bfloat16
    m = torch.full((B, H), -1e30, device=q.device).to(bf)
    den = torch.zeros((B, H), device=q.device, dtype=bf)
    acc = torch.zeros((B, H, D), device=q.device, dtype=bf)
    qf = q.float() / D ** 0.5
    for p in range(-(-int(lens.max()) // page)):
        kp = k_l[tables[:, p].long()].float()          # (B, page, H, D)
        vp = v_l[tables[:, p].long()].float()
        pos = p * page + torch.arange(page, device=q.device)
        live = pos[None, :] < lens.long()[:, None]     # (B, page)
        s = torch.einsum("bhd,bshd->bhs", qf, kp)
        s = torch.where(live[:, None, :], s, torch.full_like(s, -1e30))
        vp = torch.where(live[:, :, None, None], vp, torch.zeros_like(vp))
        m_new = torch.maximum(m.float(), s.amax(-1))
        alpha = torch.exp(m.float() - m_new)
        pr = torch.exp(s - m_new[..., None])
        den = (den.float() * alpha + pr.sum(-1)).to(bf)
        acc = (acc.float() * alpha[..., None]
               + torch.einsum("bhs,bshd->bhd", pr, vp)).to(bf)
        m = m_new.to(bf)
    return (acc.float() / den.float()[..., None]).to(bf)


def check_paged_decode(pd, flush, dtype, gen):
    """Kernel vs plain at B=8, H=12, D=64, page 16, 12-layer stacked pool
    read at its last layer, ragged lengths 1..1024."""
    B, H, D, page, L, pps = 8, 12, 64, 16, 12, 64
    lens = [1, 16, 17, 100, 256, 513, 800, 1024]
    need = [-(-n // page) for n in lens]
    P = 1 + sum(need)
    perm = (torch.randperm(P - 1, generator=gen) + 1).tolist()
    tables = torch.zeros((B, pps), dtype=torch.int32)
    nxt = 0
    for b, n in enumerate(need):
        tables[b, :n] = torch.tensor(perm[nxt:nxt + n])
        nxt += n
    shape = (L, P, page, H, D)
    k = torch.randn(shape, generator=gen).to("cuda", dtype)
    v = torch.randn(shape, generator=gen).to("cuda", dtype)
    q = torch.randn((B, H, D), generator=gen).to("cuda", dtype)
    tables = tables.cuda()
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    layer = L - 1
    clean = pd.paged_decode_attention(q, k, v, tables, sl, layer=layer)
    k[:, 0] = float("nan")
    v[:, 0] = float("nan")
    out = pd.paged_decode_attention(q, k, v, tables, sl, layer=layer)
    plain = pd.paged_decode_attention_plain(q, k, v, tables, sl, layer=layer)
    # the row of length 1024 served alone; row 0 cut to length 0
    alone = pd.paged_decode_attention(q[-1:].contiguous(), k, v,
                                      tables[-1:].contiguous(),
                                      sl[-1:].contiguous(), layer=layer)
    sl0 = sl.clone()
    sl0[0] = 0
    out0 = pd.paged_decode_attention(q, k, v, tables, sl0, layer=layer)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all(), "NaN leaked from scratch page"
    assert torch.equal(out, clean), "scratch-page poison changed the output"
    assert torch.equal(alone[0], out[-1]), \
        "the 1024-length row alone differs from the same row in the batch"
    assert torch.isnan(out0[0].float()).all(), "a length-0 row is not NaN"
    assert torch.equal(out0[1:], out[1:]), "a length-0 row moved the others"
    print(f"paged_decode {dtype}: the length-1024 row alone == in the batch "
          f"(bitwise); a length-0 row is NaN, the other rows unchanged")
    err = (out.float() - plain.float()).abs().max().item()
    tol = 2e-5
    if dtype == torch.float32:
        print(f"paged_decode {dtype}: max_abs_err {err:.3e} tol {tol:g}")
        assert err <= tol, f"paged_decode {dtype}: {err} > {tol}"
    else:
        # Kernel and plain both round an fp32 result to bf16 once, so a
        # correct kernel is off by at most one bf16 spacing of the output
        # (where the two fp32 sums, which differ by fp32 summation order,
        # straddle a rounding boundary) plus that fp32 slack.  A kernel
        # keeping its softmax state or accumulator in bf16 is off by more;
        # the control below emulates one and must fail the same check.
        ctrl = paged_decode_bf16_state(q, k[layer], v[layer], tables, sl)
        excess = bf16_excess(out, plain)
        ctrl_err = (ctrl.float() - plain.float()).abs().max().item()
        ctrl_excess = bf16_excess(ctrl, plain)
        print(f"paged_decode {dtype}: max_abs_err {err:.3e}, beyond one "
              f"bf16 spacing {excess:.3e} tol {tol:g}; control with bf16 "
              f"softmax state: max_abs_err {ctrl_err:.3e}, beyond one "
              f"spacing {ctrl_excess:.3e}")
        assert excess <= tol, f"paged_decode {dtype}: {excess} > {tol}"
        assert ctrl_excess > tol, "the bf16 check cannot tell bf16 state"
    s = torch.finfo(dtype).bits // 8
    nbytes = (2 * sum(lens) * H * D * s + 2 * B * H * D * s
              + B * pps * 4 + B * 4)
    b_ms, b_by = bound(nbytes, 4 * sum(lens) * H * D, dtype)
    ms = time_ms(lambda: pd.paged_decode_attention(q, k, v, tables, sl,
                                                   layer=layer), flush)
    plain_ms = time_ms(lambda: pd.paged_decode_attention_plain(
        q, k, v, tables, sl, layer=layer), flush)
    print(f"paged_decode {dtype}: kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms null bound_ms {b_ms:.4f} ({b_by}, "
          f"{nbytes} bytes)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def serve_prompts(vocab):
    """Phase 4's 16 prompts of 5-128 tokens (numpy seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(n)).tolist()
            for n in rng.integers(5, 129, 16)]


def serve_decode_lengths(prompt_lens):
    """Each decode step's paged-decode lengths in phase 4.  Every request
    has the same budget, so the slots fill in waves of SERVE_SLOTS in
    submission order; decode step j (1 .. budget - 1) of a wave reads
    prompt + j positions, the fed token's K/V included, and an idle slot
    reads 1 (the scratch page)."""
    steps = []
    for w in range(0, len(prompt_lens), SERVE_SLOTS):
        wave = list(prompt_lens[w:w + SERVE_SLOTS])
        wave += [0] * (SERVE_SLOTS - len(wave))
        for j in range(1, SERVE_BUDGET):
            steps.append([n + j if n else 1 for n in wave])
    return steps


def time_paged_decode_serve(pd, flush, gen, prompt_lens):
    """fp32 kernel vs plain at the lengths phase 4's decode steps reach,
    on GPT-2 small's pool (12 layers, page 16, 64 pages a row) read at
    its last layer: every step's kernel output against the plain
    version's (2e-5), and each step's median time; returns the means
    over the steps."""
    steps = serve_decode_lengths(prompt_lens)
    H, D, page, L, pps = 12, 64, 16, 12, 64
    per_row = -(-max(max(s) for s in steps) // page)
    P = 1 + SERVE_SLOTS * per_row
    tables = torch.zeros((SERVE_SLOTS, pps), dtype=torch.int32)
    for b in range(SERVE_SLOTS):
        tables[b, :per_row] = 1 + b * per_row + torch.arange(per_row)
    k, v = (torch.randn((L, P, page, H, D), generator=gen).cuda()
            for _ in range(2))
    q = torch.randn((SERVE_SLOTS, H, D), generator=gen).cuda()
    tables = tables.cuda()
    ms, plain_ms, bound_ms, err = [], [], [], 0.0
    for lens in steps:
        sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = (q, k, v, tables, sl)
        out = pd.paged_decode_attention(*args, layer=L - 1)
        ref = pd.paged_decode_attention_plain(*args, layer=L - 1)
        err = max(err, (out - ref).abs().max().item())
        ms.append(time_ms(lambda: pd.paged_decode_attention(
            *args, layer=L - 1), flush, reps=10, warmup=1))
        plain_ms.append(time_ms(lambda: pd.paged_decode_attention_plain(
            *args, layer=L - 1), flush, reps=3, warmup=1))
        nbytes = (2 * sum(lens) * H * D * 4 + 2 * SERVE_SLOTS * H * D * 4
                  + SERVE_SLOTS * pps * 4 + SERVE_SLOTS * 4)
        bound_ms.append(bound(nbytes, 4 * sum(lens) * H * D,
                              torch.float32)[0])
    mean = statistics.mean
    print(f"paged_decode float32 at phase 4's lengths ({len(steps)} decode "
          f"steps, lengths {min(min(s) for s in steps)}-"
          f"{max(max(s) for s in steps)}): max_abs_err {err:.3e} tol 2e-5; "
          f"kernel_ms {mean(ms):.4f} (median of steps {statistics.median(ms):.4f}, "
          f"max {max(ms):.4f}) plain_ms {mean(plain_ms):.4f} bound_ms "
          f"{mean(bound_ms):.4f} (bytes), means over the steps")
    assert err <= 2e-5, f"paged_decode at the serve lengths: {err} > 2e-5"
    return {"serve_steps": len(steps), "serve_ms": mean(ms),
            "serve_plain_ms": mean(plain_ms),
            "serve_bound_ms": mean(bound_ms)}


def check_lm_head(lh, flush, dtype, k, gen):
    """Kernel vs plain at N=8, E=768, V=50257 (GPT-2 small's head)."""
    N, E, V = 8, 768, 50257
    w = (torch.randn((V, E), generator=gen) * 0.02).to("cuda", dtype)
    h = torch.randn((N, E), generator=gen).to("cuda", dtype)
    vals, idx = lh.lm_head_sample(h, w, k=k)
    pv, pi = lh.lm_head_sample_plain(h, w, k=min(k + 1, V))
    torch.cuda.synchronize()
    tol = 1e-4
    err = (vals - pv[:, :k]).abs().max().item()
    gaps = pv[:, :-1] - pv[:, 1:]                        # (N, k)
    sep = gaps > tol
    sep_prev = torch.cat([torch.ones_like(sep[:, :1]), sep[:, :-1]], 1)
    checked = (sep & sep_prev)[:, :k]
    mism = (idx != pi[:, :k]) & checked
    print(f"lm_head_sample {dtype} k={k}: max_abs_err {err:.3e} tol {tol:g}"
          f"; indices checked {int(checked.sum())}/{N * k}, mismatched "
          f"{int(mism.sum())}")
    assert err <= tol, f"lm_head_sample {dtype} k={k}: {err} > {tol}"
    assert not mism.any(), "lm_head_sample: index mismatch beyond a tie"
    check_lm_head_order(lh, h, w, k)
    s = torch.finfo(dtype).bits // 8
    nbytes = V * E * s + N * E * s + N * k * 8
    b_ms, b_by = bound(nbytes, 2 * N * E * V, dtype)
    ms = time_ms(lambda: lh.lm_head_sample(h, w, k=k), flush)
    plain_ms = time_ms(lambda: lh.lm_head_sample_plain(h, w, k=k), flush)
    lib_ms = time_ms(lambda: torch.topk(h @ w.T, k), flush)
    # one plain read of W, timed the same way: the flush leaves the L2
    # full of dirty lines, written back while the next call reads
    read_ms = time_ms(lambda: w.sum(), flush)
    print(f"lm_head_sample {dtype} k={k}: kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} bound_ms {b_ms:.4f} "
          f"({b_by}, {nbytes} bytes); w.sum() {read_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_lm_head_order(lh, h, w, k):
    """NaN, +inf and -inf logits: where the plain top values are not
    finite, the kernel's indices must be the plain version's exactly (a
    NaN of either sign first, the first NaN first), and a row of NaN or
    of -inf gives 0, 1, ..., k - 1.  Three rows join the batch: one whose
    h is NaN, one whose Gumbel field is NaN at columns 7 and 20000 (two
    blocks apart) and +inf at 30000, one whose field is -inf; the eight
    rows keep a zero field.  A second call puts NaN at 7 and 25000 and
    +inf at 50000 through the bias, in every row."""
    N, V = h.shape[0], w.shape[0]
    nan, inf = float("nan"), float("inf")
    hx = torch.cat([h, torch.full_like(h[:1], nan), h[:2]])
    gx = torch.zeros((N + 3, V), device=h.device)
    gx[N + 1, [7, 20000]] = nan
    gx[N + 1, 30000] = inf
    gx[N + 2] = -inf
    bias = torch.zeros(V, device=h.device)
    bias[[7, 25000]] = nan
    bias[50000] = inf
    checked = 0
    for hh, kw, all_first in ((hx, {"gumbel": gx}, (N, N + 2)),
                              (h, {"bias": bias}, ())):
        vals, idx = lh.lm_head_sample(hh, w, k=k, **kw)
        pv, pi = lh.lm_head_sample_plain(hh, w, k=k, **kw)
        torch.cuda.synchronize()
        special = ~torch.isfinite(pv)
        assert torch.equal(idx[special], pi[special]), \
            "lm_head_sample: indices differ on NaN / inf logits"
        assert torch.equal(torch.isnan(vals), torch.isnan(pv))
        for r in all_first:
            assert idx[r].tolist() == list(range(k)), \
                f"lm_head_sample: row {r} of NaN / -inf gave {idx[r]}"
        checked += int(special.sum())
    print(f"lm_head_sample {w.dtype} k={k}: NaN / inf rows: {checked} "
          f"non-finite top entries, indices equal to the plain version's")


def rel_err(x, ref):
    """``max |x - ref|`` over ``max |ref|``, in fp32."""
    ref = ref.float()
    return ((x.float() - ref).abs().max() / ref.abs().max()).item()


# Each redesigned kernel's time predicted before its redesign first ran
# (PERF.md, Findings), in ms, with its time in PERF.md's table before the
# redesign (None where none was kept): (name, dtype) -> (low, high,
# before).  PR 6's flash kernels at (8, 12, 1024, 64) causal, the ring's
# block kernels per launch at (8, 12, 256, 64), a causal sp=4 layer's
# mean; PR 7's paged decode at B=8 H=12 D=64 page 16, lengths 1..1024,
# and fused-LN backward at T=12288 D=1024; the LM-head sampling kernel's
# at N=8 E=768 V=50257 k=1.
PREDICTED_MS = {
    ("flash_fwd", torch.float32): (0.20, 0.40, 0.6654),
    ("flash_bwd", torch.float32): (0.7, 1.4, 2.0543),
    ("flash_block_fwd", torch.float32): (0.03, 0.06, 0.0822),
    ("flash_block_bwd", torch.float32): (0.08, 0.16, 0.2591),
    ("flash_fwd", torch.bfloat16): (0.06, 0.15, 0.6688),
    ("flash_bwd", torch.bfloat16): (0.25, 0.6, 2.0751),
    ("paged_decode_attention", torch.float32): (0.010, 0.025, 0.0871),
    ("paged_decode_attention", torch.bfloat16): (0.008, 0.020, None),
    ("fused_ln_bwd", torch.bfloat16): (0.045, 0.075, 0.1553),
    ("fused_ln_bwd", torch.float32): (0.085, 0.12, 0.1636),
    ("lm_head_sample", torch.float32): (0.050, 0.075, 0.1106),
    ("lm_head_sample", torch.bfloat16): (0.027, 0.050, 0.1247),
}


def print_predictions(rows):
    """Each redesigned kernel's time beside its prediction, its time
    before the redesign, its bound and its library call's time; rows maps
    (name, dtype) to a kernels-line entry."""
    for (name, dtype), (lo, hi, before) in PREDICTED_MS.items():
        r = rows[(name, dtype)]
        ms, lib = r["ms"], r["library_ms"]
        was = ("not recorded" if before is None
               else f"{before:g} ms ({before / ms:.2f}x this)")
        lib_txt = "none" if lib is None else f"{lib:.4f} ms ({ms / lib:.2f}x)"
        print(f"prediction: {name} {dtype} {ms:.4f} ms, predicted "
              f"{lo:g}-{hi:g} ms ({'in' if lo <= ms <= hi else 'out of'} "
              f"range); before the redesign {was}; bound "
              f"{r['bound_ms']:.4f} ms; library {lib_txt}")


# (forward O, gradients) tolerances of the flash check, relative to the
# largest reference value.  fp32: summation order only.  bf16: the kernel
# and the plain version round P, dS and the outputs to bf16 at the same
# points, but P against another running max, so O differs by under one
# bf16 spacing of the largest output (2**-8 = 3.9e-3 relative; the
# kernel reads 1.0e-3 at the train shape) while a kernel that kept its
# softmax state in bf16 reads 4.1e-3 (the control below): O's limit sits
# between the two.  The gradients need no running max, and the kernel
# reads 0 against the plain version; their limit is one spacing.
FLASH_TOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2.5e-3, 4e-3)}


def flash_bf16_state(q, k, v, scale, causal=True, tile=64):
    """Control for the bf16 tolerance: the online softmax over kv tiles
    of 64 with its max, normalizer and accumulator rounded to bf16 after
    every tile, as a kernel that kept its state in the input type
    would."""
    B, H, S, D = q.shape
    Sk = k.shape[2]
    bf = torch.bfloat16
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((B, H, S), -1e30, device=q.device).to(bf)
    den = torch.zeros((B, H, S), device=q.device, dtype=bf)
    acc = torch.zeros((B, H, S, D), device=q.device, dtype=bf)
    row = torch.arange(S, device=q.device)[:, None]
    for c0 in range(0, Sk, tile):
        sc = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, c0:c0 + tile])
        col = torch.arange(c0, min(Sk, c0 + tile), device=q.device)[None, :]
        live = col <= row if causal else torch.ones_like(col, dtype=bool)
        sc = torch.where(live, sc * scale, torch.full_like(sc, -1e30))
        m_new = torch.maximum(m.float(), sc.amax(-1))
        alpha = torch.exp(m.float() - m_new)
        pr = torch.exp(sc - m_new[..., None])
        den = (den.float() * alpha + pr.sum(-1)).to(bf)
        acc = (acc.float() * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", pr.to(bf).float(),
            vf[:, :, c0:c0 + tile])).to(bf)
        m = m_new.to(bf)
    return (acc.float() / den.float()[..., None]).to(bf)


def check_flash(fl, flush, dtype, S, gen, timed):
    """Kernels vs plain at B=8, H=12, D=64, causal (the train step's
    shape at S=1024): O, LSE, dQ, dK, dV; each backward run twice and
    compared bitwise.  ``timed`` adds kernel / plain / SDPA times."""
    B, H, D = 8, 12, 64
    q, k, v, do = (torch.randn((B, H, S, D), generator=gen).to("cuda", dtype)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = fl.flash_fwd(q, k, v, causal=True, scale=scale)
    grads = fl.flash_bwd(q, k, v, o, lse, do, causal=True, scale=scale)
    again = fl.flash_bwd(q, k, v, o, lse, do, causal=True, scale=scale)
    po, plse = fl.flash_fwd_plain(q, k, v, causal=True, scale=scale)
    pgrads = fl.flash_bwd_plain(q, k, v, o, lse, do, causal=True,
                                scale=scale)
    torch.cuda.synchronize()
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    errs = {"O": rel_err(o, po), "LSE": rel_err(lse, plse)}
    errs.update({n: rel_err(a, b) for n, a, b in
                 zip(("dQ", "dK", "dV"), grads, pgrads)})
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    print(f"flash {dtype} S={S}: relative errors "
          + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f"; tol O {fwd_tol:g}, LSE 2e-5, grads {bwd_tol:g} (fp32: "
          f"summation order; bf16: see FLASH_TOL); "
          f"backward bitwise repeatable: {same}")
    assert errs["O"] <= fwd_tol and errs["LSE"] <= 2e-5, errs
    assert max(errs[n] for n in ("dQ", "dK", "dV")) <= bwd_tol, errs
    assert same, "flash backward is not bitwise repeatable"
    if dtype == torch.bfloat16:
        ctrl = rel_err(flash_bf16_state(q, k, v, scale), po)
        print(f"flash {dtype} S={S}: control with bf16 softmax state: O "
              f"relative error {ctrl:.3e} (must exceed tol {fwd_tol:g})")
        assert ctrl > fwd_tol, "the bf16 check cannot tell bf16 state"
    else:
        to, _ = fl.flash_fwd_plain(tf32_inputs(q), tf32_inputs(k),
                                   tf32_inputs(v), causal=True, scale=scale)
        ctrl = rel_err(to, po)
        print(f"flash {dtype} S={S}: control with q, k, v rounded to TF32 "
              f"(a one-pass TF32 kernel): O relative error {ctrl:.3e} (must "
              f"exceed tol {fwd_tol:g})")
        assert ctrl > fwd_tol, "the fp32 check cannot tell one-pass TF32"
        del to
    if not timed:
        return None
    s = torch.finfo(dtype).bits // 8
    ops_fwd = 4 * B * H * S * S * D / 2                 # causal half
    io = B * H * S * D * s
    f_ms, f_by = bound(4 * io + B * H * S * 4, ops_fwd, dtype)
    b_ms, b_by = bound(7 * io + 2 * B * H * S * 4, 2.5 * ops_fwd, dtype)
    ms = time_ms(lambda: fl.flash_fwd(q, k, v, causal=True, scale=scale),
                 flush)
    plain_ms = time_ms(lambda: fl.flash_fwd_plain(q, k, v, causal=True,
                                                  scale=scale), flush)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(q, k, v, is_causal=True, scale=scale),
                     flush)
    bms = time_ms(lambda: fl.flash_bwd(q, k, v, o, lse, do, causal=True,
                                       scale=scale), flush)
    bplain_ms = time_ms(lambda: fl.flash_bwd_plain(
        q, k, v, o, lse, do, causal=True, scale=scale), flush)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa_fwd_bwd():
        sdpa(qg, kg, vg, is_causal=True, scale=scale).backward(do)

    lib_fb_ms = time_ms(sdpa_fwd_bwd, flush)
    print(f"flash {dtype} S={S}: forward kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} (SDPA) bound_ms "
          f"{f_ms:.4f} ({f_by}); backward kernel_ms {bms:.4f} plain_ms "
          f"{bplain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); SDPA forward+"
          f"backward {lib_fb_ms:.4f} ms")
    fwd = {"max_abs_err": (o.float() - po.float()).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": f_ms,
           "bound_by": f_by, "library_ms": lib_ms}
    bwd = {"max_abs_err": max((a.float() - b.float()).abs().max().item()
                              for a, b in zip(grads, pgrads)),
           "ms": bms, "plain_ms": bplain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_fb_ms,
           "library_call": "scaled_dot_product_attention forward+backward"}
    return fwd, bwd


def sdpa_efficient_times(q, k, v, do, o, lse, causal, scale, flush):
    """The yardstick of the block kernels, which the port never calls:
    the memory-efficient SDPA op with its lse, and its backward fed the
    global out and lse (its own delta is then the global one).  Returns
    (forward ms, backward ms, text); the times are None, and the text
    says why, when this PyTorch build cannot run them here."""
    aten = torch.ops.aten
    try:
        efa = aten._scaled_dot_product_efficient_attention
        efa_bwd = aten._scaled_dot_product_efficient_attention_backward
        _, _, seed, offset = efa(q, k, v, None, True, 0.0, causal,
                                 scale=scale)
        lse = lse[..., 0].contiguous()
        bwd = lambda: efa_bwd(do, q, k, v, None, o, lse, seed,  # noqa: E731
                              offset, 0.0, [True, True, True, False],
                              causal, scale=scale)
        bwd()
    except (AttributeError, NotImplementedError, RuntimeError,
            TypeError) as e:
        why = str(e).splitlines()[0][:160]
        return None, None, f"library none (memory-efficient SDPA: {why})"
    f_ms = time_ms(lambda: efa(q, k, v, None, True, 0.0, causal,
                               scale=scale), flush)
    b_ms = time_ms(bwd, flush)
    return f_ms, b_ms, (f"library (memory-efficient SDPA with its lse) "
                        f"forward {f_ms:.4f} ms, its backward fed the "
                        f"global out and lse {b_ms:.4f} ms")


# bf16 O limit of the block check, on the part of |O - plain| beyond one
# bf16 spacing at each element, relative to the largest output.  The
# flash check's relative limit relies on rows whose output is exact (the
# first rows of a causal sequence set the largest output); a past visit
# has none, and there one bf16 spacing of the largest output (2**-8
# relative) is within reach of a correct kernel.  What lies beyond that
# spacing is the kernel's P rounded to bf16 against its running max
# rather than the row's, each term off by at most 2**-9 and the errors
# averaging out over the 256 keys; a kernel that kept its softmax state
# in bf16 adds a rounding of the whole row every tile.  The control
# below emulates that one at the past visit (four tiles a row) and must
# exceed the limit; at the diagonal, where most rows see one or two
# tiles, the same control is too close to a correct kernel to tell.
BLOCK_BF16_O_TOL = 2.5e-3


def check_flash_block(fl, flush, dtype, gen, shape=(8, 12, 1024, 64), sp=4):
    """The ring's block kernels at one rank's shapes of the sp=4 ring over
    GPT-2 small at 8 x 1024: q, k, v (8, 12, 256, 64).  The last rank's q
    chunk against its diagonal chunk (causal) and against the first chunk
    (a past visit, unmasked), fed the lse and delta of the whole causal
    sequence (the global ones, as the ring feeds them; not the block's
    own).  Each backward runs twice and is compared bitwise; a control
    fed the block-local lse must fail the gradient limit.  Returns, per
    case, kernel / plain / library times beside the bound."""
    B, H, S, D = shape
    c = S // sp
    q, k, v, do = (torch.randn((B, H, S, D), generator=gen).to("cuda", dtype)
                   for _ in range(4))
    scale = D ** -0.5
    o, lse = fl.flash_fwd_plain(q, k, v, causal=True, scale=scale)
    rows = slice(S - c, S)
    qc, oc, doc = (x[:, :, rows].contiguous() for x in (q, o, do))
    lse_g = lse[:, :, rows, None].contiguous()
    delta = (doc.float() * oc.float()).sum(-1, keepdim=True)
    del o, lse
    fwd_tol, bwd_tol = FLASH_TOL[dtype]
    o_tol, o_how = fwd_tol, " (as the flash check)"
    if dtype == torch.bfloat16:
        o_tol, o_how = BLOCK_BF16_O_TOL, (" beyond one bf16 spacing, of the "
                                          "largest output (BLOCK_BF16_O_TOL)")
    sz = torch.finfo(dtype).bits // 8
    io = B * H * c * D * sz
    out = {}
    for case, kv, mask in (("diagonal", S - c, True), ("past", 0, False)):
        kc, vc = (x[:, :, kv:kv + c].contiguous() for x in (k, v))
        bo, blse = fl.flash_block_fwd(qc, kc, vc, scale=scale, causal=mask)
        grads = fl.flash_block_bwd(qc, kc, vc, doc, lse_g, delta,
                                   scale=scale, causal=mask)
        again = fl.flash_block_bwd(qc, kc, vc, doc, lse_g, delta,
                                   scale=scale, causal=mask)
        local = fl.flash_block_bwd(qc, kc, vc, doc, blse, delta,
                                   scale=scale, causal=mask)
        po, plse = fl.flash_fwd_plain(qc, kc, vc, causal=mask, scale=scale)
        pgrads = fl.flash_block_bwd_plain(qc, kc, vc, doc, lse_g, delta,
                                          causal=mask, scale=scale)
        torch.cuda.synchronize()
        peak = po.float().abs().max().item()
        o_err = (max(0.0, bf16_excess(bo, po)) / peak
                 if dtype == torch.bfloat16 else rel_err(bo, po))
        errs = {"O": o_err, "LSE": rel_err(blse[..., 0], plse)}
        errs.update({n: rel_err(a, b) for n, a, b in
                     zip(("dQ", "dK", "dV"), grads, pgrads)})
        ctrl = max(rel_err(a, b) for a, b in zip(local, pgrads))
        same = all(torch.equal(a, b) for a, b in zip(grads, again))
        print(f"flash_block {dtype} {case} (q chunk 3 of 4, kv chunk "
              f"{kv // c}, causal {mask}): relative errors "
              + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
              + f"; tol O {o_tol:g}{o_how}, LSE 2e-5, grads {bwd_tol:g} (as "
              f"the flash check); backward bitwise repeatable: {same}; "
              f"control fed the block-local lse: grads {ctrl:.3e} (must "
              f"exceed {bwd_tol:g})")
        assert errs["O"] <= o_tol and errs["LSE"] <= 2e-5, errs
        assert max(errs[n] for n in ("dQ", "dK", "dV")) <= bwd_tol, errs
        assert all(g.dtype == torch.float32 for g in grads)
        assert same, "flash block backward is not bitwise repeatable"
        assert ctrl > bwd_tol, "the block check cannot tell a local lse"
        if dtype == torch.bfloat16 and not mask:
            st = flash_bf16_state(qc, kc, vc, scale, causal=False)
            st_err = max(0.0, bf16_excess(st, po)) / peak
            print(f"flash_block {dtype} {case}: control with bf16 softmax "
                  f"state: O beyond one bf16 spacing {st_err:.3e} (must "
                  f"exceed {o_tol:g})")
            assert st_err > o_tol, "the block check cannot tell bf16 state"
            del st
        del local, again
        ops = B * H * c * c * D * (0.5 if mask else 1.0)
        f_ms, f_by = bound(4 * io + B * H * c * 4, 4 * ops, dtype)
        b_ms, b_by = bound(4 * io + 2 * B * H * c * 4 + 3 * B * H * c * D * 4,
                           10 * ops, dtype)
        ms = time_ms(lambda: fl.flash_block_fwd(qc, kc, vc, scale=scale,
                                                causal=mask), flush)
        plain_ms = time_ms(lambda: fl.flash_fwd_plain(
            qc, kc, vc, causal=mask, scale=scale), flush)
        bms = time_ms(lambda: fl.flash_block_bwd(
            qc, kc, vc, doc, lse_g, delta, scale=scale, causal=mask), flush)
        bplain_ms = time_ms(lambda: fl.flash_block_bwd_plain(
            qc, kc, vc, doc, lse_g, delta, causal=mask, scale=scale), flush)
        lib_ms, lib_bms, lib_txt = sdpa_efficient_times(
            qc, kc, vc, doc, oc, lse_g, mask, scale, flush)
        print(f"flash_block {dtype} {case}: forward kernel_ms {ms:.4f} "
              f"plain_ms {plain_ms:.4f} bound_ms {f_ms:.4f} ({f_by}); "
              f"backward kernel_ms {bms:.4f} plain_ms {bplain_ms:.4f} "
              f"bound_ms {b_ms:.4f} ({b_by}); {lib_txt}")
        out[case] = (
            {"max_abs_err": (bo.float() - po.float()).abs().max().item(),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": f_ms,
             "bound_by": f_by, "library_ms": lib_ms},
            {"max_abs_err": max((a - b).abs().max().item()
                                for a, b in zip(grads, pgrads)),
             "ms": bms, "plain_ms": bplain_ms, "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": lib_bms})
    return out


# Visits of one causal sp=4 ring layer: 4 diagonal, 6 past.
RING_VISITS = {"diagonal": 4, "past": 6}


def ring_mix(rows, which):
    """One summary row for a block kernel: each number the per-launch mean
    over one causal sp=4 layer's visits (4 diagonal, 6 past)."""
    n = sum(RING_VISITS.values())
    parts = {case: rows[case][which] for case in RING_VISITS}

    def mean(key):
        vals = [parts[c][key] for c in RING_VISITS]
        if any(x is None for x in vals):
            return None
        return sum(RING_VISITS[c] * parts[c][key] for c in RING_VISITS) / n

    return {"max_abs_err": max(p["max_abs_err"] for p in parts.values()),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": parts["past"]["bound_by"],
            "library_ms": mean("library_ms"),
            "timed": "mean per launch of one causal sp=4 layer: 4 diagonal "
                     "(causal) + 6 past (unmasked) visits at (8, 12, 256, "
                     "64)"}


# Gradient tolerance of the CE check, relative to each gradient's own
# largest value.  fp32: the same products summed in another order.  bf16:
# t, dh and dW are rounded to bf16 at the same points in the kernel and
# the plain version, so an element may differ by one bf16 spacing where
# the two fp32 sums straddle a rounding boundary; only what lies beyond
# that spacing counts (``ce_grad_err``).  A control with a fault
# (``ce_bwd_control``) must exceed the limit.
CE_TOL = 1e-4


def ce_grad_err(x, ref):
    """CE gradient error over ``max |ref|``; for a bf16 output, only the
    part beyond one bf16 spacing at ``ref`` (``bf16_excess``)."""
    if x.dtype == torch.bfloat16:
        return max(0.0, bf16_excess(x, ref)) / ref.float().abs().max().item()
    return rel_err(x, ref)


def ce_bwd_control(h, w, y, lse, g, b, chunk=8192):
    """Control for the CE gradient check: the plain backward's dh and dW
    with t rounded to bf16, which in an fp32 run is the fault; in a bf16
    run, where that rounding is the function's own, t also loses its
    softmax term (only ``-onehot * dnll`` is left)."""
    hf = h.float()
    yl = y.long()
    dh = torch.zeros(hf.shape, device=h.device)
    dw = torch.empty_like(w)
    for c0 in range(0, w.shape[0], chunk):
        c1 = min(w.shape[0], c0 + chunk)
        cols = torch.arange(c0, c1, device=h.device)
        t = -(cols[None, :] == yl[:, None]).float()
        if w.dtype == torch.float32:
            t += torch.exp(hf @ w[c0:c1].T + b[c0:c1] - lse[:, None])
        t = (t * g[:, None]).to(torch.bfloat16).float()
        dh += t @ w[c0:c1].float()
        dw[c0:c1] = (t.T @ hf).to(w.dtype)
    return dh.to(h.dtype), dw


def tf32_inputs(x):
    """x with the low 13 mantissa bits cleared: an fp32 tensor as a
    one-pass TF32 product reads it."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def ce_case(gen, dtype, N, E, V):
    """Inputs of a CE check: a bias, every 97th label ignored, dnll / N."""
    h = torch.randn((N, E), generator=gen).to("cuda", dtype)
    w = (torch.randn((V, E), generator=gen) * 0.02).to("cuda", dtype)
    b = (torch.randn(V, generator=gen) * 0.1).cuda()
    y = torch.randint(0, V, (N,), generator=gen, dtype=torch.int32)
    y[::97] = -1
    y = y.cuda()
    dn = torch.randn(N, generator=gen).cuda() * (y != -1) / N
    return h, w, b, y, dn


def ce_compare(ce, name, h, w, b, y, dn):
    """Kernels vs plain with the bias: nll / lse within 1e-5, every
    gradient within ``CE_TOL``, each backward run twice and compared
    bitwise.  Returns what the timing and the controls need."""
    live = y != -1
    lse, ylog = ce.lm_head_ce_fwd(h, w, y, bias=b)
    grads = ce.lm_head_ce_bwd(h, w, y, lse, dn, bias=b)
    again = ce.lm_head_ce_bwd(h, w, y, lse, dn, bias=b)
    plse, pylog = ce.lm_head_ce_fwd_plain(h, w, y, bias=b)
    pgrads = ce.lm_head_ce_bwd_plain(h, w, y, lse, dn, bias=b)
    torch.cuda.synchronize()
    nll, pnll = lse - ylog, plse - pylog
    errs = {"nll": rel_err(nll[live], pnll[live]), "lse": rel_err(lse, plse)}
    errs.update({n: ce_grad_err(a, c) for n, a, c in
                 zip(("dh", "dW", "db"), grads, pgrads)})
    same = all(torch.equal(a, c) for a, c in zip(grads, again))
    print(f"lm_head_ce {name}: relative errors "
          + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f"; tol nll/lse 1e-5, grads {CE_TOL:g} of each gradient's own "
          f"max (fp32 sums in another order; bf16: beyond one bf16 "
          f"spacing); backward bitwise repeatable: {same}")
    assert errs["nll"] <= 1e-5 and errs["lse"] <= 1e-5, errs
    assert max(errs[n] for n in ("dh", "dW", "db")) <= CE_TOL, errs
    assert same, "lm_head_ce backward is not bitwise repeatable"
    return lse, nll, pnll, grads, pgrads


def check_lm_head_ce(ce, flush, dtype, gen, card):
    """Kernels vs plain at N=8184, E=768, V=50257 (the train step's head),
    with a bias (db checked) and every 97th label ignored; each backward
    run twice and compared bitwise; controls that must fail; then a
    ragged case at GPT-2 XL's width (N=300, E=1600, V=8193), untimed;
    times without the bias, as the GPT head runs."""
    N, E, V = 8184, 768, 50257
    h, w, b, y, dn = ce_case(gen, dtype, N, E, V)
    live = y != -1
    lse, nll, pnll, grads, pgrads = ce_compare(ce, f"{dtype}", h, w, b, y,
                                               dn)
    if dtype == torch.float32:
        # a kernel that ran one-pass TF32 products reads its inputs so
        clse, cylog = ce.lm_head_ce_fwd_plain(tf32_inputs(h), tf32_inputs(w),
                                              y, bias=b)
        c_nll = rel_err((clse - cylog)[live], pnll[live])
        print(f"lm_head_ce {dtype}: control with h and W rounded to TF32: "
              f"nll {c_nll:.3e} (must exceed tol 1e-5)")
        assert c_nll > 1e-5, "the CE check cannot tell one-pass TF32"
        del clse, cylog
    cdh, cdw = ce_bwd_control(h, w, y, lse, dn, b)
    ctrl = {"dh": ce_grad_err(cdh, pgrads[0]),
            "dW": ce_grad_err(cdw, pgrads[1])}
    fault = "t rounded to bf16" if dtype == torch.float32 else \
        "t without its softmax term"
    print(f"lm_head_ce {dtype}: control with {fault}: dh {ctrl['dh']:.3e} "
          f"dW {ctrl['dW']:.3e} (each must exceed tol {CE_TOL:g})")
    assert min(ctrl.values()) > CE_TOL, "the CE check cannot tell the fault"
    del cdh, cdw
    ce_compare(ce, f"{dtype} N=300 E=1600 V=8193",
               *ce_case(gen, dtype, 300, 1600, 8193))
    s = torch.finfo(dtype).bits // 8
    ops = 2 * N * E * V
    f_ms, f_by = bound((N + V) * E * s + N * 4 + 2 * N * 4, ops, dtype)
    # the logits once, dh = t @ W and dW = t^T @ h
    b_ms, b_by = bound(2 * (N + V) * E * s + 3 * N * 4, 3 * ops, dtype)
    ms = time_ms(lambda: ce.lm_head_ce_fwd(h, w, y), flush, reps=10)
    plain_ms = time_ms(lambda: ce.lm_head_ce_fwd_plain(h, w, y), flush,
                       reps=10)
    yl = y.long()
    xent = torch.nn.functional.cross_entropy
    lib_ms = time_ms(lambda: xent(h @ w.T, yl, ignore_index=-1,
                                  reduction="none"), flush, reps=10)
    lse0, _ = ce.lm_head_ce_fwd(h, w, y)
    bms = time_ms(lambda: ce.lm_head_ce_bwd(h, w, y, lse0, dn), flush,
                  reps=10)
    bplain_ms = time_ms(lambda: ce.lm_head_ce_bwd_plain(h, w, y, lse0, dn),
                        flush, reps=10)
    hg, wg = h.detach().clone().requires_grad_(), \
        w.detach().clone().requires_grad_()

    def lib_fwd_bwd():
        xent(hg @ wg.T, yl, ignore_index=-1, reduction="none").backward(dn)

    lib_fb_ms = time_ms(lib_fwd_bwd, flush, reps=10)
    print(f"lm_head_ce {dtype}: forward kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} (cross_entropy(h @ W.T))"
          f" bound_ms {f_ms:.4f} ({f_by}); backward kernel_ms {bms:.4f} "
          f"plain_ms {bplain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}); library "
          f"forward+backward {lib_fb_ms:.4f} ms; {card}")
    print(f"lm_head_ce {dtype}: kernel below the library: forward "
          f"{ms < lib_ms}, backward {bms < lib_fb_ms}")
    fwd = {"max_abs_err": (nll[live] - pnll[live]).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": f_ms,
           "bound_by": f_by, "library_ms": lib_ms}
    bwd = {"max_abs_err": max((a.float() - c.float()).abs().max().item()
                              for a, c in zip(grads, pgrads)),
           "ms": bms, "plain_ms": bplain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_fb_ms,
           "library_call": "cross_entropy(h @ W.T) forward+backward"}
    return fwd, bwd


# Fused LN tolerances, relative to each output's own largest value.  fp32:
# the same fp32 operations summed in another order.  bf16: out, dx and dy
# are rounded once from fp32 in both versions, so an element may differ by
# one bf16 spacing where the two fp32 values straddle a rounding boundary;
# only what lies beyond that spacing counts, and the share of elements of
# out that differ at all must stay under FLN_SHARE (a kernel that rounded
# v = x + drop(y) to bf16 before the statistics, as an unfused bf16 graph
# does, moves a large share by one spacing: the control below).
FLN_TOL = 1e-5
FLN_SHARE = 1e-3


def fln_err(x, ref):
    """Fused-LN error over ``max |ref|``; for bf16 the part beyond one
    bf16 spacing at ``ref``."""
    if x.dtype == torch.bfloat16:
        return max(0.0, bf16_excess(x, ref)) / ref.float().abs().max().item()
    return rel_err(x, ref)


def fln_rounded_v(fln, x, y, s, b, kw):
    """Control: the plain forward with v = x + drop(y) rounded to the
    inputs' type before the statistics."""
    v, _ = fln._residual_plain(x, y, kw["words"], kw["thresh"], kw["keep_y"])
    v = v.to(x.dtype).float()
    mean = v.mean(-1, keepdim=True)
    c = v - mean
    rstd = torch.rsqrt((c * c).mean(-1, keepdim=True) + 1e-5)
    return (c * rstd * s + b).to(x.dtype)


def check_fused_ln(fln, prng, flush, dtype, gen):
    """Kernels vs plain at T=12288, D=1024 (BERT-large at 96 x 128), rate
    0.1: out, dx, dy, dscale, dbias; the dropped pattern of dy bitwise
    where dv != 0; the backward run twice and compared bitwise; controls
    that must fail; times beside the bound, the plain version and
    ``F.layer_norm(x + F.dropout(y))`` (another mask: the yardstick's
    dropout draws its own)."""
    T, D, rate = 12288, 1024, 0.1
    x, y, do = (torch.randn((T, D), generator=gen).to("cuda", dtype)
                for _ in range(3))
    s = (1 + 0.1 * torch.randn(D, generator=gen)).cuda()
    b = (0.1 * torch.randn(D, generator=gen)).cuda()
    words = prng.key_words(prng.fold_in(prng.key(0), 3))
    kw = dict(words=words, thresh=fln.dropout_keep_thresh(rate),
              keep_y=fln._keep_y(rate, dtype))
    keep_g = float(torch.tensor(1.0 - rate, dtype=torch.float32))
    out, mean, rstd = fln.fused_ln_fwd(x, y, s, b, **kw)
    grads = fln.fused_ln_bwd(do, x, y, s, mean, rstd, keep_g=keep_g, **kw)
    again = fln.fused_ln_bwd(do, x, y, s, mean, rstd, keep_g=keep_g, **kw)
    pout, pmean, prstd = fln.fused_ln_fwd_plain(x, y, s, b, **kw)
    pgrads = fln.fused_ln_bwd_plain(do, x, y, s, mean, rstd, keep_g=keep_g,
                                    **kw)
    torch.cuda.synchronize()
    errs = {"out": fln_err(out, pout), "mean": rel_err(mean, pmean),
            "rstd": rel_err(rstd, prstd)}
    errs.update({n: fln_err(a, p) for n, a, p in
                 zip(("dx", "dy", "dscale", "dbias"), grads, pgrads)})
    same = all(torch.equal(a, c) for a, c in zip(grads, again))
    live = grads[0] != 0
    dropped = (grads[1] == 0) & live
    pattern = torch.equal(dropped, (pgrads[1] == 0) & live)
    kept = 1.0 - dropped.sum().item() / live.sum().item()
    share = (out != pout).float().mean().item() \
        if dtype == torch.bfloat16 else 0.0
    print(f"fused_ln {dtype}: relative errors "
          + " ".join(f"{n} {e:.3e}" for n, e in errs.items())
          + f" (tol {FLN_TOL:g} of each output's own max; bf16: beyond one "
          f"bf16 spacing); bf16 out elements differing {share:.3e} (tol "
          f"{FLN_SHARE:g}); dropped pattern bitwise equal: {pattern} (kept "
          f"{kept:.5f}, keep 0.9); backward bitwise repeatable: {same}")
    assert max(errs.values()) <= FLN_TOL, errs
    assert share <= FLN_SHARE and pattern and same
    swapped = dict(kw, words=words[::-1])
    c_out, _, _ = fln.fused_ln_fwd(x, y, s, b, **swapped)
    ctrl = {"key words swapped": fln_err(c_out, pout)}
    if dtype == torch.bfloat16:
        c_share = (fln_rounded_v(fln, x, y, s, b, kw) != pout).float()
        ctrl["v rounded to bf16 (share differing)"] = c_share.mean().item()
    print(f"fused_ln {dtype}: controls " + ", ".join(
        f"{n} {e:.3e}" for n, e in ctrl.items())
        + f" (must exceed {FLN_TOL:g}; the share {FLN_SHARE:g})")
    assert ctrl["key words swapped"] > FLN_TOL
    assert dtype == torch.float32 or \
        ctrl["v rounded to bf16 (share differing)"] > FLN_SHARE
    del c_out
    sz = torch.finfo(dtype).bits // 8
    f_ms, f_by = bound(3 * T * D * sz + 2 * T * 4 + 2 * D * 4, 8 * T * D,
                       torch.float32)
    b_ms, b_by = bound(5 * T * D * sz + 2 * T * 4 + 3 * D * 4, 16 * T * D,
                       torch.float32)
    ms = time_ms(lambda: fln.fused_ln_fwd(x, y, s, b, **kw), flush)
    plain_ms = time_ms(lambda: fln.fused_ln_fwd_plain(x, y, s, b, **kw),
                       flush, reps=10)
    F = torch.nn.functional
    sl, bl = s.to(dtype), b.to(dtype)
    lib_ms = time_ms(lambda: F.layer_norm(x + F.dropout(y, rate), (D,), sl,
                                          bl), flush)
    bms = time_ms(lambda: fln.fused_ln_bwd(do, x, y, s, mean, rstd,
                                           keep_g=keep_g, **kw), flush)
    # information: the same bytes without the mask's two hash rounds and
    # two exact divisions an element (thresh 0)
    b0ms = time_ms(lambda: fln.fused_ln_bwd(do, x, y, s, mean, rstd), flush)
    bplain_ms = time_ms(lambda: fln.fused_ln_bwd_plain(
        do, x, y, s, mean, rstd, keep_g=keep_g, **kw), flush, reps=10)
    xg, yg, sg, bg = (t.detach().clone().requires_grad_()
                      for t in (x, y, sl, bl))

    def lib_fwd_bwd():
        F.layer_norm(xg + F.dropout(yg, rate), (D,), sg, bg).backward(do)

    lib_fb_ms = time_ms(lib_fwd_bwd, flush)
    print(f"fused_ln {dtype}: forward kernel_ms {ms:.4f} plain_ms "
          f"{plain_ms:.4f} library_ms {lib_ms:.4f} (layer_norm(x + "
          f"dropout(y)), another mask) bound_ms {f_ms:.4f} ({f_by}); "
          f"backward kernel_ms {bms:.4f} plain_ms {bplain_ms:.4f} bound_ms "
          f"{b_ms:.4f} ({b_by}); library forward+backward {lib_fb_ms:.4f} "
          f"ms; backward without dropout {b0ms:.4f} ms")
    fwd = {"max_abs_err": (out.float() - pout.float()).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": f_ms,
           "bound_by": f_by, "library_ms": lib_ms,
           "library_call": "layer_norm(x + dropout(y)), another mask"}
    bwd = {"max_abs_err": max((a.float() - p.float()).abs().max().item()
                              for a, p in zip(grads, pgrads)),
           "ms": bms, "plain_ms": bplain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_fb_ms,
           "library_call": "layer_norm(x + dropout(y)) forward+backward, "
                           "another mask"}
    return fwd, bwd


def train_phase(fl, ce, gpt_mod, card):
    """GPT-2 small at full width and depth, fp32, flash attention and the
    streamed head (chunk 1024): a step-0 check of the loss and every
    gradient against the plain path on the card (materialized attention
    and head, same weights), then 5 AdamW ``Trainer`` steps on one
    numpy-seeded 8 x 1024 batch with the launch counters read per step,
    then one profiled step.  Returns the counts and the losses of the
    5-step run."""
    from hetu_tpu_torch import AdamWOptimizer, GPT, Trainer, flash_attn_fn
    cfg = gpt_mod.gpt2_small(streamed_head_chunk=1024)
    model = GPT(cfg, attn_fn=flash_attn_fn(native_layout=True),
                generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, cfg.max_seq_len))).cuda()
    tokens = ids.numel()

    def grads_of(m):
        m.zero_grad(set_to_none=True)
        loss = m.loss(ids)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in m.named_parameters()}

    fl.reset_launch_count()
    ce.reset_launch_count()
    k_loss, k_grads = grads_of(model)
    torch.cuda.synchronize()
    counts0 = (fl.fwd_launch_count(), fl.bwd_launch_count(),
               ce.fwd_launch_count(), ce.bwd_launch_count())
    assert counts0 == (12, 12, 1, 1), counts0
    plain = GPT(gpt_mod.gpt2_small(), generator=torch.Generator())
    plain.load_state_dict(model.state_dict())
    p_loss, p_grads = grads_of(plain)
    torch.cuda.synchronize()
    assert (fl.fwd_launch_count(), ce.fwd_launch_count()) == (12, 1), \
        "the plain path launched a train kernel"
    lrel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    worst = max((((k_grads[n] - g).abs().max()
                  / g.abs().max().clamp_min(1e-30)).item(), n)
                for n, g in p_grads.items())
    print(f"train step 0: loss kernel path {float(k_loss):.6f} plain path "
          f"{float(p_loss):.6f}, relative difference {lrel:.3e} (tol 1e-5);"
          f" worst gradient {worst[1]}: max |diff| / max |plain| "
          f"{worst[0]:.3e} (tol 1e-3: fp32 sums over 8192 tokens taken in "
          f"other orders)")
    assert lrel <= 1e-5 and worst[0] <= 1e-3
    del plain, p_grads, k_grads
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    trainer = Trainer(model, AdamWOptimizer(3e-4, weight_decay=0.01),
                      lambda m, batch, key: (m.loss(batch, key=key), {}))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fl.reset_launch_count()
    ce.reset_launch_count()
    losses, step_s = [], []
    for _ in range(5):
        before = (fl.fwd_launch_count(), fl.bwd_launch_count(),
                  ce.fwd_launch_count(), ce.bwd_launch_count())
        t0 = time.monotonic()
        losses.append(float(trainer.step(ids)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        after = (fl.fwd_launch_count(), fl.bwd_launch_count(),
                 ce.fwd_launch_count(), ce.bwd_launch_count())
        delta = tuple(a - b for a, b in zip(after, before))
        assert delta == (12, 12, 1, 1), f"launches per step {delta}"
    counts = {"flash_fwd": fl.fwd_launch_count(),
              "flash_bwd": fl.bwd_launch_count(),
              "lm_head_ce_fwd": ce.fwd_launch_count(),
              "lm_head_ce_bwd": ce.bwd_launch_count()}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_s)
    print(f"train: losses {[round(x, 6) for x in losses]}; launches "
          f"{counts} (12/12/1/1 per step); median step {med * 1e3:.3f} ms "
          f"(steps {[round(s * 1e3, 3) for s in step_s]} ms), "
          f"{tokens / med:.1f} tokens/s, peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB), {card}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses

    profile_step(lambda: trainer.step(ids), med)
    torch.cuda.synchronize()
    return counts, losses


def ring_phase(fl, ce, gpt_mod, card, flash_losses):
    """GPT-2 small trained with sequence-parallel ring attention, sp=4, on
    the one card (a local mesh: the four ranks' visits run in turn with a
    rank's shapes).  Same weights and batch as the train phase.  Step 0:
    the ring's loss and every gradient against the flash path's, the
    ring's gradients bitwise equal on a second run, the blockwise core
    against the flash path too; then 5 AdamW ``Trainer`` steps, each
    launching 120 block forwards and 120 block backwards (12 layers x 10
    visits), no whole-sequence flash, 1 CE forward and 1 CE backward, with
    a falling loss; step time, tokens/s, peak memory and a profiled step.
    Returns the counts of the 5-step run."""
    from hetu_tpu_torch import (AdamWOptimizer, GPT, MeshSpec, Trainer,
                                flash_attn_fn, make_mesh, ring_attn_fn)
    cfg = gpt_mod.gpt2_small(streamed_head_chunk=1024)
    mesh = make_mesh(MeshSpec(sp=4))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, cfg.max_seq_len))).cuda()
    tokens = ids.numel()

    def grads_of(m):
        m.zero_grad(set_to_none=True)
        loss = m.loss(ids)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in m.named_parameters()}

    def counts():
        return (fl.block_fwd_launch_count(), fl.block_bwd_launch_count(),
                fl.fwd_launch_count(), fl.bwd_launch_count(),
                ce.fwd_launch_count(), ce.bwd_launch_count())

    def against_flash(name, loss, grads):
        lrel = abs(float(loss) - float(f_loss)) / abs(float(f_loss))
        worst = max((((grads[n] - g).abs().max()
                      / g.abs().max().clamp_min(1e-30)).item(), n)
                    for n, g in f_grads.items())
        print(f"ring step 0 ({name}): loss {float(loss):.6f}, flash path "
              f"{float(f_loss):.6f}, relative difference {lrel:.3e} (tol "
              f"1e-5); worst gradient {worst[1]}: max |diff| / max |flash| "
              f"{worst[0]:.3e} (tol 1e-3: fp32 sums in other orders)")
        assert lrel <= 1e-5 and worst[0] <= 1e-3

    flash = GPT(cfg, attn_fn=flash_attn_fn(native_layout=True),
                generator=torch.Generator().manual_seed(0))
    f_loss, f_grads = grads_of(flash)
    ring = GPT(cfg, attn_fn=ring_attn_fn(mesh), generator=torch.Generator())
    ring.load_state_dict(flash.state_dict())
    del flash
    torch.cuda.synchronize()
    fl.reset_launch_count()
    ce.reset_launch_count()
    r_loss, r_grads = grads_of(ring)
    torch.cuda.synchronize()
    assert counts() == (120, 120, 0, 0, 1, 1), counts()
    against_flash("flash block kernels", r_loss, r_grads)
    again_loss, again = grads_of(ring)
    same = torch.equal(again_loss, r_loss) and all(
        torch.equal(again[n], g) for n, g in r_grads.items())
    print(f"ring step 0: loss and all {len(r_grads)} gradients bitwise "
          f"equal on a second run: {same}")
    assert same, "the ring's step-0 gradients are not bitwise repeatable"
    del r_grads, again
    blockwise = GPT(cfg, attn_fn=ring_attn_fn(mesh, impl="blockwise"),
                    generator=torch.Generator())
    blockwise.load_state_dict(ring.state_dict())
    before = counts()
    b_loss, b_grads = grads_of(blockwise)
    torch.cuda.synchronize()
    assert counts()[:4] == before[:4], "the blockwise core launched flash"
    against_flash("blockwise core", b_loss, b_grads)
    del blockwise, b_grads, f_grads
    ring.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    trainer = Trainer(ring, AdamWOptimizer(3e-4, weight_decay=0.01),
                      lambda m, batch, key: (m.loss(batch, key=key), {}))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fl.reset_launch_count()
    ce.reset_launch_count()
    losses, step_s = [], []
    for _ in range(5):
        before = counts()
        t0 = time.monotonic()
        losses.append(float(trainer.step(ids)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        delta = tuple(a - b for a, b in zip(counts(), before))
        assert delta == (120, 120, 0, 0, 1, 1), f"launches per step {delta}"
    launches = {"flash_block_fwd": fl.block_fwd_launch_count(),
                "flash_block_bwd": fl.block_bwd_launch_count(),
                "flash_fwd": fl.fwd_launch_count(),
                "flash_bwd": fl.bwd_launch_count(),
                "lm_head_ce_fwd": ce.fwd_launch_count(),
                "lm_head_ce_bwd": ce.bwd_launch_count()}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_s)
    gap = max(abs(a - b) for a, b in zip(losses, flash_losses))
    print(f"ring train (sp=4): losses {[round(x, 6) for x in losses]}; "
          f"launches {launches} (120/120/0/0/1/1 per step); median step "
          f"{med * 1e3:.3f} ms (steps {[round(t * 1e3, 3) for t in step_s]}"
          f" ms), {tokens / med:.1f} tokens/s, peak memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB), {card}; info: largest loss gap to the "
          f"train phase's flash path, step for step, {gap:.3e}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    profile_step(lambda: trainer.step(ids), med)
    torch.cuda.synchronize()
    return launches


# Kernel-name marks of the groups a profiled step's device time is summed
# into (the first group that matches wins).
PROFILE_GROUPS = (
    ("fused LN", ("::ln_fwd", "::ln_bwd", "::ln_sum_parts")),
    ("flash (whole-sequence, or the ring's blocks)", ("::flash_",)),
    ("LM-head cross entropy", ("::ce_",)),
    ("the port's other CUDA kernels", (
        "::head_topk_", "::paged_decode_")),
    ("matrix products", ("gemm", "nvjet", "cutlass", "xmma")),
    ("int64 elementwise (dropout hash)", ("<long",)),
    ("elementwise and copies", ("elementwise", "copy")),
    ("reductions", ("reduce_kernel",)),
)


def union_ms(spans):
    """The length of the union of ``(start, end)`` intervals in µs, in
    ms."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def device_spans(prof):
    """``(name, start, end)`` of every device activity under ``prof``.
    Busy time is the union of these: a kernel launched as a programmatic
    dependent (paged decode's merge, the fused-LN backward's partial
    sums) starts while the kernel before it runs and waits inside
    itself, so summed durations would count that overlap twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


def profile_step(step, med):
    """One profiled call of ``step``: the device's busy time, its ten
    largest items and the busy time of each group of kernels."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    if not rows:
        print("train step device time: not measured (the profiler saw no "
              "device activity)")
        return
    spans = device_spans(prof)
    dev_ms = union_ms([sp[1:] for sp in spans])
    print(f"train step under the profiler: device busy {dev_ms:.3f} ms "
          f"({dev_ms / (med * 1e3):.1%} of the median bare step; kernel "
          f"durations sum to {sum(r[1] for r in rows) / 1e3:.3f} ms)")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"  {us / 1e3:9.3f} ms  {n:5d} launches  {key[:90]}")
    groups = {}
    for name, a, b in spans:
        g = next((g for g, marks in PROFILE_GROUPS
                  if any(m in name for m in marks)), "other")
        groups.setdefault(g, []).append((a, b))
    groups = {g: (union_ms(sp), len(sp)) for g, sp in groups.items()}
    print("  by group (busy time): " + "; ".join(
        f"{g} {t:.3f} ms ({c} launches)"
        for g, (t, c) in sorted(groups.items(), key=lambda kv: -kv[1][0])))
    if "LM-head cross entropy" in groups:
        t, c = groups["LM-head cross entropy"]
        print(f"  LM-head CE kernels (forward and backward): {t:.3f} ms of "
              f"device time in {c} launches")


def bert_batch(vocab, batch, seq, seed=0):
    """A pretraining batch as the JAX package's bench makes it: numpy
    seed 0, 15% of positions carry an MLM label (else -1), random NSP
    labels; token types all 0, no attention mask."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq))
    mlm = np.where(rng.random((batch, seq)) < 0.15,
                   rng.integers(0, vocab, (batch, seq)), -1)
    nsp = rng.integers(0, 2, (batch,))
    return tuple(torch.from_numpy(a).cuda() for a in (ids, mlm, nsp))


def bert_phase(fln, card):
    """BERT-large pretraining: the fp32 step-0 check of the fused kernels
    against the plain sites at batch 8 x 128 with one fixed key, then 5
    bf16 AdamW ``Trainer`` steps at batch 96 x 128 with the launch counts
    read per step, then one profiled step, then (information) the same 5
    steps through the plain sites.  Returns the counts of the 5-step
    run."""
    from hetu_tpu_torch import (AdamWOptimizer, BertForPreTraining, Trainer,
                                bert_large, set_random_seed)
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.layers import dot_product_attention_bhsd
    attn = dot_product_attention_bhsd

    def grads_of(m, batch, key):
        ids, mlm, nsp = batch
        m.zero_grad(set_to_none=True)
        loss, _ = m.loss(ids, None, None, mlm, nsp, key=key)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in m.named_parameters()
                               if p.grad is not None}

    t0 = time.monotonic()
    fused = BertForPreTraining(bert_large(fused_ln=True), attn_fn=attn,
                               generator=torch.Generator().manual_seed(0))
    cfg = fused.config
    print(f"model: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
          f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, dropout "
          f"{cfg.dropout_rate}, {sum(p.numel() for p in fused.parameters())}"
          f" parameters, built in {time.monotonic() - t0:.2f} s")
    small = bert_batch(cfg.vocab_size, 8, 128, seed=1)
    key = prng.fold_in(prng.key(0), 1)
    fln.reset_launch_count()
    k_loss, k_grads = grads_of(fused, small, key)
    torch.cuda.synchronize()
    counts0 = (fln.fwd_launch_count(), fln.bwd_launch_count())
    assert counts0 == (48, 48), counts0
    plain = BertForPreTraining(bert_large(), attn_fn=attn,
                               generator=torch.Generator())
    plain.load_state_dict(fused.state_dict())
    p_loss, p_grads = grads_of(plain, small, key)
    torch.cuda.synchronize()
    assert (fln.fwd_launch_count(), fln.bwd_launch_count()) == counts0, \
        "the plain path launched a fused-LN kernel"
    assert sorted(k_grads) == sorted(p_grads)
    lrel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    worst = max((((k_grads[n] - g).abs().max()
                  / g.abs().max().clamp_min(1e-30)).item(), n)
                for n, g in p_grads.items())
    print(f"BERT step 0 (fp32, 8 x 128, dropout on, one key): loss fused "
          f"{float(k_loss):.6f} plain {float(p_loss):.6f}, relative "
          f"difference {lrel:.3e} (tol 1e-5); worst gradient {worst[1]}: "
          f"max |diff| / max |plain| {worst[0]:.3e} (tol 1e-3: fp32 sums "
          f"taken in other orders); launches {counts0}")
    assert lrel <= 1e-5 and worst[0] <= 1e-3
    del fused, plain, k_grads, p_grads
    torch.cuda.empty_cache()

    set_random_seed(0)
    model = BertForPreTraining(bert_large(fused_ln=True,
                                          dtype=torch.bfloat16),
                               attn_fn=attn,
                               generator=torch.Generator().manual_seed(0))
    batch = bert_batch(model.config.vocab_size, 96, 128)
    samples, tokens = batch[0].shape[0], batch[0].numel()

    def loss_fn(m, bt, k):
        ids, mlm, nsp = bt
        loss, _ = m.loss(ids, None, None, mlm, nsp, key=k)
        return loss, {}

    trainer = Trainer(model, AdamWOptimizer(1e-4, weight_decay=0.01),
                      loss_fn)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    fln.reset_launch_count()
    losses, step_s = [], []
    for _ in range(5):
        before = (fln.fwd_launch_count(), fln.bwd_launch_count())
        t0 = time.monotonic()
        losses.append(float(trainer.step(batch)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.monotonic() - t0)
        delta = (fln.fwd_launch_count() - before[0],
                 fln.bwd_launch_count() - before[1])
        assert delta == (48, 48), f"fused-LN launches per step {delta}"
    counts = {"fused_ln_fwd": fln.fwd_launch_count(),
              "fused_ln_bwd": fln.bwd_launch_count()}
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(step_s)
    print(f"BERT train (bf16, 96 x 128, AdamW 1e-4): losses "
          f"{[round(x, 6) for x in losses]}; launches {counts} (48/48 per "
          f"step); median step {med * 1e3:.3f} ms (steps "
          f"{[round(t * 1e3, 3) for t in step_s]} ms), {samples / med:.2f} "
          f"samples/s, {tokens / med:.1f} tokens/s, peak memory {peak} "
          f"bytes ({peak / 2**30:.3f} GiB), {card}")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    profile_step(lambda: trainer.step(batch), med)
    del trainer, model
    torch.cuda.empty_cache()
    # information: the same steps through the plain sites (dropout +
    # layer_norm, v rounded to bf16), same weights and keys
    set_random_seed(0)
    plain = BertForPreTraining(bert_large(dtype=torch.bfloat16),
                               attn_fn=attn,
                               generator=torch.Generator().manual_seed(0))
    ptrainer = Trainer(plain, AdamWOptimizer(1e-4, weight_decay=0.01),
                       loss_fn)
    plosses = [float(ptrainer.step(batch)["loss"]) for _ in range(5)]
    print(f"info: the same 5 steps with fused_ln=False: losses "
          f"{[round(x, 6) for x in plosses]}")
    torch.cuda.synchronize()
    return counts


# Phase 4's stochastic modes: top-k's k, and both modes' temperature.
SERVE_TOP_K, SERVE_TEMPERATURE = 5, 0.8
GUMBEL_TOL = 2e-6   # torch.log on the card against torch.log on the CPU


def check_rng(flush, N=SERVE_SLOTS, V=50257):
    """The threefry bits, the uniform and the Gumbel field at the decode
    step's shape, ``(N, V)`` from N per-row keys derived as the engine
    derives them, on the card against the CPU: bits and uniform bitwise,
    the field within GUMBEL_TOL; and the field's device time."""
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.ops import random as rnd
    keys = prng.fold_in_tensor(prng.fold_in_tensor(
        prng.key(0), torch.arange(N)), torch.arange(N) + 100)
    dk = keys.cuda()
    assert torch.equal(prng.random_bits(dk, (V,)).cpu(),
                       prng.random_bits(keys, (V,))), \
        "random_bits on the card differ from the CPU's"
    tiny = torch.finfo(torch.float32).tiny
    for lo, hi in ((tiny, 1.0), (-3.5, 7.25)):
        u = rnd._uniform(dk, (V,), torch.float32, lo, hi).cpu()
        ref = rnd._uniform(keys, (V,), torch.float32, lo, hi)
        assert torch.equal(u.view(torch.int32), ref.view(torch.int32)), \
            f"the uniform on ({lo}, {hi}) differs on the card"
    err = (rnd._gumbel(dk, (V,)).cpu() - rnd._gumbel(keys, (V,))).abs()
    err = err.max().item()
    ms = time_ms(lambda: rnd._gumbel(dk, (V,)), flush, reps=10)
    print(f"threefry bits and uniform ({N}, {V}): bitwise equal to the "
          f"CPU's; Gumbel field max_abs_err {err:.3e} tol {GUMBEL_TOL:g}; "
          f"the field takes {ms:.4f} ms on the card (eager, L2 flushed)")
    assert err <= GUMBEL_TOL, f"Gumbel field on the card: {err}"


def check_sample_tokens(lh, N=SERVE_SLOTS, E=768, V=50257):
    """``lm_head_sample_tokens`` at GPT-2 small's head in the two
    stochastic modes against its plain route on the same Gumbel field or
    the same candidates: tokens equal wherever the two best perturbed
    scores are separated by more than the kernel's 1e-4 value tolerance."""
    from hetu_tpu_torch.core import prng
    g = torch.Generator().manual_seed(11)
    w = (torch.randn((V, E), generator=g) * 0.02).cuda()
    h = torch.randn((N, E), generator=g).cuda()
    keys = prng.fold_in_tensor(prng.key(1), torch.arange(N)).cuda()
    T = SERVE_TEMPERATURE
    for mode in ("temperature", "top_k"):
        lh.reset_launch_count()
        got = lh.lm_head_sample_tokens(h, w, mode=mode, top_k=SERVE_TOP_K,
                                       temperature=T, keys=keys)
        assert lh.launch_count() == 1, \
            f"lm_head_sample_tokens {mode} did not launch the kernel once"
        ref, gap = lh._sample_tokens_plain(
            h, w, mode=mode, top_k=SERVE_TOP_K, temperature=T, keys=keys)
        sep = gap > 1e-4
        same = int((got == ref).sum())
        print(f"lm_head_sample_tokens {mode} (k={SERVE_TOP_K}, T={T}): "
              f"{same}/{N} tokens equal to the plain route, {int(sep.sum())}"
              f" rows separated by more than 1e-4")
        assert torch.equal(got[sep], ref[sep]) and sep.sum() >= N - 1, \
            f"lm_head_sample_tokens {mode} differs from its plain route"


def check_replay(engine, prompts, budget, **kw):
    """Three ticks of the phase's 16 requests (the first decode step
    captures the graph), then one replayed step against the eager impl,
    bitwise in tokens and pool bytes."""
    from hetu_tpu_torch.serve.graph import _replay_vs_eager
    eng = engine(**kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=budget)
    for _ in range(3):
        eng.step()
    assert eng._decode_graph.captured
    toks, pool, wrote = _replay_vs_eager(eng)
    assert wrote, "the replayed decode step wrote no K/V"
    print(f"graph replay vs eager impl ({kw.get('sampling', 'greedy')}): "
          f"tokens {'equal' if toks else 'DIFFER'}, pool bytes "
          f"{'equal' if pool else 'DIFFER'} (bitwise)")
    assert toks and pool, "a replayed decode step differs from the eager one"


def serve_mode(engine, eager_engine, prompts, budget, cfg, pd, lh, mode):
    """Phase 4 in a stochastic mode: the 16 requests with their counts
    read just after, a same-seed rerun, the probe request alone under its
    batched id, a replayed step against the eager one; then, for
    information, agreement with the gather path, tokens/s, the median
    decode step and the decode profile with the graph and without it."""
    kw = dict(sampling=mode, top_k=SERVE_TOP_K,
              temperature=SERVE_TEMPERATURE)
    eng = engine(**kw)
    torch.cuda.synchronize()
    pd.reset_launch_count()
    lh.reset_launch_count()
    t0 = time.monotonic()
    handles = [eng.submit(p, max_new_tokens=budget) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = (pd.launch_count(), lh.launch_count())
    st = eng.stats()
    bad = [(h.request_id, h.status, h.error) for h in handles
           if h.status != "completed" or len(h.tokens) != budget]
    assert not bad, f"{mode}: requests not completed: {bad}"
    assert all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens)
    steps = st["decode_steps"]
    print(f"{mode} (k={SERVE_TOP_K}, T={SERVE_TEMPERATURE}): launches "
          f"paged_decode {launches[0]}, lm_head_sample {launches[1]}, "
          f"decode steps {steps} (one CUDA graph, captured: "
          f"{eng._decode_graph.captured})")
    assert launches[0] == cfg.num_layers * steps > 0
    assert launches[1] == steps
    streams = [h.tokens for h in handles]
    del eng
    again = engine(**kw)
    ah = [again.submit(p, max_new_tokens=budget) for p in prompts]
    again.run_until_idle()
    assert [h.tokens for h in ah] == streams, f"{mode}: same-seed rerun"
    probe = 11
    alone = engine(**kw)
    h = alone.submit(prompts[probe], max_new_tokens=budget,
                     request_id=probe)
    alone.run_until_idle()
    assert h.tokens == streams[probe], f"{mode}: alone != batched"
    print(f"{mode}: same-seed rerun bitwise equal; request {probe} alone "
          f"== batched ({budget} tokens)")
    del again, alone
    check_replay(engine, prompts, budget, **kw)
    gather = engine(paged_decode=False, fused_sampling=False, **kw)
    gh = [gather.submit(p, max_new_tokens=budget) for p in prompts]
    gather.run_until_idle()
    same = sum(a == b.tokens for a, b in zip(streams, gh))
    del gather
    print(f"info: {mode} kernel path vs gather path: {same}/{len(gh)} "
          f"streams identical")
    print(f"{mode}: served {len(handles)} requests, {st['tokens']} tokens "
          f"in {wall:.3f} s: {st['tokens'] / wall:.1f} tokens/s; median "
          f"decode step {st['decode_step_s_p50'] * 1e3:.3f} ms")
    graph = profile_decode(lambda: engine(**kw), prompts, f"{mode}, graph")
    eager = profile_decode(lambda: eager_engine(**kw), prompts,
                           f"{mode}, eager")
    return {"steps": steps, "tokens_per_s": st["tokens"] / wall,
            "median_step_ms": st["decode_step_s_p50"] * 1e3,
            "graph": graph, "eager": eager}


def reference_greedy(cpu_model, prompt, n):
    """Greedy continuation by full recomputation on the CPU; returns the
    tokens and each step's last-position logits."""
    ids = list(prompt)
    toks, logits = [], []
    with torch.no_grad():
        for _ in range(n):
            lg = cpu_model(torch.tensor([ids]))[0, -1]
            toks.append(int(torch.argmax(lg)))
            logits.append(lg)
            ids.append(toks[-1])
    return toks, logits


def profile_decode(make_engine, prompts, label, steps=10):
    """Information only: where a decode step's time goes.  Eight requests
    fill the slots; ``steps`` decode ticks are timed bare, then again
    under ``torch.profiler``, whose device time by kernel name gives the
    device's busy share of the step.  Returns ``(bare step ms, device
    busy ms per step or None)``."""
    from torch.profiler import ProfilerActivity, profile
    eng = make_engine()
    for p in prompts[:8]:
        eng.submit(p, max_new_tokens=steps * 2 + 8)
    for _ in range(4):       # admission + prefill tick, then warm decode
        eng.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    bare = (time.monotonic() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's row repeats its kernels' time
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    print(f"decode step ({label}, 8 active slots): {bare * 1e3:.3f} ms wall "
          f"without the profiler")
    if not rows:
        print("device busy time: not measured (the profiler saw no device "
              "activity)")
        return bare * 1e3, None
    dev_ms = union_ms([sp[1:] for sp in device_spans(prof)]) / steps
    print(f"device busy {dev_ms:.3f} ms per step, {dev_ms / (bare * 1e3):.1%}"
          f" of the bare step (torch.profiler; kernel durations sum to "
          f"{sum(r[1] for r in rows) / 1e3 / steps:.3f} ms)")
    for key, us, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"  {us / 1e3 / steps:8.4f} ms/step  {n // steps:4d} "
              f"launches/step  {key[:90]}")
    # the merge is a programmatic dependent: count the union of the two
    # kernels' intervals, not their summed durations
    sample = [sp[1:] for sp in device_spans(prof) if "head_topk_" in sp[0]]
    print(f"LM-head sampling (head_topk_partial + head_topk_merge): "
          f"{union_ms(sample) / steps:.4f} ms per step busy, "
          f"{len(sample) // steps} launches per step")
    return bare * 1e3, dev_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from hetu_tpu_torch import GPT, ServingEngine, gpt2_small
    from hetu_tpu_torch.models import gpt as gpt_mod
    from hetu_tpu_torch.ops.kernels import _build
    from hetu_tpu_torch.core import prng
    from hetu_tpu_torch.ops.kernels import flash as fl
    from hetu_tpu_torch.ops.kernels import fused_ln as fln
    from hetu_tpu_torch.ops.kernels import lm_head as lh
    from hetu_tpu_torch.ops.kernels import lm_head_ce as ce
    from hetu_tpu_torch.ops.kernels import paged_decode as pd
    from hetu_tpu_torch.serve import kv_cache as kvc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("1 device")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {kind} count {count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)

    phase("2 build")
    t0 = time.monotonic()
    _build.load_library()
    print(f"kernels built and loaded in {time.monotonic() - t0:.2f} s "
          f"from {_build.SRC_DIR}")
    for line in _build.build_log().splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:   # the mangled name, its anonymous-namespace prefix cut
            print("  " + re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+",
                                "", entry.group(1))[:100])
        elif "registers" in line or "spill" in line or "==" in line:
            print("  " + line.strip())

    phase("3 kernels vs plain")
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    pd_rows = {dt: check_paged_decode(pd, flush, dt, gen)
               for dt in (torch.float32, torch.bfloat16)}
    serve_lens = [len(p) for p in serve_prompts(gpt2_small().vocab_size)]
    pd_rows[torch.float32].update(
        time_paged_decode_serve(pd, flush, torch.Generator().manual_seed(7),
                                serve_lens))
    lm_rows = {(dt, k): check_lm_head(lh, flush, dt, k, gen)
               for dt in (torch.float32, torch.bfloat16) for k in (1, 5)}
    check_rng(flush)
    check_sample_tokens(lh)
    fl_rows = {dt: check_flash(fl, flush, dt, 1024, gen, timed=True)
               for dt in (torch.float32, torch.bfloat16)}
    check_flash(fl, flush, torch.float32, 1000, gen, timed=False)
    blk_rows = {dt: check_flash_block(fl, flush, dt, gen)
                for dt in (torch.float32, torch.bfloat16)}
    ce_rows = {dt: check_lm_head_ce(ce, flush, dt, gen, smi)
               for dt in (torch.float32, torch.bfloat16)}
    fln_rows = {dt: check_fused_ln(fln, prng, flush, dt, gen)
                for dt in (torch.float32, torch.bfloat16)}
    del flush
    torch.cuda.empty_cache()

    phase("4 engine: GPT-2 small")
    cfg = gpt2_small()
    t0 = time.monotonic()
    model = GPT(cfg, generator=torch.Generator().manual_seed(0))
    print(f"model: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
          f"{cfg.num_heads} heads, vocab {cfg.vocab_size}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"built in {time.monotonic() - t0:.2f} s")
    prompts = serve_prompts(cfg.vocab_size)
    budget = SERVE_BUDGET

    def engine(**kw):
        return ServingEngine(model, num_slots=SERVE_SLOTS, page_size=16,
                             **kw)

    def eager_engine(**kw):
        """The same engine with its paged step run eagerly (the graph
        dropped), for the profile's comparison only."""
        eng = engine(**kw)
        eng._decode_graph = None
        return eng

    warm = engine()
    warm.submit(prompts[0][:5], max_new_tokens=2)
    warm.run_until_idle()
    del warm
    eng = engine()
    # the parameters are trainable: every module call of the serving run
    # must see autograd off, and the pools must stay out of any graph
    grad_modes = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: grad_modes.append(torch.is_grad_enabled()))
        for m in model.modules()]
    torch.cuda.synchronize()
    pd.reset_launch_count()
    lh.reset_launch_count()
    kvc.reset_gather_view_count()
    t0 = time.monotonic()
    handles = [eng.submit(p, max_new_tokens=budget) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for hk in hooks:
        hk.remove()
    assert all(p.requires_grad for p in model.parameters())
    assert grad_modes and not any(grad_modes), "serving ran with autograd on"
    assert not (eng.pool.k.requires_grad or eng.pool.v.requires_grad)
    print(f"no autograd graph: {len(grad_modes)} module calls, all with "
          f"grad off; pools require no grad")
    launches = {"paged_decode_attention": pd.launch_count(),
                "lm_head_sample": lh.launch_count()}
    views = kvc.gather_view_count()
    st = eng.stats()
    bad = [(h.request_id, h.status, h.error) for h in handles
           if h.status != "completed" or len(h.tokens) != budget]
    assert not bad, f"requests not completed: {bad}"
    assert all(0 <= t < cfg.vocab_size for h in handles for t in h.tokens)
    steps = st["decode_steps"]
    print(f"launches {launches}, decode steps {steps}, prefills "
          f"{st['prefills']}, contiguous views {views}")
    assert launches["paged_decode_attention"] == cfg.num_layers * steps > 0
    assert steps == len(serve_decode_lengths(serve_lens)), \
        "phase 3 timed paged decode at other lengths than this run's"
    assert launches["lm_head_sample"] == steps > 0
    assert views == len(prompts), "decode built a contiguous K/V view"
    ttft = sorted(h.ttft_s for h in handles)
    print(f"served {len(handles)} requests, {st['tokens']} tokens in "
          f"{wall:.3f} s: {st['tokens'] / wall:.1f} tokens/s; median decode "
          f"step {st['decode_step_s_p50'] * 1e3:.3f} ms; TTFT p50 "
          f"{statistics.median(ttft) * 1e3:.2f} ms max {ttft[-1] * 1e3:.2f}"
          f" ms (8 slots, prompts 5-128 tokens, {budget} new tokens each)")

    assert eng._decode_graph.captured
    greedy_profile = (profile_decode(engine, prompts, "greedy, graph"),
                      profile_decode(eager_engine, prompts, "greedy, eager"))
    check_replay(engine, prompts, budget)

    probe = 11   # admitted in the second wave, into a reused slot
    alone = engine()
    h = alone.submit(prompts[probe], max_new_tokens=budget)
    alone.run_until_idle()
    assert h.tokens == handles[probe].tokens, \
        "stream served alone differs from the batched stream"
    print(f"batch invariance: request {probe} alone == batched "
          f"({budget} tokens, bitwise)")

    gather = engine(paged_decode=False, fused_sampling=False)
    gh = [gather.submit(p, max_new_tokens=budget) for p in prompts]
    gather.run_until_idle()
    same = sum(a.tokens == b.tokens for a, b in zip(handles, gh))
    first_diff = [next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                        if x != y), budget) for a, b in zip(handles, gh)]
    print(f"info: kernel path vs gather path (paged_decode=False, "
          f"fused_sampling=False): {same}/{len(gh)} streams identical, "
          f"mean first divergence at token "
          f"{statistics.mean(first_diff):.1f} of {budget}")

    cpu_model = copy.deepcopy(model).cpu()
    ref, logits = reference_greedy(cpu_model, prompts[0], 8)
    got = handles[0].tokens[:8]
    agreed = 0
    for t, (r, g) in enumerate(zip(ref, got)):
        if r == g:
            agreed += 1
            continue
        gap = float(logits[t][r] - logits[t][g])
        assert gap < 1e-3, (f"token {t}: engine chose {g}, CPU reference "
                            f"{r} with logit gap {gap}")
        break
    print(f"reference: first {agreed}/8 tokens of request 0 equal a CPU "
          f"full-recompute greedy run (any divergence only at a near-tie)")
    with torch.no_grad():
        ids = torch.tensor([prompts[0]])
        full_gpu = model(ids.cuda()).cpu()
        full_cpu = cpu_model(ids)
    lerr = (full_gpu - full_cpu).abs().max().item()
    print(f"reference: GPU vs CPU full-sequence logits max_abs_err "
          f"{lerr:.3e} tol 1e-3")
    assert torch.isfinite(full_gpu).all() and lerr <= 1e-3

    del cpu_model, eng, alone, gather
    modes = {m: serve_mode(engine, eager_engine, prompts, budget, cfg, pd,
                           lh, m) for m in ("temperature", "top_k")}
    modes["greedy"] = {"steps": steps, "tokens_per_s": st["tokens"] / wall,
                       "median_step_ms": st["decode_step_s_p50"] * 1e3,
                       "graph": greedy_profile[0],
                       "eager": greedy_profile[1]}
    for m, r in modes.items():
        busy = [("not measured" if b is None else
                 f"{b:.3f} ms busy of {ms:.3f} ({b / ms:.1%})")
                for ms, b in (r["graph"], r["eager"])]
        print(f"decode step {m}: graph {busy[0]}, eager {busy[1]}; "
              f"{r['tokens_per_s']:.1f} tokens/s, median step "
              f"{r['median_step_ms']:.3f} ms over the 16-request run")
    del model
    torch.cuda.empty_cache()

    phase("5 train: GPT-2 small")
    train_launches, flash_losses = train_phase(fl, ce, gpt_mod, smi)

    phase("6 train: BERT-large")
    bert_launches = bert_phase(fln, smi)

    phase("7 train: GPT-2 small, ring sp=4")
    ring_launches = ring_phase(fl, ce, gpt_mod, smi, flash_losses)

    phase("8 summary")
    f32, bf16 = torch.float32, torch.bfloat16
    kernels = [
        dict(name="paged_decode_attention", route="cuda",
             source="hetu_tpu_torch/csrc/paged_decode.cu",
             replaces="hetu_tpu/ops/pallas/paged_decode.py:59",
             launches=launches["paged_decode_attention"], **pd_rows[f32]),
        dict(name="lm_head_sample", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_sample.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:346",
             launches=launches["lm_head_sample"], **lm_rows[(f32, 1)]),
        dict(name="flash_fwd", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:191",
             launches=train_launches["flash_fwd"], **fl_rows[f32][0]),
        dict(name="flash_bwd", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:462",
             launches=train_launches["flash_bwd"], **fl_rows[f32][1]),
        dict(name="lm_head_ce_fwd", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:177",
             launches=train_launches["lm_head_ce_fwd"], **ce_rows[f32][0]),
        dict(name="lm_head_ce_bwd", route="cuda",
             source="hetu_tpu_torch/csrc/lm_head_ce.cu",
             replaces="hetu_tpu/ops/pallas/lm_head.py:202",
             launches=train_launches["lm_head_ce_bwd"], **ce_rows[f32][1]),
        dict(name="fused_ln_fwd", route="cuda",
             source="hetu_tpu_torch/csrc/fused_ln.cu",
             replaces="hetu_tpu/ops/pallas/fused_ln.py:122",
             launches=bert_launches["fused_ln_fwd"], **fln_rows[bf16][0]),
        dict(name="fused_ln_bwd", route="cuda",
             source="hetu_tpu_torch/csrc/fused_ln.cu",
             replaces="hetu_tpu/ops/pallas/fused_ln.py:147",
             launches=bert_launches["fused_ln_bwd"], **fln_rows[bf16][1]),
        dict(name="flash_block_fwd", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:608",
             launches=ring_launches["flash_block_fwd"],
             **ring_mix(blk_rows[f32], 0)),
        dict(name="flash_block_bwd", route="cuda",
             source="hetu_tpu_torch/csrc/flash_attn.cu",
             replaces="hetu_tpu/ops/pallas/flash.py:619",
             launches=ring_launches["flash_block_bwd"],
             **ring_mix(blk_rows[f32], 1)),
    ]
    print_predictions({
        ("flash_fwd", f32): fl_rows[f32][0],
        ("flash_bwd", f32): fl_rows[f32][1],
        ("flash_fwd", bf16): fl_rows[bf16][0],
        ("flash_bwd", bf16): fl_rows[bf16][1],
        ("flash_block_fwd", f32): ring_mix(blk_rows[f32], 0),
        ("flash_block_bwd", f32): ring_mix(blk_rows[f32], 1),
        ("paged_decode_attention", f32): pd_rows[f32],
        ("paged_decode_attention", bf16): pd_rows[bf16],
        ("fused_ln_bwd", f32): fln_rows[f32][1],
        ("fused_ln_bwd", bf16): fln_rows[bf16][1],
        ("lm_head_sample", f32): lm_rows[(f32, 1)],
        ("lm_head_sample", bf16): lm_rows[(bf16, 1)]})
    for dt in (f32, bf16):
        one, five = lm_rows[(dt, 1)]["ms"], lm_rows[(dt, 5)]["ms"]
        print(f"prediction: lm_head_sample {dt} k=5 {five:.4f} ms, "
              f"{five / one - 1:+.1%} over k=1 (predicted within 15%)")
    r = pd_rows[f32]
    n = launches["paged_decode_attention"]
    print(f"paged_decode over phase 4's run: {n} launches x "
          f"{r['serve_ms']:.4f} ms = {n * r['serve_ms']:.3f} ms, "
          f"{n * (r['serve_ms'] - r['serve_bound_ms']):.3f} ms above the "
          f"bound ({n} x {r['serve_bound_ms']:.4f} ms)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""PipeDream 1F1B schedules (counterpart of
``hetu_tpu/parallel/pipedream.py``): synchronous 1F1B with interleaved
virtual stages, asynchronous PipeDream with weight stashing, and
HetPipe's gradient mean over data-parallel replicas.

The JAX package runs the schedule as one SPMD program over the ``pp``
mesh axis, three ``lax.scan``s over ticks (warm-up forwards, the steady
1F1B ticks, the drain of backwards, :func:`_phase_bounds`).  The port
runs the same timetable on a local mesh, every rank of the ``pp`` (and
``dp_axis``) axes in turn within each tick on the mesh's device:

* stage ``d`` forwards microbatch ``m`` of chunk ``v`` at the tick
  ``t = g*S*V + v*S + r + d`` (``m = g*S + r``) and runs its backward at
  the mirror tick (``_decode_fwd`` / ``_decode_bwd``); at each tick's end
  the activations move one stage along the forward ring and their
  gradients along the reverse ring (``parallel.collectives.ppermute``
  over the ranks' list: a re-index);
* a forward runs without autograd and stashes its input; the backward
  recomputes the stage's forward against the stashed input under
  autograd, as the JAX ``jax.vjp`` does, seeded with the loss at the
  last virtual stage and with the ring's message elsewhere;
* **asynchronous** (:func:`pipedream_train_step`): ``K = 2S - 1`` weight
  versions are stashed, each a copy (the port's optimizers update their
  tensors in place, so a reference would turn into the newest version);
  a backward replays the version its forward used, and every valid
  backward applies ``opt.update`` to the stage's current weights, which
  later forwards use.  With ``dp_axis`` each gradient is first the mean
  over the replicas (HetPipe), applied once to the weights the
  replicas share on the one device;
* **synchronous** (:func:`pipedream_grads`): the weights stay, the
  gradients accumulate per chunk, the result is the mean over
  microbatches (and replicas).

``stage_params`` is stacked tensors as in JAX (leaves ``[S*V, ...]``,
device-major for ``V > 1``: :func:`interleave_stages`) or a list of the
``S*V`` (virtual) stages' parameters, each a dict of tensors or an
``nn.Module`` (a stage's blocks); ``stage_fn(params, h, extras_mb)``
gets one of them.  Gradients come back in the same form (a list of
``{name: tensor}`` dicts for modules).  Updates are in place: the
asynchronous step returns ``stage_params`` and ``opt_state`` themselves,
scalar state (``step``) advanced by M.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from hetu_tpu_torch.parallel import collectives as col

__all__ = ["pipedream_grads", "pipedream_train_step", "interleave_stages",
           "uninterleave_stages", "pipedream_schedule_stats"]


def _microbatch(x, M, name):
    if x.shape[0] % M:
        raise ValueError(
            f"{name} batch {x.shape[0]} not divisible by {M} microbatches")
    return x.reshape(M, x.shape[0] // M, *x.shape[1:])


def _phase_bounds(S: int, V: int, M: int):
    """The three-phase schedule's static tick boundaries: [0, T1) is
    forward-only warmup, [T1, T2) steady 1F1B (T2 = last forward + 1),
    [T2, T3) backward-only drain."""
    SV = S * V
    g_last, r_last = divmod(M - 1, S)
    t_last = g_last * SV + (V - 1) * S + r_last + (S - 1)
    return SV - 1, t_last + 1, SV - 1 + t_last + 1


def _decode(a: int, S: int, V: int, M: int):
    """``(valid, m, chunk index from the front)`` of the timetable
    offset ``a`` (the unique decomposition ``a = g*S*V + v*S + r``)."""
    if a < 0:
        return False, 0, 0
    rem = a % (S * V)
    m = (a // (S * V)) * S + rem % S
    return m < M, min(m, M - 1), rem // S


def _decode_fwd(t, stage, S, V, M):
    return _decode(t - stage, S, V, M)


def _decode_bwd(t, stage, S, V, M):
    ok, m, v = _decode(t - (S * V - 1) - (S - 1 - stage), S, V, M)
    return ok, m, V - 1 - v


# -- stage parameters ---------------------------------------------------------


def _flat(tree, prefix=""):
    """``[(name, tensor)]`` of a dict tree's tensor leaves, in order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _flat(v, f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def _rebuild(tree, leaves: list):
    it = iter(leaves)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        return next(it)
    return rec(tree)


def _leading(stage_params) -> set:
    if isinstance(stage_params, (list, tuple, nn.ModuleList)):
        return {len(stage_params)}
    return {t.shape[0] for _, t in _flat(stage_params)}


class _Chunks:
    """The ``S*V`` (virtual) stages' parameters: position ``p`` (device
    ``p // V``, chunk ``p % V``), its named leaves, and a run of the
    stage function against given leaf values."""

    def __init__(self, stage_params, n: int):
        self.stacked = not isinstance(stage_params,
                                      (list, tuple, nn.ModuleList))
        self.params = stage_params
        if self.stacked:
            self.items = [_rebuild(stage_params, [t[p] for _, t in
                                                  _flat(stage_params)])
                          for p in range(n)]
        else:
            self.items = list(stage_params)

    def named(self, p: int) -> list:
        item = self.items[p]
        if isinstance(item, nn.Module):
            return list(item.named_parameters())
        return _flat(item)

    @contextlib.contextmanager
    def running(self, p: int, values: Optional[list]):
        """``(params object, leaves to differentiate)`` of position
        ``p`` with its leaves set to ``values`` (None: as they are)."""
        item, named = self.items[p], self.named(p)
        if isinstance(item, nn.Module):
            saved = [t.data for _, t in named]
            if values is not None:
                for (_, t), v in zip(named, values):
                    t.data = v
            try:
                yield item, [t for _, t in named]
            finally:
                for (_, t), v in zip(named, saved):
                    t.data = v
            return
        vals = [t for _, t in named] if values is None else values
        leaves = [v.detach().requires_grad_() for v in vals]
        yield _rebuild(item, leaves), leaves

    def result(self, grads: list):
        """Per-position gradient lists in ``stage_params``' form."""
        if not self.stacked:
            return [dict((n, g) for (n, _), g in zip(self.named(p), gs))
                    for p, gs in enumerate(grads)]
        leaves = [torch.stack([grads[p][j] for p in range(len(grads))])
                  for j in range(len(grads[0]))]
        return _rebuild(self.params, leaves)


def _stage_state(opt_state, chunks: _Chunks, p: int):
    """Stage ``p``'s optimizer state: a list's entry, or views of the
    stacked slots (every key but ``step`` mirrors the parameters)."""
    if isinstance(opt_state, (list, tuple)):
        return opt_state[p]
    names = [n for n, _ in chunks.named(p)]
    out = {}
    for k, v in opt_state.items():
        if k == "step":
            out[k] = v
            continue
        flat = dict(_flat(v))
        if sorted(flat) != sorted(names):
            raise NotImplementedError(
                f"optimizer state {k!r} does not mirror the stage "
                f"parameters {names}")
        out[k] = {n: flat[n][p] for n in names}
    return out


# -- the schedule --------------------------------------------------------------


def _run_1f1b(stage_fn, loss_fn, stage_params, opt, opt_state, x, y, extras,
              *, mesh, axis: str, n_microbatches: int,
              dp_axis: Optional[str], mode: str, virtual_stages: int = 1):
    from hetu_tpu_torch.parallel.mesh import LocalMesh, MeshSpec
    if hasattr(mesh, "group"):
        raise NotImplementedError(
            "the 1F1B schedules run on a local mesh (every stage on this "
            "process's device); across processes a pipeline runs as "
            "GPipe under a sharding strategy (parallel.pipeline)")
    S, V, M = mesh.shape[axis], virtual_stages, n_microbatches
    if V < 1:
        raise ValueError(f"virtual_stages must be >= 1, got {V}")
    if V > 1 and mode == "async":
        raise NotImplementedError(
            "interleaved virtual stages are a synchronous-schedule feature "
            "(pipedream_grads); asynchronous per-microbatch updates with "
            "chunked weight versions are not defined by the reference "
            "semantics")
    E = mesh.shape[dp_axis] if dp_axis is not None else 1
    SV = S * V
    K = max(2 * S - 1, 1) if V == 1 else 2 * S
    T1, T2, T3 = _phase_bounds(S, V, M)
    ring = LocalMesh(MeshSpec(pp=S, dp=E), mesh.device)
    R = S * E                          # rank r = d * E + e
    fwd_ring = [(i, (i + 1) % S) for i in range(S)]
    bwd_ring = [(i, (i - 1) % S) for i in range(S)]
    chunks = _Chunks(stage_params, SV)

    def split(t, name):
        parts = _microbatch(t, M, name)
        if E == 1:
            return [parts]
        if parts.shape[1] % E:
            raise ValueError(f"{name} microbatch {parts.shape[1]} not "
                             f"divisible by dp={E}")
        return list(parts.chunk(E, dim=1))

    xs, ys = split(x, "x"), split(y, "y")
    exs = None if extras is None else [
        {k: split(v, "extras")[e] for k, v in extras.items()}
        if isinstance(extras, dict) else split(extras, "extras")[e]
        for e in range(E)]

    def ex_at(e, m):
        if exs is None:
            return None
        ex = exs[e]
        return ({k: v[m] for k, v in ex.items()} if isinstance(ex, dict)
                else ex[m])

    h_shape = xs[0].shape[1:]
    dev, h_dtype = x.device, x.dtype
    zeros = lambda: torch.zeros(h_shape, dtype=h_dtype, device=dev)  # noqa: E731
    stash_h = [{} for _ in range(R)]
    fmsg = [zeros() for _ in range(R)]
    bmsg = [zeros() for _ in range(R)]
    loss_acc = [torch.zeros((), dtype=torch.float32, device=dev)
                for _ in range(R)]
    if mode == "async":
        stash_W = [{} for _ in range(S)]
        ost = [_stage_state(opt_state, chunks, d) for d in range(S)]
    else:
        gsum = [[None] * V for _ in range(R)]

    for t in range(T3):
        if t < T2:                                     # forwards
            outs = []
            for r in range(R):
                d, e = divmod(r, E)
                ok, m, v = _decode_fwd(t, d, S, V, M)
                if not ok:
                    outs.append(zeros())
                    continue
                p = d * V + v
                h_in = xs[e][m] if d == 0 and v == 0 else fmsg[r]
                stash_h[r][v * K + m % K] = h_in
                if mode == "async" and e == 0:
                    stash_W[d][m % K] = _version(chunks.named(p))
                with torch.no_grad(), chunks.running(p, None) as (W, _):
                    outs.append(stage_fn(W, h_in, ex_at(e, m)))
            fmsg = col.ppermute(outs, fwd_ring, "pp", mesh=ring)
        if t >= T1:                                    # backwards
            dhs, dws = [], [None] * R
            for r in range(R):
                d, e = divmod(r, E)
                ok, m, v = _decode_bwd(t, d, S, V, M)
                if not ok:
                    dhs.append(zeros())
                    continue
                p = d * V + v
                is_last = d == S - 1 and v == V - 1
                version = stash_W[d][m % K] if mode == "async" else None
                hh = stash_h[r][v * K + m % K].detach().requires_grad_()
                with torch.enable_grad(), \
                        chunks.running(p, version) as (W, leaves):
                    out = stage_fn(W, hh, ex_at(e, m))
                    want = [w for w in leaves if w.requires_grad] + [hh]
                    if is_last:
                        loss = loss_fn(out, ys[e][m]).float()
                        got = torch.autograd.grad(loss, want,
                                                  allow_unused=True)
                        loss_acc[r] = loss_acc[r] + loss.detach()
                    else:
                        got = torch.autograd.grad(out, want,
                                                  bmsg[r].to(out.dtype),
                                                  allow_unused=True)
                it = iter(got[:-1])
                dws[r] = [(next(it) if w.requires_grad else None)
                          for w in leaves]
                dws[r] = [torch.zeros_like(w) if g is None else g
                          for w, g in zip(leaves, dws[r])]
                dhs.append(torch.zeros_like(hh) if got[-1] is None
                           else got[-1].to(h_dtype))
                if mode == "sync":
                    acc = gsum[r][v]
                    gsum[r][v] = ([g.float() for g in dws[r]] if acc is None
                                  else [a + g for a, g in zip(acc, dws[r])])
            if mode == "async":
                _apply(opt, ost, chunks, dws, t, S, E, V, M, ring)
            bmsg = col.ppermute(dhs, bwd_ring, "pp", mesh=ring)

    per_e = [loss_acc[(S - 1) * E + e] / M for e in range(E)]
    loss = per_e[0] if E == 1 else sum(per_e) / E
    if mode == "async":
        if isinstance(opt_state, dict) and "step" in opt_state:
            opt_state["step"] = ost[0]["step"]
        return loss, stage_params, opt_state
    flats = []
    for r in range(R):
        flats.append(torch.cat([g.reshape(-1) for v in range(V)
                                for g in gsum[r][v]]) / M)
    if E > 1:
        flats = col.all_reduce_mean(flats, "dp", mesh=ring)
    grads = [None] * SV
    for d in range(S):
        flat, off = flats[d * E], 0
        for v in range(V):
            out = []
            for g in gsum[d * E][v]:
                out.append(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
            grads[d * V + v] = out
    return loss, chunks.result(grads)


def _version(named: list) -> list:
    """A stashed weight version: copies, since the optimizers update the
    stage's tensors in place."""
    return [w.detach().clone() for _, w in named]


def _apply(opt, ost, chunks, dws, t, S, E, V, M, ring):
    """The asynchronous step's updates at tick ``t``: each stage's
    gradient, the mean over its replicas where dp > 1, applied once to
    the weights the replicas share."""
    if E > 1:
        flats, shapes = [], []
        for r in range(len(dws)):
            d = r // E
            ok = _decode_bwd(t, d, S, V, M)[0]
            gs = dws[r] if ok else [torch.zeros_like(w) for _, w in
                                    chunks.named(d)]
            shapes.append(gs)
            flats.append(torch.cat([g.reshape(-1) for g in gs]))
        red = col.all_reduce_mean(flats, "dp", mesh=ring)
        for r in range(len(dws)):
            if dws[r] is not None:
                off, out = 0, []
                for g in shapes[r]:
                    out.append(red[r][off:off + g.numel()].view_as(g))
                    off += g.numel()
                dws[r] = out
    for d in range(S):
        g = dws[d * E]
        if g is None:
            continue
        named = chunks.named(d)
        opt.update({n: gi for (n, _), gi in zip(named, g)}, ost[d],
                   {n: w for n, w in named})


def _permute_stages(stacked, perm, S, V, who):
    if isinstance(stacked, (list, tuple, nn.ModuleList)):
        if len(stacked) != S * V:
            raise ValueError(f"{who}: {len(stacked)} stages != S*V = "
                             f"{S * V} (S={S}, V={V})")
        return [stacked[p] for p in perm]

    def apply(t):
        # a wrong leading dim would gather wrong rows: refuse it
        if t.shape[0] != S * V:
            raise ValueError(
                f"{who}: leaf leading dim {t.shape[0]} != S*V = {S * V} "
                f"(S={S}, V={V})")
        return t[torch.as_tensor(perm, device=t.device)]
    return _rebuild(stacked, [apply(t) for _, t in _flat(stacked)])


def interleave_stages(stacked, S: int, V: int):
    """Depth-order stage parameters (stacked ``[S*V, ...]`` leaves or a
    list, virtual stage ``u`` at index ``u``) -> the device-major layout
    the schedule reads (position ``d*V + v`` holds virtual stage
    ``u = v*S + d``)."""
    perm = [(p % V) * S + p // V for p in range(S * V)]
    return _permute_stages(stacked, perm, S, V, "interleave_stages")


def uninterleave_stages(stacked, S: int, V: int):
    """Inverse of :func:`interleave_stages` (device-major -> depth
    order); apply to the gradients ``pipedream_grads(virtual_stages=V)``
    returns."""
    perm = [(u % S) * V + u // S for u in range(S * V)]
    return _permute_stages(stacked, perm, S, V, "uninterleave_stages")


def pipedream_schedule_stats(S: int, V: int, M: int,
                             f_cost: float = 1.0, b_cost: float = 2.0):
    """Tick counts and bubble fraction of the three-phase schedule
    (``f_cost`` / ``b_cost``: a forward-only and a backward-only tick's
    relative cost; the backward recomputes the forward, hence 2)."""
    t1, t2, t3 = _phase_bounds(S, V, M)
    total = t1 * f_cost + (t2 - t1) * (f_cost + b_cost) + (t3 - t2) * b_cost
    ideal = M * V * (f_cost + b_cost)
    return {"warmup_ticks": t1, "steady_ticks": t2 - t1,
            "drain_ticks": t3 - t2, "total_ticks": t3,
            "bubble_fraction": 1.0 - ideal / total}


def pipedream_grads(stage_fn, loss_fn, stage_params, x, y, extras=None, *,
                    mesh, axis: str = "pp", n_microbatches: int,
                    dp_axis: Optional[str] = None, virtual_stages: int = 1):
    """Synchronous 1F1B: ``(loss, grads)`` of the mean-over-microbatches
    loss, ``grads`` in ``stage_params``' form.  ``loss_fn(out, y_mb)``
    runs on the last virtual stage's output.  ``virtual_stages=V > 1``
    interleaves V chunks per device: ``stage_params`` in the device-major
    order :func:`interleave_stages` gives, the gradients mapped back
    with :func:`uninterleave_stages`."""
    want = mesh.shape[axis] * virtual_stages
    leading = _leading(stage_params)
    if leading != {want}:
        raise ValueError(
            f"stage_params leading dims {sorted(leading)} != S*V = {want} "
            f"(S={mesh.shape[axis]}, virtual_stages={virtual_stages}); "
            "for V > 1 build device-major params with interleave_stages()")
    return _run_1f1b(stage_fn, loss_fn, stage_params, None, None, x, y,
                     extras, mesh=mesh, axis=axis,
                     n_microbatches=n_microbatches, dp_axis=dp_axis,
                     mode="sync", virtual_stages=virtual_stages)


def pipedream_train_step(stage_fn, loss_fn, opt, stage_params, opt_state, x,
                         y, extras=None, *, mesh, axis: str = "pp",
                         n_microbatches: int, dp_axis: Optional[str] = None):
    """Asynchronous PipeDream step with weight stashing:
    ``(mean_loss, stage_params, opt_state)``, both updated in place (a
    list of per-stage states for a list of stages, else one state whose
    slots mirror the stacked parameters); every microbatch is an
    optimizer step of each stage, so ``step`` advances by
    ``n_microbatches``."""
    want = mesh.shape[axis]
    leading = _leading(stage_params)
    if leading != {want}:
        raise ValueError(f"stage_params leading dims {sorted(leading)} != "
                         f"S = {want}")
    return _run_1f1b(stage_fn, loss_fn, stage_params, opt, opt_state, x, y,
                     extras, mesh=mesh, axis=axis,
                     n_microbatches=n_microbatches, dp_axis=dp_axis,
                     mode="async")

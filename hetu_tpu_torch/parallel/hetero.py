"""Heterogeneous data parallelism: unequal dp degrees across pipeline
stages (counterpart of ``hetu_tpu/parallel/hetero.py``).

The JAX package gives each stage a submesh of its own devices, its
parameters replicated there and each microbatch split over them, and
moves an activation to the next stage with one ``jax.device_put`` onto
that stage's sharding.  The port gives a :class:`HeteroStage` a list of
torch devices, one per replica: a microbatch's rows split over them in
order and each replica runs the stage function on its rows on its
device; one card named ``d_s`` times runs ``d_s`` replicas in turn.
:class:`HeteroPipeline` runs GPipe over the stages on the host: every
microbatch's forward (each stage's input stashed), then each
microbatch's backward from the last stage to the first, the stage's
forward recomputed under autograd, the gradients accumulated over
microbatches.  A stage's gradient is the **sum** over its replicas:
each replica's part of the output gradient already carries its rows'
share of the loss, as GSPMD's transpose of the split batch gives it.

:func:`plan_hetero_dp` is the planning half: devices split over the
stages in proportion to their costs.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

import torch
from torch import nn

from hetu_tpu_torch.parallel.pipedream import _flat, _microbatch, _rebuild

__all__ = ["HeteroStage", "HeteroPipeline", "plan_hetero_dp"]


def plan_hetero_dp(stage_costs: Sequence[float], n_devices: int) -> list:
    """Allocate ``n_devices`` across stages proportionally to per-stage
    cost, at least 1 device per stage; greedy largest remainder so the
    total is exact."""
    k = len(stage_costs)
    if n_devices < k:
        raise ValueError(f"{n_devices} devices < {k} stages")
    total = float(sum(stage_costs)) or 1.0
    raw = [max(c / total * n_devices, 1.0) for c in stage_costs]
    alloc = [max(1, int(r)) for r in raw]
    while sum(alloc) < n_devices:
        i = max(range(k), key=lambda j: raw[j] - alloc[j])
        alloc[i] += 1
    while sum(alloc) > n_devices:
        i = max(range(k), key=lambda j: alloc[j] - raw[j] if alloc[j] > 1
                else -math.inf)
        alloc[i] -= 1
    return alloc


def _named(params) -> list:
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    return _flat(params)


class HeteroStage:
    """One pipeline stage with its own dp degree: ``len(devices)``
    replicas.  ``fn(params, h, extras) -> h'``; ``params`` is a dict of
    tensors or an ``nn.Module``, on the stage's device (the devices must
    name one device, as one card holds every replica here)."""

    def __init__(self, fn: Callable, params: Any, devices: Sequence,
                 *, batch_ndim_sharded: bool = True):
        devs = {torch.device(d) for d in devices}
        if len(devs) != 1:
            raise NotImplementedError(
                f"a stage's replicas on {sorted(map(str, devs))}: the "
                f"port's replicas of one stage share one device")
        self.fn = fn
        self.dp = len(devices)
        self.device = devs.pop()
        self.batch_ndim_sharded = batch_ndim_sharded
        if isinstance(params, nn.Module):
            self.params = params.to(self.device)
        else:
            self.params = _rebuild(params, [
                torch.as_tensor(t).to(self.device) for _, t in
                _flat(params)])

    def take(self, h):
        """An activation from another stage on this stage's device; its
        (micro)batch must split over the stage's replicas."""
        if (self.batch_ndim_sharded and getattr(h, "ndim", 0) > 0
                and h.shape[0] % self.dp):
            raise ValueError(
                f"(micro)batch dim {h.shape[0]} not divisible by this "
                f"stage's dp={self.dp}; pick dp degrees that divide the "
                f"microbatch size (plan_hetero_dp output may need rounding "
                f"to divisors)")
        return h.to(self.device)

    def _rows(self, t):
        if not self.batch_ndim_sharded or t is None:
            return [t] * self.dp
        return list(t.chunk(self.dp, 0))

    def _ex_rows(self, extras):
        if extras is None:
            return [None] * self.dp
        if isinstance(extras, dict):
            parts = {k: self._rows(v) for k, v in extras.items()}
            return [{k: v[i] for k, v in parts.items()}
                    for i in range(self.dp)]
        return self._rows(extras)

    @torch.no_grad()
    def _fwd(self, h, extras=None):
        outs = [self.fn(self.params, hr, er) for hr, er in
                zip(self._rows(h), self._ex_rows(extras))]
        return torch.cat(outs, 0) if self.batch_ndim_sharded else outs[0]

    def _bwd(self, h, extras, ct):
        """``(dparams, dh)``: the stage's forward recomputed per replica
        under autograd, its parameter gradients summed over the
        replicas."""
        named = _named(self.params)
        dW, dh = None, []
        for hr, er, cr in zip(self._rows(h), self._ex_rows(extras),
                              self._rows(ct)):
            hh = hr.detach().requires_grad_()
            with torch.enable_grad():
                if isinstance(self.params, nn.Module):
                    leaves = [t for _, t in named]
                    out = self.fn(self.params, hh, er)
                else:
                    leaves = [t.detach().requires_grad_() for _, t in named]
                    out = self.fn(_rebuild(self.params, leaves), hh, er)
                want = [w for w in leaves if w.requires_grad] + [hh]
                got = torch.autograd.grad(out, want, cr, allow_unused=True)
            it = iter(got[:-1])
            gs = [(next(it) if w.requires_grad else None) for w in leaves]
            gs = [torch.zeros_like(w) if g is None else g
                  for w, g in zip(leaves, gs)]
            dW = gs if dW is None else [a + b for a, b in zip(dW, gs)]
            dh.append(torch.zeros_like(hh) if got[-1] is None else got[-1])
        return ({n: g for (n, _), g in zip(named, dW)},
                torch.cat(dh, 0) if self.batch_ndim_sharded else dh[0])

    def forward(self, h, extras=None):
        return self._fwd(self.take(h), extras)

    def backward(self, h, ct, extras=None):
        return self._bwd(self.take(h), extras, self.take(ct))


class HeteroPipeline:
    """GPipe-scheduled pipeline over stages with unequal dp degrees.
    ``loss_fn(out, y_mb) -> scalar`` runs on the last stage's output;
    ``step`` applies ``opt`` to each stage (in place) with the gradients
    averaged over microbatches."""

    def __init__(self, stages: Sequence[HeteroStage], loss_fn: Callable,
                 opt=None):
        self.stages = list(stages)
        self.loss_fn = loss_fn
        self.opt = opt
        self.opt_states = ([opt.init(_named(s.params)) for s in self.stages]
                           if opt else None)

    def _loss_head(self, last, h, ex, y):
        """The last stage's microbatch loss and its output's gradient:
        the seed of the backward wave."""
        out = last._fwd(h, ex).detach().requires_grad_()
        with torch.enable_grad():
            loss = self.loss_fn(out, y)
            ct, = torch.autograd.grad(loss, out)
        return loss.detach(), ct

    def forward(self, x, extras=None):
        h = x
        for s in self.stages:
            h = s.forward(h, extras)
        return h

    def grads(self, x, y, extras=None, *, n_microbatches: int = 1):
        """``(mean loss, per-stage gradients)`` of the mean-over-microbatch
        loss; ``extras`` (batch-leading tensors) are cut into microbatches
        as ``x`` and ``y`` are.  Each stage's gradients are ``{name:
        tensor}``, named as its parameters."""
        M = n_microbatches
        xs = _microbatch(x, M, "x")
        ys = _microbatch(y, M, "y")
        exs = None if extras is None else (
            {k: _microbatch(v, M, "extras") for k, v in extras.items()}
            if isinstance(extras, dict) else _microbatch(extras, M,
                                                         "extras"))

        def ex_at(m):
            if exs is None:
                return None
            return ({k: v[m] for k, v in exs.items()}
                    if isinstance(exs, dict) else exs[m])

        S = len(self.stages)
        stashes = [[None] * S for _ in range(M)]
        for m in range(M):                       # forward wave
            h = xs[m]
            for si, s in enumerate(self.stages):
                h = s.take(h)
                stashes[m][si] = h
                h = s._fwd(h, ex_at(m))
        gsum = [None] * S
        losses = []
        last = self.stages[-1]
        for m in range(M):                       # backward wave
            loss, ct = self._loss_head(last, stashes[m][S - 1], ex_at(m),
                                       last.take(ys[m]))
            losses.append(loss)
            for si in range(S - 1, -1, -1):
                s = self.stages[si]
                dW, ct = s._bwd(stashes[m][si], ex_at(m), s.take(ct))
                gsum[si] = dW if gsum[si] is None else {
                    k: gsum[si][k] + dW[k] for k in dW}
        grads = [{k: g / M for k, g in gs.items()} for gs in gsum]
        return float(sum(float(l) for l in losses)) / M, grads

    def step(self, x, y, extras=None, *, n_microbatches: int = 1):
        """One synchronous training step; returns the mean microbatch
        loss."""
        if self.opt is None:
            raise ValueError("construct HeteroPipeline with an optimizer")
        loss, grads = self.grads(x, y, extras, n_microbatches=n_microbatches)
        for si, s in enumerate(self.stages):
            self.opt.update(grads[si], self.opt_states[si],
                            dict(_named(s.params)))
        return loss

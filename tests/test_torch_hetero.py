"""The port's heterogeneous data parallelism
(``hetu_tpu_torch.parallel.hetero``) against the JAX package's at
``tests/test_hetero.py``'s sizes: ``plan_hetero_dp`` over a grid, and a
pipeline of three stages at dp 4 / 2 / 2 (the JAX stages on the suite's
virtual CPU devices, the port's replicas in turn on the CPU): forward
1e-6, loss 1e-5, gradients 1e-4, then ``step`` against the JAX step;
the gradient is the sum over a stage's replicas, and a control that
averages them must leave the JAX gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.optim import SGDOptimizer as JSGD
from hetu_tpu.parallel import hetero as J
from hetu_tpu_torch.optim import SGDOptimizer
from hetu_tpu_torch.parallel import hetero as T


def test_plan_hetero_dp_equals_jax():
    for costs in ([1, 1], [3, 1], [1, 1, 1], [100, 1, 1], [2, 1, 1],
                  [0, 0], [5, 3, 2, 1], [1.5, 2.5]):
        for n in range(len(costs), 13):
            assert T.plan_hetero_dp(costs, n) == J.plan_hetero_dp(costs, n)
    with pytest.raises(ValueError):
        T.plan_hetero_dp([1, 1, 1], 2)


def _jfn(W, h, ex):
    return jnp.tanh(h @ W["w"] + W["b"]) + h


def _tfn(W, h, ex):
    return torch.tanh(h @ W["w"] + W["b"]) + h


def _jloss(out, y):
    return jnp.mean((out - y) ** 2)


def _tloss(out, y):
    return torch.mean((out - y) ** 2)


def _plist():
    rng = np.random.default_rng(0)
    return [{"w": rng.normal(0, 0.4, (8, 8)).astype(np.float32),
             "b": rng.normal(0, 0.1, (8,)).astype(np.float32)}
            for _ in range(3)]


def _pipes(opt=False):
    devs = jax.devices()
    plist = _plist()
    groups = [devs[0:4], devs[4:6], devs[6:8]]
    jst = [J.HeteroStage(_jfn, {k: jnp.asarray(v) for k, v in p.items()}, g)
           for p, g in zip(plist, groups)]
    tst = [T.HeteroStage(_tfn, {k: torch.tensor(v) for k, v in p.items()},
                         ["cpu"] * n) for p, n in zip(plist, (4, 2, 2))]
    return (J.HeteroPipeline(jst, _jloss, JSGD(0.05) if opt else None),
            T.HeteroPipeline(tst, _tloss, SGDOptimizer(0.05) if opt
                             else None))


def _data(seed, B=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 8)).astype(np.float32),
            rng.normal(size=(B, 8)).astype(np.float32))


def test_forward_equals_jax():
    jp, tp = _pipes()
    x, _ = _data(1, 8)
    np.testing.assert_allclose(tp.forward(torch.tensor(x)).numpy(),
                               np.asarray(jp.forward(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    assert [s.dp for s in tp.stages] == [4, 2, 2]
    with pytest.raises(ValueError, match="dp=4"):
        tp.stages[0].take(torch.zeros(6, 8))


@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_grads_equal_jax(combine, monkeypatch):
    jp, tp = _pipes()
    x, y = _data(2)
    jl, jg = jp.grads(jnp.asarray(x), jnp.asarray(y), n_microbatches=4)
    if combine == "mean":
        # the control: replicas' gradients averaged instead of summed
        orig = T.HeteroStage._bwd

        def mean_bwd(self, h, ex, ct):
            dW, dh = orig(self, h, ex, ct)
            return {k: g / self.dp for k, g in dW.items()}, dh
        monkeypatch.setattr(T.HeteroStage, "_bwd", mean_bwd)
    tl, tg = tp.grads(torch.tensor(x), torch.tensor(y), n_microbatches=4)
    assert isinstance(tl, float) and isinstance(jl, float)
    gap = max(np.max(np.abs(tg[s][k].numpy() - np.asarray(jg[s][k])))
              for s in range(3) for k in ("w", "b"))
    if combine == "mean":
        assert gap > 1e-3, gap
        return
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for s in range(3):
        for k in ("w", "b"):
            np.testing.assert_allclose(tg[s][k].numpy(),
                                       np.asarray(jg[s][k]), rtol=1e-4,
                                       atol=1e-6)


def test_steps_equal_jax():
    jp, tp = _pipes(opt=True)
    x, y = _data(3)
    y = y * 0.1
    jl = [jp.step(jnp.asarray(x), jnp.asarray(y), n_microbatches=4)
          for _ in range(3)]
    tl = [tp.step(torch.tensor(x), torch.tensor(y), n_microbatches=4)
          for _ in range(3)]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for js, ts in zip(jp.stages, tp.stages):
        for k in ("w", "b"):
            np.testing.assert_allclose(ts.params[k].numpy(),
                                       np.asarray(js.params[k]), rtol=1e-4,
                                       atol=1e-6)

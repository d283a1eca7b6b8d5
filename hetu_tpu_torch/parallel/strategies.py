"""Distribution strategies (counterpart of
``hetu_tpu/parallel/strategies.py``).

A strategy is the JAX package's: a mesh, the logical-axis rules, the
batch's axis and a ZeRO stage.  Where the JAX ``install`` hands GSPMD
the placements and lets it insert the collectives, the port's
:meth:`ShardingStrategy.install` cuts the model into the ranks this
process holds (:class:`ShardedModel`) and the step runs the collectives
itself, each one counted (``parallel.collectives.counts``):

* **Placement.**  Each parameter's physical spec comes from its module's
  logical axes and the rules (``parallel.spec``); a rank's module holds
  its tp shard and knows its tensor-parallel role from the specs
  (``_tp_setup``: column / row-parallel MHA and MLP, the vocabulary-
  parallel embedding and head, a column-parallel ``Linear`` under
  ``OWT_RULES``).  A module whose parameters a rule shards over tp and
  that has no such path is refused: a tp-sharded convolution
  (``CNN_MP_RULES``' ``conv_out``) waits for ROADMAP queue 1 item 10
  part 7.
* **Data parallelism.**  The batch's leading dimension splits over
  ``batch_axes`` (``"dp"``, or a tuple such as ``("dp", "ep")``, cut
  first name outermost as ``P(("dp", "ep"))`` cuts it), each rank's
  forward and backward run on its piece (``parallel.ranks.run_ranks``),
  and the gradients go through ``all_reduce_mean`` over the batch axes
  or, where ZeRO shards the parameter, ``reduce_scatter`` over dp
  (stages 1 and 2: one flat bucket per kind; stage 3: below).  The
  reported loss is the mean over the batch axes of the ranks' losses.
* **Expert parallelism** (``ep`` among the batch axes).  The rules place
  the stacked experts over ``ep`` (``"experts": "ep"``), and
  ``install`` binds each rank's ``MoELayer`` to its rank
  (``_ep_setup``): the layer gathers the reference's routing block from
  the pieces that hold it and runs the exchange over ``ep``
  (``layers.moe``).  Each token counts once: a parameter replicated over
  the batch axes gets the mean over all of them; an expert slice, whose
  gradient already holds the tokens of every ep rank (the exchange's
  backward) but only its replica's share of them, gets the sum over the
  batch axes it is replicated on divided by the pieces (the mean over
  ``dp``, divided by ``ep``).
* **ZeRO** (``zero_stage``): 1 and 2 shard the optimizer slots' first
  dimension in the JAX layout (``_zero_shard``: the JAX package's rule,
  applied where the dimension is not already sharded and divides over
  dp); each rank updates its slice of the parameter with the port's
  optimizer and the slices are all-gathered back.  Stage 3 shards the
  parameters the same way: a rank's module holds only its slices.  A
  forward pre-hook on each module that owns some gathers them over dp
  (one bucket per module) just before the module runs, the root
  module's own ones when the rank's function starts (a model's methods,
  ``GPT.loss``, use them without calling the module).  The gather is an
  autograd function whose backward reduce-scatters the gradients, so
  each rank's slice gets its part of the mean gradient and no rank
  holds a whole gradient of a sharded parameter.  A module inside a
  repeated stack (an ``nn.ModuleList``: the blocks) gets its slices
  back as its forward ends, and what the backward saved of its gathered
  parameters is gathered again when the backward needs it (a saved-
  tensor hook), so the forward's end holds no block's whole parameters;
  the other modules (embeddings, final norms) keep theirs until the
  rank's function returns, since a model reads them outside their
  forward (the tied head).  Stage 3 with a remat policy is refused: the
  recomputation would run the hooks in the backward.

* **Pipelines** (``pp > 1``; ``parallel.pipeline``).  The rules place
  a stack's layers (``layers`` -> ``pp``): a rank's module holds only its
  stage's blocks, with their tp shards, and its ``Pipelined`` runs the
  rank's part of the wavefront.  ZeRO applies its rule to the JAX
  layout, where a stacked block's dimension 0 is ``layers``: no block's
  slots are sharded, only the other parameters'.  Every pp rank runs
  the model's head on the published output, and the backward is seeded
  from the last stage's loss alone (on a process mesh the other stages
  seed their hop chains with zeros, ``Pipelined.sinks``); a parameter
  replicated over pp (the embedding, a tied head, the final norm) gets
  the sum over pp of its ranks' gradients (one bucket, before the dp
  mean), each part once.  A model without a stack under ``pp > 1`` is
  replicated over pp: the last stage's gradients alone reach it.

* **Sequence parallelism** (``sp > 1``, beside ``dp`` and ``tp``).  The
  ranks of one ``sp`` group get the same dp piece of the batch and hold
  its whole sequence outside the attention; ``parallel.ring_attention``
  cuts each rank's chunk on entry, rings over the group and gathers the
  outputs (the reference's ``shard_map`` island), reaching the rank
  through the handle that ``install`` binds to each rank's attention
  (``attn_fn.for_rank``).  The chunk cut's backward gathers the chunks'
  gradients, so every gradient is equal over ``sp`` and only the dp
  mean (and, under pp, the pp sum) reduces it.  The island repeats the
  work outside the attention ``sp`` times, once on each rank of a group.

Under a strategy each rank draws dropout from the step's key as if it
were alone, so with dropout the ranks' masks are not the slices of one
global mask (the traces equal the unsharded ones at rate 0).  Refused,
with an error that says so: LAMB and a global-norm clip when a parameter
or its slots are sharded (their norms would need a reduction across
ranks), models with floating state buffers (BatchNorm statistics) over
dp > 1, a pipeline stage under a remat policy with ``tp > 1`` on a local
mesh (the recomputation in the backward would meet the other ranks
outside their run), a remat policy with ``sp > 1`` or with an expert
layer whose rank meets others (the recomputed attention or routing
would run outside its rank), ZeRO over the layers of a stack the rules
leave unplaced, and, waiting for ROADMAP queue 1 item 11, batch axes
other than ``dp`` and ``ep``, ZeRO with ``ep`` among them and ``ep``
among them beside ``pp``.
"""

from __future__ import annotations

import copy
import dataclasses
import weakref
from typing import Any, Optional

import torch

from hetu_tpu_torch.parallel import collectives as col
from hetu_tpu_torch.parallel.mesh import (DEFAULT_AXES, MeshSpec,
                                          make_mesh)
from hetu_tpu_torch.parallel.ranks import RankHandle, run_ranks
from hetu_tpu_torch.parallel.spec import (DP_RULES, MEGATRON_RULES, P,
                                          AxisRules, blocks_of,
                                          gather_param, logical_axes,
                                          resolve_specs, shard_index,
                                          shard_param, stacked_names)

__all__ = [
    "ShardingStrategy", "ShardedModel", "DataParallel", "MegatronTP",
    "ZeRO", "ModelParallel4CNN", "ModelParallel4LM", "OneWeirdTrick4CNN",
    "MegatronLM", "CNN_MP_RULES", "OWT_RULES",
]


def _dist_up() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _entries(spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


class ShardingStrategy:
    """mesh + rules + batch axis + ZeRO stage.

    zero_stage: 0 = replicated optimizer state; 1/2 = optimizer slots
    sharded over dp; 3 = parameters sharded over dp too.  ``mesh`` is a
    ``LocalMesh`` or a ``ProcessMesh``; without one, ``install`` builds
    ``make_mesh(mesh_spec)`` on the model's device, over the
    ``torch.distributed`` world when one is up (``dp`` absorbing it)."""

    def __init__(self, *, mesh=None, mesh_spec: Optional[MeshSpec] = None,
                 rules: AxisRules = DP_RULES, batch_axes: Any = "dp",
                 zero_stage: int = 0):
        axes = (() if batch_axes is None else (batch_axes,)
                if isinstance(batch_axes, str) else tuple(batch_axes))
        if not set(axes) <= {"dp", "ep"}:
            raise NotImplementedError(
                f"batch_axes={batch_axes!r}: the port splits the batch "
                f"over 'dp' and 'ep' (or not at all); other axes wait for "
                f"ROADMAP queue 1 item 11")
        if axes not in ((), ("dp",)) and zero_stage:
            raise NotImplementedError(
                f"ZeRO stage {zero_stage} with batch_axes={batch_axes!r} "
                f"waits for ROADMAP queue 1 item 11")
        self._mesh = mesh
        self.mesh_spec = mesh_spec
        self.rules = rules
        self.batch_axes = batch_axes
        self.batch = axes
        self.zero_stage = zero_stage

    @property
    def mesh(self):
        return self._mesh_on(None)

    def _mesh_on(self, device):
        if self._mesh is None:
            self._mesh = make_mesh(self.mesh_spec or MeshSpec(),
                                   device=device, processes=_dist_up())
        return self._mesh

    # -- spec construction ----------------------------------------------------
    def model_specs(self, model) -> dict:
        """``{name: PartitionSpec}`` in torch's layout; under stage 3 the
        parameters' ZeRO dimension carries ``dp``."""
        specs = resolve_specs(model, self.rules)
        if self.zero_stage >= 3:
            specs = self._zero_specs(specs, model)
        return specs

    def _zero_specs(self, specs: dict, model) -> dict:
        from hetu_tpu_torch.interop.from_jax import transposed_names
        transposed = transposed_names(model)
        params = dict(model.named_parameters())
        stacked = stacked_names(model)
        out = {}
        for n, s in specs.items():
            if n not in stacked:
                out[n] = self._zero_shard(s, tuple(params[n].shape),
                                          n in transposed)
            elif s and s[0] is not None or self.mesh.shape["dp"] == 1:
                # the JAX layout's dimension 0 is the stack's: sharded
                out[n] = s
            else:
                raise NotImplementedError(
                    f"{n}: ZeRO over the layers of a stack that the rules "
                    f"leave unplaced")
        return out

    def _zero_shard(self, spec, shape: tuple, transposed: bool = False):
        """Shard the JAX layout's dimension 0 (torch's last for a weight
        stored transposed) over dp when it is unsharded and divisible."""
        if not shape:
            return spec
        dp = self.mesh.shape.get("dp", 1)
        if dp == 1:
            return spec
        entries = _entries(spec, len(shape))
        d = len(shape) - 1 if transposed else 0
        if entries[d] is None and shape[d] % dp == 0:
            entries[d] = "dp"
            return P(*entries)
        return spec

    def opt_specs(self, opt_state, model_specs: dict, model) -> dict:
        slot = (self._zero_specs(model_specs, model) if self.zero_stage >= 1
                else model_specs)
        return {k: (P() if k == "step" else slot) for k in opt_state}

    # -- install --------------------------------------------------------------
    def install(self, model, optimizer) -> "ShardedModel":
        """Cut ``model`` into this process's ranks (``model`` itself
        becomes the first held rank's module) and build each rank's
        optimizer state."""
        dev = next(model.parameters()).device
        return ShardedModel(self, self._mesh_on(dev), model, optimizer)


@dataclasses.dataclass
class _Place:
    """One parameter's placement: the full shape, the tp spec (its
    non-dp, non-pp mesh axes), the per-dimension block counts, the ZeRO
    dimension (None where the parameter is not ZeRO-sharded), its type
    and, for a stacked block's, the pp stage that holds it (None: every
    stage)."""

    shape: tuple
    tp_spec: tuple
    blocks: tuple
    zdim: Optional[int]
    dtype: torch.dtype = torch.float32
    stage: Optional[int] = None   # a stacked block's pp stage


class ShardedModel:
    """A model cut into the ranks this process holds (``mesh.held``):
    ``models[i]`` is rank ``held[i]``'s module (``models[0]`` the model
    passed in, sharded in place), ``opt_states[i]`` its optimizer state.
    A step is :meth:`forward_backward`, :meth:`reduce_grads` and
    :meth:`update` (``Trainer`` runs them, a guard between the last
    two)."""

    def __init__(self, strategy: ShardingStrategy, mesh, model, optimizer):
        from hetu_tpu_torch.interop.from_jax import (state_tensors,
                                                     transposed_names)
        from hetu_tpu_torch.optim.optimizers import LambOptimizer
        self.strategy, self.mesh = strategy, mesh
        dev = next(model.parameters()).device
        if mesh.device != dev:
            raise ValueError(f"the mesh is on {mesh.device}, the model on "
                             f"{dev}")
        self.stage = strategy.zero_stage
        dp = mesh.shape["dp"]
        self.dp = dp
        # the axes the batch is cut over, and its pieces
        self.batch = tuple(a for a in strategy.batch
                           if mesh.shape.get(a, 1) > 1)
        self.pieces = 1
        for a in self.batch:
            self.pieces *= mesh.shape[a]
        # what the losses and gradients are averaged over (dp also where
        # the batch is not cut: its ranks hold equal gradients)
        self.reduce_axes = self.batch or (("dp",) if dp > 1 else ())
        if self.batch not in ((), ("dp",)) and mesh.shape["pp"] > 1:
            raise NotImplementedError(
                f"batch_axes={strategy.batch_axes!r} beside pp: ROADMAP "
                f"queue 1 item 11")
        floating = [n for n, b in state_tensors(model).items()
                    if not isinstance(b, torch.nn.Parameter)
                    and b.is_floating_point()]
        if floating and dp > 1:
            raise NotImplementedError(
                f"floating state buffers ({floating[:3]}...) over dp={dp}: "
                f"each rank would keep its own statistics")
        remat = getattr(getattr(model, "config", None), "remat", "none")
        if mesh.shape["sp"] > 1 and remat != "none":
            raise NotImplementedError(
                f"remat={remat!r} with sp={mesh.shape['sp']}: the "
                f"recomputation in the backward would run the attention "
                f"outside its rank; sequence parallelism under a remat "
                f"policy waits for ROADMAP queue 1 item 10 part 12")
        experts = any(hasattr(m, "_ep_setup") for m in model.modules())
        if experts and remat != "none" and (
                mesh.shape["ep"] > 1 or (dp > 1 and strategy.batch)):
            raise NotImplementedError(
                f"remat={remat!r} with expert layers whose ranks meet: the "
                f"recomputation in the backward would route outside its "
                f"rank; expert parallelism under a remat policy waits for "
                f"ROADMAP queue 1 item 10 part 12")
        if self.stage >= 3 and dp > 1 and remat != "none":
            raise NotImplementedError(
                f"ZeRO stage 3 with remat={remat!r}: the recomputation "
                f"would gather the parameters again in the backward")
        specs = resolve_specs(model, strategy.rules)
        zspecs = (strategy._zero_specs(specs, model) if self.stage >= 1
                  else specs)
        logical = logical_axes(model)
        shape = mesh.shape
        self.pp = shape["pp"]
        self.stacked = stacked_names(model)
        self.transposed = transposed_names(model)
        self._refuse_local_remat(model, mesh)
        self.place = {}
        for name, p in model.named_parameters():
            spec, lg, stage = specs[name], logical[name], None
            if name in self.stacked:
                lead = self._live(spec[0], shape)
                spec, lg = P(*spec[1:]), P(*lg[1:])
                _, li, n = self.stacked[name]
                if lead is not None and lead != ("pp",):
                    raise NotImplementedError(
                        f"{name}: a stack's layers over {lead}")
                if self.pp > 1:
                    if lead is None or n % self.pp:
                        raise ValueError(
                            f"{name}: a stack of {n} layers that the rules "
                            f"do not split over pp={self.pp}")
                    stage = li // (n // self.pp)
            ent = [self._live(e, shape) for e in _entries(spec, p.dim())]
            if any(e is not None and ("dp" in e or "pp" in e)
                   for e in ent):
                raise NotImplementedError(
                    f"{name}: rules that shard a parameter over dp or pp")
            tp_spec = tuple(None if e is None else
                            (e[0] if len(e) == 1 else e) for e in ent)
            zdim = next((d for d, e in enumerate(
                _entries(zspecs[name], p.dim())) if e == "dp"), None)
            self.place[name] = _Place(
                tuple(p.shape), tp_spec, blocks_of(_entries(lg, p.dim())),
                zdim, p.dtype, stage)
        self.shards_params = any(any(e is not None for e in pl.tp_spec)
                                 for pl in self.place.values())
        self.shards_grads = self.shards_params or any(
            pl.zdim is not None for pl in self.place.values())
        if self.shards_grads and (isinstance(optimizer, LambOptimizer)
                                  or optimizer.clip_norm > 0.0):
            raise NotImplementedError(
                "LAMB's trust ratio and a global-norm clip need norms "
                "reduced across the ranks that hold a parameter's pieces; "
                "use them with DataParallel (stage 0)")
        self.held = list(mesh.held)
        self.coords = [mesh.coords(r) for r in self.held]
        self.handles = [RankHandle(mesh, r) for r in self.held]
        copies = [copy.deepcopy(model) for _ in self.held[1:]]
        self.models = [model] + copies
        # stage 3, per held rank and None outside ``run``: the modules
        # holding gathered tensors, {id: (module, [(attribute, slice)])},
        # and the stacked modules' gathered tensors the forward may save,
        # {storage address: (the dp group's slices, ZeRO dim)}
        self._gathered = [None] * len(self.held)
        self._regather = [None] * len(self.held)
        self._root_zero = ()
        self._stacked_zero = set()
        for i, m in enumerate(self.models):
            self._shard_module(i, m)
            m._hetu_sharded = weakref.ref(self)
        self.opt_states = [optimizer.init(self._update_params(i).items())
                           for i in range(len(self.held))]
        # stage 3: each held rank's dp group's slices of each stacked
        # module's parameters, {(module path, attribute): [slice, ...]}
        group = {r: g for g in mesh.groups("dp") for r in g}
        self._group_slices = [
            {(path, a): [self.models[self.held.index(q)].get_submodule(path)
                         ._parameters[a]
                         for q in group[r] if q in self.held]
             for path, a in self._stacked_zero}
            for r in self.held]

    @staticmethod
    def _refuse_local_remat(model, mesh) -> None:
        from hetu_tpu_torch.parallel.pipeline import Pipelined
        if hasattr(mesh, "group") or mesh.shape["tp"] == 1:
            return
        for name, mod in model.named_modules():
            if isinstance(mod, Pipelined) and mod.remat != "none":
                raise NotImplementedError(
                    f"{name or 'model'}: a pipeline stage under "
                    f"remat={mod.remat!r} with tp={mesh.shape['tp']} on a "
                    f"local mesh: the recomputation in the backward would "
                    f"meet the other ranks outside their run; build it "
                    f"with remat='none'")

    def _last_stage(self, i: int) -> bool:
        return self.pp == 1 or self.coords[i]["pp"] == self.pp - 1

    @staticmethod
    def _live(entry, shape):
        """An entry's mesh axes of size above 1 (a tuple), or None."""
        if entry is None:
            return None
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        axes = tuple(a for a in axes if shape.get(a, 1) > 1)
        return axes or None

    # -- placement ------------------------------------------------------------
    def _shard_module(self, i: int, model) -> None:
        from hetu_tpu_torch.parallel.pipeline import Pipelined
        c, shape = self.coords[i], self.mesh.shape
        for mod in model.modules():
            if isinstance(mod, Pipelined):
                mod._pp_setup(self.handles[i], c, shape)
            ep_setup = getattr(mod, "_ep_setup", None)
            if ep_setup is not None:
                # an expert layer routes its rank's block over the batch
                ep_setup(self.handles[i], self.batch)
            bind = getattr(getattr(mod, "attn_fn", None), "for_rank", None)
            if bind is not None:
                # sequence-parallel attention meets its rank's sp group
                mod.attn_fn = bind(self.handles[i])
        stacked = {f"{p}.{q}" if p else q
                   for p, m in model.named_modules()
                   if isinstance(m, torch.nn.ModuleList)
                   for q, _ in m.named_modules() if q}
        for prefix, mod in model.named_modules():
            specs, index, zero = {}, {}, []
            for attr, p in mod.named_parameters(recurse=False):
                name = f"{prefix}.{attr}" if prefix else attr
                pl = self.place[name]
                if any(e is not None for e in pl.tp_spec):
                    # a new Parameter: one whose shape changes under
                    # ``.data`` keeps its old gradient accumulator's shape
                    p = torch.nn.Parameter(
                        shard_param(p.data, pl.tp_spec, c, shape, pl.blocks),
                        requires_grad=p.requires_grad)
                    setattr(mod, attr, p)
                if self.stage >= 3 and pl.zdim is not None:
                    setattr(mod, attr, torch.nn.Parameter(
                        self._zslice(p.data, pl, c["dp"]).clone(),
                        requires_grad=p.requires_grad))
                    zero.append((attr, pl.zdim))
                specs[attr] = pl.tp_spec
                index[attr] = shard_index(pl.shape, pl.tp_spec, c, shape,
                                          pl.blocks)
            if zero and not prefix:
                self._root_zero = tuple(zero)
            elif zero:
                me = weakref.ref(self)
                path = prefix if prefix in stacked else None
                if path is not None:
                    self._stacked_zero.update((path, a) for a, _ in zero)
                mod.register_forward_pre_hook(
                    lambda m, args, i=i, attrs=tuple(zero), path=path:
                    me()._gather(i, m, attrs, path))
                if path is not None:
                    mod.register_forward_hook(
                        lambda m, args, out, i=i: me()._release(i, m))
            if not any(e is not None for s in specs.values() for e in s):
                continue
            setup = getattr(mod, "_tp_setup", None)
            if setup is None:
                from hetu_tpu_torch.layers.conv import Conv2d
                if isinstance(mod, Conv2d):
                    raise NotImplementedError(
                        f"{prefix}: a convolution sharded over tp waits for "
                        f"ROADMAP queue 1 item 10 part 7")
                raise NotImplementedError(
                    f"{prefix} ({type(mod).__name__}): its parameters are "
                    f"sharded over tp {specs} and the class has no "
                    f"tensor-parallel path")
            setup(self.handles[i], specs, index)

    def _zslice(self, t, pl: _Place, k: int):
        n = t.shape[pl.zdim] // self.dp
        return t.narrow(pl.zdim, k * n, n)

    def _update_params(self, i: int) -> dict:
        """Rank ``i``'s tensors the optimizer updates: under stages 1 and
        2 its ZeRO slice of a ZeRO-sharded parameter, else the parameter
        (under stage 3 the module holds the slice)."""
        out = {}
        k = self.coords[i]["dp"]
        for name, p in self.models[i].named_parameters():
            pl = self.place[name]
            if pl.zdim is None or self.stage >= 3:
                out[name] = p
            else:
                out[name] = self._zslice(p.data, pl, k)
        return out

    def _zero_names(self) -> list:
        return [n for n, pl in self.place.items() if pl.zdim is not None]

    def _gather(self, i: int, mod, attrs: tuple, path=None) -> None:
        """Stage 3: rank ``i``'s module ``mod`` holds the gathers over dp
        of its slices ``attrs`` (``(attribute, ZeRO dim)`` pairs; one
        bucket) until :meth:`_release`; ``path``, the module's name in a
        repeated stack, makes its gathered tensors ones the backward
        gathers again (:meth:`_pack`)."""
        held = self._gathered[i]
        if held is None:
            raise RuntimeError(
                "a ZeRO stage 3 rank module runs inside its ShardedModel's "
                "step or evaluate; export_params gives the whole weights")
        if id(mod) in held:
            return   # called again while it holds them
        slices = [mod._parameters[a] for a, _ in attrs]
        flat = torch.cat([t.reshape(-1) for t in slices])
        parts = self.handles[i].collective(_gather_slices, flat,
                                           "dp").chunk(self.dp)
        off = 0
        for (a, zdim), t in zip(attrs, slices):
            n = t.numel()
            full = torch.cat([q[off:off + n].view(t.shape) for q in parts],
                             zdim)
            mod._parameters[a] = full
            if path is not None:
                self._regather[i][full.untyped_storage().data_ptr()] = (
                    self._group_slices[i][path, a], zdim)
            off += n
        held[id(mod)] = (mod, [(a, t) for (a, _), t in zip(attrs, slices)])

    def _release(self, i: int, mod) -> None:
        """Rank ``i``'s module ``mod`` gets its slices back."""
        _, pairs = self._gathered[i].pop(id(mod))
        for a, t in pairs:
            self._regather[i].pop(mod._parameters[a].untyped_storage()
                                  .data_ptr(), None)
            mod._parameters[a] = t

    def _ungather(self, i: int) -> None:
        for key in list(self._gathered[i] or ()):
            self._release(i, self._gathered[i][key][0])
        self._gathered[i] = self._regather[i] = None

    def _pack(self, i: int, t):
        """The saved-tensor hook of rank ``i``'s forward: a view of a
        stacked module's gathered parameter is saved as where to gather
        it again."""
        try:
            hit = self._regather[i].get(t.untyped_storage().data_ptr())
        except (RuntimeError, NotImplementedError):   # no storage
            return t
        if hit is None:
            return t
        return _Regather(*hit, tuple(t.shape), t.stride(),
                         t.storage_offset())

    @torch.no_grad()
    def _unpack(self, saved):
        """A saved tensor back: where :meth:`_pack` left a recipe, the
        all-gather over dp again (in the backward)."""
        if not isinstance(saved, _Regather):
            return saved
        process = len(self.held) == 1
        full = col.all_gather(saved.slices, "dp" if process else None,
                              gather_dim=saved.dim,
                              mesh=self.mesh if process else None)[0]
        return full.as_strided(saved.shape, saved.stride, saved.offset)

    # -- the step -------------------------------------------------------------
    def _piece_index(self, c: dict) -> int:
        """The index of the batch piece of the rank at ``c`` (its
        coordinates over the batch axes, the first outermost)."""
        k = 0
        for a in self.batch:
            k = k * self.mesh.shape[a] + c[a]
        return k

    def split_batch(self, batch) -> list:
        """Each held rank's piece of ``batch`` (every tensor leaf's dim 0
        split over the batch axes)."""
        n_pieces = self.pieces

        def piece(x, k):
            if isinstance(x, dict):
                return {a: piece(v, k) for a, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(piece(v, k) for v in x)
            if isinstance(x, torch.Tensor) and x.dim() and n_pieces > 1:
                if x.shape[0] % n_pieces:
                    raise ValueError(f"batch of {x.shape[0]} does not split "
                                     f"over {self.batch} ({n_pieces} "
                                     f"pieces)")
                n = x.shape[0] // n_pieces
                return x[k * n:(k + 1) * n]
            return x
        return [piece(batch, self._piece_index(c)) for c in self.coords]

    def run(self, fn_of_rank) -> list:
        """``fn_of_rank(i)`` for every held rank, through ``run_ranks``;
        under stage 3 the rank's modules hold their gathered parameters
        while it runs."""
        def rank(i):
            if self.stage < 3:
                return fn_of_rank(i)
            self._gathered[i], self._regather[i] = {}, {}
            try:
                if self._root_zero:
                    self._gather(i, self.models[i], self._root_zero)
                with torch.autograd.graph.saved_tensors_hooks(
                        lambda t: self._pack(i, t), self._unpack):
                    return fn_of_rank(i)
            finally:
                self._ungather(i)
        return run_ranks(self.mesh, [lambda i=i: rank(i)
                                     for i in range(len(self.held))])

    def forward_backward(self, loss_fn, batch, key) -> list:
        """Each rank's ``(loss, aux)`` on its piece of the batch, after
        one backward over all of them."""
        for m in self.models:
            for p in m.parameters():
                p.grad = None
        pieces = self.split_batch(batch)
        out = self.run(lambda i: loss_fn(self.models[i], pieces[i], key))
        roots, seeds = [], []
        for i, o in enumerate(out):
            if self._last_stage(i):
                roots.append(o[0])
                seeds.append(torch.ones_like(o[0]))
            for sink in self._take_sinks(i):
                if sink.requires_grad:
                    roots.append(sink)
                    seeds.append(torch.zeros_like(sink))
        torch.autograd.backward(roots, seeds)
        return out

    def _take_sinks(self, i: int) -> list:
        """Rank ``i``'s pipelines' hop-chain ends of the last forward."""
        from hetu_tpu_torch.parallel.pipeline import Pipelined
        out = []
        for mod in self.models[i].modules():
            if isinstance(mod, Pipelined):
                out += mod.sinks
                mod.sinks = []
        return out

    def mean_loss(self, losses: list):
        """The mean over the batch axes of the ranks' losses
        (detached)."""
        losses = [loss.detach() for loss in losses]
        if not self.reduce_axes:
            return losses[0]
        return col.all_reduce_mean(losses, self.reduce_axes,
                                   mesh=self.mesh)[0]

    def reduce_grads(self) -> list:
        """Each rank's gradients for :meth:`update`: the mean over the
        batch axes (one ``all_reduce_mean`` bucket for each set of axes a
        parameter is replicated on; a parameter placed over a batch axis,
        an expert slice, gets the sum over the others divided by the
        pieces), and under stages 1 and 2 the ZeRO-sharded ones as this
        rank's slice of the mean (one ``reduce_scatter`` bucket).  Under
        stage 3 a ZeRO-sharded parameter's slice already has its part of
        the mean: the backward of its gather reduce-scattered it.  No
        gradient is partial over ``sp`` (the attention's chunk cut
        gathers its gradients), so none is reduced over it."""
        n = len(self.held)
        grads = []
        for m in self.models:
            g = {}
            for name, p in m.named_parameters():
                g[name] = (p.grad if p.grad is not None
                           else torch.zeros_like(p))
            grads.append(g)
        if self.pp > 1:
            self._bucket(grads, lambda nm: self.place[nm].stage is None,
                         lambda f: col.all_reduce(f, "pp", mesh=self.mesh))
        if not self.reduce_axes:
            return grads
        zero = set(self._zero_names())
        sets = {}
        for nm in self.place:     # a pp rank holds its stage's blocks
            if nm not in zero:
                held = {a for e in self.place[nm].tp_spec if e is not None
                        for a in ((e,) if isinstance(e, str) else e)}
                axes = tuple(a for a in self.reduce_axes if a not in held)
                sets.setdefault(axes, set()).add(nm)
        for axes, names in sets.items():
            share = 1
            for a in self.reduce_axes:
                share *= self.mesh.shape[a]
            for a in axes:
                share //= self.mesh.shape[a]
            if axes:
                self._bucket(grads, names.__contains__,
                             lambda f, axes=axes: col.all_reduce_mean(
                                 f, axes, mesh=self.mesh))
            if share > 1:
                for g in grads:
                    for nm in names & set(g):
                        g[nm] = g[nm] / share
        if self.dp == 1:
            return grads
        if zero and self.stage < 3:
            names = [nm for nm in grads[0] if nm in zero]
            flats = []
            for i in range(n):
                chunks = [[self._zslice(grads[i][nm], self.place[nm], k)
                           .reshape(-1) for nm in names]
                          for k in range(self.dp)]
                flats.append(torch.cat([c for ks in chunks for c in ks]))
            red = col.reduce_scatter(flats, "dp", scatter_dim=0,
                                     mesh=self.mesh)
            for i in range(n):
                mine = red[i] / self.dp
                off = 0
                for nm in names:
                    shp = list(grads[i][nm].shape)
                    shp[self.place[nm].zdim] //= self.dp
                    k = 1
                    for s in shp:
                        k *= s
                    grads[i][nm] = mine[off:off + k].view(shp)
                    off += k
        return grads

    @staticmethod
    def _bucket(grads: list, pick, reduce) -> None:
        """Each rank's gradients that ``pick`` names, flattened into one
        bucket, through ``reduce`` (a list collective) and back."""
        names = [[nm for nm in g if pick(nm)] for g in grads]
        if not any(names):
            return
        flats = [torch.cat([g[nm].reshape(-1) for nm in ns])
                 for g, ns in zip(grads, names)]
        red = reduce(flats)
        for g, ns, r in zip(grads, names, red):
            off = 0
            for nm in ns:
                k = g[nm].numel()
                g[nm] = r[off:off + k].view_as(g[nm])
                off += k

    def update(self, optimizer, grads: list) -> None:
        """The optimizer on each rank's tensors (:meth:`_update_params`),
        then stages 1 and 2 all-gather the updated slices (one
        bucket)."""
        for i in range(len(self.held)):
            mask = {n: p.requires_grad
                    for n, p in self.models[i].named_parameters()}
            optimizer.update(grads[i], self.opt_states[i],
                             self._update_params(i), mask=mask)
        if self.stage in (1, 2):
            self._gather_slices()

    @torch.no_grad()
    def _gather_slices(self) -> None:
        names = self._zero_names()
        if not names:
            return
        n = len(self.held)
        ups = [self._update_params(i) for i in range(n)]
        flats = [torch.cat([ups[i][nm].reshape(-1) for nm in names])
                 for i in range(n)]
        full = col.all_gather(flats, "dp", gather_dim=0, mesh=self.mesh)
        for i, m in enumerate(self.models):
            params = dict(m.named_parameters())
            for k, part in enumerate(full[i].chunk(self.dp)):
                off = 0
                for nm in names:
                    dst = self._zslice(params[nm].data, self.place[nm], k)
                    c = dst.numel()
                    dst.copy_(part[off:off + c].view(dst.shape))
                    off += c

    @torch.no_grad()
    def evaluate(self, loss_fn, batch) -> tuple:
        pieces = self.split_batch(batch)
        out = self.run(lambda i: loss_fn(self.models[i], pieces[i], None))
        return self.mean_loss([o[0] for o in out]), out[0][1]

    # -- back to one tensor ---------------------------------------------------
    @torch.no_grad()
    def full_parameters(self) -> dict:
        """``{name: full tensor}`` in torch's layout, gathered from every
        rank of the mesh (a collective on a process mesh: every process
        calls it)."""
        out = {}
        shape = self.mesh.shape
        every = [self.mesh.coords(r) for r in range(self.mesh.size)]
        per_rank = [dict(m.named_parameters()) for m in self.models]
        if self.stage >= 3:
            for name in self._zero_names():
                got = col.all_gather([pr[name] for pr in per_rank], "dp",
                                     gather_dim=self.place[name].zdim,
                                     mesh=self.mesh)
                for pr, g in zip(per_rank, got):
                    pr[name] = g
        local = len(self.held) == self.mesh.size
        for name, pl in self.place.items():
            holders = [k for k, pr in enumerate(per_rank) if name in pr]
            if all(e is None for e in pl.tp_spec) and (
                    local or pl.stage is None):
                out[name] = per_rank[holders[0]][name].detach().clone()
                continue
            if local:
                pieces = [per_rank[k][name] for k in holders]
                coords = [every[self.held[k]] for k in holders]
            else:
                mine = per_rank[0].get(name)
                if mine is None:     # another stage's block: a stand-in
                    mine = torch.zeros(
                        [len(ix) for ix in shard_index(
                            pl.shape, pl.tp_spec, self.coords[0], shape,
                            pl.blocks)],
                        dtype=pl.dtype, device=self.mesh.device)
                got = self._gather_pieces(mine, pl, every)
                owners = [r for r in range(self.mesh.size)
                          if pl.stage is None or every[r]["pp"] == pl.stage]
                pieces = [got[r] for r in owners]
                coords = [every[r] for r in owners]
            out[name] = gather_param(pieces, pl.shape, pl.tp_spec, coords,
                                     shape, pl.blocks)
        return out

    @torch.no_grad()
    def load(self, params: dict, slots: Optional[dict] = None,
             step: Optional[int] = None) -> None:
        """Copy whole tensors (torch's layout, as :meth:`full_parameters`
        gives them) into every held rank: each of ``params`` as the
        rank's piece of that parameter, each ``slots[slot][name]`` as its
        piece of that optimizer slot, and ``step`` into every rank's
        optimizer state.  A name left out stays as it was."""
        for i, m in enumerate(self.models):
            own = dict(m.named_parameters())
            for name, full in params.items():
                if name in own:     # another stage's block is elsewhere
                    own[name].copy_(self._piece(full, name, i,
                                                zero=self.stage >= 3))
            for slot, named in (slots or {}).items():
                for name, full in named.items():
                    if name in own:
                        self.opt_states[i][slot][name].copy_(
                            self._piece(full, name, i, zero=True))
            if step is not None:
                self.opt_states[i]["step"] = int(step)

    def _piece(self, full, name: str, i: int, zero: bool):
        """Rank ``i``'s piece of the whole tensor ``full`` of parameter
        ``name``: its tp shard and, with ``zero``, that shard's ZeRO
        slice."""
        pl = self.place[name]
        if tuple(full.shape) != pl.shape:
            raise ValueError(f"{name}: a whole tensor of shape "
                             f"{tuple(full.shape)} for a parameter of "
                             f"{pl.shape}")
        t = full
        if any(e is not None for e in pl.tp_spec):
            t = shard_param(full, pl.tp_spec, self.coords[i],
                            self.mesh.shape, pl.blocks)
        if zero and pl.zdim is not None:
            t = self._zslice(t, pl, self.coords[i]["dp"])
        return t

    def _gather_pieces(self, mine, pl: _Place, every: list) -> list:
        shape = self.mesh.shape
        sizes = [[len(ix) for ix in shard_index(pl.shape, pl.tp_spec, c,
                                                shape, pl.blocks)]
                 for c in every]
        top = [max(s[d] for s in sizes) for d in range(len(pl.shape))]
        pad = torch.zeros(top, dtype=mine.dtype, device=mine.device)
        pad[tuple(slice(0, n) for n in mine.shape)] = mine
        got = col.all_gather([pad], DEFAULT_AXES, gather_dim=0, tiled=False,
                             mesh=self.mesh)[0]
        return [got[r][tuple(slice(0, n) for n in sizes[r])]
                for r in range(len(every))]


@dataclasses.dataclass
class _Regather:
    """A saved view of a stage-3 gathered parameter: its dp group's
    ``slices`` (this process's on a process mesh) gathered along
    ``dim``, then ``as_strided``."""

    slices: list
    dim: int
    shape: tuple
    stride: tuple
    offset: int


class _GatherSlices(torch.autograd.Function):
    """Stage 3's gather of the held ranks' flat slices over dp: forward,
    the all-gather; backward, the reduce-scatter of the gradients
    divided by dp (each rank's slice of their mean)."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        full = col.all_gather(list(xs), "dp", gather_dim=0, mesh=mesh)
        # a local mesh's ranks share one tensor: each gets its own
        return tuple(f if len(xs) == 1 else f.clone() for f in full)

    @staticmethod
    def backward(ctx, *dys):
        red = col.reduce_scatter([d.contiguous() for d in dys], "dp",
                                 scatter_dim=0, mesh=ctx.mesh)
        dp = ctx.mesh.shape["dp"]
        return (None, *[r / dp for r in red])


def _gather_slices(shards: list, axis, *, mesh) -> list:
    return list(_GatherSlices.apply(mesh, *shards))


def sharded_of(model) -> Optional[ShardedModel]:
    """The :class:`ShardedModel` a rank's module belongs to, or None."""
    ref = getattr(model, "_hetu_sharded", None)
    return None if ref is None else ref()


def DataParallel(*, mesh=None, zero_stage: int = 0) -> ShardingStrategy:
    """All ranks on the dp axis (reference simple.py:6 DataParallel)."""
    return ShardingStrategy(mesh=mesh, mesh_spec=MeshSpec(), rules=DP_RULES,
                            zero_stage=zero_stage)


def MegatronTP(tp: int, *, dp: int = 1, mesh=None,
               zero_stage: int = 0) -> ShardingStrategy:
    """Megatron column/row-parallel transformer placement
    (reference simple.py:174 MegatronLM)."""
    return ShardingStrategy(
        mesh=mesh, mesh_spec=MeshSpec(dp=dp, tp=tp), rules=MEGATRON_RULES,
        zero_stage=zero_stage,
    )


def ZeRO(stage: int = 1, *, mesh=None) -> ShardingStrategy:
    """ZeRO-style dp-sharded optimizer state / params
    (reference 'partial' NodeStatus axis + AllGather, context.py:304-317)."""
    return ShardingStrategy(mesh=mesh, mesh_spec=MeshSpec(), rules=DP_RULES,
                            zero_stage=stage)


# Full model parallel for CNNs (simple.py:46 ModelParallel4CNN): conv output
# channels and FC outputs sharded over tp.
CNN_MP_RULES = AxisRules({
    "conv_out": "tp", "out": "tp", "mlp": "tp",
    "layers": "pp", "experts": "ep",
})

# One-weird-trick (simple.py:119 OneWeirdTrick4CNN, Krizhevsky 2014): conv
# layers data-parallel (replicated weights, batch sharded), FC layers
# tensor-parallel — conv is compute-bound, FC is parameter-bound.
OWT_RULES = AxisRules({
    "out": "tp", "mlp": "tp",
    "layers": "pp", "experts": "ep",
})


def ModelParallel4CNN(tp: int, *, dp: int = 1, mesh=None) -> ShardingStrategy:
    """Channel/FC-sharded CNN (reference simple.py:46)."""
    return ShardingStrategy(mesh=mesh, mesh_spec=MeshSpec(dp=dp, tp=tp),
                            rules=CNN_MP_RULES)


def ModelParallel4LM(tp: int, *, dp: int = 1, mesh=None,
                     zero_stage: int = 0) -> ShardingStrategy:
    """Layer-sharded LM (reference simple.py:113 ModelParallel4LM): the
    Megatron column/row placement, minus pipeline stages."""
    return ShardingStrategy(mesh=mesh, mesh_spec=MeshSpec(dp=dp, tp=tp),
                            rules=MEGATRON_RULES, zero_stage=zero_stage)


def OneWeirdTrick4CNN(tp: int, *, dp: int = 1, mesh=None) -> ShardingStrategy:
    """DP convs + TP fully-connected (reference simple.py:119)."""
    return ShardingStrategy(mesh=mesh, mesh_spec=MeshSpec(dp=dp, tp=tp),
                            rules=OWT_RULES)


def MegatronLM(tp: int, *, dp: int = 1, pp: int = 1, mesh=None,
               zero_stage: int = 0) -> ShardingStrategy:
    """Megatron placement incl. the pipeline axis (reference
    simple.py:174): a model's ``Pipelined`` stack splits over ``pp``."""
    return ShardingStrategy(mesh=mesh, mesh_spec=MeshSpec(dp=dp, tp=tp, pp=pp),
                            rules=MEGATRON_RULES, zero_stage=zero_stage)

"""Weight bridge from the JAX package's models (GPT, BERT and its MoE and
task heads, the MoE LM, the CTR and NCF families, the CNNs, ViT, Swin,
T5, the RNNs and the GCN) to the port's.

``load_jax_params(model, params)`` takes ``{dotted_name: array}`` as
``hetu_tpu.core.module.named_parameters`` gives it (a dict or a list of
pairs, arrays as numpy) and copies it into the port's model.  The port
keeps the JAX names; what may differ is the layout of a 2-D weight: JAX
stores a linear ``(in, out)``, and a port module that hands it to
``F.linear`` stores it torch's ``(out, in)``.  Which arrays are stored
transposed is declared, never guessed from a name: each module class
lists its own in a class attribute ``_jax_transposed`` (``Linear``:
``w``; the MHA and Swin's window attention: ``wqkv``, ``wo``; the
transformer MLP: ``w_in``, ``w_out``; an untied GPT ``lm_head``; a MoE
gate's router ``w``; a DCN ``CrossLayer``'s ``w``; T5's eight
projections ``wq``, ``wk``, ``wv``, ``wo`` and its MLP's ``w_in``,
``w_out``), and :func:`transposed_names` collects them over a model.
A square weight's shape cannot tell a transpose, so a name rule that
missed one would load it mirrored without a word.  Everything else is
copied as it is: the tied heads (GPT's ``wte.weight``, BERT's word
embedding, T5's ``shared.weight``), BERT's ``decoder_bias``, DeepFM's
``bias``, the stacked experts' ``w1 (E, d, h)`` and ``w2 (E, h, d)``,
the HWIO convolution kernels (``ops.nn.conv2d`` hands torch their OIHW
view), Swin's ``bias_table``, T5's bias ``table``, the RNN cells'
``wx`` / ``wh`` and ``GraphConv.w`` (kept ``(in, out)`` as in JAX).
The JAX models also list their state leaves among the parameters (a
staged layer's ``rows``, the HBM cache's ``cache``, ``slots`` and
pending refresh): the port keeps such state in buffers that the host
engine fills, so names that are the port model's buffers, or the
refresh leaves the port has no counterpart for, are skipped.  Buffers
that hold a state field of the JAX layer are copied, and are declared
as the layout is: each module class maps them to their JAX dtype in a
class attribute ``_jax_state`` (``BalanceGate``: ``centroids``;
``BatchNorm2d``: ``running_mean``, ``running_var``; the compression
suite's integer state: ROBE's and DHE's uint32 hash coefficients, the
remap, mask, group and frequency tables), and :func:`state_dtypes`
collects them over a model.  A floating array crosses as fp32; an
integer array keeps its values exactly both ways (through ``int64``,
which holds every uint32), and :func:`export_params` gives it back in
its declared JAX dtype.  (fp32 holds integers exactly only up to 2**24;
a row id or a hash coefficient above that would cross corrupted.)

A stack of blocks (``parallel.pipeline.Stack``, the blocks of a
``Pipelined``) is one module in the JAX package whose leaves carry a
leading ``[n_layers]`` dimension: ``<stack>.<leaf>`` there is
``<stack>.<li>.<leaf>`` for each layer ``li`` here (:func:`unstack_jax`
splits such leaves, :func:`stack_jax` stacks them back, each block's
own leaves transposed where it declares them).

Unknown names, missing names and shape mismatches raise ``ValueError``.

``export_params(model)`` is the inverse: ``{name: np.ndarray}`` in the
JAX layout (the same arrays transposed back, the copied buffers
included), floating arrays as fp32 and integer ones in their JAX dtype,
for comparing a trained port model with the JAX one.

A host-engine embedding's rows live in its tables, not in parameters:
``copy_host_rows(dst, src)`` carries them table by table, through
``src``'s ``pull`` and ``dst``'s ``set_rows`` (a JAX
``RemoteHostEmbedding`` or ``ShardedHostEmbedding`` into the port's with
as many shards, or a staged layer's single table), in bounded
segments.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["load_jax_params", "export_params", "state_tensors",
           "state_dtypes", "transposed_names", "to_jax_layout",
           "to_jax_array", "copy_host_rows", "stack_prefixes",
           "stack_jax", "unstack_jax"]


# the HBM layer's pending-refresh leaves, which the port applies inside
# stage() instead of keeping
_JAX_STATE_ONLY = (".refresh_slots", ".refresh_rows")
def transposed_names(model) -> frozenset:
    """The dotted names of ``model``'s parameters that it stores
    transposed from the JAX layout: each module's ``_jax_transposed``
    attributes that are set, under the module's prefix."""
    out = set()
    for prefix, mod in model.named_modules():
        for attr in getattr(type(mod), "_jax_transposed", ()):
            if getattr(mod, attr, None) is not None:
                out.add(f"{prefix}.{attr}" if prefix else attr)
    return frozenset(out)


def stack_prefixes(model) -> dict:
    """``{prefix: n_layers}`` of every block stack in ``model``
    (``parallel.pipeline.Stack``), which the JAX layout stacks into
    ``[n_layers, ...]`` leaves."""
    from hetu_tpu_torch.parallel.pipeline import Stack
    return {prefix: len(mod) for prefix, mod in model.named_modules()
            if isinstance(mod, Stack)}


def _stacked_leaf(name: str, stacks: dict):
    """``(prefix, rest)`` where ``name`` lies in a stack, else None."""
    for prefix, n in stacks.items():
        if name.startswith(prefix + "."):
            return prefix, name[len(prefix) + 1:]
    return None


def unstack_jax(arrays: dict, stacks: dict) -> dict:
    """JAX-layout ``{name: array}`` with each stack's ``[n_layers, ...]``
    leaf split into its layers' names; a value may be a
    ``{"dtype", "data"}`` tag of a checkpoint."""
    out = {}
    for name, a in arrays.items():
        hit = _stacked_leaf(name, stacks)
        if hit is None or hit[1].split(".", 1)[0].isdigit():
            out[name] = a
            continue
        prefix, rest = hit
        n = stacks[prefix]
        data = a["data"] if isinstance(a, dict) else a
        if np.shape(data)[:1] != (n,):
            raise ValueError(f"{name}: a stacked leaf of shape "
                             f"{np.shape(data)} for a stack of {n} layers")
        for li in range(n):
            piece = np.asarray(data)[li]
            out[f"{prefix}.{li}.{rest}"] = (dict(a, data=piece)
                                            if isinstance(a, dict)
                                            else piece)
    return out


def stack_jax(arrays: dict, stacks: dict) -> dict:
    """The inverse of :func:`unstack_jax`: each stack's layers' arrays
    of one leaf stacked into ``<stack>.<leaf>``."""
    out, groups = {}, {}
    for name, a in arrays.items():
        hit = _stacked_leaf(name, stacks)
        if hit is None:
            out[name] = a
            continue
        prefix, rest = hit
        li, leaf = rest.split(".", 1)
        groups.setdefault(f"{prefix}.{leaf}", {})[int(li)] = a
    for name, by_layer in groups.items():
        layers = [by_layer[li] for li in sorted(by_layer)]
        if isinstance(layers[0], dict):
            out[name] = dict(layers[0], data=np.stack(
                [a["data"] for a in layers]))
        else:
            out[name] = np.stack(layers)
    return out


def state_dtypes(model) -> dict:
    """The dotted names of ``model``'s buffers that hold a JAX state
    field, each with its JAX dtype name: each module's ``_jax_state``
    entries that are set, under the module's prefix."""
    out = {}
    for prefix, mod in model.named_modules():
        for attr, dtype in getattr(type(mod), "_jax_state", {}).items():
            if getattr(mod, attr, None) is not None:
                out[f"{prefix}.{attr}" if prefix else attr] = dtype
    return out


def to_jax_layout(name: str, a, transposed: frozenset):
    """Parameter ``name``'s array (numpy or a tensor) in the port's
    layout turned to the JAX layout, or back (a transpose is its own
    inverse); ``transposed`` is :func:`transposed_names` of the model."""
    return a.T if name in transposed else a


def to_jax_array(name: str, t: torch.Tensor, transposed: frozenset,
                 dtypes: dict) -> np.ndarray:
    """Tensor ``name`` in the JAX layout as a numpy copy: a floating one
    as fp32, an integer one in its declared JAX dtype (``dtypes``, as
    :func:`state_dtypes` gives it) or its own."""
    a = to_jax_layout(name, t.detach(), transposed)
    if a.is_floating_point():
        return a.float().cpu().numpy().copy()
    n = a.cpu().numpy()
    return n.astype(dtypes.get(name, n.dtype))


def _from_jax_array(arr) -> torch.Tensor:
    """A JAX array as a CPU tensor: floating arrays as fp32, integer ones
    as int64 (every uint32 value exactly)."""
    a = np.asarray(arr)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
        return torch.from_numpy(a.astype(np.int64))
    return torch.tensor(np.asarray(a, dtype=np.float32))


def state_tensors(model) -> dict:
    """A module's parameters and its buffers that hold a JAX state field
    (the ones the bridge copies), by name."""
    own = dict(model.named_parameters())
    copied = state_dtypes(model)
    own.update((n, b) for n, b in model.named_buffers() if n in copied)
    return own


def load_jax_params(model, params) -> None:
    """Copy a JAX model's parameters and state fields into ``model``.  A
    rank's module under a sharding strategy (``parallel.strategies``)
    loads every rank its process holds, each its pieces of the whole
    tensors."""
    from hetu_tpu_torch.parallel.strategies import sharded_of
    items = dict(params.items() if hasattr(params, "items") else params)
    items = unstack_jax(items, stack_prefixes(model))
    copied = state_dtypes(model)
    buffers = {n for n, _ in model.named_buffers() if n not in copied}
    items = {n: a for n, a in items.items()
             if n not in buffers and not n.endswith(_JAX_STATE_ONLY)}
    own = state_tensors(model)
    sharded = sharded_of(model)
    # under a strategy a rank's stack holds only its stage's blocks
    known = set(own) | (set(sharded.place) if sharded is not None
                        else set())
    unknown = sorted(set(items) - known)
    missing = sorted(known - set(items))
    if unknown or missing:
        raise ValueError(f"parameter names differ: unknown {unknown}, "
                         f"missing {missing}")
    transposed = (transposed_names(model) if sharded is None
                  else sharded.transposed)
    targets = ([own] if sharded is None
               else [state_tensors(m) for m in sharded.models])
    whole = {}
    with torch.no_grad():
        for name, arr in items.items():
            a = to_jax_layout(name, _from_jax_array(arr), transposed)
            placed = sharded is not None and name in sharded.place
            dtype = sharded.place[name].dtype if placed else own[name].dtype
            shape = (sharded.place[name].shape if placed
                     else tuple(own[name].shape))
            if tuple(a.shape) != shape:
                raise ValueError(f"{name}: JAX shape {np.shape(arr)} does "
                                 f"not map onto {shape}")
            if a.is_floating_point() != dtype.is_floating_point:
                raise ValueError(f"{name}: a JAX {np.asarray(arr).dtype} "
                                 f"array does not map onto {dtype}")
            v = a.to(dtype)
            if not a.is_floating_point() and not torch.equal(v.long(), a):
                raise ValueError(f"{name}: JAX values do not fit {dtype}")
            if placed:
                whole[name] = v
            else:
                for t in targets:
                    t[name].copy_(v)
        if whole:
            sharded.load(whole)


def export_params(model) -> dict:
    """Every state tensor of ``model`` in the JAX layout.  A rank's module
    under a sharding strategy (``parallel.strategies``) gives the full
    parameters, gathered from every rank of its mesh (on a process mesh
    every process must call it)."""
    from hetu_tpu_torch.parallel.strategies import sharded_of
    transposed = transposed_names(model)
    dtypes = state_dtypes(model)
    tensors = state_tensors(model)
    sharded = sharded_of(model)
    if sharded is not None:
        transposed = sharded.transposed
        tensors.update(sharded.full_parameters())
    return stack_jax({name: to_jax_array(name, p, transposed, dtypes)
                      for name, p in tensors.items()},
                     stack_prefixes(model))


def _host_tables(layer) -> list:
    tables = getattr(layer, "tables", None)
    return list(tables) if tables is not None else [layer.table]


# rows copied per pull / set_rows pair: bounds the buffers whatever the
# table's size
_ROWS_PER_COPY = 1 << 18


def copy_host_rows(dst, src) -> None:
    """Copy every row of ``src``'s host tables into ``dst``'s, table by
    table (the shard layouts must agree); optimizer state stays."""
    dts, sts = _host_tables(dst), _host_tables(src)
    if len(dts) != len(sts):
        raise ValueError("the two embeddings have different shard counts")
    for d, s in zip(dts, sts):
        if (d.rows, d.dim) != (s.rows, s.dim):
            raise ValueError(f"table shapes differ: {(d.rows, d.dim)} vs "
                             f"{(s.rows, s.dim)}")
        for lo in range(0, d.rows, _ROWS_PER_COPY):
            ids = np.arange(lo, min(lo + _ROWS_PER_COPY, d.rows),
                            dtype=np.int64)
            d.set_rows(ids, np.asarray(s.pull(ids), np.float32))

"""Export the port's models and functions to ONNX (counterpart of
``hetu_tpu/interop/onnx_export.py``).

Where the JAX package traces to a jaxpr, the port traces with
``torch.export.export`` (non-strict) and lowers the graph to core ATen
(``run_decompositions``); each ATen operator is then lowered to the ONNX
nodes the JAX package's exporter emits (opset 17, the same operator
vocabulary), so either package's importer reads either package's files.
``torch.onnx`` is not used: it needs the ``onnx`` and ``onnxscript``
packages.

- Parameters and buffers become initializers named by their qualified
  path (``export_module``); the example inputs become graph inputs
  ``input_0, input_1, ...`` in the flattened order of the arguments.
- A node whose tensor inputs are all constants (no parameter, no input)
  is evaluated at export time and stored as an initializer, as the JAX
  package folds its shape and iota machinery; so is a node that reads
  only another tensor's shape (``zeros_like``, ``full_like``).  Unlike
  the JAX package, operations on parameters are emitted, not folded, so
  the file holds each weight once under its own name.
- Python loops unroll in the trace; the exporter refuses a
  ``models.rnn.RNN`` called on a sequence longer than
  :data:`_SCAN_UNROLL_LIMIT` steps (the JAX package's ``scan`` limit) or
  on an empty one, before the trace runs its steps.
- The hand-written CUDA kernels cannot be traced (they launch through
  raw pointers): a graph that reaches one is refused with the kernel's
  name (``_build.KernelUnavailable``).  A model exports through its
  plain versions: build it without ``flash_attn_fn`` and without
  ``streamed_head_chunk`` / ``fused_ln``, or trace it with CPU tensors,
  where every wrapper is its plain version.
"""

from __future__ import annotations

import itertools
import operator
from typing import Callable

import numpy as np
import torch
from torch.utils import _pytree as pytree

from hetu_tpu_torch.interop import onnx_pb as pb

__all__ = ["export_fn", "export_module", "save_model"]

#: The longest recurrence unrolled into a graph (the JAX package's
#: ``scan`` limit).
_SCAN_UNROLL_LIMIT = 256

_aten = torch.ops.aten

_TORCH_TO_ONNX = {
    torch.float32: pb.FLOAT, torch.float64: pb.DOUBLE,
    torch.float16: pb.FLOAT16, torch.bfloat16: pb.BFLOAT16,
    torch.int8: pb.INT8, torch.uint8: pb.UINT8, torch.int16: pb.INT16,
    torch.int32: pb.INT32, torch.int64: pb.INT64, torch.bool: pb.BOOL,
}


def _tensor_proto(name: str, t: torch.Tensor) -> pb.TensorProto:
    """A tensor as a ``TensorProto`` (bfloat16 written through torch)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        raw = t.view(torch.int16).numpy().tobytes()
    else:
        raw = t.numpy().tobytes()
    return pb.TensorProto(name=name, dims=tuple(int(d) for d in t.shape),
                          data_type=_TORCH_TO_ONNX[t.dtype], raw_data=raw)


class _Exporter:
    def __init__(self):
        self.nodes: list[pb.NodeProto] = []
        self.initializers: dict[str, torch.Tensor] = {}
        self.names: dict = {}    # fx node -> onnx name (or a tuple of them)
        self.consts: dict = {}   # fx node -> its value, where known
        self.counter = itertools.count()

    # -- naming / plumbing -----------------------------------------------------

    def fresh(self, hint: str = "t") -> str:
        return f"{hint}_{next(self.counter)}"

    def emit(self, op: str, inputs: list, n_out: int = 1,
             hint: str | None = None, **attrs) -> list:
        outs = [self.fresh(hint or op.lower()) for _ in range(n_out)]
        attributes = tuple(pb.AttributeProto.make(k, v)
                           for k, v in attrs.items() if v is not None)
        self.nodes.append(pb.NodeProto(
            op_type=op, inputs=tuple(inputs), outputs=tuple(outs),
            name=self.fresh(f"n_{op}"), attributes=attributes))
        return outs

    def const(self, value, hint: str = "c", dtype=None) -> str:
        """Register a constant as an initializer, return its name."""
        t = (value.detach() if isinstance(value, torch.Tensor)
             else torch.as_tensor(np.asarray(value)))
        if dtype is not None:
            t = t.to(dtype)
        name = self.fresh(hint)
        self.initializers[name] = t.to("cpu")
        return name

    def ints(self, values, hint: str = "c") -> str:
        return self.const(torch.tensor([int(v) for v in values],
                                       dtype=torch.int64), hint)

    def name(self, a, dtype=None) -> str:
        """The ONNX name of an argument: a graph node's output, or a Python
        number made an initializer of ``dtype``."""
        if isinstance(a, torch.fx.Node):
            return self.names[a]
        return self.const(torch.tensor(a, dtype=dtype), "lit")

    # -- graph walk ------------------------------------------------------------

    def run(self, ep) -> tuple:
        sig = ep.graph_signature
        kinds = {s.arg.name: s for s in sig.input_specs}
        state = {**ep.state_dict, **ep.constants}
        inputs, outputs = [], []
        for node in ep.graph.nodes:
            if node.op == "placeholder":
                spec = kinds[node.name]
                if spec.kind.name == "USER_INPUT":
                    name = f"input_{len(inputs)}"
                    inputs.append((name, node.meta["val"]))
                    self.names[node] = name
                    continue
                value = state[spec.target]
                name = spec.target
                self.initializers[name] = value.detach().to("cpu")
                self.names[node] = name
                if spec.kind.name == "CONSTANT_TENSOR":
                    self.consts[node] = value.detach().to("cpu")
            elif node.op == "call_function":
                self.call(node)
            elif node.op == "output":
                for out in pytree.tree_leaves(node.args[0]):
                    outputs.append((self.names[out], out.meta["val"]))
        return inputs, outputs

    def call(self, node) -> None:
        target = node.target
        if target is operator.getitem:
            src, i = node.args
            self.names[node] = self.names[src][i]
            if src in self.consts:
                self.consts[node] = self.consts[src][i]
            return
        if target in _SKIP:
            return
        tensors = [a for a in pytree.tree_leaves((node.args, node.kwargs))
                   if isinstance(a, torch.fx.Node)]
        if target in _SHAPE_ONLY or all(a in self.consts for a in tensors):
            self.fold(node)
            return
        handler = _HANDLERS.get(target)
        if handler is None:
            raise NotImplementedError(
                f"ONNX export: unsupported operator '{target}'")
        outs = handler(self, node, *node.args, **node.kwargs)
        if isinstance(outs, str):
            outs = [outs]
        self.names[node] = outs[0] if len(outs) == 1 else tuple(outs)

    def fold(self, node) -> None:
        """Evaluate ``node`` now, on the CPU, and store its value."""
        def value(a):
            if isinstance(a, torch.fx.Node):
                if a in self.consts:
                    return self.consts[a]
                v = a.meta["val"]   # read for its shape only
                return torch.empty(v.shape, dtype=v.dtype)
            if isinstance(a, torch.device):
                return torch.device("cpu")
            return a
        args, kwargs = pytree.tree_map(value, (tuple(node.args),
                                               dict(node.kwargs)))
        if "device" in kwargs:
            kwargs["device"] = torch.device("cpu")
        out = node.target(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            self.consts[node] = out
            self.names[node] = self.const(out, "fold")
        else:
            self.consts[node] = tuple(out)
            self.names[node] = tuple(self.const(o, "fold") for o in out)


# --- operator handlers --------------------------------------------------------

_HANDLERS: dict = {}


def handler(*targets):
    def deco(fn):
        for t in targets:
            _HANDLERS[t] = fn
        return fn
    return deco


_SKIP = {_aten._assert_tensor_metadata.default, _aten._assert_scalar.default,
         _aten.sym_constrain_range_for_size.default}

# operators whose result depends on their tensor inputs' shapes only
_SHAPE_ONLY = {_aten.zeros_like.default, _aten.ones_like.default,
               _aten.full_like.default, _aten.empty_like.default,
               _aten.new_zeros.default, _aten.new_ones.default,
               _aten.new_full.default, _aten.new_empty.default}


def _val(a):
    """The traced value (a fake tensor) of a graph node, or ``a``."""
    return a.meta["val"] if isinstance(a, torch.fx.Node) else a


def _out_dtype(node):
    return node.meta["val"].dtype


def _out_shape(node) -> list:
    return [int(d) for d in node.meta["val"].shape]


def _cast_to(ex, name: str, src, dtype) -> str:
    src_dtype = _val(src).dtype if isinstance(src, torch.fx.Node) else None
    if src_dtype is None or src_dtype == dtype:
        return name
    return ex.emit("Cast", [name], to=int(_TORCH_TO_ONNX[dtype]))[0]


def _operands(ex, node, args, dtype):
    """The tensor/number operands of an elementwise node, each cast to
    ``dtype`` (torch's promotion made explicit)."""
    return [_cast_to(ex, ex.name(a, dtype), a, dtype) for a in args]


def _promoted(args):
    """torch's result type of two elementwise operands."""
    a, b = (torch.empty(_val(x).shape, dtype=_val(x).dtype, device="meta")
            if isinstance(x, torch.fx.Node) else x for x in args)
    return torch.result_type(a, b)


_UNARY = {
    _aten.neg.default: "Neg", _aten.exp.default: "Exp",
    _aten.log.default: "Log", _aten.tanh.default: "Tanh",
    _aten.sigmoid.default: "Sigmoid", _aten.sqrt.default: "Sqrt",
    _aten.abs.default: "Abs", _aten.sign.default: "Sign",
    _aten.floor.default: "Floor", _aten.ceil.default: "Ceil",
    _aten.round.default: "Round", _aten.sin.default: "Sin",
    _aten.cos.default: "Cos", _aten.erf.default: "Erf",
    _aten.reciprocal.default: "Reciprocal", _aten.relu.default: "Relu",
    _aten.logical_not.default: "Not", _aten.bitwise_not.default: "Not",
    _aten.isnan.default: "IsNaN",
}
for _t, _op in _UNARY.items():
    def _make(_op):
        def h(ex, node, x, *rest, **kw):
            return ex.emit(_op, [ex.name(x)])
        return h
    _HANDLERS[_t] = _make(_op)


@handler(_aten.rsqrt.default)
def _rsqrt(ex, node, x):
    return ex.emit("Reciprocal", ex.emit("Sqrt", [ex.name(x)]))


@handler(_aten.expm1.default)
def _expm1(ex, node, x):
    e = ex.emit("Exp", [ex.name(x)])[0]
    return ex.emit("Sub", [e, ex.const(1, "one", _out_dtype(node))])


@handler(_aten.log1p.default)
def _log1p(ex, node, x):
    one = ex.const(1, "one", _out_dtype(node))
    return ex.emit("Log", ex.emit("Add", [ex.name(x), one]))


@handler(_aten.gelu.default)
def _gelu(ex, node, x, approximate="none"):
    return ex.emit("Gelu", [ex.name(x)], approximate=approximate)


_BINARY = {
    _aten.add.Tensor: "Add", _aten.add.Scalar: "Add",
    _aten.sub.Tensor: "Sub", _aten.sub.Scalar: "Sub",
    _aten.mul.Tensor: "Mul", _aten.mul.Scalar: "Mul",
    _aten.div.Tensor: "Div", _aten.div.Scalar: "Div",
    _aten.maximum.default: "Max", _aten.minimum.default: "Min",
    _aten.pow.Tensor_Scalar: "Pow", _aten.pow.Tensor_Tensor: "Pow",
    _aten.pow.Scalar: "Pow",
}


def _make_binary(op):
    def h(ex, node, a, b, alpha=1):
        dtype = _out_dtype(node)
        if op == "Pow" and not isinstance(b, torch.fx.Node):
            # the exponent keeps its own type (an integer power of a float)
            ins = [ex.name(a), ex.name(b, dtype if dtype.is_floating_point
                                       else torch.int64)]
            return ex.emit("Pow", ins)
        ins = _operands(ex, node, [a, b], dtype)
        if alpha != 1:
            ins[1] = ex.emit("Mul", [ins[1], ex.const(alpha, "alpha",
                                                      dtype)])[0]
        return ex.emit(op, ins)
    return h


for _t, _op in _BINARY.items():
    _HANDLERS[_t] = _make_binary(_op)


@handler(_aten.div.Tensor_mode)
def _div_mode(ex, node, a, b, rounding_mode=None):
    dtype = _promoted([a, b])
    ins = _operands(ex, node, [a, b], dtype)
    if not dtype.is_floating_point:
        # integer floor division: through float64, exact for |x| < 2**53
        f = [ex.emit("Cast", [n], to=int(pb.DOUBLE))[0] for n in ins]
        q = ex.emit("Div", f)[0]
        q = ex.emit("Floor" if rounding_mode == "floor" else "Identity",
                    [q])[0]
        if rounding_mode == "trunc":
            q = _trunc(ex, q)
        return ex.emit("Cast", [q], to=int(_TORCH_TO_ONNX[dtype]))
    q = ex.emit("Div", ins)[0]
    if rounding_mode == "floor":
        return ex.emit("Floor", [q])
    if rounding_mode == "trunc":
        return [_trunc(ex, q)]
    return [q]


def _trunc(ex, q: str) -> str:
    """Round toward zero: ``sign(q) * floor(|q|)``."""
    mag = ex.emit("Floor", ex.emit("Abs", [q]))[0]
    return ex.emit("Mul", [ex.emit("Sign", [q])[0], mag])[0]


@handler(_aten.remainder.Tensor, _aten.remainder.Scalar)
def _remainder(ex, node, a, b):
    return ex.emit("Mod", _operands(ex, node, [a, b], _out_dtype(node)),
                   fmod=0)


@handler(_aten.fmod.Tensor, _aten.fmod.Scalar)
def _fmod(ex, node, a, b):
    return ex.emit("Mod", _operands(ex, node, [a, b], _out_dtype(node)),
                   fmod=1)


_CMP = {
    _aten.eq: ("Equal", False), _aten.ne: ("Equal", True),
    _aten.lt: ("Less", False), _aten.le: ("LessOrEqual", False),
    _aten.gt: ("Greater", False), _aten.ge: ("GreaterOrEqual", False),
}
for _packet, (_op, _negate) in _CMP.items():
    def _makec(_op, _negate):
        def h(ex, node, a, b):
            ins = _operands(ex, node, [a, b], _promoted([a, b]))
            out = ex.emit(_op, ins)
            return ex.emit("Not", out) if _negate else out
        return h
    _HANDLERS[_packet.Tensor] = _HANDLERS[_packet.Scalar] = _makec(_op,
                                                                    _negate)

_LOGICAL = {_aten.logical_and.default: "And", _aten.logical_or.default: "Or",
            _aten.logical_xor.default: "Xor",
            _aten.bitwise_and.Tensor: "And", _aten.bitwise_or.Tensor: "Or",
            _aten.bitwise_xor.Tensor: "Xor"}
for _t, _op in _LOGICAL.items():
    def _makel(_op):
        def h(ex, node, a, b):
            if _out_dtype(node) != torch.bool:
                raise NotImplementedError(
                    f"ONNX export: bitwise {_op} of integers")
            ins = [_cast_to(ex, ex.name(x, torch.bool), x, torch.bool)
                   for x in (a, b)]
            return ex.emit(_op, ins)
        return h
    _HANDLERS[_t] = _makel(_op)


@handler(_aten.where.self, _aten.where.ScalarSelf, _aten.where.ScalarOther,
         _aten.where.Scalar)
def _where(ex, node, cond, a, b):
    dtype = _out_dtype(node)
    ins = _operands(ex, node, [a, b], dtype)
    return ex.emit("Where", [ex.name(cond)] + ins)


@handler(_aten.masked_fill.Scalar, _aten.masked_fill.Tensor)
def _masked_fill(ex, node, x, mask, value):
    dtype = _out_dtype(node)
    ins = _operands(ex, node, [value, x], dtype)
    return ex.emit("Where", [ex.name(mask)] + ins)


@handler(_aten.clamp.default, _aten.clamp.Tensor)
def _clamp(ex, node, x, min=None, max=None):  # noqa: A002
    dtype = _out_dtype(node)
    ins = [_cast_to(ex, ex.name(x), x, dtype)]
    ins += ["" if v is None else _cast_to(ex, ex.name(v, dtype), v, dtype)
            for v in (min, max)]
    return ex.emit("Clip", ins)


@handler(_aten.clamp_min.default)
def _clamp_min(ex, node, x, min):  # noqa: A002
    return _clamp(ex, node, x, min, None)


@handler(_aten.clamp_max.default)
def _clamp_max(ex, node, x, max):  # noqa: A002
    return _clamp(ex, node, x, None, max)


@handler(_aten.hardtanh.default)
def _hardtanh(ex, node, x, min_val=-1.0, max_val=1.0):
    return _clamp(ex, node, x, min_val, max_val)


@handler(_aten.leaky_relu.default)
def _leaky(ex, node, x, negative_slope=0.01):
    return ex.emit("LeakyRelu", [ex.name(x)], alpha=float(negative_slope))


@handler(_aten._softmax.default)
def _softmax(ex, node, x, dim, half_to_float=False):
    return ex.emit("Softmax", [ex.name(x)], axis=int(dim))


@handler(_aten._log_softmax.default)
def _log_softmax(ex, node, x, dim, half_to_float=False):
    return ex.emit("LogSoftmax", [ex.name(x)], axis=int(dim))


# linear algebra ---------------------------------------------------------------


@handler(_aten.mm.default, _aten.bmm.default, _aten.matmul.default)
def _matmul(ex, node, a, b):
    return ex.emit("MatMul", [ex.name(a), ex.name(b)])


@handler(_aten.addmm.default)
def _addmm(ex, node, bias, a, b, *, beta=1, alpha=1):
    dtype = _out_dtype(node)
    prod = ex.emit("MatMul", [ex.name(a), ex.name(b)])[0]
    if alpha != 1:
        prod = ex.emit("Mul", [prod, ex.const(alpha, "alpha", dtype)])[0]
    c = ex.name(bias)
    if beta != 1:
        c = ex.emit("Mul", [c, ex.const(beta, "beta", dtype)])[0]
    return ex.emit("Add", [prod, c])


@handler(_aten.baddbmm.default)
def _baddbmm(ex, node, bias, a, b, *, beta=1, alpha=1):
    return _addmm(ex, node, bias, a, b, beta=beta, alpha=alpha)


# shape ------------------------------------------------------------------------


@handler(_aten.view.default, _aten._unsafe_view.default,
         _aten.reshape.default, _aten.unsqueeze.default,
         _aten.squeeze.dim, _aten.squeeze.dims, _aten.squeeze.default,
         _aten.view_copy.default, _aten.flatten.using_ints)
def _reshape(ex, node, x, *rest):
    return ex.emit("Reshape", [ex.name(x), ex.ints(_out_shape(node),
                                                   "shape")])


@handler(_aten.permute.default)
def _permute(ex, node, x, dims):
    rank = len(_val(x).shape)
    return ex.emit("Transpose", [ex.name(x)],
                   perm=[int(d) % rank for d in dims])


@handler(_aten.t.default, _aten.numpy_T.default)
def _t(ex, node, x):
    rank = len(_val(x).shape)
    return ex.emit("Transpose", [ex.name(x)],
                   perm=list(reversed(range(rank))))


@handler(_aten.transpose.int)
def _transpose(ex, node, x, d0, d1):
    rank = len(_val(x).shape)
    perm = list(range(rank))
    perm[d0 % rank], perm[d1 % rank] = perm[d1 % rank], perm[d0 % rank]
    return ex.emit("Transpose", [ex.name(x)], perm=perm)


@handler(_aten.expand.default, _aten.broadcast_to.default)
def _expand(ex, node, x, *rest, **kw):
    return ex.emit("Expand", [ex.name(x), ex.ints(_out_shape(node),
                                                  "shape")])


@handler(_aten.clone.default, _aten.alias.default, _aten.detach.default,
         _aten.lift_fresh_copy.default, _aten.contiguous.default)
def _identity(ex, node, x, *rest, **kw):
    return ex.emit("Identity", [ex.name(x)])


@handler(_aten._to_copy.default, _aten.to.dtype, _aten.to.dtype_layout,
         _aten.to.device, _aten.type_as.default)
def _to_copy(ex, node, x, *rest, **kw):
    dtype = _out_dtype(node)
    if _val(x).dtype == dtype:
        return ex.emit("Identity", [ex.name(x)])
    return ex.emit("Cast", [ex.name(x)], to=int(_TORCH_TO_ONNX[dtype]))


@handler(_aten.cat.default)
def _cat(ex, node, tensors, dim=0):
    dtype = _out_dtype(node)
    rank = len(_out_shape(node))
    ins = [_cast_to(ex, ex.name(t), t, dtype) for t in tensors
           if tuple(_val(t).shape) != (0,)]
    return ex.emit("Concat", ins, axis=int(dim) % rank)


@handler(_aten.slice.Tensor)
def _slice(ex, node, x, dim=0, start=None, end=None, step=1):
    shape = _val(x).shape
    dim = dim % len(shape)
    n = int(shape[dim])
    start = 0 if start is None else max(-n, min(int(start), n))
    end = n if end is None else max(-n, min(int(end), n))
    return ex.emit("Slice", [ex.name(x), ex.ints([start], "st"),
                             ex.ints([end], "en"), ex.ints([dim], "ax"),
                             ex.ints([step], "sp")])


@handler(_aten.flip.default)
def _flip(ex, node, x, dims):
    shape = _val(x).shape
    dims = [d % len(shape) for d in dims]
    return ex.emit("Slice", [
        ex.name(x), ex.ints([shape[d] - 1 for d in dims], "st"),
        ex.ints([-(shape[d] + 1) for d in dims], "en"), ex.ints(dims, "ax"),
        ex.ints([-1] * len(dims), "sp")])


@handler(_aten.select.int)
def _select(ex, node, x, dim, index):
    rank = len(_val(x).shape)
    # a 0-d index drops the axis, as select does
    idx = ex.const(torch.tensor(int(index), dtype=torch.int64), "idx")
    return ex.emit("Gather", [ex.name(x), idx], axis=int(dim) % rank)


@handler(_aten.index_select.default)
def _index_select(ex, node, x, dim, index):
    rank = len(_val(x).shape)
    return ex.emit("Gather", [ex.name(x), ex.name(index)],
                   axis=int(dim) % rank)


@handler(_aten.embedding.default)
def _embedding(ex, node, weight, indices, *rest):
    return ex.emit("Gather", [ex.name(weight), ex.name(indices)], axis=0)


@handler(_aten.index.Tensor)
def _index(ex, node, x, indices):
    live = [(i, t) for i, t in enumerate(indices) if t is not None]
    if len(live) != 1 or _val(live[0][1]).dtype == torch.bool:
        raise NotImplementedError(
            "ONNX export: advanced indexing with more than one index "
            "tensor (or a mask) on non-constant data")
    axis, idx = live[0]
    return ex.emit("Gather", [ex.name(x), ex.name(idx)], axis=axis)


@handler(_aten.split_with_sizes.default)
def _split_sizes(ex, node, x, sizes, dim=0):
    rank = len(_val(x).shape)
    return ex.emit("Split", [ex.name(x), ex.ints(sizes, "sizes")],
                   n_out=len(sizes), hint="split", axis=int(dim) % rank)


@handler(_aten.split.Tensor)
def _split(ex, node, x, size, dim=0):
    n = int(_val(x).shape[dim])
    sizes = [min(size, n - i) for i in range(0, n, size)]
    return _split_sizes(ex, node, x, sizes, dim)


@handler(_aten.repeat.default)
def _repeat(ex, node, x, repeats):
    name = ex.name(x)
    rank = len(_val(x).shape)
    if len(repeats) > rank:
        shape = [1] * (len(repeats) - rank) + list(_val(x).shape)
        name = ex.emit("Reshape", [name, ex.ints(shape, "shape")])[0]
    return ex.emit("Tile", [name, ex.ints(repeats, "reps")])


@handler(_aten.constant_pad_nd.default)
def _pad(ex, node, x, pad, value=0):
    rank = len(_val(x).shape)
    lo, hi = [0] * rank, [0] * rank
    for i in range(len(pad) // 2):
        lo[rank - 1 - i], hi[rank - 1 - i] = pad[2 * i], pad[2 * i + 1]
    if any(v < 0 for v in lo + hi):
        raise NotImplementedError(
            "negative padding not supported in ONNX export")
    cv = ex.const(value, "cv", _out_dtype(node))
    return ex.emit("Pad", [ex.name(x), ex.ints(lo + hi, "pads"), cv],
                   mode="constant")


# reductions -------------------------------------------------------------------


def _axes(x, dims) -> list:
    rank = len(_val(x).shape)
    if dims is None or len(dims) == 0:
        return list(range(rank))
    return sorted(int(d) % rank for d in dims)


@handler(_aten.sum.dim_IntList, _aten.sum.default)
def _sum(ex, node, x, dim=None, keepdim=False, *, dtype=None):
    name = _cast_to(ex, ex.name(x), x, _out_dtype(node))
    if not _val(x).shape:
        return ex.emit("Identity", [name])
    return ex.emit("ReduceSum", [name, ex.ints(_axes(x, dim), "axes")],
                   keepdims=int(keepdim))


def _reduce_attr(op):
    def h(ex, node, x, dim=None, keepdim=False, *, dtype=None):
        name = _cast_to(ex, ex.name(x), x, _out_dtype(node))
        if not _val(x).shape:
            return ex.emit("Identity", [name])
        return ex.emit(op, [name], axes=_axes(x, dim), keepdims=int(keepdim))
    return h


_HANDLERS[_aten.mean.dim] = _HANDLERS[_aten.mean.default] = \
    _reduce_attr("ReduceMean")
_HANDLERS[_aten.amax.default] = _reduce_attr("ReduceMax")
_HANDLERS[_aten.amin.default] = _reduce_attr("ReduceMin")


@handler(_aten.prod.dim_int)
def _prod(ex, node, x, dim, keepdim=False, *, dtype=None):
    name = _cast_to(ex, ex.name(x), x, _out_dtype(node))
    return ex.emit("ReduceProd", [name], axes=_axes(x, [dim]),
                   keepdims=int(keepdim))


@handler(_aten.max.dim, _aten.min.dim)
def _max_dim(ex, node, x, dim, keepdim=False):
    op = "Max" if node.target == _aten.max.dim else "Min"
    axis = _axes(x, [dim])
    vals = ex.emit(f"Reduce{op}", [ex.name(x)], axes=axis,
                   keepdims=int(keepdim))[0]
    idx = ex.emit(f"Arg{op}", [ex.name(x)], axis=axis[0],
                  keepdims=int(keepdim))[0]
    return [vals, idx]


@handler(_aten.argmax.default, _aten.argmin.default)
def _argmax(ex, node, x, dim=None, keepdim=False):
    op = "ArgMax" if node.target == _aten.argmax.default else "ArgMin"
    name = ex.name(x)
    if dim is None:
        name = ex.emit("Reshape", [name, ex.ints([-1], "flat")])[0]
        dim = 0
    out = ex.emit(op, [name], axis=_axes(x, [dim])[0] if dim else 0,
                  keepdims=int(keepdim))[0]
    return ex.emit("Cast", [out], to=int(pb.INT64))


@handler(_aten.var.correction, _aten.var.dim)
def _var(ex, node, x, dim=None, *rest, correction=None, keepdim=False,
         unbiased=None):
    if rest:   # var.dim(x, dim, unbiased, keepdim)
        unbiased = rest[0]
        keepdim = rest[1] if len(rest) > 1 else keepdim
    if correction is None:
        correction = 1 if unbiased in (None, True) else 0
    axes = _axes(x, dim)
    name = ex.name(x)
    dtype = _out_dtype(node)
    mean = ex.emit("ReduceMean", [name], axes=axes, keepdims=1)[0]
    d = ex.emit("Sub", [name, mean])[0]
    sq = ex.emit("Mul", [d, d])[0]
    n = int(np.prod([_val(x).shape[a] for a in axes]))
    s = ex.emit("ReduceSum", [sq, ex.ints(axes, "axes")],
                keepdims=int(keepdim))[0]
    return ex.emit("Div", [s, ex.const(max(n - correction, 0), "n",
                                       dtype)])


@handler(_aten.cumsum.default)
def _cumsum(ex, node, x, dim, *, dtype=None):
    name = _cast_to(ex, ex.name(x), x, _out_dtype(node))
    ax = ex.const(torch.tensor(int(dim), dtype=torch.int64), "axis")
    return ex.emit("CumSum", [name, ax], reverse=0)


@handler(_aten.topk.default)
def _topk(ex, node, x, k, dim=-1, largest=True, sorted=True):  # noqa: A002
    rank = len(_val(x).shape)
    return ex.emit("TopK", [ex.name(x), ex.ints([k], "k")], n_out=2,
                   axis=int(dim) % rank, largest=int(largest))


@handler(_aten.sort.default)
def _sort(ex, node, x, dim=-1, descending=False):
    rank = len(_val(x).shape)
    k = int(_val(x).shape[dim])
    return ex.emit("TopK", [ex.name(x), ex.ints([k], "k")], n_out=2,
                   axis=int(dim) % rank, largest=int(descending))


# NN ---------------------------------------------------------------------------


@handler(_aten.native_layer_norm.default)
def _layer_norm(ex, node, x, normalized_shape, weight=None, bias=None,
                eps=1e-5):
    if len(normalized_shape) != 1:
        raise NotImplementedError(
            "ONNX export: layer norm over more than one axis")
    users = {u.args[1] for u in node.users if u.target is operator.getitem}
    if users - {0}:
        raise NotImplementedError(
            "ONNX export: layer norm's mean / rstd outputs")
    ins = [ex.name(x)] + ["" if t is None else ex.name(t)
                          for t in (weight, bias)]
    out = ex.emit("LayerNormalization", ins, axis=-1, epsilon=float(eps))[0]
    return [out, "", ""]


@handler(_aten.convolution.default)
def _conv(ex, node, x, w, bias, stride, padding, dilation, transposed,
          output_padding, groups):
    if transposed:
        raise NotImplementedError(
            "ONNX export: input-dilated (transposed) convolution")
    ins = [ex.name(x), ex.name(w)] + ([] if bias is None
                                      else [ex.name(bias)])
    return ex.emit("Conv", ins, strides=[int(s) for s in stride],
                   dilations=[int(d) for d in dilation],
                   pads=[int(p) for p in padding] * 2, group=int(groups))


def _pool_pads(padding, nd) -> list:
    p = [int(v) for v in padding] or [0]
    p = p * nd if len(p) == 1 else p
    return p + p


@handler(_aten.max_pool2d_with_indices.default)
def _maxpool(ex, node, x, kernel, stride=(), padding=(0,), dilation=(1,),
             ceil_mode=False):
    users = {u.args[1] for u in node.users if u.target is operator.getitem}
    if users - {0} or ceil_mode or any(d != 1 for d in dilation):
        raise NotImplementedError(
            "ONNX export: max pool indices, ceil mode or dilation")
    stride = list(stride) or list(kernel)
    out = ex.emit("MaxPool", [ex.name(x)], kernel_shape=list(kernel),
                  strides=[int(s) for s in stride],
                  pads=_pool_pads(padding, len(kernel)))[0]
    return [out, ""]


@handler(_aten.avg_pool2d.default)
def _avgpool(ex, node, x, kernel, stride=(), padding=(0,), ceil_mode=False,
             count_include_pad=True, divisor_override=None):
    if ceil_mode or divisor_override is not None:
        raise NotImplementedError(
            "ONNX export: average pool ceil mode or divisor override")
    stride = list(stride) or list(kernel)
    return ex.emit("AveragePool", [ex.name(x)], kernel_shape=list(kernel),
                   strides=[int(s) for s in stride],
                   pads=_pool_pads(padding, len(kernel)),
                   count_include_pad=int(count_include_pad))


@handler(_aten._native_batch_norm_legit_no_training.default)
def _batch_norm(ex, node, x, weight, bias, mean, var, momentum, eps):
    users = {u.args[1] for u in node.users if u.target is operator.getitem}
    if users - {0}:
        raise NotImplementedError("ONNX export: batch norm's statistics")
    out = ex.emit("BatchNormalization",
                  [ex.name(t) for t in (x, weight, bias, mean, var)],
                  epsilon=float(eps))[0]
    return [out, "", ""]


# --- public API ---------------------------------------------------------------


class _Traced(torch.nn.Module):
    """``fn`` over flat tensor arguments, for ``torch.export``; ``model``
    (a module ``fn`` closes over) is held so its parameters and buffers
    are lifted as the graph's state."""

    def __init__(self, fn, in_spec, model=None):
        super().__init__()
        self.fn = fn
        self.in_spec = in_spec
        self.model = model

    def forward(self, *flat):
        args = pytree.tree_unflatten(list(flat), self.in_spec)
        return tuple(pytree.tree_leaves(self.fn(*args)))


def _check_unroll(module, args) -> None:
    """A forward pre-hook for the trace: refuse a recurrence the JAX
    package's exporter would not unroll."""
    from hetu_tpu_torch.models.rnn import RNN
    if isinstance(module, RNN) and args:
        steps = args[0].shape[1]
        if not 0 < steps <= _SCAN_UNROLL_LIMIT:
            raise NotImplementedError(
                f"ONNX export: a recurrence of {steps} steps (the unroll "
                f"limit is {_SCAN_UNROLL_LIMIT}, and 0 steps have no "
                f"outputs)")


def _trace(fn, example_args, model=None):
    flat, spec = pytree.tree_flatten(example_args)
    hook = torch.nn.modules.module.register_module_forward_pre_hook(
        lambda m, args: _check_unroll(m, args)
        if torch.compiler.is_exporting() else None)
    try:
        ep = torch.export.export(_Traced(fn, spec, model), tuple(flat),
                                 strict=False)
    finally:
        hook.remove()
    return ep.run_decompositions()


def _build(ep, name: str, rename: Callable[[str], str]) -> pb.ModelProto:
    ex = _Exporter()
    inputs, outputs = ex.run(ep)
    inputs = tuple(pb.ValueInfoProto(
        name=n, elem_type=_TORCH_TO_ONNX[v.dtype],
        shape=tuple(int(d) for d in v.shape)) for n, v in inputs)
    outputs = tuple(pb.ValueInfoProto(
        name=rename(n), elem_type=_TORCH_TO_ONNX[v.dtype],
        shape=tuple(int(d) for d in v.shape)) for n, v in outputs)
    names = {k: rename(k) for k in ex.initializers}
    inits = tuple(_tensor_proto(names[k], v)
                  for k, v in ex.initializers.items())
    nodes = tuple(pb.NodeProto(
        op_type=n.op_type, inputs=tuple(names.get(i, i) for i in n.inputs),
        outputs=n.outputs, name=n.name, attributes=n.attributes)
        for n in ex.nodes)
    graph = pb.GraphProto(name=name, nodes=nodes, initializers=inits,
                          inputs=inputs, outputs=outputs)
    return pb.ModelProto(graph=graph)


def export_fn(fn: Callable, *example_args, name: str = "hetu_tpu",
              const_names: dict | None = None) -> pb.ModelProto:
    """Trace ``fn(*example_args)`` and convert the graph to an ONNX model.

    Tensors ``fn`` closes over become initializers (a module it closes
    over: pass it to :func:`export_module` to keep the parameters'
    names); the flattened tensor arguments become graph inputs.
    ``const_names`` optionally maps ``id(tensor)`` of a closure tensor to
    the initializer name to use, as the reference's does."""
    ep = _trace(fn, example_args)
    names = {k: const_names[id(v)] for k, v in ep.constants.items()
             if const_names and id(v) in const_names}
    return _build(ep, name, lambda n: names.get(n, n))


def export_module(model: torch.nn.Module, *example_inputs,
                  name: str | None = None,
                  apply: Callable | None = None) -> pb.ModelProto:
    """Export a module: parameters and buffers become initializers named
    by their qualified path, the example inputs become graph inputs.
    ``apply(model, *inputs)`` defaults to ``model(*inputs)``."""
    apply = apply or (lambda m, *xs: m(*xs))
    ep = _trace(lambda *xs: apply(model, *xs), example_inputs, model)

    def rename(n: str) -> str:
        return n[len("model."):] if n.startswith("model.") else n
    return _build(ep, name or type(model).__name__, rename)


def save_model(proto: pb.ModelProto, path: str) -> None:
    with open(path, "wb") as f:
        f.write(proto.encode())

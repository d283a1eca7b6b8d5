"""GNN: GCN layers and models and host-side neighbour sampling
(counterpart of ``hetu_tpu/models/gnn.py``).

Aggregation is the reference's gather + segment sum over an edge list,
the sum an ``index_add`` (on CUDA it adds with atomics, so the order of
a node's sum, and its last bits, may change from run to run).
``normalize_adjacency`` computes the symmetric GCN weights in numpy
float64, as the reference does.  ``GraphConv.w`` keeps the JAX ``(in,
out)`` layout (``x @ w``), so the weight bridge copies it as it is.
``GraphIndex`` and ``sample_subgraph`` are numpy, copied.

The 1.5D partitioned pair (``dist_spmm_15d``, ``DistGCN15D``) runs over a
``gr x gc`` mesh (``parallel.mesh.make_grid_mesh``): rank ``(i, j)``
multiplies A's block ``[N/r, N/c]`` by X's shard ``[N/c, F]`` (the same on
every row of the grid), the partial products are summed over ``gc`` and
the result is row-sharded.  On a local mesh whole tensors come in and
go out, every rank's product at its own shapes on the one device, the
sum over ``gc`` the group's partials gathered and added in group order;
on a process mesh each process multiplies its own blocks and the sum is
an all-reduce over its ``gc`` group, the rows then gathered over ``gr``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from hetu_tpu_torch.core.device import resolve_device
from hetu_tpu_torch.core.prng import split
from hetu_tpu_torch.init import xavier_uniform, zeros
from hetu_tpu_torch.ops.nn import dropout
from hetu_tpu_torch.parallel import collectives as col

__all__ = ["normalize_adjacency", "spmm_edges", "dense_adjacency",
           "GraphConv", "GCN", "dist_spmm_15d", "DistGCN15D", "GraphIndex",
           "sample_subgraph"]


def normalize_adjacency(edge_index, num_nodes: int, *, add_self_loops=True,
                        device=None):
    """Symmetric GCN normalization D^-1/2 (A+I) D^-1/2 as ``(edges,
    weights)``: int32 ``(2, E)`` and fp32 ``(E,)`` tensors on ``device``
    (``None``: the CUDA device).  ``edge_index``: ``(2, E)`` (src, dst),
    numpy or a tensor."""
    device = resolve_device(device)
    if isinstance(edge_index, torch.Tensor):
        edge_index = edge_index.cpu().numpy()
    src, dst = np.asarray(edge_index)
    if add_self_loops:
        loops = np.arange(num_nodes)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
    deg = np.bincount(dst, minlength=num_nodes).astype(np.float64)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    w = dinv[src] * dinv[dst]
    return (torch.from_numpy(np.stack([src, dst]).astype(np.int32)).to(device),
            torch.from_numpy(w.astype(np.float32)).to(device))


def spmm_edges(edge_index, edge_weight, x, num_nodes: int):
    """A @ x: each edge's message ``x[src] * w`` summed into ``dst``."""
    src, dst = edge_index.long()
    msgs = x[src] * edge_weight[:, None].to(x.dtype)
    out = msgs.new_zeros((num_nodes,) + tuple(x.shape[1:]))
    return out.index_add(0, dst, msgs)


def dense_adjacency(edge_index, edge_weight, num_nodes: int):
    """The ``(N, N)`` matrix with ``a[dst, src] += w`` for each edge."""
    a = edge_weight.new_zeros((num_nodes, num_nodes))
    ei = edge_index.long()
    return a.index_put((ei[1], ei[0]), edge_weight, accumulate=True)


class GraphConv(nn.Module):
    """GCN layer: Â H W + b (Kipf & Welling), the transform first."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, initializer=None, *,
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init = initializer or xavier_uniform()
        self.w = nn.Parameter(init(generator, (in_features, out_features),
                                   dtype, device))
        self.b = (nn.Parameter(zeros(None, (out_features,), dtype, device))
                  if bias else None)
        self.in_features = in_features
        self.out_features = out_features

    def forward(self, x, edge_index, edge_weight, *, num_nodes=None):
        n = num_nodes or x.shape[0]
        h = x @ self.w.to(x.dtype)          # transform first: E F << N^2
        h = spmm_edges(edge_index, edge_weight, h, n)
        if self.b is not None:
            h = h + self.b.to(h.dtype)
        return h


class GCN(nn.Module):
    """Multi-layer GCN classifier: relu between layers, and in training
    with a ``key`` dropout after each relu, the key split once a layer
    (``key, sub = split(key)``) as in the reference."""

    def __init__(self, in_features: int, hidden: int, num_classes: int,
                 num_layers: int = 2, dropout_rate: float = 0.5, *,
                 dtype=torch.float32, generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = [in_features] + [hidden] * (num_layers - 1) + [num_classes]
        self.convs = nn.ModuleList(
            GraphConv(dims[i], dims[i + 1], dtype=dtype, generator=generator,
                      device=device) for i in range(num_layers))
        self.dropout_rate = dropout_rate

    def forward(self, x, edge_index, edge_weight, *, key=None,
                training: bool = False):
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            x = conv(x, edge_index, edge_weight)
            if i < last:
                x = torch.relu(x)
                if training and key is not None and self.dropout_rate > 0:
                    key, sub = split(key)
                    x = dropout(x, self.dropout_rate, sub, training=True)
        return x


# -- 1.5D distributed aggregation ---------------------------------------------


def dist_spmm_15d(a_dense, x, mesh, *, row_axis: str = "gr",
                  col_axis: str = "gc"):
    """1.5D partitioned ``Z = A @ X`` over a ``(row x col)`` mesh
    (DistGCN_15d.py's broadcast-and-compute loop, CAGNET's 1.5D
    algorithm): rank ``(i, j)`` holds A's block ``[N/r, N/c]`` and X's
    shard ``[N/c, F]``, its partial product is summed over ``col_axis``,
    and row block ``i`` of Z is the result (the module docstring says how
    each mesh runs it).  Differentiable in ``a_dense`` and ``x``."""
    r, c = mesh.shape[row_axis], mesh.shape[col_axis]
    n = a_dense.shape[0]
    if n % r or a_dense.shape[1] % c or a_dense.shape[1] != x.shape[0]:
        raise ValueError(f"A {tuple(a_dense.shape)} and X {tuple(x.shape)} "
                         f"do not split over {row_axis}={r} x "
                         f"{col_axis}={c}")
    rows, cols = n // r, a_dense.shape[1] // c

    def block(coords):
        i, j = coords[row_axis], coords[col_axis]
        return a_dense[i * rows:(i + 1) * rows, j * cols:(j + 1) * cols]

    if hasattr(mesh, "group"):
        coords = mesh.coords(mesh.rank)
        xs = col.copy_to_group([x], row_axis, mesh=mesh)
        xs = col.scatter_to_group(xs, col_axis, dim=0, mesh=mesh)
        z = col.all_reduce([block(coords) @ xs[0]], col_axis, mesh=mesh)
        return col.gather_from_group(z, row_axis, dim=0, mesh=mesh)[0]
    partial = []
    for rank in mesh.held:
        coords = mesh.coords(rank)
        j = coords[col_axis]
        partial.append(block(coords) @ x[j * cols:(j + 1) * cols])
    parts = col.all_gather(partial, col_axis, gather_dim=0, tiled=False,
                           mesh=mesh)
    out = []
    for rank in mesh.groups(row_axis)[0]:
        # rank (i, 0)'s gc group holds row block i's partials
        stack = parts[rank]
        z = stack[0]
        for k in range(1, c):
            z = z + stack[k]
        out.append(z)
    return torch.cat(out, dim=0)


class DistGCN15D(nn.Module):
    """GCN whose aggregation runs 1.5D-partitioned over a ``gr x gc``
    mesh (:func:`dist_spmm_15d`): ``ws.i (in, out)`` in the JAX layout
    (``x @ w``), the bias added after the aggregation, as ``GraphConv``
    adds it.  The dense-block variant (the adjacency materialized as
    ``[N, N]`` blocks) is the one for the mid-size graphs the reference's
    DistGCN examples target."""

    def __init__(self, in_features: int, hidden: int, num_classes: int,
                 mesh, num_layers: int = 2, row_axis: str = "gr",
                 col_axis: str = "gc", dtype=torch.float32, *,
                 generator=None, device=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        dims = [in_features] + [hidden] * (num_layers - 1) + [num_classes]
        init = xavier_uniform()
        self.ws = nn.ParameterList(
            nn.Parameter(init(generator, (dims[i], dims[i + 1]), dtype,
                              device)) for i in range(num_layers))
        self.bs = nn.ParameterList(
            nn.Parameter(zeros(None, (dims[i + 1],), dtype, device))
            for i in range(num_layers))
        self.mesh = mesh
        self.row_axis = row_axis
        self.col_axis = col_axis

    def forward(self, a_dense, x):
        last = len(self.ws) - 1
        for i, (w, b) in enumerate(zip(self.ws, self.bs)):
            x = x @ w.to(x.dtype)
            x = dist_spmm_15d(a_dense, x, self.mesh, row_axis=self.row_axis,
                              col_axis=self.col_axis)
            x = x + b.to(x.dtype)
            if i < last:
                x = torch.relu(x)
        return x


# -- host-side neighbor sampling (GraphMix-server capability, light) ----------


class GraphIndex:
    """CSR-style in-neighbor index built ONCE per graph and reused across
    minibatch sampling calls (the per-call work then touches only the
    sampled neighborhood, not the whole edge list)."""

    def __init__(self, edge_index):
        self.src, self.dst = (np.asarray(a) for a in edge_index)
        if self.src.size:
            self.order = np.argsort(self.dst, kind="stable")
            sorted_dst = self.dst[self.order]
            self.starts = np.searchsorted(
                sorted_dst, np.arange(int(sorted_dst.max()) + 2))
        else:
            self.order = np.zeros((0,), np.int64)
            self.starts = np.zeros((1,), np.int64)

    def in_neighbors(self, v: int) -> np.ndarray:
        if v + 1 >= len(self.starts):
            return self.src[:0]
        lo, hi = self.starts[v], self.starts[v + 1]
        return self.src[self.order[lo:hi]]


def sample_subgraph(edge_index, seed_nodes, num_hops: int = 2,
                    fanout: int = 10,
                    rng: Optional[np.random.Generator] = None,
                    index: Optional[GraphIndex] = None):
    """Uniform neighbor sampling producing an induced subgraph + relabeled
    edges (the role GraphMix sampling servers play for examples/gnn;
    dataloader.py:253 GNNDataLoaderOp feeds such blocks).

    Pass a prebuilt ``GraphIndex`` when sampling repeatedly from the same
    graph — building it is the only O(E log E) step.
    Returns (node_ids [M], sub_edge_index [2, E'], seed positions).
    """
    rng = rng or np.random.default_rng()
    index = index or GraphIndex(edge_index)
    src, dst = index.src, index.dst
    seeds = np.unique(np.asarray(seed_nodes))
    if src.size == 0:
        node_ids = np.sort(seeds).astype(np.int64)
        seed_pos = np.searchsorted(node_ids, np.asarray(seed_nodes))
        return node_ids, np.zeros((2, 0), np.int32), seed_pos.astype(np.int32)
    frontier = seeds
    nodes = set(frontier.tolist())
    for _ in range(num_hops):
        nxt = []
        for v in frontier:
            neigh = index.in_neighbors(v)
            if len(neigh) > fanout:
                neigh = rng.choice(neigh, fanout, replace=False)
            if len(neigh):
                nxt.append(neigh)
        if not nxt:
            break
        frontier = np.unique(np.concatenate(nxt))
        frontier = frontier[~np.isin(frontier, list(nodes))]
        nodes.update(frontier.tolist())
    node_ids = np.sort(np.fromiter(nodes, dtype=np.int64))
    # relabel via binary search over the (small) sampled node set — no
    # O(max_node_id) table allocation
    sub_src_parts, sub_dst_parts = [], []
    for v in node_ids:
        neigh = index.in_neighbors(int(v))
        keep = np.isin(neigh, node_ids, assume_unique=False)
        kept = neigh[keep]
        sub_src_parts.append(np.searchsorted(node_ids, kept))
        sub_dst_parts.append(
            np.full(len(kept), np.searchsorted(node_ids, v), np.int64))
    if sub_src_parts:
        sub_edges = np.stack([np.concatenate(sub_src_parts),
                              np.concatenate(sub_dst_parts)])
    else:
        sub_edges = np.zeros((2, 0), np.int64)
    seed_pos = np.searchsorted(node_ids, np.asarray(seed_nodes))
    return node_ids, sub_edges.astype(np.int32), seed_pos.astype(np.int32)

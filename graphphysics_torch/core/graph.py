"""Static-size graph containers (counterpart of
``graphphysics_tpu/core/graph.py``).

A ``Graph`` is a flat struct of arrays with padded node and edge counts.
Padding is tracked with boolean validity masks: padded nodes carry
``NodeType.PADDING`` and padded edges are self-loops on the last node, masked
out of every aggregation, loss and statistic. The host builds graphs as numpy
arrays; ``Graph.to(device)`` turns them into tensors on the device.

The port adds a receiver-sorted padding (``pad_graph_sorted_np``): edges are
stably sorted by receiver and ``row_bounds`` holds each node's ``[start, end)``
range of real edges, which is what the CUDA segment-sum kernel reads
(``ops.csr_segment``). The sender-sorted padding of the attention kernel
(``pad_graph_csr_np``, ``ops.csr_attention``) keeps its ranges apart, in
``sender_bounds``, so neither kernel can read the other's layout. The
fixed-degree ELL layout (``pad_graph_ell_np``, ``topology.ell``) groups the
edges by receiver into ``ell_degree`` slots per node and carries each slot's
reversed twin (``twin_perm``); its ops (``ops.ell_ops``) are dense reshapes
and gathers on every device.

An edge-partitioned graph (``parallel.graph_partition``) names its process
group in ``partition_axis``; its parts are stacked ``[P, ...]`` on the host
and each rank holds one (``graph[p]``). A part's edges are sorted by its
local receivers, with ``row_bounds`` over them, for both model families;
in the split-edge layout (``num_local_edges``) the local slice and the halo
slice are each sorted, with ``row_bounds`` and ``halo_row_bounds``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from graphphysics_torch.core.device import DeviceLike, resolve_device
from graphphysics_torch.ops.csr_attention import BLOCK_NODES
from graphphysics_torch.ops.csr_segment import compute_row_bounds


@dataclasses.dataclass(frozen=True)
class Graph:
    """A (possibly padded) mesh graph; fields are numpy arrays on the host or
    tensors on a device, with a leading ``[T]`` or ``[B]`` axis once stacked.

    Attributes:
        x: ``[N, F]`` raw node features (dynamic fields, node_type column,
            time column, ... per the dataset config).
        pos: ``[N, D]`` mesh positions.
        senders: ``[E]`` int32 edge sources.
        receivers: ``[E]`` int32 edge targets (the aggregation side).
        edge_attr: ``[E, Fe]`` edge features or None.
        node_mask: ``[N]`` bool, True for real nodes.
        edge_mask: ``[E]`` bool, True for real edges.
        y: ``[N, Fo]`` targets (next-frame dynamic fields) or None.
        exclude_mask: ``[N]`` bool or None; True for nodes left out of the loss.
        row_bounds: ``[2, N]`` int32 or None. Set when edges are sorted by
            receiver: node ``n``'s real edges are
            ``[row_bounds[0, n], row_bounds[1, n])``; padding edges lie
            outside every range.
        sender_bounds: ``[2, N]`` int32 or None. The same per-node ranges
            for edges sorted by sender (``pad_graph_csr_np``), read by the
            attention kernel.
        twin_perm: ``[E]`` int32 or None (ELL layout): the slot of each
            slot's reversed edge (a padding slot's is itself).
        ell_degree: int or None, not an array: with it the edges are in the
            fixed-degree ELL layout, slot ``e`` owned by node
            ``e // ell_degree`` (``receivers[e] == e // ell_degree``). It
            stays an int through ``to``, stacking and indexing.
        halo_send_idx: ``[P, B]`` int32 or None (halo mode of an
            edge-partitioned part): the local rows this rank sends to each
            peer, so senders index the exchange table ``[local rows | the
            P*B received rows]`` (``ops.halo``). Without it a partitioned
            part's senders are global ids into the all-gathered table.
        halo_row_bounds: ``[2, N]`` int32 or None: in the split-edge layout,
            each local row's range of the halo slice's edges, counted from
            the slice's start ``num_local_edges``.
        partition_axis: str or None, not an array: the name of the process
            group of an edge-partitioned graph (``parallel.mesh``).
        halo_dtype: "bf16", "f16" or None: the wire dtype of the halo
            exchange.
        num_local_edges: int or None: the split-edge layout's local slice,
            edge slots ``[0, num_local_edges)``; the halo slice follows.
    """

    x: Any
    pos: Any
    senders: Any
    receivers: Any
    edge_attr: Any
    node_mask: Any
    edge_mask: Any
    y: Any
    exclude_mask: Any = None
    row_bounds: Any = None
    sender_bounds: Any = None
    twin_perm: Any = None
    ell_degree: Optional[int] = None
    halo_send_idx: Any = None
    halo_row_bounds: Any = None
    partition_axis: Optional[str] = None
    halo_dtype: Optional[str] = None
    num_local_edges: Optional[int] = None

    @property
    def num_nodes(self) -> int:
        return self.x.shape[-2]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[-1]

    def replace(self, **kw: Any) -> "Graph":
        return dataclasses.replace(self, **kw)

    def _map(self, fn) -> "Graph":
        """``fn`` applied to every array field; the fields that are not
        arrays (``META_FIELDS``) are kept."""
        return Graph(
            **{
                f.name: (None if getattr(self, f.name) is None else fn(getattr(self, f.name)))
                for f in dataclasses.fields(self)
                if f.name not in META_FIELDS
            },
            **self.meta(),
        )

    def meta(self) -> dict:
        """The fields that are not arrays, by name."""
        return {name: getattr(self, name) for name in META_FIELDS}

    def to(self, device: DeviceLike = None) -> "Graph":
        """Move every field to ``device`` (``cuda`` unless named) as a tensor:
        floats as float32, indices as int32, masks as bool."""
        dev = resolve_device(device)

        def move(a):
            t = torch.as_tensor(a)
            if t.is_floating_point():
                t = t.to(torch.float32)
            elif t.dtype != torch.bool:
                t = t.to(torch.int32)
            return t.to(dev)

        return self._map(move)

    def __getitem__(self, i) -> "Graph":
        """Index the leading (time or batch) axis of a stacked graph."""
        return self._map(lambda a: a[i])


# fields that are not arrays: carried as they are, equal across a batch
META_FIELDS = ("ell_degree", "partition_axis", "halo_dtype", "num_local_edges")


def masked_filler(graph: Graph) -> Graph:
    """A copy of ``graph`` with every node and edge masked out: the loader's
    filler for a partial batch. Its masked edges add nothing to any segment
    sum or attention (the kernels and the plain versions skip masked
    edges), its masked nodes nothing to the loss or the normalizers."""
    return graph.replace(
        node_mask=np.zeros_like(graph.node_mask), edge_mask=np.zeros_like(graph.edge_mask)
    )


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= n."""
    return ((n + multiple - 1) // multiple) * multiple


def bucket_size(n: int, multiple: int, growth: float = 1.0) -> int:
    """Padded size for ``n``: round up to ``multiple``, optionally with
    geometric headroom (``growth > 1``) so nearby sizes share one bucket."""
    if growth > 1.0:
        m = multiple
        while m < n:
            m = round_up(int(np.ceil(m * growth)), multiple)
        return max(m, multiple)
    return round_up(max(n, 1), multiple)


def _pad_rows(a: Optional[np.ndarray], rows: int) -> Optional[np.ndarray]:
    if a is None:
        return None
    out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def pad_graph_np(
    x: np.ndarray,
    pos: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    n_pad: int,
    e_pad: int,
    edge_attr: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    node_type_index: Optional[int] = None,
    padding_node_type: int = 8,
) -> Graph:
    """Host-side padding of a raw graph to static sizes. Padded edges are
    masked self-loops on the last node (a padding node whenever
    ``n_pad > N``); padded nodes get ``padding_node_type`` in column
    ``node_type_index`` when it is given."""
    n, e = x.shape[0], senders.shape[0]
    if n_pad < n or e_pad < e:
        raise ValueError(f"pad sizes too small: nodes {n}->{n_pad}, edges {e}->{e_pad}")
    x_p = _pad_rows(x.astype(np.float32), n_pad)
    if node_type_index is not None and n_pad > n:
        x_p[n:, node_type_index] = padding_node_type
    dummy = n_pad - 1
    s_p = np.full((e_pad,), dummy, dtype=np.int32)
    r_p = np.full((e_pad,), dummy, dtype=np.int32)
    s_p[:e] = senders
    r_p[:e] = receivers
    node_mask = np.zeros((n_pad,), dtype=bool)
    node_mask[:n] = True
    edge_mask = np.zeros((e_pad,), dtype=bool)
    edge_mask[:e] = True
    return Graph(
        x=x_p,
        pos=_pad_rows(pos.astype(np.float32), n_pad),
        senders=s_p,
        receivers=r_p,
        edge_attr=_pad_rows(
            None if edge_attr is None else edge_attr.astype(np.float32), e_pad
        ),
        node_mask=node_mask,
        edge_mask=edge_mask,
        y=_pad_rows(None if y is None else y.astype(np.float32), n_pad),
    )


def _pad_sorted(by: str, x, pos, senders, receivers, n_pad, e_pad, edge_attr, y, node_type_index):
    """``pad_graph_np`` with the real edges stably sorted by ``by``
    ("receivers" or "senders") and that side's per-node ranges of real edges
    attached (``row_bounds`` or ``sender_bounds``). Padded edges (both ends
    the last node) follow every real edge, so the sorted side stays
    ascending, and the ranges stop before them: the last node's range holds
    only its real edges even when ``n_pad == N``."""
    order = np.argsort(receivers if by == "receivers" else senders, kind="stable")
    g = pad_graph_np(
        x,
        pos,
        np.asarray(senders)[order],
        np.asarray(receivers)[order],
        n_pad,
        e_pad,
        edge_attr=None if edge_attr is None else np.asarray(edge_attr)[order],
        y=y,
        node_type_index=node_type_index,
    )
    bounds = compute_row_bounds(getattr(g, by), n_pad, num_real_edges=len(order))
    return g.replace(**{"row_bounds" if by == "receivers" else "sender_bounds": bounds})


def pad_graph_sorted_np(
    x: np.ndarray,
    pos: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    n_pad: int,
    e_pad: int,
    edge_attr: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    node_type_index: Optional[int] = None,
) -> Graph:
    """``pad_graph_np`` with the real edges stably sorted by receiver and the
    per-node ``row_bounds`` of the segment-sum kernel attached (see
    ``_pad_sorted``). Node outputs equal the unsorted graph's up to
    summation order; edge arrays come out permuted by
    ``np.argsort(receivers, kind="stable")``."""
    return _pad_sorted(
        "receivers", x, pos, senders, receivers, n_pad, e_pad, edge_attr, y, node_type_index
    )


def pad_graph_csr_np(
    x: np.ndarray,
    pos: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    n_pad: int,
    e_pad: int,
    edge_attr: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    node_type_index: Optional[int] = None,
) -> Graph:
    """``pad_graph_np`` with the real edges stably sorted by sender and the
    per-node ``sender_bounds`` of the attention kernel attached (see
    ``_pad_sorted``), as the JAX package's ``pad_graph_csr_np``, whose
    per-block ranges these refine. ``n_pad`` must be a multiple of the JAX
    kernel's node block (``BLOCK_NODES`` = 128), as there."""
    if n_pad % BLOCK_NODES:
        raise ValueError(
            f"CSR layout requires node padding {n_pad} to be a multiple of "
            f"{BLOCK_NODES}; round the node budget up"
        )
    return _pad_sorted(
        "senders", x, pos, senders, receivers, n_pad, e_pad, edge_attr, y, node_type_index
    )


def pad_graph_ell_np(
    x: np.ndarray,
    pos: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    n_pad: int,
    degree: int,
    edge_attr: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    node_type_index: Optional[int] = None,
    padding_node_type: int = 8,
) -> Graph:
    """Padding into the fixed-degree ELL layout (``topology.ell``): nodes
    padded to ``n_pad``, edges grouped by receiver into ``degree`` slots per
    node (``n_pad * degree`` edge rows), with ``twin_perm`` and
    ``ell_degree`` set, as the JAX package's ``pad_graph_ell_np``. The edge
    list must be symmetric."""
    from graphphysics_torch.topology.ell import build_ell

    n = x.shape[0]
    if n_pad < n:
        raise ValueError(f"pad size too small: nodes {n}->{n_pad}")
    ell = build_ell(senders, receivers, n_pad, degree=degree)
    x_p = _pad_rows(x.astype(np.float32), n_pad)
    if node_type_index is not None and n_pad > n:
        x_p[n:, node_type_index] = padding_node_type
    ea_p = None
    if edge_attr is not None:
        ea_p = np.zeros((n_pad * degree, edge_attr.shape[1]), np.float32)
        ea_p[ell.edge_mask] = edge_attr[ell.edge_perm[ell.edge_mask]]
    node_mask = np.zeros((n_pad,), dtype=bool)
    node_mask[:n] = True
    return Graph(
        x=x_p,
        pos=_pad_rows(pos.astype(np.float32), n_pad),
        senders=ell.senders,
        receivers=ell.receivers,
        edge_attr=ea_p,
        node_mask=node_mask,
        edge_mask=ell.edge_mask,
        y=_pad_rows(None if y is None else y.astype(np.float32), n_pad),
        twin_perm=ell.twin_perm,
        ell_degree=int(degree),
    )


def stack_graphs(graphs: List[Graph]) -> Graph:
    """Stack same-shape host Graphs along a new leading (time, batch or
    part) axis; the fields that are not arrays must be equal and stay as
    they are."""
    first = graphs[0]
    for name in META_FIELDS:
        if len({getattr(g, name) for g in graphs}) != 1:
            raise ValueError(f"stack_graphs: the graphs differ in {name}")
    return Graph(
        **{
            f.name: (
                None
                if getattr(first, f.name) is None
                else np.stack([np.asarray(getattr(g, f.name)) for g in graphs], axis=0)
            )
            for f in dataclasses.fields(first)
            if f.name not in META_FIELDS
        },
        **first.meta(),
    )


def concat_graphs(graphs: List[Graph]) -> Graph:
    """Batch same-shape padded host Graphs into one flat graph, offsetting
    edge indices by each graph's node count and row or sender bounds and
    ELL twin slots by its edge count. Edges never cross graph boundaries, so
    one segment sum covers the batch, sorted members stay sorted, and ELL
    members stay ELL (slot ``e`` of the batch is owned by ``e // degree``).
    Graphs of different layouts, or ELL graphs of different degrees, are
    refused."""
    if len(graphs) == 1:
        return graphs[0]
    if any(g.partition_axis is not None for g in graphs):
        raise ValueError("concat_graphs: partitioned graphs have part-local index spaces")
    n = graphs[0].num_nodes
    e = graphs[0].num_edges
    for g in graphs:
        if g.num_nodes != n or g.num_edges != e:
            raise ValueError("concat_graphs requires identical padded shapes")
    for field in ("row_bounds", "sender_bounds", "twin_perm"):
        if len({getattr(g, field) is None for g in graphs}) != 1:
            raise ValueError(f"concat_graphs: some graphs have {field}, some not")
    if len({g.ell_degree for g in graphs}) != 1:
        raise ValueError("concat_graphs: the graphs differ in ell_degree")

    def cat(field):
        vals = [getattr(g, field) for g in graphs]
        if vals[0] is None:
            return None
        return np.concatenate([np.asarray(v) for v in vals], axis=0)

    def offset(field, step, axis=0):
        return np.concatenate(
            [np.asarray(getattr(g, field)) + i * step for i, g in enumerate(graphs)],
            axis=axis,
        ).astype(np.int32)

    return Graph(
        x=cat("x"),
        pos=cat("pos"),
        senders=offset("senders", n),
        receivers=offset("receivers", n),
        edge_attr=cat("edge_attr"),
        node_mask=cat("node_mask"),
        edge_mask=cat("edge_mask"),
        y=cat("y"),
        exclude_mask=cat("exclude_mask"),
        row_bounds=(
            None if graphs[0].row_bounds is None else offset("row_bounds", e, axis=1)
        ),
        sender_bounds=(
            None if graphs[0].sender_bounds is None else offset("sender_bounds", e, axis=1)
        ),
        twin_perm=None if graphs[0].twin_perm is None else offset("twin_perm", e),
        ell_degree=graphs[0].ell_degree,
    )


def flatten_batched_graph(g: Graph) -> Graph:
    """A stacked ``[B, N, ...]`` batch as one concat graph ``[B*N, ...]``,
    host arrays or tensors on any device (the counterpart of JAX
    ``flatten_batched_graph``, which a data-parallel device runs on its own
    rows): graph ``i``'s senders and receivers move by ``i * N``, its row or
    sender bounds and ELL twin slots by ``i * E``, as ``concat_graphs``
    moves them, whose result it equals bit for bit. A partitioned graph
    (halo or gather) has part-local index spaces and is refused."""
    if g.halo_send_idx is not None or g.partition_axis is not None:
        raise ValueError(
            "flatten_batched_graph: partitioned graphs (halo_send_idx or partition_axis set) "
            "use part-local senders and cannot be flattened; feed them to the "
            "graph-parallel step instead"
        )
    b, n, e = g.x.shape[0], g.x.shape[1], g.senders.shape[1]
    on_device = isinstance(g.x, torch.Tensor)

    def flat(a):
        return None if a is None else a.reshape((b * a.shape[1],) + tuple(a.shape[2:]))

    def shifted(a, step):
        """``a[i] + i * step``, int32 as ``concat_graphs`` gives it."""
        if a is None:
            return None
        shape = (b,) + (1,) * (a.ndim - 1)
        if on_device:
            return a + (torch.arange(b, device=a.device, dtype=a.dtype) * step).reshape(shape)
        return (np.asarray(a) + np.arange(b, dtype=np.int64).reshape(shape) * step).astype(np.int32)

    def bounds(a):
        """``[B, 2, N]`` ranges shifted by ``i * E``, as ``[2, B*N]``."""
        if a is None:
            return None
        a = shifted(a, e)
        return (a.permute(1, 0, 2) if on_device else a.transpose(1, 0, 2)).reshape(2, b * n)

    return Graph(
        x=flat(g.x),
        pos=flat(g.pos),
        senders=flat(shifted(g.senders, n)),
        receivers=flat(shifted(g.receivers, n)),
        edge_attr=flat(g.edge_attr),
        node_mask=flat(g.node_mask),
        edge_mask=flat(g.edge_mask),
        y=flat(g.y),
        exclude_mask=flat(g.exclude_mask),
        row_bounds=bounds(g.row_bounds),
        sender_bounds=bounds(g.sender_bounds),
        twin_perm=flat(shifted(g.twin_perm, e)),
        ell_degree=g.ell_degree,
    )

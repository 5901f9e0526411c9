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
(``ops.csr_segment``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from graphphysics_torch.core.device import DeviceLike, resolve_device
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

    @property
    def num_nodes(self) -> int:
        return self.x.shape[-2]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[-1]

    def replace(self, **kw: Any) -> "Graph":
        return dataclasses.replace(self, **kw)

    def _map(self, fn) -> "Graph":
        return Graph(
            **{
                f.name: (None if getattr(self, f.name) is None else fn(getattr(self, f.name)))
                for f in dataclasses.fields(self)
            }
        )

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
    per-node ``row_bounds`` of the segment-sum kernel attached. Padded edges
    (receiver = last node) follow every real edge, so receivers stay
    ascending, and the row ranges stop before them: the last node's range
    holds only its real edges even when ``n_pad == N``. Node outputs equal
    the unsorted graph's up to summation order; edge arrays come out
    permuted by ``np.argsort(receivers, kind="stable")``."""
    order = np.argsort(receivers, kind="stable")
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
    return g.replace(
        row_bounds=compute_row_bounds(g.receivers, n_pad, num_real_edges=len(order))
    )


def stack_graphs(graphs: List[Graph]) -> Graph:
    """Stack same-shape host Graphs along a new leading (time or batch) axis."""
    first = graphs[0]
    return Graph(
        **{
            f.name: (
                None
                if getattr(first, f.name) is None
                else np.stack([np.asarray(getattr(g, f.name)) for g in graphs], axis=0)
            )
            for f in dataclasses.fields(first)
        }
    )


def concat_graphs(graphs: List[Graph]) -> Graph:
    """Batch same-shape padded host Graphs into one flat graph, offsetting
    edge indices by each graph's node count and row bounds by its edge count.
    Edges never cross graph boundaries, so one segment sum covers the batch,
    and receiver-sorted members stay sorted."""
    if len(graphs) == 1:
        return graphs[0]
    n = graphs[0].num_nodes
    e = graphs[0].num_edges
    for g in graphs:
        if g.num_nodes != n or g.num_edges != e:
            raise ValueError("concat_graphs requires identical padded shapes")
    if len({g.row_bounds is None for g in graphs}) != 1:
        raise ValueError("concat_graphs: mix of sorted and unsorted graphs")

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
    )

"""Locality-aware node reordering before the partition cut (counterpart of
``graphphysics_tpu/parallel/reorder.py``).

``partition_graph_np`` cuts the node axis into contiguous equal blocks, so
the halo volume (boundary rows exchanged per layer, ``ops.halo``) depends
on the dataset's node numbering. Reordering nodes by locality first
shrinks each part's surface:

- ``rcm``: reverse Cuthill-McKee on the symmetric adjacency (scipy);
- ``bfs``: breadth-first order from node 0;
- ``hilbert``: a Morton (Z-order) code of the quantized positions.

Training is node-permutation-equivariant (losses, gradients and the
normalizers' statistics are masked sums), so a reordered step equals the
plain one up to the order of float sums; node-wise outputs map back with
``inverse_permutation``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from graphphysics_torch.core.graph import Graph, round_up


def locality_permutation(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    edge_mask: Optional[np.ndarray] = None,
    pos: Optional[np.ndarray] = None,
    method: str = "rcm",
) -> np.ndarray:
    """``perm`` with ``perm[new] = old``, ordering nodes by locality. Masked
    edges add no adjacency; isolated nodes keep their relative order; the
    result is a bijection on ``num_nodes``."""
    if method == "hilbert":
        if pos is None:
            raise ValueError("hilbert reordering needs node positions")
        return _morton_permutation(np.asarray(pos), num_nodes)
    s = np.asarray(senders).astype(np.int64)
    r = np.asarray(receivers).astype(np.int64)
    if edge_mask is not None:
        m = np.asarray(edge_mask)
        s, r = s[m], r[m]
    from scipy import sparse
    from scipy.sparse import csgraph

    adj = sparse.coo_matrix((np.ones(len(s), np.int8), (s, r)), shape=(num_nodes, num_nodes)).tocsr()
    adj = (adj + adj.T).tocsr()  # both methods want the undirected graph
    if method == "rcm":
        return np.asarray(csgraph.reverse_cuthill_mckee(adj, symmetric_mode=True), np.int64)
    if method == "bfs":
        order, _ = csgraph.breadth_first_order(adj, 0, directed=False, return_predecessors=True)
        seen = np.zeros(num_nodes, bool)
        seen[order] = True
        rest = np.flatnonzero(~seen)  # unreachable components, in index order
        return np.concatenate([order, rest]).astype(np.int64)
    raise ValueError(f"unknown reorder method {method!r}")


def _morton_permutation(pos: np.ndarray, num_nodes: int) -> np.ndarray:
    """Z-order sort of the quantized positions (16 bits a coordinate in 2-D,
    10 in 3-D)."""
    p = pos[:num_nodes].astype(np.float64)
    lo, hi = p.min(axis=0), p.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    bits = 16 // p.shape[1] * 2
    q = np.clip(((p - lo) / span * ((1 << bits) - 1)).astype(np.uint64), 0, (1 << bits) - 1)
    code = np.zeros(num_nodes, np.uint64)
    for b in range(bits):
        for d in range(p.shape[1]):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * p.shape[1] + d)
    return np.argsort(code, kind="stable").astype(np.int64)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """``inv`` with ``inv[old] = new``: ``out_orig = out_perm[inv]``."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def permute_graph_np(graph: Graph, perm: np.ndarray) -> Graph:
    """Reorder a host Graph's node rows so new row ``i`` is old row
    ``perm[i]`` and relabel the edge ends (edge order unchanged). Its
    ranges are dropped: they describe the old order, and the partitioner
    computes its own."""
    inv = inverse_permutation(np.asarray(perm))

    def rows(a):
        return None if a is None else np.asarray(a)[perm]

    return graph.replace(
        x=rows(graph.x), pos=rows(graph.pos), node_mask=rows(graph.node_mask), y=rows(graph.y),
        exclude_mask=rows(graph.exclude_mask),
        senders=inv[np.asarray(graph.senders)].astype(np.int32),
        receivers=inv[np.asarray(graph.receivers)].astype(np.int32),
        row_bounds=None, sender_bounds=None,
    )


def halo_volume(graph: Graph, num_parts: int) -> dict:
    """The halo exchange's rows per message-passing layer if ``graph`` is
    cut into ``num_parts`` contiguous blocks: ``real`` counts the distinct
    requested rows, ``budgeted`` the uniform-budget slots shipped
    (``P * (P - 1) * B``)."""
    from graphphysics_torch.parallel.graph_partition import halo_requests

    n = graph.num_nodes
    if n % num_parts:
        raise ValueError(f"num_nodes {n} not divisible by num_parts {num_parts}")
    nl = n // num_parts
    requests, max_req = halo_requests(np.asarray(graph.senders), np.asarray(graph.receivers) // nl,
                                      np.asarray(graph.edge_mask), nl, num_parts)
    real = sum(len(requests[p][q]) for p in range(num_parts) for q in range(num_parts) if q != p)
    b = max(8, round_up(max_req, 8))
    budgeted = num_parts * (num_parts - 1) * b
    return {
        "parts": num_parts,
        "halo_budget": b,
        "rows_exchanged_budgeted": budgeted,
        "rows_exchanged_real": real,
        "rows_total": n,
        "budgeted_fraction": budgeted / n,
        "real_fraction": real / n,
    }

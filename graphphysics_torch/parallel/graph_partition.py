"""Edge-partitioned graphs (counterpart of
``graphphysics_tpu/parallel/graph_partition.py``): one large mesh graph cut
into ``P`` parts, one per rank of the graph process group
(``parallel.mesh``).

- nodes split into contiguous equal blocks, so node features, targets,
  masks and the normalizers' statistics are local rows;
- every directed edge lives on the part that owns its receiver, so segment
  sums and softmaxes are local;
- the only communication is, per message-passing layer, the ``x[senders]``
  gather: an all-gather of the node table with ``partition_graph_np``, or
  an all-to-all of the boundary rows with ``partition_graph_halo_np``
  (``ops.halo``).

Every part's real edges are stably sorted by local receiver and carry the
port's per-node ranges ``row_bounds`` (``[2, Nl]``), for both model
families, so the segment-sum kernel (EncodeProcessDecode) and the softmax
kernels (EncodeTransformDecode) run on each part. This is the JAX
package's ``csr=True`` order; its ``csr=False`` (the EncodeProcessDecode
default there) keeps the input order, which changes only the order of the
sums.
The split-edge layout (``split_local=True``) sorts its local and its halo
slice apart, with ``row_bounds`` and ``halo_row_bounds``.

The parts come back stacked on a leading ``[P, ...]`` axis; rank ``p``
takes ``graph[p]``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from graphphysics_torch.core.graph import Graph, round_up, stack_graphs
from graphphysics_torch.ops.csr_segment import compute_row_bounds
from graphphysics_torch.parallel.mesh import GRAPH_AXIS


def _check_unpartitioned(graph: Graph, num_parts: int) -> int:
    if graph.partition_axis is not None:
        raise ValueError("graph is already partitioned")
    if graph.ell_degree is not None:
        raise ValueError("partitioning expects the COO layout")
    n = graph.num_nodes
    if n % num_parts:
        raise ValueError(f"num_nodes {n} not divisible by {num_parts} parts")
    return n // num_parts


def _part_edge_idx(edge_mask, part_of_edge, receivers, p) -> np.ndarray:
    """Indices of part ``p``'s real edges, stably sorted by receiver: the
    order the base partitioner and the halo sender remap share, so row
    ``i`` always describes the same edge."""
    idx = np.flatnonzero(edge_mask & (part_of_edge == p))
    return idx[np.argsort(receivers[idx], kind="stable")]


def _node_field(a, num_parts: int, nl: int):
    if a is None:
        return None
    a = np.asarray(a)
    return a.reshape((num_parts, nl) + a.shape[1:])


def _node_fields(graph: Graph, num_parts: int, nl: int) -> dict:
    return {name: _node_field(getattr(graph, name), num_parts, nl)
            for name in ("x", "pos", "node_mask", "y", "exclude_mask")}


def partition_graph_np(
    graph: Graph,
    num_parts: int,
    axis_name: str = GRAPH_AXIS,
    edge_multiple: int = 128,
    edge_budget_local: Optional[int] = None,
) -> Graph:
    """Cut an unpartitioned host Graph into ``num_parts`` parts stacked on a
    new leading axis, for the all-gather ("gather") mode: senders stay
    GLOBAL node ids, receivers are local. The node count must divide by
    ``num_parts``. Edges go to the part that owns their receiver, each
    part's real edges sorted by receiver, padded to the largest part
    rounded up to ``edge_multiple`` (or to ``edge_budget_local``) with
    masked self-loops on the part's last node, with per-part
    ``row_bounds``. Any bounds of the input are dropped."""
    nl = _check_unpartitioned(graph, num_parts)
    senders = np.asarray(graph.senders)
    receivers = np.asarray(graph.receivers)
    edge_mask = np.asarray(graph.edge_mask)
    part_of_edge = receivers // nl
    # budget and assign real edges only: the input's padding edges all point
    # at the last node and would inflate the last part's count
    counts = np.bincount(part_of_edge[edge_mask], minlength=num_parts)
    el = edge_budget_local or round_up(int(counts.max()), edge_multiple)
    if counts.max() > el:
        raise ValueError(f"edge_budget_local {el} < max part edges {int(counts.max())}")

    s_p = np.zeros((num_parts, el), np.int32)
    r_p = np.zeros((num_parts, el), np.int32)
    m_p = np.zeros((num_parts, el), bool)
    ea = None if graph.edge_attr is None else np.asarray(graph.edge_attr)
    ea_p = None if ea is None else np.zeros((num_parts, el, ea.shape[1]), ea.dtype)
    bounds = np.zeros((num_parts, 2, nl), np.int32)
    for p in range(num_parts):
        idx = _part_edge_idx(edge_mask, part_of_edge, receivers, p)
        k = len(idx)
        # padding: a self-loop on the part's last node; receiver nl - 1 keeps
        # the receiver sort ascending end to end
        s_p[p] = p * nl + nl - 1
        r_p[p] = nl - 1
        s_p[p, :k] = senders[idx]
        r_p[p, :k] = receivers[idx] - p * nl
        m_p[p, :k] = True
        if ea_p is not None:
            ea_p[p, :k] = ea[idx]
        bounds[p] = compute_row_bounds(r_p[p], nl, num_real_edges=k)

    return Graph(
        senders=s_p, receivers=r_p, edge_attr=ea_p, edge_mask=m_p, row_bounds=bounds,
        partition_axis=axis_name, **_node_fields(graph, num_parts, nl),
    )


def halo_requests(senders, part_of_edge, edge_mask, nl: int, num_parts: int):
    """``(requests, max_req)``: ``requests[p][q]`` are the sorted unique LOCAL
    row ids of part ``q`` that part ``p`` needs (``q != p``), ``max_req``
    the longest. Masked edges request nothing."""
    requests: List[List[np.ndarray]] = [[np.empty(0, np.int64)] * num_parts for _ in range(num_parts)]
    max_req = 0
    for p in range(num_parts):
        s_glob = senders[(part_of_edge == p) & edge_mask]
        owners = s_glob // nl
        for q in range(num_parts):
            if q == p:
                continue
            uniq = np.unique(s_glob[owners == q] - q * nl)
            requests[p][q] = uniq
            max_req = max(max_req, len(uniq))
    return requests, max_req


def _halo_budget_and_send(requests, max_req, num_parts, halo_multiple, halo_budget):
    """The uniform halo budget ``B`` and the ``[P, P, B]`` send table (row
    ``[q, p]``: the local rows part ``q`` sends to part ``p``), shared by
    the plain and split-edge halo layouts."""
    b = halo_budget or max(halo_multiple, round_up(max_req, halo_multiple))
    if max_req > b:
        raise ValueError(f"halo_budget {b} < max boundary rows {max_req}")
    halo_send = np.zeros((num_parts, num_parts, b), np.int32)
    for p in range(num_parts):
        for q in range(num_parts):
            req = requests[p][q]
            halo_send[q, p, : len(req)] = req
    return b, halo_send


def _remap_senders(s_glob, requests_p, p, nl, b, num_parts, fill) -> np.ndarray:
    """Global senders of part ``p``'s edges as exchange-table rows: a local
    sender its local row, a remote one (owner ``q``, request slot ``r``)
    ``nl + q * b + r``; ``fill`` where neither applies."""
    owners = s_glob // nl
    local = (s_glob - owners * nl).astype(np.int64)
    out = np.full(len(s_glob), fill, np.int32)
    own = owners == p
    out[own] = local[own]
    for q in range(num_parts):
        if q == p:
            continue
        sel = owners == q
        if sel.any():
            out[sel] = nl + q * b + np.searchsorted(requests_p[q], local[sel])
    return out


def partition_graph_halo_np(
    graph: Graph,
    num_parts: int,
    axis_name: str = GRAPH_AXIS,
    edge_multiple: int = 128,
    edge_budget_local=None,
    halo_multiple: int = 8,
    halo_budget: Optional[int] = None,
    split_local: bool = False,
    requests=None,
) -> Graph:
    """Partition for the halo exchange: as ``partition_graph_np``, but the
    senders are remapped into the per-part exchange table ``[Nl local rows
    | P * B received rows]`` (the row part ``q`` sends at request slot
    ``r`` sits at ``Nl + q * B + r``) and ``halo_send_idx`` (stacked
    ``[P, P, B]``, row ``[q, p]`` the local rows part ``q`` sends to part
    ``p``) carries the send lists. ``B`` is the largest request between any
    two parts, rounded up to ``halo_multiple`` (or ``halo_budget``).

    ``split_local=True`` lays each part's edges out ``[local | halo]``
    (``num_local_edges``): the edges whose sender is a local row first, then
    those that need a received row, each slice sorted by receiver with its
    own ranges (``row_bounds``, ``halo_row_bounds``), so attention can
    compute the local partial before the exchange has arrived.
    ``edge_budget_local`` is then a ``(local, halo)`` pair. ``requests``
    (from ``halo_requests``) skips their computation."""
    if split_local:
        return _partition_halo_split(graph, num_parts, axis_name, edge_multiple,
                                     edge_budget_local, halo_multiple, halo_budget, requests)
    base = partition_graph_np(graph, num_parts, axis_name, edge_multiple, edge_budget_local)
    nl = graph.num_nodes // num_parts
    senders = np.asarray(graph.senders)
    receivers = np.asarray(graph.receivers)
    edge_mask = np.asarray(graph.edge_mask)
    part_of_edge = receivers // nl
    if requests is None:
        requests = halo_requests(senders, part_of_edge, edge_mask, nl, num_parts)
    reqs, max_req = requests
    b, halo_send = _halo_budget_and_send(reqs, max_req, num_parts, halo_multiple, halo_budget)
    # padding slots point at the part's last local row (masked out)
    s_new = np.full(base.senders.shape, nl - 1, np.int32)
    for p in range(num_parts):
        idx = _part_edge_idx(edge_mask, part_of_edge, receivers, p)
        s_new[p, : len(idx)] = _remap_senders(senders[idx], reqs[p], p, nl, b, num_parts, nl - 1)
    return base.replace(senders=s_new, halo_send_idx=halo_send)


def _partition_halo_split(graph, num_parts, axis_name, edge_multiple, edge_budget_local,
                          halo_multiple, halo_budget, requests) -> Graph:
    """``partition_graph_halo_np(split_local=True)``: the ``[local | halo]``
    layout, built directly because its edge order (two sorted slices)
    differs from ``partition_graph_np``'s."""
    nl = _check_unpartitioned(graph, num_parts)
    senders = np.asarray(graph.senders)
    receivers = np.asarray(graph.receivers)
    edge_mask = np.asarray(graph.edge_mask)
    part_of_edge = receivers // nl
    if requests is None:
        requests = halo_requests(senders, part_of_edge, edge_mask, nl, num_parts)
    reqs, max_req = requests
    b, halo_send = _halo_budget_and_send(reqs, max_req, num_parts, halo_multiple, halo_budget)

    locs, hals = [], []
    for p in range(num_parts):
        idx = np.flatnonzero(edge_mask & (part_of_edge == p))
        owners = senders[idx] // nl
        loc, hal = idx[owners == p], idx[owners != p]
        locs.append(loc[np.argsort(receivers[loc], kind="stable")])
        hals.append(hal[np.argsort(receivers[hal], kind="stable")])
    most_loc = max(len(x) for x in locs)
    most_hal = max(len(x) for x in hals)
    if edge_budget_local is not None:
        el, eh = edge_budget_local
    else:
        el = round_up(most_loc, edge_multiple)
        eh = round_up(max(most_hal, 1), edge_multiple)
    if most_loc > el or most_hal > eh:
        raise ValueError(f"edge budgets (local {el}, halo {eh}) < max part edges "
                         f"({most_loc}, {most_hal})")
    e_tot = el + eh

    s_p = np.zeros((num_parts, e_tot), np.int32)
    r_p = np.full((num_parts, e_tot), nl - 1, np.int32)
    m_p = np.zeros((num_parts, e_tot), bool)
    ea = None if graph.edge_attr is None else np.asarray(graph.edge_attr)
    ea_p = None if ea is None else np.zeros((num_parts, e_tot, ea.shape[1]), ea.dtype)
    bounds_loc = np.zeros((num_parts, 2, nl), np.int32)
    bounds_hal = np.zeros((num_parts, 2, nl), np.int32)
    for p in range(num_parts):
        loc, hal = locs[p], hals[p]
        kl, kh = len(loc), len(hal)
        # local slice: local sender rows; padding a masked self-loop on the
        # last local row (keeps the receiver sort ascending)
        s_p[p, :el] = nl - 1
        s_p[p, :kl] = senders[loc] - p * nl
        r_p[p, :kl] = receivers[loc] - p * nl
        m_p[p, :kl] = True
        # halo slice: senders index the table's received rows; padding
        # points at the first of them (masked out)
        s_p[p, el:] = nl
        s_p[p, el : el + kh] = _remap_senders(senders[hal], reqs[p], p, nl, b, num_parts, nl)
        r_p[p, el : el + kh] = receivers[hal] - p * nl
        m_p[p, el : el + kh] = True
        if ea_p is not None:
            ea_p[p, :kl] = ea[loc]
            ea_p[p, el : el + kh] = ea[hal]
        bounds_loc[p] = compute_row_bounds(r_p[p, :el], nl, num_real_edges=kl)
        bounds_hal[p] = compute_row_bounds(r_p[p, el:], nl, num_real_edges=kh)

    return Graph(
        senders=s_p, receivers=r_p, edge_attr=ea_p, edge_mask=m_p,
        row_bounds=bounds_loc, halo_row_bounds=bounds_hal, halo_send_idx=halo_send,
        partition_axis=axis_name, num_local_edges=el, **_node_fields(graph, num_parts, nl),
    )


def unpartition_rows(stacked: np.ndarray) -> np.ndarray:
    """``[P, Nl, ...]`` node-wise output back to ``[N, ...]`` (the parts are
    contiguous)."""
    a = np.asarray(stacked)
    return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


def frame_budgets(frames: Sequence[Graph], num_parts: int, split_local: bool = False):
    """The per-part edge budget shared by every frame (the largest part
    rounded up to 128), or with ``split_local`` the ``(local, halo)``
    pair."""
    nl = frames[0].num_nodes // num_parts
    budget = el_max = eh_max = 0
    for f in frames:
        em = np.asarray(f.edge_mask)
        part = (np.asarray(f.receivers) // nl)[em]
        budget = max(budget, round_up(int(np.bincount(part, minlength=num_parts).max()), 128))
        if split_local:
            owner = (np.asarray(f.senders) // nl)[em]
            loc = np.bincount(part[owner == part], minlength=num_parts)
            hal = np.bincount(part[owner != part], minlength=num_parts)
            el_max = max(el_max, round_up(int(loc.max()), 128))
            eh_max = max(eh_max, round_up(max(int(hal.max()), 1), 128))
    return (el_max, eh_max) if split_local else budget


def partition_frames_np(
    frames: Sequence[Graph],
    num_parts: int,
    axis_name: str = GRAPH_AXIS,
    halo: bool = False,
    split_local: bool = False,
) -> Graph:
    """Partition every frame of a trajectory alike and stack them to leaves
    ``[T, P, ...]``: the input of ``parallel.dp.partitioned_rollout`` (rank
    ``p`` takes ``frames[:, p]``). The frames share the node split; the edge
    budgets (and with ``halo`` the halo budget) are the largest over the
    frames, so every frame has one shape. ``split_local`` (halo only) takes
    the ``[local | halo]`` layout."""
    if split_local and not halo:
        raise ValueError("split_local requires halo=True")
    nl = frames[0].num_nodes // num_parts
    eb = frame_budgets(frames, num_parts, split_local)
    if halo:
        per_frame = [halo_requests(np.asarray(f.senders), np.asarray(f.receivers) // nl,
                                   np.asarray(f.edge_mask), nl, num_parts) for f in frames]
        halo_b = max([8] + [round_up(r[1], 8) for r in per_frame])
        parts = [
            partition_graph_halo_np(f, num_parts, axis_name, edge_budget_local=eb,
                                    halo_budget=halo_b, split_local=split_local, requests=req)
            for f, req in zip(frames, per_frame)
        ]
    else:
        parts = [partition_graph_np(f, num_parts, axis_name, edge_budget_local=eb) for f in frames]
    return stack_graphs(parts)


def part_of(stacked: Graph, rank: int, axis: int = 0) -> Graph:
    """Rank ``rank``'s part of a stacked partitioned graph: leaves
    ``[P, ...]`` (``axis=0``) or ``[T, P, ...]`` (``axis=1``)."""
    if axis == 0:
        return stacked[rank]
    return stacked._map(lambda a: a[:, rank])


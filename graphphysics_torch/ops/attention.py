"""Sparse (mesh-adjacency-masked) multi-head attention on edge lists
(counterpart of ``graphphysics_tpu/ops/attention.py``).

As in the reference, node ``i`` takes a softmax over its out-edges
``(i -> j)`` of ``<q_i, k_j>`` and sums ``v_j``: the softmax segment is
``senders`` and keys/values are gathered at ``receivers``.

Three branches are ported. With ``sender_bounds`` (a sender-sorted graph
from ``pad_graph_csr_np``) the attention goes through
``ops.csr_attention.csr_sparse_attention``, which on CUDA is one fused
Hopper kernel forward and one backward. With ``ell_degree`` (an ELL graph,
``pad_graph_ell_np``) it is the dense ELL ops of ``ops.ell_ops`` on either
device: the query is the slot owner (``receivers``) and keys and values
come from ``senders``, the transpose of the COO convention, equal to it on
the symmetric mesh adjacency. Without either, the plain COO branch:
``segment_softmax`` and a masked segment sum, on the CPU only; a CUDA
tensor with neither raises, and nothing falls back to another path.

An edge-partitioned part (``partition_axis`` set, ``parallel``) takes q at
its LOCAL receivers, k and v at ``senders`` from the exchange table (the
halo exchange, or the all-gathered rows: ``ops.halo``), and segments the
softmax by receivers, as the JAX package does; on the symmetric mesh
adjacency this equals the COO convention. Unsplit, the softmax and the
weighted sum are ``csr_softmax_spmm`` over the part's receiver ranges
(``row_bounds``): K2 forward and K3 backward on CUDA. In the split-edge
layout (``num_local_edges``) the exchange is started first, the local
edges' gathers and scores are computed while it is in flight, and after
it the halo edges'; both sets then go through ``csr_softmax_spmm_pair``
(K5 on CUDA), whose online softmax merges them.
"""

from __future__ import annotations

from typing import Optional

import torch

from graphphysics_torch.ops import halo
from graphphysics_torch.ops.csr_attention import (
    EPS,
    NEG,
    csr_softmax_spmm,
    csr_softmax_spmm_pair,
    csr_sparse_attention,
)
from graphphysics_torch.ops.ell_ops import ell_gather, ell_repeat, ell_segment_sum, ell_softmax
from graphphysics_torch.ops.segment import masked_segment_sum, segment_softmax, take_rows


def sparse_graph_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    senders: torch.Tensor,
    receivers: torch.Tensor,
    num_nodes: int,
    edge_mask: Optional[torch.Tensor] = None,
    scale: float = 1.0,
    sender_bounds: Optional[torch.Tensor] = None,
    ell_degree: Optional[int] = None,
    twin_perm: Optional[torch.Tensor] = None,
    row_bounds: Optional[torch.Tensor] = None,
    partition_axis: Optional[str] = None,
    halo_send_idx: Optional[torch.Tensor] = None,
    halo_dtype: Optional[str] = None,
    halo_row_bounds: Optional[torch.Tensor] = None,
    num_local_edges: Optional[int] = None,
    gather_csr=None,
) -> torch.Tensor:
    """Adjacency-masked attention. ``q``, ``k``, ``v`` are ``[N, H, Dh]``
    per-head projections, ``senders``/``receivers`` the ``[E]`` edge list,
    ``edge_mask`` the ``[E]`` validity of padded edges, ``scale`` multiplies
    the scores and ``sender_bounds`` (``[2, N]``, ``Graph.sender_bounds``)
    selects the CSR branch, ``ell_degree`` with ``twin_perm`` the ELL one,
    ``partition_axis`` the partitioned ones (with the part's
    ``row_bounds``, ``halo_send_idx``, ``halo_dtype`` and, split,
    ``halo_row_bounds`` and ``num_local_edges``; ``Graph``'s fields).
    ``gather_csr`` (``ops.csr_attention.gather_csr`` of the graph) is what
    the CSR branch's bf16 backward on CUDA sums dk and dv over. Returns
    ``[N, H, Dh]``.

    The per-head dot accumulates in f32, as in the JAX package. In the COO
    branch edge-sized intermediates stay 2-D ``[E, H*Dh]`` with head-blocked
    columns; the CSR branch on CUDA has none."""
    if partition_axis is not None:
        return _partitioned_attention(
            q, k, v, senders, receivers, num_nodes, edge_mask, scale, row_bounds, partition_axis,
            halo_send_idx, halo_dtype, halo_row_bounds, num_local_edges)
    if sender_bounds is not None:
        return csr_sparse_attention(
            q, k, v, senders, receivers, sender_bounds, edge_mask=edge_mask, scale=scale,
            gather=gather_csr,
        )
    n, h, dh = q.shape
    d = h * dh
    scores_of, weight = _edge_math(q.dtype, scale, h, dh)

    if ell_degree is not None:
        q_e = ell_repeat(q.reshape(n, d), ell_degree)
        kv_e = ell_gather(torch.cat([k.reshape(n, d), v.reshape(n, d)], dim=1), senders,
                          twin_perm, ell_degree)
        k_e, v_e = kv_e[:, :d], kv_e[:, d:]
        attn = ell_softmax(scores_of(q_e, k_e), ell_degree, edge_mask)
        return ell_segment_sum(weight(v_e, attn), ell_degree, edge_mask).reshape(num_nodes, h, dh)
    if q.is_cuda:
        raise ValueError(
            "sparse_graph_attention on CUDA needs a sender-sorted graph with "
            "sender_bounds (build it with pad_graph_csr_np) or an ELL graph"
        )
    q_e = take_rows(q.reshape(n, d), senders)
    k_e = take_rows(k.reshape(n, d), receivers)
    v_e = take_rows(v.reshape(n, d), receivers)
    attn = segment_softmax(scores_of(q_e, k_e), senders, num_nodes, mask=edge_mask)  # [E, H]
    out = masked_segment_sum(weight(v_e, attn), senders, num_nodes, mask=edge_mask)
    return out.reshape(num_nodes, h, dh)


def _edge_math(dtype, scale, h, dh):
    """``(scores_of, weight)``: ``[E, d] x2 -> [E, H]`` per-head dots in
    f32 times the scale (rounded to ``dtype`` first, as the JAX package's
    ``jnp.asarray``), and ``[E, d], [E, H] -> [E, d]`` head weighting."""
    scale_f32 = torch.tensor(scale, dtype=dtype).to(torch.float32).item()

    def scores_of(q_e, k_e):
        prod = q_e.to(torch.float32) * k_e.to(torch.float32)
        return prod.reshape(q_e.shape[0], h, dh).sum(dim=-1) * scale_f32

    def weight(v_e, attn):
        return (v_e.reshape(v_e.shape[0], h, dh) * attn[:, :, None].to(v_e.dtype)).reshape(-1, h * dh)

    return scores_of, weight


def _partitioned_attention(q, k, v, senders, receivers, num_nodes, edge_mask, scale, row_bounds,
                           partition_axis, halo_send_idx, halo_dtype, halo_row_bounds,
                           num_local_edges):
    """The partitioned branches (JAX ``sparse_graph_attention``'s
    ``partition_axis`` branch and ``_overlapped_partitioned_attention``)."""
    n, h, dh = q.shape
    d = h * dh
    q2 = q.reshape(n, d)
    kv2 = torch.cat([k.reshape(n, d), v.reshape(n, d)], dim=1)
    scores_of, weight = _edge_math(q.dtype, scale, h, dh)
    if num_local_edges is not None and halo_send_idx is not None:
        return _overlapped_partitioned_attention(
            q2, kv2, senders, receivers, num_nodes, edge_mask, row_bounds, halo_row_bounds,
            partition_axis, halo_send_idx, halo_dtype, num_local_edges, h, dh, scores_of, q.dtype)
    # every edge gather reads the exchange table: all of it after the exchange
    kv_e = halo.partitioned_gather(kv2, senders, partition_axis, halo_send_idx, halo_dtype)
    q_e = take_rows(q2, receivers)
    k_e, v_e = kv_e[:, :d], kv_e[:, d:]
    scores = scores_of(q_e, k_e)  # [E, H] f32
    if row_bounds is not None:
        out, _ = csr_softmax_spmm(scores, v_e.to(torch.float32).contiguous(), receivers,
                                  row_bounds, edge_mask)
        return out.reshape(num_nodes, h, dh).to(q.dtype)
    if q.is_cuda:
        raise ValueError("partitioned attention on CUDA needs the part's row_bounds "
                         "(parallel.graph_partition lays them out)")
    attn = segment_softmax(scores, receivers, num_nodes, mask=edge_mask)
    out = masked_segment_sum(weight(v_e, attn), receivers, num_nodes, mask=edge_mask)
    return out.reshape(num_nodes, h, dh)


def _partial_softmax_spmm(scores, values, seg, num_nodes, mask, h, dh):
    """One edge subset's unmerged online-softmax partial, per node
    ``(acc, m, l)`` in f32 with ``acc = sum exp(s - m) * v``; rows without
    unmasked edges in the subset get ``m = -1e30``, ``l = 0``, ``acc = 0``
    (JAX ``_partial_softmax_spmm``)."""
    e = scores.shape[0]
    seg = seg.to(torch.int64)
    if mask is not None:
        scores = torch.where(mask[:, None], scores, torch.full((), NEG, dtype=scores.dtype))
    m = torch.full((num_nodes, h), NEG, dtype=scores.dtype, device=scores.device)
    m = m.scatter_reduce(0, seg[:, None].expand(e, h), scores, "amax", include_self=True)
    p = torch.exp(scores - m.index_select(0, seg))
    if mask is not None:
        p = torch.where(mask[:, None], p, torch.zeros((), dtype=p.dtype))
    l = torch.zeros((num_nodes, h), dtype=p.dtype, device=p.device).index_add(0, seg, p)
    weighted = (values.to(torch.float32).reshape(e, h, dh) * p[:, :, None]).reshape(e, h * dh)
    acc = torch.zeros((num_nodes, h * dh), dtype=p.dtype, device=p.device).index_add(0, seg, weighted)
    return acc, m, l


def _overlapped_partitioned_attention(q2, kv2, senders, receivers, num_nodes, edge_mask,
                                      row_bounds, halo_row_bounds, partition_axis, halo_send_idx,
                                      halo_dtype, num_local_edges, h, dh, scores_of, out_dtype):
    """Split-edge partitioned attention: the exchange starts first, the
    local edges' gathers and scores (no received row among their inputs)
    run while it is in flight, then the halo edges', whose senders index
    the received rows (``senders - Nl``); the two sets' softmax + SpMM
    merge by their ``(m, l)``: ``csr_softmax_spmm_pair`` over the slices'
    own ranges, or without ranges (CPU) the plain partials and merge."""
    d = h * dh
    nl, el = num_nodes, num_local_edges
    s_loc, r_loc = senders[:el], receivers[:el]
    s_hal, r_hal = senders[el:] - nl, receivers[el:]  # table rows -> received rows
    m_loc = None if edge_mask is None else edge_mask[:el]
    m_hal = None if edge_mask is None else edge_mask[el:]

    pending = halo.halo_recv(kv2, halo_send_idx, partition_axis, halo_dtype, async_op=True)
    q_loc = take_rows(q2, r_loc)
    kv_loc = take_rows(kv2, s_loc)
    scores_loc = scores_of(q_loc, kv_loc[:, :d])  # [El, H] f32
    recv = pending.wait()
    q_hal = take_rows(q2, r_hal)
    kv_hal = take_rows(recv, s_hal)
    scores_hal = scores_of(q_hal, kv_hal[:, :d])  # [Eh, H] f32

    if row_bounds is not None:
        out, _ = csr_softmax_spmm_pair(
            scores_loc, kv_loc[:, d:].to(torch.float32).contiguous(), r_loc, row_bounds,
            scores_hal, kv_hal[:, d:].to(torch.float32).contiguous(), r_hal, halo_row_bounds,
            m_loc, m_hal)
        return out.reshape(num_nodes, h, dh).to(out_dtype)
    if q2.is_cuda:
        raise ValueError("split-edge attention on CUDA needs the slices' row_bounds and "
                         "halo_row_bounds (parallel.graph_partition lays them out)")
    acc_l, mx_l, l_l = _partial_softmax_spmm(scores_loc, kv_loc[:, d:], r_loc, nl, m_loc, h, dh)
    acc_h, mx_h, l_h = _partial_softmax_spmm(scores_hal, kv_hal[:, d:], r_hal, nl, m_hal, h, dh)
    mx = torch.maximum(mx_l, mx_h)
    wl, wh = torch.exp(mx_l - mx), torch.exp(mx_h - mx)
    l = wl * l_l + wh * l_h  # [N, H]
    acc = wl.repeat_interleave(dh, dim=1) * acc_l + wh.repeat_interleave(dh, dim=1) * acc_h
    out = acc / (l.repeat_interleave(dh, dim=1) + EPS)
    return out.reshape(num_nodes, h, dh).to(out_dtype)

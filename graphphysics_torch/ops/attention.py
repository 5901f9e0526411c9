"""Sparse (mesh-adjacency-masked) multi-head attention on edge lists
(counterpart of ``graphphysics_tpu/ops/attention.py``).

As in the reference, node ``i`` takes a softmax over its out-edges
``(i -> j)`` of ``<q_i, k_j>`` and sums ``v_j``: the softmax segment is
``senders`` and keys/values are gathered at ``receivers``.

Two branches are ported. With ``sender_bounds`` (a sender-sorted graph from
``pad_graph_csr_np``) the softmax + SpMM goes through
``ops.csr_attention.csr_sparse_attention``, which on CUDA is the Hopper
kernel. Without it, the plain COO branch: ``segment_softmax`` and a masked
segment sum, on the CPU only; a CUDA tensor without ``sender_bounds``
raises, and nothing falls back to another path. The partitioned, halo,
split-edge and ELL branches of the JAX package come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from graphphysics_torch.ops.csr_attention import csr_sparse_attention
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
) -> torch.Tensor:
    """Adjacency-masked attention. ``q``, ``k``, ``v`` are ``[N, H, Dh]``
    per-head projections, ``senders``/``receivers`` the ``[E]`` edge list,
    ``edge_mask`` the ``[E]`` validity of padded edges, ``scale`` multiplies
    the scores and ``sender_bounds`` (``[2, N]``, ``Graph.sender_bounds``)
    selects the CSR branch. Returns ``[N, H, Dh]``.

    Edge-sized intermediates stay 2-D ``[E, H*Dh]`` with head-blocked
    columns, and the per-head dot accumulates in f32, as in the JAX package."""
    if sender_bounds is not None:
        return csr_sparse_attention(
            q, k, v, senders, receivers, sender_bounds, edge_mask=edge_mask, scale=scale
        )
    if q.is_cuda:
        raise ValueError(
            "sparse_graph_attention on CUDA needs a sender-sorted graph with "
            "sender_bounds (build it with pad_graph_csr_np)"
        )
    n, h, dh = q.shape
    d = h * dh
    q_e = take_rows(q.reshape(n, d), senders)
    k_e = take_rows(k.reshape(n, d), receivers)
    v_e = take_rows(v.reshape(n, d), receivers)
    e = q_e.shape[0]
    prod = q_e.to(torch.float32) * k_e.to(torch.float32)
    scores = prod.reshape(e, h, dh).sum(dim=-1) * scale
    attn = segment_softmax(scores, senders, num_nodes, mask=edge_mask)  # [E, H]
    weighted = (v_e.reshape(e, h, dh) * attn[:, :, None].to(v_e.dtype)).reshape(e, d)
    out = masked_segment_sum(weighted, senders, num_nodes, mask=edge_mask)
    return out.reshape(num_nodes, h, dh)

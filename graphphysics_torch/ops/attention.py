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
tensor with neither raises, and nothing falls back to another path. The
partitioned, halo and split-edge branches of the JAX package are not ported
yet (ROADMAP.md section 1, item 14).
"""

from __future__ import annotations

from typing import Optional

import torch

from graphphysics_torch.ops.csr_attention import csr_sparse_attention
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
) -> torch.Tensor:
    """Adjacency-masked attention. ``q``, ``k``, ``v`` are ``[N, H, Dh]``
    per-head projections, ``senders``/``receivers`` the ``[E]`` edge list,
    ``edge_mask`` the ``[E]`` validity of padded edges, ``scale`` multiplies
    the scores and ``sender_bounds`` (``[2, N]``, ``Graph.sender_bounds``)
    selects the CSR branch, ``ell_degree`` with ``twin_perm`` the ELL one.
    Returns ``[N, H, Dh]``.

    The per-head dot accumulates in f32, as in the JAX package. In the COO
    branch edge-sized intermediates stay 2-D ``[E, H*Dh]`` with head-blocked
    columns; the CSR branch on CUDA has none."""
    if sender_bounds is not None:
        return csr_sparse_attention(
            q, k, v, senders, receivers, sender_bounds, edge_mask=edge_mask, scale=scale
        )
    n, h, dh = q.shape
    d = h * dh

    # the scale rounded to q's dtype first, as the JAX package's jnp.asarray
    scale_f32 = torch.tensor(scale, dtype=q.dtype).to(torch.float32).item()

    def scores_of(q_e, k_e):  # [E, d] x2 -> [E, H], the per-head dot in f32
        prod = q_e.to(torch.float32) * k_e.to(torch.float32)
        return prod.reshape(q_e.shape[0], h, dh).sum(dim=-1) * scale_f32

    def weight(v_e, attn):  # [E, d], [E, H] -> [E, d]
        return (v_e.reshape(v_e.shape[0], h, dh) * attn[:, :, None].to(v_e.dtype)).reshape(-1, d)

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

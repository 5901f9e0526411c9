"""MeshMask utilities on padded graphs (counterpart of
``graphphysics_tpu/utils/meshmask.py``): masking expressed with boolean
masks, every tensor kept at its padded size.

- ``build_masked_graph``: edges touching a hidden node are dropped (the edge
  mask AND both endpoints' visibility) and hidden nodes marked invalid, so
  message passing treats the visible nodes as the reference's extracted
  subgraph would (hidden nodes are isolated).
- ``reconstruct_graph``: re-inflated with a learnable [MASK] token for the
  hidden nodes and, for the dropped edges, the re-encoded raw edge features
  plus an edge [MASK] token.

Scaffolding for masked pre-training variants: the training path does not
call it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from graphphysics_torch.core.graph import Graph


def visible_edge_mask(graph: Graph, keep_mask: torch.Tensor) -> torch.Tensor:
    """Edges whose both endpoints are visible, and valid."""
    m = keep_mask[graph.senders.long()] & keep_mask[graph.receivers.long()]
    if graph.edge_mask is not None:
        m = m & graph.edge_mask
    return m


def build_masked_graph(graph: Graph, keep_mask: torch.Tensor) -> Tuple[Graph, torch.Tensor]:
    """The same tensors with the hidden nodes and their edges masked out,
    and the edge visibility (``reconstruct_graph`` takes it)."""
    edges_visible = visible_edge_mask(graph, keep_mask)
    node_mask = graph.node_mask & keep_mask
    return graph.replace(node_mask=node_mask, edge_mask=edges_visible), edges_visible


def reconstruct_graph(
    graph: Graph,
    latent_x: torch.Tensor,
    keep_mask: torch.Tensor,
    node_mask_token: torch.Tensor,
    edges_visible: Optional[torch.Tensor] = None,
    latent_edge_attr: Optional[torch.Tensor] = None,
    encoded_raw_edge_attr: Optional[torch.Tensor] = None,
    edge_mask_token: Optional[torch.Tensor] = None,
) -> Graph:
    """The full-size graph of a masked model run: ``latent_x`` ([N, F]) on
    the visible nodes (``keep_mask``), ``node_mask_token`` ([F]) on the
    hidden ones; with ``latent_edge_attr`` ([E, Fe]) also the edges:
    latent on the visible ones (``edges_visible``), ``encoded_raw_edge_attr
    + edge_mask_token`` on the dropped ones."""
    x = torch.where(keep_mask[:, None], latent_x, node_mask_token[None, :])
    edge_attr = graph.edge_attr
    if latent_edge_attr is not None:
        if encoded_raw_edge_attr is None or edge_mask_token is None or edges_visible is None:
            raise ValueError(
                "edge reconstruction needs edges_visible, encoded_raw_edge_attr, and edge_mask_token"
            )
        hidden_edges = encoded_raw_edge_attr + edge_mask_token[None, :]
        edge_attr = torch.where(edges_visible[:, None], latent_edge_attr, hidden_edges)
    return graph.replace(x=x, edge_attr=edge_attr, edge_mask=graph.edge_mask)

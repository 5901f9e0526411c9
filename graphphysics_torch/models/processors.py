"""Processor architectures (counterpart of
``graphphysics_tpu/models/processors.py``): EncodeProcessDecode and
EncodeTransformDecode, unrolled, with the plain MLP decoder or, with
``num_mixture_components`` K > 0, a GMM head (diagonal unless
``use_diagonal`` is false) whose output the Simulator samples at eval with
``temperature`` (None reads as 1.0; 0.0 gives the chosen component's mean)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from graphphysics_torch.core.graph import Graph
from graphphysics_torch.models.layers import (
    MLP,
    DiagonalGMMHead,
    GMMHead,
    GraphNetBlock,
    TransformerBlock,
)


def _decoder(hidden_size: int, output_size: int, num_mixture_components: int,
             use_diagonal: bool) -> nn.Module:
    """The MLP decoder (no output norm) for K = 0, else a GMM head."""
    if num_mixture_components == 0:
        return MLP(hidden_size, hidden_size, output_size, layer_norm=False)
    head = DiagonalGMMHead if use_diagonal else GMMHead
    return head(hidden_size, output_size, num_mixture_components)


class _GMMOptions:
    """The decoder's GMM settings, as the JAX models carry them."""

    num_mixture_components: int
    temperature: Optional[float]
    use_diagonal: bool
    output_size: int

    def _set_gmm(self, output_size, num_mixture_components, temperature, use_diagonal):
        self.output_size = output_size
        self.num_mixture_components = num_mixture_components
        self.temperature = temperature
        self.use_diagonal = use_diagonal

    @property
    def d(self) -> int:
        return self.output_size

    @property
    def K(self) -> int:
        return self.num_mixture_components


class EncodeProcessDecode(_GMMOptions, nn.Module):
    """MeshGraphNet-style EPD: MLP encoders for nodes and edges,
    ``message_passing_num`` GraphNetBlocks, MLP decoder (no output norm) or
    GMM head. Emits float32 predictions."""

    def __init__(
        self,
        message_passing_num: int,
        node_input_size: int,
        edge_input_size: int,
        output_size: int,
        hidden_size: int = 128,
        num_mixture_components: int = 0,
        temperature: Optional[float] = None,
        use_diagonal: bool = True,
    ):
        super().__init__()
        self._set_gmm(output_size, num_mixture_components, temperature, use_diagonal)
        self.nodes_encoder = MLP(node_input_size, hidden_size, hidden_size)
        self.edges_encoder = MLP(edge_input_size, hidden_size, hidden_size)
        self.processor_list = nn.ModuleList(
            GraphNetBlock(hidden_size) for _ in range(message_passing_num)
        )
        self.decode_module = _decoder(hidden_size, output_size, num_mixture_components, use_diagonal)

    def forward(self, graph: Graph) -> torch.Tensor:
        x = self.nodes_encoder(graph.x)
        edge_attr = self.edges_encoder(graph.edge_attr)
        for block in self.processor_list:
            x, edge_attr = block(
                x,
                edge_attr,
                graph.senders,
                graph.receivers,
                graph.edge_mask,
                graph.row_bounds,
            )
        return self.decode_module(x).to(torch.float32)


class EncodeTransformDecode(_GMMOptions, nn.Module):
    """Sparse graph transformer: MLP node encoder (with RMSNorm),
    ``message_passing_num`` pre-norm TransformerBlocks attending over the
    mesh adjacency, MLP decoder (no output norm) or GMM head. Edge features
    are not used. On CUDA the graph must carry ``sender_bounds``
    (``pad_graph_csr_np``): attention then runs the fused Hopper attention
    kernel once per block. Emits float32 predictions."""

    def __init__(
        self,
        message_passing_num: int,
        node_input_size: int,
        output_size: int,
        hidden_size: int = 128,
        num_heads: int = 4,
        num_mixture_components: int = 0,
        temperature: Optional[float] = None,
        use_diagonal: bool = True,
    ):
        super().__init__()
        self._set_gmm(output_size, num_mixture_components, temperature, use_diagonal)
        self.nodes_encoder = MLP(node_input_size, hidden_size, hidden_size)
        self.processor_list = nn.ModuleList(
            TransformerBlock(hidden_size, num_heads) for _ in range(message_passing_num)
        )
        self.decode_module = _decoder(hidden_size, output_size, num_mixture_components, use_diagonal)

    def forward(self, graph: Graph) -> torch.Tensor:
        x = self.nodes_encoder(graph.x)
        for block in self.processor_list:
            x = block(x, graph.senders, graph.receivers, graph.edge_mask, graph.sender_bounds)
        return self.decode_module(x).to(torch.float32)

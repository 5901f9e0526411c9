"""Processor architectures (counterpart of
``graphphysics_tpu/models/processors.py``): EncodeProcessDecode, unrolled,
with the plain MLP decoder."""

from __future__ import annotations

import torch
from torch import nn

from graphphysics_torch.core.graph import Graph
from graphphysics_torch.models.layers import MLP, GraphNetBlock


class EncodeProcessDecode(nn.Module):
    """MeshGraphNet-style EPD: MLP encoders for nodes and edges,
    ``message_passing_num`` GraphNetBlocks, MLP decoder (no output norm).
    Emits float32 predictions."""

    def __init__(
        self,
        message_passing_num: int,
        node_input_size: int,
        edge_input_size: int,
        output_size: int,
        hidden_size: int = 128,
    ):
        super().__init__()
        self.nodes_encoder = MLP(node_input_size, hidden_size, hidden_size)
        self.edges_encoder = MLP(edge_input_size, hidden_size, hidden_size)
        self.processor_list = nn.ModuleList(
            GraphNetBlock(hidden_size) for _ in range(message_passing_num)
        )
        self.decode_module = MLP(hidden_size, hidden_size, output_size, layer_norm=False)

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

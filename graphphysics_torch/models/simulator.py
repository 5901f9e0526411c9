"""Simulator: feature assembly, normalization, delta targets, denormalizing
decode (counterpart of ``graphphysics_tpu/models/simulator.py``).

The three running normalizers (node / edge / output-delta) are submodules
whose statistics are buffers named as in the reference ``state_dict``
(``_output_normalizer._acc_sum`` ...). Graphs are batched by concatenation
(``core.graph.concat_graphs``), so the simulator always sees one flat graph.
This slice ports the eval forward of the plain (K = 0) decoder and
``accumulate_stats``; training comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graphphysics_torch.core import normalizer as norm
from graphphysics_torch.core.device import DeviceLike, resolve_device
from graphphysics_torch.core.graph import Graph
from graphphysics_torch.core.nodetype import NodeType


class Normalizer(nn.Module):
    """Online-statistics normalizer over ``core.normalizer``."""

    def __init__(self, size: int):
        super().__init__()
        state = norm.init(size)
        self.register_buffer("_acc_count", state.acc_count)
        self.register_buffer("_num_accumulations", state.num_accumulations)
        self.register_buffer("_acc_sum", state.acc_sum)
        self.register_buffer("_acc_sum_squared", state.acc_sum_sq)

    @property
    def state(self) -> norm.NormalizerState:
        return norm.NormalizerState(
            self._acc_count, self._num_accumulations, self._acc_sum, self._acc_sum_squared
        )

    @torch.no_grad()
    def accumulate(self, data: torch.Tensor, mask: Optional[torch.Tensor] = None) -> None:
        new = norm.accumulate(self.state, data, mask)
        self._acc_count.copy_(new.acc_count)
        self._num_accumulations.copy_(new.num_accumulations)
        self._acc_sum.copy_(new.acc_sum)
        self._acc_sum_squared.copy_(new.acc_sum_sq)

    def forward(self, data: torch.Tensor) -> torch.Tensor:
        return norm.normalize(self.state, data)

    def inverse(self, normalized: torch.Tensor) -> torch.Tensor:
        return norm.inverse(self.state, normalized)


@dataclasses.dataclass(frozen=True)
class SimulatorConfig:
    """Index layout of the raw node-feature matrix."""

    node_input_size: int  # features fed to the model, INCLUDING the NodeType.SIZE one-hot
    edge_input_size: int
    output_size: int
    feature_index_start: int
    feature_index_end: int
    output_index_start: int
    output_index_end: int
    node_type_index: int


class Simulator(nn.Module):
    """Wraps a processor model with normalization and delta-target handling.

    ``forward`` is the eval branch of the reference ``Simulator.forward``:
    ``(network_output, target_delta_normalized, outputs)`` with
    ``outputs = pre_target + output_normalizer.inverse(network_output)``.
    The module is moved to ``device`` (``cuda`` unless named)."""

    def __init__(self, config: SimulatorConfig, model: nn.Module, device: DeviceLike = None):
        super().__init__()
        self.config = config
        self.model = model
        self._output_normalizer = Normalizer(config.output_size)
        self._node_normalizer = Normalizer(config.node_input_size)
        self._edge_normalizer = Normalizer(config.edge_input_size)
        self.to(resolve_device(device))

    def _pre_target(self, graph: Graph) -> torch.Tensor:
        cfg = self.config
        return graph.x[:, cfg.output_index_start : cfg.output_index_end]

    def node_type(self, graph: Graph) -> torch.Tensor:
        return graph.x[:, self.config.node_type_index].to(torch.int64)

    def _build_node_features(self, graph: Graph) -> torch.Tensor:
        cfg = self.config
        features = graph.x[:, cfg.feature_index_start : cfg.feature_index_end]
        one_hot = F.one_hot(self.node_type(graph), int(NodeType.SIZE)).to(features.dtype)
        return torch.cat([features, one_hot], dim=1)

    @torch.no_grad()
    def accumulate_stats(self, graph: Graph) -> None:
        """Fold one graph into the three normalizers without running the
        model; padding rows are left out through the masks."""
        self._output_normalizer.accumulate(
            graph.y - self._pre_target(graph), mask=graph.node_mask
        )
        self._node_normalizer.accumulate(
            self._build_node_features(graph), mask=graph.node_mask
        )
        self._edge_normalizer.accumulate(graph.edge_attr, mask=graph.edge_mask)

    def forward(
        self, graph: Graph
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        pre_target = self._pre_target(graph)
        target_delta_normalized = (
            None if graph.y is None else self._output_normalizer(graph.y - pre_target)
        )
        model_graph = graph.replace(
            x=self._node_normalizer(self._build_node_features(graph)),
            edge_attr=self._edge_normalizer(graph.edge_attr),
        )
        network_output = self.model(model_graph)
        outputs = pre_target + self._output_normalizer.inverse(network_output)
        return network_output, target_delta_normalized, outputs

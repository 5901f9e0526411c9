"""Simulator: feature assembly, normalization, delta targets, denormalizing
decode (counterpart of ``graphphysics_tpu/models/simulator.py``).

The three running normalizers (node / edge / output-delta) are submodules
whose statistics are buffers named as in the reference ``state_dict``
(``_output_normalizer._acc_sum`` ...). Graphs are batched by concatenation
(``core.graph.concat_graphs``), so the simulator always sees one flat graph.
``forward`` has the training branch (the batch is folded into the
normalizers, then normalized with the updated statistics, in the same call,
as flax's mutable collection does) and the eval branch: the plain (K = 0)
decoder's output denormalized, or for a GMM head (K > 0) a sample of the
mixture drawn from the ``torch.Generator`` the caller passes, then
denormalized. A model without
edge features (``edge_input_size == 0``, the transformer) has no edge
normalizer, as in the JAX package.
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
from graphphysics_torch.models.gmm import sample_gmm, sample_gmm_diagonal


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
    edge_input_size: int  # 0: no edge features and no edge normalizer
    output_size: int
    feature_index_start: int
    feature_index_end: int
    output_index_start: int
    output_index_end: int
    node_type_index: int


class Simulator(nn.Module):
    """Wraps a processor model with normalization and delta-target handling,
    as the reference ``Simulator.forward``. The module is moved to
    ``device`` (``cuda`` unless named)."""

    def __init__(self, config: SimulatorConfig, model: nn.Module, device: DeviceLike = None):
        super().__init__()
        self.config = config
        self.model = model
        self._output_normalizer = Normalizer(config.output_size)
        self._node_normalizer = Normalizer(config.node_input_size)
        self._edge_normalizer = (
            Normalizer(config.edge_input_size) if config.edge_input_size > 0 else None
        )
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
        if self._edge_normalizer is not None and graph.edge_attr is not None:
            self._edge_normalizer.accumulate(graph.edge_attr, mask=graph.edge_mask)

    def forward(
        self,
        graph: Graph,
        is_training: bool = False,
        accumulate_stats: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
        """``(network_output, target_delta_normalized, outputs)``.

        ``accumulate_stats`` (default: ``is_training``) first folds the
        graph's real rows into the three normalizers, so this batch is
        normalized with statistics that include it. Training returns
        ``outputs = None``; eval returns the denormalized prediction
        ``pre_target + output_normalizer.inverse(update)``, where ``update``
        is the network output (K = 0) or, for a GMM head, a sample of the
        model's mixture at its temperature (None reads as 1.0, 0.0 gives the
        chosen component's mean) drawn from ``generator``, which eval with
        K > 0 requires."""
        if accumulate_stats is None:
            accumulate_stats = is_training
        if accumulate_stats:
            self.accumulate_stats(graph)
        pre_target = self._pre_target(graph)
        target_delta_normalized = (
            None if graph.y is None else self._output_normalizer(graph.y - pre_target)
        )
        edge_attr = graph.edge_attr
        if self._edge_normalizer is not None and edge_attr is not None:
            edge_attr = self._edge_normalizer(edge_attr)
        model_graph = graph.replace(
            x=self._node_normalizer(self._build_node_features(graph)), edge_attr=edge_attr
        )
        network_output = self.model(model_graph)
        if is_training:
            return network_output, target_delta_normalized, None
        update = network_output
        if self.model.K > 0:
            if generator is None:
                raise ValueError("eval of a GMM head (num_mixture_components > 0) samples: pass a "
                                 "torch.Generator as generator=")
            temperature = 1.0 if self.model.temperature is None else self.model.temperature
            sampler = sample_gmm_diagonal if self.model.use_diagonal else sample_gmm
            update = sampler(network_output, self.model.d, self.model.K, temperature, generator)
        outputs = pre_target + self._output_normalizer.inverse(update)
        return network_output, target_delta_normalized, outputs

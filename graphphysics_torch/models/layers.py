"""Core neural layers (counterpart of ``graphphysics_tpu/models/layers.py``).

Module and parameter names follow the reference PyTorch ``state_dict``
(``build_mlp`` is a Sequential: Linear layers at even indices, the RMSNorm
last), so reference-format weights load with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from graphphysics_torch.ops.segment import masked_segment_sum, take_rows


class RMSNorm(nn.Module):
    """``scale * x / (sqrt(max(sum(x^2), 1e-24)) * d^-0.5 + eps)``: the
    reference formula, not ``torch.nn.RMSNorm``. The ``1e-24`` floor gives an
    all-zero row (reachable through ReLU) a zero, not NaN, gradient."""

    EPS = 1e-8

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sq = (x * x).sum(dim=-1, keepdim=True)
        rms_x = torch.sqrt(torch.clamp(sq, min=1e-24)) * self.dim ** (-0.5)
        return self.scale * (x / (rms_x + self.EPS))


class MLP(nn.Sequential):
    """Reference ``build_mlp`` with its 4 linear layers: (Linear+ReLU) x 3,
    Linear, optional RMSNorm output."""

    def __init__(self, in_size: int, hidden_size: int, out_size: int, layer_norm: bool = True):
        layers = [nn.Linear(in_size, hidden_size), nn.ReLU()]
        for _ in range(2):
            layers += [nn.Linear(hidden_size, hidden_size), nn.ReLU()]
        layers.append(nn.Linear(hidden_size, out_size))
        if layer_norm:
            layers.append(RMSNorm(out_size))
        super().__init__(*layers)


class GraphNetBlock(nn.Module):
    """Message-passing block, plain COO branch.

    Edge update: MLP on ``[edge_attr, x[receivers], x[senders]]``. Node
    update: MLP on ``[x, sum of incoming edge messages]``, the messages summed
    into their receivers. Residuals on both."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.edge_block = MLP(3 * hidden_size, hidden_size, hidden_size)
        self.node_block = MLP(2 * hidden_size, hidden_size, hidden_size)

    def forward(
        self,
        x: torch.Tensor,
        edge_attr: torch.Tensor,
        senders: torch.Tensor,
        receivers: torch.Tensor,
        edge_mask: Optional[torch.Tensor] = None,
        row_bounds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        edge_in = torch.cat(
            [edge_attr, take_rows(x, receivers), take_rows(x, senders)], dim=-1
        )
        edge_update = self.edge_block(edge_in)
        aggr = masked_segment_sum(
            edge_update, receivers, x.shape[0], mask=edge_mask, row_bounds=row_bounds
        )
        node_update = self.node_block(torch.cat([x, aggr], dim=-1))
        return x + node_update, edge_attr + edge_update


def reset_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every ``nn.Linear`` of ``module`` from ``generator`` with
    PyTorch's default bounds (uniform in +-1/sqrt(fan_in)), so a seed fixes
    the weights without touching the global random state."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                bound = m.in_features ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
    return module

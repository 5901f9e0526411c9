"""Online normalizer statistics (counterpart of
``graphphysics_tpu/core/normalizer.py``), on tensors:

- running mean = acc_sum / max(acc_count, 1)
- std = sqrt(clamp(acc_sum_sq / count - mean^2, 0)), floored at ``STD_EPSILON``
- accumulation stops after ``MAX_ACCUMULATIONS`` calls
- a validity mask keeps padding rows out of the statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

MAX_ACCUMULATIONS = 10**5
STD_EPSILON = 1e-8


@dataclasses.dataclass(frozen=True)
class NormalizerState:
    acc_count: torch.Tensor  # f32 scalar: number of accumulated rows
    num_accumulations: torch.Tensor  # f32 scalar: number of accumulate() calls
    acc_sum: torch.Tensor  # [size]
    acc_sum_sq: torch.Tensor  # [size]


def init(size: int, device=None, dtype=torch.float32) -> NormalizerState:
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return NormalizerState(zeros(), zeros(), zeros(size), zeros(size))


def mean(state: NormalizerState) -> torch.Tensor:
    return state.acc_sum / torch.clamp(state.acc_count, min=1.0)


def std_with_epsilon(state: NormalizerState) -> torch.Tensor:
    safe_count = torch.clamp(state.acc_count, min=1.0)
    variance = state.acc_sum_sq / safe_count - mean(state) ** 2
    return torch.clamp(torch.sqrt(torch.clamp(variance, min=0.0)), min=STD_EPSILON)


def accumulate(
    state: NormalizerState,
    data: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> NormalizerState:
    """Add ``data`` (``[..., size]``) to the running statistics; ``mask``
    (``[...]`` bool) selects valid rows. A no-op once ``num_accumulations``
    reaches ``MAX_ACCUMULATIONS``."""
    flat = data.detach().to(state.acc_sum.dtype).reshape(-1, data.shape[-1])
    if mask is not None:
        m = mask.reshape(-1, 1).to(flat.dtype)
        flat = flat * m
        count = m.sum()
    else:
        count = torch.tensor(float(flat.shape[0]), dtype=flat.dtype, device=flat.device)
    w = (state.num_accumulations < MAX_ACCUMULATIONS).to(flat.dtype)
    return NormalizerState(
        acc_count=state.acc_count + w * count,
        num_accumulations=state.num_accumulations + w,
        acc_sum=state.acc_sum + w * flat.sum(dim=0),
        acc_sum_sq=state.acc_sum_sq + w * (flat**2).sum(dim=0),
    )


def normalize(state: NormalizerState, data: torch.Tensor) -> torch.Tensor:
    return (data - mean(state)) / std_with_epsilon(state)


def inverse(state: NormalizerState, normalized: torch.Tensor) -> torch.Tensor:
    return normalized * std_with_epsilon(state) + mean(state)

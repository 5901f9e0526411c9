"""Segment reductions over padded edge lists (counterpart of
``graphphysics_tpu/ops/segment.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_reference


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``x[idx]`` (the JAX package's 16-bit packing was a TPU gather
    workaround and has no counterpart here)."""
    return x.index_select(0, idx)


def masked_segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    row_bounds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum ``data`` (``[E, H]``) into ``num_segments`` rows by ``segment_ids``;
    ``mask`` (``[E]`` bool) drops padded edges. 16-bit inputs accumulate in
    f32 and return their own dtype.

    With ``row_bounds`` (edges sorted by receiver, ``Graph.row_bounds``) the
    sum goes through ``csr_segment_sum``, which on CUDA is the Hopper kernel.
    A CUDA tensor without ``row_bounds`` raises: the kernel needs the sorted
    layout, and nothing falls back to another path."""
    out_dtype = data.dtype
    if out_dtype in (torch.float16, torch.bfloat16):
        data = data.to(torch.float32)
    if row_bounds is not None:
        if row_bounds.shape[-1] != num_segments:
            raise ValueError(
                f"row_bounds covers {row_bounds.shape[-1]} rows, expected {num_segments}"
            )
        out = csr_segment_sum(data, segment_ids, row_bounds, mask)
    elif data.is_cuda:
        raise ValueError(
            "masked_segment_sum on CUDA needs receiver-sorted edges with "
            "row_bounds (build the graph with pad_graph_sorted_np)"
        )
    else:
        out = csr_segment_sum_reference(data, segment_ids, num_segments, mask)
    return out.to(out_dtype)

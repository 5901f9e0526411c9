"""Segment reductions over padded edge lists (counterpart of
``graphphysics_tpu/ops/segment.py``): the segment sum and the segment
softmax."""

from __future__ import annotations

from typing import Optional

import torch

from graphphysics_torch.ops.csr_segment import csr_segment_sum, csr_segment_sum_reference

_NEG_INF = -1e30
_16BIT = (torch.float16, torch.bfloat16)


class _TakeRows16(torch.autograd.Function):
    """``x[idx]`` of a 16-bit ``[N, F]`` tensor whose backward sums the
    rows' gradients in f32 and rounds once, as the JAX ``take_rows``'s
    custom VJP does (a bare ``index_select`` would add in 16 bits)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        gx = torch.zeros((ctx.num_rows, g.shape[1]), dtype=torch.float32, device=g.device)
        return gx.index_add_(0, idx, g.to(torch.float32)).to(g.dtype), None


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``x[idx]``. A 16-bit ``[N, F]`` tensor of even width (the JAX
    package's packed path) gets a backward that accumulates in f32 and
    rounds once; any other takes ``index_select``, as the JAX function
    takes ``jnp.take``. (The JAX package's 16-bit packing itself was a TPU
    gather workaround and has no counterpart here.)"""
    if x.dim() == 2 and x.dtype in _16BIT and x.shape[1] % 2 == 0:
        return _TakeRows16.apply(x, idx)
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
    sum goes through ``csr_segment_sum``, which on CUDA is the Hopper kernel
    of the data's dtype (float32, or the bfloat16 and float16 entries, which
    read the 16-bit rows as they are). A CUDA tensor without ``row_bounds``
    raises: the kernel needs the sorted layout, and nothing falls back to
    another path."""
    if row_bounds is not None:
        if row_bounds.shape[-1] != num_segments:
            raise ValueError(
                f"row_bounds covers {row_bounds.shape[-1]} rows, expected {num_segments}"
            )
        return csr_segment_sum(data, segment_ids, row_bounds, mask)
    if data.is_cuda:
        raise ValueError(
            "masked_segment_sum on CUDA needs receiver-sorted edges with "
            "row_bounds (build the graph with pad_graph_sorted_np)"
        )
    out_dtype = data.dtype
    if out_dtype in _16BIT:
        data = data.to(torch.float32)
    return csr_segment_sum_reference(data, segment_ids, num_segments, mask).to(out_dtype)


def segment_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-16,
) -> torch.Tensor:
    """Numerically stable softmax of per-edge ``scores`` (``[E, ...]``)
    within each segment. Masked edges get probability 0; a segment with no
    edges, or only masked ones, gives all-zero rows. 16-bit scores compute
    in f32 and return their own dtype. Plain PyTorch on every device (a
    ``scatter_reduce`` max and an ``index_add_`` sum)."""
    out_dtype = scores.dtype
    if out_dtype in _16BIT:
        scores = scores.to(torch.float32)
    seg = segment_ids.to(torch.int64)
    idx = seg.reshape(seg.shape + (1,) * (scores.dim() - 1)).expand_as(scores)
    if mask is not None:
        m = mask.reshape(mask.shape + (1,) * (scores.dim() - 1))
        scores = torch.where(m, scores, torch.full((), _NEG_INF, dtype=scores.dtype, device=scores.device))
    shape = (num_segments,) + tuple(scores.shape[1:])
    seg_max = torch.full(shape, float("-inf"), dtype=scores.dtype, device=scores.device)
    seg_max = seg_max.scatter_reduce(0, idx, scores, "amax", include_self=False)
    # empty segments keep -inf: replace by a finite value, as the JAX package
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, torch.zeros((), dtype=seg_max.dtype, device=seg_max.device))
    ex = torch.exp(scores - seg_max.index_select(0, seg))
    if mask is not None:
        ex = torch.where(m, ex, torch.zeros((), dtype=ex.dtype, device=ex.device))
    denom = torch.zeros(shape, dtype=ex.dtype, device=ex.device).index_add_(0, seg, ex)
    return (ex / (denom.index_select(0, seg) + eps)).to(out_dtype)

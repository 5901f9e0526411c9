"""Dense ops of the fixed-degree ELL edge layout (counterpart of
``graphphysics_tpu/ops/ell_ops.py``; the layout is ``topology.ell``).

Slot ``e`` belongs to owner node ``e // D``, so every op over owners is a
dense reshape over the slot axis, with no scatter anywhere:

- ``ell_segment_sum``: the edge-to-node sum as ``reshape(...).sum(1)``;
- ``ell_repeat``: ``x[receivers]`` as a broadcast (its backward is the same
  dense sum);
- ``ell_softmax``: the per-node softmax over the slots;
- ``ell_gather``: ``x[senders]`` whose backward is the twin-permutation
  gather and the dense sum, not a scatter.

The JAX package runs these as XLA ops, with no Pallas kernel; they are
plain PyTorch here too, on the CPU and on CUDA alike: an ELL graph takes
them because of its layout, on either device.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def _slot_view(t: torch.Tensor, ell_degree: int) -> torch.Tensor:
    """``[N*D, ...]`` as ``[N, D, ...]``."""
    return t.reshape((t.shape[0] // ell_degree, ell_degree) + tuple(t.shape[1:]))


def ell_segment_sum(
    data: torch.Tensor, ell_degree: int, edge_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Sum the slot rows into their owners: ``[N*D, ...] -> [N, ...]``;
    masked slots add nothing."""
    if edge_mask is not None:
        data = data * edge_mask.reshape(edge_mask.shape + (1,) * (data.dim() - 1)).to(data.dtype)
    return _slot_view(data, ell_degree).sum(dim=1)


def ell_repeat(x: torch.Tensor, ell_degree: int) -> torch.Tensor:
    """The owners' rows broadcast to their slots: ``[N, ...] -> [N*D, ...]``,
    the ELL form of ``x[receivers]``."""
    n = x.shape[0]
    return x[:, None].expand((n, ell_degree) + tuple(x.shape[1:])).reshape(
        (n * ell_degree,) + tuple(x.shape[1:])
    )


def ell_softmax(
    scores: torch.Tensor,
    ell_degree: int,
    edge_mask: Optional[torch.Tensor] = None,
    eps: float = 1e-16,
) -> torch.Tensor:
    """Per-owner softmax over the slot axis; masked slots get probability 0,
    as ``ops.segment.segment_softmax`` on the same edges."""
    s = _slot_view(scores, ell_degree)
    if edge_mask is not None:
        m = _slot_view(edge_mask, ell_degree).reshape(
            s.shape[:2] + (1,) * (scores.dim() - 1)
        )
        s = torch.where(m, s, torch.full((), _NEG_INF, dtype=s.dtype, device=s.device))
    s_max = s.amax(dim=1, keepdim=True)
    s_max = torch.where(torch.isfinite(s_max), s_max, torch.zeros((), dtype=s.dtype, device=s.device))
    ex = torch.exp(s - s_max)
    if edge_mask is not None:
        ex = torch.where(m, ex, torch.zeros((), dtype=ex.dtype, device=ex.device))
    denom = ex.sum(dim=1, keepdim=True)
    return (ex / (denom + eps)).reshape(scores.shape)


class _EllGather(torch.autograd.Function):
    """``x[senders]`` whose backward is ``ell_segment_sum(g[twin_perm])``:
    since ``senders[e] == owner(twin_perm[e])`` for every slot (a padding
    slot is its own twin and points at its owner), the gradient of node
    ``n``, the sum of ``g`` over the slots whose sender is ``n``, is the
    sum over ``n``'s own slots of their twins' ``g``."""

    @staticmethod
    def forward(ctx, x, senders, twin_perm, ell_degree):
        ctx.save_for_backward(twin_perm)
        ctx.ell_degree = ell_degree
        return x.index_select(0, senders)

    @staticmethod
    def backward(ctx, g):
        (twin_perm,) = ctx.saved_tensors
        return ell_segment_sum(g.index_select(0, twin_perm), ctx.ell_degree), None, None, None


def ell_gather(
    x: torch.Tensor, senders: torch.Tensor, twin_perm: torch.Tensor, ell_degree: int
) -> torch.Tensor:
    """``x[senders]`` on an ELL graph, with the scatter-free backward of
    ``_EllGather``."""
    return _EllGather.apply(x, senders, twin_perm, ell_degree)

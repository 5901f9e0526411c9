"""Masked losses on static padded graphs (counterpart of
``graphphysics_tpu/training/losses.py``): each loss is a masked mean over
rows, with static shapes. The mask combines node-type membership in
``masks``, the MeshMask exclusion (``exclude_mask``) and the padding
``node_mask``. An empty mask gives 0, not NaN. The GMM losses come with the
GMM heads."""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def node_type_mask(
    node_type: torch.Tensor,
    masks: Sequence[int],
    node_valid: Optional[torch.Tensor] = None,
    exclude_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Boolean ``[N]`` mask: node_type in ``masks``, valid, and not excluded."""
    m = torch.zeros(node_type.shape, dtype=torch.bool, device=node_type.device)
    for t in masks:
        m = m | (node_type == int(t))
    if node_valid is not None:
        m = m & node_valid
    if exclude_mask is not None:
        m = m & ~exclude_mask
    return m


def _masked_row_mean(per_row: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of per-row scalars over masked rows (0 if the mask is empty)."""
    w = mask.to(per_row.dtype)
    return (per_row * w).sum() / torch.clamp(w.sum(), min=1.0)


def make_local_loss(masks: Sequence[int], loss_kind: str) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """A local ``(sum, count)`` loss, whose sums over shards or microbatches
    reproduce the single-device masked mean: ``loss_kind`` "l2" only (the GMM
    kinds come with the GMM heads)."""
    if loss_kind != "l2":
        raise NotImplementedError(
            f"loss kind {loss_kind!r} is not ported yet (ROADMAP.md section 1, item 9, GMM)"
        )
    masks = [int(m) for m in masks]

    def local_loss(target, out, node_type, node_valid, exclude_mask):
        mask = node_type_mask(node_type, masks, node_valid, exclude_mask)
        per_row = ((out - target) ** 2).mean(dim=-1)
        w = mask.to(per_row.dtype)
        return (per_row * w).sum(), w.sum()

    return local_loss


def l2_loss(
    target: torch.Tensor,
    network_output: torch.Tensor,
    node_type: torch.Tensor,
    masks: Sequence[int],
    node_valid: Optional[torch.Tensor] = None,
    exclude_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MSE over the masked nodes' feature elements (mean over all elements
    of the selected rows)."""
    mask = node_type_mask(node_type, masks, node_valid, exclude_mask)
    per_row = ((network_output - target) ** 2).mean(dim=-1)
    return _masked_row_mean(per_row, mask)


def l1_smooth_loss(
    target: torch.Tensor,
    network_output: torch.Tensor,
    node_type: torch.Tensor,
    masks: Sequence[int],
    beta: float = 1.0,
    node_valid: Optional[torch.Tensor] = None,
    exclude_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Huber / smooth-L1 over the masked rows."""
    mask = node_type_mask(node_type, masks, node_valid, exclude_mask)
    diff = (network_output - target).abs()
    elem = torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)
    return _masked_row_mean(elem.mean(dim=-1), mask)

"""Masked losses on static padded graphs (counterpart of
``graphphysics_tpu/training/losses.py``): each loss is a masked mean over
rows, with static shapes. The mask combines node-type membership in
``masks``, the MeshMask exclusion (``exclude_mask``) and the padding
``node_mask``. An empty mask gives 0, not NaN. The GMM negative
log-likelihoods (diagonal and full covariance) are computed on every row,
padding included (the full one guards degenerate rows before its
triangular solve so they stay finite), then mean-reduced over the mask."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from graphphysics_torch.models.gmm import tril_matrix

_LOG_TWO_PI = math.log(2.0 * math.pi)


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


def make_local_loss(
    masks: Sequence[int], loss_kind: str, gmm_kwargs: Optional[Dict[str, Any]] = None
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """A local ``(sum, count)`` loss, whose sums over shards or microbatches
    reproduce the single-device masked mean: ``loss_kind`` "l2",
    "diag_gmm" or "full_gmm" (the NLLs, with ``gmm_kwargs`` ``d``, ``K``
    and ``temperature``)."""
    masks = [int(m) for m in masks]
    gmm_kwargs = gmm_kwargs or {}
    per_row_fns = {
        "l2": lambda target, out: ((out - target) ** 2).mean(dim=-1),
        "diag_gmm": lambda target, out: diagonal_gmm_nll_per_row(target, out, **gmm_kwargs),
        "full_gmm": lambda target, out: gmm_nll_per_row(target, out, **gmm_kwargs),
    }
    if loss_kind not in per_row_fns:
        raise ValueError(loss_kind)
    per_row_fn = per_row_fns[loss_kind]

    def local_loss(target, out, node_type, node_valid, exclude_mask):
        mask = node_type_mask(node_type, masks, node_valid, exclude_mask)
        per_row = per_row_fn(target, out)
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


def diagonal_gmm_nll_per_row(
    target: torch.Tensor, network_output: torch.Tensor, d: int, K: int, temperature: float = 1.0
) -> torch.Tensor:
    """Per-node diagonal-GMM negative log-likelihood ``[N]`` of ``target``
    under the output's mixture ``[N, K * (2d + 1)]``."""
    n = network_output.shape[0]
    net = network_output.reshape(n, K, 2 * d + 1)
    alpha = torch.softmax(net[..., 0], dim=-1)
    means = net[..., 1 : 1 + d]
    log_std = net[..., 1 + d : 1 + 2 * d]
    diff = target[:, None, :] - means  # [N, K, d]
    std = torch.exp(log_std) * temperature
    var = std**2
    log_component = -0.5 * (
        2.0 * torch.log(std + 1e-12) + diff**2 / (var + 1e-12) + _LOG_TWO_PI
    )
    log_mixture = torch.log(alpha + 1e-12) + log_component.sum(dim=-1)  # [N, K]
    return -torch.logsumexp(log_mixture, dim=-1)


def diagonal_gmm_nll_loss(
    target: torch.Tensor,
    network_output: torch.Tensor,
    node_type: torch.Tensor,
    masks: Sequence[int],
    d: int,
    K: int,
    temperature: float = 1.0,
    node_valid: Optional[torch.Tensor] = None,
    exclude_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Diagonal-covariance GMM NLL, computed on all rows, mean-reduced over
    the mask."""
    mask = node_type_mask(node_type, masks, node_valid, exclude_mask)
    return _masked_row_mean(diagonal_gmm_nll_per_row(target, network_output, d, K, temperature), mask)


def gmm_nll_per_row(
    target: torch.Tensor, network_output: torch.Tensor, d: int, K: int, temperature: float = 1.0
) -> torch.Tensor:
    """Per-node full-covariance GMM negative log-likelihood ``[N]`` of
    ``target`` under the output's mixture ``[N, K * (1 + d + d(d+1)/2)]``,
    by a lower-triangular solve. A row whose Cholesky diagonal has an entry
    below 1e-8 in magnitude (padding, degenerate rows) gets ``1e-4`` added
    to its diagonal before the solve, so it stays finite."""
    n = network_output.shape[0]
    l_len = d * (d + 1) // 2
    net = network_output.reshape(n, K, 1 + d + l_len)
    alpha = torch.softmax(net[..., 0], dim=-1)
    means = net[..., 1 : 1 + d]
    l_mat = tril_matrix(net[..., 1 + d : 1 + d + l_len], d) * temperature  # [N, K, d, d]
    diff = target[:, None, :] - means  # [N, K, d]
    diag_l = torch.diagonal(l_mat, dim1=-2, dim2=-1)  # [N, K, d]
    logdet = 2.0 * torch.log(diag_l.abs() + 1e-8).sum(dim=-1)  # [N, K]
    eye = torch.eye(d, dtype=l_mat.dtype, device=l_mat.device)
    safe_l = torch.where(diag_l.abs()[..., None] < 1e-8, l_mat + 1e-4 * eye, l_mat)
    y = torch.linalg.solve_triangular(safe_l, diff[..., None], upper=False)[..., 0]
    maha = (y**2).sum(dim=-1)  # [N, K]
    logpdf = -0.5 * (d * _LOG_TWO_PI + logdet + maha)
    log_mixture = torch.log(alpha + 1e-12) + logpdf
    return -torch.logsumexp(log_mixture, dim=-1)


def gmm_nll_loss(
    target: torch.Tensor,
    network_output: torch.Tensor,
    node_type: torch.Tensor,
    masks: Sequence[int],
    d: int,
    K: int,
    temperature: float = 1.0,
    node_valid: Optional[torch.Tensor] = None,
    exclude_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-covariance GMM NLL, computed on all rows, mean-reduced over the
    mask."""
    mask = node_type_mask(node_type, masks, node_valid, exclude_mask)
    return _masked_row_mean(gmm_nll_per_row(target, network_output, d, K, temperature), mask)

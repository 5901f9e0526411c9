"""Gaussian-mixture output sampling (counterpart of
``graphphysics_tpu/models/gmm.py``).

Each sampler is split in two:

- a pure function of the network output and explicit draws, the component
  ids ``[N]`` and the standard normals ``[N, d]``
  (``gmm_diagonal_from_draws``, ``gmm_full_from_draws``), which the tests
  hold against the JAX samplers fed the same draws;
- the sampler (``sample_gmm_diagonal``, ``sample_gmm``), which makes those
  draws from an explicit ``torch.Generator`` and calls the pure function.

The draws are made on the generator's device, in a fixed order per call:
``[N, K]`` uniforms for the component choice, then ``[N, d]`` normals. The
component of node n is ``argmax_k(logit[n, k] + gumbel[n, k])`` with
``gumbel = -log(-log(u))``, a draw from ``softmax(logit[n])`` (the
Gumbel-max form of JAX's ``categorical``). Nothing draws from the global
random state. A ``torch.Generator`` gives other numbers than a JAX key of the
same seed: only the distributions agree.

Layouts per component, as in the JAX package:

- diagonal: ``[logit, mean(d), log_std(d)]``, sample ``mean + T exp(log_std) z``;
- full: ``[logit, mean(d), tril(L)(d(d+1)/2)]`` (row-major lower triangle),
  sample ``mean + (T L) z``.
"""

from __future__ import annotations

from typing import Tuple

import torch

# keeps -log(-log(u)) finite for u drawn at exactly 0
_TINY = torch.finfo(torch.float32).tiny


def draw_gmm(
    n: int, K: int, d: int, generator: torch.Generator, dtype: torch.dtype = torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The random draws of one sampler call on the generator's device:
    ``(gumbel [N, K], z [N, d])``, standard Gumbel and standard normal."""
    dev = generator.device
    u = torch.rand((n, K), generator=generator, device=dev, dtype=dtype)
    gumbel = -torch.log(-torch.log(u.clamp_min(_TINY)))
    z = torch.randn((n, d), generator=generator, device=dev, dtype=dtype)
    return gumbel, z


def components(logit: torch.Tensor, gumbel: torch.Tensor) -> torch.Tensor:
    """Component ids ``[N]`` from the mixture logits ``[N, K]`` and Gumbel
    draws: ``argmax_k(logit + gumbel)``."""
    return torch.argmax(logit + gumbel.to(logit.device, logit.dtype), dim=-1)


def gmm_diagonal_from_draws(
    network_output: torch.Tensor,
    comp_ids: torch.Tensor,
    z: torch.Tensor,
    d: int,
    K: int,
    temperature: float = 1.0,
) -> torch.Tensor:
    """``[N, d]`` samples ``mean + temperature * exp(log_std) * z`` of the
    components ``comp_ids`` from a diagonal GMM output ``[N, K * (2d + 1)]``."""
    n = network_output.shape[0]
    net = network_output.reshape(n, K, 2 * d + 1)
    idx = comp_ids.to(network_output.device).long()[:, None, None].expand(n, 1, d)
    chosen_means = torch.gather(net[..., 1 : 1 + d], 1, idx)[:, 0]
    chosen_std = torch.exp(torch.gather(net[..., 1 + d : 1 + 2 * d], 1, idx)[:, 0]) * temperature
    return chosen_means + chosen_std * z.to(network_output.device, network_output.dtype)


def tril_matrix(l_flat: torch.Tensor, d: int) -> torch.Tensor:
    """``[..., d(d+1)/2]`` row-major lower triangles as ``[..., d, d]``
    matrices (``jnp.tril_indices`` order)."""
    rows, cols = torch.tril_indices(d, d, device=l_flat.device)
    mat = l_flat.new_zeros(l_flat.shape[:-1] + (d, d))
    mat[..., rows, cols] = l_flat
    return mat


def gmm_full_from_draws(
    network_output: torch.Tensor,
    comp_ids: torch.Tensor,
    z: torch.Tensor,
    d: int,
    K: int,
    temperature: float = 1.0,
) -> torch.Tensor:
    """``[N, d]`` samples ``mean + (temperature * L) @ z`` of the components
    ``comp_ids`` from a full-covariance GMM output
    ``[N, K * (1 + d + d(d+1)/2)]``."""
    n = network_output.shape[0]
    l_len = d * (d + 1) // 2
    net = network_output.reshape(n, K, 1 + d + l_len)
    l_mat = tril_matrix(net[..., 1 + d :], d) * temperature  # [N, K, d, d]
    ids = comp_ids.to(network_output.device).long()
    chosen_means = torch.gather(net[..., 1 : 1 + d], 1, ids[:, None, None].expand(n, 1, d))[:, 0]
    chosen_l = torch.gather(l_mat, 1, ids[:, None, None, None].expand(n, 1, d, d))[:, 0]
    zz = z.to(network_output.device, network_output.dtype)
    return chosen_means + torch.einsum("nij,nj->ni", chosen_l, zz)


def _sample(from_draws, network_output, d, K, temperature, generator):
    n = network_output.shape[0]
    per_comp = network_output.shape[1] // K
    logit = network_output.reshape(n, K, per_comp)[..., 0]
    gumbel, z = draw_gmm(n, K, d, generator, network_output.dtype)
    return from_draws(network_output, components(logit, gumbel), z, d, K, temperature)


def sample_gmm_diagonal(
    network_output: torch.Tensor,
    d: int,
    K: int,
    temperature: float,
    generator: torch.Generator,
) -> torch.Tensor:
    """Per-node ``[N, d]`` samples from a diagonal GMM output, with the draws
    of ``draw_gmm`` from ``generator``."""
    return _sample(gmm_diagonal_from_draws, network_output, d, K, temperature, generator)


def sample_gmm(
    network_output: torch.Tensor,
    d: int,
    K: int,
    temperature: float,
    generator: torch.Generator,
) -> torch.Tensor:
    """Per-node ``[N, d]`` samples from a full-covariance GMM output, with the
    draws of ``draw_gmm`` from ``generator``."""
    return _sample(gmm_full_from_draws, network_output, d, K, temperature, generator)

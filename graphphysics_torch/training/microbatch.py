"""Gradient accumulation: one optimizer step over M microbatches in turn
(counterpart of ``graphphysics_tpu/training/microbatch.py``).

The batch is a stacked Graph with leaves ``[M, ...]``
(``GraphLoader(collate="stack")``). The step equals the plain step on the
concatenation of the M microbatches up to the order of float sums, while
only one microbatch's activations are alive at a time:

- phase 1 folds every microbatch's statistics into the normalizers (the
  sums are linear). The accumulation counter of each normalizer that is
  still live is opened before the fold and closed to its old value + 1
  after it, so the step counts as one accumulation, as the plain step
  does; a normalizer at ``MAX_ACCUMULATIONS`` stays as it is;
- phase 2 runs the forward and backward of each microbatch in turn with
  the merged statistics (``accumulate_stats=False``): ``backward()`` on
  that microbatch's masked loss *sum*, which frees its graph before the
  next. When all are done the gradients and the loss are divided once by
  the total count (``losses.make_local_loss``), so microbatches of
  different node counts are weighed as in the concatenation, not as a mean
  of means.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from graphphysics_torch.core.graph import Graph
from graphphysics_torch.core.normalizer import MAX_ACCUMULATIONS
from graphphysics_torch.models.simulator import Normalizer, Simulator


def _normalizers(sim: Simulator) -> List[Normalizer]:
    return [m for m in sim.modules() if isinstance(m, Normalizer)]


def open_counters(sim: Simulator) -> List[torch.Tensor]:
    """Set the accumulation counter of every live normalizer to 0 (a capped
    one keeps its count) and return the old counters."""
    old = []
    with torch.no_grad():
        for n in _normalizers(sim):
            c = n._num_accumulations
            old.append(c.clone())
            c.copy_(torch.where(c >= MAX_ACCUMULATIONS, c, torch.zeros_like(c)))
    return old


def close_counters(sim: Simulator, old: Sequence[torch.Tensor]) -> None:
    """Set each normalizer's counter to its ``old`` value + 1, or back to
    ``old`` where that was capped."""
    with torch.no_grad():
        for n, o in zip(_normalizers(sim), old):
            n._num_accumulations.copy_(torch.where(o >= MAX_ACCUMULATIONS, o, o + 1.0))


def microbatch_step(
    sim: Simulator,
    optimizer: torch.optim.Optimizer,
    stacked: Graph,
    local_loss: Callable,
) -> torch.Tensor:
    """One optimizer step of ``sim`` over the microbatches of ``stacked``
    (leaves ``[M, ...]``, on the device). ``local_loss(target, out,
    node_type, node_valid, exclude_mask)`` gives a microbatch's masked
    ``(sum, count)``. Leaves the gradients in ``.grad`` (already divided)
    and steps ``optimizer``; returns the step's loss, a 0-d tensor on the
    device, not synchronized."""
    micro = [stacked[i] for i in range(stacked.x.shape[0])]
    old = open_counters(sim)
    for graph in micro:
        sim.accumulate_stats(graph)
    close_counters(sim, old)

    optimizer.zero_grad(set_to_none=True)
    loss_sum = count = None
    for graph in micro:
        out, target, _ = sim(graph, is_training=True, accumulate_stats=False)
        ls, c = local_loss(target, out, sim.node_type(graph), graph.node_mask, graph.exclude_mask)
        ls.backward()  # frees this microbatch's graph before the next forward
        ls, c = ls.detach(), c.detach()
        loss_sum = ls if loss_sum is None else loss_sum + ls
        count = c if count is None else count + c
    denom = torch.clamp(count, min=1.0)
    with torch.no_grad():
        for p in sim.parameters():
            if p.grad is not None:
                p.grad.div_(denom)
    optimizer.step()
    return loss_sum / denom


def loss_kind(num_mixture_components: int, use_diagonal: bool) -> str:
    """The ``make_local_loss`` kind of a model's decoder."""
    if num_mixture_components == 0:
        return "l2"
    return "diag_gmm" if use_diagonal else "full_gmm"


def gmm_kwargs(num_mixture_components: int, d: int, temperature: float) -> Dict[str, float]:
    """The ``make_local_loss`` GMM arguments of a K > 0 decoder (none for
    the plain one)."""
    if num_mixture_components == 0:
        return {}
    return {"d": d, "K": num_mixture_components, "temperature": temperature}

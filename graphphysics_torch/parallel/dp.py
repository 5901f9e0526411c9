"""The edge-partitioned train step, forward and rollout (counterpart of the
graph-parallel part of ``graphphysics_tpu/parallel/dp.py``).

Each of the ``P`` ranks of the graph group (``parallel.mesh``) holds one part
of the partitioned graph (``parallel.graph_partition``) and the same model.
A step:

- folds its part into the normalizers, then sums the statistics' deltas
  over the ranks (``merge_normalizer_states``: one ``all_reduce``), so every
  rank normalizes with the whole graph's statistics; the accumulation
  counter advances by one per step, as on one device;
- runs the forward and backward of the part's masked mean loss (the
  per-layer exchanges run inside the model: ``ops.halo``);
- weights its gradients and loss by ``count / total`` (``total`` the
  summed loss counts) and sums them over the ranks, so the step equals the
  unpartitioned step on the whole graph up to the order of float sums.

The 2-D data x graph step (JAX ``make_dp_graph_parallel_train_step``) is
ROADMAP item 13 and is not here.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from graphphysics_torch.core.graph import Graph
from graphphysics_torch.parallel.mesh import GRAPH_AXIS, graph_group
from graphphysics_torch.training.losses import make_local_loss


def _normalizers(sim) -> list:
    from graphphysics_torch.models.simulator import Normalizer

    return [m for m in sim.modules() if isinstance(m, Normalizer)]


def _stats(norm) -> List[torch.Tensor]:
    return [norm._acc_count, norm._num_accumulations, norm._acc_sum, norm._acc_sum_squared]


def merge_normalizer_states(sim, before: Sequence[Sequence[torch.Tensor]],
                            axis_name: str = GRAPH_AXIS) -> None:
    """Merge this rank's statistics with the others' after each has folded
    its part in: ``before`` holds every normalizer's ``[count,
    accumulations, sum, sum_sq]`` from before the fold (``snapshot``). The
    count and sums become ``before + the ranks' summed deltas``, the
    accumulation counter ``before + their mean delta`` (one per step), in
    one ``all_reduce``."""
    norms = _normalizers(sim)
    deltas = [now - old for norm, olds in zip(norms, before) for now, old in zip(_stats(norm), olds)]
    flat = torch.cat([t.reshape(-1) for t in deltas])
    group = graph_group(axis_name)
    dist.all_reduce(flat, group=group)
    size = dist.get_world_size(group)
    off = 0
    with torch.no_grad():
        for norm, olds in zip(norms, before):
            for i, (buf, old) in enumerate(zip(_stats(norm), olds)):
                delta = flat[off:off + buf.numel()].reshape(buf.shape)
                off += buf.numel()
                buf.copy_(old + (delta / size if i == 1 else delta))


def snapshot(sim) -> List[List[torch.Tensor]]:
    """Every normalizer's statistics, copied (for
    ``merge_normalizer_states``)."""
    return [[t.clone() for t in _stats(norm)] for norm in _normalizers(sim)]


def all_reduce_weighted(tensors: Sequence[Optional[torch.Tensor]], weight: torch.Tensor,
                        like: Sequence[torch.Tensor], axis_name: str = GRAPH_AXIS) -> List[torch.Tensor]:
    """``sum over ranks of weight * t`` for each tensor (None reads as zeros
    shaped like ``like``), in one ``all_reduce``."""
    parts = [(torch.zeros_like(l) if t is None else t).reshape(-1) * weight
             for t, l in zip(tensors, like)]
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=graph_group(axis_name))
    out, off = [], 0
    for l in like:
        out.append(flat[off:off + l.numel()].reshape(l.shape))
        off += l.numel()
    return out


def make_graph_parallel_train_step(
    sim,
    optimizer: torch.optim.Optimizer,
    masks: Sequence[int],
    axis_name: str = GRAPH_AXIS,
    loss_kind: str = "l2",
    gmm_kwargs: Optional[dict] = None,
) -> Callable[[Graph], torch.Tensor]:
    """``step(part)``: one optimizer step of ``sim`` over this rank's part
    (on the device) of an edge-partitioned graph; every rank of the group
    calls it at once. Returns the whole graph's loss (the count-weighted sum
    of the ranks' local means), a 0-d tensor on the device. Leaves the
    summed gradients in ``.grad``."""
    local_loss = make_local_loss(list(masks), loss_kind, gmm_kwargs or {})
    params = [p for p in sim.parameters()]

    def step(part: Graph) -> torch.Tensor:
        before = snapshot(sim)
        sim.accumulate_stats(part)
        merge_normalizer_states(sim, before, axis_name)
        out, target, _ = sim(part, is_training=True, accumulate_stats=False)
        loss_sum, count = local_loss(target, out, sim.node_type(part), part.node_mask,
                                     part.exclude_mask)
        loss = loss_sum / torch.clamp(count, min=1.0)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        total = count.detach().clone().reshape(1)
        dist.all_reduce(total, group=graph_group(axis_name))
        w = count.detach() / torch.clamp(total[0], min=1.0)
        *grads, gloss = all_reduce_weighted([p.grad for p in params] + [loss.detach()], w,
                                            params + [loss.detach()], axis_name)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.grad = g.to(p.dtype)
        optimizer.step()
        return gloss

    return step


def graph_parallel_forward(model, part: Graph, **kwargs):
    """``model(part, **kwargs)`` on this rank's part: every rank calls it at
    once (the exchanges run inside). Returns this rank's node rows; stack
    the ranks' (``gather_rows``) for the whole graph's."""
    return model(part, **kwargs)


def gather_rows(t: torch.Tensor, axis_name: str = GRAPH_AXIS, dim: int = 0) -> torch.Tensor:
    """Every rank's node rows of ``t`` (rows along ``dim``), concatenated in
    rank order along ``dim``: the whole graph's, on every rank."""
    group = graph_group(axis_name)
    moved = t.movedim(dim, 0).contiguous()
    out = moved.new_empty((dist.get_world_size(group) * moved.shape[0],) + tuple(moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim)


def partitioned_rollout(
    sim,
    frames_part: Graph,
    device=None,
    generator: Optional[torch.Generator] = None,
    axis_name: str = GRAPH_AXIS,
    use_previous_data: bool = False,
    previous_data_start: Optional[int] = None,
    previous_data_end: Optional[int] = None,
):
    """Autoregressive rollout over an edge-partitioned trajectory: this
    rank's frames (``partition_frames_np(...)[:, rank]``, leaves
    ``[T, ...]``), every rank at once, each frame's exchanges inside the
    model. A GMM head samples from ``generator``, which should differ per
    rank. Returns the whole graph's ``(predictions, targets)``, ``[T, N,
    d]`` with the parts' rows in order, on every rank."""
    from graphphysics_torch.training.rollout import rollout

    preds, targets = rollout(sim, frames_part, device=device, generator=generator,
                             use_previous_data=use_previous_data,
                             previous_data_start=previous_data_start,
                             previous_data_end=previous_data_end)
    return gather_rows(preds, axis_name, dim=1), gather_rows(targets, axis_name, dim=1)

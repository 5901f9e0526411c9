"""The data-parallel, edge-partitioned and 2-D train steps, the
partitioned forward and rollout (counterpart of
``graphphysics_tpu/parallel/dp.py``).

Every rank holds the same model and optimizer. The three steps differ only
in the process groups they reduce over (``parallel.mesh``) and in how a
rank turns its shard into one local graph, as in JAX
(``_make_sharded_train_step``):

- ``make_dp_train_step``: the ``R`` ranks of the data group each take
  their contiguous block of ``B / R`` rows of the stacked ``[B, ...]``
  batch (JAX's ``P("data")`` shards) and flatten it
  (``core.graph.flatten_batched_graph``);
- ``make_graph_parallel_train_step``: the ``P`` ranks of the graph group
  each hold one part of an edge-partitioned graph
  (``parallel.graph_partition``), the per-layer exchanges running inside
  the model (``ops.halo``);
- ``make_dp_graph_parallel_train_step``: the ``D x P`` ranks of the 2-D
  layout each hold one part of one graph of the batch (a ``[1, 1, ...]``
  shard); the exchanges ride the graph group, the reductions both axes
  (the world).

A step:

- folds its local graph into the normalizers, then sums the statistics'
  deltas over the reducing group (``merge_normalizer_states``: one
  ``all_reduce``), so every rank normalizes with the whole batch's
  statistics; the accumulation counter advances by one per step (the
  group's mean delta), as on one device;
- runs the forward and backward of the local masked mean loss;
- weights its gradients and loss by ``count / total`` (``total`` the
  summed loss counts) and sums them over the group, so the step equals the
  single-device step on the whole batch up to the order of float sums.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from graphphysics_torch.core.graph import Graph, flatten_batched_graph
from graphphysics_torch.parallel.mesh import DATA_AXIS, GRAPH_AXIS, axis_group, graph_group
from graphphysics_torch.training.losses import make_local_loss

Axes = Union[str, Tuple[str, ...]]


def _normalizers(sim) -> list:
    from graphphysics_torch.models.simulator import Normalizer

    return [m for m in sim.modules() if isinstance(m, Normalizer)]


def _stats(norm) -> List[torch.Tensor]:
    return [norm._acc_count, norm._num_accumulations, norm._acc_sum, norm._acc_sum_squared]


def merge_normalizer_states(sim, before: Sequence[Sequence[torch.Tensor]],
                            axis_name: Axes = GRAPH_AXIS) -> None:
    """Merge this rank's statistics with the others' after each has folded
    its local graph in: ``before`` holds every normalizer's ``[count,
    accumulations, sum, sum_sq]`` from before the fold (``snapshot``). The
    count and sums become ``before + the ranks' summed deltas``, the
    accumulation counter ``before + their mean delta`` (one per step), in
    one ``all_reduce`` over ``axis_name``'s group (a name, or a tuple of
    both axes: the world)."""
    norms = _normalizers(sim)
    deltas = [now - old for norm, olds in zip(norms, before) for now, old in zip(_stats(norm), olds)]
    flat = torch.cat([t.reshape(-1) for t in deltas])
    group = axis_group(axis_name)
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
                        like: Sequence[torch.Tensor], axis_name: Axes = GRAPH_AXIS) -> List[torch.Tensor]:
    """``sum over ranks of weight * t`` for each tensor (None reads as zeros
    shaped like ``like``), in one ``all_reduce`` over ``axis_name``'s
    group."""
    parts = [(torch.zeros_like(l) if t is None else t).reshape(-1) * weight
             for t, l in zip(tensors, like)]
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=axis_group(axis_name))
    out, off = [], 0
    for l in like:
        out.append(flat[off:off + l.numel()].reshape(l.shape))
        off += l.numel()
    return out


def _make_sharded_train_step(sim, optimizer: torch.optim.Optimizer, masks: Sequence[int],
                             axes: Axes, local_graph_fn: Callable[[Graph], Graph],
                             loss_kind: str = "l2",
                             gmm_kwargs: Optional[dict] = None) -> Callable[[Graph], torch.Tensor]:
    """The body the three steps share: ``step(shard)`` turns the rank's
    shard into its local graph on the model's device
    (``local_graph_fn``), folds it into the statistics merged over
    ``axes``, and takes one optimizer step on the gradients summed over
    them. Returns the whole batch's loss (the count-weighted sum of the
    ranks' local means), a 0-d tensor on the device; leaves the summed
    gradients in ``.grad``."""
    local_loss = make_local_loss(list(masks), loss_kind, gmm_kwargs or {})
    params = [p for p in sim.parameters()]
    device = params[0].device
    group = axis_group(axes)

    def step(shard: Graph) -> torch.Tensor:
        graph = local_graph_fn(shard).to(device)
        before = snapshot(sim)
        sim.accumulate_stats(graph)
        merge_normalizer_states(sim, before, axes)
        out, target, _ = sim(graph, is_training=True, accumulate_stats=False)
        loss_sum, count = local_loss(target, out, sim.node_type(graph), graph.node_mask,
                                     graph.exclude_mask)
        loss = loss_sum / torch.clamp(count, min=1.0)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        total = count.detach().clone().reshape(1)
        dist.all_reduce(total, group=group)
        w = count.detach() / torch.clamp(total[0], min=1.0)
        *grads, gloss = all_reduce_weighted([p.grad for p in params] + [loss.detach()], w,
                                            params + [loss.detach()], axes)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.grad = g.to(p.dtype)
        optimizer.step()
        return gloss

    return step


def rank_rows(batch: Graph, axis_name: str = DATA_AXIS) -> Graph:
    """This rank's contiguous block of a stacked ``[B, ...]`` batch over
    ``axis_name``'s group: rows ``[r * B / R, (r + 1) * B / R)``, the shard
    JAX's ``P(axis)`` gives device ``r``. ``B`` must divide by ``R``."""
    group = graph_group(axis_name)
    r, size = dist.get_rank(group), dist.get_world_size(group)
    b = batch.x.shape[0]
    if b % size:
        raise ValueError(f"data-parallel step: the batch of {b} graphs does not split over the "
                         f"{size} ranks of the '{axis_name}' axis")
    rows = b // size
    return batch[r * rows:(r + 1) * rows]


def make_dp_train_step(
    sim,
    optimizer: torch.optim.Optimizer,
    masks: Sequence[int],
    axis_name: str = DATA_AXIS,
    loss_kind: str = "l2",
    gmm_kwargs: Optional[dict] = None,
    local_rows: bool = False,
) -> Callable[[Graph], torch.Tensor]:
    """``step(batch)``: one optimizer step of ``sim`` over a stacked
    ``[B, ...]`` batch (host or device), every rank of ``axis_name``'s
    group calling it at once with the same batch; each flattens its own
    rows (``rank_rows``). With ``local_rows`` each passes its own rows
    instead (what ``parallel.multihost.MultihostGraphLoader`` yields).
    Returns the whole batch's loss on every rank."""

    def local(batch: Graph) -> Graph:
        return flatten_batched_graph(batch if local_rows else rank_rows(batch, axis_name))

    return _make_sharded_train_step(sim, optimizer, masks, axis_name, local, loss_kind, gmm_kwargs)


def make_graph_parallel_train_step(
    sim,
    optimizer: torch.optim.Optimizer,
    masks: Sequence[int],
    axis_name: str = GRAPH_AXIS,
    loss_kind: str = "l2",
    gmm_kwargs: Optional[dict] = None,
) -> Callable[[Graph], torch.Tensor]:
    """``step(part)``: one optimizer step of ``sim`` over this rank's part
    (on the device) of an edge-partitioned graph; every rank of the graph
    group calls it at once. Returns the whole graph's loss on every rank."""
    return _make_sharded_train_step(sim, optimizer, masks, axis_name, lambda part: part,
                                    loss_kind, gmm_kwargs)


def check_2d_shard(lead) -> None:
    """Raise unless a 2-D step's shard is ``[1, 1, ...]``."""
    if tuple(lead) != (1, 1):
        raise ValueError(
            f"2-D (data x graph) step: expected a [1, 1, ...] local shard (one graph per data "
            f"row, one partition per graph device), got {tuple(lead)} — size the batch to "
            f"mesh.shape[data_axis] graphs of mesh.shape[graph_axis] parts (extra rows would be "
            f"silently dropped)"
        )


def make_dp_graph_parallel_train_step(
    sim,
    optimizer: torch.optim.Optimizer,
    masks: Sequence[int],
    data_axis: str = DATA_AXIS,
    graph_axis: str = GRAPH_AXIS,
    loss_kind: str = "l2",
    gmm_kwargs: Optional[dict] = None,
) -> Callable[[Graph], torch.Tensor]:
    """``step(shard)``: the 2-D (data x graph) step over the ``D x P``
    layout (``parallel.mesh.init_layout``). A batch of ``D`` graphs, each
    edge-partitioned into ``P`` parts, stacks ``[D, P, ...]``; rank ``(d,
    p)`` passes its ``[1, 1, ...]`` shard ``parts[d:d+1, p:p+1]`` (any
    other shape raises). The exchanges inside the model ride the graph
    group (the parts' ``partition_axis``), the loss, gradients and
    statistics reduce over both axes, so the step equals the data-parallel
    step on the unpartitioned graphs."""

    def local(shard: Graph) -> Graph:
        check_2d_shard(shard.x.shape[:2])
        return shard[0][0]

    return _make_sharded_train_step(sim, optimizer, masks, (data_axis, graph_axis), local,
                                    loss_kind, gmm_kwargs)


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
